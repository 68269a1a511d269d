"""Opto-electronic Blend Unit (OBU) — paper §3.2.

Port of ``repro.core.obu``.  The permutation builders are numpy (static,
drawn once from a seed) and copied from the reference; the tensor side is
torch:

  * **optical transpose** — the same programmed array computes ``x @ W.T``;
    :func:`blend_dot` contracts over the weight's last dim (a transposed
    view, never a materialized transpose);
  * **electronic shuffle** — a static channel permutation of the
    activations (group shuffle or blocked random shuffle), applied as an
    index gather.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


# --------------------------------------------------------------------------
# permutation builders (static, numpy)
# --------------------------------------------------------------------------
def group_shuffle_permutation(channels: int, groups: int) -> np.ndarray:
    """Channel-group shuffle as an explicit permutation vector:
    ``y[i] = x[perm[i]]`` reproduces reshape(g, C/g) -> transpose -> flatten."""
    if channels % groups != 0:
        raise ValueError(f"channels {channels} not divisible by groups {groups}")
    idx = np.arange(channels).reshape(groups, channels // groups)
    return idx.T.reshape(-1).copy()


def blocked_random_permutation(channels: int, block: int, seed: int) -> np.ndarray:
    """Blocked random shuffle: permute whole blocks of ``block`` channels."""
    if channels % block != 0:
        raise ValueError(f"channels {channels} not divisible by block {block}")
    nblk = channels // block
    rng = np.random.default_rng(seed)
    order = rng.permutation(nblk)
    idx = np.arange(channels).reshape(nblk, block)
    return idx[order].reshape(-1).copy()


def invert_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0])
    return inv


def build_transform_tables(channels: int, reuse_times: int, transforms,
                           groups: int, block: int, seed: int) -> np.ndarray:
    """Per-reuse-step channel permutation table, shape (T, channels).  Step
    ``t`` applies ``perm[t]`` to the activations entering reuse ``t``;
    identity / transpose-only steps get the identity permutation."""
    table = np.tile(np.arange(channels), (reuse_times, 1))
    for t in range(reuse_times):
        name = transforms[t % len(transforms)] if transforms else "identity"
        if name in ("shuffle", "shuffle_transpose"):
            if block and block > 0:
                table[t] = blocked_random_permutation(channels, block, seed + t)
            else:
                table[t] = group_shuffle_permutation(channels, groups)
    return table


def transpose_flags(reuse_times: int, transforms) -> np.ndarray:
    """Boolean per-reuse-step table: does step ``t`` use the transposed path."""
    flags = np.zeros((reuse_times,), dtype=bool)
    for t in range(reuse_times):
        name = transforms[t % len(transforms)] if transforms else "identity"
        flags[t] = name in ("transpose", "shuffle_transpose")
    return flags


# --------------------------------------------------------------------------
# torch-side application
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def device_index(index: bytes, device: str) -> torch.Tensor:
    """A static int64 index (its bytes) on ``device``, copied there once
    per (index, device) and kept: a host-to-device copy per call would
    make the host wait for the device, and a captured decode step keeps
    the tensor's address."""
    return torch.as_tensor(np.frombuffer(index, dtype=np.int64).copy(),
                           device=device)


def apply_channel_permutation(x: torch.Tensor, perm) -> torch.Tensor:
    """Permute the last axis of ``x`` by the static permutation ``perm``."""
    idx = device_index(np.asarray(perm, np.int64).tobytes(), str(x.device))
    return x.index_select(-1, idx)


def group_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """Channel-group shuffle of the last axis (reshape/transpose form; the
    permutation-vector form is bit-identical)."""
    *lead, c = x.shape
    if c % groups != 0:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    x = x.reshape(*lead, groups, c // groups)
    return x.transpose(-1, -2).reshape(*lead, c)


def optical_transpose(w: torch.Tensor) -> torch.Tensor:
    """Transpose of the last two dims: the OBU's vertical-input path.  At
    matmul use-sites :func:`blend_dot` with ``transpose=True`` contracts
    over the weight's last dim instead."""
    return w.transpose(-1, -2)


# The product dtype of ``blend_dot`` (the reference's ``_ACCUM_FP32``):
# float32 by default, so a bf16 model's xla and training GEMMs run in
# float32; ``set_matmul_accum_fp32(False)`` multiplies in x's dtype (the
# reference's switch for its TP collectives' width).
_ACCUM_FP32 = True


def set_matmul_accum_fp32(value: bool) -> None:
    global _ACCUM_FP32
    _ACCUM_FP32 = value


def _pref(x: torch.Tensor) -> torch.dtype:
    return (torch.float32 if (_ACCUM_FP32 or x.dtype == torch.float32)
            else x.dtype)


def blend_dot(x: torch.Tensor, w: torch.Tensor, *,
              transpose: bool) -> torch.Tensor:
    """``x @ w`` or ``x @ w.T`` (w: (k, n), or (n, k) when transposed) in
    :func:`_pref`'s dtype (float32 by default), cast back to x's dtype —
    the reference's ``dot_general(preferred_element_type=_pref(x))``."""
    if transpose:
        if w.shape[-1] != x.shape[-1]:
            raise ValueError(f"transpose blend needs square-compatible dims, "
                             f"got x{tuple(x.shape)} w{tuple(w.shape)}")
        w = w.transpose(-1, -2)
    p = _pref(x)
    return torch.matmul(x.to(p), w.to(p)).to(x.dtype)
