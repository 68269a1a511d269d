"""Execution backends — the seam between the model stack and the compute
substrate (partial port of ``repro.core.backend``).

Every weight matmul in ``models/*`` goes through ``Backend.dot``; the OBU
activation shuffle in ``core/sharing.py`` goes through ``Backend.shuffle``;
sequence attention goes through ``Backend.attention``.

  * ``"xla"`` (name kept from the reference) — plain torch matmuls with
    float32 accumulation (``obu.blend_dot``) and the einsum attention.
  * ``"photonic"`` — every matmul runs a W8A8 MVM kernel against a
    prepared bank (or the fp weight quantized in-step):
      - ``fused=True`` (default): the fused kernel
        (``kernels/photonic_mvm.photonic_mvm_fused``: A8 quantization in
        the prologue, the blend epilogue in the kernel);
      - ``fused=False``: the split comparator — the A8 pass, the split MVM
        kernel (``photonic_mvm`` / ``photonic_mvm_t``) with a float32
        output cast to the activation dtype, then the unfused epilogue
        (the blend kernel for blocked shuffles, torch ops otherwise).  Same
        numbers as the fused path with noise off;
      - an enabled ``noise`` (``core/noise.NoiseConfig``) reroutes every
        matmul through the split pipeline with the fault model applied to
        the raw MVM output, keyed by the bank's tag.
    Blocked OBU shuffles run the blend kernel; long-sequence attention runs
    the flash kernel (``kernels/flash_attention.py``).

Left out for later slices: the mesh/sharded branches, ``reuse_dot``
(PRM-blended MoE experts) and the TPU tile plans (``bm/bk/bn``,
``adaptive``: the CUDA kernels pick their own tiles).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import obu
from repro_torch.core.prepared import (PreparedTensor, quantize_weight,
                                       quantize_weight_t)
from repro_torch.kernels import ops
from repro_torch.kernels.photonic_mvm import apply_activation

EXECUTIONS = ("xla", "photonic")


def _epilogue_unfused(y, bias, block_perm, block, activation):
    """The split blend epilogue: the blend kernel for blocked shuffles,
    torch ops for bias/activation-only epilogues."""
    if block_perm is not None:
        return ops.blend_shuffle(y, bias, block_perm, block=block,
                                 activation=activation or "none")
    if bias is not None:
        y = y + bias.to(y.dtype)
    return apply_activation(y, activation)


def _epilogue_xla(y, bias, block_perm, block, activation):
    """Reference epilogue on the xla backend (gather + torch ops)."""
    if block_perm is not None:
        perm = np.asarray(block_perm)
        C = y.shape[-1]
        if block <= 0 or C % block != 0 or perm.shape[0] * block != C:
            raise ValueError(f"blocked shuffle needs C % block == 0 and a "
                             f"full permutation, got C={C} block={block}")
        idx = (perm[:, None] * block + np.arange(block)[None, :]).reshape(-1)
        y = y.index_select(-1, torch.as_tensor(idx, device=y.device))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return apply_activation(y, activation)


@dataclasses.dataclass(frozen=True)
class Backend:
    """Static description of the matmul substrate."""

    execution: str = "xla"
    fused: bool = True                # the fused kernel vs the split
                                      # quantize/MVM/blend pipeline
    noise: Any = None                 # core.noise.NoiseConfig | None — the
                                      # opt-in photonic fault model; None /
                                      # all-zero is the clean path
    flash: bool = True                # long photonic attention -> flash
    flash_min_seq: int = 512          # query lengths below this take the
                                      # einsum path

    def __post_init__(self):
        if self.execution not in EXECUTIONS:
            raise ValueError(f"unknown execution backend "
                             f"{self.execution!r}; have {EXECUTIONS}")

    @property
    def is_photonic(self) -> bool:
        return self.execution == "photonic"

    @property
    def noise_active(self) -> bool:
        """True when the fault model actually perturbs: photonic execution
        AND an enabled config.  Always False on xla."""
        return (self.is_photonic and self.noise is not None
                and self.noise.enabled)

    # ----------------------------------------------------------- attention
    def use_flash(self, q_len: int) -> bool:
        """Photonic execution only, at or above ``flash_min_seq`` rows."""
        return self.is_photonic and self.flash and q_len >= self.flash_min_seq

    def attention(self, q, k, v, *, causal: bool = True, q_offset=None):
        """q: (B, Sq, H, hd); k: (B, L, KV, hd); v: (B, L, KV, hd_v).
        Returns (B, Sq, H * hd_v).  Long photonic sequences run the flash
        kernel; everything else the einsum reference."""
        B, Sq, H, _ = q.shape
        hd_v = v.shape[-1]
        if self.use_flash(Sq):
            o = ops.flash_attention(q, k, v, causal=causal,
                                    q_offset=q_offset)
            return o.reshape(B, Sq, H * hd_v)
        from repro_torch.models import attention as _attn  # models -> core
        return _attn.attend_seq_xla(q, k, v, causal=causal,
                                    q_offset=q_offset)

    # ------------------------------------------------------------- matmuls
    def dot(self, x, w, *, transpose: bool = False, bias=None,
            block_perm=None, block: int = 0, activation=None):
        """``x @ w`` (w: (k, n)) or ``x @ w.T`` (w: (n, k)) plus an optional
        blend epilogue.  ``w`` may be a fp tensor or a PreparedTensor bank."""
        if isinstance(w, PreparedTensor):
            return self.dot_prepared(x, w, transpose=transpose, bias=bias,
                                     block_perm=block_perm, block=block,
                                     activation=activation)
        if not self.is_photonic:
            y = obu.blend_dot(x, w, transpose=transpose)
            return _epilogue_xla(y, bias, block_perm, block, activation)
        if transpose:
            if w.shape[-1] != x.shape[-1]:
                raise ValueError(f"transpose blend needs square-compatible "
                                 f"dims, got x{tuple(x.shape)} "
                                 f"w{tuple(w.shape)}")
            wq, wscale = quantize_weight_t(w)
        else:
            wq, wscale = quantize_weight(w)
        return self._photonic_matmul(x, wq, wscale, transpose=transpose,
                                     bias=bias, block_perm=block_perm,
                                     block=block, activation=activation,
                                     bank_tag=None)

    def dot_prepared(self, x, prep: PreparedTensor, *,
                     transpose: bool = False, bias=None, block_perm=None,
                     block: int = 0, activation=None):
        """``dot`` against a programmed bank: the transposed orientation
        uses the per-row image (``wq_t``/``scale_t``)."""
        if not self.is_photonic:
            # xla pointed at a photonic bank: dequantize the W8 image
            if transpose:
                w = (prep.wq_t.to(torch.float32)
                     * (prep.scale_t / 127.0)[..., :, None]).to(x.dtype)
            else:
                w = (prep.wq.to(torch.float32)
                     * (prep.scale / 127.0)[..., None, :]).to(x.dtype)
            y = obu.blend_dot(x, w, transpose=transpose)
            return _epilogue_xla(y, bias, block_perm, block, activation)
        if transpose:
            if prep.shape[-1] != x.shape[-1]:
                raise ValueError(f"transpose blend needs square-compatible "
                                 f"dims, got x{tuple(x.shape)} "
                                 f"w{prep.shape}")
            wq, wscale = prep.wq_t, prep.scale_t
        else:
            wq, wscale = prep.wq, prep.scale
        return self._photonic_matmul(x, wq, wscale, transpose=transpose,
                                     bias=bias, block_perm=block_perm,
                                     block=block, activation=activation,
                                     bank_tag=prep.tag)

    def _photonic_matmul(self, x, wq, wscale, *, transpose, bias,
                         block_perm, block, activation, bank_tag):
        """The fused kernel, or the split quantize -> MVM -> epilogue
        pipeline; with an enabled fault model, the split pipeline with the
        ``core/noise.py`` perturbation on the raw MVM output.
        ``bank_tag`` (the PreparedTensor's path hash; None for in-step
        quantized weights) keys the bank's random streams and its age."""
        if self.noise_active:
            y = ops.photonic_matmul_noisy(x, wq, wscale, noise=self.noise,
                                          bank_tag=bank_tag,
                                          transpose=transpose)
            return _epilogue_unfused(y, bias, block_perm, block, activation)
        if self.fused:
            return ops.photonic_matmul_fused(
                x, wq, wscale, transpose=transpose, bias=bias,
                block_perm=block_perm, block=block,
                activation=activation or "none")
        mm = (ops.photonic_matmul_prepared_t if transpose
              else ops.photonic_matmul_prepared)
        return _epilogue_unfused(mm(x, wq, wscale), bias, block_perm, block,
                                 activation)

    # -------------------------------------------------------------- shuffle
    def shuffle(self, h, perm, block_perm=None, block: int = 0):
        """OBU electronic shuffle of the channel axis.  Photonic + blocked
        permutation (the paper's §3.2 method 1): the blend kernel, fused or
        split alike.  Otherwise the static index gather."""
        if self.is_photonic and block_perm is not None and block > 0:
            return ops.blend_shuffle(h, None, block_perm, block=block,
                                     activation="none")
        return obu.apply_channel_permutation(h, perm)


XLA = Backend("xla")
PHOTONIC = Backend("photonic")


def resolve(spec=None) -> Backend:
    """Backend from a Backend | name | config-with-.execution | None."""
    if spec is None:
        return XLA
    if isinstance(spec, Backend):
        return spec
    if isinstance(spec, str):
        return PHOTONIC if spec == "photonic" else Backend(spec)
    return resolve(getattr(spec, "execution", None))
