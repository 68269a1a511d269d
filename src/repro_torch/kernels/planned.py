"""Planned kernel calls: what the kernel wrappers do on meta tensors.

A meta tensor has a shape and a dtype and no memory.  The dry-run
(``launch/dryrun.py``) walks the real step functions on such tensors, so
every kernel wrapper has a third device rule beside the CPU's plain
version and the card's launch: on a meta tensor it checks its operands as
the launch would, returns an empty meta output of the kernel's shape and
dtype, and adds one **planned call** here, with the work the kernel would
do on those shapes (its operations, and its bytes: each input read once,
each output written once).  A planned call is never a launch: the
``launches`` counters of ``kernels/counts.py`` do not move.

The names are those of ``counts.COUNTERS``.
"""
from __future__ import annotations

import torch

NAMES = ("photonic_mvm_fused", "photonic_mvm_fused_gemv", "photonic_mvm",
         "photonic_mvm_t", "photonic_mvm_resident", "blend_shuffle",
         "flash_attention", "flash_attention_mma", "flash_attention_causal",
         "ssd_chunk", "decode_attention")

calls = dict.fromkeys(NAMES, 0)
ops = dict.fromkeys(NAMES, 0.0)       # operations (multiply-add = 2)
traffic = dict.fromkeys(NAMES, 0.0)   # bytes: inputs once, outputs once


def tensor_bytes(t) -> int:
    """Bytes a kernel reads of ``t`` once: its distinct elements (a dim of
    stride 0, a broadcast, is read once)."""
    if t is None:
        return 0
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def add(name: str, n_ops: float, inputs, outputs, **also) -> None:
    """One planned call of kernel ``name`` doing ``n_ops`` operations on
    ``inputs`` into ``outputs``; ``also`` names sub-counters (e.g.
    ``photonic_mvm_fused_gemv=True``) that count the call too."""
    nbytes = (sum(tensor_bytes(t) for t in inputs)
              + sum(tensor_bytes(t) for t in outputs))
    calls[name] += 1
    ops[name] += float(n_ops)
    traffic[name] += float(nbytes)
    for sub, on in also.items():
        calls[sub] += int(bool(on))


def snapshot() -> dict:
    """Planned calls by kernel name."""
    return dict(calls)


def totals() -> tuple:
    """(operations, bytes) of every planned call so far."""
    return sum(ops.values()), sum(traffic.values())


def causal_pairs(Sq: int, L: int, q_offset: int, kv_len: int,
                 causal: bool) -> int:
    """(query, key) pairs a flash call scores: every key below ``kv_len``,
    or under the causal mask only those at or before ``q_offset + i``."""
    if not causal:
        return Sq * kv_len
    # row i sees min(kv_len, q_offset + i + 1) keys (at least 0)
    total = 0
    full_from = max(0, kv_len - q_offset - 1)      # rows that see kv_len
    ramp = min(Sq, full_from)
    # rows 0..ramp-1 see q_offset + i + 1 keys (>= 0)
    lo, hi = q_offset + 1, q_offset + ramp
    if ramp > 0:
        total += max(0, (lo + hi) * ramp // 2)
    total += (Sq - ramp) * kv_len
    return int(total)
