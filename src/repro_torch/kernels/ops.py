"""Tensor-shaped wrappers around the kernels (partial port of
``repro.kernels.ops``).

The shape plumbing lives here so callers stay tensor-shaped: the A8 scale
pre-pass and row flattening of the fused MVM, and the head flattening of
flash attention.  The kernels themselves are built and loaded by
``kernels/build.py`` (re-exported here as :func:`build_kernels`).
"""
from __future__ import annotations

from repro_torch.core.photonic import a8_scale
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import photonic_mvm as _pm
from repro_torch.kernels.build import build as build_kernels  # noqa: F401


def photonic_matmul_fused(x, wq, wscale, *, transpose=False, bias=None,
                          block_perm=None, block=0, activation="none"):
    """One-kernel serving matmul against a prepared bank.

    x: fp (..., k); wq/wscale: a prepared orientation — (k, n)/per-column,
    or (n, k)/per-row with ``transpose=True``.  The A8 scale is a separate
    abs-max reduction over EVERY row of x (per tensor, as in the
    reference); quantization, bias, activation and the blocked output
    shuffle run inside the kernel."""
    xscale = a8_scale(x)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    n_out = wq.shape[0] if transpose else wq.shape[1]
    y = _pm.photonic_mvm_fused(x2, wq, xscale, wscale.reshape(-1),
                               bias=bias, transpose=transpose,
                               activation=activation, block_perm=block_perm,
                               block=block)
    return y.reshape(*lead, n_out)


def flash_attention(q, k, v, *, causal=True, q_offset=None):
    """Tensor-shaped flash attention: q (B, Sq, H, hd); k (B, L, KV, hd);
    v (B, L, KV, hd_v) with H % KV == 0.  Heads flatten in the
    ``(B, KV, G)`` order of the reference (``ops.py:199-215``), so query
    row b*H + kv*G + g reads kv row b*KV + kv.  Returns (B, Sq, H, hd_v)."""
    B, Sq, H, hd = q.shape
    _, L, KV, hdv = v.shape
    qf = q.permute(0, 2, 1, 3).reshape(B * H, Sq, hd).contiguous()
    kf = k.permute(0, 2, 1, 3).reshape(B * KV, L, hd).contiguous()
    vf = v.permute(0, 2, 1, 3).reshape(B * KV, L, hdv).contiguous()
    o = _fa.flash_attention(qf, kf, vf, causal=causal, q_offset=q_offset)
    return o.reshape(B, H, Sq, hdv).permute(0, 2, 1, 3)
