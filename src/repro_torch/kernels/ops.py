"""Tensor-shaped wrappers around the kernels (partial port of
``repro.kernels.ops``).

The shape plumbing lives here so callers stay tensor-shaped: the A8 scale
pre-pass and row flattening of the fused MVM, the A8 quantization pass of
the split MVMs, the row flattening of the blend, and the head flattening
of flash attention.  The kernels themselves are built and loaded by
``kernels/build.py`` (re-exported here as :func:`build_kernels`, which
starts one ``nvcc`` per source, all at once).
"""
from __future__ import annotations

from repro_torch.core import noise as noise_lib
from repro_torch.core.photonic import a8_scale, quantize_symmetric
from repro_torch.kernels import blend as _blend
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import photonic_mvm as _pm
from repro_torch.kernels.build import build as build_kernels  # noqa: F401


# =========================================================================
# split pipeline (write-once banks): A8 pass, then the MVM kernel
# =========================================================================
def photonic_matmul_prepared(x, wq, wscale):
    """Offset-decomposed MVM against a programmed bank: wq int8 (k, n)
    per-output-channel quantized, wscale f32 (n,).  Only the activations
    are quantized here, per tensor (the reference's ``_quantize_a8``; its
    ``x_scale`` override serves only the sharded path, not ported).  The
    kernel's float32 output is cast to x's dtype, as in the reference."""
    xq, xscale = quantize_symmetric(x, 8)
    lead = x.shape[:-1]
    y = _pm.photonic_mvm(xq.reshape(-1, x.shape[-1]), wq, xscale,
                         wscale.reshape(-1))
    return y.reshape(*lead, wq.shape[1]).to(x.dtype)


def photonic_matmul_prepared_t(x, wq, wscale):
    """Prepared ``x @ w.T``: wq int8 (n, k) per-ROW quantized; wscale
    (n,)."""
    xq, xscale = quantize_symmetric(x, 8)
    lead = x.shape[:-1]
    y = _pm.photonic_mvm_t(xq.reshape(-1, x.shape[-1]), wq, xscale,
                           wscale.reshape(-1))
    return y.reshape(*lead, wq.shape[0]).to(x.dtype)


def photonic_matmul_noisy(x, wq, wscale, *, noise, bank_tag=None,
                          transpose=False):
    """Split MVM + fault model: the bit-exact prepared MVM, then the
    ``core/noise.py`` perturbation of the raw MVM output (after the TIA
    rescale, before the electronic blend epilogue)."""
    mm = photonic_matmul_prepared_t if transpose else photonic_matmul_prepared
    y = mm(x, wq, wscale)
    return noise_lib.perturb_mvm_output(y, noise, tag=bank_tag,
                                        transpose=transpose)


def blend_shuffle(x, bias, block_perm, *, block=128, activation="relu"):
    """Blocked OBU shuffle + bias + activation over the last axis of x
    (any leading shape); ``bias`` may be None."""
    lead = x.shape[:-1]
    y = _blend.blend_shuffle(x.reshape(-1, x.shape[-1]).contiguous(), bias,
                             block_perm, block=block, activation=activation)
    return y.reshape(*lead, x.shape[-1])


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
