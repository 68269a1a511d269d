"""Primitive layers: norms, RoPE, the SwiGLU MLP, embeddings (port of
``repro.models.layers``).

Parameters are nested dicts of tensors with the reference's keys.  Weight
matmuls route through the execution backend (``core/backend.py``), and a
matmul weight may be a fp tensor or a prepared bank (``PreparedTensor``);
``Backend.dot`` dispatches on the leaf type.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.backend import resolve as resolve_backend
from repro_torch.core.prepared import PreparedTensor


def cast(w, dtype):
    """``w.astype(dtype)`` of the reference: a no-op for a prepared bank
    (its readout gain sets the output dtype)."""
    return w if isinstance(w, PreparedTensor) else w.to(dtype)


def dense_init(shape, generator: torch.Generator, device,
               scale=None, lead=()) -> torch.Tensor:
    """N(0, 1) * scale with the reference's default scale 1/sqrt(shape[0])
    (``_dense_init``).  ``lead`` prepends stacked copies (the PRM R axis)
    without changing the scale, as the reference's vmapped init does."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    w = torch.randn(tuple(lead) + tuple(shape), generator=generator,
                    dtype=torch.float32, device=device)
    return w * scale


# ----------------------------------------------------------------- norms
def init_norm(d: int, device, lead=()):
    return {"scale": torch.ones(tuple(lead) + (d,), device=device)}


def apply_norm(p, x, kind: str = "rms", eps: float = 1e-5):
    xf = x.to(torch.float32)
    if kind != "rms":
        raise NotImplementedError("layer norm belongs to a later slice")
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"]
    return y.to(x.dtype)


# ------------------------------------------------------------------ RoPE
def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables for ``positions`` (any shape) -> (..., head_dim/2)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / torch.pow(float(theta), exps)     # no host-to-device copy
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: (B, S, H, hd); cos/sin: (B, S, hd/2) or (S, hd/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.ndim == 2:          # (S, half) -> broadcast over batch and heads
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:                      # (B, S, half)
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ------------------------------------------------------------------- MLP
def init_mlp(d_model: int, d_ff: int, generator, device, lead=()):
    return {"w_gate": dense_init((d_model, d_ff), generator, device, lead=lead),
            "w_up": dense_init((d_model, d_ff), generator, device, lead=lead),
            "w_down": dense_init((d_ff, d_model), generator, device,
                                 lead=lead)}


def apply_mlp(p, x, act: str = "swiglu", transpose: bool = False,
              backend=None):
    """SwiGLU FFN with OBU-transpose support: the transposed reuse swaps
    the gate and down projections (``W_down.T`` is a valid (d, ff) up-proj
    and vice versa) and consumes ``w_up`` unchanged.  The gate's silu rides
    the fused MVM kernel's epilogue on the photonic backend."""
    if act != "swiglu":
        raise NotImplementedError("the gelu MLP belongs to a later slice")
    bk = resolve_backend(backend)
    wg, wu, wd = p["w_gate"], p["w_up"], p["w_down"]
    if transpose:
        g = bk.dot(x, wd, transpose=True, activation="silu")  # (ff,d).T
        u = bk.dot(x, wu, transpose=False)
        return bk.dot(g * u, wg, transpose=True)               # (d,ff).T
    g = bk.dot(x, wg, transpose=False, activation="silu")
    u = bk.dot(x, wu, transpose=False)
    return bk.dot(g * u, wd, transpose=False)


# ------------------------------------------------------------- embeddings
def init_embedding(vocab: int, d_model: int, generator, device):
    return {"table": dense_init((vocab, d_model), generator, device,
                                scale=0.02)}


def embed(p, tokens, dtype):
    return p["table"].to(dtype)[tokens]


def init_unembed(d_model: int, vocab: int, generator, device):
    return {"w": dense_init((d_model, vocab), generator, device)}


def unembed(p, x, backend=None):
    return resolve_backend(backend).dot(x, cast(p["w"], x.dtype),
                                        transpose=False)
