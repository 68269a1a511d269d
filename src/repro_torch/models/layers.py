"""Primitive layers: RMS and layer norms, RoPE, the SwiGLU and gelu MLPs,
embeddings and the linear adapters (port of ``repro.models.layers``).

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
def init_norm(d: int, device, lead=(), kind: str = "rms"):
    shape = tuple(lead) + (d,)
    p = {"scale": torch.ones(shape, device=device)}
    if kind != "rms":
        p["bias"] = torch.zeros(shape, device=device)
    return p


def apply_norm(p, x, kind: str = "rms", eps: float = 1e-5):
    """RMSNorm, or (``kind="layer"``) layer norm with the population
    variance; float32 statistics either way."""
    xf = x.to(torch.float32)
    if kind == "rms":
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"]
    else:
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, correction=0)
        y = (xf - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
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
def init_mlp(d_model: int, d_ff: int, generator, device, lead=(),
             act: str = "swiglu"):
    if act != "swiglu":
        return {"w_up": dense_init((d_model, d_ff), generator, device,
                                   lead=lead),
                "w_down": dense_init((d_ff, d_model), generator, device,
                                     lead=lead)}
    return {"w_gate": dense_init((d_model, d_ff), generator, device, lead=lead),
            "w_up": dense_init((d_model, d_ff), generator, device, lead=lead),
            "w_down": dense_init((d_ff, d_model), generator, device,
                                 lead=lead)}


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh approximation) in the reference's
    arithmetic: every op and constant in x's dtype, which is how XLA
    evaluates it for bf16 (torch's ``F.gelu(approximate="tanh")`` rounds
    once and lands one bf16 step off in ~43% of entries)."""
    def c(v):                   # a device fill: no host-to-device copy
        return torch.full((), v, dtype=x.dtype, device=x.device)
    inner = c(0.7978845608028654) * (x + c(0.044715) * (x * x * x))
    return x * (c(0.5) * (c(1.0) + torch.tanh(inner)))


def apply_mlp(p, x, act: str = "swiglu", transpose: bool = False,
              backend=None):
    """SwiGLU or gelu FFN with OBU-transpose support: the transposed reuse
    swaps the up- and down-projections (``W_down.T`` is a valid (d, ff)
    up-proj and vice versa); SwiGLU swaps gate and down and consumes
    ``w_up`` unchanged.  The gate's silu rides the fused MVM kernel's
    epilogue on the photonic backend; gelu stays a torch op after the MVM,
    as in the reference (fusing its tanh chain would re-round it)."""
    bk = resolve_backend(backend)
    # the pair-second (ff -> d) projection carries tp_hint="row": on a mesh
    # it runs row-parallel over the ff axis, and where ``bk.pairs`` holds
    # it takes the pair-first dots' local ff block as it is (the Megatron
    # pairing, core/backend.py)
    pair = bk.pairs(p["w_up"].shape[-1], p["w_up"])
    if act != "swiglu":
        wu, wd = p["w_up"], p["w_down"]
        if transpose:
            return bk.dot(gelu(bk.dot(x, wd, transpose=True,
                                      local_out=pair)), wu,
                          transpose=True, tp_hint="row", local_in=pair)
        return bk.dot(gelu(bk.dot(x, wu, transpose=False, local_out=pair)),
                      wd, transpose=False, tp_hint="row", local_in=pair)
    wg, wu, wd = p["w_gate"], p["w_up"], p["w_down"]
    if transpose:
        g = bk.dot(x, wd, transpose=True, activation="silu",  # (ff,d).T
                   local_out=pair)
        u = bk.dot(x, wu, transpose=False, local_out=pair)
        return bk.dot(g * u, wg, transpose=True,               # (d,ff).T
                      tp_hint="row", local_in=pair)
    g = bk.dot(x, wg, transpose=False, activation="silu", local_out=pair)
    u = bk.dot(x, wu, transpose=False, local_out=pair)
    return bk.dot(g * u, wd, transpose=False, tp_hint="row", local_in=pair)


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


def init_linear(d_in: int, d_out: int, generator, device):
    return {"w": dense_init((d_in, d_out), generator, device)}


def apply_linear(p, x, transpose: bool = False, backend=None):
    return resolve_backend(backend).dot(x, cast(p["w"], x.dtype),
                                        transpose=transpose)
