"""A8 activation quantization of the photonic MVM path (paper §3.4, §4).

Partial port of ``repro.core.photonic``: the per-tensor symmetric
quantizer and the A8 scale that the fused MVM kernel's prologue quantizes
against.  The scale's derivation matches the reference exactly: the abs-max
and the divide by ``qmax`` run in the input dtype (a bf16 activation gets a
bf16 scale), and only then is the scale widened to float32, so the float32
scale is the exact up-cast of the input-dtype scale.
"""
from __future__ import annotations

import torch


def quantize_symmetric(x: torch.Tensor, bits: int, axis=None):
    """Symmetric uniform quantization; returns (q int8, scale float32).

    ``axis=None`` -> per-tensor scale; otherwise per-slice along ``axis``."""
    qmax = 2 ** (bits - 1) - 1
    if axis is None:
        amax = x.abs().amax()
    else:
        amax = x.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / qmax
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax)
    return q.to(torch.int8), scale.to(torch.float32)


def a8_scale(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Per-tensor A8 scale of ``x`` without materializing the int8 image.
    The abs-max pre-pass stays outside the MVM kernel, as in the
    reference (an XLA reduce outside Pallas there)."""
    return a8_scale_from_amax(x.abs().amax(), bits=bits)


def a8_scale_from_amax(amax: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """The amax -> scale half of :func:`a8_scale` (0-d float32 tensor)."""
    qmax = 2 ** (bits - 1) - 1
    return (torch.clamp(amax, min=1e-8) / qmax).to(torch.float32)
