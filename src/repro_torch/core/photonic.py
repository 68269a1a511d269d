"""MRR-crossbar simulator and A8 quantization (paper §3.4, §4).

Port of ``repro.core.photonic``.  The symmetric quantizer and the A8 scale
that the fused MVM kernel's prologue quantizes against; the scale's
derivation matches the reference exactly: the abs-max and the divide by
``qmax`` run in the input dtype (a bf16 activation gets a bf16 scale), and
only then is the scale widened to float32, so the float32 scale is the
exact up-cast of the input-dtype scale.

The simulator (:func:`photonic_matmul`) models the photonic MVM end to
end: weights normalized per output channel to [-1, 1], W8 quantization,
the offset decomposition of paper eq. 6 (``W' = W/2 + W0`` with the
uniform ``W0 = 0.5``, recovered as ``W x = 2 (W' x - W0 x)``), A8
activations and, optionally, Gaussian write noise on every programmed
ring.  The noise draws from a ``torch.Generator`` the caller passes (the
reference's ``noise_key``), so a noisy output is held by its properties,
not by value.  The tiling helpers count the ``tile x tile`` crossbars a
weight occupies.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class PhotonicConfig:
    tile: int = 8              # MRR crossbar is tile x tile (paper: 8x8)
    weight_bits: int = 8       # W8
    act_bits: int = 8          # A8
    write_noise_sigma: float = 0.0   # std of programming error, in weight LSBs
    offset_value: float = 0.5  # the uniform W0


_QMAX: dict = {}


def _divisor(amax: torch.Tensor, qmax: int):
    """``qmax`` as the divisor of ``amax``: the Python number on the CPU and
    on meta tensors (the dry-run: only the shape and dtype exist), a 0-d
    tensor of ``amax``'s dtype on the card.  PyTorch's CUDA ``div``
    computes ``tensor / python_number`` as a multiply by the reciprocal,
    one ulp off the true division of the CPU and the reference on some
    scales; a device tensor divides truly.  One tensor per (device, dtype,
    qmax), kept only when made outside a CUDA graph capture, so a replayed
    step reads it and adds no kernel."""
    if amax.device.type in ("cpu", "meta"):
        return qmax
    key = (amax.device, amax.dtype, qmax)
    d = _QMAX.get(key)
    if d is None:
        d = torch.full((), qmax, dtype=amax.dtype, device=amax.device)
        if not torch.cuda.is_current_stream_capturing():
            _QMAX[key] = d
    return d


def quantize_symmetric(x: torch.Tensor, bits: int, axis=None):
    """Symmetric uniform quantization; returns (q int8, scale float32).

    ``axis=None`` -> per-tensor scale; otherwise per-slice along ``axis``."""
    qmax = 2 ** (bits - 1) - 1
    if axis is None:
        amax = x.abs().amax()
    else:
        amax = x.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / _divisor(amax, qmax)
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
    return (torch.clamp(amax, min=1e-8)
            / _divisor(amax, qmax)).to(torch.float32)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


# ------------------------------------------------- offset decomposition (eq 6)
def offset_decompose(w_norm: torch.Tensor, offset: float = 0.5):
    """``w_norm`` in [-1,1] -> non-negative ``w_prime`` in [0,1] (eq. 6)."""
    return 0.5 * w_norm + offset


def offset_recompose_mvm(wp_x: torch.Tensor, x_sum: torch.Tensor,
                         offset: float = 0.5) -> torch.Tensor:
    """Recover full-range MVM: ``W x = 2 (W' x - offset * sum(x))``."""
    return 2.0 * (wp_x - offset * x_sum)


# ------------------------------------------------------------------ simulator
def normalize_weights(w: torch.Tensor):
    """Per-output-channel normalization of ``w`` (k, n) into [-1, 1]."""
    wmax = torch.clamp(w.abs().amax(dim=0, keepdim=True), min=1e-8)
    return w / wmax, wmax


def mrr_tiles(rows: int, cols: int, tile: int) -> int:
    """Number of tile x tile crossbars a (rows, cols) weight occupies."""
    return int(math.ceil(rows / tile) * math.ceil(cols / tile))


def photonic_matmul(x: torch.Tensor, w: torch.Tensor,
                    cfg: PhotonicConfig = PhotonicConfig(),
                    generator: torch.Generator | None = None
                    ) -> torch.Tensor:
    """Simulated photonic ``x @ w`` for x:(..., k), w:(k, n): quantize ->
    offset-shift to non-negative MRR transmissions -> optical MVM of ``W'``
    plus the shared ``W0`` row -> BPD subtraction -> TIA rescale.  With
    ``write_noise_sigma == 0`` (or no ``generator``) this equals
    :func:`w8a8_matmul_reference`; otherwise every quantized weight gets
    N(0, sigma) LSBs of write noise drawn from ``generator``."""
    w_norm, wmax = normalize_weights(w)
    qmax = 2 ** (cfg.weight_bits - 1) - 1
    wq = torch.round(w_norm * qmax) / qmax                   # quantized, [-1,1]
    if cfg.write_noise_sigma > 0.0 and generator is not None:
        noise = torch.randn(wq.shape, generator=generator, dtype=wq.dtype,
                            device=wq.device) * (cfg.write_noise_sigma / qmax)
        wq = torch.clamp(wq + noise, -1.0, 1.0)
    w_prime = offset_decompose(wq, cfg.offset_value)         # [0, 1] MRR domain
    xq, xscale = quantize_symmetric(x, cfg.act_bits)
    xf = dequantize(xq, xscale)
    wp_x = torch.matmul(xf, w_prime.to(torch.float32))
    x_sum = xf.sum(dim=-1, keepdim=True)
    y = offset_recompose_mvm(wp_x, x_sum, cfg.offset_value)
    if x.ndim == 1:
        return (y * wmax.reshape(1, -1)).to(x.dtype)
    return (y * wmax).to(x.dtype)


def w8a8_matmul_reference(x: torch.Tensor, w: torch.Tensor,
                          cfg: PhotonicConfig = PhotonicConfig()
                          ) -> torch.Tensor:
    """Plain W8A8 matmul (no photonic dataflow): the equality target of
    :func:`photonic_matmul` with zero write noise."""
    w_norm, wmax = normalize_weights(w)
    qmax = 2 ** (cfg.weight_bits - 1) - 1
    wq = torch.round(w_norm * qmax) / qmax * wmax
    xq, xscale = quantize_symmetric(x, cfg.act_bits)
    xf = dequantize(xq, xscale)
    return torch.matmul(xf, wq.to(torch.float32)).to(x.dtype)


def mrr_write_count(w_shape, tile: int) -> int:
    """Individual MRR programmings needed to load one (k, n) weight."""
    k, n = w_shape
    return int(k * n)  # every element is one ring; tiling determines latency


def crossbar_utilization(w_shape, tile: int) -> float:
    k, n = w_shape
    return k * n / (mrr_tiles(k, n, tile) * tile * tile)
