"""Mamba-2 intra-chunk SSD: plain PyTorch version and CUDA wrapper.

Port of ``repro.kernels.ssd.ssd_chunk`` (the TPU kernel).  Per (batch *
chunk, head) cell of L steps:

    cs      = cumsum(dA)
    Lmat    = exp(cs_i - cs_j)  on the lower triangle i >= j
    y_diag  = ((C B^T) * Lmat) @ x
    state   = (B * exp(cs_L - cs))^T @ x

x (b, nc, L, H, P) arrives dt-folded, dA (b, nc, H, L), B and C (b, nc, L,
H, N) head-broadcast; everything float32.  Returns y_diag (b, nc, L, H, P)
and states (b, nc, H, N, P), the reference's (N, P) state layout.  The
inter-chunk recurrence stays in ``models/ssm.py``.

The CUDA kernel is ``csrc/ssd_chunk.cu``.  It reads every input through
its strides, so B and C may be stride-0 views over the head axis (the
group broadcast of ``models/ssm.ssd_chunked``, nothing copied).  The
wrapper takes the plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import ref as _ref

MAX_L = 4096                 # the kernel's longest chunk (shared memory)
MAX_P = 64                   # the kernel's widest head (one register tile)
_MAX_GRID_YZ = 65535

# kernel launches on the CUDA path (the plain CPU path does not count)
launches = 0


def _check(x, dA, B, C):
    if x.ndim != 5:
        raise ValueError(f"need x (b, nc, L, H, P), got {tuple(x.shape)}")
    b, nc, L, H, P = x.shape
    if tuple(dA.shape) != (b, nc, H, L):
        raise ValueError(f"dA {tuple(dA.shape)} != {(b, nc, H, L)}")
    if B.ndim != 5 or tuple(B.shape[:4]) != (b, nc, L, H) \
            or tuple(C.shape) != tuple(B.shape):
        raise ValueError(f"B {tuple(B.shape)} and C {tuple(C.shape)} must be "
                         f"(b, nc, L, H, N) = {(b, nc, L, H)} + (N,)")
    return b, nc, L, H, P, B.shape[-1]


def ssd_chunk_plain(x, dA, B, C):
    """Plain version (any device): the oracle's algebra
    (``kernels/ref.ssd_chunk_ref``) in float32.  B and C are made
    contiguous first, so a stride-0 view gives the bits of a materialised
    copy."""
    _check(x, dA, B, C)
    return _ref.ssd_chunk_ref(x, dA, B.contiguous(), C.contiguous())


@functools.lru_cache(maxsize=1)
def _library():
    lib = _build.load("ssd_chunk")
    fn = lib.ssd_chunk
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p, p, p]
    fn.restype = i
    return lib, fn


def _launch(x, dA, B, C, b, nc, L, H, P, N):
    global launches
    for t in (x, dA, B, C):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_chunk takes float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError("all operands must be on the same CUDA device")
    if not (1 <= L <= MAX_L and 1 <= P <= MAX_P and N >= 1):
        raise ValueError(f"ssd_chunk needs 1 <= L <= {MAX_L}, "
                         f"1 <= P <= {MAX_P} and N >= 1; got L={L} P={P} "
                         f"N={N}")
    if H > _MAX_GRID_YZ or b * nc > _MAX_GRID_YZ:
        raise ValueError(f"H={H} and b*nc={b * nc} must be <= {_MAX_GRID_YZ}")
    strides = (ctypes.c_longlong * 19)(
        *x.stride(), *dA.stride(), *B.stride(), *C.stride())
    y = torch.empty((b, nc, L, H, P), dtype=torch.float32, device=x.device)
    st = torch.empty((b, nc, H, N, P), dtype=torch.float32, device=x.device)
    lib, fn = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), dA.data_ptr(), B.data_ptr(), C.data_ptr(),
            ctypes.cast(strides, ctypes.c_void_p), b, nc, L, H, P, N,
            y.data_ptr(), st.data_ptr(), stream)
    _build.check(lib, "ssd_chunk_error_string", rc, "ssd_chunk")
    launches += 1
    return y, st


def ssd_chunk(x, dA, B, C):
    """Intra-chunk SSD: x (b, nc, L, H, P) dt-folded, dA (b, nc, H, L),
    B/C (b, nc, L, H, N) head-broadcast (any strides), float32.  Returns
    y_diag (b, nc, L, H, P) and states (b, nc, H, N, P), float32.  CPU
    tensors take the plain version; CUDA tensors launch the kernel (L up to
    ``MAX_L``, P up to ``MAX_P``; ValueError beyond)."""
    b, nc, L, H, P, N = _check(x, dA, B, C)
    if x.device.type == "cpu":
        return ssd_chunk_plain(x, dA, B, C)
    return _launch(x, dA, B, C, b, nc, L, H, P, N)
