"""The photonic W8A8 MVMs: plain PyTorch versions and CUDA wrappers.

Ports of ``repro.kernels.photonic_mvm``:

  * ``photonic_mvm_fused`` (the TPU megakernel): quantize -> offset-
    decomposed MVM -> bias -> activation -> blocked output shuffle, in one
    kernel (``csrc/photonic_mvm_fused.cu``);
  * ``photonic_mvm`` / ``photonic_mvm_t`` (the split pipeline's MVM, both
    OBU orientations): int8 activations and an A8 scale in, the float32
    MVM out (``csrc/photonic_mvm_split.cu``, one library, both
    orientations).  Quantization and the epilogue are separate passes
    (``kernels/ops.py``, ``kernels/blend.py``).

Both versions compute the same function:

    q = clamp(round_half_even(x / s_x), -128, 127)    # divide in x's dtype
    y = 2 (q @ W' - sum_k(q) / 2) s_x s_w,  W' = wq/254 + 1/2   (paper eq. 6)
      = (q @ wq) s_x s_w / 127
    y = act(y.to(x.dtype)[:, blocks permuted] + bias)  # blend epilogue

The plain versions keep the reference kernels' float32 arithmetic (the
offset decomposition above, first line), so on the CPU it tracks the JAX
reference closely enough that no A8 rounding boundary flips between them
on the test models.  The CUDA kernels compute the second line: an exact
int32 product (``dp4a``) rescaled once, with one rescale expression in
both libraries, so the split output cast to x's dtype equals the fused
output.  Kernel and plain version differ only by the float32 rounding of
the decomposition; ``chip_smoke.py`` holds them together within one bf16
step (rel-L2 <= 2**-8).  The wrappers take the plain versions only for CPU
tensors; for CUDA tensors they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.kernels import build as _build

ACTIVATIONS = ("none", "relu", "silu")
_ACT_CODE = {"none": 0, "relu": 1, "silu": 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches on the CUDA path (the plain CPU path does not count):
# photonic_mvm_fused, photonic_mvm and photonic_mvm_t
launches = 0
launches_mvm = 0
launches_mvm_t = 0

QMAX = 127.0          # W8A8: the kernel's int8 grid
BN, BK = 128, 64      # kernel output-column tile and reduction stage
_SMS_H100 = 132


def apply_activation(y: torch.Tensor, activation: str) -> torch.Tensor:
    """The epilogue activations in the reference's arithmetic: silu is
    ``y * (1 / (1 + exp(-y)))`` with every op rounded to y's dtype, which is
    how XLA evaluates ``y * jax.nn.sigmoid(y)`` for bf16 (torch's fused
    ``sigmoid`` rounds once and lands one bf16 step off in ~30% of
    entries)."""
    if activation in (None, "none"):
        return y
    if activation == "relu":
        return torch.clamp(y, min=0.0)
    if activation == "silu":
        return y * (1.0 / (1.0 + torch.exp(-y)))
    raise ValueError(f"unsupported fused activation {activation!r}; "
                     f"have {ACTIVATIONS}")


def out_block_index(block_perm, block: int, N: int) -> np.ndarray:
    """Inverse of a block-level output permutation: computed column block
    ``j`` lands at output block ``inv[j]`` (output block ``q`` carries
    computed block ``block_perm[q]``)."""
    perm = np.asarray(block_perm, dtype=np.int64)
    nblk = perm.shape[0]
    if sorted(perm.tolist()) != list(range(nblk)):
        raise ValueError("block_perm must be a permutation")
    if block <= 0:
        raise ValueError("block_perm needs a positive block size")
    if nblk * block != N:
        raise ValueError(f"block_perm covers {nblk * block} channels, "
                         f"output has {N}")
    return np.argsort(perm).astype(np.int32)


def launch_plan(M: int, K: int, N: int, sms: int = _SMS_H100) -> tuple:
    """(bm, k_per_split) for an (M, K) x (K, N) launch.  Decode widths
    (M <= 16) take the 16-row tile; K splits until the grid holds about two
    blocks per SM (integer partials, so the split never changes results)."""
    bm = 16 if M <= 16 else 128
    tiles = math.ceil(M / bm) * math.ceil(N / BN)
    ksteps = max(1, math.ceil(K / BK))
    want = max(1, min(ksteps, math.ceil(2 * sms / tiles)))
    k_per_split = math.ceil(ksteps / want) * BK
    return bm, k_per_split


def _offset_mvm(xq, wq, x_scale, w_scale, transpose):
    """The reference kernels' float32 arithmetic (``_kernel``/``_kernel_t``):
    ``2 (q @ W' - sum(q)/2) s_x s_w`` with ``W' = wq/254 + 1/2``; ``xq``
    holds the A8 grid values (any dtype), ``wq`` is (K, N), or (N, K) with
    ``transpose``.  Shared by every plain version, so the split and fused
    plain paths agree bit for bit."""
    xf = xq.to(torch.float32)
    w = wq.to(torch.float32)
    w_prime = (w.T if transpose else w) / (2.0 * QMAX) + 0.5
    acc = xf @ w_prime
    xsum = xf.sum(dim=1, keepdim=True)                # the W0 offset row
    return 2.0 * (acc - 0.5 * xsum) * (x_scale * w_scale)


def photonic_mvm_fused_plain(x, wq, x_scale, w_scale, *, bias=None,
                             transpose=False, activation="none",
                             block_perm=None, block=0):
    """Plain PyTorch version of the fused kernel (any device), in the
    reference kernel's float32 arithmetic (``_kernel_fused``)."""
    xq = torch.clamp(torch.round(x / x_scale.to(x.dtype)), -QMAX - 1.0,
                     QMAX)
    y = _offset_mvm(xq, wq, x_scale, w_scale, transpose).to(x.dtype)
    if block_perm is not None:
        N = y.shape[-1]
        out_block_index(block_perm, block, N)          # validate
        perm = np.asarray(block_perm)
        idx = (perm[:, None] * block + np.arange(block)[None, :]).reshape(-1)
        y = y[:, torch.as_tensor(idx, device=y.device)]
    if bias is not None:
        y = y + bias.to(y.dtype)
    return apply_activation(y, activation)


def _check_operands(x, wq, x_scale, w_scale, bias, transpose):
    if x.ndim != 2 or wq.ndim != 2:
        raise ValueError(f"need x (M, K) and wq 2-D, got {tuple(x.shape)} "
                         f"and {tuple(wq.shape)}")
    M, K = x.shape
    N, K2 = wq.shape if transpose else (wq.shape[1], wq.shape[0])
    if K != K2:
        raise ValueError(f"reduction dims differ: x {tuple(x.shape)}, "
                         f"wq {tuple(wq.shape)}, transpose={transpose}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x dtype {x.dtype} not supported (float32/bf16)")
    if wq.dtype != torch.int8:
        raise TypeError(f"wq must be int8, got {wq.dtype}")
    if x_scale.numel() != 1 or x_scale.dtype != torch.float32:
        raise TypeError("x_scale must be one float32 value")
    if tuple(w_scale.shape) != (N,) or w_scale.dtype != torch.float32:
        raise ValueError(f"w_scale must be float32 ({N},), got "
                         f"{w_scale.dtype} {tuple(w_scale.shape)}")
    if bias is not None and (tuple(bias.shape) != (N,)
                             or bias.dtype != x.dtype):
        raise ValueError(f"bias must be ({N},) {x.dtype}")
    return M, K, N


@functools.lru_cache(maxsize=1)
def _library():
    """The built library and its launcher with C argument types declared
    (pointers and the stream as void*, so ctypes never truncates them)."""
    lib = _build.load("photonic_mvm_fused")
    fn = lib.photonic_mvm_fused
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, p, i, p, p, p, p, i, i, i, i, i, i, i, p, p, p]
    fn.restype = i
    return lib, fn


def _launch(x, wq, x_scale, w_scale, bias, transpose, activation,
            block_perm, block):
    global launches
    M, K, N = _check_operands(x, wq, x_scale, w_scale, bias, transpose)
    tensors = [x, wq, x_scale, w_scale] + ([bias] if bias is not None else [])
    for t in tensors:
        if t.device != x.device:
            raise ValueError("all operands must be on the same CUDA device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if activation not in _ACT_CODE:
        raise ValueError(f"unsupported fused activation {activation!r}")
    inv = None
    if block_perm is not None:
        inv = torch.as_tensor(out_block_index(block_perm, block, N),
                              device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    bm, kps = launch_plan(M, K, N, sms)
    splits = math.ceil(K / kps)
    work = (torch.empty((splits, M, N), dtype=torch.int32, device=x.device)
            if splits > 1 else None)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    lib, fn = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), _DTYPE_CODE[x.dtype], wq.data_ptr(), int(transpose),
            x_scale.data_ptr(), w_scale.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            inv.data_ptr() if inv is not None else None,
            int(block), _ACT_CODE[activation], M, K, N, bm, kps,
            work.data_ptr() if work is not None else None, out.data_ptr(),
            stream)
    _build.check(lib, "photonic_mvm_error_string", rc, "photonic_mvm_fused")
    launches += 1
    return out


def photonic_mvm_fused(x, wq, x_scale, w_scale, *, bias=None,
                       transpose=False, activation="none", block_perm=None,
                       block=0):
    """quantize -> MVM -> bias -> activation -> blocked output shuffle.

    x: (M, K) float32/bf16; wq: int8 (K, N) per-column quantized, or (N, K)
    per-row quantized with ``transpose=True``; x_scale: the float32 A8 scale
    (``core.photonic.a8_scale``); w_scale: (N,) float32; bias: optional (N,)
    indexed by OUTPUT position; block_perm: output block ``q`` carries
    computed block ``block_perm[q]`` (blocks of ``block`` channels).
    Returns (M, N) in x's dtype.  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if x.device.type == "cpu":
        return photonic_mvm_fused_plain(
            x, wq, x_scale, w_scale, bias=bias, transpose=transpose,
            activation=activation, block_perm=block_perm, block=block)
    return _launch(x, wq, x_scale.reshape(()), w_scale, bias, transpose,
                   activation, block_perm, block)


# -------------------------------------------------------------------------
# split pipeline: photonic_mvm / photonic_mvm_t
# -------------------------------------------------------------------------
def photonic_mvm_plain(xq, wq, x_scale, w_scale):
    """Plain version of ``photonic_mvm``: xq int8 (M, K) @ wq int8 (K, N),
    per-column w_scale (N,); float32 (M, N), any device."""
    return _offset_mvm(xq, wq, x_scale, w_scale.reshape(1, -1), False)


def photonic_mvm_t_plain(xq, wq, x_scale, w_scale):
    """Plain version of ``photonic_mvm_t``: xq int8 (M, K) @ wq int8
    (N, K).T, per-row w_scale (N,); float32 (M, N), any device."""
    return _offset_mvm(xq, wq, x_scale, w_scale.reshape(1, -1), True)


@functools.lru_cache(maxsize=1)
def _split_library():
    lib = _build.load("photonic_mvm_split")
    fn = lib.photonic_mvm_split
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, p, p, i, i, i, i, i, p, p, p]
    fn.restype = i
    return lib, fn


def _launch_split(xq, wq, x_scale, w_scale, transpose):
    if xq.ndim != 2 or wq.ndim != 2:
        raise ValueError(f"need xq (M, K) and wq 2-D, got {tuple(xq.shape)} "
                         f"and {tuple(wq.shape)}")
    M, K = xq.shape
    N, K2 = wq.shape if transpose else (wq.shape[1], wq.shape[0])
    if K != K2:
        raise ValueError(f"reduction dims differ: xq {tuple(xq.shape)}, "
                         f"wq {tuple(wq.shape)}, transpose={transpose}")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"xq and wq must be int8, got {xq.dtype}/{wq.dtype}")
    if x_scale.numel() != 1 or x_scale.dtype != torch.float32:
        raise TypeError("x_scale must be one float32 value")
    if tuple(w_scale.shape) != (N,) or w_scale.dtype != torch.float32:
        raise ValueError(f"w_scale must be float32 ({N},), got "
                         f"{w_scale.dtype} {tuple(w_scale.shape)}")
    for t in (xq, wq, x_scale, w_scale):
        if t.device != xq.device:
            raise ValueError("all operands must be on the same CUDA device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    sms = torch.cuda.get_device_properties(xq.device).multi_processor_count
    bm, kps = launch_plan(M, K, N, sms)
    splits = math.ceil(K / kps)
    work = (torch.empty((splits, M, N), dtype=torch.int32, device=xq.device)
            if splits > 1 else None)
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    lib, fn = _split_library()
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    rc = fn(xq.data_ptr(), wq.data_ptr(), int(transpose), x_scale.data_ptr(),
            w_scale.data_ptr(), M, K, N, bm, kps,
            work.data_ptr() if work is not None else None, out.data_ptr(),
            stream)
    _build.check(lib, "photonic_mvm_split_error_string", rc,
                 "photonic_mvm_t" if transpose else "photonic_mvm")
    return out


def photonic_mvm(xq, wq, x_scale, w_scale):
    """Split W8A8 MVM: xq int8 (M, K), wq int8 (K, N) per-column quantized,
    x_scale the float32 A8 scale, w_scale (N,) float32.  Returns float32
    (M, N).  CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    global launches_mvm
    if xq.device.type == "cpu":
        return photonic_mvm_plain(xq, wq, x_scale, w_scale)
    out = _launch_split(xq, wq, x_scale.reshape(()), w_scale, False)
    launches_mvm += 1
    return out


def photonic_mvm_t(xq, wq, x_scale, w_scale):
    """``xq @ wq.T`` for wq int8 (N, K) per-row quantized (the OBU
    transpose), w_scale (N,).  Returns float32 (M, N).  CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    global launches_mvm_t
    if xq.device.type == "cpu":
        return photonic_mvm_t_plain(xq, wq, x_scale, w_scale)
    out = _launch_split(xq, wq, x_scale.reshape(()), w_scale, True)
    launches_mvm_t += 1
    return out
