"""The photonic W8A8 MVMs: plain PyTorch versions and CUDA wrappers.

Ports of ``repro.kernels.photonic_mvm``:

  * ``photonic_mvm_fused`` (the TPU megakernel): quantize -> offset-
    decomposed MVM -> bias -> activation -> blocked output shuffle
    (``csrc/photonic_mvm_fused.cu``), in two regimes that ``launch_plan``
    picks from M: decode widths (M <= ``GEMV_MAX_M``) stream the bank once
    with ``dp4a`` from registers, quantizing in the prologue; prefill
    widths quantize x once into an int8 workspace, then run the product on
    the s8 tensor cores (``csrc/photonic_mvm_mma.cuh``);
  * ``photonic_mvm`` / ``photonic_mvm_t`` (the split pipeline's MVM, both
    OBU orientations): int8 activations and an A8 scale in, the float32
    MVM out (``csrc/photonic_mvm_split.cu``, one library, one launch per
    call).  Both run the fused kernel's two regimes on their int8 rows
    (``split_kn_launch_plan``, ``split_t_launch_plan``): the decode stream
    of their orientation, or the s8 tensor cores.  Quantization and the
    epilogue are separate passes (``kernels/ops.py``, ``kernels/blend.py``);
  * ``photonic_mvm_resident`` (the PRM-blended MoE experts' MVM): T int8
    activation streams, each with its own A8 scale, through ONE programmed
    (K, N) bank (``csrc/photonic_mvm_resident.cu``): the T * M rows as one
    matrix on the s8 tensor cores, any K (``resident_launch_plan``).

Both versions compute the same function:

    q = clamp(round_half_even(x / s_x), -128, 127)    # divide in x's dtype
    y = 2 (q @ W' - sum_k(q) / 2) s_x s_w,  W' = wq/254 + 1/2   (paper eq. 6)
      = (q @ wq) s_x s_w / 127
    y = act(y.to(x.dtype)[:, blocks permuted] + bias)  # blend epilogue

The plain versions keep the reference kernels' float32 arithmetic (the
offset decomposition above, first line), so on the CPU it tracks the JAX
reference closely enough that no A8 rounding boundary flips between them
on the test models.  The CUDA kernels compute the second line: an exact
int32 product (``dp4a`` or s8 tensor cores) rescaled once, with one
rescale expression in both libraries, so the split output cast to x's
dtype equals the fused
output.  Kernel and plain version differ only by the float32 rounding of
the decomposition; ``chip_smoke.py`` holds them together within one bf16
step (rel-L2 <= 2**-8).  The wrappers take the plain versions only for CPU
tensors; for CUDA tensors they launch the kernel or raise; for meta
tensors (the dry-run) they plan a call (``kernels/planned.py``).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import planned as _planned

ACTIVATIONS = ("none", "relu", "silu")
_ACT_CODE = {"none": 0, "relu": 1, "silu": 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches on the CUDA path (the plain CPU path does not count):
# photonic_mvm_fused (``launches_gemv`` of them in the decode regime),
# photonic_mvm, photonic_mvm_t and photonic_mvm_resident
launches = 0
launches_gemv = 0
launches_mvm = 0
launches_mvm_t = 0
launches_resident = 0

QMAX = 127.0          # W8A8: the kernel's int8 grid
_SMS_H100 = 132
# the fused kernel (``csrc/photonic_mvm_fused.cu``, the same constants
# there): decode regime up to GEMV_MAX_M rows; its blocks cover GEMV_COLS
# columns of a (K, N) bank or GEMV_T_COLS channels of an (N, K) one and
# hold rows x k_per_split <= GEMV_XS_BYTES quantized activations
GEMV_MAX_M = 8
GEMV_COLS, GEMV_T_COLS = 128, 64
GEMV_XS_BYTES = 32768
# decode blocks resident per SM (the kernels' launch bounds): 4 and 3 for
# the (K, N) bank at rows = 4 and 8, 2 for the (N, K) bank
GEMV_BLOCKS_PER_SM = {(False, 4): 4, (False, 8): 3, (True, 4): 2,
                      (True, 8): 2}
# the tensor-core regime's block tile (``pmma::BM, BN, BK``)
MMA_BM, MMA_BN, MMA_BK = 128, 128, 128
# a split tensor-core call keeps its int32 partials within this many bytes
# (they stay in the 50 MB L2 until the last block of a tile adds them)
MMA_PART_BYTES = 8 << 20
# the resident kernel splits the K of a full row tile from this depth on,
# each split keeping at least RESIDENT_SPLIT_MIN_KTILES k-tiles: granite's
# 4-8 k-tiles ran fastest unsplit, 33 k-tiles over 4 tiles fastest at 7
# splits (not 33), jamba's w_down (112 over 32 tiles) at 8 (chip_smoke
# ``by_splits``, PERF.md); a depth between 8 and 33 is unmeasured
RESIDENT_SPLIT_KTILES = 16
RESIDENT_SPLIT_MIN_KTILES = 4


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


class Plan(NamedTuple):
    """How a planned MVM kernel (``photonic_mvm_fused``, ``photonic_mvm``,
    ``photonic_mvm_t``, ``photonic_mvm_resident``) runs one (M, K) x
    (K, N) call.  ``regime`` "gemv" (decode widths, ``rows`` = 4 or 8 >=
    M) or "mma" (tensor cores, ``rows`` = the 128-row tile); ``tiles``
    output tiles, K split into ``splits`` ranges of ``k_per_split``;
    workspaces: the int8 A8 grid of x (``xq_bytes``, the fused kernel's
    mma regime only) and the int32 split partials (``part_bytes``, splits
    > 1 only)."""
    regime: str
    rows: int
    tiles: int
    k_per_split: int
    splits: int
    xq_bytes: int
    part_bytes: int


def _rounded(n, unit):
    return math.ceil(n / unit) * unit


def _mma_plan(M, K, N, sms, xq_bytes, min_ktiles=2, splits=None) -> Plan:
    """128 x 128 tensor-core tiles; K splits only while the tiles fill
    less than one wave, each split keeping ``min_ktiles`` k-tiles and all
    partials within MMA_PART_BYTES.  ``splits`` asks for that many K
    ranges instead (fewer where K has fewer k-tiles)."""
    tiles = math.ceil(M / MMA_BM) * math.ceil(N / MMA_BN)
    ktiles = math.ceil(K / MMA_BK)
    if splits is None:
        splits = 1
        if tiles < sms:
            splits = max(1, min(math.ceil(2 * sms / tiles),
                                ktiles // min_ktiles,
                                MMA_PART_BYTES // (4 * M * N)))
    splits = min(splits, ktiles)
    kps = math.ceil(ktiles / splits) * MMA_BK
    splits = math.ceil(K / kps)
    return Plan("mma", MMA_BM, tiles, kps, splits, xq_bytes,
                4 * splits * M * N if splits > 1 else 0)


def launch_plan(M: int, K: int, N: int, transpose: bool = False,
                sms: int = _SMS_H100) -> Plan:
    """The fused kernel's plan for an (M, K) x (K, N) call.  Decode widths
    stream the bank: K splits while the blocks fit one wave at
    GEMV_BLOCKS_PER_SM and a block's quantized rows fit GEMV_XS_BYTES (an
    (N, K) split keeps whole 512-byte row segments: one 16-byte load per
    lane).  Prefill widths take 128 x 128 tensor-core tiles
    (``_mma_plan``).  The last block of a tile adds the integer partials:
    the split never changes results."""
    if M <= GEMV_MAX_M:
        rows = 4 if M <= 4 else 8
        tiles = math.ceil(N / (GEMV_T_COLS if transpose else GEMV_COLS))
        unit = 512 if transpose and K >= 512 else 64
        per_sm = GEMV_BLOCKS_PER_SM[(bool(transpose), rows)]
        splits = max(1, min((per_sm * sms) // tiles,
                            K // (512 if transpose else 128), K // (8 * M)))
        kps = min(_rounded(math.ceil(K / splits), unit),
                  GEMV_XS_BYTES // rows)
        splits = math.ceil(K / kps)
        return Plan("gemv", rows, tiles, kps, splits, 0,
                    4 * splits * M * N if splits > 1 else 0)
    return _mma_plan(M, K, N, sms, M * _rounded(K, 16))


def split_kn_launch_plan(M: int, K: int, N: int,
                         sms: int = _SMS_H100) -> Plan:
    """``photonic_mvm``'s plan on the (K, N) bank: the fused kernel's (K, N)
    decode plan at M <= GEMV_MAX_M (the stream on int8 rows), the
    resident kernel's tensor-core plan for one stream above (K splits only
    where the tiles fill less than a wave at decode-like widths, or on a
    deep bank).  No A8 workspace: the rows are int8 already."""
    if M <= GEMV_MAX_M:
        return launch_plan(M, K, N, False, sms)
    return resident_launch_plan(1, M, K, N, sms)


def split_t_launch_plan(M: int, K: int, N: int,
                        sms: int = _SMS_H100) -> Plan:
    """``photonic_mvm_t``'s plan: the fused kernel's (N, K) plan, whose
    regimes it runs on int8 rows (no A8 workspace): the decode stream at
    M <= GEMV_MAX_M, the tensor cores above."""
    return launch_plan(M, K, N, True, sms)._replace(xq_bytes=0)


def resident_launch_plan(T: int, M: int, K: int, N: int,
                         sms: int = _SMS_H100, splits=None) -> Plan:
    """``photonic_mvm_resident``'s plan for T streams of M rows: the T * M
    rows are one matrix on the tensor-core tiles (no A8 workspace: the
    rows are int8 already).  A K split adds a finish whose cost grows with
    the rows of a tile, so K splits (the fused kernel's rule, down to one
    k-tile per split: ``_mma_plan``) only at decode widths (at most half a
    row tile: the MoE path's 32 rows) or on deep banks
    (RESIDENT_SPLIT_KTILES k-tiles or more, RESIDENT_SPLIT_MIN_KTILES per
    split), not on granite's prefill tiles of 8 k-tiles or fewer, where no
    split was fastest (PERF.md; chip_smoke times every case under 1, 2, 4
    and 8 splits).  ``splits`` forces the
    number of K ranges, which never changes the result."""
    rows = T * M
    ktiles = math.ceil(K / MMA_BK)
    if rows <= MMA_BM // 2:
        min_ktiles = 1
    elif ktiles >= RESIDENT_SPLIT_KTILES:
        min_ktiles = RESIDENT_SPLIT_MIN_KTILES
    else:
        min_ktiles = ktiles
    return _mma_plan(rows, K, N, sms, 0, min_ktiles=min_ktiles,
                     splits=splits)


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


def exact_mvm(xq, wq, x_scale, w_scale, transpose=False):
    """The CUDA kernels' arithmetic (``csrc/photonic_mvm_common.cuh``
    ``rescale``): the exact integer product ``acc = q @ wq``, then
    ``float(acc) * (s_x * s_w) / 127`` in float32.  ``xq`` holds the A8
    grid values (any dtype), ``wq`` is (K, N), or (N, K) with
    ``transpose``; ``w_scale`` broadcasts over the rows.  The plain
    versions keep the reference's offset decomposition (``_offset_mvm``);
    this is what the card computes, for holding its outputs to a
    kernel-level tolerance.  The product runs in float64, exact while
    |acc| < 2**53 (K below ~5e11)."""
    w = wq.to(torch.float64)
    acc = xq.to(torch.float64) @ (w.T if transpose else w)
    return acc.to(torch.float32) * (x_scale * w_scale) / QMAX


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


@functools.lru_cache(maxsize=None)
def _inv_perm(block_perm: tuple, block: int, N: int, device) -> torch.Tensor:
    """``out_block_index`` on the device, copied there once per
    permutation and never dropped: a captured decode step keeps its
    address."""
    return torch.as_tensor(out_block_index(block_perm, block, N),
                           device=device)


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
    fn.argtypes = [p, i, p, i, p, p, p, p, i, i, i, i, i, i, i, i, p, p, p,
                   p, p]
    fn.restype = i
    return lib, fn


# split-K grids stay under one wave: at most 4 x 132 / 2 decode tiles or
# 132 tensor-core tiles carry arrival counters
MAX_SPLIT_TILES = 1024


@functools.lru_cache(maxsize=None)
def _tile_counters(device) -> torch.Tensor:
    """Split-K arrival counters of one device, one int32 per output tile,
    shared by every one-launch split (the fused, both split and the
    resident kernels).  They are zero between calls: the kernel's last
    block of a tile re-arms its counter, and calls on the device run in
    stream order."""
    return torch.zeros(MAX_SPLIT_TILES, dtype=torch.int32, device=device)


_partials: dict = {}
_retired_partials: list = []


def _split_workspace(plan: Plan, device):
    """(partials, counters) of a one-launch split call, or (None, None).
    The int32 partials live in one buffer per device, grown to the largest
    call so far (at most MMA_PART_BYTES for a tensor-core split): like the
    counters, it relies on the device's calls running in stream order, and
    a split call costs no allocation (no aten op) on the host.  A captured
    CUDA graph keeps the raw address of the buffer it was captured with,
    so an outgrown buffer is kept alive, never freed, and the buffer may
    not grow while a graph is being captured (warm every shape up
    first)."""
    if not plan.part_bytes:
        return None, None
    if plan.tiles > MAX_SPLIT_TILES:
        raise ValueError(f"{plan.tiles} split tiles exceed the "
                         f"{MAX_SPLIT_TILES} arrival counters")
    part = _partials.get(device)
    if part is None or 4 * part.numel() < plan.part_bytes:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"the split-K partials must grow to {plan.part_bytes} bytes "
                f"inside a CUDA graph capture; run the step eagerly first")
        if part is not None:
            _retired_partials.append(part)
        part = torch.empty(plan.part_bytes // 4, dtype=torch.int32,
                           device=device)
        _partials[device] = part
    return part, _tile_counters(device)


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _launch(x, wq, x_scale, w_scale, bias, transpose, activation,
            block_perm, block):
    global launches, launches_gemv
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
        inv = _inv_perm(tuple(int(b) for b in block_perm), int(block), N,
                        x.device)
    plan = launch_plan(M, K, N, transpose, _sms(x.device))
    xq = (torch.empty(plan.xq_bytes, dtype=torch.int8, device=x.device)
          if plan.xq_bytes else None)
    part, counters = _split_workspace(plan, x.device)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    lib, fn = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    gemv = plan.regime == "gemv"
    rc = fn(x.data_ptr(), _DTYPE_CODE[x.dtype], wq.data_ptr(), int(transpose),
            x_scale.data_ptr(), w_scale.data_ptr(), _ptr(bias), _ptr(inv),
            int(block), _ACT_CODE[activation], M, K, N, 0 if gemv else 1,
            plan.rows, plan.k_per_split, _ptr(xq), _ptr(part),
            _ptr(counters), out.data_ptr(), stream)
    _build.check(lib, "photonic_mvm_error_string", rc, "photonic_mvm_fused")
    launches += 1
    launches_gemv += gemv
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
    tensors launch the kernel; meta tensors plan a call
    (``kernels/planned.py``)."""
    if x.device.type == "cpu":
        return photonic_mvm_fused_plain(
            x, wq, x_scale, w_scale, bias=bias, transpose=transpose,
            activation=activation, block_perm=block_perm, block=block)
    if x.device.type == "meta":
        M, K, N = _check_operands(x, wq, x_scale, w_scale, bias, transpose)
        if activation not in _ACT_CODE:
            raise ValueError(f"unsupported fused activation {activation!r}")
        out = torch.empty((M, N), dtype=x.dtype, device=x.device)
        _planned.add("photonic_mvm_fused", 2 * M * K * N,
                     (x, wq, x_scale, w_scale, bias), (out,),
                     photonic_mvm_fused_gemv=M <= GEMV_MAX_M)
        return out
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
    """The split library and its launcher (both orientations)."""
    lib = _build.load("photonic_mvm_split")
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.photonic_mvm_split
    fn.argtypes = [p, p, i, p, p, i, i, i, i, i, i, p, p, p, p]
    fn.restype = i
    return lib, fn


def _check_split(xq, wq, x_scale, w_scale, transpose):
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
    return M, K, N


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_split(xq, wq, x_scale, w_scale, transpose):
    M, K, N = _check_split(xq, wq, x_scale, w_scale, transpose)
    plan = (split_t_launch_plan if transpose else split_kn_launch_plan)(
        M, K, N, _sms(xq.device))
    part, counters = _split_workspace(plan, xq.device)
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    lib, fn = _split_library()
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    rc = fn(xq.data_ptr(), wq.data_ptr(), int(transpose), x_scale.data_ptr(),
            w_scale.data_ptr(), M, K, N, 0 if plan.regime == "gemv" else 1,
            plan.rows, plan.k_per_split, _ptr(part), _ptr(counters),
            out.data_ptr(), stream)
    _build.check(lib, "photonic_mvm_split_error_string", rc,
                 "photonic_mvm_t" if transpose else "photonic_mvm")
    return out


def _plan_split(name, xq, wq, x_scale, w_scale, transpose):
    """A split MVM's planned call on meta tensors: its float32 output."""
    M, K, N = _check_split(xq, wq, x_scale.reshape(()), w_scale, transpose)
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    _planned.add(name, 2 * M * K * N, (xq, wq, x_scale, w_scale), (out,))
    return out


def photonic_mvm(xq, wq, x_scale, w_scale):
    """Split W8A8 MVM: xq int8 (M, K), wq int8 (K, N) per-column quantized,
    x_scale the float32 A8 scale, w_scale (N,) float32.  Returns float32
    (M, N), on the card bit for bit ``photonic_mvm_t(xq,
    wq.T.contiguous(), x_scale, w_scale)``.  CPU tensors take the plain
    version; CUDA tensors launch the kernel (the decode stream at M <=
    GEMV_MAX_M, the tensor cores above: ``split_kn_launch_plan``)."""
    global launches_mvm
    if xq.device.type == "cpu":
        return photonic_mvm_plain(xq, wq, x_scale, w_scale)
    if xq.device.type == "meta":
        return _plan_split("photonic_mvm", xq, wq, x_scale, w_scale, False)
    out = _launch_split(xq, wq, x_scale.reshape(()), w_scale, False)
    launches_mvm += 1
    return out


def photonic_mvm_t(xq, wq, x_scale, w_scale):
    """``xq @ wq.T`` for wq int8 (N, K) per-row quantized (the OBU
    transpose), w_scale (N,).  Returns float32 (M, N), on the card bit for
    bit ``photonic_mvm(xq, wq.T.contiguous(), x_scale, w_scale)``.  CPU
    tensors take the plain version; CUDA tensors launch the kernel (the
    decode stream at M <= GEMV_MAX_M, the tensor cores above:
    ``split_t_launch_plan``)."""
    global launches_mvm_t
    if xq.device.type == "cpu":
        return photonic_mvm_t_plain(xq, wq, x_scale, w_scale)
    if xq.device.type == "meta":
        return _plan_split("photonic_mvm_t", xq, wq, x_scale, w_scale, True)
    out = _launch_split(xq, wq, x_scale.reshape(()), w_scale, True)
    launches_mvm_t += 1
    return out


# -------------------------------------------------------------------------
# reuse-resident: T streams through one programmed bank
# -------------------------------------------------------------------------
def photonic_mvm_resident_plain(xq, wq, x_scale, w_scale):
    """Plain version of ``photonic_mvm_resident``: xq int8 (T, M, K), wq
    int8 (K, N), x_scale float32 (T,) (one A8 scale per stream), w_scale
    (N,); float32 (T, M, N), any device.  The reference kernel's float32
    arithmetic (``_kernel_resident``): ``2 (q @ W' - sum(q)/2)``, then
    times ``s_x[t]``, then times ``s_w``."""
    xf = xq.to(torch.float32)
    w_prime = wq.to(torch.float32) / (2.0 * QMAX) + 0.5
    y = xf @ w_prime
    y = 2.0 * (y - 0.5 * xf.sum(dim=2, keepdim=True))
    return y * x_scale.reshape(-1, 1, 1) * w_scale.reshape(1, 1, -1)


def _check_resident(xq, wq, x_scale, w_scale):
    if xq.ndim != 3 or wq.ndim != 2:
        raise ValueError(f"need xq (T, M, K) and wq (K, N), got "
                         f"{tuple(xq.shape)} and {tuple(wq.shape)}")
    T, M, K = xq.shape
    K2, N = wq.shape
    if K != K2:
        raise ValueError(f"reduction dims differ: xq {tuple(xq.shape)}, "
                         f"wq {tuple(wq.shape)}")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"xq and wq must be int8, got {xq.dtype}/{wq.dtype}")
    if tuple(x_scale.shape) != (T,) or x_scale.dtype != torch.float32:
        raise ValueError(f"x_scale must be float32 ({T},), got "
                         f"{x_scale.dtype} {tuple(x_scale.shape)}")
    if tuple(w_scale.shape) != (N,) or w_scale.dtype != torch.float32:
        raise ValueError(f"w_scale must be float32 ({N},), got "
                         f"{w_scale.dtype} {tuple(w_scale.shape)}")
    return T, M, K, N


@functools.lru_cache(maxsize=1)
def _resident_library():
    lib = _build.load("photonic_mvm_resident")
    fn = lib.photonic_mvm_resident
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i, i, p, p, p, p]
    fn.restype = i
    return lib, fn


def _launch_resident(xq, wq, x_scale, w_scale, T, M, K, N, splits):
    global launches_resident
    for t in (xq, wq, x_scale, w_scale):
        if t.device != xq.device:
            raise ValueError("all operands must be on the same CUDA device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    out = torch.empty((T, M, N), dtype=torch.float32, device=xq.device)
    if out.numel() == 0:
        return out
    plan = resident_launch_plan(T, M, K, N, _sms(xq.device), splits)
    part, counters = _split_workspace(plan, xq.device)
    lib, fn = _resident_library()
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    rc = fn(xq.data_ptr(), wq.data_ptr(), x_scale.data_ptr(),
            w_scale.data_ptr(), T, M, K, N, plan.k_per_split, _ptr(part),
            _ptr(counters), out.data_ptr(), stream)
    _build.check(lib, "photonic_mvm_resident_error_string", rc,
                 "photonic_mvm_resident")
    launches_resident += 1
    return out


def photonic_mvm_resident(xq, wq, x_scale, w_scale, *, splits=None):
    """Reuse-resident MVM: T int8 activation streams ``xq`` (T, M, K), each
    with its own A8 scale ``x_scale`` (T,), through ONE programmed bank
    ``wq`` int8 (K, N) with per-column ``w_scale`` (N,), any K.  Returns
    float32 (T, M, N); stream t equals ``photonic_mvm(xq[t], wq,
    x_scale[t], w_scale)`` (bit for bit on the card).  ``splits``
    overrides the plan's number of K ranges (``resident_launch_plan``),
    for measuring it; the result is the same.  CPU tensors take the plain
    version; CUDA tensors launch the kernel; meta tensors plan a call."""
    T, M, K, N = _check_resident(xq, wq, x_scale, w_scale)
    if xq.device.type == "cpu":
        return photonic_mvm_resident_plain(xq, wq, x_scale, w_scale)
    if xq.device.type == "meta":
        out = torch.empty((T, M, N), dtype=torch.float32, device=xq.device)
        _planned.add("photonic_mvm_resident", 2 * T * M * K * N,
                     (xq, wq, x_scale, w_scale), (out,))
        return out
    return _launch_resident(xq, wq, x_scale, w_scale, T, M, K, N, splits)
