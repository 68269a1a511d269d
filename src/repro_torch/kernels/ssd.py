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

The CUDA kernel is ``csrc/ssd_chunk.cu``: all three products on the TF32
tensor cores, each operand split into two TF32 halves (3xTF32, float32
accuracy).  It reads every input through its strides, so B and C may be
stride-0 views over the head axis (the group broadcast of
``models/ssm.ssd_chunked``, nothing copied); then a block computes the
scores C B^T once for the group of heads it serves (``ssd_launch_plan``).
The wrapper takes the plain version only for CPU tensors; for CUDA tensors
it launches the kernel or raises; for meta tensors (the dry-run) it plans a
call (``kernels/planned.py``).  It is a ``torch.autograd.Function``: the
backward (:func:`ssd_chunk_vjp`) is the block's VJP written out in float32
torch ops on any device (the reference trains through XLA einsums of the
same block and has no Pallas backward).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import planned as _planned
from repro_torch.kernels import ref as _ref

MAX_L = 4096                 # the kernel's longest chunk (shared memory)
MAX_P = 64                   # the kernel's widest head (one register tile)
TILE = 64                    # query, key and state rows per block tile
MAX_HEADS_PER_BLOCK = 4
BLOCKS_PER_SM = 2            # at L <= 256 (launch bounds, shared memory)
_SMS_H100 = 132
_MAX_BLOCKS = 2 ** 31 - 1

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


class SSDPlan(NamedTuple):
    """How one ``ssd_chunk`` launch covers its work.  A query block owns a
    64-row query tile of ``heads_per_block`` heads (with stride-0 B/C one
    scores tile C B^T serves them all), a state block 64 state rows of
    ``state_heads_per_block`` heads.  Per batch * chunk: ``query_tiles``
    query blocks for each group of heads (``query_cells`` in all) and
    ``state_tiles`` state blocks for each state group (``state_cells``).
    The ``heavy`` longest query tiles of every cell launch first, then the
    state blocks, then the other query tiles."""
    heads_per_block: int
    state_heads_per_block: int
    query_tiles: int
    state_tiles: int
    query_cells: int
    state_cells: int
    heavy: int
    blocks: int


def _blocks(b, nc, H, nq, nn, hb, hbs):
    """(query cells, state cells, blocks) of groups of hb and hbs heads."""
    qcells = b * nc * math.ceil(H / hb)
    scells = b * nc * math.ceil(H / hbs)
    return qcells, scells, nq * qcells + nn * scells


def _plan(b, nc, L, H, P, N, shared, hb, hbs) -> SSDPlan:
    """The grid of groups of ``hb`` query and ``hbs`` state heads (clamped
    to 1..H); any grouping gives the same result bit for bit."""
    nq, nn = math.ceil(L / TILE), math.ceil(N / TILE)
    hb, hbs = max(1, min(hb, H)), max(1, min(hbs, H))
    qcells, scells, blocks = _blocks(b, nc, H, nq, nn, hb, hbs)
    # multiply-adds in 64^3 units: a query tile's scores (once per group
    # with stride-0 B/C) and x products over qt + 1 key tiles; a state
    # block's over all nq key tiles
    state = hbs * nq * P / TILE
    heavy = sum((qt + 1) * (N / TILE * (1 if shared else hb) + hb * P / TILE)
                > state for qt in range(nq))
    return SSDPlan(hb, hbs, nq, nn, qcells, scells, heavy, blocks)


def ssd_launch_plan(b, nc, L, H, P, N, shared, sms=_SMS_H100) -> SSDPlan:
    """The kernel's grid for one call.  With ``shared`` (stride-0) B/C a
    query block serves the largest group of heads (4, 2 or 1) that still
    leaves a block for every block slot of the card, so the scores C B^T
    are computed once per group while the card stays full; a state block,
    which shares nothing, takes half as many.  Materialised B/C gain
    nothing from a group: one head per block.  On an H100 (132 SMs, two
    blocks each) at mamba2's widths that is 1 head at b * nc = 1, 2 at 2
    and 4 from 3 on."""
    nq, nn = math.ceil(L / TILE), math.ceil(N / TILE)
    hb = 1
    if shared:
        for cand in (MAX_HEADS_PER_BLOCK, 2):
            if _blocks(b, nc, H, nq, nn, cand,
                       max(1, cand // 2))[2] >= BLOCKS_PER_SM * sms:
                hb = cand
                break
    return _plan(b, nc, L, H, P, N, shared, hb, max(1, hb // 2))


@functools.lru_cache(maxsize=1)
def _library():
    lib = _build.load("ssd_chunk")
    fn = lib.ssd_chunk
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p, p, p]
    fn.restype = i
    return lib, fn


def _vec16(t) -> bool:
    """16-byte copies allowed: unit stride along the last axis, every other
    stride a multiple of 4 elements (0 too) and a 16-byte aligned base."""
    return (t.stride(-1) == 1 and all(s % 4 == 0 for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def _launch(x, dA, B, C, b, nc, L, H, P, N, plan=None):
    """Launch the kernel on CUDA tensors, on the grid of
    ``ssd_launch_plan`` unless a ``plan`` is given."""
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
    if plan is None:
        plan = ssd_launch_plan(b, nc, L, H, P, N,
                               B.stride(3) == 0 and C.stride(3) == 0,
                               _sms(x.device))
    if plan.blocks > _MAX_BLOCKS:
        raise ValueError(f"{plan.blocks} blocks exceed the grid's "
                         f"{_MAX_BLOCKS}")
    strides = (ctypes.c_longlong * 19)(
        *x.stride(), *dA.stride(), *B.stride(), *C.stride())
    vec = _vec16(x) | _vec16(B) << 1 | _vec16(C) << 2
    y = torch.empty((b, nc, L, H, P), dtype=torch.float32, device=x.device)
    st = torch.empty((b, nc, H, N, P), dtype=torch.float32, device=x.device)
    lib, fn = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), dA.data_ptr(), B.data_ptr(), C.data_ptr(),
            ctypes.cast(strides, ctypes.c_void_p), b, nc, L, H, P, N,
            plan.heads_per_block, plan.state_heads_per_block, plan.heavy,
            vec, y.data_ptr(),
            st.data_ptr(), stream)
    _build.check(lib, "ssd_chunk_error_string", rc, "ssd_chunk")
    launches += 1
    return y, st


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _forward(x, dA, B, C):
    """The forward dispatch: CPU tensors take the plain version, meta
    tensors plan a call, CUDA tensors launch the kernel."""
    b, nc, L, H, P, N = _check(x, dA, B, C)
    if x.device.type == "cpu":
        return ssd_chunk_plain(x, dA, B, C)
    if x.device.type == "meta":
        y = torch.empty((b, nc, L, H, P), dtype=torch.float32,
                        device=x.device)
        st = torch.empty((b, nc, H, N, P), dtype=torch.float32,
                         device=x.device)
        # C B^T, the masked scores times x, and the chunk states
        _planned.add("ssd_chunk",
                     2 * b * nc * H * (L * L * N + L * L * P + L * N * P),
                     (x, dA, B, C), (y, st))
        return y, st
    return _launch(x, dA, B, C, b, nc, L, H, P, N)


def ssd_chunk_vjp(x, dA, B, C, gy, gst):
    """The VJP of the intra-chunk block, in float32 torch ops on any
    device: given the inputs and the gradients ``gy`` of y_diag (b, nc, L,
    H, P) and ``gst`` of the states (b, nc, H, N, P), returns the gradients
    of x, dA, B and C (B's and C's (b, nc, L, H, N), contiguous; autograd
    sums them over a stride-0 head broadcast).  With cs = cumsum(dA),
    S = C B^T, Lmat = exp(cs_i - cs_j) on the causal triangle, M = S * Lmat
    and w = exp(cs_L - cs):

        y  = M x                  gx = M^T gy + (B w) gst
        st = (B w)^T x            gS = (gy x^T) * Lmat,  gC = gS B,
                                  gB = gS^T C + (x gst^T) w
        d cs_i = sum_j G_ij - sum_j G_ji - h_i (+ sum_l h_l at i = L-1),
        G = gS * S, h = w * rowsum((x gst^T) * B),

    and dA's gradient is the reverse cumsum of cs's.  The scores and decays
    are recomputed from the saved inputs."""
    L = x.shape[2]
    x, dA, B, C, gy, gst = (t.to(torch.float32)
                            for t in (x, dA, B, C, gy, gst))
    cs = torch.cumsum(dA, dim=-1)                          # (b,nc,H,L)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    Lmat = torch.exp(seg.masked_fill(~mask, float("-inf")))
    del seg
    scores = torch.einsum("bclhn,bcshn->bchls", C, B)
    gS = torch.einsum("bclhp,bcshp->bchls", gy, x) * Lmat
    gx = torch.einsum("bchls,bclhp->bcshp", scores * Lmat, gy)
    del Lmat
    gC = torch.einsum("bchls,bcshn->bclhn", gS, B)
    gB = torch.einsum("bchls,bclhn->bcshn", gS, C)
    G = gS * scores
    del gS, scores
    g_cs = G.sum(-1) - G.sum(-2)
    del G
    w = torch.exp(cs[..., -1:] - cs).permute(0, 1, 3, 2)[..., None]
    Bw = B * w                                             # (b,nc,L,H,N)
    gx = gx + torch.einsum("bclhn,bchnp->bclhp", Bw, gst)
    gBw = torch.einsum("bclhp,bchnp->bclhn", x, gst)
    gB = gB + gBw * w
    h = ((gBw * Bw).sum(-1)).permute(0, 1, 3, 2)          # (b,nc,H,L)
    g_cs = g_cs - h
    g_cs[..., -1] += h.sum(-1)
    g_dA = torch.flip(torch.cumsum(torch.flip(g_cs, (-1,)), -1), (-1,))
    return gx, g_dA, gB, gC


class _SSDChunk(torch.autograd.Function):
    """``ssd_chunk`` with a gradient: the forward is the kernel's dispatch
    (:func:`_forward`), the backward :func:`ssd_chunk_vjp` on the saved
    inputs."""

    @staticmethod
    def forward(ctx, x, dA, B, C):
        ctx.save_for_backward(x, dA, B, C)
        return _forward(x, dA, B, C)

    @staticmethod
    def backward(ctx, gy, gst):
        return ssd_chunk_vjp(*ctx.saved_tensors, gy, gst)


def ssd_chunk(x, dA, B, C):
    """Intra-chunk SSD: x (b, nc, L, H, P) dt-folded, dA (b, nc, H, L),
    B/C (b, nc, L, H, N) head-broadcast (any strides), float32.  Returns
    y_diag (b, nc, L, H, P) and states (b, nc, H, N, P), float32.  CPU
    tensors take the plain version; CUDA tensors launch the kernel (L up to
    ``MAX_L``, P up to ``MAX_P``; ValueError beyond).  Differentiable on
    every device: the gradient is :func:`ssd_chunk_vjp`."""
    return _SSDChunk.apply(x, dA, B, C)
