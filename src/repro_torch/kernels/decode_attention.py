"""Decode attention: plain PyTorch version and CUDA wrapper.

One query token a row against its past-only KV cache plus the new token's
K/V, held apart (the cache is read-only here): the function of the
reference's ``_attend_decode`` (``src/repro/models/attention.py:202``), an
einsum chain in the reference and in this module's plain version.  It has
no Pallas counterpart.  The CUDA kernel (``csrc/decode_attention.cu``)
exists so that a row's output does not depend on the other rows or heads
of the call: its reduction order is fixed by the head dim, the split size
and the row's own position, where cuBLAS picks the einsum's from the whole
call's shapes (so a rank holding one row, or its own KV heads, got other
bits than the unsharded step).  One launch a call: split-K over fixed
blocks of ``SPLIT`` positions, the last block of a (row, KV head) to
arrive joining the splits in split order (the source's design note).

Shapes: q (B, 1, H, hd); ck / cv (B, L, KV, hd), the cache; k_new / v_new
(B, 1, KV, hd); ``pos`` an int or a (B,) / 0-d tensor: cache position l of
row b is seen when ``offset + l < pos[b]``.  Returns (B, 1, H * hd) in q's
dtype.  The **partial** form returns, per (row, head), the max of the
scores it saw, the sum of their exponentials and the unnormalised float32
P V over them, with the new token counted only when ``with_new``: a caller
that holds a piece of the cache's positions joins the pieces with
:func:`join_partials` (the sequence-split cache of a mesh, over
collectives).

The wrapper takes the plain version only for CPU tensors; for CUDA tensors
it launches the kernel or raises; for meta tensors (the dry-run) it plans a
call (``kernels/planned.py``).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import planned as _planned

MAX_HEAD_DIM = 256           # the kernel's largest hd
MAX_GROUP = 16               # query heads a KV head serves
SPLIT = 128                  # positions one block takes (DECODE_SPLIT)
STAGES = 4                   # steps a lane keeps in flight (DECODE_STAGES)
NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches on the CUDA path (the plain CPU path does not count)
launches = 0


def score_scale(hd: int) -> torch.Tensor:
    """1 / sqrt(hd) as the reference forms it: a float32 division."""
    return 1.0 / torch.tensor(math.sqrt(hd), dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def _scale_value(hd: int) -> float:
    """``score_scale(hd)`` as the float the kernel takes, formed once."""
    return float(score_scale(hd))


def seen_mask(pos, L: int, device, offset: int = 0):
    """(B|1, L) bool mask of the cache rows a query sees: global position
    ``offset + l`` strictly before ``pos``."""
    ar = torch.arange(L, device=device) + offset
    if not isinstance(pos, torch.Tensor) or pos.ndim == 0:
        return (ar < int(pos))[None, :]
    return ar[None, :] < pos.to(device)[:, None]


def _scores(q, ck, k_new, pos, offset):
    """Float32 scaled scores of the cache (masked to NEG_INF where not seen)
    and of the new token: (B, KV, G, 1, L), (B, KV, G, 1, 1), and the
    (B|1, L) mask."""
    B, _, H, hd = q.shape
    KV, L = ck.shape[2], ck.shape[1]
    qg = q.reshape(B, 1, KV, H // KV, hd).float()
    scale = score_scale(hd)
    s_c = torch.einsum("bskgh,blkh->bkgsl", qg, ck.float()) * scale
    seen = seen_mask(pos, L, q.device, offset)
    s_c = s_c.masked_fill(~seen[:, None, None, None, :], NEG_INF)
    s_n = torch.einsum("bskgh,blkh->bkgsl", qg,
                       k_new.to(q.dtype).float()) * scale
    return s_c, s_n, seen


def decode_attention_plain(q, ck, cv, k_new, v_new, pos):
    """Plain version (any device): the reference's einsum chain, float32
    scores and softmax over L + 1, the cache part's probabilities rounded
    to the cache dtype and the new token's to q's dtype."""
    B, S, H, hd = q.shape
    L = ck.shape[1]
    s_c, s_n, _ = _scores(q, ck, k_new, pos, 0)
    att = torch.softmax(torch.cat([s_c, s_n], dim=-1), dim=-1)
    out = (torch.einsum("bkgsl,blkh->bskgh",
                        att[..., :L].to(cv.dtype).float(), cv.float())
           + torch.einsum("bkgsl,blkh->bskgh",
                          att[..., L:].to(q.dtype).float(),
                          v_new.to(q.dtype).float()))
    return out.reshape(B, 1, H * cv.shape[-1]).to(q.dtype)


def decode_attention_partial_plain(q, ck, cv, k_new, v_new, pos, *,
                                   offset: int = 0, with_new: bool = True):
    """Plain partial form: (m, l, o) float32 of shapes (B, H), (B, H),
    (B, H, hd) over the cache rows seen (global positions ``offset + l``)
    and, ``with_new``, the new token: m the scores' max (NEG_INF when none
    was seen), l the sum of exp(s - m), o the sum of exp(s - m) V with each
    weight rounded to its V's dtype (the cache's, q's for the new token)."""
    B, _, H, hd = q.shape
    KV = ck.shape[2]
    s_c, s_n, seen = _scores(q, ck, k_new, pos, offset)
    m = s_c.amax(dim=-1, keepdim=True)
    if with_new:
        m = torch.maximum(m, s_n)
    e_c = torch.exp(s_c - m).masked_fill(~seen[:, None, None, None, :], 0.0)
    l_sum = e_c.sum(dim=-1)
    o = torch.einsum("bkgsl,blkh->bkgh", e_c.to(cv.dtype).float(),
                     cv.float())
    if with_new:
        e_n = torch.exp(s_n - m)
        l_sum = l_sum + e_n[..., 0]
        o = o + torch.einsum("bkgsl,blkh->bkgh", e_n.to(q.dtype).float(),
                             v_new.to(q.dtype).float())
    return (m.reshape(B, H), l_sum.reshape(B, H),
            o.reshape(B, H, cv.shape[-1]))


def join_partials(parts, dtype):
    """Join partial results ``[(m, l, o), ...]`` over disjoint pieces of the
    positions (the new token counted in exactly one): (B, 1, H * hd) in
    ``dtype``.  The sequence-split cache joins its ranks' the same way over
    collectives (``models.attention``)."""
    M = parts[0][0]
    for m, _, _ in parts[1:]:
        M = torch.maximum(M, m)
    den = sum(l_ * torch.exp(m - M) for m, l_, _ in parts)
    num = sum(o * torch.exp(m - M)[..., None] for m, _, o in parts)
    B, H, hd = num.shape
    return (num / den[..., None]).reshape(B, 1, H * hd).to(dtype)


# =========================================================================
# the CUDA kernel
# =========================================================================
def _bind(lib):
    """(library, launcher with C argument types declared, its SPLIT)."""
    fn = lib.decode_attention
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, ll, ll, ll, ll,
                   ctypes.c_float, ll, i, i, p, p, p, p, p, p, p, p]
    fn.restype = i
    lib.decode_attention_split.restype = i
    return lib, fn, int(lib.decode_attention_split())


@functools.lru_cache(maxsize=1)
def _library():
    """The built library, bound (``_bind``)."""
    return _bind(_build.load("decode_attention"))


_counters: dict = {}
_retired_counters: list = []


def _arrival_counters(device, n: int) -> torch.Tensor:
    """At least ``n`` int32 arrival counters of ``device``, zero between
    calls: the last block of a (row, KV head) re-arms its counter, and the
    device's calls run in stream order.  One buffer per device, grown to the
    largest call; a captured CUDA graph keeps the raw address it was
    captured with, so an outgrown buffer is kept alive, and the buffer may
    not grow while a graph is being captured (warm the shape up first)."""
    buf = _counters.get(device)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"decode attention's arrival counters must grow to {n} "
                f"inside a CUDA graph capture; run the step eagerly first")
        if buf is not None:
            _retired_counters.append(buf)
        buf = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _counters[device] = buf
    return buf


def _check(q, ck, cv, k_new, v_new):
    """(B, L, H, KV, hd) of a call the kernel takes; raises otherwise."""
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, hd), got {tuple(q.shape)}")
    B, _, H, hd = q.shape
    if ck.ndim != 4 or tuple(cv.shape) != tuple(ck.shape) \
            or ck.shape[0] != B or ck.shape[3] != hd:
        raise ValueError(f"ck {tuple(ck.shape)} / cv {tuple(cv.shape)} must "
                         f"be (B, L, KV, hd) with B={B}, hd={hd}")
    L, KV = ck.shape[1], ck.shape[2]
    for t in (k_new, v_new):
        if tuple(t.shape) != (B, 1, KV, hd):
            raise ValueError(f"k_new / v_new must be {(B, 1, KV, hd)}, got "
                             f"{tuple(t.shape)}")
    if KV == 0 or H % KV or H // KV > MAX_GROUP:
        raise ValueError(f"H={H} query heads over KV={KV}: need H % KV == 0 "
                         f"and at most {MAX_GROUP} a KV head")
    if not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd}: the kernel takes 1 to "
                         f"{MAX_HEAD_DIM}")
    for t in (ck, cv):
        if t.stride(3) != 1 or t.stride(2) != hd:
            raise ValueError("ck / cv need contiguous heads and channels "
                             "(strides (..., hd, 1))")
    return B, L, H, KV, hd


def _positions(pos, B: int, device):
    """(int64 positions on ``device``, stride over rows): one for every row
    (stride 0) or one a row."""
    if not isinstance(pos, torch.Tensor):
        return torch.full((1,), int(pos), dtype=torch.long, device=device), 0
    p = pos.to(device=device, dtype=torch.long).reshape(-1).contiguous()
    if p.numel() == 1:
        return p, 0
    if p.numel() != B:
        raise ValueError(f"pos has {p.numel()} entries for {B} rows")
    return p, 1


def _launch(q, ck, cv, k_new, v_new, pos, offset, partial, with_new):
    global launches
    B, L, H, KV, hd = _check(q, ck, cv, k_new, v_new)
    dt = q.dtype
    if dt not in _DTYPE_CODE or any(t.dtype != dt for t in (ck, cv)):
        raise TypeError(f"q, ck and cv must share float32 or bf16, got "
                        f"{q.dtype}/{ck.dtype}/{cv.dtype}")
    dev = q.device
    if any(t.device != dev for t in (ck, cv, k_new, v_new)):
        raise ValueError("decode attention operands must lie on one device")
    q = q.contiguous()
    k_new = k_new.to(dt).contiguous()
    v_new = v_new.to(dt).contiguous()
    p, pstride = _positions(pos, B, dev)
    lib, fn, split = _library()
    nsplit = max(1, -(-L // split))
    ws = torch.empty(B * H * nsplit * (hd + 2), dtype=torch.float32,
                     device=dev)
    ws_m, ws_l, ws_o = ws.split([B * H * nsplit, B * H * nsplit,
                                 B * H * nsplit * hd])
    counters = _arrival_counters(dev, B * KV)
    if partial:
        out = torch.empty((B, H, hd), dtype=torch.float32, device=dev)
        m = torch.empty((B, H), dtype=torch.float32, device=dev)
        l_sum = torch.empty((B, H), dtype=torch.float32, device=dev)
        mp, lp = m.data_ptr(), l_sum.data_ptr()
    else:
        out = torch.empty((B, 1, H, hd), dtype=dt, device=dev)
        mp = lp = None
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(q.data_ptr(), ck.data_ptr(), cv.data_ptr(), k_new.data_ptr(),
            v_new.data_ptr(), p.data_ptr(), pstride, _DTYPE_CODE[dt], B, L,
            H, KV, hd, ck.stride(0), ck.stride(1), cv.stride(0),
            cv.stride(1), _scale_value(hd), int(offset), int(partial),
            int(with_new), ws_m.data_ptr(), ws_l.data_ptr(), ws_o.data_ptr(),
            counters.data_ptr(), out.data_ptr(), mp, lp, stream)
    _build.check(lib, "decode_attention_error_string", rc,
                 "decode_attention")
    launches += 1
    if partial:
        return m, l_sum, out
    return out.reshape(B, 1, H * hd)


def seen_rows(pos, B: int, L: int, offset: int = 0) -> list:
    """Cache rows each query sees (``pos`` an int or a host-readable
    tensor)."""
    if isinstance(pos, torch.Tensor) and pos.ndim > 0:
        vals = [int(v) for v in pos.reshape(-1).tolist()]
        vals = vals * B if len(vals) == 1 else vals
    else:
        vals = [int(pos)] * B
    return [min(max(v - offset, 0), L) for v in vals]


def work(B: int, H: int, KV: int, hd: int, seen: list, itemsize: int,
         partial: bool = False) -> tuple:
    """(operations, bytes) of one call: per seen cache row and the new
    token, 2 * hd for the score and 2 * hd for the V product a query head;
    each seen K / V row, q and the new K / V read once, the output written
    once (the positions' few bytes left out)."""
    rows = sum(seen)
    n_ops = 4.0 * H * hd * (rows + B)
    out_bytes = (B * H * hd * 4 + 2 * B * H * 4 if partial
                 else B * H * hd * itemsize)
    n_bytes = (2 * rows * KV * hd * itemsize + B * H * hd * itemsize
               + 2 * B * KV * hd * itemsize + out_bytes)
    return n_ops, float(n_bytes)


def _plan(q, ck, cv, k_new, v_new, pos, offset, partial, with_new):
    """The planned call on meta tensors (``kernels/planned.py``): the
    launch's checks and outputs, no launch.  A position a meta tensor
    cannot give counts every cache row as seen."""
    B, L, H, KV, hd = _check(q, ck, cv, k_new, v_new)
    dev = q.device
    if isinstance(pos, torch.Tensor) and pos.ndim > 0:
        seen = [L] * B
    else:
        seen = seen_rows(pos, B, L, offset)
    n_ops, _ = work(B, H, KV, hd, seen, q.element_size(), partial)
    rows = max(seen)
    if partial:
        outs = (torch.empty((B, H), dtype=torch.float32, device=dev),
                torch.empty((B, H), dtype=torch.float32, device=dev),
                torch.empty((B, H, hd), dtype=torch.float32, device=dev))
    else:
        outs = (torch.empty((B, 1, H * hd), dtype=q.dtype, device=dev),)
    _planned.add("decode_attention", n_ops,
                 (q, ck.narrow(1, 0, rows), cv.narrow(1, 0, rows), k_new,
                  v_new), outs)
    return outs if partial else outs[0]


def decode_attention(q, ck, cv, k_new, v_new, pos):
    """Decode attention (module docstring): (B, 1, H * hd) in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, ck, cv, k_new, v_new, pos)
    if q.device.type == "meta":
        return _plan(q, ck, cv, k_new, v_new, pos, 0, False, True)
    return _launch(q, ck, cv, k_new, v_new, pos, 0, False, True)


def decode_attention_partial(q, ck, cv, k_new, v_new, pos, *,
                             offset: int = 0, with_new: bool = True):
    """The partial form over the cache rows at global positions ``offset +
    l`` (module docstring): (m, l, o) float32."""
    if q.device.type == "cpu":
        return decode_attention_partial_plain(q, ck, cv, k_new, v_new, pos,
                                              offset=offset,
                                              with_new=with_new)
    if q.device.type == "meta":
        return _plan(q, ck, cv, k_new, v_new, pos, offset, True, with_new)
    return _launch(q, ck, cv, k_new, v_new, pos, offset, True, with_new)
