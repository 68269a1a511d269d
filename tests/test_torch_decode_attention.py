"""The decode-attention kernel's module (``kernels/decode_attention.py``):

  * the plain version against the reference's ``_attend_decode``
    (``src/repro/models/attention.py:202``) on numpy-seeded inputs:
    float32 rel-L2 <= 1e-5, bf16 within one bf16 ulp, scalar and per-row
    positions, G = 1 and 3, hd 16 and 64;
  * the partial form joined over 2 and 4 pieces of the positions (the new
    token in one) against the whole, float32 <= 1e-6;
  * the kernel's arithmetic emulated here, with the constants read from
    its source: splits of ``SPLIT`` positions, each with its own max and
    its unnormalised weights rounded to the cache dtype; lanes owning 8
    elements of a row, their products summed in element order and joined
    by the row's butterfly; the P V sums of each (warp, row slot) in
    position order, the row slots' butterfly and the warps in warp order;
    the splits joined in split order with the new token.  At the card's
    gates against the plain version at the four serving (G, hd) pairs, in
    bf16 and float32, whole and as the partial form over pieces, and a
    row's and a KV-head group's bits the same alone as in the whole call;
  * the wrapper's device rules: the plain version for CPU tensors (no
    launch counted), a planned call on meta tensors (operations and bytes
    of the positions seen), on any other device the kernel or an error;
    ``build.SOURCES`` naming the source, whose limits and constants equal
    the module's; the arrival counters' buffer; ``chip_smoke``'s profile
    groups naming the source's kernels."""
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.models import attention as j_attn

from repro_torch.kernels import build as t_build
from repro_torch.kernels import counts, planned
from repro_torch.kernels import decode_attention as da

BF16_ULP = 2.0 ** -8


def _inputs(seed, B, L, H, KV, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((B, 1, H, hd), (B, L, KV, hd), (B, L, KV, hd), (B, 1, KV, hd),
             (B, 1, KV, hd))]


def _positions(kind, B, L):
    if kind == "scalar":
        return L - 3
    return np.random.default_rng(B + L).integers(0, L + 1, B)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


CASES = [(2, 20, 3, 3, 16), (3, 37, 6, 2, 64), (1, 9, 2, 2, 16),
         (2, 130, 12, 4, 64)]


@pytest.mark.parametrize("B,L,H,KV,hd", CASES)
@pytest.mark.parametrize("pos_kind", ["scalar", "per_row"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_the_reference(B, L, H, KV, hd, pos_kind, dtype):
    arrs = _inputs(L * H + hd, B, L, H, KV, hd)
    pos = _positions(pos_kind, B, L)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = np.asarray(j_attn._attend_decode(
        *(jnp.asarray(a, jdt) for a in arrs),
        pos if pos_kind == "scalar" else jnp.asarray(pos, jnp.int32)),
        np.float32)
    tdt = getattr(torch, dtype)
    got = da.decode_attention(
        *(torch.as_tensor(a).to(tdt) for a in arrs),
        pos if pos_kind == "scalar" else torch.as_tensor(pos))
    assert got.dtype == tdt and tuple(got.shape) == (B, 1, H * hd)
    got = got.float().numpy()
    if dtype == "float32":
        assert _rel(got, want) <= 1e-5
    else:
        # one bf16 step of the larger of the two, where the two round apart
        step = BF16_ULP * np.maximum(np.abs(want), np.abs(got))
        assert np.all(np.abs(got - want) <= step + 1e-30)


@pytest.mark.parametrize("pieces", [2, 4])
@pytest.mark.parametrize("pos_kind", ["scalar", "per_row"])
def test_partial_form_joined_over_pieces_equals_the_whole(pieces, pos_kind):
    B, L, H, KV, hd = 3, 48, 6, 2, 16
    q, ck, cv, kn, vn = (torch.as_tensor(a) for a in
                         _inputs(pieces, B, L, H, KV, hd))
    pos = _positions(pos_kind, B, L)
    pos = pos if pos_kind == "scalar" else torch.as_tensor(pos)
    whole = da.decode_attention(q, ck, cv, kn, vn, pos)
    w = L // pieces
    parts = [da.decode_attention_partial(
        q, ck[:, j * w:(j + 1) * w], cv[:, j * w:(j + 1) * w], kn, vn, pos,
        offset=j * w, with_new=j == 1) for j in range(pieces)]
    for m, l_sum, o in parts:
        assert m.dtype == l_sum.dtype == o.dtype == torch.float32
        assert tuple(o.shape) == (B, H, hd)
    assert _rel(da.join_partials(parts, torch.float32), whole) <= 1e-6
    # a piece no query sees, without the new token, adds nothing
    m, l_sum, o = da.decode_attention_partial(q, ck, cv, kn, vn, 0,
                                              with_new=False)
    assert torch.all(m == da.NEG_INF) and not l_sum.any() and not o.any()


def _source_constants():
    """The kernel's constants as its source states them."""
    text = (t_build.csrc_dir() / t_build.SOURCES["decode_attention"]) \
        .read_text()

    def const(pat):
        return int(re.search(pat, text).group(1))
    return {"split": const(r"#define DECODE_SPLIT (\d+)"),
            "stages": const(r"#define DECODE_STAGES (\d+)"),
            "threads": const(r"constexpr int THREADS = (\d+);"),
            "slice": const(r"constexpr int SLICE = (\d+);"),
            "max_hd": const(r"constexpr int MAX_HD = (\d+);"),
            "max_g": const(r"constexpr int MAX_G = (\d+);")}


_C = _source_constants()
WARPS, SLICE, SPLIT = _C["threads"] // 32, _C["slice"], _C["split"]


def _fma(a, b, c):
    """fmaf: a * b + c rounded once to float32 (through float64, where the
    product of two float32 values is exact)."""
    return (a.double() * b.double() + c.double()).float()


def _geometry(hd):
    """(hd padded to whole lane slices, lanes a row, rows a warp step)."""
    hdp = -(-hd // SLICE) * SLICE
    lpr = 1
    while lpr * SLICE < hdp:
        lpr *= 2
    return hdp, lpr, 32 // lpr


def _halvings(n):
    """n / 2, n / 4, ..., 1 (none for n = 1): a butterfly's offsets."""
    out = []
    while n > 1:
        n //= 2
        out.append(n)
    return out


def _butterfly(v, offsets):
    """``v += shfl_xor(v, o)`` over the last axis (the lanes), for each
    offset in turn; every lane ends with the same bits."""
    idx = torch.arange(v.shape[-1])
    for o in offsets:
        v = v + v[..., idx ^ o]
    return v


def _slice_dots(qh, rows, hd):
    """Scores before the scale, (G, n): each lane's 8 products in element
    order (fmaf), then the butterfly over the row's lanes (lpr / 2 .. 1)."""
    hdp, lpr, _ = _geometry(hd)
    G, n = qh.shape[0], rows.shape[0]
    qp = torch.zeros(G, lpr * SLICE)
    kp = torch.zeros(n, lpr * SLICE)
    qp[:, :hd], kp[:, :hd] = qh, rows
    qp, kp = qp.view(G, 1, lpr, SLICE), kp.view(1, n, lpr, SLICE)
    acc = torch.zeros(G, n, lpr)
    for e in range(SLICE):
        acc = _fma(qp[..., e], kp[..., e], acc)
    return _butterfly(acc, _halvings(lpr))[..., 0]


def _split(qh, K, V, scale):
    """One block's split: (m (G,), l (G,), P V (G, hd)) over its n rows."""
    G, hd = qh.shape
    n = K.shape[0]
    hdp, lpr, rpw = _geometry(hd)
    s = _slice_dots(qh, K.float(), hd) * scale
    m = s.max(dim=1).values
    p = torch.exp(s - m[:, None])
    lanes = torch.zeros(G, 32)
    for c0 in range(0, n, 32):
        w = min(32, n - c0)
        lanes[:, :w] = lanes[:, :w] + p[:, c0:c0 + w]
    l_sum = _butterfly(lanes, _halvings(32))[:, 0]
    pr = p.to(V.dtype).float()                       # (G, n)
    step = WARPS * rpw
    steps = -(-n // step)
    vp = torch.zeros(steps * step, hdp)
    vp[:n, :hd] = V.float()
    pp = torch.zeros(G, steps * step)
    pp[:, :n] = pr
    live = torch.arange(steps * step) < n
    acc = torch.zeros(WARPS, rpw, G, hdp)
    for c in range(steps):
        sl = slice(c * step, (c + 1) * step)
        x = vp[sl].view(WARPS, rpw, 1, hdp)
        w8 = pp[:, sl].T.reshape(WARPS, rpw, G, 1)
        acc = torch.where(live[sl].view(WARPS, rpw, 1, 1),
                          _fma(w8, x, acc), acc)
    # the row slots (lane offsets 16 .. lpr), then the warps in order
    acc = _butterfly(acc.permute(0, 2, 3, 1), _halvings(rpw))[..., 0]
    o_sum = acc[0]
    for w in range(1, WARPS):
        o_sum = o_sum + acc[w]
    return m, l_sum, o_sum[:, :hd]


def _kernel_emulated(q, ck, cv, kn, vn, pos, offset=0, partial=False,
                     with_new=True):
    """The CUDA kernel's arithmetic on the CPU, per (row, KV head): splits
    of SPLIT seen positions (``_split``), joined in split order with the
    new token.  Returns what the wrapper returns."""
    B, _, H, hd = q.shape
    KV, L = ck.shape[2], ck.shape[1]
    G = H // KV
    scale = torch.tensor(da._scale_value(hd), dtype=torch.float32)
    seen = da.seen_rows(pos, B, L, offset)
    out = torch.empty((B, H, hd), dtype=torch.float32 if partial
                      else q.dtype)
    m_out = torch.empty((B, H))
    l_out = torch.empty((B, H))
    for b in range(B):
        for k in range(KV):
            qh = q[b, 0, k * G:(k + 1) * G].float()
            parts = [_split(qh, ck[b, c0:min(c0 + SPLIT, seen[b]), k],
                            cv[b, c0:min(c0 + SPLIT, seen[b]), k], scale)
                     for c0 in range(0, seen[b], SPLIT)]
            if with_new or not partial:
                s_new = _slice_dots(qh, kn[b, 0, k:k + 1].float(), hd)[:, 0] \
                    * scale
                M = s_new
            else:
                M = torch.full((G,), da.NEG_INF)
            for m, _, _ in parts:
                M = torch.maximum(M, m)
            S = torch.zeros(G)
            for m, l_sum, _ in parts:
                S = _fma(l_sum, torch.exp(m - M), S)
            e_new = torch.exp(s_new - M) if (with_new or not partial) \
                else torch.zeros(G)
            S = S + e_new
            o = torch.zeros(G, hd)
            for m, _, o_c in parts:
                o = _fma(o_c, torch.exp(m - M)[:, None], o)
            v = vn[b, 0, k].float()[None, :]
            rows = slice(k * G, (k + 1) * G)
            if not partial:
                w_new = (e_new / S).to(q.dtype).float()[:, None]
                out[b, rows] = _fma(w_new, v, o / S[:, None]).to(q.dtype)
            else:
                if with_new:
                    o = _fma(e_new.to(q.dtype).float()[:, None], v, o)
                out[b, rows] = o
                m_out[b, rows], l_out[b, rows] = M, S
    if partial:
        return m_out, l_out, out
    return out.reshape(B, 1, H * hd)


# the serving paths' (G, hd): minitron-4b, the vlm's self-attention,
# whisper's decoder, granite-moe (chip_smoke.decode_attention_cases)
SERVING_PAIRS = [(3, 128), (4, 128), (1, 64), (2, 64)]
GATES = [("bfloat16", 2.0 ** -8), ("float32", 1e-5)]


def _emulation_inputs(G, hd, dtype, B=3, KV=2, seed=7):
    L = 3 * SPLIT + 37                 # three whole splits and a ragged tail
    dt = getattr(torch, dtype)
    arrs = [torch.as_tensor(a).to(dt) for a in
            _inputs(seed + G + hd, B, L, G * KV, KV, hd)]
    return arrs, L, torch.tensor([5, SPLIT + 1, L][:B])


@pytest.mark.parametrize("dtype,tol", GATES)
@pytest.mark.parametrize("G,hd", SERVING_PAIRS)
def test_kernel_arithmetic_within_the_card_gates(G, hd, dtype, tol):
    """The kernel's arithmetic at each serving (G, hd), over one split, two
    and four with a ragged tail: within the gates ``chip_smoke.py`` holds
    the kernel to (rel-L2 2**-8 in bf16, 1e-5 in float32); each row the
    same alone as beside the others, and each KV head with its query heads
    the same alone as in the whole call."""
    (q, ck, cv, kn, vn), L, pos = _emulation_inputs(G, hd, dtype)
    got = _kernel_emulated(q, ck, cv, kn, vn, pos)
    assert _rel(got.float(), da.decode_attention_plain(
        q, ck, cv, kn, vn, pos).float()) <= tol
    for b in range(q.shape[0]):
        alone = _kernel_emulated(q[b:b + 1], ck[b:b + 1], cv[b:b + 1],
                                 kn[b:b + 1], vn[b:b + 1], pos[b:b + 1])
        assert torch.equal(alone, got[b:b + 1])
    head = _kernel_emulated(q[:, :, G:], ck[:, :, 1:], cv[:, :, 1:],
                            kn[:, :, 1:], vn[:, :, 1:], pos)
    assert torch.equal(head, got[..., G * hd:])


@pytest.mark.parametrize("pieces", [2, 4])
@pytest.mark.parametrize("dtype,tol", GATES)
def test_kernel_partial_form_joined_within_the_card_gates(dtype, tol,
                                                          pieces):
    """The kernel's partial form over 2 and 4 pieces of the positions (the
    new token in the first), joined by ``join_partials``: within the card's
    gates against the plain whole, as ``chip_smoke`` holds it; a piece no
    query sees gives m = NEG_INF, l = 0, o = 0."""
    (q, ck, cv, kn, vn), L, pos = _emulation_inputs(3, 128, dtype)
    w = L // pieces
    parts = [_kernel_emulated(q, ck[:, j * w:(j + 1) * w],
                              cv[:, j * w:(j + 1) * w], kn, vn, pos,
                              offset=j * w, partial=True, with_new=j == 0)
             for j in range(pieces)]
    tail = L - pieces * w
    if tail:
        parts.append(_kernel_emulated(q, ck[:, pieces * w:],
                                      cv[:, pieces * w:], kn, vn, pos,
                                      offset=pieces * w, partial=True,
                                      with_new=False))
    want = da.decode_attention_plain(q, ck, cv, kn, vn, pos)
    assert _rel(da.join_partials(parts, q.dtype).float(),
                want.float()) <= tol
    m, l_sum, o = _kernel_emulated(q, ck, cv, kn, vn, pos * 0, partial=True,
                                   with_new=False)
    assert torch.all(m == da.NEG_INF) and not l_sum.any() and not o.any()


def test_cpu_takes_the_plain_version_and_counts_no_launch():
    q, ck, cv, kn, vn = (torch.as_tensor(a) for a in
                         _inputs(1, 2, 10, 4, 2, 16))
    before = counts.snapshot()
    got = da.decode_attention(q, ck, cv, kn, vn, 7)
    assert torch.equal(got, da.decode_attention_plain(q, ck, cv, kn, vn, 7))
    m, l_sum, o = da.decode_attention_partial(q, ck, cv, kn, vn, 7,
                                              offset=2, with_new=False)
    want = da.decode_attention_partial_plain(q, ck, cv, kn, vn, 7, offset=2,
                                             with_new=False)
    assert all(torch.equal(a, b) for a, b in zip((m, l_sum, o), want))
    assert counts.snapshot() == before
    assert counts.COUNTERS["decode_attention"] == (da, "launches")


def test_meta_plans_a_call_with_the_positions_seen():
    B, L, H, KV, hd = 2, 300, 24, 8, 128
    meta = [torch.empty(s, dtype=torch.bfloat16, device="meta") for s in
            ((B, 1, H, hd), (B, L, KV, hd), (B, L, KV, hd), (B, 1, KV, hd),
             (B, 1, KV, hd))]
    launches = counts.snapshot()
    before = (planned.calls["decode_attention"],
              planned.ops["decode_attention"],
              planned.traffic["decode_attention"])
    out = da.decode_attention(*meta, 100)
    assert out.device.type == "meta" and tuple(out.shape) == (B, 1, H * hd)
    assert out.dtype == torch.bfloat16
    n_ops, n_bytes = da.work(B, H, KV, hd, [100, 100], 2)
    assert planned.calls["decode_attention"] == before[0] + 1
    assert planned.ops["decode_attention"] == before[1] + n_ops
    assert planned.traffic["decode_attention"] == before[2] + n_bytes
    m, l_sum, o = da.decode_attention_partial(*meta, 100, offset=50,
                                              with_new=False)
    assert tuple(o.shape) == (B, H, hd) and o.dtype == torch.float32
    assert tuple(m.shape) == tuple(l_sum.shape) == (B, H)
    assert counts.snapshot() == launches
    with pytest.raises(ValueError):
        da.decode_attention(meta[0][..., :64], *meta[1:], 100)


def test_launch_refuses_what_the_kernel_cannot_take_and_never_falls_back(
        monkeypatch):
    """The CUDA path's refusals come before any library is loaded, with
    the kernel's own limits (``csrc/decode_attention.cu``); past them it
    builds and launches or raises: here, with no ``nvcc``, it raises."""
    text = (t_build.csrc_dir() / t_build.SOURCES["decode_attention"]) \
        .read_text()
    assert t_build.SOURCES["decode_attention"] == "decode_attention.cu"
    assert "decode_attention_split" in text
    assert (_C["split"], _C["stages"]) == (da.SPLIT, da.STAGES)
    assert (_C["max_hd"], _C["max_g"]) == (da.MAX_HEAD_DIM, da.MAX_GROUP)
    assert re.search(r"constexpr int SPLIT = (\w+);", text).group(1) \
        == "DECODE_SPLIT"

    def launch(B=1, L=8, H=2, KV=1, hd=16, dtype=torch.float32):
        q, ck, cv, kn, vn = (torch.as_tensor(a).to(dtype) for a in
                             _inputs(0, B, L, H, KV, hd))
        return da._launch(q, ck, cv, kn, vn, 3, 0, False, True)
    with pytest.raises(ValueError, match="head dim"):
        launch(hd=da.MAX_HEAD_DIM + 1)
    with pytest.raises(ValueError, match="query heads"):
        launch(H=da.MAX_GROUP + 1)
    with pytest.raises(TypeError, match="float32 or bf16"):
        launch(dtype=torch.float64)
    monkeypatch.setattr(t_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", "/nonexistent/k")
    da._library.cache_clear()
    with pytest.raises((FileNotFoundError, OSError)):
        launch()
    da._library.cache_clear()


def test_chip_smoke_kernel_groups_name_the_sources_kernels():
    """Every CUDA kernel name ``chip_smoke.KERNEL_GROUPS`` lists for
    decode attention is a ``__global__`` function of its source, and every
    ``__global__`` function of the source is listed: a renamed kernel's
    time would otherwise land in "other torch kernels"."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    text = (t_build.csrc_dir() / t_build.SOURCES["decode_attention"]) \
        .read_text()
    kernels = set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\("
                             r"(?:[^()]|\([^()]*\))*\)\s+)?(\w+)\s*\(",
                             text))
    listed = dict(cs.KERNEL_GROUPS)["decode_attention"]
    assert kernels and {k.removeprefix("::") for k in listed} == kernels
    for k in kernels:
        assert cs.kernel_group(f"void (anonymous namespace)::{k}"
                               f"<__nv_bfloat16, 3>((anonymous namespace)"
                               f"::Args)") == "decode_attention"


def test_arrival_counters_grow_outside_a_capture_and_keep_old_buffers(
        monkeypatch):
    """One zeroed counter buffer per device, grown to the largest call; an
    outgrown buffer stays alive (a captured graph holds its address); no
    growth inside a graph capture; the scale is formed once per head dim,
    equal to the plain version's."""
    dev = torch.device("cpu")
    monkeypatch.setattr(da, "_counters", {})
    monkeypatch.setattr(da, "_retired_counters", [])
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    first = da._arrival_counters(dev, 32)
    assert first.dtype == torch.int32 and first.numel() >= 32
    assert not first.any()
    assert da._arrival_counters(dev, 16) is first
    grown = da._arrival_counters(dev, first.numel() + 1)
    assert grown.numel() > first.numel() and not grown.any()
    assert da._retired_counters == [first]
    capturing[0] = True
    assert da._arrival_counters(dev, 8) is grown
    with pytest.raises(RuntimeError, match="capture"):
        da._arrival_counters(dev, grown.numel() + 1)
    for hd in (64, 100, 128):
        assert da._scale_value(hd) == float(da.score_scale(hd))
