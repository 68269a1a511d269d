"""The decode-attention kernel's module (``kernels/decode_attention.py``):

  * the plain version against the reference's ``_attend_decode``
    (``src/repro/models/attention.py:202``) on numpy-seeded inputs:
    float32 rel-L2 <= 1e-5, bf16 within one bf16 ulp, scalar and per-row
    positions, G = 1 and 3, hd 16 and 64;
  * the partial form joined over 2 and 4 pieces of the positions (the new
    token in one) against the whole, float32 <= 1e-6;
  * the kernel's arithmetic (chunks of ``CHUNK`` positions, each with its
    own max and the unnormalised weights rounded to the cache dtype, joined
    in chunk order) emulated here: at the card's gates against the plain
    version, and a row's output independent of the other rows;
  * the wrapper's device rules: the plain version for CPU tensors (no
    launch counted), a planned call on meta tensors (operations and bytes
    of the positions seen), on any other device the kernel or an error;
    ``build.SOURCES`` naming the source, whose limits equal the module's."""
import re

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


def _kernel_emulated(q, ck, cv, kn, vn, pos):
    """The CUDA kernel's arithmetic on the CPU: per row and KV head, chunks
    of ``CHUNK`` seen positions, each with its own max and its weights
    exp(s - max) rounded to the cache dtype for the V sum, joined in chunk
    order with the new token (whose normalised weight rounds to q's
    dtype)."""
    B, _, H, hd = q.shape
    KV, L = ck.shape[2], ck.shape[1]
    G = H // KV
    scale = da.score_scale(hd)
    seen = da.seen_rows(pos, B, L)
    out = torch.empty((B, 1, H, hd), dtype=q.dtype)
    for b in range(B):
        for h in range(H):
            k = h // G
            qv = q[b, 0, h].float()
            ms, ls, os_ = [], [], []
            for c0 in range(0, seen[b], da.CHUNK):
                c1 = min(c0 + da.CHUNK, seen[b])
                s = (ck[b, c0:c1, k].float() @ qv) * scale
                m = s.max()
                p = torch.exp(s - m)
                ms.append(m)
                ls.append(p.sum())
                os_.append(p.to(cv.dtype).float() @ cv[b, c0:c1, k].float())
            s_new = (kn[b, 0, k].float() @ qv) * scale
            M = torch.stack(ms + [s_new]).max()
            S = sum(l_ * torch.exp(m - M) for m, l_ in zip(ms, ls))
            e_new = torch.exp(s_new - M)
            S = S + e_new
            o = sum((o_ * torch.exp(m - M) for m, o_ in zip(ms, os_)),
                    torch.zeros(hd))
            o = o / S + (e_new / S).to(q.dtype).float() * vn[b, 0, k].float()
            out[b, 0, h] = o.to(q.dtype)
    return out.reshape(B, 1, H * hd)


@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2.0 ** -8),
                                       ("float32", 1e-5)])
def test_kernel_arithmetic_within_the_card_gates(dtype, tol):
    """Chunked, with chunk-local maxima and weights rounded before their
    normalisation: within the gates ``chip_smoke.py`` holds the kernel to
    (rel-L2 2**-8 in bf16, 1e-5 in float32), and each row the same alone
    as beside the others."""
    B, L, H, KV, hd = 3, 3 * da.CHUNK + 5, 6, 2, 32
    dt = getattr(torch, dtype)
    q, ck, cv, kn, vn = (torch.as_tensor(a).to(dt) for a in
                         _inputs(7, B, L, H, KV, hd))
    pos = torch.tensor([5, da.CHUNK + 1, L])
    got = _kernel_emulated(q, ck, cv, kn, vn, pos)
    assert _rel(got.float(), da.decode_attention_plain(
        q, ck, cv, kn, vn, pos).float()) <= tol
    alone = _kernel_emulated(q[1:2], ck[1:2], cv[1:2], kn[1:2], vn[1:2],
                             pos[1:2])
    assert torch.equal(alone, got[1:2])


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
    assert int(re.search(r"CHUNK = (\d+);", text).group(1)) == da.CHUNK
    assert int(re.search(r"MAX_HD = (\d+);", text).group(1)) \
        == da.MAX_HEAD_DIM
    assert int(re.search(r"MAX_G = (\d+);", text).group(1)) == da.MAX_GROUP

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
