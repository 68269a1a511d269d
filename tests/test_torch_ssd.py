"""The intra-chunk SSD kernel's plain version and the port's ``ssd_chunked``
against the JAX reference, on the same inputs (numpy seeds).

* ``ssd_chunk_plain`` vs the JAX ``ops.ssd_chunk`` (the Pallas kernel in
  interpret mode, as the JAX tests run it) and the ``ssd_chunk_ref``
  oracles, at the JAX tests' shapes: rtol = atol = 2e-4, the JAX tests'
  own tolerance.  At one full-width chunk (L 256, P 64, N 128) outputs
  reach |y| ~ 110 and the decay exponent |cs| ~ 220, so one fp32 ulp of
  the cumsum (1.5e-5; the JAX kernel sums it as a matmul, the oracle and
  the port sequentially) moves y by ~1e-3: there the JAX kernel and its
  own oracle differ by 8e-4 in one of 32768 entries, beyond an
  elementwise 2e-4.  That case is held to rel-L2 <= 2e-4 instead.
* A stride-0 (head-broadcast view) B/C gives the bits of a materialised
  copy.
* The port's ``ssd_chunked`` (kernel path) vs the JAX ``ssd_chunked`` and
  the sequential ``ssd_reference`` (the ``test_kernels.py`` composition,
  5e-4), with a ragged S, several chunks, groups and an initial state.
* The decay's numerics at mamba2's widths: the kernel forms
  ``exp(cs_i - cs_j)`` from a per-chunk cumsum, the reference's
  ``ssd_chunked`` the same decay from a masked cumsum of the steps.  At
  A = -linspace(1, 16, 48) |cs| reaches thousands in a 256-step chunk;
  the gap stays inside the 5e-4 composition gate, which is held
  unchanged.
* What the on-card check of the kernel (``chip_smoke.py``) can see: at
  mamba2's decay only the diagonal and the adjacent key tile of a query
  row, and only the last 64 rows of the state, carry weight, so its slow-
  decay cases are the ones that would catch a kernel that dropped the
  rest.
* The kernel's arithmetic, emulated: each product in 3xTF32 (operands
  split into TF32 hi and lo parts, rounded as ``cvt.rna.tf32.f32``; lo*hi
  + hi*lo + hi*hi in float32), C B^T once per group of heads.  Against the
  float64 algebra it sits at the float32 plain version's level, within the
  card check's 1e-4; one-pass TF32 falls outside it (why the kernel takes
  three passes).
* The card check's cases (ragged tails, both decays, both B/C layouts),
  its bound's operation count and the kernel's launch plan.
"""
import importlib.util
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.models import ssm as j_ssm

from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels import ssd as t_ssd
from repro_torch.models import ssm as t_ssm

torch.set_num_threads(2)
KTOL = 2e-4
CTOL = 5e-4


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _chunk_inputs(seed, b, nc, L, H, P, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, nc, L, H, P)).astype(np.float32)
    dA = -np.log1p(np.exp(rng.standard_normal((b, nc, H, L)))).astype(
        np.float32)
    B = rng.standard_normal((b, nc, L, H, N)).astype(np.float32)
    C = rng.standard_normal((b, nc, L, H, N)).astype(np.float32)
    return x, dA, B, C


def _plain_and_wants(b, nc, L, H, P, N):
    arrs = _chunk_inputs(L * H + P, b, nc, L, H, P, N)
    y, st = t_ssd.ssd_chunk(*map(torch.as_tensor, arrs))
    assert tuple(y.shape) == (b, nc, L, H, P)
    assert tuple(st.shape) == (b, nc, H, N, P)
    assert y.dtype == st.dtype == torch.float32
    wants = (j_ops.ssd_chunk(*map(jnp.asarray, arrs)),
             j_ref.ssd_chunk_ref(*map(jnp.asarray, arrs)),
             t_ref.ssd_chunk_ref(*map(torch.as_tensor, arrs)))
    return y, st, wants


@pytest.mark.parametrize("b,nc,L,H,P,N", [
    (2, 3, 16, 2, 8, 4), (2, 3, 32, 4, 16, 8), (2, 3, 64, 1, 32, 16),
    (2, 2, 8, 1, 4, 2)])
def test_plain_matches_jax_kernel_and_oracles(b, nc, L, H, P, N):
    y, st, wants = _plain_and_wants(b, nc, L, H, P, N)
    for want_y, want_st in wants:
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y),
                                   rtol=KTOL, atol=KTOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(want_st),
                                   rtol=KTOL, atol=KTOL)


def test_plain_matches_jax_kernel_at_full_width_chunk():
    y, st, wants = _plain_and_wants(1, 1, 256, 2, 64, 128)
    for want_y, want_st in wants:
        assert _rel(y, want_y) <= KTOL and _rel(st, want_st) <= KTOL


def test_stride0_heads_equal_materialised_bitwise():
    """B/C as a stride-0 view over the head axis (one group) and a
    non-contiguous dA (the (b, nc, L, H) -> (b, nc, H, L) view) give the
    bits of contiguous copies."""
    b, nc, L, H, P, N = 2, 2, 32, 4, 16, 8
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.standard_normal((b, nc, L, H, P)),
                        dtype=torch.float32)
    dA = -torch.nn.functional.softplus(torch.as_tensor(
        rng.standard_normal((b, nc, L, H)), dtype=torch.float32))
    Bg = torch.as_tensor(rng.standard_normal((b, nc, L, 1, N)),
                         dtype=torch.float32)
    Cg = torch.as_tensor(rng.standard_normal((b, nc, L, 1, N)),
                         dtype=torch.float32)
    Bv, Cv = Bg.expand(b, nc, L, H, N), Cg.expand(b, nc, L, H, N)
    dAv = dA.permute(0, 1, 3, 2)
    assert Bv.stride(3) == 0 and not dAv.is_contiguous()
    y0, st0 = t_ops.ssd_chunk(x, dAv, Bv, Cv)
    y1, st1 = t_ops.ssd_chunk(x, dAv.contiguous(), Bv.contiguous(),
                              Cv.contiguous())
    assert torch.equal(y0, y1) and torch.equal(st0, st1)


def test_wrapper_refuses_bad_shapes():
    x, dA, B, C = map(torch.as_tensor, _chunk_inputs(0, 1, 1, 8, 2, 4, 2))
    with pytest.raises(ValueError, match="dA"):
        t_ssd.ssd_chunk(x, dA[..., :4], B, C)
    with pytest.raises(ValueError, match="B"):
        t_ssd.ssd_chunk(x, dA, B, C[..., :1])
    with pytest.raises(ValueError, match="x"):
        t_ssd.ssd_chunk(x[0], dA, B, C)


def test_launch_refuses_what_the_kernel_cannot_take():
    """The CUDA path's refusals, checked before any library is loaded; the
    limits are the kernel's own (``csrc/ssd_chunk.cu``)."""
    src = Path(t_ssd.__file__).resolve().parent.parent / "csrc" / \
        "ssd_chunk.cu"
    text = src.read_text()
    assert re.search(r"MAX_L = (\d+);", text).group(1) == str(t_ssd.MAX_L)
    assert re.search(r"BP = (\d+);", text).group(1) == str(t_ssd.MAX_P)

    def launch(L, P, dtype=torch.float32):
        x, dA, B, C = (torch.as_tensor(a, dtype=dtype) for a in
                       _chunk_inputs(0, 1, 1, L, 1, P, 2))
        return t_ssd._launch(x, dA, B, C, 1, 1, L, 1, P, 2)
    with pytest.raises(ValueError, match="P <= 64"):
        launch(8, t_ssd.MAX_P + 1)
    with pytest.raises(ValueError, match="L <= 4096"):
        launch(t_ssd.MAX_L + 1, 4)
    with pytest.raises(TypeError, match="float32"):
        launch(8, 4, torch.float64)


def _scan_inputs(seed, b, S, H, P, G, N, A=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H)))).astype(np.float32)
    if A is None:
        A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((b, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((b, S, G, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("b,S,H,P,G,N,L,with_h0", [
    (1, 32, 2, 8, 1, 4, 8, False),      # the test_kernels.py composition
    (2, 29, 4, 8, 1, 4, 8, False),      # ragged S: tail padding
    (1, 40, 4, 16, 2, 8, 16, True),     # two groups, an initial state
    (1, 8, 2, 4, 1, 2, 8, False)])      # one chunk
def test_ssd_chunked_matches_reference(b, S, H, P, G, N, L, with_h0):
    arrs = _scan_inputs(S + H, b, S, H, P, G, N)
    h0 = (np.random.default_rng(1).standard_normal((b, H, P, N)).astype(
        np.float32) if with_h0 else None)
    ty, th = t_ssm.ssd_chunked(*map(torch.as_tensor, arrs), L,
                               h0=None if h0 is None else torch.as_tensor(h0))
    assert tuple(ty.shape) == (b, S, H, P) and tuple(th.shape) == (b, H, P, N)
    jh0 = None if h0 is None else jnp.asarray(h0)
    jy, jh = j_ssm.ssd_chunked(*map(jnp.asarray, arrs), L, h0=jh0)
    ry, rh = j_ssm.ssd_reference(*map(jnp.asarray, arrs), h0=jh0)
    for want_y, want_h in ((jy, jh), (ry, rh)):
        np.testing.assert_allclose(ty.numpy(), np.asarray(want_y),
                                   rtol=CTOL, atol=CTOL)
        np.testing.assert_allclose(th.numpy(), np.asarray(want_h),
                                   rtol=CTOL, atol=CTOL)
    # the port's own sequential oracle agrees with the reference's
    th0 = None if h0 is None else torch.as_tensor(h0)
    py, ph = t_ssm.ssd_reference(*map(torch.as_tensor, arrs), h0=th0)
    np.testing.assert_allclose(py.numpy(), np.asarray(ry), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ph.numpy(), np.asarray(rh), rtol=1e-5,
                               atol=1e-5)


def test_decay_gap_at_mamba2_width():
    """One full-width chunk pair at mamba2's decay spread (48 heads, A =
    -linspace(1, 16), L 256, P 64, N 128): the cumsum-difference decay of
    the kernel path against the reference's ``_segsum`` path and the
    sequential oracle, held to the composition gate; the gap is also kept
    under 1e-5, the size it has had since the port (a larger one would
    mean the decay's rounding changed)."""
    x, dt, A, Bm, Cm = _scan_inputs(
        0, 1, 512, 48, 64, 1, 128,
        A=-np.linspace(1.0, 16.0, 48).astype(np.float32))
    cs = np.cumsum((dt * A).reshape(1, 2, 256, 48), axis=2)
    assert np.abs(cs).max() > 1e3          # the cancellation regime
    ty, th = t_ssm.ssd_chunked(*map(torch.as_tensor, (x, dt, A, Bm, Cm)),
                               256)
    jy, jh = j_ssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), 256)
    ry, rh = j_ssm.ssd_reference(*map(jnp.asarray, (x, dt, A, Bm, Cm)))
    gap = max(_rel(ty, jy), _rel(ty, ry), _rel(th, jh), _rel(th, rh))
    assert gap <= CTOL and gap <= 1e-5, gap


def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _far_tiles_dropped(x, dA, B, C, tile=64):
    """The plain algebra without what a faulty kernel might skip: the key
    tiles two or more back of each query tile (y) and every state row
    before the last ``tile`` (states)."""
    L = x.shape[2]
    cs = torch.cumsum(dA, -1)                               # (b,nc,H,L)
    i = torch.arange(L)
    near = (i[:, None] >= i[None, :]) & (
        i[None, :] // tile >= i[:, None] // tile - 1)
    seg = (cs[..., :, None] - cs[..., None, :]).masked_fill(~near, -torch.inf)
    scores = torch.einsum("bclhn,bcshn->bchls", C, B) * torch.exp(seg)
    y = torch.einsum("bchls,bcshp->bclhp", scores, x)
    decay = torch.exp(cs[..., -1:] - cs) * (i >= L - tile)  # (b,nc,H,L)
    st = torch.einsum("bclhn,bchl,bclhp->bchnp", B, decay, x)
    return y, st


@pytest.mark.parametrize("decay", ["slow", "mamba2"])
@pytest.mark.parametrize("H,N", [(48, 128), (128, 16)])
def test_chip_ssd_check_sees_every_tile(decay, H, N):
    """``chip_smoke.py``'s kernel inputs, one chunk at each of its widths:
    at the slow decay, dropping the far key tiles or the early state rows
    moves y and the states by more than 0.1 rel-L2, far past the check's
    2^-8; at mamba2's spread it would not reach 2^-8 (hence the slow cases
    beside the served ones)."""
    cs = _chip_smoke()
    gen = torch.Generator().manual_seed(7)
    args = cs.ssd_inputs(torch, gen, 1, 1, H, N, True, decay, device="cpu")
    y, st = t_ssd.ssd_chunk_plain(*args)
    y_cut, st_cut = _far_tiles_dropped(*(a.contiguous() for a in args))
    seen = min(_rel(y_cut, y), _rel(st_cut, st))
    if decay == "slow":
        assert seen > 0.1 > cs.SSD_TOL, seen
    else:
        assert max(_rel(y_cut, y), _rel(st_cut, st)) < cs.SSD_TOL


def test_chip_mvm_and_flash_cases_cover_regimes_and_variants():
    """``chip_smoke.py``'s kernel cases reach every code path of the two
    redesigned kernels on the card: both fused-MVM regimes in both bank
    orientations, both sides of the regime boundary, a ragged N; both flash
    variants, a float32 hd 16 case, and a case with a capacity buffer
    poisoned (NaN / inf) past kv_len."""
    from repro_torch.kernels import flash_attention as t_fa
    from repro_torch.kernels import photonic_mvm as t_pm
    cs = _chip_smoke()
    mvm = cs.mvm_cases()
    seen = {(t_pm.launch_plan(M, K, N, tr).regime, tr)
            for _, M, K, N, tr, _, _ in mvm}
    assert seen == {("gemv", False), ("gemv", True), ("mma", False),
                    ("mma", True)}
    widths = {M for _, M, _, _, _, _, _ in mvm}
    assert {t_pm.GEMV_MAX_M, t_pm.GEMV_MAX_M + 1, 40, 512, 600} <= widths
    assert any(N % 128 for _, _, _, N, _, _, _ in mvm)
    flash = cs.flash_cases()
    variants = {t_fa.flash_variant(getattr(torch, c[10]), c[8], c[9])
                for c in flash}
    assert variants == {"mma", "simt"}
    assert any(c[10] == "float32" and c[8] == 16 for c in flash)
    poisoned = [c for c in flash if c[11]]
    assert poisoned and all(c[5] < c[3] for c in poisoned)   # kv_len < L
    k = torch.zeros(2, 10, 4)
    cs.poison_past(k, 6)
    assert torch.isfinite(k[:, :6]).all() and not torch.isfinite(k[:, 6:]
                                                                 ).any()
    assert torch.isnan(k[:, 6:]).any() and torch.isinf(k[:, 6:]).any()


# ---------------------------------------------------------------- 3xTF32
def _tf32(a):
    """``cvt.rna.tf32.f32`` on finite values: add half a TF32 ulp to the
    magnitude bits, clear the 13 low bits (round to nearest, ties away)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(a):
    hi = _tf32(a)
    return hi, _tf32(a - hi)


def _mm_3xtf32(a, b):
    """a @ b as the kernel's wgmmas take it: lo*hi + hi*lo + hi*hi, float32
    accumulators (products of TF32 values are exact in float32)."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return al @ bh + ah @ bl + ah @ bh


def _mm_tf32(a, b):
    return _tf32(a) @ _tf32(b)


def _emulate(x, dA, B, C, mm):
    """The kernel's algebra with stride-0 B/C: C B^T once for the group,
    then per head the decay exp(cs_i - cs_j) on the causal triangle (masked
    entries never exponentiated), the decayed scores times x, and the
    states (B o exp(cs_L - cs))^T x; every product through ``mm``."""
    L = x.shape[2]
    Bg, Cg = B[:, :, :, 0], C[:, :, :, 0]                 # (b,nc,L,N)
    scores = mm(Cg, Bg.transpose(-1, -2))                 # (b,nc,L,L)
    cs = torch.cumsum(dA, -1)                             # (b,nc,H,L)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((L, L), dtype=torch.bool).tril()
    decay = torch.where(mask, torch.exp(torch.where(mask, seg, 0.0)), 0.0)
    xh = x.permute(0, 1, 3, 2, 4)                         # (b,nc,H,L,P)
    y = mm(scores[:, :, None] * decay, xh).permute(0, 1, 3, 2, 4)
    Bd = Bg[:, :, None] * torch.exp(cs[..., -1:] - cs)[..., None]
    st = mm(Bd.transpose(-1, -2), xh)                     # (b,nc,H,N,P)
    return y, st


def _ssd_float64(x, dA, B, C):
    """``kernels/ref.ssd_chunk_ref``'s algebra in float64."""
    L = x.shape[2]
    x, dA, B, C = (t.to(torch.float64) for t in (x, dA, B, C))
    cs = torch.cumsum(dA, -1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((L, L), dtype=torch.bool).tril()
    Lmat = torch.exp(seg.masked_fill(~mask, float("-inf")))
    scores = torch.einsum("bclhn,bcshn->bchls", C, B)
    y = torch.einsum("bchls,bcshp->bclhp", scores * Lmat, x)
    decay = torch.exp(cs[..., -1:] - cs)
    st = torch.einsum("bclhn,bclhp->bchnp",
                      B * decay.permute(0, 1, 3, 2)[..., None], x)
    return y, st


@pytest.mark.parametrize("decay", ["mamba2", "slow"])
@pytest.mark.parametrize("b,nc,L,H,P,N", [(1, 2, 256, 48, 64, 128),
                                         (1, 1, 100, 6, 40, 20)])
def test_3xtf32_arithmetic_holds_float32_level(b, nc, L, H, P, N, decay):
    """The kernel's 3xTF32 arithmetic (C B^T once per group) against the
    float64 algebra, on ``chip_smoke.py``'s inputs: y and the states within
    the card check's 1e-4 (at the float32 plain version's level: ~3e-6
    where mamba2's |cumsum| reaches thousands, ~3e-7 at the slow decay);
    one-pass TF32 reads 2.8e-4 to 4.2e-4, outside it."""
    cs = _chip_smoke()
    gen = torch.Generator().manual_seed(7)
    args = cs.ssd_inputs(torch, gen, b, nc, H, N, True, decay, L=L, P=P,
                         device="cpu")
    want_y, want_st = _ssd_float64(*args)
    y, st = _emulate(*args, _mm_3xtf32)
    assert max(_rel(y, want_y), _rel(st, want_st)) <= cs.SSD_F32_TOL
    plain_y, plain_st = t_ssd.ssd_chunk_plain(*args)
    assert _rel(y, want_y) <= 2 * _rel(plain_y, want_y) + 1e-6
    assert _rel(st, want_st) <= 2 * _rel(plain_st, want_st) + 1e-6
    y1, st1 = _emulate(*args, _mm_tf32)
    assert min(_rel(y1, want_y), _rel(st1, want_st)) > cs.SSD_F32_TOL


def test_tf32_rounding_is_round_to_nearest_ties_away():
    """``_tf32`` keeps 10 mantissa bits, rounding half away from zero, and
    hi + lo carries a float32 value to within 2^-22 of itself."""
    one_ulp = 2.0 ** -10
    a = torch.tensor([1.0 + one_ulp / 2, -(1.0 + one_ulp / 2),
                      1.0 + one_ulp / 2 - 2.0 ** -23, 3.0e-3, -7.25e5])
    hi = _tf32(a)
    assert hi[0] == 1.0 + one_ulp and hi[1] == -(1.0 + one_ulp)
    assert hi[2] == 1.0
    assert torch.all((hi.view(torch.int32) & 0x1FFF) == 0)
    rng = np.random.default_rng(0)
    v = torch.as_tensor(rng.standard_normal(4096) * 10.0 ** rng.integers(
        -6, 6, 4096), dtype=torch.float32)
    h, lo = _split(v)
    err = ((h.double() + lo.double()) - v.double()).abs() / v.double().abs()
    assert float(err.max()) <= 2.0 ** -22


# ------------------------------------------------- the card check's cases
def test_chip_ssd_cases_cover_ragged_tails_both_decays_and_layouts():
    """``chip_smoke.py``'s SSD cases: every served chunk count (b * nc = 1,
    2, 6, 8) at mamba2's widths and the jamba-width pair, and a ragged
    chunk whose every tile is partial (L past a 64-row tile, P below one,
    N past a 32-wide slice and an 8-wide mma step), each at both decays;
    the mamba2 and ragged ones with stride-0 and materialised B/C."""
    cs = _chip_smoke()
    cases = cs.ssd_cases()
    seen = {(b * nc, L, H, P, N, s0, decay)
            for _, b, nc, L, H, P, N, s0, decay in cases}
    for decay in ("mamba2", "slow"):
        for bnc in (1, 2, 6, 8):
            for s0 in (True, False):
                assert (bnc, 256, 48, 64, 128, s0, decay) in seen
        assert (2, 256, 128, 64, 16, True, decay) in seen
        ragged = [c for c in seen if c[1] % 64 and c[6] == decay]
        assert {c[5] for c in ragged} == {True, False}
        for _, L, H, P, N, _, _ in ragged:
            assert L % 64 and P < t_ssd.MAX_P and N % 32 and N % 8
    assert len({c[0] for c in cases}) == len(cases)   # labels are unique
    # the slow decay's ragged case still weighs every key and state row
    gen = torch.Generator().manual_seed(7)
    x, dA, B, C = cs.ssd_inputs(torch, gen, 1, 1, 6, 20, True, "slow",
                                L=100, P=40, device="cpu")
    assert float(torch.cumsum(dA, -1).abs().max()) < 1.0


def _direct_ssd_ops(b, nc, L, H, P, N, stride0):
    """Multiply-adds x 2, counted pair by pair: scores over N for every
    (i, j <= i) of each group, x over P for every pair of each head, the
    states over L x N x P of each head."""
    macs = 0
    for _ in range(b * nc):
        for i in range(L):
            for _ in range(i + 1):
                macs += N * (1 if stride0 else H) + H * P
        macs += H * L * N * P
    return 2 * macs


@pytest.mark.parametrize("b,nc,L,H,P,N", [(1, 1, 8, 3, 4, 5),
                                         (2, 3, 100, 6, 40, 20)])
def test_chip_ssd_bound_counts_the_work(b, nc, L, H, P, N):
    """``chip_smoke.ssd_bound`` counts the operations of a stride-0 call
    (C B^T once per group) and of a materialised one (once per head), at
    the 3xTF32 rate, and keeps the fp32 CUDA-core bound beside it; at
    mamba2's b=1 nc=8 the shared scores halve the work, 6.46 -> 3.30
    GFLOP."""
    cs = _chip_smoke()
    for s0 in (True, False):
        bound, by, nbytes, flops, bound_fp32 = cs.ssd_bound(b, nc, L, H, P,
                                                            N, s0)
        assert flops == _direct_ssd_ops(b, nc, L, H, P, N, s0)
        t_ops = flops / cs.TF32X3_FLOPS * 1e3
        t_bytes = nbytes / cs.HBM_BYTES_S * 1e3
        assert bound == max(t_ops, t_bytes)
        assert by == ("bytes" if t_bytes >= t_ops else "operations")
        assert bound_fp32 >= t_bytes
    shared = cs.ssd_ops(1, 8, 256, 48, 64, 128, True)
    per_head = cs.ssd_ops(1, 8, 256, 48, 64, 128, False)
    assert abs(shared / 1e9 - 3.30) < 0.01 and abs(per_head / 1e9 - 6.46) < 0.01
    assert cs.ssd_bound(1, 8, 256, 48, 64, 128, True)[1] == "operations"


# ------------------------------------------------------------ launch plan
@pytest.mark.parametrize("b,nc,hb", [(1, 1, 1), (1, 2, 2), (2, 3, 4),
                                     (1, 8, 4)])
def test_ssd_launch_plan_groups_heads_and_fills_the_card(b, nc, hb):
    """At mamba2's widths a stride-0 call groups 1, 2 or 4 heads per query
    block (one scores tile for the group), keeping at least a block per
    block slot of an H100 (two per SM): b=1 nc=1 keeps one head and 288
    blocks.  Materialised B/C take one head; the grid of any other
    grouping (``_plan``, chip_smoke's groups of 3) is counted the same
    way; the heaviest query tiles launch first."""
    plan = t_ssd.ssd_launch_plan(b, nc, 256, 48, 64, 128, True)
    assert plan.heads_per_block == hb
    assert plan.state_heads_per_block == max(1, hb // 2)
    assert plan.blocks >= t_ssd.BLOCKS_PER_SM * 132
    assert plan.blocks == (plan.query_tiles * plan.query_cells
                           + plan.state_tiles * plan.state_cells)
    assert plan.query_cells == b * nc * math.ceil(48 / hb)
    assert (plan.query_tiles, plan.state_tiles) == (4, 2)
    assert 0 <= plan.heavy <= plan.query_tiles
    if (b, nc) == (1, 1):
        assert plan.blocks == 288
    assert t_ssd.ssd_launch_plan(b, nc, 256, 48, 64, 128,
                                 False).heads_per_block == 1
    forced = t_ssd._plan(b, nc, 256, 48, 64, 128, True, 3, 5)
    assert (forced.heads_per_block, forced.state_heads_per_block) == (3, 5)
    assert forced.query_cells == b * nc * 16
    assert t_ssd._plan(1, 1, 8, 4, 16, 8, True, 64, 1).heads_per_block == 4
