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
"""
import importlib.util
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
