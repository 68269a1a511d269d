"""The port's kernel modules on the CPU: the plain versions of the fused
W8A8 MVM and of flash attention against the JAX Pallas kernels (interpret
mode, as the reference's own tests run them) and the reference oracles.

Tolerances: float32 outputs rel-L2 <= 1e-5 (the same float32 arithmetic
summed in another order); bf16 outputs elementwise within one bf16 ulp of
the reference (a float32 sum-order difference can move a value across one
bf16 rounding boundary), plus 1e-6 of the largest output for entries that
cancel to near zero.  The CUDA kernels themselves run only on the card:
``chip_smoke.py`` holds each against its plain version there.
"""
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import photonic as j_photonic
from repro.kernels import flash_attention as j_fa
from repro.kernels import ops as j_ops
from repro.kernels import photonic_mvm as j_pm
from repro.kernels import ref as j_ref

from repro_torch.core import photonic as t_photonic
from repro_torch.kernels import build as t_build
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import photonic_mvm as t_pm
from repro_torch.kernels import ref as t_ref

torch.set_num_threads(2)
F32_TOL = 1e-5


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _within_one_bf16_ulp(got, want):
    """|got - want| <= one bf16 ulp of the larger of the two, plus 1e-6 of
    the output's largest magnitude for entries that cancel to near zero
    (there a float32 sum-order difference is large relative to the entry
    but not to the operands)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    mag = np.maximum(np.maximum(np.abs(want), np.abs(got)),
                     np.float32(2.0 ** -120))
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    floor = 1e-6 * float(np.abs(want).max())
    return bool(np.all(np.abs(got - want) <= ulp + floor))


MVM_CASES = [
    # M, K, N, transpose, activation, bias, (block_perm, block)
    (1, 64, 96, False, "none", False, None),
    (3, 96, 160, True, "silu", False, None),
    (8, 128, 128, False, "relu", True, None),
    (130, 72, 200, True, "none", True, None),
    (8, 64, 128, False, "silu", True, ((1, 3, 0, 2), 32)),
    (130, 96, 160, True, "relu", False, ((4, 2, 0, 1, 3), 32)),
]


def _mvm_inputs(M, K, N, transpose, bias, seed, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[0, 0] = 4.0                                  # an outlier sets the scale
    wq = rng.integers(-127, 128, (N, K) if transpose else (K, N),
                      dtype=np.int8)
    ws = (rng.random(N) * 0.05 + 0.01).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32) if bias else None
    jx = jnp.asarray(x, dtype)
    tx = torch.as_tensor(x).to(torch.bfloat16 if dtype == jnp.bfloat16
                                else torch.float32)
    jb = None if b is None else jnp.asarray(b, dtype)
    tb = None if b is None else torch.as_tensor(b).to(tx.dtype)
    return (jx, jnp.asarray(wq), jnp.asarray(ws), jb), \
        (tx, torch.as_tensor(wq), torch.as_tensor(ws), tb)


@pytest.mark.parametrize("case", MVM_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_mvm_plain_matches_pallas_kernel(case, dtype):
    M, K, N, tr, act, bias, perm = case
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    (jx, jwq, jws, jb), (tx, twq, tws, tb) = _mvm_inputs(
        M, K, N, tr, bias, MVM_CASES.index(case), jdt)
    jxs = j_photonic.a8_scale(jx)
    txs = t_photonic.a8_scale(tx)
    assert float(txs) == float(jxs) and txs.dtype == torch.float32
    block_perm, block = perm if perm else (None, 0)
    bm, bk, bn = j_pm.tile_plan(M, K, N)
    want = j_pm.photonic_mvm_fused(
        jx, jwq, jxs, jws, bias=jb, bm=bm, bk=bk, bn=bn, transpose=tr,
        activation=act, block_perm=block_perm, block=block, interpret=True,
        out_dtype=jdt)
    got = t_pm.photonic_mvm_fused(tx, twq, txs, tws, bias=tb, transpose=tr,
                                  activation=act, block_perm=block_perm,
                                  block=block)
    assert tuple(got.shape) == (M, N) and got.dtype == tx.dtype
    if dtype == "float32":
        assert _rel(_np(got), want) <= F32_TOL
        oracle = j_ref.photonic_mvm_fused_ref(
            jx, jwq, jxs, jws, transpose=tr, bias=jb, block_perm=block_perm,
            block=block, activation=act)
        assert _rel(_np(got), oracle) <= F32_TOL
    else:
        assert _within_one_bf16_ulp(_np(got), np.asarray(want, np.float32))


def test_torch_ref_oracles_match_jax_oracles():
    (jx, jwq, jws, jb), (tx, twq, tws, tb) = _mvm_inputs(
        5, 64, 96, False, True, 7, jnp.float32)
    xs = j_photonic.a8_scale(jx)
    txs = t_photonic.a8_scale(tx)
    want = j_ref.photonic_mvm_fused_ref(jx, jwq, xs, jws, bias=jb,
                                        block_perm=(2, 0, 1), block=32,
                                        activation="silu")
    got = t_ref.photonic_mvm_fused_ref(tx, twq, txs, tws, bias=tb,
                                       block_perm=(2, 0, 1), block=32,
                                       activation="silu")
    assert _rel(_np(got), want) <= F32_TOL
    q = np.random.default_rng(1).standard_normal((4, 9, 8)).astype(np.float32)
    k = np.random.default_rng(2).standard_normal((2, 11, 8)).astype(np.float32)
    want = j_ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(k), q_offset=2, kv_len=10)
    got = t_ref.flash_attention_ref(torch.as_tensor(q), torch.as_tensor(k),
                                    torch.as_tensor(k), q_offset=2, kv_len=10)
    assert _rel(got.numpy(), want) <= F32_TOL


def test_photonic_matmul_fused_ops_leading_dims():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    wq = rng.integers(-127, 128, (64, 96), dtype=np.int8)
    ws = (rng.random(96) * 0.05 + 0.01).astype(np.float32)
    want = j_ops.photonic_matmul_fused(jnp.asarray(x), jnp.asarray(wq),
                                       jnp.asarray(ws), activation="silu")
    got = t_ops.photonic_matmul_fused(torch.as_tensor(x), torch.as_tensor(wq),
                                      torch.as_tensor(ws), activation="silu")
    assert tuple(got.shape) == (2, 3, 96)
    assert _rel(got.numpy(), want) <= F32_TOL


FLASH_CASES = [
    # BHq, BHkv, Sq, L, hd, hdv, causal, q_offset, kv_len
    (2, 2, 16, 16, 16, 16, True, 0, None),           # G=1
    (4, 2, 24, 40, 16, 16, True, 16, None),          # G=2, chunk offset
    (8, 2, 13, 29, 8, 8, False, 0, 21),              # G=4, ragged, kv_len<L
    (4, 2, 20, 20, 16, 24, True, 0, None),           # hd_v != hd
    (4, 1, 10, 37, 16, 16, True, 20, 30),            # G=4, offset + kv_len
    (2, 2, 16, 16, 192, 128, True, 0, None),         # MLA (DeepSeek-V2)
    (2, 2, 8, 24, 192, 128, True, 8, 20),            # MLA chunk, kv_len<L
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_pallas_kernel(case):
    BHq, BHkv, Sq, L, hd, hdv, causal, off, kv_len = case
    rng = np.random.default_rng(Sq * L)
    q = rng.standard_normal((BHq, Sq, hd)).astype(np.float32)
    k = rng.standard_normal((BHkv, L, hd)).astype(np.float32)
    v = rng.standard_normal((BHkv, L, hdv)).astype(np.float32)
    want = j_fa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, q_offset=off,
                                kv_len=kv_len, bq=8, bk=8, interpret=True)
    got = t_fa.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                               torch.as_tensor(v), causal=causal,
                               q_offset=off, kv_len=kv_len)
    assert tuple(got.shape) == (BHq, Sq, hdv)
    assert _rel(got.numpy(), want) <= F32_TOL
    oracle = j_ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=causal,
                                       q_offset=off, kv_len=kv_len)
    assert _rel(got.numpy(), oracle) <= F32_TOL


def test_flash_ops_head_flattening_matches_reference():
    rng = np.random.default_rng(4)
    B, Sq, L, H, KV, hd = 2, 12, 20, 6, 2, 16
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, L, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, L, KV, hd)).astype(np.float32)
    want = j_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), q_offset=8, bq=8, bk=8)
    got = t_ops.flash_attention(torch.as_tensor(q), torch.as_tensor(k),
                                torch.as_tensor(v), q_offset=8)
    assert tuple(got.shape) == (B, Sq, H, hd)
    assert _rel(got.numpy(), want) <= F32_TOL


def test_chunk_garbage_past_causal_window_never_counts():
    """Keys past q_offset + C (a capacity buffer's unwritten tail) are
    masked: garbage there, even non-finite, leaves the output unchanged."""
    rng = np.random.default_rng(5)
    q = torch.as_tensor(rng.standard_normal((2, 8, 16)).astype(np.float32))
    k = torch.as_tensor(rng.standard_normal((1, 32, 16)).astype(np.float32))
    v = torch.as_tensor(rng.standard_normal((1, 32, 16)).astype(np.float32))
    clean = t_fa.flash_attention(q, k, v, q_offset=8)
    k2, v2 = k.clone(), v.clone()
    k2[:, 16:] = 1e4
    v2[:, 16:] = -1e4
    dirty = t_fa.flash_attention(q, k2, v2, q_offset=8)
    torch.testing.assert_close(dirty, clean, rtol=0, atol=0)


def test_cpu_wrappers_take_the_plain_path_and_count_no_launch():
    before = (t_pm.launches, t_pm.launches_gemv, t_fa.launches,
              t_fa.launches_mma)
    x = torch.randn(4, 64)
    wq = torch.randint(-127, 128, (64, 32), dtype=torch.int8)
    ws = torch.rand(32) + 0.01
    xs = t_photonic.a8_scale(x)
    out = t_pm.photonic_mvm_fused(x, wq, xs, ws)
    torch.testing.assert_close(out, t_pm.photonic_mvm_fused_plain(x, wq, xs,
                                                                 ws))
    q = torch.randn(2, 5, 8)
    t_fa.flash_attention(q, q, q)
    qb = torch.randn(2, 5, 16).to(torch.bfloat16)
    t_fa.flash_attention(qb, qb, qb)
    assert (t_pm.launches, t_pm.launches_gemv, t_fa.launches,
            t_fa.launches_mma) == before


def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_SPLIT_PLAN_SHAPES = [(4, 3072, 3072), (4, 3072, 9216), (4, 9216, 3072),
                      (4, 3072, 256000), (2048, 3072, 9216), (130, 72, 200),
                      (1, 64, 96)]
# every chip_smoke MVM shape, plus the shapes the plan was first tested at
# in both orientations (the small models' ragged 72 -> 200 among them)
_FUSED_PLAN_SHAPES = sorted(
    {(M, K, N, tr) for _, M, K, N, tr, _, _ in _chip_smoke().mvm_cases()}
    | {(M, K, N, tr) for M, K, N in _SPLIT_PLAN_SHAPES for tr in (False, True)})


@pytest.mark.parametrize("M,K,N,transpose", _FUSED_PLAN_SHAPES)
def test_launch_plan(M, K, N, transpose):
    """The fused kernel's plan: decode widths stream the bank ("gemv"),
    prefill widths take the tensor cores ("mma"); every split has work; the
    workspaces are the int8 A8 grid (mma) and the int32 partials (split)."""
    plan = t_pm.launch_plan(M, K, N, transpose)
    kps, splits = plan.k_per_split, plan.splits
    assert kps % 64 == 0 and splits == -(-K // kps)
    assert (splits - 1) * kps < K <= splits * kps       # every split has work
    assert plan.part_bytes == (4 * splits * M * N if splits > 1 else 0)
    if splits > 1:                      # one arrival counter per split tile
        assert plan.tiles <= t_pm.MAX_SPLIT_TILES
    if M <= t_pm.GEMV_MAX_M:
        assert plan.regime == "gemv" and plan.xq_bytes == 0
        assert plan.rows in (4, 8) and plan.rows >= M
        assert plan.rows * kps <= t_pm.GEMV_XS_BYTES   # shared-memory rows
        cols = t_pm.GEMV_T_COLS if transpose else t_pm.GEMV_COLS
        assert plan.tiles == -(-N // cols)
        per_sm = t_pm.GEMV_BLOCKS_PER_SM[(transpose, plan.rows)]
        if splits > 1:             # one wave, unless the rows' cap splits
            assert (plan.tiles * splits <= per_sm * 132
                    or plan.rows * kps == t_pm.GEMV_XS_BYTES)
        if transpose and K >= 512:
            assert kps % 512 == 0       # whole 16-byte loads for every lane
    else:
        assert plan.regime == "mma" and plan.rows == t_pm.MMA_BM
        assert kps % t_pm.MMA_BK == 0
        assert plan.tiles == -(-M // t_pm.MMA_BM) * -(-N // t_pm.MMA_BN)
        assert plan.xq_bytes == M * -(-K // 16) * 16
        if plan.tiles >= 132:
            assert splits == 1                  # a full wave: no split
        if splits > 1:
            assert plan.part_bytes <= t_pm.MMA_PART_BYTES


# the first plan shapes, every chip_smoke (K, N) case, plus ragged ones
_SPLIT_KN_PLAN_SHAPES = sorted(
    set(_SPLIT_PLAN_SHAPES)
    | {(M, K, N) for _, M, K, N, tr in _chip_smoke().split_cases() if not tr}
    | {(1, 4100, 300), (40, 4100, 300), (8, 3072, 9216), (9, 3072, 9216),
       (64, 3072, 9216), (65, 9216, 3072)})


@pytest.mark.parametrize("M,K,N", _SPLIT_KN_PLAN_SHAPES)
def test_split_launch_plan(M, K, N):
    """``photonic_mvm``'s plan on the (K, N) bank (``split_kn_launch_plan``):
    the fused kernel's (K, N) decode plan at M <= GEMV_MAX_M (the stream on
    int8 rows, no A8 workspace), the resident kernel's tensor-core plan
    for one stream above; every split has work, its partials fit
    MMA_PART_BYTES and its tiles the arrival counters."""
    plan = t_pm.split_kn_launch_plan(M, K, N)
    kps, splits = plan.k_per_split, plan.splits
    assert plan.xq_bytes == 0
    assert kps % 64 == 0 and splits == -(-K // kps)
    assert (splits - 1) * kps < K <= splits * kps       # every split has work
    assert plan.part_bytes == (4 * splits * M * N if splits > 1 else 0)
    assert plan.part_bytes <= t_pm.MMA_PART_BYTES
    if splits > 1:
        assert plan.tiles <= t_pm.MAX_SPLIT_TILES
    if M <= t_pm.GEMV_MAX_M:
        assert plan == t_pm.launch_plan(M, K, N, False)
        assert plan.regime == "gemv" and plan.rows in (4, 8)
        assert plan.rows >= M
        assert plan.tiles == -(-N // t_pm.GEMV_COLS)
        assert plan.rows * kps <= t_pm.GEMV_XS_BYTES   # shared-memory rows
    else:
        assert plan == t_pm.resident_launch_plan(1, M, K, N)
        assert plan.regime == "mma" and plan.rows == t_pm.MMA_BM
        assert kps % t_pm.MMA_BK == 0
        assert plan.tiles == -(-M // t_pm.MMA_BM) * -(-N // t_pm.MMA_BN)
        if plan.tiles >= 132:
            assert splits == 1                  # a full wave: no split


# every chip_smoke ^T case, plus ragged ones: 72 -> 200, M = 1, K = 4100
_SPLIT_T_PLAN_SHAPES = sorted(
    {(M, K, N) for _, M, K, N, tr in _chip_smoke().split_cases() if tr}
    | {(130, 72, 200), (1, 64, 96), (1, 4100, 300), (40, 4100, 300),
       (8, 3072, 9216), (9, 3072, 9216)})


@pytest.mark.parametrize("M,K,N", _SPLIT_T_PLAN_SHAPES)
def test_split_t_launch_plan(M, K, N):
    """``photonic_mvm_t`` runs the fused kernel's (N, K) regimes on int8
    rows: the same tiles and K split, no A8 workspace; every split has
    work; the boundary is GEMV_MAX_M."""
    plan = t_pm.split_t_launch_plan(M, K, N)
    assert plan == t_pm.launch_plan(M, K, N, True)._replace(xq_bytes=0)
    assert plan.regime == ("gemv" if M <= t_pm.GEMV_MAX_M else "mma")
    kps, splits = plan.k_per_split, plan.splits
    assert kps % 64 == 0 and splits == -(-K // kps)
    assert (splits - 1) * kps < K <= splits * kps       # every split has work
    assert plan.xq_bytes == 0
    assert plan.part_bytes == (4 * splits * M * N if splits > 1 else 0)
    if splits > 1:
        assert plan.tiles <= t_pm.MAX_SPLIT_TILES
    if plan.regime == "gemv":
        assert plan.tiles == -(-N // t_pm.GEMV_T_COLS)
        assert plan.rows * kps <= t_pm.GEMV_XS_BYTES
    else:
        assert plan.tiles == -(-M // t_pm.MMA_BM) * -(-N // t_pm.MMA_BN)


# every chip_smoke resident case (with jamba's w_down past the old K
# limit), plus ragged ones: 72 -> 200, M = 1, K = 4100
_RESIDENT_PLAN_SHAPES = sorted(
    {(T, M, K, N) for _, T, M, K, N in _chip_smoke().resident_cases()}
    | {(1, 40, 72, 200), (3, 1, 72, 200), (1, 1, 4100, 40), (2, 13, 4100, 130),
       (4, 8, 4160, 512), (1, 32, 512, 1024), (1, 33, 512, 1024)})


@pytest.mark.parametrize("T,M,K,N", _RESIDENT_PLAN_SHAPES)
def test_resident_launch_plan(T, M, K, N):
    """The resident kernel's plan over the T * M stacked rows: the
    tensor-core tiles at every width (no decode regime: the tile loop with
    a split K measured faster than the decode stream at the MoE path's 32
    rows); K splits, down to one k-tile per split while the tiles fill
    less than a wave, only at decode widths (at most 64 rows) or from
    RESIDENT_SPLIT_KTILES k-tiles on (RESIDENT_SPLIT_MIN_KTILES per split
    there); every split has work; the partials
    are the size the wrapper uses and split tiles fit the arrival
    counters."""
    rows = T * M
    ktiles = -(-K // t_pm.MMA_BK)
    plan = t_pm.resident_launch_plan(T, M, K, N)
    kps, splits = plan.k_per_split, plan.splits
    assert plan.regime == "mma" and plan.rows == t_pm.MMA_BM
    assert plan.tiles == -(-rows // t_pm.MMA_BM) * -(-N // t_pm.MMA_BN)
    assert kps % t_pm.MMA_BK == 0 and splits == -(-K // kps)
    assert (splits - 1) * kps < K <= splits * kps       # every split has work
    assert plan.xq_bytes == 0
    assert plan.part_bytes == (4 * splits * rows * N if splits > 1 else 0)
    if splits > 1:
        assert plan.tiles < 132                     # less than a wave
        assert plan.tiles <= t_pm.MAX_SPLIT_TILES
        assert plan.part_bytes <= t_pm.MMA_PART_BYTES
        assert rows <= t_pm.MMA_BM // 2 or ktiles >= t_pm.RESIDENT_SPLIT_KTILES
        if rows > t_pm.MMA_BM // 2:         # a deep bank's full tiles
            assert kps >= t_pm.RESIDENT_SPLIT_MIN_KTILES * t_pm.MMA_BK
    if rows <= t_pm.MMA_BM // 2 and plan.tiles * ktiles <= 2 * 132 and \
            4 * ktiles * rows * N <= t_pm.MMA_PART_BYTES:
        assert kps == t_pm.MMA_BK           # decode: one k-tile per split
    if rows > t_pm.MMA_BM // 2 and ktiles < t_pm.RESIDENT_SPLIT_KTILES:
        assert splits == 1                  # prefill tiles: no finish


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("T,M,K,N", _RESIDENT_PLAN_SHAPES)
def test_resident_launch_plan_forced_splits(T, M, K, N, splits):
    """``splits`` (chip_smoke's ``by_splits`` rows) forces the number of K
    ranges: at most the k-tiles of K, each range with work, the default
    plan's tiles, and partials the size the wrapper allocates."""
    rows = T * M
    ktiles = -(-K // t_pm.MMA_BK)
    plan = t_pm.resident_launch_plan(T, M, K, N, splits=splits)
    kps, made = plan.k_per_split, plan.splits
    assert plan.tiles == t_pm.resident_launch_plan(T, M, K, N).tiles
    assert kps == -(-ktiles // min(splits, ktiles)) * t_pm.MMA_BK
    assert 1 <= made <= min(splits, ktiles) and made == -(-K // kps)
    assert (made - 1) * kps < K <= made * kps           # every split has work
    assert plan.part_bytes == (4 * made * rows * N if made > 1 else 0)
    assert plan.tiles <= t_pm.MAX_SPLIT_TILES
    if splits <= ktiles and ktiles % splits == 0:
        assert made == splits


_CSRC = Path(t_build.__file__).resolve().parents[1] / "csrc"


def _device_function(path: Path, name: str) -> str:
    """The body of device function ``name`` in a CUDA source, comments
    dropped and whitespace collapsed."""
    code = re.sub(r"//[^\n]*", "", path.read_text())
    head = re.search(r"__device__ __forceinline__ \w+ " + name + r"\(", code)
    assert head is not None, f"{name} not in {path.name}"
    start = code.index("{", head.end())
    depth = 0
    for i in range(start, len(code)):
        depth += {"{": 1, "}": -1}.get(code[i], 0)
        if depth == 0:
            return " ".join(code[start:i + 1].split())
    raise AssertionError(f"{name}: unbalanced braces")


def _between(body: str, first: str, last: str) -> str:
    i = body.index(first)
    return body[i:body.index(last, i) + len(last)]


_FINISH_STORE = "#pragma unroll for (int e = 0; e < EC; ++e) { if (!ok[e])"
_PASS_LOOP = ("for (int p = 0; p < PASSES; ++p) {",
              "butterfly<1>(acc, lane);")


_KN_LOOP = ("int32_t acc[4][MT];",
            "acc[j][m] = __dp4a(static_cast<int>(col[j]), xw, acc[j][m]);")


@pytest.mark.parametrize("fused_name,copy_name,where,part", [
    ("last_arrival", "last_arrival", "photonic_mvm_int8.cuh", None),
    ("finish_tile", "finish_tile", "photonic_mvm_int8.cuh", "finish"),
    ("load_rows_nk", "load_rows_nk", "photonic_mvm_split.cu", None),
    ("butterfly", "butterfly", "photonic_mvm_split.cu", None),
    ("gemv_nk", "gemv_t", "photonic_mvm_split.cu", "passes"),
    ("load_quads_kn", "load_quads_kn", "photonic_mvm_split.cu", None),
    ("gemv_kn", "gemv_kn", "photonic_mvm_split.cu", "kn_loop"),
])
def test_split_kernels_copy_the_fused_kernels_code(fused_name, copy_name,
                                                   where, part):
    """The split and resident libraries carry copies of the fused kernel's
    split-K finish and both decode streams: shared through one header,
    the same code changed the fused tensor-core kernel's register
    allocation and slowed it.  The copies stay the fused kernel's code
    apart from their interfaces: whole functions, the finish up to its
    epilogue store, the (N, K) stream's pass loop and the (K, N) stream's
    main loop."""
    fused = _device_function(_CSRC / "photonic_mvm_fused.cu", fused_name)
    copy = _device_function(_CSRC / where, copy_name)
    if part == "finish":
        fused = fused.replace("o.part", "part").split(_FINISH_STORE)[0]
        copy = copy.split(_FINISH_STORE)[0]
    elif part == "passes":
        fused, copy = _between(fused, *_PASS_LOOP), _between(copy, *_PASS_LOOP)
    elif part == "kn_loop":
        fused, copy = _between(fused, *_KN_LOOP), _between(copy, *_KN_LOOP)
    assert len(copy) > 200
    assert copy == fused


def test_split_decode_streams_keep_the_fused_kernels_tiles():
    """The split library's decode streams run the fused kernel's plans
    (``split_kn_launch_plan``, ``split_t_launch_plan``), so their column
    tiles, unroll and blocks per SM are the fused kernel's constants."""
    fused = (_CSRC / "photonic_mvm_fused.cu").read_text()
    split = (_CSRC / "photonic_mvm_split.cu").read_text()

    def const(src, name):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m, name
        return int(m.group(1))

    assert const(split, "KN_COLS") == const(fused, "GEMV_COLS") == \
        t_pm.GEMV_COLS
    assert const(split, "T_COLS") == const(fused, "GEMV_T_COLS") == \
        t_pm.GEMV_T_COLS
    assert const(split, "KN_UNROLL") == const(fused, "KN_UNROLL")
    assert const(split, "KN_THREADS") == const(split, "T_THREADS") == \
        const(fused, "GEMV_THREADS")
    # blocks per SM: the fused kernel's launch bounds, the split kernels',
    # and the plan's table
    assert "return TRANS ? 2 : (MT == 4 ? 4 : 3);" in fused
    assert "__launch_bounds__(KN_THREADS, MT == 4 ? 4 : 3)" in split
    assert "__launch_bounds__(T_THREADS, 2)" in split
    assert t_pm.GEMV_BLOCKS_PER_SM == {(False, 4): 4, (False, 8): 3,
                                       (True, 4): 2, (True, 8): 2}


@pytest.mark.parametrize("dtype,hd,hd_v,variant", [
    (torch.bfloat16, 128, 128, "mma"),      # minitron-4b
    (torch.bfloat16, 64, 96, "mma"),        # hd_v != hd
    (torch.bfloat16, 16, 16, "mma"),
    (torch.bfloat16, 24, 24, "simt"),       # not a multiple of 16
    (torch.bfloat16, 128, 72, "simt"),
    (torch.bfloat16, 144, 144, "mma"),      # past 128, within the 256 limit
    (torch.bfloat16, 192, 128, "mma"),      # deepseek-v2-lite-16b (MLA)
    (torch.bfloat16, 48, 32, "mma"),        # chip_smoke's small bf16 MLA
    (torch.bfloat16, 256, 256, "mma"),
    (torch.bfloat16, 200, 128, "simt"),
    (torch.float32, 16, 16, "simt"),        # the float32 smoke models
    (torch.float32, 12, 8, "simt"),         # the float32 MLA smoke model
    (torch.float32, 128, 128, "simt"),
    (torch.float32, 192, 128, "simt"),
])
def test_flash_variant_dispatch(dtype, hd, hd_v, variant):
    assert t_fa.flash_variant(dtype, hd, hd_v) == variant


@pytest.mark.parametrize("hd,hd_v", [(272, 128), (192, 264), (0, 16)])
def test_flash_variant_refuses_head_dims_past_256(hd, hd_v):
    """Neither kernel takes a head dim past ``MAX_HEAD_DIM`` (256): the
    wrapper raises, naming the limit, before any launch."""
    assert t_fa.MAX_HEAD_DIM == 256
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="1 to 256"):
            t_fa.flash_variant(dtype, hd, hd_v)


def test_chip_smoke_profile_groups_every_kernel():
    """``chip_smoke``'s profile attributes each CUDA kernel in ``csrc/`` to
    a port kernel whose library defines it (none falls into "other torch
    kernels"); the split library's two orientations are separate groups."""
    cs = _chip_smoke()
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\("
                     r"(?:[^()]|\([^()]*\))*\)\s+)?(\w+)\s*\(")
    library = {"photonic_mvm": "photonic_mvm_split",
               "photonic_mvm_t": "photonic_mvm_split"}
    seen = {}
    for name, src in t_build.SOURCES.items():
        kernels = pat.findall((t_build.csrc_dir() / src).read_text())
        assert kernels, src
        for k in kernels:
            group = cs.kernel_group(f"void (anonymous namespace)::{k}<float>"
                                    f"(float const*)")
            assert library.get(group, group) == name, k
            seen[k] = group
    assert cs.kernel_group("void at::native::vectorized_elementwise_kernel"
                           "<4>()") == "other torch kernels"
    assert len(seen) >= 12
    assert {seen["split_gemv_kernel"], seen["split_mma_kernel"]} == \
        {"photonic_mvm"}
    assert {seen["split_t_gemv_kernel"], seen["split_t_mma_kernel"]} == \
        {"photonic_mvm_t"}
    assert {seen["blend_kernel"], seen["blend_vec_kernel"]} == \
        {"blend_shuffle"}
    assert seen["resident_mma_kernel"] == "photonic_mvm_resident"


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("M,K,N", [(4, 96, 40), (33, 300, 17), (1, 4100, 8)])
def test_exact_mvm_is_the_integer_product_rescaled(M, K, N, transpose):
    """``exact_mvm`` (the CUDA kernels' arithmetic, held against the card's
    model logits by ``chip_smoke.py``) is the int64 product of the same
    int8 grid, rescaled as ``float(acc) * (s_x * s_w) / 127`` in float32:
    rel-L2 <= 1e-6, in both bank orientations, near the largest grid
    values too."""
    rng = np.random.default_rng(M * K + N + transpose)
    q = rng.integers(-128, 128, (M, K)).astype(np.int8)
    q[0, :] = -128                                   # the extreme products
    wq = rng.integers(-127, 128, (N, K) if transpose else (K, N)).astype(
        np.int8)
    sx = np.float32(rng.uniform(0.01, 0.05))
    sw = rng.uniform(0.001, 0.01, (1, N)).astype(np.float32)
    acc = q.astype(np.int64) @ (wq.T if transpose else wq).astype(np.int64)
    want = acc.astype(np.float32) * (sx * sw) / np.float32(127.0)
    got = t_pm.exact_mvm(torch.as_tensor(q).to(torch.float32),
                         torch.as_tensor(wq), torch.tensor(sx),
                         torch.as_tensor(sw), transpose)
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    assert _rel(got.numpy(), want) <= 1e-6


def test_block_perm_validation():
    with pytest.raises(ValueError):
        t_pm.out_block_index((0, 0, 1), 32, 96)
    with pytest.raises(ValueError):
        t_pm.out_block_index((0, 1), 32, 96)
    with pytest.raises(ValueError):
        t_pm.out_block_index((0, 1), 0, 0)
    np.testing.assert_array_equal(t_pm.out_block_index((2, 0, 1), 32, 96),
                                  np.argsort([2, 0, 1]))


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(t_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        t_build.find_nvcc()
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "k"))
    lib = t_build.library_path("flash_attention")
    assert lib.parent == tmp_path / "k"
    assert lib.name.startswith("flash_attention-") and lib.suffix == ".so"
    assert t_build.library_path("flash_attention") == lib
    assert sorted(t_build.SOURCES) == ["blend_shuffle", "decode_attention",
                                       "flash_attention",
                                       "photonic_mvm_fused",
                                       "photonic_mvm_resident",
                                       "photonic_mvm_split", "ssd_chunk"]
    for src in t_build.SOURCES.values():
        assert (t_build.csrc_dir() / src).is_file()
    # the fused kernel's library is keyed by both MVM headers it includes
    assert sorted(p.name for p in t_build.source_files("photonic_mvm_fused")) \
        == ["photonic_mvm_common.cuh", "photonic_mvm_fused.cu",
            "photonic_mvm_mma.cuh"]


def test_library_path_hashes_the_headers_a_source_includes(monkeypatch,
                                                           tmp_path):
    """Editing a ``csrc/`` header rebuilds exactly the kernels that include
    it: the shared rescale and tile-loop headers the three MVM libraries,
    the int8 tile header (with the one-launch split-K finish) the split
    and resident ones.
    The library name hashes the ``.cu`` file and every header it includes,
    directly or through another header."""
    import shutil
    src = tmp_path / "csrc"
    shutil.copytree(t_build.csrc_dir(), src)
    monkeypatch.setattr(t_build, "csrc_dir", lambda: src)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "k"))
    names = [p.name for p in t_build.source_files("photonic_mvm_split")]
    assert names[0] == "photonic_mvm_split.cu"
    assert sorted(names[1:]) == ["photonic_mvm_common.cuh",
                                 "photonic_mvm_int8.cuh",
                                 "photonic_mvm_mma.cuh"]
    assert [p.name for p in t_build.source_files("blend_shuffle")] == \
        ["blend_shuffle.cu"]
    mvm = ["photonic_mvm_fused", "photonic_mvm_resident", "photonic_mvm_split"]
    for header, want in (("photonic_mvm_common.cuh", mvm),
                         ("photonic_mvm_mma.cuh", mvm),
                         ("photonic_mvm_int8.cuh", mvm[1:])):
        before = {n: t_build.library_path(n) for n in t_build.SOURCES}
        path = src / header
        path.write_text(path.read_text() + "\n// edited\n")
        after = {n: t_build.library_path(n) for n in t_build.SOURCES}
        assert sorted(n for n in before if before[n] != after[n]) == want, \
            header
