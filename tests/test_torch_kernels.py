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
    before = (t_pm.launches, t_fa.launches)
    x = torch.randn(4, 64)
    wq = torch.randint(-127, 128, (64, 32), dtype=torch.int8)
    ws = torch.rand(32) + 0.01
    xs = t_photonic.a8_scale(x)
    out = t_pm.photonic_mvm_fused(x, wq, xs, ws)
    torch.testing.assert_close(out, t_pm.photonic_mvm_fused_plain(x, wq, xs,
                                                                 ws))
    q = torch.randn(2, 5, 8)
    t_fa.flash_attention(q, q, q)
    assert (t_pm.launches, t_fa.launches) == before


@pytest.mark.parametrize("M,K,N", [(4, 3072, 3072), (4, 3072, 9216),
                                   (4, 9216, 3072), (4, 3072, 256000),
                                   (2048, 3072, 9216), (130, 72, 200),
                                   (1, 64, 96)])
def test_launch_plan(M, K, N):
    bm, kps = t_pm.launch_plan(M, K, N)
    assert bm == (16 if M <= 16 else 128)
    assert kps % t_pm.BK == 0 and kps >= t_pm.BK
    splits = -(-K // kps)
    assert (splits - 1) * kps < K <= splits * kps       # every split has work
    tiles = -(-M // bm) * -(-N // t_pm.BN)
    if tiles >= 2 * 132:
        assert splits == 1                              # big grids: no split
    else:
        assert tiles * splits >= min(2 * 132, tiles * -(-K // t_pm.BK)) // 2


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
    assert sorted(t_build.SOURCES) == ["blend_shuffle", "flash_attention",
                                       "photonic_mvm_fused",
                                       "photonic_mvm_split"]
    for src in t_build.SOURCES.values():
        assert (t_build.csrc_dir() / src).is_file()


def test_library_path_hashes_the_headers_a_source_includes(monkeypatch,
                                                           tmp_path):
    """Editing a ``csrc/`` header shared by two kernels rebuilds both, and
    no other kernel: the library name hashes the ``.cu`` file and every
    header it includes, directly or through another header."""
    import shutil
    src = tmp_path / "csrc"
    shutil.copytree(t_build.csrc_dir(), src)
    monkeypatch.setattr(t_build, "csrc_dir", lambda: src)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "k"))
    names = [p.name for p in t_build.source_files("photonic_mvm_split")]
    assert names == ["photonic_mvm_split.cu", "photonic_mvm_common.cuh"]
    assert [p.name for p in t_build.source_files("blend_shuffle")] == \
        ["blend_shuffle.cu"]
    before = {n: t_build.library_path(n) for n in t_build.SOURCES}
    header = src / "photonic_mvm_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: t_build.library_path(n) for n in t_build.SOURCES}
    changed = sorted(n for n in before if before[n] != after[n])
    assert changed == ["photonic_mvm_fused", "photonic_mvm_split"]
