"""The split photonic pipeline of the port on the CPU: the plain versions of
``photonic_mvm`` / ``photonic_mvm_t`` and ``blend_shuffle`` against the JAX
Pallas kernels (interpret mode) and the reference oracles, the blend's
refusals, and whole Programs on ``Backend(fused=False)`` — against the
port's fused path and against the JAX Program.

Tolerances: float32 MVM outputs rel-L2 <= 1e-5 (the same float32
arithmetic summed in another order); the blend is a gather plus an add of
the same operands, so bitwise, except silu in bf16, which may land one
bf16 step away (XLA's and torch's exp differ in the last float32 bit).
The port's fused and split plain paths share their arithmetic, so their
logits are bitwise equal; port vs JAX Program logits rel-L2 <= 1e-3 (a
one-ulp difference can flip a per-tensor A8 rounding).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import api as j_api
from repro.configs import smoke_variant as j_smoke
from repro.core.backend import Backend as JBackend
from repro.core.prm import ReuseConfig as JRC
from repro.kernels import blend as j_blend
from repro.kernels import photonic_mvm as j_pm
from repro.kernels import ref as j_ref
from repro.models import transformer as j_tfm
from repro.train.checkpoint import _flatten

from repro_torch import api as t_api
from repro_torch import bridge
from repro_torch.configs import smoke_variant as t_smoke
from repro_torch.core.backend import Backend as TBackend
from repro_torch.core.prm import ReuseConfig as TRC
from repro_torch.kernels import blend as t_blend
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import photonic_mvm as t_pm

torch.set_num_threads(2)
F32_TOL = 1e-5
PROGRAM_TOL = 1e-3


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


# -------------------------------------------------------------------------
# the split MVM kernels
# -------------------------------------------------------------------------
SPLIT_CASES = [
    # M, K, N, transpose
    (1, 64, 96, False),
    (3, 96, 160, True),
    (8, 128, 128, False),
    (130, 72, 200, True),
    (17, 200, 64, False),
]


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_mvm_plain_matches_pallas_kernel(case):
    M, K, N, tr = case
    rng = np.random.default_rng(M * K + N)
    xq = rng.integers(-128, 128, (M, K), dtype=np.int8)
    wq = rng.integers(-127, 128, (N, K) if tr else (K, N), dtype=np.int8)
    ws = (rng.random(N) * 0.05 + 0.01).astype(np.float32)
    xs = np.float32(0.0123)
    j_fn, j_oracle = ((j_pm.photonic_mvm_t, j_ref.photonic_mvm_t_ref) if tr
                      else (j_pm.photonic_mvm, j_ref.photonic_mvm_ref))
    args = (jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(xs),
            jnp.asarray(ws))
    want = j_fn(*args, bm=8, bk=128, bn=128, interpret=True)
    t_fn = t_pm.photonic_mvm_t if tr else t_pm.photonic_mvm
    got = t_fn(torch.as_tensor(xq), torch.as_tensor(wq),
               torch.tensor(xs), torch.as_tensor(ws))
    assert tuple(got.shape) == (M, N) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= F32_TOL
    assert _rel(got.numpy(), j_oracle(*args)) <= F32_TOL


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_ops_match_reference_ops(transpose, dtype):
    """``ops.photonic_matmul_prepared{,_t}``: the A8 pass, the MVM and the
    cast to x's dtype, with leading dims, against the reference's."""
    from repro.kernels import ops as j_ops
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    wq = rng.integers(-127, 128, (96, 64) if transpose else (64, 96),
                      dtype=np.int8)
    ws = (rng.random(96) * 0.05 + 0.01).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    j_mm = (j_ops.photonic_matmul_prepared_t if transpose
            else j_ops.photonic_matmul_prepared)
    t_mm = (t_ops.photonic_matmul_prepared_t if transpose
            else t_ops.photonic_matmul_prepared)
    want = np.asarray(j_mm(jnp.asarray(x, jdt), jnp.asarray(wq),
                           jnp.asarray(ws)), np.float32)
    got = t_mm(torch.as_tensor(x).to(tdt), torch.as_tensor(wq),
               torch.as_tensor(ws))
    assert tuple(got.shape) == (2, 3, 96) and got.dtype == tdt
    tol = F32_TOL if dtype == "float32" else 2.0 ** -8
    assert _rel(_np(got), want) <= tol


# -------------------------------------------------------------------------
# the blend kernel
# -------------------------------------------------------------------------
def _within_one_bf16_ulp(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    mag = np.maximum(np.maximum(np.abs(want), np.abs(got)),
                     np.float32(2.0 ** -120))
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    return bool(np.all(np.abs(got - want) <= ulp))


BLEND_CASES = [
    # M, C, block, activation, bias
    (5, 64, 16, "none", False),
    (8, 96, 32, "relu", True),
    (130, 128, 32, "silu", True),
    (3, 256, 128, "none", True),
]


@pytest.mark.parametrize("case", BLEND_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blend_plain_matches_pallas_kernel(case, dtype):
    M, C, block, act, with_bias = case
    rng = np.random.default_rng(M + C)
    x = rng.standard_normal((M, C)).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    perm = rng.permutation(C // block)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jb = jnp.asarray(b if with_bias else np.zeros(C, np.float32), jdt)
    want = np.asarray(j_blend.blend_shuffle(
        jnp.asarray(x, jdt), jb, perm, block=block, bm=8, activation=act,
        interpret=True), np.float32)
    oracle = np.asarray(j_ref.blend_shuffle_ref(
        jnp.asarray(x, jdt), jb, perm, block, activation=act), np.float32)
    tb = torch.as_tensor(b).to(tdt) if with_bias else None
    got = t_blend.blend_shuffle(torch.as_tensor(x).to(tdt), tb, perm,
                                block=block, activation=act)
    assert tuple(got.shape) == (M, C) and got.dtype == tdt
    if act == "silu" and dtype == "bfloat16":
        assert _within_one_bf16_ulp(_np(got), want)
        assert _within_one_bf16_ulp(_np(got), oracle)
    elif act == "silu":
        assert _rel(_np(got), want) <= F32_TOL
    else:
        np.testing.assert_array_equal(_np(got), want)
        np.testing.assert_array_equal(_np(got), oracle)


def test_blend_refuses_ragged_channels_and_non_permutations():
    x = torch.zeros((4, 96))
    with pytest.raises(ValueError, match="multiple of block"):
        t_blend.blend_shuffle(x, None, (0, 1), block=40)
    with pytest.raises(ValueError, match="multiple of block"):
        t_blend.blend_shuffle(x, None, (0,), block=0)
    with pytest.raises(ValueError, match="permutation"):
        t_blend.blend_shuffle(x, None, (0, 0, 1), block=32)
    with pytest.raises(ValueError, match="permutation"):
        t_blend.blend_shuffle(x, None, (0, 1), block=32)
    with pytest.raises(ValueError, match="permutation"):
        t_ops.blend_shuffle(x.reshape(2, 2, 96), None, (3, 1, 0), block=32)


def test_blend_ops_leading_dims_and_device_index_cache():
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.standard_normal((2, 3, 64)).astype(np.float32))
    got = t_ops.blend_shuffle(x, None, (1, 3, 0, 2), block=16,
                              activation="none")
    idx = np.concatenate([np.arange(16) + 16 * p for p in (1, 3, 0, 2)])
    np.testing.assert_array_equal(got.numpy(), x.numpy()[..., idx])
    a = t_blend._cached_index((1, 3, 0, 2), 16, 64, "cpu")
    assert t_blend._cached_index((1, 3, 0, 2), 16, 64, "cpu") is a


# -------------------------------------------------------------------------
# whole Programs: split vs fused (the port), port vs JAX
# -------------------------------------------------------------------------
def _small_cfgs():
    kw = dict(name="split-t", family="dense", num_layers=2, d_model=32,
              num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=128,
              compute_dtype="float32")
    from repro.configs.base import ModelConfig as JCfg
    from repro_torch.configs.base import ModelConfig as TCfg
    return JCfg(**kw), TCfg(**kw)


def _obu_cfgs():
    """The reference's OBU-stack gate config (``test_program_api.py:317``):
    the deepseek smoke variant on an R=2 x T=2 ``shuffle_transpose`` stack
    with a blocked shuffle of 8 channels."""
    kw = dict(num_basic=2, reuse_times=2,
              transforms=("identity", "shuffle_transpose"), shuffle_block=8,
              seed=1)
    return (dataclasses.replace(j_smoke("deepseek-7b"), reuse=JRC(**kw)),
            dataclasses.replace(t_smoke("deepseek-7b"), reuse=TRC(**kw)))


@functools.lru_cache(maxsize=None)
def _model(kind):
    jc, tc = _small_cfgs() if kind == "small" else _obu_cfgs()
    params, _ = j_tfm.init_model(jax.random.PRNGKey(0), jc)
    return jc, tc, params, bridge.params_from_flat(_flatten(params),
                                                   device="cpu")


def _tokens(seed, vocab, shape=(2, 8)):
    return np.random.default_rng(seed).integers(1, vocab, shape).astype(
        np.int32)


def test_split_bitwise_equals_fused_on_cpu():
    """The reference's Program-level fused-vs-unfused gate
    (``test_program_api.py:296``) on the port: prefill and decode logits
    bitwise equal."""
    _, tc, _, tp = _model("small")
    toks = _tokens(1, tc.vocab_size)
    pf = t_api.Program.build(tc, tp, execution=TBackend("photonic"),
                             device="cpu")
    pu = t_api.Program.build(tc, tp,
                             execution=TBackend("photonic", fused=False),
                             device="cpu")
    lf, cf = pf.prefill({"tokens": toks}, 10)
    lu, cu = pu.prefill({"tokens": toks}, 10)
    assert torch.equal(lf, lu)
    df, _ = pf.decode(toks[:, :1], cf, 8)
    du, _ = pu.decode(toks[:, :1], cu, 8)
    assert torch.equal(df, du)


def test_split_tokens_equal_fused_on_blocked_shuffle_stack():
    """``test_program_api.py:317`` on the port: the blocked OBU shuffle
    (the blend kernel) and the transpose orientation, fused vs split."""
    _, tc, _, tp = _model("obu")
    toks = _tokens(2, tc.vocab_size)
    out_f = t_api.Program.build(tc, tp, execution=TBackend("photonic"),
                                device="cpu").generate(toks, 4)
    out_u = t_api.Program.build(
        tc, tp, execution=TBackend("photonic", fused=False),
        device="cpu").generate(toks, 4)
    assert torch.equal(out_f, out_u)


@pytest.mark.parametrize("fused", [True, False])
def test_blocked_shuffle_program_matches_jax(fused):
    """Port vs JAX Program on the ``shuffle_block=8`` stack, photonic, split
    and fused: prefill logits within 1e-3 and identical greedy tokens."""
    jc, tc, params, tp = _model("obu")
    toks = _tokens(3, tc.vocab_size)
    jprog = j_api.Program.build(jc, params,
                                execution=JBackend("photonic", fused=fused))
    tprog = t_api.Program.build(tc, tp,
                                execution=TBackend("photonic", fused=fused),
                                device="cpu")
    jl, _ = jprog.prefill({"tokens": jnp.asarray(toks)}, 12)
    tl, _ = tprog.prefill({"tokens": toks}, 12)
    assert _rel(tl.numpy(), np.asarray(jl)) <= PROGRAM_TOL
    np.testing.assert_array_equal(
        tprog.generate(toks, 4).numpy(),
        np.asarray(jprog.generate(jnp.asarray(toks), 4)))
