"""The port's reuse-resident MVM on the CPU: the plain version of
``photonic_mvm_resident`` against the JAX Pallas kernel (interpret mode)
and the reference oracle, the per-stream A8 pass of
``reuse_resident_matmul_prepared``, ``Backend.reuse_dot`` in every form
(xla, photonic fp weight, photonic bank, fault model) against the JAX
Backend, the wrapper's refusals, and a depth past the 4096 the first CUDA
kernel held in shared memory (any K is taken now).

Tolerances: float32 MVM outputs rel-L2 <= 1e-5 (the same float32
arithmetic summed in another order); bf16 stacks within one bf16 step of
the reference (the float32 output rounds to bf16 once, and a one-ulp
float32 difference can cross a bf16 rounding boundary).  The A8 grid is an
integer artifact: bitwise.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import noise as j_noise
from repro.core import prepared as j_prep
from repro.core.backend import Backend as JBackend
from repro.core.photonic import quantize_symmetric as j_quant
from repro.kernels import ops as j_ops
from repro.kernels import photonic_mvm as j_pm
from repro.kernels import ref as j_ref

from repro_torch.core import noise as t_noise
from repro_torch.core import prepared as t_prep
from repro_torch.core.backend import Backend as TBackend
from repro_torch.core.photonic import quantize_symmetric as t_quant
from repro_torch.kernels import build as t_build
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


def _resident_inputs(T, M, K, N, seed):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-128, 128, (T, M, K)).astype(np.int8)
    wq = rng.integers(-127, 128, (K, N)).astype(np.int8)
    xs = (rng.random(T) * 0.02 + 0.001).astype(np.float32)
    ws = (rng.random(N) * 0.05 + 0.01).astype(np.float32)
    return xq, wq, xs, ws


RESIDENT_CASES = [
    # T, M, K, N: ragged M, K and N, then the MoE path's banks
    (1, 5, 72, 40),
    (2, 13, 100, 130),
    (4, 3, 64, 96),
    (4, 8, 1024, 512),
    (2, 20, 512, 1024),
]


@pytest.mark.parametrize("case", RESIDENT_CASES)
def test_resident_plain_matches_pallas_kernel_and_oracle(case):
    T, M, K, N = case
    xq, wq, xs, ws = _resident_inputs(T, M, K, N, seed=T * 1000 + M)
    want = np.asarray(j_pm.photonic_mvm_resident(
        jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(xs), jnp.asarray(ws),
        interpret=True))
    oracle = np.asarray(j_ref.photonic_mvm_resident_ref(
        jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(xs), jnp.asarray(ws)))
    args = [torch.as_tensor(a) for a in (xq, wq, xs, ws)]
    got = t_pm.photonic_mvm_resident(*args)
    assert got.dtype == torch.float32 and tuple(got.shape) == (T, M, N)
    assert _rel(got.numpy(), want) <= F32_TOL
    assert _rel(got.numpy(), oracle) <= F32_TOL
    assert _rel(t_ref.photonic_mvm_resident_ref(*args).numpy(),
                oracle) <= F32_TOL
    # stream t is the split MVM on xq[t] with x_scale[t]
    for t in range(T):
        split = t_pm.photonic_mvm_plain(args[0][t], args[1], args[2][t],
                                        args[3])
        assert _rel(got[t].numpy(), split.numpy()) <= 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead", [(3,), (2, 5)])
def test_reuse_resident_matmul_prepared_matches_reference(dtype, lead):
    """Per-stream A8 scales (abs-max and divide in the stack's dtype) and
    the float32 output cast to the stack's dtype, any leading shape."""
    T, K, N = 4, 48, 80
    rng = np.random.default_rng(7)
    x = rng.standard_normal((T, *lead, K)).astype(np.float32)
    x[1] *= 5.0                                    # streams of other ranges
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    jx = jnp.asarray(x, dtype=jnp.dtype(dtype))
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    jwq, jws = j_prep.quantize_weight(jnp.asarray(w))
    twq, tws = t_prep.quantize_weight(torch.as_tensor(w))
    np.testing.assert_array_equal(twq.numpy(), np.asarray(jwq))
    jq, js = j_quant(jx.reshape(T, -1, K), 8, axis=(1, 2))
    tq, ts = t_quant(tx.reshape(T, -1, K), 8, axis=(1, 2))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    want = np.asarray(j_ops.reuse_resident_matmul_prepared(jx, jwq, jws),
                      np.float32)
    got = t_ops.reuse_resident_matmul_prepared(tx, twq, tws)
    assert got.dtype == tx.dtype and tuple(got.shape) == (T, *lead, N)
    if dtype == "float32":
        assert _rel(got.numpy(), want) <= F32_TOL
    else:
        step = np.abs(want) * 2.0 ** -7 + 1e-30
        assert (np.abs(_np(got) - want) <= step).all()
    # the fp-weight entry point programs the bank in-step: same numbers
    again = t_ops.reuse_resident_matmul(tx, torch.as_tensor(w).to(tx.dtype))
    torch.testing.assert_close(again, t_ops.reuse_resident_matmul_prepared(
        tx, *t_prep.quantize_weight(torch.as_tensor(w).to(tx.dtype))),
        rtol=0, atol=0)


def _stack_and_bank(seed=3, T=2, M=6, K=32, N=48):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    tag = 12345
    jbank = j_prep.prepare_tensor(jnp.asarray(w), tag=tag)
    tbank = t_prep.prepare_tensor(torch.as_tensor(w), tag=tag)
    return x, w, jbank, tbank


@pytest.mark.parametrize("execution", ["xla", "photonic"])
def test_backend_reuse_dot_matches_reference(execution):
    x, w, jbank, tbank = _stack_and_bank()
    jb, tb = JBackend(execution), TBackend(execution)
    tx = torch.as_tensor(x)
    for jw, tw in ((jnp.asarray(w), torch.as_tensor(w)), (jbank, tbank)):
        want = np.asarray(jb.reuse_dot(jnp.asarray(x), jw))
        got = tb.reuse_dot(tx, tw)
        assert tuple(got.shape) == want.shape
        assert _rel(got.numpy(), want) <= F32_TOL


def test_reuse_dot_fault_model_crosstalk_by_value_and_zero_config_clean():
    """One perturbation, keyed by the bank's tag, covers all T streams:
    crosstalk (which draws nothing at random) equals the reference's by
    value; an all-zero config leaves the output bitwise clean."""
    x, _, jbank, tbank = _stack_and_bank(seed=5, T=4)
    tx = torch.as_tensor(x)
    jn = j_noise.NoiseConfig(crosstalk=0.004)
    tn = t_noise.NoiseConfig(crosstalk=0.004)
    want = np.asarray(JBackend("photonic", noise=jn).reuse_dot(
        jnp.asarray(x), jbank))
    got = TBackend("photonic", noise=tn).reuse_dot(tx, tbank)
    clean = TBackend("photonic").reuse_dot(tx, tbank)
    assert _rel(got.numpy(), want) <= F32_TOL
    assert not torch.equal(got, clean)
    zero = TBackend("photonic", noise=t_noise.NoiseConfig()).reuse_dot(
        tx, tbank)
    assert torch.equal(zero, clean)
    # the same pattern for every stream: stream t perturbed alone equals
    # its slice of the stacked perturbation
    one = t_noise.perturb_mvm_output(clean[2], tn, tag=tbank.tag)
    torch.testing.assert_close(one, got[2], rtol=0, atol=0)


def test_resident_wrapper_refusals_and_cpu_counts_no_launch():
    xq, wq, xs, ws = (torch.as_tensor(a)
                      for a in _resident_inputs(2, 4, 64, 32, seed=1))
    before = t_pm.launches_resident
    t_pm.photonic_mvm_resident(xq, wq, xs, ws)
    assert t_pm.launches_resident == before        # plain path, no launch
    with pytest.raises(ValueError, match="reduction dims"):
        t_pm.photonic_mvm_resident(xq, wq[:32], xs, ws)
    with pytest.raises(ValueError, match="x_scale"):
        t_pm.photonic_mvm_resident(xq, wq, xs[:1], ws)
    with pytest.raises(TypeError):
        t_pm.photonic_mvm_resident(xq.float(), wq, xs, ws)


@pytest.mark.parametrize("K", [4160, 4100])
def test_resident_plain_matches_pallas_kernel_past_old_limit(K):
    """Past the former RESIDENT_MAX_K = 4096 (4100 is not a multiple of
    16): the plain version and ``reuse_resident_matmul_prepared`` against
    the JAX Pallas kernel in interpret mode, which takes any K."""
    T, M, N = 2, 3, 40
    xq, wq, xs, ws = _resident_inputs(T, M, K, N, seed=K)
    want = np.asarray(j_pm.photonic_mvm_resident(
        jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(xs), jnp.asarray(ws),
        interpret=True))
    got = t_pm.photonic_mvm_resident(*(torch.as_tensor(a)
                                       for a in (xq, wq, xs, ws)))
    assert tuple(got.shape) == (T, M, N)
    assert _rel(got.numpy(), want) <= F32_TOL
    # the per-stream A8 pass too: float streams through a programmed bank
    rng = np.random.default_rng(K + 1)
    x = rng.standard_normal((T, M, K)).astype(np.float32)
    x[1] *= 3.0
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    jwq, jws = j_prep.quantize_weight(jnp.asarray(w))
    twq, tws = t_prep.quantize_weight(torch.as_tensor(w))
    jq, js = j_quant(jnp.asarray(x), 8, axis=(1, 2))
    want = np.asarray(j_pm.photonic_mvm_resident(
        jq, jwq, js.reshape(T), jws.reshape(-1), interpret=True))
    got = t_ops.reuse_resident_matmul_prepared(torch.as_tensor(x), twq, tws)
    assert got.dtype == torch.float32 and tuple(got.shape) == (T, M, N)
    assert _rel(got.numpy(), want) <= F32_TOL


def test_resident_limit_matches_the_cuda_source():
    """The resident library is built from its source and the MVM headers
    it reaches (the int8 tensor-core tile with its split-K finish, the tile
    loop, the shared rescale); the plan's tile is the kernel's, and no K
    limit remains in the source or the wrapper."""
    assert "photonic_mvm_resident" in t_build.SOURCES
    names = [p.name for p in t_build.source_files("photonic_mvm_resident")]
    assert names[0] == "photonic_mvm_resident.cu"
    assert sorted(names[1:]) == ["photonic_mvm_common.cuh",
                                 "photonic_mvm_int8.cuh",
                                 "photonic_mvm_mma.cuh"]
    mma = (t_build.csrc_dir() / "photonic_mvm_mma.cuh").read_text()
    for name, value in (("BM", t_pm.MMA_BM), ("BN", t_pm.MMA_BN),
                        ("BK", t_pm.MMA_BK)):
        m = re.search(rf"constexpr int {name} = (\d+);", mma)
        assert m and int(m.group(1)) == value, name
    src = (t_build.csrc_dir() / names[0]).read_text()
    wrapper = Path(t_pm.__file__).read_text()
    for text in (src, wrapper):
        assert "RESIDENT_MAX_K" not in text and "max_k" not in text
    assert not hasattr(t_pm, "RESIDENT_MAX_K")
