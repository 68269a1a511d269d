"""The MoE slice as a whole against the JAX reference on the same weights:
the granite smoke model with blended experts (4 experts from 2 basic
ones) on an R&B stack with a transposed reuse (R=2 x T=2, identity then
transpose), float32, served photonic through ``Program`` and the
``ContinuousScheduler``.

The blended experts' up projections run the reuse-resident MVM in every
layer; the gate and down projections run it in the identity reuse and
the per-expert fused MVM in the transposed one.  Capacity couples the
rows of a batch (tokens past an expert's capacity drop in row order), so
the scheduler is compared with the reference's scheduler on the same
trace, never with solo runs.

Tolerances: logits rel-L2 <= 1e-3 (a one-ulp float32 difference can flip
a per-tensor or per-stream A8 rounding); greedy tokens identical; the
crosstalk-only fault model by value (<= 1e-3, as the logits); an all-zero
fault config bitwise clean.
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
from repro.core.noise import NoiseConfig as JNoise
from repro.core.prm import ReuseConfig as JRC
from repro.models import transformer as j_tfm
from repro.serve.batcher import Request as JRequest
from repro.serve.scheduler import ContinuousScheduler as JScheduler
from repro.train.checkpoint import _flatten

from repro_torch import api as t_api
from repro_torch import bridge
from repro_torch.configs import smoke_variant as t_smoke
from repro_torch.core.backend import Backend as TBackend
from repro_torch.core.noise import NoiseConfig as TNoise
from repro_torch.core.prm import ReuseConfig as TRC
from repro_torch.serve.batcher import Request as TRequest
from repro_torch.serve.scheduler import ContinuousScheduler as TScheduler

torch.set_num_threads(2)
TOL = 1e-3
V = 211
TRANSFORMS = ("identity", "transpose")


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


@functools.lru_cache(maxsize=None)
def _model():
    jc, tc = j_smoke("granite-moe-1b-a400m"), t_smoke("granite-moe-1b-a400m")
    jc = dataclasses.replace(
        jc, moe=dataclasses.replace(jc.moe, num_basic_experts=2),
        reuse=JRC(num_basic=2, reuse_times=2, transforms=TRANSFORMS,
                  shuffle_groups=8))
    tc = dataclasses.replace(
        tc, moe=dataclasses.replace(tc.moe, num_basic_experts=2),
        reuse=TRC(num_basic=2, reuse_times=2, transforms=TRANSFORMS,
                  shuffle_groups=8))
    params, _ = j_tfm.init_model(jax.random.PRNGKey(0), jc)
    return jc, tc, params, bridge.params_from_flat(_flatten(params),
                                                   device="cpu")


@functools.lru_cache(maxsize=None)
def _programs(noise=None):
    jc, tc, params, tp = _model()
    jn = tn = None
    if noise is not None:
        jn, tn = JNoise(**dict(noise)), TNoise(**dict(noise))
    return (j_api.Program.build(jc, params,
                                execution=JBackend("photonic", noise=jn)),
            t_api.Program.build(tc, tp,
                                execution=TBackend("photonic", noise=tn),
                                device="cpu"))


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, V, shape).astype(np.int32)


def test_prefill_and_decode_logits_match_reference_program():
    jp, tp = _programs()
    assert tp.bank_stats() == jp.bank_stats()
    assert tp.verify_banks() < 1e-5
    # 4-D expert banks (R, R_e, K, N), the router left floating point
    ffn = tp.bank["segments"]["main"]["l0"]["ffn"]
    assert ffn["w_up"].shape == (2, 2, 64, 32)
    assert isinstance(ffn["router"], torch.Tensor)
    # slicing R, then R_e (the PRM loop, then the basic expert) keeps the
    # tag that the fault model keys each bank's streams on
    assert ffn["w_up"][1][0].shape == (64, 32)
    assert ffn["w_up"][1][0].tag == ffn["w_up"].tag != 0
    toks = _tokens(1, (2, 9))
    last = np.array([8, 5], np.int32)
    jl, jcache = jp.prefill({"tokens": jnp.asarray(toks)}, 16, last=last)
    tl, tcache = tp.prefill({"tokens": toks}, 16, last=last)
    assert _rel(tl.numpy(), jl) <= TOL
    nxt = _tokens(2, (2, 1))
    pos = np.array([9, 6], np.int32)
    jd, _ = jp.decode(jnp.asarray(nxt), jcache, jnp.asarray(pos))
    td, _ = tp.decode(nxt, tcache, pos)
    assert _rel(td.numpy(), jd) <= TOL


def test_generate_greedy_tokens_identical():
    jp, tp = _programs()
    prompt = _tokens(0, (2, 10))
    want = np.asarray(jp.generate(jnp.asarray(prompt), 8))
    got = tp.generate(prompt, 8)
    assert tuple(got.shape) == (2, 18)
    np.testing.assert_array_equal(got.numpy(), want)


def _drain(scheduler, request, prompts):
    for rid, p in enumerate(prompts):
        scheduler.submit(request(rid=rid, prompt=p, max_new=5))
    return {c.rid: c.tokens for c in scheduler.drain()}


@pytest.mark.parametrize("chunk", [None, 16])
def test_continuous_scheduler_token_identical_to_reference(chunk):
    jp, tp = _programs()
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, V, n).astype(np.int32)
               for n in (5, 23, 9, 40)]
    want = _drain(JScheduler(jp, capacity=3, max_len=64,
                             prefill_chunk=chunk), JRequest, prompts)
    ts = TScheduler(tp, capacity=3, max_len=64, prefill_chunk=chunk)
    got = _drain(ts, TRequest, prompts)
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    if chunk is not None:
        assert ts.stats.prefill_chunks > 0


def test_crosstalk_by_value_and_zero_config_bitwise_clean():
    """Crosstalk draws nothing at random: the port's noisy Program (the
    resident path's one perturbation per bank, the per-expert fused dots
    through the noisy split pipeline) tracks the reference's by value.
    An all-zero config is the clean path, bit for bit."""
    toks = _tokens(3, (2, 8))
    jp, tp = _programs((("crosstalk", 0.003),))
    jl, _ = jp.prefill({"tokens": jnp.asarray(toks)}, 10)
    tl, _ = tp.prefill({"tokens": toks}, 10)
    assert _rel(tl.numpy(), jl) <= TOL
    _, clean = _programs()
    cl, _ = clean.prefill({"tokens": toks}, 10)
    assert not torch.equal(tl, cl)
    _, zero = _programs((("crosstalk", 0.0),))
    zl, _ = zero.prefill({"tokens": toks}, 10)
    assert torch.equal(zl, cl)
