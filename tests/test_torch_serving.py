"""Serving through the port against the JAX reference on the same weights:
greedy ``Program.generate`` tokens, chunked vs monolithic prefill, and the
``ContinuousScheduler`` on a mixed-length trace — monolithic and chunked
admission — token for token."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import api as j_api
from repro.configs.base import ModelConfig as JCfg
from repro.core.prm import ReuseConfig as JRC
from repro.models import transformer as j_tfm
from repro.serve.batcher import Request as JRequest
from repro.serve.scheduler import ContinuousScheduler as JScheduler
from repro.train.checkpoint import _flatten

from repro_torch import api as t_api
from repro_torch import bridge
from repro_torch.configs.base import ModelConfig as TCfg
from repro_torch.core.prm import ReuseConfig as TRC
from repro_torch.serve.batcher import Request as TRequest
from repro_torch.serve.scheduler import ContinuousScheduler as TScheduler
from repro_torch.serve.slots import SlotPool, SlotState

torch.set_num_threads(2)
W8A8_BOUND = 0.055


@functools.lru_cache(maxsize=None)
def _model(kind):
    kw = dict(name="t", family="dense", num_layers=2, d_model=32,
              num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=128,
              compute_dtype="float32")
    jr = tr = None
    if kind == "rb":
        kw["num_layers"] = 8
        t = ("identity", "shuffle", "transpose", "shuffle")
        jr = JRC(num_basic=2, reuse_times=4, transforms=t, shuffle_groups=8)
        tr = TRC(num_basic=2, reuse_times=4, transforms=t, shuffle_groups=8)
    jc, tc = JCfg(reuse=jr, **kw), TCfg(reuse=tr, **kw)
    params, _ = j_tfm.init_model(jax.random.PRNGKey(0), jc)
    return jc, tc, params, bridge.params_from_flat(_flatten(params),
                                                   device="cpu")


@functools.lru_cache(maxsize=None)
def _programs(kind, execution="photonic"):
    jc, tc, params, tp = _model(kind)
    return (j_api.Program.build(jc, params, execution=execution),
            t_api.Program.build(tc, tp, execution=execution, device="cpu"))


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


@pytest.mark.parametrize("kind", ["dense", "rb"])
def test_generate_greedy_tokens_identical(kind):
    jp, tp = _programs(kind)
    prompt = np.random.default_rng(0).integers(0, 128, (2, 10)).astype(
        np.int32)
    want = np.asarray(jp.generate(jnp.asarray(prompt), 8))
    got = tp.generate(prompt, 8)
    assert got.dtype == torch.int64 and tuple(got.shape) == (2, 18)
    np.testing.assert_array_equal(got.numpy(), want)


def test_prefill_logits_match_reference_program():
    jp, tp = _programs("rb")
    toks = np.random.default_rng(1).integers(0, 128, (2, 9)).astype(np.int32)
    last = np.array([8, 5], np.int32)
    jl, _ = jp.prefill({"tokens": jnp.asarray(toks)}, 16, last=last)
    tl, _ = tp.prefill({"tokens": toks}, 16, last=last)
    assert _rel(tl.numpy(), jl) <= 1e-3
    assert tp.verify_banks() < 1e-5
    assert tp.bank_stats() == jp.bank_stats()


@pytest.mark.parametrize("execution", ["xla", "photonic"])
def test_prefill_chunked_matches_prefill(execution):
    """Chunked prefill equals monolithic prefill: to float32 rounding on
    xla, and within the W8A8 bound on photonic (each chunk has its own A8
    activation scale); and the port's chunked logits track the reference's
    chunked logits."""
    jp, tp = _programs("dense", execution)
    toks = np.random.default_rng(2).integers(0, 128, (2, 13)).astype(
        np.int32)
    mono, _ = tp.prefill({"tokens": toks}, 24)
    chunked, caches = tp.prefill_chunked({"tokens": toks}, 24, chunk=5)
    bound = 1e-5 if execution == "xla" else W8A8_BOUND
    assert _rel(chunked.numpy(), mono.numpy()) <= bound
    assert tuple(caches["main"]["l0"]["k"].shape) == (2, 1, 2, 24, 2, 8)
    want, _ = jp.prefill_chunked({"tokens": jnp.asarray(toks)}, 24, chunk=5)
    assert _rel(chunked.numpy(), want) <= 1e-3


TRACE = [5, 23, 9, 40, 17, 3]


def _drain(scheduler, request, prompts):
    for rid, p in enumerate(prompts):
        scheduler.submit(request(rid=rid, prompt=p, max_new=6))
    return {c.rid: (c.tokens, c.finish_reason) for c in scheduler.drain()}


@pytest.mark.parametrize("chunk", [None, 16])
def test_continuous_scheduler_token_identical_to_reference(chunk):
    """Same mixed-length trace through both schedulers (photonic, R&B):
    admission order, bucket padding, chunk tail padding and the idle and
    staging slots riding each decode batch all shape the per-tensor A8
    scales, so token identity checks them all."""
    jp, tp = _programs("rb")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 128, n).astype(np.int32) for n in TRACE]
    want = _drain(JScheduler(jp, capacity=3, max_len=64,
                             prefill_chunk=chunk), JRequest, prompts)
    ts = TScheduler(tp, capacity=3, max_len=64, prefill_chunk=chunk)
    got = _drain(ts, TRequest, prompts)
    assert sorted(got) == sorted(want) == list(range(len(TRACE)))
    for rid in want:
        np.testing.assert_array_equal(got[rid][0], want[rid][0])
        assert got[rid][1] == want[rid][1] == "length"
    assert ts.stats.generated_tokens == 6 * len(TRACE)
    if chunk is not None:
        assert ts.stats.prefill_chunks > 0


def test_scheduler_eos_and_validation():
    _, tp = _programs("dense")
    prompt = np.arange(4, dtype=np.int32)
    first = int(tp.generate(prompt[None], 1)[0, -1])
    ts = TScheduler(tp, capacity=2, max_len=16)
    ts.submit(TRequest(rid=0, prompt=prompt, max_new=5, eos_id=first))
    (comp,) = ts.drain()
    assert comp.finish_reason == "eos" and len(comp.tokens) == 5
    with pytest.raises(ValueError):
        ts.submit(TRequest(rid=1, prompt=np.zeros(15, np.int32), max_new=5))
    with pytest.raises(ValueError):
        ts.submit(TRequest(rid=2, prompt=prompt, max_new=0))


def test_slot_pool_allocate_free_and_prefill_insert():
    _, tc, _, _ = _model("dense")
    pool = SlotPool(tc, capacity=3, max_len=16, device="cpu")
    s0 = pool.allocate(SlotState(rid=0, prompt_len=4, max_new=2))
    s1 = pool.allocate(SlotState(rid=1, prompt_len=4, max_new=2))
    assert (s0, s1) == (0, 1) and pool.num_free == 1
    pool.positions[s0] = 7
    assert pool.free(s0).rid == 0 and pool.positions[s0] == 0
    assert pool.allocate(SlotState(rid=2, prompt_len=4, max_new=2)) == 0
    with pytest.raises(ValueError):
        pool.free(2)
    pre = {"main": {"l0": {k: torch.ones((2, 1, 1, 5, 2, 8))
                           for k in ("k", "v")}}}
    pool.write_prefill(1, pre, 5)
    k = pool.caches["main"]["l0"]["k"]
    assert float(k[:, :, 1, :5].min()) == 1.0
    assert float(k[:, :, 1, 5:].abs().max()) == 0.0
    assert float(k[:, :, 0].abs().max()) == 0.0
    assert pool.positions[1] == 5
    for _ in range(20):
        pool.advance(1)
    assert pool.positions[1] == 15                      # clamped
    assert pool.position_vector().tolist() == [0, 15, 0]


def test_temperature_sampling_needs_a_generator():
    _, tp = _programs("dense")
    logits = torch.randn(2, 128)
    with pytest.raises(ValueError):
        t_api.sample(logits, 100, temperature=0.7)
    g = torch.Generator().manual_seed(0)
    tok = t_api.sample(logits, 100, g, temperature=0.7)
    assert tok.shape == (2,) and int(tok.max()) < 100
    out = tp.generate(np.zeros((1, 3), np.int32), 4, temperature=0.8, seed=1)
    again = tp.generate(np.zeros((1, 3), np.int32), 4, temperature=0.8,
                        seed=1)
    torch.testing.assert_close(out, again)
