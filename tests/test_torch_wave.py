"""The port's wave batcher, ``Scheduler`` protocol and engine shims against
the JAX reference's on the same weights (float32 dense and MoE smoke
configs): completions and greedy tokens identical, ``WaveStats`` equal
field for field, and a mesh or an ``act_pspec`` without ranks refused
(sharded serving on ranks: ``tests/test_torch_sharded.py``).  ``legacy_decode`` runs since slice 12
(``tests/test_torch_serve_launch.py``).  Modality extras are
taken since slice 11 (``tests/test_torch_vlm.py``,
``tests/test_torch_audio.py``).

The MoE waves run on xla as they are.  On photonic they are compared
*taught* (``test_photonic_moe_waves_taught``, with ``test_torch_vlm``'s
``taught``): untaught, one of these waves parts from the reference at its
third generated token through the reference's own sensitivity: after one
decode step the two caches differ by 1.5e-6 (float32 summation order),
and the reference's next logits move 0.03 rel-L2 between its own caches
and the port's (an A8 or routing flip), while on the port's caches the
two agree to 5e-7.  ``test_torch_graphs.py`` holds photonic MoE decode
steps to the reference from shared caches, and
``test_torch_moe_serving.py`` its greedy tokens."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import api as j_api
from repro.configs import smoke_variant as j_smoke
from repro.models import transformer as j_tfm
from repro.serve import engine as j_engine
from repro.serve.batcher import Request as JRequest
from repro.serve.batcher import WaveBatcher as JWave
from repro.train.checkpoint import _flatten

from repro_torch import api as t_api
from repro_torch import bridge
from repro_torch.configs import smoke_variant as t_smoke
from repro_torch.obs.stats import ContinuousStats, WaveStats
from repro_torch.serve import engine as t_engine
from repro_torch.serve.batcher import Request as TRequest
from repro_torch.serve.batcher import WaveBatcher as TWave
from repro_torch.serve.scheduler import ContinuousScheduler, Scheduler
from test_torch_vlm import RecordingBackend, taught

torch.set_num_threads(2)
V = 211


@functools.lru_cache(maxsize=None)
def _model(name):
    jc, tc = j_smoke(name), t_smoke(name)
    params, _ = j_tfm.init_model(jax.random.PRNGKey(1), jc)
    return jc, tc, params, bridge.params_from_flat(_flatten(params),
                                                   device="cpu")


@functools.lru_cache(maxsize=None)
def _programs(name, execution="photonic"):
    jc, tc, params, tp = _model(name)
    return (j_api.Program.build(jc, params, execution=execution),
            t_api.Program.build(tc, tp, execution=execution, device="cpu"))


def _requests(request, seed=6):
    rng = np.random.default_rng(seed)
    lens, news = (7, 3, 12, 5, 9), (4, 6, 3, 5, 2)
    return [request(rid=i, prompt=rng.integers(0, V, n).astype(np.int32),
                    max_new=m) for i, (n, m) in enumerate(zip(lens, news))]


@pytest.mark.parametrize("name, execution", [
    ("minitron-4b", "photonic"), ("minitron-4b", "xla"),
    ("granite-moe-1b-a400m", "xla")])
def test_wave_batcher_token_identical_to_reference(name, execution):
    """Left-padded waves of 2 from a 5-request queue (the head window sorts
    longest first): the same completions, in the same order, and the same
    ``WaveStats``."""
    jp, tp = _programs(name, execution)
    jw, tw = JWave(jp, wave_size=2), TWave(tp, wave_size=2)
    for jr, tr in zip(_requests(JRequest), _requests(TRequest)):
        jw.submit(jr)
        tw.submit(tr)
    want, got = jw.drain(), tw.drain()
    assert [c.rid for c in got] == [c.rid for c in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))
        assert (g.prompt_len, g.padded_to, g.finish_reason) == (
            w.prompt_len, w.padded_to, w.finish_reason)
    assert tw.stats.as_dict() == jw.stats.as_dict()
    assert tw.stats.waves == 3 and tw.stats.padding_overhead == pytest.approx(
        jw.stats.padding_overhead)


def test_photonic_moe_waves_taught(monkeypatch):
    """granite's MoE waves on photonic, taught: the reference records the
    input of each of its MVM calls, the port checks its own input to the
    same call (rel-L2 <= 1e-5; each differing A8 code a one-step flip
    within ``chip_smoke.A8_FLIP_BAND`` of its boundary) and multiplies the
    reference's.  The same completions, greedy tokens and ``WaveStats``
    (one A8 code flips on these requests, and is taught away)."""
    jc, tc, params, tp = _model("granite-moe-1b-a400m")
    jprog = j_api.Program.build(jc, params,
                                execution=RecordingBackend("photonic"))
    tprog = t_api.Program.build(tc, tp, execution="photonic", device="cpu")

    def drain(wave, prog, request):
        w = wave(prog, wave_size=2)
        for r in _requests(request):
            w.submit(r)
        done = w.drain()
        return ([(c.rid, np.asarray(c.tokens), c.prompt_len, c.padded_to,
                  c.finish_reason) for c in done], w.stats.as_dict())

    want, got, flips = taught(monkeypatch,
                              lambda: drain(JWave, jprog, JRequest),
                              lambda: drain(TWave, tprog, TRequest))
    assert [c[0] for c in got[0]] == [c[0] for c in want[0]]
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g[1], w[1])
        assert g[2:] == w[2:]
    assert got[1] == want[1] and got[1]["waves"] == 3
    assert flips <= 4


def test_wave_batcher_builds_from_params_and_refuses_extras():
    """Built from (params, cfg) on the CPU; a missing cfg refuses.  Since
    slice 11 extras are no longer refused: they queue, and waves group by
    ``_extras_match`` (arrays or tensors, compared by value)."""
    _, tc, _, tp = _model("minitron-4b")
    tw = TWave(tp, tc, wave_size=4, device="cpu")
    assert tw.program.device == torch.device("cpu")
    with pytest.raises(ValueError):
        TWave(tp)
    tw.submit(TRequest(rid=0, prompt=np.arange(3, dtype=np.int32),
                       max_new=2, extras={"image": np.zeros(4)}))
    assert len(tw.queue) == 1
    assert TWave._extras_match({"a": torch.ones(2)}, {"a": np.ones(2)})
    assert not TWave._extras_match({"a": torch.ones(2)},
                                   {"a": torch.zeros(2)})
    assert TWave._extras_match(None, None)
    assert not TWave._extras_match({"a": np.ones(2)}, None)
    assert TWave._extras_match({"a": np.ones(2)}, {"a": np.ones(2)})
    assert not TWave._extras_match({"a": np.ones(2)}, {"a": np.zeros(2)})


@pytest.mark.parametrize("execution", ["xla", "photonic"])
def test_engine_shims_token_identical(execution):
    """``engine.generate`` against ``Program.generate`` and the reference's
    ``engine.generate``; ``prefill_step`` / ``decode_step`` greedy loops
    against ``Program.generate``."""
    jc, tc, params, tp = _model("minitron-4b")
    prompt = np.random.default_rng(7).integers(0, V, (2, 8)).astype(np.int32)
    got = t_engine.generate(tp, tc, prompt, 6, execution=execution,
                            device="cpu")
    prog = t_api.Program.build(tc, tp, execution=execution, device="cpu")
    torch.testing.assert_close(got, prog.generate(prompt, 6), rtol=0, atol=0)
    want = j_engine.generate(params, jc, jnp.asarray(prompt), 6,
                             execution=execution)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    logits, caches = t_engine.prefill_step(tp, tc, {"tokens": prompt}, 14,
                                           execution=execution)
    toks = []
    for i in range(6):
        cur = t_engine.sample(logits, tc.vocab_size).long()[:, None]
        toks.append(cur)
        if i < 5:
            logits, caches = t_engine.decode_step(
                tp, tc, {"tokens": cur}, caches,
                np.full(2, 8 + i) if i % 2 else 8 + i, execution=execution)
    torch.testing.assert_close(torch.cat(toks, dim=1), got[:, 8:], rtol=0,
                               atol=0)


def test_engine_cast_params_and_refusals():
    _, tc, _, tp = _model("minitron-4b")
    bf = t_engine.cast_params(tp, dataclasses.replace(
        tc, compute_dtype="bfloat16"))
    assert bf["embed"]["table"].dtype == torch.bfloat16
    assert t_engine.cast_params(tp, tc)["embed"]["table"].dtype == \
        torch.float32
    prompt = np.zeros((1, 4), np.int32)
    # since the sharding slice: a mesh of several positions runs as ranks,
    # and an act_pspec needs a backend on such a mesh
    from repro_torch.launch import mesh as mesh_lib
    with pytest.raises(ValueError, match="init_ranks"):
        t_engine.generate(tp, tc, prompt, 2, device="cpu",
                          mesh=mesh_lib.parse_mesh("2x2"))
    with pytest.raises(ValueError, match="active mesh"):
        t_engine.prefill_step(tp, tc, {"tokens": prompt}, 8,
                              act_pspec=object())
    with pytest.raises(ValueError, match="scalar position"):
        caches = t_api.Program.build(tc, tp, device="cpu").empty_caches(1, 8)
        t_engine.decode_step(tp, tc, {"tokens": prompt[:, :1]}, caches,
                             np.array([4]), legacy_decode=True)
    with pytest.raises(ValueError, match="active mesh"):
        t_api.decode_step_fn(tc, act_pspec=object())


def test_schedulers_satisfy_the_protocol():
    _, tp = _programs("minitron-4b")
    assert isinstance(ContinuousScheduler(tp, capacity=2, max_len=16),
                      Scheduler)
    assert isinstance(TWave(tp), Scheduler)
    assert not isinstance(object(), Scheduler)


def test_stats_are_registry_backed():
    ws = WaveStats()
    ws.requests += 2
    ws.slot_steps += 10
    ws.useful_steps += 7
    assert ws.registry.counter("serve.requests").value == 2.0
    assert ws.overhead == pytest.approx(0.3)
    cs = ContinuousStats()
    cs.decode_steps += 3
    assert cs.as_dict() == {"requests": 0, "prompt_tokens": 0,
                            "generated_tokens": 0, "slot_steps": 0,
                            "useful_steps": 0, "prefills": 0,
                            "decode_steps": 3, "padded_prefill_tokens": 0,
                            "idle_slot_steps": 0, "prefill_chunks": 0,
                            "overhead": 0.0}
    cs.slot_steps += 8
    cs.useful_steps += 6
    assert cs.overhead == pytest.approx(0.25)
