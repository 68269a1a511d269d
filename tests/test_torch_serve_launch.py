"""The serving launcher and the scheduler's telemetry against the JAX
reference on the same weights: ``ContinuousScheduler(telemetry=...)`` and
``WaveBatcher(telemetry=...)`` on a float32 R&B tiny dense model (xla,
photonic, chunked prefill) give the same tokens, stats, occupancy, meter
ledger, tracker counts, trace rows and streaming callbacks as the
reference's; ``gqa_decode_legacy`` and ``decode_step_fn(legacy_decode=
True)``; ``SlotPool.reset`` / ``remaining``; the launcher's trace; and
``repro_torch.launch.serve.main`` on the CPU for every scheduler, the
telemetry outputs, the fault model, a vlm and ``--mesh`` (a 1x1 mesh
in-process, a malformed spec refused; ranks in ``test_torch_sharded``)."""
import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import api as j_api
from repro.configs.base import ModelConfig as JCfg
from repro.core.prm import ReuseConfig as JRC
from repro.launch import serve as j_launch
from repro.models import attention as j_attn
from repro.models import transformer as j_tfm
from repro.obs.serving import ServingObs as JObs
from repro.serve import engine as j_engine
from repro.serve.batcher import Request as JRequest
from repro.serve.batcher import WaveBatcher as JWave
from repro.serve.scheduler import ContinuousScheduler as JScheduler
from repro.serve.slots import SlotPool as JPool
from repro.serve.slots import SlotState as JState
from repro.train.checkpoint import _flatten

from repro_torch import api as t_api
from repro_torch import bridge
from repro_torch.configs.base import ModelConfig as TCfg
from repro_torch.core.prm import ReuseConfig as TRC
from repro_torch.kernels import counts
from repro_torch.launch import serve as t_launch
from repro_torch.models import attention as t_attn
from repro_torch.obs import check_schema
from repro_torch.obs import metrics as t_metrics
from repro_torch.obs.serving import ServingObs as TObs
from repro_torch.serve import engine as t_engine
from repro_torch.serve.batcher import Request as TRequest
from repro_torch.serve.batcher import WaveBatcher as TWave
from repro_torch.serve.scheduler import ContinuousScheduler as TScheduler
from repro_torch.serve.slots import SlotPool as TPool
from repro_torch.serve.slots import SlotState as TState

torch.set_num_threads(2)
# the model gates of the port (ROADMAP): logits vs the reference
GATES = {"xla": 1e-5, "photonic": 1e-3}


@functools.lru_cache(maxsize=None)
def _model():
    """8 float32 layers as 2 banks x 4 reuses (identity, shuffle,
    transpose, shuffle)."""
    kw = dict(name="t", family="dense", num_layers=8, d_model=32,
              num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=128,
              compute_dtype="float32")
    t = ("identity", "shuffle", "transpose", "shuffle")
    jc = JCfg(reuse=JRC(num_basic=2, reuse_times=4, transforms=t,
                        shuffle_groups=8), **kw)
    tc = TCfg(reuse=TRC(num_basic=2, reuse_times=4, transforms=t,
                        shuffle_groups=8), **kw)
    params, _ = j_tfm.init_model(jax.random.PRNGKey(0), jc)
    return jc, tc, params, _flatten(params)


@functools.lru_cache(maxsize=None)
def _j_program(execution):
    jc, _, params, _ = _model()
    return j_api.Program.build(jc, params, execution=execution)


def _t_program(execution):
    """Built in the test: ``program.*`` lands on the current default
    registry."""
    _, tc, _, flat = _model()
    return t_api.Program.build(tc, bridge.params_from_flat(flat,
                                                           device="cpu"),
                               execution=execution, device="cpu")


def _trace(request_cls, cfg):
    """The launcher's trace, through the package's own ``_make_trace``."""
    launch = j_launch if request_cls is JRequest else t_launch
    return launch._make_trace(cfg, 7, 24, 6)


def _drain(sched, reqs):
    for r in reqs:
        sched.submit(r)
    return sched.drain()


def _trace_shape(obs):
    evs = obs.tracer.events
    rows = {e["args"]["name"] for e in evs if e["ph"] == "M"}
    return {e["name"] for e in evs}, rows


def _tracker_counts(obs):
    t = obs.tracker
    c = obs.registry.counter
    return (t.ttft.count, t.tpot.count, t.e2e.count, t.queue.count,
            c("serve.requests.arrived").value,
            c("serve.requests.completed").value)


def _assert_same_meter(t_rep, j_rep):
    assert set(t_rep) == set(j_rep)
    for k, v in j_rep.items():
        if isinstance(v, int):
            assert t_rep[k] == v, k
        else:
            assert t_rep[k] == pytest.approx(v, rel=1e-9, abs=1e-9), k


def _assert_snapshot(obs):
    snap = obs.snapshot()
    assert check_schema.validate(snap, check_schema.load_schema()) == []
    keys = set(snap["counters"]) | set(snap["gauges"])
    assert snap["counters"]["program.builds"] >= 1
    assert any(k.startswith("program.bank.") for k in keys)
    assert "compile.capture.decode" in keys
    assert {f'kernel.launches{{kernel="{n}"}}' for n in counts.COUNTERS
            } <= keys
    return snap


@pytest.mark.parametrize("execution, chunk", [
    ("xla", None), ("photonic", None), ("photonic", 8)])
def test_continuous_scheduler_telemetry_equal_to_reference(execution, chunk):
    jc, tc, _, _ = _model()
    jp, tp = _j_program(execution), _t_program(execution)
    out = {}
    for side, sched_cls, obs_cls, prog, cfg, req in (
            ("ref", JScheduler, JObs, jp, jc, JRequest),
            ("port", TScheduler, TObs, tp, tc, TRequest)):
        calls = []
        obs = obs_cls.create(cfg)
        sched = sched_cls(prog, capacity=3, max_len=30,
                          prefill_chunk=chunk, telemetry=obs,
                          on_token=lambda rid, tok: calls.append((rid, tok)),
                          on_complete=lambda c: calls.append(("done",
                                                              c.rid)))
        done = _drain(sched, _trace(req, cfg))
        out[side] = (done, sched, obs, calls)
    (j_done, j_s, j_obs, j_calls), (t_done, t_s, t_obs, t_calls) = (
        out["ref"], out["port"])
    assert [c.rid for c in t_done] == [c.rid for c in j_done]
    for t, j in zip(t_done, j_done):
        np.testing.assert_array_equal(t.tokens, np.asarray(j.tokens))
        assert (t.prompt_len, t.padded_to, t.finish_reason) == (
            j.prompt_len, j.padded_to, j.finish_reason)
    assert t_calls == [(r, int(k)) if r != "done" else (r, k)
                       for r, k in j_calls]
    assert t_s.stats.as_dict() == j_s.stats.as_dict()
    assert t_s.stats.overhead == j_s.stats.overhead > 0.0
    assert t_s.stats.occupancy_distribution == \
        j_s.stats.occupancy_distribution
    assert t_s.stats.idle_fraction == j_s.stats.idle_fraction
    assert (chunk is None) == (t_s.stats.prefill_chunks == 0)
    _assert_same_meter(t_obs.meter.report(), j_obs.meter.report())
    assert _tracker_counts(t_obs) == _tracker_counts(j_obs)
    assert _trace_shape(t_obs) == _trace_shape(j_obs)
    names, rows = _trace_shape(t_obs)
    assert {"queue", "prefill", "decode", "finish", "decode_step",
            "active_slots"} <= names
    assert ("prefill_chunk" in names) == (chunk is not None)
    assert rows == {f"req {i}" for i in range(7)}
    assert t_obs.stats_line(t_s.stats).startswith("[stats] reqs 7/7 | ")
    snap = _assert_snapshot(t_obs)
    for k in ("serve.ttft_ms", "serve.tpot_ms", "serve.e2e_ms",
              "serve.queue_ms", "serve.active_slots"):
        assert snap["histograms"][k]["count"] == \
            j_obs.snapshot()["histograms"][k]["count"]


@pytest.mark.parametrize("execution", ["xla", "photonic"])
def test_wave_batcher_telemetry_equal_to_reference(execution):
    jc, tc, _, _ = _model()
    jp, tp = _j_program(execution), _t_program(execution)
    j_obs, t_obs = JObs.create(jc), TObs.create(tc)
    jw = JWave(jp, wave_size=3, telemetry=j_obs)
    tw = TWave(tp, wave_size=3, telemetry=t_obs)
    j_done = _drain(jw, _trace(JRequest, jc))
    t_done = _drain(tw, _trace(TRequest, tc))
    assert [c.rid for c in t_done] == [c.rid for c in j_done]
    for t, j in zip(t_done, j_done):
        np.testing.assert_array_equal(t.tokens, np.asarray(j.tokens))
    assert tw.stats.as_dict() == jw.stats.as_dict()
    _assert_same_meter(t_obs.meter.report(), j_obs.meter.report())
    assert _tracker_counts(t_obs) == _tracker_counts(j_obs)
    assert _trace_shape(t_obs) == _trace_shape(j_obs)
    assert "wave" in _trace_shape(t_obs)[0]
    _assert_snapshot(t_obs)


def test_gqa_decode_legacy_equal_to_reference():
    """One layer's baseline decode on a random cache: the output and the
    cache with the token's K/V written at ``pos``."""
    _, tc, _, _ = _model()
    rng = np.random.default_rng(3)
    d, H, KV, hd = tc.d_model, tc.num_heads, tc.num_kv_heads, tc.head_dim
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.2 for k, s in
         (("wq", (d, H * hd)), ("wk", (d, KV * hd)), ("wv", (d, KV * hd)),
          ("wo", (H * hd, d)))}
    x = rng.standard_normal((2, 1, d)).astype(np.float32)
    cache = {k: rng.standard_normal((2, 12, KV, hd)).astype(np.float32)
             for k in ("k", "v")}
    jc = _model()[0]
    for transpose in (False, True):
        jy, jcache = j_attn.gqa_decode_legacy(
            {k: jnp.asarray(v) for k, v in p.items()}, jc, jnp.asarray(x),
            {k: jnp.asarray(v) for k, v in cache.items()}, 5,
            transpose=transpose)
        tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
        ty, out = t_attn.gqa_decode_legacy(
            {k: torch.from_numpy(v) for k, v in p.items()}, tc,
            torch.from_numpy(x), tcache, 5, transpose=transpose)
        assert out is tcache
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-6)
        for k in ("k", "v"):
            np.testing.assert_allclose(tcache[k].numpy(),
                                       np.asarray(jcache[k]), rtol=1e-5,
                                       atol=1e-6)
    with pytest.raises(ValueError, match="scalar position"):
        t_attn.gqa_decode_legacy(
            {k: torch.from_numpy(v) for k, v in p.items()}, tc,
            torch.from_numpy(x), tcache, torch.tensor([5, 6]))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


@pytest.mark.parametrize("execution", ["xla", "photonic"])
def test_legacy_decode_step_fn_equal_to_reference(execution):
    """Prefill, then greedy legacy decode steps at scalar positions through
    the engine shims: logits within the model gate, tokens identical, and
    the port's legacy steps equal to its default decode path."""
    jc, tc, params, flat = _model()
    tp = bridge.params_from_flat(flat, device="cpu")
    prompt = np.random.default_rng(5).integers(0, 128, (2, 9)).astype(
        np.int32)
    j_lg, j_c = j_engine.prefill_step(params, jc, {"tokens": jnp.asarray(
        prompt)}, 16, execution=execution)
    t_lg, t_c = t_engine.prefill_step(tp, tc, {"tokens": prompt}, 16,
                                      execution=execution)
    _, t_ref_c = t_engine.prefill_step(tp, tc, {"tokens": prompt}, 16,
                                       execution=execution)
    for i in range(3):
        j_tok = np.asarray(jnp.argmax(j_lg[:, :tc.vocab_size], -1))
        t_tok = torch.argmax(t_lg[:, :tc.vocab_size], -1).numpy()
        np.testing.assert_array_equal(t_tok, j_tok)
        cur = t_tok[:, None].astype(np.int32)
        j_lg, j_c = j_engine.decode_step(
            params, jc, {"tokens": jnp.asarray(cur)}, j_c, 9 + i,
            legacy_decode=True, execution=execution)
        t_lg, t_c = t_engine.decode_step(tp, tc, {"tokens": cur}, t_c,
                                         9 + i, legacy_decode=True,
                                         execution=execution)
        assert _rel(t_lg.numpy(), np.asarray(j_lg)) <= GATES[execution]
        ref_lg, t_ref_c = t_engine.decode_step(tp, tc, {"tokens": cur},
                                               t_ref_c, 9 + i,
                                               execution=execution)
        assert _rel(t_lg.numpy(), ref_lg.numpy()) <= GATES[execution]


def test_legacy_decode_with_cross_attention_and_refusals():
    """A vlm stack under legacy decode: its self-attention layers write
    their own cache, its cross-attention K/V stay as the prefill wrote
    them, and the logits equal the default decode path's.  Stacks whose
    decode returns a delta the legacy runner would not write refuse."""
    from repro_torch.configs import smoke_variant, stub_extras
    from repro_torch.core.prepared import tree_leaves
    from repro_torch.models import transformer as t_tfm
    cfg = smoke_variant("llama-3.2-vision-11b")
    params = t_tfm.init_model(cfg, seed=0, device="cpu")
    prompt = np.random.default_rng(2).integers(1, cfg.vocab_size, (2, 7))
    extras = stub_extras(cfg, 2, torch.Generator().manual_seed(4))
    logits = []
    for legacy in (True, False):
        lg, caches = t_engine.prefill_step(params, cfg, {"tokens": prompt,
                                                         **extras}, 12)
        cross = [v for v in tree_leaves(caches)
                 if v.shape[-3] == cfg.vision.num_image_tokens]
        kept = [v.clone() for v in cross]
        for i in range(3):
            cur = torch.argmax(lg[:, :cfg.vocab_size], -1)[:, None]
            lg, caches = t_engine.decode_step(params, cfg, {"tokens": cur},
                                              caches, 7 + i,
                                              legacy_decode=legacy)
        assert cross and all(torch.equal(a, b) for a, b in zip(cross, kept))
        logits.append(lg)
    np.testing.assert_allclose(logits[0].numpy(), logits[1].numpy(),
                               rtol=1e-5, atol=1e-5)
    for name in ("whisper-medium", "deepseek-v2-lite-16b"):
        c = smoke_variant(name)
        with pytest.raises(ValueError, match="legacy_decode"):
            t_engine.decode_step(t_tfm.init_model(c, seed=0, device="cpu"),
                                 c, {"tokens": np.zeros((1, 1), np.int64)},
                                 t_tfm.init_caches(c, 1, 4, device="cpu"),
                                 1, legacy_decode=True)


def test_slot_pool_reset_and_remaining_equal_to_reference():
    jc, tc, _, _ = _model()
    jp, tp = JPool(jc, 3, 16), TPool(tc, 3, 16, device="cpu")
    for pool, state in ((jp, JState), (tp, TState)):
        for rid in range(3):
            pool.allocate(state(rid=rid, prompt_len=4, max_new=2))
        pool.positions[:] = [4, 15, 9]
        pool.advance(0)
        pool.advance(1)
        pool.free(2)
    assert [tp.remaining(s) for s in range(3)] == \
        [jp.remaining(s) for s in range(3)] == [11, 1, 16]
    jp.reset()
    tp.reset()
    for pool in (jp, tp):
        assert (pool.num_free, pool.num_active, pool.active_slots()) == (
            3, 0, [])
        assert list(pool.positions) == [0, 0, 0]
        assert [pool.remaining(s) for s in range(3)] == [16] * 3


def test_make_trace_equal_to_reference():
    jc, tc, _, _ = _model()
    for n, mp, mn in ((12, 32, 16), (5, 1024, 32), (3, 4, 1)):
        want = j_launch._make_trace(jc, n, mp, mn)
        got = t_launch._make_trace(tc, n, mp, mn)
        assert [(r.rid, r.max_new, r.extras) for r in got] == [
            (r.rid, r.max_new, None) for r in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.prompt, w.prompt)
            assert g.prompt.dtype == np.int32


SMOKE = ["--arch", "minitron-4b", "--smoke", "--device", "cpu",
         "--requests", "5", "--capacity", "3", "--max-prompt", "24",
         "--new-tokens", "6"]


@pytest.mark.parametrize("scheduler", ["continuous", "wave", "engine"])
def test_launcher_main_each_scheduler(scheduler, capsys):
    done = t_launch.main(SMOKE + ["--scheduler", scheduler])
    out = capsys.readouterr().out
    n = 3 if scheduler == "engine" else 5
    assert len(done) == n and [c.rid for c in done] == list(range(n))
    assert f"[serve/{scheduler}] minitron-4b-smoke" in out
    assert "tok/s on CPU" in out
    assert not t_metrics.enabled()


def test_launcher_telemetry_outputs_and_token_identity(tmp_path, capsys):
    """--stats --trace-out --metrics-out: the periodic stats line, a
    Chrome trace with a row per request, a snapshot that validates (also
    through the CLI); and the same Program drained with telemetry off
    gives the same tokens."""
    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.json"
    args = t_launch.parse_args(SMOKE + [
        "--execution", "photonic", "--stats", "--stats-every", "2",
        "--trace-out", str(trace), "--metrics-out", str(metrics)])
    cfg, prog = t_launch.build_program(args)
    off = t_launch.serve(prog, t_launch.parse_args(
        SMOKE + ["--execution", "photonic"]))
    on = t_launch.serve(prog, args, t_launch.make_obs(cfg, args))
    assert [c.tokens.tolist() for c in on] == [c.tokens.tolist()
                                               for c in off]
    out = capsys.readouterr().out
    assert "[stats] step 2 | reqs" in out and "energy:" in out
    assert check_schema.main([str(metrics),
                              str(check_schema.SCHEMA_PATH)]) == 0
    snap = json.loads(metrics.read_text())
    gen = sum(c.tokens.size - c.prompt_len for c in on)
    assert snap["histograms"]["serve.ttft_ms"]["count"] == 5
    assert snap["histograms"]["serve.tpot_ms"]["count"] == gen - 5
    assert (snap["counters"]['program.steps{kind="decode_sample"}']
            == snap["counters"]["serve.decode_steps"])
    evs = json.loads(trace.read_text())["traceEvents"]
    rows = {e["args"]["name"] for e in evs if e["ph"] == "M"}
    assert rows == {f"req {i}" for i in range(5)}
    assert {"queue", "prefill", "decode", "finish", "decode_step",
            "active_slots"} <= {e["name"] for e in evs}
    assert not t_metrics.enabled()


def test_launcher_fault_model_and_vlm(capsys):
    done = t_launch.main(SMOKE + [
        "--execution", "photonic", "--array-budget", "20", "--noise",
        "gain=0.01,ct=0.002,dac=0.25,drift=0.05", "--calibrate-every", "2",
        "--stats"])
    out = capsys.readouterr().out
    assert len(done) == 5
    assert "[serve] photonic fault model on:" in out
    assert "residency: hit rate" in out and "calibration: " in out
    vlm = t_launch.main(["--arch", "llama-3.2-vision-11b", "--smoke",
                         "--device", "cpu", "--requests", "3",
                         "--max-prompt", "16", "--new-tokens", "4"])
    assert len(vlm) == 3
    cfg = t_launch.smoke_variant("llama-3.2-vision-11b")
    emb = [r.extras["image_embeds"] for r in
           t_launch._make_trace(cfg, 2, 16, 4, device="cpu")]
    assert emb[0].shape == (1, cfg.vision.num_image_tokens,
                            cfg.vision.d_vision)
    assert not torch.equal(emb[0], emb[1])
    assert torch.equal(emb[0], t_launch._request_extras(
        cfg, 0, "cpu")["image_embeds"])


def test_launcher_refusals():
    # --mesh is served since the sharding slice: a 1x1 mesh in-process,
    # a malformed spec refused before any rank starts
    assert len(t_launch.main(SMOKE + ["--mesh", "1x1"])) == 5
    with pytest.raises(ValueError, match="must be DxM or PxDxM"):
        t_launch.main(SMOKE + ["--mesh", "2xq"])
    with pytest.raises(SystemExit, match="needs --noise"):
        t_launch.main(SMOKE + ["--calibrate-every", "2"])
    with pytest.raises(SystemExit, match="--execution photonic"):
        t_launch.main(SMOKE + ["--noise", "gain=0.01"])
