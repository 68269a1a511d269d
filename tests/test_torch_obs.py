"""The port's serving telemetry (``repro_torch.obs``: tracing, stats,
serving, check_schema and the metrics schema's copy) against the JAX
reference's on the same inputs: event streams and Chrome-trace JSON under
one patched clock, request-tracker histograms for one hook sequence, the
schema validator's error lists, the serving stats' fields and derived
metrics, the stats line and the Prometheus text.  Neither side runs a
model here (``tests/test_torch_serve_launch.py`` serves both)."""
import json
import types
from pathlib import Path

import pytest

from repro.configs import smoke_variant as j_smoke
from repro.obs import check_schema as j_schema
from repro.obs import metrics as j_metrics
from repro.obs import serving as j_serving
from repro.obs import stats as j_stats
from repro.obs import tracing as j_tracing

import repro_torch.obs as t_obs
from repro_torch.configs import smoke_variant as t_smoke
from repro_torch.kernels import counts
from repro_torch.obs import check_schema as t_schema
from repro_torch.obs import metrics as t_metrics
from repro_torch.obs import serving as t_serving
from repro_torch.obs import stats as t_stats
from repro_torch.obs import tracing as t_tracing

ROOT = Path(__file__).resolve().parents[1]
REF_SCHEMA = ROOT / "benchmarks" / "metrics_schema.json"


class _Clock:
    """A monotonic clock that steps by a fixed, uneven sequence."""

    def __init__(self, start=100.0):
        self.t = start
        self.steps = [0.0013, 0.0021, 0.0007, 0.0113, 0.0042]
        self.i = 0

    def monotonic(self):
        self.t += self.steps[self.i % len(self.steps)]
        self.i += 1
        return self.t


@pytest.fixture
def clocks(monkeypatch):
    """One clock per package, stepping identically: each module's ``time``
    is swapped for it."""
    made = {}
    for side, mods in (("ref", (j_tracing, j_serving)),
                       ("port", (t_tracing, t_serving))):
        clk = _Clock()
        fake = types.SimpleNamespace(monotonic=clk.monotonic)
        for mod in mods:
            monkeypatch.setattr(mod, "time", fake)
        made[side] = clk
    return made


def _drive_tracer(tr):
    tr.complete("queue", 5.0, 12.5, tid=3, prompt_len=9)
    with tr.span("decode_step", active=3, capacity=4):
        tr.instant("finish", tid=7, reason="length")
    tr.counter("active_slots", 3)
    tr.thread_name(7, "req 7")
    tr.complete("neg", 1.0, -4.0)
    return tr


def test_tracer_event_streams_and_chrome_trace_equal(clocks, tmp_path):
    j, t = (_drive_tracer(m.Tracer(enabled=True))
            for m in (j_tracing, t_tracing))
    assert list(t.events) == list(j.events)
    assert t.chrome_trace() == j.chrome_trace()
    t.save(str(tmp_path / "t.json"))
    j.save(str(tmp_path / "j.json"))
    assert (json.loads((tmp_path / "t.json").read_text())
            == json.loads((tmp_path / "j.json").read_text()))
    # off: nothing recorded; bounded: the oldest events fall out
    off = _drive_tracer(t_tracing.Tracer(enabled=False))
    assert len(off.events) == 0
    for mod in (j_tracing, t_tracing):
        b = mod.Tracer(maxlen=10, enabled=True)
        for i in range(25):
            b.instant(f"e{i}")
        assert [e["name"] for e in b.events] == [f"e{i}"
                                                 for i in range(15, 25)]
    assert not t_tracing.default_tracer().enabled
    assert t_tracing.enable_tracing(True) is t_tracing.default_tracer()
    t_tracing.enable_tracing(False)


def _hooks(tracker):
    """Two finished requests (one of them eos) and one still live."""
    for rid in (0, 1, 2):
        tracker.on_submit(rid)
    tracker.on_admit(0, 5, 8)
    tracker.on_admit(1, 9, 16)
    tracker.on_first_token(0)
    tracker.on_token(0)
    tracker.on_first_token(1)
    for _ in range(3):
        tracker.on_token(0)
        tracker.on_token(1)
    tracker.on_finish(0, "length")
    tracker.on_admit(2, 3, 8)
    tracker.on_token(1)
    tracker.on_finish(1, "eos")
    tracker.on_first_token(2)
    tracker.on_token(99)                 # unknown rids are ignored
    tracker.on_finish(99)


def test_request_tracker_histograms_equal(clocks):
    out = {}
    for side, mod, tmod, mmod in (("ref", j_serving, j_tracing, j_metrics),
                                  ("port", t_serving, t_tracing, t_metrics)):
        reg = mmod.MetricsRegistry()
        tr = tmod.Tracer(enabled=True)
        tracker = mod.RequestTracker(reg, tr)
        _hooks(tracker)
        out[side] = (tracker.percentiles(), reg.snapshot(), list(tr.events),
                     sorted(tracker._live))
    assert out["port"] == out["ref"]
    pct = out["port"][0]
    assert (pct["ttft_ms"]["count"], pct["tpot_ms"]["count"],
            pct["e2e_ms"]["count"], pct["queue_ms"]["count"]) == (3, 8, 2, 3)
    assert out["port"][3] == [2]


def _negative_cases(snap):
    """The reference's schema negative cases (``tests/test_obs.py``)."""
    def bad(edit):
        doc = json.loads(json.dumps(snap))
        edit(doc)
        return doc
    return [
        bad(lambda d: d["energy"].pop("tile")),
        bad(lambda d: d["counters"].__setitem__("serve.x", -1)),
        bad(lambda d: d.__setitem__("unexpected_top_level", {})),
        bad(lambda d: d["histograms"].__setitem__("serve.ttft_ms",
                                                  {"count": 1})),
        bad(lambda d: d.__setitem__("schema_version", "one")),
        bad(lambda d: d.pop("histograms")),
    ]


def test_schema_copy_and_validate_equal_to_reference():
    assert t_schema.load_schema() == json.loads(REF_SCHEMA.read_text())
    schema = t_schema.load_schema()
    obs = j_serving.ServingObs.create(trace=False)
    obs.tracker.on_submit(0)
    obs.tracker.on_admit(0, 4, 8)
    obs.tracker.on_first_token(0)
    snap = obs.snapshot()
    errors = []
    for doc in [snap] + _negative_cases(snap):
        want = j_schema.validate(doc, schema)
        assert t_schema.validate(doc, schema) == want
        errors.append(want)
    assert errors[0] == [] and errors[-1] == []
    assert all(errors[1:-1])
    # the port's own snapshot validates too, with the folded ledgers
    t = t_serving.ServingObs.create(trace=False)
    t_snap = t.snapshot()
    assert t_schema.validate(t_snap, schema) == []
    assert t_snap["histograms"] == {}
    assert "compile.capture.decode" in t_snap["counters"]
    keys = {f'kernel.launches{{kernel="{n}"}}' for n in counts.COUNTERS}
    assert keys <= set(t_snap["counters"])


def test_schema_cli(tmp_path, capsys):
    schema = str(t_schema.SCHEMA_PATH)
    snap = t_serving.ServingObs.create(trace=False).snapshot()
    good = tmp_path / "good.json"
    good.write_text(json.dumps({"metrics": {"inner": snap}}))
    assert t_schema.main([str(good), schema, "--key", "metrics.inner"]) == 0
    assert "OK:" in capsys.readouterr().out
    assert t_schema.main([str(good), schema, "--key", "nope"]) == 1
    assert t_schema.main([str(good), schema]) == 1
    out = capsys.readouterr().out
    assert "has no key 'nope'" in out and "does not match" in out


def _drive_stats(stats):
    stats.requests += 3
    stats.prompt_tokens += 37
    stats.generated_tokens += 12
    stats.slot_steps += 60
    stats.useful_steps += 45
    if isinstance(stats, (j_stats.ContinuousStats, t_stats.ContinuousStats)):
        stats.prefills += 3
        stats.padded_prefill_tokens += 11
        stats.prefill_chunks += 2
        for n in (3, 4, 4, 2, 4, 1):
            stats.observe_active(n)
            stats.decode_steps += 1
            stats.idle_slot_steps += 4 - n
    elif isinstance(stats, (j_stats.WaveStats, t_stats.WaveStats)):
        stats.waves += 2
        stats.padded_tokens += 9
    return stats


@pytest.mark.parametrize("kind", ["ServingStats", "WaveStats",
                                  "ContinuousStats"])
def test_stats_equal_to_reference(kind):
    kw = {"_capacity": 4} if kind == "ContinuousStats" else {}
    j = _drive_stats(getattr(j_stats, kind)(**kw))
    t = _drive_stats(getattr(t_stats, kind)(**kw))
    assert t.as_dict() == j.as_dict()
    assert t.overhead == j.overhead == pytest.approx(0.25)
    assert t.registry.snapshot() == j.registry.snapshot()
    assert repr(t).split("(", 1)[1] == repr(j).split("(", 1)[1]
    if kind == "ContinuousStats":
        for attr in ("occupancy_distribution", "mean_occupancy",
                     "idle_fraction"):
            assert getattr(t, attr) == getattr(j, attr)
        assert t.occupancy_distribution == {1: 1, 2: 1, 3: 1, 4: 3}
        empty = t_stats.ContinuousStats(_capacity=2)
        assert (empty.mean_occupancy, empty.idle_fraction,
                empty.overhead) == (0.0, 0.0, 0.0)
    if kind == "WaveStats":
        assert t.padding_overhead == j.padding_overhead


def test_stats_line_and_prometheus_equal(clocks):
    name = "minitron-4b"
    out = {}
    for side, mod, stats_mod, cfg in (
            ("ref", j_serving, j_stats, j_smoke(name)),
            ("port", t_serving, t_stats, t_smoke(name))):
        obs = mod.ServingObs.create(cfg)
        stats = stats_mod.ContinuousStats(registry=obs.registry,
                                          _capacity=4)
        first = obs.stats_line(stats, step=0)
        _hooks(obs.tracker)
        obs.meter.on_prefill(24)
        for n in (3, 4, 2):
            stats.observe_active(n)
            stats.decode_steps += 1
            obs.meter.on_decode_step(4)
        out[side] = (first, obs.stats_line(stats, step=9),
                     obs.stats_line(), obs.to_prometheus(),
                     obs.registry.snapshot())
    assert out["port"] == out["ref"]
    line = out["port"][1]
    assert line.startswith("[stats] step 9 | reqs 2/3 | ttft p50/p95 ")
    assert "occ 3.0/4" in line and "reuse " in line
    prom = out["port"][3]
    for metric in ("serve_ttft_ms_count", "serve_active_slots_count",
                   'serve_finish_reason{reason="eos"}',
                   "# TYPE serve_requests_arrived counter"):
        assert metric in prom


def test_obs_package_exports():
    for name in ("Tracer", "default_tracer", "enable_tracing",
                 "MetricsRegistry", "CounterGroup", "record_kernel_call"):
        assert hasattr(t_obs, name)
    j_obs = pytest.importorskip("repro.obs")
    assert set(t_obs._LAZY) == set(j_obs._LAZY)
    for name, (mod, attr) in t_obs._LAZY.items():
        assert mod == j_obs._LAZY[name][0].replace("repro.", "repro_torch.")
        assert getattr(t_obs, name).__name__ == attr
    with pytest.raises(AttributeError):
        t_obs.not_a_name
