"""Request-lifecycle tracking + the serving telemetry bundle (port of
``repro.obs.serving``).

:class:`RequestTracker` follows every request through
``arrive -> admit -> prefill -> first token -> decode -> finish`` and turns
the timestamps into the serving latency metrics:

  * ``serve.ttft_ms``  — time to first token (arrive -> first sampled
    token, queueing included: the number a user feels);
  * ``serve.tpot_ms``  — per-token inter-arrival during decode;
  * ``serve.e2e_ms``   — arrive -> finish;
  * ``serve.queue_ms`` — arrive -> admission (backpressure visibility);

all as streaming histograms (p50/p95/p99), plus Chrome-trace spans — one
timeline row per request (``tid`` = rid) — so ``chrome://tracing`` renders
the whole continuous-batching queue.

:class:`ServingObs` bundles what a serving loop needs: one registry, one
tracer, one tracker, one :class:`~repro.obs.meter.PhotonicMeter` — and
formats the periodic stats line ``launch/serve.py --stats`` prints and the
schema'd snapshot every exporter emits.

The timestamps are the host's (``time.monotonic()``); the serving loop
reads every token back to the host before it stamps it, so the latencies
include the device time of the steps that made them, and telemetry adds
no device synchronization of its own (``obs/tracing.py`` says what each
span covers on the card).
"""
from __future__ import annotations

import dataclasses
import time

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import tracing as _tracing
from repro_torch.obs.meter import PhotonicMeter, StackProfile


@dataclasses.dataclass
class _ReqTimes:
    arrive: float
    admit: float = 0.0
    first: float = 0.0
    last: float = 0.0
    tokens: int = 0
    prompt_len: int = 0
    padded_to: int = 0


class RequestTracker:
    """Lifecycle timestamps -> latency histograms + per-request spans."""

    def __init__(self, registry: _metrics.MetricsRegistry,
                 tracer: _tracing.Tracer | None = None):
        self.registry = registry
        self.tracer = tracer or _tracing.Tracer(enabled=False)
        # millisecond-scale latencies on a 5%-relative grid
        self.ttft = registry.histogram("serve.ttft_ms", lo=1e-3)
        self.tpot = registry.histogram("serve.tpot_ms", lo=1e-3)
        self.e2e = registry.histogram("serve.e2e_ms", lo=1e-3)
        self.queue = registry.histogram("serve.queue_ms", lo=1e-3)
        self._live: dict[int, _ReqTimes] = {}
        self._t0 = time.monotonic()

    # -------------------------------------------------------------- clock
    def _now(self) -> float:
        return time.monotonic()

    def _us(self, t: float) -> float:
        """Monotonic seconds -> tracer microseconds (shared timebase)."""
        return (t - self.tracer._t0) * 1e6

    # -------------------------------------------------------------- hooks
    def on_submit(self, rid: int) -> None:
        self._live[rid] = _ReqTimes(arrive=self._now())
        self.registry.counter("serve.requests.arrived").inc()

    def on_admit(self, rid: int, prompt_len: int, padded_to: int) -> None:
        st = self._live.get(rid)
        if st is None:
            return
        st.admit = self._now()
        st.prompt_len, st.padded_to = prompt_len, padded_to
        self.queue.record((st.admit - st.arrive) * 1e3)

    def on_first_token(self, rid: int) -> None:
        st = self._live.get(rid)
        if st is None:
            return
        st.first = st.last = self._now()
        self.ttft.record((st.first - st.arrive) * 1e3)

    def on_token(self, rid: int) -> None:
        st = self._live.get(rid)
        if st is None:
            return
        now = self._now()
        if st.tokens > 0 or st.first:       # inter-token gap only
            self.tpot.record((now - st.last) * 1e3)
        st.last = now
        st.tokens += 1

    def on_finish(self, rid: int, reason: str = "length") -> None:
        st = self._live.pop(rid, None)
        if st is None:
            return
        now = self._now()
        self.e2e.record((now - st.arrive) * 1e3)
        self.registry.counter("serve.requests.completed").inc()
        self.registry.counter("serve.finish_reason", reason=reason).inc()
        tr = self.tracer
        if tr.enabled:
            tr.thread_name(rid, f"req {rid}")
            admit = st.admit or now
            first = st.first or now
            tr.complete("queue", self._us(st.arrive),
                        (admit - st.arrive) * 1e6, tid=rid)
            tr.complete("prefill", self._us(admit), (first - admit) * 1e6,
                        tid=rid, prompt_len=st.prompt_len,
                        padded_to=st.padded_to)
            tr.complete("decode", self._us(first), (now - first) * 1e6,
                        tid=rid, tokens=st.tokens)
            tr.instant("finish", tid=rid, reason=reason)

    # ------------------------------------------------------------- summary
    def percentiles(self) -> dict:
        return {name: h.summary() for name, h in
                (("ttft_ms", self.ttft), ("tpot_ms", self.tpot),
                 ("e2e_ms", self.e2e), ("queue_ms", self.queue))}


class ServingObs:
    """One registry + tracer + tracker + meter, wired together.

    Pass to ``ContinuousScheduler(telemetry=...)`` (and the serve/bench
    drivers).  ``create(cfg)`` derives the meter's stack profile from the
    arch so the energy report prices the model actually being served.
    """

    def __init__(self, registry: _metrics.MetricsRegistry,
                 tracer: _tracing.Tracer, tracker: RequestTracker,
                 meter: PhotonicMeter | None):
        self.registry = registry
        self.tracer = tracer
        self.tracker = tracker
        self.meter = meter

    @classmethod
    def create(cls, cfg=None, *, tile: int = 256, refresh_steps: int = 8,
               trace: bool = True,
               registry: _metrics.MetricsRegistry | None = None
               ) -> "ServingObs":
        registry = registry or _metrics.MetricsRegistry()
        tracer = _tracing.Tracer(enabled=trace)
        tracker = RequestTracker(registry, tracer)
        meter = None
        if cfg is not None:
            meter = PhotonicMeter(StackProfile.from_cfg(cfg, tile=tile),
                                  refresh_steps=refresh_steps,
                                  registry=registry)
        return cls(registry, tracer, tracker, meter)

    # ------------------------------------------------------------ exports
    def snapshot(self) -> dict:
        """The shared metrics JSON (schema: ``obs/metrics_schema.json``, a
        copy of the reference's): registry counters/gauges/histograms + the
        meter's energy block.

        Folded in from the process when the snapshot is taken: the
        default registry's ``program.*`` keys (builds, bank gauges, step
        counters); the decode-graph captures (``graphs.CAPTURE_COUNTS``)
        as ``compile.capture.<kind>``, the counterpart of the reference's
        ``compile.trace.*`` retrace counters; and the kernel wrappers'
        launch counters (``kernels/counts.py``) as
        ``kernel.launches{kernel=<name>}``, which take the place of the
        reference's per-plan ``kernel.calls{kind, plan}`` (XLA records
        those at trace time; they have no meaning under eager dispatch)."""
        from repro_torch import graphs
        from repro_torch.kernels import counts
        snap = self.registry.snapshot()
        snap["schema_version"] = 1
        snap["energy"] = (self.meter.report() if self.meter is not None
                          else PhotonicMeter(
                              StackProfile(1, 1, 1, 1, 1, 256)).report())
        dflt = _metrics.default_registry()
        if dflt is not self.registry:
            d = dflt.snapshot()
            for kind in ("counters", "gauges"):
                for k, v in d[kind].items():
                    if k.startswith("program."):
                        snap[kind].setdefault(k, v)
        for k in sorted({"decode", *graphs.CAPTURE_COUNTS}):
            snap["counters"].setdefault(f"compile.capture.{k}",
                                        float(graphs.CAPTURE_COUNTS[k]))
        for name, n in counts.snapshot().items():
            snap["counters"].setdefault(
                _metrics._key("kernel.launches", {"kernel": name}),
                float(n))
        return snap

    def to_prometheus(self) -> str:
        if self.meter is not None:
            self.meter.report()          # refresh the energy.* gauges
        return self.registry.to_prometheus()

    def stats_line(self, stats=None, step: int | None = None) -> str:
        """The periodic serving line: TTFT/TPOT p50/p95, slot occupancy,
        reuse ratio, cumulative simulated write energy saved."""
        t = self.tracker
        ttft, tpot = t.ttft, t.tpot
        parts = []
        if step is not None:
            parts.append(f"step {step}")
        done = int(t.registry.counter("serve.requests.completed").value)
        arrived = int(t.registry.counter("serve.requests.arrived").value)
        parts.append(f"reqs {done}/{arrived}")
        parts.append(f"ttft p50/p95 {ttft.quantile(.5):.1f}/"
                     f"{ttft.quantile(.95):.1f}ms" if ttft.count
                     else "ttft -")
        parts.append(f"tpot p50/p95 {tpot.quantile(.5):.1f}/"
                     f"{tpot.quantile(.95):.1f}ms" if tpot.count
                     else "tpot -")
        if stats is not None and getattr(stats, "decode_steps", 0):
            parts.append(f"occ {stats.mean_occupancy:.1f}"
                         f"/{stats._capacity}")
        if self.meter is not None:
            rep = self.meter.report()
            parts.append(f"reuse {rep['reuse_ratio']:.3f}")
            parts.append(f"writeE saved "
                         f"{rep['write_energy_saved_uJ']:.1f}uJ "
                         f"(E -{rep['energy_savings_frac']:.1%} "
                         f"T -{rep['latency_savings_frac']:.1%})")
            if self.meter.resident_hits + self.meter.resident_misses:
                parts.append(f"res hit {rep['resident_hit_rate']:.3f} "
                             f"ev {rep['evictions']}")
        return "[stats] " + " | ".join(parts)
