"""Dependency-free metrics primitives — counters, gauges, histograms
(copy of ``repro.obs.metrics``).

The measurement substrate for the paper's economics (DESIGN.md
§Observability): every runtime number the repo reports — TTFT/TPOT
percentiles, slot occupancy, kernel-call counts per tile plan, simulated
MRR write energy — flows through a :class:`MetricsRegistry` so live
serving, the benchmarks, and the dry-run all emit ONE schema
(`benchmarks/metrics_schema.json`).

Three metric kinds:

  * :class:`Counter`   — monotone float accumulator (``inc``);
  * :class:`Gauge`     — last-write-wins level (``set``);
  * :class:`Histogram` — streaming distribution over sparse *exponential*
    buckets.  A value lands in bucket ``floor(log(v / lo) / log(growth))``,
    so the quantile estimate carries a bounded RELATIVE error (< growth - 1)
    at O(1) memory per decade, and two histograms merge by adding bucket
    counts — exactly associative, which is what lets per-shard / per-run
    histograms combine without a reservoir's order sensitivity
    (tests/test_obs.py proves both properties against numpy).

Metrics are named ``dotted.path`` plus optional ``{label="value"}`` pairs
(Prometheus convention) — e.g. the per-tile-plan kernel-call counter the
backend dispatch records is ``kernel.calls{kind="fused",plan="8x512x512"}``.

A module-level *default registry* backs the convenience functions
(``counter()``/``gauge()``/``histogram()``) and the global ``enable()``
switch that gates the optional per-step instrumentation on the serving hot
path (the <= 5% overhead budget measured in ``backend_bench --smoke``);
plain stats counters stay on regardless — they are the
``WaveStats``/``ContinuousStats`` substrate.
"""
from __future__ import annotations

import json
import math
import threading


# =========================================================================
# global enable switch (hot-path instrumentation only)
# =========================================================================
_ENABLED = False


def enable(on: bool = True) -> None:
    """Turn the *optional* per-step instrumentation on (Program step
    counters, tracer spans).  Registry-backed stats counters are always
    live — this switch only gates the hot-path extras."""
    global _ENABLED
    _ENABLED = bool(on)


def disable() -> None:
    enable(False)


def enabled() -> bool:
    return _ENABLED


# =========================================================================
# metric kinds
# =========================================================================
class Counter:
    """Monotone accumulator.  ``set`` exists so legacy ``stats.field = v``
    assignment (the pre-registry dataclasses) keeps working."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def set(self, v: float) -> None:
        self.value = v


class Gauge:
    """Last-write-wins level (slot occupancy, bank bytes, dropped rules)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Histogram:
    """Streaming distribution over sparse exponential buckets.

    ``lo`` anchors the grid (values at or below it share bucket index 0 —
    sub-nanosecond latencies and zero all collapse there); ``growth`` is
    the per-bucket ratio and therefore the relative quantile error bound.
    ``count``/``total``/``min``/``max`` are tracked exactly; quantiles
    interpolate inside the winning bucket, clamped to the exact [min, max]
    envelope so single-value histograms report that value exactly.
    """

    __slots__ = ("lo", "growth", "_log_g", "buckets", "count", "total",
                 "min", "max")

    def __init__(self, lo: float = 1e-9, growth: float = 1.05):
        if not (growth > 1.0):
            raise ValueError(f"growth must be > 1, got {growth}")
        self.lo = float(lo)
        self.growth = float(growth)
        self._log_g = math.log(growth)
        self.buckets: dict[int, int] = {}
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    # ------------------------------------------------------------ recording
    def _index(self, v: float) -> int:
        if v <= self.lo:
            return 0
        return 1 + int(math.floor(math.log(v / self.lo) / self._log_g))

    def record(self, v: float, n: int = 1) -> None:
        v = float(v)
        if v < 0.0:
            raise ValueError(f"histogram values must be >= 0, got {v}")
        i = self._index(v)
        self.buckets[i] = self.buckets.get(i, 0) + n
        self.count += n
        self.total += v * n
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    # ------------------------------------------------------------ quantiles
    def _bucket_value(self, i: int) -> float:
        """Geometric midpoint of bucket ``i`` (bucket 0 is the <= lo sink)."""
        if i == 0:
            return self.lo
        return self.lo * self.growth ** (i - 0.5)

    def quantile(self, q: float) -> float:
        """q in [0, 1].  Empty histogram -> nan."""
        if self.count == 0:
            return math.nan
        rank = q * (self.count - 1)
        seen = 0
        for i in sorted(self.buckets):
            seen += self.buckets[i]
            if seen - 1 >= rank:
                v = self._bucket_value(i)
                return min(max(v, self.min), self.max)
        return self.max

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else math.nan

    # -------------------------------------------------------------- merging
    def merge(self, other: "Histogram") -> "Histogram":
        """Bucket-count addition — exactly associative (same grid only)."""
        if (self.lo, self.growth) != (other.lo, other.growth):
            raise ValueError("cannot merge histograms on different grids")
        out = Histogram(self.lo, self.growth)
        out.buckets = dict(self.buckets)
        for i, n in other.buckets.items():
            out.buckets[i] = out.buckets.get(i, 0) + n
        out.count = self.count + other.count
        out.total = self.total + other.total
        out.min = min(self.min, other.min)
        out.max = max(self.max, other.max)
        return out

    # -------------------------------------------------------------- summary
    def summary(self) -> dict:
        """The schema'd digest every exporter emits (finite even when
        empty, so JSON stays valid)."""
        empty = self.count == 0
        return {
            "count": self.count,
            "sum": 0.0 if empty else self.total,
            "min": 0.0 if empty else self.min,
            "max": 0.0 if empty else self.max,
            "mean": 0.0 if empty else self.mean,
            "p50": 0.0 if empty else self.quantile(0.50),
            "p95": 0.0 if empty else self.quantile(0.95),
            "p99": 0.0 if empty else self.quantile(0.99),
        }


# =========================================================================
# registry
# =========================================================================
def _key(name: str, labels: dict) -> str:
    """Canonical metric key: ``name{k="v",...}`` with sorted labels."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Name -> metric map with JSON-snapshot and Prometheus-text export.

    Thread-safe creation (the serving loop and a stats printer may race);
    the metrics themselves are plain Python float updates — atomic enough
    under the GIL for the single-writer serving loop.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    # ------------------------------------------------------------- creation
    def counter(self, name: str, **labels) -> Counter:
        k = _key(name, labels)
        c = self._counters.get(k)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(k, Counter())
        return c

    def gauge(self, name: str, **labels) -> Gauge:
        k = _key(name, labels)
        g = self._gauges.get(k)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(k, Gauge())
        return g

    def histogram(self, name: str, lo: float = 1e-9, growth: float = 1.05,
                  **labels) -> Histogram:
        k = _key(name, labels)
        h = self._histograms.get(k)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(k, Histogram(lo, growth))
        return h

    # -------------------------------------------------------------- exports
    def snapshot(self) -> dict:
        """The JSON metrics block — same shape everywhere (live serving,
        serve_bench, backend_bench, dryrun), validated against
        ``benchmarks/metrics_schema.json``.

        Histograms that never recorded a sample (count 0) are OMITTED —
        a registered-but-unused latency meter is declaration noise, and
        its zero-filled quantiles read as a measured 0 in trend tooling.
        The schema treats absent-but-empty as valid."""
        return {
            "counters": {k: c.value
                         for k, c in sorted(self._counters.items())},
            "gauges": {k: g.value for k, g in sorted(self._gauges.items())},
            "histograms": {k: h.summary()
                           for k, h in sorted(self._histograms.items())
                           if h.count > 0},
        }

    def to_prometheus(self) -> str:
        """Prometheus text exposition (metric names: dots -> underscores;
        histograms as <name>_{count,sum} + quantile gauges)."""
        lines = []

        def _pn(key: str) -> str:
            name, brace, labels = key.partition("{")
            return name.replace(".", "_") + brace + labels

        for k, c in sorted(self._counters.items()):
            base = _pn(k).partition("{")[0]
            lines.append(f"# TYPE {base} counter")
            lines.append(f"{_pn(k)} {c.value:g}")
        for k, g in sorted(self._gauges.items()):
            base = _pn(k).partition("{")[0]
            lines.append(f"# TYPE {base} gauge")
            lines.append(f"{_pn(k)} {g.value:g}")
        for k, h in sorted(self._histograms.items()):
            s = h.summary()
            name, _, labels = _pn(k).partition("{")
            labels = labels[:-1] if labels else ""
            lines.append(f"# TYPE {name} summary")
            for q in ("p50", "p95", "p99"):
                lab = (f'{labels},quantile="0.{q[1:]}"' if labels
                       else f'quantile="0.{q[1:]}"')
                lines.append(f"{name}{{{lab}}} {s[q]:g}")
            suffix = f"{{{labels}}}" if labels else ""
            lines.append(f"{name}_sum{suffix} {s['sum']:g}")
            lines.append(f"{name}_count{suffix} {s['count']:g}")
        return "\n".join(lines) + "\n"

    def dump_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)


# =========================================================================
# default registry + convenience surface
# =========================================================================
_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _DEFAULT


def reset_default_registry() -> MetricsRegistry:
    """Fresh default registry (tests / bench isolation)."""
    global _DEFAULT
    _DEFAULT = MetricsRegistry()
    return _DEFAULT


def counter(name: str, **labels) -> Counter:
    return _DEFAULT.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return _DEFAULT.gauge(name, **labels)


def histogram(name: str, **labels) -> Histogram:
    return _DEFAULT.histogram(name, **labels)


def record_kernel_call(kind: str, bm: int, bk: int, bn: int) -> None:
    """Per-plan kernel-call counter, recorded at TRACE time by the backend
    dispatch (``core/backend.py``): each compiled cell's Pallas calls are
    counted once per (re)trace, keyed by the resolved tile plan — the
    compile-side ledger of which megakernel variants exist at which tile
    geometries."""
    _DEFAULT.counter("kernel.calls", kind=kind, plan=f"{bm}x{bk}x{bn}").inc()


class CounterGroup(dict):
    """A ``collections.Counter``-alike whose writes mirror into the default
    registry under ``<prefix>.<key>`` — how ``api.TRACE_COUNTS`` is promoted
    into the metrics registry while keeping its dict/Counter surface
    (``TRACE_COUNTS["prefill"] += 1``, ``dict(TRACE_COUNTS)``)."""

    def __init__(self, prefix: str):
        super().__init__()
        self._prefix = prefix

    def __missing__(self, key):
        return 0

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        _DEFAULT.counter(f"{self._prefix}.{key}").set(float(value))
