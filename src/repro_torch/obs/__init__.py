"""repro_torch.obs — dependency-free telemetry subsystem (port of
``repro.obs``).

  * :mod:`repro_torch.obs.metrics` — counters / gauges / mergeable
    streaming-percentile histograms, a :class:`MetricsRegistry` with
    JSON-snapshot + Prometheus-text export, and the global ``enable()``
    switch gating hot-path instrumentation;
  * :mod:`repro_torch.obs.tracing` — span/event tracer with Chrome-trace
    export;
  * :mod:`repro_torch.obs.meter`   — :class:`PhotonicMeter`, the live
    write-vs-reuse energy/latency ledger over ``core/costmodel.py``;
  * :mod:`repro_torch.obs.stats`   — the shared ``WaveStats`` /
    ``ContinuousStats`` protocol, registry-backed;
  * :mod:`repro_torch.obs.serving` — request-lifecycle tracking
    (TTFT/TPOT/e2e) and the :class:`ServingObs` bundle the serving loop
    carries;
  * :mod:`repro_torch.obs.check_schema` — the metrics-schema validator CLI.

Only ``metrics`` and ``tracing`` import eagerly (they are leaves); the
model-aware modules load lazily to keep import edges acyclic.
"""
from repro_torch.obs.metrics import (  # noqa: F401
    Counter, CounterGroup, Gauge, Histogram, MetricsRegistry, counter,
    default_registry, disable, enable, enabled, gauge, histogram,
    record_kernel_call, reset_default_registry,
)
from repro_torch.obs.tracing import (  # noqa: F401
    Tracer, default_tracer, enable_tracing,
)

_LAZY = {
    "PhotonicMeter": ("repro_torch.obs.meter", "PhotonicMeter"),
    "StackProfile": ("repro_torch.obs.meter", "StackProfile"),
    "ServingStats": ("repro_torch.obs.stats", "ServingStats"),
    "WaveStats": ("repro_torch.obs.stats", "WaveStats"),
    "ContinuousStats": ("repro_torch.obs.stats", "ContinuousStats"),
    "RequestTracker": ("repro_torch.obs.serving", "RequestTracker"),
    "ServingObs": ("repro_torch.obs.serving", "ServingObs"),
    "validate_schema": ("repro_torch.obs.check_schema", "validate"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'repro_torch.obs' has no attribute "
                         f"{name!r}")
