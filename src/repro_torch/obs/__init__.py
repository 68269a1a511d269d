"""repro_torch.obs — the dependency-free metrics registry and the
PhotonicMeter write-vs-reuse ledger (copies of ``repro.obs.metrics`` and
``repro.obs.meter``).  Tracing, serving telemetry and the schema checker
belong to a later slice."""
from repro_torch.obs.metrics import (  # noqa: F401
    Counter, CounterGroup, Gauge, Histogram, MetricsRegistry, counter,
    default_registry, disable, enable, enabled, gauge, histogram,
    record_kernel_call, reset_default_registry,
)
from repro_torch.obs.meter import PhotonicMeter, StackProfile  # noqa: F401
