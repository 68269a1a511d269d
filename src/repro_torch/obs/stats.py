"""Serving stats over the metrics registry (port of ``repro.obs.stats``).

Both schedulers' stats derive from :class:`ServingStats`: every field is a
property backed by a counter ``serve.<field>`` in a
:class:`~repro_torch.obs.metrics.MetricsRegistry`, so ``stats.requests +=
1`` updates the registry and a registry snapshot carries the same numbers,
and the shared waste metric, ``overhead``, lives once, on the base class.

``ContinuousStats`` also records the per-step *active-slot histogram*
(``observe_active``): the occupancy distribution over time, not only the
aggregate idle counter.  Both classes are the reference's, field for
field.
"""
from __future__ import annotations

import collections

from repro_torch.obs import metrics as _metrics


def _counter_property(field: str, doc: str = ""):
    name = f"serve.{field}"

    def fget(self):
        return self._int(self.registry.counter(name).value)

    def fset(self, v):
        self.registry.counter(name).set(float(v))

    return property(fget, fset, doc=doc)


class ServingStats:
    """Registry-backed counters and the shared waste metric.

    ``slot_steps`` counts executed slot-token-steps (padding and idle lanes
    included); ``useful_steps`` the processed positions that served a
    request.  ``overhead``, the wasted fraction, is the metric the
    schedulers compare on."""

    FIELDS: tuple = ("requests", "prompt_tokens", "generated_tokens",
                     "slot_steps", "useful_steps")

    def __init__(self, registry: _metrics.MetricsRegistry | None = None):
        self.registry = registry or _metrics.MetricsRegistry()

    @staticmethod
    def _int(v: float):
        i = int(v)
        return i if i == v else v

    @property
    def overhead(self) -> float:
        """Wasted fraction of executed slot-token-steps."""
        return (1.0 - self.useful_steps / self.slot_steps
                if self.slot_steps else 0.0)

    def as_dict(self) -> dict:
        d = {f: getattr(self, f) for f in self.FIELDS}
        d["overhead"] = self.overhead
        return d

    def __repr__(self):
        inner = ", ".join(f"{k}={v}" for k, v in self.as_dict().items())
        return f"{type(self).__name__}({inner})"


for _f in ServingStats.FIELDS:
    setattr(ServingStats, _f, _counter_property(_f))


class WaveStats(ServingStats):
    """Static wave scheduler: padding and lockstep-decode waste."""

    FIELDS = ServingStats.FIELDS + ("waves", "padded_tokens")

    @property
    def padding_overhead(self) -> float:
        total = self.prompt_tokens + self.padded_tokens
        return self.padded_tokens / total if total else 0.0


for _f in ("waves", "padded_tokens"):
    setattr(WaveStats, _f, _counter_property(_f))


class ContinuousStats(ServingStats):
    """Continuous batching: bucket padding and idle decode lanes, plus the
    per-step active-slot occupancy distribution."""

    FIELDS = ServingStats.FIELDS + ("prefills", "decode_steps",
                                    "padded_prefill_tokens",
                                    "idle_slot_steps", "prefill_chunks")

    def __init__(self, registry: _metrics.MetricsRegistry | None = None,
                 _capacity: int = 1):
        super().__init__(registry)
        self._capacity = _capacity
        # the exact integer distribution, and a registry histogram so the
        # percentile export shares one schema with the latencies
        self.occupancy: collections.Counter = collections.Counter()
        self._occ_hist = self.registry.histogram("serve.active_slots",
                                                 lo=0.5, growth=1.05)

    def observe_active(self, n: int) -> None:
        """Record one decode step's active-slot count."""
        self.occupancy[int(n)] += 1
        self._occ_hist.record(n)
        self.registry.gauge("serve.slots.active").set(n)

    @property
    def occupancy_distribution(self) -> dict:
        """{active_slots: steps} over all decode steps, exact."""
        return dict(sorted(self.occupancy.items()))

    @property
    def mean_occupancy(self) -> float:
        steps = sum(self.occupancy.values())
        if not steps:
            return 0.0
        return sum(k * v for k, v in self.occupancy.items()) / steps

    @property
    def idle_fraction(self) -> float:
        if not self.decode_steps:
            return 0.0
        return self.idle_slot_steps / (self.decode_steps * self._capacity)


for _f in ("prefills", "decode_steps", "padded_prefill_tokens",
           "idle_slot_steps", "prefill_chunks"):
    setattr(ContinuousStats, _f, _counter_property(_f))
del _f
