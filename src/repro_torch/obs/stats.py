"""Serving stats over the metrics registry (port of ``repro.obs.stats``).

Both schedulers' stats derive from :class:`ServingStats`: every field is a
property backed by a counter ``serve.<field>`` in a
:class:`~repro_torch.obs.metrics.MetricsRegistry`, so ``stats.requests +=
1`` updates the registry and a registry snapshot carries the same numbers.

``WaveStats`` is the reference's, field for field.  ``ContinuousStats``
keeps the port scheduler's counters (requests, generated tokens, prefill
chunks, decode steps); the reference's prompt, padding and idle-lane
counters, its slot-step totals and the occupancy histogram come with the
scheduler's telemetry (a later slice), so it has no ``overhead`` yet.
"""
from __future__ import annotations

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
    """Work counters of one continuous scheduler."""

    FIELDS = ("requests", "generated_tokens", "prefill_chunks",
              "decode_steps")

    @property
    def overhead(self) -> float:
        raise NotImplementedError(
            "the port's ContinuousStats counts no slot steps yet (the "
            "scheduler's telemetry is a later slice)")

    def as_dict(self) -> dict:
        return {f: getattr(self, f) for f in self.FIELDS}


for _f in ("prefill_chunks", "decode_steps"):
    setattr(ContinuousStats, _f, _counter_property(_f))
del _f
