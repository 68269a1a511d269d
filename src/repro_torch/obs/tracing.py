"""Span/event tracer with Chrome-trace (``chrome://tracing``) JSON export
(copy of ``repro.obs.tracing``).

The request-lifecycle visualization layer: the serving scheduler emits one
timeline *row per request* (trace ``tid`` = request id) carrying its
``queue -> prefill -> decode`` spans, plus a row 0 for scheduler steps;
load the exported file in ``chrome://tracing`` / Perfetto and the
continuous-batching queue becomes a picture (admission waves, slot churn,
stragglers).

Events follow the Trace Event Format: ``X`` complete spans (``ts`` +
``dur``, microseconds), ``i`` instants, ``C`` counter tracks (the live
slot-occupancy graph), ``M`` metadata (thread names).  The event buffer is
a bounded deque so a long-running server cannot grow without limit; the
tracer is disabled by default and every record call is a one-bool check
when off.

What a span covers on a CUDA device.  Every timestamp is the host's
``time.monotonic()``, and PyTorch returns from a CUDA call as soon as the
work is queued.  No telemetry call synchronizes the device, so a span
measures device work only where the host already waits for it inside the
span:

  * ``decode_step`` (scheduler) closes after the next tokens are read back
    to the host (``.cpu()``), so it covers the step's device time, whether
    the cell replays its CUDA graph or runs eagerly;
  * ``prefill_chunk`` of a chunk that is not a prompt's last has no
    read-back: on the card it measures the host's dispatch of the chunk's
    kernels, and the device work that outruns it lands in the next span
    that waits.  A prompt's last chunk samples its first token
    (``int(...)``) after the span, so its device time falls between spans;
  * ``wave`` (wave batcher) closes after the wave's tokens are read back
    to the host, so it covers the wave's device time;
  * the request rows (``queue``, ``prefill``, ``decode``) are stamped at
    admission, at the first token and at the finish; a token is on the
    host when it is stamped, so TTFT, TPOT and e2e include the device time
    of the steps that made them.
"""
from __future__ import annotations

import collections
import contextlib
import json
import time


class Tracer:
    """Bounded in-memory trace-event buffer."""

    def __init__(self, maxlen: int = 200_000, enabled: bool = True):
        self.events: collections.deque = collections.deque(maxlen=maxlen)
        self.enabled = enabled
        self._t0 = time.monotonic()

    # -------------------------------------------------------------- clock
    def now_us(self) -> float:
        """Microseconds since tracer start (Chrome trace timebase)."""
        return (time.monotonic() - self._t0) * 1e6

    # ------------------------------------------------------------- records
    def complete(self, name: str, ts_us: float, dur_us: float, *,
                 tid: int = 0, **args) -> None:
        """An ``X`` span from explicit timestamps — how the request tracker
        emits lifecycle phases after the fact (arrive/admit/first/finish
        were recorded as the steps happened)."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "X", "pid": 0, "tid": int(tid),
              "ts": ts_us, "dur": max(dur_us, 0.0)}
        if args:
            ev["args"] = args
        self.events.append(ev)

    @contextlib.contextmanager
    def span(self, name: str, *, tid: int = 0, **args):
        """Context-managed ``X`` span around live work."""
        if not self.enabled:
            yield
            return
        t0 = self.now_us()
        try:
            yield
        finally:
            self.complete(name, t0, self.now_us() - t0, tid=tid, **args)

    def instant(self, name: str, *, tid: int = 0, **args) -> None:
        if not self.enabled:
            return
        ev = {"name": name, "ph": "i", "pid": 0, "tid": int(tid),
              "ts": self.now_us(), "s": "t"}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def counter(self, name: str, value: float, *, tid: int = 0) -> None:
        """A ``C`` counter sample — chrome renders these as a filled graph
        (slot occupancy over time)."""
        if not self.enabled:
            return
        self.events.append({"name": name, "ph": "C", "pid": 0,
                            "tid": int(tid), "ts": self.now_us(),
                            "args": {name: value}})

    def thread_name(self, tid: int, name: str) -> None:
        """``M`` metadata naming a timeline row (e.g. ``req 7``)."""
        if not self.enabled:
            return
        self.events.append({"name": "thread_name", "ph": "M", "pid": 0,
                            "tid": int(tid),
                            "args": {"name": name}})

    # -------------------------------------------------------------- export
    def chrome_trace(self) -> dict:
        """The ``chrome://tracing`` JSON object (structurally validated in
        tests/test_obs.py)."""
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)


# A process-wide disabled tracer: instrumentation sites can always call
# through it; ``enable_tracing`` flips it live.
_DEFAULT = Tracer(enabled=False)


def default_tracer() -> Tracer:
    return _DEFAULT


def enable_tracing(on: bool = True) -> Tracer:
    _DEFAULT.enabled = on
    return _DEFAULT
