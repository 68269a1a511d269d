"""Reuse-aware request co-scheduling over resident banks (copy of
``repro.resident.cosched``).

Two layers, both extending (not replacing) the cost-model admission the
continuous scheduler already runs:

* :class:`ResidencyAwareAdmission` — ``ReuseAwareAdmission`` plus a
  residency term: while this Program's banks are resident (hot), queued
  requests are bank-affine — admitting them together streams more rows
  through banks that are already programmed, so the cap on admissions per
  step lifts to the free-slot count.  When the banks are cold the base
  policy stands (its below-``min_population`` batching already rebuilds
  amortization fastest).

* :class:`BankAffineCoScheduler` — groups traffic ACROSS Programs: one
  lane (a ``ContinuousScheduler``) per Program, all lanes sharing one
  :class:`~repro.resident.manager.BankResidencyManager`.  Each ``step``
  drives the lane whose banks are resident (switching lanes is what forces
  evictions + reprograms on a small array), holding a lane at most
  ``max_lane_steps`` consecutive steps so no lane starves.  Lane choice is
  deterministic: (has-work, residency, queue depth, name).

``group_by_affinity`` is the pure batch-mode form of the same idea (used by
``benchmarks/residency_bench.py``): within a bounded look-ahead window,
requests reorder into bank-affinity groups; per-key FIFO order is
preserved, and no request is deferred past ``window`` later arrivals.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Mapping, Optional, Sequence, TypeVar

from repro_torch.serve.batcher import Completion, Request
from repro_torch.serve.scheduler import ReuseAwareAdmission

from repro_torch.resident.manager import ProgramResidency

T = TypeVar("T")


# =========================================================================
# admission
# =========================================================================
@dataclasses.dataclass(frozen=True)
class ResidencyAwareAdmission(ReuseAwareAdmission):
    """Cost-model admission with a residency term (see module docstring)."""

    residency: Optional[ProgramResidency] = None

    @classmethod
    def from_base(cls, base: ReuseAwareAdmission,
                  residency: ProgramResidency) -> "ResidencyAwareAdmission":
        return cls(min_population=base.min_population,
                   max_admit_per_step=base.max_admit_per_step,
                   residency=residency)

    def admit_count(self, *, queued: int, free: int, active: int) -> int:
        base = super().admit_count(queued=queued, free=free, active=active)
        if self.residency is None or queued == 0 or free == 0:
            return base
        if self.residency.all_resident():
            # hot banks: the queued requests are bank-affine with the
            # in-flight population — admit the whole group now, every
            # admitted row is a free (already-programmed) pass
            return min(queued, free)
        return base


# =========================================================================
# bounded bank-affinity grouping (pure; shared with the bench)
# =========================================================================
def group_by_affinity(items: Sequence[T], key_fn: Callable[[T], str],
                      window: int = 16) -> list[T]:
    """Reorder ``items`` into bank-affinity runs under a bounded window.

    Consecutive windows of ``window`` items are each stably regrouped by
    ``key_fn`` (groups ordered by first arrival within the window), so
    items sharing banks serve back-to-back — fewer bank switches — while
    per-key FIFO order is globally preserved and nothing is deferred past
    ``window`` later arrivals."""
    if window <= 1:
        return list(items)
    out: list[T] = []
    for start in range(0, len(items), window):
        chunk = items[start:start + window]
        order: list[str] = []
        groups: dict[str, list[T]] = {}
        for it in chunk:
            k = key_fn(it)
            if k not in groups:
                groups[k] = []
                order.append(k)
            groups[k].append(it)
        for k in order:
            out.extend(groups[k])
    return out


# =========================================================================
# cross-Program co-scheduler
# =========================================================================
class BankAffineCoScheduler:
    """Serve several Programs from one MRR array, residency-aware.

    ``lanes`` maps a lane name to a ``ContinuousScheduler`` built with a
    ``ProgramResidency`` over the SHARED manager (each lane's residency
    does its own accounting; this front-end only decides which lane's
    banks get the array next).  Implements the same ``submit``/``drain``
    surface as the schedulers, with ``submit`` taking the lane name.
    """

    def __init__(self, lanes: Mapping[str, object],
                 residencies: Mapping[str, ProgramResidency], *,
                 max_lane_steps: int = 32):
        if set(lanes) != set(residencies):
            raise ValueError("lanes and residencies must cover the same "
                             "names")
        if not lanes:
            raise ValueError("need at least one lane")
        self.lanes = dict(lanes)
        self.residencies = dict(residencies)
        self.max_lane_steps = max(1, max_lane_steps)
        self._current: Optional[str] = None
        self._run = 0                 # consecutive steps on _current
        self.lane_switches = 0

    # ------------------------------------------------------------ interface
    def submit(self, lane: str, req: Request) -> None:
        self.lanes[lane].submit(req)

    def _has_work(self, name: str) -> bool:
        s = self.lanes[name]
        return bool(s.queue) or s.pool.num_active > 0

    def _pick_lane(self) -> Optional[str]:
        live = [n for n in sorted(self.lanes) if self._has_work(n)]
        if not live:
            return None
        # stickiness: keep draining the current lane while it has work and
        # hasn't exhausted its turn — every extra step is a resident hit
        if (self._current in live and self._run < self.max_lane_steps):
            return self._current
        # otherwise the hottest lane: resident banks first, then the
        # deepest backlog, name as the final deterministic tie-break
        def score(name: str):
            sched = self.lanes[name]
            backlog = len(sched.queue) + sched.pool.num_active
            return (0 if self.residencies[name].all_resident() else 1,
                    -backlog, name)
        return min(live, key=score)

    def step(self) -> list[Completion]:
        name = self._pick_lane()
        if name is None:
            return []
        if name != self._current:
            if self._current is not None:
                self.lane_switches += 1
            self._current, self._run = name, 0
        self._run += 1
        return self.lanes[name].step()

    def drain(self) -> list[Completion]:
        done: list[Completion] = []
        while any(self._has_work(n) for n in self.lanes):
            done.extend(self.step())
        return done


def interleave_fifo(traces: Mapping[str, Iterable[Request]]
                    ) -> list[tuple[str, Request]]:
    """Merge per-lane request lists round-robin (arrival order for the
    bench's FIFO baselines): one from each lane in name order, repeating."""
    iters = {n: list(t) for n, t in sorted(traces.items())}
    out: list[tuple[str, Request]] = []
    i = 0
    while any(i < len(t) for t in iters.values()):
        for n in sorted(iters):
            if i < len(iters[n]):
                out.append((n, iters[n][i]))
        i += 1
    return out
