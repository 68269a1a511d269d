"""PhotonicMeter — the paper's energy/latency economics, measured at runtime
(copy of ``repro.obs.meter``).

``core/costmodel.py`` prices writes and passes statically; this meter turns
those prices into a *live* ledger by watching the serving loop: every
simulated MRR bank write (programming a basic block's matrices) and every
reuse hit (a matrix pass served by an already-resident bank) is accounted
against the calibrated Table-3 model, and the report comes out in the
paper's own units —

  * ``reuse_ratio``          — matrix passes served WITHOUT a fresh
    programming / all matrix passes (R&B's write amortization, live);
  * ``energy_savings_frac``  — 1 - E_rb / E_baseline where the baseline
    reprograms every logical matrix per pass (paper headline: 69%);
  * ``latency_savings_frac`` — same ratio on the delay ledger (57%);
  * ``write_energy_saved_uJ`` — the cumulative write energy the resident
    banks avoided, the number ``launch/serve.py --stats`` prints per line.

The accounting model mirrors ``ReuseAwareAdmission``: the R physical basic
blocks (each ``mats_per_block`` matrices of ~(d, d)) are programmed once at
serving start and re-programmed every ``refresh_steps`` decode steps
(thermal-drift recalibration, paper §4.2.3), while every executed row of
every step streams through the stack's ``depth x mats`` logical matrices.
The no-reuse baseline programs each logical matrix per pass (programs ==
passes — exactly ``costmodel.baseline_stack_cost``'s schedule), so the
savings fractions are a true reuse-on vs reuse-off comparison over the SAME
served trace (tests/test_obs.py checks the ledger against a hand-computed
``costmodel`` trace).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import costmodel
from repro_torch.core.prm import ReusePlan
from repro_torch.obs import metrics as _metrics


@dataclasses.dataclass(frozen=True)
class StackProfile:
    """Static per-arch quantities the meter prices against: R physical
    blocks, logical depth, matrices per block, and the representative
    (rows, cols) crossbar shape."""

    num_physical: int            # R — basic blocks actually programmed
    depth: int                   # logical layers (passes per token)
    mats_per_block: int          # weight matrices per basic block
    rows: int
    cols: int
    tile: int

    @classmethod
    def from_cfg(cls, cfg, *, tile: int = 256,
                 mats_per_block: int = 6) -> "StackProfile":
        """Same derivation as ``ReuseAwareAdmission.build`` — decoder
        segments only, PRM plan per segment."""
        from repro_torch.models import transformer as tfm
        R, depth = 0, 0
        for spec in tfm.build_segments(cfg):
            if spec.stream == "encoder":
                continue
            plan = ReusePlan.build(spec.num_groups, spec.reuse)
            R += plan.num_physical
            depth += spec.depth
        d = cfg.d_model
        return cls(num_physical=max(1, R), depth=max(1, depth),
                   mats_per_block=mats_per_block, rows=d, cols=d, tile=tile)

    @property
    def cycles_per_matrix(self) -> float:
        """Bank cycles of one representative matrix — the Table-3 pricing
        unit, via the one shared ``costmodel.bank_cycles`` helper."""
        return costmodel.bank_cycles((self.rows, self.cols), self.tile)


class PhotonicMeter:
    """Write-vs-reuse energy/latency ledger over the calibrated cost model.

    Hook points (called by the continuous scheduler / benches):

      * :meth:`on_prefill`       — ``tokens`` rows ran through the stack;
      * :meth:`on_decode_step`   — one decode step executed ``rows`` lanes
        (the full slot capacity — idle lanes burn optical passes too);
        bank (re)programming is accounted here, once at first use and then
        every ``refresh_steps`` decode steps;
      * :meth:`record_bank_write` / :meth:`record_passes` — the raw ledger,
        for callers with their own schedule.

    All accumulators also mirror into ``registry`` gauges/counters under
    ``energy.*`` so the meter's report and the metrics snapshot agree.
    """

    def __init__(self, profile: StackProfile, *, refresh_steps: int = 8,
                 registry: _metrics.MetricsRegistry | None = None,
                 model: costmodel.CalibratedCost = costmodel.CALIBRATED,
                 external_writes: bool = False):
        self.profile = profile
        self.refresh_steps = max(1, refresh_steps)
        self.registry = registry or _metrics.MetricsRegistry()
        self.model = model
        p = profile
        # per-matrix unit prices (ns, uJ) — priced once, applied per event,
        # with the affine negative-intercept clamp centralized in
        # costmodel.unit_prices (only active for sub-calibration toy sizes).
        self._wd, self._we, self._cd, self._ce = costmodel.unit_prices(
            p.rows, p.cols, p.tile, model)
        self.bank_writes = 0          # matrices programmed (R&B schedule)
        self.matrix_passes = 0        # logical matrix MVM passes executed
        self.baseline_writes = 0      # programs the no-reuse baseline pays
        self.decode_steps = 0
        # residency-manager feed: hits/misses on the bank cache, evictions,
        # and writes sourced outside the meter's own schedule
        self.resident_hits = 0
        self.resident_misses = 0
        self.evictions = 0
        self.external_bank_writes = 0
        self.calibration_writes = 0   # drift-repair reprograms (a subset of
                                      # external_bank_writes — never billed
                                      # a second time)
        self._steps_since_refresh = 0
        self._programmed = False
        # with external_writes=True the meter's OWN programming schedule
        # (program-at-first-traffic + per-refresh_steps reprogram) is off:
        # a residency manager owns the write schedule and feeds it through
        # record_external_bank_write, so resident hits are never
        # double-billed as refresh writes.
        self.external_writes = bool(external_writes)

    def set_external_writes(self, on: bool = True) -> None:
        """Hand the write schedule to an external source (the residency
        manager).  Must flip before first traffic to keep the ledger
        consistent."""
        self.external_writes = bool(on)

    # ------------------------------------------------------------ raw ledger
    def record_bank_write(self, n: int = 1) -> None:
        self.bank_writes += n
        self.registry.counter("energy.bank_writes").inc(n)

    def record_passes(self, n: int = 1) -> None:
        self.matrix_passes += n
        self.baseline_writes += n       # baseline reprograms per pass
        self.registry.counter("energy.matrix_passes").inc(n)

    # ------------------------------------------------- residency-manager feed
    def record_external_bank_write(self, n: int = 1) -> None:
        """A bank (re)programming decided OUTSIDE the meter's schedule —
        a residency-manager install or post-eviction reprogram.  Priced
        exactly like any other write so ``write_energy_saved_uJ`` and
        ``reuse_ratio`` stay honest when residency is on."""
        self.external_bank_writes += n
        self.registry.counter("energy.external_bank_writes").inc(n)
        self.record_bank_write(n)

    def record_calibration_write(self, n: int = 1) -> None:
        """A calibration-loop drift repair: re-programming a stale resident
        bank in place (``serve/calibration.py``).  Tagged separately so the
        report can say how much of the write budget maintenance costs, but
        PRICED through the one external-write chain — each matrix lands in
        ``bank_writes`` exactly once (the no-double-billing contract
        tests/test_residency.py extends to calibration)."""
        self.calibration_writes += n
        self.registry.counter("energy.calibration_bank_writes").inc(n)
        self.record_external_bank_write(n)

    def record_resident_access(self, hit: bool, n: int = 1) -> None:
        """One residency-cache lookup: a hit is a free pass (the bank was
        already programmed), a miss precedes an install write."""
        if hit:
            self.resident_hits += n
            self.registry.counter("energy.resident_hits").inc(n)
        else:
            self.resident_misses += n
            self.registry.counter("energy.resident_misses").inc(n)

    def record_eviction(self, n: int = 1) -> None:
        self.evictions += n
        self.registry.counter("energy.evictions").inc(n)

    # --------------------------------------------------------- serving hooks
    def _program_banks(self) -> None:
        self.record_bank_write(self.profile.num_physical
                               * self.profile.mats_per_block)

    def _stack_passes(self, rows: int) -> None:
        """``rows`` activation rows ran the whole stack once."""
        if rows <= 0:
            return
        if not self._programmed and not self.external_writes:
            self._programmed = True    # first traffic programs the banks
            self._program_banks()
        self.record_passes(rows * self.profile.depth
                           * self.profile.mats_per_block)

    def on_prefill(self, tokens: int) -> None:
        self._stack_passes(tokens)

    def on_decode_step(self, rows: int) -> None:
        self.decode_steps += 1
        self._steps_since_refresh += 1
        if (self._steps_since_refresh >= self.refresh_steps
                and not self.external_writes):
            # thermal-drift recalibration: reprogram the R basic blocks
            self._steps_since_refresh = 0
            self._program_banks()
        self._stack_passes(rows)

    # --------------------------------------------------------------- report
    @property
    def reuse_hits(self) -> int:
        """Matrix passes served without a fresh programming."""
        return max(0, self.matrix_passes - self.bank_writes)

    @property
    def reuse_ratio(self) -> float:
        return (self.reuse_hits / self.matrix_passes
                if self.matrix_passes else 0.0)

    @property
    def resident_hit_rate(self) -> float:
        """Residency-cache hit rate over all bank lookups (0 when no
        residency manager feeds the meter)."""
        n = self.resident_hits + self.resident_misses
        return self.resident_hits / n if n else 0.0

    def report(self) -> dict:
        """The ``energy`` block of the metrics schema, in paper units."""
        we = self.bank_writes * self._we
        wd = self.bank_writes * self._wd
        ce = self.matrix_passes * self._ce
        cd = self.matrix_passes * self._cd
        bwe = self.baseline_writes * self._we
        bwd = self.baseline_writes * self._wd
        e_rb, e_base = we + ce, bwe + ce
        t_rb, t_base = wd + cd, bwd + cd
        rep = {
            "tile": self.profile.tile,
            "num_physical_blocks": self.profile.num_physical,
            "logical_depth": self.profile.depth,
            "refresh_steps": self.refresh_steps,
            "decode_steps": self.decode_steps,
            "bank_writes": self.bank_writes,
            "matrix_passes": self.matrix_passes,
            "reuse_hits": self.reuse_hits,
            "reuse_ratio": self.reuse_ratio,
            # amortization per PRM stack: passes served per programming
            "amortization_passes_per_write": (
                self.matrix_passes / self.bank_writes
                if self.bank_writes else 0.0),
            "write_energy_uJ": we,
            "compute_energy_uJ": ce,
            "write_delay_ns": wd,
            "compute_delay_ns": cd,
            "baseline_write_energy_uJ": bwe,
            "write_energy_saved_uJ": max(bwe - we, 0.0),
            "write_delay_saved_ns": max(bwd - wd, 0.0),
            "energy_savings_frac": (1.0 - e_rb / e_base) if e_base else 0.0,
            "latency_savings_frac": (1.0 - t_rb / t_base) if t_base else 0.0,
            # residency-manager feed (zeros when residency is off)
            "resident_hit_rate": self.resident_hit_rate,
            "evictions": self.evictions,
            # calibration-loop feed (zeros when no calibration runs):
            # maintenance's share of the write ledger, in matrices / uJ /
            # fraction-of-all-writes (the measured input costmodel.
            # energy_breakdown prefers over its static 0.5 split)
            "calibration_writes": self.calibration_writes,
            "calibration_write_energy_uJ": self.calibration_writes * self._we,
            "calibration_fraction": (self.calibration_writes
                                     / self.bank_writes
                                     if self.bank_writes else 0.0),
        }
        g = self.registry.gauge
        g("energy.reuse_ratio").set(rep["reuse_ratio"])
        g("energy.write_energy_saved_uJ").set(rep["write_energy_saved_uJ"])
        g("energy.energy_savings_frac").set(rep["energy_savings_frac"])
        g("energy.latency_savings_frac").set(rep["latency_savings_frac"])
        g("energy.resident_hit_rate").set(rep["resident_hit_rate"])
        return rep
