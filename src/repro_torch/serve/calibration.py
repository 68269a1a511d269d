"""Calibration read-back loop — drift detection & repair for served banks
(port of ``repro.serve.calibration``).

The fault model (``core/noise.py``) makes a programmed bank's effective
gain walk away from its calibrated value as write-age accumulates.  This
module closes the loop the way the hardware would (paper §4.2.3: periodic
thermal recalibration):

  1. **Detect** — every ``every_steps`` scheduler decode steps, re-measure
     each RESIDENT bank's W0 checksums (``core/noise.py::
     readback_gain_error`` — both OBU orientations, against the stored
     post-programming reference) at the age the :class:`~repro_torch.resident.
     manager.DriftClock` reports;
  2. **Repair** — a bank whose read-back error exceeds ``stale_threshold``
     is re-programmed in place: the write is priced through
     ``PhotonicMeter.record_calibration_write`` (the external-writes chain
     — billed exactly once), the residency manager's lifetime write ledger
     advances (``record_calibration`` — feeding the eviction drift
     penalty), and the drift clock re-anchors at zero;
  3. **Republish** — the surviving per-bank ages (quantized to the config's
     ``writes_per_epoch`` so small age deltas don't rebuild gain vectors) are
     installed on the live Program via ``Program.update_noise``, so the
     next decode step simulates each bank at its true drift age.

Observability: ``calibration.rechecks`` / ``calibration.reprograms``
counters plus ``calibration.stale_banks`` / ``calibration.max_readback_err``
gauges on the attached registry — the staleness view.

The loop is pure host-side policy over deterministic state (logical
clocks, hashed per-tile draws): a fixed trace replays bit-identically,
calibration on or off.  Bank keys are the reference's: the ``keystr``
paths of the prepared bank in JAX's sorted order
(``core/prepared.flatten_with_path``), as ``resident.specs_from_program``
names them.
"""
from __future__ import annotations

from repro_torch.core import noise as noise_lib
from repro_torch.core.prepared import (PreparedTensor, flatten_with_path,
                                       keystr)
from repro_torch.resident.manager import BankSpec, DriftClock


class CalibrationLoop:
    """Periodic read-back verification + reprogram of a Program's banks.

    Wire it into a :class:`~repro_torch.serve.scheduler.ContinuousScheduler` via
    ``calibration=``, or drive :meth:`on_step` / :meth:`run` directly (the
    drift bench does).  ``manager``/``clock`` supply residency state and
    per-bank ages; ``meter`` (optional) prices the repair writes.
    """

    def __init__(self, program, manager, *, clock: DriftClock | None = None,
                 noise=None, every_steps: int = 8,
                 stale_threshold: float = 0.01, meter=None, registry=None,
                 prefix: str | None = None, tile: int = 256):
        if every_steps < 1:
            raise ValueError(f"every_steps must be >= 1, got {every_steps}")
        if stale_threshold <= 0:
            raise ValueError(f"stale_threshold must be > 0, got "
                             f"{stale_threshold}")
        base = noise if noise is not None else program.backend.noise
        if base is None:
            raise ValueError("CalibrationLoop needs a NoiseConfig — pass "
                             "noise= or build the Program with a noisy "
                             "Backend")
        self.program = program
        self.manager = manager
        self.clock = clock if clock is not None else DriftClock(manager)
        self.noise = base
        self.every_steps = int(every_steps)
        self.stale_threshold = float(stale_threshold)
        self.meter = meter
        self.registry = registry
        prefix = prefix if prefix is not None else program.cfg.name
        # enumerate the programmed banks once: (residency key, BankSpec,
        # prepared leaf) — keys match resident.specs_from_program exactly,
        # so the loop and the residency binding talk about the same banks
        self.banks: list[tuple[str, BankSpec, PreparedTensor]] = []
        for path, leaf in flatten_with_path(program.bank):
            if not isinstance(leaf, PreparedTensor):
                continue
            k, n = int(leaf.wq.shape[-2]), int(leaf.wq.shape[-1])
            stacked = 1
            for d in leaf.wq.shape[:-2]:
                stacked *= int(d)
            key = f"{prefix}:{keystr(path)}"
            self.banks.append((key, BankSpec(key=key, rows=k, cols=n,
                                             mats=stacked, tile=tile), leaf))
        self._steps = 0
        self.rechecks = 0
        self.reprograms = 0
        self.sweeps = 0
        self.last_stale = 0
        self.last_max_err = 0.0

    # ---------------------------------------------------------------- hooks
    def on_step(self) -> bool:
        """One scheduler decode step; runs a sweep every ``every_steps``.
        Returns True when a sweep ran."""
        self._steps += 1
        if self._steps % self.every_steps:
            return False
        self.run()
        return True

    def _quantize_age(self, age: float) -> float:
        """Round an age DOWN to the config's ``writes_per_epoch`` grid —
        bounds how often republished ages rebuild the gain vectors (drift
        between grid points is under-simulated by at most one epoch)."""
        step = max(float(self.noise.writes_per_epoch), 1.0)
        return (age // step) * step

    def run(self) -> dict:
        """One calibration sweep over the currently resident banks.

        Non-resident banks are skipped: they are reprogrammed at their next
        install anyway (the drift clock sees that write and re-anchors), so
        read-back there would verify rings about to be overwritten."""
        self.sweeps += 1
        stale = 0
        checked = 0
        max_err = 0.0
        ages: dict[int, float] = {}
        for key, spec, leaf in self.banks:
            if not self.manager.is_resident(key):
                continue
            age = self.clock.age_writes(key)
            err = noise_lib.readback_gain_error(leaf, self.noise,
                                                age_writes=age)
            checked += 1
            self.rechecks += 1
            max_err = max(max_err, err)
            if err > self.stale_threshold:
                # drift repair: reprogram in place, billed exactly once
                stale += 1
                self.reprograms += 1
                if self.meter is not None:
                    self.meter.record_calibration_write(spec.mats)
                self.manager.record_calibration(spec)
                self.clock.reset(key)
                age = 0.0
            ages[leaf.tag] = self._quantize_age(age)
        self.last_stale = stale
        self.last_max_err = max_err
        new_noise = self.noise.with_bank_ages(ages)
        if new_noise != self.noise:
            self.noise = new_noise
            self.program.update_noise(new_noise)
        if self.registry is not None:
            c = self.registry.counter
            if checked:
                c("calibration.rechecks").inc(checked)
            if stale:
                c("calibration.reprograms").inc(stale)
            g = self.registry.gauge
            g("calibration.stale_banks").set(stale)
            g("calibration.max_readback_err").set(max_err)
            g("calibration.sweeps").set(self.sweeps)
        return {"stale": stale, "max_readback_err": max_err,
                "rechecks": self.rechecks, "reprograms": self.reprograms}

    # --------------------------------------------------------------- report
    def report(self) -> dict:
        return {
            "sweeps": self.sweeps,
            "rechecks": self.rechecks,
            "reprograms": self.reprograms,
            "stale_banks": self.last_stale,
            "max_readback_err": self.last_max_err,
            "every_steps": self.every_steps,
            "stale_threshold": self.stale_threshold,
        }
