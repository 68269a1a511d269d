"""Drift sweep: accuracy against write age under the fault model, with the
calibration loop off and on (port of ``benchmarks/drift_bench.py``'s sweep
and gates).

One model is built twice, on ``xla`` (the reference) and on ``photonic``
with a ``NoiseConfig`` whose only error source is write-age drift.  A
ladder of ages from 0 to ``aging.writes_for_drift_nm(drift_nm)`` is swept
over the same prompts:

  * uncalibrated: the age is installed on the live Program
    (``Program.update_noise``); prefill parity against xla degrades;
  * calibrated: a ``BankResidencyManager`` holds the banks, a
    ``DriftClock`` turns its accesses into ages, and a ``CalibrationLoop``
    reads every bank back each rung and reprograms the stale ones, billed
    once through ``PhotonicMeter.record_calibration_write``.

Gates (:func:`check_gates`): the uncalibrated sweep breaks the W8A8 parity
bound (rel-L2 > 0.055) by the top rung, the calibrated sweep holds it at
every rung, calibration repaired at least one bank, and every write lands
in the meter exactly once.
"""
from __future__ import annotations

import dataclasses

import torch

PARITY_REL_L2 = 0.055       # the repository's photonic parity bound


def rel_l2(a, b) -> float:
    a = torch.as_tensor(a).detach().float().cpu()
    b = torch.as_tensor(b).detach().float().cpu()
    return float((a - b).norm() / max(float(b.norm()), 1e-12))


def age_ladder(drift_nm: float, rungs: int, aging_cfg):
    """Uniform write-age ladder whose top rung reaches ``drift_nm`` of
    expected resonance drift.  Returns (ages, step)."""
    from repro_torch.core import aging
    age_max = aging.writes_for_drift_nm(drift_nm, aging_cfg)
    step = age_max / (rungs - 1)
    return [i * step for i in range(rungs)], step


def drift_noise(drift_gain_per_nm: float = 0.05, drift_nm: float = 3.0,
                rungs: int = 3, seed: int = 0):
    """(noise0, ages, rung_step): the drift-only config of the reference
    bench, its republished ages quantized to the rung granularity."""
    from repro_torch.core.noise import NoiseConfig
    noise0 = NoiseConfig(drift_gain_per_nm=drift_gain_per_nm, seed=seed)
    ages, step = age_ladder(drift_nm, rungs, noise0.aging)
    return (dataclasses.replace(noise0, writes_per_epoch=max(step, 1.0)),
            ages, step)


def parity(prog, prog_ref, batch, cache_len: int) -> float:
    ref = prog_ref.prefill(batch, cache_len)[0]
    got = prog.prefill(batch, cache_len)[0]
    return rel_l2(got, ref)


def run_sweeps(prog, prog_ref, batch, *, cfg, noise0, ages, rung_step,
               cache_len, stale_threshold=0.01, registry=None):
    """Sweep the age ladder uncalibrated, then calibrated (same Program,
    same prompts).  Returns (rows, CalibrationLoop, PhotonicMeter,
    BankResidencyManager)."""
    from repro_torch.core import aging
    from repro_torch.obs.meter import PhotonicMeter, StackProfile
    from repro_torch.resident import (BankResidencyManager, DriftClock,
                                      specs_from_program)
    from repro_torch.serve.calibration import CalibrationLoop

    uncal = []
    for age in ages:
        prog.update_noise(dataclasses.replace(noise0, age_writes=age))
        uncal.append(parity(prog, prog_ref, batch, cache_len))

    prog.update_noise(noise0)                      # fresh rings
    manager = BankResidencyManager(10 ** 9, registry=registry)
    meter = PhotonicMeter(StackProfile.from_cfg(cfg), external_writes=True,
                          registry=registry)
    clock = DriftClock(manager, writes_per_access=rung_step)
    specs = specs_from_program(prog, prefix=cfg.name)
    for spec in specs:                             # initial programming
        acc = manager.access(spec)
        if acc.writes:
            meter.record_external_bank_write(acc.writes)
    loop = CalibrationLoop(prog, manager, clock=clock, noise=noise0,
                           every_steps=1, stale_threshold=stale_threshold,
                           meter=meter, registry=registry, prefix=cfg.name)
    rows = []
    for i, age in enumerate(ages):
        readback = 0.0
        reprogrammed = 0
        if i:                                      # one rung of serving load
            for spec in specs:
                acc = manager.access(spec)
                meter.record_resident_access(acc.hit)
            swept = loop.run()
            readback = swept["max_readback_err"]
            reprogrammed = swept["stale"]
        rows.append({
            "age_writes": age,
            "drift_nm": aging.expected_drift_nm(age, noise0.aging),
            "drift_gain_sigma": noise0.drift_sigma(age),
            "uncal_rel_l2": uncal[i],
            "cal_rel_l2": parity(prog, prog_ref, batch, cache_len),
            "readback_err": readback,
            "reprogrammed_banks": reprogrammed,
        })
    return rows, loop, meter, manager


def check_gates(rows, loop, meter, manager) -> None:
    """The reference bench's gates; raises AssertionError on a miss."""
    final = rows[-1]
    assert final["uncal_rel_l2"] > PARITY_REL_L2, (
        f"uncalibrated drift at {final['drift_nm']:.2f}nm must break the "
        f"{PARITY_REL_L2} parity bound (got {final['uncal_rel_l2']:.4f})")
    bad = [(r["age_writes"], r["cal_rel_l2"]) for r in rows
           if r["cal_rel_l2"] > PARITY_REL_L2]
    assert not bad, f"calibrated rungs above {PARITY_REL_L2}: {bad}"
    assert loop.reprograms > 0, "calibration never repaired a bank"
    installs = sum(spec.mats for _, spec, _ in loop.banks)
    assert meter.bank_writes == installs + meter.calibration_writes, (
        f"write ledger double-bills: {meter.bank_writes} != installs "
        f"{installs} + calibration {meter.calibration_writes}")
    assert (manager.report()["calibration_writes_mats"]
            == meter.calibration_writes), "calibration ledgers disagree"
