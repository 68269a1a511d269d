"""MRR aging / write-variation model — paper §4.2.3 (copy of
``repro.core.aging``).

Long-term operation under frequent thermal tuning degrades MRRs: resonance
wavelength drifts and Q-factor drops.  The paper argues R&B's write-count
reduction (Table 2: ``min(N,B)`` programmings vs ``min(N,B)·K·C``) directly
extends device endurance.  This module makes that argument quantitative:

  * drift is modeled as a per-write-cycle random walk plus a small
    deterministic (VBTI-like) component — each programming/calibration
    cycle stresses the heater;
  * a ring is considered *degraded* when its accumulated expected drift
    exceeds the trimming tolerance the calibration loop can recover
    (beyond it, remedying costs 240 mW/nm of standing trim power —
    paper Table 1 / [22]);
  * endurance = number of write cycles until that point; the R&B endurance
    *gain* for a stack is baseline writes / shared writes = the reuse
    factor, weighted per matrix.

All constants are configurable; defaults follow the paper's cited numbers.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.costmodel import COMPONENTS
from repro_torch.core.prm import ReusePlan


@dataclasses.dataclass(frozen=True)
class AgingConfig:
    drift_sigma_pm_per_write: float = 0.05   # random-walk step, picometers
    drift_bias_pm_per_write: float = 0.002   # deterministic (VBTI) component
    tolerance_nm: float = 0.5                # recoverable drift budget
    trim_power_per_nm_w: float = COMPONENTS.trim_power_per_nm_w


def expected_drift_nm(writes: float, cfg: AgingConfig = AgingConfig()):
    """E[|drift|] after ``writes`` cycles (random walk + bias), in nm."""
    rw = cfg.drift_sigma_pm_per_write * math.sqrt(max(writes, 0.0)) \
        * math.sqrt(2.0 / math.pi)
    bias = cfg.drift_bias_pm_per_write * writes
    return (rw + bias) / 1e3


def writes_for_drift_nm(target_nm: float,
                        cfg: AgingConfig = AgingConfig()) -> float:
    """Inverse of :func:`expected_drift_nm`: the write-cycle age at which
    expected drift reaches ``target_nm`` (geometric bisection — the model
    is monotone).  Used by ``benchmarks/drift_bench.py`` to pick the age
    ladder for a target accuracy impact."""
    if target_nm <= 0:
        return 0.0
    lo, hi = 1.0, 1e15
    for _ in range(200):
        mid = math.sqrt(lo * hi)
        if expected_drift_nm(mid, cfg) > target_nm:
            hi = mid
        else:
            lo = mid
    return lo


def endurance_writes(cfg: AgingConfig = AgingConfig()) -> float:
    """Write cycles until expected drift exceeds the tolerance."""
    lo, hi = 1.0, 1e15
    for _ in range(200):
        mid = math.sqrt(lo * hi)
        if expected_drift_nm(mid, cfg) > cfg.tolerance_nm:
            hi = mid
        else:
            lo = mid
    return lo


def trim_power_w(writes: float, cfg: AgingConfig = AgingConfig()) -> float:
    """Standing trim power needed to remedy accumulated drift (W)."""
    return expected_drift_nm(writes, cfg) * cfg.trim_power_per_nm_w


def endurance_gain(plan: ReusePlan) -> float:
    """Device-lifetime multiplier from PRM sharing: writes per inference
    drop from ``depth`` to ``num_physical`` programmings."""
    return plan.depth / plan.num_physical


def lifetime_report(plan: ReusePlan, inferences_per_day: float = 1e6,
                    cfg: AgingConfig = AgingConfig()) -> dict:
    """Endurance summary for a stack under a deployment load."""
    ew = endurance_writes(cfg)
    base_writes_day = plan.depth * inferences_per_day
    rb_writes_day = plan.num_physical * inferences_per_day
    return {
        "endurance_write_cycles": ew,
        "baseline_days": ew / base_writes_day,
        "rb_days": ew / rb_writes_day,
        "endurance_gain": endurance_gain(plan),
        "trim_power_after_30d_baseline_w":
            trim_power_w(base_writes_day * 30, cfg),
        "trim_power_after_30d_rb_w":
            trim_power_w(rb_writes_day * 30, cfg),
    }
