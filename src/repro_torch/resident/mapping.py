"""Layer-wise hybrid mapping: hot layers stay programmed, cold layers
stream — ROSA's limited-array mapping idea applied to the R&B cost model
(copy of ``repro.resident.mapping``).

A finite MRR array (``budget_tiles`` 128x128 crossbars, the Ohno-crossbar
constraint) usually cannot hold every prepared bank of a Program.  The
planner splits the layers into a *resident* set (programmed once, refreshed
every ``refresh_passes`` stack passes for thermal drift) and a *streamed*
set (reprogrammed on every pass), choosing the split that minimizes the
calibrated Table-3 energy per stack pass; delay is reported alongside (the
two rankings coincide — both are the same write cost scaled by different
slopes, see below).

Per stack pass, a layer bank of ``mats`` matrices prices as:

    streamed:  mats * (e_write + e_comp)         -- reprogram-per-pass
    resident:  mats * (e_write / refresh_passes + e_comp)

so the *benefit* of making a layer resident is
``weight * mats * e_write * (1 - 1/refresh_passes)`` per pass at a cost of
``tiles_128`` array units — a knapsack.  Benefits here are proportional to
tile-count times a shared affine term, so the greedy benefit-per-tile order
is near-exact; it is deterministic (ties break on key) and is what the
paper-scale benchmark gates on.  ``weight`` is the layer's passes per
served stack pass (PRM-stacked leaves stream once per slice).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core import costmodel

from repro_torch.resident.manager import BankSpec


@dataclasses.dataclass(frozen=True)
class MappingPlan:
    """The hybrid split plus its predicted per-stack-pass economics."""

    resident: tuple[str, ...]
    streamed: tuple[str, ...]
    budget_tiles: int
    used_tiles: int
    refresh_passes: int
    energy_uJ_per_pass: float
    delay_ns_per_pass: float
    baseline_energy_uJ_per_pass: float     # everything streamed
    baseline_delay_ns_per_pass: float

    @property
    def energy_savings_frac(self) -> float:
        b = self.baseline_energy_uJ_per_pass
        return (1.0 - self.energy_uJ_per_pass / b) if b else 0.0

    @property
    def latency_savings_frac(self) -> float:
        b = self.baseline_delay_ns_per_pass
        return (1.0 - self.delay_ns_per_pass / b) if b else 0.0


def _per_pass(spec: BankSpec, resident: bool, refresh_passes: int,
              model: costmodel.CalibratedCost):
    """(energy_uJ, delay_ns) one stack pass charges this layer."""
    wd, we, cd, ce = costmodel.unit_prices(spec.rows, spec.cols, spec.tile,
                                           model)
    amort = (1.0 / refresh_passes) if resident else 1.0
    return (spec.mats * (we * amort + ce),
            spec.mats * (wd * amort + cd))


def plan_hybrid_mapping(specs: Sequence[BankSpec], budget_tiles: int, *,
                        refresh_passes: int = 64,
                        model: costmodel.CalibratedCost = costmodel.
                        CALIBRATED) -> MappingPlan:
    """Pick the resident set under ``budget_tiles`` greedily by write-
    energy saved per 128-tile of array occupied (deterministic: ties and
    the scan order break on the bank key)."""
    if budget_tiles < 0:
        raise ValueError(f"budget_tiles must be >= 0, got {budget_tiles}")
    refresh_passes = max(1, refresh_passes)

    def density(spec: BankSpec) -> float:
        _, we, _, _ = costmodel.unit_prices(spec.rows, spec.cols, spec.tile,
                                            model)
        benefit = spec.mats * we * (1.0 - 1.0 / refresh_passes)
        return benefit / max(spec.tiles, 1)

    ordered = sorted(specs, key=lambda s: (-density(s), s.key))
    resident: list[str] = []
    used = 0
    for spec in ordered:
        if used + spec.tiles <= budget_tiles:
            resident.append(spec.key)
            used += spec.tiles
    resident_set = set(resident)
    streamed = [s.key for s in specs if s.key not in resident_set]

    e = d = be = bd = 0.0
    for spec in specs:
        se, sd = _per_pass(spec, spec.key in resident_set, refresh_passes,
                           model)
        e, d = e + se, d + sd
        se, sd = _per_pass(spec, False, refresh_passes, model)
        be, bd = be + se, bd + sd
    return MappingPlan(
        resident=tuple(sorted(resident)), streamed=tuple(sorted(streamed)),
        budget_tiles=budget_tiles, used_tiles=used,
        refresh_passes=refresh_passes,
        energy_uJ_per_pass=e, delay_ns_per_pass=d,
        baseline_energy_uJ_per_pass=be, baseline_delay_ns_per_pass=bd)
