"""Global weight-bank residency manager — the paper's economics as a cache
(copy of ``repro.resident.manager``).

R&B's savings come from amortizing MRR reprogramming across reuses; until
now reuse was static per-arch (PRM stacks) and priced per-wave inside one
scheduler.  This module makes bank residency *global*: a bounded MRR array
budget (128x128-tile units, the denomination of ``core/prepared.py`` bank
stats) holds programmed int8 banks ACROSS requests, programs, and layers,
with cost-model-driven eviction when demand exceeds the array.

The eviction score prices what keeping a bank is worth per unit of array it
occupies.  For bank *b* at logical time *t* (one tick per manager access):

    rate(b)   = 1 / max(ewma_interval(b), t - last_access(b))
                -- an EWMA of the bank's access interval, staled by the
                   time since it was last seen (the hit predictor);
    value(b)  = rate(b) * (e_write(b) + endurance_weight * trim_delta(b))
    score(b)  = value(b) / tiles_128(b)

``e_write`` is the calibrated Table-3 programming energy the next install
would pay (``costmodel.unit_prices`` — same clamp as the meter), and
``trim_delta`` is the *marginal* standing trim power (W, ``core/aging.py``)
one more reprogram adds to the bank's accumulated drift — evicting a hot,
already-stressed bank costs endurance, not just energy.  The lowest score
evicts first; ties break on (last_access, key) so eviction order is exactly
reproducible (tests/test_residency.py replays it).

``ProgramResidency`` binds one served Program's banks to a shared manager:
the serving scheduler calls its ``on_prefill``/``on_decode_step`` hooks,
hits ride resident banks for free, misses install (priced writes through
``PhotonicMeter.record_external_bank_write``), and layers a hybrid mapping
plan (``resident/mapping.py``) marked *streamed* reprogram per pass.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.core import aging, costmodel
from repro_torch.core.prepared import tiles_128


# =========================================================================
# bank identity
# =========================================================================
@dataclasses.dataclass(frozen=True)
class BankSpec:
    """One residency unit: a programmed weight bank.

    ``key`` must be globally unique across every Program sharing the
    manager (convention: ``"<program>:<pytree path>"``).  ``mats`` is how
    many matrices the bank programs per install (a PRM-stacked leaf's R
    slices, a MoE bank's experts); ``tile`` is the WDM bus width the
    Table-3 prices are denominated in (bank cycles, NOT the 128-tile
    budget unit)."""

    key: str
    rows: int
    cols: int
    mats: int = 1
    tile: int = 256

    @property
    def tiles(self) -> int:
        """Array-budget occupancy in 128x128 MRR tiles."""
        return self.mats * tiles_128(self.rows, self.cols)

    @property
    def cycles(self) -> float:
        """Bank cycles per matrix (the shared Table-3 pricing unit)."""
        return costmodel.bank_cycles((self.rows, self.cols), self.tile)


@dataclasses.dataclass
class _BankStats:
    """Per-bank history — survives eviction (the predictor must not forget
    a hot bank just because it was evicted)."""

    spec: BankSpec
    last_access: int = -1
    ewma_interval: float = 0.0     # 0 = seen at most once
    accesses: int = 0
    writes: int = 0                # matrices programmed over this bank's life
    last_write_access: int = 0     # accesses count at the last programming
                                   # (the DriftClock's age anchor)


@dataclasses.dataclass(frozen=True)
class Access:
    """Outcome of one ``BankResidencyManager.access``."""

    hit: bool
    resident: bool                 # False: oversized/zero-budget, streamed
    writes: int                    # matrices programmed by this access
    evicted: tuple[str, ...]       # bank keys displaced to make room


# =========================================================================
# the manager
# =========================================================================
class BankResidencyManager:
    """Bounded MRR-array bank cache with cost-model-driven eviction.

    ``budget_tiles`` is the array size in 128x128-tile units (``0`` means
    no array to cache in: every access streams).  All state advances on a
    logical clock (one tick per ``access``) — no wall time, no randomness —
    so a fixed access trace yields a bit-reproducible eviction log.
    """

    def __init__(self, budget_tiles: int, *,
                 ewma_alpha: float = 0.25,
                 endurance_weight: float = 1e3,
                 drift_weight: float = 0.0,
                 model: costmodel.CalibratedCost = costmodel.CALIBRATED,
                 aging_cfg: aging.AgingConfig = aging.AgingConfig(),
                 registry=None):
        if budget_tiles < 0:
            raise ValueError(f"budget_tiles must be >= 0, got {budget_tiles}")
        if not (0.0 < ewma_alpha <= 1.0):
            raise ValueError(f"ewma_alpha must be in (0, 1], got {ewma_alpha}")
        if drift_weight < 0:
            raise ValueError(f"drift_weight must be >= 0, got {drift_weight}")
        self.budget_tiles = int(budget_tiles)
        self.ewma_alpha = float(ewma_alpha)
        self.endurance_weight = float(endurance_weight)
        self.drift_weight = float(drift_weight)
        self.model = model
        self.aging_cfg = aging_cfg
        self.registry = registry
        self.clock = 0
        self.resident: dict[str, BankSpec] = {}      # key -> spec
        self.known: dict[str, _BankStats] = {}       # key -> history
        self.used_tiles = 0
        # counters (mirrored into registry when one is attached)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.writes_mats = 0          # matrices programmed (installs)
        self.streamed_writes_mats = 0  # unresidentable banks, per access
        self.calibration_writes_mats = 0  # calibration-loop reprograms
        self.eviction_log: list[str] = []

    # ------------------------------------------------------------ predictor
    def _stats(self, spec: BankSpec) -> _BankStats:
        st = self.known.get(spec.key)
        if st is None:
            st = self.known[spec.key] = _BankStats(spec=spec)
        return st

    def _observe(self, st: _BankStats) -> None:
        """Fold the current access into the EWMA interval estimate."""
        if st.last_access >= 0:
            interval = float(self.clock - st.last_access)
            if st.ewma_interval <= 0.0:
                st.ewma_interval = interval
            else:
                st.ewma_interval = (self.ewma_alpha * interval
                                    + (1 - self.ewma_alpha)
                                    * st.ewma_interval)
        st.last_access = self.clock
        st.accesses += 1

    def _rate(self, st: _BankStats) -> float:
        """Predicted accesses per clock tick, staled by idle time."""
        idle = float(self.clock - st.last_access)
        interval = max(st.ewma_interval, idle, 1.0)
        return 1.0 / interval

    # -------------------------------------------------------------- scoring
    def _write_energy(self, spec: BankSpec) -> float:
        _, we, _, _ = costmodel.unit_prices(spec.rows, spec.cols, spec.tile,
                                            self.model)
        return spec.mats * we

    def _endurance_delta_w(self, st: _BankStats) -> float:
        """Marginal standing trim power (W) one more reprogram of this
        bank adds — the aging cost of evicting (and later reinstalling)
        an already-stressed bank."""
        w = float(st.writes)
        return (aging.trim_power_w(w + st.spec.mats, self.aging_cfg)
                - aging.trim_power_w(w, self.aging_cfg))

    def retention_score(self, key: str) -> float:
        """Expected per-tile value of keeping ``key`` resident (higher =
        keep).  See the module docstring for the formula.

        With ``drift_weight > 0`` the score learns a drift penalty:
        ``drift_weight * expected_drift_nm(writes) / tolerance_nm`` — a
        heavily written (drift-stressed) bank is a worse tenant because the
        calibration loop will soon have to reprogram it anyway, so keeping
        it resident buys fewer free passes than its access rate suggests.
        The default ``drift_weight=0.0`` leaves every existing eviction
        trace bit-identical."""
        st = self.known[key]
        value = self._rate(st) * (self._write_energy(st.spec)
                                  + self.endurance_weight
                                  * self._endurance_delta_w(st))
        score = value / max(st.spec.tiles, 1)
        if self.drift_weight > 0:
            score -= self.drift_weight * aging.expected_drift_nm(
                float(st.writes), self.aging_cfg) / self.aging_cfg.tolerance_nm
        return score

    # ------------------------------------------------------------- eviction
    def _evict_for(self, need_tiles: int) -> list[str]:
        evicted = []
        while self.used_tiles + need_tiles > self.budget_tiles:
            # lowest retention score goes first; deterministic tie-break on
            # (last_access, key) so a fixed trace replays bit-identically
            victim = min(
                self.resident,
                key=lambda k: (self.retention_score(k),
                               self.known[k].last_access, k))
            spec = self.resident.pop(victim)
            self.used_tiles -= spec.tiles
            evicted.append(victim)
        self.evictions += len(evicted)
        self.eviction_log.extend(evicted)
        if self.registry is not None and evicted:
            self.registry.counter("residency.evictions").inc(len(evicted))
        return evicted

    # -------------------------------------------------------------- access
    def access(self, spec: BankSpec) -> Access:
        """One lookup of ``spec`` (the bank is about to serve a pass).

        Hit: the bank is resident — a free pass.  Miss: evict until the
        bank fits, install it, pay ``spec.mats`` programmings.  A bank
        larger than the whole array can never be resident: it streams
        (reprograms) on every access."""
        self.clock += 1
        st = self._stats(spec)
        self._observe(st)
        if spec.key in self.resident:
            self.hits += 1
            if self.registry is not None:
                self.registry.counter("residency.hits").inc()
            return Access(hit=True, resident=True, writes=0, evicted=())
        self.misses += 1
        if self.registry is not None:
            self.registry.counter("residency.misses").inc()
        if spec.tiles > self.budget_tiles:
            # unresidentable: stream it — a reprogram per access
            st.writes += spec.mats
            st.last_write_access = st.accesses
            self.streamed_writes_mats += spec.mats
            return Access(hit=False, resident=False, writes=spec.mats,
                          evicted=())
        evicted = self._evict_for(spec.tiles)
        self.resident[spec.key] = spec
        self.used_tiles += spec.tiles
        st.writes += spec.mats
        st.last_write_access = st.accesses
        self.writes_mats += spec.mats
        if self.registry is not None:
            self.registry.counter("residency.install_writes").inc(spec.mats)
        return Access(hit=False, resident=True, writes=spec.mats,
                      evicted=tuple(evicted))

    def record_calibration(self, spec: BankSpec) -> None:
        """An in-place calibration reprogram of ``spec`` (the bank stays
        resident; no eviction, no clock tick — this is maintenance, not a
        serving access).  The reprogram still stresses the heaters, so the
        bank's lifetime write count — the drift-penalty input — advances by
        ``spec.mats``.  Billing is the CALLER's job (the calibration loop
        prices it through ``PhotonicMeter.record_calibration_write``); the
        manager only keeps the age ledger honest."""
        st = self._stats(spec)
        st.writes += spec.mats
        st.last_write_access = st.accesses
        self.calibration_writes_mats += spec.mats
        if self.registry is not None:
            self.registry.counter(
                "residency.calibration_writes").inc(spec.mats)

    # ------------------------------------------------------------- queries
    def is_resident(self, key: str) -> bool:
        return key in self.resident

    def all_resident(self, keys: Sequence[str]) -> bool:
        return all(k in self.resident for k in keys)

    @property
    def occupancy_frac(self) -> float:
        return (self.used_tiles / self.budget_tiles
                if self.budget_tiles else 0.0)

    @property
    def total_writes_mats(self) -> int:
        """All programmings paid: installs + streamed reprograms +
        calibration reprograms (zero unless a calibration loop runs)."""
        return (self.writes_mats + self.streamed_writes_mats
                + self.calibration_writes_mats)

    # ------------------------------------------------------------- reports
    def endurance_report(self) -> dict:
        """Aging view of the trace served so far: actual programmings vs
        the reprogram-per-access baseline, and the standing trim power
        each schedule would have accrued (``core/aging.py``)."""
        baseline = sum(st.accesses * st.spec.mats
                       for st in self.known.values())
        actual = self.total_writes_mats
        return {
            "baseline_writes": baseline,
            "actual_writes": actual,
            "endurance_gain": baseline / actual if actual else 0.0,
            "trim_power_baseline_w": aging.trim_power_w(baseline,
                                                        self.aging_cfg),
            "trim_power_actual_w": aging.trim_power_w(actual,
                                                      self.aging_cfg),
        }

    def report(self) -> dict:
        """Residency ledger + occupancy (mirrored into ``residency.*``
        registry gauges when a registry is attached)."""
        lookups = self.hits + self.misses
        rep = {
            "budget_tiles": self.budget_tiles,
            "used_tiles": self.used_tiles,
            "occupancy_frac": self.occupancy_frac,
            "resident_banks": len(self.resident),
            "known_banks": len(self.known),
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / lookups if lookups else 0.0,
            "evictions": self.evictions,
            "install_writes_mats": self.writes_mats,
            "streamed_writes_mats": self.streamed_writes_mats,
            "calibration_writes_mats": self.calibration_writes_mats,
            "endurance": self.endurance_report(),
        }
        if self.registry is not None:
            g = self.registry.gauge
            g("residency.budget_tiles").set(self.budget_tiles)
            g("residency.used_tiles").set(self.used_tiles)
            g("residency.occupancy_frac").set(rep["occupancy_frac"])
            g("residency.resident_banks").set(len(self.resident))
            g("residency.hit_rate").set(rep["hit_rate"])
            g("residency.endurance_gain").set(
                rep["endurance"]["endurance_gain"])
        return rep


# =========================================================================
# drift clock
# =========================================================================
class DriftClock:
    """Per-bank write-age clock over a manager's access log — the source
    feeding ``core/noise.py``'s drift model and the calibration loop.

    Every serving access of a bank holds its rings under thermal bias for
    one pass; ``writes_per_access`` converts that logged access count into
    equivalent write-stress cycles (the unit ``core/aging.py`` prices).
    ``age_writes(key)`` is the stress accumulated SINCE the bank was last
    (re)programmed: ``reset(key)`` — called by the calibration loop after a
    reprogram — re-anchors the baseline at the bank's current access count,
    so age is always "accesses since last program", not lifetime total
    (lifetime stays in ``_BankStats.writes`` for the eviction penalty).

    The anchor is ``_BankStats.last_write_access`` — the manager stamps it
    on every programming event (install after a miss/eviction, streamed
    reprogram, calibration repair), so age is exact from the bank's very
    first sweep.  Purely a view over the manager's deterministic counters:
    no wall time, no state of its own, so a fixed access trace yields
    bit-reproducible ages."""

    def __init__(self, manager: BankResidencyManager, *,
                 writes_per_access: float = 1.0):
        if writes_per_access < 0:
            raise ValueError(f"writes_per_access must be >= 0, got "
                             f"{writes_per_access}")
        self.manager = manager
        self.writes_per_access = float(writes_per_access)

    def age_writes(self, key: str) -> float:
        """Write-stress cycles accumulated since ``key`` was last
        programmed (0.0 for a bank the manager has never seen)."""
        st = self.manager.known.get(key)
        if st is None:
            return 0.0
        return max(st.accesses - st.last_write_access, 0) \
            * self.writes_per_access

    def reset(self, key: str) -> None:
        """Re-anchor ``key``'s age at zero (just reprogrammed).  Usually
        implicit — every manager write path stamps the anchor itself —
        kept for callers driving reprograms outside the manager."""
        st = self.manager.known.get(key)
        if st is not None:
            st.last_write_access = st.accesses

    def ages(self, keys: Sequence[str]) -> dict:
        return {k: self.age_writes(k) for k in keys}


# =========================================================================
# per-Program binding
# =========================================================================
class ProgramResidency:
    """Binds one served Program's banks to a shared residency manager.

    The serving scheduler calls ``on_prefill``/``on_decode_step`` once per
    scheduler event (mirroring the PhotonicMeter hooks): every bank the
    stack streams through must be programmed for that pass, so each spec
    is looked up once.  With a hybrid mapping plan (``resident/
    mapping.py``), only the plan's *resident* layers go through the
    manager; *streamed* layers reprogram every pass — both priced into the
    bound meter so the energy ledger stays honest.
    """

    def __init__(self, manager: BankResidencyManager,
                 specs: Sequence[BankSpec], *, plan=None, meter=None):
        self.manager = manager
        keys = {s.key for s in specs}
        if len(keys) != len(specs):
            raise ValueError("duplicate bank keys in residency specs")
        if plan is not None:
            resident = set(plan.resident)
            unknown = resident - keys
            if unknown:
                raise ValueError(f"mapping plan names unknown banks: "
                                 f"{sorted(unknown)[:4]}")
            self.resident_specs = tuple(s for s in specs
                                        if s.key in resident)
            self.streamed_specs = tuple(s for s in specs
                                        if s.key not in resident)
        else:
            self.resident_specs = tuple(specs)
            self.streamed_specs = ()
        self.plan = plan
        self.meter = meter

    # ------------------------------------------------------------- binding
    def bind_meter(self, meter) -> None:
        """Attach the serving PhotonicMeter and hand it the write schedule
        (its internal program/refresh accounting turns off — the manager
        is now the only write source, so hits are never double-billed)."""
        self.meter = meter
        if meter is not None:
            meter.set_external_writes(True)

    @property
    def bank_keys(self) -> tuple[str, ...]:
        return tuple(s.key for s in self.resident_specs)

    def all_resident(self) -> bool:
        """Are all of this Program's manager-managed banks currently hot?
        (False until first traffic installs them.)"""
        return bool(self.resident_specs) and self.manager.all_resident(
            self.bank_keys)

    # --------------------------------------------------------------- hooks
    def _touch(self) -> None:
        m = self.meter
        for spec in self.resident_specs:
            acc = self.manager.access(spec)
            if m is not None:
                m.record_resident_access(acc.hit)
                if acc.writes:
                    m.record_external_bank_write(acc.writes)
                if acc.evicted:
                    m.record_eviction(len(acc.evicted))
        for spec in self.streamed_specs:
            # hybrid-mapped cold layer: reprogram-per-pass by design
            self.manager.streamed_writes_mats += spec.mats
            if m is not None:
                m.record_external_bank_write(spec.mats)

    def on_prefill(self, tokens: int) -> None:
        self._touch()

    def on_decode_step(self, rows: int) -> None:
        self._touch()


def specs_from_profile(profile, prefix: str = "prog") -> list[BankSpec]:
    """Bank specs for an arch from its meter :class:`StackProfile` — one
    spec per physical basic block (R blocks of ``mats_per_block`` matrices
    of (rows, cols)).  The fallback when no prepared photonic bank exists
    (xla execution) and the unit the multi-arch bench simulates with."""
    return [BankSpec(key=f"{prefix}:block{i}", rows=profile.rows,
                     cols=profile.cols, mats=profile.mats_per_block,
                     tile=profile.tile)
            for i in range(profile.num_physical)]


def specs_from_program(program, prefix: Optional[str] = None,
                       tile: int = 256) -> list[BankSpec]:
    """Bank specs from a built Program's prepared photonic bank (one per
    programmed tensor, 128-tile occupancy from ``core/prepared.py``).
    Returns [] on a non-photonic Program — fall back to
    :func:`specs_from_profile`."""
    from repro_torch.core.prepared import bank_descriptors
    prefix = prefix if prefix is not None else program.cfg.name
    return [BankSpec(key=f"{prefix}:{d['path']}", rows=d["rows"],
                     cols=d["cols"], mats=d["stacked"], tile=tile)
            for d in bank_descriptors(program.bank)]
