"""Energy / latency cost model — paper Tables 1–3, Fig. 1.

Two layers:

1. **Formula layer** (paper Table 2): closed-form programming-times / latency /
   power for MZI-ONN, CrossLight, HolyLight and R&B ("ours"), parameterized by
   (M, N, K, C, B, beta_a, beta_p, beta_t).

2. **Calibrated layer** (paper Table 3): an affine per-matrix cost in "bank
   cycles" ``u = elements / tile`` (one cycle programs or streams ``tile``
   rings over the WDM bus):

       t_write(u)  = 19.642857 * u - 157.142857      [ns]
       t_comp(u)   =  6.869676 * u + 157.059         [ns]
       e_write(u)  = 3.138021e-3 * u + 0.100952      [uJ]
       e_comp(u)   = 1.097005e-3 * u + 0.024881      [uJ]

   Constants are fit to the paper's Table 3 (8 matrices of 256x256, tile in
   {64, 256, 1024}, one basic matrix reused 8x).  The fit reproduces all 12
   delay entries exactly and all 12 energy entries to <0.3% (see
   benchmarks/table3.py).  Totals for K matrices served by R basic matrices:

       delay  = R * t_write + K * t_comp
       energy = R * e_write + K * e_comp

   The negative write intercept / positive compute intercept is a fixed
   pipeline-fill term the paper's numbers move between the two phases; they
   cancel in any full pass.

A copy of ``repro.core.costmodel`` with one change: the reference's TPU
roofline spec is replaced by the H100's published peaks (``H100``), which
``chip_smoke.py`` uses for every kernel's bound.  The calibrated photonic
prices are unchanged (tested equal to the reference).
"""
from __future__ import annotations

import dataclasses
import math


# --------------------------------------------------------------- GPU roofline
@dataclasses.dataclass(frozen=True)
class GPUSpec:
    """Published dense peaks of one card (NVIDIA H100 SXM data sheet, at
    the full 700 W power limit)."""
    name: str = "h100-sxm"
    peak_flops_bf16: float = 989e12    # FLOP/s, tensor cores
    peak_ops_int8: float = 1979e12     # OP/s, tensor cores
    peak_flops_fp32: float = 67e12     # FLOP/s outside the tensor cores
    hbm_bw: float = 3.35e12            # bytes/s
    nvlink_bw: float = 450e9           # bytes/s each way
    hbm_bytes: float = 80e9


H100 = GPUSpec()


# ------------------------------------------------------- Table 1 constants
@dataclasses.dataclass(frozen=True)
class ComponentTable:
    """Selected rows of paper Table 1 (used by the Fig.-1 breakdown)."""
    modulator_driver_w: float = 0.8e-3     # @ 10 Gbps
    heater_tuner_w: float = 14e-3          # per-MRR thermal hold
    adc_w: float = 39e-3
    dac_w: float = 3.93e-3
    pd_responsivity: float = 1.1           # A/W
    mrr_cell_area_um2: float = 127.0 * 127.0
    adc_area_mm2: float = 1.2288
    dac_area_mm2: float = 0.0004
    sh_area_mm2: float = 0.00004
    edram_area_mm2: float = 0.268
    bus_area_mm2: float = 0.009
    trim_power_per_nm_w: float = 240e-3    # §4.2.3


COMPONENTS = ComponentTable()


# ------------------------------------------------------ Table 3 calibration
def bank_cycles(shape, tile: int) -> float:
    """Bank cycles ``u = elements / tile`` of one (rows, cols) matrix.

    The single unit the Table-3 affine costs are priced in: one cycle
    programs (write phase) or streams (compute phase) ``tile`` rings over
    the WDM bus.  This is the ONE place the conversion lives — the meter
    (`obs/meter.py`), the residency manager's eviction scorer
    (`resident/manager.py`), and the hybrid-mapping planner all price
    through it, so the accounting cannot drift between them."""
    rows, cols = shape
    return rows * cols / tile


@dataclasses.dataclass(frozen=True)
class CalibratedCost:
    # delay, ns per bank-cycle + fixed
    t_write_slope: float = 137.5 / 7.0           # 19.642857...
    t_write_fixed: float = -1100.0 / 7.0         # -157.142857...
    t_comp_slope: float = 6.869676
    t_comp_fixed: float = 157.059
    # energy, uJ
    e_write_slope: float = 3.138021e-3
    e_write_fixed: float = 0.100952
    e_comp_slope: float = 1.097005e-3
    e_comp_fixed: float = 0.024881

    def write_cost(self, rows: int, cols: int, tile: int):
        """(delay_ns, energy_uJ) to program one rows x cols matrix."""
        u = bank_cycles((rows, cols), tile)
        return (self.t_write_slope * u + self.t_write_fixed,
                self.e_write_slope * u + self.e_write_fixed)

    def compute_cost(self, rows: int, cols: int, tile: int):
        """(delay_ns, energy_uJ) for one optical MVM pass of the matrix."""
        u = bank_cycles((rows, cols), tile)
        return (self.t_comp_slope * u + self.t_comp_fixed,
                self.e_comp_slope * u + self.e_comp_fixed)


CALIBRATED = CalibratedCost()


def unit_prices(rows: int, cols: int, tile: int,
                model: CalibratedCost = CALIBRATED):
    """Clamped per-event prices ``(wd_ns, we_uJ, cd_ns, ce_uJ)`` of one
    (rows, cols) matrix: one programming and one MVM pass.

    The affine fit's negative write intercept is a pipeline-fill term that
    cancels in any full pass (module docstring); as a standalone per-event
    price it must be non-negative, so every component clamps at 0 — only
    active for sub-calibration toy sizes (u < 8 bank cycles).  The meter
    and the residency manager both price events through this helper."""
    wd, we = model.write_cost(rows, cols, tile)
    cd, ce = model.compute_cost(rows, cols, tile)
    return max(wd, 0.0), max(we, 0.0), max(cd, 0.0), max(ce, 0.0)


@dataclasses.dataclass(frozen=True)
class CostBreakdown:
    delay_ns: float
    energy_uJ: float
    write_delay_ns: float
    write_energy_uJ: float
    compute_delay_ns: float
    compute_energy_uJ: float
    programs: int            # weight-block programmings (R)
    passes: int              # MVM passes (K)

    def __add__(self, other: "CostBreakdown") -> "CostBreakdown":
        return CostBreakdown(*(getattr(self, f.name) + getattr(other, f.name)
                               for f in dataclasses.fields(self)))


ZERO_COST = CostBreakdown(0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0, 0)


def matrix_cost(rows: int, cols: int, tile: int, *, programs: int,
                passes: int, model: CalibratedCost = CALIBRATED
                ) -> CostBreakdown:
    """Cost of serving ``passes`` logical MVMs of a (rows, cols) matrix from
    ``programs`` physical programmings (PRM: programs = R, passes = K)."""
    wd, we = model.write_cost(rows, cols, tile)
    cd, ce = model.compute_cost(rows, cols, tile)
    return CostBreakdown(
        delay_ns=programs * wd + passes * cd,
        energy_uJ=programs * we + passes * ce,
        write_delay_ns=programs * wd,
        write_energy_uJ=programs * we,
        compute_delay_ns=passes * cd,
        compute_energy_uJ=passes * ce,
        programs=programs, passes=passes)


def stack_cost(weight_shapes, plan, tile: int,
               model: CalibratedCost = CALIBRATED) -> CostBreakdown:
    """Cost of one forward pass of a PRM-shared stack.

    ``weight_shapes``: list of (rows, cols) matrices inside ONE basic block.
    ``plan``: a core.prm.ReusePlan covering the stack.
    Each basic block is programmed once and its matrices are each used
    ``plan.depth / plan.num_physical`` times total across the stack.
    """
    total = ZERO_COST
    for (r, c) in weight_shapes:
        total = total + matrix_cost(
            r, c, tile, programs=plan.num_physical, passes=plan.depth,
            model=model)
    return total


def baseline_stack_cost(weight_shapes, depth: int, tile: int,
                        model: CalibratedCost = CALIBRATED) -> CostBreakdown:
    """No-reuse baseline: every logical layer programs its own weights."""
    total = ZERO_COST
    for (r, c) in weight_shapes:
        total = total + matrix_cost(r, c, tile, programs=depth, passes=depth,
                                    model=model)
    return total


# ----------------------------------------------------------- Table 2 formulas
def table2_row(method: str, *, M: int, N: int, K: int, C: int, B: int,
               beta_a: float = 24.0, beta_p: float = 12.0,
               beta_t: float = 2.0) -> dict:
    """Programming-times / latency / power formulas of paper Table 2."""
    m = method.lower()
    if m == "mzi":
        return {"programming_times": beta_a * M * N * K,
                "latency": beta_a,
                "power": beta_p * M * N * K,
                "control": "high"}
    if m == "crosslight":
        return {"programming_times": min(N, B) * K * C,
                "latency": math.ceil(N * C / (B * beta_t)),
                "power": min(N, B) * K / beta_t,
                "control": "high"}
    if m == "holylight":
        return {"programming_times": min(N, B) * K * C,
                "latency": math.ceil(N * C / B),
                "power": min(N, B) * K,
                "control": "high"}
    if m in ("ours", "rb", "r&b"):
        return {"programming_times": min(N, B),
                "latency": math.ceil(N / (B * K)),
                "power": min(N, B),
                "control": "low"}
    raise ValueError(f"unknown method {method!r}")


# ------------------------------------------------------------ Fig 1 breakdown
def energy_breakdown(cost: CostBreakdown, calibration_fraction: float = 0.5,
                     comp: ComponentTable = COMPONENTS,
                     meter_report: dict | None = None) -> dict:
    """Decompose a CostBreakdown into the Fig.-1 stacked bars.

    Write energy splits into *programming* (thermal hold) and *calibration*
    (the C-loop weight-current search; the paper attributes ~33.3% of total
    energy to the nonlinear mapping, which pins calibration_fraction ~ 0.5 of
    the write phase for the no-reuse MLP-Mixer workload).  Compute energy
    splits by the Table-1 static powers of the data-path components.

    ``meter_report`` (a ``PhotonicMeter.report()`` dict) upgrades the static
    split to a MEASURED one: when the served trace actually ran a
    calibration loop, its calibration share of the write ledger
    (``calibration_writes / bank_writes``) replaces the 0.5 prior.  A report
    with no writes (or one predating the calibration counters) falls back
    to the static fraction, so pre-calibration callers see identical output.
    """
    if meter_report is not None and meter_report.get("bank_writes", 0) > 0 \
            and "calibration_writes" in meter_report:
        calibration_fraction = (meter_report["calibration_writes"]
                                / meter_report["bank_writes"])
    prog = cost.write_energy_uJ * (1.0 - calibration_fraction)
    calib = cost.write_energy_uJ * calibration_fraction
    # data-path split proportional to component power draw
    p = {"laser+modulator": comp.modulator_driver_w * 8,  # 8 WDM channels
         "adc": comp.adc_w, "dac": comp.dac_w}
    tot_p = sum(p.values())
    comp_split = {k: cost.compute_energy_uJ * v / tot_p for k, v in p.items()}
    out = {"programming": prog, "calibration": calib}
    out.update(comp_split)
    out["total"] = cost.energy_uJ
    return out


# ----------------------------------------------- GPU-side roofline helpers
def roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float,
                   chips: int, spec: GPUSpec = H100) -> dict:
    t_comp = flops / (chips * spec.peak_flops_bf16)
    t_mem = hbm_bytes / (chips * spec.hbm_bw)
    t_coll = coll_bytes / (chips * spec.nvlink_bw)
    terms = {"t_compute_s": t_comp, "t_memory_s": t_mem,
             "t_collective_s": t_coll}
    dom = max(terms, key=terms.get)
    bound = max(t_comp, t_mem, t_coll)
    terms["dominant"] = dom
    terms["roofline_fraction"] = (t_comp / bound) if bound > 0 else 0.0
    return terms
