"""The paper's tables and Fig. 1 on the port (port of ``benchmarks/run.py``'s
``bench_table2`` .. ``bench_fig1``).

    python -m repro_torch.paper_run [--quick] [--only NAME] [--device DEV]

Prints ``name,us_per_call,derived`` CSV rows, where ``derived`` carries
the table's headline quantity, then each table's details; the details go
to ``results/torch_bench_details.json`` (never the reference's file).
Each ``bench_*`` function returns a :class:`Bench` (its row and details).

Tables 2, 3 and Fig. 1 are the calibrated cost model (host arithmetic).
Tables 4 and 5 build the paper's models from a CPU ``torch.Generator``
seeded as the reference keys them (so every device trains the same
initial weights), move them to ``device`` and train the MLPs and Mixers
there on the synthetic vision task (``vision_task``): 120 steps of batch
64, or 60 with ``--quick``.  VGG-13 and ResNet-18 get their parameter and
energy columns only, as in the reference.  ``--device`` defaults to
``cuda`` and raises without a GPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time

import torch

TABLE3_PAPER = {64: (217190, 35.70, 77490, 12.50),
                256: (54297, 9.68, 20197, 3.35),
                1024: (13574, 3.17, 5874, 1.06)}
MIXER_TRANSFORMS = ("identity", "shuffle", "transpose", "shuffle")


@dataclasses.dataclass
class Bench:
    name: str
    us_per_call: float
    derived: str
    details: object

    def row(self) -> str:
        return f"{self.name},{self.us_per_call:.1f},{self.derived}"


def timed(fn, *args, reps=3, **kw):
    t0 = time.time()
    out = None
    for _ in range(reps):
        out = fn(*args, **kw)
    return out, (time.time() - t0) / reps * 1e6


# ======================================================================
def bench_table2() -> Bench:
    """Hardware cost / feature comparison formulas (paper Table 2)."""
    from repro_torch.core.costmodel import table2_row
    sweep = [(K, C, N, B) for K in (1, 8, 64) for C in (1, 4, 16)
             for N in (256, 1024) for B in (16,)]

    def run():
        out = []
        for K, C, N, B in sweep:
            r = {m: table2_row(m, M=N, N=N, K=K, C=C, B=B, beta_t=2.0)
                 for m in ("mzi", "crosslight", "holylight", "ours")}
            out.append(((K, C, N, B), r))
        return out

    table, us = timed(run)
    # headline: ours/holylight programming ratio at the largest scale point
    (K, C, N, B), r = table[-1]
    ratio = r["ours"]["programming_times"] / max(
        r["holylight"]["programming_times"], 1)
    details = [
        {"K": k, "C": c, "N": n, "B": b,
         **{f"{m}_{q}": v[m][q] for m in v for q in
            ("programming_times", "latency", "power")}}
        for (k, c, n, b), v in table]
    return Bench("table2_hw_cost", us,
                 f"ours/holylight programming ratio @K={K} C={C}: "
                 f"{ratio:.2e}", details)


def bench_table3() -> Bench:
    """Energy/delay, 8x(256x256) matrices, tiles {64,256,1024} (Table 3)."""
    from repro_torch.core.costmodel import matrix_cost

    def run():
        out = {}
        for tile in TABLE3_PAPER:
            no = matrix_cost(256, 256, tile, programs=8, passes=8)
            re = matrix_cost(256, 256, tile, programs=1, passes=8)
            out[tile] = (no.delay_ns, no.energy_uJ, re.delay_ns, re.energy_uJ)
        return out

    got, us = timed(run)
    errs = []
    det = []
    for tile, want in TABLE3_PAPER.items():
        g = got[tile]
        for gv, wv in zip(g, want):
            errs.append(abs(gv - wv) / wv)
        det.append({"tile": tile,
                    "delay_no_reuse_ns": g[0], "energy_no_reuse_uJ": g[1],
                    "delay_reuse_ns": g[2], "energy_reuse_uJ": g[3],
                    "paper": want,
                    "energy_saving": 1 - g[3] / g[1],
                    "latency_saving": 1 - g[2] / g[0]})
    return Bench("table3_energy_delay", us,
                 f"max rel err vs paper: {max(errs):.4%}; "
                 f"latency saving @1024: {det[-1]['latency_saving']:.1%}; "
                 f"energy saving: {det[-1]['energy_saving']:.1%}", det)


def table4_variants():
    """(model, arc, config) of every Table 4 row, in the reference's order."""
    from repro_torch.core.prm import ReuseConfig
    from repro_torch.models import paper_models as pm
    return [
        ("MLP", "baseline", pm.MLPConfig()),
        ("MLP", "layer-wise 1x6", pm.MLPConfig(reuse=ReuseConfig(
            num_basic=1, reuse_times=6,
            transforms=("identity", "shuffle", "transpose")))),
        ("MLP-Mixer", "baseline", pm.MixerConfig()),
        ("MLP-Mixer", "block-wise 1x8", pm.MixerConfig(reuse=ReuseConfig(
            num_basic=1, reuse_times=8, transforms=MIXER_TRANSFORMS))),
        ("MLP-Mixer", "block-wise 2x4", pm.MixerConfig(reuse=ReuseConfig(
            num_basic=2, reuse_times=4, transforms=MIXER_TRANSFORMS))),
        ("VGG-13", "baseline", pm.VGGConfig()),
        ("VGG-13", "layer-wise shared", pm.VGGConfig(share_same_shape=True)),
        ("ResNet-18", "baseline", pm.ResNetConfig()),
        ("ResNet-18", "stage shared",
         pm.ResNetConfig(share_within_stage=True)),
    ]


def build(cfg, seed: int = 0, device=None):
    """(params, shared, forward) of ``cfg``'s model, drawn from a CPU
    generator seeded ``seed`` and moved to ``device`` (None: the card, or
    raise); ``shared`` and ``forward`` are None for the conv models (not
    trained, as in the reference)."""
    from repro_torch.device import resolve_device
    from repro_torch.models import paper_models as pm
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    if isinstance(cfg, pm.MLPConfig):
        p, sh = pm.mlp_init(gen, cfg)
        fwd = lambda pp, x, c=cfg, s=sh: pm.mlp_forward(       # noqa: E731
            pp, c, s, x.reshape(x.shape[0], -1)[:, :784])
    elif isinstance(cfg, pm.MixerConfig):
        p, sh = pm.mixer_init(gen, cfg)
        fwd = lambda pp, x, c=cfg, s=sh: pm.mixer_forward(     # noqa: E731
            pp, c, s, x)
    elif isinstance(cfg, pm.VGGConfig):
        p, sh, fwd = pm.vgg13_init(gen, cfg), None, None
    else:
        p, sh, fwd = pm.resnet18_init(gen, cfg), None, None
    return pm.to_device(p, device), sh, fwd


def cost_columns(cfg, params, shared) -> tuple:
    """(params_M, energy_uJ) of a Table 4 row, as the reference rounds
    them; ResNet-18 has no energy column."""
    from repro_torch.core.costmodel import ZERO_COST, matrix_cost, stack_cost
    from repro_torch.models import paper_models as pm
    n = pm.param_count(params)
    if isinstance(cfg, pm.MLPConfig):
        cost = stack_cost(pm.mlp_weight_shapes(cfg), shared.plan, tile=8)
    elif isinstance(cfg, pm.MixerConfig):
        cost = stack_cost(pm.mixer_weight_shapes(cfg), shared.plan, tile=8)
    elif isinstance(cfg, pm.VGGConfig):
        shapes, programs = pm.vgg13_weight_shapes(cfg, cfg.share_same_shape)
        cost = ZERO_COST
        for (r, c), prog in zip(shapes, programs):
            cost = cost + matrix_cost(r, c, 8, programs=prog, passes=1)
        return round(n / 1e6, 2), round(cost.energy_uJ, 2)
    else:
        return round(n / 1e6, 2), None
    return round(n / 1e6, 3), round(cost.energy_uJ, 2)


def bench_table4(quick=False, device=None) -> Bench:
    """R&B performance across models: params, energy, accuracy (Table 4).

    Param/energy columns are exact (the models + the calibrated cost
    model); accuracy uses the synthetic vision proxy (no CIFAR offline).
    Each trained row also carries its first and last loss and whether
    every loss was finite."""
    from repro_torch.device import resolve_device
    from repro_torch.vision_task import train_classifier
    dev = resolve_device(device)
    steps = 60 if quick else 120
    t0 = time.time()
    det = []
    for model, arc, cfg in table4_variants():
        p, sh, fwd = build(cfg, device=dev)
        params_m, energy = cost_columns(cfg, p, sh)
        row = {"model": model, "arc": arc, "params_M": params_m,
               "energy_uJ": energy, "acc_proxy": None}
        if fwd is not None:
            losses: list = []
            _, acc = train_classifier(fwd, p, steps=steps, batch_size=64,
                                      device=dev, losses=losses)
            row.update(acc_proxy=round(acc, 3), loss_first=losses[0],
                       loss_last=losses[-1],
                       losses_finite=all(map(math.isfinite, losses)))
        det.append(row)
    us = (time.time() - t0) * 1e6
    mixer_base = next(d for d in det if d["model"] == "MLP-Mixer"
                      and d["arc"] == "baseline")
    mixer_24 = next(d for d in det if d["arc"] == "block-wise 2x4")
    e_save = 1 - mixer_24["energy_uJ"] / mixer_base["energy_uJ"]
    p_save = 1 - mixer_24["params_M"] / mixer_base["params_M"]
    acc_drop = mixer_base["acc_proxy"] - mixer_24["acc_proxy"]
    return Bench("table4_rb_performance", us,
                 f"mixer 2x4: params -{p_save:.0%} energy -{e_save:.0%} "
                 f"acc_drop {acc_drop:+.3f} (paper: >=34% params, ~69% "
                 f"energy, <1% acc)", det)


def table5_variants():
    """(method, ReuseConfig) of every Table 5 row (Mixer 2 x 4)."""
    from repro_torch.core.prm import ReuseConfig
    return [
        ("baseline(no reuse)", None),
        ("reuse only", ReuseConfig(num_basic=2, reuse_times=4,
                                   transforms=("identity",))),
        ("reuse+shuffle", ReuseConfig(num_basic=2, reuse_times=4,
                                      transforms=("identity", "shuffle"))),
        ("reuse+transpose", ReuseConfig(num_basic=2, reuse_times=4,
                                        transforms=("identity",
                                                    "transpose"))),
        ("reuse+shuffle+transpose", ReuseConfig(
            num_basic=2, reuse_times=4,
            transforms=("identity", "shuffle", "transpose",
                        "shuffle_transpose"))),
    ]


def bench_table5(quick=False, device=None) -> Bench:
    """OBU ablation on the synthetic vision task (Table 5)."""
    from repro_torch.device import resolve_device
    from repro_torch.models import paper_models as pm
    from repro_torch.vision_task import train_classifier
    dev = resolve_device(device)
    steps = 60 if quick else 120
    t0 = time.time()
    det = []
    for tag, rc in table5_variants():
        p, _, fwd = build(pm.MixerConfig(blocks=8, reuse=rc), device=dev)
        losses: list = []
        _, acc = train_classifier(fwd, p, steps=steps, batch_size=64,
                                  device=dev, losses=losses)
        det.append({"method": tag, "acc_proxy": round(acc, 3),
                    "params": pm.param_count(p), "loss_first": losses[0],
                    "loss_last": losses[-1],
                    "losses_finite": all(map(math.isfinite, losses))})
    us = (time.time() - t0) * 1e6
    base = det[0]["acc_proxy"]
    ro = det[1]["acc_proxy"]
    best_blend = max(d["acc_proxy"] for d in det[2:])
    return Bench("table5_obu_ablation", us,
                 f"reuse-only {ro:.3f} vs +blend best {best_blend:.3f} "
                 f"(baseline {base:.3f}); blend recovers "
                 f"{best_blend - ro:+.3f} (paper: +3.16% shuffle)", det)


def bench_fig1() -> Bench:
    """Energy-consumption breakdown: no-sharing vs R&B (paper Fig. 1)."""
    from repro_torch.core.costmodel import (baseline_stack_cost,
                                            energy_breakdown, stack_cost)
    from repro_torch.core.prm import ReuseConfig, ReusePlan
    from repro_torch.models import paper_models as pm

    shapes = pm.mixer_weight_shapes(pm.MixerConfig())

    def run():
        plan_rb = ReusePlan.build(8, ReuseConfig(num_basic=2, reuse_times=4))
        base = baseline_stack_cost(shapes, 8, tile=8)
        rb = stack_cost(shapes, plan_rb, tile=8)
        return (energy_breakdown(base), energy_breakdown(rb))

    (b, r), us = timed(run)
    write_frac = (b["programming"] + b["calibration"]) / b["total"]
    save = 1 - r["total"] / b["total"]
    return Bench("fig1_energy_breakdown", us,
                 f"write-phase fraction {write_frac:.0%} of baseline energy; "
                 f"R&B total saving {save:.0%}",
                 {"no_sharing": b, "rb": r})


# ======================================================================
def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device of Tables 4/5 (default cuda)")
    args = ap.parse_args(argv)
    from repro_torch.device import resolve_device
    dev = resolve_device(args.device)
    # the reference computes in float32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    benches = {
        "table2": bench_table2,
        "table3": bench_table3,
        "table4": lambda: bench_table4(args.quick, dev),
        "table5": lambda: bench_table5(args.quick, dev),
        "fig1": bench_fig1,
    }
    if args.only is not None and args.only not in benches:
        ap.error(f"--only: one of {sorted(benches)}")
    print("name,us_per_call,derived")
    details = {}
    for name, fn in benches.items():
        if args.only and args.only != name:
            continue
        b = fn()
        print(b.row(), flush=True)
        details[name] = b.details
    os.makedirs("results", exist_ok=True)
    with open("results/torch_bench_details.json", "w") as f:
        json.dump(details, f, indent=1, default=str)
    print("\n# details written to results/torch_bench_details.json")
    for name, rows in details.items():
        print(f"\n## {name}")
        if isinstance(rows, list):
            for r in rows[:44]:
                print("  ", r)
        else:
            print("  ", rows)


if __name__ == "__main__":
    main()
