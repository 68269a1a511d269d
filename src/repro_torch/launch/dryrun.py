"""Dry-run: walk every (arch x shape x mesh) cell per rank on meta tensors
(port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell's real step for the production
mesh and reads memory, cost and the collective schedule from XLA.  The
port has no compiler to ask.  Instead it takes one rank of the mesh, binds
a census mesh to its coordinates (``launch.mesh.census_mesh``: no process
group), builds that rank's inputs as meta tensors (shape and dtype, no
memory) and runs the same Python step the rank would run, once, under the
census of ``launch/analysis.py``.  Nothing is allocated and no card, no
process group and no JAX is needed: a cell at the width of a 123 B model
on a 512-rank mesh walks on a laptop's CPU.

  * "lowering" builds the rank's inputs: its parameters (a train cell:
    ``trainer.param_specs``, the pieces of ``partition.tree_pspecs`` under
    ``cfg.fsdp``, "model" entries included; a serving cell: their data-axes
    part, whole otherwise), Adam state, the global batch (every
    rank passes it, as the Program's methods take it) and, for decode, its
    pieces of the caches under ``partition.cache_pspecs`` (its rows, and
    its KV heads or its block of the positions, its latent positions, its
    SSM heads and conv channels), as a prefill makes them too.
    ``--no-compile`` stops here (``"lowered"``);
  * "compiling" is the walk: aten ops, FLOPs, modelled HBM traffic, the
    peak of live bytes, every collective with its bytes, and each kernel's
    planned calls (``kernels/planned.py``; no launch counter moves).

The steps are the port's: ``trainer.make_train_step`` (remat, the
reference's microbatch rule), ``api.prefill_step_fn`` and
``api.decode_step_fn``.  ``--act-mode seq|hidden`` cuts the residual of
the train and prefill cells over "model" as the reference's rules give its
spec (``rank_step``); decode cells keep it whole.  A rank whose
parameters are FSDP pieces gathers them where they are used, as
``api.Program`` and the train step do (``Backend.fsdp``,
``sharding/fsdp.py``: each block of a stack where it runs, again where a
train step's backward recomputes it, its gradient reduce-scattered), so
the census counts those collectives and the peak holds one block gathered
at a time.  The port's scalar decode position is a Python int; the walk
passes the cache's last position.

Memory, per rank: ``argument_size_in_bytes`` (the inputs), ``output_size_
in_bytes`` (returned storages that are not inputs: in-place cache updates
count as inputs), ``temp_size_in_bytes`` (the peak of live bytes less both)
and ``per_device_total_gb``, their sum: the peak of live bytes, what
``torch.cuda.max_memory_allocated`` reads for the same step on the card.

Usage:
  python -m repro_torch.launch.dryrun --arch minitron-4b --shape decode_32k
  python -m repro_torch.launch.dryrun --all --reuse --out build/dryrun.json
  python -m repro_torch.launch.dryrun --all --reuse --mesh-shape 1x1
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from repro_torch import api, graphs
from repro_torch.configs import (ARCHS, SHAPES, get_arch, input_specs,
                                 shape_supported)
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.core import backend as backend_lib
from repro_torch.core import obu
from repro_torch.core.costmodel import H100, roofline_terms
from repro_torch.device import torch_dtype
from repro_torch.kernels import planned
from repro_torch.launch import analysis
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
from repro_torch.sharding import collectives as coll
from repro_torch.sharding import fsdp as fsdp_lib
from repro_torch.sharding import partition
from repro_torch.train import trainer

SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


# =========================================================================
# active-parameter count (MODEL_FLOPS numerator)
# =========================================================================
def _paths(tree, keys=()):
    """(keys, leaf) of every leaf, dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], keys + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, keys + (f"[{i}]",))
    elif tree is not None:
        yield keys, tree


def active_param_count(cfg: ModelConfig) -> dict:
    """Logical (per-token-pass) parameter count: shared stacks count every
    reuse; MoE expert tensors count top_k/E; embedding table excluded,
    lm_head included."""
    logical = dataclasses.replace(cfg, reuse=None)  # reuse => logical depth
    moe = cfg.moe
    enc = dec = 0
    for keys, leaf in _paths(tfm.abstract_params(logical)):
        if keys[0] == "embed":
            continue
        n = int(np.prod(leaf.shape))
        # routed-expert tensors carry an E dim at -3 (stacked: [R, E, d, f])
        if ("ffn" in keys and moe is not None and leaf.ndim >= 3
                and leaf.shape[-3] == moe.num_experts
                and keys[-1] in ("w_gate", "w_up", "w_down")):
            n = int(n * moe.top_k / moe.num_experts)
        if len(keys) > 1 and keys[1] == "enc":
            enc += n
        else:
            dec += n
    if cfg.tie_embeddings:
        dec += cfg.padded_vocab * cfg.d_model      # lm_head matmul still runs
    return {"decoder": dec, "encoder": enc}


def total_param_count(cfg: ModelConfig) -> int:
    return int(sum(np.prod(leaf.shape)
                   for _, leaf in _paths(tfm.abstract_params(cfg))))


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    act = active_param_count(cfg)
    B = shape.global_batch
    toks_dec = B * (1 if shape.kind == "decode" else shape.seq_len)
    # encoder runs during train/prefill only (decode reuses the cached memory)
    toks_enc = (B * cfg.audio.num_frames
                if cfg.family == "audio" and shape.kind != "decode" else 0)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * (act["decoder"] * toks_dec + act["encoder"] * toks_enc)


def microbatches(cfg: ModelConfig) -> int:
    """The reference's microbatch rule (grad accumulation by model
    scale)."""
    n_params = total_param_count(cfg)
    return 8 if n_params >= 10e9 else (4 if n_params >= 2e9 else 1)


def _metrics_block(planned_calls=None) -> dict:
    """The walk's planned calls per kernel (the reference's compiled-in
    kernel variants) and the CUDA-graph capture ledger (its retrace
    ledger)."""
    return {"kernel_calls": dict(planned_calls or {}),
            "capture_counts": dict(graphs.CAPTURE_COUNTS)}


# =========================================================================
# walking one cell
# =========================================================================
def _compute_dtype(tree, cfg: ModelConfig):
    dt = torch_dtype(cfg.compute_dtype)
    return adamw.tree_map(
        lambda t: t.to(dt) if t.dtype == torch.float32 else t, tree)


def _spec_leaves(specs):
    if isinstance(specs, dict):
        for v in specs.values():
            yield from _spec_leaves(v)
    else:
        yield specs


def rank_step(cfg: ModelConfig, shape: ShapeConfig, mesh, *, params=None,
              batch=None, legacy_decode=False, noise=None, microbatch=None,
              act_mode="replicated", result=None):
    """(run, arguments): the step a rank of ``mesh`` (bound: a census
    mesh, or a rank's from ``launch.mesh.init_ranks``) runs for the cell,
    as a thunk over its inputs.  ``params`` (the whole float32 tree) and
    ``batch`` default to meta tensors (``abstract_params``,
    ``input_specs``); given real ones, the thunk runs the same step on
    them (the tests hold a census walk to a gloo run that way).
    ``act_mode`` "seq" / "hidden" cuts the residual of a train or prefill
    step over "model" (the reference's ``act_pspec(mesh, act_mode)``, its
    batch entry None where the batch does not divide the data axes); a
    decode step keeps it whole.  A train step's rank holds the "model"
    pieces of its parameters and Adam state (``trainer.param_specs``); a
    serving step's, the data-axes part of them, gathered where the step
    uses them (``Backend.fsdp``)."""
    B, S = shape.global_batch, shape.seq_len
    active = mesh.size > 1
    result = {} if result is None else result
    pspecs = trainer.param_specs(cfg, mesh)
    if shape.kind != "train":
        pspecs = partition.data_specs(pspecs, mesh)
    if params is None:
        params = tfm.abstract_params(cfg)
    local = partition.local_tree(params, pspecs, mesh)
    if batch is None:
        batch = input_specs(cfg, shape)["batch"]
    device = api._device_of(params)
    if shape.kind == "train":
        mb = microbatch or microbatches(cfg)
        result["microbatch"] = mb
        apspec = (partition.act_pspec(mesh, act_mode)
                  if active and act_mode != "replicated" else None)
        step = trainer.make_train_step(cfg, TrainConfig(microbatch=mb),
                                       act_pspec=apspec, remat=True,
                                       mesh=mesh if active else None)
        opt = adamw.init(local)
        return (lambda: step(local, opt, batch)), (local, opt, batch)

    params = _compute_dtype(local, cfg)
    bk = backend_lib.resolve(cfg)
    if noise is not None:
        bk = dataclasses.replace(bk, noise=noise)
    if active:
        bk = dataclasses.replace(bk, mesh=mesh)
    apspec = api._serve_act_pspec(bk, B) if active else None
    if active and act_mode != "replicated" and shape.kind == "prefill":
        apspec = api._act_pspec_of(bk, B, act_mode)
    if active and any(partition.cuts(spec) for spec in _spec_leaves(pspecs)):
        bk = dataclasses.replace(bk, fsdp=fsdp_lib.Layout(pspecs, mesh))

    if shape.kind == "prefill":
        fn = api.prefill_step_fn(cfg, S, act_pspec=apspec, execution=bk)
        return (lambda: fn(params, batch)), (params, batch)
    caches = tfm.init_caches(cfg, B, S,
                             dtype=torch_dtype(cfg.compute_dtype),
                             device=device, mesh=mesh if active else None)
    fn = api.decode_step_fn(cfg, act_pspec=apspec,
                            legacy_decode=legacy_decode, execution=bk)
    return (lambda: fn(params, batch, caches, S - 1)), (params, batch,
                                                        caches)


def walk(cfg: ModelConfig, shape: ShapeConfig, mesh, *, compile_=True,
         legacy_decode=False, noise=None, microbatch=None, rank=0,
         act_mode="replicated", result=None) -> dict:
    """Lower and walk one cell on one rank (module docstring): ``cfg`` and
    ``shape`` objects at any size, ``mesh`` a mesh spec (``"DxM"``, a
    tuple or a ``launch.mesh.Mesh``) bound here to rank ``rank``.
    ``microbatch`` overrides the reference's rule for a train step;
    ``noise`` a ``NoiseConfig`` for a photonic inference step.  Returns
    the result dict (``result``'s keys kept).  ``act_mode``: the
    residual's placement (:func:`rank_step`)."""
    result = {} if result is None else result
    mesh = mesh_lib.census_mesh(mesh, rank)
    chips = mesh.size
    result["mesh"] = dict(mesh.shape)
    report = partition.PartitionReport(dropped=[])
    shapes = tfm.abstract_params(cfg)
    partition.param_shardings(shapes, partition.model_specs(shapes), mesh,
                              cfg.fsdp, report)
    t0 = time.time()
    run, args = rank_step(cfg, shape, mesh, legacy_decode=legacy_decode,
                          noise=noise, microbatch=microbatch,
                          act_mode=act_mode, result=result)
    result["lower_s"] = round(time.time() - t0, 2)
    if not compile_:
        result["metrics"] = _metrics_block()
        result["status"] = "lowered"
        return result

    from torch.utils.flop_counter import FlopCounterMode
    excl = (cfg.d_model, cfg.padded_vocab, cfg.d_ff,
            cfg.num_heads * (cfg.head_dim or 0))
    census = analysis.OpCensus(seq_len=shape.seq_len, score_exclude=excl)
    calls0 = planned.snapshot()
    t1 = time.time()
    with coll.recording() as records, \
            FlopCounterMode(display=False) as flops, census:
        census.arguments(args)
        out = run()
        out_bytes = census.outputs(out)
    result["compile_s"] = round(time.time() - t1, 2)
    calls = {k: v - calls0[k] for k, v in planned.snapshot().items()}
    kernel_ops, kernel_bytes = census.planned_totals()
    del out

    result["dropped_rules"] = [f"{a}:{d}" for a, d, _ in report.dropped[:8]]
    if report.dropped:
        result["dropped_rules_summary"] = partition.dropped_summary(report)
    arg = census.argument_bytes
    temp = max(census.peak - arg - out_bytes, 0)
    result["memory"] = {"argument_size_in_bytes": int(arg),
                        "output_size_in_bytes": int(out_bytes),
                        "temp_size_in_bytes": int(temp),
                        "per_device_total_gb": round(
                            (arg + out_bytes + temp) / 1e9, 3)}
    result["fits_one_card"] = (arg + out_bytes + temp) <= H100.hbm_bytes
    # the rank's own numbers (the reference's per-device raw costs)
    result["census_flops"] = float(flops.get_total_flops() + kernel_ops)
    result["census_ops"] = census.ops
    traffic_dev = census.traffic + kernel_bytes
    score_dev = census.score_traffic
    result["collectives"] = analysis.collective_census(records)
    acost = analysis.analytic_cost(cfg, shape, active_param_count(cfg),
                                   total_param_count(cfg))
    result["analytic"] = {"matmul_flops": acost.matmul_flops,
                          "context_flops": acost.context_flops,
                          "overhead_flops": acost.overhead_flops,
                          "hbm_bytes_floor": acost.hbm_bytes,
                          "hbm_bytes_census": traffic_dev * chips,
                          "hbm_score_bytes_census": score_dev * chips}
    # ---- roofline on the H100 spec: analytic FLOPs, census traffic and
    # collectives (every rank taken to do this rank's work)
    spec = H100
    coll_total = result["collectives"]["total_bytes"]
    terms = roofline_terms(acost.total_flops, traffic_dev * chips,
                           coll_total * chips, chips, spec)
    terms["t_memory_floor_s"] = acost.hbm_bytes / (chips * spec.hbm_bw)
    # flash/SSD kernels keep the S^2 score buffers on chip
    terms["t_memory_kernelized_s"] = max(
        traffic_dev - score_dev, 0.0) * chips / (chips * spec.hbm_bw)
    bound_serial = (terms["t_compute_s"] + terms["t_memory_s"]
                    + terms["t_collective_s"])
    t_useful = acost.matmul_flops / (chips * spec.peak_flops_bf16)
    terms["mfu_overlapped"] = t_useful / max(
        terms["t_compute_s"], terms["t_memory_s"], terms["t_collective_s"])
    terms["mfu_serial"] = t_useful / bound_serial if bound_serial else 0.0
    bound_kern = (terms["t_compute_s"] + terms["t_memory_kernelized_s"]
                  + terms["t_collective_s"])
    terms["mfu_kernelized"] = (t_useful / bound_kern) if bound_kern else 0.0
    result["roofline"] = {k: (v if isinstance(v, str) else float(v))
                          for k, v in terms.items()}
    result["model_flops"] = acost.matmul_flops
    result["useful_flops_ratio"] = (acost.matmul_flops / acost.total_flops
                                    if acost.total_flops > 0 else 0.0)
    result["metrics"] = _metrics_block(calls)
    result["status"] = "ok"
    return result


def lower_cell(arch: str, shape_name: str, *, multi_pod=False, reuse=False,
               mesh_shape=None, compile_=True, extra_tag="",
               legacy_decode=False, act_mode="replicated",
               fp32_accum=False, execution="xla", noise=None):
    """One grid cell with the reference's signature, statuses and SKIP
    rules, walked on rank 0 of the production mesh (16x16, or 2x16x16
    with ``multi_pod``) or of ``mesh_shape``.  ``fp32_accum`` sets
    ``obu.set_matmul_accum_fp32`` for the walk (restored after)."""
    cfg = get_arch(arch, reuse=reuse)
    if execution != "xla":
        cfg = dataclasses.replace(cfg, execution=execution)
    shape = SHAPES[shape_name]
    ok, why = shape_supported(cfg, shape)
    result = {"arch": arch, "shape": shape_name, "reuse": reuse,
              "multi_pod": multi_pod, "tag": extra_tag,
              "execution": execution}
    if not ok:
        result["status"] = why
        return result
    if execution == "photonic" and shape.kind == "train":
        # the photonic kernels carry no gradient: inference-only backend
        result["status"] = "SKIP(photonic: inference-only backend)"
        return result
    ncfg = None
    if noise is not None:
        if execution != "photonic":
            result["status"] = "SKIP(--noise needs --execution photonic)"
            return result
        from repro_torch.core.noise import NoiseConfig
        ncfg = (NoiseConfig.parse(noise) if isinstance(noise, str)
                else noise)
        result["noise"] = repr(ncfg)
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    mesh = mesh_lib.parse_mesh(mesh_shape)
    if ncfg is not None and mesh.size > 1:
        result["status"] = "SKIP(--noise is single-device; use " \
                           "--mesh-shape 1x1)"
        return result
    if act_mode != "replicated":
        result["act_mode"] = act_mode
    prev = obu._ACCUM_FP32
    obu.set_matmul_accum_fp32(fp32_accum)
    try:
        return walk(cfg, shape, mesh, compile_=compile_,
                    legacy_decode=legacy_decode, noise=ncfg,
                    act_mode=act_mode, result=result)
    finally:
        obu.set_matmul_accum_fp32(prev)


# =========================================================================
def all_cells():
    for arch in sorted(ARCHS):
        for shape in SHAPE_NAMES:
            yield arch, shape


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--reuse", action="store_true",
                    help="use the R&B (PRM-shared) variant of the arch")
    ap.add_argument("--mesh-shape", default=None,
                    help="e.g. 1x1, 2x4 or 2x16x16 (default: the production "
                         "mesh, 16x16 or 2x16x16 with --multipod)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=None, help="write JSON here")
    ap.add_argument("--no-compile", action="store_true",
                    help="build the rank's inputs only (status 'lowered')")
    ap.add_argument("--decode-legacy", action="store_true",
                    help="baseline decode path (attention over the whole "
                         "buffer at a scalar position)")
    ap.add_argument("--act-mode", default="replicated",
                    choices=["seq", "hidden", "replicated"],
                    help="residual-stream sharding of the train and "
                         "prefill cells: the positions ('seq') or the "
                         "channels ('hidden') over 'model', or whole rows")
    ap.add_argument("--fp32-accum", action="store_true",
                    help="float32 blend_dot products "
                         "(obu.set_matmul_accum_fp32)")
    ap.add_argument("--execution", default="xla",
                    choices=["xla", "photonic"],
                    help="matmul substrate: torch matmuls or the W8A8 "
                         "photonic kernels (inference shapes only)")
    ap.add_argument("--noise", default=None,
                    help="photonic fault model spec (core/noise.py), e.g. "
                         "'gain=0.01,drift=0.05,age=1e6'; photonic + "
                         "--mesh-shape 1x1 only")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    mesh_shape = (tuple(int(x) for x in args.mesh_shape.split("x"))
                  if args.mesh_shape else None)
    cells = (list(all_cells()) if args.all
             else [(args.arch, args.shape)])
    results = []
    for arch, shape in cells:
        try:
            r = lower_cell(arch, shape, multi_pod=args.multipod,
                           reuse=args.reuse, mesh_shape=mesh_shape,
                           compile_=not args.no_compile, extra_tag=args.tag,
                           legacy_decode=args.decode_legacy,
                           act_mode=args.act_mode,
                           fp32_accum=args.fp32_accum,
                           execution=args.execution, noise=args.noise)
        except Exception as e:
            r = {"arch": arch, "shape": shape, "status": "FAIL",
                 "error": f"{type(e).__name__}: {e}"[:500]}
        results.append(r)
        rl = r.get("roofline", {})
        mem = r.get("memory", {})
        print(f"[{r['status']:>4s}] {arch:25s} {shape:12s} "
              f"mesh={r.get('mesh')} "
              f"gb={mem.get('per_device_total_gb', 0)} "
              f"comp={rl.get('t_compute_s', 0):.2e}s "
              f"mem={rl.get('t_memory_s', 0):.2e}s "
              f"coll={rl.get('t_collective_s', 0):.2e}s "
              f"dom={rl.get('dominant', '-')} "
              f"mfu={rl.get('mfu_serial', 0):.2f} "
              f"(lower {r.get('lower_s', 0)}s walk {r.get('compile_s', 0)}s)",
              flush=True)
        if r["status"] == "FAIL":
            print("   error:", r["error"][:300], flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    bad = [r for r in results if r["status"] == "FAIL"]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
