"""Serving driver: compile-once Program + continuous-batching scheduler
(port of ``repro.launch.serve``).

The model is built into ONE :class:`repro_torch.api.Program` (backend
resolved, photonic weight banks prepared at build time) and every
scheduler serves from it: no per-request backend resolution or weight
re-quantization.

On the CPU (the plain PyTorch versions of the kernels):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \\
      --smoke --device cpu --requests 12 --max-prompt 32 --new-tokens 16

On a CUDA device (the default ``--device cuda``; it raises without one):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch minitron-4b \\
      --reuse --requests 12 --max-prompt 1024 --new-tokens 32 --stats

``--scheduler`` picks the serving path:
  continuous  slot-level continuous batching (default; serve/scheduler.py)
  wave        static aligned waves (fallback; serve/batcher.py)
  engine      one aligned batch straight through Program.generate
``--execution`` picks the matmul substrate (xla | photonic).  ``--mesh``
picks the execution mesh: ``auto`` the largest (data, model) mesh over the
available devices (``launch/mesh.py``), ``DxM`` (e.g. ``1x2``) a given
one.  A mesh of more than one position spawns its ranks
(``launch.mesh.init_ranks``; ranks share the card when there are more
ranks than cards): every rank builds the Program on its mesh and serves
the same trace, and rank 0 prints the report.  The continuous scheduler's
capacity rounds up to divide over the data shards.

``main`` parses the flags, builds the Program (:func:`build_program`) and
serves the trace (:func:`serve`), so a caller can drain the same Program
with telemetry on and off.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import time
import warnings

import numpy as np
import torch

from repro_torch.api import Program
from repro_torch.configs import get_arch, smoke_variant, stub_extras
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as tfm
from repro_torch.obs import metrics as metrics_lib
from repro_torch.obs.serving import ServingObs
from repro_torch.serve.batcher import Completion, Request, WaveBatcher
from repro_torch.serve.scheduler import ContinuousScheduler
from repro_torch.sharding import partition


def _request_extras(cfg, rid: int, device=None):
    """Seeded stub modality embeddings of request ``rid`` (a generator
    seeded ``100 + rid`` on ``device``), or None for families without a
    memory stream."""
    if cfg.family not in ("vlm", "audio"):
        return None
    gen = torch.Generator(device=device or "cuda").manual_seed(100 + rid)
    return stub_extras(cfg, 1, gen)


def _make_trace(cfg, n: int, max_prompt: int, max_new: int, seed: int = 0,
                device=None):
    """Mixed-length request trace (the realistic serving distribution):
    the reference's rids, prompts and ``max_new`` from the same numpy
    seed."""
    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(n):
        plen = int(rng.integers(max(2, max_prompt // 4), max_prompt + 1))
        mn = int(rng.integers(max(1, max_new // 4), max_new + 1))
        reqs.append(Request(
            rid=rid, prompt=rng.integers(1, cfg.vocab_size, plen
                                         ).astype(np.int32),
            max_new=mn, extras=_request_extras(cfg, rid, device)))
    return reqs


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--reuse", action="store_true")
    ap.add_argument("--scheduler", default="continuous",
                    choices=["continuous", "wave", "engine"])
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--capacity", type=int, default=4,
                    help="slot-pool capacity / wave size")
    ap.add_argument("--max-prompt", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--execution", default=None,
                    choices=["xla", "photonic"],
                    help="matmul substrate override (default: cfg.execution)")
    ap.add_argument("--mesh", default=None,
                    help="execution mesh: 'auto' (largest (data, model) "
                         "mesh from the available devices), 'DxM' (e.g. "
                         "1x2); ranks are spawned for it.  Default: none")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda, which "
                         "raises without a CUDA device; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--array-budget", type=int, default=0,
                    help="MRR array budget in 128x128-tile units for the "
                         "global bank residency manager "
                         "(repro_torch.resident): layers hybrid-map into "
                         "resident (stay programmed) vs streamed "
                         "(reprogram-per-pass) sets under the budget.  "
                         "0 = off (all banks statically resident, the "
                         "legacy accounting)")
    ap.add_argument("--noise", default=None,
                    help="photonic fault model (core/noise.py), e.g. "
                         "'gain=0.01,ct=0.002,dac=0.25,drift=0.05': per-tile"
                         " gain error, crosstalk, DAC noise, write-age "
                         "drift.  Photonic only; default off "
                         "(bit-identical clean path)")
    ap.add_argument("--calibrate-every", type=int, default=0,
                    help="decode steps between calibration read-back sweeps"
                         " (serve/calibration.py): stale resident banks are"
                         " re-programmed and billed as calibration writes. "
                         "0 = no calibration loop.  Needs --noise")
    ap.add_argument("--stale-threshold", type=float, default=0.01,
                    help="read-back gain error above which a bank is "
                         "re-programmed by the calibration loop")
    ap.add_argument("--stats", action="store_true",
                    help="enable telemetry: periodic stats line (TTFT/TPOT "
                         "p50/p95, slot occupancy, reuse ratio, write "
                         "energy saved) + final energy report")
    ap.add_argument("--stats-every", type=int, default=8,
                    help="scheduler steps between stats lines")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome-trace JSON (chrome://tracing) here")
    ap.add_argument("--metrics-out", default=None,
                    help="write the metrics JSON snapshot "
                         "(obs/metrics_schema.json shape) here")
    args = ap.parse_args(argv)
    if args.calibrate_every and not args.noise:
        raise SystemExit("--calibrate-every needs --noise (nothing drifts "
                         "on the clean path)")
    return args


def resolve_mesh(args):
    """The ``--mesh`` flag as a mesh (None without the flag)."""
    if not args.mesh:
        return None
    if args.mesh == "auto":
        devices = None if torch.device(args.device).type == "cuda" else 1
        return mesh_lib.make_mesh_auto(devices=devices)
    return mesh_lib.parse_mesh(args.mesh)


def build_program(args, mesh=None):
    """The config, random weights (seed 0) on ``args.device`` (on a mesh
    rank, the rank's device) and the Program built once from them, on
    ``mesh`` when given; a partition rule the mesh drops is printed as a
    warning.  Returns (cfg, program)."""
    cfg = smoke_variant(args.arch) if args.smoke else get_arch(
        args.arch, reuse=args.reuse)
    execution = args.execution
    if args.noise:
        from repro_torch.core import backend as backend_lib
        from repro_torch.core.noise import NoiseConfig
        noise_cfg = NoiseConfig.parse(args.noise)
        exec_name = args.execution or cfg.execution
        if exec_name != "photonic":
            raise SystemExit("--noise models the photonic substrate; pass "
                             "--execution photonic")
        execution = backend_lib.Backend("photonic", noise=noise_cfg)
        print(f"[serve] photonic fault model on: {noise_cfg}")
    device = args.device if mesh is None or not mesh.bound or \
        mesh.device is None else mesh.device
    params = tfm.init_model(cfg, seed=0, device=device)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        prog = Program.build(cfg, params, execution=execution,
                             device=device, mesh=mesh)
    del params
    for w in caught:
        print(f"[serve] WARNING {w.message}")
    if mesh is not None:
        print(f"[serve] execution mesh {mesh.shape} ({mesh.size} ranks"
              + (f", {mesh.describe()})" if mesh.size > 1 else ")"))
    if prog.backend.is_photonic:
        st = prog.bank_stats()
        print(f"[serve] photonic banks prepared once: "
              f"{st['programmed_tensors']} tensors, "
              f"{st['int8_bytes'] / 1e6:.2f} MB int8, "
              f"{st['mrr_tiles_128']} MRR tiles")
    return cfg, prog


def make_obs(cfg, args):
    """The telemetry bundle the flags ask for (one registry, tracer,
    request tracker and photonic meter), or None."""
    if args.stats or args.trace_out or args.metrics_out:
        return ServingObs.create(cfg, trace=bool(args.trace_out)
                                 or args.stats)
    return None


def _residency(prog, cfg, args, obs):
    """Global bank residency: bounded MRR array, hybrid layer mapping,
    cost-model eviction (repro_torch.resident)."""
    from repro_torch import resident
    from repro_torch.obs.meter import StackProfile
    specs = resident.specs_from_program(prog)
    if not specs:        # xla execution: no prepared bank: use the arch's
        specs = resident.specs_from_profile(    # stack profile
            StackProfile.from_cfg(cfg), prefix=cfg.name)
    plan = resident.plan_hybrid_mapping(specs, args.array_budget)
    manager = resident.BankResidencyManager(
        args.array_budget, registry=obs.registry if obs else None)
    residency = resident.ProgramResidency(manager, specs, plan=plan)
    print(f"[serve] residency: array budget {args.array_budget} "
          f"x128-tiles, {len(plan.resident)}/{len(specs)} banks "
          f"resident ({plan.used_tiles} tiles), hybrid-map est "
          f"E -{plan.energy_savings_frac:.1%} / "
          f"T -{plan.latency_savings_frac:.1%} vs stream-all")
    return residency


def _calibration(prog, args, obs, residency):
    """The calibration read-back loop over the resident banks (needs
    --noise for a drift source).  Returns (loop, residency)."""
    from repro_torch import resident
    from repro_torch.serve.calibration import CalibrationLoop
    if residency is None:
        # the loop verifies RESIDENT banks: with no --array-budget, bind
        # the Program's banks to an unbounded manager (everything
        # statically resident, the legacy accounting)
        specs = resident.specs_from_program(prog)
        manager = resident.BankResidencyManager(
            10 ** 9, registry=obs.registry if obs else None)
        residency = resident.ProgramResidency(manager, specs)
    loop = CalibrationLoop(
        prog, residency.manager, noise=prog.backend.noise,
        every_steps=args.calibrate_every,
        stale_threshold=args.stale_threshold,
        meter=obs.meter if obs else None,
        registry=obs.registry if obs else None)
    print(f"[serve] calibration loop: sweep every "
          f"{args.calibrate_every} steps, stale threshold "
          f"{args.stale_threshold}")
    return loop, residency


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type.upper()


def _serve_engine(prog, cfg, args) -> list[Completion]:
    """One aligned batch of ``--capacity`` rows of ``--max-prompt`` tokens
    (a numpy generator seeded 1) through ``Program.generate``."""
    prompt = np.random.default_rng(1).integers(
        1, cfg.vocab_size, (args.capacity, args.max_prompt)).astype(np.int32)
    extras = _request_extras(cfg, 0, prog.device)
    if extras:
        extras = {k: v.expand(args.capacity, *v.shape[1:])
                  for k, v in extras.items()}
    t0 = time.time()
    out = prog.generate(prompt, args.new_tokens, extras=extras,
                        temperature=args.temperature).cpu().numpy()
    dt = time.time() - t0
    n_new = args.capacity * args.new_tokens
    print(f"[serve/engine] {cfg.name}: {n_new} tokens in {dt:.2f}s "
          f"({n_new / dt:.1f} tok/s on {_device_name(prog.device)})")
    print("sample row:", out[0, :].tolist()[:48])
    return [Completion(rid=i, tokens=row.astype(np.int32),
                       prompt_len=args.max_prompt, padded_to=args.max_prompt)
            for i, row in enumerate(out)]


def serve(prog, args, obs=None) -> list[Completion]:
    """Serve the request trace of ``args`` from ``prog`` through the
    scheduler ``args.scheduler`` picks, with the telemetry bundle ``obs``
    (None: off; ``metrics.enable()`` for the run and ``disable()`` at its
    end when given), and print the reference's report.  Returns the
    completions sorted by rid."""
    cfg = prog.cfg
    if args.scheduler == "engine":
        return _serve_engine(prog, cfg, args)
    if obs is not None:
        metrics_lib.enable()
    try:
        return _serve_trace(prog, cfg, args, obs)
    finally:
        if obs is not None:
            metrics_lib.disable()


def _serve_trace(prog, cfg, args, obs) -> list[Completion]:
    residency = None
    if args.array_budget:
        residency = _residency(prog, cfg, args, obs)
        if args.scheduler != "continuous":
            print("[serve] WARNING --array-budget only drives the "
                  "continuous scheduler; ignoring")
            residency = None
    calibration = None
    if args.calibrate_every and args.scheduler == "continuous":
        calibration, residency = _calibration(prog, args, obs, residency)
    elif args.calibrate_every:
        print("[serve] WARNING --calibrate-every only drives the "
              "continuous scheduler; ignoring")

    reqs = _make_trace(cfg, args.requests, args.max_prompt, args.new_tokens,
                       device=prog.device)
    if args.scheduler == "wave":
        sched = WaveBatcher(prog, wave_size=args.capacity,
                            temperature=args.temperature, telemetry=obs)
    else:
        capacity = args.capacity
        if prog.backend.mesh_active:
            # one per-shard sub-batch per data shard: round capacity up
            dp = partition.dp_size(prog.mesh)
            capacity = -(-capacity // dp) * dp
            if capacity != args.capacity:
                print(f"[serve] capacity {args.capacity} -> {capacity} "
                      f"(divides over {dp} data shard(s))")
        sched = ContinuousScheduler(
            prog, capacity=capacity,
            max_len=args.max_prompt + args.new_tokens,
            temperature=args.temperature, telemetry=obs,
            residency=residency, calibration=calibration)
    for r in reqs:
        sched.submit(r)
    t0 = time.time()
    if args.scheduler == "continuous" and obs is not None and args.stats:
        # step-driven drain so the periodic stats line interleaves with
        # serving (the long-running-server view of the same loop)
        comps = []
        step_i = 0
        while sched.queue or sched.pool.num_active:
            comps.extend(sched.step())
            step_i += 1
            if step_i % max(1, args.stats_every) == 0:
                print(obs.stats_line(sched.stats, step=step_i))
    else:
        comps = sched.drain()
    dt = time.time() - t0
    st = sched.stats
    gen = st.generated_tokens
    print(f"[serve/{args.scheduler}] {cfg.name}: {len(comps)} requests, "
          f"{gen} new tokens in {dt:.2f}s ({gen / dt:.1f} tok/s on "
          f"{_device_name(prog.device)})")
    print(f"  slot-steps executed {st.slot_steps}, useful {st.useful_steps}, "
          f"overhead {st.overhead:.1%}")
    rr = residency.manager.report() if residency is not None else None
    if obs is not None:
        if args.stats:
            print(obs.stats_line(sched.stats))
            if obs.meter is not None:
                rep = obs.meter.report()
                print(f"  energy: {rep['bank_writes']} bank writes, "
                      f"{rep['matrix_passes']} matrix passes, "
                      f"reuse {rep['reuse_ratio']:.3f}, amortization "
                      f"{rep['amortization_passes_per_write']:.1f} "
                      f"passes/write, saved "
                      f"{rep['write_energy_saved_uJ']:.1f} uJ write energy "
                      f"(-{rep['energy_savings_frac']:.1%} E, "
                      f"-{rep['latency_savings_frac']:.1%} T vs "
                      f"reprogram-per-pass)")
            if rr is not None:
                print(f"  residency: hit rate {rr['hit_rate']:.3f} "
                      f"({rr['hits']}/{rr['hits'] + rr['misses']} lookups),"
                      f" {rr['evictions']} evictions, occupancy "
                      f"{rr['used_tiles']}/{rr['budget_tiles']} tiles "
                      f"({rr['occupancy_frac']:.0%}), endurance gain "
                      f"{rr['endurance']['endurance_gain']:.1f}x")
            if calibration is not None:
                cr = calibration.report()
                print(f"  calibration: {cr['sweeps']} sweeps, "
                      f"{cr['rechecks']} rechecks, {cr['reprograms']} "
                      f"reprograms, last sweep {cr['stale_banks']} stale / "
                      f"max read-back err {cr['max_readback_err']:.4f}")
        if args.trace_out:
            obs.tracer.save(args.trace_out)
            print(f"[serve] Chrome trace -> {args.trace_out} "
                  f"({len(obs.tracer.events)} events)")
        if args.metrics_out:
            with open(args.metrics_out, "w") as f:
                json.dump(obs.snapshot(), f, indent=1)
            print(f"[serve] metrics snapshot -> {args.metrics_out}")
    comps.sort(key=lambda c: c.rid)
    if comps:
        print("  first completion:", comps[0].tokens.tolist()[:48])
    return comps


def serve_rank(mesh, args) -> list[Completion]:
    """One mesh rank of ``main``: build the Program on the rank's mesh and
    serve the trace; only rank 0 prints."""
    quiet = mesh.rank != 0
    with contextlib.redirect_stdout(io.StringIO() if quiet else sys.stdout):
        cfg, prog = build_program(args, mesh)
        return serve(prog, args, make_obs(cfg, args))


def main(argv=None) -> list[Completion]:
    args = parse_args(argv)
    mesh = resolve_mesh(args)
    if mesh is not None and mesh.size > 1:
        return mesh_lib.init_ranks(serve_rank, mesh, device=args.device,
                                   args=(args,))[0]
    cfg, prog = build_program(args, mesh)
    return serve(prog, args, make_obs(cfg, args))


if __name__ == "__main__":
    main()
