"""End-to-end training driver (port of ``repro.launch.train``).

  * step-granular checkpoint/restart (atomic, hash-verified; resume is
    exact because the data pipeline is stateless by step);
  * a SIGTERM/SIGINT trap that flushes a checkpoint before exit;
  * a straggler watch: steps slower than mean + 4 std of the last 50 are
    flagged;
  * a held-out eval through ``Program.loss`` after training.

A step's wall is taken after ``float(loss)``, the step's one host sync, so
it holds the step's device time (the reference, dispatching
asynchronously, reads its clock before that sync).  Training runs on the
xla backend.

``run(..., mesh=)`` with a bound mesh (``launch.mesh.init_ranks`` starts
one rank per position and each calls ``run``) trains on the ranks, as the
reference's ``run(mesh=)`` does: every rank builds the same seeded weights
and keeps its pieces of them (``trainer.param_specs``: the reference's
``tree_pspecs``, "model" entries and, under ``cfg.fsdp``, the data axes'),
each data rank steps on its rows of every global batch with the residual
cut over "model" by positions (``trainer.make_train_step(...,
act_pspec=partition.act_pspec(mesh), mesh=mesh)``: "seq", the reference's
train layout), and checkpoints hold the logical layout, so a run resumes on
any mesh or on none.  Every rank keeps its own trap, straggler watch and
``record``; the ranks agree after each step whether a signal arrived, so
all of them checkpoint and stop at the same step.  Rank 0 prints the step
lines.  The reference's CLI has no mesh for training, nor has this one.

On the CPU:
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite-moe-1b-a400m --smoke --reuse --steps 20 --device cpu

On a CUDA device (the default ``--device cuda``; it raises without one):
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite-moe-1b-a400m --reuse --steps 50 --batch 8 --seq 1024
"""
from __future__ import annotations

import argparse
import os
import signal
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, rb, smoke_variant
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
from repro_torch.sharding import collectives as coll
from repro_torch.sharding import partition
from repro_torch.train import checkpoint, trainer


def run(cfg, tcfg: TrainConfig, *, batch: int, seq: int, steps: int,
        mesh=None, task: str = "copy", log_every: int = 10,
        resume: bool = True, device=None, record=None):
    """Train ``cfg`` from seeded weights (or the latest checkpoint in
    ``tcfg.checkpoint_dir``) up to step ``steps``.  ``record``, a list,
    receives one dict per step: its wall ``s``, ``loss`` and the 0-d
    tensors ``grad_norm`` and ``lr`` (read them after the run; reading
    them here would add host syncs).  ``mesh``: the rank's bound mesh
    (module docstring; ``None`` is the 1x1 mesh); ``device`` defaults to
    the rank's.  An empty ``tcfg.checkpoint_dir`` keeps no checkpoint:
    nothing is resumed or saved.  Returns (params, opt_state, losses): on
    a mesh the rank's pieces (``partition.gather_tree`` with ``trainer.param_specs``
    gathers them)."""
    mesh = mesh_lib.single_device_mesh() if mesh is None else mesh
    if mesh.size > 1 and not mesh.bound:
        raise ValueError(f"a {dict(mesh.shape)} mesh trains as {mesh.size} "
                         f"ranks: start them with launch.mesh.init_ranks")
    device = mesh.device if device is None else device
    speaks = mesh.rank == 0
    dev = resolve_device(device)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch, task=task, seed=tcfg.seed)
    pipe = SyntheticPipeline(dcfg)
    pspecs = trainer.param_specs(cfg, mesh)
    params = partition.local_tree(
        tfm.init_model(cfg, seed=tcfg.seed, device=dev), pspecs, mesh)
    specs = trainer.state_specs(pspecs)
    opt_state = adamw.init(params)
    start_step = 0
    keeps = bool(tcfg.checkpoint_dir)
    if resume and keeps:
        last = checkpoint.latest_step(tcfg.checkpoint_dir)
        if last is not None:
            (params, opt_state), extra = checkpoint.restore(
                tcfg.checkpoint_dir, last, (params, opt_state), mesh=mesh,
                specs=specs)
            start_step = extra.get("next_step", last)
            if speaks:
                print(f"[train] resumed from step {start_step}")
    step_fn = trainer.make_train_step(
        cfg, tcfg, act_pspec=partition.act_pspec(mesh), remat=True,
        mesh=mesh)

    # ---- preemption trap: flush a checkpoint on SIGTERM/SIGINT ----
    state = {"step": start_step, "stop": False}

    def _trap(sig, frame):
        state["stop"] = True

    old = {s: signal.signal(s, _trap)
           for s in (signal.SIGTERM, signal.SIGINT)}

    def stop_now() -> bool:
        """A signal reached this rank, or (on a mesh) any rank."""
        if mesh.size == 1:
            return state["stop"]
        flag = torch.tensor(float(state["stop"]), device=dev)
        return bool(coll.pmax(flag, mesh, mesh.axis_names) > 0)

    times = []
    losses = []
    try:
        for step in range(start_step, steps):
            t0 = time.time()
            batch_dev = pipe.device_batch(step, device=dev)
            params, opt_state, metrics = step_fn(params, opt_state,
                                                 batch_dev)
            state["step"] = step + 1
            losses.append(float(metrics["loss"]))
            dt = time.time() - t0
            times.append(dt)
            if record is not None:
                record.append({"step": step, "s": dt, "loss": losses[-1],
                               "grad_norm": metrics["grad_norm"],
                               "lr": metrics["lr"]})
            if len(times) > 8:
                mu, sd = np.mean(times[-50:]), np.std(times[-50:])
                if dt > mu + 4 * sd + 1e-3:
                    who = f" on rank {mesh.coords}" if mesh.size > 1 \
                        else ""
                    print(f"[straggler] step {step} took {dt:.3f}s "
                          f"(mean {mu:.3f}s){who} — flagged")
            if speaks and (step % log_every == 0 or step == steps - 1):
                print(f"step {step:5d} loss {losses[-1]:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e} {dt:.2f}s",
                      flush=True)
            if keeps and tcfg.checkpoint_every and (step + 1) % \
                    tcfg.checkpoint_every == 0:
                checkpoint.save(tcfg.checkpoint_dir, step + 1,
                                (params, opt_state),
                                extra={"next_step": step + 1}, mesh=mesh,
                                specs=specs)
            if stop_now():
                if speaks:
                    print("[train] preemption signal — checkpoint + exit")
                break
    finally:
        for s, h in old.items():
            signal.signal(s, h)
    if keeps:
        checkpoint.save(tcfg.checkpoint_dir, state["step"],
                        (params, opt_state),
                        extra={"next_step": state["step"]}, mesh=mesh,
                        specs=specs)
    return params, opt_state, losses


def build_config(args):
    """The model config of ``args``: the smoke variant (with ``--reuse``,
    R&B over half its groups, reused twice) or the published one."""
    if args.smoke:
        cfg = smoke_variant(args.arch)
        if args.reuse:
            segs = tfm.build_segments(cfg)
            ng = [s for s in segs if s.name != "pre"][-1].num_groups
            cfg = rb(cfg, max(1, ng // 2), 2)
        return cfg
    return get_arch(args.arch, reuse=args.reuse)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--reuse", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--task", default="copy", choices=["copy", "lm"])
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = build_config(args)
    tcfg = TrainConfig(lr=args.lr, total_steps=args.steps,
                       warmup_steps=max(1, args.steps // 10),
                       checkpoint_every=args.ckpt_every,
                       checkpoint_dir=args.ckpt_dir)
    params, _, losses = run(cfg, tcfg, batch=args.batch, seq=args.seq,
                            steps=args.steps, task=args.task,
                            resume=not args.no_resume, device=dev)
    print(f"[train] done. loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    # held-out eval through the serving surface: the trained params become
    # a Program (backend resolved, banks prepared once)
    from repro_torch.api import Program
    prog = Program.build(cfg, params, device=dev)
    pipe = SyntheticPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=args.seq,
                                        global_batch=args.batch,
                                        task=args.task, seed=tcfg.seed + 1))
    ce, _ = prog.loss(pipe.device_batch(10_000, device=dev))
    print(f"[train] held-out eval via Program.loss: ce {float(ce):.4f}")


if __name__ == "__main__":
    main()
