"""The 2x1 train ranks' peak memory, data-parallel and with ``cfg.fsdp``,
of one or more trees of this repository, in turns on one CUDA card.

    git archive <commit> | tar -x -C build/probe_parent
    python3 tools/probe_fsdp_peak.py build/probe_parent . . build/probe_parent

Each argument is the root of a tree; each runs in a process of its own
with that tree's ``src`` first on ``sys.path``, in the order given (the
same tree twice reads its spread).  A tree's process spawns 2x1 gloo ranks
sharing the card (``launch.mesh.init_ranks``) that train
granite-moe-1b-a400m R&B at full width with chip_smoke's ``train_mesh``
setup (bf16 over float32 masters, 8 x 1024 in 2 microbatches, remat,
deterministic algorithms, lr 1e-3 over 6 steps): ``--steps`` steps
data-parallel, then as many with ``cfg.fsdp``, from seed 0, keeping no
checkpoint.  Each rank prints one JSON line a mode: its peak
(``torch.cuda.max_memory_allocated``), the bytes of its params plus Adam
state, its step walls, losses and grad norms.  Then the card's name and
power limit (``nvidia-smi``) and a summary line of each tree's peaks.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ARCH = "granite-moe-1b-a400m"
BATCH, SEQ, TOTAL_STEPS = 8, 1024, 6


@contextlib.contextmanager
def deterministic(torch):
    """``torch.use_deterministic_algorithms`` for the block, as chip_smoke
    trains on the mesh."""
    old = (torch.are_deterministic_algorithms_enabled(),
           os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(old[0])
        if old[1] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = old[1]


def probe_rank(mesh, steps):
    """One rank: ``steps`` steps data-parallel, then with ``cfg.fsdp``."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import train as launch

    base = get_arch(ARCH, reuse=True)
    out = []
    for fsdp in (False, True):
        cfg = dataclasses.replace(base, fsdp=fsdp)
        tcfg = TrainConfig(lr=1e-3, total_steps=TOTAL_STEPS, warmup_steps=1,
                           microbatch=2, checkpoint_every=0,
                           checkpoint_dir="")
        record = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with deterministic(torch):
            params, opt, losses = launch.run(
                cfg, tcfg, batch=BATCH, seq=SEQ, steps=steps, mesh=mesh,
                log_every=1, record=record)
        torch.cuda.synchronize()
        held = [t for tree in (params, opt.m, opt.v)
                for t in _leaves(tree)]
        out.append({"rank": mesh.rank, "mode": "fsdp" if fsdp else "dp",
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "params_adam_bytes": sum(t.numel() * t.element_size()
                                             for t in held),
                    "run_s": time.perf_counter() - t0,
                    "step_walls_s": [r["s"] for r in record],
                    "losses": losses,
                    "grad_norms": [float(r["grad_norm"]) for r in record]})
        del params, opt, held
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def one(steps: int) -> None:
    """The ranks of the tree on ``sys.path``: one JSON line a rank and
    mode."""
    import repro_torch
    from repro_torch.launch import mesh as mesh_lib

    ranks = mesh_lib.init_ranks(probe_rank, "2x1", device="cuda",
                                args=(steps,))
    for r in ranks:
        for line in r:
            print(json.dumps({"package": repro_torch.__file__, **line}),
                  flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", help="roots of the trees to run")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--one", action="store_true",
                    help="run the tree on sys.path (a child process)")
    args = ap.parse_args()
    if args.one:
        one(args.steps)
        return 0
    summary = []
    for tree in args.trees:
        root = Path(tree).resolve()
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--one", "--steps", str(args.steps)],
                              env=env, capture_output=True, text=True)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode:
            print(proc.stdout[-4000:])
            raise SystemExit(f"{root}: exit {proc.returncode}")
        lines = [json.loads(x) for x in proc.stdout.splitlines()
                 if x.startswith("{")]
        for x in lines:
            print(json.dumps({"tree": str(root), **x}), flush=True)
        summary.append({"tree": str(root), **{
            m: [x["peak_mem_gb"] for x in lines if x["mode"] == m]
            for m in ("dp", "fsdp")}})
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(gpu)
    print(json.dumps({"peak_mem_gb": summary, "gpu": gpu}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
