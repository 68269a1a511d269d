#!/usr/bin/env python3
"""Capture and replay ``graphs.DecodeCell`` on one NVIDIA GPU, against the
same cell kept eager, from the same caches.

    python3 tools/probe_decode_cell.py

For the dense, MoE, SSM and hybrid smoke models (R&B 2 x 2 but the hybrid,
photonic, float32 and bfloat16) and for minitron-4b R&B at full width, with
capacity-4 caches filled with seeded random values and rows at scattered
positions: the warm-up step and a replay must equal the eager cell's
logits, and the caches after them the eager step's, bit for bit; the launch
counts of the eager step, the warm-up and a replay must be equal.  Each row
reports the wall time of an eager and a replayed step (median of 5
synchronized steps) and the device busy time of one profiled step of each;
one ``Program.generate`` (one capture) must give the tokens of eager
``decode_sample`` steps.  The full-width row uses 2048-slot caches.

One JSON object per line, the card's name and power limit first.  Without
a CUDA device it exits non-zero.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def busy_ms(step) -> float:
    """Device busy time of one profiled ``step()``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3


def wall_ms(step) -> float:
    """Median wall time of 5 synchronized ``step()`` calls."""
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def check(name, cfg, B=4, L=64) -> dict:
    from chip_smoke import eager_cells
    from repro_torch import api, graphs
    from repro_torch.kernels import counts
    from repro_torch.models import transformer as tfm

    prog = api.Program.build(cfg, tfm.init_model(cfg, seed=0),
                             execution="photonic")
    caches = prog.empty_caches(B, L)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for x in leaves(caches):
        x.copy_(torch.randn(x.shape, generator=gen, device="cuda") * 0.5)
    saved = [x.clone() for x in leaves(caches)]

    def restore():
        for x, s in zip(leaves(caches), saved):
            x.copy_(s)

    toks = np.arange(1, B + 1).reshape(B, 1) * 7
    pos = np.array([L // 2, 0, L // 3, L - 2][:B])
    eager = graphs.DecodeCell(prog, caches)

    def eager_step():
        with eager_cells():
            return eager.step(toks, pos)

    def counted(step):
        before = counts.snapshot()
        out = step().clone()
        return out, counts.difference(before, counts.snapshot())

    want, d_eager = counted(eager_step)
    want_caches = [x.clone() for x in leaves(caches)]
    restore()
    cell = graphs.DecodeCell(prog, caches)
    captures = graphs.CAPTURE_COUNTS["decode"]
    warm, d_warm = counted(lambda: cell.step(toks, pos))
    restore()
    got, d_replay = counted(lambda: cell.step(toks, pos))
    row = {"name": name, "captured": cell.graph is not None,
           "captures": graphs.CAPTURE_COUNTS["decode"] - captures,
           "warm_equal": bool(torch.equal(warm, want)),
           "replay_equal": bool(torch.equal(got, want)),
           "caches_equal": all(torch.equal(a, b) for a, b in
                               zip(want_caches, leaves(caches))),
           "counts_equal": d_eager == d_warm == d_replay,
           "delta": {k: v for k, v in cell.delta.items() if v},
           "wall_ms": {"eager": wall_ms(eager_step),
                       "replay": wall_ms(lambda: cell.step(toks, pos))},
           "busy_ms": {"eager": busy_ms(eager_step),
                       "replay": busy_ms(lambda: cell.step(toks, pos))}}
    prompt = np.array([[1, 2, 3, 4, 5]])
    out = prog.generate(prompt, 6)
    logits, cc = prog.prefill({"tokens": prompt}, 11)
    cur = api.sample(logits, cfg.vocab_size).long()[:, None]
    ref = [cur]
    for i in range(5):
        nxt, cc = prog.decode_sample(cur, cc, 5 + i)
        cur = nxt.long()[:, None]
        ref.append(cur)
    row["generate_equal_eager"] = (out[0, 5:].tolist()
                                   == torch.cat(ref, 1)[0].tolist())
    row["ok"] = all(row[k] for k in ("captured", "warm_equal",
                                     "replay_equal", "caches_equal",
                                     "counts_equal",
                                     "generate_equal_eager")) and \
        row["captures"] == 1
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_decode_cell: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.configs.archs import rb
    from repro_torch.kernels import ops

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    ops.build_kernels()
    # the profiler's first session on a process can miss device events
    busy_ms(lambda: torch.ones(1, device="cuda").add_(1))
    ok = True
    for name in ("minitron-4b", "granite-moe-1b-a400m", "mamba2-780m",
                 "jamba-v0.1-52b"):
        for dtype in ("float32", "bfloat16"):
            cfg = smoke_variant(name)
            if name != "jamba-v0.1-52b":
                cfg = rb(cfg, 2, 2)
            cfg = dataclasses.replace(cfg, compute_dtype=dtype)
            if cfg.moe is not None and name == "granite-moe-1b-a400m":
                cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                    cfg.moe, num_basic_experts=2))
            row = check(f"{name}-{dtype}", cfg)
            ok &= row["ok"]
            emit(row)
    row = check("minitron-4b-full", get_arch("minitron-4b", reuse=True),
                B=4, L=2048)
    ok &= row["ok"]
    emit(row)
    emit({"ok": bool(ok)})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
