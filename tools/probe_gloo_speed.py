"""How fast gloo moves CUDA tensors between two ranks that share a card,
directly and staged through pinned host memory.

Two ranks on ``cuda:0`` (one spawn).  For each size, each op runs on a
float32 CUDA tensor handed to gloo as it is ("direct") and on a pinned
host copy that is copied back ("staged": device -> pinned host, the CPU
collective, host -> device), both held equal, each timed as the median
wall of 3 calls after a warm-up.  Prints one JSON line per (op, size) on
rank 0: the seconds and the rate, payload bytes (the tensor's) over
seconds.

    python tools/probe_gloo_speed.py            # ~1 min on an H100
"""
import json
import os
import statistics
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SIZES_MB = (16, 256, 1536)
OPS = ("all_reduce", "all_gather", "reduce_scatter")


def call(name, t, world):
    """``name`` on ``t`` (any device); returns its output."""
    if name == "all_reduce":
        y = t.clone()
        dist.all_reduce(y)
        return y
    if name == "all_gather":
        out = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(out, t)
        return torch.cat(out)
    parts = [p.contiguous() for p in t.chunk(world)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts)
    return out


def staged(name, t, world, pinned):
    pinned.copy_(t, non_blocking=True)
    torch.cuda.synchronize()
    return call(name, pinned, world).to(t.device, non_blocking=True)


def timed(fn):
    walls = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls[1:]), out


def run(rank, world, path):
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{path}",
                            world_size=world, rank=rank)
    for mb in SIZES_MB:
        n = mb * 2 ** 20 // 4
        t = torch.randn(n, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(rank))
        pinned = torch.empty(n, pin_memory=True)
        for name in OPS:
            s_direct, a = timed(lambda: call(name, t, world))
            s_staged, b = timed(lambda: staged(name, t, world, pinned))
            if rank == 0:
                print(json.dumps({
                    "op": name, "mb": mb, "direct_s": s_direct,
                    "staged_s": s_staged,
                    "direct_gb_s": t.numel() * 4 / s_direct / 1e9,
                    "staged_gb_s": t.numel() * 4 / s_staged / 1e9,
                    "equal": bool(torch.equal(a, b))}), flush=True)
            dist.barrier()
        del t, pinned
    dist.destroy_process_group()


def main():
    if not torch.cuda.is_available():
        print("probe_gloo_speed: no CUDA device", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(run, args=(2, os.path.join(tmp, "rv")), nprocs=2,
                 join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
