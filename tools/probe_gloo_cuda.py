"""Which gloo collectives run on CUDA tensors.

One 2-rank spawn per op (an op gloo refuses can abort its ranks instead
of raising, so each op gets fresh processes).  Each op runs on float32 and
bfloat16 CUDA tensors and is held equal to the same op on CPU tensors.
Prints one ``PROBE <op> ok|FAILS`` line per op.  The result is the table
``repro_torch.launch.mesh.GLOO_CUDA_STAGED`` encodes.

    python tools/probe_gloo_cuda.py [cuda|cpu]        # ~75 s on an H100
"""
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

OPS = ("all_reduce", "all_reduce_max", "broadcast", "all_gather",
       "reduce_scatter", "send_recv")


def op(name, rank, world, dt, dev):
    t = torch.arange(8, dtype=dt, device=dev) + rank
    if name == "all_reduce":
        dist.all_reduce(t)
        return t
    if name == "all_reduce_max":
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return t
    if name == "broadcast":
        dist.broadcast(t, 0)
        return t
    if name == "all_gather":
        out = [torch.empty(8, dtype=dt, device=dev) for _ in range(world)]
        dist.all_gather(out, t)
        return torch.cat(out)
    if name == "reduce_scatter":
        out = torch.empty(8 // world, dtype=dt, device=dev)
        dist.reduce_scatter(out, list(t.chunk(world)))
        return out
    if name == "send_recv":
        r = torch.empty(8, dtype=dt, device=dev)
        for w in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, t, (rank + 1) % world),
                dist.P2POp(dist.irecv, r, (rank - 1) % world)]):
            w.wait()
        return r
    raise ValueError(name)


def run(rank, world, path, name, dev):
    dist.init_process_group("gloo", init_method=f"file://{path}",
                            world_size=world, rank=rank)
    for dt in (torch.float32, torch.bfloat16):
        y = op(name, rank, world, dt, dev)
        ref = op(name, rank, world, dt, "cpu")
        assert torch.equal(y.cpu(), ref), (name, dt)
        dist.barrier()
    dist.destroy_process_group()


def main():
    dev = sys.argv[1] if len(sys.argv) > 1 else "cuda"
    for name in OPS:
        with tempfile.TemporaryDirectory() as d:
            try:
                mp.spawn(run, args=(2, os.path.join(d, "init"), name, dev),
                         nprocs=2)
                print("PROBE", name, "ok", flush=True)
            except Exception as e:
                print("PROBE", name, "FAILS", type(e).__name__, flush=True)


if __name__ == "__main__":
    main()
