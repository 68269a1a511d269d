"""How far a tensor-parallel minitron-4b R&B (full width, seeded random
weights) lands from the unsharded Program, beside the unsharded Program's
own distance between its two attention routes (flash, and the einsum a
mesh runs), in bf16 and float32; in bf16 also with each row-parallel
dot's partials kept in float32 (the input cast to float32, so the fused
kernel returns float32, and the sum rounded to bf16 once).

One JSON line per reading: rel-L2 of the 2 x 600 prefill's last logits,
then of 4 decode steps on the einsum route's greedy tokens.

    python tools/probe_tp_noise.py          # ~2 min on an H100
"""
import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

PROMPT, STEPS = 600, 4


def float32_partials():
    """Row-parallel partials in float32: a no-epilogue fused call on a
    bf16 input runs on its float32 cast, and the collective's float32 sum
    is rounded to bf16 before the epilogue."""
    from repro_torch.core import backend as B
    from repro_torch.kernels import ops
    fused, epilogue = ops.photonic_matmul_fused, B._epilogue_unfused

    def fused32(x, wq, ws, *, x_scale=None, bias=None, block_perm=None,
                activation="none", **kw):
        if (x_scale is not None and bias is None and block_perm is None
                and activation == "none" and x.dtype == torch.bfloat16):
            x = x.float()
        return fused(x, wq, ws, x_scale=x_scale, bias=bias,
                     block_perm=block_perm, activation=activation, **kw)

    def epilogue16(y, *a):
        return epilogue(y.to(torch.bfloat16) if y.dtype == torch.float32
                        else y, *a)
    ops.photonic_matmul_fused = fused32
    B._epilogue_unfused = epilogue16


def config(dtype):
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch("minitron-4b", reuse=True),
                               compute_dtype=dtype)


def rank(mesh, job):
    import torch.distributed as dist
    from repro_torch import api
    from repro_torch.models import transformer as tfm
    cfg = config(job["dtype"])
    if job["f32_partials"]:
        float32_partials()
    for r in range(mesh.size):
        if r == mesh.rank:
            params = tfm.init_model(cfg, seed=0, device=mesh.device)
            prog = api.Program.build(cfg, params, execution="photonic",
                                     mesh=mesh)
            del params
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    lg, c = prog.prefill({"tokens": torch.as_tensor(job["prompts"]).cuda()},
                         PROMPT + STEPS)
    out = [lg.float().cpu()]
    for i, tok in enumerate(job["tokens"]):
        lg, c = prog.decode(torch.as_tensor(tok)[:, None].cuda(), c,
                            PROMPT + i)
        out.append(lg.float().cpu())
    return out if mesh.rank == 0 else None


def unsharded(dtype, prompts):
    """Both attention routes' logits; the flash route decodes the einsum
    route's tokens."""
    from repro_torch import api
    from repro_torch.models import transformer as tfm
    cfg = config(dtype)
    params = tfm.init_model(cfg, seed=0)
    prog = api.Program.build(cfg, params, execution="photonic")
    del params
    base = prog.backend
    runs = {}
    for route in ("einsum", "flash"):
        prog.backend = dataclasses.replace(base, flash=route == "flash")
        lg, c = prog.prefill({"tokens": prompts}, PROMPT + STEPS)
        ref, toks = [lg.float().cpu()], []
        for i in range(STEPS):
            tok = (torch.argmax(ref[-1], -1).numpy() if route == "einsum"
                   else runs["einsum"][1][i])
            toks.append(tok)
            lg, c = prog.decode(torch.as_tensor(tok)[:, None].cuda(), c,
                                PROMPT + i)
            ref.append(lg.float().cpu())
        runs[route] = (ref, toks)
    del prog, c
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def rel(a, b):
    return float((a - b).norm() / b.norm())


def main():
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    ops.build_kernels()
    prompts = np.random.default_rng(15).integers(0, 256000, (2, PROMPT))
    for dtype in ("bfloat16", "float32"):
        runs = unsharded(dtype, prompts)
        ref, toks = runs["einsum"]
        print(json.dumps({"dtype": dtype, "unsharded_flash_vs_einsum": [
            rel(a, b) for a, b in zip(runs["flash"][0], ref)]}), flush=True)
        for f32p in ((False, True) if dtype == "bfloat16" else (False,)):
            t0 = time.perf_counter()
            got = mesh_lib.init_ranks(rank, "1x2", device="cuda", args=(
                {"dtype": dtype, "f32_partials": f32p, "prompts": prompts,
                 "tokens": toks},))[0]
            print(json.dumps({"dtype": dtype, "mesh": "1x2",
                              "float32_partials": f32p,
                              "rel_l2": [rel(a, b) for a, b in zip(got, ref)],
                              "s": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
