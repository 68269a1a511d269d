#!/usr/bin/env python3
"""The SSM decode read-out ``y = C h`` in its two forms, on one NVIDIA GPU:
as ``einsum("bhn,bhpn->bhp")`` (a batched matmul) and as a product and a
sum over N (``models/ssm.ssm_decode``: a head's bits do not depend on the
heads beside it, which a rank holding some of the heads needs).

    python3 tools/probe_ssm_readout.py [--steps 30]

mamba2-780m R&B (12 x 4) at full width, photonic, bf16: a 4 x 600 prefill
into 2048-slot caches, then for each form a decode cell
(``graphs.DecodeCell``) captured on its own copy of those caches.  Reported
per form, in the order sum, einsum, einsum, sum: the median wall of
``--steps`` synchronized replays and the device busy of one profiled
replay.  Beside them: the two forms' logits of the first step from the same
caches (rel-L2, bit-equal or not); the read-out alone at the step's shape
(4, 48, 64, 128) float32 (median of 200 CUDA-event timings, and its bound:
h and C read once, y written once, at 3.35 TB/s); and for each form whether
heads 24..47 of the 48-head call equal a call on those 24 heads alone.

One JSON object per line, the card's name and power limit first.  Without
a CUDA device it exits non-zero.
"""
from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
SUM_FORM = "y = (Ch[:, :, None, :] * h).sum(-1)"
EINSUM_FORM = 'y = torch.einsum("bhn,bhpn->bhp", Ch, h)'


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


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


def einsum_decode():
    """``ssm.ssm_decode`` with its read-out as the batched-matmul einsum."""
    from repro_torch.models import ssm as ssm_lib
    src = inspect.getsource(ssm_lib.ssm_decode)
    if SUM_FORM not in src:
        raise RuntimeError("ssm_decode's read-out is not the product-sum "
                           "form this probe replaces")
    ns = dict(vars(ssm_lib))
    exec(compile(src.replace(SUM_FORM, EINSUM_FORM), "einsum_decode",
                 "exec"), ns)
    return ns["ssm_decode"]


def readout_alone(g) -> dict:
    """The read-out at the decode step's shape, both forms."""
    B, H, P, N = 4, 48, 64, 128
    Ch = torch.randn((B, H, N), generator=g, device="cuda")
    h = torch.randn((B, H, P, N), generator=g, device="cuda")
    forms = {"sum": lambda c, s: (c[:, :, None, :] * s).sum(-1),
             "einsum": lambda c, s: torch.einsum("bhn,bhpn->bhp", c, s)}
    out = {"shape": [B, H, P, N],
           "bound_ms": 4.0 * (B * H * P * N + B * H * N + B * H * P)
           / HBM_BYTES_PER_S * 1e3}
    for name, f in forms.items():
        for _ in range(10):
            f(Ch, h)
        times = []
        for _ in range(200):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            f(Ch, h)
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        whole = f(Ch, h)
        half = f(Ch[:, 24:].contiguous(), h[:, 24:].contiguous())
        out[name] = {"ms": statistics.median(times),
                     "heads_24_47_bit_equal_alone":
                         bool(torch.equal(whole[:, 24:], half))}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_ssm_readout: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import api, graphs
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.models import transformer as tfm

    emit(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                         "--format=csv,noheader"], capture_output=True,
                        text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    ops.build_kernels()
    busy_ms(lambda: torch.ones(1, device="cuda").add_(1))
    g = torch.Generator(device="cuda").manual_seed(0)
    emit({"readout_alone": readout_alone(g)})

    cfg = get_arch("mamba2-780m", reuse=True)
    prog = api.Program.build(cfg, tfm.init_model(cfg, seed=0),
                             execution="photonic")
    prompts = np.random.default_rng(17).integers(0, cfg.vocab_size,
                                                 (4, 600))
    logits, caches = prog.prefill({"tokens": prompts}, 2048)
    toks = torch.argmax(logits, dim=-1)[:, None]
    own = ssm_lib.ssm_decode
    forms = {"sum": own, "einsum": einsum_decode()}
    cells, first = {}, {}
    for name, fn in forms.items():
        ssm_lib.ssm_decode = fn
        try:
            mine = clone_tree(caches)
            saved = [x.clone() for x in leaves(mine)]
            cell = graphs.DecodeCell(prog, mine)
            cell.step(toks, 600)                     # warm-up and capture
            for x, s in zip(leaves(mine), saved):
                x.copy_(s)
            first[name] = cell.step(toks, 600).float().clone()
        finally:
            ssm_lib.ssm_decode = own
        if cell.graph is None:
            raise RuntimeError(f"{name}: the decode cell did not capture "
                               f"({cell.reason})")
        cells[name] = cell
    emit({"first_step": {
        "rel_l2_einsum_vs_sum": rel_l2(first["einsum"], first["sum"]),
        "bit_equal": bool(torch.equal(first["einsum"], first["sum"])),
        "finite": all(bool(torch.isfinite(v).all())
                      for v in first.values())}})
    rows = []
    for name in ("sum", "einsum", "einsum", "sum"):
        cell = cells[name]
        walls = []
        for _ in range(args.steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cell.step(toks, 600)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        rows.append({"form": name, "replay_wall_ms_median":
                     statistics.median(walls),
                     "replay_busy_ms": busy_ms(lambda: cell.step(toks, 600)),
                     "steps": args.steps})
        emit(rows[-1])
    emit({"ok": True, "arch": cfg.name, "rows": 4, "cache_len": 2048})
    return 0


if __name__ == "__main__":
    sys.exit(main())
