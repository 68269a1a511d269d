#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one JSON object per line; any failed check raises and
the script exits non-zero without printing the final ``ok`` line):

1. the card (``nvidia-smi`` name and power limit) and the kernel build:
   both CUDA sources compile from this checkout, in parallel;
2. every kernel against its plain PyTorch version on the card, in bf16, at
   the shapes the serving path gives it, with its median time (CUDA
   events, L2 flushed before each launch), the plain version's time, a
   PyTorch library call computing the same product as a yardstick (never
   used by the port) and the card's lower bound for the work;
3. the serving path: minitron-4b with its R&B plan (8 physical blocks x 4
   reuses) at full width, photonic, bf16, seeded random weights, through
   ``Program.generate`` and a ``ContinuousScheduler`` with chunked prefill;
   kernel launch counts are zeroed just before and read just after; then
   one prefill's logits are checked and a small model's GPU logits are
   held against the CPU plain path;
4. a ``{"kernels": [...]}`` summary and the ``{"ok": true, ...}`` line.

Tolerances (bf16 outputs): the MVM kernel computes an exact int32 product
while the plain version keeps the reference's fp32 offset decomposition,
so they agree up to bf16 rounding: rel-L2 <= 2**-8.  Flash attention
reorders fp32 softmax sums: rel-L2 <= 2**-8.  The small-model end-to-end
check uses the repository's W8A8 bound, rel-L2 <= 0.055.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
MVM_TOL = 2.0 ** -8
FLASH_TOL = 2.0 ** -8
W8A8_BOUND = 0.055


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / (b.norm() + 1e-12))


class Timer:
    """Median CUDA-event time of a call, with the 50 MB L2 flushed (a
    64 MiB write) before every timed launch: on the serving path each
    weight bank is cold when its matmul runs."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(64 << 20, dtype=torch.uint8,
                                     device="cuda")

    def ms(self, fn, reps: int) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            self.flush_buf.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


# -------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# -------------------------------------------------------------------------
def mvm_cases():
    """(label, M, K, N, transpose, activation, bias_perm) at the serving
    path's shapes for minitron-4b (d 3072, kv 1024, d_ff 9216, vocab
    256000), decode M = 4 slots and prefill M = 2048 rows.  The transposed
    rows are the OBU transpose reuse: wq/wo (square), w_down^T with the
    gate's silu, w_gate^T."""
    shapes = [("wq", 3072, 3072, False, "none"),
              ("wq^T", 3072, 3072, True, "none"),
              ("wk", 3072, 1024, False, "none"),
              ("w_gate+silu", 3072, 9216, False, "silu"),
              ("w_down^T+silu", 3072, 9216, True, "silu"),
              ("w_down", 9216, 3072, False, "none"),
              ("w_gate^T", 9216, 3072, True, "none"),
              ("lm_head", 3072, 256000, False, "none")]
    cases = []
    for M in (4, 2048):
        for name, K, N, tr, act in shapes:
            cases.append((f"M={M} {name} {K}->{N}", M, K, N, tr, act, False))
    cases.append(("M=8 bias+relu+block_perm 256->512", 8, 256, 512, False,
                  "relu", True))
    return cases


def check_mvm(torch, timer, pm, photonic):
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for label, M, K, N, tr, act, extra in mvm_cases():
        x = torch.randn((M, K), generator=gen, device="cuda").to(
            torch.bfloat16)
        wshape = (N, K) if tr else (K, N)
        wq = torch.randint(-127, 128, wshape, generator=gen, device="cuda",
                           dtype=torch.int8)
        ws = (torch.rand((N,), generator=gen, device="cuda") * 0.05 + 0.01)
        xs = photonic.a8_scale(x)
        kw = dict(transpose=tr, activation=act)
        if extra:
            kw.update(bias=torch.randn((N,), generator=gen, device="cuda").to(
                torch.bfloat16), block_perm=(2, 0, 3, 1), block=128)
        got = pm.photonic_mvm_fused(x, wq, xs, ws, **kw)
        want = pm.photonic_mvm_fused_plain(x, wq, xs, ws, **kw)
        torch.cuda.synchronize()
        err = rel_l2(got, want)
        max_abs = float((got.float() - want.float()).abs().max())
        if not (err <= MVM_TOL and torch.isfinite(got).all()):
            raise AssertionError(f"photonic_mvm_fused {label}: rel-L2 {err} "
                                 f"> {MVM_TOL}")
        big = M * K * N > 1e12
        reps = 5 if big else 20
        ms = timer.ms(lambda: pm.photonic_mvm_fused(x, wq, xs, ws, **kw),
                      reps)
        plain_ms = timer.ms(
            lambda: pm.photonic_mvm_fused_plain(x, wq, xs, ws, **kw),
            3 if big else 10)
        lib_ms = int_mm_ms(torch, timer, x, xs, wq, tr, reps)
        nbytes = (M * K * 2 + K * N + 4 * N + M * N * 2
                  + (2 * N if extra else 0))
        ops = 2.0 * M * K * N
        t_bytes = nbytes / 3.35e12 * 1e3
        t_ops = ops / 1979e12 * 1e3
        row = {"case": label, "kernel": "photonic_mvm_fused",
               "rel_l2": err, "max_abs_err": max_abs, "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "library": "torch._int_mm on the int8 operands (product "
                          "only; rows padded to >= 32)",
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "ops": ops}
        emit(row)
        rows.append(row)
    return rows


def int_mm_ms(torch, timer, x, xs, wq, transpose, reps):
    """Yardstick: cuBLAS int8 x int8 -> int32 (``torch._int_mm``) on the
    same quantized operands.  It needs more than 16 rows, so decode widths
    pad the rows to 32 with zeros."""
    xq = torch.clamp(torch.round(x / xs.to(x.dtype)), -128, 127).to(
        torch.int8)
    if xq.shape[0] < 32:
        xq = torch.cat([xq, xq.new_zeros((32 - xq.shape[0], xq.shape[1]))])
    w = wq.t() if transpose else wq
    return timer.ms(lambda: torch._int_mm(xq, w), reps)


def flash_cases():
    """(label, B, Sq, L, q_offset, kv_len, H, KV, hd, hd_v): minitron-4b
    attention (24 query heads, 8 KV heads: G = 3, hd 128) as a monolithic
    2048-token causal prefill, two 600-token prompts, and a 512-wide chunk
    at q_offset 512 against the 2048-slot capacity buffer with kv_len < L;
    plus one hd_v != hd case (the layout MLA will need)."""
    return [("B=1 Sq=L=2048 causal", 1, 2048, 2048, 0, 2048,
             24, 8, 128, 128),
            ("B=2 Sq=L=600 causal", 2, 600, 600, 0, 600, 24, 8, 128, 128),
            ("B=1 chunk Sq=512 q_offset=512 L=2048 kv_len=1024", 1, 512,
             2048, 512, 1024, 24, 8, 128, 128),
            ("B=1 Sq=L=300 hd=64 hd_v=96 G=4", 1, 300, 300, 0, 300,
             8, 2, 64, 96)]


def check_flash(torch, timer, fa):
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for label, B, Sq, L, off, kv_len, H, KV, hd, hdv in flash_cases():
        q = torch.randn((B * H, Sq, hd), generator=gen, device="cuda").to(
            torch.bfloat16)
        k = torch.randn((B * KV, L, hd), generator=gen, device="cuda").to(
            torch.bfloat16)
        v = torch.randn((B * KV, L, hdv), generator=gen, device="cuda").to(
            torch.bfloat16)
        kw = dict(causal=True, q_offset=off, kv_len=kv_len)
        got = fa.flash_attention(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = rel_l2(got, want)
        max_abs = float((got.float() - want.float()).abs().max())
        if not (err <= FLASH_TOL and torch.isfinite(got).all()):
            raise AssertionError(f"flash_attention {label}: rel-L2 {err} "
                                 f"> {FLASH_TOL}")
        ms = timer.ms(lambda: fa.flash_attention(q, k, v, **kw), 10)
        plain_ms = timer.ms(lambda: fa.flash_attention_plain(q, k, v, **kw),
                            5)
        # SDPA yardstick on the same data: (B, H, S, hd) views, causal mask
        # on absolute positions, keys past kv_len masked
        q4 = q.view(B, H, Sq, hd)
        k4 = k.view(B, KV, L, hd)
        v4 = v.view(B, KV, L, hdv)
        qi = off + torch.arange(Sq, device="cuda")[:, None]
        kj = torch.arange(L, device="cuda")[None, :]
        mask = (kj <= qi) & (kj < kv_len)
        lib_ms = timer.ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask, enable_gqa=True), 10)
        pairs = int(mask.sum())                 # visible (query, key) pairs
        flops = 2.0 * (hd + hdv) * pairs * B * H
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + got.numel())
        t_bytes = nbytes / 3.35e12 * 1e3
        t_ops = flops / 989e12 * 1e3
        row = {"case": label, "kernel": "flash_attention", "rel_l2": err,
               "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms,
               "library": "F.scaled_dot_product_attention(enable_gqa=True)",
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "ops": flops}
        emit(row)
        rows.append(row)
    return rows


# -------------------------------------------------------------------------
# phase 3: the serving path
# -------------------------------------------------------------------------
def small_model_check(torch):
    """A small dense model (the reference's prefill-test shape, float32)
    with flash engaged: the GPU kernels against the CPU plain path on the
    same weights, held to the repository's W8A8 bound, plus a greedy-token
    comparison (reported, not gated: the kernel's exact int32 product and
    the plain fp32 decomposition may round one A8 boundary differently)."""
    from repro_torch import api
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.backend import Backend
    from repro_torch.models import transformer as tfm

    cfg = ModelConfig(name="small", family="dense", num_layers=2,
                      d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                      vocab_size=97, compute_dtype="float32")
    params = tfm.init_model(cfg, seed=3, device="cpu")
    bk = Backend("photonic", flash_min_seq=64)
    gpu = api.Program.build(cfg, params, execution=bk)
    cpu = api.Program.build(cfg, params, execution=bk, device="cpu")
    toks = np.random.default_rng(3).integers(0, 97, (2, 96))
    lg_gpu, _ = gpu.prefill({"tokens": toks}, 112)
    lg_cpu, _ = cpu.prefill({"tokens": toks}, 112)
    err = rel_l2(lg_gpu.cpu(), lg_cpu)
    if not (err <= W8A8_BOUND and torch.isfinite(lg_gpu).all()):
        raise AssertionError(f"small model GPU vs CPU rel-L2 {err}")
    same = bool((gpu.generate(toks, 8).cpu() == cpu.generate(toks, 8)).all())
    return {"small_model_gpu_vs_cpu_rel_l2": err,
            "small_model_greedy_tokens_equal": same}


def profile_generate(torch, prog, prompt):
    """Where the device time goes: ``torch.profiler`` over one
    ``Program.generate`` (one prefill + 7 decode steps), kernel time summed
    by kernel, and the device's idle share of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prog.generate(prompt, 8)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    groups: dict = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        name = ev.key
        if name.startswith(("void (anonymous namespace)::mvm_kernel",
                            "void (anonymous namespace)::reduce_kernel")):
            group = "photonic_mvm_fused"
        elif "flash_kernel" in name:
            group = "flash_attention"
        else:
            group = "other torch kernels"
        groups[group] = groups.get(group, 0.0) + ev.self_device_time_total
    busy = sum(groups.values())
    return {"phase": "profile", "what": f"generate {tuple(prompt.shape)} "
            f"+ 8 tokens", "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / wall_us if wall_us else None,
            "kernel_ms": {k: v / 1e3 for k, v in sorted(groups.items())}}


def decode_step_costs(torch, prog):
    """Host cost of one decode step at the scheduler's shape (capacity 4,
    2048-slot caches): the aten ops it dispatches (counted with a
    ``TorchDispatchMode``; the CUDA kernels are not aten ops) and its wall
    time, median of 5 synchronized steps."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    caches = prog.empty_caches(4, 2048)
    toks = np.zeros((4, 1), np.int64)
    pos = np.array([700, 0, 300, 1500])
    with Count():
        prog.decode_sample(toks, caches, pos)
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prog.decode_sample(toks, caches, pos)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"phase": "decode_step", "capacity": 4, "max_len": 2048,
            "aten_ops": Count.n, "wall_ms_median": statistics.median(times)}


def serve(torch, pm, fa, gpu):
    from repro_torch import api
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.batcher import Request
    from repro_torch.serve.scheduler import ContinuousScheduler

    cfg = get_arch("minitron-4b", reuse=True)
    t0 = time.perf_counter()
    params = tfm.init_model(cfg, seed=0)
    prog = api.Program.build(cfg, params, execution="photonic")
    del params
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    stats = prog.bank_stats()
    emit({"phase": "build", "arch": cfg.name, "R": cfg.reuse.num_basic,
          "T": cfg.reuse.reuse_times, "d_model": cfg.d_model,
          "d_ff": cfg.d_ff, "padded_vocab": cfg.padded_vocab,
          "dtype": cfg.compute_dtype, "build_s": build_s,
          "bank_int8_bytes": stats["int8_bytes"],
          "bank_fp_bytes": stats["fp_bytes"],
          "verify_banks": prog.verify_banks(),
          "mem_allocated_gb": torch.cuda.memory_allocated() / 1e9})
    rng = np.random.default_rng(0)
    V = cfg.vocab_size

    pm.launches = 0
    fa.launches = 0
    torch.cuda.reset_peak_memory_stats()

    # -- Program.generate: two 600-token prompts (monolithic flash prefill)
    prompts = rng.integers(0, V, (2, 600))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = prog.generate(prompts, 16)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    if tuple(out.shape) != (2, 616) or not bool(
            (out[:, :600].cpu() == torch.as_tensor(prompts)).all()):
        raise AssertionError(f"generate returned {tuple(out.shape)}")

    # -- ContinuousScheduler: monolithic einsum (40, 300), monolithic flash
    #    (512) and chunked flash (1300, 1900) admissions, 16 tokens each
    lens = (40, 300, 512, 1300, 1900)
    sched = ContinuousScheduler(prog, capacity=4, max_len=2048,
                                prefill_chunk=512)
    for rid, n in enumerate(lens):
        sched.submit(Request(rid=rid, prompt=rng.integers(0, V, n),
                             max_new=16))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = sched.drain()
    torch.cuda.synchronize()
    sched_s = time.perf_counter() - t0
    mvm_launches, flash_launches = pm.launches, fa.launches

    # outside the counted window: the logits of one 600-token prefill
    logits, _ = prog.prefill({"tokens": prompts[:1]}, 616)
    if not (logits.shape[-1] == cfg.padded_vocab
            and bool(torch.isfinite(logits).all())):
        raise AssertionError("non-finite prefill logits")

    got = sorted((c.rid, len(c.tokens), c.finish_reason) for c in done)
    want = [(rid, n + 16, "length") for rid, n in enumerate(lens)]
    if got != want:
        raise AssertionError(f"completions {got} != {want}")
    if mvm_launches <= 0 or flash_launches <= 0:
        raise AssertionError(f"kernels not on the serving path: mvm "
                             f"{mvm_launches}, flash {flash_launches}")
    gen_tokens = 2 * 16
    sched_tokens = 16 * len(lens)
    result = {"phase": "serve", "gpu": gpu, "generate_s": gen_s,
              "generate_tokens_per_s": gen_tokens / gen_s,
              "scheduler_s": sched_s,
              "scheduler_tokens_per_s": sched_tokens / sched_s,
              "scheduler_prompt_tokens": sum(lens),
              "scheduler_decode_steps": sched.stats.decode_steps,
              "scheduler_prefill_chunks": sched.stats.prefill_chunks,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "launches": {"photonic_mvm_fused": mvm_launches,
                           "flash_attention": flash_launches}}
    result.update(small_model_check(torch))
    emit(result)
    emit(profile_generate(torch, prog, prompts[:1]))
    emit(decode_step_costs(torch, prog))
    return mvm_launches, flash_launches


# -------------------------------------------------------------------------
def summary(name, rows, launches, at, source, replaces):
    """One kernel's entry: errors are maxima over every case (``worst_at``
    names the case of the largest rel-L2); times are those of case ``at``."""
    rep = next(r for r in rows if r["case"] == at)
    worst = max(rows, key=lambda r: r["rel_l2"])
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_rel_l2": worst["rel_l2"], "worst_at": worst["case"],
            "at": at, "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import photonic
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import photonic_mvm as pm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    per_kernel = ops.build_kernels()
    emit({"gpu": smi, "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": time.perf_counter() - t0, "build_s_per_kernel":
          per_kernel})

    timer = Timer(torch)
    mvm_rows = check_mvm(torch, timer, pm, photonic)
    flash_rows = check_flash(torch, timer, fa)
    del timer
    torch.cuda.empty_cache()
    mvm_launches, flash_launches = serve(torch, pm, fa, smi)

    emit({"kernels": [
        summary("photonic_mvm_fused", mvm_rows, mvm_launches,
                "M=4 w_gate+silu 3072->9216",
                "src/repro_torch/csrc/photonic_mvm_fused.cu",
                "src/repro/kernels/photonic_mvm.py:432"),
        summary("flash_attention", flash_rows, flash_launches,
                "B=1 Sq=L=2048 causal",
                "src/repro_torch/csrc/flash_attention.cu",
                "src/repro/kernels/flash_attention.py:114")]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
