#!/usr/bin/env python3
"""Time a kernel library of this checkout against another checkout's, in
one process, on one NVIDIA GPU: the fused W8A8 MVM (default) or flash
attention.

    python3 tools/ab_fused_library.py --other DIR [--kernel K] [--reps N]
                                      [--out FILE]

DIR is the root of another checkout (for example the parent commit,
unpacked with ``git archive``).  Both trees' source of the kernel
(``photonic_mvm_fused.cu`` or ``flash_attention.cu``) are built with the
same ``nvcc`` flags (``kernels/build.py``), each into its own library under
``build/ab/``, and both are driven through this tree's wrapper (same plan,
same workspaces): the fused MVM at every ``chip_smoke.mvm_cases`` shape,
flash at every ``chip_smoke.flash_cases`` case with both head dims up to
128 (the other tree may predate the larger instantiations).  The two
libraries are timed in turns (other, this, this, other) with
``chip_smoke.Timer`` (CUDA events, L2 flushed before each launch); each
case reports both medians and their ratio, and the outputs of the two
libraries must be equal bit for bit.  Where ``cuobjdump`` is found, the
script also reports whether the two libraries' machine code (SASS) is the
same.

Use it when an edit touches a source or header the fused kernel includes
(its code generation has moved with code it does not run, PERF.md), or
the flash kernel.  One JSON object per line; the last is the summary.
Without a CUDA device it exits non-zero.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def build_library(csrc: Path, out: Path, nvcc: str, flags,
                  kernel: str) -> Path:
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([nvcc, *flags, "-o", str(out),
                           str(csrc / f"{kernel}.cu")],
                          capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {csrc}:\n{proc.stderr}")
    return out


def load_fused(path: Path):
    lib = ctypes.CDLL(str(path))
    fn = lib.photonic_mvm_fused
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, p, i, p, p, p, p, i, i, i, i, i, i, i, i, p, p, p,
                   p, p]
    fn.restype = i
    return lib, fn


def sass(path: Path, nvcc: str) -> str | None:
    """The library's machine code with addresses dropped, or None without
    ``cuobjdump`` (looked up beside ``nvcc``, then on PATH)."""
    tool = Path(nvcc).with_name("cuobjdump")
    if not tool.is_file():
        found = shutil.which("cuobjdump")
        if found is None:
            return None
        tool = Path(found)
    text = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True).stdout
    return "\n".join(line.split("*/", 1)[-1].strip()
                     for line in text.splitlines() if "/*" in line)


def in_turns(torch, timer, use, call, reps):
    """Outputs and times of ``call`` under each library, in turns (other,
    this, this, other); raises unless the outputs are equal bit for bit."""
    outs, times = {}, {"other": [], "this": []}
    for side in ("other", "this", "this", "other"):
        use(side)
        outs[side] = call()
        times[side].append(timer.ms(call, reps))
    torch.cuda.synchronize()
    if not torch.equal(outs["this"], outs["other"]):
        raise AssertionError("the two libraries differ")
    return times, (statistics.median(times["this"])
                   / statistics.median(times["other"]))


def fused_ab(torch, cs, pm, photonic, libs, timer, reps_arg, emit):
    loaded = {side: load_fused(path) for side, path in libs.items()}

    def use(side):
        pm._library = lambda: loaded[side]

    gen = torch.Generator(device="cuda").manual_seed(1)
    ratios = []
    for label, M, K, N, tr, act, extra in cs.mvm_cases():
        x = torch.randn((M, K), generator=gen, device="cuda").to(
            torch.bfloat16)
        wq = torch.randint(-127, 128, (N, K) if tr else (K, N), generator=gen,
                           device="cuda", dtype=torch.int8)
        ws = torch.rand((N,), generator=gen, device="cuda") * 0.05 + 0.01
        xs = photonic.a8_scale(x)
        kw = dict(transpose=tr, activation=act)
        if extra:
            kw.update(bias=torch.randn((N,), generator=gen, device="cuda").to(
                torch.bfloat16), block_perm=(2, 0, 3, 1), block=128)
        reps = max(3, reps_arg // 4) if M * K * N > 1e12 else reps_arg
        times, ratio = in_turns(
            torch, timer, use,
            lambda: pm.photonic_mvm_fused(x, wq, xs, ws, **kw), reps)
        ratios.append(ratio)
        emit({"case": label, "regime": pm.launch_plan(M, K, N, tr).regime,
              "other_ms": times["other"], "this_ms": times["this"],
              "ratio": ratio, "equal": True})
    return ratios


def flash_ab(torch, cs, fa, libs, timer, reps, emit):
    """Both flash libraries through this tree's wrapper (its argument
    types), at every chip_smoke case with head dims up to 128, the
    NaN/inf-past-kv_len cases poisoned as chip_smoke poisons them."""
    from repro_torch.kernels import build
    loaded = {}
    for side, path in libs.items():
        build._LIBS["flash_attention"] = ctypes.CDLL(str(path))
        fa._library.cache_clear()
        loaded[side] = fa._library()

    def use(side):
        fa._library = lambda: loaded[side]

    gen = torch.Generator(device="cuda").manual_seed(2)
    ratios = []
    for (label, B, Sq, L, off, kv_len, H, KV, hd, hdv, dtype,
         garbage, causal) in cs.flash_cases():
        if max(hd, hdv) > 128:
            continue
        dt = getattr(torch, dtype)
        q = torch.randn((B * H, Sq, hd), generator=gen, device="cuda").to(dt)
        k = torch.randn((B * KV, L, hd), generator=gen, device="cuda").to(dt)
        v = torch.randn((B * KV, L, hdv), generator=gen,
                        device="cuda").to(dt)
        if garbage:
            cs.poison_past(k, kv_len)
            cs.poison_past(v, kv_len)
        kw = dict(causal=causal, q_offset=off, kv_len=kv_len)
        times, ratio = in_turns(torch, timer, use,
                                lambda: fa.flash_attention(q, k, v, **kw),
                                reps)
        ratios.append(ratio)
        emit({"case": label, "variant": fa.flash_variant(dt, hd, hdv),
              "other_ms": times["other"], "this_ms": times["this"],
              "ratio": ratio, "equal": True})
    return ratios


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="root of the other checkout")
    ap.add_argument("--kernel", default="photonic_mvm_fused",
                    choices=("photonic_mvm_fused", "flash_attention"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON lines here")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("ab_fused_library: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import photonic
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import photonic_mvm as pm

    lines = []

    def emit(obj):
        lines.append(json.dumps(obj))
        print(lines[-1], flush=True)

    nvcc = build.find_nvcc()
    flags = list(build.NVCC_FLAGS)
    libs = {}
    for side, tree in (("other", args.other.resolve()), ("this", ROOT)):
        path = ROOT / "build" / "ab" / f"{args.kernel}-{side}.so"
        libs[side] = build_library(tree / "src" / "repro_torch" / "csrc",
                                   path, nvcc, flags, args.kernel)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    code = {side: sass(path, nvcc) for side, path in libs.items()}
    emit({"gpu": smi, "other": str(args.other),
          "sass_equal": (None if code["this"] is None
                         else code["this"] == code["other"])})
    timer = cs.Timer(torch)
    if args.kernel == "flash_attention":
        ratios = flash_ab(torch, cs, fa, libs, timer, args.reps, emit)
    else:
        ratios = fused_ab(torch, cs, pm, photonic, libs, timer, args.reps,
                          emit)
    emit({"summary": f"{args.kernel} this / other", "gpu": smi,
          "cases": len(ratios), "ratio_min": min(ratios),
          "ratio_median": statistics.median(ratios),
          "ratio_max": max(ratios), "sass_equal": (
              None if code["this"] is None
              else code["this"] == code["other"])})
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
