#!/usr/bin/env python3
"""Time the fused W8A8 MVM library of this checkout against another
checkout's, in one process, on one NVIDIA GPU.

    python3 tools/ab_fused_library.py --other DIR [--reps N] [--out FILE]

DIR is the root of another checkout (for example the parent commit,
unpacked with ``git archive``).  Both trees' ``photonic_mvm_fused.cu`` are
built with the same ``nvcc`` flags (``kernels/build.py``), each into its
own library under ``build/ab/``, and both are driven through this tree's
wrapper (``photonic_mvm_fused``: same plan, same workspaces) at every
``chip_smoke.mvm_cases`` shape.  The two libraries are timed in turns
(other, this, this, other) with ``chip_smoke.Timer`` (CUDA events, L2
flushed before each launch); each case reports both medians and their
ratio, and the outputs of the two libraries must be equal bit for bit.
Where ``cuobjdump`` is found, the script also reports whether the two
libraries' machine code (SASS) is the same.

Use it when an edit touches a source or header the fused kernel includes:
its code generation has moved with code it does not run (PERF.md).  One
JSON object per line; the last is the summary.  Without a CUDA device it
exits non-zero.
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


def build_library(csrc: Path, out: Path, nvcc: str, flags) -> Path:
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([nvcc, *flags, "-o", str(out),
                           str(csrc / "photonic_mvm_fused.cu")],
                          capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {csrc}:\n{proc.stderr}")
    return out


def load(path: Path):
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="root of the other checkout")
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
    from repro_torch.kernels import photonic_mvm as pm

    lines = []

    def emit(obj):
        lines.append(json.dumps(obj))
        print(lines[-1], flush=True)

    nvcc = build.find_nvcc()
    flags = list(build.NVCC_FLAGS)
    libs = {}
    for side, tree in (("other", args.other.resolve()), ("this", ROOT)):
        path = ROOT / "build" / "ab" / f"photonic_mvm_fused-{side}.so"
        libs[side] = build_library(tree / "src" / "repro_torch" / "csrc",
                                   path, nvcc, flags)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    code = {side: sass(path, nvcc) for side, path in libs.items()}
    emit({"gpu": smi, "other": str(args.other),
          "sass_equal": (None if code["this"] is None
                         else code["this"] == code["other"])})
    loaded = {side: load(path) for side, path in libs.items()}

    def use(side):
        pm._library = lambda: loaded[side]

    timer = cs.Timer(torch)
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
        outs, times = {}, {"other": [], "this": []}
        for side in ("other", "this", "this", "other"):
            use(side)
            outs[side] = pm.photonic_mvm_fused(x, wq, xs, ws, **kw)
            reps = max(3, args.reps // 4) if M * K * N > 1e12 else args.reps
            times[side].append(timer.ms(
                lambda: pm.photonic_mvm_fused(x, wq, xs, ws, **kw), reps))
        torch.cuda.synchronize()
        if not torch.equal(outs["this"], outs["other"]):
            raise AssertionError(f"{label}: the two libraries differ")
        other_ms = statistics.median(times["other"])
        this_ms = statistics.median(times["this"])
        ratios.append(this_ms / other_ms)
        emit({"case": label, "regime": pm.launch_plan(M, K, N, tr).regime,
              "other_ms": times["other"], "this_ms": times["this"],
              "ratio": this_ms / other_ms, "equal": True})
    emit({"summary": "photonic_mvm_fused this / other", "gpu": smi,
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
