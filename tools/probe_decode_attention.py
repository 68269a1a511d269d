"""Build the decode-attention kernel alone and run ``chip_smoke.py``'s checks
of it (``check_decode_attention``: every serving shape against the plain
version, batch and head invariance, the partial form over pieces, the
kernel's, plain version's and SDPA's median times and the bound).  Prints
the card, the build's ``-Xptxas=-v`` report and one JSON line per case,
then, per case, the ``torch.profiler`` device time of each CUDA kernel of
one call by name (``"phase": "kernel_profile"``) and the call's achieved
share of its bound (bound ms / median ms).

Then the edge cases the serving shapes do not reach (``"phase": "edge"``):
G 5 and 16, hd 80, hd 100 (bf16 rows not 16-byte aligned: the element
copy; float32: a zero-filled pad), hd 256 in float32, a cache nobody has
seen, one position, the partial form with and without the new token;
each against the plain version at the card's gates and bit-equal row by
row to the rows called alone.

``--variants`` also builds the source once per variant of its constants
(``split=128,stages=8`` -> ``-DDECODE_SPLIT=128 -DDECODE_STAGES=8``,
one ``nvcc`` each, all started together), holds each build to the plain
version and times it at the four bf16 serving shapes, the variants in
turns (one line per variant and case, ``"phase": "variant"``).

``--trace`` builds the source with ``-DDECODE_TRACE`` (and a variant's
macros, or ``default``): thread 0 of every block records the card's
%globaltimer and its SM's clock64 at each phase of its work, and the probe
prints, per serving case, each phase's median and largest time across the
blocks and the kernel's span from the first block's start to the last
join's end (``"phase": "trace"``).  The phases: q and the new K / V
staged, the positions read and the first copies issued; the K rows
scored; the split's softmax; the V rows; the warps' join; the arrival
count (the last block of a row with more than one split); the join of
the splits, and its parts (the P V loads issued, the max and sums, the
barrier, the outputs).

    python3 tools/probe_decode_attention.py                    # ~1 min on an H100
    python3 tools/probe_decode_attention.py --variants split=128 split=512
    python3 tools/probe_decode_attention.py --trace default split=128
"""
import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402

FLUSH_KERNEL = "FillFunctor"     # the Timer's L2 flush (``zero_``)


def kernel_profile(timer, fn, reps: int) -> dict:
    """Mean device ms a launch and launches per call of every CUDA kernel
    ``fn`` runs, by name, over ``reps`` calls each after an L2 flush (the
    flush's own kernel left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            timer.flush_buf.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or FLUSH_KERNEL in ev.key:
            continue
        out[ev.key[:160]] = {
            "group": cs.kernel_group(ev.key),
            "ms_a_launch": ev.self_device_time_total / ev.count / 1e3,
            "launches_a_call": ev.count / reps}
    return out


def profile_cases(timer, rows) -> None:
    gen = torch.Generator(device="cuda").manual_seed(31)
    for (label, B, L, H, KV, hd, dtype), row in zip(
            cs.decode_attention_cases(), rows):
        args = cs.decode_attention_inputs(torch, gen, B, L, H, KV, hd,
                                          getattr(torch, dtype))
        kernels = kernel_profile(timer, lambda: da.decode_attention(*args),
                                 20)
        cs.emit({"phase": "kernel_profile", "case": label,
                 "kernels": kernels,
                 "profiled_ms_a_call": sum(
                     k["ms_a_launch"] * k["launches_a_call"]
                     for k in kernels.values()),
                 "ms": row["ms"], "bound_ms": row["bound_ms"],
                 "bound_share": row["bound_ms"] / row["ms"],
                 "library_ms": row["library_ms"]})


MACROS = {"split": "DECODE_SPLIT", "stages": "DECODE_STAGES"}


def build_variants(specs, extra=(), tag="variant") -> dict:
    """One library per variant, built from the checkout's source with its
    ``-D`` macros (and ``extra`` flags) beside the default build: {spec:
    (lib, fn, split)}; ``default`` names the source's own constants."""
    src = build.csrc_dir() / build.SOURCES["decode_attention"]
    out_dir = build.build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for j, spec in enumerate(specs):
        defs = [f"-D{MACROS[k]}={int(v)}" for k, v in
                (kv.split("=") for kv in spec.split(",") if kv != "default")]
        defs += list(extra)
        lib = out_dir / f"decode_attention-{tag}{j}.so"
        procs[spec] = (lib, subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, *defs, "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for spec, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        print(f"{spec}:\n{log.decode(errors='replace')}", flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {spec}")
        libs[spec] = da._bind(ctypes.CDLL(str(lib)))
    return libs


def time_variants(timer, libs, rounds: int = 2) -> None:
    """Each variant against the plain version, then timed at the four bf16
    serving shapes in turns (a, b, c, c, b, a, ...): median of the rounds'
    medians."""
    own = da._library
    gen = torch.Generator(device="cuda").manual_seed(31)
    cases = [c for c in cs.decode_attention_cases() if c[-1] == "bfloat16"]
    inputs = [cs.decode_attention_inputs(torch, gen, B, L, H, KV, hd,
                                         torch.bfloat16)
              for _, B, L, H, KV, hd, _ in cases]
    order = list(libs)
    times = {(v, c[0]): [] for v in order for c in cases}
    errs = {}
    try:
        for r in range(2 * rounds):
            for v in (order if r % 2 == 0 else order[::-1]):
                da._library = lambda b=libs[v]: b
                for case, args in zip(cases, inputs):
                    if r == 0:
                        got = da.decode_attention(*args)
                        errs[(v, case[0])] = cs.rel_l2(
                            got, da.decode_attention_plain(*args))
                    times[(v, case[0])].append(
                        timer.ms(lambda: da.decode_attention(*args), 20))
    finally:
        da._library = own
    for (v, label), ts in times.items():
        cs.emit({"phase": "variant", "variant": v, "split": libs[v][2],
                 "case": label, "ms": statistics.median(ts),
                 "ms_each_round": ts, "rel_l2": errs[(v, label)],
                 "ok": errs[(v, label)] <= cs.DECODE_ATTN_TOL})


# (phase, the points it may start from (the first one a block passed),
# the point it ends at): the kernel's trace points 0-11
PHASES = (("q, positions, first copies", (0,), 1), ("K rows", (1,), 2),
          ("softmax", (2,), 3), ("V rows", (3,), 4), ("warp join", (4,), 5),
          ("arrival", (5,), 6), ("join", (6, 5), 7),
          ("join: P V loads issued", (6, 5), 8),
          ("join: max and sums", (8,), 9), ("join: barrier", (9,), 10),
          ("join: outputs", (10,), 7))
TRACE_POINTS = 12


def trace_cases(timer, libs) -> None:
    """Per variant and serving case, one call after an L2 flush with the
    trace on: each phase's median and largest time across the blocks
    (globaltimer ns; clock64 cycles), and the span from the first block's
    start to the last block's end, with each row's span."""
    import numpy as np
    own = da._library
    gen = torch.Generator(device="cuda").manual_seed(31)
    try:
        for spec, bound in libs.items():
            lib, _, split = bound
            tr = lib.decode_attention_trace
            tr.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            tr.restype = ctypes.c_int
            da._library = lambda b=bound: b
            for label, B, L, H, KV, hd, dtype in cs.decode_attention_cases():
                args = cs.decode_attention_inputs(
                    torch, gen, B, L, H, KV, hd, getattr(torch, dtype))
                da.decode_attention(*args)
                torch.cuda.synchronize()
                assert tr(None, 0, 1) == 0
                timer.flush_buf.zero_()
                torch.cuda.synchronize()
                da.decode_attention(*args)
                torch.cuda.synchronize()
                nsplit = max(1, -(-L // split))
                blocks = nsplit * KV * B
                buf = (ctypes.c_ulonglong * (blocks * TRACE_POINTS * 2))()
                assert tr(buf, blocks, 0) == 0
                t = np.array(buf, dtype=np.float64).reshape(
                    B, KV, nsplit, TRACE_POINTS, 2)
                ran = t[..., 1, 0] > 0          # blocks that did not exit
                start = t[..., 0, 0][ran].min()
                phases = {}
                for name, starts, end in PHASES:
                    ns_, cyc = [], []
                    for idx in zip(*np.nonzero(ran)):
                        pt = t[idx]
                        p0 = next((p for p in starts if pt[p, 0]), None)
                        if pt[end, 0] == 0 or p0 is None:
                            continue
                        ns_.append(pt[end, 0] - pt[p0, 0])
                        cyc.append(pt[end, 1] - pt[p0, 1])
                    if ns_:
                        phases[name] = {
                            "blocks": len(ns_),
                            "median_ns": float(np.median(ns_)),
                            "max_ns": float(np.max(ns_)),
                            "median_cycles": float(np.median(cyc)),
                            "max_cycles": float(np.max(cyc))}
                ends = t[..., 7, 0]
                cs.emit({"phase": "trace", "variant": spec, "split": split,
                         "case": label, "active_blocks": int(ran.sum()),
                         "span_ns": float(ends.max() - start),
                         "row_span_ns": [float(ends[b].max() - start)
                                         for b in range(B)],
                         "start_spread_ns": float(
                             t[..., 0, 0][ran].max() - start),
                         "phases": phases})
    finally:
        da._library = own


def edge_cases() -> bool:
    """(label, B, L, H, KV, hd, dtype, positions, offset, partial,
    with_new) beyond the serving shapes; each held to the plain version
    and, row by row, to the row called alone."""
    cases = [("G5 hd80", 3, 700, 10, 2, 80, "bfloat16", [0, 1, 700], 0,
              False, True),
             ("G16 hd256 f32", 2, 600, 16, 1, 256, "float32", [513, 77], 0,
              False, True),
             ("hd100 element copy", 2, 300, 4, 4, 100, "bfloat16",
              [299, 256], 0, False, True),
             ("hd100 f32 zero-filled pad", 2, 300, 6, 3, 100, "float32",
              [300, 5], 0, False, True),
             ("G8 hd16 one split", 3, 40, 8, 1, 16, "float32", [40, 0, 3],
              0, False, True),
             ("partial, nothing seen", 2, 512, 24, 8, 128, "bfloat16",
              [100, 200], 300, True, False),
             ("partial with new", 2, 512, 24, 8, 128, "bfloat16",
              [700, 300], 100, True, True),
             ("partial without new", 2, 512, 16, 8, 64, "float32",
              [700, 400], 100, True, False)]
    gen = torch.Generator(device="cuda").manual_seed(7)
    ok_all = True
    for label, B, L, H, KV, hd, dtype, pos, off, partial, with_new in cases:
        dt = getattr(torch, dtype)
        tol = cs.DECODE_ATTN_TOL if dt == torch.bfloat16 \
            else cs.DECODE_ATTN_F32_TOL

        def r(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dt)
        args = (r(B, 1, H, hd), r(B, L, KV, hd), r(B, L, KV, hd),
                r(B, 1, KV, hd), r(B, 1, KV, hd),
                torch.tensor(pos, dtype=torch.long, device="cuda"))
        if partial:
            def call(*a):
                return torch.cat([t.reshape(a[0].shape[0], -1) for t in
                                  da.decode_attention_partial(
                                      *a, offset=off, with_new=with_new)],
                                 dim=1)
            got = call(*args)
            want = torch.cat([t.reshape(B, -1) for t in
                              da.decode_attention_partial_plain(
                                  *args, offset=off, with_new=with_new)],
                             dim=1)
            # rows nobody sees hold m = NEG_INF: compare where finite
            keep = want.abs() < 1e29
            err = cs.rel_l2(got[keep], want[keep])
            exact = torch.equal(got[~keep], want[~keep])
        else:
            call = da.decode_attention
            got = call(*args)
            want = da.decode_attention_plain(*args)
            err, exact = cs.rel_l2(got, want), True
        torch.cuda.synchronize()
        alone = all(torch.equal(call(*(t[i:i + 1] for t in args)),
                                got[i:i + 1]) for i in range(B))
        ok = bool(err <= tol and exact and alone
                  and torch.isfinite(got[got.abs() < 1e29]).all())
        ok_all &= ok
        cs.emit({"phase": "edge", "case": label, "rel_l2": err,
                 "batch_invariant": alone, "ok": ok})
    return ok_all


def warm_up(timer) -> None:
    """Half a second of L2 flushes, so the first timed case does not meet
    an idle card's clocks."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.5:
        timer.flush_buf.zero_()
        torch.cuda.synchronize()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="*", default=[],
                    help="variants of the kernel's constants to build and "
                         "time, e.g. split=128 split=512,stages=6")
    ap.add_argument("--trace", nargs="*", default=[],
                    help="variants (or 'default') to build with "
                         "-DDECODE_TRACE and trace phase by phase")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_decode_attention: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    print(build.build(["decode_attention"]), flush=True)
    print(build.library_path("decode_attention").with_suffix(".log")
          .read_text(), flush=True)
    timer = cs.Timer(torch)
    warm_up(timer)
    rows = cs.check_decode_attention(torch, timer, da)
    profile_cases(timer, rows)
    ok = edge_cases()
    if args.variants:
        time_variants(timer, build_variants(args.variants))
    if args.trace:
        trace_cases(timer, build_variants(args.trace, ["-DDECODE_TRACE"],
                                          "trace"))
    print(json.dumps({"ok": ok, "seconds": time.perf_counter() - t0,
                      "launches": da.launches}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
