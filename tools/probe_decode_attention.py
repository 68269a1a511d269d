"""Build the decode-attention kernel alone and run ``chip_smoke.py``'s checks
of it (``check_decode_attention``: every serving shape against the plain
version, batch and head invariance, the partial form over pieces, the
kernel's, plain version's and SDPA's median times and the bound).  Prints
the card, the build's ``-Xptxas=-v`` report and one JSON line per case.

    python3 tools/probe_decode_attention.py     # ~30 s on an H100
"""
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


def main() -> int:
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
    cs.check_decode_attention(torch, cs.Timer(torch), da)
    print(f"ok in {time.perf_counter() - t0:.1f} s, {da.launches} launches")
    return 0


if __name__ == "__main__":
    sys.exit(main())
