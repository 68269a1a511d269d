"""Walk ``Program.build`` of each architecture on meta tensors and report
whether its build fits one 80 GB card.

    PYTHONPATH=src python tools/dryrun_build.py [--no-reuse] [--out F.json]

A build on the card starts from the float32 parameters on the device
(``tfm.init_model``, as chip_smoke's paths do) and programs the bank from
them; this walks the same ``api.Program.build`` on ``abstract_params``
under the dry-run's census (``launch/analysis.OpCensus``) and prints, per
architecture and execution, the float32 parameters' bytes, the built
bank's bytes and the peak of live bytes during the build.  Host only: no
card and no memory.  A model of the card's allocator, not a measurement.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from repro_torch import api
from repro_torch.configs import ARCHS, get_arch
from repro_torch.core.costmodel import H100
from repro_torch.launch import analysis
from repro_torch.models import transformer as tfm


def build_walk(cfg, execution: str) -> dict:
    """Bytes of ``Program.build(cfg, float32 params)`` walked on meta."""
    census = analysis.OpCensus()
    t0 = time.time()
    params = tfm.abstract_params(cfg)
    with census:
        census.arguments(params)
        prog = api.Program.build(cfg, params, execution=execution,
                                 device="meta")
        bank = census.outputs(prog.bank)
    return {"arch": cfg.name, "execution": execution,
            "float_params_bytes": census.argument_bytes,
            "bank_bytes": bank, "build_peak_bytes": census.peak,
            "fits_one_card": census.peak <= H100.hbm_bytes,
            "walk_s": round(time.time() - t0, 2)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-reuse", action="store_true",
                    help="the archs without their R&B plans")
    ap.add_argument("--out", default=None, help="write JSON here")
    args = ap.parse_args(argv)
    rows = []
    for arch in sorted(ARCHS):
        cfg = get_arch(arch, reuse=not args.no_reuse)
        for execution in ("photonic", "xla"):
            r = build_walk(cfg, execution)
            rows.append(r)
            print(f"{arch:25s} {execution:8s} "
                  f"params {r['float_params_bytes'] / 1e9:8.3f} GB  "
                  f"bank {r['bank_bytes'] / 1e9:8.3f} GB  "
                  f"peak {r['build_peak_bytes'] / 1e9:8.3f} GB  "
                  f"fits {r['fits_one_card']}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
