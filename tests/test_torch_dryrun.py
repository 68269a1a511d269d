"""The port's dry-run (``launch/dryrun.py``): cells walked per rank on meta
tensors at full width, the reference's SKIP statuses, the kernels' meta
rule (planned calls, never launches) and the collective census held to
real gloo ranks running the same steps."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import blend, counts, planned
from repro_torch.launch import analysis, dryrun, shardcheck
from repro_torch.launch import mesh as mesh_lib
from repro_torch.sharding import collectives as coll

import _torch_mesh_jobs as jobs

ROOT = Path(__file__).resolve().parents[1]

KEYS = ("mesh", "lower_s", "compile_s", "dropped_rules", "memory",
        "fits_one_card", "census_flops", "census_ops", "collectives",
        "analytic", "roofline", "model_flops", "useful_flops_ratio",
        "metrics", "status")
MEMORY = ("argument_size_in_bytes", "output_size_in_bytes",
          "temp_size_in_bytes", "per_device_total_gb")
ANALYTIC = ("matmul_flops", "context_flops", "overhead_flops",
            "hbm_bytes_floor", "hbm_bytes_census", "hbm_score_bytes_census")
ROOFLINE = ("t_compute_s", "t_memory_s", "t_collective_s", "dominant",
            "roofline_fraction", "t_memory_floor_s", "t_memory_kernelized_s",
            "mfu_overlapped", "mfu_serial", "mfu_kernelized")


def _check_ok(r):
    assert r["status"] == "ok", r
    for k in KEYS:
        assert k in r, k
    assert set(MEMORY) <= set(r["memory"])
    assert set(r["collectives"]) == {"bytes", "counts", "total_bytes"}
    assert set(r["collectives"]["bytes"]) == set(analysis.COLLECTIVES)
    assert set(ANALYTIC) <= set(r["analytic"])
    assert set(ROOFLINE) <= set(r["roofline"])
    m = r["memory"]
    assert m["per_device_total_gb"] == round(
        (m["argument_size_in_bytes"] + m["output_size_in_bytes"]
         + m["temp_size_in_bytes"]) / 1e9, 3)
    assert r["fits_one_card"] == (m["per_device_total_gb"] <= 80.0)
    assert r["census_flops"] > 0 and r["census_ops"] > 0
    assert r["model_flops"] == r["analytic"]["matmul_flops"]
    assert 0 < r["useful_flops_ratio"] <= 1


# the grid cells of the tests, each at its arch's full width
CELLS = {
    "minitron-rb-decode-photonic-16x16": dict(
        arch="minitron-4b", shape_name="decode_32k", reuse=True,
        execution="photonic", mesh_shape=(16, 16)),
    "jamba-long-xla": dict(arch="jamba-v0.1-52b", shape_name="long_500k"),
    "whisper-prefill": dict(arch="whisper-medium",
                            shape_name="prefill_32k"),
    "granite-train-2x16x16": dict(arch="granite-moe-1b-a400m",
                                  shape_name="train_4k",
                                  mesh_shape=(2, 16, 16)),
}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_lower_cell_walks_full_width_cells(cell):
    kw = dict(CELLS[cell])
    launches = counts.snapshot()
    r = dryrun.lower_cell(kw.pop("arch"), kw.pop("shape_name"), **kw)
    assert counts.snapshot() == launches       # no kernel launched
    _check_ok(r)
    calls = r["metrics"]["kernel_calls"]
    if r["execution"] == "photonic":
        assert calls["photonic_mvm_fused"] > 0
        # every rank's dots run sharded over "model": gathers at least
        assert r["collectives"]["counts"]["all-gather"] > 0
    else:
        # xla plans no MVM or flash; decode attention is a kernel on every
        # backend (one call a self-attention layer of a decode step)
        assert not any(v for k, v in calls.items() if k != "decode_attention")
    if r["shape"].startswith(("decode", "long")) and r["arch"] != \
            "mamba2-780m":
        assert calls["decode_attention"] > 0
    if r["shape"] == "train_4k":
        assert r["mesh"] == {"pod": 2, "data": 16, "model": 16}
        assert r["microbatch"] == 1
        # the gradient all-reduce over the data axes
        assert r["collectives"]["counts"]["all-reduce"] > 0
    if r["shape"] == "long_500k":
        # jamba's cfg.fsdp: each rank's parameter pieces are gathered over
        # the data axes where the step uses them, a block at a time
        assert r["collectives"]["counts"]["all-gather"] > 0


def test_lower_cell_lowered_only():
    r = dryrun.lower_cell("minitron-4b", "decode_32k", compile_=False,
                          mesh_shape=(1, 1))
    assert r["status"] == "lowered" and "memory" not in r
    assert r["metrics"]["kernel_calls"] == {}


SKIPS = [("deepseek-7b", "long_500k", {}),
         ("minitron-4b", "train_4k", {"execution": "photonic"}),
         ("minitron-4b", "prefill_32k", {"noise": "gain=0.01"}),
         ("minitron-4b", "prefill_32k", {"noise": "gain=0.01",
                                         "execution": "photonic",
                                         "mesh_shape": (2, 2)})]

REFERENCE_SKIPS = r'''
import json, sys
from repro.launch import dryrun as d
cells = json.loads(sys.argv[1])
print(json.dumps([d.lower_cell(a, s, **{k: (tuple(v) if k == "mesh_shape"
                                              else v) for k, v in kw.items()})
                  for a, s, kw in cells]))
'''


def test_skip_statuses_equal_the_reference():
    env = dict(os.environ, REPRO_DRYRUN_DEVICES="4", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", REFERENCE_SKIPS, json.dumps(SKIPS)], env=env,
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    for (arch, shape, kw), w in zip(SKIPS, want):
        got = dryrun.lower_cell(arch, shape, **kw)
        assert got["status"] == w["status"]
        assert got["status"].startswith("SKIP(")
        for k in ("arch", "shape", "reuse", "multi_pod", "tag",
                  "execution"):
            assert got[k] == w[k]


def test_photonic_walks_plan_flash_fused_and_resident_calls():
    """A photonic prefill of 1024 rows on 1x1 plans tensor-core flash per
    layer; granite R&B with blended experts (``num_basic_experts=8``, as
    chip_smoke builds it) plans the resident MVM, 480 a pass; a mamba2
    prefill ``ssd_chunk`` once per layer (48)."""
    cfg = dataclasses.replace(get_arch("minitron-4b", reuse=True),
                              execution="photonic")
    before = counts.snapshot()
    r = dryrun.walk(cfg, ShapeConfig("p1k", 1024, 1, "prefill"), "1x1")
    calls = r["metrics"]["kernel_calls"]
    assert calls["flash_attention"] == calls["flash_attention_mma"] == 32
    assert calls["flash_attention_causal"] == 32
    assert calls["photonic_mvm_fused"] == 225
    assert calls["photonic_mvm_fused_gemv"] == 0
    g = get_arch("granite-moe-1b-a400m", reuse=True)
    g = dataclasses.replace(g, execution="photonic", moe=dataclasses.replace(
        g.moe, num_basic_experts=8))
    r = dryrun.walk(g, ShapeConfig("d", 64, 4, "decode"), "1x1")
    assert r["metrics"]["kernel_calls"]["photonic_mvm_resident"] == 480
    assert r["metrics"]["kernel_calls"]["photonic_mvm_fused_gemv"] > 0
    m = dataclasses.replace(get_arch("mamba2-780m", reuse=True),
                            execution="photonic")
    r = dryrun.walk(m, ShapeConfig("p", 600, 1, "prefill"), "1x1")
    assert r["metrics"]["kernel_calls"]["ssd_chunk"] == 48
    assert counts.snapshot() == before


def test_noise_cells_walk_the_split_wrappers():
    launches = counts.snapshot()
    r = dryrun.lower_cell("minitron-4b", "decode_32k", reuse=True,
                          execution="photonic", mesh_shape=(1, 1),
                          noise="gain=0.01,ct=0.002,dac=0.25,drift=0.05")
    assert counts.snapshot() == launches
    _check_ok(r)
    calls = r["metrics"]["kernel_calls"]
    assert calls["photonic_mvm"] > 0 and calls["photonic_mvm_t"] > 0
    assert calls["photonic_mvm_fused"] == 0


def test_blend_shuffle_meta_rule():
    x = torch.empty((5, 256), dtype=torch.bfloat16, device="meta")
    bias = torch.empty((256,), dtype=torch.bfloat16, device="meta")
    launches = counts.snapshot()
    before = planned.snapshot()["blend_shuffle"]
    y = blend.blend_shuffle(x, bias, [1, 0], block=128, activation="relu")
    assert y.device.type == "meta" and y.shape == x.shape
    assert y.dtype == x.dtype
    assert planned.snapshot()["blend_shuffle"] == before + 1
    assert counts.snapshot() == launches
    with pytest.raises(ValueError):
        blend.blend_shuffle(x, bias, [0, 0], block=128)


def test_census_mesh_refuses_other_tensors():
    mesh = mesh_lib.census_mesh("2x2", rank=3)
    assert mesh.coords == (1, 1) and mesh.transport == "census"
    with pytest.raises(ValueError, match="meta"):
        coll.psum(torch.ones(3), mesh, "model")
    with pytest.raises(ValueError, match="meta"):
        coll.all_gather(torch.ones(3), mesh, "data")
    x = torch.empty((4, 6), device="meta")
    with coll.recording() as rec:
        assert coll.all_gather(x, mesh, ("data", "model"), dim=0).shape \
            == (16, 6)
        assert coll.psum_scatter(x, mesh, "model", dim=1).shape == (4, 3)
        assert coll.ppermute_ring(x, mesh, "model").shape == (4, 6)
        assert coll.pmax(x, mesh, "data").shape == (4, 6)
        coll.barrier(mesh)
    assert rec == [("all-gather", 16 * 6 * 4), ("reduce-scatter", 4 * 3 * 4),
                   ("collective-permute", 4 * 6 * 4),
                   ("all-reduce", 4 * 6 * 4)]


# -------------------------------------------------------------------------
# the census against real gloo ranks on 2x2
# -------------------------------------------------------------------------
def _gloo_cells():
    variants = shardcheck.variant_cfgs()
    rb, moe = variants["rb"], variants["moe"]
    pre = ShapeConfig("p", 16, 4, "prefill")
    return {
        "prefill": (dataclasses.replace(rb, execution="photonic"), pre),
        "decode": (dataclasses.replace(rb, execution="photonic"),
                   ShapeConfig("d", 24, 4, "decode")),
        "moe_prefill": (dataclasses.replace(moe, execution="photonic"), pre),
        "train": (rb, ShapeConfig("t", 16, 4, "train")),
        "train_fsdp": (dataclasses.replace(rb, fsdp=True),
                       ShapeConfig("t", 16, 4, "train")),
        "moe_train": (moe, ShapeConfig("t", 16, 4, "train")),
    }


@pytest.fixture(scope="module")
def gloo_records():
    return mesh_lib.init_ranks(jobs.census_rank, "2x2", device="cpu",
                               args=(_gloo_cells(),), threads=1)


@pytest.mark.parametrize("name", sorted(_gloo_cells()))
def test_census_collectives_equal_a_gloo_run(gloo_records, name):
    cfg, shape = _gloo_cells()[name]
    for rank, recorded in enumerate(gloo_records):
        got = dryrun.walk(cfg, shape, "2x2", rank=rank)["collectives"]
        want = analysis.collective_census(recorded[name])
        assert got == want, (name, rank)
        assert want["total_bytes"] > 0
