"""The dry-run's accounting against the JAX reference's: parameter counts,
``model_flops``, every ``analytic_cost`` field, the grid's applicability
rule and the input specs, for every architecture x shape x reuse.

Importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` for its whole process,
so the reference's numbers come from one subprocess for this module (one
host device, the CPU platform) and cross as JSON, which carries Python
floats exactly."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import (ARCHS, SHAPES, batch_specs, get_arch,
                                 input_specs, shape_supported)
from repro_torch.core import obu as t_obu
from repro_torch.launch import analysis as t_analysis
from repro_torch.launch import dryrun as t_dryrun

ROOT = Path(__file__).resolve().parents[1]
ARCH_NAMES = sorted(ARCHS)
SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")

REFERENCE = r'''
import dataclasses, json, sys
import jax
from repro.launch import dryrun as d
from repro.launch import analysis as a
from repro.configs import (ARCHS, SHAPES, get_arch, input_specs,
                           shape_supported)

def leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(k.key) if hasattr(k, "key") else str(k)
                     for k in path): [list(x.shape), str(x.dtype)]
            for path, x in flat}

out = {}
for arch in sorted(ARCHS):
    for reuse in (False, True):
        cfg = get_arch(arch, reuse=reuse)
        act = d.active_param_count(cfg)
        tot = d.total_param_count(cfg)
        cell = {"active": act, "total": tot, "shapes": {},
                "layer_census": list(a._layer_census(cfg))}
        for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            shape = SHAPES[name]
            c = a.analytic_cost(cfg, shape, act, tot)
            ok, why = shape_supported(cfg, shape)
            spec = input_specs(cfg, shape)
            cell["shapes"][name] = {
                "model_flops": d.model_flops(cfg, shape),
                "analytic": [c.matmul_flops, c.context_flops,
                             c.overhead_flops, c.hbm_bytes, c.total_flops],
                "cache_bytes": a._cache_bytes(cfg, shape.global_batch,
                                              shape.seq_len),
                "supported": [ok, why],
                "specs": leaves(spec)}
        out[f"{arch}|{reuse}"] = cell
json.dump(out, sys.stdout)
'''


@pytest.fixture(scope="module")
def ref():
    env = dict(os.environ, REPRO_DRYRUN_DEVICES="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", REFERENCE], env=env,
                          capture_output=True, text=True, timeout=600,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], path + (k,)))
        return out
    return {"/".join(path): [list(tree.shape),
                             str(tree.dtype).replace("torch.", "")]}


@pytest.mark.parametrize("reuse", [False, True])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_counts_flops_and_analytic_cost_equal_the_reference(ref, arch,
                                                            reuse):
    want = ref[f"{arch}|{reuse}"]
    cfg = get_arch(arch, reuse=reuse)
    act = t_dryrun.active_param_count(cfg)
    tot = t_dryrun.total_param_count(cfg)
    assert act == want["active"]
    assert tot == want["total"]
    assert list(t_analysis._layer_census(cfg)) == want["layer_census"]
    for name in SHAPE_NAMES:
        shape = SHAPES[name]
        w = want["shapes"][name]
        c = t_analysis.analytic_cost(cfg, shape, act, tot)
        assert t_dryrun.model_flops(cfg, shape) == w["model_flops"]
        assert [c.matmul_flops, c.context_flops, c.overhead_flops,
                c.hbm_bytes, c.total_flops] == w["analytic"], name
        assert t_analysis._cache_bytes(
            cfg, shape.global_batch, shape.seq_len) == w["cache_bytes"]


@pytest.mark.parametrize("reuse", [False, True])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_shape_supported_and_input_specs_match_the_reference(ref, arch,
                                                             reuse):
    """Leaf by leaf by path, in shape and dtype: the batch, the decode
    caches of ``tfm.init_caches`` and the 0-d position."""
    want = ref[f"{arch}|{reuse}"]
    cfg = get_arch(arch, reuse=reuse)
    for name in SHAPE_NAMES:
        shape = SHAPES[name]
        w = want["shapes"][name]
        assert list(shape_supported(cfg, shape)) == w["supported"]
        spec = input_specs(cfg, shape)
        assert all(t.device.type == "meta"
                   for t in _leaves_tensors(spec)), name
        assert _leaves(spec) == w["specs"], name
        assert _leaves(batch_specs(cfg, shape)) == {
            k[len("batch/"):]: v for k, v in w["specs"].items()
            if k.startswith("batch/")}


def _leaves_tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves_tensors(v)]
    return [tree]


def test_tables_and_score_rule_equal_the_reference():
    from repro.launch import analysis as j_analysis

    assert t_analysis.DTYPE_BYTES == j_analysis.DTYPE_BYTES
    assert t_analysis.COLLECTIVES == j_analysis.COLLECTIVES
    seq = 4096
    excl = (4096, 128256, 14336, 4096)
    for shape in [(32, 4096, 4096), (8, 2048, 8192), (1024, 4096 * 3),
                  (4, 1000, 4096), (2, 4096, 4096 * 129), (4096, 128256),
                  (4096,), (16, 2048, 8192 + 1), (2048, 14336)]:
        text = "f32[" + ",".join(map(str, shape)) + "]{0}"
        assert t_analysis._is_score_shape(shape, seq, excl) == \
            j_analysis._is_score_shape(text, seq, excl), shape


@pytest.mark.parametrize("transpose", [False, True])
def test_bf16_blend_dot_under_the_flag_matches_the_reference(transpose):
    """``set_matmul_accum_fp32(False)``: a bf16 x bf16 product in bf16,
    held to the reference's under the same flag within one bf16 ulp of
    the output; the default (True) is the float32 product, and each flag
    is reset after."""
    import jax.numpy as jnp
    from repro.core import obu as j_obu

    rng = np.random.default_rng(7)
    x = rng.standard_normal((6, 96)).astype(np.float32)
    w = rng.standard_normal((96, 96) if transpose else (96, 80)
                            ).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    xj, wj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    assert t_obu._ACCUM_FP32 is True and t_obu._pref(xt) == torch.float32
    default = t_obu.blend_dot(xt, wt, transpose=transpose)
    want_default = torch.matmul(
        xt.float(), (wt.T if transpose else wt).float()).to(torch.bfloat16)
    assert torch.equal(default, want_default)
    j_prev = j_obu._ACCUM_FP32
    try:
        t_obu.set_matmul_accum_fp32(False)
        j_obu.set_matmul_accum_fp32(False)
        assert t_obu._pref(xt) == torch.bfloat16
        assert t_obu._pref(xt.float()) == torch.float32
        got = t_obu.blend_dot(xt, wt, transpose=transpose)
        ref = np.asarray(j_obu.blend_dot(xj, wj, transpose=transpose)
                         .astype(jnp.float32))
    finally:
        t_obu.set_matmul_accum_fp32(True)
        j_obu.set_matmul_accum_fp32(j_prev)
    assert got.dtype == torch.bfloat16
    g = got.float().numpy()
    ulp = np.abs(ref) * 2.0 ** -7 + 1e-30
    assert np.all(np.abs(g - ref) <= ulp)
    assert t_obu._ACCUM_FP32 is True
