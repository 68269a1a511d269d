"""The port's MoE layer against the JAX reference on the same weights
(bridged through numpy): routing, the blended experts' gate permutations,
``apply_moe`` on both backends and both OBU orientations, shared experts
with a dense ``pre`` segment, and the init.

Tolerances: the dispatch and combine one-hots are exactly equal (0/1 and
bf16 values: the routing is float32 and the top-k order is the
reference's); the aux losses within 1e-6; xla outputs rel-L2 <= 1e-5
(float32 matmuls summed in another order); photonic rel-L2 <= 1e-3 — the
A8 activation grid is per tensor (per stream on the resident path), and a
one-ulp float32 difference can move a value across a rounding boundary,
which moves the output by far more than an ulp.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import api as j_api
from repro.configs import smoke_variant as j_smoke
from repro.configs.base import MoEConfig as JMoE
from repro.core import prepared as j_prep
from repro.core.backend import Backend as JBackend
from repro.models import moe as j_moe
from repro.models import transformer as j_tfm
from repro.train.checkpoint import _flatten

from repro_torch import api as t_api
from repro_torch import bridge
from repro_torch.configs import smoke_variant as t_smoke
from repro_torch.configs.base import MoEConfig as TMoE
from repro_torch.core import prepared as t_prep
from repro_torch.core.backend import Backend as TBackend
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_tfm

torch.set_num_threads(2)
TOL = {"xla": 1e-5, "photonic": 1e-3}
D = 64


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _cfgs(**kw):
    base = dict(num_experts=4, top_k=2, d_ff_expert=32, capacity_factor=4.0)
    base.update(kw)
    return JMoE(**base), TMoE(**base)


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


# -------------------------------------------------------------------------
# routing
# -------------------------------------------------------------------------
@pytest.mark.parametrize("kw,G,g", [
    ({}, 2, 16),
    ({"capacity_factor": 0.5}, 3, 16),          # tokens dropped
    ({"num_experts": 8, "top_k": 3, "capacity_factor": 1.0}, 1, 40),
])
def test_route_matches_reference_exactly(kw, G, g):
    jc, tc = _cfgs(**kw)
    rng = np.random.default_rng(0)
    xg = rng.standard_normal((G, g, D)).astype(np.float32)
    xg[0, :3] = 0.0          # zero tokens: every expert ties, the lower
    #                          indices win (jax.lax.top_k's order)
    router = (rng.standard_normal((D, jc.num_experts)) * 0.5).astype(
        np.float32)
    jd, jcomb, jaux = j_moe.route({"router": jnp.asarray(router)},
                                  jnp.asarray(xg), jc)
    td, tcomb, taux = t_moe.route({"router": torch.as_tensor(router)},
                                  torch.as_tensor(xg), tc)
    assert td.dtype == tcomb.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(td), np.asarray(jd, np.float32))
    np.testing.assert_array_equal(_np(tcomb), np.asarray(jcomb, np.float32))
    for k in ("load_balance", "dropped_frac"):
        assert abs(float(taux[k]) - float(jaux[k])) <= 1e-6
    if kw.get("capacity_factor", 4.0) < 1.0:
        assert float(taux["dropped_frac"]) > 0.0
    # the tied tokens went to experts 0..K-1
    picked = _np(td)[0, :3].sum(-1) > 0                   # (3, E)
    assert picked[:, :jc.top_k].all() and not picked[:, jc.top_k:].any()


def test_group_shape_and_capacity_match_reference():
    for kw in ({}, {"group_tokens": 256, "num_experts": 32, "top_k": 8,
                    "d_ff_expert": 512, "capacity_factor": 1.25}):
        jc, tc = _cfgs(**kw)
        for n in (1, 2, 4, 7, 48, 304, 512, 1200, 2048):
            assert t_moe._group_shape(n, tc) == j_moe._group_shape(n, jc)
            g = t_moe._group_shape(n, tc)[1]
            assert t_moe._capacity(g, tc) == j_moe._capacity(g, jc)


@pytest.mark.parametrize("E,Rp,f", [(32, 8, 512), (4, 2, 32), (8, 2, 6)])
def test_expert_gate_perms_match_reference(E, Rp, f):
    jc, tc = _cfgs(num_experts=E, num_basic_experts=Rp, d_ff_expert=f)
    np.testing.assert_array_equal(
        t_moe._expert_gate_perms(tc).numpy(),
        np.asarray(j_moe._expert_gate_perms(jc)))


# -------------------------------------------------------------------------
# apply_moe
# -------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _layer(blended, shared):
    kw = {"num_basic_experts": 2} if blended else {}
    if shared:
        kw.update(num_shared=1, d_ff_shared=48)
    jc, tc = _cfgs(**kw)
    p, _ = j_moe.init_moe(jax.random.PRNGKey(1), D, jc)
    return jc, tc, p, bridge.params_from_flat(_flatten(p), device="cpu")


@pytest.mark.parametrize("execution", ["xla", "photonic"])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("blended,shared", [(False, False), (True, False),
                                            (True, True)])
def test_apply_moe_matches_reference(execution, transpose, blended, shared):
    jc, tc, jp, tp = _layer(blended, shared)
    if execution == "photonic":
        jp = j_prep.prepare_params(jp, "float32", True)
        tp = t_prep.prepare_params(tp, "float32", True)
    x = np.random.default_rng(2).standard_normal((2, 12, D)).astype(
        np.float32)
    jy, jaux = j_moe.apply_moe(jp, jnp.asarray(x), jc, transpose=transpose,
                               backend=JBackend(execution))
    ty, taux = t_moe.apply_moe(tp, torch.as_tensor(x), tc,
                               transpose=transpose,
                               backend=TBackend(execution))
    assert tuple(ty.shape) == (2, 12, D) and ty.dtype == torch.float32
    assert _rel(ty.numpy(), jy) <= TOL[execution]
    assert abs(float(taux["load_balance"]) - float(jaux["load_balance"])) \
        <= 1e-6


def test_init_moe_shapes_and_scales():
    jc, tc = _cfgs(num_experts=8, num_basic_experts=2, num_shared=1,
                   d_ff_shared=40)
    gen = torch.Generator().manual_seed(0)
    p = t_moe.init_moe(D, tc, gen, "cpu", lead=(3,))
    jp, _ = j_moe.init_moe(jax.random.PRNGKey(0), D, jc)
    flat_t = {k: tuple(v.shape[1:]) for k, v in _flat(p).items()}
    flat_j = {k: tuple(np.shape(v)) for k, v in _flatten(jp).items()}
    assert flat_t == flat_j
    assert abs(float(p["router"].std()) - 0.02) < 0.003
    # the reference scales a bank by 1/sqrt of its first dim (R_e = 2)
    assert abs(float(p["w_gate"].std()) - 1 / np.sqrt(2)) < 0.03


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


# -------------------------------------------------------------------------
# a whole MoE stack with shared experts and a dense ``pre`` segment
# -------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _shared_model():
    moe = dict(num_experts=4, top_k=2, d_ff_expert=32, num_shared=1,
               d_ff_shared=32, first_dense=1, first_dense_d_ff=96,
               capacity_factor=4.0, num_basic_experts=2)
    jc = dataclasses.replace(j_smoke("granite-moe-1b-a400m"), num_layers=3,
                             moe=JMoE(**moe))
    tc = dataclasses.replace(t_smoke("granite-moe-1b-a400m"), num_layers=3,
                             moe=TMoE(**moe))
    params, _ = j_tfm.init_model(jax.random.PRNGKey(2), jc)
    return jc, tc, params, bridge.params_from_flat(_flatten(params),
                                                   device="cpu")


@pytest.mark.parametrize("execution", ["xla", "photonic"])
def test_shared_experts_and_dense_pre_segment_match_reference(execution):
    jc, tc, params, tp = _shared_model()
    assert [s.name for s in t_tfm.build_segments(tc)] == ["pre", "main"]
    assert tuple(tp["segments"]["pre"]["l0"]["ffn"]["w_gate"].shape) == \
        (1, 64, 96)
    jprog = j_api.Program.build(jc, params, execution=execution)
    tprog = t_api.Program.build(tc, tp, execution=execution, device="cpu")
    toks = np.random.default_rng(3).integers(0, 211, (2, 10)).astype(
        np.int32)
    jl, _ = jprog.prefill({"tokens": jnp.asarray(toks)}, 12)
    tl, _ = tprog.prefill({"tokens": toks}, 12)
    assert _rel(tl.numpy(), jl) <= TOL[execution]
    jlog, _, jaux = j_tfm.forward(jprog.bank, jc,
                                  {"tokens": jnp.asarray(toks)},
                                  execution=jprog.backend)
    tlog, _, taux = t_tfm.forward(tprog.bank, tc,
                                  {"tokens": torch.as_tensor(toks).long()},
                                  execution=tprog.backend)
    assert _rel(tlog.numpy(), jlog) <= TOL[execution]
    assert abs(float(taux) - float(jaux)) <= 1e-5


def test_moe_is_ported_and_mla_still_raises():
    """MoE stacks are ported, with GQA and (since the MLA slice) with MLA
    attention; MLA still raises outside the dense and moe families (the
    vlm and audio families are ported since slice 11, with GQA)."""
    t_tfm.check_ported(t_smoke("granite-moe-1b-a400m"))
    t_tfm.check_ported(t_smoke("deepseek-v2-lite-16b"))
    mla = t_smoke("deepseek-v2-lite-16b").mla
    for name in ("whisper-medium", "llama-3.2-vision-11b"):
        t_tfm.check_ported(t_smoke(name))
        with pytest.raises(NotImplementedError, match="not a buildable"):
            t_tfm.init_model(dataclasses.replace(t_smoke(name), mla=mla),
                             device="cpu")


def test_init_model_tree_matches_reference():
    """``init_model`` builds the reference's parameter tree for MoE stacks:
    the same flattened paths and shapes (a ``pre`` segment, shared experts,
    R-stacked blended banks)."""
    jc, tc, params, _ = _shared_model()
    tp = t_tfm.init_model(tc, seed=0, device="cpu")
    want = {k: tuple(np.shape(v)) for k, v in _flatten(params).items()}
    assert {k: tuple(v.shape) for k, v in _flat(tp).items()} == want
