"""Expert parallelism and the SSM heads in training, on gloo ranks on the
CPU (``launch.mesh.init_ranks``; the rank functions live in
``tests/_torch_ep_jobs.py``): a train step on "model" ranks runs its own
experts (``partition.ExpertLayout``: the banks cut on their experts,
routing whole, the rank's partial combine summed over "model") and its own
SSM heads and conv channels (``partition.SSMLayout`` with ``train``),
against the reference's UNSHARDED train step on the same weights
(``PRNGKey(3)``, bridged) and batches.

Models, float32, R&B 2 x 2 smoke: granite-moe-1b-a400m with plain
experts and blended from ``num_basic_experts=2`` banks, mamba2-780m (one
B/C group, and two) and jamba-v0.1-52b (SSM heads, and experts); on 1x2
and on 2x2 with
``cfg.fsdp`` ("seq", the reference's ``act_pspec``; granite's 2x2 run
without FSDP is ``tests/test_torch_train_mesh.py``'s).  The
tolerances are ``tests/test_torch_seq_parallel.py``'s: loss, CE and aux
within 1e-5, each gradient leaf within 1e-4 rel-L2; two microbatched
steps' losses and norms within 1e-4 (the first 1e-5), the params after
them within 1e-4 and the moments within 1e-3.  Jamba's routers are held
to ``test_torch_train_ssm.ROUTER_TOL``, for the cause named there (the
bf16 cotangent of the combine weights on both sides), and its steps
are one microbatched step, not two: further steps drift apart by float32
summation order alone beyond these tolerances in the reference itself
(``test_torch_train_ssm.py``'s docstring).

Also:
  * a step's all-gathers over "model" hold no expert bank and no SSM
    head or channel leaf (their per-block shapes), while the same step
    with the layouts taken away does gather them (the check has teeth);
  * a rank's expert FFN outputs are bit-equal to those experts' rows of
    the unsharded expert FFN on the same inputs (each expert runs the same
    dots), for plain and blended experts, with and without the OBU swap;
  * the dry-run's census of a mamba2 train cell on 1x2 equals what a real
    rank records, and its ``ssd_chunk`` calls are planned at the rank's
    heads, one per call the rank makes."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import rb as j_rb
from repro.configs import smoke_variant as j_smoke
from repro.configs.base import TrainConfig as JTrain
from repro.models import transformer as j_tfm
from repro.optim import adamw as j_adamw
from repro.train import checkpoint as j_ckpt
from repro.train import trainer as j_trainer

from repro_torch.configs import rb as t_rb
from repro_torch.configs import smoke_variant as t_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import analysis
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import moe as t_moe
from repro_torch.models import ssm as t_ssm
from repro_torch.models import transformer as t_tfm
from repro_torch.sharding import partition

import _torch_ep_jobs as ep_jobs
import _torch_mesh_jobs as mesh_jobs
import test_torch_train_mesh as tm
from test_torch_train_ssm import ROUTER_TOL

torch.set_num_threads(2)
ARCHS = {"granite": "granite-moe-1b-a400m", "granite_b2":
         "granite-moe-1b-a400m", "mamba2": "mamba2-780m",
         "mamba2_g2": "mamba2-780m", "jamba": "jamba-v0.1-52b"}
RUNS = {"1x2": (False,), "2x2": (True,)}
B, S, STEPS, MB = 8, 8, 2, (2,)
TCFG = tm.TCFG


def _steps(name) -> int:
    return 1 if name == "jamba" else STEPS


def _cfgs(name):
    """(reference cfg, port cfg): the smoke R&B 2 x 2 in float32;
    ``granite_b2`` blends its 4 experts from 2 basic banks, ``mamba2_g2``
    has 2 B/C groups (a rank's 4 heads read their own group)."""
    out = []
    for rb, smoke in ((j_rb, j_smoke), (t_rb, t_smoke)):
        c = dataclasses.replace(rb(smoke(ARCHS[name]), 2, 2),
                                compute_dtype="float32")
        if name == "granite_b2":
            c = dataclasses.replace(c, moe=dataclasses.replace(
                c.moe, num_basic_experts=2))
        if name == "mamba2_g2":
            c = dataclasses.replace(c, ssm=dataclasses.replace(
                c.ssm, n_groups=2))
        out.append(c)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _model(name):
    jc, tc = _cfgs(name)
    params, _ = j_tfm.init_model(jax.random.PRNGKey(3), jc)
    return jc, tc, params, j_ckpt._flatten(params)


@functools.lru_cache(maxsize=None)
def _spawn(shape):
    job = {name: (_model(name)[1], _model(name)[3], _steps(name))
           for name in ARCHS}
    return mesh_lib.init_ranks(
        ep_jobs.train_ep_rank, shape, device="cpu",
        args=(job, B, S, TCFG, MB, RUNS[shape]), threads=1)


def _batches(vocab):
    return mesh_jobs.batches(vocab, B, S, STEPS)


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(name):
    jc, _, params, _ = _model(name)
    fn = jax.jit(jax.value_and_grad(j_trainer._loss_with_mask, has_aux=True),
                 static_argnums=(1, 3, 4, 5))
    (loss, (ce, aux)), grads = fn(params, jc, {"tokens": jnp.asarray(
        _batches(jc.vocab_size)[0])}, None, 0.01, True)
    return float(loss), float(ce), float(aux), {
        k: np.asarray(v, np.float32)
        for k, v in j_ckpt._flatten(grads).items()}


@functools.lru_cache(maxsize=None)
def _jax_steps(name):
    jc, _, params, _ = _model(name)
    step = jax.jit(j_trainer.make_train_step(jc, JTrain(
        **TCFG, microbatch=MB[0])))
    p, o = params, j_adamw.init(params)
    metrics = []
    for b in _batches(jc.vocab_size)[:_steps(name)]:
        p, o, m = step(p, o, {"tokens": jnp.asarray(b)})
        metrics.append((float(m["loss"]), float(m["grad_norm"]),
                        float(m["lr"])))
    flat = lambda t: {k: np.asarray(v, np.float32)
                      for k, v in j_ckpt._flatten(t).items()}
    return metrics, flat(p), flat(o.m), flat(o.v), int(o.step)


def _trees_close(got, want, tol, what):
    assert sorted(got) == sorted(want)
    for k in want:
        t = max(tol, ROUTER_TOL) if k.endswith("/router") else tol
        err = tm._rel(got[k], want[k])
        assert err <= t, f"{what} {k}: rel-L2 {err}"


CASES = [(shape, fsdp, name) for shape in RUNS for fsdp in RUNS[shape]
         for name in ARCHS]


@pytest.mark.parametrize("shape,fsdp,name", CASES)
def test_loss_and_grads_match_unsharded_reference(shape, fsdp, name):
    ranks = _spawn(shape)
    r0 = ranks[0][(name, fsdp)]["loss_and_grads"]
    for r in ranks[1:]:
        assert r[(name, fsdp)]["loss_and_grads"][:3] == r0[:3]
    loss, ce, aux, grads = r0
    want = _jax_loss_and_grads(name)
    assert abs(loss - want[0]) <= tm.LOSS_TOL * abs(want[0])
    assert abs(ce - want[1]) <= tm.LOSS_TOL * abs(want[1])
    assert abs(aux - want[2]) <= tm.LOSS_TOL * max(abs(want[2]), 1e-30)
    _trees_close(grads, want[3], tm.GRAD_TOL, "grad")


@pytest.mark.parametrize("shape,fsdp,name", CASES)
def test_train_steps_match_unsharded_reference(shape, fsdp, name):
    got = _spawn(shape)[0][(name, fsdp)][("steps", MB[0])]
    want = _jax_steps(name)
    tm._metrics_close(got[0], want[0])
    _trees_close(got[1], want[1], tm.GRAD_TOL, "params")
    _trees_close(got[2], want[2], tm.STATE_TOL, "m")
    _trees_close(got[3], want[3], tm.STATE_TOL, "v")
    assert got[4] == want[4] == _steps(name)


def _held_shapes(name, whole_only=False) -> set:
    """The shapes of the leaves a rank holds as "model" pieces and must
    never gather, whole (a step gathers its stacks at its start) and per
    block (FSDP gathers a block where it runs): expert banks, ``conv_k``,
    ``A_log``, ``D``, ``dt_bias``."""
    tc = _model(name)[1]
    out = set()
    shapes = t_tfm.abstract_params(tc)

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
            return
        axes = partition.leaf_axes(path, tree.ndim)
        if set(axes) & {"experts", "ssm_conv", "ssm_heads"}:
            out.add(tuple(tree.shape))
            if not whole_only:
                out.add(tuple(tree.shape[1:]))
    walk(shapes, ())
    return out


@pytest.mark.parametrize("shape,fsdp,name", CASES)
def test_no_model_gather_of_expert_banks_or_ssm_leaves(shape, fsdp, name):
    """Every rank's step gathers over "model" none of the leaves it holds
    as its experts, heads or channels; it does gather other leaves (the
    norm scale, ``w_out``'s column blocks) and activations."""
    held = _held_shapes(name)
    assert held
    for rank in _spawn(shape):
        got = rank[(name, fsdp)]["model_gathers"]
        assert got
        assert not held & set(got), (held & set(got))


def test_the_gather_check_sees_gathered_banks_and_ssm_leaves():
    """The same 1x2 step with the layouts taken away gathers jamba's
    expert banks and SSM leaves over "model": the shapes the check above
    looks for are the right ones."""
    _, tc, _, flat = _model("jamba")
    ranks = mesh_lib.init_ranks(ep_jobs.step_without_layouts, "1x2",
                                device="cpu", args=(tc, flat, B, S, TCFG),
                                threads=1)
    held = _held_shapes("jamba", whole_only=True)
    assert len(held) == 4
    for shapes in ranks:
        assert held <= set(shapes), held - set(shapes)


# -------------------------------------------------------------------------
# a rank's experts run the same dots as the whole call
# -------------------------------------------------------------------------
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("name", ["granite", "granite_b2"])
def test_rank_expert_ffn_rows_bit_equal_to_the_whole_call(name, transpose):
    """``moe.expert_ffn`` of a rank's experts (its banks, the capacity
    buffers of its experts in the layout's reuse-major order) against the
    whole call's rows of those experts: bit for bit."""
    tc = _model(name)[1]
    mcfg = tc.moe
    basic = mcfg.num_basic_experts or mcfg.num_experts
    g = torch.Generator().manual_seed(11)
    d, f = tc.d_model, mcfg.d_ff_expert
    p = {"w_gate": torch.randn((basic, d, f), generator=g),
         "w_up": torch.randn((basic, d, f), generator=g),
         "w_down": torch.randn((basic, f, d), generator=g)}
    xe = torch.randn((3, mcfg.num_experts, 5, d), generator=g)
    whole = t_moe.expert_ffn(p, xe, mcfg, transpose)
    tp = 2
    for i in range(tp):
        n = basic // tp
        lay = partition.ExpertLayout(i * n, n, basic)
        # the logical experts t * R_e + r of the rank's banks r, reuse-major
        mine = [t * basic + r for t in range(mcfg.num_experts // basic)
                for r in range(i * n, (i + 1) * n)]
        assert t_moe._local(torch.arange(mcfg.num_experts), lay,
                            dim=0).tolist() == mine
        piece = {k: v[i * n:(i + 1) * n] for k, v in p.items()}
        got = t_moe.expert_ffn(piece, t_moe._local(xe, lay, dim=1), mcfg,
                               transpose, lay)
        assert torch.equal(got, whole[:, mine]), (i, mine)


# -------------------------------------------------------------------------
# the dry-run's census of an SSM train cell
# -------------------------------------------------------------------------
def _ssm_cell():
    return {"mamba2": (_model("mamba2")[1], ShapeConfig("t", 16, 4,
                                                         "train"))}


@pytest.fixture(scope="module")
def ssm_census_ranks():
    return mesh_lib.init_ranks(ep_jobs.census_ssm_rank, "1x2", device="cpu",
                               args=(_ssm_cell(),), threads=1)


def test_census_of_an_ssm_train_cell_equals_a_gloo_run(ssm_census_ranks):
    """The census of a 1x2 mamba2 train cell equals each rank's recorded
    collectives; its planned ``ssd_chunk`` calls equal the rank's calls,
    each on its 4 of the 8 heads."""
    from repro_torch.kernels import planned

    cfg, shape = _ssm_cell()["mamba2"]
    H = t_ssm.ssm_dims(cfg)[1]
    for rank, got in enumerate(ssm_census_ranks):
        before = planned.snapshot()["ssd_chunk"]
        res = dryrun.walk(cfg, shape, "1x2", rank=rank)
        assert res["collectives"] == analysis.collective_census(
            got["collectives"]["mamba2"])
        assert res["collectives"]["total_bytes"] > 0
        calls = planned.snapshot()["ssd_chunk"] - before
        assert calls == len(got["ssd_heads"]) > 0
        assert set(got["ssd_heads"]) == {H // 2}
