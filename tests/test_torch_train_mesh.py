"""Training on a mesh of gloo ranks on the CPU (``launch.mesh.init_ranks``,
one spawn per mesh shape): ``trainer.loss_and_grads`` and
``trainer.make_train_step`` with ``mesh=`` against the reference's
UNSHARDED train step on the same weights (``PRNGKey(3)``, carried over with
``bridge``) and batches, and against the port's unsharded step.

Models, float32: the granite-moe-1b-a400m smoke R&B 2 x 2 (MoE: routing on
the batch gathered over "data", the load-balance aux counted once) and the
mistral-large-123b smoke with ``fsdp=True`` (dense), each on 2x1 and 2x2,
with ``cfg.fsdp`` off and on, without microbatches and with 2.  A batch of
8 rows: 4 a data rank, 2 a rank in each microbatch.

Tolerances (``tests/test_torch_train.py``'s): losses, CE, aux and the
first step's ``grad_norm`` within 1e-5 (``LOSS_TOL``), a later step's loss
and norm, each gradient leaf and the params after the steps within 1e-4
(``GRAD_TOL``, rel-L2 for trees), lr within 1e-6 (``F32``), the Adam
moments within 1e-3 (as that file's microbatched steps).  Exact: FSDP
against DP at dp = 2 (a reduce-scatter and an all-reduce add the same two
numbers; the grad norm's shares are the same under both layouts), and
every rank's gathered params equal.  2x2 against 2x1 within ``GRAD_TOL``:
the "model" ranks hold the reference's "model" pieces and run the dots
tensor-parallel around a sequence-sharded residual (the ranks' spec is
``partition.act_pspec``'s "seq"), which sums in another order.  One leaf
kind after a first step (no microbatches) is held otherwise, for a cause
named beside it: a MoE router under expert parallelism
(``_router_first_step_close``).

The reference's own sharded path raises under jax 0.9 (ROADMAP), so the
port is held to the reference's unsharded step, as
``tests/test_torch_sharded.py`` holds its serving."""
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
from repro.data import pipeline as j_pipe
from repro.models import transformer as j_tfm
from repro.optim import adamw as j_adamw
from repro.train import checkpoint as j_ckpt
from repro.train import trainer as j_trainer

from repro_torch import bridge
from repro_torch.configs import rb as t_rb
from repro_torch.configs import smoke_variant as t_smoke
from repro_torch.configs.base import TrainConfig as TTrain
from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim import adamw as t_adamw
from repro_torch.sharding import partition
from repro_torch.train import checkpoint as t_ckpt
from repro_torch.train import trainer as t_trainer

import _torch_mesh_jobs as jobs

torch.set_num_threads(2)
MESHES = ("2x1", "2x2")
NAMES = ("granite", "mistral")
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
F32 = 1e-6
STATE_TOL = 1e-3
B, S = 8, 8
STEPS = 2                       # microbatched steps (one without)
TCFG = dict(lr=3e-3, warmup_steps=1, total_steps=10)
MB = (0, 2)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _cfgs(name):
    """(reference cfg, port cfg) in float32."""
    if name == "granite":
        arch = "granite-moe-1b-a400m"
        return (dataclasses.replace(j_rb(j_smoke(arch), 2, 2),
                                    compute_dtype="float32"),
                dataclasses.replace(t_rb(t_smoke(arch), 2, 2),
                                    compute_dtype="float32"))
    arch = "mistral-large-123b"
    return (dataclasses.replace(j_smoke(arch), fsdp=True),
            dataclasses.replace(t_smoke(arch), fsdp=True))


@functools.lru_cache(maxsize=None)
def _model(name):
    jc, tc = _cfgs(name)
    params, _ = j_tfm.init_model(jax.random.PRNGKey(3), jc)
    return jc, tc, params, j_ckpt._flatten(params)


def _batches(vocab):
    pipe = j_pipe.SyntheticPipeline(j_pipe.DataConfig(
        vocab_size=vocab, seq_len=S, global_batch=B))
    return [pipe.batch_for_step(s)["tokens"] for s in range(STEPS)]


_tensors = jobs.tensors
_np_tree = jobs.np_tree


def _spec_paths(tree, prefix=()):
    """``{"a/b": spec tuple}`` of a nested dict of PartitionSpecs."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_spec_paths(v, prefix + (k,)))
        return out
    return {"/".join(prefix): tuple(getattr(tree, "spec", tree))}


@functools.lru_cache(maxsize=None)
def _spawn(shape):
    job = {name: (_model(name)[1], _model(name)[3]) for name in NAMES}
    return mesh_lib.init_ranks(jobs.train_rank, shape, device="cpu",
                               args=(job, B, S, STEPS, TCFG, MB), threads=1)


# -------------------------------------------------------------------------
# the references: the JAX package's unsharded step, and the port's
# -------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(name):
    jc, _, params, _ = _model(name)
    fn = jax.jit(jax.value_and_grad(j_trainer._loss_with_mask, has_aux=True),
                 static_argnums=(1, 3, 4, 5))
    (loss, (ce, aux)), grads = fn(params, jc, {"tokens": jnp.asarray(
        _batches(jc.vocab_size)[0])}, None, 0.01, True)
    return float(loss), float(ce), float(aux), {
        k: np.asarray(v, np.float32) for k, v in j_ckpt._flatten(grads).items()}


@functools.lru_cache(maxsize=None)
def _jax_steps(name, mb):
    """The reference's unsharded train step: jitted with microbatches;
    without, one step is its gradient (``_jax_loss_and_grads``) and
    ``adamw.update``, which is what its ``make_train_step`` runs."""
    jc, _, params, _ = _model(name)
    tcfg = JTrain(**TCFG, microbatch=mb)
    flat = lambda t: {k: np.asarray(v, np.float32)
                      for k, v in j_ckpt._flatten(t).items()}
    if not mb:
        loss, _, _, g = _jax_loss_and_grads(name)
        grads = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(params),
            [jnp.asarray(g[k]) for k in _paths(params)])
        p, o, m = jax.jit(j_adamw.update, static_argnums=(3,))(
            params, grads, j_adamw.init(params), tcfg)
        return ([(loss, float(m["grad_norm"]), float(m["lr"]))], flat(p),
                flat(o.m), flat(o.v), int(o.step))
    step = jax.jit(j_trainer.make_train_step(jc, tcfg))
    p, o = params, j_adamw.init(params)
    metrics = []
    for b in _batches(jc.vocab_size):
        p, o, m = step(p, o, {"tokens": jnp.asarray(b)})
        metrics.append((float(m["loss"]), float(m["grad_norm"]),
                        float(m["lr"])))
    return metrics, flat(p), flat(o.m), flat(o.v), int(o.step)


def _paths(tree):
    """The checkpoint keys of ``tree``'s leaves in its flatten order."""
    return list(j_ckpt._flatten(tree))


@functools.lru_cache(maxsize=None)
def _port_unsharded(name, mb):
    _, tc, _, flat = _model(name)
    params = bridge.params_from_flat(flat, device="cpu")
    batches = _tensors(_batches(tc.vocab_size))
    step = t_trainer.make_train_step(tc, TTrain(**TCFG, microbatch=mb))
    p, o = params, t_adamw.init(params)
    metrics = []
    for b in batches[:STEPS if mb else 1]:
        p, o, m = step(p, o, b)
        metrics.append((float(m["loss"]), float(m["grad_norm"]),
                        float(m["lr"])))
    return metrics, _np_tree(p)


def _trees_close(got, want, tol, what, first=None):
    """Every leaf of ``got`` within ``tol`` rel-L2 of ``want``'s.  With
    ``first`` (``_first_step``: the params after one step without
    microbatches) a MoE router leaf is held as ``_router_first_step_close``
    says; every other leaf to ``tol``."""
    assert sorted(got) == sorted(want)
    for k in want:
        if first is not None and k.endswith("/router"):
            _router_first_step_close(got[k], want[k], first[0][k],
                                     first[1], tol, f"{what} {k}")
            continue
        err = _rel(got[k], want[k])
        assert err <= tol, f"{what} {k}: rel-L2 {err}"


def _first_step(name, mb, metrics):
    """``_trees_close``'s ``first`` for a run of ``mb`` microbatches whose
    step metrics are ``metrics``: the reference's gradient of each leaf and
    the step's lr after one step without microbatches, else None."""
    if mb:
        return None
    return _jax_loss_and_grads(name)[3], metrics[0][2]


def _router_first_step_close(got, want, grads, lr, tol, what):
    """A MoE router after Adam's first step, ``got`` against ``want``.

    The cause: expert parallelism (granite's experts cut over "model" on
    2x2) sums the ranks' partial combines, a float32 order change, and the
    combine weights' cotangent is rounded to bf16 (the reference's
    rounding: ``moe.route`` builds the combine in bf16), which turns that
    order change into one-ulp flips of single cotangents summed into the
    router's gradient.  The gradient stays within ``GRAD_TOL`` of the
    reference's (``test_loss_and_grads_match_unsharded_reference``), but
    Adam's first update is lr * g / (|g| + eps), the sign of g, so on an
    element whose reference gradient lies within ``tol`` * ||g|| of zero
    (the gradient gate, which one element may carry whole) the update may
    go the other way.  Such an element is held to one flipped first update
    (2 * lr); every other element, as a leaf, within ``tol`` rel-L2.  The
    granite smoke's l0 router reads 1.19e-2 rel-L2 whole (one element)."""
    free = np.abs(grads) <= tol * np.linalg.norm(grads)
    gap = np.abs(got - want)[free]
    assert not gap.size or gap.max() <= 2 * lr * (1 + 1e-3), (
        f"{what}: a near-zero gradient's element moved {gap.max()}")
    err = _rel(np.where(free, want, got), want)
    assert err <= tol, f"{what}: rel-L2 {err} off the near-zero elements"


def _metrics_close(got, want):
    """The first step's loss and grad norm within ``LOSS_TOL``; a later
    step's, from params that already differ in float32, within
    ``GRAD_TOL`` (``test_torch_train.py``'s microbatched steps)."""
    assert len(got) == len(want)
    for i, ((gl, gn, glr), (wl, wn, wlr)) in enumerate(zip(got, want)):
        tol = LOSS_TOL if i == 0 else GRAD_TOL
        assert abs(gl - wl) <= tol * abs(wl)
        assert abs(gn - wn) <= tol * abs(wn)
        assert abs(glr - wlr) <= F32 * abs(wlr)


def _ranks_equal(ranks, key):
    """Every rank returned the same numbers (gathered whole) for ``key``."""
    r0 = ranks[0][key]
    for r in ranks[1:]:
        assert r[key]["loss_and_grads"][:3] == r0["loss_and_grads"][:3]
        for k, v in r0["loss_and_grads"][3].items():
            np.testing.assert_array_equal(r[key]["loss_and_grads"][3][k], v)
        for mb in MB:
            assert r[key][("steps", mb)][0] == r0[("steps", mb)][0]
            for a, b in zip(r[key][("steps", mb)][1:4],
                            r0[("steps", mb)][1:4]):
                for k in b:
                    np.testing.assert_array_equal(a[k], b[k])


# -------------------------------------------------------------------------
# tests
# -------------------------------------------------------------------------
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape", MESHES)
def test_loss_and_grads_match_unsharded_reference(shape, name, fsdp):
    """The unsharded loss, CE and aux on every rank; each gradient leaf,
    summed over the data axes (gathered whole), the unsharded one."""
    ranks = _spawn(shape)
    _ranks_equal(ranks, (name, fsdp))
    loss, ce, aux, grads = ranks[0][(name, fsdp)]["loss_and_grads"]
    want = _jax_loss_and_grads(name)
    assert abs(loss - want[0]) <= LOSS_TOL * abs(want[0])
    assert abs(ce - want[1]) <= LOSS_TOL * abs(want[1])
    if name == "granite":
        assert want[2] > 0.0
    assert abs(aux - want[2]) <= LOSS_TOL * max(abs(want[2]), 1e-30)
    _trees_close(grads, want[3], GRAD_TOL, "grad")
    _, tc, _, flat = _model(name)
    port = t_trainer.loss_and_grads(
        bridge.params_from_flat(flat, device="cpu"), tc,
        _tensors(_batches(tc.vocab_size))[0], remat=True)
    assert abs(loss - float(port[0])) <= LOSS_TOL * abs(float(port[0]))
    _trees_close(grads, _np_tree(port[3]), GRAD_TOL, "grad vs port")


@pytest.mark.parametrize("mb", MB)
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape", MESHES)
def test_train_steps_match_unsharded_reference(shape, name, fsdp, mb):
    """Losses, grad norms and lr of each step; the params and Adam moments
    after them, against the reference's and the port's unsharded step."""
    got = _spawn(shape)[0][(name, fsdp)][("steps", mb)]
    want = _jax_steps(name, mb)
    _metrics_close(got[0], want[0])
    first = _first_step(name, mb, got[0])
    _trees_close(got[1], want[1], GRAD_TOL, "params", first)
    _trees_close(got[2], want[2], STATE_TOL, "m")
    _trees_close(got[3], want[3], STATE_TOL, "v")
    assert got[4] == want[4] == (STEPS if mb else 1)
    port = _port_unsharded(name, mb)
    _metrics_close(got[0], port[0])
    _trees_close(got[1], port[1], GRAD_TOL, "params vs port", first)


@pytest.mark.parametrize("mb", MB)
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape", MESHES)
def test_fsdp_bit_equal_to_dp(shape, name, mb):
    """At dp = 2 the FSDP run's losses, grad norms, params and moments are
    the data-parallel run's, bit for bit."""
    r = _spawn(shape)[0]
    dp, fs = r[(name, False)], r[(name, True)]
    assert fs[("steps", mb)][0] == dp[("steps", mb)][0]
    for a, b in zip(fs[("steps", mb)][1:4], dp[("steps", mb)][1:4]):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    assert fs["loss_and_grads"][:3] == dp["loss_and_grads"][:3]
    for k, v in dp["loss_and_grads"][3].items():
        np.testing.assert_array_equal(fs["loss_and_grads"][3][k], v)


@pytest.mark.parametrize("mb", MB)
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_2x2_bit_equal_to_2x1(name, fsdp, mb):
    """2x2 (tensor-parallel dots, sequence-sharded residual) against 2x1
    (whole dots): metrics within ``LOSS_TOL`` / ``GRAD_TOL``, params within
    ``GRAD_TOL``, the moments within ``STATE_TOL``."""
    a = _spawn("2x2")[0][(name, fsdp)][("steps", mb)]
    b = _spawn("2x1")[0][(name, fsdp)][("steps", mb)]
    _metrics_close(a[0], b[0])
    _trees_close(a[1], b[1], GRAD_TOL, "params 2x2 vs 2x1",
                 _first_step(name, mb, a[0]))
    _trees_close(a[2], b[2], STATE_TOL, "m 2x2 vs 2x1")
    _trees_close(a[3], b[3], STATE_TOL, "v 2x2 vs 2x1")


@pytest.mark.parametrize("shape", MESHES)
def test_differentiable_collectives(shape):
    """``all_gather_grad``'s backward reduce-scatters (rank i receives the
    sum over the data ranks of the gradient of its block) and
    ``reduce_scatter_grad``'s all-gathers, against the same sums written
    out in numpy."""
    ranks = _spawn(shape)
    dp = int(shape.split("x")[0])
    data = [next(r for r in ranks if r["coords"][0] == i) for i in range(dp)]
    xs = [np.arange(6.0).reshape(2, 3) + 10 * i for i in range(dp)]
    us = [np.arange(8.0).reshape(4, 2) - i for i in range(dp)]
    gathered = np.concatenate(xs, axis=1)
    scattered = np.split(sum(us), dp, axis=0)
    ws = [np.arange(gathered.size).reshape(gathered.shape) * (i + 1)
          for i in range(dp)]
    for i, r in enumerate(data):
        c = r["collectives"]
        np.testing.assert_array_equal(c["gathered"].numpy(), gathered)
        np.testing.assert_array_equal(
            c["x_grad"].numpy(), np.split(sum(ws), dp, axis=1)[i])
        np.testing.assert_array_equal(c["scattered"].numpy(), scattered[i])
        vs = [np.arange(scattered[0].size).reshape(scattered[0].shape) + j
              for j in range(dp)]
        np.testing.assert_array_equal(c["u_grad"].numpy(),
                                      np.concatenate(vs, axis=0))


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape", MESHES)
def test_param_pieces_follow_the_reference_tree_pspecs(shape, name, fsdp):
    """Each rank's pieces: the whole leaf cut by the reference's whole
    ``tree_pspecs(..., cfg.fsdp)``, "model" entries included.  With FSDP
    every leaf with an "embed" dim the data axes divide is cut over them;
    without, none is; on 2x2 the "model" rules cut leaves of both
    models."""
    from jax.sharding import AbstractMesh
    from repro.sharding import partition as jp

    jc, _, params, flat = _model(name)
    dims = tuple(int(x) for x in shape.split("x"))
    jm = AbstractMesh(dims, ("data", "model"))
    specs = _spec_paths(jp.tree_pspecs(params, j_tfm.model_specs(jc), jm,
                                       fsdp))
    cut = model_cut = 0
    sizes = dict(zip(("data", "model"), dims))
    for rank in _spawn(shape):
        got = rank[(name, fsdp)]["pieces"]
        assert sorted(got) == sorted(flat)
        for k, a in flat.items():
            want = list(a.shape)
            for d, e in enumerate(specs[k]):
                axes = (e,) if isinstance(e, str) else tuple(e or ())
                for ax in axes:
                    want[d] //= sizes[ax]
                cut += "data" in axes
                model_cut += "model" in axes and sizes["model"] > 1
            assert got[k] == tuple(want), k
    assert (cut > 0) == fsdp
    assert (model_cut > 0) == (dims[1] > 1)
