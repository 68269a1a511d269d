"""``cfg.fsdp`` on a mesh of gloo ranks on the CPU, and the eval and the
checkpoints of training on a mesh (one spawn per mesh shape, as
``tests/test_torch_sharded.py``), against the JAX reference on the same
weights (``PRNGKey(3)``, carried over with ``bridge``):

  * a Program built with ``cfg.fsdp`` serves the same logits, bit for bit,
    as the same mesh's build without it (its bank fields and float leaves
    gathered over the data axes at each use), on xla and photonic;
  * each rank's bank pieces are what the reference's
    ``bank_shardings(..., fsdp=True)`` gives (a programmed bank's leading
    dims whole, as the port places them; a float leaf cut over the data
    axes only, as every rank runs it whole), and FSDP's bank takes fewer
    bytes a rank;
  * ``Program.loss`` on 2x1 and 2x2 within 1e-5 (xla) and 1e-3 (photonic)
    of the unsharded Program's and of the reference's ``Program.loss``;
  * ``launch.train.run(mesh=)`` with FSDP on 2x1 against the reference's
    unsharded train step from the same (port-seeded) weights; its
    checkpoint restores bit-equal on 1x1 in this process, on 2x2 (a run
    resumed there) and through ``repro.train.checkpoint.restore``.

Models, float32: the granite-moe-1b-a400m smoke R&B 2 x 2 (MoE) and the
mistral-large-123b smoke with ``fsdp=True`` (dense).  Four rows, two a data
rank; 12 prompt tokens and 2 greedy decode steps."""
import dataclasses
import functools
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AbstractMesh

from repro import api as j_api
from repro.configs import rb as j_rb
from repro.configs import smoke_variant as j_smoke
from repro.configs.base import TrainConfig as JTrain
from repro.core import prepared as j_prepared
from repro.data import pipeline as j_pipe
from repro.models import transformer as j_tfm
from repro.optim import adamw as j_adamw
from repro.sharding import partition as jp
from repro.train import checkpoint as j_ckpt
from repro.train import trainer as j_trainer

from repro_torch import api as t_api
from repro_torch import bridge
from repro_torch.configs import rb as t_rb
from repro_torch.configs import smoke_variant as t_smoke
from repro_torch.configs.base import TrainConfig as TTrain
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as t_tfm
from repro_torch.optim import adamw as t_adamw
from repro_torch.train import checkpoint as t_ckpt
from repro_torch.train import trainer as t_trainer

import _torch_mesh_jobs as jobs

torch.set_num_threads(2)
MESHES = ("2x1", "2x2")
NAMES = ("granite", "mistral")
EXECUTIONS = ("xla", "photonic")
B, S, DECODE = 4, 12, 2
LOSS_TOL = {"xla": 1e-5, "photonic": 1e-3}
GRAD_TOL = 1e-4
RUN = dict(batch=8, seq=8, steps=2)
RUN_TCFG = dict(lr=3e-3, warmup_steps=1, total_steps=10, microbatch=2,
                checkpoint_every=0)


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


@functools.lru_cache(maxsize=None)
def _tokens():
    return np.random.default_rng(26).integers(0, 100, (B, S))


@functools.lru_cache(maxsize=None)
def _serve(shape):
    job = {"models": {n: (_model(n)[1], _model(n)[3]) for n in NAMES},
           "executions": EXECUTIONS, "tokens": _tokens(), "decode": DECODE}
    return mesh_lib.init_ranks(jobs.serve_rank, shape, device="cpu",
                               args=(job,), threads=1)


@functools.lru_cache(maxsize=None)
def _unsharded(execution, name):
    """The port's unsharded Program: prefill + decode logits, (ce, aux)."""
    _, tc, _, flat = _model(name)
    prog = t_api.Program.build(tc, bridge.params_from_flat(flat, device="cpu"),
                               execution=execution, device="cpu")
    toks = torch.as_tensor(_tokens()).long()
    logits, caches = prog.prefill({"tokens": toks}, S + DECODE)
    steps = [logits]
    for i in range(DECODE):
        tok = torch.argmax(steps[-1], dim=-1)[:, None]
        lg, caches = prog.decode(tok, caches, S + i)
        steps.append(lg)
    ce, aux = prog.loss({"tokens": toks})
    return steps, float(ce), float(aux)


@functools.lru_cache(maxsize=None)
def _jax_loss(execution, name):
    jc, _, params, _ = _model(name)
    prog = j_api.Program.build(jc, params, execution=execution)
    ce, aux = prog.loss({"tokens": jnp.asarray(_tokens(), jnp.int32)})
    return float(ce), float(aux)


def _rel(a, b):
    a = np.asarray(torch.as_tensor(a).double())
    b = np.asarray(torch.as_tensor(b).double())
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


# -------------------------------------------------------------------------
# serving and eval on a mesh
# -------------------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("execution", EXECUTIONS)
@pytest.mark.parametrize("shape", MESHES)
def test_fsdp_serving_bit_equal_to_the_same_mesh_without(shape, execution,
                                                         name):
    """Prefill and decode logits, CE and aux of an FSDP build equal the
    same mesh's build without FSDP bit for bit, on every rank; every
    rank returns the same; the banks' checksums hold."""
    ranks = _serve(shape)
    r0 = ranks[0][(execution, name, False)]
    for r in ranks:
        dp, fs = r[(execution, name, False)], r[(execution, name, True)]
        assert len(fs["logits"]) == DECODE + 1
        for a, b, c in zip(fs["logits"], dp["logits"], r0["logits"]):
            assert bool(torch.isfinite(a).all())
            assert torch.equal(a, b) and torch.equal(b, c)
        assert (fs["ce"], fs["aux"]) == (dp["ce"], dp["aux"])
        assert fs["verify"] == dp["verify"] <= 1e-6
    # the mesh's logits against the unsharded Program (the W8A8 bound on
    # photonic, as tests/test_torch_sharded.py holds serving on a mesh)
    want = _unsharded(execution, name)[0]
    tol = 1e-5 if execution == "xla" else 0.055
    for a, b in zip(r0["logits"], want):
        assert _rel(a, b) <= tol


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("execution", EXECUTIONS)
@pytest.mark.parametrize("shape", MESHES)
def test_program_loss_on_a_mesh(shape, execution, name):
    """``Program.loss`` on every rank, with and without FSDP, against the
    unsharded port Program and the reference's ``Program.loss``."""
    tol = LOSS_TOL[execution]
    _, ce_u, aux_u = _unsharded(execution, name)
    ce_j, aux_j = _jax_loss(execution, name)
    for r in _serve(shape):
        for fsdp in (False, True):
            got = r[(execution, name, fsdp)]
            for ce, aux in ((ce_u, aux_u), (ce_j, aux_j)):
                assert abs(got["ce"] - ce) <= tol * abs(ce)
                assert abs(got["aux"] - aux) <= tol * max(abs(aux), 1e-30)
    if name == "granite":
        assert aux_j > 0.0


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape", MESHES)
def test_bank_pieces_follow_the_reference_bank_shardings(shape, name):
    """FSDP cuts each rank's photonic bank on the data axes exactly where
    the reference's ``bank_shardings(..., fsdp=True)`` (on an
    ``AbstractMesh``) puts them: every ``PreparedTensor`` field and every
    float leaf is the same mesh's piece without FSDP (the placement
    over "model"; a float leaf whole) divided by the data size on the
    dims the reference's spec names "data", and on no other.  So FSDP
    holds fewer bytes a rank."""
    jc, _, params, _ = _model(name)
    dims = tuple(int(x) for x in shape.split("x"))
    jm = AbstractMesh(dims, ("data", "model"))
    j_bank = jax.eval_shape(
        lambda p: j_prepared.prepare_params(p, jc.compute_dtype, True),
        params)
    specs = jp.bank_shardings(j_bank, j_tfm.model_specs(jc), jm, True)
    data_dims = {}

    def walk(bank, spec, path):
        if isinstance(bank, dict):
            for k in bank:
                walk(bank[k], spec[k], path + (k,))
            return
        key = "/".join(path)
        pairs = ([(f"{key}/{f}", getattr(spec, f)) for f in
                  ("wq", "scale", "wq_t", "scale_t", "w0_colsum",
                   "w0_rowsum_t")]
                 if isinstance(bank, j_prepared.PreparedTensor)
                 else [(key, spec)])
        for k, sp in pairs:
            sp = tuple(getattr(sp, "spec", sp))
            data_dims[k] = [d for d, e in enumerate(sp) if e is not None
                            and "data" in ((e,) if isinstance(e, str)
                                           else tuple(e))]

    walk(j_bank, specs, ())
    cut = 0
    for r in _serve(shape):
        got = r[("photonic", name, True)]["pieces"]
        base = r[("photonic", name, False)]["pieces"]
        assert sorted(got) == sorted(data_dims) == sorted(base)
        for k, ds in data_dims.items():
            want = list(base[k])
            for d in ds:
                want[d] //= dims[0]
            assert got[k] == tuple(want), k
            cut += bool(ds)
        assert (r[("photonic", name, True)]["bytes"]
                < r[("photonic", name, False)]["bytes"])
    assert cut > 0


# -------------------------------------------------------------------------
# launch.train.run on a mesh, and its checkpoints
# -------------------------------------------------------------------------
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A 2x1 FSDP ``run`` into a fresh directory, then a 2x2 ``run``
    resumed from a copy of its checkpoint."""
    _, tc, _, _ = _model("mistral")
    root = tmp_path_factory.mktemp("fsdp_ckpt")
    out = {}
    for shape, d in (("2x1", root / "a"), ("2x2", root / "b")):
        if shape == "2x2":
            shutil.copytree(root / "a", d)
        job = dict(RUN, cfg=tc, tcfg=TTrain(**RUN_TCFG, checkpoint_dir=str(d)))
        out[shape] = mesh_lib.init_ranks(jobs.run_rank, shape, device="cpu",
                                         args=(job,), threads=1)
    out["dir"] = str(root / "a")
    return out


def _reference_run(tc):
    """The reference's unsharded train step from the port's seed-0
    weights (crossed through the reference's checkpoint reader) on the
    same pipeline batches."""
    jc, _, params, _ = _model("mistral")
    flat = t_ckpt._flatten(t_tfm.init_model(tc, seed=0, device="cpu"))
    leaves = [jnp.asarray(flat[k]) for k in j_ckpt._flatten(params)]
    p = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(params),
                                     leaves)
    step = jax.jit(j_trainer.make_train_step(jc, JTrain(
        **{k: v for k, v in RUN_TCFG.items() if k != "checkpoint_every"})))
    pipe = j_pipe.SyntheticPipeline(j_pipe.DataConfig(
        vocab_size=jc.vocab_size, seq_len=RUN["seq"],
        global_batch=RUN["batch"], seed=0))     # run's: tcfg.seed
    o = j_adamw.init(p)
    losses = []
    for s in range(RUN["steps"]):
        p, o, m = step(p, o, {"tokens": jnp.asarray(
            pipe.batch_for_step(s)["tokens"])})
        losses.append(float(m["loss"]))
    return losses, j_ckpt._flatten((p, o))


def test_run_on_a_mesh_matches_the_unsharded_reference(runs):
    _, tc, _, _ = _model("mistral")
    losses, want = _reference_run(tc)
    ranks = runs["2x1"]
    for r in ranks:
        assert len(r["losses"]) == RUN["steps"]
        for a, b in zip(r["losses"], losses):
            assert abs(a - b) <= GRAD_TOL * abs(b)
        for k, v in r["state"].items():
            np.testing.assert_array_equal(v, ranks[0]["state"][k])
    got = ranks[0]["state"]
    assert sorted(got) == sorted(want)
    for k in want:
        if k.startswith("0/"):
            assert _rel(got[k], want[k]) <= GRAD_TOL, k
    # each rank holds pieces: the embedding table's "embed" dim halved
    d_model = tc.d_model
    assert ranks[0]["pieces"]["0/embed/table"][-1] == d_model // 2
    assert ranks[0]["pieces"]["1/m/embed/table"][-1] == d_model // 2


def test_checkpoint_restores_on_one_device(runs):
    """The 2x1 FSDP run's checkpoint, in this process with no mesh and on
    the 1x1 mesh: every leaf equal to the ranks' gathered state."""
    _, tc, _, _ = _model("mistral")
    params = t_tfm.init_model(tc, seed=5, device="cpu")
    template = (params, t_adamw.init(params))
    want = runs["2x1"][0]["state"]
    for mesh in (None, mesh_lib.single_device_mesh()):
        tree, extra = t_ckpt.restore(runs["dir"], RUN["steps"], template,
                                     mesh=mesh)
        assert extra == {"next_step": RUN["steps"]}
        got = t_ckpt._flatten(tree)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_checkpoint_restores_on_2x2(runs):
    """A run on 2x2 resumed from the 2x1 checkpoint (nothing left to
    train) holds the same state, gathered, on every rank, in its own
    pieces: the 2x1 pieces (params, ``m`` and ``v``) cut over "model" as
    the reference's ``tree_pspecs`` on a 2x2 ``AbstractMesh`` cuts
    them."""
    jc, _, params, _ = _model("mistral")
    specs = jp.tree_pspecs(params, j_tfm.model_specs(jc),
                           AbstractMesh((2, 2), ("data", "model")), True)
    model_dims = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )[0]:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        model_dims[key] = [d for d, e in enumerate(tuple(spec))
                           if e == "model"]
    pieces = {}
    for k, shape in runs["2x1"][0]["pieces"].items():
        leaf = k.split("/", 2)[-1] if k.startswith("1/") else k[2:]
        shape = list(shape)
        for d in model_dims.get(leaf, ()):
            shape[d] //= 2
        pieces[k] = tuple(shape)
    assert any(pieces[k] != v for k, v in runs["2x1"][0]["pieces"].items())
    want = runs["2x1"][0]["state"]
    for r in runs["2x2"]:
        assert r["losses"] == []
        for k in want:
            np.testing.assert_array_equal(r["state"][k], want[k])
        assert r["pieces"] == pieces


def test_checkpoint_restores_through_the_reference(runs):
    jc, _, params, _ = _model("mistral")
    zeros = jax.tree.map(jnp.zeros_like, params)
    (rp, ro), extra = j_ckpt.restore(runs["dir"], RUN["steps"],
                                     (zeros, j_adamw.init(zeros)))
    assert extra == {"next_step": RUN["steps"]}
    got = j_ckpt._flatten((rp, ro))
    want = runs["2x1"][0]["state"]
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
