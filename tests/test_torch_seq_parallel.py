"""Training with the residual cut over "model" on gloo ranks on the CPU:
the reference's ``launch.train`` layout (``act_pspec`` "seq", parameters
and Adam state by the whole ``tree_pspecs``), and the "hidden" and
"replicated" residuals, with the xla dots tensor-parallel
(``core/backend.py``, ``train/trainer.py``), against the reference's
UNSHARDED train step on the same weights (``PRNGKey(3)``, carried over with
``bridge``) and batches.

Models, float32: the granite-moe-1b-a400m smoke R&B 2 x 2 (MoE) and the
mistral-large-123b smoke with ``fsdp=True`` (dense), with ``cfg.fsdp`` off
and on, without microbatches and with 2; here on 1x2 in every mode, in
``tests/test_torch_seq_parallel_2x2.py`` on 2x2 "hidden" and "replicated"
("seq" on 2x2 is ``tests/test_torch_train_mesh.py``'s).  The tolerances
are that file's: losses, CE, aux and the first ``grad_norm`` within 1e-5,
each gradient leaf and the params after the steps within 1e-4 rel-L2, the Adam moments within 1e-3.  Also: the rank's
pieces are the reference's whole ``tree_pspecs`` on an ``AbstractMesh``,
and a 1x2 run's checkpoint (``launch.train.run(mesh=)``, "seq") restores
bit for bit unsharded and in the JAX package."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AbstractMesh

from repro.models import transformer as j_tfm
from repro.optim import adamw as j_adamw
from repro.sharding import partition as jp
from repro.train import checkpoint as j_ckpt

from repro_torch.configs.base import TrainConfig as TTrain
from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim import adamw as t_adamw
from repro_torch.train import checkpoint as t_ckpt

import _torch_mesh_jobs as jobs
import test_torch_train_mesh as tm

torch.set_num_threads(2)
MODES = {"1x2": ("seq", "hidden", "replicated"),
         "2x2": ("hidden", "replicated")}


@functools.lru_cache(maxsize=None)
def _spawn(shape):
    job = {name: (tm._model(name)[1], tm._model(name)[3])
           for name in tm.NAMES}
    return mesh_lib.init_ranks(
        jobs.train_rank, shape, device="cpu",
        args=(job, tm.B, tm.S, tm.STEPS, tm.TCFG, tm.MB, MODES[shape]),
        threads=1)


def _ranks_equal(ranks, key):
    """Every rank returned the same numbers (gathered whole)."""
    r0 = ranks[0][key]
    for r in ranks[1:]:
        assert r[key]["loss_and_grads"][:3] == r0["loss_and_grads"][:3]
        for k, v in r0["loss_and_grads"][3].items():
            np.testing.assert_array_equal(r[key]["loss_and_grads"][3][k], v)
        for mb in tm.MB:
            assert r[key][("steps", mb)][0] == r0[("steps", mb)][0]


def check_loss_and_grads(shape, mode, name, fsdp):
    """The unsharded loss, CE and aux on every rank; each gradient leaf,
    gathered whole, the unsharded one."""
    ranks = _spawn(shape)
    _ranks_equal(ranks, (name, fsdp, mode))
    loss, ce, aux, grads = ranks[0][(name, fsdp, mode)]["loss_and_grads"]
    want = tm._jax_loss_and_grads(name)
    assert abs(loss - want[0]) <= tm.LOSS_TOL * abs(want[0])
    assert abs(ce - want[1]) <= tm.LOSS_TOL * abs(want[1])
    assert abs(aux - want[2]) <= tm.LOSS_TOL * max(abs(want[2]), 1e-30)
    tm._trees_close(grads, want[3], tm.GRAD_TOL, "grad")


def check_train_steps(shape, mode, name, fsdp, mb):
    """Losses, grad norms and lr of each step; the params and Adam moments
    after them, against the reference's unsharded step."""
    got = _spawn(shape)[0][(name, fsdp, mode)][("steps", mb)]
    want = tm._jax_steps(name, mb)
    tm._metrics_close(got[0], want[0])
    tm._trees_close(got[1], want[1], tm.GRAD_TOL, "params",
                    tm._first_step(name, mb, got[0]))
    tm._trees_close(got[2], want[2], tm.STATE_TOL, "m")
    tm._trees_close(got[3], want[3], tm.STATE_TOL, "v")
    assert got[4] == want[4] == (tm.STEPS if mb else 1)


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("name", tm.NAMES)
@pytest.mark.parametrize("mode", MODES["1x2"])
def test_loss_and_grads_match_unsharded_reference(mode, name, fsdp):
    check_loss_and_grads("1x2", mode, name, fsdp)


@pytest.mark.parametrize("mb", tm.MB)
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("name", tm.NAMES)
@pytest.mark.parametrize("mode", MODES["1x2"])
def test_train_steps_match_unsharded_reference(mode, name, fsdp, mb):
    check_train_steps("1x2", mode, name, fsdp, mb)


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("name", tm.NAMES)
def test_pieces_are_the_whole_reference_tree_pspecs(name, fsdp):
    """On 1x2 each rank's piece of every leaf is the whole leaf cut by the
    reference's ``tree_pspecs(..., cfg.fsdp)`` on an ``AbstractMesh``, its
    "model" entries included, in every mode (and some leaf is cut)."""
    jc, _, params, flat = tm._model(name)
    specs = tm._spec_paths(jp.tree_pspecs(
        params, j_tfm.model_specs(jc), AbstractMesh((1, 2),
                                                    ("data", "model")), fsdp))
    cut = 0
    for rank in _spawn("1x2"):
        for mode in MODES["1x2"]:
            got = rank[(name, fsdp, mode)]["pieces"]
            assert sorted(got) == sorted(flat)
            for k, a in flat.items():
                want = list(a.shape)
                for d, e in enumerate(specs[k]):
                    if e == "model":
                        want[d] //= 2
                        cut += 1
                assert got[k] == tuple(want), k
    assert cut > 0


# -------------------------------------------------------------------------
# a 1x2 run's checkpoint, restored unsharded and in the reference
# -------------------------------------------------------------------------
RUN = dict(batch=8, seq=8, steps=2)


@pytest.fixture(scope="module")
def run_1x2(tmp_path_factory):
    _, tc, _, _ = tm._model("granite")
    d = tmp_path_factory.mktemp("sp_ckpt")
    job = dict(RUN, cfg=tc, tcfg=TTrain(**tm.TCFG, checkpoint_dir=str(d),
                                        checkpoint_every=0))
    ranks = mesh_lib.init_ranks(jobs.run_rank, "1x2", device="cpu",
                                args=(job,), threads=1)
    return d, ranks


def test_checkpoint_from_1x2_restores_unsharded_and_in_the_reference(
        run_1x2):
    """The state gathered on each rank is what the checkpoint holds, bit
    for bit, restored by the port without a mesh and by the JAX package's
    ``checkpoint.restore``; the rank held "model" pieces."""
    d, ranks = run_1x2
    want = ranks[0]["state"]
    for r in ranks[1:]:
        for k in want:
            np.testing.assert_array_equal(r["state"][k], want[k])
    assert any(ranks[0]["pieces"][k] != want[k].shape for k in want)
    jc, tc, params, _ = tm._model("granite")
    from repro_torch.models import transformer as t_tfm
    tp = t_tfm.init_model(tc, seed=0, device="cpu")
    (p, o), extra = t_ckpt.restore(str(d), RUN["steps"],
                                   (tp, t_adamw.init(tp)))
    assert extra == {"next_step": RUN["steps"]}
    got = t_ckpt._flatten((p, o))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    zeros = jax.tree.map(jnp.zeros_like, params)
    (rp, ro), _ = j_ckpt.restore(str(d), RUN["steps"],
                                 (zeros, j_adamw.init(zeros)))
    got = j_ckpt._flatten((rp, ro))
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k])


def test_run_without_a_checkpoint_dir_keeps_none(tmp_path, monkeypatch):
    """``launch.train.run`` with an empty ``checkpoint_dir`` (the card's
    runs that need no checkpoint) trains, resumes nothing and writes
    nothing, even where ``checkpoint_every`` asks for saves."""
    from repro_torch.launch import train as launch

    monkeypatch.chdir(tmp_path)
    _, tc, _, _ = tm._model("mistral")
    tcfg = TTrain(**tm.TCFG, checkpoint_dir="", checkpoint_every=1)
    _, opt, losses = launch.run(tc, tcfg, batch=4, seq=8, steps=2,
                                device="cpu")
    assert len(losses) == 2 and int(opt.step) == 2
    assert list(tmp_path.iterdir()) == []
