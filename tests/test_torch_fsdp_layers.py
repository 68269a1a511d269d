"""FSDP gathers each block where it runs (``sharding/fsdp.py``), on gloo
ranks on the CPU, one spawn per mesh shape (rank functions in
``tests/_torch_fsdp_jobs.py``):

  * the mesh train step with ``cfg.fsdp`` on 2x1 and 2x2 (dp = 2), for the
    granite-moe-1b-a400m smoke R&B 2 x 2 (MoE, tied embeddings) and the
    mistral-large-123b smoke (``fsdp=True``, dense, bf16), without
    microbatches and with 2: at most one block's gathered leaves plus one
    leaf group outside the stacks are alive at once, strictly less than
    the whole tree; the all-gathers and reduce-scatters a step are
    ``fsdp.planned``'s a microbatch times the microbatches; the losses,
    grad norms, params and moments match the reference's unsharded step
    within ``tests/test_torch_train_mesh.py``'s tolerances;
  * the xla FSDP ``Program`` on the same meshes: its prefill and 2 greedy
    decode steps give logits bit-equal to the same mesh's build without
    FSDP, under the same live-bytes bound;
  * a tied table's head gradient handed to the lookup's backward, in one
    process on a 1x1 mesh: exact where the head's backward runs first, as
    in the model, and an error where the order is flipped.

Live bytes are counted by weakref finalizers on every tensor the gather
returns (``sharding.fsdp.track_live``)."""
import functools

import numpy as np
import pytest
import torch

from repro_torch.launch import mesh as mesh_lib
from repro_torch.sharding import fsdp

import _torch_fsdp_jobs as fjobs
import test_torch_train_mesh as tm

torch.set_num_threads(2)
MESHES = ("2x1", "2x2")
NAMES = tm.NAMES
MB = tm.MB
DECODE = 2


@functools.lru_cache(maxsize=None)
def _train(shape):
    job = {name: (tm._model(name)[1], tm._model(name)[3]) for name in NAMES}
    return mesh_lib.init_ranks(fjobs.train_layers_rank, shape, device="cpu",
                               args=(job, tm.B, tm.S, tm.STEPS, tm.TCFG, MB),
                               threads=1)


@functools.lru_cache(maxsize=None)
def _serve(shape):
    job = {"models": {n: (tm._model(n)[1], tm._model(n)[3]) for n in NAMES},
           "tokens": np.random.default_rng(32).integers(0, 100, (4, 12)),
           "decode": DECODE}
    return mesh_lib.init_ranks(fjobs.serve_layers_rank, shape, device="cpu",
                               args=(job,), threads=1)


def _steps(mb):
    return tm.STEPS if mb else 1


@pytest.mark.parametrize("mb", MB)
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape", MESHES)
def test_one_block_gathered_at_a_time(shape, name, mb):
    """The most gathered bytes alive in a step: at most one block plus one
    leaf group outside the stacks, below the whole tree; never two blocks'
    gathers alive at once; none left alive after the step."""
    for rank in _train(shape):
        r = rank[name]
        for _, live in r[("collectives", mb)]:
            _held_to_one_block(live, r["bytes"])


def _held_to_one_block(live, b):
    assert b["block"] + b["group"] < b["whole"]
    assert 0 < live["max"] <= b["block"] + b["group"], (live, b)
    assert live["blocks_max"] == 1
    assert live["now"] == live["blocks_now"] == 0


@pytest.mark.parametrize("mb", MB)
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape", MESHES)
def test_collectives_per_step_are_planned(shape, name, mb):
    """Each step's FSDP all-gathers and reduce-scatters: ``fsdp.planned``
    (two all-gathers and one reduce-scatter a block; one of each a leaf
    group outside the stacks, two all-gathers for the lookup, no
    reduce-scatter for a tied head) times the microbatches."""
    for rank in _train(shape):
        r = rank[name]
        plan = r[("planned", mb)]
        assert plan["all-gather"] > plan["reduce-scatter"] > 0
        want = {k: v * max(mb, 1) for k, v in plan.items()}
        got = [c for c, _ in r[("collectives", mb)]]
        assert got == [want] * _steps(mb)


@pytest.mark.parametrize("mb", MB)
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape", MESHES)
def test_steps_match_unsharded_reference(shape, name, mb):
    """Losses, grad norms and lr of each step; the params and Adam moments
    after them, against the reference's unsharded step; every rank's
    gathered state equal."""
    ranks = _train(shape)
    got = ranks[0][name][("steps", mb)]
    want = tm._jax_steps(name, mb)
    tm._metrics_close(got[0], want[0])
    tm._trees_close(got[1], want[1], tm.GRAD_TOL, "params",
                    tm._first_step(name, mb, got[0]))
    tm._trees_close(got[2], want[2], tm.STATE_TOL, "m")
    tm._trees_close(got[3], want[3], tm.STATE_TOL, "v")
    assert got[4] == want[4] == _steps(mb)
    for rank in ranks[1:]:
        other = rank[name][("steps", mb)]
        assert other[0] == got[0]
        for a, b in zip(other[1:4], got[1:4]):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape", MESHES)
def test_fsdp_serving_gathers_per_block(shape, name):
    """The xla FSDP Program's prefill and decode logits equal the same
    mesh's build without FSDP bit for bit; its gathers hold at most one
    block plus one leaf group at once, and none after the steps."""
    for rank in _serve(shape):
        dp, fs = rank[(name, False)], rank[(name, True)]
        assert len(fs["logits"]) == DECODE + 1
        for a, b in zip(fs["logits"], dp["logits"]):
            assert bool(torch.isfinite(a).all())
            assert torch.equal(a, b)
        assert dp["counts"] == {"all-gather": 0, "reduce-scatter": 0}
        assert fs["counts"]["all-gather"] > 0
        assert fs["counts"]["reduce-scatter"] == 0
        _held_to_one_block(fs["live"], fs["bytes"])


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("head_last", (True, False))
def test_tied_head_gradient_reaches_lookup(head_last, dtype):
    """The gradient of a tied table through the FSDP lookup and the
    head's gather equals autograd's through the whole table cast to
    ``dtype``, bit for bit, where the head's gather follows the lookup (its
    backward runs first, as in the model); where the head's gather comes
    first, the lookup's backward raises rather than drop the head's
    share."""
    mesh = mesh_lib.single_device_mesh()
    rng = np.random.default_rng(32)
    table = torch.as_tensor(rng.standard_normal((16, 8)), dtype=torch.float32)
    idx = torch.as_tensor(rng.integers(0, 16, (2, 5)))
    h = torch.as_tensor(rng.standard_normal((2, 5, 8)), dtype=torch.float32)

    def loss(rows, head):
        return ((rows.float() * h).sum()
                + (h.to(dtype) @ head.t()).float().square().sum())

    lay = fsdp.Layout({"embed": {"table": (None, "data")}}, mesh,
                      dtype=dtype)
    piece = table.clone().requires_grad_(True)
    rows_of, _, _ = lay.lookup(piece, ("embed", "table"), dtype, False)
    if head_last:
        rows = rows_of(idx)
        head = lay.use({"table": piece}, ("embed",))["table"]
    else:
        head = lay.use({"table": piece}, ("embed",))["table"]
        rows = rows_of(idx)
        with pytest.raises(RuntimeError, match="tied head"):
            loss(rows, head).backward()
        return
    loss(rows, head).backward()
    ref = table.clone().requires_grad_(True)
    whole = ref.to(dtype)
    loss(whole[idx], whole).backward()
    assert torch.equal(piece.grad, ref.grad)
