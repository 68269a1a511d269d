"""Training through the SSM: the port's unsharded train step on the
mamba2-780m and jamba-v0.1-52b smoke R&B models (2 x 2, float32) against
the JAX reference on the same weights (``PRNGKey(3)``, bridged) and the
same batches: the loss and every gradient leaf with remat off and on, and
three microbatched train steps.  The SSM's intra-chunk block runs through
``ssd_chunk``'s ``autograd.Function`` (its explicit VJP), the reference
through XLA einsums of the same block.

Tolerances (``tests/test_torch_train.py``'s): losses within 1e-5, each
gradient leaf and the params after the steps within 1e-4 rel-L2, the Adam
moments within 1e-3.

One leaf kind is held to another bound, for a cause the reference has
too: jamba's MoE router (``ROUTER_TOL``).  Both sides build the combine
tensor in bf16 (``moe.route``: ``pos_oh * weight_ge.astype(bf16)``) and
cast it to the activation dtype for the combine einsum, so the cotangent
of the combine weights is rounded to bf16 on both sides; the float32
summation-order noise in it (the sum over d of the rows' gradient times
the expert outputs) flips a bf16 rounding here and there, one ulp (2^-8)
of that element each, and the router's gradient sums them.  It reads
1.14e-4 on ``l5/ffn/router``.  With the rounding replaced by a
straight-through float32 cotangent on both sides (a test-time patch of
both ``route`` functions; the JAX package is not edited) it falls inside
``GRAD_TOL`` with every other leaf:
``test_router_gap_is_the_bf16_combine_cotangent``.

Jamba's three steps are taken each from the reference's state of that
step (its params and Adam moments carried over), so each step is held
alone: free-running, three jamba steps drift apart by float32 summation
order alone beyond ``GRAD_TOL`` and the moments' 1e-3 in the reference
itself, whose jitted and eager runs of the same steps lie 1.63e-4 apart
on the zero-initialised ``dt_bias`` params and 1.03e-3 on a ``dt_bias``
second moment (the port free-running: 1.37e-4 and 1.01e-3)
(``tools/probe_train_ssm_spread.py``).

In bf16, the models' stated precision, the SSM leaves' gradients are
rounding-bound in the reference itself (its bf16 step lies more than
1e-2 rel-L2 from its float32 one on each), and the port's bf16 gradients
lie within half that spread of the reference's run op by op
(``test_bf16_grads_within_the_references_own_bf16_spread``)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import TrainConfig as JTrain
from repro.models import moe as j_moe
from repro.optim import adamw as j_adamw
from repro.train import checkpoint as j_ckpt
from repro.train import trainer as j_trainer

from repro_torch.configs.base import TrainConfig as TTrain
from repro_torch.models import moe as t_moe
from repro_torch.optim import adamw as t_adamw
from repro_torch.train import checkpoint as t_ckpt
from repro_torch.train import trainer as t_trainer

import test_torch_train as tt

torch.set_num_threads(2)
NAMES = ("mamba2-780m", "jamba-v0.1-52b")
LOSS_TOL = tt.LOSS_TOL
GRAD_TOL = tt.GRAD_TOL
STATE_TOL = 1e-3
# jamba's routers: the bf16 cotangent of the combine weights on both sides
# (module docstring), one decade above GRAD_TOL
ROUTER_TOL = 1e-3
TCFG = dict(lr=3e-3, warmup_steps=1, total_steps=10, microbatch=2)


def _tol(name, key):
    return ROUTER_TOL if key.endswith("/router") else GRAD_TOL


def _errors(got, want) -> dict:
    got, want = t_ckpt._flatten(got), j_ckpt._flatten(want)
    assert sorted(got) == sorted(want)
    return {k: tt._rel(got[k].astype(np.float32),
                       np.asarray(want[k], np.float32)) for k in want}


def _port_loss_and_grads(name, remat):
    jc, tc, params = tt._model(name)
    batch = tt._batch(tc.vocab_size)
    return t_trainer.loss_and_grads(
        tt._port_params(params), tc, {"tokens": torch.as_tensor(
            batch["tokens"]).long()}, remat=remat)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_loss_and_grads_match_reference(name, remat):
    jc, tc, params = tt._model(name)
    want = tt._ref_loss_and_grads(jc, params, tt._batch(tc.vocab_size),
                                  remat)
    loss, ce, aux, grads = _port_loss_and_grads(name, remat)
    assert abs(float(loss) - want[0]) <= LOSS_TOL * abs(want[0])
    assert abs(float(ce) - want[1]) <= LOSS_TOL * abs(want[1])
    assert (want[2] > 0.0) == (tc.moe is not None)
    assert abs(float(aux) - want[2]) <= LOSS_TOL * max(abs(want[2]), 1e-30)
    errs = _errors(grads, want[3])
    assert any("/mixer/A_log" in k for k in errs)
    for k, e in errs.items():
        assert e <= _tol(name, k), (k, e)


@pytest.mark.parametrize("name", NAMES)
def test_remat_is_bit_equal(name):
    off = _port_loss_and_grads(name, False)
    on = _port_loss_and_grads(name, True)
    for a, b in zip(off[:3], on[:3]):
        assert torch.equal(a, b)
    for a, b in zip(t_adamw.tree_leaves(off[3]), t_adamw.tree_leaves(on[3])):
        assert torch.equal(a, b)


def _port_state(jo):
    return t_adamw.OptState(m=tt._port_params(jo.m),
                            v=tt._port_params(jo.v),
                            step=torch.tensor(int(jo.step),
                                              dtype=torch.int32))


@pytest.mark.parametrize("name", NAMES)
def test_three_microbatched_steps_match_reference(name):
    """mamba2 free-running; jamba each step from the reference's state
    (module docstring)."""
    jc, tc, params = tt._model(name)
    jstep = jax.jit(j_trainer.make_train_step(jc, JTrain(**TCFG)))
    tstep = t_trainer.make_train_step(tc, TTrain(**TCFG))
    jp, jo = params, j_adamw.init(params)
    tp = tt._port_params(params)
    to = t_adamw.init(tp)
    for s in range(3):
        if s and name.startswith("jamba"):
            tp, to = tt._port_params(jp), _port_state(jo)
        b = tt._batch(tc.vocab_size, step=s)
        jp, jo, jm = jstep(jp, jo, {"tokens": jnp.asarray(b["tokens"])})
        tp, to, tm = tstep(tp, to, {"tokens": torch.as_tensor(
            b["tokens"]).long()})
        for key in ("loss", "grad_norm", "lr"):
            assert abs(float(tm[key]) - float(jm[key])) <= GRAD_TOL * abs(
                float(jm[key]))
    for k, e in _errors(tp, jp).items():
        assert e <= _tol(name, k), ("params", k, e)
    for k, e in _errors((to.m, to.v), (jo.m, jo.v)).items():
        assert e <= STATE_TOL, ("state", k, e)
    assert int(to.step) == int(jo.step) == 3


# -------------------------------------------------------------------------
# the witness: jamba's router gap is the bf16 combine cotangent
# -------------------------------------------------------------------------
def _j_route_float32_cotangent(p, xg, mcfg):
    """The reference's ``route`` with the combine built in float32 from the
    bf16-rounded weights whose gradient passes unrounded (straight
    through): the same forward values."""
    G, g, d = xg.shape
    E, K = mcfg.num_experts, mcfg.top_k
    C = j_moe._capacity(g, mcfg)
    logits = jnp.einsum("ngd,de->nge", xg.astype(jnp.float32),
                        p["router"].astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, gate_idx = jax.lax.top_k(probs, K)
    gate_vals = gate_vals / jnp.sum(gate_vals, axis=-1, keepdims=True)
    sel = jax.nn.one_hot(gate_idx, E, dtype=jnp.float32)
    mask = jnp.max(sel, axis=2)
    pos_in_e = jnp.cumsum(mask, axis=1) - 1.0
    keep = (pos_in_e < C) * mask
    w = jnp.einsum("ngke,ngk->nge", sel, gate_vals) * keep
    w = w + jax.lax.stop_gradient(
        w.astype(jnp.bfloat16).astype(jnp.float32) - w)
    pos_oh = jax.nn.one_hot(pos_in_e.astype(jnp.int32), C, dtype=jnp.float32)
    aux = {"load_balance": E * jnp.sum(jnp.mean(mask, axis=(0, 1))
                                       * jnp.mean(probs, axis=(0, 1))),
           "dropped_frac": 1.0 - jnp.sum(keep) / (G * g * K)}
    return pos_oh * keep[..., None], pos_oh * w[..., None], aux


def _t_route_float32_cotangent(route):
    """The port's ``route`` wrapped the same way: its dispatch (the kept
    slots' one-hots) times the float32 combine weights, recomputed with
    the port's routing, rounded to bf16 with an unrounded gradient."""
    def wrapped(p, xg, mcfg, experts=None, mesh=None):
        dispatch, _, aux = route(p, xg, mcfg)
        E, K = mcfg.num_experts, mcfg.top_k
        probs = torch.softmax(xg.float() @ p["router"].float(), dim=-1)
        vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate = vals[..., :K] / vals[..., :K].sum(-1, keepdim=True)
        sel = (idx[..., :K, None] == torch.arange(E)).float()
        keep = dispatch.float().amax(-1)
        w = (sel * gate[..., None]).sum(2) * keep
        w = w + (w.to(torch.bfloat16).float() - w).detach()
        return dispatch, dispatch.float() * w[..., None], aux
    return wrapped


def test_router_gap_is_the_bf16_combine_cotangent(monkeypatch):
    """jamba (remat off): with the bf16 rounding of the combine weights'
    cotangent, some router leaf reads above ``GRAD_TOL`` (within
    ``ROUTER_TOL``); with a float32 cotangent on both sides every router
    and every other leaf lies within ``GRAD_TOL`` and the loss is
    unchanged."""
    name = "jamba-v0.1-52b"
    jc, tc, params = tt._model(name)
    batch = tt._batch(tc.vocab_size)
    want = tt._ref_loss_and_grads(jc, params, batch, False)
    rounded = _errors(_port_loss_and_grads(name, False)[3], want[3])
    assert max(e for k, e in rounded.items() if k.endswith("/router")) \
        > GRAD_TOL
    monkeypatch.setattr(j_moe, "route", _j_route_float32_cotangent)
    monkeypatch.setattr(t_moe, "route", _t_route_float32_cotangent(
        t_moe.route))
    straight = tt._ref_loss_and_grads(jc, params, batch, False)
    loss, _, _, grads = _port_loss_and_grads(name, False)
    assert straight[0] == want[0]
    assert abs(float(loss) - straight[0]) <= LOSS_TOL * abs(straight[0])
    errs = _errors(grads, straight[3])
    for k, e in errs.items():
        assert e <= GRAD_TOL, (k, e)


# -------------------------------------------------------------------------
# the witness: in bf16 the gradients are rounding-bound in the reference
# itself, and the port rounds as the reference's ops do one by one
# -------------------------------------------------------------------------
BF16_LOSS_TOL = 2.0 ** -8     # one bf16 rounding of the loss
BF16_SPREAD_SHARE = 0.5       # the port's bf16 gradient vs the eager
                              # reference's, as a share of the latter's own
                              # distance from float32 (read: <= 0.38)
SSM_LEAVES = ("conv_k", "A_log", "D", "dt_bias")


def _ref_eager_loss_and_grads(jc, params, batch):
    """The reference's loss and gradients run op by op
    (``jax.disable_jit``): each op rounds to the compute dtype, as the
    port's do, where the jitted program fuses elementwise ops."""
    with jax.disable_jit():
        (loss, _), grads = jax.value_and_grad(
            j_trainer._loss_with_mask, has_aux=True)(
                params, jc, {"tokens": jnp.asarray(batch["tokens"])}, None,
                0.01, False)
    return float(loss), grads


@pytest.mark.parametrize("name", NAMES)
def test_bf16_grads_within_the_references_own_bf16_spread(name):
    """Computing in bf16, the models' stated precision (remat off).  The
    reference's own bf16 gradient of every SSM leaf (``conv_k``,
    ``A_log``, ``D``, ``dt_bias``) lies more than 1e-2 rel-L2 from its
    float32 one, jitted and eager alike: at this random init the
    gradients cancel, so bf16's roundings reach them.  The port's bf16
    step rounds as the reference's ops do one by one: every leaf of its
    gradient lies within ``BF16_SPREAD_SHARE`` of the eager reference's
    own bf16 spread from that reference's bf16 gradient, and its loss
    within one bf16 rounding.  (The jitted reference fuses elementwise
    ops; on jamba its bf16 step lies half as far from float32 as the
    eager one.)"""
    jc, tc, params = tt._model(name)
    jb, tb, _ = tt._model(name, "bfloat16")
    batch = tt._batch(tc.vocab_size)
    f32 = tt._ref_loss_and_grads(jc, params, batch, False)[3]
    jit = tt._ref_loss_and_grads(jb, params, batch, False)[3]
    want_loss, want = _ref_eager_loss_and_grads(jb, params, batch)
    loss, _, _, grads = t_trainer.loss_and_grads(
        tt._port_params(params), tb, {"tokens": torch.as_tensor(
            batch["tokens"]).long()}, remat=False)
    assert abs(float(loss) - want_loss) <= BF16_LOSS_TOL * abs(want_loss)
    spread, spread_jit = _errors(want, f32), _errors(jit, f32)
    ssm = [k for k in spread if k.rsplit("/", 1)[1] in SSM_LEAVES]
    assert len(ssm) >= 4
    for k in ssm:
        assert min(spread[k], spread_jit[k]) > 1e-2, k
    for k, e in _errors(grads, want).items():
        assert e <= BF16_SPREAD_SHARE * spread[k], (k, e, spread[k])
