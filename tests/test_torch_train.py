"""The port's training path against the JAX reference on the same weights
(bridged through numpy) and the same numpy batches: ``cross_entropy``,
the loss and its gradients (remat on and off on both sides), AdamW
(``update``, ``cosine_lr``, the clip branch), ``make_train_step`` with
microbatches, the data pipeline, checkpoints that cross in both
directions, and ``Program.loss`` on xla and photonic.

Models: the launcher's ``--smoke --reuse`` configs of minitron-4b (dense)
and granite-moe-1b-a400m (MoE: the load-balance aux and the routing
gradients), R&B 2 x 2, float32.

Tolerances: ``cross_entropy``, AdamW params, m, v, lr and grad norm within
1e-6 (float32 in another summation order); losses within 1e-5 and each
gradient leaf within 1e-4 rel-L2 (float32 backward passes through other
kernels); the bf16 model's gradients no farther from the float32
gradients than the reference's own bf16 gradients are, times
``BF16_SLACK`` (at this random init bf16 rounding alone moves the
reference's gradients 0.19-0.37 rel-L2 from its float32 ones, so a fixed
bf16 gate would measure rounding noise); three microbatched train steps
within 1e-4 (their Adam moments within 1e-3); ``Program.loss``
within 1e-5 on xla and 1e-3 on photonic (the logits gate of the port's
photonic tests).  Exact: remat on and off in the port, the pipeline's
batches, and every checkpoint leaf across the two packages.
"""
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import api as j_api
from repro.configs import rb as j_rb
from repro.configs import smoke_variant as j_smoke
from repro.configs.base import TrainConfig as JTrain
from repro.data import pipeline as j_pipe
from repro.models import transformer as j_tfm
from repro.optim import adamw as j_adamw
from repro.train import checkpoint as j_ckpt
from repro.train import trainer as j_trainer

from repro_torch import api as t_api
from repro_torch import bridge
from repro_torch.configs import rb as t_rb
from repro_torch.configs import smoke_variant as t_smoke
from repro_torch.configs.base import TrainConfig as TTrain
from repro_torch.data import pipeline as t_pipe
from repro_torch.models import transformer as t_tfm
from repro_torch.optim import adamw as t_adamw
from repro_torch.train import checkpoint as t_ckpt
from repro_torch.train import trainer as t_trainer

torch.set_num_threads(2)
NAMES = ("minitron-4b", "granite-moe-1b-a400m")
F32 = 1e-6
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
BF16_SLACK = 1.25


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


@functools.lru_cache(maxsize=None)
def _model(name, dtype="float32"):
    """(reference cfg, port cfg, reference params): the launcher's smoke
    R&B config (2 x 2) in ``dtype``."""
    jc = dataclasses.replace(j_rb(j_smoke(name), 2, 2), compute_dtype=dtype)
    tc = dataclasses.replace(t_rb(t_smoke(name), 2, 2), compute_dtype=dtype)
    params, _ = j_tfm.init_model(jax.random.PRNGKey(3), jc)
    return jc, tc, params


def _port_params(params):
    return bridge.params_from_flat(j_ckpt._flatten(params), device="cpu")


def _batch(vocab, B=4, S=16, step=0, task="copy"):
    pipe = j_pipe.SyntheticPipeline(j_pipe.DataConfig(
        vocab_size=vocab, seq_len=S, global_batch=B, task=task))
    return pipe.batch_for_step(step)


def _assert_trees_close(got, want, tol, what):
    got, want = t_ckpt._flatten(got), j_ckpt._flatten(want)
    assert sorted(got) == sorted(want)
    for k in want:
        err = _rel(got[k].astype(np.float32), np.asarray(want[k], np.float32))
        assert err <= tol, f"{what} {k}: rel-L2 {err}"


# -------------------------------------------------------------------------
# cross_entropy
# -------------------------------------------------------------------------
@pytest.mark.parametrize("padded,vocab,pad_id,all_pad", [
    (211, 211, -1, False),           # no padded columns
    (256, 211, -1, False),           # padded vocab: columns 211.. masked
    (256, 211, 0, False),            # pad_id masking
    (256, 211, 0, True),             # every target a pad: the max(., 1)
])
def test_cross_entropy_matches_reference(padded, vocab, pad_id, all_pad):
    rng = np.random.default_rng(padded + pad_id)
    logits = (rng.standard_normal((3, 9, padded)) * 4).astype(np.float32)
    logits[..., vocab:] += 50.0      # padded columns would win unmasked
    targets = rng.integers(0, vocab, (3, 9)).astype(np.int32)
    targets[1, :4] = 0
    if all_pad:
        targets[:] = 0
    want = float(j_trainer.cross_entropy(jnp.asarray(logits),
                                         jnp.asarray(targets), vocab, pad_id))
    got = float(t_trainer.cross_entropy(torch.as_tensor(logits),
                                        torch.as_tensor(targets).long(),
                                        vocab, pad_id))
    if all_pad:
        assert got == want == 0.0
    else:
        assert abs(got - want) <= F32 * abs(want)
    # bf16 logits go through float32 first, on both sides
    lb = torch.as_tensor(logits).to(torch.bfloat16)
    want_b = float(j_trainer.cross_entropy(
        jnp.asarray(logits, jnp.bfloat16), jnp.asarray(targets), vocab,
        pad_id))
    got_b = float(t_trainer.cross_entropy(lb, torch.as_tensor(targets).long(),
                                          vocab, pad_id))
    assert abs(got_b - want_b) <= F32 * max(abs(want_b), 1e-30)


# -------------------------------------------------------------------------
# loss and gradients
# -------------------------------------------------------------------------
def _ref_loss_and_grads(jc, params, batch, remat):
    fn = jax.jit(jax.value_and_grad(j_trainer._loss_with_mask, has_aux=True),
                 static_argnums=(1, 3, 4, 5))
    (loss, (ce, aux)), grads = fn(params, jc, {"tokens": jnp.asarray(
        batch["tokens"])}, None, 0.01, remat)
    return float(loss), float(ce), float(aux), grads


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_loss_and_grads_match_reference(name, remat):
    jc, tc, params = _model(name)
    batch = _batch(tc.vocab_size)
    want = _ref_loss_and_grads(jc, params, batch, remat)
    loss, ce, aux, grads = t_trainer.loss_and_grads(
        _port_params(params), tc, {"tokens": torch.as_tensor(
            batch["tokens"]).long()}, remat=remat)
    assert abs(float(loss) - want[0]) <= LOSS_TOL * abs(want[0])
    assert abs(float(ce) - want[1]) <= LOSS_TOL * abs(want[1])
    if tc.moe is not None:
        assert want[2] > 0.0
    assert abs(float(aux) - want[2]) <= LOSS_TOL * max(abs(want[2]), 1e-30)
    _assert_trees_close(grads, want[3], GRAD_TOL, "grad")


def test_bf16_loss_and_grads_match_reference():
    """bf16 compute over float32 masters: the cast sits inside the graph on
    both sides, so the gradients are float32.  The loss within one bf16
    ulp (2**-8) of the reference's; each gradient leaf no farther from the
    reference's float32 gradient than ``BF16_SLACK`` times the reference's
    own bf16 gradient is."""
    name = "granite-moe-1b-a400m"
    jc, tc, params = _model(name, "bfloat16")
    batch = _batch(tc.vocab_size)
    want = _ref_loss_and_grads(jc, params, batch, True)
    exact = _ref_loss_and_grads(_model(name)[0], params, batch, True)
    loss, _, _, grads = t_trainer.loss_and_grads(
        _port_params(params), tc, {"tokens": torch.as_tensor(
            batch["tokens"]).long()})
    assert abs(float(loss) - want[0]) <= 2 ** -8 * abs(want[0])
    got = t_ckpt._flatten(grads)
    ref, f32 = j_ckpt._flatten(want[3]), j_ckpt._flatten(exact[3])
    assert sorted(got) == sorted(f32)
    for k in f32:
        assert got[k].dtype == np.float32
        own = _rel(np.asarray(ref[k], np.float32), f32[k])
        assert 0.0 < own < 0.5
        assert _rel(got[k], f32[k]) <= BF16_SLACK * own, k


@pytest.mark.parametrize("name", NAMES)
def test_remat_is_bit_equal(name):
    """Recomputing each reuse in the backward changes no bit of the loss or
    of any gradient."""
    _, tc, params = _model(name)
    tp = _port_params(params)
    batch = {"tokens": torch.as_tensor(_batch(tc.vocab_size)["tokens"]).long()}
    off = t_trainer.loss_and_grads(tp, tc, batch, remat=False)
    on = t_trainer.loss_and_grads(tp, tc, batch, remat=True)
    for a, b in zip(off[:3], on[:3]):
        assert torch.equal(a, b)
    for a, b in zip(t_adamw.tree_leaves(off[3]), t_adamw.tree_leaves(on[3])):
        assert torch.equal(a, b)


def test_remat_refuses_a_cache():
    from repro_torch.core.sharing import run_stack
    _, tc, _ = _model("minitron-4b")
    with pytest.raises(ValueError):
        run_stack(None, {}, torch.zeros(1), t_tfm.shareds_for(tc)["main"],
                  cache={}, remat=True)


def test_photonic_training_is_refused():
    _, tc, _ = _model("minitron-4b")
    with pytest.raises(ValueError):
        t_trainer.make_train_step(
            dataclasses.replace(tc, execution="photonic"), TTrain())


# -------------------------------------------------------------------------
# AdamW
# -------------------------------------------------------------------------
def _opt_inputs(seed, step):
    """Params, grads and an AdamW state at ``step`` (numpy), shaped like a
    small tree."""
    rng = np.random.default_rng(seed)
    shapes = {"a": {"w": (8, 5), "b": (5,)}, "emb": {"table": (11, 4)}}

    def tree(scale):
        return {k: {n: (rng.standard_normal(s) * scale).astype(np.float32)
                    for n, s in v.items()} for k, v in shapes.items()}
    p, g, m = tree(1.0), tree(0.3), tree(0.05)
    v = {k: {n: np.abs(a) for n, a in d.items()}
         for k, d in tree(0.01).items()}
    return p, g, m, v, np.int32(step)


def _both(tree_np):
    return (jax.tree.map(jnp.asarray, tree_np),
            jax.tree.map(torch.as_tensor, tree_np))


@pytest.mark.parametrize("grad_clip,step", [(1.0, 0), (1e3, 0), (1.0, 7),
                                            (0.05, 30)])
def test_adamw_update_matches_reference(grad_clip, step):
    """One update from the same params, grads and state; ``grad_clip``
    1.0 and 0.05 clip (the grads' norm is ~2), 1e3 does not."""
    p, g, m, v, s = _opt_inputs(step + int(grad_clip * 7), step)
    jp, tp = _both(p)
    jg, tg = _both(g)
    jm, tm = _both(m)
    jv, tv = _both(v)
    kw = dict(lr=2e-3, warmup_steps=5, total_steps=40, grad_clip=grad_clip,
              weight_decay=0.1)
    jn, jst, jmet = j_adamw.update(
        jp, jg, j_adamw.OptState(m=jm, v=jv, step=jnp.int32(s)), JTrain(**kw))
    tp0 = {k: {n: a.clone() for n, a in d.items()} for k, d in tp.items()}
    tn, tst, tmet = t_adamw.update(
        tp, tg, t_adamw.OptState(m=tm, v=tv, step=torch.tensor(s)),
        TTrain(**kw))
    assert tst.step.dtype == torch.int32 and int(tst.step) == step + 1
    assert int(jst.step) == step + 1
    for got, want in ((tn, jn), (tst.m, jst.m), (tst.v, jst.v)):
        for k in want:
            for n in want[k]:
                assert _rel(_np(got[k][n]), want[k][n]) <= F32
    for key in ("lr", "grad_norm"):
        assert abs(float(tmet[key]) - float(jmet[key])) <= F32 * abs(
            float(jmet[key]))
    clipped = float(jmet["grad_norm"]) > grad_clip
    assert clipped == (grad_clip < 1e3)
    # new tensors: the inputs are untouched
    for k in tp:
        for n in tp[k]:
            assert torch.equal(tp[k][n], tp0[k][n])


def test_cosine_lr_matches_reference():
    """Warm-up, the cosine decay and past the end (0), and a zero warm-up."""
    for kw in (dict(lr=3e-4, warmup_steps=10, total_steps=50),
               dict(lr=1e-3, warmup_steps=0, total_steps=7)):
        for s in (0, 1, 5, 10, 11, 30, 49, 50, 51, 80):
            want = float(j_adamw.cosine_lr(JTrain(**kw), jnp.int32(s)))
            got = float(t_adamw.cosine_lr(TTrain(**kw),
                                          torch.tensor(s, dtype=torch.int32)))
            # near the end 1 + cos(pi * prog) cancels: one float32 ulp of
            # cos moves lr by ~6e-8 of its peak on either side
            assert abs(got - want) <= F32 * kw["lr"]


def test_init_state_is_zero_float32():
    st = t_adamw.init({"a": {"w": torch.ones(3, 2)}})
    assert st.step.dtype == torch.int32 and st.step.ndim == 0
    assert st.m["a"]["w"].dtype == torch.float32
    assert not st.m["a"]["w"].any() and not st.v["a"]["w"].any()


# -------------------------------------------------------------------------
# the train step
# -------------------------------------------------------------------------
TCFG = dict(lr=3e-3, warmup_steps=1, total_steps=10, microbatch=2)


@pytest.mark.parametrize("name", NAMES)
def test_three_microbatched_steps_match_reference(name):
    jc, tc, params = _model(name)
    jstep = jax.jit(j_trainer.make_train_step(jc, JTrain(**TCFG)))
    tstep = t_trainer.make_train_step(tc, TTrain(**TCFG))
    jp, jo = params, j_adamw.init(params)
    tp = _port_params(params)
    to = t_adamw.init(tp)
    for s in range(3):
        b = _batch(tc.vocab_size, step=s)
        jp, jo, jm = jstep(jp, jo, {"tokens": jnp.asarray(b["tokens"])})
        tp, to, tm = tstep(tp, to, {"tokens": torch.as_tensor(
            b["tokens"]).long()})
        for key in ("loss", "grad_norm", "lr"):
            assert abs(float(tm[key]) - float(jm[key])) <= 1e-4 * abs(
                float(jm[key]))
    _assert_trees_close(tp, jp, 1e-4, "params")
    # the MoE router's moments carry its gradient's float32 noise, the
    # largest of any leaf: 1.1e-4 rel-L2 after three steps
    _assert_trees_close((to.m, to.v), (jo.m, jo.v), 1e-3, "state")
    assert int(to.step) == int(jo.step) == 3


def test_microbatched_step_equals_full_batch():
    """Two microbatches of 2 rows against one batch of 4 (the reference's
    grad-accumulation property): every param within 1e-5.  The dense
    model: a MoE's load-balance loss is taken per routing group, so its
    value depends on how the batch is split."""
    _, tc, params = _model("minitron-4b")
    b = {"tokens": torch.as_tensor(_batch(tc.vocab_size)["tokens"]).long()}
    tp = _port_params(params)
    out = {}
    for mb in (0, 2):
        step = t_trainer.make_train_step(tc, TTrain(**dict(TCFG,
                                                           microbatch=mb)))
        out[mb] = step(tp, t_adamw.init(tp), b)
    for a, c in zip(t_adamw.tree_leaves(out[0][0]),
                    t_adamw.tree_leaves(out[2][0])):
        assert _rel(_np(c), _np(a)) <= 1e-5
    with pytest.raises(ValueError):
        t_trainer.make_train_step(tc, TTrain(microbatch=3))(
            tp, t_adamw.init(tp), b)


# -------------------------------------------------------------------------
# the data pipeline
# -------------------------------------------------------------------------
@pytest.mark.parametrize("task", ["copy", "lm"])
def test_pipeline_batches_bit_equal(task):
    for seed in (0, 1234, 99):
        for S in (16, 17):
            kw = dict(vocab_size=211, seq_len=S, global_batch=6, task=task,
                      seed=seed)
            for hosts in (1, 2):
                for h in range(hosts):
                    jp = j_pipe.SyntheticPipeline(j_pipe.DataConfig(**kw),
                                                  hosts, h)
                    tp = t_pipe.SyntheticPipeline(t_pipe.DataConfig(**kw),
                                                  hosts, h)
                    for step in (0, 1, 7, 10_000):
                        want = jp.batch_for_step(step)["tokens"]
                        got = tp.batch_for_step(step)["tokens"]
                        assert got.dtype == want.dtype
                        np.testing.assert_array_equal(got, want)
                    dev = tp.device_batch(3, device="cpu")["tokens"]
                    assert dev.dtype == torch.long
                    np.testing.assert_array_equal(
                        dev.numpy(), jp.batch_for_step(3)["tokens"])
    with pytest.raises(ValueError):
        t_pipe.SyntheticPipeline(t_pipe.DataConfig(**kw), num_hosts=4)


def test_device_batch_defaults_to_cuda():
    tp = t_pipe.SyntheticPipeline(t_pipe.DataConfig(vocab_size=11,
                                                    seq_len=4,
                                                    global_batch=2))
    if torch.cuda.is_available():
        assert tp.device_batch(0)["tokens"].is_cuda
    else:
        with pytest.raises(RuntimeError):
            tp.device_batch(0)


def test_eval_accuracy_equal():
    rng = np.random.default_rng(4)
    toks = _batch(50, B=3, S=12)["tokens"]
    logits = rng.standard_normal((3, 12, 64)).astype(np.float32)
    logits[0, 6:11, :] = 0.0
    logits[0, np.arange(6, 11), toks[0, 7:12]] = 5.0   # row 0 right
    assert t_pipe.eval_accuracy(logits, toks, 50) == j_pipe.eval_accuracy(
        logits, toks, 50)
    assert t_pipe.eval_accuracy(logits, toks, 50) > 0.3


# -------------------------------------------------------------------------
# checkpoints
# -------------------------------------------------------------------------
def _state(name="granite-moe-1b-a400m"):
    """A (params, OptState) pair of both packages with the same non-zero
    values: one reference update from the bridged weights."""
    jc, tc, params = _model(name)
    g = jax.tree.map(lambda p: jnp.full_like(p, 0.01), params)
    jp, jo, _ = j_adamw.update(params, g, j_adamw.init(params), JTrain())
    flat = j_ckpt._flatten((jp, jo))
    return (jp, jo), flat, tc


def _port_template(tc, params_flat):
    tp = bridge.params_from_flat(
        {k[2:]: v for k, v in params_flat.items() if k.startswith("0/")},
        device="cpu")
    return (tp, t_adamw.init(tp))


def test_checkpoint_reference_to_port(tmp_path):
    (jp, jo), flat, tc = _state()
    d = str(tmp_path / "ck")
    j_ckpt.save(d, 5, (jp, jo), extra={"next_step": 5})
    assert t_ckpt.latest_step(d) == 5
    (tp, to), extra = t_ckpt.restore(d, 5, _port_template(tc, flat))
    assert extra == {"next_step": 5}
    got = t_ckpt._flatten((tp, to))
    assert sorted(got) == sorted(flat)
    for k in flat:
        assert got[k].dtype == flat[k].dtype and got[k].shape == flat[k].shape
        np.testing.assert_array_equal(got[k], flat[k])
    assert to.step.dtype == torch.int32 and int(to.step) == 1


def test_checkpoint_port_to_reference(tmp_path):
    (jp, jo), flat, tc = _state()
    tp = bridge.params_from_flat(
        {k[2:]: v for k, v in flat.items() if k.startswith("0/")},
        device="cpu")
    to = t_adamw.OptState(
        m=bridge.params_from_flat({k[4:]: v for k, v in flat.items()
                                   if k.startswith("1/m/")}, device="cpu"),
        v=bridge.params_from_flat({k[4:]: v for k, v in flat.items()
                                   if k.startswith("1/v/")}, device="cpu"),
        step=torch.tensor(int(flat["1/step"]), dtype=torch.int32))
    d = str(tmp_path / "ck")
    path = t_ckpt.save(d, 9, (tp, to), extra={"next_step": 9})
    assert os.path.basename(path) == "step_00000009"
    meta_keys = sorted(t_ckpt._flatten((tp, to)))
    assert meta_keys == sorted(flat)
    template = (jax.tree.map(jnp.zeros_like, jp),
                j_adamw.init(jax.tree.map(jnp.zeros_like, jp)))
    (rp, ro), extra = j_ckpt.restore(d, 9, template)
    assert extra == {"next_step": 9}
    back = j_ckpt._flatten((rp, ro))
    for k in flat:
        assert back[k].dtype == flat[k].dtype
        np.testing.assert_array_equal(back[k], flat[k])


def test_checkpoint_bf16_leaves_cross(tmp_path):
    """bf16 leaves as numpy stores the reference's (raw two-byte values),
    both ways, bit for bit."""
    a = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    jt = {"w": jnp.asarray(a, jnp.bfloat16)}
    tt = {"w": torch.as_tensor(a).to(torch.bfloat16)}
    j_ckpt.save(str(tmp_path / "j"), 1, jt)
    got, _ = t_ckpt.restore(str(tmp_path / "j"), 1,
                            {"w": torch.zeros(3, 5, dtype=torch.bfloat16)})
    assert torch.equal(got["w"], tt["w"])
    t_ckpt.save(str(tmp_path / "t"), 1, tt)
    with np.load(os.path.join(str(tmp_path / "t"), "step_00000001",
                              "arrays.npz")) as z:
        raw = z["w"]
    np.testing.assert_array_equal(
        raw.view(np.uint16), np.asarray(jt["w"]).view(np.uint16))


def test_checkpoint_detects_corruption_and_shape(tmp_path):
    _, tc, params = _model("minitron-4b")
    tp = _port_params(params)
    d = str(tmp_path / "ck")
    path = t_ckpt.save(d, 1, tp)
    with pytest.raises(ValueError):
        bad = dict(tp, embed={"table": torch.zeros(3, 3)})
        t_ckpt.restore(d, 1, bad)
    npz = os.path.join(path, "arrays.npz")
    with open(npz, "r+b") as f:
        f.seek(100)
        f.write(b"\x00\x01\x02corrupt")
    with pytest.raises(IOError):
        t_ckpt.restore(d, 1, tp)


def test_checkpoint_gc_keeps_latest_three(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"w": torch.arange(4.0)}
    assert t_ckpt.latest_step(d) is None
    for s in (1, 2, 3, 4, 5):
        t_ckpt.save(d, s, tree)
    steps = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    assert steps == ["step_00000003", "step_00000004", "step_00000005"]
    assert not [x for x in os.listdir(d) if x.startswith(".tmp_step_")]
    assert t_ckpt.latest_step(d) == 5


# -------------------------------------------------------------------------
# Program.loss
# -------------------------------------------------------------------------
@pytest.mark.parametrize("execution", ["xla", "photonic"])
@pytest.mark.parametrize("name", NAMES)
def test_program_loss_matches_reference(name, execution):
    jc, tc, params = _model(name)
    b = _batch(tc.vocab_size, B=2, S=24, step=5, task="lm")
    jprog = j_api.Program.build(jc, params, execution=execution)
    tprog = t_api.Program.build(tc, _port_params(params),
                                execution=execution, device="cpu")
    jce, jaux = jprog.loss({"tokens": jnp.asarray(b["tokens"])})
    tce, taux = tprog.loss(b)
    tol = 1e-5 if execution == "xla" else 1e-3
    assert tce.dtype == torch.float32
    assert abs(float(tce) - float(jce)) <= tol * abs(float(jce))
    assert abs(float(taux) - float(jaux)) <= tol * max(abs(float(jaux)),
                                                       1e-30)


def test_moe_photonic_logits_leave_the_w8a8_bound_in_both_packages():
    """Why the card's held-out eval holds each kernel call to its plain
    version, and the cross-entropy to xla's, rather than the photonic
    logits to the xla ones: on the MoE smoke model the reference's own
    photonic logits lie 0.2-0.4 rel-L2 from its xla logits (per-tensor A8
    moves near-tied routing choices, and a moved choice carries through
    the layers), and the port's lie as far; the cross-entropies agree to
    1e-2."""
    jc, tc, params = _model("granite-moe-1b-a400m")
    b = _batch(tc.vocab_size, B=2, S=24, step=5, task="lm")
    gaps, ces = {}, {}
    for pkg in ("reference", "port"):
        out = {}
        for ex in ("xla", "photonic"):
            if pkg == "reference":
                prog = j_api.Program.build(jc, params, execution=ex)
                lg = j_tfm.forward(prog.bank, jc, {"tokens": jnp.asarray(
                    b["tokens"])}, mode="train", execution=prog.backend)[0]
                ces[pkg, ex] = float(prog.loss({"tokens": jnp.asarray(
                    b["tokens"])})[0])
            else:
                prog = t_api.Program.build(tc, _port_params(params),
                                           execution=ex, device="cpu")
                toks = torch.as_tensor(b["tokens"]).long()
                with torch.no_grad():
                    lg = t_tfm.forward(prog.bank, tc, {"tokens": toks},
                                       execution=prog.backend)[0]
                ces[pkg, ex] = float(prog.loss(b)[0])
            out[ex] = _np(lg)
        gaps[pkg] = _rel(out["photonic"], out["xla"])
        assert abs(ces[pkg, "photonic"] - ces[pkg, "xla"]) <= 1e-2 * abs(
            ces[pkg, "xla"])
    assert 0.2 <= gaps["reference"] <= 0.4 and 0.2 <= gaps["port"] <= 0.4
