"""The port's vision task and paper-table runner against the reference's
``benchmarks/_vision_task.py`` and ``benchmarks/run.py``: ``make_task``'s
batches, three ``train_classifier`` steps of the MLP (layer-wise 1x6) and
the Mixer (block-wise 2x4, shuffle and transpose) from the same weights,
the loss, the Table 2, 3 and Fig. 1 details and Table 4's parameter and
energy columns, and ``python -m repro_torch.paper_run`` end to end.

Tolerances: batches and the cost-model details exact; the loss within
1e-6 relative (one float32 log-softmax); params after three AdamW steps
within 1e-4 rel-L2 (float32 forward and backward passes through other
kernels in another summation order).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import _vision_task as j_task  # noqa: E402
from benchmarks import run as j_run  # noqa: E402
from repro.core import costmodel as j_cost  # noqa: E402
from repro.core.prm import ReuseConfig as JReuse  # noqa: E402
from repro.models import paper_models as j_pm  # noqa: E402
from repro.train import checkpoint as j_ckpt  # noqa: E402

from repro_torch import bridge, paper_run  # noqa: E402
from repro_torch import vision_task as t_task  # noqa: E402
from repro_torch.core.prm import ReuseConfig as TReuse  # noqa: E402
from repro_torch.core.sharing import SharedStack  # noqa: E402
from repro_torch.models import paper_models as t_pm  # noqa: E402

torch.set_num_threads(2)
PARAM_TOL = 1e-4
LOSS_TOL = 1e-6
MIXER_T = ("identity", "shuffle", "transpose", "shuffle")


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


@pytest.mark.parametrize("seed,steps,batch", [(0, (0, 1, 119), 64),
                                              (3, (10_000, 10_003), 256)])
def test_make_task_batches_bit_equal(seed, steps, batch):
    jt = j_task.make_task(seed=seed)
    tt = t_task.make_task(seed=seed, device="cpu")
    for s in steps:
        jx, jy = jt(s, batch)
        tx, ty = tt(s, batch)
        assert tx.dtype == torch.float32 and tuple(tx.shape) == jx.shape
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))


def _models(name):
    """(reference params, reference forward, port params, port forward)."""
    if name == "mlp":
        tf = ("identity", "shuffle", "transpose")
        jc = j_pm.MLPConfig(reuse=JReuse(num_basic=1, reuse_times=6,
                                         transforms=tf))
        tc = t_pm.MLPConfig(reuse=TReuse(num_basic=1, reuse_times=6,
                                         transforms=tf))
        jp, jsh = j_pm.mlp_init(jax.random.PRNGKey(0), jc)
        tsh = SharedStack.build(tc.depth, tc.width, tc.reuse)
        jf = lambda p, x: j_pm.mlp_forward(                  # noqa: E731
            p, jc, jsh, x.reshape(x.shape[0], -1)[:, :784])
        tf_ = lambda p, x: t_pm.mlp_forward(                 # noqa: E731
            p, tc, tsh, x.reshape(x.shape[0], -1)[:, :784])
    else:
        jc = j_pm.MixerConfig(reuse=JReuse(num_basic=2, reuse_times=4,
                                           transforms=MIXER_T))
        tc = t_pm.MixerConfig(reuse=TReuse(num_basic=2, reuse_times=4,
                                           transforms=MIXER_T))
        jp, jsh = j_pm.mixer_init(jax.random.PRNGKey(0), jc)
        tsh = SharedStack.build(tc.blocks, tc.channels, tc.reuse)
        jf = lambda p, x: j_pm.mixer_forward(p, jc, jsh, x)  # noqa: E731
        tf_ = lambda p, x: t_pm.mixer_forward(p, tc, tsh, x)  # noqa: E731
    tp = bridge.paper_params_from_flat(j_ckpt._flatten(jp), device="cpu")
    return jp, jf, tp, tf_


@pytest.mark.parametrize("name", ["mlp", "mixer"])
def test_three_train_steps_match_reference(name):
    jp, jf, tp, tf_ = _models(name)
    x, y = j_task.make_task(seed=0)(0, 64)
    ls = jax.nn.log_softmax(jf(jp, x).astype(jnp.float32))
    want_loss = float(-jnp.mean(jnp.take_along_axis(ls, y[:, None], axis=1)))
    jp3, jacc = j_task.train_classifier(jf, jp, steps=3, batch_size=64,
                                        eval_batches=1)
    losses = []
    tp3, tacc = t_task.train_classifier(tf_, tp, steps=3, batch_size=64,
                                        eval_batches=1, device="cpu",
                                        losses=losses)
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses[0] == pytest.approx(want_loss, rel=LOSS_TOL)
    want = j_ckpt._flatten(jp3)
    got = {"/".join(k): v.numpy() for k, v in _flat(tp3)}
    assert sorted(got) == sorted(want)
    for k in want:
        assert _rel(got[k], want[k]) <= PARAM_TOL, k
    out = "w_out" if name == "mlp" else "head"
    moved = _rel(got[out], j_ckpt._flatten(jp)[out])
    assert moved > 10 * PARAM_TOL          # three steps moved the weights
    assert 0.0 <= tacc <= 1.0 and abs(tacc - jacc) <= 4 / 256


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flat(tree[k], path + (k,))]
    return [(path, tree)]


def test_train_step_leaves_its_inputs_and_counts_steps():
    _, _, tp, tf_ = _models("mlp")
    before = {k: v.clone() for k, v in _flat(tp)}
    from repro_torch.configs.base import TrainConfig
    from repro_torch.optim import adamw
    opt = adamw.init(tp)
    x, y = t_task.make_task(device="cpu")(0, 8)
    p1, opt1, loss = t_task.train_step(tf_, tp, opt, x, y, TrainConfig(
        lr=1e-3, weight_decay=1e-4, warmup_steps=10, total_steps=3))
    for k, v in _flat(tp):
        assert torch.equal(v, before[k]) and not v.requires_grad
    assert int(opt1.step) == 1 and loss.ndim == 0 and not loss.requires_grad
    assert all(not v.requires_grad for _, v in _flat(p1))


def test_table2_table3_fig1_details_equal_reference(capsys):
    j_run.bench_table2()
    j_run.bench_table3()
    j_run.bench_fig1()
    capsys.readouterr()
    t2, t3, f1 = (paper_run.bench_table2(), paper_run.bench_table3(),
                  paper_run.bench_fig1())
    assert t2.details == j_run.DETAILS["table2"]
    assert t3.details == j_run.DETAILS["table3"]
    assert f1.details == j_run.DETAILS["fig1"]
    assert [b.name for b in (t2, t3, f1)] == [
        "table2_hw_cost", "table3_energy_delay", "fig1_energy_breakdown"]
    assert "latency saving @1024: 56.7%" in t3.derived
    for det in t3.details:
        for got, want in zip((det["delay_no_reuse_ns"],
                              det["energy_no_reuse_uJ"],
                              det["delay_reuse_ns"], det["energy_reuse_uJ"]),
                             det["paper"]):
            assert abs(got - want) / want <= 5e-3


def _reference_columns(model, cfg):
    """Table 4's params and energy columns from the reference's models and
    cost model, as ``benchmarks/run.py`` computes them."""
    rc = None
    if getattr(cfg, "reuse", None) is not None:
        rc = JReuse(**dataclasses.asdict(cfg.reuse))
    key = jax.random.PRNGKey(0)
    if model == "MLP":
        jc = j_pm.MLPConfig(reuse=rc)
        p, sh = j_pm.mlp_init(key, jc)
        cost = j_cost.stack_cost(j_pm.mlp_weight_shapes(jc), sh.plan, tile=8)
    elif model == "MLP-Mixer":
        jc = j_pm.MixerConfig(reuse=rc)
        p, sh = j_pm.mixer_init(key, jc)
        cost = j_cost.stack_cost(j_pm.mixer_weight_shapes(jc), sh.plan,
                                 tile=8)
    elif model == "VGG-13":
        jc = j_pm.VGGConfig(share_same_shape=cfg.share_same_shape)
        p = j_pm.vgg13_init(key, jc)
        shapes, programs = j_pm.vgg13_weight_shapes(jc, cfg.share_same_shape)
        cost = j_cost.ZERO_COST
        for (r, c), prog in zip(shapes, programs):
            cost = cost + j_cost.matrix_cost(r, c, 8, programs=prog,
                                             passes=1)
        return round(j_pm.param_count(p) / 1e6, 2), round(cost.energy_uJ, 2)
    else:
        p = j_pm.resnet18_init(key, j_pm.ResNetConfig(
            share_within_stage=cfg.share_within_stage))
        return round(j_pm.param_count(p) / 1e6, 2), None
    return round(j_pm.param_count(p) / 1e6, 3), round(cost.energy_uJ, 2)


def test_table4_cost_columns_equal_reference():
    variants = paper_run.table4_variants()
    assert [(m, a) for m, a, _ in variants] == [
        ("MLP", "baseline"), ("MLP", "layer-wise 1x6"),
        ("MLP-Mixer", "baseline"), ("MLP-Mixer", "block-wise 1x8"),
        ("MLP-Mixer", "block-wise 2x4"), ("VGG-13", "baseline"),
        ("VGG-13", "layer-wise shared"), ("ResNet-18", "baseline"),
        ("ResNet-18", "stage shared")]
    for model, arc, cfg in variants:
        p, sh, fwd = paper_run.build(cfg, device="cpu")
        assert (fwd is None) == (model in ("VGG-13", "ResNet-18"))
        assert paper_run.cost_columns(cfg, p, sh) == \
            _reference_columns(model, cfg), (model, arc)
    assert [m for m, _ in paper_run.table5_variants()] == [
        "baseline(no reuse)", "reuse only", "reuse+shuffle",
        "reuse+transpose", "reuse+shuffle+transpose"]


def test_paper_run_cli_table3(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.paper_run", "--quick",
         "--device", "cpu", "--only", "table3"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert lines[1].startswith("table3_energy_delay,")
    assert "latency saving @1024: 56.7%" in lines[1]
    details = json.loads((tmp_path / "results" /
                          "torch_bench_details.json").read_text())
    assert list(details) == ["table3"]
    assert [d["tile"] for d in details["table3"]] == [64, 256, 1024]
    bad = subprocess.run(
        [sys.executable, "-m", "repro_torch.paper_run", "--device", "cpu",
         "--only", "table9"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=120)
    assert bad.returncode == 2 and "--only" in bad.stderr
