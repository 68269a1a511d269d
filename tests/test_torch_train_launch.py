"""The port's training launcher (``repro_torch.launch.train``) on the CPU:
``main`` with the reference's flags and printed lines, exact resume, a
resume from a checkpoint the JAX reference wrote, the preemption trap and
the straggler watch.  The reference's own launcher builds a device mesh
(``sharding/partition.py``), so these tests hold the port to the
reference's ``make_train_step`` and ``checkpoint`` instead.

Models: the launcher's ``--smoke --reuse`` granite-moe-1b-a400m (MoE, R&B
2 x 2, float32).  Exact: a resumed run's params against a straight run's,
bit for bit.  A resume from the reference's checkpoint: params within
1e-4 rel-L2 of the reference's own steps (the gate of the three-step
comparison in ``tests/test_torch_train.py``).
"""
import os
import re
import signal
import types

import numpy as np
import pytest
import torch

import jax

from repro.configs import rb as j_rb
from repro.configs import smoke_variant as j_smoke
from repro.configs.base import TrainConfig as JTrain
from repro.data import pipeline as j_pipe
from repro.models import transformer as j_tfm
from repro.optim import adamw as j_adamw
from repro.train import checkpoint as j_ckpt
from repro.train import trainer as j_trainer

from repro_torch.api import Program
from repro_torch.configs.base import TrainConfig as TTrain
from repro_torch.data import pipeline as t_pipe
from repro_torch.launch import train as launch
from repro_torch.optim import adamw as t_adamw
from repro_torch.train import checkpoint as t_ckpt

torch.set_num_threads(2)
NAME = "granite-moe-1b-a400m"
ARGV = ["--arch", NAME, "--smoke", "--reuse", "--device", "cpu"]
STEP_LINE = re.compile(r"^step +(\d+) loss (\d+\.\d{4}) gnorm (\d+\.\d{3}) "
                       r"lr (\d\.\d{2}e[+-]\d{2}) (\d+\.\d{2})s$")


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _cfg():
    return launch.build_config(launch.parse_args(ARGV))


def _tcfg(d, **kw):
    base = dict(lr=3e-3, total_steps=6, warmup_steps=1, checkpoint_every=0,
                checkpoint_dir=str(d), microbatch=2)
    base.update(kw)
    return TTrain(**base)


def _run(d, steps, **kw):
    return launch.run(_cfg(), _tcfg(d), batch=4, seq=16, steps=steps,
                      device="cpu", **kw)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(t_adamw.tree_leaves(a),
                                                  t_adamw.tree_leaves(b)))


def test_main_prints_the_reference_lines(tmp_path, capsys):
    """The step lines (every ``log_every`` and the last), a checkpoint every
    ``--ckpt-every`` steps plus the final one, ``done`` and the held-out
    ``Program.loss`` eval on pipeline seed + 1, step 10000."""
    d = tmp_path / "ck"
    launch.main(ARGV + ["--steps", "12", "--batch", "4", "--seq", "16",
                        "--ckpt-dir", str(d), "--ckpt-every", "5"])
    lines = capsys.readouterr().out.strip().splitlines()
    steps = [STEP_LINE.match(x) for x in lines if x.startswith("step")]
    assert [int(m.group(1)) for m in steps] == [0, 10, 11]
    assert all(np.isfinite(float(m.group(2))) for m in steps)
    done = re.match(r"^\[train\] done\. loss (\d+\.\d{3}) -> (\d+\.\d{3})$",
                    lines[-2])
    assert done and done.group(1) == f"{float(steps[0].group(2)):.3f}"
    ev = re.match(r"^\[train\] held-out eval via Program\.loss: ce "
                  r"(\d+\.\d{4})$", lines[-1])
    assert ev
    assert sorted(os.listdir(d)) == ["step_00000005", "step_00000010",
                                     "step_00000012"]
    # the eval, again from the final checkpoint
    cfg = _cfg()
    from repro_torch.models import transformer as t_tfm
    tmpl = t_tfm.init_model(cfg, seed=0, device="cpu")
    (params, _), extra = t_ckpt.restore(str(d), 12,
                                        (tmpl, t_adamw.init(tmpl)))
    assert extra == {"next_step": 12}
    pipe = t_pipe.SyntheticPipeline(t_pipe.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=4, seed=1))
    ce, _ = Program.build(cfg, params, device="cpu").loss(
        pipe.device_batch(10_000, device="cpu"))
    assert ev.group(1) == f"{float(ce):.4f}"


def test_main_defaults_to_the_card():
    assert launch.parse_args(["--arch", NAME]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            launch.main(["--arch", NAME, "--smoke", "--steps", "1"])


def test_resume_is_exact(tmp_path, capsys):
    """A run to step 2, then a resumed run to step 4: params and the Adam
    state bit-equal to a straight 4-step run."""
    p_straight, o_straight, l_straight = _run(tmp_path / "a", 4)
    _run(tmp_path / "b", 2)
    capsys.readouterr()
    p, o, losses = _run(tmp_path / "b", 4)
    assert "[train] resumed from step 2" in capsys.readouterr().out
    assert losses == l_straight[2:]
    assert _equal(p, p_straight) and _equal(o.m, o_straight.m)
    assert _equal(o.v, o_straight.v) and int(o.step) == 4


def test_resume_from_a_reference_checkpoint(tmp_path):
    """The reference trains 2 steps from its own init and saves; the port's
    ``run`` resumes from that checkpoint and takes steps 2-3 on the same
    pipeline batches; the reference's ``make_train_step`` takes the same
    two steps.  Params within 1e-4, losses within 1e-5."""
    jc = j_rb(j_smoke(NAME), 2, 2)
    kw = dict(lr=3e-3, total_steps=6, warmup_steps=1, microbatch=2)
    params, _ = j_tfm.init_model(jax.random.PRNGKey(0), jc)
    opt = j_adamw.init(params)
    step = jax.jit(j_trainer.make_train_step(jc, JTrain(**kw)))
    pipe = j_pipe.SyntheticPipeline(j_pipe.DataConfig(
        vocab_size=jc.vocab_size, seq_len=16, global_batch=4, seed=0))
    want = []
    for s in range(4):
        params, opt, m = step(params, opt, pipe.device_batch(s))
        want.append(float(m["loss"]))
        if s == 1:
            j_ckpt.save(str(tmp_path), 2, (params, opt),
                        extra={"next_step": 2})
    p, o, losses = launch.run(_cfg(), _tcfg(tmp_path, **kw), batch=4,
                              seq=16, steps=4, device="cpu")
    assert len(losses) == 2
    for got, w in zip(losses, want[2:]):
        assert abs(got - w) <= 1e-5 * abs(w)
    got, ref = t_ckpt._flatten((p, o)), j_ckpt._flatten((params, opt))
    assert sorted(got) == sorted(ref)
    for k in ref:
        if k.startswith("0/"):
            assert _rel(got[k], np.asarray(ref[k])) <= 1e-4, k
    assert int(o.step) == 4


def test_preemption_flushes_a_checkpoint_that_resumes(tmp_path, capsys,
                                                      monkeypatch):
    """SIGTERM delivered while step 2 loads its batch: the step finishes,
    the trap prints the reference's message and saves step 3; a second run
    resumes there and lands bit-equal on a straight run."""
    p_straight, _, _ = _run(tmp_path / "a", 5)
    real = t_pipe.SyntheticPipeline.device_batch

    def batch(self, step, device=None):
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(self, step, device=device)

    monkeypatch.setattr(t_pipe.SyntheticPipeline, "device_batch", batch)
    before = signal.getsignal(signal.SIGTERM)
    capsys.readouterr()
    _, _, losses = _run(tmp_path / "b", 5)
    out = capsys.readouterr().out
    assert "[train] preemption signal — checkpoint + exit" in out
    assert len(losses) == 3 and t_ckpt.latest_step(str(tmp_path / "b")) == 3
    assert signal.getsignal(signal.SIGTERM) is before
    monkeypatch.setattr(t_pipe.SyntheticPipeline, "device_batch", real)
    p, _, losses = _run(tmp_path / "b", 5)
    assert len(losses) == 2 and _equal(p, p_straight)


def test_straggler_is_flagged(tmp_path, capsys, monkeypatch):
    """Steps of 0.1 s and one of 5 s at step 22: mean + 4 std of the last
    50 (the step itself among them) flags it, and only it."""
    clock = {"t": 0.0, "calls": 0}

    def fake_time():
        clock["calls"] += 1
        if clock["calls"] % 2 == 0:                     # a step's end
            clock["t"] += 5.0 if clock["calls"] // 2 == 23 else 0.1
        return clock["t"]

    monkeypatch.setattr(launch, "time", types.SimpleNamespace(time=fake_time))
    launch.run(_cfg(), _tcfg(tmp_path, microbatch=0), batch=2, seq=8,
               steps=24, device="cpu", log_every=100)
    flagged = [x for x in capsys.readouterr().out.splitlines()
               if x.startswith("[straggler]")]
    assert len(flagged) == 1
    assert re.match(r"^\[straggler\] step 22 took 5\.000s \(mean \d\.\d{3}s\)"
                    r" — flagged$", flagged[0])


def test_record_holds_every_step(tmp_path):
    rec = []
    _, _, losses = launch.run(_cfg(), _tcfg(tmp_path), batch=4, seq=16,
                              steps=3, device="cpu", record=rec)
    assert [r["step"] for r in rec] == [0, 1, 2]
    assert [r["loss"] for r in rec] == losses
    assert all(r["s"] > 0 and float(r["grad_norm"]) > 0 for r in rec)
    assert float(rec[0]["lr"]) == pytest.approx(3e-3)
