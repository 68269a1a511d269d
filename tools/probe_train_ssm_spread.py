"""How far three microbatched train steps of the jamba (or mamba2) smoke
R&B model drift apart by float32 summation order alone, on the CPU: the
JAX reference's jitted step against the same step run eagerly
(``jax.disable_jit``), and the port's step against the jitted reference,
from the same weights (``PRNGKey(3)``) and batches as
``tests/test_torch_train_ssm.py``.  Prints the five largest rel-L2 leaf
gaps of the params and of the Adam moments after the steps (keys ``0/``
params, ``1/`` m, ``2/`` v) for each pair (~1.5 min).

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu \
        python tools/probe_train_ssm_spread.py [arch]
"""
import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import TrainConfig as JTrain
from repro.optim import adamw as j_adamw
from repro.train import checkpoint as j_ckpt
from repro.train import trainer as j_trainer

from repro_torch.configs.base import TrainConfig as TTrain
from repro_torch.optim import adamw as t_adamw
from repro_torch.train import checkpoint as t_ckpt
from repro_torch.train import trainer as t_trainer

import test_torch_train as tt
import test_torch_train_ssm as ts


def _steps(step, params, opt, vocab, port=False):
    """The params and the Adam moments after three steps."""
    for s in range(3):
        b = tt._batch(vocab, step=s)["tokens"]
        batch = {"tokens": torch.as_tensor(b).long() if port
                 else jnp.asarray(b)}
        params, opt, _ = step(params, opt, batch)
    return params, opt.m, opt.v


def _top(got: dict, want: dict, label: str) -> None:
    errs = {k: tt._rel(np.asarray(got[k], np.float32),
                       np.asarray(want[k], np.float32)) for k in want}
    for k, e in sorted(errs.items(), key=lambda kv: -kv[1])[:5]:
        print(f"{label}\t{k}\t{e:.4e}")


def main(arch: str) -> None:
    jc, tc, params = tt._model(arch)
    jitted = _steps(jax.jit(j_trainer.make_train_step(jc, JTrain(
        **ts.TCFG))), params, j_adamw.init(params), tc.vocab_size)
    with jax.disable_jit():
        eager = _steps(j_trainer.make_train_step(jc, JTrain(**ts.TCFG)),
                       params, j_adamw.init(params), tc.vocab_size)
    tp = tt._port_params(params)
    port = _steps(t_trainer.make_train_step(tc, TTrain(**ts.TCFG)), tp,
                  t_adamw.init(tp), tc.vocab_size, port=True)
    want = j_ckpt._flatten(jitted)
    _top(j_ckpt._flatten(eager), want, "reference eager vs jitted")
    _top(t_ckpt._flatten(port), want, "port vs reference jitted")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "jamba-v0.1-52b")
