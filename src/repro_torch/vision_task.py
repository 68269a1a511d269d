"""Synthetic CIFAR-stand-in vision task for the accuracy-bearing tables
(port of ``benchmarks/_vision_task.py``).

No datasets ship offline, so the Tables 4/5 accuracy columns use a
deterministic 10-class task: each class has a fixed random 32x32x3
template; samples are ``alpha * template[y] + noise`` with per-sample
contrast jitter.  The task is non-trivial (templates overlap, SNR < 1) but
learnable, which is what measuring *relative* accuracy across R&B
ablations needs.  Batches come from the reference's numpy streams, so they
are bit-equal to its batches, on the asked device.

:func:`train_classifier` trains a functional params tree with the port's
AdamW under the reference's ``TrainConfig`` (weight decay 1e-4, 10 warm-up
steps, cosine to ``steps``, global-norm clip 1.0) on the float32
log-softmax cross entropy; gradients come from ``torch.autograd`` over
the tree's leaves.  Entry points run on the CUDA device unless given
``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.device import resolve_device
from repro_torch.optim import adamw


def make_task(num_classes=10, image=32, seed=0, snr=0.8, device=None):
    """``batch(step, batch_size) -> (x float32 NHWC, y int64)`` on
    ``device`` (default CUDA)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    templates = rng.normal(size=(num_classes, image, image, 3)).astype(
        np.float32)

    def batch(step: int, batch_size: int):
        r = np.random.default_rng(seed * 7919 + step)
        y = r.integers(0, num_classes, size=(batch_size,))
        alpha = r.uniform(0.7, 1.3, size=(batch_size, 1, 1, 1)).astype(
            np.float32)
        x = (snr * alpha * templates[y]
             + r.normal(size=(batch_size, image, image, 3))).astype(
            np.float32)
        return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)

    return batch


def loss_fn(forward, params, x, y) -> torch.Tensor:
    ls = torch.log_softmax(forward(params, x).to(torch.float32), dim=-1)
    return -ls.gather(1, y[:, None]).mean()


def train_step(forward, params, opt, x, y, tcfg: TrainConfig):
    """One AdamW step on the loss's gradient (the reference's jitted
    ``step_fn``).  Returns (params, opt, loss); the params passed in are
    left as they were."""
    p = adamw.tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss = loss_fn(forward, p, x, y)
    loss.backward()
    grads = adamw.tree_map(lambda t: t.grad, p)
    params, opt, _ = adamw.update(params, grads, opt, tcfg)
    return params, opt, loss.detach()


@torch.no_grad()
def accuracy(forward, params, task, eval_batches=4) -> float:
    """Mean accuracy over the held-out batches ``10_000 + i`` of 256."""
    accs = []
    for i in range(eval_batches):
        x, y = task(10_000 + i, 256)
        accs.append(float((forward(params, x).argmax(-1) == y)
                          .to(torch.float32).mean()))
    return float(np.mean(accs))


def train_classifier(forward, params, *, steps=200, batch_size=128, lr=1e-3,
                     seed=0, eval_batches=4, device=None, losses=None):
    """Generic small-model classifier training; returns (params, accuracy).
    ``params`` must already be on ``device`` (default CUDA).  A list passed
    as ``losses`` receives every step's loss (read once, at the end)."""
    task = make_task(seed=seed, device=device)
    tcfg = TrainConfig(lr=lr, weight_decay=1e-4, warmup_steps=10,
                       total_steps=steps, grad_clip=1.0)
    opt = adamw.init(params)
    step_losses = []
    for s in range(steps):
        x, y = task(s, batch_size)
        params, opt, loss = train_step(forward, params, opt, x, y, tcfg)
        step_losses.append(loss)
    if losses is not None and step_losses:
        losses.extend(torch.stack(step_losses).cpu().tolist())
    return params, accuracy(forward, params, task, eval_batches)
