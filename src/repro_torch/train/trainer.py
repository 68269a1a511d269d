"""The train step (port of ``repro.train.trainer``): a mixed-precision
forward (float32 masters cast to ``cfg.compute_dtype`` inside the graph),
per-reuse remat, optional gradient accumulation over microbatches, and the
AdamW update.

Gradients come from ``torch.autograd`` over the xla backend's torch ops,
as the reference differentiates XLA ops.  A photonic backend is refused:
its MVM kernels carry no autograd, so a gradient through them would leave
the weights out.

Training keeps no mesh (no ``act_pspec``): the reference's train cell
shards the batch over "data" and lets GSPMD all-reduce the gradients (and
reduce-scatter them under ``cfg.fsdp``); the port's step would need that
gradient exchange over the ranks, left for a later slice, so a config
carrying a mesh-only setting (``cfg.fsdp`` is refused by
``Program.build`` on a mesh) trains on one device.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import backend as backend_lib
from repro_torch.device import torch_dtype
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw

NEG_INF = -1e30
AUX_WEIGHT = 0.01


def cross_entropy(logits, targets, vocab_size: int, pad_id: int = -1):
    """Next-token CE with padded-vocab masking (the pad columns never
    win), averaged over the targets that are not ``pad_id``."""
    lf = logits.to(torch.float32)
    padded = lf.shape[-1]
    if padded != vocab_size:
        col = torch.arange(padded, device=lf.device)
        lf = lf.masked_fill(col >= vocab_size, NEG_INF)
    ls = torch.log_softmax(lf, dim=-1)
    nll = -torch.gather(ls, -1, targets[..., None].long())[..., 0]
    mask = (targets != pad_id).to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _loss_with_mask(params, cfg: ModelConfig, batch, aux_weight, remat):
    dtype = torch_dtype(cfg.compute_dtype)
    compute = adamw.tree_map(
        lambda p: p.to(dtype) if p.dtype == torch.float32 else p, params)
    logits, _, aux = tfm.forward(compute, cfg, batch, mode="train",
                                 remat=remat)
    tokens = batch["tokens"]
    ce = cross_entropy(logits[:, :-1], tokens[:, 1:], cfg.vocab_size)
    return ce + aux_weight * aux, (ce, aux)


def loss_and_grads(params, cfg: ModelConfig, batch, remat: bool = True):
    """(loss, ce, aux, grads): the loss of ``batch`` and its gradient with
    respect to every leaf of ``params`` (a tree of the same shape)."""
    tracked = adamw.tree_map(lambda p: p.detach().requires_grad_(True),
                             params)
    live = adamw.tree_leaves(tracked)
    loss, (ce, aux) = _loss_with_mask(tracked, cfg, batch, AUX_WEIGHT, remat)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    by_id = {id(p): torch.zeros_like(p) if g is None else g
             for p, g in zip(live, grads)}
    return (loss.detach(), ce.detach(), aux.detach(),
            adamw.tree_map(lambda p: by_id[id(p)], tracked))


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, remat: bool = True):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; metrics hold the 0-d tensors ``loss``, ``lr`` and
    ``grad_norm``.

    With ``tcfg.microbatch > 1`` the batch splits into that many
    microbatches along its rows; their float32 gradients are summed and
    divided by the count, and the loss is their mean."""
    if backend_lib.resolve(cfg).is_photonic:
        raise ValueError(f"{cfg.name}: training runs on the xla backend; "
                         f"the photonic kernels carry no gradient")

    def train_step(params, opt_state, batch):
        mb = tcfg.microbatch
        if mb and mb > 1:
            B = batch["tokens"].shape[0]
            if B % mb:
                raise ValueError(f"batch {B} does not split into {mb} "
                                 f"microbatches")
            split = {k: v.reshape(mb, B // mb, *v.shape[1:])
                     for k, v in batch.items()}
            gsum = adamw.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            lsum = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            for i in range(mb):
                loss, _, _, g = loss_and_grads(
                    params, cfg, {k: v[i] for k, v in split.items()}, remat)
                adamw.tree_map(lambda a, b: a.add_(b), gsum, g)
                lsum = lsum + loss
                del g
            grads = adamw.tree_map(lambda g: g / mb, gsum)
            loss = lsum / mb
        else:
            loss, _, _, grads = loss_and_grads(params, cfg, batch, remat)
        params, opt_state, om = adamw.update(params, grads, opt_state, tcfg)
        return params, opt_state, {"loss": loss, **om}

    return train_step
