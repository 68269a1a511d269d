"""AdamW with a cosine schedule and global-norm clipping (port of
``repro.optim.adamw``).

Trees are the port's nested dicts of tensors, walked by
``core.sharing.tree_map`` and ``tree_leaves`` (dict keys sorted).  Master
params stay float32; the forward casts them to ``cfg.compute_dtype``
inside the graph, so the gradients reaching :func:`update` are float32.  The update runs without
autograd and returns new tensors: the params, ``m`` and ``v`` passed in
are left as they were.

On a mesh (``train/trainer.py``) the update is elementwise on the rank's
pieces, and :func:`global_norm` adds every rank's share of the squares
over the whole mesh, so the clip scale and ``grad_norm`` are the unsharded
ones, and the same bit for bit whether the rank holds ``cfg.fsdp`` pieces
or leaves whole over the data axes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.sharing import tree_leaves, tree_map
from repro_torch.sharding import collectives as coll
from repro_torch.sharding import partition


@dataclasses.dataclass(frozen=True)
class OptState:
    m: Any                      # float32 tree shaped like the params
    v: Any
    step: torch.Tensor          # int32, 0-d


def init(params) -> OptState:
    z = lambda p: torch.zeros_like(p, dtype=torch.float32)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return OptState(m=tree_map(z, params), v=tree_map(z, params), step=step)


def cosine_lr(tcfg: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``tcfg.lr``, then a cosine to 0 at
    ``total_steps`` (float32, on ``step``'s device)."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(tcfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - tcfg.warmup_steps)
                       / max(tcfg.total_steps - tcfg.warmup_steps, 1),
                       0.0, 1.0)
    return tcfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def global_norm(tree, mesh=None, norm_specs=None,
                pieces: bool = False) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares.

    On a mesh, ``norm_specs`` gives each leaf's spec under the FSDP rules
    (``trainer.param_specs(..., fsdp=True)``), and the tree holds the
    rank's "model" piece of each leaf it cuts over "model".  A rank squares
    its share of every leaf: over the data axes its piece where ``pieces``
    (the tree holds its FSDP pieces), else its cut of the leaf, and a leaf
    no rule cuts over them on data rank 0 only; over "model" its piece, and
    a leaf whole over "model" on model rank 0 only (each element counted
    once).  The sums are added over the whole mesh."""
    if mesh is None or mesh.size == 1:
        total = 0
        for x in tree_leaves(tree):
            total = total + torch.sum(torch.square(x.to(torch.float32)))
        return torch.sqrt(total)
    d = partition.data_axes(mesh)
    first_data = mesh.index(d) == 0
    first_model = mesh.index("model") == 0
    shares = []

    def share(x, spec):
        dspec = partition.data_spec(spec, mesh)
        if partition.cuts(dspec):
            if not pieces:
                x = partition.local_slice(x, dspec, mesh).contiguous()
        elif not first_data:
            return
        if partition.model_dim(spec) is None and not first_model:
            return
        shares.append(torch.sum(torch.square(x.to(torch.float32))))

    partition.map_with_specs(share, tree, norm_specs)
    total = torch.zeros((), dtype=torch.float32,
                        device=tree_leaves(tree)[0].device)
    for x in shares:
        total = total + x
    return torch.sqrt(coll.psum(total, mesh, mesh.axis_names))


@torch.no_grad()
def update(params, grads, state: OptState, tcfg: TrainConfig, *, mesh=None,
           norm_specs=None, pieces: bool = False):
    """One AdamW step.  Returns (new_params, new_state, metrics).  On a
    mesh, ``grads`` are the rank's (summed over the data axes) and the
    norm is :func:`global_norm`'s over the ranks."""
    step = state.step + 1
    lr = cosine_lr(tcfg, step)
    gnorm = global_norm(grads, mesh, norm_specs, pieces)
    scale = torch.clamp(tcfg.grad_clip / (gnorm + 1e-9), max=1.0)
    b1, b2 = tcfg.beta1, tcfg.beta2
    c1 = 1 - torch.pow(torch.full((), b1, device=step.device), step)
    c2 = 1 - torch.pow(torch.full((), b2, device=step.device), step)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        mh = m / c1
        vh = v / c2
        p_new = p - lr * (mh / (torch.sqrt(vh) + 1e-8)
                          + tcfg.weight_decay * p)
        return p_new.to(p.dtype), m, v

    out = tree_map(upd, params, grads, state.m, state.v)
    new_p, new_m, new_v = (_pick(out, i) for i in range(3))
    metrics = {"lr": lr, "grad_norm": gnorm}
    return new_p, OptState(m=new_m, v=new_v, step=step), metrics


def _pick(tree, i):
    """Element ``i`` of every (p, m, v) leaf of ``tree``."""
    if isinstance(tree, tuple):
        return tree[i]
    return {k: _pick(v, i) for k, v in tree.items()}
