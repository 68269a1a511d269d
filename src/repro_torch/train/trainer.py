"""The train step (port of ``repro.train.trainer``): a mixed-precision
forward (float32 masters cast to ``cfg.compute_dtype`` inside the graph),
per-reuse remat, optional gradient accumulation over microbatches, and the
AdamW update.

Gradients come from ``torch.autograd`` over the xla backend's torch ops,
as the reference differentiates XLA ops.  A photonic backend is refused:
its MVM kernels carry no autograd, so a gradient through them would leave
the weights out.

**On a mesh** (``mesh``: the rank's bound ``launch.mesh.Mesh`` of more than
one position; ``act_pspec`` the reference's train spec,
``partition.act_pspec(mesh)``): every rank is handed the global batch and
each data rank runs its rows of it (of each microbatch), replicated over
"model" (the xla backend runs its dots whole, so the "model" part of the
"seq" spec saves nothing yet).  CE's numerator and its denominator are each
summed over the data axes before the division, and the MoE load-balance
aux, the same on every rank (``transformer._moe_ffn`` routes the batch
gathered over "data"), enters on data rank 0 only: the losses the ranks
differentiate add up to the unsharded loss.  A ``cfg.fsdp`` piece (its
"embed" dim over the data axes) is all-gathered whole once a step, before
the first microbatch.  The rank sums its gradients over the microbatches,
then over the data axes once a step: all-reduced for a leaf the rank holds
whole, reduce-scattered into the rank's piece for a ``cfg.fsdp`` leaf.  So
every parameter's gradient is the unsharded one, and under FSDP the rank's
piece of it.  ``grad_norm``, the clip and the update follow
``optim/adamw.py``.  :func:`param_specs` gives the layout,
:func:`state_specs` that of ``(params, OptState)`` for the checkpoints.
``tcfg.grad_allreduce_dtype`` is not read (nor is it in the reference):
the gradients are summed in float32.  Without a mesh the step runs on
``launch.mesh.single_device_mesh()``, where every collective is the
identity: one body for every mesh.
"""
from __future__ import annotations

import dataclasses
import warnings

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import backend as backend_lib
from repro_torch.device import torch_dtype
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
from repro_torch.sharding import collectives as coll
from repro_torch.sharding import partition

NEG_INF = -1e30
AUX_WEIGHT = 0.01


def ce_terms(logits, targets, vocab_size: int, pad_id: int = -1):
    """(numerator, denominator) of :func:`cross_entropy`: the summed nll of
    the targets that are not ``pad_id`` and their count (0-d float32)."""
    lf = logits.to(torch.float32)
    padded = lf.shape[-1]
    if padded != vocab_size:
        col = torch.arange(padded, device=lf.device)
        lf = lf.masked_fill(col >= vocab_size, NEG_INF)
    ls = torch.log_softmax(lf, dim=-1)
    nll = -torch.gather(ls, -1, targets[..., None].long())[..., 0]
    mask = (targets != pad_id).to(torch.float32)
    return torch.sum(nll * mask), torch.sum(mask)


def cross_entropy(logits, targets, vocab_size: int, pad_id: int = -1):
    """Next-token CE with padded-vocab masking (the pad columns never
    win), averaged over the targets that are not ``pad_id``."""
    num, den = ce_terms(logits, targets, vocab_size, pad_id)
    return num / torch.clamp(den, min=1.0)


def _compute(params, cfg: ModelConfig):
    dtype = torch_dtype(cfg.compute_dtype)
    return adamw.tree_map(
        lambda p: p.to(dtype) if p.dtype == torch.float32 else p, params)


def _loss_with_mask(params, cfg: ModelConfig, batch, aux_weight, remat):
    logits, _, aux = tfm.forward(_compute(params, cfg), cfg, batch,
                                 mode="train", remat=remat)
    tokens = batch["tokens"]
    ce = cross_entropy(logits[:, :-1], tokens[:, 1:], cfg.vocab_size)
    return ce + aux_weight * aux, (ce, aux)


# =========================================================================
# the layout on a mesh
# =========================================================================
def param_specs(cfg: ModelConfig, mesh, fsdp=None) -> dict:
    """A rank's layout of the parameter tree: the data-axes part of the
    reference's ``tree_pspecs(..., cfg.fsdp)`` (``fsdp`` overrides it), one
    spec tuple a leaf (``()``: whole on every rank).  Without ``cfg.fsdp``
    every leaf is whole."""
    shapes = tfm.abstract_params(cfg)
    fsdp = cfg.fsdp if fsdp is None else fsdp
    return partition.data_specs(partition.tree_pspecs(
        shapes, partition.model_specs(shapes), mesh, fsdp), mesh)


def state_specs(pspecs) -> tuple:
    """The layout of a ``(params, OptState)`` pair (what ``launch.train``
    checkpoints): ``m`` and ``v`` as the params, the step whole."""
    return (pspecs, adamw.OptState(m=pspecs, v=pspecs, step=()))


@dataclasses.dataclass(frozen=True)
class _MeshStep:
    """What a rank's train step needs of its mesh: the backend (xla, rows
    over the data axes), the parameter layout and the grad-norm shares.
    One position (``launch.mesh.single_device_mesh``) is the unsharded
    step: every collective below is the identity there."""

    mesh: object
    backend: backend_lib.Backend
    specs: dict            # param_specs under cfg.fsdp
    norm_specs: dict       # param_specs under fsdp=True: the norm's shares
    fsdp: bool             # the rank holds cfg.fsdp pieces (dp > 1)

    @property
    def data(self) -> tuple:
        return partition.data_axes(self.mesh)

    def rows(self, B: int) -> slice:
        """This data rank's rows of a B-row (micro)batch."""
        dp = partition.dp_size(self.mesh)
        if B % dp:
            raise ValueError(f"a batch of {B} rows does not divide over "
                             f"{dp} data ranks")
        n = B // dp
        i = self.mesh.index(self.data)
        return slice(i * n, (i + 1) * n)

    def whole(self, params):
        """The parameter tree whole on this rank (its FSDP pieces
        all-gathered; else ``params`` itself)."""
        if not self.fsdp:
            return params
        return partition.gather_tree(params, self.specs, self.mesh)

    def reduce(self, grads):
        """Gradients of the whole tree summed over the data axes: a
        ``cfg.fsdp`` leaf's reduce-scattered into the rank's piece, every
        other leaf's all-reduced, all of them in one collective
        (elementwise sums: the same numbers as one all-reduce a leaf)."""
        if partition.dp_size(self.mesh) == 1:
            return grads
        pending = []

        def one(g, spec):
            if self.fsdp and partition.cuts(spec):
                return partition.scatter_leaf(g, spec, self.mesh)
            pending.append(g)
            return g

        grads = partition.map_with_specs(one, grads, self.specs)
        if not pending:
            return grads
        flat = coll.psum(torch.cat([g.reshape(-1) for g in pending]),
                         self.mesh, self.data)
        summed, at = {}, 0
        for g in pending:
            summed[id(g)] = flat[at:at + g.numel()].view_as(g)
            at += g.numel()
        return adamw.tree_map(lambda g: summed.get(id(g), g), grads)


def _mesh_step(cfg: ModelConfig, mesh, act_pspec) -> _MeshStep:
    if mesh is None:
        if act_pspec is not None:
            raise ValueError("act_pspec needs a mesh")
        mesh = mesh_lib.single_device_mesh()
    if mesh.size > 1 and not mesh.bound:
        raise ValueError(f"a {dict(mesh.shape)} mesh trains as {mesh.size} "
                         f"ranks: start them with launch.mesh.init_ranks")
    d = partition.data_axes(mesh)
    dp = partition.dp_size(mesh)
    if dp > 1:
        lead = d if len(d) > 1 else d[0]
        if act_pspec is not None and tuple(act_pspec)[:1] != (lead,):
            raise NotImplementedError(
                f"act_pspec {tuple(act_pspec)}: a rank trains on its data "
                f"shard's rows (the spec's batch entry {lead!r}); other "
                f"placements of the batch are not ported")
    report = partition.PartitionReport(dropped=[])
    shapes = tfm.abstract_params(cfg)
    partition.param_shardings(shapes, partition.model_specs(shapes), mesh,
                              cfg.fsdp, report)
    if report.dropped:
        warnings.warn(partition.dropped_summary(report), stacklevel=3)
    bk = backend_lib.Backend("xla", mesh=mesh, rows_sharded=True)
    return _MeshStep(mesh=mesh, backend=bk,
                     specs=param_specs(cfg, mesh),
                     norm_specs=param_specs(cfg, mesh, fsdp=True),
                     fsdp=bool(cfg.fsdp) and dp > 1)


def _track(params):
    return adamw.tree_map(lambda p: p.detach().requires_grad_(True), params)


def _grads(loss, tracked):
    """d loss / d every leaf of ``tracked`` (zeros for an unused one)."""
    live = adamw.tree_leaves(tracked)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    by_id = {id(p): torch.zeros_like(p) if g is None else g
             for p, g in zip(live, grads)}
    return adamw.tree_map(lambda p: by_id[id(p)], tracked)


def _rank_grads(whole, cfg: ModelConfig, batch, remat: bool, ms: _MeshStep):
    """(ce, aux, grads) of this rank's rows of the global (micro)batch
    ``batch``: the unsharded CE and aux, and the gradient of the rank's
    loss with respect to every leaf of ``whole`` (the whole tree); summed
    over the data axes (``ms.reduce``) they are the unsharded gradients."""
    sl = ms.rows(batch["tokens"].shape[0])
    batch = {k: v[sl] for k, v in batch.items()}
    tracked = _track(whole)
    logits, _, aux = tfm.forward(_compute(tracked, cfg), cfg, batch,
                                 mode="train", remat=remat,
                                 execution=ms.backend)
    tokens = batch["tokens"]
    num, den = ce_terms(logits[:, :-1], tokens[:, 1:], cfg.vocab_size)
    den = torch.clamp(coll.psum(den.detach(), ms.mesh, ms.data), min=1.0)
    ce = coll.psum(num.detach(), ms.mesh, ms.data) / den
    # aux is the same on every rank (the MoE routes the gathered batch):
    # the rank losses add up to CE + AUX_WEIGHT * aux
    rank_loss = num / den
    if ms.mesh.index(ms.data) == 0:
        rank_loss = rank_loss + AUX_WEIGHT * aux
    return ce, aux.detach(), _grads(rank_loss, tracked)


def loss_and_grads(params, cfg: ModelConfig, batch, remat: bool = True, *,
                   mesh=None, act_pspec=None):
    """(loss, ce, aux, grads): the loss of ``batch`` and its gradient with
    respect to every leaf of ``params`` (a tree of the same shape).  On a
    bound mesh of more than one position ``batch`` is the global batch and
    ``params`` the rank's (:func:`param_specs`): the unsharded loss and the
    gradients summed over the data axes (the rank's pieces of them under
    ``cfg.fsdp``)."""
    ms = _mesh_step(cfg, mesh, act_pspec)
    ce, aux, grads = _rank_grads(ms.whole(params), cfg, batch, remat, ms)
    return ce + AUX_WEIGHT * aux, ce, aux, ms.reduce(grads)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, act_pspec=None,
                    remat: bool = True, mesh=None):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; metrics hold the 0-d tensors ``loss``, ``lr`` and
    ``grad_norm``.

    With ``tcfg.microbatch > 1`` the batch splits into that many
    microbatches along its rows; their float32 gradients are summed and
    divided by the count, and the loss is their mean.

    ``mesh`` (a bound mesh of more than one position) trains on the ranks
    (module docstring): every rank passes the global batch, and its params
    and Adam state in :func:`param_specs`' layout (its ``cfg.fsdp`` pieces).
    A batch, or a microbatch, that does not divide over the data ranks
    raises, as does ``act_pspec`` without a mesh.  ``None`` and a 1x1 mesh
    are the unsharded step."""
    if backend_lib.resolve(cfg).is_photonic:
        raise ValueError(f"{cfg.name}: training runs on the xla backend; "
                         f"the photonic kernels carry no gradient")
    ms = _mesh_step(cfg, mesh, act_pspec)

    def train_step(params, opt_state, batch):
        mb = max(tcfg.microbatch or 1, 1)
        B = batch["tokens"].shape[0]
        if B % mb:
            raise ValueError(f"batch {B} does not split into {mb} "
                             f"microbatches")
        split = {k: v.reshape(mb, B // mb, *v.shape[1:])
                 for k, v in batch.items()}
        whole = ms.whole(params)
        for i in range(mb):
            ce, aux, g = _rank_grads(whole, cfg,
                                     {k: v[i] for k, v in split.items()},
                                     remat, ms)
            loss = ce + AUX_WEIGHT * aux
            if i == 0:
                lsum = loss
                gsum = g if mb == 1 else adamw.tree_map(
                    lambda x: x.to(torch.float32), g)
            else:
                adamw.tree_map(lambda a, b: a.add_(b), gsum, g)
                lsum = lsum + loss
            del g
        del whole
        # summed over the data axes once a step
        grads = ms.reduce(gsum)
        del gsum
        if mb > 1:
            grads = adamw.tree_map(lambda g: g / mb, grads)
            lsum = lsum / mb
        params, opt_state, om = adamw.update(
            params, grads, opt_state, tcfg, mesh=ms.mesh,
            norm_specs=ms.norm_specs, pieces=ms.fsdp)
        return params, opt_state, {"loss": lsum, **om}

    return train_step
