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
``partition.act_pspec(mesh)``, "seq" by default): every rank is handed the
global batch and each data rank runs its rows of it (of each microbatch).
A rank holds the reference's whole ``tree_pspecs(..., cfg.fsdp)`` piece of
every parameter and of the Adam moments (:func:`param_specs`), "model"
entries included, as the reference's ``launch.train`` places them.

The forward runs tensor-parallel over "model" (the reference leaves the
xla dots to GSPMD, which partitions them so): a matrix the rank holds a
piece of reaches ``Backend.dot`` as a ``partition.ModelPiece`` and runs
by ``partition_rule`` on it (``core/backend.py``: column blocks, row blocks
rejoined, the Megatron pairing of the MLP and, where "model" divides the
KV heads, of attention on the rank's own heads).  A MoE expert bank cut on
its experts stays the rank's experts (``partition.ExpertLayout`` on
``Backend.experts``: routing whole, the rank's dispatch, expert FFN and
partial combine, summed over "model"; ``models/moe.apply_moe``), and the
SSM's conv kernel and per-head vectors stay the rank's channels and heads
(``partition.SSMLayout`` with ``train`` on ``Backend.ssm``: the conv on
the rank's channels, ``ssd_chunk`` on its heads, joined before the gated
norm; ``models/ssm.ssm_forward``).  Any other leaf cut over "model" (the
SSM's norm scale, an expert bank cut on its matrices) is all-gathered
whole, differentiably: at the step's start, or under FSDP where its block
runs.  The residual follows ``act_pspec``
(``partition.ResidualLayout``): "seq" holds the rank's block of positions
between the layers (Korthikanti's sequence parallelism: each norm on the
rank's positions, an all-gather entering each mixer and FFN, the
pair-second dot's reduce-scatter over the positions), "hidden" its block
of channels, "replicated" whole rows.  The
final norm's output is gathered whole: the lm head runs column-parallel
over the vocabulary and its logits are gathered whole, so CE is not
vocab-parallel.

The loss and the gradients: every collective is differentiable.  Over the
data axes each rank differentiates its own share of the loss: CE's
numerator over the rank's rows, summed over the data axes
(``collectives.psum_grad``: the value is the whole CE, the gradient the
rows') and divided by the denominator summed over them; the MoE
load-balance aux, the same on every rank (``transformer._moe_ffn`` routes
the batch gathered over "data", whole positions), on data rank 0 only.
Over "model" the loss is the same on every rank and Megatron's convention
holds (``sharding/collectives.py``, ``core/backend.py``): a tensor every
rank holds whole gets its whole gradient on each, so a leaf whole over
"model" (norm scales, biases, the router) has the unsharded gradient of
its data rank's rows (a norm applied to the rank's positions takes its
scale through ``copy_to_model``), and a "model" piece the gradient of its
block.  Each microbatch's gradients are summed over the data axes as its
backward ends, then added to the step's sum: a leaf whole over them in one
all-reduce of all such leaves (:meth:`_MeshStep.reduce`), a ``cfg.fsdp``
piece (its "embed" dim over the data axes) in its block's reduce-scatter.
Under ``cfg.fsdp`` the rank never holds the whole tree: the step's backend
carries a ``sharding.fsdp.Layout``, so the forward gathers each block of a
stack where it runs (in the compute dtype; under remat again where the
backward recomputes it) and every other leaf group at its use, and each
gathered group's gradient is cast to float32 and reduce-scattered into the
rank's piece as its backward completes (``sharding/fsdp.py``).  At two
data ranks every element of a gradient is then one float32 add of the
same two numbers under FSDP and under DP: the runs are bit-equal.
``grad_norm``, the clip and the update follow ``optim/adamw.py`` (the
norm's shares over "model" too).
:func:`state_specs` is the layout of ``(params, OptState)`` for the
checkpoints, which hold the logical layout.  ``tcfg.grad_allreduce_dtype``
is not read (nor is it in the reference): the gradients are summed in
float32.  Without a mesh the step runs on
``launch.mesh.single_device_mesh()``, where every collective is the
identity: one body for every mesh.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import backend as backend_lib
from repro_torch.device import torch_dtype
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
from repro_torch.sharding import collectives as coll
from repro_torch.sharding import fsdp as fsdp_lib
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
    """A rank's layout of the parameter tree: the reference's whole
    ``tree_pspecs(..., cfg.fsdp)`` (``fsdp`` overrides it), one spec tuple
    a leaf (``()``: whole on every rank), "model" entries included."""
    shapes = tfm.abstract_params(cfg)
    fsdp = cfg.fsdp if fsdp is None else fsdp
    return partition.tree_pspecs(shapes, partition.model_specs(shapes),
                                 mesh, fsdp)


def state_specs(pspecs) -> tuple:
    """The layout of a ``(params, OptState)`` pair (what ``launch.train``
    checkpoints): ``m`` and ``v`` as the params, the step whole."""
    return (pspecs, adamw.OptState(m=pspecs, v=pspecs, step=()))


@dataclasses.dataclass(frozen=True)
class _MeshStep:
    """What a rank's train step needs of its mesh: the backend (xla, rows
    over the data axes), the parameter layout, the residual's and the
    grad-norm shares.  One position (``launch.mesh.single_device_mesh``)
    is the unsharded step: every collective below is the identity there."""

    mesh: object
    cfg: ModelConfig
    backend: backend_lib.Backend
    act_pspec: tuple       # the residual's spec (partition.residual_mode)
    specs: dict            # param_specs under cfg.fsdp
    data_specs: dict       # their data-axes part (what FSDP gathers)
    norm_specs: dict       # param_specs under fsdp=True: the norm's shares
    gather: Any = None     # fsdp.Layout of the rank's cfg.fsdp pieces
                           # (dp > 1), else None

    @property
    def fsdp(self) -> bool:
        """The rank holds ``cfg.fsdp`` pieces."""
        return self.gather is not None

    @property
    def data(self) -> tuple:
        return partition.data_axes(self.mesh)

    @property
    def first(self) -> bool:
        """Data rank 0 (it counts the aux)."""
        return self.mesh.index(self.data) == 0

    def rows(self, B: int) -> slice:
        """This data rank's rows of a B-row (micro)batch."""
        dp = partition.dp_size(self.mesh)
        if B % dp:
            raise ValueError(f"a batch of {B} rows does not divide over "
                             f"{dp} data ranks")
        n = B // dp
        i = self.mesh.index(self.data)
        return slice(i * n, (i + 1) * n)

    def step_backend(self, B: int, S: int) -> backend_lib.Backend:
        """The backend of a forward over B rows of S positions: the
        residual layout of ``act_pspec``, on "model" ranks that divide the
        KV heads attention on the rank's own heads, and the rank's SSM
        heads and conv channels (``partition.SSMLayout``) and its experts
        (``partition.ExpertLayout``) where "model" cuts them."""
        mesh = self.mesh
        bk = self.backend
        if self.fsdp:
            bk = dataclasses.replace(bk, fsdp=self.gather)
        if mesh.axis_size("model") == 1:
            return bk
        lay = partition.residual_layout(self.act_pspec, mesh, S,
                                        self.cfg.d_model)
        kv = None
        if self.cfg.mla is None and partition.kv_layout(
                self.cfg, mesh, B, S).heads:
            kv = partition.KVLayout(True, (), S)
        cfg = self.cfg
        ssm = None if cfg.ssm is None else partition.ssm_layout(cfg, mesh)
        return dataclasses.replace(bk, residual=lay, kv=kv, ssm=ssm,
                                   experts=partition.expert_layout(cfg, mesh))

    def forward_tree(self, tracked):
        """The forward's parameter tree of the tracked leaves: under FSDP
        the rank's pieces themselves (the step's backend gathers them where
        they are used: ``sharding/fsdp.py``); else cast to the compute
        dtype, then each "model" piece as ``partition.forward_leaf`` gives
        it."""
        if self.fsdp:
            return tracked
        mesh = self.mesh
        return partition.map_with_paths(
            lambda t, spec, path: partition.forward_leaf(t, spec, path,
                                                         mesh),
            _compute(tracked, self.cfg), self.specs)

    def reduce(self, grads):
        """A microbatch's gradients summed over the data axes: a
        ``cfg.fsdp`` piece's came summed from its gather's backward (a
        reduce-scatter); every other leaf's is all-reduced, all of them in
        one collective (elementwise sums: the same numbers as one
        all-reduce a leaf)."""
        if partition.dp_size(self.mesh) == 1:
            return grads
        pending = []

        def one(g, spec):
            if self.fsdp and partition.cuts(spec):
                return g
            pending.append(g)
            return g

        grads = partition.map_with_specs(one, grads, self.data_specs)
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
    specs = param_specs(cfg, mesh)
    data = partition.data_specs(specs, mesh)
    gather = None
    if cfg.fsdp and dp > 1:
        gather = fsdp_lib.Layout(data, mesh, dtype=torch_dtype(
            cfg.compute_dtype), model_specs=specs)
    return _MeshStep(mesh=mesh, cfg=cfg, backend=bk,
                     act_pspec=tuple(act_pspec or ()), specs=specs,
                     data_specs=data,
                     norm_specs=param_specs(cfg, mesh, fsdp=True),
                     gather=gather)


def _track(params):
    return adamw.tree_map(lambda p: p.detach().requires_grad_(True), params)


def _grads(loss, tracked):
    """d loss / d every leaf of ``tracked`` (zeros for an unused one)."""
    live = adamw.tree_leaves(tracked)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    by_id = {id(p): torch.zeros_like(p) if g is None else g
             for p, g in zip(live, grads)}
    return adamw.tree_map(lambda p: by_id[id(p)], tracked)


def _rank_grads(params, cfg: ModelConfig, batch, remat: bool,
                ms: _MeshStep):
    """(ce, aux, grads) of this rank's rows of the global (micro)batch
    ``batch``: the unsharded CE and aux, and the gradient of the rank's
    loss (module docstring) with respect to every leaf of ``params`` (the
    rank's); summed over the data axes (``ms.reduce``; a ``cfg.fsdp``
    piece's is summed already) they are the unsharded gradients."""
    sl = ms.rows(batch["tokens"].shape[0])
    batch = {k: v[sl] for k, v in batch.items()}
    tracked = _track(params)
    tokens = batch["tokens"]
    B, S = tokens.shape
    logits, _, aux = tfm.forward(ms.forward_tree(tracked), cfg, batch,
                                 mode="train", remat=remat,
                                 execution=ms.step_backend(B, S))
    num, den = ce_terms(logits[:, :-1], tokens[:, 1:], cfg.vocab_size)
    den = torch.clamp(coll.psum(den, ms.mesh, ms.data), min=1.0)
    # the whole CE on every rank, each data rank's gradient its own rows'
    ce = coll.psum_grad(num, ms.mesh, ms.data) / den
    # aux is the same on every rank (the MoE routes the gathered batch):
    # the data ranks' losses add up to CE + AUX_WEIGHT * aux
    rank_loss = ce + AUX_WEIGHT * aux if ms.first else ce
    return ce.detach(), aux.detach(), _grads(rank_loss, tracked)


def loss_and_grads(params, cfg: ModelConfig, batch, remat: bool = True, *,
                   mesh=None, act_pspec=None):
    """(loss, ce, aux, grads): the loss of ``batch`` and its gradient with
    respect to every leaf of ``params`` (a tree of the same shape).  On a
    bound mesh of more than one position ``batch`` is the global batch and
    ``params`` the rank's (:func:`param_specs`): the unsharded loss and the
    gradients summed over the data axes (the rank's pieces of them under
    ``cfg.fsdp``)."""
    ms = _mesh_step(cfg, mesh, act_pspec)
    ce, aux, grads = _rank_grads(params, cfg, batch, remat, ms)
    return ce + AUX_WEIGHT * aux, ce, aux, ms.reduce(grads)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, act_pspec=None,
                    remat: bool = True, mesh=None):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; metrics hold the 0-d tensors ``loss``, ``lr`` and
    ``grad_norm``.

    With ``tcfg.microbatch > 1`` the batch splits into that many
    microbatches along its rows; their float32 gradients, each summed over
    the data axes first, are summed and divided by the count, and the loss
    is their mean.

    ``mesh`` (a bound mesh of more than one position) trains on the ranks
    (module docstring): every rank passes the global batch, and its params
    and Adam state in :func:`param_specs`' layout (its pieces over
    "model" and, under ``cfg.fsdp``, over the data axes).
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
        for i in range(mb):
            ce, aux, g = _rank_grads(params, cfg,
                                     {k: v[i] for k, v in split.items()},
                                     remat, ms)
            # summed over the data axes a microbatch, then over them
            g = ms.reduce(g)
            loss = ce + AUX_WEIGHT * aux
            if i == 0:
                lsum = loss
                grads = g if mb == 1 else adamw.tree_map(
                    lambda x: x.to(torch.float32), g)
            else:
                adamw.tree_map(lambda a, b: a.add_(b), grads, g)
                lsum = lsum + loss
            del g
        if mb > 1:
            grads = adamw.tree_map(lambda g: g / mb, grads)
            lsum = lsum / mb
        params, opt_state, om = adamw.update(
            params, grads, opt_state, tcfg, mesh=ms.mesh,
            norm_specs=ms.norm_specs, pieces=ms.fsdp)
        return params, opt_state, {"loss": lsum, **om}

    return train_step
