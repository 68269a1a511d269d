"""FSDP's "all-gather on use, reduce-scatter on grads" (the reference's
``sharding/partition.py`` docstring) on a rank's pieces.

Under ``cfg.fsdp`` a rank holds its piece of every parameter leaf whose
"embed" dim the data axes divide (``partition.data_specs`` of its specs).
A step carries a :class:`Layout` on its backend (``Backend.fsdp``), and the
model stack gathers the pieces where it uses them and lets them go after:

  * block r of a PRM stack (``core.sharing.run_stack``): the cut leaves of
    ``params[r]`` in one all-gather over the data axes before the block's
    first reuse, dropped after its last (:meth:`Layout.block`);
  * a leaf outside the stacks at its use (:meth:`Layout.use`): the final
    norm, the lm head or the tied table at the head, the vlm's and
    whisper's projections, whisper's encoder norm;
  * the embedding lookup (:meth:`Layout.lookup`): each rank looks up its
    columns of the rows every data rank needs, and the rows are
    all-gathered on their last dim (exact).

A training layout (``dtype`` set) casts each float32 piece to the compute
dtype before the gather (half the bytes on the wire) and then gives each
"model" piece as ``partition.forward_leaf`` does.  Its gathers are
autograd Functions whose backward casts the gradient to float32 and only
then reduce-scatters it over the data axes, one collective a block or
leaf group: each rank receives its piece of the gradient summed over the
data ranks in float32, as a data-parallel all-reduce sums it.  A tied
table's head gather keeps its gradient for the lookup's backward, which
adds the lookup's own in the compute dtype first, as one cast table
accumulates both in a data-parallel step.  So FSDP stays bit-equal to DP
at two data ranks.  That hand-over needs the head's backward to run
first (autograd runs the later node first, and the head follows the
lookup); either side raises if the order ever flips.

Under remat (:meth:`Block.remat`) a block's gathered leaves enter each
reuse's checkpoint as tokens (``saved_tensors_hooks``), not as tensors:
the backward gathers the block again when it recomputes the block's last
reuse and drops it after the first, so a step holds one block's gathered
leaves at a time, in each direction.  Without remat the forward's ops save
what they read, and a block stays gathered until its backward.

Per microbatch a remat train step makes, over the data axes
(:func:`planned`): two all-gathers a block (the forward's and the
backward's) and one reduce-scatter; per leaf group outside the stacks one
all-gather and one reduce-scatter, except the lookup (two all-gathers,
its indices and its rows) and a tied head (no reduce-scatter: the
lookup's carries its gradient).  :data:`COUNTS` counts what this module
runs; :func:`track_live` counts the gathered bytes alive.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Any

import torch

from repro_torch.sharding import collectives as coll
from repro_torch.sharding import partition

# the collectives this module ran (gathers, re-gathers, reduce-scatters)
COUNTS = {"all-gather": 0, "reduce-scatter": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def snapshot() -> dict:
    return dict(COUNTS)


# the gathered bytes alive, once tracked (:func:`track_live`)
LIVE: dict | None = None


def track_live() -> dict:
    """Count the live bytes of every tensor :func:`gather_pieces` returns
    from now on, each until a weakref finalizer sees it go (a tensor that
    autograd or a checkpoint still holds stays alive, so the count is its
    true lifetime): ``{"now": bytes alive, "max": the most alive since the
    last :func:`reset_live`, "blocks_now" / "blocks_max": gathers of a
    block of a stack with a tensor alive}``."""
    global LIVE
    if LIVE is None:
        LIVE = {"now": 0, "max": 0, "blocks_now": 0, "blocks_max": 0}
    return LIVE


def reset_live() -> None:
    if LIVE is not None:
        LIVE["max"] = LIVE["now"]
        LIVE["blocks_max"] = LIVE["blocks_now"]


def _drop(call, n):
    LIVE["now"] -= n
    call["left"] -= 1
    if call["left"] == 0 and call["block"]:
        LIVE["blocks_now"] -= 1


def _track(plan, out) -> None:
    call = {"left": len(out), "block": plan.path[:1] == ("segments",)}
    LIVE["blocks_now"] += call["block"]
    LIVE["blocks_max"] = max(LIVE["blocks_max"], LIVE["blocks_now"])
    for t in out:
        n = t.numel() * t.element_size()
        LIVE["now"] += n
        LIVE["max"] = max(LIVE["max"], LIVE["now"])
        weakref.finalize(t, _drop, call, n)


def _cast(t, dtype):
    """``t`` in ``dtype`` when it is float32 (a train step's masters; the
    reference casts those only), else ``t``."""
    if dtype is None or t.dtype != torch.float32:
        return t
    return t.to(dtype)


@dataclasses.dataclass(eq=False)
class _Slot:
    """A tied table's head gradient, kept for the lookup's backward:
    ``tied`` once the head's gather takes the slot, ``used`` once the
    lookup's backward has run."""
    grad: Any = None
    tied: bool = False
    used: bool = False


@dataclasses.dataclass(eq=False)
class _Plan:
    """How a group of pieces is gathered whole over the data axes: each
    piece's cut dim, the dtype float32 pieces travel in, and a slot for a
    piece whose gradient the lookup's backward takes instead; ``path``
    names the group (``("segments", name)`` for a block of a stack)."""
    mesh: Any
    axes: tuple
    dims: list
    dtype: Any = None
    slots: dict = dataclasses.field(default_factory=dict)
    path: tuple = ()

    @property
    def parts(self) -> int:
        return self.mesh.axis_size(self.axes)


def _groups(dtypes) -> dict:
    out: dict = {}
    for k, dt in enumerate(dtypes):
        out.setdefault(dt, []).append(k)
    return out


def gather_pieces(plan: _Plan, pieces) -> list:
    """The whole tensor, over the data axes, of each piece (float32 pieces
    cast to ``plan.dtype`` first): one all-gather of the pieces laid end
    to end per dtype, each whole tensor a copy of its own."""
    n = plan.parts
    cast = [_cast(p, plan.dtype) for p in pieces]
    out = [None] * len(cast)
    for idx in _groups([c.dtype for c in cast]).values():
        flat = torch.cat([cast[k].reshape(-1) for k in idx])
        whole = coll.all_gather(flat, plan.mesh, plan.axes, dim=0)
        COUNTS["all-gather"] += 1
        whole = whole.view(n, -1)
        at = 0
        for k in idx:
            c, d = cast[k], plan.dims[k]
            m = c.numel()
            blocks = whole[:, at:at + m].reshape(n, *c.shape)
            out[k] = blocks.movedim(0, d).reshape(
                *c.shape[:d], n * c.shape[d], *c.shape[d + 1:])
            at += m
    if LIVE is not None:
        _track(plan, out)
    return out


def scatter_grads(plan: _Plan, grads, like) -> list:
    """The rank's piece of each whole gradient summed over the data axes:
    each cast to its piece's dtype (float32 for a master) before one
    reduce-scatter per dtype; None for a slot's piece."""
    n = plan.parts
    out = [None] * len(like)
    live = [k for k in range(len(like)) if k not in plan.slots]
    for idx in _groups([like[k][1] for k in live]).values():
        idx = [live[i] for i in idx]
        rows = []
        for k in idx:
            shape, dtype = like[k]
            d = plan.dims[k]
            whole = (*shape[:d], n * shape[d], *shape[d + 1:])
            g = grads[k]
            g = (torch.zeros(whole, dtype=dtype, device=_device(grads))
                 if g is None else g.to(dtype))
            rows.append(g.reshape(*shape[:d], n, shape[d], *shape[d + 1:])
                        .movedim(d, 0).reshape(n, -1))
        flat = torch.cat(rows, dim=1).reshape(-1)
        mine = coll.psum_scatter(flat, plan.mesh, plan.axes, dim=0)
        COUNTS["reduce-scatter"] += 1
        at = 0
        for k in idx:
            shape = like[k][0]
            m = int(torch.Size(shape).numel())
            out[k] = mine[at:at + m].view(shape)
            at += m
    return out


def _device(grads):
    """The device of the gradients (for the zeros of a leaf the forward
    did not use)."""
    return next(g.device for g in grads if g is not None)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, *pieces):
        ctx.plan = plan
        ctx.like = [(tuple(p.shape), p.dtype) for p in pieces]
        return tuple(gather_pieces(plan, pieces))

    @staticmethod
    def backward(ctx, *grads):
        plan = ctx.plan
        for k, slot in plan.slots.items():
            if slot.used:
                raise RuntimeError(
                    f"{'/'.join(plan.path)}: the lookup's backward ran "
                    f"before the tied head's; the head's gradient is lost")
            slot.grad = grads[k]
        if len(plan.slots) == len(grads):
            return (None,) * (len(grads) + 1)
        return (None, *scatter_grads(plan, grads, ctx.like))


def lookup_rows(plan: _Plan, piece, idx, same_rows: bool):
    """``whole[idx]`` of the table whose (Vb, D / n) column piece this rank
    holds: the data ranks' indices are all-gathered (not when every rank
    holds the same rows), each rank looks up its columns of those rows and
    the rows are all-gathered on their last dim."""
    mesh, axes = plan.mesh, plan.axes
    c = _cast(piece, plan.dtype)
    every = idx
    if not same_rows:
        every = coll.all_gather(idx.contiguous(), mesh, axes, dim=0)
        COUNTS["all-gather"] += 1
    rows = coll.all_gather(c[every], mesh, axes, dim=-1)
    COUNTS["all-gather"] += 1
    if same_rows:
        return rows
    B = idx.shape[0]
    i = mesh.index(axes)
    return rows[i * B:(i + 1) * B].clone()


class _Lookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, piece, idx, plan, same_rows):
        ctx.plan = plan
        ctx.like = (tuple(piece.shape), piece.dtype)
        ctx.save_for_backward(idx)
        return lookup_rows(plan, piece, idx, same_rows)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        plan = ctx.plan
        shape = ctx.like[0]
        # the lookup's gradient over the whole table, as the backward of
        # ``whole[idx]`` accumulates it, plus a tied head's
        grad = torch.zeros((shape[0], shape[1] * plan.parts), dtype=g.dtype,
                           device=g.device).index_put_((idx,), g,
                                                       accumulate=True)
        slot = plan.slots[0]
        if slot.tied and slot.grad is None:
            raise RuntimeError(
                f"{'/'.join(plan.path)}: the lookup's backward ran before "
                f"the tied head's; the head's gradient is lost")
        slot.used = True
        if slot.grad is not None:
            grad = slot.grad + grad
            slot.grad = None
        plain = dataclasses.replace(plan, slots={})
        return (scatter_grads(plain, [grad], [ctx.like])[0], None, None,
                None)


# -------------------------------------------------------------------------
# the layout a step carries
# -------------------------------------------------------------------------
def _subtree(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _leaves(tree, path, out):
    """(path, leaf) of a nested dict in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], path + (k,), out)
    else:
        out.append((path, tree))
    return out


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    return next(it)


@dataclasses.dataclass(frozen=True, eq=False)
class Layout:
    """A step's parameters held as FSDP pieces (module docstring).

    ``specs``: the data-axes spec of every leaf (``partition.data_specs``;
    ``()`` whole; None for a ``PreparedTensor`` bank, whose dots gather it
    field by field, ``core/backend.bank_field``).  A training layout also
    has ``dtype`` (the compute dtype of the float32 masters) and
    ``model_specs`` (the rank's whole ``tree_pspecs`` specs, read by
    ``partition.forward_leaf``)."""
    specs: Any
    mesh: Any
    dtype: Any = None
    model_specs: Any = None
    _slots: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def axes(self) -> tuple:
        return partition.data_axes(self.mesh)

    def _spec(self, path, lead: int):
        spec = _subtree(self.specs, path)
        return None if spec is None else tuple(spec)[lead:]

    def _materialize(self, tree, path: tuple, lead: int = 0):
        """``tree`` (the rank's pieces at ``path``; ``lead`` leading dims
        indexed away: 1 for a block of a stack) as the forward reads it:
        its cut leaves gathered (one :class:`_Gather`), float32 leaves
        cast to ``dtype``, "model" pieces by ``partition.forward_leaf``."""
        flat = _leaves(tree, path, [])
        cut, dims = [], []
        slots = {}
        for k, (p, t) in enumerate(flat):
            spec = self._spec(p, lead)
            if spec is None or not isinstance(t, torch.Tensor) \
                    or not partition.cuts(spec):
                continue
            d = [i for i, e in enumerate(spec) if partition.cuts((e,))]
            if len(d) != 1:
                raise ValueError(f"{'/'.join(p)}: FSDP cuts one dim, spec "
                                 f"{spec}")
            slot = self._slots.pop(p, None)
            if slot is not None:
                slot.tied = True
                slots[len(cut)] = slot
            cut.append(k)
            dims.append(d[0])
        out = [t for _, t in flat]
        if cut:
            plan = _Plan(self.mesh, self.axes, dims, self.dtype, slots,
                         path)
            whole = _Gather.apply(plan, *(out[k] for k in cut))
            for k, w in zip(cut, whole):
                out[k] = w
        for k, (p, _) in enumerate(flat):
            t = out[k]
            if k not in cut and isinstance(t, torch.Tensor):
                t = _cast(t, self.dtype)
            if self.model_specs is not None:
                t = partition.forward_leaf(t, _subtree(self.model_specs, p),
                                           p, self.mesh, lead=lead)
            out[k] = t
        return _rebuild(tree, iter(out))

    def use(self, tree, path: tuple):
        """The subtree ``tree`` of the params at ``path`` (a leaf group
        outside the stacks) as its use reads it."""
        return self._materialize(tree, tuple(path))

    def block(self, stack, r: int, path: tuple) -> "Block":
        """Block ``r`` of the stack at ``path`` (its leaves lead with R),
        gathered for its reuses."""
        from repro_torch.core.sharing import tree_index
        return Block(self, tree_index(stack, r), tuple(path))

    def lookup(self, table, path: tuple, dtype, same_rows: bool):
        """(rows, n, vocab_cut) of the embedding table piece ``table`` at
        ``path``: ``rows(idx)`` is the rows ``idx`` of the table as the
        forward reads it (its "model" piece of the vocabulary where
        ``vocab_cut``, n rows), in ``dtype``.  A table cut over the data
        axes on its last dim is looked up column by column
        (:func:`lookup_rows`); its backward reduce-scatters the table's
        gradient with a tied head's added (:meth:`use` of the same path
        after this call)."""
        path = tuple(path)
        spec = self._spec(path, 0)
        mspec = (None if self.model_specs is None
                 else _subtree(self.model_specs, path))
        vocab_cut = (mspec is not None and self.mesh.axis_size("model") > 1
                     and partition.model_dim(mspec) == 0)
        if spec is None or not partition.cuts(spec):
            t = self._materialize(table, path)
            t = t.t if isinstance(t, partition.ModelPiece) else t
            return (lambda idx: t.to(dtype)[idx]), t.shape[0], vocab_cut
        if len(spec) != 2 or partition._entry_axes(spec[0]):
            raise ValueError(f"{'/'.join(path)}: a lookup needs the table's "
                             f"columns cut, spec {spec}")
        slot = self._slots[path] = _Slot()
        plan = _Plan(self.mesh, self.axes, [1], dtype, {0: slot}, path)
        return ((lambda idx: _Lookup.apply(table, idx, plan, same_rows)),
                table.shape[0], vocab_cut)


def _skeleton(tree, tensors: list):
    """``tree``'s layout with each tensor (a ``ModelPiece``'s too) replaced
    by its index in ``tensors``, which it is appended to."""
    if isinstance(tree, dict):
        return {k: _skeleton(v, tensors) for k, v in tree.items()}
    if isinstance(tree, partition.ModelPiece):
        tensors.append(tree.t)
        return ("piece", len(tensors) - 1, tree.dim, tree.shape)
    tensors.append(tree)
    return ("tensor", len(tensors) - 1)


def _from_skeleton(skel, ts):
    if isinstance(skel, dict):
        return {k: _from_skeleton(v, ts) for k, v in skel.items()}
    if skel[0] == "piece":
        return partition.ModelPiece(ts[skel[1]], skel[2], skel[3])
    return ts[skel[1]]


class _Token:
    """A gathered leaf as a checkpoint keeps it: its block and index."""
    __slots__ = ("state", "k")

    def __init__(self, state, k):
        self.state, self.k = state, k


class Block:
    """Block r of a stack gathered for its reuses (:meth:`Layout.block`):
    ``tree`` its leaves as the forward reads them."""

    def __init__(self, layout: Layout, pieces, path: tuple):
        self.layout, self.pieces, self.path = layout, pieces, path
        self.tree = layout._materialize(pieces, path, lead=1)

    def flat(self, tree=None):
        """(tensors, rebuild): the tensors of ``tree`` (default: the
        block's) in order, and a function that rebuilds a tree of the same
        layout from such a list (``ModelPiece`` records re-made around
        their tensors)."""
        tensors: list = []
        skel = _skeleton(self.tree if tree is None else tree, tensors)
        return tensors, (lambda ts: _from_skeleton(skel, ts))

    def _again(self) -> list:
        """The block's tensors gathered again, values only (the backward's
        gather under remat)."""
        with torch.no_grad():
            return self.flat(self.layout._materialize(self.pieces, self.path,
                                                      lead=1))[0]

    @contextlib.contextmanager
    def remat(self, tensors):
        """Checkpoints made inside keep ``tensors`` (this block's, from
        :meth:`flat`) as tokens: the backward's first unpack gathers the
        block again, its last drops it."""
        ids = {id(t): k for k, t in enumerate(tensors)}
        flags = [t.requires_grad for t in tensors]
        state = {"left": 0, "cache": None}

        def pack(t):
            k = ids.get(id(t))
            if k is None:
                return t
            state["left"] += 1
            return _Token(state, k)

        def unpack(p):
            if not isinstance(p, _Token):
                return p
            if state["cache"] is None:
                again = self._again()
                for t, f in zip(again, flags):
                    if f:
                        t.requires_grad_(True)
                state["cache"] = again
            out = state["cache"][p.k]
            state["left"] -= 1
            if state["left"] == 0:
                state["cache"] = None
            return out

        try:
            with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
                yield
        finally:
            ids.clear()
            self.tree = None


# -------------------------------------------------------------------------
# what a step makes
# -------------------------------------------------------------------------
def planned(cfg, specs, remat: bool = True) -> dict:
    """The all-gathers and reduce-scatters :data:`COUNTS` takes for one
    forward and backward of a train step (one microbatch) of ``cfg`` over
    a rank's data-axes ``specs`` (module docstring); a block or group with
    no cut leaf gathers nothing."""
    from repro_torch.models import transformer as tfm

    def any_cut(tree) -> bool:
        return any(partition.cuts(s) for _, s in _leaves(tree, (), [])
                   if s is not None)

    ag = rs = 0
    for spec in tfm.build_segments(cfg):
        if any_cut(specs["segments"][spec.name]):
            R = tfm.shareds_for(cfg)[spec.name].num_physical
            ag += R * (2 if remat else 1)
            rs += R
    if any_cut(specs["embed"]):
        ag += 2                       # the lookup: its indices and rows
        rs += 1
        if cfg.tie_embeddings:
            ag += 1                   # the head's table
    for key in ("final_norm", "lm_head", "vision_proj", "audio_proj",
                "enc_final_norm"):
        if key in specs and any_cut(specs[key]):
            ag += 1
            rs += 1
    return {"all-gather": ag, "reduce-scatter": rs}
