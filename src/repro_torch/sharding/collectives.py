"""Collectives over one set of mesh axes: the torch counterparts of the
``jax.lax`` calls in the reference's sharded backend (``psum``,
``psum_scatter``, ``all_gather``, ``pmax``, ``ppermute``).

Each takes a bound ``launch.mesh.Mesh`` and the axes to reduce over (a
name or a tuple of names).  Over an axis set of size 1 each is the
identity, with no process group involved.  The transport rule lives in the
mesh (``Mesh.staged``): an op the transport cannot run on this rank's
tensors goes through host memory, and only that op.  Gloo's list forms of
``all_gather`` and ``reduce_scatter`` are used throughout; its
single-tensor forms abort a process on CUDA tensors.

On a **census** mesh (``launch.mesh.census_mesh``: one rank's coordinates,
no process group, ``device="meta"``) each returns an empty meta tensor of
its result's shape and moves nothing; the dry-run walks a rank's step that
way (``launch/dryrun.py``).  A census mesh given a tensor that is not on
the meta device raises.

Every collective that runs (over more than one rank, on any transport)
appends ``(kind, result bytes)`` to each active :func:`recording`, under
the reference's kinds (``all-reduce``, ``all-gather``, ``reduce-scatter``,
``collective-permute``) and the reference's measure: the bytes of the
per-rank result (``launch/analysis.py``'s counterpart of
``collective_bytes_trip_corrected``).  So a census walk and a real run of
the same step can be held to each other.

Six are differentiable (``torch.autograd.Function``s), for the train step
on a mesh.  Over the data axes each rank differentiates its own share of
the loss: :func:`all_gather_grad` (backward: a reduce-scatter on the
gathered dim, so each rank receives the gradient of its own block summed
over the ranks) and :func:`reduce_scatter_grad` (backward: an all-gather).
Over "model" the loss is the same on every rank and a tensor every rank
holds whole gets the whole gradient on each (Megatron's convention): the
conjugates :func:`copy_to_model` (the identity whose backward all-reduces:
entering a computation that each rank does on its own piece) and
:func:`psum_grad` (an all-reduce whose backward is the identity: leaving
one), :func:`all_gather_split` (backward: the rank's block) and
:func:`split_grad` (the rank's block; backward: an all-gather), beside
:func:`reduce_scatter_grad`.  Every rank of the group must reach each of
them, forward and backward, in the same order; a train step's graph is the
same on every rank, so its backward is too.
"""
from __future__ import annotations

import contextlib

import torch

_RECORDINGS: list = []


@contextlib.contextmanager
def recording():
    """Record the collectives this process runs while the context is open:
    yields a list that fills with ``(kind, result bytes)`` pairs."""
    rec: list = []
    _RECORDINGS.append(rec)
    try:
        yield rec
    finally:
        _RECORDINGS.remove(rec)


def _record(kind: str, result: torch.Tensor) -> torch.Tensor:
    if _RECORDINGS:
        nbytes = result.numel() * result.element_size()
        for rec in _RECORDINGS:
            rec.append((kind, nbytes))
    return result


def _census(mesh, x: torch.Tensor) -> bool:
    """Whether ``mesh`` is a census mesh (its collectives shape meta
    results and move nothing); raises when it is given a tensor that is
    not a meta tensor."""
    if mesh.transport != "census":
        return False
    if x.device.type != "meta":
        raise ValueError(f"a census mesh takes meta tensors, got one on "
                         f"{x.device}")
    return True


def _resized(x: torch.Tensor, dim: int, factor: float) -> torch.Tensor:
    shape = list(x.shape)
    shape[dim] = int(shape[dim] * factor)
    return torch.empty(shape, dtype=x.dtype, device=x.device)


def _dist():
    import torch.distributed as dist
    return dist


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _host(x, mesh, op):
    """``x`` as the transport takes it for ``op``: a host copy when the op
    is staged, else ``x`` itself."""
    return x.cpu() if mesh.staged(op) else x


def psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum of ``x`` over the ranks along ``axes`` (every rank gets it)."""
    axes = _axes(axes)
    if mesh.axis_size(axes) == 1:
        return x
    if _census(mesh, x):
        return _record("all-reduce", torch.empty_like(x))
    dist = _dist()
    y = _host(x, mesh, "all_reduce").clone()
    dist.all_reduce(y, group=mesh.group(axes))
    return _record("all-reduce", y.to(x.device))


def pmax(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Elementwise max of ``x`` over the ranks along ``axes``."""
    axes = _axes(axes)
    if mesh.axis_size(axes) == 1:
        return x
    if _census(mesh, x):
        return _record("all-reduce", torch.empty_like(x))
    dist = _dist()
    y = _host(x, mesh, "all_reduce").clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=mesh.group(axes))
    return _record("all-reduce", y.to(x.device))


def all_gather(x: torch.Tensor, mesh, axes, dim: int = -1) -> torch.Tensor:
    """The ranks' ``x`` along ``axes`` concatenated on ``dim`` in rank
    order (tiled, as ``jax.lax.all_gather(..., tiled=True)``)."""
    axes = _axes(axes)
    n = mesh.axis_size(axes)
    if n == 1:
        return x
    if _census(mesh, x):
        return _record("all-gather", _resized(x, dim, n))
    dist = _dist()
    src = _host(x, mesh, "all_gather").contiguous()
    out = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(out, src, group=mesh.group(axes))
    return _record("all-gather", torch.cat(out, dim=dim).to(x.device))


def psum_scatter(x: torch.Tensor, mesh, axes, dim: int = -1) -> torch.Tensor:
    """Sum over the ranks along ``axes``, each rank keeping its own block
    of ``dim`` (``jax.lax.psum_scatter(..., tiled=True)``; the last dim by
    default)."""
    axes = _axes(axes)
    n = mesh.axis_size(axes)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"reduce-scatter of dim {dim} ({x.shape[dim]}) "
                         f"over {n} ranks")
    if _census(mesh, x):
        return _record("reduce-scatter", _resized(x, dim, 1 / n))
    dist = _dist()
    src = _host(x, mesh, "reduce_scatter")
    parts = [p.contiguous() for p in src.chunk(n, dim=dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=mesh.group(axes))
    return _record("reduce-scatter", out.to(x.device))


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather(x, mesh, axes, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return psum_scatter(g.contiguous(), ctx.mesh, ctx.axes,
                            dim=ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return psum_scatter(x, mesh, axes, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.mesh, ctx.axes,
                          dim=ctx.dim), None, None, None


def all_gather_grad(x: torch.Tensor, mesh, axes, dim: int = -1):
    """:func:`all_gather` on ``dim`` whose backward reduce-scatters the
    gradient on ``dim``: rank i receives the sum over the ranks of the
    gradient of block i (the MoE FFN's rows gathered over "data"; FSDP's
    leaves go through ``sharding/fsdp.py``, a block's in one
    collective)."""
    axes = _axes(axes)
    if mesh.axis_size(axes) == 1:
        return x
    return _AllGather.apply(x, mesh, axes, dim)


def reduce_scatter_grad(x: torch.Tensor, mesh, axes, dim: int = -1):
    """:func:`psum_scatter` on ``dim`` whose backward all-gathers the
    gradient on ``dim``."""
    axes = _axes(axes)
    if mesh.axis_size(axes) == 1:
        return x
    return _ReduceScatter.apply(x, mesh, axes, dim)


class _PsumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return psum(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g.contiguous(), ctx.mesh, ctx.axes), None, None


def _block(t, mesh, axes, dim):
    n = mesh.axis_size(axes)
    w = t.shape[dim] // n
    return t.narrow(dim, mesh.index(axes) * w, w)


class _GatherSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather(x, mesh, axes, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return (_block(g, ctx.mesh, ctx.axes, ctx.dim).contiguous(), None,
                None, None)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _block(x, mesh, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.mesh, ctx.axes,
                          dim=ctx.dim), None, None, None


def psum_grad(x: torch.Tensor, mesh, axes):
    """:func:`psum` whose backward is the identity (Megatron's "g"): the
    ranks' partial sums joined into a tensor every rank holds whole, whose
    gradient each rank has whole (a row-parallel dot's rejoin); over the
    data axes, the train step's CE numerator: its value the whole sum, each
    rank's gradient its own term's."""
    axes = _axes(axes)
    if mesh.axis_size(axes) == 1:
        return x
    return _PsumGrad.apply(x, mesh, axes)


def copy_to_model(x: torch.Tensor, mesh, axes="model"):
    """The identity whose backward all-reduces the gradient over ``axes``
    (Megatron's "f"): a tensor every rank holds whole, entering a
    computation each rank does on its own piece (a column-parallel dot's
    input, a norm scale applied to the rank's positions) gets the sum of
    the ranks' partial gradients."""
    axes = _axes(axes)
    if mesh.axis_size(axes) == 1:
        return x
    return _Copy.apply(x, mesh, axes)


def all_gather_split(x: torch.Tensor, mesh, axes, dim: int = -1):
    """:func:`all_gather` on ``dim`` whose backward keeps the rank's block
    of the gradient: the gathered tensor's gradient is whole on every rank
    already (Megatron's gather from the model-parallel region)."""
    axes = _axes(axes)
    if mesh.axis_size(axes) == 1:
        return x
    return _GatherSplit.apply(x, mesh, axes, dim)


def split_grad(x: torch.Tensor, mesh, axes, dim: int = -1):
    """The rank's block of ``x`` on ``dim`` (a tensor every rank holds
    whole) whose backward all-gathers the blocks' gradients into the whole
    one (Megatron's scatter to the model-parallel region)."""
    axes = _axes(axes)
    if mesh.axis_size(axes) == 1:
        return x
    return _Split.apply(x, mesh, axes, dim)


def barrier(mesh) -> None:
    """Wait for every rank of ``mesh`` (no-op on one position and on a
    census mesh)."""
    if mesh.size > 1 and mesh.transport != "census":
        _dist().barrier(group=mesh.group(mesh.axis_names))


def ppermute_ring(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """One hop of the ring ``i -> i + 1`` along ``axis``: every rank sends
    ``x`` to its successor and returns what its predecessor sent."""
    n = mesh.axis_size(axis)
    if n == 1:
        return x
    if _census(mesh, x):
        return _record("collective-permute", torch.empty_like(x))
    dist = _dist()
    group = mesh.group(axis)
    members = dist.get_process_group_ranks(group)
    me = mesh.index(axis)
    src = _host(x, mesh, "send_recv").contiguous()
    recv = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, members[(me + 1) % n], group),
           dist.P2POp(dist.irecv, recv, members[(me - 1) % n], group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return _record("collective-permute", recv.to(x.device))


def split_last(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """This rank's block of ``x``'s last dim along ``axes`` (no
    communication)."""
    axes = _axes(axes)
    if mesh.axis_size(axes) == 1:
        return x
    return _block(x, mesh, axes, -1)
