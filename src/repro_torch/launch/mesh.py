"""Execution meshes and the ranks that run them (port of
``repro.launch.mesh``).

The reference lays one SPMD program over a ``jax.sharding.Mesh`` of
devices.  The port runs one process per mesh position instead: ``D x M``
ranks over ``torch.distributed``, each knowing its (data, model)
coordinates and holding one process group per set of mesh axes.

  * :func:`parse_mesh`, :func:`make_mesh`, :func:`make_mesh_auto`,
    :func:`single_device_mesh` and :func:`make_production_mesh` describe a
    mesh: its axis names and sizes.  Such a mesh is *unbound* (no rank
    coordinates) unless it has one position: a 1x1 mesh is usable in the
    calling process and takes the exact unsharded path.
  * :func:`init_ranks` is the one way to start ranks: it spawns one process
    per position with ``torch.multiprocessing``, joins them through a
    ``file://`` rendezvous in a temporary directory (no TCP port to collide
    with another run), hands each its *bound* :class:`Mesh` and returns
    what each rank's function returned.  A rank that raises makes
    ``init_ranks`` raise.

:func:`census_mesh` binds a mesh to one rank's coordinates with no
process group: its transport is ``"census"`` and its device ``meta``.  The
dry-run (``launch/dryrun.py``) walks one rank's step on it in the calling
process; its collectives shape their results and move nothing
(``sharding/collectives.py``).

**The transport rule**, decided once in :func:`transport_for` when the
ranks start and never switched at run time:

  * ``nccl`` when every rank has a CUDA device of its own;
  * ``gloo`` on the CPU, and on CUDA when ranks share a device (NCCL
    refuses two ranks on one device).  Gloo runs only some collectives on
    CUDA tensors, so the others go through host memory:
    :data:`GLOO_CUDA_STAGED`, checked on an H100 with torch 2.11 by
    ``tools/probe_gloo_cuda.py`` (one 2-rank spawn per op, on float32 and
    bfloat16 CUDA tensors, each held equal to the same op on CPU tensors).

The NCCL branch needs a card per rank and is unverified on a one-card
machine.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import pickle
import tempfile
from typing import Any, Optional

import numpy as np
import torch

AXES_2D = ("data", "model")
AXES_3D = ("pod", "data", "model")

# collectives gloo refuses on CUDA tensors (torch 2.11 on an H100): point
# to point sends raise, so the ring's hops are staged through host memory.
# Gloo runs all_reduce (SUM and MAX), broadcast and the list forms of
# all_gather and reduce_scatter on CUDA tensors itself; the single-tensor
# forms (``all_gather_into_tensor``, ``reduce_scatter_tensor``) abort the
# process there, so sharding/collectives.py uses the list forms only.
GLOO_CUDA_STAGED = frozenset({"send_recv"})


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, model) or (pod, data, model) mesh.

    ``shape`` maps axis name -> size, as a JAX mesh's does.  A bound mesh
    also knows this rank's ``coords`` (one per axis), its CUDA or CPU
    ``device``, the ``transport`` and its process groups (one per set of
    axes, made by every rank in the same order)."""

    axis_names: tuple
    sizes: tuple
    coords: Optional[tuple] = None
    device: Any = dataclasses.field(default=None, compare=False)
    transport: str = dataclasses.field(default="local", compare=False)
    _groups: dict = dataclasses.field(default_factory=dict, compare=False,
                                      repr=False, hash=False)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.sizes))

    @property
    def bound(self) -> bool:
        return self.coords is not None

    @property
    def rank(self) -> int:
        """This rank's index: row-major over the mesh coordinates (0 on a
        mesh of one position, bound or not)."""
        return self.index(self.axis_names)

    def index(self, axes) -> int:
        """This rank's position along ``axes`` (one name or a tuple of
        names, row-major in that order; 0 along axes of size 1)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if self.axis_size(axes) == 1:
            return 0
        pos = [self.coords[self.axis_names.index(a)] for a in axes]
        return int(np.ravel_multi_index(pos, [self.shape[a] for a in axes]))

    def axis_size(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return int(np.prod([self.shape[a] for a in axes])) if axes else 1

    def group(self, axes):
        """The process group of the ranks that differ from this one only
        along ``axes``."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return self._groups[tuple(sorted(axes))]

    def staged(self, op: str) -> bool:
        """Whether collective ``op`` on this rank's tensors goes through
        host memory (the transport rule)."""
        return (self.transport == "gloo" and self.device is not None
                and torch.device(self.device).type == "cuda"
                and op in GLOO_CUDA_STAGED)

    def describe(self) -> str:
        staged = sorted(op for op in ("all_reduce", "all_gather",
                                      "reduce_scatter", "send_recv")
                        if self.staged(op))
        return (f"{self.transport} ({'x'.join(map(str, self.sizes))} ranks"
                f" on {self.device}; staged through host: "
                f"{', '.join(staged) or 'none'})")


def _axes_for(shape) -> tuple:
    return AXES_3D if len(shape) == 3 else AXES_2D


def make_mesh(shape: tuple, axes: tuple) -> Mesh:
    """An unbound mesh of ``shape`` over ``axes``; a 1x1 mesh is bound to
    the calling process (its one position)."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    if int(np.prod(shape)) == 1:
        return Mesh(tuple(axes), shape, coords=(0,) * len(shape))
    return Mesh(tuple(axes), shape)


def parse_mesh(spec) -> Mesh:
    """Mesh from a ``"DxM"`` / ``"PxDxM"`` string (or an int tuple): 2 dims
    map to ``(data, model)``, 3 to ``(pod, data, model)``.  The one spec
    parser every entry point (serve, shardcheck) shares."""
    try:
        if isinstance(spec, str):
            shape = tuple(int(x) for x in spec.split("x"))
        else:
            shape = tuple(int(x) for x in spec)
    except (TypeError, ValueError):
        shape = ()
    if len(shape) not in (2, 3) or any(s < 1 for s in shape):
        raise ValueError(f"mesh spec {spec!r} must be DxM or PxDxM with "
                         f"positive sizes")
    return make_mesh(shape, _axes_for(shape))


def device_count() -> int:
    """CUDA devices this process sees (0 without a card)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def make_mesh_auto(*, max_model: int = 4, devices=None) -> Mesh:
    """Largest ``(data, model)`` mesh over the available devices: the
    largest power-of-two factor <= ``max_model`` on "model", the rest on
    "data".  ``devices`` is a count (default: the CUDA devices, at least
    one).  One device gives :func:`single_device_mesh`."""
    n = max(1, device_count()) if devices is None else int(
        devices if isinstance(devices, int) else len(devices))
    model = 1
    while model * 2 <= max_model and n % (model * 2) == 0:
        model *= 2
    return make_mesh((n // model, model), AXES_2D)


def single_device_mesh() -> Mesh:
    """The 1x1 mesh: the exact unsharded path, no process group."""
    return make_mesh((1, 1), AXES_2D)


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """16x16 = 256 positions per pod; 2 pods = 512 multi-pod.  Raises when
    fewer devices exist, as the reference does."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    n = int(np.prod(shape))
    have = device_count() if devices is None else int(devices)
    if have < n:
        raise RuntimeError(f"mesh {shape} needs {n} devices, have {have}")
    return make_mesh(shape, _axes_for(shape))


def census_mesh(spec, rank: int = 0) -> Mesh:
    """``spec`` (a :class:`Mesh`, a ``"DxM"`` / ``"PxDxM"`` string or an int
    tuple) bound to rank ``rank``'s coordinates with the census transport
    on the meta device: no process group, no memory (module docstring)."""
    mesh = spec if isinstance(spec, Mesh) else parse_mesh(spec)
    if not 0 <= rank < mesh.size:
        raise ValueError(f"rank {rank} outside a mesh of {mesh.size}")
    coords = tuple(int(c) for c in np.unravel_index(rank, mesh.sizes))
    return Mesh(mesh.axis_names, mesh.sizes, coords=coords,
                device=torch.device("meta"), transport="census")


# =========================================================================
# ranks
# =========================================================================
def transport_for(device: str, world: int) -> str:
    """The transport rule: ``nccl`` when each of ``world`` ranks has a CUDA
    device of its own, else ``gloo``."""
    if torch.device(device).type == "cuda" and world <= device_count():
        return "nccl"
    return "gloo"


def _rank_device(device: str, rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank % max(1, device_count()))


def bind(mesh: Mesh, rank: int, device, transport: str) -> Mesh:
    """This rank's view of ``mesh``: its coordinates and one process group
    per non-empty set of axes.  Every rank makes every group, in the same
    order (``torch.distributed.new_group`` is collective)."""
    import torch.distributed as dist

    coords = tuple(int(c) for c in np.unravel_index(rank, mesh.sizes))
    groups = {}
    names = mesh.axis_names
    for r in range(1, len(names) + 1):
        for axes in itertools.combinations(names, r):
            key = tuple(sorted(axes))
            rest = [a for a in names if a not in axes]
            mine = None
            for fixed in itertools.product(
                    *[range(mesh.shape[a]) for a in rest]):
                members = []
                for q in range(mesh.size):
                    qc = np.unravel_index(q, mesh.sizes)
                    if all(qc[names.index(a)] == f
                           for a, f in zip(rest, fixed)):
                        members.append(q)
                g = dist.new_group(members, backend=transport)
                if rank in members:
                    mine = g
            groups[key] = mine
    return Mesh(names, mesh.sizes, coords=coords, device=device,
                transport=transport, _groups=groups)


def _rank_main(rank, fn, mesh, device, tmp, args, threads):
    import torch.distributed as dist

    if threads:
        torch.set_num_threads(threads)
    dev = _rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    transport = transport_for(device, mesh.size)
    dist.init_process_group(transport, init_method=f"file://{tmp}/rendezvous",
                            world_size=mesh.size, rank=rank)
    try:
        bound = bind(mesh, rank, dev, transport)
        out = fn(bound, *args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def init_ranks(fn, mesh, *, device="cuda", args=(), threads=None) -> list:
    """Run ``fn(bound_mesh, *args)`` on one process per position of
    ``mesh`` (a :class:`Mesh` or a ``"DxM"`` spec) and return the ranks'
    results in rank order.  ``fn`` must be importable by the child
    processes (a module-level function) and return a picklable value.
    ``device`` "cuda" puts rank r on CUDA device ``r % device_count``
    (ranks share a card when there are more ranks than cards); "cpu" runs
    the plain paths.  ``threads`` caps each rank's intra-op threads."""
    import torch.multiprocessing as mp

    if not isinstance(mesh, Mesh):
        mesh = parse_mesh(mesh)
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_ranks(device='cuda'): no CUDA device; pass "
                           "device='cpu' for the plain paths")
    mesh = Mesh(mesh.axis_names, mesh.sizes)
    with tempfile.TemporaryDirectory(prefix="repro-ranks-") as tmp:
        mp.spawn(_rank_main, args=(fn, mesh, str(device), tmp, tuple(args),
                                   threads),
                 nprocs=mesh.size, join=True)
        out = []
        for r in range(mesh.size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
