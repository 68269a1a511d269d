"""Slot-level KV/SSM cache pool for continuous batching (port of
``repro.serve.slots``).

A ``SlotPool`` owns ONE preallocated cache tree shaped ``[R, T, B, L, ...]``
where ``B`` is the slot capacity and ``L`` the per-slot context budget.
Requests are left-aligned at position 0 of their slot and a per-slot
position vector tracks each slot's fill.  Freeing a slot is bookkeeping
only: stale cache contents beyond a slot's position are masked on read.

**Pools on a mesh** (``mesh=`` of more than one position): the caches are
this rank's pieces under ``partition.cache_pspecs`` (``tfm.init_caches(...,
mesh=)``).  The slot axis spans the mesh's ``dp`` data shards in
contiguous blocks (capacity must divide): every rank keeps the bookkeeping
of all slots, but its caches hold only its shard's block (capacity / dp
rows; ``lo`` is the block's first slot), which is what a decode step on
the rank's rows reads; KV heads or positions are cut over "model" as the
spec says.  ``write_prefill`` is collective there (every rank calls it, as
every rank runs the scheduler's loop): a prefill cache whose positions are
cut (over other axes or lengths than the pool's) is gathered whole over
its axes, then each rank writes its block.  ``allocate`` packs per-shard
sub-batches: the slot comes from the least-loaded shard block (ties to the
lowest shard), the lowest index within it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.models import transformer as tfm
from repro_torch.sharding import partition


@dataclasses.dataclass
class SlotState:
    """Host-side bookkeeping for one occupied slot."""
    rid: int
    prompt_len: int
    max_new: int
    eos_id: Optional[int] = None
    generated: int = 0
    tokens: list = dataclasses.field(default_factory=list)  # generated ids
    prompt: Optional[np.ndarray] = None
    padded_to: int = 0             # prefill compile-bucket length


def _positions_whole(pre, mesh):
    """Tree ``pre`` with every leaf whose positions (dim 3) are cut
    gathered whole over the cut's axes (``partition.piece_of``)."""
    if isinstance(pre, dict):
        return {k: _positions_whole(v, mesh) for k, v in pre.items()}
    rec = partition.piece_of(pre)
    if rec is None or not partition.cuts(rec[0][3:4]):
        return pre
    return partition.gather_leaf(pre, (None,) * 3 + rec[0][3:4], mesh)


def _insert(pool, pre, slot: int, mesh=None) -> None:
    """Write each prefill leaf's whole extent at (0, 0, slot, 0, 0, ...) of
    its pool leaf, as the reference's ``dynamic_update_slice``: K/V rows
    0..Lp-1, an SSM state whole, a conv tail at its leading rows.  A pool
    leaf holding a block of positions (``partition.piece_of``) takes the
    prefill rows of that block."""
    if isinstance(pool, dict):
        for k in pool:
            _insert(pool[k], pre[k], slot, mesh)
        return
    if pre.ndim != pool.ndim:
        raise ValueError(f"prefill leaf rank {pre.ndim} != pool rank "
                         f"{pool.ndim}")
    rec = partition.piece_of(pool)
    if rec is not None and partition.cuts(rec[0][3:4]):
        _, i = partition.piece(mesh, rec[0][3])
        n = pool.shape[3]
        pre = pre.narrow(3, min(i * n, pre.shape[3]),
                         max(0, min(n, pre.shape[3] - i * n)))
    if pre.shape[2] != 1 or any(a > b for a, b in zip(pre.shape, pool.shape)):
        raise ValueError(f"batch-1 prefill leaf {tuple(pre.shape)} does not "
                         f"fit pool leaf {tuple(pool.shape)}")
    idx = (slice(None), slice(None), slice(slot, slot + 1)) + tuple(
        slice(0, n) for n in pre.shape[3:])
    pool[idx].copy_(pre.to(pool.dtype))


class SlotPool:
    """Fixed-capacity slot pool over one preallocated [R, T, B, L, ...]
    cache: ``allocate`` hands out the lowest free slot, ``write_prefill``
    inserts a prefilled request at position 0, ``free`` recycles it."""

    def __init__(self, cfg: ModelConfig, capacity: int, max_len: int,
                 dtype=None, device=None, mesh=None):
        if capacity < 1 or max_len < 2:
            raise ValueError("need capacity >= 1 and max_len >= 2")
        self.cfg = cfg
        self.capacity = capacity
        self.max_len = max_len
        self.mesh = mesh
        self.dp = 1
        self.lo = 0
        if mesh is not None and mesh.size > 1:
            self.dp = partition.dp_size(mesh)
            if capacity % self.dp != 0:
                raise ValueError(
                    f"slot capacity {capacity} must divide over the mesh's "
                    f"{self.dp} data shard(s) (one per-shard sub-batch each)")
        self.rows = capacity // self.dp
        if self.dp > 1:
            self.lo = mesh.index(partition.data_axes(mesh)) * self.rows
        dtype = torch_dtype(dtype or cfg.compute_dtype)
        self.caches = tfm.init_caches(cfg, capacity, max_len, dtype=dtype,
                                      device=device, mesh=mesh)
        # next write position per slot; clamped to max_len - 1 so a full
        # slot's delta write lands in-bounds (and is masked on read)
        self.positions = np.zeros(capacity, np.int32)
        self.slots: list[Optional[SlotState]] = [None] * capacity
        self._free: list[int] = list(range(capacity))

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_active(self) -> int:
        return self.capacity - len(self._free)

    def active_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is not None]

    def allocate(self, state: SlotState) -> int:
        """Claim a free slot for ``state``: the lowest free index, or on a
        data-parallel pool the lowest free index of the least-loaded shard
        block (ties to the lowest shard)."""
        if not self._free:
            raise RuntimeError("slot pool exhausted")
        self._free.sort()
        if self.dp <= 1:
            slot = self._free.pop(0)
        else:
            per = self.rows
            free_by_shard = [[s for s in self._free if s // per == i]
                             for i in range(self.dp)]
            shard = min((i for i in range(self.dp) if free_by_shard[i]),
                        key=lambda i: per - len(free_by_shard[i]))
            slot = free_by_shard[shard][0]
            self._free.remove(slot)
        self.slots[slot] = state
        return slot

    def free(self, slot: int) -> SlotState:
        """Release ``slot``; its cache contents become dead (masked) data."""
        state = self.slots[slot]
        if state is None:
            raise ValueError(f"slot {slot} is not active")
        self.slots[slot] = None
        self.positions[slot] = 0
        self._free.append(slot)
        return state

    def reset(self) -> None:
        """Drop all slots (cache memory is kept allocated)."""
        self.positions[:] = 0
        self.slots = [None] * self.capacity
        self._free = list(range(self.capacity))

    def write_prefill(self, slot: int, prefill_caches, prompt_len: int
                      ) -> None:
        """Copy a batch-1 prefilled cache tree ([R, T, 1, Lp, ...] leaves,
        or full-state leaves like SSM ``h`` with no length axis) into
        position 0 of ``slot`` (on a mesh every rank calls it: module
        docstring)."""
        if self.slots[slot] is None:
            raise ValueError(f"slot {slot} is not active")
        if prompt_len > self.max_len:
            raise ValueError(
                f"prompt_len {prompt_len} exceeds slot budget {self.max_len}")
        if self.mesh is not None and self.mesh.size > 1:
            prefill_caches = _positions_whole(prefill_caches, self.mesh)
        if self.lo <= slot < self.lo + self.rows:     # this rank's block
            _insert(self.caches, prefill_caches, slot - self.lo, self.mesh)
        self.positions[slot] = prompt_len

    def advance(self, slot: int) -> None:
        """One token decoded for ``slot``: bump its position (clamped)."""
        self.positions[slot] = min(self.positions[slot] + 1,
                                   self.max_len - 1)

    def position_vector(self) -> np.ndarray:
        """(B,) per-slot next-write positions for the decode step (a copy:
        the decode cell stages it through its own pinned buffer)."""
        return self.positions.astype(np.int64)

    def remaining(self, slot: int) -> int:
        """Context budget left in ``slot`` (tokens)."""
        return self.max_len - int(self.positions[slot])
