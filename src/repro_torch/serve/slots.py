"""Slot-level KV/SSM cache pool for continuous batching (port of
``repro.serve.slots`` without the mesh).

A ``SlotPool`` owns ONE preallocated cache tree shaped ``[R, T, B, L, ...]``
where ``B`` is the slot capacity and ``L`` the per-slot context budget.
Requests are left-aligned at position 0 of their slot and a per-slot
position vector tracks each slot's fill.  Freeing a slot is bookkeeping
only: stale cache contents beyond a slot's position are masked on read.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.models import transformer as tfm


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


def _insert(pool, pre, slot: int) -> None:
    """Write each prefill leaf's whole extent at (0, 0, slot, 0, 0, ...) of
    its pool leaf, as the reference's ``dynamic_update_slice``: K/V rows
    0..Lp-1, an SSM state whole, a conv tail at its leading rows."""
    if isinstance(pool, dict):
        for k in pool:
            _insert(pool[k], pre[k], slot)
        return
    if pre.ndim != pool.ndim:
        raise ValueError(f"prefill leaf rank {pre.ndim} != pool rank "
                         f"{pool.ndim}")
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
                 dtype=None, device=None):
        if capacity < 1 or max_len < 2:
            raise ValueError("need capacity >= 1 and max_len >= 2")
        self.cfg = cfg
        self.capacity = capacity
        self.max_len = max_len
        dtype = torch_dtype(dtype or cfg.compute_dtype)
        self.caches = tfm.init_caches(cfg, capacity, max_len, dtype=dtype,
                                      device=device)
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
        """Claim the lowest free slot for ``state``."""
        if not self._free:
            raise RuntimeError("slot pool exhausted")
        self._free.sort()
        slot = self._free.pop(0)
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
        position 0 of ``slot``."""
        if self.slots[slot] is None:
            raise ValueError(f"slot {slot} is not active")
        if prompt_len > self.max_len:
            raise ValueError(
                f"prompt_len {prompt_len} exceeds slot budget {self.max_len}")
        _insert(self.caches, prefill_caches, slot)
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
