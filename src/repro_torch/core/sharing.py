"""Shared-stack execution — PRM (§3.1) + OBU (§3.2).

Port of ``repro.core.sharing``.  A stack of ``depth = R*T`` logical blocks
runs as a loop over the R physical blocks (each block's parameters are the
R-axis slice of the stacked params) with an inner loop over the T reuses,
applying the static OBU transform of each reuse (channel shuffle before
the block, transpose flag at the weight use-sites).  The reference's
``lax.scan`` becomes a Python loop: PyTorch runs eagerly.

Per-logical-layer caches have leading dims [R, T, ...].  Unlike the
reference (immutable arrays, a new cache returned), **the port updates the
cache in place**: prefill and chunked-prefill attention blocks write their
K/V into the [r, t] view they are handed; a prefill SSM block returns its
final state and conv tail, which :func:`_write_prefill` copies into the
[r, t] slice at offset 0 (the reference stacks them as the new cache); in
decode mode the block returns a one-token delta (attention) or a
full-slice update (SSM) that :func:`_delta_update` writes into the carried
buffer at ``decode_pos`` (a per-row scatter for a (B,) position vector),
or None for a leaf it only read (cross-attention K/V, written once by the
prefill), which stays untouched.  The cache object passed in is the one
returned.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import backend as backend_lib
from repro_torch.core import obu
from repro_torch.core.prm import ReuseConfig, ReusePlan


def tree_index(tree, i):
    """Index every leaf's leading axis (PreparedTensor slices all fields)."""
    if isinstance(tree, dict):
        return {k: tree_index(v, i) for k, v in tree.items()}
    return tree[i]


@dataclasses.dataclass(frozen=True)
class SharedStack:
    """Static schedule for one stack: plan + resolved OBU tables."""

    plan: ReusePlan
    perm_table: np.ndarray          # (T, channels)
    inv_perm_table: np.ndarray      # (T, channels)
    transpose_flags: np.ndarray     # (T,) bool
    shuffle_active: tuple           # (T,) python bool — skip identity gathers
    block_perm_table: tuple = ()    # (T,) block order | None (blocked shuffle)
    shuffle_block: int = 0

    @staticmethod
    def build(depth: int, channels: int,
              cfg: ReuseConfig | None) -> "SharedStack":
        plan = ReusePlan.build(depth, cfg)
        c = plan.config
        perm = obu.build_transform_tables(
            channels, c.reuse_times, c.transforms, c.shuffle_groups,
            c.shuffle_block, c.seed)
        inv = np.stack([obu.invert_permutation(p) for p in perm])
        tf = obu.transpose_flags(c.reuse_times, c.transforms)
        active = tuple(bool((perm[t] != np.arange(channels)).any())
                       for t in range(c.reuse_times))
        block = (c.shuffle_block if c.shuffle_block > 0
                 and channels % c.shuffle_block == 0 else 0)
        bpt = []
        for t in range(c.reuse_times):
            bp = None
            if block and active[t]:
                p2 = perm[t].reshape(-1, block)
                order = p2[:, 0] // block
                if (p2 == order[:, None] * block
                        + np.arange(block)[None, :]).all():
                    bp = tuple(int(v) for v in order)
            bpt.append(bp)
        return SharedStack(plan=plan, perm_table=perm, inv_perm_table=inv,
                           transpose_flags=tf, shuffle_active=active,
                           block_perm_table=tuple(bpt), shuffle_block=block)

    @property
    def num_physical(self) -> int:
        return self.plan.num_physical

    @property
    def reuse_times(self) -> int:
        return self.plan.reuse_times


BlockFn = Callable[..., tuple]
# block_fn(params_r, x, cache_t, aux, *, transpose: bool, reuse_index: int)
#   -> (x, new_cache_t, aux)


def _delta_update(cache_leaf: torch.Tensor, delta: torch.Tensor, r: int,
                  t: int, pos) -> None:
    """Write a decode-mode cache update into the [R, T, ...] buffer IN
    PLACE.  A full-slice update replaces the [r, t] slice; a one-token
    delta (exactly one dim of size 1 where the cache has L) is written at
    ``pos`` — a scalar (every row at the same position) or a (B,) vector
    (row ``b`` at ``pos[b]``: a per-row scatter)."""
    dst = cache_leaf[r, t]
    up = delta.to(cache_leaf.dtype)
    if tuple(up.shape) == tuple(dst.shape):
        dst.copy_(up)
        return
    diff = [i for i, (a, b) in enumerate(zip(up.shape, dst.shape)) if a != b]
    if len(diff) != 1 or up.shape[diff[0]] != 1:
        raise ValueError(f"cache delta {tuple(up.shape)} incompatible with "
                         f"slice {tuple(dst.shape)}")
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        if diff[0] != 1 or up.shape[0] != pos.shape[0]:
            raise ValueError(f"per-slot delta {tuple(up.shape)} needs a "
                             f"batch-leading slice {tuple(dst.shape)} and "
                             f"one position per slot ({tuple(pos.shape)})")
        B = up.shape[0]
        rows = torch.arange(B, device=dst.device)
        dst[rows, pos.to(dst.device).long()] = up.squeeze(1)
        return
    dst.narrow(diff[0], int(pos), 1).copy_(up)


def run_stack(block_fn: BlockFn, params: Any, x: torch.Tensor,
              shared: SharedStack, cache: Any = None, aux0=0.0,
              decode_pos=None, backend=None):
    """Run a PRM-shared stack.

    params: tree with leading axis R; cache: optional tree with leading
    axes [R, T, ...], updated in place (see module docstring); decode_pos:
    set in decode mode, where block cache returns are deltas.  Returns
    (x, cache, aux)."""
    T = shared.reuse_times
    R = shared.num_physical
    backend = backend_lib.resolve(backend)
    bpt = shared.block_perm_table
    aux = torch.as_tensor(aux0, dtype=torch.float32)
    for r in range(R):
        p_r = tree_index(params, r)
        for t in range(T):
            if shared.shuffle_active[t]:
                x = backend.shuffle(x, shared.perm_table[t],
                                    block_perm=bpt[t] if bpt else None,
                                    block=shared.shuffle_block)
            c_t = tree_index(tree_index(cache, r), t) if cache is not None \
                else None
            x, new_c, aux = block_fn(p_r, x, c_t, aux,
                                     transpose=bool(shared.transpose_flags[t]),
                                     reuse_index=t)
            if cache is not None:
                if decode_pos is not None:
                    _write_deltas(cache, new_c, r, t, decode_pos)
                else:
                    _write_prefill(c_t, new_c)
    return x, cache, aux


def _write_prefill(view, new) -> None:
    """Copy a prefill block's returned cache into its [r, t] view at offset
    0 of every axis; a leaf the block already wrote in place (the view
    itself) or only read (None: a legacy decode step's cross K/V) is
    skipped.  A leaf shorter than the view (the conv tail of a prompt
    shorter than W-1) fills the leading rows only."""
    if new is None:
        return
    if isinstance(view, dict):
        for k in view:
            _write_prefill(view[k], new[k])
        return
    if new is view:
        return
    view[tuple(slice(0, n) for n in new.shape)].copy_(new.to(view.dtype))


def _write_deltas(cache, delta, r, t, pos):
    if delta is None:                   # a read-only leaf (cross K/V)
        return
    if isinstance(cache, dict):
        for k in cache:
            _write_deltas(cache[k], delta[k], r, t, pos)
        return
    _delta_update(cache, delta, r, t, pos)
