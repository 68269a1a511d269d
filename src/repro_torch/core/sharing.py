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

With ``remat`` (training, no cache) each reuse runs under
``torch.utils.checkpoint``: only its input is kept for the backward, and
the reuse is recomputed there against the shared weights (the reference's
``jax.checkpoint(one_reuse(t))`` boundary).

A backend carrying FSDP pieces (``Backend.fsdp``, a
``sharding.fsdp.Layout``) has block r's leaves gathered before its first
reuse and dropped after its last; under remat its checkpoints keep them as
tokens, so the backward gathers the block once more where it recomputes
it (``fsdp.Block.remat``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import backend as backend_lib
from repro_torch.core import obu
from repro_torch.core.prm import ReuseConfig, ReusePlan, no_reuse


def tree_index(tree, i):
    """Index every leaf's leading axis (PreparedTensor slices all fields)."""
    if isinstance(tree, dict):
        return {k: tree_index(v, i) for k, v in tree.items()}
    return tree[i]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, lists and tuples (and the
    same places of ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves of nested dicts, lists and tuples in the reference's order
    (dict keys sorted); None is no leaf, as in ``jax.tree.leaves``."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_stack(trees):
    """Stack the leaves of same-structured nested dicts on a new axis 0."""
    if isinstance(trees[0], dict):
        return {k: tree_stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(list(trees), dim=0)


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


def identity_stack(depth: int, channels: int) -> SharedStack:
    return SharedStack.build(depth, channels, no_reuse(depth))


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
              remat: bool = False, decode_pos=None, backend=None,
              path: tuple = ()):
    """Run a PRM-shared stack.

    params: tree with leading axis R; cache: optional tree with leading
    axes [R, T, ...], updated in place (see module docstring); remat:
    recompute each reuse in the backward (no cache); decode_pos: set in
    decode mode, where block cache returns are deltas; path: where
    ``params`` lies in the model's tree (read by ``backend.fsdp``).
    Returns (x, cache, aux)."""
    if remat and cache is not None:
        raise ValueError("remat runs without a cache (train mode)")
    T = shared.reuse_times
    R = shared.num_physical
    backend = backend_lib.resolve(backend)
    bpt = shared.block_perm_table
    aux = torch.as_tensor(aux0, dtype=torch.float32)

    def one_reuse(t, p_r, h, aux, c_t):
        if shared.shuffle_active[t]:
            h = backend.shuffle(h, shared.perm_table[t],
                                block_perm=bpt[t] if bpt else None,
                                block=shared.shuffle_block)
        return block_fn(p_r, h, c_t, aux,
                        transpose=bool(shared.transpose_flags[t]),
                        reuse_index=t)

    fsdp = backend.fsdp
    for r in range(R):
        if fsdp is not None and remat and torch.is_grad_enabled():
            x, aux = _run_gathered_remat(fsdp.block(params, r, path),
                                         one_reuse, T, x, aux)
            continue
        p_r = (tree_index(params, r) if fsdp is None
               else fsdp.block(params, r, path).tree)
        for t in range(T):
            c_t = tree_index(tree_index(cache, r), t) if cache is not None \
                else None
            if remat:
                x, new_c, aux = checkpoint(one_reuse, t, p_r, x, aux, None,
                                           use_reentrant=False)
            else:
                x, new_c, aux = one_reuse(t, p_r, x, aux, c_t)
            if cache is not None:
                if decode_pos is not None:
                    _write_deltas(cache, new_c, r, t, decode_pos)
                else:
                    _write_prefill(c_t, new_c)
        del p_r                         # block r's gathered leaves go
    return x, cache, aux


def _run_gathered_remat(block, one_reuse, T: int, x, aux):
    """The T reuses of a block gathered by ``fsdp.Block``, each under a
    checkpoint that takes the block's tensors as arguments and keeps them
    as tokens (``Block.remat``); its tree is rebuilt inside the reuse."""
    tensors, rebuild = block.flat()
    block.tree = None

    def reuse(t, h, a, *ts):
        return one_reuse(t, rebuild(ts), h, a, None)

    with block.remat(tensors):
        for t in range(T):
            x, _, aux = checkpoint(reuse, t, x, aux, *tensors,
                                   use_reentrant=False)
    return x, aux


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


# ---------------------------------------------------------------------------
# parameter bookkeeping
# ---------------------------------------------------------------------------
def stacked_init(init_one: Callable[[torch.Generator], Any],
                 generator: torch.Generator, num_physical: int) -> Any:
    """R independent draws of a block's params from ``generator``, stacked
    on axis 0 (the reference vmaps ``init_one`` over R split keys)."""
    return tree_stack([init_one(generator) for _ in range(num_physical)])


def param_count(tree) -> int:
    """Elements over every leaf (a leaf without a shape raises, as in the
    reference; ``models.paper_models.param_count`` skips such leaves)."""
    return int(sum(math.prod(x.shape) for x in tree_leaves(tree)))
