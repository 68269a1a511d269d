"""Checkpoints: atomic, integrity-checked, resumable (port of
``repro.train.checkpoint``), in the reference's layout, so a checkpoint
written by either package restores in the other.

Layout: ``<dir>/step_<N:08d>/arrays.npz`` + ``meta.json``, staged in a
``.tmp_step_<N>_*`` directory and renamed into place.  Arrays are keyed by
the reference's flattened pytree path: a ``(params, OptState)`` tuple
flattens to ``0/segments/main/l0/mixer/wq``, ``1/m/...``, ``1/v/...`` and
``1/step`` (dict keys sorted, tuple items by index, dataclass fields by
name).  A SHA-256 of the npz bytes guards against torn writes.  A bf16 leaf
is stored as numpy stores the reference's: two raw bytes a value (``V2``),
read back into a bf16 template through a uint16 view.

On a mesh (``mesh``, the rank's bound mesh, and ``specs``, the tree's
layout: ``trainer.state_specs``) the files hold the logical layout only,
as the reference's do: :func:`save` all-gathers each leaf's pieces on every
rank, rank 0 alone copies them to the host and writes the same ``arrays.npz`` / ``meta.json`` as one device
would, and every rank waits for its atomic rename; :func:`restore` reads
the logical arrays and keeps the rank's piece of each.  So a checkpoint
restores on any mesh or on none (the reference's elastic re-scaling), and
crosses both packages bit for bit.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
from typing import Any

import numpy as np
import torch

from repro_torch.sharding import collectives as coll
from repro_torch.sharding import partition


def _items(tree):
    """(key, child) pairs of one tree node in the reference's flatten
    order, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    return None


def _to_numpy(t) -> np.ndarray:
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view("V2")
    return t.numpy()


def _flatten(tree, prefix=(), specs=None, mesh=None, keep=True) -> dict:
    """``{path: array}`` of ``tree``; with ``specs`` each leaf is gathered
    whole over ``mesh`` first (one leaf at a time on the device).  With
    ``keep`` false the leaves are gathered and dropped (a rank that takes
    part in the gathers but does not write): ``{}``."""
    items = _items(tree)
    if items is None:
        if specs is not None:
            tree = partition.gather_leaf(tree, specs, mesh)
        return {"/".join(prefix): _to_numpy(tree)} if keep else {}
    sub = dict(_items(specs)) if specs is not None else {}
    out = {}
    for k, v in items:
        out.update(_flatten(v, prefix + (k,), sub.get(k), mesh, keep))
    return out


def _from_numpy(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    a = np.array(a, copy=True)
    if like.dtype == torch.bfloat16:
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(like.device)
    return torch.from_numpy(a).to(like.device)


def _unflatten_into(template, arrays: dict, prefix=(), specs=None,
                    mesh=None):
    items = _items(template)
    if items is None:
        key = "/".join(prefix)
        a = arrays[key]
        if specs is not None:
            a = partition.local_slice(a, specs, mesh)
        if tuple(a.shape) != tuple(template.shape):
            raise ValueError(f"checkpoint shape mismatch at {key}: "
                             f"{a.shape} vs {tuple(template.shape)}")
        return _from_numpy(a, template)
    sub = dict(_items(specs)) if specs is not None else {}
    kids = {k: _unflatten_into(v, arrays, prefix + (k,), sub.get(k), mesh)
            for k, v in items}
    if isinstance(template, dict):
        return {k: kids[str(k)] for k in template}
    if isinstance(template, (tuple, list)):
        return type(template)(kids[str(i)] for i in range(len(template)))
    return dataclasses.replace(template, **kids)


def save(ckpt_dir: str, step: int, tree: Any, extra: dict | None = None,
         keep: int = 3, *, mesh=None, specs=None) -> str:
    """Write ``tree`` as ``step_<step>``, atomically; keep the newest
    ``keep``.  On a mesh of more than one position every rank calls it
    with its pieces (``specs`` their layout), rank 0 writes, and all return
    once the checkpoint is in place."""
    if mesh is not None and mesh.size > 1:
        writes = mesh.rank == 0
        arrays = _flatten(tree, specs=specs, mesh=mesh, keep=writes)
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        if writes:
            final = _write(ckpt_dir, step, arrays, extra, keep)
        coll.barrier(mesh)
        return final
    return _write(ckpt_dir, step, _flatten(tree), extra, keep)


def _write(ckpt_dir: str, step: int, arrays: dict, extra, keep: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=f".tmp_step_{step}_")
    npz_path = os.path.join(tmp, "arrays.npz")
    np.savez(npz_path, **arrays)
    with open(npz_path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    meta = {"step": step, "sha256": digest,
            "keys": sorted(arrays), "extra": extra or {}}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic publish
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    if not steps:
        return None
    return int(steps[-1].split("_")[1])


def restore(ckpt_dir: str, step: int, template: Any, *, mesh=None,
            specs=None) -> tuple[Any, dict]:
    """Restore into ``template``'s structure (nested dicts, tuples and
    dataclasses of tensors), each leaf on its template leaf's device.
    On a mesh of more than one position each leaf is the rank's piece of
    the logical array under ``specs`` (the template holds pieces).
    Returns (tree, the ``extra`` dict saved with it)."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    npz_path = os.path.join(d, "arrays.npz")
    with open(npz_path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != meta["sha256"]:
        raise IOError(f"checkpoint {d} corrupt (hash mismatch)")
    with np.load(npz_path) as z:
        arrays = {k: z[k] for k in z.files}
    if mesh is None or mesh.size == 1:
        specs = None
    return _unflatten_into(template, arrays, specs=specs,
                           mesh=mesh), meta["extra"]
