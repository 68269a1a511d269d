"""Weight bridge: reference parameters, flattened to numpy, into the port.

The reference's checkpoints (``repro.train.checkpoint._flatten``) store
arrays by flattened pytree path with ``/`` separators, e.g.
``segments/main/l0/mixer/wq``.  :func:`params_from_flat` rebuilds the
port's nested-dict params from such a mapping.  torch cannot replay
``jax.random`` streams, so this is how the port runs the reference's exact
weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _to_tensor(a, device) -> torch.Tensor:
    a = np.array(a, copy=True)          # writable, contiguous, owned
    if a.dtype.name == "bfloat16":      # ml_dtypes bfloat16 from JAX
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_flat(flat: dict, device=None) -> dict:
    """``{"a/b/c": array}`` -> ``{"a": {"b": {"c": tensor}}}`` on
    ``device`` (default CUDA; ``device="cpu"`` for the CPU)."""
    dev = resolve_device(device)
    out: dict = {}
    for key, arr in flat.items():
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _to_tensor(arr, dev)
    return out


def paper_params_from_flat(flat: dict, device=None) -> dict:
    """The reference's paper-model params (``repro.models.paper_models``),
    flattened by path, as the port's tree on ``device`` (default CUDA).
    Beyond :func:`params_from_flat`: a dict whose keys are all list
    indices becomes the list it was (VGG-13's ``convs``, ResNet-18's
    ``stages`` of lists of blocks), and a 0-d integer array becomes a
    static Python int (VGG-13's ``shared_map``), never a tensor leaf."""
    dev = resolve_device(device)
    out: dict = {}
    for key, arr in flat.items():
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        a = np.asarray(arr)
        node[parts[-1]] = (int(a) if a.ndim == 0 and a.dtype.kind in "iu"
                           else _to_tensor(a, dev))
    return _lists(out)


def _lists(node):
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        if sorted(map(int, node)) != list(range(len(node))):
            raise ValueError(f"list indices not contiguous: {sorted(node)}")
        return [node[str(i)] for i in range(len(node))]
    return node
