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
