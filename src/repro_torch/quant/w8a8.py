"""Post-training W8A8 quantization (the paper's deployment setting, §4).

Port of ``repro.quant.w8a8``.  Weights: symmetric per-output-channel int8
(abs-max over every axis but the last, ``max(amax, 1e-8) / qmax``, round
half to even, clip), so on the same float32 tree the int8 leaves and the
float32 scales are bit-identical to the reference's.  ``quantize_params``
rewrites every floating leaf of two or more dims into an (int8, scale)
pair; ``dequantize_params`` restores a float32 tree for execution.

Trees are the port's nested dicts, lists and tuples of tensors; dicts are
walked in sorted key order, the reference's leaf order.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.photonic import quantize_symmetric
from repro_torch.core.sharing import tree_leaves, tree_map

QUANT_MIN_DIM = 2


def _quantizable(leaf) -> bool:
    return (isinstance(leaf, torch.Tensor) and leaf.ndim >= QUANT_MIN_DIM
            and leaf.is_floating_point())


def quantize_params(params: Any, bits: int = 8) -> tuple[Any, Any]:
    """Returns (q_tree, scale_tree) mirroring params; non-matrix leaves
    (norm scales, biases, 1-D) pass through unquantized (scale None)."""
    def q(leaf):
        if not _quantizable(leaf):
            return leaf, None
        return quantize_symmetric(leaf, bits,
                                  axis=tuple(range(leaf.ndim - 1)))

    pairs = tree_map(q, params)         # a (q, scale) pair at each leaf
    return (tree_map(lambda _, p: p[0], params, pairs),
            tree_map(lambda _, p: p[1], params, pairs))


def dequantize_params(q_tree: Any, s_tree: Any) -> Any:
    def dq(qv, s):
        if s is None:
            return qv
        return (qv.to(torch.float32) * s).to(torch.float32)

    return tree_map(dq, q_tree, s_tree)


def quantization_error(params: Any, bits: int = 8) -> dict:
    """Max/mean relative error introduced by W8 PTQ (per-tensor summary)."""
    q, s = quantize_params(params, bits)
    dq = dequantize_params(q, s)
    errs = []
    for a, b in zip(tree_leaves(params), tree_leaves(dq)):
        if a.shape != b.shape or a.ndim < QUANT_MIN_DIM:
            continue
        denom = torch.clamp(a.abs().amax(), min=1e-8)
        errs.append(float((a - b).abs().amax() / denom))
    return {"max_rel_err": max(errs) if errs else 0.0,
            "mean_rel_err": float(np.mean(errs)) if errs else 0.0}


def model_bytes(q_tree: Any) -> int:
    return sum(leaf.numel() * leaf.element_size()
               for leaf in tree_leaves(q_tree))
