"""Device resolution shared by the port's entry points.

Entry points run on the CUDA device unless the caller asks for the CPU by
passing ``device="cpu"``.  With no CUDA device and no explicit CPU request
they raise: the port never carries on silently on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for (or
    defaulted to) and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name) -> torch.dtype:
    """``ModelConfig.compute_dtype`` string -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    return DTYPES[str(name)]
