"""Request / completion records (partial port of ``repro.serve.batcher``;
the ``WaveBatcher`` belongs to a later slice)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray             # (prompt_len,) int32
    max_new: int
    extras: Optional[dict] = None
    eos_id: Optional[int] = None   # early stop


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: np.ndarray             # (prompt_len + n_generated,)
    prompt_len: int
    padded_to: int
    finish_reason: str = "length"  # length | eos
