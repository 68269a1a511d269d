"""Deterministic synthetic data pipeline (port of ``repro.data.pipeline``).

Stateless by step: ``batch_for_step(step)`` is a pure function of (seed,
step, host), drawn from the same numpy generator as the reference's, so
the port's batches are bit-identical to it and a resumed run sees the
same token stream with no loader state to save.  Each host materialises
only its slice of the global batch.

Two synthetic tasks:
  * ``lm``:    a Zipf-distributed token stream (shaped like text);
  * ``copy``:  the second half of every sequence repeats the first, so
               next-token loss is learnable.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    task: str = "copy"             # lm | copy
    seed: int = 1234
    zipf_a: float = 1.2


class SyntheticPipeline:
    def __init__(self, dcfg: DataConfig, num_hosts: int = 1,
                 host_index: int = 0):
        self.cfg = dcfg
        if dcfg.global_batch % num_hosts:
            raise ValueError(f"global batch {dcfg.global_batch} does not "
                             f"split over {num_hosts} hosts")
        self.per_host = dcfg.global_batch // num_hosts
        self.host_index = host_index

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.cfg.seed * 1_000_003 + step) * 31 + self.host_index)

    def batch_for_step(self, step: int) -> dict:
        """{"tokens": (per_host, seq_len) int32 numpy array}."""
        c = self.cfg
        rng = self._rng(step)
        B, S, V = self.per_host, c.seq_len, c.vocab_size
        if c.task == "lm":
            toks = rng.zipf(c.zipf_a, size=(B, S)).astype(np.int64)
            toks = np.clip(toks, 1, V - 1).astype(np.int32)
        elif c.task == "copy":
            half = S // 2
            first = rng.integers(1, V, size=(B, half), dtype=np.int32)
            toks = np.concatenate([first, first], axis=1)
            if toks.shape[1] < S:
                pad = np.zeros((B, S - toks.shape[1]), np.int32)
                toks = np.concatenate([toks, pad], axis=1)
        else:
            raise ValueError(c.task)
        return {"tokens": toks}

    def device_batch(self, step: int, device=None) -> dict:
        """``batch_for_step`` as int64 tensors on ``device`` (default CUDA;
        ``device="cpu"`` for the CPU)."""
        dev = resolve_device(device)
        return {k: torch.from_numpy(v).to(dev, torch.long)
                for k, v in self.batch_for_step(step).items()}


def eval_accuracy(logits: np.ndarray, tokens: np.ndarray,
                  vocab_size: int) -> float:
    """Copy-task accuracy: fraction of second-half tokens predicted right."""
    S = tokens.shape[1]
    half = S // 2
    preds = logits[:, :-1, :vocab_size].argmax(-1)
    targets = tokens[:, 1:]
    span = slice(half, S - 1)  # positions whose target is a copied token
    return float((preds[:, span] == targets[:, span]).mean())
