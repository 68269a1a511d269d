"""Wave-scheduling request batcher (port of ``repro.serve.batcher``).

Groups queued requests into fixed-size *waves* (prompts left-padded to the
wave maximum; only requests with equal modality extras share a wave), runs
one ``Program.generate`` per wave (one prefill, then a shared decode loop
through its decode cell) and tracks padding efficiency.  Requests never join a running wave: this is the simple
fallback behind the ``Scheduler`` protocol; ``serve.scheduler.
ContinuousScheduler`` is the production path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import api
from repro_torch.configs.base import ModelConfig
from repro_torch.obs.stats import WaveStats


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray             # (prompt_len,) int32
    max_new: int
    extras: Optional[dict] = None
    eos_id: Optional[int] = None   # early stop (continuous scheduler only)


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: np.ndarray             # (prompt_len + n_generated,)
    prompt_len: int
    padded_to: int
    finish_reason: str = "length"  # length | eos


def _equal(a, b) -> bool:
    """Equal shapes and values; two tensors compare where they lie (no
    copy of a card's embeddings to the host)."""
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return (a.shape == b.shape and a.device == b.device
                and bool(torch.equal(a, b)))
    as_np = [x.cpu().numpy() if isinstance(x, torch.Tensor)
             else np.asarray(x) for x in (a, b)]
    return np.array_equal(*as_np)


class WaveBatcher:
    """Admit requests, emit completions wave by wave.

    Takes a built ``api.Program`` or the (params, cfg) pair, built on
    ``device`` (default CUDA).  A wave's requests share their modality
    ``extras`` (one batched prefill), passed to ``generate`` as the first
    request's.  The reference's ``telemetry=`` lifecycle
    hooks (latency histograms, wave spans) come with the port's serving
    telemetry, a later slice; ``stats`` counts the same work as the
    reference's."""

    def __init__(self, params, cfg: ModelConfig = None, wave_size: int = 8,
                 pad_id: int = 0, temperature: float = 0.0, *,
                 device=None):
        if isinstance(params, api.Program):
            self.program = params
            cfg = params.cfg
        else:
            if cfg is None:
                raise ValueError("WaveBatcher(params, cfg) needs the model "
                                 "config (or pass a prebuilt Program)")
            self.program = api.Program.build(cfg, params, device=device)
        self.cfg = cfg
        self.wave_size = wave_size
        self.pad_id = pad_id
        self.temperature = temperature
        self.queue: list[Request] = []
        self.stats = WaveStats()

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    @staticmethod
    def _extras_match(a: Optional[dict], b: Optional[dict]) -> bool:
        """Wave-compatible extras: same keys, identical arrays or tensors
        (a wave runs ONE batched prefill)."""
        if (a is None) != (b is None):
            return False
        if a is None:
            return True
        if set(a) != set(b):
            return False
        return all(_equal(a[k], b[k]) for k in a)

    def _form_wave(self) -> list[Request]:
        # matching extras only, then longest prompt first within the queue
        # head window, to minimize padding
        head = self.queue[0]
        window = [r for r in self.queue[:4 * self.wave_size]
                  if self._extras_match(r.extras, head.extras)]
        window.sort(key=lambda r: -len(r.prompt))
        wave = window[:self.wave_size]
        for r in wave:
            self.queue.remove(r)
        return wave

    def _run_wave(self, wave: list[Request]) -> list[Completion]:
        B = len(wave)
        max_prompt = max(len(r.prompt) for r in wave)
        max_new = max(r.max_new for r in wave)
        prompts = np.full((B, max_prompt), self.pad_id, np.int32)
        for i, r in enumerate(wave):
            # left-pad so every prompt ends at the same position (the
            # aligned decode then starts all rows together)
            prompts[i, max_prompt - len(r.prompt):] = r.prompt
        out = self.program.generate(prompts, max_new,
                                    extras=wave[0].extras,
                                    temperature=self.temperature)
        out = out.cpu().numpy().astype(np.int32)
        comps = []
        for i, r in enumerate(wave):
            toks = out[i, max_prompt - len(r.prompt):
                       max_prompt + r.max_new]
            comps.append(Completion(rid=r.rid, tokens=toks,
                                    prompt_len=len(r.prompt),
                                    padded_to=max_prompt))
            self.stats.prompt_tokens += len(r.prompt)
            self.stats.padded_tokens += max_prompt - len(r.prompt)
            self.stats.generated_tokens += r.max_new
            # processed positions: the prompt, plus one decode lane-step per
            # generated token after the first (the first comes from prefill)
            self.stats.useful_steps += len(r.prompt) + r.max_new - 1
        self.stats.waves += 1
        self.stats.requests += B
        self.stats.slot_steps += B * (max_prompt + max_new - 1)
        return comps

    def drain(self) -> list[Completion]:
        """Run everything queued; returns completions in wave order."""
        done: list[Completion] = []
        while self.queue:
            done.extend(self._run_wave(self._form_wave()))
        return done
