"""Wave-scheduling request batcher (port of ``repro.serve.batcher``).

Groups queued requests into fixed-size *waves* (prompts left-padded to the
wave maximum; only requests with equal modality extras share a wave), runs
one ``Program.generate`` per wave (one prefill, then a shared decode loop
through its decode cell) and tracks padding efficiency.  Requests never join a running wave: this is the simple
fallback behind the ``Scheduler`` protocol; ``serve.scheduler.
ContinuousScheduler`` is the production path.
"""
from __future__ import annotations

import contextlib
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
    request's.  ``telemetry`` (an optional
    :class:`repro_torch.obs.serving.ServingObs`) shares the registry with
    ``self.stats`` and adds request-lifecycle latency histograms and wave
    spans in the Chrome trace.  Waves run as one blocking ``generate``, so
    per-request TTFT inside a wave is not observable: the tracker records
    admission at wave start and completion at wave end (the continuous
    scheduler is the per-token path)."""

    def __init__(self, params, cfg: ModelConfig = None, wave_size: int = 8,
                 pad_id: int = 0, temperature: float = 0.0, telemetry=None,
                 *, device=None):
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
        self.obs = telemetry
        self.stats = WaveStats(
            registry=telemetry.registry if telemetry else None)

    def submit(self, req: Request) -> None:
        self.queue.append(req)
        if self.obs:
            self.obs.tracker.on_submit(req.rid)

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
        if self.obs:
            for r in wave:
                self.obs.tracker.on_admit(r.rid, len(r.prompt), max_prompt)
            if self.obs.meter is not None:
                self.obs.meter.on_prefill(B * max_prompt)
        tr = self.obs.tracer if self.obs else None
        # the span closes after the tokens' read-back (obs/tracing.py)
        with (tr.span("wave", requests=B, max_prompt=max_prompt,
                      max_new=max_new) if tr else contextlib.nullcontext()):
            out = self.program.generate(prompts, max_new,
                                        extras=wave[0].extras,
                                        temperature=self.temperature)
            out = out.cpu().numpy().astype(np.int32)
        if self.obs and self.obs.meter is not None:
            for _ in range(max_new - 1):
                self.obs.meter.on_decode_step(B)
        comps = []
        for i, r in enumerate(wave):
            toks = out[i, max_prompt - len(r.prompt):
                       max_prompt + r.max_new]
            comps.append(Completion(rid=r.rid, tokens=toks,
                                    prompt_len=len(r.prompt),
                                    padded_to=max_prompt))
            if self.obs:
                self.obs.tracker.on_finish(r.rid)
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
