"""Serving engine — the legacy function surface over the Program API
(port of ``repro.serve.engine``).

New code uses :class:`repro_torch.api.Program` directly::

    prog = Program.build(cfg, params)        # backend + banks, once
    out = prog.generate(prompt, max_new=32)

The functions here are thin shims for the old call sites:
``prefill_step`` / ``decode_step`` wrap the functional steps of
``repro_torch.api`` over raw params, and ``generate`` builds a Program per
call.  Greedy outputs are token-identical to the Program methods.  The
port has no mesh: ``act_pspec`` and ``mesh`` raise.
"""
from __future__ import annotations

import torch

from repro_torch import api
from repro_torch.configs.base import ModelConfig
from repro_torch.device import torch_dtype


def cast_params(params, cfg: ModelConfig):
    """float32 -> compute-dtype cast (subsumed by ``Program.build``)."""
    if isinstance(params, dict):
        return {k: cast_params(v, cfg) for k, v in params.items()}
    if isinstance(params, torch.Tensor) and params.dtype == torch.float32:
        return params.to(torch_dtype(cfg.compute_dtype))
    return params


def prefill_step(params, cfg: ModelConfig, batch, cache_len: int,
                 act_pspec=None, execution=None):
    """Run the prompt through the model into fresh caches (on the params'
    device).  ``execution`` overrides ``cfg.execution``.  Returns
    (last_token_logits (B, V), caches)."""
    fn = api.prefill_step_fn(cfg, cache_len, act_pspec=act_pspec,
                             execution=execution)
    return fn(params, batch)


def decode_step(params, cfg: ModelConfig, batch, caches, pos,
                act_pspec=None, legacy_decode=False, execution=None):
    """One token for every sequence: batch["tokens"] (B, 1); ``pos`` an int
    (aligned decode) or (B,) per-slot positions (``legacy_decode``: an int
    only).  The caches are updated in place and returned with the logits
    (B, V)."""
    fn = api.decode_step_fn(cfg, act_pspec=act_pspec,
                            legacy_decode=legacy_decode, execution=execution)
    return fn(params, batch, caches, pos)


def sample(logits, vocab_size: int, generator=None,
           temperature: float = 0.0):
    """Greedy / temperature sampling (``repro_torch.api.sample``)."""
    return api.sample(logits, vocab_size, generator, temperature)


def generate(params, cfg: ModelConfig, prompt, max_new: int, *,
             extras=None, temperature: float = 0.0, seed: int = 0,
             execution=None, mesh=None, device=None):
    """Host-side autoregressive loop: prompt (B, S) -> (B, S + max_new),
    with the modality ``extras`` of a vlm or audio model.  Builds the
    Program (backend, prepared banks) on ``device`` (default
    CUDA) per call, as the reference does."""
    if mesh is not None:
        raise NotImplementedError("mesh: the port has no mesh yet")
    prog = api.Program.build(cfg, params, execution=execution, device=device)
    return prog.generate(prompt, max_new, extras=extras,
                         temperature=temperature, seed=seed)
