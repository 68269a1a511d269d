"""Program API — the public entry point for inference (port of
``repro.api``).

    prog = Program.build(cfg, params)            # prepare banks ONCE
    logits, caches = prog.prefill(batch, cache_len)
    tok, caches = prog.decode_sample(tokens, caches, pos)
    out = prog.generate(prompt, max_new=32)

``build`` resolves the backend, moves the params to the device, casts them
to the compute dtype and — photonic — programs every matmul weight into a
``PreparedTensor`` bank once.  PyTorch runs eagerly, so there are no jit
cells: each step calls ``models.transformer.forward`` directly.  Caches are
updated in place and returned.

Greedy decoding matches the reference token for token on the test
configs; temperature sampling draws from a ``torch.Generator`` and is not
expected to reproduce ``jax.random``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import backend as backend_lib
from repro_torch.core import noise as noise_lib
from repro_torch.core import prepared as prepared_lib
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import transformer as tfm

NEG_INF = -1e30


# =========================================================================
# sampling
# =========================================================================
def _mask_padded(logits, vocab_size: int):
    padded = logits.shape[-1]
    if padded == vocab_size:
        return logits
    col = torch.arange(padded, device=logits.device)
    return logits.masked_fill(col >= vocab_size, NEG_INF)


def sample(logits, vocab_size: int, generator=None,
           temperature: float = 0.0):
    """Greedy (``temperature <= 0``) or temperature sampling over the
    unpadded vocabulary.  ``temperature > 0`` needs a ``torch.Generator``
    on the logits' device."""
    if temperature > 0.0 and generator is None:
        raise ValueError(f"sample(temperature={temperature}) needs a "
                         f"torch.Generator; use temperature=0 for greedy")
    logits = _mask_padded(logits.to(torch.float32), vocab_size)
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0].to(
        torch.int32)


# =========================================================================
# Program
# =========================================================================
@dataclasses.dataclass
class Program:
    """A model prepared for serving: backend resolved, banks programmed."""

    cfg: ModelConfig
    backend: backend_lib.Backend
    bank: Any
    device: torch.device

    @classmethod
    def build(cls, cfg: ModelConfig, params, *, execution=None,
              device=None) -> "Program":
        """Resolve the substrate, move ``params`` (nested dict of tensors,
        the reference's keys) to ``device`` and prepare the banks once.
        ``device`` defaults to CUDA and raises when no CUDA device exists;
        pass ``device="cpu"`` for the plain CPU path."""
        dev = resolve_device(device)
        bk = backend_lib.resolve(execution if execution is not None else cfg)
        moved = prepared_lib.map_with_path(
            lambda _p, leaf: leaf.to(dev) if isinstance(leaf, torch.Tensor)
            else leaf, params)
        bank = prepared_lib.prepare_params(moved, cfg.compute_dtype,
                                           bk.is_photonic)
        return cls(cfg=cfg, backend=bk, bank=bank, device=dev)

    def update_noise(self, noise) -> None:
        """Swap the fault-model config on the live Program (in place): the
        calibration loop's republish step.  The banks and caches stay;
        the device gain cache of the old config is dropped."""
        self.backend = dataclasses.replace(self.backend, noise=noise)
        noise_lib.clear_gain_cache()

    # -------------------------------------------------------------- stats
    def bank_stats(self) -> dict:
        return prepared_lib.prepared_stats(self.bank)

    def verify_banks(self) -> float:
        """Max W0 checksum error across all programmed banks (~0 for
        uncorrupted banks; 0.0 for a pure-fp xla bank)."""
        errs = [prepared_lib.verify_bank(leaf)
                for leaf in prepared_lib.tree_leaves(self.bank)
                if isinstance(leaf, prepared_lib.PreparedTensor)]
        return max(errs, default=0.0)

    # -------------------------------------------------------------- steps
    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens) if not isinstance(
            tokens, torch.Tensor) else tokens).to(self.device, torch.long)

    def _dtype(self):
        return torch_dtype(self.cfg.compute_dtype)

    @torch.no_grad()
    def prefill(self, batch, cache_len: int, last=None):
        """Run prompts into fresh caches.  ``last`` (B,) picks each row's
        last-prompt-token logits (default: the final column).  The lm head
        runs over every position first, as in the reference, so its A8
        scale covers all prefill rows.  Returns (logits (B, V), caches)."""
        tokens = self._tokens(batch["tokens"])
        B, S = tokens.shape
        if last is None:
            last = torch.full((B,), S - 1, dtype=torch.long)
        last = torch.as_tensor(last).to(self.device, torch.long)
        caches = tfm.init_caches(self.cfg, B, cache_len, dtype=self._dtype(),
                                 device=self.device)
        logits, caches, _ = tfm.forward(self.bank, self.cfg,
                                        {"tokens": tokens}, mode="prefill",
                                        caches=caches, execution=self.backend)
        return logits[torch.arange(B, device=self.device), last], caches

    def empty_caches(self, B: int, cache_len: int):
        """Zero capacity caches for the chunked-prefill entry points."""
        return tfm.init_caches(self.cfg, B, cache_len, dtype=self._dtype(),
                               device=self.device)

    @torch.no_grad()
    def prefill_chunk(self, tokens, caches, q_offset: int, last=None):
        """One fixed-width prefill chunk into existing capacity caches
        (updated in place).  tokens: (B, W) = prompt slice
        [q_offset, q_offset + W); ``last`` (B,) indexes logits WITHIN the
        chunk (default: final column)."""
        tokens = self._tokens(tokens)
        B, W = tokens.shape
        if last is None:
            last = torch.full((B,), W - 1, dtype=torch.long)
        last = torch.as_tensor(last).to(self.device, torch.long)
        logits, caches, _ = tfm.forward(
            self.bank, self.cfg, {"tokens": tokens}, mode="prefill_chunk",
            caches=caches, pos=int(q_offset), execution=self.backend)
        return logits[torch.arange(B, device=self.device), last], caches

    def prefill_chunked(self, batch, cache_len: int, chunk: int, last=None):
        """Chunked prefill over a whole batch: fixed-width query chunks
        (tail zero-padded, causally invisible).  Equivalent to
        :meth:`prefill` within the W8A8 tolerance on photonic (per-chunk
        activation scales).  Returns (logits (B, V), caches)."""
        tokens = self._tokens(batch["tokens"])
        B, S = tokens.shape
        if last is None:
            last = torch.full((B,), S - 1, dtype=torch.long)
        last = torch.as_tensor(last).to(self.device, torch.long)
        S_pad = -(-S // chunk) * chunk
        if S_pad != S:
            tokens = torch.nn.functional.pad(tokens, (0, S_pad - S))
        caches = self.empty_caches(B, cache_len)
        out = None
        for off in range(0, S_pad, chunk):
            idx = torch.clamp(last - off, 0, chunk - 1)
            lg, caches = self.prefill_chunk(tokens[:, off:off + chunk],
                                            caches, off, last=idx)
            hit = (last >= off) & (last < off + chunk)
            out = lg if out is None else torch.where(hit[:, None], lg, out)
        return out, caches

    @torch.no_grad()
    def decode(self, tokens, caches, pos):
        """One token per sequence.  tokens: (B, 1); ``pos`` an int (aligned)
        or (B,) per-slot positions.  Caches are updated in place.  Returns
        (logits (B, V), caches)."""
        tokens = self._tokens(tokens)
        if not isinstance(pos, int):
            pos = torch.as_tensor(pos).to(self.device, torch.long)
        logits, caches, _ = tfm.forward(self.bank, self.cfg,
                                        {"tokens": tokens}, mode="decode",
                                        caches=caches, pos=pos,
                                        execution=self.backend)
        return logits[:, 0, :], caches

    def decode_sample(self, tokens, caches, pos, generator=None,
                      temperature: float = 0.0):
        """Decode + sample.  Returns (token_ids (B,), caches)."""
        if temperature > 0.0 and generator is None:
            raise ValueError("decode_sample(temperature>0) needs a "
                             "torch.Generator")
        logits, caches = self.decode(tokens, caches, pos)
        return sample(logits, self.cfg.vocab_size, generator,
                      temperature), caches

    def generate(self, prompt, max_new: int, *, temperature: float = 0.0,
                 seed: int = 0):
        """Autoregressive loop: prompt (B, S) -> (B, S + max_new) tokens."""
        prompt = self._tokens(prompt)
        B, S = prompt.shape
        logits, caches = self.prefill({"tokens": prompt}, S + max_new)
        gen = None
        if temperature > 0.0:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        toks = [prompt]
        cur = sample(logits, self.cfg.vocab_size, gen,
                     temperature).long()[:, None]
        for i in range(max_new):
            toks.append(cur)
            if i == max_new - 1:
                break
            nxt, caches = self.decode_sample(cur, caches, S + i,
                                             generator=gen,
                                             temperature=temperature)
            cur = nxt.long()[:, None]
        return torch.cat(toks, dim=1)
