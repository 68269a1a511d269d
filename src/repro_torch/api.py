"""Program API — the public entry point for inference (port of
``repro.api``).

    prog = Program.build(cfg, params)            # prepare banks ONCE
    logits, caches = prog.prefill(batch, cache_len)
    tok, caches = prog.decode_sample(tokens, caches, pos)
    out = prog.generate(prompt, max_new=32)

``build`` resolves the backend, moves the params to the device, casts them
to the compute dtype and — photonic — programs every matmul weight into a
``PreparedTensor`` bank once.  Stacks with SSM or cross-attention mixers
prefill monolithically (an SSM state integrates every token; a memory
stream is projected once per request): ``prefill_chunk`` and
``prefill_chunked`` raise for them.  A vlm or audio model's prefill takes
its modality extras in the batch (``image_embeds`` / ``audio_embeds``).
Caches are updated in place and returned.

Decode steps are the compiled part, as in the reference: a
``graphs.DecodeCell`` captures the decode step into a CUDA graph and
replays it (the counterpart of ``_decode_cells``).  ``generate`` builds one
cell after its prefill and releases it when it returns;
:meth:`Program.decode_cell` registers a cell for caches that live longer
(the scheduler's slot pool), and ``decode`` / ``decode_sample`` on those
caches go through it.  Prefill stays eager.

Greedy decoding matches the reference token for token on the test
configs; temperature sampling draws from a ``torch.Generator`` and is not
expected to reproduce ``jax.random``.

The Program keeps the reference's ledger on the default metrics registry:
``program.builds``, a ``program.bank.<k>`` gauge per ``bank_stats()`` key
and ``program.partition.dropped_rules`` (0: the port has no mesh) at each
build, and, while ``obs.metrics.enabled()``, one
``program.steps{kind=prefill|prefill_chunk|decode|decode_sample}`` per
step.  They are host-side Python outside any captured region, so a
replayed decode step counts as a step, exactly as an eager one does.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import backend as backend_lib
from repro_torch.core import noise as noise_lib
from repro_torch.core import prepared as prepared_lib
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.graphs import DecodeCell
from repro_torch.models import transformer as tfm
from repro_torch.obs import metrics as metrics_lib

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


def _short_conv(caches, S: int):
    """A prompt shorter than the conv tail (W-1 rows): the reference's
    prefill returns conv leaves of S rows, which its slot pool writes at
    rows 0..S-1 and its decode reads with clamped indices.  Narrow the conv
    leaves (views of the W-1-row buffers) to match."""
    if isinstance(caches, dict):
        return {k: (v.narrow(-2, 0, S) if k == "conv" else
                    _short_conv(v, S)) for k, v in caches.items()}
    return caches


def _as_tokens(tokens, device) -> torch.Tensor:
    """Token ids (array or tensor) as an int64 tensor on ``device``."""
    return torch.as_tensor(np.asarray(tokens) if not isinstance(
        tokens, torch.Tensor) else tokens).to(device, torch.long)


def _as_batch(batch, device) -> dict:
    """A forward batch on ``device``: the tokens as int64, any modality
    extras (arrays or tensors) as tensors."""
    out = {"tokens": _as_tokens(batch["tokens"], device)}
    for k, v in batch.items():
        if k != "tokens":
            out[k] = (v if isinstance(v, torch.Tensor)
                      else torch.as_tensor(np.asarray(v))).to(device)
    return out


def _device_of(params) -> torch.device:
    return params["embed"]["table"].device


def _no_mesh(act_pspec) -> None:
    if act_pspec is not None:
        raise NotImplementedError("act_pspec: the port has no mesh yet")


# =========================================================================
# functional steps over raw params (what the engine shims call)
# =========================================================================
def _prefill(cfg: ModelConfig, params, batch, cache_len: int, execution):
    """The prefill forward of ``batch`` (tokens plus any modality extras)
    into fresh caches on the params' device: (logits (B, S, V), caches)."""
    batch = _as_batch(batch, _device_of(params))
    B, S = batch["tokens"].shape
    caches = tfm.init_caches(cfg, B, cache_len,
                             dtype=torch_dtype(cfg.compute_dtype),
                             device=batch["tokens"].device)
    logits, caches, _ = tfm.forward(params, cfg, batch, mode="prefill",
                                    caches=caches, execution=execution)
    if cfg.ssm is not None and S < cfg.ssm.conv_width - 1:
        caches = _short_conv(caches, S)
    return logits, caches


def prefill_step_fn(cfg: ModelConfig, cache_len: int, *, act_pspec=None,
                    execution=None):
    """Pure ``fn(params, batch) -> (last_logits (B, V), caches)`` over raw
    params (no banks: a photonic backend quantizes each weight in the
    step); the caches are made on the params' device."""
    _no_mesh(act_pspec)

    @torch.no_grad()
    def fn(params, batch):
        logits, caches = _prefill(cfg, params, batch, cache_len, execution)
        return logits[:, -1, :], caches
    return fn


def decode_step_fn(cfg: ModelConfig, *, act_pspec=None, legacy_decode=False,
                   execution=None):
    """Pure ``fn(params, batch, caches, pos) -> (logits (B, V), caches)``;
    ``pos`` an int or (B,) positions.  The caches are updated in place.
    ``legacy_decode=True`` runs the baseline attention decode
    (``attention.gqa_decode_legacy``: the token's K/V written into the
    cache at a scalar ``pos`` inside the block, attention over the whole
    buffer)."""
    _no_mesh(act_pspec)

    @torch.no_grad()
    def fn(params, batch, caches, pos):
        dev = _device_of(params)
        tokens = _as_tokens(batch["tokens"], dev)
        if not isinstance(pos, int):
            pos = torch.as_tensor(pos).to(dev, torch.long)
        logits, caches, _ = tfm.forward(params, cfg, {"tokens": tokens},
                                        mode="decode", caches=caches,
                                        pos=pos, legacy_decode=legacy_decode,
                                        execution=execution)
        return logits[:, 0, :], caches
    return fn


def _count_step(kind: str) -> None:
    """One ``program.steps{kind=...}`` on the default registry, while the
    hot-path instrumentation is enabled."""
    if metrics_lib.enabled():
        metrics_lib.counter("program.steps", kind=kind).inc()


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
    # decode cells by id of the cache tree they own (the cell keeps the
    # tree alive, so the id is not reused while it is registered)
    _cells: Any = dataclasses.field(default_factory=weakref.WeakValueDictionary,
                                    repr=False, compare=False)

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
        # bank accounting as registry gauges (the last Program built wins:
        # builds are one-time events, not hot-path)
        reg = metrics_lib.default_registry()
        reg.counter("program.builds").inc()
        for k, v in prepared_lib.prepared_stats(bank).items():
            reg.gauge(f"program.bank.{k}").set(v)
        reg.gauge("program.partition.dropped_rules").set(0)
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
        return _as_tokens(tokens, self.device)

    def _dtype(self):
        return torch_dtype(self.cfg.compute_dtype)

    @torch.no_grad()
    def prefill(self, batch, cache_len: int, last=None):
        """Run prompts (``batch["tokens"]``, plus the modality extras of a
        vlm or audio model) into fresh caches.  ``last`` (B,) picks each
        row's last-prompt-token logits (default: the final column).  The lm
        head runs over every position first, as in the reference, so its
        A8 scale covers all prefill rows.  Returns (logits (B, V),
        caches)."""
        _count_step("prefill")
        logits, caches = _prefill(self.cfg, self.bank, batch, cache_len,
                                  self.backend)
        B, S = logits.shape[:2]
        if last is None:
            last = torch.full((B,), S - 1, dtype=torch.long)
        last = torch.as_tensor(last).to(self.device, torch.long)
        return logits[torch.arange(B, device=self.device), last], caches

    def _refuse_chunks(self, what: str) -> None:
        if not tfm.chunkable(self.cfg):
            raise ValueError(f"{what}: chunked prefill supports attention "
                             f"mixers only; {self.cfg.name} has SSM or "
                             f"cross-attention layers")

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
        self._refuse_chunks("prefill_chunk")
        _count_step("prefill_chunk")
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
        self._refuse_chunks("prefill_chunked")
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

    def decode_cell(self, caches) -> DecodeCell:
        """A decode cell over ``caches`` (leaves [R, T, B, ...]) registered
        with this Program: ``decode`` and ``decode_sample`` on these caches
        replay it.  It lives as long as the caller holds it."""
        cell = DecodeCell(self, caches)
        self._cells[id(caches)] = cell
        return cell

    def _decode_forward(self, backend, tokens, caches, pos):
        """``decode_step_fn`` on the banks under ``backend``: logits
        (B, V); the caches are updated in place."""
        return decode_step_fn(self.cfg, execution=backend)(
            self.bank, {"tokens": tokens}, caches, pos)[0]

    @torch.no_grad()
    def _decode_logits(self, tokens, caches, pos):
        """One decode step: through the caches' decode cell when they have
        one, else eagerly."""
        cell = self._cells.get(id(caches))
        if cell is not None and cell.caches is caches:
            return cell.step(tokens, pos).clone()
        return self._decode_forward(self.backend, tokens, caches, pos)

    def decode(self, tokens, caches, pos):
        """One token per sequence.  tokens: (B, 1); ``pos`` an int (aligned)
        or (B,) per-slot positions.  Caches are updated in place (through
        their decode cell, when they have one).  Returns (logits (B, V),
        caches)."""
        _count_step("decode")
        return self._decode_logits(tokens, caches, pos), caches

    def decode_sample(self, tokens, caches, pos, generator=None,
                      temperature: float = 0.0):
        """Decode + sample.  Returns (token_ids (B,), caches)."""
        if temperature > 0.0 and generator is None:
            raise ValueError("decode_sample(temperature>0) needs a "
                             "torch.Generator")
        _count_step("decode_sample")
        logits = self._decode_logits(tokens, caches, pos)
        return sample(logits, self.cfg.vocab_size, generator,
                      temperature), caches

    def generate(self, prompt, max_new: int, *, extras=None,
                 temperature: float = 0.0, seed: int = 0):
        """Autoregressive loop: prompt (B, S) -> (B, S + max_new) tokens;
        ``extras`` the modality inputs of a vlm or audio model (see
        ``transformer.forward``).  The decode steps run through one decode
        cell (every row at position S + i), released on return."""
        prompt = self._tokens(prompt)
        B, S = prompt.shape
        batch = {"tokens": prompt}
        if extras:
            batch.update(extras)
        logits, caches = self.prefill(batch, S + max_new)
        gen = None
        if temperature > 0.0:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        toks = [prompt]
        cur = sample(logits, self.cfg.vocab_size, gen,
                     temperature).long()[:, None]
        cell = DecodeCell(self, caches)
        try:
            for i in range(max_new):
                toks.append(cur)
                if i == max_new - 1:
                    break
                _count_step("decode_sample")
                nxt = sample(cell.step(cur, S + i), self.cfg.vocab_size,
                             gen, temperature)
                cur = nxt.long()[:, None]
        finally:
            cell.release()
        return torch.cat(toks, dim=1)
