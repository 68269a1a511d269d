"""Continuous-batching scheduler over the slot-level KV pool (port of
``repro.serve.scheduler``: ``ReuseAwareAdmission`` and
``ContinuousScheduler`` with monolithic and chunked admission).

The pool decodes every slot each step while new requests prefill into free
slots; each slot carries its own position and requests finish
independently.  Admission order decides which rows share a decode batch,
and the photonic A8 scale is per tensor over every row of a matmul, so the
admission policy, the prefill bucket padding, the chunk tail padding and
the idle/staging slots riding the decode batch with ``pad_id`` at position
0 all follow the reference exactly.

Bank residency (``residency=``, a ``resident.ProgramResidency``) and the
calibration loop (``calibration=``, a ``serve.calibration.CalibrationLoop``)
hook in as in the reference: every prefill and decode step looks each bank
up once, and a calibration sweep follows the residency hook of a decode
step.  ``telemetry=`` (an ``obs.serving.ServingObs``) carries the
request tracker (TTFT, TPOT, e2e and queue histograms), the Chrome-trace
spans (``prefill_chunk``, ``decode_step``, the ``active_slots`` counter
track) and the photonic meter, fed by every prefill and decode step and
bound to the residency when both are given; the stats share its registry.
``on_token(rid, tok)`` and ``on_complete(completion)`` stream results as
they land.  All of it runs on the host between device steps: nothing of it
enters the decode graph, and it adds no device synchronization.

A Program built with ``mesh=`` makes serving data-parallel: the scheduler
inherits the Program's mesh (and refuses another one), the slot pool's
batch axis spans the mesh's data shards (capacity must divide; each rank
holds its shard block's caches) and admission packs per-shard
sub-batches.  Every rank runs this same host loop on the same requests;
each decode step runs the rank's rows and gathers the sampled tokens over
"data", so every rank's scheduler sees every slot.  Chunked admission is
off on an active mesh, as in the reference.

The decode step runs through one ``graphs.DecodeCell`` over the pool's
caches, built once at the pool's capacity and registered with the
Program: on the card every step after the first replays its CUDA graph
(the pool's caches are updated in place, so one capture serves the whole
life of the scheduler).  Sampling, the read-back of the next tokens and
this loop stay on the host.  Both schedulers implement the ``Scheduler``
protocol: ``submit`` requests, ``drain`` completions.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
from typing import Callable, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch import api
from repro_torch.configs.base import ModelConfig
from repro_torch.core import costmodel
from repro_torch.core.prm import ReusePlan
from repro_torch.models import transformer as tfm
from repro_torch.obs.stats import ContinuousStats
from repro_torch.serve.batcher import Completion, Request
from repro_torch.serve.slots import SlotPool, SlotState


@runtime_checkable
class Scheduler(Protocol):
    """What serving front ends program against (``ContinuousScheduler`` and
    ``WaveBatcher``)."""

    def submit(self, req: Request) -> None: ...

    def drain(self) -> list[Completion]: ...


# =========================================================================
# reuse-aware admission
# =========================================================================
@dataclasses.dataclass(frozen=True)
class ReuseAwareAdmission:
    """Cost-model-driven admission policy (R&B amortization at request
    level).  ``min_population`` is the smallest active population whose
    write energy is amortized to ``target_efficiency``; below it every
    queued request that fits is admitted, at or above it at most
    ``max_admit_per_step`` per step."""

    min_population: int
    max_admit_per_step: int = 1

    @staticmethod
    def build(cfg: ModelConfig, *, tile: int = 256,
              target_efficiency: float = 0.9, refresh_steps: int = 8,
              mats_per_block: int = 6, max_admit_per_step: int = 1
              ) -> "ReuseAwareAdmission":
        R, depth = 0, 0
        for spec in tfm.build_segments(cfg):
            if spec.stream == "encoder":
                continue
            plan = ReusePlan.build(spec.num_groups, spec.reuse)
            R += plan.num_physical
            depth += spec.depth
        d = cfg.d_model
        _, e_write = costmodel.CALIBRATED.write_cost(d, d, tile)
        _, e_comp = costmodel.CALIBRATED.compute_cost(d, d, tile)
        ratio = target_efficiency / max(1.0 - target_efficiency, 1e-9)
        min_pop = math.ceil(ratio * R * mats_per_block * e_write
                            / (depth * e_comp * refresh_steps))
        return ReuseAwareAdmission(min_population=max(1, min_pop),
                                   max_admit_per_step=max_admit_per_step)

    def admit_count(self, *, queued: int, free: int, active: int) -> int:
        if queued == 0 or free == 0:
            return 0
        if active < self.min_population:
            return min(queued, free)
        return min(queued, free, self.max_admit_per_step)


# =========================================================================
# continuous scheduler
# =========================================================================
class ContinuousScheduler:
    """Slot-level continuous batching over a shared [R, T, B, L, ...] pool,
    serving from a :class:`repro_torch.api.Program`.  Greedy outputs are
    token-identical to the reference scheduler on the same trace."""

    def __init__(self, program: api.Program, *, capacity: int = 8,
                 max_len: int = 256, pad_id: int = 0,
                 temperature: float = 0.0, seed: int = 0,
                 prefill_bucket: int = 16,
                 prefill_chunk: Optional[int] = None,
                 admission: Optional[ReuseAwareAdmission] = None,
                 on_token: Optional[Callable[[int, int], None]] = None,
                 on_complete: Optional[Callable[[Completion], None]] = None,
                 telemetry=None, residency=None, calibration=None,
                 mesh=None):
        if not isinstance(program, api.Program):
            raise TypeError("ContinuousScheduler serves a built Program")
        if mesh is not None and mesh != program.mesh:
            # a pool placed on a mesh the Program does not run on would
            # feed a rank's block of caches into unsharded steps
            raise ValueError(
                "mesh= conflicts with the Program's execution mesh; build "
                "it with Program.build(..., mesh=mesh)")
        self.program = program
        self.mesh = program.mesh
        cfg = program.cfg
        self.cfg = cfg
        self.pad_id = pad_id
        self.temperature = temperature
        self.prefill_bucket = max(1, prefill_bucket)
        # global bank residency: resident hits are free passes, misses and
        # evictions are priced writes.  Accounting only: served tokens are
        # identical with it on or off
        self.residency = residency
        # drift detection & repair: its on_step runs after the residency
        # hook of each decode step, at the ages that step's accesses made
        self.calibration = calibration
        if admission is None and residency is not None:
            from repro_torch.resident.cosched import ResidencyAwareAdmission
            admission = ResidencyAwareAdmission.from_base(
                ReuseAwareAdmission.build(cfg), residency)
        self.admission = admission or ReuseAwareAdmission.build(cfg)
        self.on_token = on_token
        self.on_complete = on_complete
        self.pool = SlotPool(cfg, capacity, max_len, device=program.device,
                             mesh=self.mesh)
        # the compiled decode step over the pool, kept for its life
        self.decode_cell = program.decode_cell(self.pool.caches)
        # Right padding is causally invisible to attention (masked by the
        # slot position) but NOT to recurrent state: SSM ``h`` and the conv
        # tail integrate every input token.  Stacks with SSM layers prefill
        # at the exact prompt length.  Chunked admission is for stacks of
        # self-attention only (``prefill_chunk`` is ignored otherwise: a
        # cross-attention memory is not chunk-resumable either), and never
        # for a request with modality extras.
        self._exact_prefill = tfm.has_ssm(cfg)
        self.prefill_chunk = prefill_chunk
        self._chunkable = (prefill_chunk is not None and tfm.chunkable(cfg)
                           and not program.backend.mesh_active)
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        # slot -> in-progress chunked prefill (staging cache at pool
        # max_len, padded prompt, next chunk offset); such slots are
        # allocated but not decoded until their last chunk lands
        self._prefilling: dict[int, dict] = {}
        self.queue: collections.deque[Request] = collections.deque()
        # telemetry: latency histograms, Chrome-trace spans and the
        # photonic meter; the stats counters share its registry so one
        # snapshot carries everything
        self.obs = telemetry
        if (self.residency is not None and self.obs is not None
                and self.obs.meter is not None):
            # resident hits must never be billed again as refresh writes
            self.residency.bind_meter(self.obs.meter)
        self.stats = ContinuousStats(
            registry=telemetry.registry if telemetry else None,
            _capacity=capacity)
        self.generator = None
        if temperature > 0.0:
            self.generator = torch.Generator(
                device=program.device).manual_seed(seed)
        # current (unprocessed) token per slot, fed to the next decode step
        self._cur = np.full((capacity, 1), pad_id, np.int32)

    # ------------------------------------------------------------ interface
    def submit(self, req: Request) -> None:
        plen = len(req.prompt)
        if plen + req.max_new > self.pool.max_len:
            raise ValueError(
                f"request {req.rid}: prompt {plen} + max_new {req.max_new} "
                f"exceeds slot budget {self.pool.max_len}")
        if req.max_new < 1:
            raise ValueError("max_new must be >= 1")
        self.queue.append(req)
        if self.obs:
            self.obs.tracker.on_submit(req.rid)

    def drain(self) -> list[Completion]:
        """Run until queue and slots are empty; completions in finish order."""
        done: list[Completion] = []
        while self.queue or self.pool.num_active:
            done.extend(self.step())
        return done

    def step(self) -> list[Completion]:
        """Admit (policy-bounded) new requests, advance one prefill chunk
        per staging slot, then decode one token for every in-flight slot."""
        done: list[Completion] = []
        n = self.admission.admit_count(queued=len(self.queue),
                                       free=self.pool.num_free,
                                       active=self.pool.num_active)
        for _ in range(n):
            comp = self._admit_one(self.queue.popleft())
            if comp is not None:
                done.append(comp)
        if self._prefilling:
            done.extend(self._advance_chunks())
        if self.pool.num_active > len(self._prefilling):
            done.extend(self._decode_once())
        if self.obs and self.obs.tracer.enabled:
            self.obs.tracer.counter("active_slots", self.pool.num_active)
        return done

    # ------------------------------------------------------------ internals
    def _span(self, name: str, **args):
        tr = self.obs.tracer if self.obs else None
        if tr is not None and tr.enabled:
            return tr.span(name, **args)
        return contextlib.nullcontext()

    def _admitted(self, req: Request, padded: int) -> None:
        """Account an admission whose prefill (monolithic or chunked)
        streams ``padded`` positions through the stack: the tracker, the
        meter, the residency lookups and the stats counters."""
        plen = len(req.prompt)
        if self.obs:
            self.obs.tracker.on_admit(req.rid, plen, padded)
            if self.obs.meter is not None:
                self.obs.meter.on_prefill(padded)
        if self.residency is not None:
            self.residency.on_prefill(padded)
        st = self.stats
        st.requests += 1
        st.prefills += 1
        st.prompt_tokens += plen
        st.padded_prefill_tokens += padded - plen
        st.slot_steps += padded
        st.useful_steps += plen

    def _sample(self, logits) -> int:
        return int(api.sample(logits, self.cfg.vocab_size, self.generator,
                              self.temperature)[0])

    def _bucket(self, plen: int) -> int:
        if self._exact_prefill:
            return plen
        b = self.prefill_bucket
        return min(-(-plen // b) * b, self.pool.max_len)

    def _admit_one(self, req: Request) -> Optional[Completion]:
        plen = len(req.prompt)
        if self._chunkable and not req.extras and plen > self.prefill_chunk:
            self._start_chunked(req)
            return None
        bucket = self._bucket(plen)
        state = SlotState(rid=req.rid, prompt_len=plen, max_new=req.max_new,
                          eos_id=req.eos_id,
                          prompt=np.asarray(req.prompt, np.int32),
                          padded_to=bucket)
        slot = self.pool.allocate(state)
        self._admitted(req, bucket)
        toks = np.full((1, bucket), self.pad_id, np.int32)
        toks[0, :plen] = req.prompt
        batch = {"tokens": toks}
        if req.extras:
            batch.update(req.extras)
        logits, caches = self.program.prefill(batch, bucket, last=[plen - 1])
        self.pool.write_prefill(slot, caches, plen)
        tok = self._sample(logits)
        self._cur[slot, 0] = tok
        return self._commit_token(slot, tok)

    def _start_chunked(self, req: Request) -> None:
        """Allocate a slot and stage a chunked prefill: ``prefill_chunk``-
        wide pieces (tail padded with ``pad_id``), one per step, into a
        batch-1 staging cache at the pool's max_len."""
        W = self.prefill_chunk
        plen = len(req.prompt)
        padded = -(-plen // W) * W
        state = SlotState(rid=req.rid, prompt_len=plen, max_new=req.max_new,
                          eos_id=req.eos_id,
                          prompt=np.asarray(req.prompt, np.int32),
                          padded_to=padded)
        slot = self.pool.allocate(state)
        self._admitted(req, padded)
        toks = np.full((1, padded), self.pad_id, np.int32)
        toks[0, :plen] = req.prompt
        self._prefilling[slot] = {
            "state": state, "tokens": toks, "off": 0,
            "caches": self.program.empty_caches(1, self.pool.max_len)}

    def _advance_chunks(self) -> list[Completion]:
        """One prefill chunk for every staging slot; final chunks publish
        the staged cache into the pool and sample the first token."""
        done: list[Completion] = []
        W = self.prefill_chunk
        for slot in sorted(self._prefilling):
            st = self._prefilling[slot]
            state, off = st["state"], st["off"]
            last = off + W >= st["tokens"].shape[1]
            idx = state.prompt_len - 1 - off if last else W - 1
            # no read-back inside: on the card this span is the chunk's
            # host dispatch (obs/tracing.py)
            with self._span("prefill_chunk", rid=state.rid, off=off):
                logits, st["caches"] = self.program.prefill_chunk(
                    st["tokens"][:, off:off + W], st["caches"], off,
                    last=[idx])
            st["off"] = off + W
            self.stats.prefill_chunks += 1
            if not last:
                continue
            del self._prefilling[slot]
            self.pool.write_prefill(slot, st["caches"], state.prompt_len)
            tok = self._sample(logits)
            self._cur[slot, 0] = tok
            comp = self._commit_token(slot, tok)
            if comp is not None:
                done.append(comp)
        return done

    def _commit_token(self, slot: int, tok: int) -> Optional[Completion]:
        """Record one generated token; complete/free the slot if done."""
        state = self.pool.slots[slot]
        state.tokens.append(tok)
        state.generated += 1
        self.stats.generated_tokens += 1
        if self.obs:
            # the first token comes out of prefill (TTFT); later ones are
            # decode inter-arrivals (TPOT)
            if state.generated == 1:
                self.obs.tracker.on_first_token(state.rid)
            else:
                self.obs.tracker.on_token(state.rid)
        if self.on_token is not None:
            self.on_token(state.rid, tok)
        hit_eos = state.eos_id is not None and tok == state.eos_id
        if state.generated >= state.max_new or hit_eos:
            self.pool.free(slot)
            self._cur[slot, 0] = self.pad_id
            comp = Completion(
                rid=state.rid,
                tokens=np.concatenate([state.prompt,
                                       np.asarray(state.tokens, np.int32)]),
                prompt_len=state.prompt_len, padded_to=state.padded_to,
                finish_reason="eos" if hit_eos else "length")
            if self.obs:
                self.obs.tracker.on_finish(state.rid, comp.finish_reason)
            if self.on_complete is not None:
                self.on_complete(comp)
            return comp
        return None

    def _decode_once(self) -> list[Completion]:
        # staging (chunk-prefilling) and idle slots ride the full-pool step
        # with pad_id at their position (0 for staging slots): their delta
        # write is dead data and they commit no tokens
        active = [s for s in self.pool.active_slots()
                  if s not in self._prefilling]
        self.stats.observe_active(len(active))
        if self.obs and self.obs.meter is not None:
            # the decode step runs the FULL pool through the stack; idle
            # slots ride along (the occupancy histogram exposes the waste)
            self.obs.meter.on_decode_step(self.pool.capacity)
        if self.residency is not None:
            self.residency.on_decode_step(self.pool.capacity)
        if self.calibration is not None:
            self.calibration.on_step()
        # the span closes after the tokens' read-back, so on the card it
        # covers the step's device time, not the enqueue of a replay
        with self._span("decode_step", active=len(active),
                        capacity=self.pool.capacity):
            nxt, self.pool.caches = self.program.decode_sample(
                self._cur, self.pool.caches, self.pool.position_vector(),
                generator=self.generator, temperature=self.temperature)
            nxt = nxt.cpu().numpy()
        self.stats.decode_steps += 1
        self.stats.slot_steps += self.pool.capacity
        self.stats.idle_slot_steps += self.pool.capacity - len(active)
        done = []
        for slot in active:
            self.pool.advance(slot)
            self.stats.useful_steps += 1
            comp = self._commit_token(slot, int(nxt[slot]))
            if comp is None:
                self._cur[slot, 0] = int(nxt[slot])
            else:
                done.append(comp)
        return done
