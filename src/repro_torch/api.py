"""Program API — the public entry point for inference (port of
``repro.api``).

    prog = Program.build(cfg, params)            # prepare banks ONCE
    logits, caches = prog.prefill(batch, cache_len)
    tok, caches = prog.decode_sample(tokens, caches, pos)
    out = prog.generate(prompt, max_new=32)
    ce, aux = prog.loss(batch)                  # held-out eval

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

**On a mesh** (``Program.build(mesh=...)``, on each rank that
``launch.mesh.init_ranks`` started): the methods take the whole batch, as
the reference's take global arrays, and every rank passes the same one.  A
step whose B rows divide over the data axes runs on this rank's shard of
them (``rows_sharded``), else on all of them; its logits, or sampled
tokens, are all-gathered over "data", so every rank returns the whole
batch's; its caches hold the rank's rows.  The dots run sharded over
"model" (``core/backend.py``); the rank holds its piece of each bank.
With ``cfg.fsdp`` the rank's pieces are also cut over the data axes on
their "embed" dim (the reference's ``bank_shardings(..., fsdp=True)``): a
dot all-gathers its bank's fields over them at each use, and the float
leaves so cut (norms, router, biases; every leaf on xla) are gathered
where the model stack uses them, each block of a stack before its reuses
and freed after (``Backend.fsdp``, ``sharding/fsdp.py``); the embedding
is looked up by its columns, its rows gathered.  ``loss`` runs each
data rank's rows (the train cell's ``_mesh_act_pspec``), sums CE's
numerator and denominator over the data axes and returns the unsharded
CE and aux on every rank.  Decode steps run eagerly
(``graphs.MESH_RULE``).  A 1x1 mesh is the unsharded path.  A rank's caches are its piece of the whole caches under
``partition.cache_pspecs`` (made at that shape, ``tfm.init_caches(...,
mesh=)``): KV heads over "model" where they divide, else the positions;
MLA latents over the positions; SSM states over their heads and conv tails
over their channels where "model" divides them.  Each serving step carries
that layout (``Backend.kv``, ``Backend.ssm``), so attention runs on the
rank's own heads or positions (``models/attention.py``) and an SSM layer
on its own heads and channels (``models/ssm.py``).  The functional
prefill (``prefill_step_fn``) also takes the reference's "seq" and
"hidden" residual specs: the rank holds its block of the positions or the
channels between the layers (``partition.ResidualLayout``,
``models/transformer.py``); the Program's own steps hold whole rows.

The Program keeps the reference's ledger on the default metrics registry:
``program.builds``, a ``program.bank.<k>`` gauge per ``bank_stats()`` key
and ``program.partition.dropped_rules`` (the rules the mesh's partition
report dropped; 0 without a mesh) at each build, and, while
``obs.metrics.enabled()``, one
``program.steps{kind=prefill|prefill_chunk|decode|decode_sample}`` per
step.  They are host-side Python outside any captured region, so a
replayed decode step counts as a step, exactly as an eager one does.
"""
from __future__ import annotations

import dataclasses
import warnings
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
from repro_torch.sharding import collectives as coll
from repro_torch.sharding import fsdp as fsdp_lib
from repro_torch.sharding import partition
from repro_torch.train.trainer import ce_terms

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


# =========================================================================
# mesh plumbing (the reference's, as placement rules of the ranks)
# =========================================================================
def _backend_mesh(backend):
    """The backend's mesh when it partitions (more than one position)."""
    bk = backend_lib.resolve(backend)
    return bk.mesh if bk.mesh_active else None


def _row_split(backend, B: int):
    """This rank's rows of a B-row step: a slice when the rows divide over
    the data axes of an active mesh, else None (every rank runs all
    rows)."""
    mesh = _backend_mesh(backend)
    if mesh is None:
        return None
    d_axes = partition.data_axes(mesh)
    dp = partition.dp_size(mesh)
    if dp <= 1 or B % dp != 0:
        return None
    n = B // dp
    i = mesh.index(d_axes)
    return slice(i * n, (i + 1) * n)


def _mesh_act_pspec(backend, B: int):
    """The train/loss cell's residual spec (batch over data, replicated
    d_model); None when the batch does not divide the data axes."""
    mesh = _backend_mesh(backend)
    if mesh is None:
        return None
    dp = partition.dp_size(mesh)
    if dp <= 1 or B % dp != 0:
        return None
    return partition.act_pspec(mesh, "replicated")


def _serve_act_pspec(backend, B: int):
    """The serving steps' residual spec: batch over data (when it divides)
    and replicated over "model", as every rank holds its rows outside the
    dots.  Unlike the train cell's it also applies on pure-TP meshes
    (dp == 1); None off-mesh and on a 1x1 mesh."""
    mesh = _backend_mesh(backend)
    if mesh is None:
        return None
    dp = partition.dp_size(mesh)
    if dp > 1 and B % dp != 0:
        return None
    return partition.act_pspec(mesh, "replicated")


def _cache_leaves(tree, name=None):
    """(leaf name, tensor) of every leaf of a cache tree, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _cache_leaves(v, k)
    elif tree is not None:
        yield name, tree


def _cache_geometry(caches):
    """(whole batch, whole length) of a rank's placed caches, read from the
    first leaf with positions (self-attention K, MLA latents) in its record
    (``partition.piece_of``; the length None where the model has none, as
    mamba2), or None for caches made whole."""
    rows = None
    for name, leaf in _cache_leaves(caches):
        rec = partition.piece_of(leaf)
        if rec is None:
            continue
        if name in ("k", "ckv"):
            return rec[1][2], rec[1][3]
        rows = rows if rows is not None else rec[1][2]
    return None if rows is None else (rows, None)


def _with_kv(backend, cfg: ModelConfig, B: int, L):
    """``backend`` carrying the layout of ``cfg``'s caches for a B-row step
    over ``L`` positions on an active mesh: ``kv`` (``partition.KVLayout``:
    attention heads or positions, MLA latent positions; None without a
    length) and ``ssm`` (``partition.SSMLayout``: SSM heads and conv
    channels, for a model with SSM layers); else ``backend``."""
    mesh = _backend_mesh(backend)
    if mesh is None:
        return backend
    kv = None if L is None else partition.kv_layout(cfg, mesh, B, L)
    ssm = None if cfg.ssm is None else partition.ssm_layout(cfg, mesh)
    if kv is None and ssm is None:
        return backend
    return dataclasses.replace(backend, kv=kv, ssm=ssm)


def _kv_of(backend, cfg: ModelConfig, caches):
    """:func:`_with_kv` for the layout recorded on a rank's caches."""
    geo = _cache_geometry(caches)
    return backend if geo is None else _with_kv(backend, cfg, *geo)


def _constrain_caches(caches, cfg: ModelConfig, backend, B: int, L):
    """The cache placement of a B-row step over ``L`` positions (None: the
    length recorded on the caches): every leaf of a rank's caches must be
    its piece under ``partition.cache_pspecs`` (batch over the data axes;
    KV heads over "model" where they divide, else the positions; MLA
    latents by their positions; SSM states by their heads and conv tails by
    their channels where "model" divides them).  A conv tail may hold fewer
    rows than W-1 (a prompt shorter than that).  Raises when a leaf holds
    other rows, heads, channels or positions than its piece.  No-op
    off-mesh and on a 1x1 mesh."""
    mesh = _backend_mesh(backend)
    if mesh is None:
        return caches
    if L is None:
        geo = _cache_geometry(caches)
        L = geo[1] if geo is not None and geo[1] is not None else 1
    want = tfm.init_caches(cfg, B, L, device="meta", mesh=mesh)
    for (name, got), (_, ref) in zip(_cache_leaves(caches),
                                     _cache_leaves(want)):
        g, r = tuple(got.shape), tuple(ref.shape)
        if name == "conv" and len(g) == len(r) and g[3] <= r[3]:
            g = g[:3] + g[4:]
            r = r[:3] + r[4:]
        if g != r:
            raise ValueError(
                f"cache leaf {name!r} {tuple(got.shape)} on a rank whose "
                f"piece of a {B}-row step over {L} positions is "
                f"{tuple(ref.shape)} (rows, heads, channels, positions: "
                f"partition.cache_pspecs)")
    return caches


def _check_act_pspec(execution, act_pspec) -> None:
    """A step function's ``act_pspec`` needs an execution backend with an
    active mesh (the spec places rows on its data axes)."""
    if act_pspec is not None and _backend_mesh(execution) is None:
        raise ValueError("act_pspec needs an execution Backend with an "
                         "active mesh")


def _act_pspec_of(backend, B: int, mode: str):
    """The residual spec of a B-row step in ``mode`` ("seq" / "hidden") on
    ``backend``'s mesh, as the reference's dry-run gives it: the batch over
    the data axes, or, when B does not divide them, ``(None, "model",
    None)`` / ``(None, None, "model")`` (every rank holds every row)."""
    mesh = _backend_mesh(backend)
    dp = partition.dp_size(mesh)
    if dp > 1 and B % dp != 0:
        return (None, "model", None) if mode == "seq" else \
            (None, None, "model")
    return partition.act_pspec(mesh, mode)


def _step_rows(backend, B: int, act_pspec, length=None, width=None):
    """(row slice or None, backend for the step) of a functional step
    (after :func:`_check_act_pspec`).  ``act_pspec`` is None, the serving
    spec (the rank's rows, replicated over "model") or the "seq" /
    "hidden" spec of :func:`_act_pspec_of`: then a step over ``length``
    positions of ``width`` channels (a prefill; None: a decode step, whose
    one position keeps the residual whole) carries its
    ``partition.ResidualLayout``."""
    bk = backend_lib.resolve(backend)
    if act_pspec is None:
        return None, bk
    mode = partition.residual_mode(act_pspec)
    want = (_serve_act_pspec(bk, B) if mode == "replicated"
            else _act_pspec_of(bk, B, mode))
    if tuple(act_pspec) != tuple(want):
        raise NotImplementedError(
            f"act_pspec {tuple(act_pspec)}: a {B}-row step on this mesh "
            f"places its residual as {tuple(want)} in {mode!r} mode")
    sl = _row_split(bk, B)
    if sl is not None:
        bk = dataclasses.replace(bk, rows_sharded=True)
    if mode != "replicated" and length is not None:
        bk = dataclasses.replace(bk, residual=partition.residual_layout(
            act_pspec, bk.mesh, length, width))
    return sl, bk


def _rows_of(batch: dict, sl, B: int) -> dict:
    """The rows ``sl`` of a batch (an extra of one row serves every row and
    is kept whole)."""
    if sl is None:
        return batch
    return {k: (v[sl] if v.shape[0] == B else v) for k, v in batch.items()}


def _gather_rows(t, backend, sl):
    """The whole batch of a per-row output: ``t`` (this rank's rows)
    all-gathered over the data axes when the rows were split."""
    if sl is None:
        return t
    mesh = backend.mesh
    return coll.all_gather(t, mesh, partition.data_axes(mesh), dim=0)


# =========================================================================
# functional steps over raw params (what the engine shims call)
# =========================================================================
def _prefill(cfg: ModelConfig, params, batch, cache_len: int, execution,
             whole_batch: int):
    """The prefill forward of ``batch`` (tokens plus any modality extras:
    this rank's rows of a ``whole_batch``-row step) into fresh caches on
    the params' device, on an active mesh the rank's pieces:
    (logits (B, S, V), caches)."""
    batch = _as_batch(batch, _device_of(params))
    B, S = batch["tokens"].shape
    bk = backend_lib.resolve(execution)
    mesh = _backend_mesh(bk)
    caches = tfm.init_caches(cfg, B if mesh is None else whole_batch,
                             cache_len, dtype=torch_dtype(cfg.compute_dtype),
                             device=batch["tokens"].device, mesh=mesh)
    logits, caches, _ = tfm.forward(
        params, cfg, batch, mode="prefill", caches=caches,
        execution=_with_kv(bk, cfg, whole_batch, cache_len))
    if cfg.ssm is not None and S < cfg.ssm.conv_width - 1:
        caches = _short_conv(caches, S)
    return logits, caches


def prefill_step_fn(cfg: ModelConfig, cache_len: int, *, act_pspec=None,
                    execution=None):
    """Pure ``fn(params, batch) -> (last_logits (B, V), caches)`` over raw
    params (no banks: a photonic backend quantizes each weight in the
    step); the caches are made on the params' device.  With ``act_pspec``
    (the serving spec of ``execution``'s mesh, or its "seq" / "hidden"
    spec, ``_act_pspec_of``) the step runs on this rank's rows, with its
    residual cut over "model" as the spec says, and returns their
    logits."""
    _check_act_pspec(execution, act_pspec)

    @torch.no_grad()
    def fn(params, batch):
        batch = _as_batch(batch, _device_of(params))
        B = batch["tokens"].shape[0]
        sl, bk = _step_rows(execution if execution is not None else cfg,
                            B, act_pspec, batch["tokens"].shape[1],
                            cfg.d_model)
        logits, caches = _prefill(cfg, params, _rows_of(batch, sl, B),
                                  cache_len, bk, B)
        return logits[:, -1, :], caches
    return fn


def decode_step_fn(cfg: ModelConfig, *, act_pspec=None, legacy_decode=False,
                   execution=None):
    """Pure ``fn(params, batch, caches, pos) -> (logits (B, V), caches)``;
    ``pos`` an int or (B,) positions.  The caches are updated in place.
    ``legacy_decode=True`` runs the baseline attention decode
    (``attention.gqa_decode_legacy``: the token's K/V written into the
    cache at a scalar ``pos`` inside the block, attention over the whole
    buffer).  With ``act_pspec`` (the serving spec of ``execution``'s
    mesh, or its "seq" / "hidden" spec: the one position keeps the
    residual whole) the step runs on this rank's rows of the tokens and
    positions, with the rank's caches, and returns its rows' logits."""
    _check_act_pspec(execution, act_pspec)

    @torch.no_grad()
    def fn(params, batch, caches, pos):
        dev = _device_of(params)
        tokens = _as_tokens(batch["tokens"], dev)
        sl, bk = (None, execution) if act_pspec is None else _step_rows(
            execution, tokens.shape[0], act_pspec)
        if not isinstance(pos, int):
            pos = torch.as_tensor(np.asarray(pos) if not isinstance(
                pos, torch.Tensor) else pos).to(dev, torch.long)
            if sl is not None:
                pos = pos[sl]
        if sl is not None:
            tokens = tokens[sl]
        logits, caches, _ = tfm.forward(params, cfg, {"tokens": tokens},
                                        mode="decode", caches=caches,
                                        pos=pos, legacy_decode=legacy_decode,
                                        execution=_kv_of(bk, cfg, caches))
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
    # the whole bank's accounting (a mesh rank holds pieces of it)
    _stats: Any = dataclasses.field(default=None, repr=False, compare=False)

    @classmethod
    def build(cls, cfg: ModelConfig, params, *, execution=None,
              device=None, mesh=None) -> "Program":
        """Resolve the substrate, move ``params`` (nested dict of tensors,
        the reference's keys) to ``device`` and prepare the banks once.
        ``device`` defaults to CUDA (on a mesh rank, the rank's device) and
        raises when no CUDA device exists; pass ``device="cpu"`` for the
        plain CPU path.

        ``mesh`` (a ``launch.mesh.Mesh``; on more than one position, the
        rank's bound mesh from ``launch.mesh.init_ranks``) makes the mesh a
        property of execution: the partition rules resolve the bank's
        specs, the rank keeps its piece of every bank, and the dots run
        sharded (``core/backend.py``).  ``None`` and a 1x1 mesh are the
        unsharded path.  Rules that do not divide a concrete dim are
        replicated, not an error: surfaced here as a one-line warning.
        ``cfg.fsdp`` on an active mesh also cuts each bank's "embed" dim
        over the data axes, and the backend then carries the float leaves'
        data-axes specs (``Backend.fsdp``: each step gathers them where
        they are used; module docstring)."""
        bk = backend_lib.resolve(execution if execution is not None else cfg)
        if mesh is not None and bk.mesh is not None and bk.mesh != mesh:
            raise ValueError(
                "Program.build(mesh=...) conflicts with the mesh the "
                "execution Backend already carries — pass one or the other")
        if mesh is not None and bk.mesh is None:
            bk = dataclasses.replace(bk, mesh=mesh)
        mesh = bk.mesh
        if bk.mesh_active:
            if not mesh.bound:
                raise ValueError(
                    f"a {dict(mesh.shape)} mesh runs as {mesh.size} ranks: "
                    f"start them with launch.mesh.init_ranks and build the "
                    f"Program on each rank's mesh")
            if device is None:
                device = mesh.device
        dev = resolve_device(device)
        moved = prepared_lib.map_with_path(
            lambda _p, leaf: leaf.to(dev) if isinstance(leaf, torch.Tensor)
            else leaf, params)
        bank = prepared_lib.prepare_params(moved, cfg.compute_dtype,
                                           bk.is_photonic)
        del moved
        stats = prepared_lib.prepared_stats(bank)
        dropped = 0
        if mesh is not None:
            report = partition.PartitionReport(dropped=[])
            specs = partition.model_specs(bank)
            partition.bank_shardings(bank, specs, mesh, cfg.fsdp, report)
            if bk.mesh_active:
                if cfg.fsdp:
                    fp_specs = partition.bank_data_specs(bank, specs, mesh,
                                                         True)
                    if any(prepared_lib.tree_leaves(fp_specs)):
                        bk = dataclasses.replace(
                            bk, fsdp=fsdp_lib.Layout(fp_specs, mesh))
                bank = partition.place_bank(bank, specs, mesh, cfg.fsdp)
            dropped = len(report.dropped)
            if report.dropped:
                warnings.warn(partition.dropped_summary(report),
                              stacklevel=2)
        # bank accounting as registry gauges (the last Program built wins:
        # builds are one-time events, not hot-path)
        reg = metrics_lib.default_registry()
        reg.counter("program.builds").inc()
        for k, v in stats.items():
            reg.gauge(f"program.bank.{k}").set(v)
        reg.gauge("program.partition.dropped_rules").set(dropped)
        return cls(cfg=cfg, backend=bk, bank=bank, device=dev, _stats=stats)

    @property
    def mesh(self):
        """The execution mesh (None: unsharded single-device semantics)."""
        return self.backend.mesh

    def update_noise(self, noise) -> None:
        """Swap the fault-model config on the live Program (in place): the
        calibration loop's republish step.  The banks and caches stay;
        the device gain cache of the old config is dropped.  The backend's
        checks re-run: noise with a multi-position mesh raises."""
        self.backend = dataclasses.replace(self.backend, noise=noise)
        noise_lib.clear_gain_cache()

    # -------------------------------------------------------------- stats
    def bank_stats(self) -> dict:
        """The bank's accounting (the whole bank's, on a mesh rank too)."""
        if self._stats is not None:
            return dict(self._stats)
        return prepared_lib.prepared_stats(self.bank)

    def verify_banks(self) -> float:
        """Max W0 checksum error across all programmed banks (~0 for
        uncorrupted banks; 0.0 for a pure-fp xla bank).  On a mesh rank the
        banks' pieces are gathered whole for the check (every rank of the
        mesh calls it)."""
        errs = []
        for leaf in prepared_lib.tree_leaves(self.bank):
            if not isinstance(leaf, prepared_lib.PreparedTensor):
                continue
            if leaf.placement is not None:
                leaf = prepared_lib.PreparedTensor(
                    *(self.backend._whole(leaf, f)
                      for f in prepared_lib.FIELDS), tag=leaf.tag)
            errs.append(prepared_lib.verify_bank(leaf))
        return max(errs, default=0.0)

    # --------------------------------------------------------- mesh rows
    def _rows(self, B: int):
        """(this rank's row slice or None, the step's backend) for a
        B-row step."""
        sl = _row_split(self.backend, B)
        if sl is None:
            return None, self.backend
        return sl, dataclasses.replace(self.backend, rows_sharded=True)

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
        batch = _as_batch(batch, self.device)
        B, S = batch["tokens"].shape
        sl, bk = self._rows(B)
        logits, caches = _prefill(self.cfg, self.bank,
                                  _rows_of(batch, sl, B), cache_len, bk, B)
        if last is None:
            last = torch.full((B,), S - 1, dtype=torch.long)
        last = torch.as_tensor(last).to(self.device, torch.long)
        if sl is not None:
            last = last[sl]
        caches = _constrain_caches(caches, self.cfg, bk, B, cache_len)
        rows = torch.arange(logits.shape[0], device=self.device)
        return _gather_rows(logits[rows, last], bk, sl), caches

    @torch.no_grad()
    def loss(self, batch):
        """Mean next-token cross-entropy of ``batch`` (eval; no gradients)
        through the prepared banks on the Program's backend.  Returns (ce,
        aux) 0-d float32 tensors.  On an active mesh every rank passes the
        whole batch; a batch whose rows divide over the data axes runs on
        this rank's rows (``_mesh_act_pspec``), CE's numerator and
        denominator summed over the data axes, and every rank returns the
        unsharded CE and aux."""
        batch = _as_batch(batch, self.device)
        B = batch["tokens"].shape[0]
        sl, bk = self._rows(B)
        rows = _rows_of(batch, sl, B)
        logits, _, aux = tfm.forward(self.bank, self.cfg, rows,
                                     mode="train", execution=bk)
        num, den = ce_terms(logits[:, :-1], rows["tokens"][:, 1:],
                            self.cfg.vocab_size)
        if sl is not None:
            d = partition.data_axes(self.mesh)
            num = coll.psum(num, self.mesh, d)
            den = coll.psum(den, self.mesh, d)
        return num / torch.clamp(den, min=1.0), aux

    def _refuse_chunks(self, what: str) -> None:
        if not tfm.chunkable(self.cfg):
            raise ValueError(f"{what}: chunked prefill supports attention "
                             f"mixers only; {self.cfg.name} has SSM or "
                             f"cross-attention layers")

    def empty_caches(self, B: int, cache_len: int):
        """Zero capacity caches for the chunked-prefill entry points (on a
        mesh rank, its pieces of a B-row step's)."""
        return tfm.init_caches(self.cfg, B, cache_len, dtype=self._dtype(),
                               device=self.device, mesh=self.mesh)

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
        sl, bk = self._rows(B)
        if sl is not None:
            tokens, last = tokens[sl], last[sl]
        logits, caches, _ = tfm.forward(
            self.bank, self.cfg, {"tokens": tokens},
            mode="prefill_chunk", caches=caches, pos=int(q_offset),
            execution=_kv_of(bk, self.cfg, caches))
        rows = torch.arange(tokens.shape[0], device=self.device)
        return _gather_rows(logits[rows, last], bk, sl), caches

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

    def _decode_rows(self, tokens, caches, pos):
        """One eager decode step on an active mesh: this rank's rows of the
        tokens and positions, with its caches.  Returns (row slice or None,
        step backend, the rows' logits)."""
        tokens = self._tokens(tokens)
        sl, bk = self._rows(tokens.shape[0])
        _constrain_caches(caches, self.cfg, bk, tokens.shape[0], None)
        if sl is not None:
            tokens = tokens[sl]
            if not isinstance(pos, int):
                pos = torch.as_tensor(np.asarray(pos) if not isinstance(
                    pos, torch.Tensor) else pos)[sl]
        return sl, bk, self._decode_forward(bk, tokens, caches, pos)

    @torch.no_grad()
    def _decode_logits(self, tokens, caches, pos):
        """One decode step: through the caches' decode cell when they have
        one, else eagerly; on an active mesh eagerly on the rank's rows,
        the logits gathered (``graphs.MESH_RULE``)."""
        if self.backend.mesh_active:
            sl, bk, logits = self._decode_rows(tokens, caches, pos)
            return _gather_rows(logits, bk, sl)
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
        if self.backend.mesh_active and temperature <= 0.0:
            # greedy on the rank's rows; the tokens are gathered over data
            with torch.no_grad():
                sl, bk, logits = self._decode_rows(tokens, caches, pos)
            return _gather_rows(sample(logits, self.cfg.vocab_size),
                                bk, sl), caches
        # a draw samples the whole batch's logits (gathered on a mesh), so
        # it consumes the generator as the unsharded program does
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
        if self.backend.mesh_active:
            # eager steps on the rank's rows (graphs.MESH_RULE)
            for i in range(max_new):
                toks.append(cur)
                if i == max_new - 1:
                    break
                nxt, caches = self.decode_sample(cur, caches, S + i, gen,
                                                 temperature)
                cur = nxt.long()[:, None]
            return torch.cat(toks, dim=1)
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
