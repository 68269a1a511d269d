"""Model assembly: decoder-only LMs (dense, MoE, SSM, hybrid, VLM) and
the encoder-decoder (whisper), all built from PRM-shared scan segments
(port of ``repro.models.transformer``).

A model is a list of segments; each segment is a homogeneous stack of
groups run through the PRM runner (``core.sharing.run_stack``).  Params are
nested dicts with the reference's keys (``segments/main/l0/mixer/wq``) and
a leading R axis on every segment leaf.  Caches hold one entry per layer
of a group, shaped by its mixer: attention
``{"k": (R, T, B, L, KV, hd), "v": ...}``, MLA
``{"ckv": (R, T, B, L, kv_lora), "kr": (R, T, B, L, rope_dim)}``, SSM
``{"h": (R, T, B, H, P, N) fp32, "conv": (R, T, B, W-1, conv_dim)}``,
cross-attention ``{"ck": (R, T, B, M, KV, hd), "cv": ...}`` over the M
memory rows, and the encoder-decoder's ``{"self": attention, "cross":
cross-attention}``.

A sequence mixer is attention (``attn``: GQA, or MLA where ``cfg.mla`` is
set), the Mamba-2 block (``ssm``, ``models/ssm.py``), cross-attention
(``cross_attn``: the vlm's image layers) or self- then cross-attention
(``attn_cross``: whisper's decoder); a hybrid stack interleaves them
within a group.  An FFN is a SwiGLU or gelu MLP (``dense``;
``dense_first`` in the ``pre`` segment of a MoE stack with
``first_dense`` layers, at ``first_dense_d_ff``), a mixture of experts
(``moe``, ``models/moe.py``), whose load-balance loss adds to the
forward's ``aux``, or absent (``none``: mamba2 has no FFN).

On a mesh a train or prefill step may hold its residual cut over "model"
between the layers (``Backend.residual``: "seq", the rank's block of the
positions, or "hidden", of the channels; :func:`apply_layer`): every norm's
output is gathered whole for the mixer and the FFN, and their output lands
back in the rank's block.

Memory streams: the vlm projects its image embeddings (``vision_proj``);
whisper runs its encoder segment, non-causal, over the projected frame
embeddings (``audio_proj``, then ``enc_final_norm``).  Prefill computes
each cross layer's K/V from the memory and writes them into the cache;
decode reads them there and leaves them as they are.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import backend as backend_lib
from repro_torch.core.prm import ReuseConfig
from repro_torch.core.sharing import SharedStack, run_stack
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (apply_linear, apply_mlp, apply_norm,
                                       cast, embed, init_embedding,
                                       init_linear, init_mlp, init_norm,
                                       init_unembed, unembed)

MODES = ("train", "prefill", "prefill_chunk", "decode")


@dataclasses.dataclass(frozen=True)
class SegmentSpec:
    name: str
    num_groups: int
    group_size: int
    mixer_kinds: tuple
    ffn_kinds: tuple
    causal: bool
    reuse: Optional[ReuseConfig]
    stream: str = "decoder"

    @property
    def depth(self) -> int:
        return self.num_groups * self.group_size


def _seg_reuse(cfg: ModelConfig, num_groups: int):
    """Apply cfg.reuse to a segment iff it covers exactly its group count."""
    r = cfg.reuse
    if r is not None and r.logical_depth == num_groups:
        return r
    return None


def build_segments(cfg: ModelConfig) -> tuple:
    """Segment structure of any family (a copy of the reference's pure-
    Python planner; the admission policy prices every arch with it).  The
    families that run are those :func:`check_ported` admits."""
    if cfg.family == "audio":
        a = cfg.audio
        enc = SegmentSpec("enc", a.encoder_layers, 1, ("attn",), ("dense",),
                          causal=False, reuse=_seg_reuse(cfg, a.encoder_layers),
                          stream="encoder")
        dec = SegmentSpec("dec", cfg.num_layers, 1, ("attn_cross",),
                          ("dense",), causal=True,
                          reuse=_seg_reuse(cfg, cfg.num_layers))
        return (enc, dec)
    gs = cfg.group_size
    first_dense = cfg.moe.first_dense if cfg.moe else 0
    segs = []
    if first_dense:
        segs.append(SegmentSpec(
            "pre", first_dense, 1,
            tuple(cfg.layer_kind(i) for i in range(1)),
            ("dense_first",), causal=True, reuse=None))
    depth = cfg.num_layers - first_dense
    ngroups = depth // gs
    mixer_kinds = tuple(cfg.layer_kind(first_dense + i) for i in range(gs))
    ffn_kinds = tuple(cfg.ffn_kind(first_dense + i) for i in range(gs))
    segs.append(SegmentSpec("main", ngroups, gs, mixer_kinds, ffn_kinds,
                            causal=True, reuse=_seg_reuse(cfg, ngroups)))
    return tuple(segs)


def check_ported(cfg: ModelConfig) -> None:
    """Raise for a configuration that neither the port nor the reference
    builds: an SSM or hybrid family without its SSM config (or an SSM
    config elsewhere), a vlm without its vision config or an audio family
    without its audio config, MLA outside the dense and moe families, or
    an unknown norm or MLP activation.  Every architecture of
    ``configs.archs`` passes."""
    ok = (cfg.family in ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
          and (cfg.ssm is not None) == (cfg.family in ("ssm", "hybrid"))
          and (cfg.vision is not None or cfg.family != "vlm")
          and (cfg.audio is not None or cfg.family != "audio")
          and (cfg.mla is None or cfg.family in ("dense", "moe"))
          and cfg.mlp_act in ("swiglu", "gelu")
          and cfg.norm in ("rms", "layer"))
    if not ok:
        raise NotImplementedError(
            f"{cfg.name}: not a buildable configuration (family "
            f"{cfg.family!r}, mla={cfg.mla is not None}, "
            f"ssm={cfg.ssm is not None}, vision={cfg.vision is not None}, "
            f"audio={cfg.audio is not None}, mlp_act={cfg.mlp_act!r}, "
            f"norm={cfg.norm!r})")


@functools.lru_cache(maxsize=64)
def shareds_for(cfg: ModelConfig) -> dict:
    return {spec.name: SharedStack.build(spec.num_groups, cfg.d_model,
                                         spec.reuse)
            for spec in build_segments(cfg)}


# =========================================================================
# one layer
# =========================================================================
def _cross_kv(p, cfg, memory, B, backend):
    """Cross K/V of the memory, broadcast to B rows where the memory has
    one (a wave's shared extras: the reference's einsum broadcasts it, and
    the cache holds a row per sequence)."""
    kv = attn.cross_attn_memory(p, cfg, memory, backend=backend)
    if memory.shape[0] != B:
        kv = {k: v.expand(B, *v.shape[1:]) for k, v in kv.items()}
    return kv


def _moe_ffn(p, cfg: ModelConfig, hn, transpose, backend):
    """The MoE FFN.  Its token groups and expert capacities couple rows,
    so on a mesh rank holding its data shard's rows it runs on the whole
    batch, gathered over the data axes, and keeps its own rows of the
    result: the routing, the drops and the load-balance loss are the
    unsharded program's.  The gather is differentiable (its backward
    reduce-scatters), so a train step's backward reaches every rank's rows;
    the aux is then the same on every rank (``train/trainer.py`` counts it
    once)."""
    bk = backend_lib.resolve(backend)
    if bk.residual is not None:
        # the routed FFN returns whole rows (the layer cuts them); its
        # shared expert's pair-second dot rejoins whole too
        bk = dataclasses.replace(bk, residual=None)
    if not (bk.mesh_active and bk.rows_sharded):
        return moe_lib.apply_moe(p, hn, cfg.moe, transpose=transpose,
                                 backend=bk)
    from repro_torch.sharding import collectives as coll
    from repro_torch.sharding.partition import data_axes
    d_axes = data_axes(bk.mesh)
    whole = coll.all_gather_grad(hn, bk.mesh, d_axes, dim=0)
    y, aux = moe_lib.apply_moe(p, whole, cfg.moe, transpose=transpose,
                               backend=bk.whole_rows())
    n = hn.shape[0]
    i = bk.mesh.index(d_axes)
    return y[i * n:(i + 1) * n], aux


# =========================================================================
# the residual stream under a layout (``Backend.residual``)
# =========================================================================
def _layout(backend):
    """The step's active ``partition.ResidualLayout``, or None."""
    lay = backend_lib.resolve(backend).residual
    return lay if lay is not None and lay.active else None


def cut_residual(h, backend):
    """This rank's block of a whole residual ``h`` (B, S, D) under the
    step's layout: its positions ("seq") or channels ("hidden"); ``h``
    itself without one, or when it is that block already (a pair-second
    dot rejoined into it).  Differentiable: the blocks' gradients are
    all-gathered back."""
    lay = _layout(backend)
    if lay is None:
        return h
    whole = lay.length if lay.mode == "seq" else lay.width
    if h.shape[lay.dim] != whole:
        return h
    from repro_torch.sharding import collectives as coll
    return coll.split_grad(h, backend_lib.resolve(backend).mesh, "model",
                           dim=lay.dim)


def normed_whole(p, h, cfg: ModelConfig, backend):
    """The norm of residual ``h`` as the next mixer, FFN or head reads it:
    whole rows.  Under "seq" each rank norms its positions and the result
    is all-gathered over "model" (the norm's scale and bias, whole on every
    rank, enter through ``copy_to_model``: a rank's gradient of them is its
    positions' share); under "hidden" the rank's channels are all-gathered
    and normed whole (the statistics span every channel, so they are the
    unsharded ones bit for bit: a sum of per-rank partial squares would
    re-round them and flip A8 codes downstream)."""
    lay = _layout(backend)
    if lay is None:
        return apply_norm(p, h, cfg.norm, cfg.norm_eps)
    from repro_torch.sharding import collectives as coll
    mesh = backend_lib.resolve(backend).mesh
    if lay.mode == "seq":
        p = {k: coll.copy_to_model(v, mesh) for k, v in p.items()}
        return coll.all_gather_split(
            apply_norm(p, h, cfg.norm, cfg.norm_eps), mesh, "model", dim=1)
    whole = coll.all_gather_split(h, mesh, "model", dim=-1)
    return apply_norm(p, whole, cfg.norm, cfg.norm_eps)


def _embed(p, tokens, dtype, backend):
    """The embedding rows of ``tokens``, cut to the step's residual layout.
    A train step's table cut over the vocabulary (a ``ModelPiece``) is
    looked up vocab-parallel: each rank takes the tokens in its rows of
    the table (zeros elsewhere) and the ranks' rows are summed, by a
    reduce-scatter into the layout's block or an all-reduce (one nonzero
    term per output: exact).  A table held as FSDP pieces
    (``Backend.fsdp``) is looked up by its columns and its rows gathered
    (``fsdp.Layout.lookup``)."""
    from repro_torch.sharding.partition import ModelPiece
    bk = backend_lib.resolve(backend)
    table = p["table"]
    if bk.fsdp is not None:
        rows_of, n, vocab_cut = bk.fsdp.lookup(table, ("embed", "table"),
                                               dtype, not bk.rows_sharded)
    elif isinstance(table, ModelPiece):
        n, vocab_cut = table.t.shape[0], True

        def rows_of(idx):
            return table.t.to(dtype)[idx]
    else:
        return cut_residual(embed(p, tokens, dtype), backend)
    if not vocab_cut:
        return cut_residual(rows_of(tokens), backend)
    from repro_torch.sharding import collectives as coll
    mesh = bk.mesh
    local = tokens.long() - mesh.index("model") * n
    hit = (local >= 0) & (local < n)
    rows = rows_of(local.clamp(0, n - 1))
    rows = torch.where(hit[..., None], rows, torch.zeros_like(rows))
    lay = _layout(bk)
    if lay is None:
        return coll.psum_grad(rows, mesh, "model")
    return coll.reduce_scatter_grad(rows, mesh, "model", dim=lay.dim)


def apply_layer(p, cfg: ModelConfig, h, cache, aux, *, mixer_kind, ffn_kind,
                mode, causal, pos, backend, transpose, memory=None,
                legacy_decode=False):
    """One pre-norm residual layer.  Returns (h, cache, aux): an attention
    layer writes its K/V into ``cache`` in place and returns it; an SSM
    layer returns its new state (decode: the full-slice update; prefill:
    the final state and conv tail, written into the slice by
    ``core.sharing.run_stack``); a cross-attention layer returns its
    memory's K/V in prefill (written at offset 0 by ``run_stack``) and
    None in decode, where it only reads the cache.  ``legacy_decode``
    sends a GQA self-attention layer's decode through
    ``attention.gqa_decode_legacy``, which writes the cache itself.

    Under a residual layout (``Backend.residual``) ``h`` is the rank's
    block of positions or channels: each norm's output reaches the mixer
    and the FFN whole (:func:`normed_whole`), and their output, either
    rejoined into the block by the pair-second dot or whole (then cut:
    :func:`cut_residual`), adds to ``h`` locally."""
    if mode == "prefill_chunk" and mixer_kind != "attn":
        # SSM state integration and cross-attention memory streams would
        # need chunk-to-chunk state threading; the scheduler prefills such
        # stacks monolithically
        raise ValueError(f"chunked prefill supports attention mixers only, "
                         f"got {mixer_kind!r}")
    hn = normed_whole(p["norm1"], h, cfg, backend)
    if mixer_kind == "ssm":
        if mode == "decode":
            y, new_cache = ssm_lib.ssm_decode(p["mixer"], cfg, hn, cache, pos,
                                              transpose=transpose,
                                              backend=backend)
        else:
            y, new_cache = ssm_lib.ssm_forward(
                p["mixer"], cfg, hn, transpose=transpose,
                return_cache=(mode == "prefill"), backend=backend)
    elif mixer_kind == "cross_attn":
        if mode == "decode":
            kv, new_cache = cache, None
        else:
            kv = _cross_kv(p["mixer"], cfg, memory, h.shape[0], backend)
            new_cache = kv if mode == "prefill" else None
        y = attn.cross_attn_forward(p["mixer"], cfg, hn, kv,
                                    transpose=transpose, backend=backend)
    elif mixer_kind == "attn_cross":
        pm = p["mixer"]
        if mode == "decode":
            y, self_c = attn.gqa_decode(pm["self"], cfg, hn, cache["self"],
                                        pos, transpose=transpose,
                                        backend=backend)
            kv, cross_c = cache["cross"], None
        else:
            y, self_c = attn.gqa_forward(
                pm["self"], cfg, hn, transpose=transpose, causal=causal,
                cache=cache["self"] if mode == "prefill" else None,
                backend=backend)
            kv = _cross_kv(pm["cross"], cfg, memory, h.shape[0], backend)
            cross_c = kv
        h = h + cut_residual(y, backend)
        hn2 = normed_whole(p["norm_cross"], h, cfg, backend)
        y = attn.cross_attn_forward(pm["cross"], cfg, hn2, kv,
                                    transpose=transpose, backend=backend)
        new_cache = ({"self": self_c, "cross": cross_c}
                     if mode in ("prefill", "decode") else None)
    elif mixer_kind == "attn":
        mla = cfg.mla is not None
        if mode == "decode":
            dec = attn.mla_decode if mla else attn.gqa_decode
            if legacy_decode and not mla:
                dec = attn.gqa_decode_legacy
            y, new_cache = dec(p["mixer"], cfg, hn, cache, pos,
                               transpose=transpose, backend=backend)
        elif mode == "prefill_chunk":
            # ``pos`` is the chunk's q_offset
            chunk = attn.mla_prefill_chunk if mla else attn.gqa_prefill_chunk
            y, new_cache = chunk(p["mixer"], cfg, hn, cache, pos,
                                 transpose=transpose, backend=backend)
        else:
            fwd = attn.mla_forward if mla else attn.gqa_forward
            y, new_cache = fwd(p["mixer"], cfg, hn, transpose=transpose,
                               causal=causal,
                               cache=cache if mode == "prefill" else None,
                               backend=backend)
    else:
        raise ValueError(mixer_kind)
    h = h + cut_residual(y, backend)
    if ffn_kind != "none":
        hn = normed_whole(p["norm2"], h, cfg, backend)
        if ffn_kind == "moe":
            y, moe_aux = _moe_ffn(p["ffn"], cfg, hn, transpose, backend)
            aux = aux + moe_aux["load_balance"]
        else:
            y = apply_mlp(p["ffn"], hn, act=cfg.mlp_act,
                          transpose=transpose, backend=backend)
        h = h + cut_residual(y, backend)
    return h, new_cache, aux


def group_block_fn(cfg: ModelConfig, spec: SegmentSpec, mode, pos, backend,
                   memory=None, legacy_decode=False):
    def block_fn(p_r, h, cache_t, aux, *, transpose, reuse_index):
        new_cache = {} if cache_t is not None else None
        for i in range(spec.group_size):
            c_i = cache_t[f"l{i}"] if cache_t is not None else None
            h, c_i, aux = apply_layer(
                p_r[f"l{i}"], cfg, h, c_i, aux,
                mixer_kind=spec.mixer_kinds[i], ffn_kind=spec.ffn_kinds[i],
                mode=mode, causal=spec.causal, pos=pos, backend=backend,
                transpose=transpose, memory=memory,
                legacy_decode=legacy_decode)
            if new_cache is not None:
                new_cache[f"l{i}"] = c_i
        return h, new_cache, aux
    return block_fn


# =========================================================================
# init
# =========================================================================
def _init_ffn(cfg: ModelConfig, kind: str, generator, device, lead):
    if kind == "moe":
        return moe_lib.init_moe(cfg.d_model, cfg.moe, generator, device,
                                lead=lead)
    d_ff = (cfg.moe.first_dense_d_ff if kind == "dense_first" and cfg.moe
            else cfg.d_ff)
    return init_mlp(cfg.d_model, d_ff, generator, device, lead=lead,
                    act=cfg.mlp_act)


def _init_mixer(cfg: ModelConfig, kind: str, generator, device, lead):
    if kind == "ssm":
        return ssm_lib.init_ssm(cfg, generator, device, lead=lead)
    if kind == "cross_attn":
        return attn.init_cross_attn(cfg, generator, device, lead=lead)
    if kind == "attn_cross":
        return {"self": attn.init_gqa(cfg, generator, device, lead=lead),
                "cross": attn.init_cross_attn(cfg, generator, device,
                                              lead=lead)}
    if cfg.mla is not None:
        return attn.init_mla(cfg, generator, device, lead=lead)
    return attn.init_gqa(cfg, generator, device, lead=lead)


def _init_group(cfg: ModelConfig, spec: SegmentSpec, R: int, generator,
                device):
    p = {}
    for i in range(spec.group_size):
        layer = {"norm1": init_norm(cfg.d_model, device, lead=(R,),
                                    kind=cfg.norm),
                 "mixer": _init_mixer(cfg, spec.mixer_kinds[i], generator,
                                      device, (R,))}
        if spec.mixer_kinds[i] == "attn_cross":
            layer["norm_cross"] = init_norm(cfg.d_model, device, lead=(R,),
                                            kind=cfg.norm)
        if spec.ffn_kinds[i] != "none":
            layer["norm2"] = init_norm(cfg.d_model, device, lead=(R,),
                                       kind=cfg.norm)
            layer["ffn"] = _init_ffn(cfg, spec.ffn_kinds[i], generator,
                                     device, (R,))
        p[f"l{i}"] = layer
    return p


def init_model(cfg: ModelConfig, *, seed: int = 0, device=None) -> dict:
    """Random float32 params from a ``torch.Generator`` with the reference's
    scales (N(0,1)/sqrt(fan_in) matmul weights, 0.02 embedding, unit norm
    scales).  The streams differ from ``jax.random``; to hold the port to
    the reference, load JAX params with ``repro_torch.bridge`` instead.
    ``device`` defaults to CUDA (``device="cpu"`` for the CPU)."""
    check_ported(cfg)
    dev = resolve_device(device)
    # meta tensors draw nothing (abstract_params); a generator is on a
    # real device
    generator = torch.Generator(
        device="cpu" if dev.type == "meta" else dev).manual_seed(seed)
    params: dict[str, Any] = {
        "embed": init_embedding(cfg.padded_vocab, cfg.d_model, generator,
                                dev),
        "final_norm": init_norm(cfg.d_model, dev, kind=cfg.norm)}
    if not cfg.tie_embeddings:
        params["lm_head"] = init_unembed(cfg.d_model, cfg.padded_vocab,
                                         generator, dev)
    if cfg.family == "vlm":
        params["vision_proj"] = init_linear(cfg.vision.d_vision, cfg.d_model,
                                            generator, dev)
    if cfg.family == "audio":
        params["audio_proj"] = init_linear(cfg.audio.d_audio, cfg.d_model,
                                           generator, dev)
        params["enc_final_norm"] = init_norm(cfg.d_model, dev, kind=cfg.norm)
    params["segments"] = {}
    for spec in build_segments(cfg):
        R = shareds_for(cfg)[spec.name].num_physical
        params["segments"][spec.name] = _init_group(cfg, spec, R, generator,
                                                    dev)
    return params


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree as meta tensors: shapes and dtypes, no memory
    (the reference's ``abstract_params``; the partition rules read it)."""
    return init_model(cfg, device="meta")


# =========================================================================
# forward
# =========================================================================
def encoder_pass(params, cfg: ModelConfig, batch, backend,
                 remat: bool = False):
    """Whisper's encoder over the stub frame embeddings: ``audio_proj``,
    the ``enc`` segment (non-causal, mode ``train``: no cache; ``remat``
    recomputes each reuse in the backward), then ``enc_final_norm``.
    Returns the memory (B, F, d) and the aux."""
    dtype = torch_dtype(cfg.compute_dtype)
    frames = batch["audio_embeds"].to(dtype)
    bk = backend_lib.resolve(backend)
    if bk.residual is not None:
        # the encoder's residual over its frames, in the step's layout
        bk = dataclasses.replace(
            bk, residual=bk.residual.for_length(frames.shape[1]))
    h = cut_residual(apply_linear(_use(params, "audio_proj", bk), frames,
                                  backend=bk), bk)
    spec = build_segments(cfg)[0]
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    h, _, aux = run_stack(group_block_fn(cfg, spec, "train", None, bk),
                          params["segments"][spec.name], h,
                          shareds_for(cfg)[spec.name], aux0=aux,
                          remat=remat, backend=bk,
                          path=("segments", spec.name))
    return normed_whole(_use(params, "enc_final_norm", bk), h, cfg, bk), aux


def _use(params, key: str, backend):
    """``params[key]`` (a leaf group outside the stacks) as its use reads
    it: gathered from FSDP pieces where the backend carries them
    (``fsdp.Layout.use``), else as it is."""
    fs = backend_lib.resolve(backend).fsdp
    return params[key] if fs is None else fs.use(params[key], (key,))


def forward(params, cfg: ModelConfig, batch, *, mode="train", caches=None,
            pos=None, remat=False, legacy_decode=False, execution=None):
    """Run the model.

    batch: {"tokens": (B, S) int tensor} plus the modality extras outside
    decode: vlm ``{"image_embeds": (B|1, M, d_vision)}``, audio
    ``{"audio_embeds": (B|1, F, d_audio)}`` (a one-row memory serves every
    row).  mode: train | prefill | prefill_chunk | decode (decode: S == 1
    and ``pos`` a scalar or a (B,) tensor of per-slot positions;
    prefill_chunk: ``pos`` is the chunk's q_offset and ``caches`` the
    partially filled capacity buffers).  caches are updated IN PLACE and
    returned.  ``remat`` (mode ``train``) recomputes each reuse of every
    stack in the backward, keeping only its input.  ``legacy_decode``
    (decode, scalar ``pos``) runs the GQA
    layers' baseline decode, which writes each layer's cache in the block,
    so the stack runner writes no deltas; as in the reference it leaves
    MLA's decode as it is, and it refuses stacks whose decode step returns
    a delta the runner would then not write (MLA, whisper's self- and
    cross-attention layer).  Returns (logits (B, S, V), caches, aux).

    A backend carrying a residual layout (``Backend.residual``, set for a
    train or prefill step by ``train/trainer.py`` and ``api._step_rows``)
    holds the residual cut over "model" between the layers, the
    encoder's too: the embedding is cut to the rank's block (:func:`_embed`),
    every layer norms its block and works on whole rows
    (:func:`apply_layer`), and the final norm's output is gathered whole,
    so the lm head (column-parallel over the vocabulary where it is cut)
    and the logits see whole rows.

    A backend carrying FSDP pieces (``Backend.fsdp``: ``params`` are the
    rank's pieces) gathers each stack's blocks where they run
    (``core.sharing.run_stack``), every other leaf group at its use and
    looks the embedding up by its columns (``sharding/fsdp.py``)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    check_ported(cfg)
    legacy = legacy_decode and mode == "decode"
    if legacy and (cfg.mla is not None or any(
            "attn_cross" in spec.mixer_kinds for spec in build_segments(cfg))):
        raise ValueError(f"{cfg.name}: legacy_decode needs GQA attention "
                         f"layers that write their own cache")
    dtype = torch_dtype(cfg.compute_dtype)
    backend = backend_lib.resolve(execution if execution is not None
                                  else cfg)
    shareds = shareds_for(cfg)
    if backend.residual is not None and mode not in ("train", "prefill"):
        # only full-sequence steps cut the residual (a decode step's one
        # position, a chunk's rows: whole)
        backend = dataclasses.replace(backend, residual=None)
    h = _embed(params["embed"], batch["tokens"], dtype, backend)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    memory = None                   # decode: the cross K/V are in the cache
    if cfg.family == "vlm" and mode != "decode":
        memory = apply_linear(_use(params, "vision_proj", backend),
                              batch["image_embeds"].to(dtype),
                              backend=backend)
    if cfg.family == "audio" and mode != "decode":
        memory, aux = encoder_pass(params, cfg, batch, backend, remat=remat)
    for spec in build_segments(cfg):
        if spec.stream == "encoder":
            continue                        # run by encoder_pass
        seg_cache = caches.get(spec.name) if caches is not None else None
        block = group_block_fn(cfg, spec, mode, pos, backend, memory,
                               legacy_decode=legacy)
        h, seg_cache, aux = run_stack(
            block, params["segments"][spec.name], h, shareds[spec.name],
            cache=seg_cache, aux0=aux, remat=remat,
            decode_pos=pos if mode == "decode" and not legacy else None,
            backend=backend, path=("segments", spec.name))
    h = normed_whole(_use(params, "final_norm", backend), h, cfg, backend)
    if cfg.tie_embeddings:
        table = _use(params, "embed", backend)["table"]
        logits = backend.dot(h, cast(table, h.dtype), transpose=True)
    else:
        logits = unembed(_use(params, "lm_head", backend), h,
                         backend=backend)
    return logits, caches, aux


def memory_len(cfg: ModelConfig) -> int:
    """Rows of the memory stream a cross-attention cache holds: the image
    tokens (vlm) or the audio frames (audio); 0 otherwise."""
    if cfg.family == "vlm":
        return cfg.vision.num_image_tokens
    if cfg.family == "audio":
        return cfg.audio.num_frames
    return 0


def _mixer_cache(cfg: ModelConfig, kind: str, batch: int, length: int,
                 dtype, device, lead) -> dict:
    if kind == "ssm":
        return ssm_lib.init_ssm_cache(cfg, batch, dtype, device, lead=lead)
    if kind in ("cross_attn", "attn_cross"):
        shape = lead + (batch, memory_len(cfg), cfg.num_kv_heads,
                        cfg.head_dim)
        cross = {"ck": torch.zeros(shape, dtype=dtype, device=device),
                 "cv": torch.zeros(shape, dtype=dtype, device=device)}
        if kind == "cross_attn":
            return cross
        return {"self": _mixer_cache(cfg, "attn", batch, length, dtype,
                                     device, lead), "cross": cross}
    if cfg.mla is not None:
        return attn.init_mla_cache(cfg, batch, length, dtype, device,
                                   lead=lead)
    shape = lead + (batch, length, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_caches(cfg: ModelConfig, batch: int, length: int,
                dtype=torch.bfloat16, device=None, mesh=None) -> dict:
    """Zero caches with leading [R, T] axes per layer of each decoder
    segment's group: attention [R, T, B, L, KV, hd] K/V (MLA: [R, T, B, L,
    kv_lora] latents and [R, T, B, L, rope_dim] rope keys), SSM [R, T, B,
    H, P, N] fp32 state and [R, T, B, W-1, conv_dim] conv tail (no length
    axis), cross-attention [R, T, B, M, KV, hd] memory K/V.  The encoder
    segment keeps no cache.

    On an active ``mesh`` (a rank's), ``batch`` is the step's whole batch
    and every leaf is made at this rank's piece of the whole cache under
    ``partition.cache_pspecs`` (never whole and then cut), marked with its
    spec and whole shape (``partition.piece_of``)."""
    check_ported(cfg)
    dev = resolve_device(device)
    placed = mesh is not None and mesh.size > 1
    caches = {}
    for spec in build_segments(cfg):
        if spec.stream == "encoder":
            continue
        shared = shareds_for(cfg)[spec.name]
        lead = (shared.num_physical, shared.reuse_times)
        caches[spec.name] = {
            f"l{i}": _mixer_cache(cfg, spec.mixer_kinds[i], batch, length,
                                  dtype, "meta" if placed else dev, lead)
            for i in range(spec.group_size)}
    if not placed:
        return caches
    from repro_torch.sharding import partition

    def piece(whole, spec):
        if isinstance(whole, dict):
            return {k: piece(v, spec[k]) for k, v in whole.items()}
        t = torch.zeros(partition.local_shape(whole.shape, spec, mesh),
                        dtype=whole.dtype, device=dev)
        return partition.mark_piece(t, spec, whole.shape)

    return piece(caches, partition.cache_pspecs(cfg, mesh, batch, length))


def has_ssm(cfg: ModelConfig) -> bool:
    """True when a decoder segment holds an SSM mixer (its state integrates
    every prompt token: no right padding, no chunked prefill)."""
    return any("ssm" in spec.mixer_kinds for spec in build_segments(cfg)
               if spec.stream != "encoder")


def chunkable(cfg: ModelConfig) -> bool:
    """True when every decoder mixer is self-attention: only such stacks
    prefill in chunks (an SSM state and a cross-attention memory are not
    chunk-resumable)."""
    return all(kind == "attn" for spec in build_segments(cfg)
               if spec.stream != "encoder" for kind in spec.mixer_kinds)
