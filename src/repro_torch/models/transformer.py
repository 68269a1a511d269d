"""Model assembly for the GQA and MLA decoders, Mamba-2 and hybrid families
(port of the dense, MoE, SSM and hybrid paths of
``repro.models.transformer``).

A model is a list of segments; each segment is a homogeneous stack of
groups run through the PRM runner (``core.sharing.run_stack``).  Params are
nested dicts with the reference's keys (``segments/main/l0/mixer/wq``) and
a leading R axis on every segment leaf.  Caches hold one entry per layer
of a group, shaped by its mixer: attention
``{"k": (R, T, B, L, KV, hd), "v": ...}``, MLA
``{"ckv": (R, T, B, L, kv_lora), "kr": (R, T, B, L, rope_dim)}``, SSM
``{"h": (R, T, B, H, P, N) fp32, "conv": (R, T, B, W-1, conv_dim)}``.

A sequence mixer is attention (``attn``: GQA, or MLA where ``cfg.mla`` is
set) or the Mamba-2 block (``ssm``, ``models/ssm.py``); a hybrid stack
interleaves them within a group.  An FFN is a SwiGLU MLP (``dense``;
``dense_first`` in the ``pre`` segment of a MoE stack with
``first_dense`` layers, at ``first_dense_d_ff``), a mixture of experts
(``moe``, ``models/moe.py``), whose load-balance loss adds to the
forward's ``aux``, or absent (``none``: mamba2 has no FFN).  Cross-attention and the encoder stream
belong to later slices; :func:`check_ported` raises for them.
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
from repro_torch.models.layers import (apply_mlp, apply_norm, cast, embed,
                                       init_embedding, init_mlp, init_norm,
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
    """Raise for model families the port does not run yet.  Ported: the
    RMSNorm/SwiGLU stacks of GQA or MLA attention and Mamba-2 mixers with
    dense, MoE or no FFNs (``family`` dense, moe, ssm or hybrid; MLA on
    the dense and moe families).  Cross-attention (vlm), encoder-decoder
    (audio) and gelu/layer-norm stacks belong to later slices."""
    ok = (cfg.family in ("dense", "moe", "ssm", "hybrid")
          and (cfg.ssm is not None) == (cfg.family in ("ssm", "hybrid"))
          and (cfg.mla is None or cfg.family in ("dense", "moe"))
          and cfg.mlp_act == "swiglu" and cfg.norm == "rms")
    if not ok:
        raise NotImplementedError(
            f"{cfg.name}: only the RMSNorm/SwiGLU stacks of GQA or MLA "
            f"attention and Mamba-2 mixers (dense, MoE, SSM, hybrid) are "
            f"ported so far; vlm, audio and gelu/layer-norm stacks are "
            f"later slices (family {cfg.family!r}, "
            f"mla={cfg.mla is not None}, ssm={cfg.ssm is not None}, "
            f"mlp_act={cfg.mlp_act!r}, norm={cfg.norm!r})")


@functools.lru_cache(maxsize=64)
def shareds_for(cfg: ModelConfig) -> dict:
    return {spec.name: SharedStack.build(spec.num_groups, cfg.d_model,
                                         spec.reuse)
            for spec in build_segments(cfg)}


# =========================================================================
# one layer
# =========================================================================
def apply_layer(p, cfg: ModelConfig, h, cache, aux, *, mixer_kind, ffn_kind,
                mode, causal, pos, backend, transpose):
    """One pre-norm residual layer.  Returns (h, cache, aux): an attention
    layer writes its K/V into ``cache`` in place and returns it; an SSM
    layer returns its new state (decode: the full-slice update; prefill:
    the final state and conv tail, written into the slice by
    ``core.sharing.run_stack``)."""
    if mixer_kind not in ("attn", "ssm"):
        raise NotImplementedError(f"mixer {mixer_kind!r} is a later slice")
    if mode == "prefill_chunk" and mixer_kind != "attn":
        # SSM state integration would need chunk-to-chunk state threading;
        # the scheduler prefills such stacks monolithically
        raise ValueError(f"chunked prefill supports attention mixers only, "
                         f"got {mixer_kind!r}")
    hn = apply_norm(p["norm1"], h, cfg.norm, cfg.norm_eps)
    if mixer_kind == "ssm":
        if mode == "decode":
            y, new_cache = ssm_lib.ssm_decode(p["mixer"], cfg, hn, cache, pos,
                                              transpose=transpose,
                                              backend=backend)
        else:
            y, new_cache = ssm_lib.ssm_forward(
                p["mixer"], cfg, hn, transpose=transpose,
                return_cache=(mode == "prefill"), backend=backend)
    else:
        mla = cfg.mla is not None
        if mode == "decode":
            dec = attn.mla_decode if mla else attn.gqa_decode
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
    h = h + y
    if ffn_kind != "none":
        hn = apply_norm(p["norm2"], h, cfg.norm, cfg.norm_eps)
        if ffn_kind == "moe":
            y, moe_aux = moe_lib.apply_moe(p["ffn"], hn, cfg.moe,
                                           transpose=transpose,
                                           backend=backend)
            aux = aux + moe_aux["load_balance"]
        else:
            y = apply_mlp(p["ffn"], hn, act=cfg.mlp_act,
                          transpose=transpose, backend=backend)
        h = h + y
    return h, new_cache, aux


def group_block_fn(cfg: ModelConfig, spec: SegmentSpec, mode, pos, backend):
    def block_fn(p_r, h, cache_t, aux, *, transpose, reuse_index):
        new_cache = {} if cache_t is not None else None
        for i in range(spec.group_size):
            c_i = cache_t[f"l{i}"] if cache_t is not None else None
            h, c_i, aux = apply_layer(
                p_r[f"l{i}"], cfg, h, c_i, aux,
                mixer_kind=spec.mixer_kinds[i], ffn_kind=spec.ffn_kinds[i],
                mode=mode, causal=spec.causal, pos=pos, backend=backend,
                transpose=transpose)
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
    return init_mlp(cfg.d_model, d_ff, generator, device, lead=lead)


def _init_mixer(cfg: ModelConfig, kind: str, generator, device, lead):
    if kind == "ssm":
        return ssm_lib.init_ssm(cfg, generator, device, lead=lead)
    if cfg.mla is not None:
        return attn.init_mla(cfg, generator, device, lead=lead)
    return attn.init_gqa(cfg, generator, device, lead=lead)


def _init_group(cfg: ModelConfig, spec: SegmentSpec, R: int, generator,
                device):
    p = {}
    for i in range(spec.group_size):
        layer = {"norm1": init_norm(cfg.d_model, device, lead=(R,)),
                 "mixer": _init_mixer(cfg, spec.mixer_kinds[i], generator,
                                      device, (R,))}
        if spec.ffn_kinds[i] != "none":
            layer["norm2"] = init_norm(cfg.d_model, device, lead=(R,))
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
    generator = torch.Generator(device=dev).manual_seed(seed)
    params: dict[str, Any] = {
        "embed": init_embedding(cfg.padded_vocab, cfg.d_model, generator,
                                dev),
        "final_norm": init_norm(cfg.d_model, dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = init_unembed(cfg.d_model, cfg.padded_vocab,
                                         generator, dev)
    params["segments"] = {}
    for spec in build_segments(cfg):
        R = shareds_for(cfg)[spec.name].num_physical
        params["segments"][spec.name] = _init_group(cfg, spec, R, generator,
                                                    dev)
    return params


# =========================================================================
# forward
# =========================================================================
def forward(params, cfg: ModelConfig, batch, *, mode="train", caches=None,
            pos=None, execution=None):
    """Run the model.

    batch: {"tokens": (B, S) int tensor}.  mode: train | prefill |
    prefill_chunk | decode (decode: S == 1 and ``pos`` a scalar or a (B,)
    tensor of per-slot positions; prefill_chunk: ``pos`` is the chunk's
    q_offset and ``caches`` the partially filled capacity buffers).
    caches are updated IN PLACE and returned.  Returns
    (logits (B, S, V), caches, aux)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    check_ported(cfg)
    dtype = torch_dtype(cfg.compute_dtype)
    backend = backend_lib.resolve(execution if execution is not None
                                  else cfg)
    shareds = shareds_for(cfg)
    h = embed(params["embed"], batch["tokens"], dtype)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for spec in build_segments(cfg):
        seg_cache = caches.get(spec.name) if caches is not None else None
        block = group_block_fn(cfg, spec, mode, pos, backend)
        h, seg_cache, aux = run_stack(
            block, params["segments"][spec.name], h, shareds[spec.name],
            cache=seg_cache, aux0=aux,
            decode_pos=pos if mode == "decode" else None, backend=backend)
    h = apply_norm(params["final_norm"], h, cfg.norm, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = backend.dot(h, cast(params["embed"]["table"], h.dtype),
                             transpose=True)
    else:
        logits = unembed(params["lm_head"], h, backend=backend)
    return logits, caches, aux


def _mixer_cache(cfg: ModelConfig, kind: str, batch: int, length: int,
                 dtype, device, lead) -> dict:
    if kind == "ssm":
        return ssm_lib.init_ssm_cache(cfg, batch, dtype, device, lead=lead)
    if cfg.mla is not None:
        return attn.init_mla_cache(cfg, batch, length, dtype, device,
                                   lead=lead)
    shape = lead + (batch, length, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_caches(cfg: ModelConfig, batch: int, length: int,
                dtype=torch.bfloat16, device=None) -> dict:
    """Zero caches with leading [R, T] axes per layer of each segment's
    group: attention [R, T, B, L, KV, hd] K/V (MLA: [R, T, B, L, kv_lora]
    latents and [R, T, B, L, rope_dim] rope keys), SSM [R, T, B, H, P, N]
    fp32 state and [R, T, B, W-1, conv_dim] conv tail (no length axis)."""
    check_ported(cfg)
    dev = resolve_device(device)
    caches = {}
    for spec in build_segments(cfg):
        shared = shareds_for(cfg)[spec.name]
        lead = (shared.num_physical, shared.reuse_times)
        caches[spec.name] = {
            f"l{i}": _mixer_cache(cfg, spec.mixer_kinds[i], batch, length,
                                  dtype, dev, lead)
            for i in range(spec.group_size)}
    return caches


def has_ssm(cfg: ModelConfig) -> bool:
    """True when a decoder segment holds an SSM mixer (its state integrates
    every prompt token: no right padding, no chunked prefill)."""
    return any("ssm" in spec.mixer_kinds for spec in build_segments(cfg)
               if spec.stream != "encoder")
