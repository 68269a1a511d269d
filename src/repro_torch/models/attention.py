"""Attention: GQA/MHA with RoPE and a KV cache, MLA, multi-head latent
attention (DeepSeek-V2), and cross-attention over a memory stream (port of
``repro.models.attention``).

Cache layouts per logical layer (stacked [R, T, ...] by the PRM runner):
  gqa: ``{"k": (B, L, KV, hd), "v": (B, L, KV, hd)}``;
  mla: ``{"ckv": (B, L, kv_lora), "kr": (B, L, rope_dim)}`` (compressed);
  cross: ``{"ck": (B, M, KV, hd), "cv": (B, M, KV, hd)}``, the memory's
  K/V, written once by the prefill and only read by decode steps.
Decode takes ``pos`` as a scalar (aligned batch) or a (B,) tensor
(continuous batching, one position per slot).  Softmax is always fp32.

Prefill and chunked prefill write the new K/V (or latents) into the cache
view they are given IN PLACE (the reference returns an updated copy);
decode reads the cache and returns the one-token delta for the stack
runner to write.  GQA decode attention runs the decode-attention kernel
(``kernels/decode_attention.py``: the reference's masked einsum, with a
reduction order fixed per row and head on the card); MLA decodes in the
absorbed form, attending in the latent space.  Cross-attention has no
RoPE and no mask: a prefill of 512 rows or more runs flash with
``causal=False`` over the M memory rows, a decode row the einsum.

**On a mesh** a serving step carries its caches' layout
(``Backend.kv``, a ``partition.KVLayout`` of ``cache_pspecs``):

  * KV heads over "model" (``heads``): ``wq``/``wk``/``wv`` leave the
    rank's columns local (the Megatron pairing, ``core/backend.py``), so
    a rank projects, caches and attends with its own KV heads and their
    query heads, and ``wo`` takes its block of the attention output as its
    K/tp input; cross-attention alike;
  * else positions over ``seq_axes``: a rank holds its block of positions
    and every head.  Prefill attends whole and writes its own positions; a
    chunk attends against its cache gathered over those axes; decode runs
    the kernel's partial form on the rank's positions (the new token
    counted by the first rank of the axes), joins the pieces with one
    ``pmax`` and one ``psum`` over exactly those axes, and writes the
    token's K/V in place on the rank that holds its position.

Training and ``Program.loss`` carry no layout and attend with whole heads.
MLA and SSM caches keep the batch-over-data placement.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backend import resolve as resolve_backend
from repro_torch.kernels import decode_attention as _da
from repro_torch.models.layers import (apply_rope, cast, dense_init,
                                       rope_angles)
from repro_torch.sharding import collectives as coll

NEG_INF = -1e30


def _maybe_t(x, w, transpose, backend=None, tp_hint=None, local_in=False,
             local_out=False):
    """OBU transpose where the matrix is square (wq, wo here); the identity
    path otherwise (wk, wv).  ``tp_hint`` passes through to
    ``Backend.dot``: the output projections mark themselves "row", so a
    mesh runs them row-parallel (``core.backend.partition_rule``);
    ``local_in`` / ``local_out`` too (the Megatron pairing)."""
    bk = resolve_backend(backend)
    t = bool(transpose and w.shape[0] == w.shape[1])
    return bk.dot(x, w, transpose=t, tp_hint=tp_hint, local_in=local_in,
                  local_out=local_out)


def _heads_local(backend) -> bool:
    """Whether the step's rank attends with its own KV heads (module
    docstring)."""
    kv = resolve_backend(backend).kv
    return kv is not None and kv.heads


def _seq_split(backend):
    """The step's ``KVLayout`` when its positions split over some axes,
    else None."""
    kv = resolve_backend(backend).kv
    return kv if kv is not None and kv.seq_axes else None


def _write_positions(cache, k, v, start: int, backend):
    """Write the K/V of positions [start, start + C) into the cache view:
    all of them, or on a sequence-split cache those of this rank's
    block."""
    C = k.shape[1]
    lo, n = 0, cache["k"].shape[1]
    seq = _seq_split(backend)
    if seq is not None:
        lo, n = seq.window(resolve_backend(backend).mesh)
    a, b = max(start, lo), min(start + C, lo + n)
    if a < b:
        cache["k"][:, a - lo:b - lo] = k[:, a - start:b - start].to(
            cache["k"].dtype)
        cache["v"][:, a - lo:b - lo] = v[:, a - start:b - start].to(
            cache["v"].dtype)


def _write_token(cache, k, v, pos, lo: int):
    """Write a decode token's K/V (B, 1, KV, hd) at ``pos`` (an int or
    (B,)) into a cache view that holds positions [lo, lo + L): rows whose
    position lies elsewhere are left as they are."""
    L = cache["k"].shape[1]
    if not isinstance(pos, torch.Tensor) or pos.ndim == 0:
        p = int(pos) - lo
        if 0 <= p < L:
            cache["k"][:, p] = k[:, 0].to(cache["k"].dtype)
            cache["v"][:, p] = v[:, 0].to(cache["v"].dtype)
        return
    idx = pos.to(cache["k"].device).long() - lo
    hit = ((idx >= 0) & (idx < L))[:, None, None]
    idx = idx.clamp(0, L - 1)
    rows = torch.arange(idx.shape[0], device=idx.device)
    for name, new in (("k", k), ("v", v)):
        buf = cache[name]
        buf[rows, idx] = torch.where(hit, new[:, 0].to(buf.dtype),
                                     buf[rows, idx])


def _decode_positions(pos, device):
    """Position array for RoPE at decode: (1,) shared or (B, 1) per-slot."""
    if not isinstance(pos, torch.Tensor) or pos.ndim == 0:
        # a device-side fill: a host-to-device copy here would make the
        # host wait for the device once per layer
        return torch.full((1,), int(pos), device=device)
    return pos.to(device)[:, None]


# =========================================================================
# GQA / MHA
# =========================================================================
def init_gqa(cfg: ModelConfig, generator, device, lead=()):
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {"wq": dense_init((d, H * hd), generator, device, lead=lead),
            "wk": dense_init((d, KV * hd), generator, device, lead=lead),
            "wv": dense_init((d, KV * hd), generator, device, lead=lead),
            "wo": dense_init((H * hd, d), generator, device, lead=lead)}


def _gqa_attend(q, k, v, mask):
    """q: (B,S,H,hd) k/v: (B,L,KV,hd) mask: (B,S,L) or (S,L)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd)
    scores = torch.einsum("bskgh,blkh->bkgsl", qg.float(), k.float())
    scores = scores / torch.tensor(math.sqrt(hd), dtype=torch.float32)
    m = mask[:, None, None, :, :] if mask.ndim == 3 \
        else mask[None, None, None, :, :]
    scores = scores.masked_fill(~m, NEG_INF)
    att = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgsl,blkh->bskgh", att.to(v.dtype).float(),
                       v.float())
    hd_v = v.shape[-1]
    return out.reshape(B, S, H * hd_v).to(v.dtype)


def attend_seq_xla(q, k, v, *, causal: bool, q_offset=None):
    """The einsum attention reference — ``Backend.attention``'s path for
    short sequences and xla execution.  ``q_offset`` places query row i at
    absolute position q_offset + i in the causal mask (chunked prefill).
    (The reference's lax.scan over query chunks beyond 8192 rows is not
    needed at this slice's lengths.)"""
    B, S, H, hd = q.shape
    L = k.shape[1]
    off = 0 if q_offset is None else int(q_offset)
    if causal:
        mask = ((off + torch.arange(S, device=q.device))[:, None]
                >= torch.arange(L, device=q.device)[None, :])
    else:
        mask = torch.ones((S, L), dtype=torch.bool, device=q.device)
    return _gqa_attend(q, k, v, mask)


def _project_qkv(p, cfg, x, transpose, backend, S):
    """q (B, S, H, hd), k and v (B, S, KV, hd): every head, or with
    :func:`_heads_local` the rank's KV heads and their query heads."""
    B = x.shape[0]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    local = _heads_local(backend)
    if local:
        tp = resolve_backend(backend).tp
        H, KV = H // tp, KV // tp
    q = _maybe_t(x, cast(p["wq"], x.dtype), transpose, backend,
                 local_out=local).reshape(B, S, H, hd)
    k = _maybe_t(x, cast(p["wk"], x.dtype), transpose, backend,
                 local_out=local).reshape(B, S, KV, hd)
    v = _maybe_t(x, cast(p["wv"], x.dtype), transpose, backend,
                 local_out=local).reshape(B, S, KV, hd)
    return q, k, v


def _out_proj(out, p, x, transpose, backend):
    """``wo`` (row-parallel on a mesh) of the attention output: this rank's
    heads' block of it under :func:`_heads_local`."""
    return _maybe_t(out, cast(p["wo"], x.dtype), transpose, backend,
                    tp_hint="row", local_in=_heads_local(backend))


def gqa_forward(p, cfg: ModelConfig, x, *, transpose=False, causal=True,
                positions=None, cache=None, backend=None):
    """Full-sequence path (train / prefill).  With ``cache`` (a capacity
    buffer view) the new K/V are written at offset 0 in place."""
    B, S, d = x.shape
    q, k, v = _project_qkv(p, cfg, x, transpose, backend, S)
    if positions is None:
        positions = torch.arange(S, device=x.device)
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = resolve_backend(backend).attention(q, k, v, causal=causal)
    y = _out_proj(out, p, x, transpose, backend)
    if cache is not None:
        _write_positions(cache, k, v, 0, backend)
        return y, cache
    return y, None


def gqa_prefill_chunk(p, cfg: ModelConfig, x, cache, q_offset, *,
                      transpose=False, backend=None):
    """One query chunk of a chunked prefill: x (B, C, d) holds prompt tokens
    at absolute positions q_offset..q_offset+C-1.  Their K/V are written
    into the capacity cache at ``q_offset`` (in place), then the chunk's
    queries attend against the WHOLE buffer with the absolute-position
    causal mask: positions past the chunk hold garbage that the mask
    hides."""
    B, C, d = x.shape
    off = int(q_offset)
    q, k, v = _project_qkv(p, cfg, x, transpose, backend, C)
    positions = off + torch.arange(C, device=x.device)
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    _write_positions(cache, k, v, off, backend)
    ck, cv = cache["k"], cache["v"]
    seq = _seq_split(backend)
    if seq is not None:
        mesh = resolve_backend(backend).mesh
        ck = coll.all_gather(ck, mesh, seq.seq_axes, dim=1)
        cv = coll.all_gather(cv, mesh, seq.seq_axes, dim=1)
    out = resolve_backend(backend).attention(
        q, ck.to(x.dtype), cv.to(x.dtype), causal=True, q_offset=off)
    y = _out_proj(out, p, x, transpose, backend)
    return y, cache


def _decode_seq(q, cache, k, v, pos, backend, seq):
    """Decode attention on a sequence-split cache: the kernel's partial form
    on this rank's block of positions (the new token counted by the first
    rank of the split axes), joined with one ``pmax`` and one ``psum`` over
    exactly those axes; the token's K/V written on the rank whose block
    holds its position."""
    mesh = resolve_backend(backend).mesh
    axes = seq.seq_axes
    lo, _ = seq.window(mesh)
    B, _, H, hd = q.shape
    m, l_sum, o = _da.decode_attention_partial(
        q, cache["k"], cache["v"], k, v, pos, offset=lo,
        with_new=mesh.index(axes) == 0)
    M = coll.pmax(m, mesh, axes)
    w = torch.exp(m - M)
    both = coll.psum(torch.cat([o * w[..., None], (l_sum * w)[..., None]],
                               dim=-1), mesh, axes)
    out = both[..., :hd] / both[..., hd:]
    _write_token(cache, k, v, pos, lo)
    return out.reshape(B, 1, H * hd).to(q.dtype)


def gqa_decode(p, cfg: ModelConfig, x, cache, pos, *, transpose=False,
               backend=None):
    """Single-token decode: x (B,1,d); cache k/v (B,L,KV,hd) read-only;
    pos scalar or (B,).  Returns the one-token cache delta (None on a
    sequence-split cache, where the rank holding the position writes the
    token itself)."""
    B, S, d = x.shape
    if S != 1:
        raise ValueError(f"decode takes one token per row, got {S}")
    q, k, v = _project_qkv(p, cfg, x, transpose, backend, 1)
    cos, sin = rope_angles(_decode_positions(pos, x.device), cfg.head_dim,
                           cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    seq = _seq_split(backend)
    if seq is not None:
        out = _decode_seq(q, cache, k, v, pos, backend, seq)
        delta = None
    else:
        out = _da.decode_attention(q, cache["k"], cache["v"], k, v, pos)
        delta = {"k": k.to(cache["k"].dtype), "v": v.to(cache["v"].dtype)}
    return _out_proj(out, p, x, transpose, backend), delta


def gqa_decode_legacy(p, cfg: ModelConfig, x, cache, pos, *,
                      transpose=False, backend=None):
    """Baseline decode (the reference's A/B knob): write the token's K/V
    into the cache buffer at the scalar ``pos`` inside the block (in
    place) and attend against the whole buffer.  Returns the cache itself,
    which the stack runner leaves as it is."""
    B, S, d = x.shape
    if isinstance(pos, torch.Tensor) and pos.ndim > 0:
        raise ValueError("legacy decode takes a scalar position")
    if _seq_split(backend) is not None:
        raise NotImplementedError("legacy decode writes the whole buffer; "
                                  "a sequence-split cache holds a block")
    pos = int(pos)
    q, k, v = _project_qkv(p, cfg, x, transpose, backend, 1)
    cos, sin = rope_angles(_decode_positions(pos, x.device), cfg.head_dim,
                           cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    cache["k"][:, pos:pos + 1] = k.to(cache["k"].dtype)
    cache["v"][:, pos:pos + 1] = v.to(cache["v"].dtype)
    L = cache["k"].shape[1]
    mask = (torch.arange(L, device=x.device) <= pos)[None, :]
    out = _gqa_attend(q, cache["k"], cache["v"], mask)
    return _out_proj(out, p, x, transpose, backend), cache


def init_gqa_cache(cfg: ModelConfig, batch: int, length: int, dtype,
                   device):
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    return {"k": torch.zeros((batch, length, KV, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, length, KV, hd), dtype=dtype,
                             device=device)}


# =========================================================================
# MLA: multi-head latent attention (DeepSeek-V2)
# =========================================================================
def init_mla(cfg: ModelConfig, generator, device, lead=()):
    """The reference's leaves and shapes: ``wq`` (d, H * (nope + rope)),
    ``w_dkv`` (d, kv_lora + rope), ``w_ukv`` (kv_lora, H * (nope + v)),
    ``wo`` (H * v, d)."""
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    qd = m.qk_nope_dim + m.qk_rope_dim
    return {"wq": dense_init((d, H * qd), generator, device, lead=lead),
            "w_dkv": dense_init((d, m.kv_lora_rank + m.qk_rope_dim),
                                generator, device, lead=lead),
            "w_ukv": dense_init((m.kv_lora_rank,
                                 H * (m.qk_nope_dim + m.v_head_dim)),
                                generator, device, lead=lead),
            "wo": dense_init((H * m.v_head_dim, d), generator, device,
                             lead=lead)}


def _mla_qkr(p, cfg, x, positions, backend=None):
    """Project q (its rope half rotated) and the new tokens' compressed
    latents ``ckv`` and shared rope key ``kr`` (one head for all)."""
    bk = resolve_backend(backend)
    m = cfg.mla
    B, S, _ = x.shape
    q = bk.dot(x, cast(p["wq"], x.dtype), transpose=False)
    q = q.reshape(B, S, cfg.num_heads, m.qk_nope_dim + m.qk_rope_dim)
    qn, qr = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    dkv = bk.dot(x, cast(p["w_dkv"], x.dtype), transpose=False)
    ckv, kr = dkv[..., :m.kv_lora_rank], dkv[..., m.kv_lora_rank:]
    cos, sin = rope_angles(positions, m.qk_rope_dim, cfg.rope_theta)
    qr = apply_rope(qr, cos, sin)
    kr = apply_rope(kr[:, :, None, :], cos, sin)[:, :, 0, :]
    return qn, qr, ckv, kr


def _mla_attend_latents(p, cfg, x, qn, qr, ckv, kr, causal, q_offset,
                        backend):
    """Up-project the latents ``ckv`` (B, L, kv_lora) to per-head K/V
    (``w_ukv``, kept floating point: a photonic backend quantizes it in the
    step), append the shared rope key to every head's K, and attend:
    q (B, S, H, nope + rope) against k (B, L, H, nope + rope), v (B, L, H,
    v) through ``Backend.attention`` (flash at hd 192 / hd_v 128 on
    DeepSeek-V2)."""
    bk = resolve_backend(backend)
    m = cfg.mla
    B, L, _ = ckv.shape
    H = cfg.num_heads
    ukv = bk.dot(ckv, cast(p["w_ukv"], x.dtype), transpose=False)
    ukv = ukv.reshape(B, L, H, m.qk_nope_dim + m.v_head_dim)
    kn, v = ukv[..., :m.qk_nope_dim], ukv[..., m.qk_nope_dim:]
    k = torch.cat([kn, kr[:, :, None, :].expand(B, L, H, m.qk_rope_dim)],
                  dim=-1)
    q = torch.cat([qn, qr], dim=-1)
    out = bk.attention(q, k, v, causal=causal, q_offset=q_offset)
    return bk.dot(out, cast(p["wo"], x.dtype), transpose=False,
                  tp_hint="row")


def mla_forward(p, cfg: ModelConfig, x, *, transpose=False, causal=True,
                positions=None, cache=None, backend=None):
    """Full-sequence path (train / prefill); ``transpose`` is unused, as in
    the reference (no MLA weight is square).  With ``cache`` the new
    latents are written at offset 0 in place."""
    S = x.shape[1]
    if positions is None:
        positions = torch.arange(S, device=x.device)
    qn, qr, ckv, kr = _mla_qkr(p, cfg, x, positions, backend)
    y = _mla_attend_latents(p, cfg, x, qn, qr, ckv, kr, causal, None,
                            backend)
    if cache is not None:
        cache["ckv"][:, :S] = ckv.to(cache["ckv"].dtype)
        cache["kr"][:, :S] = kr.to(cache["kr"].dtype)
        return y, cache
    return y, None


def mla_prefill_chunk(p, cfg: ModelConfig, x, cache, q_offset, *,
                      transpose=False, backend=None):
    """One chunk of a chunked prefill: the chunk's latents are written
    into the capacity cache at ``q_offset`` (in place), then the WHOLE
    latent buffer is up-projected and the chunk's queries attend against
    it with the absolute-position causal mask, as the reference does (the
    garbage tail's up-projection is work the mask discards)."""
    C = x.shape[1]
    off = int(q_offset)
    positions = off + torch.arange(C, device=x.device)
    qn, qr, ckv_new, kr_new = _mla_qkr(p, cfg, x, positions, backend)
    cache["ckv"][:, off:off + C] = ckv_new.to(cache["ckv"].dtype)
    cache["kr"][:, off:off + C] = kr_new.to(cache["kr"].dtype)
    y = _mla_attend_latents(p, cfg, x, qn, qr, cache["ckv"].to(x.dtype),
                            cache["kr"].to(x.dtype), True, off, backend)
    return y, cache


def _mm(eq, a, b, dtype=None):
    """einsum with float32 accumulation, rounded to ``dtype`` (None:
    float32 out) — the reference's dot at default precision (``dtype`` the
    operands' type) or with ``preferred_element_type=float32``."""
    out = torch.einsum(eq, a.float(), b.float())
    return out if dtype is None else out.to(dtype)


def mla_decode(p, cfg: ModelConfig, x, cache, pos, *, transpose=False,
               backend=None):
    """Absorbed-matrix MLA decode: ``W_uk`` folds into q, the scores run
    against the latents ``ckv`` directly and ``W_uv`` applies to the
    attended context only.  The cache is read-only; the one-token latent
    delta is returned.  bf16 rounds where the reference rounds: ``q_lat``
    and the two context products in ``x.dtype``, the scores in float32,
    the weights cast to ``x.dtype`` before the context products."""
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"decode takes one token per row, got {S}")
    m = cfg.mla
    H, dt = cfg.num_heads, x.dtype
    qn, qr, ckv_new, kr_new = _mla_qkr(
        p, cfg, x, _decode_positions(pos, x.device), backend)
    ckv, kr = cache["ckv"], cache["kr"]
    L = ckv.shape[1]
    w_ukv = cast(p["w_ukv"], dt).reshape(m.kv_lora_rank, H,
                                        m.qk_nope_dim + m.v_head_dim)
    w_uk, w_uv = w_ukv[..., :m.qk_nope_dim], w_ukv[..., m.qk_nope_dim:]
    q_lat = _mm("bshn,rhn->bshr", qn, w_uk, dt)       # absorb W_uk into q
    scale = 1.0 / torch.tensor(math.sqrt(m.qk_nope_dim + m.qk_rope_dim),
                               dtype=torch.float32)
    s_c = (_mm("bshr,blr->bhsl", q_lat, ckv)
           + _mm("bshr,blr->bhsl", qr, kr)) * scale
    valid = _da.seen_mask(pos, L, x.device)[:, None, None, :]
    s_c = s_c.masked_fill(~valid, NEG_INF)
    s_n = (_mm("bshr,blr->bhsl", q_lat, ckv_new.to(dt))
           + _mm("bshr,blr->bhsl", qr, kr_new.to(dt))) * scale
    att = torch.softmax(torch.cat([s_c, s_n], dim=-1), dim=-1)
    ctx_lat = (_mm("bhsl,blr->bshr", att[..., :L].to(dt), ckv, dt)
               + _mm("bhsl,blr->bshr", att[..., L:].to(dt), ckv_new.to(dt),
                     dt))
    ctx = _mm("bshr,rhv->bshv", ctx_lat, w_uv, dt)
    y = resolve_backend(backend).dot(ctx.reshape(B, S, H * m.v_head_dim),
                                     cast(p["wo"], dt), transpose=False,
                                     tp_hint="row")
    return y, {"ckv": ckv_new.to(ckv.dtype), "kr": kr_new.to(kr.dtype)}


def init_mla_cache(cfg: ModelConfig, batch: int, length: int, dtype,
                   device, lead=()):
    m = cfg.mla
    return {"ckv": torch.zeros(lead + (batch, length, m.kv_lora_rank),
                               dtype=dtype, device=device),
            "kr": torch.zeros(lead + (batch, length, m.qk_rope_dim),
                              dtype=dtype, device=device)}


# =========================================================================
# cross-attention (VLM image layers, enc-dec decoder)
# =========================================================================
def init_cross_attn(cfg: ModelConfig, generator, device, lead=()):
    """The reference's leaves, with the memory at width d_model (its only
    use: ``vision_proj`` / ``audio_proj`` project the memory to it)."""
    return init_gqa(cfg, generator, device, lead=lead)


def cross_attn_memory(p, cfg: ModelConfig, memory, backend=None):
    """K/V of the (frozen per request) memory stream (B, M, d_memory).
    ``wk`` / ``wv`` run untransposed on every reuse, as in the
    reference."""
    bk = resolve_backend(backend)
    B, M, _ = memory.shape
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    local = _heads_local(bk)
    if local:
        KV //= bk.tp
    k = bk.dot(memory, cast(p["wk"], memory.dtype), transpose=False,
               local_out=local).reshape(B, M, KV, hd)
    v = bk.dot(memory, cast(p["wv"], memory.dtype), transpose=False,
               local_out=local).reshape(B, M, KV, hd)
    return {"ck": k, "cv": v}


def cross_attn_forward(p, cfg: ModelConfig, x, kv, *, transpose=False,
                       backend=None):
    """x: (B, S, d); kv: precomputed {"ck", "cv"} (B, M, KV, hd) (the
    rank's KV heads under :func:`_heads_local`, with its query heads)."""
    B, S, _ = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    local = _heads_local(backend)
    if local:
        H //= resolve_backend(backend).tp
    q = _maybe_t(x, cast(p["wq"], x.dtype), transpose, backend,
                 local_out=local).reshape(B, S, H, hd)
    out = resolve_backend(backend).attention(q, kv["ck"], kv["cv"],
                                             causal=False)
    return _out_proj(out, p, x, transpose, backend)
