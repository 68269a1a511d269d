"""Mamba-2 SSD (state-space duality) sequence mixer — chunked scan form
(port of ``repro.models.ssm``).

The sequence is split into chunks of length L (Dao & Gu,
arXiv:2405.21060).  The intra-chunk terms — the masked quadratic form and
each chunk's state — run in the ``ssd_chunk`` kernel (``kernels/ssd.py``;
the reference computes them inline); the inter-chunk recurrence over the
(H, P, N) state and the state-to-output correction stay in torch.

Cache layout (decode): {"h": (B, H, P, N) fp32, "conv": (B, W-1, conv_dim)};
on a mesh a rank's pieces of them (``partition.cache_pspecs``: its heads
of ``h``, its channels of ``conv``, where "model" divides them), which a
serving step reads from ``Backend.ssm`` (``ssm_forward``).  A train step on
a mesh runs the same cuts with its pieces of the SSM leaves: the gradient
of the intra-chunk block is ``ssd_chunk``'s own
(``kernels/ssd.ssd_chunk_vjp``).
The kernel returns chunk states as (N, P); :func:`ssd_chunked` transposes
them to the carried (P, N) layout in one place.

bf16 arithmetic follows the reference's rounding points: the silus of the
causal conv and of the output gate round every op
(``kernels/photonic_mvm.apply_activation``), and softplus is
``logaddexp(x, 0)``, the formula of ``jax.nn.softplus`` (not
``torch.nn.functional.softplus``, which switches to ``x`` above 20).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.core.backend import resolve as resolve_backend
from repro_torch.kernels import ops
from repro_torch.kernels.photonic_mvm import apply_activation
from repro_torch.models.layers import apply_norm, cast, dense_init
from repro_torch.sharding import collectives as coll


def ssm_dims(cfg: ModelConfig):
    s: SSMConfig = cfg.ssm
    d_in = s.expand * cfg.d_model
    heads = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return d_in, heads, conv_dim


def init_ssm(cfg: ModelConfig, generator, device, lead=()):
    """Random params with the reference's scales and constants (``lead``
    prepends the stacked PRM R axis)."""
    s = cfg.ssm
    d = cfg.d_model
    d_in, H, conv_dim = ssm_dims(cfg)
    in_width = 2 * d_in + 2 * s.n_groups * s.d_state + H
    lead = tuple(lead)

    def const(v):
        return v.to(device).expand(*lead, *v.shape).clone()

    return {"w_in": dense_init((d, in_width), generator, device, lead=lead),
            "conv_k": dense_init((s.conv_width, conv_dim), generator, device,
                                 scale=0.5, lead=lead),
            "A_log": const(torch.log(torch.linspace(1.0, 16.0, H))),
            "D": const(torch.ones(H)),
            "dt_bias": const(torch.zeros(H)),
            "norm_scale": const(torch.ones(d_in)),
            "w_out": dense_init((d_in, d), generator, device, lead=lead)}


def _split_in(cfg: ModelConfig, proj):
    s = cfg.ssm
    d_in, _, _ = ssm_dims(cfg)
    gn = s.n_groups * s.d_state
    z = proj[..., :d_in]
    xBC = proj[..., d_in:d_in + d_in + 2 * gn]
    dt = proj[..., d_in + d_in + 2 * gn:]
    return z, xBC, dt


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(xBC, kernel):
    """Depthwise causal conv, width W: y[t] = sum_w k[w] * x[t-W+1+w]."""
    W = kernel.shape[0]
    S = xBC.shape[1]
    xp = F.pad(xBC, (0, 0, W - 1, 0))
    y = sum(kernel[w][None, None, :] * xp[:, w:w + S, :] for w in range(W))
    return apply_activation(y, "silu")


def ssd_chunked(x, dt, A, B, C, chunk: int, h0=None):
    """SSD scan.

    x:  (b, S, H, P)   dt: (b, S, H)   A: (H,) negative
    B, C: (b, S, G, N)
    Returns y (b, S, H, P) in x's dtype and the final state (b, H, P, N),
    fp32 state math.  The intra-chunk diagonal blocks and chunk states come
    from ``ops.ssd_chunk`` (decay ``exp(cs_i - cs_j)`` on a per-chunk
    cumsum; the reference forms the same decay from a masked cumsum of the
    steps).
    """
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    L = chunk
    S_orig = S
    if S % L != 0:
        # zero-pad the tail: dt == 0 there, so exp(dt*A) == 1 and x*dt == 0 —
        # the padded steps are exact no-ops on the carried state
        pad = L - S % L
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
        S = S + pad
    nc = S // L
    rep = H // G
    dt = dt.to(torch.float32)
    xdt = x.to(torch.float32) * dt[..., None]            # fold dt into x
    dA = dt * A[None, None, :]                           # (b,S,H), negative
    xc = xdt.reshape(b, nc, L, H, P)
    Bc = B.to(torch.float32).reshape(b, nc, L, G, N)
    Cc = C.to(torch.float32).reshape(b, nc, L, G, N)
    dAc = dA.reshape(b, nc, L, H).permute(0, 1, 3, 2)    # (b,nc,H,L) view
    # head broadcast: one group is a stride-0 view (nothing copied)
    if G == 1:
        Bh = Bc.expand(b, nc, L, H, N)
        Ch = Cc.expand(b, nc, L, H, N)
    else:
        Bh = Bc.repeat_interleave(rep, dim=3)
        Ch = Cc.repeat_interleave(rep, dim=3)
    # --- intra-chunk diagonal blocks and chunk states (the kernel) ---
    y_diag, st = ops.ssd_chunk(xc, dAc, Bh, Ch)
    states = st.transpose(-1, -2)                        # (b,nc,H,P,N)
    # --- inter-chunk recurrence ---
    dA_cs = torch.cumsum(dAc, dim=-1)                    # (b,nc,H,L)
    chunk_decay = torch.exp(dA_cs[..., -1])              # (b,nc,H)
    h = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.to(torch.float32))
    h_prev = []
    for c in range(nc):                                  # state BEFORE chunk
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                  # (b,nc,H,P,N)
    state_decay = torch.exp(dA_cs).permute(0, 1, 3, 2)   # (b,nc,L,H)
    y_off = torch.einsum("bclgn,bcgrpn->bclgrp", Cc,
                         h_prev.reshape(b, nc, G, rep, P, N))
    y_off = y_off.reshape(b, nc, L, H, P) * state_decay[..., None]
    y = (y_diag + y_off).reshape(b, S, H, P)[:, :S_orig]
    return y.to(x.dtype), h


def ssd_reference(x, dt, A, B, C, h0=None):
    """O(S) sequential oracle (per-token recurrence) for tests."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    Bh = B.to(torch.float32).repeat_interleave(rep, dim=2)
    Ch = C.to(torch.float32).repeat_interleave(rep, dim=2)
    dt = dt.to(torch.float32)
    x32 = x.to(torch.float32)
    h = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.to(torch.float32))
    ys = []
    for t in range(S):
        dA = torch.exp(dt[:, t] * A[None, :])
        h = h * dA[:, :, None, None] + torch.einsum(
            "bhn,bhp->bhpn", Bh[:, t], x32[:, t] * dt[:, t, :, None])
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype), h


# =========================================================================
# full mamba2 block
# =========================================================================
def _gate_norm(p, cfg: ModelConfig, y, z):
    return apply_norm({"scale": p["norm_scale"]},
                      y * apply_activation(z, "silu"), "rms", cfg.norm_eps)


def _channels(bk):
    """This rank's conv channels (a slice) when the step's layout cuts
    them over "model", else None."""
    lay = bk.ssm
    if lay is None or not lay.channels:
        return None
    return slice(lay.chan_lo, lay.chan_lo + lay.n_chans)


def _conv_inputs(xBC, kernel, bk):
    """xBC and the conv kernel of the rank's channels: the rank's block of
    the whole xBC (``split_grad``: in a train step its gradient is
    gathered whole), and the kernel's block where it arrives whole (a
    serving step; a train step's is the rank's piece already)."""
    ch = _channels(bk)
    if ch is None:
        return xBC, kernel
    if kernel.shape[-1] == xBC.shape[-1]:
        kernel = kernel[:, ch]
    return coll.split_grad(xBC, bk.mesh, "model", dim=-1), kernel


def _join(y, bk, dim):
    """The rank's block ``y`` gathered whole over "model" on ``dim`` (a
    concatenation: exact), differentiably (``all_gather_split``: in a train
    step the gradient, whole on every rank, comes back as the block's)."""
    return coll.all_gather_split(y.contiguous(), bk.mesh, "model", dim=dim)


def _join_channels(y, bk):
    """The conv output of the rank's channels gathered whole over
    "model"."""
    if _channels(bk) is None:
        return y
    return _join(y, bk, -1)


def _head_inputs(cfg: ModelConfig, p, xBC, dt, bk, lead):
    """The SSD inputs of the step's heads: every head, or under a layout
    that cuts them the rank's heads [head_lo, head_lo + n_heads) with the
    B/C of their groups.  ``xBC`` (lead..., conv_dim) is the whole conv
    output, ``dt`` (lead..., H) the raw step sizes.  Returns x (lead..., h,
    P), B and C (lead..., g, N), dt after softplus (float32), A, and D.

    Under the layout x's heads are the rank's block of the whole tensor
    (``split_grad``), and the B/C of its groups a block of the groups where
    the ranks' blocks tile them, else (ranks sharing one group) a slice of
    the whole entering through ``copy_to_model``, whose backward sums the
    ranks' gradients.  The per-head leaves (``A_log``, ``D``, ``dt_bias``)
    arrive whole in a serving step: softplus and exp run over every head
    before the rank's are taken (an elementwise op on a slice may take
    another vector path on the CPU than on the whole); in a train step they
    are the rank's pieces (``partition.forward_leaf``)."""
    s = cfg.ssm
    d_in, H, _ = ssm_dims(cfg)
    P, N, G = s.head_dim, s.d_state, s.n_groups
    xs = xBC[..., :d_in]
    Bm = xBC[..., d_in:d_in + G * N].reshape(*lead, G, N)
    Cm = xBC[..., d_in + G * N:d_in + 2 * G * N].reshape(*lead, G, N)
    dt = dt.to(torch.float32)
    A_log, D, dt_bias = p["A_log"], p["D"], p["dt_bias"]
    lay = bk.ssm
    if lay is None or not lay.heads:
        return (xs.reshape(*lead, H, P), Bm, Cm, _softplus(dt + dt_bias),
                -torch.exp(A_log), D)
    mesh = bk.mesh

    def block(t, dim=-1):
        return coll.split_grad(t, mesh, "model", dim=dim)

    def groups(t):
        if lay.n_groups * mesh.axis_size("model") == G:
            return block(t, -2)
        g = slice(lay.group_lo, lay.group_lo + lay.n_groups)
        return coll.copy_to_model(t, mesh)[..., g, :]

    if dt_bias.shape[-1] == H:
        dt = block(_softplus(dt + dt_bias))
        A, D = block(-torch.exp(A_log)), block(D)
    else:
        dt = _softplus(block(dt) + dt_bias)
        A = -torch.exp(A_log)
    return (block(xs).reshape(*lead, lay.n_heads, P), groups(Bm),
            groups(Cm), dt, A, D)


def _join_heads(y, bk):
    """y (..., h, P) of the rank's heads gathered over "model" into every
    head (exact) when the layout cuts them."""
    lay = bk.ssm
    if lay is None or not lay.heads:
        return y
    return _join(y, bk, -2)


def ssm_forward(p, cfg: ModelConfig, x, *, transpose=False,
                return_cache=False, backend=None):
    """Full-sequence mamba2 block (train / prefill).  With
    ``return_cache`` it also returns {"h": the final state, "conv": the
    last min(S, W-1) pre-conv xBC rows}.

    A serving step on a mesh whose layout (``Backend.ssm``) cuts the SSM
    caches: ``w_in``'s output is gathered whole (its column split does not
    fall on the z | xBC | dt bounds); the depthwise conv runs on the rank's
    channels and is all-gathered; ``ssd_chunk`` scans the rank's heads
    (with every group's B/C they read) and ``h`` keeps them; y is gathered
    over the heads before the gated RMSNorm (exact: the norm spans all of
    d_in), and ``w_out`` takes the whole normed y by its own rule (no
    ``tp_hint``, as in the reference: column where "model" divides d).  The
    conv tail keeps the rank's channels of the second ``w_in`` dot.  A
    train step on a mesh runs the same cuts on the rank's pieces of
    ``conv_k``, ``A_log``, ``D`` and ``dt_bias``; every cut and join is
    differentiable in Megatron's convention (``_conv_inputs``,
    ``_head_inputs``, ``_join``)."""
    bk = resolve_backend(backend)
    s = cfg.ssm
    B_, S, d = x.shape
    d_in, H, _ = ssm_dims(cfg)
    proj = bk.dot(x, cast(p["w_in"], x.dtype), transpose=False)
    z, xBC, dt = _split_in(cfg, proj)
    ch = _channels(bk)
    xBC = _join_channels(_causal_conv(*_conv_inputs(
        xBC, p["conv_k"].to(x.dtype), bk)), bk)
    xs, Bm, Cm, dt, A, D = _head_inputs(cfg, p, xBC, dt, bk, (B_, S))
    y, h_last = ssd_chunked(xs, dt, A, Bm, Cm, s.chunk)
    y = y + D.to(x.dtype)[None, None, :, None] * xs
    y = _join_heads(y, bk)
    y = _gate_norm(p, cfg, y.reshape(B_, S, d_in), z)
    out = bk.dot(y, cast(p["w_out"], x.dtype),
                 transpose=transpose and d_in == d)
    if return_cache:
        tail = _conv_tail(cfg, x, p, bk)
        return out, {"h": h_last,
                     "conv": tail if ch is None else tail[..., ch]}
    return out, None


def _conv_tail(cfg, x, p, backend=None):
    """Last (W-1) pre-conv xBC rows, for decode continuation: a second
    ``w_in`` dot over the last rows (its own A8 scale on the photonic
    backend), as in the reference — not a slice of the block's ``proj``."""
    bk = resolve_backend(backend)
    W = cfg.ssm.conv_width
    proj = bk.dot(x[:, -(W - 1):, :], cast(p["w_in"], x.dtype),
                  transpose=False)
    _, xBC, _ = _split_in(cfg, proj)
    return xBC


def ssm_decode(p, cfg: ModelConfig, x, cache, pos, *, transpose=False,
               backend=None):
    """Single-token recurrent step. x: (B,1,d).  Returns (out, full-slice
    cache update).  A conv cache shorter than W-1 rows (a prefill of fewer
    than W-1 tokens) reads its last row for the missing taps, as the
    reference's clamped indexing does.  Under a layout that cuts the
    caches (``ssm_forward``) the conv runs on the rank's channels against
    its ``conv`` piece and the state step on its heads against its ``h``
    piece."""
    bk = resolve_backend(backend)
    s = cfg.ssm
    B_, S, d = x.shape
    assert S == 1
    d_in, H, _ = ssm_dims(cfg)
    proj = bk.dot(x, cast(p["w_in"], x.dtype), transpose=False)
    z, xBC_new, dt = _split_in(cfg, proj)               # (B,1,*)
    ch = _channels(bk)
    kernel = p["conv_k"].to(x.dtype)
    if ch is not None:
        xBC_new, kernel = xBC_new[..., ch], kernel[:, ch]
    # causal conv against the cached tail
    hist = torch.cat([cache["conv"], xBC_new.to(cache["conv"].dtype)], dim=1)
    last = hist.shape[1] - 1
    conv_out = sum(kernel[w][None, :] * hist[:, min(w, last), :]
                   for w in range(s.conv_width))
    xBC = _join_channels(apply_activation(conv_out, "silu"), bk)[:, None, :]
    xs, Bm, Cm, dt, A, D = _head_inputs(cfg, p, xBC, dt[:, 0, :], bk, (B_,))
    rep = xs.shape[1] // Bm.shape[1]
    Bh = Bm.repeat_interleave(rep, dim=1).to(torch.float32)
    Ch = Cm.repeat_interleave(rep, dim=1).to(torch.float32)
    dA = torch.exp(dt * A[None, :])
    h = cache["h"] * dA[:, :, None, None] + torch.einsum(
        "bhn,bhp->bhpn", Bh, xs.to(torch.float32) * dt[..., None])
    # the read-out C h as a product and a sum over N: a head's bits do not
    # depend on the heads beside it (a batched matmul's do on the card)
    y = (Ch[:, :, None, :] * h).sum(-1)
    y = y.to(x.dtype) + D.to(x.dtype)[None, :, None] * xs
    y = _join_heads(y, bk)
    y = _gate_norm(p, cfg, y.reshape(B_, 1, d_in), z)
    out = bk.dot(y, cast(p["w_out"], x.dtype),
                 transpose=transpose and d_in == d)
    return out, {"h": h, "conv": hist[:, 1:, :]}


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device, lead=()):
    """Zero decode cache; ``lead`` prepends the [R, T] axes."""
    s = cfg.ssm
    _, H, conv_dim = ssm_dims(cfg)
    lead = tuple(lead)
    return {"h": torch.zeros(lead + (batch, H, s.head_dim, s.d_state),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros(lead + (batch, s.conv_width - 1, conv_dim),
                                dtype=dtype, device=device)}
