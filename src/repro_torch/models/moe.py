"""Mixture-of-Experts FFN with grouped capacity dispatch (port of
``repro.models.moe``, GShard style).

Tokens are split into fixed-size *groups* (``MoEConfig.group_tokens``); each
group routes independently with capacity ``C = ceil(g/E * top_k * cf)``.
Dense one-hot dispatch/combine einsums keep every shape static, and both
FLOPs and memory stay linear in tokens (O(tokens * E * C_g), C_g fixed by
the group size).

DeepSeek-V2-style *shared experts* (always-on) are a plain dense MLP added
to the routed output.  The OBU transpose on a routed expert swaps its
up/down projections exactly like the dense MLP (``layers.apply_mlp``).

With ``num_basic_experts`` = R_e < E the E logical experts are *blended*
from R_e basic experts (PRM across the expert dimension): expert e reuses
bank e % R_e, so the photonic path streams the E / R_e logical experts of
each bank through the reuse-resident kernel (``Backend.reuse_dot``).

A train step on a mesh runs expert parallelism over "model"
(``Backend.experts``, a ``partition.ExpertLayout``): a rank holds basic
banks [lo, lo + n) and runs the logical experts that reuse them, the
capacity buffers taken in the reuse-major order that makes its experts a
block of each reuse (:func:`_local`); routing stays whole and float32 on
every rank, and the ranks' partial combines are summed over "model", as
the reference's expert-sharded combine is partitioned.

What the port matches of the reference, besides the arithmetic:

  * top-k tie order: ``jax.lax.top_k`` sorts descending and puts the lower
    index first among equal values; ``torch.topk`` promises no tie order,
    so :func:`route` takes a stable descending sort;
  * the combine weights are rounded to bf16 (the one-hots are built in
    bf16) even in float32 models, then cast to the activation dtype;
  * capacity couples rows: the per-group capacity and the cumulative
    position drop tokens in row order, so idle scheduler slots and bucket
    or chunk padding change routing — the callers feed the reference's
    exact rows.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.core.backend import resolve as resolve_backend
from repro_torch.core.obu import group_shuffle_permutation
from repro_torch.kernels.photonic_mvm import apply_activation
from repro_torch.models.layers import apply_mlp, cast, dense_init, init_mlp


def init_moe(d_model: int, mcfg: MoEConfig, generator, device, lead=()):
    """Router (scale 0.02), expert banks ``(R_e, d, f)`` / ``(R_e, f, d)``
    with the reference's default scale (1/sqrt of the bank's first dim, as
    ``_dense_init`` computes it) and the optional shared MLP."""
    E, f = mcfg.num_experts, mcfg.d_ff_expert
    Ep = mcfg.num_basic_experts or E    # PRM across experts (R_e physical)
    p = {"router": dense_init((d_model, E), generator, device, scale=0.02,
                              lead=lead),
         "w_gate": dense_init((Ep, d_model, f), generator, device, lead=lead),
         "w_up": dense_init((Ep, d_model, f), generator, device, lead=lead),
         "w_down": dense_init((Ep, f, d_model), generator, device,
                              lead=lead)}
    if mcfg.num_shared:
        d_sh = mcfg.d_ff_shared or f * mcfg.num_shared
        p["shared"] = init_mlp(d_model, d_sh, generator, device, lead=lead)
    return p


def _group_shape(n_tokens: int, mcfg: MoEConfig):
    g = min(mcfg.group_tokens, n_tokens)
    while n_tokens % g != 0:          # static search: g divides tokens
        g -= 1
    return n_tokens // g, g


def _capacity(g: int, mcfg: MoEConfig) -> int:
    cap = -(-g // mcfg.num_experts) * mcfg.top_k
    cap = int(cap * mcfg.capacity_factor)
    return max(min(cap, g), mcfg.top_k)


def _local(t, lay, dim: int = -1):
    """The rank's experts of ``t``'s expert dim ``dim`` (E logical experts,
    ``t * R_e + r``) under an ``ExpertLayout``: the (T, R_e) view's block
    of basic banks [lo, lo + n), reuse-major (a view: no index tensor)."""
    dim = dim % t.ndim
    v = t.unflatten(dim, (t.shape[dim] // lay.basic, lay.basic))
    return v.narrow(dim + 1, lay.lo, lay.n).flatten(dim, dim + 1)


def route(p, xg, mcfg: MoEConfig, experts=None, mesh=None):
    """Per-group routing in float32.  xg: (G, g, d).

    Returns dispatch (G,g,E,C), combine (G,g,E,C) — both bf16 — and the aux
    losses.  Tokens beyond an expert's capacity are dropped.  With
    ``experts`` (a train step's ``partition.ExpertLayout`` on ``mesh``)
    the routing, the drops and the aux are still the whole ones, and the
    dispatch and combine are those of the rank's experts only
    (:func:`_local`); their combine weights enter through
    ``copy_to_model``, so the router and the rows get the ranks' gradients
    summed."""
    G, g, d = xg.shape
    E, K = mcfg.num_experts, mcfg.top_k
    C = _capacity(g, mcfg)
    logits = xg.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k order: descending, lower index first among ties
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :K], idx[..., :K]          # (G,g,K)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    # one_hot as a comparison: on the CPU ``F.one_hot`` reads its input's
    # range back to the host (``.item()``), which a decode step must not do
    sel = (gate_idx[..., None] == torch.arange(E, device=xg.device)).to(
        torch.float32)
    mask = sel.amax(dim=2)                                     # (G,g,E)
    pos_in_e = torch.cumsum(mask, dim=1) - 1.0                 # (G,g,E)
    keep = (pos_in_e < C).to(torch.float32) * mask
    # one nonzero term per (token, expert): exact
    weight_ge = (sel * gate_vals[..., None]).sum(dim=2) * keep
    frac_tokens = mask.mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    aux = {"load_balance": E * (frac_tokens * frac_probs).sum(),
           "dropped_frac": 1.0 - keep.sum() / (G * g * K)}
    if experts is not None:
        from repro_torch.sharding import collectives as coll
        weight_ge = _local(coll.copy_to_model(weight_ge, mesh), experts)
        keep, pos_in_e = _local(keep, experts), _local(pos_in_e, experts)
    # the (G,g,E,C) one-hots are bf16, as in the reference: the combine
    # weights round to bf16 even in a float32 model
    slots = torch.arange(C, device=xg.device, dtype=torch.int32)
    pos_oh = (pos_in_e.to(torch.int32)[..., None] == slots).to(
        torch.bfloat16)
    dispatch = pos_oh * keep.to(torch.bfloat16)[..., None]
    combine = pos_oh * weight_ge.to(torch.bfloat16)[..., None]
    return dispatch, combine, aux


def _blended(mcfg: MoEConfig) -> bool:
    return bool(mcfg.num_basic_experts
                and mcfg.num_basic_experts < mcfg.num_experts)


def _expert_weights(p, mcfg: MoEConfig, dtype, lay=None):
    """Effective (E, ...) expert banks: with ``num_basic_experts`` set,
    expert e reuses basic e % R_e.  Under an ``ExpertLayout`` ``lay`` the
    banks are the rank's n and its T * n experts (reuse-major) reuse bank
    j % n."""
    wg, wu, wd = (cast(p[k], dtype) for k in ("w_gate", "w_up", "w_down"))
    if lay is not None and wg.shape[0] != lay.n:
        raise ValueError(f"an expert layout of {lay.n} banks a rank, got "
                         f"{wg.shape[0]}")
    if _blended(mcfg):
        nb = wg.shape[0]
        E = mcfg.num_experts * nb // mcfg.num_basic_experts
        idx = torch.arange(E, device=wg.device) % nb
        wg, wu, wd = wg[idx], wu[idx], wd[idx]
    return wg, wu, wd


@functools.lru_cache(maxsize=16)
def _expert_gate_perms(mcfg: MoEConfig, device=None) -> torch.Tensor:
    """(E, f) static permutation table for the blended experts' gate
    activations; identity for basic (first-use) experts.  Expert e is
    reuse ``e // R_e`` of its bank.  Kept on ``device`` once per config:
    a host-to-device copy per layer would make the host wait."""
    E, f = mcfg.num_experts, mcfg.d_ff_expert
    Rp = mcfg.num_basic_experts
    perms = np.tile(np.arange(f), (E, 1))
    for e in range(E):
        t = e // Rp                    # reuse index of this expert
        if t > 0:
            g = min(4 * t, max(2, f // 2))
            if f % g:
                g = 2
            perms[e] = group_shuffle_permutation(f, g)
    return torch.as_tensor(perms, dtype=torch.long, device=device)


def _photonic_expert_ffn(bk, p, xe, mcfg: MoEConfig, dtype, transpose):
    """Expert FFN on the photonic backend.  With PRM-blended experts the
    E / R_e logical experts of a bank stream through the reuse-resident
    kernel (stream j of bank r is logical expert ``r + j * R_e``); the
    transposed banks (``W_down.T`` as up-projection, ``W_gate.T`` as
    down-projection) run E per-expert fused dots, the gate's silu in the
    kernel's epilogue."""
    G, E, C, d = xe.shape
    rows = xe.permute(1, 0, 2, 3).reshape(E, G * C, d)
    wg, wu, wd = (cast(p[k], dtype) for k in ("w_gate", "w_up", "w_down"))
    nb = wg.shape[0]                       # R_e physical banks (== E if none)
    blended = nb < E

    def bank_dot(h, w_bank, transpose_w=False, activation=None):
        if blended and not transpose_w and E % nb == 0:
            # (R_e, T, M, n) -> (T, R_e, M, n): row j * R_e + r is expert e
            ys = [bk.reuse_dot(h[r::nb], w_bank[r]) for r in range(nb)]
            y = torch.stack(ys, dim=1).reshape(E, *ys[0].shape[1:])
            return apply_activation(y, activation)
        return torch.stack([bk.dot(h[e], w_bank[e % nb], transpose=transpose_w,
                                   activation=activation)
                            for e in range(E)])

    if transpose:
        gate = bank_dot(rows, wd, transpose_w=True,   # W_down.T as up-proj
                        activation="silu")
        up = bank_dot(rows, wu)
        out = bank_dot(gate * up, wg, transpose_w=True)  # W_gate.T: down
    else:
        if blended:
            # the reuse_dot output, then the static gather, then silu
            gate = bank_dot(rows, wg)                     # (E, M, f)
            perms = _expert_gate_perms(mcfg, gate.device)  # (E, f)
            gate = torch.gather(gate, -1,
                                perms[:, None, :].expand(gate.shape))
            gate = apply_activation(gate, "silu")
        else:
            gate = bank_dot(rows, wg, activation="silu")
        up = bank_dot(rows, wu)
        out = bank_dot(gate * up, wd)
    return out.reshape(E, G, C, d).permute(1, 0, 2, 3)


def _einsum(eq, a, b, dtype):
    """einsum with float32 accumulation, cast to ``dtype`` (the
    reference's dot_general with a float32 preferred element type)."""
    return torch.einsum(eq, a.to(torch.float32), b.to(torch.float32)).to(dtype)


def expert_ffn(p, xe, mcfg: MoEConfig, transpose: bool = False, lay=None):
    """The xla expert FFN of the capacity buffers xe (G, E, C, d): gate, up
    and down per expert with float32 accumulation, the OBU-transposed swap,
    and the blended experts' static gate shuffle.  Under an
    ``ExpertLayout`` ``lay``, xe holds the rank's experts (reuse-major, as
    :func:`_local` orders them) and ``p`` the rank's banks: each expert
    runs the same dots as in the whole call."""
    dtype = xe.dtype
    wg, wu, wd = _expert_weights(p, mcfg, dtype, lay)
    if transpose:
        gate = _einsum("necd,efd->necf", xe, wd, dtype)        # W_down.T
        up = _einsum("necd,edf->necf", xe, wu, dtype)
        h = apply_activation(gate, "silu") * up
        return _einsum("necf,edf->necd", h, wg, dtype)         # W_gate.T
    gate = _einsum("necd,edf->necf", xe, wg, dtype)
    if _blended(mcfg):
        perms = _expert_gate_perms(mcfg, xe.device)            # (E, f)
        if lay is not None:
            perms = _local(perms, lay, dim=0)
        gate = torch.gather(gate, -1, perms[None, :, None, :].expand(
            gate.shape))
    up = _einsum("necd,edf->necf", xe, wu, dtype)
    h = apply_activation(gate, "silu") * up
    return _einsum("necf,efd->necd", h, wd, dtype)


def apply_moe(p, x, mcfg: MoEConfig, transpose: bool = False, backend=None):
    """x: (B, S, d) -> ((B, S, d), aux losses).

    Routing stays float32 on every backend; only the expert FFN banks
    route through the photonic kernels.  A train step whose banks are the
    rank's experts (``Backend.experts``, a ``partition.ExpertLayout``)
    routes whole, dispatches the rows (entering through ``copy_to_model``)
    to its own experts only, runs their FFN and combines them: each rank's
    partial sum over its experts, rounded to the activation dtype, is
    summed over "model" (``psum_grad``), as a row-parallel dot rejoins."""
    bk = resolve_backend(backend)
    B, S, d = x.shape
    G, g = _group_shape(B * S, mcfg)
    xg = x.reshape(G, g, d)
    lay = bk.experts
    if lay is not None and bk.is_photonic:
        raise NotImplementedError("an expert layout runs on the xla "
                                  "backend (a train step)")
    dispatch, combine, aux = route(p, xg, mcfg, experts=lay, mesh=bk.mesh)
    if lay is not None:
        from repro_torch.sharding import collectives as coll
        xg = coll.copy_to_model(xg, bk.mesh)
    # one nonzero term per output: exact in any dtype
    xe = torch.einsum("ngec,ngd->necd", dispatch.to(x.dtype), xg)
    if bk.is_photonic:
        ye = _photonic_expert_ffn(bk, p, xe, mcfg, x.dtype, transpose)
    else:
        ye = expert_ffn(p, xe, mcfg, transpose, lay)
    y = _einsum("ngec,necd->ngd", combine, ye, x.dtype).reshape(B, S, d)
    if lay is not None:
        y = coll.psum_grad(y, bk.mesh, "model")
    if "shared" in p:
        y = y + apply_mlp(p["shared"], x, act="swiglu", transpose=transpose,
                          backend=bk)
    return y, aux
