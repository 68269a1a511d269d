"""Plain PyTorch oracles (partial port of ``repro.kernels.ref``).

These are the reference's allclose targets written in torch: the direct
dequantized matmuls, the fused-MVM composition, the blocked blend shuffle,
the full-softmax attention with the flash kernel's layout contract and the
intra-chunk SSD algebra.
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30


def photonic_mvm_ref(xq, wq, x_scale, w_scale, qmax=127.0):
    """Direct dequantized matmul: xq (M,K) @ wq (K,N), per-column scales."""
    xf = xq.to(torch.float32) * x_scale
    wf = wq.to(torch.float32) / qmax * w_scale.reshape(1, -1)
    return xf @ wf


def photonic_mvm_t_ref(xq, wq, x_scale, w_scale, qmax=127.0):
    """xq (M,K) @ wq (N,K).T with per-row weight scales."""
    xf = xq.to(torch.float32) * x_scale
    wf = wq.to(torch.float32) / qmax * w_scale.reshape(-1, 1)
    return xf @ wf.T


def photonic_mvm_resident_ref(xq, wq, x_scales, w_scale, qmax=127.0):
    """Per-stream ``photonic_mvm_ref``, stacked: xq (T,M,K) with one A8
    scale per stream — residency is a schedule property, not a numerics
    one."""
    return torch.stack([photonic_mvm_ref(xq[t], wq, x_scales[t], w_scale,
                                         qmax=qmax)
                        for t in range(xq.shape[0])])


def photonic_mvm_fused_ref(x, wq, x_scale, w_scale, *, transpose=False,
                           bias=None, block_perm=None, block=0,
                           activation="none", qmax=127.0):
    """Explicit A8 quantization at the given scale (the round runs in x's
    dtype), the dequantized matmul, then the blend epilogue."""
    xq = torch.clamp(torch.round(x / x_scale.to(x.dtype)),
                     -qmax - 1.0, qmax).to(torch.float32)
    if transpose:
        y = photonic_mvm_t_ref(xq, wq, x_scale, w_scale, qmax=qmax)
    else:
        y = photonic_mvm_ref(xq, wq, x_scale, w_scale, qmax=qmax)
    y = y.to(x.dtype)
    if bias is None and block_perm is None and activation == "none":
        return y
    C = y.shape[-1]
    b = torch.zeros((C,), dtype=y.dtype, device=y.device) if bias is None \
        else bias
    if block_perm is None:
        perm, blk = np.arange(1), C
    else:
        perm, blk = np.asarray(block_perm), block
    return blend_shuffle_ref(y, b, perm, blk, activation=activation)


def blend_shuffle_ref(x, bias, block_perm, block, activation="relu"):
    """``y[:, blk j] = act(x[:, blk perm[j]] + bias[blk j])``."""
    M, C = x.shape
    perm = np.asarray(block_perm)
    idx = (perm[:, None] * block + np.arange(block)[None, :]).reshape(-1)
    y = x[:, torch.as_tensor(idx, device=x.device)] + bias.reshape(1, C)
    if activation == "relu":
        y = torch.clamp(y, min=0.0)
    elif activation == "silu":
        y = y * (1.0 / (1.0 + torch.exp(-y)))   # jax.nn.sigmoid's rounding
    return y.to(x.dtype)


def flash_attention_ref(q, k, v, causal=True, q_offset=0, kv_len=None):
    """Full-softmax attention with the flash kernel's layout contract:
    q (BH_q, Sq, hd), k (BH_kv, L, hd), v (BH_kv, L, hd_v); query row b
    reads kv row b // (BH_q // BH_kv); causal mask on absolute positions
    (query i at q_offset + i) and keys at or past ``kv_len`` masked."""
    BHq, Sq, hd = q.shape
    BHkv, L, _ = k.shape
    G = BHq // BHkv
    if G > 1:
        k = k.repeat_interleave(G, dim=0)
        v = v.repeat_interleave(G, dim=0)
    s = torch.einsum("bqh,bkh->bqk", q.float(), k.float()) / (hd ** 0.5)
    kj = torch.arange(L, device=q.device)[None, :]
    mask = kj < (L if kv_len is None else kv_len)
    if causal:
        qi = q_offset + torch.arange(Sq, device=q.device)[:, None]
        mask = mask & (qi >= kj)
    s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkh->bqh", p, v.float()).to(q.dtype)


def ssd_chunk_ref(x, dA, B, C):
    """Oracle for the intra-chunk SSD kernel (the reference's
    ``ref.ssd_chunk_ref``): x (b, nc, L, H, P) dt-folded, dA (b, nc, H, L),
    B/C (b, nc, L, H, N) head-broadcast.  Returns y (b, nc, L, H, P) and
    states (b, nc, H, N, P), float32."""
    L = x.shape[2]
    x, dA, Bh, Ch = (t.to(torch.float32) for t in (x, dA, B, C))
    cs = torch.cumsum(dA, dim=-1)                          # (b,nc,H,L)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    Lmat = torch.exp(seg.masked_fill(~mask, float("-inf")))
    scores = torch.einsum("bclhn,bcshn->bchls", Ch, Bh)
    y = torch.einsum("bchls,bcshp->bclhp", scores * Lmat, x)
    decay = torch.exp(cs[..., -1:] - cs)                   # (b,nc,H,L)
    st = torch.einsum("bclhn,bclhp->bchnp",
                      Bh * decay.permute(0, 1, 3, 2)[..., None], x)
    return y, st
