"""The gradient of ``ssd_chunk`` (``kernels/ssd.py``: a
``torch.autograd.Function`` whose backward is the block's VJP written out
in float32 torch ops) against the JAX reference's VJPs on the same inputs
(numpy seeds):

* ``jax.vjp`` of the oracle ``ref.ssd_chunk_ref`` (what the Pallas kernel
  computes), with the group broadcast of B/C inside the function on both
  sides: one group as a stride-0 view over the heads (autograd sums the
  Function's per-head gradients back over the view), and two groups
  materialised by ``repeat_interleave``; at mamba2's decay spread and a
  slow one (every key of a query row and every state row weighs in).
* ``jax.vjp`` of the reference's ``ssd_chunked`` (the chunked scan the
  reference trains through as XLA einsums) against the port's, whose
  intra-chunk block is the Function: x, dt, A, B, C and an initial state,
  with S a multiple of the chunk and a ragged S, one group and two.

Tolerance: rel-L2 <= 1e-5 per gradient (float32 in another summation
order).  Also: the backward never runs the plain version (it is not
autograd through ``ssd_chunk_plain``), and on meta tensors the forward
plans one call and the backward shapes every gradient."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ref as j_ref
from repro.models import ssm as j_ssm

from repro_torch.kernels import planned
from repro_torch.kernels import ssd as t_ssd
from repro_torch.models import ssm as t_ssm

torch.set_num_threads(2)
TOL = 1e-5


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _chunk_inputs(seed, b, nc, L, H, P, N, G, decay):
    """dt-folded x, dA (b, nc, H, L), group-level B/C (b, nc, L, G, N) and
    the cotangents of y_diag and the states, float32 numpy."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((b, nc, L, H))))
    lo, hi = (1.0, 16.0) if decay == "mamba2" else (1e-3, 4e-3)
    A = -np.linspace(lo, hi, H)
    x = rng.standard_normal((b, nc, L, H, P)) * dt[..., None]
    dA = np.transpose(dt * A, (0, 1, 3, 2))
    Bg = rng.standard_normal((b, nc, L, G, N))
    Cg = rng.standard_normal((b, nc, L, G, N))
    gy = rng.standard_normal((b, nc, L, H, P))
    gst = rng.standard_normal((b, nc, H, N, P))
    return [a.astype(np.float32) for a in (x, dA, Bg, Cg, gy, gst)]


def _heads(t, H, G, lib):
    """Group-level B/C (..., G, N) broadcast to the H heads: a stride-0
    view for one group, ``repeat_interleave`` otherwise."""
    if lib == "jax":
        return jnp.repeat(t, H // G, axis=3)
    if G == 1:
        return t.expand(*t.shape[:3], H, t.shape[-1])
    return t.repeat_interleave(H // G, dim=3)


@pytest.mark.parametrize("decay", ["mamba2", "slow"])
@pytest.mark.parametrize("b,nc,L,H,P,N,G", [
    (2, 3, 16, 4, 8, 6, 1),          # one group: stride-0 B/C
    (1, 2, 24, 6, 5, 7, 2),          # two groups, materialised
    (1, 1, 64, 3, 16, 32, 1),        # one longer chunk
])
def test_vjp_matches_jax_vjp_of_ssd_chunk_ref(b, nc, L, H, P, N, G, decay):
    x, dA, Bg, Cg, gy, gst = _chunk_inputs(L + H + G, b, nc, L, H, P, N, G,
                                           decay)

    def jfn(x, dA, Bg, Cg):
        return j_ref.ssd_chunk_ref(x, dA, _heads(Bg, H, G, "jax"),
                                   _heads(Cg, H, G, "jax"))

    (jy, jst), vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (x, dA, Bg, Cg)))
    want = vjp((jnp.asarray(gy), jnp.asarray(gst)))
    ins = [torch.tensor(a, requires_grad=True) for a in (x, dA, Bg, Cg)]
    y, st = t_ssd.ssd_chunk(ins[0], ins[1], _heads(ins[2], H, G, "torch"),
                            _heads(ins[3], H, G, "torch"))
    assert _rel(y.detach(), jy) <= TOL and _rel(st.detach(), jst) <= TOL
    got = torch.autograd.grad((y, st), ins, (torch.as_tensor(gy),
                                             torch.as_tensor(gst)))
    for name, g, w in zip(("x", "dA", "B", "C"), got, want):
        assert g.shape == w.shape
        assert _rel(g, w) <= TOL, (name, _rel(g, w))


@pytest.mark.parametrize("S,G", [(32, 1), (27, 1), (32, 2), (21, 2)])
def test_vjp_matches_jax_vjp_of_ssd_chunked(S, G):
    """The chunked scan (chunk 8) with an initial state: the gradients of
    x, dt, A, B, C and h0 under cotangents of y and the final state."""
    rng = np.random.default_rng(S * 10 + G)
    b, H, P, N, chunk = 2, 4, 8, 6, 8
    x = rng.standard_normal((b, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H)))).astype(np.float32)
    A = -np.linspace(0.5, 4.0, H).astype(np.float32)
    B = rng.standard_normal((b, S, G, N)).astype(np.float32)
    C = rng.standard_normal((b, S, G, N)).astype(np.float32)
    h0 = rng.standard_normal((b, H, P, N)).astype(np.float32)
    gy = rng.standard_normal((b, S, H, P)).astype(np.float32)
    gh = rng.standard_normal((b, H, P, N)).astype(np.float32)

    def jfn(x, dt, A, B, C, h0):
        return j_ssm.ssd_chunked(x, dt, A, B, C, chunk, h0=h0)

    (jy, jh), vjp = jax.vjp(jfn, *(jnp.asarray(a)
                                   for a in (x, dt, A, B, C, h0)))
    want = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    ins = [torch.tensor(a, requires_grad=True)
           for a in (x, dt, A, B, C, h0)]
    y, h = t_ssm.ssd_chunked(*ins[:5], chunk, h0=ins[5])
    assert _rel(y.detach(), jy) <= TOL and _rel(h.detach(), jh) <= TOL
    got = torch.autograd.grad((y, h), ins, (torch.as_tensor(gy),
                                            torch.as_tensor(gh)))
    for name, g, w in zip(("x", "dt", "A", "B", "C", "h0"), got, want):
        assert _rel(g, w) <= TOL, (name, _rel(g, w))


def test_backward_is_not_autograd_through_the_plain_version(monkeypatch):
    """The forward runs the plain version once on the CPU; the backward
    runs :func:`ssd.ssd_chunk_vjp` on the saved inputs and never the plain
    version again."""
    x, dA, Bg, Cg, gy, gst = _chunk_inputs(0, 1, 2, 8, 2, 4, 3, 1, "slow")
    calls = {"plain": 0, "vjp": 0}
    plain, vjp = t_ssd.ssd_chunk_plain, t_ssd.ssd_chunk_vjp

    def count(key, fn):
        def wrapped(*a):
            calls[key] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(t_ssd, "ssd_chunk_plain", count("plain", plain))
    monkeypatch.setattr(t_ssd, "ssd_chunk_vjp", count("vjp", vjp))
    ins = [torch.tensor(a, requires_grad=True) for a in (x, dA, Bg, Cg)]
    y, st = t_ssd.ssd_chunk(ins[0], ins[1], _heads(ins[2], 2, 1, "torch"),
                            _heads(ins[3], 2, 1, "torch"))
    assert calls == {"plain": 1, "vjp": 0}
    assert y.grad_fn is not None and "SSDChunk" in type(y.grad_fn).__name__
    torch.autograd.grad((y, st), ins, (torch.as_tensor(gy),
                                       torch.as_tensor(gst)))
    assert calls == {"plain": 1, "vjp": 1}


def test_meta_tensors_plan_the_forward_and_shape_the_backward():
    """The dry-run's rule: on meta tensors the forward plans one
    ``ssd_chunk`` call (launching nothing) and the backward's torch ops
    give every gradient its shape."""
    b, nc, L, H, P, N = 2, 3, 16, 4, 8, 6
    x = torch.empty((b, nc, L, H, P), device="meta", requires_grad=True)
    dA = torch.empty((b, nc, H, L), device="meta", requires_grad=True)
    Bg = torch.empty((b, nc, L, 1, N), device="meta", requires_grad=True)
    Cg = torch.empty((b, nc, L, 1, N), device="meta", requires_grad=True)
    before = planned.snapshot()["ssd_chunk"]
    launches = t_ssd.launches
    y, st = t_ssd.ssd_chunk(x, dA, Bg.expand(b, nc, L, H, N),
                            Cg.expand(b, nc, L, H, N))
    assert planned.snapshot()["ssd_chunk"] == before + 1
    g = torch.autograd.grad((y.sum() + st.sum()), (x, dA, Bg, Cg))
    assert [tuple(t.shape) for t in g] == [tuple(t.shape)
                                          for t in (x, dA, Bg, Cg)]
    assert planned.snapshot()["ssd_chunk"] == before + 1
    assert t_ssd.launches == launches
