"""The port's dense model forward against the JAX reference on the same
weights (bridged through numpy), in every mode: train, prefill,
prefill_chunk and decode with a scalar and a per-slot (B,) position.

Tolerances: xla execution rel-L2 <= 1e-5 (float32 matmuls and softmax
summed in another order); photonic rel-L2 <= 1e-3 — the A8 activation
grid is per tensor, and a float32 difference of one ulp can move a value
across a rounding boundary (a flip of one int8 step), which then moves the
logits by far more than an ulp.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import api as j_api
from repro.configs.base import ModelConfig as JCfg
from repro.core.backend import Backend as JBackend
from repro.core.prm import ReuseConfig as JRC
from repro.models import transformer as j_tfm
from repro.train.checkpoint import _flatten

from repro_torch import bridge
from repro_torch.configs.base import ModelConfig as TCfg
from repro_torch.core import prepared as t_prep
from repro_torch.core.backend import Backend as TBackend
from repro_torch.core.prm import ReuseConfig as TRC
from repro_torch.models import transformer as t_tfm

torch.set_num_threads(2)
TOL = {"xla": 1e-5, "photonic": 1e-3}
B, S, L = 2, 12, 20


@functools.lru_cache(maxsize=None)
def _model(kind):
    """(jax cfg, torch cfg, jax params, torch params): a tiny dense stack,
    or an R&B stack (R=2 x T=4 with group shuffle and transpose)."""
    kw = dict(name="t", family="dense", num_layers=2, d_model=32,
              num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=128,
              compute_dtype="float32")
    jr = tr = None
    if kind == "rb":
        kw["num_layers"] = 8
        t = ("identity", "shuffle", "transpose", "shuffle")
        jr = JRC(num_basic=2, reuse_times=4, transforms=t, shuffle_groups=8)
        tr = TRC(num_basic=2, reuse_times=4, transforms=t, shuffle_groups=8)
    jc, tc = JCfg(reuse=jr, **kw), TCfg(reuse=tr, **kw)
    params, _ = j_tfm.init_model(jax.random.PRNGKey(0), jc)
    return jc, tc, params, bridge.params_from_flat(_flatten(params),
                                                   device="cpu")


def _banks(kind, execution):
    jc, tc, params, tp = _model(kind)
    photonic = execution == "photonic"
    return (jc, tc, j_api._prepare_cell(params, cfg=jc, photonic=photonic),
            t_prep.prepare_params(tp, "float32", photonic))


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _tokens(seed=0, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, 128, shape).astype(
        np.int32)


def _run(jc, tc, jbank, tbank, toks, mode, execution, jcache=None,
         tcache=None, pos=None):
    jl, jcache, _ = j_tfm.forward(jbank, jc, {"tokens": jnp.asarray(toks)},
                                  mode=mode, caches=jcache, pos=pos,
                                  execution=execution[0])
    tpos = pos
    if isinstance(pos, np.ndarray):
        tpos = torch.as_tensor(pos)
    tl, tcache, _ = t_tfm.forward(tbank, tc,
                                  {"tokens": torch.as_tensor(toks).long()},
                                  mode=mode, caches=tcache, pos=tpos,
                                  execution=execution[1])
    return np.asarray(jl), tl.numpy(), jcache, tcache


def _cache_rel(jcache, tcache):
    worst = 0.0
    for li, c in jcache["main"].items():
        for kv in ("k", "v"):
            worst = max(worst, _rel(tcache["main"][li][kv].numpy(),
                                    np.asarray(c[kv])))
    return worst


def _clone(tcache):
    return {s: {li: {k: t.clone() for k, t in c.items()}
                for li, c in seg.items()} for s, seg in tcache.items()}


@pytest.mark.parametrize("kind,execution", [
    ("dense", "xla"), ("dense", "photonic"), ("rb", "xla"),
    ("rb", "photonic")])
def test_forward_modes_match_reference(kind, execution):
    jc, tc, jbank, tbank = _banks(kind, execution)
    ex = (execution, execution)
    tol = TOL[execution]
    toks = _tokens()
    # ---- train (no caches)
    jl, tl, _, _ = _run(jc, tc, jbank, tbank, toks, "train", ex)
    assert tl.shape == jl.shape == (B, S, jc.padded_vocab)
    assert _rel(tl, jl) <= tol
    # ---- prefill into capacity caches
    jcache = j_tfm.init_caches(jc, B, L, dtype=jnp.float32)
    tcache = t_tfm.init_caches(tc, B, L, dtype=torch.float32, device="cpu")
    jl, tl, jpre, tpre = _run(jc, tc, jbank, tbank, toks, "prefill", ex,
                              jcache, tcache)
    assert _rel(tl, jl) <= tol and _cache_rel(jpre, tpre) <= tol
    # ---- decode, aligned (scalar position) and per-slot (B,) positions
    step = _tokens(1, (B, 1))
    for pos in (S, np.array([S, S - 3], np.int32)):
        jl, tl, jc2, tc2 = _run(jc, tc, jbank, tbank, step, "decode", ex,
                                jpre, _clone(tpre), pos=pos)
        assert tl.shape == (B, 1, jc.padded_vocab)
        assert _rel(tl, jl) <= tol and _cache_rel(jc2, tc2) <= tol
    # ---- chunked prefill: two 6-wide chunks into empty capacity caches
    jcache = j_tfm.init_caches(jc, B, L, dtype=jnp.float32)
    tcache = t_tfm.init_caches(tc, B, L, dtype=torch.float32, device="cpu")
    for off in (0, 6):
        jl, tl, jcache, tcache = _run(jc, tc, jbank, tbank,
                                      toks[:, off:off + 6], "prefill_chunk",
                                      ex, jcache, tcache, pos=off)
        assert _rel(tl, jl) <= tol
    assert _cache_rel(jcache, tcache) <= tol


def test_flash_prefill_and_chunks_match_reference():
    """Photonic with flash engaged (``flash_min_seq`` lowered): monolithic
    and chunked prefill through the flash path on both sides."""
    jc, tc, jbank, tbank = _banks("rb", "photonic")
    ex = (JBackend("photonic", flash_min_seq=6),
          TBackend("photonic", flash_min_seq=6))
    toks = _tokens(2)
    jcache = j_tfm.init_caches(jc, B, L, dtype=jnp.float32)
    tcache = t_tfm.init_caches(tc, B, L, dtype=torch.float32, device="cpu")
    jl, tl, _, _ = _run(jc, tc, jbank, tbank, toks, "prefill", ex, jcache,
                        tcache)
    assert _rel(tl, jl) <= TOL["photonic"]
    jcache = j_tfm.init_caches(jc, B, L, dtype=jnp.float32)
    tcache = t_tfm.init_caches(tc, B, L, dtype=torch.float32, device="cpu")
    for off in (0, 6):
        jl, tl, jcache, tcache = _run(jc, tc, jbank, tbank,
                                      toks[:, off:off + 6], "prefill_chunk",
                                      ex, jcache, tcache, pos=off)
        assert _rel(tl, jl) <= TOL["photonic"]


def test_raw_weights_photonic_quantize_in_step():
    """Raw fp weights on the photonic backend quantize in-step, exactly
    like a prepared bank."""
    jc, tc, params, tp = _model("rb")
    toks = _tokens(3)
    jl, tl, _, _ = _run(jc, tc, params, tp, toks, "train",
                        ("photonic", "photonic"))
    assert _rel(tl, jl) <= TOL["photonic"]
    tbank = t_prep.prepare_params(tp, "float32", True)
    tl2 = t_tfm.forward(tbank, tc, {"tokens": torch.as_tensor(toks).long()},
                        mode="train", execution="photonic")[0]
    torch.testing.assert_close(tl2, torch.as_tensor(tl), rtol=0, atol=0)


def test_torch_init_uses_reference_scales():
    _, tc, _, _ = _model("rb")
    p = t_tfm.init_model(tc, seed=0, device="cpu")
    wq = p["segments"]["main"]["l0"]["mixer"]["wq"]
    assert tuple(wq.shape) == (2, 32, 32)                 # R stacked copies
    assert abs(float(wq.std()) - 1 / np.sqrt(32)) < 0.03
    assert abs(float(p["embed"]["table"].std()) - 0.02) < 0.003
    assert tuple(p["lm_head"]["w"].shape) == (32, tc.padded_vocab)
    torch.testing.assert_close(p["final_norm"]["scale"], torch.ones(32))
    q = t_tfm.init_model(tc, seed=0, device="cpu")
    torch.testing.assert_close(q["embed"]["table"], p["embed"]["table"])
