"""The port's Mamba-2 block and SSM/hybrid model forward against the JAX
reference on the same weights (bridged through numpy), float32.

* The block: ``ssm_forward`` (train and prefill with its cache),
  ``_conv_tail``, ``ssm_decode`` and ``init_ssm_cache``.
* Whole models: the mamba2 smoke variant on an R&B stack (R=2 x T=2,
  identity then shuffle) in every mode (train, prefill into caches, decode
  with a scalar and a per-slot position), and the jamba smoke variant
  (SSM, attention and MoE layers in one group of 8).
* Train logits on four prompts.
* Greedy ``Program.generate`` tokens identical to the reference's.

Tolerances: the port's model gates — rel-L2 <= 1e-5 on xla, <= 1e-3 on
photonic (a one-ulp float32 difference can flip a per-tensor A8
rounding).  jamba on photonic is held layer by layer instead, in
``tests/test_torch_ssm_jamba.py``: its whole-model logits move by more
than 1e-3 under a one-ulp input change in the reference itself.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import api as j_api
from repro.configs import smoke_variant as j_smoke
from repro.configs.archs import rb as j_rb
from repro.core import backend as j_bk
from repro.models import ssm as j_ssm
from repro.models import transformer as j_tfm
from repro.train.checkpoint import _flatten

from repro_torch import api as t_api
from repro_torch import bridge
from repro_torch.configs import smoke_variant as t_smoke
from repro_torch.configs.archs import rb as t_rb
from repro_torch.core import backend as t_bk
from repro_torch.core import prepared as t_prep
from repro_torch.core.sharing import tree_index
from repro_torch.models import ssm as t_ssm
from repro_torch.models import transformer as t_tfm

torch.set_num_threads(2)
TOL = {"xla": 1e-5, "photonic": 1e-3}
B, S, L = 2, 12, 16
V = 211


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


@functools.lru_cache(maxsize=None)
def _model(name):
    """(jax cfg, torch cfg, jax params, torch params): the mamba2 smoke
    variant with an R=2 x T=2 stack, or the jamba smoke variant."""
    jc, tc = j_smoke(name), t_smoke(name)
    if name == "mamba2-780m":
        jc, tc = j_rb(jc, 2, 2), t_rb(tc, 2, 2)
    params, _ = j_tfm.init_model(jax.random.PRNGKey(0), jc)
    return jc, tc, params, bridge.params_from_flat(_flatten(params),
                                                   device="cpu")


@functools.lru_cache(maxsize=None)
def _banks(name, execution):
    jc, tc, params, tp = _model(name)
    photonic = execution == "photonic"
    return (jc, tc, j_api._prepare_cell(params, cfg=jc, photonic=photonic),
            t_prep.prepare_params(tp, "float32", photonic))


def _tokens(seed=0, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, V, shape).astype(np.int32)


# -------------------------------------------------------------------------
# the block
# -------------------------------------------------------------------------
@pytest.mark.parametrize("execution", ["xla", "photonic"])
def test_ssm_block_matches_reference(execution):
    jc, tc, jbank, tbank = _banks("mamba2-780m", execution)
    jp = jax.tree.map(lambda a: a[1], jbank["segments"]["main"]["l0"]["mixer"])
    tp = tree_index(tbank["segments"]["main"]["l0"]["mixer"], 1)
    jbk, tbk = j_bk.resolve(execution), t_bk.resolve(execution)
    tol = TOL[execution]
    x = np.random.default_rng(5).standard_normal((B, S, jc.d_model)).astype(
        np.float32)
    # train (no cache) and prefill (final state + conv tail)
    jy, _ = j_ssm.ssm_forward(jp, jc, jnp.asarray(x), backend=jbk)
    ty, none = t_ssm.ssm_forward(tp, tc, torch.as_tensor(x), backend=tbk)
    assert none is None and _rel(ty, jy) <= tol
    jy, jcache = j_ssm.ssm_forward(jp, jc, jnp.asarray(x), return_cache=True,
                                   backend=jbk)
    ty, tcache = t_ssm.ssm_forward(tp, tc, torch.as_tensor(x),
                                   return_cache=True, backend=tbk)
    assert _rel(ty, jy) <= tol
    assert tcache["h"].dtype == torch.float32
    for k in ("h", "conv"):
        assert tuple(tcache[k].shape) == jcache[k].shape
        assert _rel(tcache[k], jcache[k]) <= tol
    jtail = j_ssm._conv_tail(jc, jnp.asarray(x), jp, jbk)
    ttail = t_ssm._conv_tail(tc, torch.as_tensor(x), tp, tbk)
    assert tuple(ttail.shape) == jtail.shape == (B, 3, 144)
    assert _rel(ttail, jtail) <= tol
    # decode: two steps from the reference's prefill cache
    jc_, tc_ = jcache, {k: torch.as_tensor(np.asarray(v))
                        for k, v in jcache.items()}
    for step in range(2):
        xt = np.random.default_rng(6 + step).standard_normal(
            (B, 1, jc.d_model)).astype(np.float32)
        jy, jc_ = j_ssm.ssm_decode(jp, jc, jnp.asarray(xt), jc_, S + step,
                                   backend=jbk)
        ty, tc_ = t_ssm.ssm_decode(tp, tc, torch.as_tensor(xt), tc_,
                                   S + step, backend=tbk)
        assert _rel(ty, jy) <= tol
        for k in ("h", "conv"):
            assert tuple(tc_[k].shape) == jc_[k].shape
            assert _rel(tc_[k], jc_[k]) <= tol


def test_init_ssm_cache_matches_reference():
    jc, tc, _, _ = _model("mamba2-780m")
    jcache = j_ssm.init_ssm_cache(jc, 3, jnp.bfloat16)
    tcache = t_ssm.init_ssm_cache(tc, 3, torch.bfloat16, "cpu")
    for k, dt in (("h", torch.float32), ("conv", torch.bfloat16)):
        assert tuple(tcache[k].shape) == jcache[k].shape
        assert tcache[k].dtype == dt and not tcache[k].any()
    lead = t_ssm.init_ssm_cache(tc, 3, torch.float32, "cpu", lead=(2, 2))
    assert tuple(lead["h"].shape) == (2, 2, 3, 8, 16, 8)
    assert tuple(lead["conv"].shape) == (2, 2, 3, 3, 144)


def test_softplus_is_logaddexp():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)``; the port evaluates the
    same formula (within an ulp of XLA's exp/log1p) on both sides of
    ``torch.nn.functional.softplus``'s threshold of 20."""
    x = np.array([-80.0, -30.0, -1.0, 0.0, 0.5, 19.0, 20.5, 25.0, 60.0],
                 np.float32)
    got = t_ssm._softplus(torch.as_tensor(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got, np.logaddexp(x.astype(np.float64), 0.0),
                               rtol=1e-6, atol=0)


# -------------------------------------------------------------------------
# whole models
# -------------------------------------------------------------------------
def _run(jc, tc, jbank, tbank, toks, mode, execution, jcache=None,
         tcache=None, pos=None):
    jl, jcache, _ = j_tfm.forward(jbank, jc, {"tokens": jnp.asarray(toks)},
                                  mode=mode, caches=jcache, pos=pos,
                                  execution=execution)
    tpos = torch.as_tensor(pos) if isinstance(pos, np.ndarray) else pos
    tl, tcache, _ = t_tfm.forward(tbank, tc,
                                  {"tokens": torch.as_tensor(toks).long()},
                                  mode=mode, caches=tcache, pos=tpos,
                                  execution=execution)
    return np.asarray(jl), tl.numpy(), jcache, tcache


def _cache_rel(jcache, tcache):
    worst = 0.0
    for li, c in jcache["main"].items():
        for k, v in c.items():
            assert tuple(tcache["main"][li][k].shape) == v.shape
            worst = max(worst, _rel(tcache["main"][li][k].numpy(),
                                    np.asarray(v)))
    return worst


def _clone(tcache):
    return {s: {li: {k: t.clone() for k, t in c.items()}
                for li, c in seg.items()} for s, seg in tcache.items()}


@pytest.mark.parametrize("name,execution", [
    ("mamba2-780m", "xla"), ("mamba2-780m", "photonic"),
    ("jamba-v0.1-52b", "xla")])
def test_forward_modes_match_reference(name, execution):
    jc, tc, jbank, tbank = _banks(name, execution)
    tol = TOL[execution]
    toks = _tokens()
    if name == "mamba2-780m":         # jamba's train logits = its prefill's
        jl, tl, _, _ = _run(jc, tc, jbank, tbank, toks, "train", execution)
        assert tl.shape == jl.shape == (B, S, jc.padded_vocab)
        assert _rel(tl, jl) <= tol
    jcache = j_tfm.init_caches(jc, B, L, dtype=jnp.float32)
    tcache = t_tfm.init_caches(tc, B, L, dtype=torch.float32, device="cpu")
    jl, tl, jpre, tpre = _run(jc, tc, jbank, tbank, toks, "prefill",
                              execution, jcache, tcache)
    assert _rel(tl, jl) <= tol and _cache_rel(jpre, tpre) <= tol
    step = _tokens(1, (B, 1))
    for pos in (S, np.array([S, S - 3], np.int32)):
        jl, tl, jc2, tc2 = _run(jc, tc, jbank, tbank, step, "decode",
                                execution, jpre, _clone(tpre), pos=pos)
        assert tl.shape == (B, 1, jc.padded_vocab)
        assert _rel(tl, jl) <= tol and _cache_rel(jc2, tc2) <= tol


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("name,execution", [
    ("mamba2-780m", "xla"), ("mamba2-780m", "photonic"),
    ("jamba-v0.1-52b", "xla")])
def test_train_logits_match_reference_across_prompts(name, execution, seed):
    """The whole-model gates on three more prompts (seed 0 is above)."""
    jc, tc, jbank, tbank = _banks(name, execution)
    jl, tl, _, _ = _run(jc, tc, jbank, tbank, _tokens(seed), "train",
                        execution)
    assert _rel(tl, jl) <= TOL[execution]


@pytest.mark.parametrize("name", ["mamba2-780m", "jamba-v0.1-52b"])
def test_generate_tokens_match_reference(name):
    jc, tc, params, tp = _model(name)
    jprog = j_api.Program.build(jc, params, execution="photonic")
    tprog = t_api.Program.build(tc, tp, execution="photonic", device="cpu")
    toks = _tokens()
    want = np.asarray(jprog.generate(jnp.asarray(toks), 8))
    got = tprog.generate(toks, 8).numpy()
    np.testing.assert_array_equal(got, want)


def test_short_prompt_conv_tail_follows_reference():
    """A prompt shorter than the conv tail (2 < W-1 tokens): the reference
    returns a 2-row conv cache and decodes with clamped indices; the port
    returns the same rows and the same greedy tokens."""
    jc, tc, params, tp = _model("mamba2-780m")
    jprog = j_api.Program.build(jc, params, execution="xla")
    tprog = t_api.Program.build(tc, tp, execution="xla", device="cpu")
    toks = np.array([[3, 5]], np.int32)
    _, jcache = jprog.prefill({"tokens": jnp.asarray(toks)}, 4)
    _, tcache = tprog.prefill({"tokens": toks}, 4)
    assert tuple(tcache["main"]["l0"]["conv"].shape) == \
        jcache["main"]["l0"]["conv"].shape == (2, 2, 1, 2, 144)
    assert _cache_rel(jcache, tcache) <= TOL["xla"]
    np.testing.assert_array_equal(
        tprog.generate(toks, 4).numpy(),
        np.asarray(jprog.generate(jnp.asarray(toks), 4)))


def test_chunked_prefill_refused_for_ssm_stacks():
    for name in ("mamba2-780m", "jamba-v0.1-52b"):
        _, tc, _, tp = _model(name)
        prog = t_api.Program.build(tc, tp, execution="xla", device="cpu")
        with pytest.raises(ValueError, match="attention mixers only"):
            prog.prefill_chunk(_tokens(0, (1, 4)), prog.empty_caches(1, 8),
                               0)
        with pytest.raises(ValueError, match="attention mixers only"):
            prog.prefill_chunked({"tokens": _tokens(0, (1, 8))}, 8, 4)
    _, tc, _, tp = _model("mamba2-780m")
    caches = t_tfm.init_caches(tc, 1, 8, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="attention mixers only"):
        t_tfm.forward(t_prep.prepare_params(tp, "float32", False), tc,
                      {"tokens": torch.zeros((1, 4), dtype=torch.long)},
                      mode="prefill_chunk", caches=caches, pos=0)


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = tuple(v.shape)
    return out


def test_torch_init_matches_reference_tree_and_scales():
    jc, tc, params, _ = _model("jamba-v0.1-52b")
    p = t_tfm.init_model(tc, seed=0, device="cpu")
    assert _shapes(p) == {k: tuple(v.shape)
                          for k, v in _flatten(params).items()}
    m = p["segments"]["main"]["l0"]["mixer"]
    _, H, _ = t_ssm.ssm_dims(tc)
    assert abs(float(m["w_in"].std()) - 1 / np.sqrt(tc.d_model)) < 0.03
    assert abs(float(m["conv_k"].std()) - 0.5) < 0.05
    torch.testing.assert_close(m["A_log"][0],
                               torch.log(torch.linspace(1.0, 16.0, H)))
    torch.testing.assert_close(m["D"], torch.ones_like(m["D"]))
    assert not m["dt_bias"].any()


def test_check_ported_admits_ssm_and_hybrid_only():
    """The SSM and hybrid families are admitted, as are MLA (since its
    slice) and the vlm and audio families (since slice 11) at full width;
    an SSM family without its SSM config, or an SSM config on another
    family, still raises."""
    from repro_torch.configs import get_arch
    for name in ("mamba2-780m", "jamba-v0.1-52b", "deepseek-v2-lite-16b",
                 "llama-3.2-vision-11b", "whisper-medium"):
        t_tfm.check_ported(get_arch(name, reuse=True))
    ssm = get_arch("mamba2-780m").ssm
    for cfg in (dataclasses.replace(get_arch("mamba2-780m"), ssm=None),
                dataclasses.replace(get_arch("whisper-medium"), ssm=ssm)):
        with pytest.raises(NotImplementedError, match="not a buildable"):
            t_tfm.check_ported(cfg)
