"""The port's MLA (multi-head latent attention, DeepSeek-V2) against the
JAX reference on the same weights (bridged through numpy): each of the
reference's MLA functions, then the deepseek-v2-lite-16b smoke model as a
whole (one dense ``pre`` layer, MoE layers with a shared expert, MLA in
every layer) through ``forward``, ``Program.generate`` and the
``ContinuousScheduler`` with chunked prefill.

Tolerances: float32 outputs rel-L2 <= 1e-5 (the same float32 arithmetic
summed in another order).  bf16 outputs elementwise within one bf16 ulp
of the reference: the port rounds to bf16 where the reference does (the
projections, ``q_lat``, the attention weights and the context products
of the absorbed decode), so all that may differ is a float32 sum-order
difference moving a value across one rounding boundary (at these sizes
none does: the outputs are bit-equal).  Model logits rel-L2 <= 1e-5 on
xla and <= 1e-3 on photonic (a one-ulp float32 difference can flip a
per-tensor A8 rounding); greedy tokens identical.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import api as j_api
from repro.configs import smoke_variant as j_smoke
from repro.models import attention as j_attn
from repro.models import transformer as j_tfm
from repro.serve.batcher import Request as JRequest
from repro.serve.scheduler import ContinuousScheduler as JScheduler
from repro.train.checkpoint import _flatten

from repro_torch import api as t_api
from repro_torch import bridge
from repro_torch.configs import smoke_variant as t_smoke
from repro_torch.core import sharing
from repro_torch.models import attention as t_attn
from repro_torch.models import transformer as t_tfm
from repro_torch.serve.batcher import Request as TRequest
from repro_torch.serve.scheduler import ContinuousScheduler as TScheduler

torch.set_num_threads(2)
NAME = "deepseek-v2-lite-16b"
TOL = {"xla": 1e-5, "photonic": 1e-3}
F32_TOL = 1e-5
V = 211


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _jnp32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


# -------------------------------------------------------------------------
# the MLA functions, one layer
# -------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _layer():
    jc, tc = j_smoke(NAME), t_smoke(NAME)
    jp, _ = j_attn.init_mla(jax.random.PRNGKey(1), jc)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jc, tc, jp, tp


def _inputs(seed, shape, dtype):
    """The same values for both packages, rounded to ``dtype`` once."""
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.as_tensor(a).to(getattr(torch, dtype)))


def _caches(seed, B, L, dtype):
    """An MLA cache holding random latents in every row (rows a mask must
    hide hold values too), for both packages."""
    jc, tc, _, _ = _layer()
    m = tc.mla
    jckv, tckv = _inputs(seed, (B, L, m.kv_lora_rank), dtype)
    jkr, tkr = _inputs(seed + 1, (B, L, m.qk_rope_dim), dtype)
    return {"ckv": jckv, "kr": jkr}, {"ckv": tckv, "kr": tkr}


def _assert_close(got, want, dtype):
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == tuple(np.shape(want))
    got, want = _np(got), _jnp32(want)
    if dtype == "float32":
        assert _rel(got, want) <= F32_TOL
        return
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), 2.0 ** -120)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)      # bf16: 8 significant bits
    assert np.all(np.abs(got - want) <= ulp)


def test_init_mla_leaves_and_shapes_match_reference():
    jc, tc, jp, _ = _layer()
    p = t_attn.init_mla(tc, torch.Generator().manual_seed(0), "cpu",
                        lead=(3,))
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        k: (3,) + tuple(np.shape(v)) for k, v in jp.items()}
    jcache = j_attn.init_mla_cache(jc, 2, 7, jnp.float32)
    tcache = t_attn.init_mla_cache(tc, 2, 7, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in tcache.items()} == {
        k: tuple(v.shape) for k, v in jcache.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_forward_matches_reference(dtype):
    """Prefill into a capacity cache: the output and the latents written
    at offset 0 (the rest of the buffer untouched)."""
    jc, tc, jp, tp = _layer()
    jx, tx = _inputs(0, (2, 10, tc.d_model), dtype)
    jcache = j_attn.init_mla_cache(jc, 2, 16, getattr(jnp, dtype))
    tcache = t_attn.init_mla_cache(tc, 2, 16, getattr(torch, dtype), "cpu")
    jy, jnew = j_attn.mla_forward(jp, jc, jx, cache=jcache)
    ty, tnew = t_attn.mla_forward(tp, tc, tx, cache=tcache)
    assert tnew is tcache                          # written in place
    _assert_close(ty, jy, dtype)
    for key in ("ckv", "kr"):
        _assert_close(tnew[key], jnew[key], dtype)
        assert not tnew[key][:, 10:].any()
    jy2, _ = j_attn.mla_forward(jp, jc, jx, causal=False)
    ty2, none = t_attn.mla_forward(tp, tc, tx, causal=False)
    assert none is None
    _assert_close(ty2, jy2, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_offset", [0, 8])
def test_mla_prefill_chunk_matches_reference(q_offset, dtype):
    """A 4-token chunk at ``q_offset`` into a 16-row buffer whose other
    rows hold values: the chunk's latents land at the offset, the whole
    buffer is up-projected and the causal mask hides the rows past the
    chunk."""
    jc, tc, jp, tp = _layer()
    jx, tx = _inputs(2, (2, 4, tc.d_model), dtype)
    jcache, tcache = _caches(3, 2, 16, dtype)
    jy, jnew = j_attn.mla_prefill_chunk(jp, jc, jx, jcache, q_offset)
    ty, tnew = t_attn.mla_prefill_chunk(tp, tc, tx, tcache, q_offset)
    _assert_close(ty, jy, dtype)
    for key in ("ckv", "kr"):
        _assert_close(tnew[key], jnew[key], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [7, (4, 0, 9)], ids=["scalar", "vector"])
def test_mla_decode_matches_reference(pos, dtype):
    """The absorbed decode against a read-only cache, at one position for
    every row or one per row: the output and the one-token latent delta;
    the cache is left as it was."""
    jc, tc, jp, tp = _layer()
    jx, tx = _inputs(4, (3, 1, tc.d_model), dtype)
    jcache, tcache = _caches(5, 3, 12, dtype)
    before = {k: v.clone() for k, v in tcache.items()}
    jpos = jnp.asarray(np.asarray(pos, np.int32))
    tpos = (torch.as_tensor(np.asarray(pos, np.int64))
            if isinstance(pos, tuple) else pos)
    jy, jd = j_attn.mla_decode(jp, jc, jx, jcache, jpos)
    ty, td = t_attn.mla_decode(tp, tc, tx, tcache, tpos)
    _assert_close(ty, jy, dtype)
    for key in ("ckv", "kr"):
        _assert_close(td[key], jd[key], dtype)
        assert torch.equal(tcache[key], before[key])


@pytest.mark.parametrize("pos", [5, (4, 0, 9)], ids=["scalar", "vector"])
def test_latent_deltas_land_at_each_rows_position(pos):
    """``core.sharing._delta_update`` writes the (B, 1, kv_lora) and
    (B, 1, rope) deltas into the [R, T, B, L, .] buffers at ``pos`` (a
    per-row scatter for a position vector), nothing else."""
    cache = torch.zeros(2, 2, 3, 12, 16)
    delta = torch.randn(3, 1, 16)
    p = torch.as_tensor(pos) if isinstance(pos, tuple) else pos
    sharing._delta_update(cache, delta, 1, 0, p)
    rows = [pos] * 3 if isinstance(pos, int) else list(pos)
    want = torch.zeros_like(cache)
    for b, at in enumerate(rows):
        want[1, 0, b, at] = delta[b, 0]
    assert torch.equal(cache, want)


# -------------------------------------------------------------------------
# the deepseek smoke model
# -------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _model():
    jc, tc = j_smoke(NAME), t_smoke(NAME)
    params, _ = j_tfm.init_model(jax.random.PRNGKey(0), jc)
    return jc, tc, params, bridge.params_from_flat(_flatten(params),
                                                   device="cpu")


@functools.lru_cache(maxsize=None)
def _programs(execution):
    jc, tc, params, tp = _model()
    return (j_api.Program.build(jc, params, execution=execution),
            t_api.Program.build(tc, tp, execution=execution, device="cpu"))


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, V, shape).astype(
        np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def test_check_ported_admits_mla_and_init_tree_matches_reference():
    """``init_model`` builds the reference's tree: a dense ``pre`` layer
    and MoE layers with a shared expert, MLA leaves in every layer."""
    jc, tc, params, _ = _model()
    t_tfm.check_ported(tc)
    tp = t_tfm.init_model(tc, seed=0, device="cpu")
    want = {k: tuple(np.shape(v)) for k, v in _flatten(params).items()}
    got = {k: tuple(v.shape) for k, v in _flat(tp).items()}
    assert got == want
    assert "segments/pre/l0/mixer/w_ukv" in got
    assert "segments/main/l0/ffn/shared/w_gate" in got
    caches = t_tfm.init_caches(tc, 2, 9, dtype=torch.float32, device="cpu")
    jcaches = j_tfm.init_caches(jc, 2, 9, dtype=jnp.float32)
    assert {k: tuple(v.shape) for k, v in _flat(caches).items()} == {
        k: tuple(v.shape) for k, v in _flatten(jcaches).items()}


@pytest.mark.parametrize("execution", ["xla", "photonic"])
def test_forward_logits_match_reference(execution):
    jp, tp = _programs(execution)
    jc, tc, _, _ = _model()
    toks = _tokens(1, (2, 11))
    jl, _, jaux = j_tfm.forward(jp.bank, jc, {"tokens": jnp.asarray(toks)},
                                execution=jp.backend)
    tl, _, taux = t_tfm.forward(tp.bank, tc,
                                {"tokens": torch.as_tensor(toks).long()},
                                execution=tp.backend)
    assert _rel(tl.numpy(), jl) <= TOL[execution]
    assert abs(float(taux) - float(jaux)) <= 1e-5


@pytest.mark.parametrize("execution", ["xla", "photonic"])
def test_prefill_and_decode_logits_match_reference_program(execution):
    """``Program.prefill`` into capacity caches, then one decode step at
    per-row positions from those caches."""
    jp, tp = _programs(execution)
    toks = _tokens(2, (2, 9))
    last = np.array([8, 5], np.int32)
    jl, jcache = jp.prefill({"tokens": jnp.asarray(toks)}, 16, last=last)
    tl, tcache = tp.prefill({"tokens": toks}, 16, last=last)
    assert _rel(tl.numpy(), jl) <= TOL[execution]
    nxt = _tokens(3, (2, 1))
    pos = np.array([9, 6], np.int32)
    jd, _ = jp.decode(jnp.asarray(nxt), jcache, jnp.asarray(pos))
    td, _ = tp.decode(nxt, tcache, pos)
    assert _rel(td.numpy(), jd) <= TOL[execution]


@pytest.mark.parametrize("execution", ["xla", "photonic"])
def test_generate_greedy_tokens_identical(execution):
    jp, tp = _programs(execution)
    prompt = _tokens(4, (2, 10))
    want = np.asarray(jp.generate(jnp.asarray(prompt), 6))
    got = tp.generate(prompt, 6)
    assert tuple(got.shape) == (2, 16)
    np.testing.assert_array_equal(got.numpy(), want)


def _drain(scheduler, request, prompts):
    for rid, p in enumerate(prompts):
        scheduler.submit(request(rid=rid, prompt=p, max_new=5))
    return {c.rid: c.tokens for c in scheduler.drain()}


@pytest.mark.parametrize("execution", ["xla", "photonic"])
def test_chunked_scheduler_token_identical_to_reference(execution):
    """The ``ContinuousScheduler`` with chunked prefill (``prefill_chunk``
    runs ``mla_prefill_chunk`` on the staging caches) against the
    reference's scheduler on the same trace."""
    jp, tp = _programs(execution)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, V, n).astype(np.int32)
               for n in (5, 23, 9, 40)]
    want = _drain(JScheduler(jp, capacity=3, max_len=64, prefill_chunk=16),
                  JRequest, prompts)
    ts = TScheduler(tp, capacity=3, max_len=64, prefill_chunk=16)
    got = _drain(ts, TRequest, prompts)
    assert ts.stats.prefill_chunks > 0
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


# -------------------------------------------------------------------------
# chip_smoke's MLA phase, on the CPU
# -------------------------------------------------------------------------
def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_chip_smoke_fused_per_pass_counts_every_crossbar_dot(mode,
                                                            monkeypatch):
    """``chip_smoke.fused_per_pass`` equals the fused-MVM calls one forward
    pass of the photonic smoke model makes (counted on the plain path),
    and gives the MLA phase's deepseek-v2-lite-16b R&B (``mla_config``)
    the counts the phase holds."""
    from repro_torch.kernels import photonic_mvm as t_pm
    cs = _chip_smoke()
    assert cs.mla_config().d_model == 2048
    assert cs.MLA_FUSED_PER_PASS == (
        cs.fused_per_pass(cs.mla_config(), prefill=False),
        cs.fused_per_pass(cs.mla_config(), prefill=True))
    _, tp = _programs("photonic")
    calls = []
    plain = t_pm.photonic_mvm_fused
    monkeypatch.setattr(t_pm, "photonic_mvm_fused",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    if mode == "prefill":
        tp.prefill({"tokens": _tokens(6, (2, 7))}, 9)
    else:
        caches = tp.empty_caches(2, 9)
        tp.decode(_tokens(7, (2, 1)), caches, np.array([3, 5]))
    assert len(calls) == cs.fused_per_pass(tp.cfg, mode == "prefill")


@pytest.mark.parametrize("causal,q_offset,kv_len", [(True, 0, None),
                                                    (True, 64, 150),
                                                    (False, 0, 100)])
def test_chip_smoke_mma_flash_emulation(causal, q_offset, kv_len):
    """``chip_smoke.mma_flash_emulated`` (the tensor-core flash kernel's
    bf16 rounding of P, which the small bf16 MLA check holds the card to)
    sits one P rounding from the plain version (~2e-3 rel-L2, not 0) and
    ignores keys past ``kv_len`` and the causal window, NaN or not."""
    from repro_torch.kernels import flash_attention as t_fa
    cs = _chip_smoke()
    g = torch.Generator().manual_seed(8)
    q = torch.randn(8, 96, 48, generator=g).to(torch.bfloat16)
    k = torch.randn(4, 200, 48, generator=g).to(torch.bfloat16)
    v = torch.randn(4, 200, 32, generator=g).to(torch.bfloat16)
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    got = cs.mma_flash_emulated(q, k, v, **kw)
    want = t_fa.flash_attention_plain(q, k, v, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == (8, 96, 32)
    assert 1e-4 < _rel(_np(got), _np(want)) <= 4e-3
    end = min(kv_len or 200, q_offset + 96 if causal else 200)
    k2, v2 = k.clone(), v.clone()
    k2[:, end:], v2[:, end:] = float("nan"), float("inf")
    assert torch.equal(cs.mma_flash_emulated(q, k2, v2, **kw), got)


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_small_mla_check_bound_covers_the_emulated_flash_rounding(seed):
    """The basis of ``chip_smoke.MLA_MODEL_TOL``: on the CPU, the small
    bf16 MLA model's logits with the tensor-core flash's bf16 P emulated
    lie 0.0517-0.0666 rel-L2 from the same program with the plain flash
    over these seeds (seed 7 is the card check's), inside the bound and
    far from zero."""
    cs = _chip_smoke()
    cfg, params, toks = cs.small_mla_model(seed)
    logits = {}
    for mma in (True, False):
        prog = t_api.Program.build(
            cfg, params, device="cpu",
            execution=cs.exact_backend(mma_flash=mma, flash_min_seq=64))
        logits[mma], _ = prog.prefill({"tokens": toks}, 112)
    gap = cs.rel_l2(logits[True], logits[False])
    assert 0.05 <= gap <= 0.067 < cs.MLA_MODEL_TOL


def test_a8_flip_ulps_measures_bf16_flips():
    """``chip_smoke.a8_flip_ulps``: at a scale of 1 (amax 127), 10.5 and
    10.5625, one bf16 ulp apart, round to 10 and 11 (half to even): each
    value lies within one ulp of the boundary 10.5; 10.375 against 10.625
    (four ulps apart) put 10.625 two ulps from it."""
    cs = _chip_smoke()

    def bf(*v):
        return torch.tensor((127.0,) + v, dtype=torch.bfloat16)
    assert cs.a8_flip_ulps(bf(3.0), bf(3.0)) == 0.0
    assert cs.a8_flip_ulps(bf(10.5), bf(10.5625)) == 1.0
    assert cs.a8_flip_ulps(bf(10.375), bf(10.625)) == 2.0


def test_small_mla_taught_check_runs_on_the_cpu():
    """``chip_smoke.small_mla_check``'s taught comparison with the card's
    part played by the emulating program itself (each MVM input recorded):
    the taught logits equal it bit for bit, every call is taught, no A8
    code flips, and the flips group per layer (7 calls a layer, then the
    lm head)."""
    import collections
    cs = _chip_smoke()
    cfg, params, toks = cs.small_mla_model(7)
    records = []
    base = type(cs.exact_backend(mma_flash=True))

    class Recording(base):
        def _photonic_matmul(self, x, *a, **k):
            records.append(x.clone())
            return super()._photonic_matmul(x, *a, **k)

    card = t_api.Program.build(cfg, params, device="cpu",
                               execution=Recording("photonic",
                                                   flash_min_seq=64))
    lg, _ = card.prefill({"tokens": toks}, 112)
    flips = {}
    taught = t_api.Program.build(
        cfg, params, device="cpu", execution=cs.exact_backend(
            mma_flash=True, flash_min_seq=64,
            teacher=collections.deque(records), flips=flips,
            input_tol=cs.MLA_INPUT_TOL))
    lt, _ = taught.prefill({"tokens": toks}, 112)
    assert torch.equal(lg, lt) and lg.dtype == torch.bfloat16
    assert flips["calls"] == len(records) == 15
    assert cs.per_layer_flips(cfg, flips["per_call"]) == [0, 0, 0]
    assert flips["max_flip_bf16_ulps"] == 0.0
    with pytest.raises(AssertionError):
        cs.per_layer_flips(cfg, [0] * 14)
