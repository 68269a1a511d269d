"""The port's encoder-decoder (whisper-medium, family audio) against the JAX
reference on the same weights (bridged through numpy) and the same seeded
numpy inputs: layer norm, the gelu MLP (float32 and bf16, both OBU
orientations), the linear adapters, the encoder pass, then the smoke model
(float32; 2 non-causal encoder layers over 13 frames, 2 decoder layers of
self- then cross-attention) through ``forward``, ``Program.prefill`` /
``decode``, ``generate(extras=)``, the ``ContinuousScheduler`` and the
``WaveBatcher``, the decode cell, and on a photonic ``Backend`` whose
lowered ``flash_min_seq`` sends the encoder and the cross-attention
through flash's plain version with ``causal=False`` over the ragged 13
frames.

Tolerances and the taught comparison of photonic runs as in
``tests/test_torch_vlm.py``, whose helpers this file shares: untaught, an
A8 flip at a rounding boundary carries this model's photonic logits 0.02
rel-L2 from the reference's on 1 of 12 prompt seeds (seed 3, which the
forward tests use).  bf16 gelu is bit-equal to XLA's: every op and
constant rounds to bf16, as XLA evaluates ``jax.nn.gelu`` (torch's
``F.gelu(approximate="tanh")`` rounds once and lands a bf16 step off in
~43% of entries).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import api as j_api
from repro.configs import smoke_variant as j_smoke
from repro.core.backend import Backend as JBackend
from repro.models import layers as j_layers
from repro.models import transformer as j_tfm
from repro.serve.batcher import Request as JRequest
from repro.serve.batcher import WaveBatcher as JWave
from repro.serve.scheduler import ContinuousScheduler as JScheduler
from repro.train.checkpoint import _flatten

from repro_torch import api as t_api
from repro_torch import bridge
from repro_torch.configs import get_arch, modality_shapes
from repro_torch.configs import smoke_variant as t_smoke
from repro_torch.core import prepared
from repro_torch.core.backend import Backend as TBackend
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import photonic_mvm as t_pm
from repro_torch.models import layers as t_layers
from repro_torch.models import transformer as t_tfm
from repro_torch.serve.batcher import Request as TRequest
from repro_torch.serve.batcher import WaveBatcher as TWave
from repro_torch.serve.scheduler import ContinuousScheduler as TScheduler
from test_torch_vlm import (RecordingBackend, _assert_close, _bank_tags_jax,
                            _chip_smoke, _clone, _drain, _flat, _inputs, _np,
                            _rel, compare, cpu_capture, taught)

torch.set_num_threads(2)
NAME = "whisper-medium"
TOL = {"xla": 1e-5, "photonic": 1e-3}
V = 211
KEY = "audio_embeds"
assert cpu_capture                  # the shared fixture, used by name


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, V, shape).astype(np.int32)


def _frames(seed, B=2):
    """Stub frame embeddings (B, 13, 12) as numpy (for both packages)."""
    shape = modality_shapes(t_smoke(NAME), B)[KEY]
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# -------------------------------------------------------------------------
# layer norm, gelu, the gelu MLP, the linear adapters
# -------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    """``init_norm(kind="layer")`` holds scale and bias; ``apply_norm``
    takes float32 statistics with the population variance."""
    jp, _ = j_layers.init_norm(64, "layer")
    tp = t_layers.init_norm(64, "cpu", kind="layer")
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: tuple(v.shape) for k, v in jp.items()}
    js, ts = _inputs(1, (64,))
    jb, tb = _inputs(2, (64,))
    jx, tx = _inputs(3, (2, 7, 64), dtype)
    jx, tx = jx * 3 + 1, tx * 3 + 1          # a mean to take away
    want = j_layers.apply_norm({"scale": js, "bias": jb}, jx, "layer")
    got = t_layers.apply_norm({"scale": ts, "bias": tb}, tx, "layer")
    assert got.dtype == tx.dtype
    _assert_close(got, want, dtype)


def test_gelu_is_xlas_tanh_gelu():
    """bf16: bit for bit ``jax.nn.gelu`` as XLA compiles it (the default
    tanh approximation), over a spread of magnitudes; float32 within
    1e-5 (XLA's tanh is its own approximation)."""
    a = np.concatenate([
        np.random.default_rng(4).standard_normal(20000) * 3,
        np.linspace(-10, 10, 4001)]).astype(np.float32)
    gelu = jax.jit(jax.nn.gelu)
    want = np.asarray(gelu(jnp.asarray(a, jnp.bfloat16)).astype(jnp.float32))
    got = t_layers.gelu(torch.as_tensor(a).to(torch.bfloat16))
    np.testing.assert_array_equal(_np(got), want)
    want32 = np.asarray(gelu(jnp.asarray(a)))
    assert _rel(t_layers.gelu(torch.as_tensor(a)).numpy(), want32) <= 1e-5


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("execution,dtype", [("xla", "float32"),
                                             ("xla", "bfloat16"),
                                             ("photonic", "float32")])
def test_gelu_mlp_matches_reference(execution, dtype, transpose):
    """The gelu MLP (``w_up``, ``w_down``; the transposed reuse swaps them),
    gelu a torch op between the two dots."""
    jp, _ = j_layers.init_mlp(jax.random.PRNGKey(5), 64, 128, act="gelu")
    tp = t_layers.init_mlp(64, 128, torch.Generator().manual_seed(0), "cpu",
                           act="gelu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: tuple(v.shape) for k, v in jp.items()}
    tp = {k: torch.from_numpy(np.array(v)).to(getattr(torch, dtype))
          for k, v in jp.items()}
    jp = {k: v.astype(getattr(jnp, dtype)) for k, v in jp.items()}
    jx, tx = _inputs(6, (2, 5, 64), dtype)
    want = j_layers.apply_mlp(jp, jx, act="gelu", transpose=transpose,
                              backend=JBackend(execution))
    got = t_layers.apply_mlp(tp, tx, act="gelu", transpose=transpose,
                             backend=TBackend(execution))
    if execution == "xla":
        _assert_close(got, want, dtype)
    else:
        assert _rel(got.numpy(), want) <= TOL["photonic"]


@pytest.mark.parametrize("execution", ["xla", "photonic"])
def test_linear_matches_reference(execution):
    jp, _ = j_layers.init_linear(jax.random.PRNGKey(7), 12, 64)
    tp = t_layers.init_linear(12, 64, torch.Generator().manual_seed(0),
                              "cpu")
    assert tuple(tp["w"].shape) == tuple(jp["w"].shape)
    tp = {"w": torch.from_numpy(np.array(jp["w"]))}
    jx, tx = _inputs(8, (2, 13, 12))
    want = j_layers.apply_linear(jp, jx, backend=JBackend(execution))
    got = t_layers.apply_linear(tp, tx, backend=TBackend(execution))
    assert _rel(got.numpy(), want) <= TOL[execution]


# -------------------------------------------------------------------------
# the whisper smoke model
# -------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _model():
    jc, tc = j_smoke(NAME), t_smoke(NAME)
    params, _ = j_tfm.init_model(jax.random.PRNGKey(0), jc)
    return jc, tc, params, bridge.params_from_flat(_flatten(params),
                                                   device="cpu")


@functools.lru_cache(maxsize=None)
def _programs(execution):
    """The reference's Program (on a ``RecordingBackend`` when photonic)
    and the port's."""
    jc, tc, params, tp = _model()
    jexec = RecordingBackend("photonic") if execution == "photonic" \
        else execution
    return (j_api.Program.build(jc, params, execution=jexec),
            t_api.Program.build(tc, tp, execution=execution, device="cpu"))


def test_init_model_and_caches_match_reference_tree():
    """``init_model`` builds the reference's tree (``audio_proj``,
    ``enc_final_norm``, layer norms with biases, the decoder's
    ``mixer/self`` and ``mixer/cross`` and ``norm_cross``, gelu MLPs) and
    ``init_caches`` its cache tree: no encoder cache, the decoder's self
    K/V and its cross K/V at the 13 frames."""
    jc, tc, params, _ = _model()
    t_tfm.check_ported(tc)
    tp = t_tfm.init_model(tc, seed=0, device="cpu")
    want = {k: tuple(np.shape(v)) for k, v in _flatten(params).items()}
    got = {k: tuple(v.shape) for k, v in _flat(tp).items()}
    assert got == want
    for key in ("audio_proj/w", "enc_final_norm/bias",
                "segments/dec/l0/norm_cross/bias",
                "segments/dec/l0/mixer/cross/wk",
                "segments/enc/l0/ffn/w_up"):
        assert key in got
    caches = t_tfm.init_caches(tc, 2, 12, dtype=torch.float32, device="cpu")
    jcaches = j_tfm.init_caches(jc, 2, 12, dtype=jnp.float32)
    shapes = {k: tuple(v.shape) for k, v in _flat(caches).items()}
    assert shapes == {k: tuple(v.shape)
                      for k, v in _flatten(jcaches).items()}
    assert set(caches) == {"dec"}
    assert shapes["dec/l0/cross/cv"] == (2, 1, 2, 13, 4, 16)


def test_bank_tags_equal_reference():
    jp, tp = _programs("photonic")
    got = {prepared.keystr(path): leaf.tag
           for path, leaf in prepared.flatten_with_path(tp.bank)
           if isinstance(leaf, prepared.PreparedTensor)}
    assert got == _bank_tags_jax(jp.bank)
    assert "['audio_proj']['w']" in got
    assert "['segments']['dec']['l0']['mixer']['cross']['wq']" in got


@pytest.mark.parametrize("execution", ["xla", "photonic"])
def test_encoder_pass_matches_reference(execution, monkeypatch):
    """``audio_proj``, the non-causal encoder segment and
    ``enc_final_norm`` over the frames: the memory the decoder reads
    (photonic taught)."""
    jp, tp = _programs(execution)
    jc, tc, _, _ = _model()
    fr = _frames(9)
    ctx = {"dtype": jnp.float32, "backend": jp.backend, "remat": False}
    want, got = compare(
        execution, monkeypatch,
        lambda: np.asarray(j_tfm._encoder_pass(
            jp.bank, jc, {KEY: jnp.asarray(fr)}, ctx, jnp.float32(0))[0]),
        lambda: t_tfm.encoder_pass(tp.bank, tc, {KEY: torch.as_tensor(fr)},
                                   tp.backend)[0].numpy())
    assert got.shape == (2, 13, tc.d_model)
    assert _rel(got, want) <= TOL["xla"]


def _forward_pair(seed, execution, S=9):
    jp, tp = _programs(execution)
    jc, tc, _, _ = _model()
    toks, fr = _tokens(seed, (2, S)), _frames(seed)
    return (lambda: np.asarray(j_tfm.forward(
                jp.bank, jc, {"tokens": jnp.asarray(toks),
                              KEY: jnp.asarray(fr)},
                execution=jp.backend)[0]),
            lambda: t_tfm.forward(
                tp.bank, tc, {"tokens": torch.as_tensor(toks).long(),
                              KEY: torch.as_tensor(fr)},
                execution=tp.backend)[0].numpy())


@pytest.mark.parametrize("execution", ["xla", "photonic"])
def test_forward_logits_match_reference(execution, monkeypatch):
    """On prompt seed 3, whose untaught photonic run flips: xla as it is,
    photonic taught."""
    want, got = compare(execution, monkeypatch,
                        *_forward_pair(3, execution))
    assert _rel(got, want) <= TOL[execution]


def test_untaught_photonic_gap_is_a8_flips(monkeypatch):
    """Prompt seed 3's untaught photonic logits part from the reference's
    past the gate, and A8 codes flipped at their rounding boundaries are
    the whole cause: taught, the gap is float32 noise."""
    run_ref, run_port = _forward_pair(3, "photonic")
    assert _rel(run_port(), run_ref()) > 10 * TOL["photonic"]
    want, got, flips = taught(monkeypatch, run_ref, run_port)
    assert flips >= 1 and _rel(got, want) <= 1e-5


@pytest.mark.parametrize("execution", ["xla", "photonic"])
def test_prefill_and_decode_logits_match_reference_program(execution,
                                                           monkeypatch):
    """``Program.prefill`` with the frames (the encoder runs, the decoder's
    cross K/V land in the cache), then one decode step at per-row
    positions from those caches."""
    jp, tp = _programs(execution)
    toks, fr = _tokens(10, (2, 9)), _frames(10)
    last = np.array([8, 5], np.int32)
    nxt, pos = _tokens(11, (2, 1)), np.array([9, 6], np.int32)

    def run_ref():
        jl, jcache = jp.prefill({"tokens": jnp.asarray(toks),
                                 KEY: jnp.asarray(fr)}, 16, last=last)
        jd, _ = jp.decode(jnp.asarray(nxt), jcache, jnp.asarray(pos))
        return np.asarray(jl), np.asarray(jd)

    def run_port():
        tl, tcache = tp.prefill({"tokens": toks, KEY: fr}, 16, last=last)
        td, _ = tp.decode(nxt, tcache, pos)
        return tl.numpy(), td.numpy()

    want, got = compare(execution, monkeypatch, run_ref, run_port)
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL[execution]


def test_decode_leaves_the_cross_kv_untouched():
    """A decode step writes the self-attention row and leaves the decoder's
    cross K/V (written by the prefill) bit for bit as they were."""
    _, tp = _programs("photonic")
    _, caches = tp.prefill({"tokens": _tokens(12, (2, 7)), KEY: _frames(12)},
                           12)
    cross = {k: v.clone() for k, v in _flat(caches).items() if "/cross/" in k}
    assert len(cross) == 2 and all(v.abs().sum() > 0 for v in cross.values())
    before = _flat(caches)["dec/l0/self/v"].clone()
    tp.decode(_tokens(13, (2, 1)), caches, np.array([7, 2]))
    for k, v in cross.items():
        assert torch.equal(_flat(caches)[k], v)
    assert not torch.equal(_flat(caches)["dec/l0/self/v"], before)


@pytest.mark.parametrize("execution", ["xla", "photonic"])
def test_generate_greedy_tokens_identical(execution, monkeypatch):
    """``generate(extras=)`` with frames per row, and with one clip shared
    by both rows (broadcast)."""
    jp, tp = _programs(execution)
    prompt = _tokens(14, (2, 10))
    clips = (_frames(14), _frames(15, B=1))
    want, got = compare(
        execution, monkeypatch,
        lambda: [np.asarray(jp.generate(jnp.asarray(prompt), 4,
                                        extras={KEY: jnp.asarray(fr)}))
                 for fr in clips],
        lambda: [tp.generate(prompt, 4, extras={KEY: fr}).numpy()
                 for fr in clips])
    for g, w in zip(got, want):
        assert g.shape == (2, 14)
        np.testing.assert_array_equal(g, w)


def _requests(request, seed, lens, clips):
    rng = np.random.default_rng(seed)
    return [request(rid=rid, prompt=rng.integers(0, V, n).astype(np.int32),
                    max_new=4, extras={KEY: clips[rid]})
            for rid, n in enumerate(lens)]


@pytest.mark.parametrize("execution", ["xla", "photonic"])
def test_scheduler_token_identical_to_reference(execution, monkeypatch):
    """The ``ContinuousScheduler`` with ``prefill_chunk`` set: a stack with
    cross-attention never chunks (the 40-token prompt prefills whole),
    token for token the reference's scheduler on the same trace."""
    jp, tp = _programs(execution)
    lens = (5, 13, 9, 40)
    clips = [_frames(40 + rid, B=1) for rid in range(4)]
    ts = TScheduler(tp, capacity=3, max_len=64, prefill_chunk=16)
    want, got = compare(
        execution, monkeypatch,
        lambda: _drain(JScheduler(jp, capacity=3, max_len=64,
                                  prefill_chunk=16),
                       _requests(JRequest, 16, lens, clips)),
        lambda: _drain(ts, _requests(TRequest, 16, lens, clips)))
    want = {c.rid: c.tokens for c in want}
    got = {c.rid: c.tokens for c in got}
    assert ts.stats.prefill_chunks == 0 and not ts._chunkable
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


@pytest.mark.parametrize("execution", ["xla", "photonic"])
def test_wave_batcher_token_identical_to_reference(execution, monkeypatch):
    """Waves by matching extras (requests 0 and 2 share a clip, 1 and 3
    another); completions and ``WaveStats`` equal the reference's."""
    jp, tp = _programs(execution)
    jw, tw = JWave(jp, wave_size=4), TWave(tp, wave_size=4)
    lens = (10, 10, 6, 10)
    clips = [_frames(50 + rid % 2, B=1) for rid in range(4)]
    want, got = compare(
        execution, monkeypatch,
        lambda: _drain(jw, _requests(JRequest, 17, lens, clips)),
        lambda: _drain(tw, _requests(TRequest, 17, lens, clips)))
    assert [c.rid for c in got] == [c.rid for c in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)
    assert tw.stats.as_dict() == jw.stats.as_dict() and tw.stats.waves == 2


def test_lowered_flash_runs_the_encoder_and_cross_attention(monkeypatch):
    """With ``flash_min_seq=8`` on both sides the encoder (13 x 13 frames)
    and the cross-attention (10 rows over 13 frames) run flash with
    ``causal=False``, the decoder's self-attention with ``causal=True``:
    the JAX Pallas kernel in interpret mode, the port's plain version;
    taught, logits within the photonic gate and greedy tokens
    identical."""
    jc, tc, params, tparams = _model()
    jp = j_api.Program.build(jc, params, execution=RecordingBackend(
        "photonic", flash_min_seq=8))
    tp = t_api.Program.build(tc, tparams, device="cpu",
                             execution=TBackend("photonic", flash_min_seq=8))
    calls = []
    plain = t_fa.flash_attention
    monkeypatch.setattr(t_fa, "flash_attention", lambda q, k, v, **kw: (
        calls.append((kw["causal"], q.shape[1], k.shape[1]))
        or plain(q, k, v, **kw)))
    toks, fr = _tokens(18, (2, 10)), _frames(18)

    def run_ref():
        jl, _ = jp.prefill({"tokens": jnp.asarray(toks),
                            KEY: jnp.asarray(fr)}, 14)
        return np.asarray(jl), np.asarray(jp.generate(
            jnp.asarray(toks), 4, extras={KEY: jnp.asarray(fr)}))

    def run_port():
        tl, _ = tp.prefill({"tokens": toks, KEY: fr}, 14)
        return tl.numpy(), tp.generate(toks, 4, extras={KEY: fr}).numpy()

    (jl, jt), (tl, tt) = compare("photonic", monkeypatch, run_ref, run_port)
    assert _rel(tl, jl) <= TOL["photonic"]
    np.testing.assert_array_equal(tt, jt)
    # per prefill: 2 encoder layers (13 x 13), 2 decoder layers of self
    # (causal, 10 x 10) and cross (10 x 13) attention; two prefills
    assert sorted(set(calls)) == [(False, 10, 13), (False, 13, 13),
                                  (True, 10, 10)]
    assert len(calls) == 12


def test_decode_cell_replay_equals_eager(cpu_capture):
    """The decode cell over prefilled caches (an eager first step, then the
    capture and replays) against eager steps on a copy: logits and caches
    bit for bit, the cross K/V untouched."""
    _, tp = _programs("photonic")
    logits, caches = tp.prefill({"tokens": _tokens(19, (2, 8)),
                                 KEY: _frames(19)}, 13)
    eager = _clone(caches)
    cross = {k: v.clone() for k, v in _flat(caches).items() if "/cross/" in k}
    cell = tp.decode_cell(caches)
    cur = t_api.sample(logits, V).long()[:, None]
    for i in range(4):
        got, _ = tp.decode(cur, caches, np.full(2, 8 + i))
        want, _ = tp.decode(cur, eager, 8 + i)
        assert torch.equal(got, want)
        cur = t_api.sample(got, V).long()[:, None]
    assert cell.graph is not None
    for k, v in _flat(caches).items():
        assert torch.equal(v, _flat(eager)[k])
    for k, v in cross.items():
        assert torch.equal(_flat(caches)[k], v)


# -------------------------------------------------------------------------
# chip_smoke's counts, flip check and small models, on the CPU
# -------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_chip_smoke_counts_equal_the_plain_paths_calls(mode, monkeypatch):
    """``chip_smoke.fused_per_pass`` and ``flash_per_prefill`` equal the
    fused-MVM and flash calls a pass of the photonic smoke model makes
    (counted on the plain path; flash from 8 rows), and give
    whisper-medium R&B the counts its phase holds: 193 per decode step,
    386 per prefill pass; 24 encoder flash launches per prefill, plus 24
    causal and 24 cross once the prompt has 512 rows."""
    cs = _chip_smoke()
    full = get_arch(NAME, reuse=True)
    assert cs.AUDIO_FUSED_PER_PASS == (cs.fused_per_pass(full, False),
                                       cs.fused_per_pass(full, True))
    assert cs.flash_per_prefill(full, 600) == (72, 24)
    assert cs.flash_per_prefill(full, 304) == (24, 0)
    _, tc, _, tparams = _model()
    tp = t_api.Program.build(tc, tparams, device="cpu",
                             execution=TBackend("photonic", flash_min_seq=8))
    mvm, flash = [], []
    plain_mvm, plain_fa = t_pm.photonic_mvm_fused, t_fa.flash_attention
    monkeypatch.setattr(t_pm, "photonic_mvm_fused", lambda *a, **k: (
        mvm.append(1) or plain_mvm(*a, **k)))
    monkeypatch.setattr(t_fa, "flash_attention", lambda *a, **k: (
        flash.append(k["causal"]) or plain_fa(*a, **k)))
    if mode == "prefill":
        tp.prefill({"tokens": _tokens(20, (2, 10)), KEY: _frames(20)}, 12)
        assert (len(flash), sum(flash)) == cs.flash_per_prefill(tc, 10, 8)
    else:
        tp.decode(_tokens(21, (2, 1)), tp.empty_caches(2, 12),
                  np.array([3, 5]))
        assert not flash
    assert len(mvm) == cs.fused_per_pass(tc, mode == "prefill")


def test_chip_smoke_a8_flips():
    """``chip_smoke.a8_flips`` finds the A8 codes that differ between two
    inputs and how far each sits from the boundary it straddles: nothing
    for equal inputs, one code a hair from its boundary, and a code moved
    a whole step (a wrong input, not a flip)."""
    cs = _chip_smoke()
    x = torch.tensor([[1.0, -2.0, 0.5, 127.0]])     # scale 1: x / s = x
    assert cs.a8_flips(x, x.clone()) == (0, 0.0, 0)
    near = x.clone()
    near[0, 2] = 0.5 + 1e-6                           # rounds to 1, not 0
    n, dist, step = cs.a8_flips(x, near)
    assert (n, step) == (1, 1) and dist < 1e-5 < cs.A8_FLIP_BAND
    far = x.clone()
    far[0, 0] = 2.0
    n, dist, step = cs.a8_flips(x, far)
    assert (n, step) == (1, 1) and dist == pytest.approx(0.5)


@pytest.mark.parametrize("family", ["vlm", "audio"])
def test_chip_smoke_small_memory_models(family, monkeypatch):
    """``chip_smoke.small_memory_model`` (the card's small float32 checks):
    admitted, its memory of 64 rows or more, and one prefill of 96 rows at
    ``flash_min_seq=64`` makes the flash calls ``flash_per_prefill``
    counts, non-causal ones over the memory among them.  Taught by a
    recording of the plain program's MVM inputs (offset decomposition:
    float32 noise away from the exact arithmetic, so A8 codes flip at
    their boundaries here too), ``exact_backend`` accepts every call, and
    its logits stay within kernel-level tolerance of the plain ones."""
    import collections
    cs = _chip_smoke()
    cfg, params, toks, extras = cs.small_memory_model(family, 13)
    t_tfm.check_ported(cfg)
    assert t_tfm.memory_len(cfg) >= 64 and cfg.reuse.reuse_times == 2
    calls = []
    plain = t_fa.flash_attention
    monkeypatch.setattr(t_fa, "flash_attention", lambda q, k, v, **kw: (
        calls.append((kw["causal"], k.shape[1])) or plain(q, k, v, **kw)))
    batch = dict(tokens=toks, **extras)
    records = []
    rec = t_api.Program.build(cfg, params, device="cpu",
                              execution=cs.recording_backend(
                                  records, flash_min_seq=64))
    lg, _ = rec.prefill(batch, 112)
    assert (len(calls), sum(c for c, _ in calls)) == cs.flash_per_prefill(
        cfg, 96, 64)
    assert (False, t_tfm.memory_len(cfg)) in calls
    flips = {}
    exact = t_api.Program.build(cfg, params, device="cpu",
                                execution=cs.exact_backend(
                                    flash_min_seq=64,
                                    teacher=collections.deque(records),
                                    flips=flips))
    lt, _ = exact.prefill(batch, 112)
    assert flips["calls"] == len(records)
    assert flips["max_flip_distance"] <= cs.A8_FLIP_BAND
    assert _rel(lt.numpy(), lg.numpy()) <= cs.EXACT_ARITH_TOL
