"""The SSM slice served: the port's ``ContinuousScheduler`` and
``SlotPool`` against the reference's on the same trace and weights
(float32), for the mamba2 smoke variant on an R&B stack (R=2 x T=2,
identity then shuffle) and the jamba smoke variant (SSM + attention + MoE).

Stacks with SSM layers prefill at the exact prompt length (right padding
would enter the state and the conv tail) and never in chunks, even with
``prefill_chunk`` set; idle slots ride the decode batch.  A prompt shorter
than the conv tail (2 < W-1 tokens) leaves a stale conv row in its slot,
which the decode reads as the newest, as in the reference.

Tolerances: greedy tokens identical; pool contents after ``write_prefill``
equal to the reference's bit for bit (the same prefill caches in).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import api as j_api
from repro.configs import smoke_variant as j_smoke
from repro.configs.archs import rb as j_rb
from repro.models import transformer as j_tfm
from repro.serve.batcher import Request as JRequest
from repro.serve.scheduler import ContinuousScheduler as JScheduler
from repro.serve.slots import SlotPool as JPool
from repro.train.checkpoint import _flatten

from repro_torch import api as t_api
from repro_torch import bridge
from repro_torch.configs import smoke_variant as t_smoke
from repro_torch.configs.archs import rb as t_rb
from repro_torch.configs.base import ModelConfig as TCfg
from repro_torch.serve.batcher import Request as TRequest
from repro_torch.serve.scheduler import ContinuousScheduler as TScheduler
from repro_torch.serve.slots import SlotPool as TPool
from repro_torch.serve.slots import SlotState

torch.set_num_threads(2)
V = 211
MODELS = ["mamba2-780m", "jamba-v0.1-52b"]


@functools.lru_cache(maxsize=None)
def _programs(name):
    jc, tc = j_smoke(name), t_smoke(name)
    if name == "mamba2-780m":
        jc, tc = j_rb(jc, 2, 2), t_rb(tc, 2, 2)
    params, _ = j_tfm.init_model(jax.random.PRNGKey(0), jc)
    tp = bridge.params_from_flat(_flatten(params), device="cpu")
    return (j_api.Program.build(jc, params, execution="photonic"),
            t_api.Program.build(tc, tp, execution="photonic", device="cpu"))


def _drain(scheduler, request, prompts, max_new=4):
    for rid, p in enumerate(prompts):
        scheduler.submit(request(rid=rid, prompt=p, max_new=max_new))
    return {c.rid: (c.tokens, c.padded_to) for c in scheduler.drain()}


@pytest.mark.parametrize("name", MODELS)
def test_scheduler_token_identical_to_reference(name):
    """Exact-length monolithic prefills (``prefill_chunk=4`` ignored), a
    capacity-2 pool whose slots are reused, idle slots in the decode
    batch, and a 2-token prompt last, into a reused slot."""
    jp, tp = _programs(name)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, V, n).astype(np.int32) for n in (7, 11, 5, 2)]
    kw = dict(capacity=2, max_len=24, prefill_chunk=4)
    want = _drain(JScheduler(jp, **kw), JRequest, prompts)
    ts = TScheduler(tp, **kw)
    assert ts._exact_prefill and not ts._chunkable
    got = _drain(ts, TRequest, prompts)
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for rid, (toks, padded_to) in want.items():
        np.testing.assert_array_equal(got[rid][0], toks)
        assert got[rid][1] == padded_to == len(prompts[rid])
    assert ts.stats.prefill_chunks == 0 and ts.stats.requests == 4


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree.numpy() if isinstance(tree, torch.Tensor)
                      else tree)


def _assert_trees_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k])
        else:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("name", MODELS)
def test_write_prefill_places_ssm_leaves_as_reference(name):
    """The reference's own prefill caches (a 5-token and a 2-token prompt)
    written into both pools over non-zero contents: the pools agree bit for
    bit — SSM ``h`` whole, the conv tail at its leading rows (the 2-token
    one leaves the stale third row), K/V at rows 0..Lp-1."""
    jp, tp = _programs(name)
    jpool = JPool(jp.cfg, 3, 12, dtype=jnp.float32)
    tpool = TPool(tp.cfg, 3, 12, dtype=torch.float32, device="cpu")
    jpool.caches = jax.tree.map(lambda a: jnp.full(a.shape, 0.5, a.dtype),
                                jpool.caches)
    _fill(tpool.caches, 0.5)
    for pool in (jpool, tpool):
        for rid in range(3):
            pool.allocate(SlotState(rid=rid, prompt_len=1, max_new=1))
    for slot, n in ((1, 5), (2, 2)):
        toks = np.arange(1, n + 1, dtype=np.int32)[None]
        _, pre = jp.prefill({"tokens": jnp.asarray(toks)}, n)
        jpool.write_prefill(slot, pre, n)
        tpool.write_prefill(slot, _to_torch(pre), n)
    _assert_trees_equal(_np(tpool.caches), _np(jpool.caches))
    np.testing.assert_array_equal(tpool.positions, jpool.positions)


def _fill(tree, value):
    for v in tree.values():
        if isinstance(v, dict):
            _fill(v, value)
        else:
            v.fill_(value)


def test_insert_lands_at_zero_and_leaves_the_rest():
    """``write_prefill`` writes every prefill leaf's whole extent at
    (0, 0, slot, 0, ...): an SSM state whole, a conv tail shorter than the
    pool's at its leading rows, K/V shorter in length AND in a trailing
    axis; every other pool entry keeps its value."""
    cfg = TCfg(name="t", family="dense", num_layers=1, d_model=8,
               num_heads=2, num_kv_heads=1, d_ff=16, vocab_size=32,
               compute_dtype="float32")
    pool = TPool(cfg, 3, 10, dtype=torch.float32, device="cpu")
    pool.caches = {"main": {
        "l0": {"h": torch.full((2, 2, 3, 4, 5, 6), -1.0),
               "conv": torch.full((2, 2, 3, 3, 7), -1.0)},
        "l1": {"k": torch.full((2, 2, 3, 10, 2, 4), -1.0),
               "v": torch.full((2, 2, 3, 10, 2, 4), -1.0)}}}
    pre = {"main": {
        "l0": {"h": torch.rand((2, 2, 1, 4, 5, 6)),
               "conv": torch.rand((2, 2, 1, 2, 7))},
        "l1": {"k": torch.rand((2, 2, 1, 6, 2, 4)),
               "v": torch.rand((2, 2, 1, 6, 2, 3))}}}
    before = {k: {kk: t.clone() for kk, t in v.items()}
              for k, v in pool.caches["main"].items()}
    pool.allocate(SlotState(rid=0, prompt_len=6, max_new=1))
    pool.allocate(SlotState(rid=1, prompt_len=6, max_new=1))
    pool.write_prefill(1, pre, 6)
    assert pool.positions[1] == 6
    for li, leaves in pre["main"].items():
        for k, p in leaves.items():
            got = pool.caches["main"][li][k]
            region = (slice(None), slice(None), slice(1, 2)) + tuple(
                slice(0, n) for n in p.shape[3:])
            assert torch.equal(got[region], p)
            mask = torch.ones(got.shape, dtype=torch.bool)
            mask[region] = False
            assert torch.equal(got[mask], before[li][k][mask])
    too_big = {"main": {"l0": {"h": torch.rand((2, 2, 1, 4, 5, 6)),
                               "conv": torch.rand((2, 2, 1, 4, 7))},
                        "l1": pre["main"]["l1"]}}
    with pytest.raises(ValueError, match="does not fit"):
        pool.write_prefill(1, too_big, 6)


def test_attention_stacks_keep_buckets_and_chunks():
    """Only SSM stacks prefill exactly: an attention-only stack keeps its
    bucket padding and chunked admission."""
    cfg = TCfg(name="t", family="dense", num_layers=2, d_model=16,
               num_heads=2, num_kv_heads=1, d_ff=32, vocab_size=64,
               compute_dtype="float32")
    from repro_torch.models import transformer as t_tfm
    prog = t_api.Program.build(cfg, t_tfm.init_model(cfg, device="cpu"),
                               device="cpu")
    s = TScheduler(prog, capacity=2, max_len=32, prefill_chunk=8)
    assert not s._exact_prefill and s._chunkable and s._bucket(5) == 16
