"""Tensor-parallel attention laid out as the reference lays it out
(``partition.cache_pspecs``), on gloo ranks on the CPU (one spawn per mesh
shape; the ranks run ``tests/_torch_mesh_jobs.tp_attention_rank``):

  * a rank's caches are ``local_slice`` of the whole caches under
    ``cache_pspecs``: KV heads over "model" for the small model (2 KV
    heads), the positions for the misdivided one (3 KV heads,
    ``shardcheck.seq_cfg``), over the data axes too when one row leaves
    them idle;
  * photonic logits within the W8A8 bound of the unsharded JAX program and
    of the unsharded port; xla on 1x2 within 1e-5 of the unsharded port;
  * the Megatron pairing: each pair-first dot's local block bit-equal to
    the block of its gathered output, the row dot on a block bit-equal to
    it on the whole input, the MLP bit-equal with and without the pairing;
  * the sequence branch (prefill, decode across the ranks' blocks of
    positions and at per-row positions) within 1e-5 in float32 on 1x2 and
    2x2; one row on 2x1, where the KV heads divide the "model" axis of one
    rank and no position is cut;
  * data-parallel ``ContinuousScheduler`` drains token-identical to solo
    ``generate`` (the reference's weights, photonic; the misdivided model
    on xla, whose prefills' caches are re-cut into the pool's blocks);
  * the dry-run census's collective records equal to the gloo ranks'.

The reference's own sharded path raises under jax 0.9, so the port is
held to the reference's UNSHARDED program, as in ``test_torch_sharded``."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import api as j_api
from repro.configs.base import ModelConfig as JCfg
from repro.models import transformer as j_tfm
from repro.train.checkpoint import _flatten

from repro_torch import api as t_api
from repro_torch import bridge
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import analysis, dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import shardcheck as sc
from repro_torch.models import transformer as t_tfm
from repro_torch.sharding import partition

import _torch_mesh_jobs as jobs

torch.set_num_threads(2)
W8A8_BOUND = 0.055
XLA_TOL = 1e-5
MESHES = ("1x2", "2x2", "2x1")


@functools.lru_cache(maxsize=None)
def _weights():
    """The reference shardcheck's small model on the reference's
    ``PRNGKey(0)`` weights (and the port's copy of them)."""
    jcfg = JCfg(name="shard-t", family="dense", num_layers=2, d_model=32,
                num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=128,
                compute_dtype="float32")
    params, _ = j_tfm.init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, params, bridge.params_from_flat(_flatten(params),
                                                 device="cpu")


@functools.lru_cache(maxsize=None)
def _seq_params():
    return t_tfm.init_model(sc.seq_cfg(), seed=0, device="cpu")


def _cells():
    """Dry-run cells whose census the 1x2 ranks run for real: the small
    model's prefill and decode (heads over "model", the pairing) and the
    misdivided model's decode (the sequence branch's pmax / psum)."""
    small = dataclasses.replace(sc.small_cfg(), execution="photonic")
    seq = dataclasses.replace(sc.seq_cfg(), execution="photonic")
    return {"prefill": (small, ShapeConfig("p", 16, 4, "prefill")),
            "decode": (small, ShapeConfig("d", 24, 4, "decode")),
            "seq_decode": (seq, ShapeConfig("d", 24, 4, "decode")),
            "seq_prefill": (seq, ShapeConfig("p", 16, 1, "prefill"))}


@functools.lru_cache(maxsize=None)
def _spawn(shape):
    _, _, params = _weights()
    small, seq = sc.small_cfg(), sc.seq_cfg()
    job = {"programs": {
        "small_photonic": (small, params, "photonic"),
        "small_xla": (small, params, "xla"),
        "seq_xla": (seq, _seq_params(), "xla")}}
    if shape != "2x1":
        job["pairing"] = "small_photonic"
    if shape == "2x2":
        job["drain"] = {"small_photonic": sc.small_requests(small),
                        "seq_xla": sc.small_requests(seq)}
    if shape == "1x2":
        job["cells"] = _cells()
    return mesh_lib.init_ranks(jobs.tp_attention_rank, shape, device="cpu",
                               args=(job,), threads=1)


def _program(name):
    _, _, params = _weights()
    cfg, p, ex = {"small_photonic": (sc.small_cfg(), params, "photonic"),
                  "small_xla": (sc.small_cfg(), params, "xla"),
                  "seq_xla": (sc.seq_cfg(), _seq_params(), "xla")}[name]
    return cfg, t_api.Program.build(cfg, p, execution=ex, device="cpu")


@functools.lru_cache(maxsize=None)
def _unsharded(name):
    """The unsharded port's ``seq_steps`` logits per case."""
    cfg, prog = _program(name)
    return {case: sc.seq_steps(prog, cfg, *case)["logits"]
            for case in sc.SEQ_CASES}


@functools.lru_cache(maxsize=None)
def _jax_unsharded(execution):
    """The reference's unsharded program on the steps of
    ``shardcheck.seq_steps``, per case."""
    jcfg, params, _ = _weights()
    prog = j_api.Program.build(jcfg, params, execution=execution)
    toks = jnp.asarray(sc.small_inputs(sc.small_cfg()).numpy(), jnp.int32)
    out = {}
    for B, L in sc.SEQ_CASES:
        t = toks[:B]
        S = t.shape[1]
        lg, caches = prog.prefill({"tokens": t[:, :sc.SEQ_PROMPT]}, L)
        got = [np.asarray(lg)]
        for pos in range(sc.SEQ_PROMPT, S):
            lg, caches = prog.decode(t[:, pos:pos + 1], caches, pos)
            got.append(np.asarray(lg))
        lg, _ = prog.decode(t[:, -1:], caches,
                            jnp.asarray(S - np.arange(B), jnp.int32))
        got.append(np.asarray(lg))
        out[(B, L)] = got
    return out


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
@pytest.mark.parametrize("name", ["small_photonic", "seq_xla"])
def test_cache_pieces_follow_cache_pspecs(shape, name):
    """Each rank's caches are its ``local_slice`` of the whole caches under
    ``cache_pspecs`` (made at that shape): the small model's KV heads
    over "model", the misdivided model's positions, over ("data",
    "model") for one row of 16 positions on 2x2."""
    cfg = {"small_photonic": sc.small_cfg(), "seq_xla": sc.seq_cfg()}[name]
    ranks = _spawn(shape)
    mesh = mesh_lib.parse_mesh(shape)
    for B, L in sc.SEQ_CASES:
        whole = t_tfm.init_caches(cfg, B, L, device="meta")
        specs = partition.cache_pspecs(cfg, mesh, B, L)
        for rank, r in enumerate(ranks):
            bound = mesh_lib.census_mesh(shape, rank)
            got = r["programs"][name][(B, L)]["shapes"]
            for (seg, layer, leaf), shp in got.items():
                spec = specs[seg][layer][leaf]
                want = partition.local_slice(whole[seg][layer][leaf], spec,
                                             bound).shape
                assert shp == tuple(want), (shape, B, L, rank, leaf, spec)
        spec = specs["main"]["l0"]["k"]
        if name == "small_photonic":
            assert spec[4] == "model" and spec[3] is None
        else:
            assert spec[4] is None
            assert spec[3] == (("data", "model") if (shape, B) == ("2x2", 1)
                               else "model")


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_photonic_logits_within_bound_of_jax_and_port_unsharded(shape):
    """Heads over "model": each prefill and decode step (scalar and per-row
    positions) within the W8A8 bound of the unsharded JAX program and of
    the unsharded port; every rank returns the same logits."""
    ranks = _spawn(shape)
    jax_ref = _jax_unsharded("photonic")
    port = _unsharded("small_photonic")
    for case in sc.SEQ_CASES:
        got = ranks[0]["programs"]["small_photonic"][case]["logits"]
        for r in ranks[1:]:
            assert all(torch.equal(a, b) for a, b in zip(
                r["programs"]["small_photonic"][case]["logits"], got))
        for a, j, p in zip(got, jax_ref[case], port[case]):
            assert _rel(a, j) <= W8A8_BOUND
            assert _rel(a, p) <= W8A8_BOUND


def test_xla_1x2_within_1e5_of_unsharded():
    """xla on 1x2: the dots run whole, attention on the rank's heads (its
    block of the whole projections), ``wo`` on the gathered heads."""
    got = _spawn("1x2")[0]["programs"]["small_xla"]
    want = _unsharded("small_xla")
    for case in sc.SEQ_CASES:
        for a, b in zip(got[case]["logits"], want[case]):
            assert _rel(a, b) <= XLA_TOL


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_pairing_dots_bit_equal_to_the_gathered_outputs(shape):
    """``local_out`` of ``wq`` / ``wk`` / ``wv`` (both orientations of the
    square ``wq``) and of an in-step quantized weight with a fused silu is
    the rank's block of the gathered output bit for bit; ``wo`` on its
    block (``local_in``) equals ``wo`` on the whole input; the MLP with the
    pairing equals it without, in both orientations; attention on the
    rank's heads within 1e-6 of attention on every head."""
    for r in _spawn(shape):
        pairing = r["pairing"]
        assert pairing["heads"]
        assert all(pairing["bit_equal"].values()), pairing["bit_equal"]
        assert ("wq", True) in pairing["bit_equal"]
        y_local, y_whole = pairing["attention"]
        assert _rel(y_local, y_whole) <= 1e-6


@pytest.mark.parametrize("shape", MESHES)
def test_sequence_branch_within_1e5_of_unsharded(shape):
    """The misdivided model on xla: prefill, decode steps crossing the
    ranks' blocks of positions and a per-row step, within 1e-5 (float32) of
    the unsharded port on every rank.  On 2x1 the KV heads divide the one
    "model" rank, so ``cache_pspecs`` cuts no position: one row runs whole
    on both data ranks."""
    want = _unsharded("seq_xla")
    mesh = mesh_lib.parse_mesh(shape)
    for B, L in sc.SEQ_CASES:
        spec = partition.cache_pspecs(sc.seq_cfg(), mesh, B, L)["main"][
            "l0"]["k"]
        for r in _spawn(shape):
            got = r["programs"]["seq_xla"][(B, L)]
            for a, b in zip(got["logits"], want[(B, L)]):
                assert _rel(a, b) <= XLA_TOL
            cut = mesh.axis_size(tuple(a for a in mesh.axis_names
                                       if a in (spec[3] or ())))
            assert got["k_shape"][3] * cut == L
            assert (cut > 1) == (shape != "2x1")


@pytest.mark.parametrize("name", ["small_photonic", "seq_xla"])
def test_dp_drain_token_identical_to_solo_generate(name):
    """2x2: a data-parallel ``ContinuousScheduler`` drain (KV heads over
    "model" for the small model; positions over "model" in the pool and
    over ("data", "model") in a 16-token prefill for the misdivided one)
    gives every rank the tokens of unsharded solo ``generate``."""
    cfg, prog = _program(name)
    want = {}
    for rid, prompt, max_new in sc.small_requests(cfg):
        want[rid] = prog.generate(torch.as_tensor(prompt)[None, :].long(),
                                  max_new)[0].tolist()
    for r in _spawn("2x2"):
        assert r["drain"][name] == want


@pytest.mark.parametrize("name", sorted(_cells()))
def test_census_collectives_equal_the_gloo_ranks(name):
    """The dry-run's census of a 1x2 rank (the pairing's missing gathers,
    the pmax of a block's abs-max, the sequence branch's pmax and psum)
    equals the collectives the gloo ranks recorded running the step."""
    cfg, shape = _cells()[name]
    for rank, r in enumerate(_spawn("1x2")):
        got = dryrun.walk(cfg, shape, "1x2", rank=rank)["collectives"]
        want = analysis.collective_census(r["census"][name])
        assert got == want, (name, rank)
        assert want["total_bytes"] > 0
