"""SSM states and MLA latents laid out as the reference lays them out
(``partition.cache_pspecs``), on gloo ranks on the CPU (one spawn per mesh
shape, every model in each; the ranks run
``tests/_torch_mesh_jobs.tp_ssm_mla_rank``):

  * every SSM and MLA cache leaf of a rank is ``local_slice`` of the whole
    caches under ``cache_pspecs``: a Mamba-2 stack's ``h`` over its heads
    and ``conv`` over its channels, a misdivided one's ``h`` whole (3
    heads), MLA latents over the positions, over ("data", "model") for one
    row on 2x2;
  * photonic logits within the W8A8 bound of the unsharded JAX program and
    of the unsharded port, the SSM prefill's bit-equal to the unsharded
    port's; xla on 1x2 within 1e-5 of the unsharded port;
  * a prefill's ``h`` / ``conv`` pieces bit-equal to the unsharded
    prefill's heads and channels (xla);
  * the MLA sequence branch (prefill, chunked prefill, decode across the
    ranks' blocks of positions and at per-row positions) within 1e-5 in
    float32;
  * data-parallel ``ContinuousScheduler`` drains on 2x2 token-identical to
    solo ``generate`` (the slot pool inserts a prefill's head and channel
    pieces as they are and re-cuts its latent positions);
  * the dry-run census's collectives equal to the gloo ranks';
  * jamba's smoke model (SSM, attention and MoE layers) on 1x2 xla within
    1e-5 of the unsharded port;
  * the dry-run: a 1x1 cell's bytes as before the cut, a 16x16 mamba2
    decode cell's caches the sum of their leaves' ``local_shape``.

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
from repro.configs import base as j_base
from repro.models import transformer as j_tfm
from repro.train.checkpoint import _flatten

from repro_torch import api as t_api
from repro_torch import bridge
from repro_torch.configs import get_arch, smoke_variant
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
CASES = sc.SEQ_CASES
MODELS = ("ssm", "ssm_odd", "mla")
SSM_LEAVES = ("h", "conv")
MLA_LEAVES = ("ckv", "kr")
# mamba2-780m R&B decode at 4 x 512 on 1x1, walked on the parent commit
# of the SSM / MLA cut (``dryrun.walk``'s memory block)
DRYRUN_1X1_MEMORY = {"argument_size_in_bytes": 967059856,
                     "output_size_in_bytes": 403456,
                     "temp_size_in_bytes": 310306852,
                     "per_device_total_gb": 1.278}


def _jcfg(cfg):
    """The reference's ModelConfig of a port config (same fields; nested
    configs by class name)."""
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = getattr(j_base, type(v).__name__)(**dataclasses.asdict(v))
        kw[f.name] = v
    return j_base.ModelConfig(**kw)


@functools.lru_cache(maxsize=None)
def _weights(model):
    """A shardcheck variant on the reference's ``PRNGKey(0)`` weights (and
    the port's copy of them)."""
    cfg = sc.variant_cfgs()[model]
    jcfg = _jcfg(cfg)
    params, _ = j_tfm.init_model(jax.random.PRNGKey(0), jcfg)
    return cfg, jcfg, params, bridge.params_from_flat(_flatten(params),
                                                      device="cpu")


@functools.lru_cache(maxsize=None)
def _jamba():
    cfg = smoke_variant("jamba-v0.1-52b")
    return cfg, t_tfm.init_model(cfg, seed=0, device="cpu")


def _programs(shape):
    """{name: (cfg, params, execution)} of a spawn."""
    out = {}
    for model in MODELS:
        cfg, _, _, params = _weights(model)
        out[f"{model}_xla"] = (cfg, params, "xla")
        if model != "ssm_odd":
            out[f"{model}_photonic"] = (cfg, params, "photonic")
    if shape == "1x2":
        out["jamba_xla"] = (*_jamba(), "xla")
    return out


def _cells():
    """Dry-run cells whose census the 1x2 ranks run for real: the SSM
    model's prefill (the conv output's and y's all-gathers, ``w_out``'s
    column all-gather) and decode, the MLA model's decode (the join's ``pmax`` /
    ``psum``)."""
    ssm = dataclasses.replace(sc.variant_cfgs()["ssm"], execution="photonic")
    mla = dataclasses.replace(sc.variant_cfgs()["mla"], execution="photonic")
    return {"ssm_prefill": (ssm, ShapeConfig("p", 16, 4, "prefill")),
            "ssm_decode": (ssm, ShapeConfig("d", 24, 4, "decode")),
            "mla_decode": (mla, ShapeConfig("d", 24, 4, "decode")),
            "mla_prefill": (mla, ShapeConfig("p", 16, 1, "prefill"))}


@functools.lru_cache(maxsize=None)
def _spawn(shape):
    job = {"programs": _programs(shape), "cases": CASES,
           "chunked": ("mla_xla",)}
    if shape == "2x2":
        job["drain"] = {f"{m}_xla": sc.small_requests(
            sc.variant_cfgs()[m]) for m in ("ssm", "mla")}
    if shape == "1x2":
        job["cells"] = _cells()
        job["refuse"] = ("ssm_xla", "ssm_odd_xla", "mla_xla")
    return mesh_lib.init_ranks(jobs.tp_ssm_mla_rank, shape, device="cpu",
                               args=(job,), threads=1)


@functools.lru_cache(maxsize=None)
def _unsharded(name):
    """The unsharded port's steps per case (and chunked case)."""
    cfg, params, ex = _programs("1x2")[name]
    prog = t_api.Program.build(cfg, params, execution=ex, device="cpu")
    out = {case: jobs.ssm_mla_steps(prog, cfg, *case) for case in CASES}
    if name == "mla_xla":
        for B, L in CASES:
            out[("chunked", B, L)] = jobs.ssm_mla_steps(prog, cfg, B, L,
                                                        chunk=4)
    return out


@functools.lru_cache(maxsize=None)
def _jax_unsharded(model, execution):
    """The reference's unsharded program on the same steps, per case."""
    _, jcfg, params, _ = _weights(model)
    prog = j_api.Program.build(jcfg, params, execution=execution)
    toks = jnp.asarray(sc.small_inputs(sc.variant_cfgs()[model]).numpy(),
                       jnp.int32)
    out = {}
    for B, L in CASES:
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
@pytest.mark.parametrize("model", MODELS)
def test_cache_pieces_follow_cache_pspecs(shape, model):
    """Each rank's SSM and MLA cache leaves are its ``local_slice`` of the
    whole caches under ``cache_pspecs`` (made at that shape): ``h`` over
    the 8 heads and ``conv`` over the 80 channels, the misdivided model's
    ``h`` whole and its 64 channels cut, the latents over "model", over
    ("data", "model") for one row of 16 positions on 2x2."""
    cfg = sc.variant_cfgs()[model]
    mesh = mesh_lib.parse_mesh(shape)
    ranks = _spawn(shape)
    for B, L in CASES:
        whole = t_tfm.init_caches(cfg, B, L, device="meta")
        specs = partition.cache_pspecs(cfg, mesh, B, L)
        for rank, r in enumerate(ranks):
            bound = mesh_lib.census_mesh(shape, rank)
            got = r["programs"][f"{model}_xla"][(B, L)]["shapes"]
            assert got
            for (seg, layer, leaf), shp in got.items():
                spec = specs[seg][layer][leaf]
                want = partition.local_slice(whole[seg][layer][leaf], spec,
                                             bound).shape
                if leaf == "conv":       # a 5-token prompt: W-1 = 3 rows
                    want = want[:3] + (min(want[3], sc.SEQ_PROMPT),) \
                        + want[4:]
                assert shp == tuple(want), (shape, B, L, rank, leaf, spec)
        leaves = specs["main"]["l0"]
        if model == "mla":
            assert leaves["ckv"][3] == (("data", "model")
                                        if (shape, B) == ("2x2", 1)
                                        else "model")
        else:
            assert leaves["h"][3] == ("model" if model == "ssm" else None)
            assert leaves["conv"][4] == "model"


@pytest.mark.parametrize("name", ["ssm_xla", "ssm_odd_xla", "mla_xla"])
def test_whole_caches_refused_on_a_rank(name):
    """A decode step given caches made whole (an SSM state of every head,
    a conv tail of every channel, latents of every position) on a 1x2
    rank whose pieces are cut raises, naming the leaf."""
    for r in _spawn("1x2"):
        msg = r["refused"][name]
        assert msg is not None and "cache leaf" in msg
        assert ("'ckv'" if name == "mla_xla" else "'h'" if name == "ssm_xla"
                else "'conv'") in msg


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
@pytest.mark.parametrize("model", ["ssm", "mla"])
def test_photonic_logits_within_bound_of_jax_and_port_unsharded(shape,
                                                                model):
    """A rank scanning its own SSM heads (``w_out`` on the whole y, by
    its column rule) or holding its block of latent positions: each prefill and decode step (scalar and
    per-row positions) within the W8A8 bound of the unsharded JAX program
    and of the unsharded port; every rank returns the same logits."""
    ranks = _spawn(shape)
    name = f"{model}_photonic"
    jax_ref = _jax_unsharded(model, "photonic")
    port = _unsharded(name)
    for case in CASES:
        got = ranks[0]["programs"][name][case]["logits"]
        for r in ranks[1:]:
            assert all(torch.equal(a, b) for a, b in zip(
                r["programs"][name][case]["logits"], got))
        assert len(got) == len(jax_ref[case])
        for a, j, p in zip(got, jax_ref[case], port[case]["logits"]):
            assert _rel(a, j) <= W8A8_BOUND
            assert _rel(a, p) <= W8A8_BOUND


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_ssm_photonic_prefill_bit_equal_to_unsharded_port(shape):
    """The SSM cut is exact and every dot of the prefill runs the
    unsharded rule on the same input (``w_in`` and ``w_out`` column, as
    the reference's rule picks them), so a rank's photonic prefill logits
    equal the unsharded port's bit for bit.  (Its decode steps are held to
    the W8A8 bound above: on the CPU an elementwise op over a rank's
    channels of one row takes the vector loop's tail where the whole row
    does not.)"""
    port = _unsharded("ssm_photonic")
    for case in CASES:
        for r in _spawn(shape):
            got = r["programs"]["ssm_photonic"][case]["logits"][0]
            assert torch.equal(got, port[case]["logits"][0]), (shape, case)


@pytest.mark.parametrize("name", ["ssm_xla", "ssm_odd_xla", "mla_xla",
                                  "jamba_xla"])
def test_xla_1x2_within_1e5_of_unsharded(name):
    """xla on 1x2 (float32): the SSM on the rank's heads and channels, the
    misdivided SSM on its channels with every head, MLA on the rank's
    latent positions, and jamba's hybrid stack (SSM, attention on its KV
    heads, MoE) within 1e-5 of the unsharded port at every step."""
    want = _unsharded(name)
    for r in _spawn("1x2"):
        got = r["programs"][name]
        for case in CASES:
            for a, b in zip(got[case]["logits"], want[case]["logits"]):
                assert _rel(a, b) <= XLA_TOL, (name, case)


def test_xla_logits_match_the_jax_program():
    """The same xla runs held to the reference's unsharded program."""
    for model in MODELS:
        jax_ref = _jax_unsharded(model, "xla")
        got = _spawn("1x2")[0]["programs"][f"{model}_xla"]
        for case in CASES:
            for a, j in zip(got[case]["logits"], jax_ref[case]):
                assert _rel(a, j) <= XLA_TOL, (model, case)


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
@pytest.mark.parametrize("model", ["ssm", "ssm_odd"])
def test_prefill_state_pieces_bit_equal_to_unsharded(shape, model):
    """A rank's ``h`` and ``conv`` after prefill, in every layer, are the
    unsharded prefill's state and conv tail of the same rows cut to the
    rank's heads and channels, bit for bit (xla: the dots run whole, the
    conv is per-channel and the scan per-head).  Where the rows split over
    "data" the unsharded prefill runs the rank's rows alone (the CPU's
    plain einsums are not batch-invariant)."""
    cfg, params, ex = _programs(shape)[f"{model}_xla"]
    prog = t_api.Program.build(cfg, params, execution=ex, device="cpu")
    toks = sc.small_inputs(cfg)[:, :sc.SEQ_PROMPT]
    mesh = mesh_lib.parse_mesh(shape)
    for B, L in CASES:
        specs = partition.cache_pspecs(cfg, mesh, B, L)
        for rank, r in enumerate(_spawn(shape)):
            bound = mesh_lib.census_mesh(shape, rank)
            rows = partition.local_slice(toks[:B], (specs["main"]["l0"][
                "h"][2],), bound)
            _, whole = prog.prefill({"tokens": rows}, L)
            whole = jobs.leaf_tree(whole)
            got = r["programs"][f"{model}_xla"][(B, L)]["pieces"]
            assert {k[2] for k in got} == set(SSM_LEAVES)
            for key, t in got.items():
                spec = (None, None, None) + specs[key[0]][key[1]][key[2]][3:]
                assert torch.equal(t, partition.local_slice(
                    whole[key], spec, bound)), (shape, B, rank, key)


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_mla_sequence_branch_within_1e5_of_unsharded(shape):
    """MLA on xla (float32): a prefill and a chunked prefill (4-token
    chunks: each writes its rank's positions, then the latent buffer is
    gathered for the up-projection), decode steps crossing the ranks'
    blocks of positions and at per-row positions, within 1e-5 of the
    unsharded port; each rank's latents hold its block of the positions,
    which equals the unsharded latents' block."""
    want = _unsharded("mla_xla")
    mesh = mesh_lib.parse_mesh(shape)
    cfg = sc.variant_cfgs()["mla"]
    for case in list(CASES) + [("chunked",) + c for c in CASES]:
        B, L = case[-2:]
        specs = partition.cache_pspecs(cfg, mesh, B, L)
        for rank, r in enumerate(_spawn(shape)):
            got = r["programs"]["mla_xla"][case]
            for a, b in zip(got["logits"], want[case]["logits"]):
                assert _rel(a, b) <= XLA_TOL, (shape, case)
            bound = mesh_lib.census_mesh(shape, rank)
            assert {k[2] for k in got["pieces"]} == set(MLA_LEAVES)
            for key, t in got["pieces"].items():
                spec = specs[key[0]][key[1]][key[2]]
                cut = partition.local_slice(want[case]["pieces"][key], spec,
                                            bound)
                assert t.shape[3] * mesh.axis_size(
                    partition._entry_axes(spec[3])) == L
                assert _rel(t, cut) <= XLA_TOL, (shape, case, key)


@pytest.mark.parametrize("model", ["ssm", "mla"])
def test_dp_drain_token_identical_to_solo_generate(model):
    """2x2 on xla: a data-parallel ``ContinuousScheduler`` drain (the pool
    holds each rank's heads of ``h``, channels of ``conv`` or block of
    latent positions; a one-row prefill's pieces are inserted as they are,
    its latents re-cut from ("data", "model") to the pool's "model") gives
    every rank the tokens of unsharded solo ``generate``."""
    cfg, params, ex = _programs("2x2")[f"{model}_xla"]
    prog = t_api.Program.build(cfg, params, execution=ex, device="cpu")
    want = {}
    for rid, prompt, max_new in sc.small_requests(cfg):
        want[rid] = prog.generate(torch.as_tensor(prompt)[None, :].long(),
                                  max_new)[0].tolist()
    for r in _spawn("2x2"):
        assert r["drain"][f"{model}_xla"] == want


@pytest.mark.parametrize("name", sorted(_cells()))
def test_census_collectives_equal_the_gloo_ranks(name):
    """The dry-run's census of a 1x2 rank (the conv output's and y's
    all-gathers, ``w_out``'s column all-gather and no reduce-scatter, the
    MLA join's pmax and psum, the one-row prefill's latent window) equals
    the collectives the gloo ranks recorded running the step; the planned
    ``ssd_chunk`` calls scan the rank's 4 of 8 heads."""
    cfg, shape = _cells()[name]
    for rank, r in enumerate(_spawn("1x2")):
        res = dryrun.walk(cfg, shape, "1x2", rank=rank)
        want = analysis.collective_census(r["census"][name])
        assert res["collectives"] == want, (name, rank)
        assert want["total_bytes"] > 0
        if name == "ssm_prefill":
            kinds = {k for k, _ in r["census"][name]}
            assert "all-gather" in kinds and "reduce-scatter" not in kinds
        if name == "mla_decode":
            kinds = [k for k, _ in r["census"][name]]
            assert kinds.count("all-reduce") >= 2 * cfg.num_layers


def test_planned_ssd_calls_take_the_ranks_heads():
    """On meta tensors a 1x2 rank plans one ``ssd_chunk`` call a layer
    with half the heads: half the unsharded call's operations."""
    from repro_torch.kernels import planned
    cfg = dataclasses.replace(sc.variant_cfgs()["ssm"], execution="photonic")
    shape = ShapeConfig("p", 16, 4, "prefill")
    got = {}
    for mesh in ("1x1", "1x2"):
        c0, o0 = planned.snapshot()["ssd_chunk"], planned.ops["ssd_chunk"]
        dryrun.walk(cfg, shape, mesh)
        got[mesh] = (planned.snapshot()["ssd_chunk"] - c0,
                     planned.ops["ssd_chunk"] - o0)
    assert got["1x1"][0] == got["1x2"][0] == cfg.num_layers
    assert got["1x2"][1] * 2 == got["1x1"][1]


def test_dryrun_1x1_cell_bytes_unchanged():
    """A 1x1 cell walks no piece: mamba2-780m R&B decode at 4 x 512 holds
    the same bytes as before the SSM caches were cut (the value of the
    walk on the parent commit)."""
    cfg = get_arch("mamba2-780m", reuse=True)
    res = dryrun.walk(cfg, ShapeConfig("d", 512, 4, "decode"), "1x1")
    assert res["memory"] == DRYRUN_1X1_MEMORY


def test_dryrun_16x16_mamba2_decode_caches_are_their_pieces():
    """A 16x16 rank of mamba2-780m R&B decode_32k holds, of every cache
    leaf, its ``local_shape`` under ``cache_pspecs`` (heads and channels
    over the 16 "model" ranks, rows over the 16 data ranks): the caches'
    bytes are the sum of those pieces', 1/256 of the whole caches'."""
    cfg = get_arch("mamba2-780m", reuse=True)
    shape = ShapeConfig("d", 32768, 128, "decode")
    mesh = mesh_lib.census_mesh("16x16", 0)
    _, (_, _, caches) = dryrun.rank_step(cfg, shape, mesh)
    whole = t_tfm.init_caches(cfg, 128, 32768, device="meta")
    specs = partition.cache_pspecs(cfg, mesh, 128, 32768)
    held = want = full = 0
    for key, t in jobs.leaf_tree(caches).items():
        w = jobs.leaf_tree(whole)[key]
        spec = specs[key[0]][key[1]][key[2]]
        held += t.numel() * t.element_size()
        want += int(np.prod(partition.local_shape(w.shape, spec, mesh))) \
            * w.element_size()
        full += w.numel() * w.element_size()
    assert held == want == full // 256
