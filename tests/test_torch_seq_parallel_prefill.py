"""The prefill with the residual cut over "model" ("seq": a rank's block
of the positions, "hidden": its block of the channels; ``api.
prefill_step_fn(..., act_pspec=)``) on gloo ranks on the CPU, and the
dry-run's ``--act-mode seq|hidden`` cells:

  * "seq" and "hidden" last logits and every cache leaf bit-equal to the
    same mesh's serving-spec ("replicated") prefill, on the xla and the
    photonic backends: the pair-second dot adds the same partial sums and
    only the dim of its reduce-scatter moves, each norm sees whole rows of
    statistics (a "hidden" rank gathers its channels before the norm);
  * those logits within 1e-5 (xla) and 1e-3 (photonic) of the unsharded
    port and of the JAX program on the same weights, and a decode step
    under each spec (its residual whole) equal to the serving spec's;
  * the "seq" prefill's collectives: an all-gather entering every mixer
    and FFN and one for the head, a reduce-scatter leaving each;
  * the dry-run's "seq" / "hidden" train and prefill cells ``ok`` on 2x2
    with their census collectives equal to the gloo ranks' running the
    same step, and a 1x1 cell's bytes unchanged by the mode.

Models: the shardcheck variants ``rb`` (dense R&B) and ``ssm`` (Mamba-2:
``ssd_chunk`` on a rank's heads) on the reference's ``PRNGKey(0)``
weights; two rows of 16 tokens."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import api as j_api
from repro.core import backend as j_backend
from repro.models import transformer as j_tfm
from repro.train.checkpoint import _flatten

from repro_torch import api as t_api
from repro_torch import bridge
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import analysis, dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import shardcheck as sc

import _torch_mesh_jobs as jobs
import test_torch_tp_ssm_mla as tsm

torch.set_num_threads(2)
MODELS = ("rb", "ssm")
EXECUTIONS = ("xla", "photonic")
MODES = ("seq", "hidden")
TOL = {"xla": 1e-5, "photonic": 1e-3}
B, S = 2, 16


@functools.lru_cache(maxsize=None)
def _weights(model):
    cfg = sc.variant_cfgs()[model]
    jcfg = tsm._jcfg(cfg)
    params, _ = j_tfm.init_model(jax.random.PRNGKey(0), jcfg)
    return cfg, jcfg, params, _flatten(params)


def _tokens(cfg):
    g = torch.Generator().manual_seed(5)
    return torch.randint(1, cfg.vocab_size, (B, S), generator=g)


@functools.lru_cache(maxsize=None)
def _spawn(shape):
    job = {"models": {m: (_weights(m)[0], _weights(m)[3]) for m in MODELS},
           "executions": EXECUTIONS,
           "tokens": _tokens(sc.variant_cfgs()["rb"]).numpy()}
    return mesh_lib.init_ranks(jobs.prefill_rank, shape, device="cpu",
                               args=(job,), threads=1)


@functools.lru_cache(maxsize=None)
def _unsharded(model, execution):
    """(last logits of the unsharded port, of the JAX program)."""
    cfg, jcfg, params, flat = _weights(model)
    toks = _tokens(sc.variant_cfgs()["rb"])
    port, _ = t_api.prefill_step_fn(cfg, S + 1, execution=execution)(
        bridge.params_from_flat(flat, device="cpu"), {"tokens": toks})
    jfn = j_api.prefill_step_fn(jcfg, S + 1,
                                execution=j_backend.Backend(execution))
    ref, _ = jfn(params, {"tokens": jnp.asarray(toks.numpy(), jnp.int32)})
    return port.numpy(), np.asarray(ref)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("execution", EXECUTIONS)
@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_prefill_bit_equal_to_the_serving_spec(shape, model, execution,
                                               mode):
    for r in _spawn(shape):
        got = r[(model, execution, mode)]
        want = r[(model, execution, "replicated")]
        assert torch.equal(got["logits"], want["logits"])
        assert sorted(got["caches"]) == sorted(want["caches"])
        for k, v in want["caches"].items():
            assert torch.equal(got["caches"][k], v), k
        assert torch.equal(got["decode"], want["decode"])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("execution", EXECUTIONS)
@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_prefill_matches_the_unsharded_port_and_jax(shape, model,
                                                    execution, mode):
    """Each rank's rows of the last logits (its data shard's: one row a
    rank on 2x2) against the same rows unsharded."""
    port, ref = _unsharded(model, execution)
    for r in _spawn(shape):
        got = r[(model, execution, mode)]["logits"].numpy()
        rows = slice(r["coords"][0] * len(got), (r["coords"][0] + 1)
                     * len(got))
        assert _rel(got, port[rows]) <= TOL[execution]
        assert _rel(got, ref[rows]) <= TOL[execution]


@pytest.mark.parametrize("model", MODELS)
def test_seq_prefill_gathers_entering_and_scatters_leaving(model):
    """On 1x2 the photonic "seq" prefill runs one all-gather more than the
    serving spec's for each mixer and FFN entry and one for the final norm,
    and one reduce-scatter a pair-second dot (attention's ``wo``, the MLP's
    ``w_down``; the SSM's ``w_out`` has no row partner and rejoins whole),
    as the serving spec's does over the channels; where that one then
    all-gathers the channels back, "seq" gathers nothing."""
    cfg = sc.variant_cfgs()[model]
    r = _spawn("1x2")[0]
    kinds = {}
    for mode in ("replicated", "seq"):
        rec = r[(model, "photonic", mode)]["collectives"]
        kinds[mode] = {k: sum(1 for kk, _ in rec if kk == k)
                       for k in ("all-gather", "reduce-scatter")}
    blocks = cfg.num_layers * (1 + (cfg.ffn_kind(0) != "none"))
    rows = 0 if model == "ssm" else blocks
    assert kinds["seq"]["reduce-scatter"] == \
        kinds["replicated"]["reduce-scatter"] == rows
    assert kinds["seq"]["all-gather"] == \
        kinds["replicated"]["all-gather"] + blocks + 1 - rows


# -------------------------------------------------------------------------
# the dry-run's --act-mode cells
# -------------------------------------------------------------------------
def _cells():
    rb = sc.variant_cfgs()["rb"]
    moe = sc.variant_cfgs()["moe"]
    pre = ShapeConfig("p", 16, 4, "prefill")
    train = ShapeConfig("t", 16, 4, "train")
    return {
        "seq_prefill": (dataclasses.replace(rb, execution="photonic"), pre,
                        "seq"),
        "hidden_prefill": (dataclasses.replace(rb, execution="photonic"),
                           pre, "hidden"),
        "seq_train": (rb, train, "seq"),
        "hidden_train_fsdp": (dataclasses.replace(rb, fsdp=True), train,
                              "hidden"),
        "seq_moe_train": (moe, train, "seq"),
    }


@pytest.fixture(scope="module")
def gloo_records():
    return mesh_lib.init_ranks(jobs.census_rank, "2x2", device="cpu",
                               args=(_cells(),), threads=1)


@pytest.mark.parametrize("name", sorted(_cells()))
def test_act_mode_census_equals_a_gloo_run(gloo_records, name):
    cfg, shape, mode = _cells()[name]
    for rank, recorded in enumerate(gloo_records):
        r = dryrun.walk(cfg, shape, "2x2", rank=rank, act_mode=mode)
        assert r["status"] == "ok"
        want = analysis.collective_census(recorded[name])
        assert r["collectives"] == want, (name, rank)
        assert want["total_bytes"] > 0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_act_mode_cells_walk_and_a_1x1_cell_is_unchanged(kind, mode):
    """``lower_cell`` walks ``--act-mode`` cells on a mesh (no SKIP); on
    1x1 the mode changes no byte of a cell."""
    cfg = sc.variant_cfgs()["rb"]
    shape = ShapeConfig("c", 16, 4, kind)
    base = dryrun.walk(cfg, shape, "1x1")
    cut = dryrun.walk(cfg, shape, "1x1", act_mode=mode)
    assert cut["memory"] == base["memory"]
    r = dryrun.walk(cfg, shape, "2x2", act_mode=mode)
    assert r["status"] == "ok"
    assert r["memory"] != base["memory"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cell", [("minitron-4b", "prefill_32k"),
                                  ("granite-moe-1b-a400m", "train_4k")])
def test_lower_cell_walks_act_mode_cells_at_full_width(cell, mode):
    r = dryrun.lower_cell(*cell, reuse=True, mesh_shape=(2, 2),
                          act_mode=mode)
    assert r["status"] == "ok" and r["act_mode"] == mode
    assert r["collectives"]["total_bytes"] > 0
