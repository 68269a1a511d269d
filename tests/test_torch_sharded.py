"""Sharded execution on gloo ranks on the CPU (``launch.mesh.init_ranks``,
one spawn per mesh shape), with the reference's gates
(``repro.launch.shardcheck``) on its ``small_cfg`` and its weights
(``PRNGKey(0)``, carried over with ``bridge``):

  * photonic 1x2 and 2x2 prefill and decode logits within the W8A8 bound
    (0.055 rel-L2) of the unsharded JAX program and of the unsharded port;
  * xla 2x1 within 1e-5;
  * ``reduce_scatter`` bit-identical to ``psum``, ``ring`` within 1e-5 per
    dot and within the bound over the model;
  * a 1x1 mesh bit-identical to ``mesh=None`` (in-process);
  * 2x2 data-parallel ``ContinuousScheduler`` completions token-identical
    to unsharded solo ``generate`` (and to the unsharded scheduler);
  * the dropped-rule warning, and the refusals: conflicting meshes, noise
    with a mesh, a mesh given to a scheduler whose Program has none, a
    mesh of several positions without ranks.  (``Program.loss`` and
    ``cfg.fsdp`` on a mesh run since slice 16: ``tests/test_torch_fsdp.py``
    and ``tests/test_torch_train_mesh.py``.)

The reference's own sharded path raises under jax 0.9's explicit mesh
axes (``repro/api.py`` ``_constrain_caches``), so the port is held to the
reference's UNSHARDED program, as the reference holds itself."""
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
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import shardcheck as sc

torch.set_num_threads(2)
W8A8_BOUND = 0.055


@functools.lru_cache(maxsize=None)
def _weights():
    # the reference shardcheck's small_cfg (its module sets XLA_FLAGS on
    # import, so it is not imported here)
    jcfg = JCfg(name="shard-t", family="dense", num_layers=2, d_model=32,
                num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=128,
                compute_dtype="float32")
    params, _ = j_tfm.init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, params, bridge.params_from_flat(_flatten(params),
                                                 device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_unsharded(execution):
    """The reference's unsharded prefill / decode logits on the gate's
    tokens."""
    jcfg, params, _ = _weights()
    B, S, L = sc.SEQ
    toks = jnp.asarray(sc.small_inputs(sc.small_cfg()).numpy(), jnp.int32)
    prog = j_api.Program.build(jcfg, params, execution=execution)
    lr, cr = prog.prefill({"tokens": toks}, L)
    dr, _ = prog.decode(toks[:, :1], cr, S)
    return np.asarray(lr), np.asarray(dr)


@functools.lru_cache(maxsize=None)
def _spawn(mesh, execution, **kw):
    _, _, params = _weights()
    return sc.run(mesh, execution, W8A8_BOUND, device="cpu", params=params,
                  threads=1, **kw)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _photonic_1x2():
    return _spawn("1x2", "photonic", collectives=True, variants=True)


def _photonic_2x2():
    return _spawn("2x2", "photonic", serve=True, dropped=True,
                  refusals=True, solo_gate=True, variants=True)


@pytest.mark.parametrize("which", ["1x2", "2x2"])
def test_photonic_gates_pass(which):
    fails, rep = _photonic_1x2() if which == "1x2" else _photonic_2x2()
    assert fails == []
    assert len(rep["ranks"]) == (2 if which == "1x2" else 4)
    assert all("gloo" in r["transport"] for r in rep["ranks"])


@pytest.mark.parametrize("which", ["1x2", "2x2"])
def test_photonic_logits_within_bound_of_jax_and_port_unsharded(which):
    _, rep = _photonic_1x2() if which == "1x2" else _photonic_2x2()
    jl, jd = _jax_unsharded("photonic")
    lr, dr = rep["unsharded"]
    for r in rep["ranks"]:
        assert r["prefill"].shape == jl.shape
        assert _rel(r["prefill"], jl) <= W8A8_BOUND
        assert _rel(r["decode"], jd) <= W8A8_BOUND
        assert _rel(r["prefill"], lr) <= W8A8_BOUND
        assert _rel(r["decode"], dr) <= W8A8_BOUND
    # the port's unsharded program itself sits within the bound of JAX's
    assert _rel(lr, jl) <= W8A8_BOUND and _rel(dr, jd) <= W8A8_BOUND


@pytest.mark.parametrize("which", ["1x2", "2x2"])
@pytest.mark.parametrize("variant", ["rb", "moe", "ssm", "ssm_odd", "mla"])
def test_rb_and_moe_variants_within_bound_of_unsharded(which, variant):
    """An R&B stack whose square attention banks are read transposed (a
    rank regathers those fields over "model"), a MoE stack with blended
    experts (the reuse-resident MVM column-split; the expert FFN on the
    whole batch), Mamba-2 stacks with their SSM heads cut over "model" and
    whole (3 heads), and an MLA stack with its latents over the positions,
    against their unsharded port programs."""
    _, rep = _photonic_1x2() if which == "1x2" else _photonic_2x2()
    ul, ud = rep["unsharded_variants"][variant]
    for r in rep["ranks"]:
        vl, vd = r["variants"][variant]
        assert vl.shape == ul.shape and bool(torch.isfinite(vl).all())
        assert _rel(vl, ul) <= W8A8_BOUND
        assert _rel(vd, ud) <= W8A8_BOUND


def test_xla_2x1_within_1e5_of_unsharded():
    fails, rep = _spawn("2x1", "xla")
    assert fails == []
    jl, jd = _jax_unsharded("xla")
    lr, dr = rep["unsharded"]
    for r in rep["ranks"]:
        assert r["cache_rows"] == sc.SEQ[0] // 2      # each its data shard
        assert _rel(r["prefill"], lr) <= 1e-5
        assert _rel(r["decode"], dr) <= 1e-5
        assert _rel(r["prefill"], jl) <= 1e-5
        assert _rel(r["decode"], jd) <= 1e-5


def test_reduce_scatter_bit_identical_to_psum_and_ring_close():
    _, rep = _photonic_1x2()
    col = rep["ranks"][0]["collectives"]
    for label in ("plain", "bias+silu", "blend-shuffle"):
        psum = col["per_dot"][(label, "psum")]
        assert torch.equal(col["per_dot"][(label, "reduce_scatter")], psum)
        assert _rel(col["per_dot"][(label, "ring")], psum) <= 1e-5
    m = col["model"]
    assert torch.equal(m["reduce_scatter"][0], m["psum"][0])
    assert _rel(m["reduce_scatter"][1], m["psum"][1]) <= 1e-5
    assert _rel(m["ring"][1], m["psum"][1]) <= W8A8_BOUND


def test_single_device_mesh_bit_identical_in_process():
    _, _, params = _weights()
    cfg = sc.small_cfg()
    toks = sc.small_inputs(cfg)
    B, S, L = sc.SEQ
    for execution in ("photonic", "xla"):
        ref = t_api.Program.build(cfg, params, execution=execution,
                                  device="cpu")
        one = t_api.Program.build(cfg, params, execution=execution,
                                  device="cpu",
                                  mesh=mesh_lib.single_device_mesh())
        assert one.mesh == mesh_lib.single_device_mesh()
        assert not one.backend.mesh_active
        lr, cr = ref.prefill({"tokens": toks}, L)
        lo, co = one.prefill({"tokens": toks}, L)
        assert torch.equal(lr, lo)
        dr, _ = ref.decode(toks[:, :1], cr, S)
        do, _ = one.decode(toks[:, :1], co, S)
        assert torch.equal(dr, do)
        assert torch.equal(ref.generate(toks[:2], 4),
                           one.generate(toks[:2], 4))


def test_dp_serving_token_identical_to_solo_generate():
    _, rep = _photonic_2x2()
    _, _, params = _weights()
    ref = t_api.Program.build(sc.small_cfg(), params, execution="photonic",
                              device="cpu")
    reqs = sc.small_requests(sc.small_cfg())
    for r in rep["ranks"]:
        assert r["serve"]["pool_rows"] == 2
        for rid, prompt, max_new in reqs:
            solo = ref.generate(torch.as_tensor(prompt)[None].long(),
                                max_new)[0].numpy()
            np.testing.assert_array_equal(r["serve"]["tokens"][rid], solo)
    assert sorted(r["serve"]["pool_lo"] for r in rep["ranks"]) == [0, 0,
                                                                   2, 2]


def test_dropped_rule_warning_on_every_rank():
    _, rep = _photonic_2x2()
    for r in rep["ranks"]:
        assert len(r["dropped"]) == 1
        assert r["dropped"][0].startswith("sharding: ")
        assert "rule(s) dropped" in r["dropped"][0]
        assert "mlp:45%model" in r["dropped"][0]


@pytest.mark.parametrize("what", [
    "conflicting_mesh", "noise_backend", "update_noise",
    "scheduler_mesh_without_program_mesh", "scheduler_conflicting_mesh",
    "unbound_mesh"])
def test_mesh_refusals(what):
    _, rep = _photonic_2x2()
    want = {"noise_backend": "NotImplementedError",
            "update_noise": "NotImplementedError"}.get(what, "ValueError")
    for r in rep["ranks"]:
        assert r["refusals"][what] == want


def test_act_pspec_on_the_step_functions():
    """``prefill_step_fn`` / ``decode_step_fn`` accept the serving spec of
    a mesh and its "seq" / "hidden" specs as the reference's dry-run rules
    give them (the batch entry None where the rows do not divide the data
    axes), refuse any other placement, and refuse a spec off-mesh."""
    from repro_torch.core import backend as backend_lib
    cfg = sc.small_cfg()
    _, _, params = _weights()
    toks = sc.small_inputs(cfg)
    with pytest.raises(ValueError, match="active mesh"):
        t_api.prefill_step_fn(cfg, 14, act_pspec=("data",))(
            params, {"tokens": toks})
    bk = backend_lib.Backend("xla", mesh=mesh_lib.parse_mesh("2x2"))
    assert toks.shape[0] % 2 == 0
    with pytest.raises(NotImplementedError, match="places its residual"):
        t_api.prefill_step_fn(cfg, 14, act_pspec=(None, "model", None),
                              execution=bk)(params, {"tokens": toks})
    assert t_api._act_pspec_of(bk, 4, "seq") == ("data", "model", None)
    assert t_api._act_pspec_of(bk, 4, "hidden") == ("data", None, "model")
    assert t_api._act_pspec_of(bk, 3, "seq") == (None, "model", None)
    assert t_api._act_pspec_of(bk, 3, "hidden") == (None, None, "model")
    assert t_api._serve_act_pspec(bk, 4) == ("data",)
    assert t_api._serve_act_pspec(bk, 3) is None
    assert t_api._mesh_act_pspec(bk, 4) == ("data",)
    one = backend_lib.Backend("xla", mesh=mesh_lib.single_device_mesh())
    assert t_api._serve_act_pspec(one, 4) is None
