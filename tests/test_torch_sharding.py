"""The pure parts of the port's sharded execution against the JAX
reference: the partition rule's decision table, the spec tables (params,
prepared banks, caches, activations), the dropped-rule report, the mesh
parsers, the data-parallel slot packing, and a rank's pieces of a bank
reassembling into the whole bank.  The reference's specs are computed on
``jax.sharding.AbstractMesh`` (no devices)."""
import functools
import itertools

import numpy as np
import pytest
import torch

import jax
from jax.sharding import AbstractMesh

from repro.configs.archs import smoke_variant as j_smoke
from repro.core import backend as j_backend
from repro.core import prepared as j_prepared
from repro.models import transformer as j_tfm
from repro.serve import slots as j_slots
from repro.sharding import partition as jp
from repro.train.checkpoint import _flatten

from repro_torch import bridge
from repro_torch.configs import smoke_variant as t_smoke
from repro_torch.core import backend as t_backend
from repro_torch.core import prepared as t_prepared
from repro_torch.core.noise import NoiseConfig
from repro_torch.launch import mesh as mesh_lib
from repro_torch.serve.slots import SlotPool, SlotState
from repro_torch.sharding import partition as tp

torch.set_num_threads(2)

SHAPES = [(1, 1), (1, 2), (2, 1), (2, 2), (2, 2, 2)]
ARCHS = ["minitron-4b", "granite-moe-1b-a400m", "mamba2-780m"]


def _axes(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def _meshes(shape):
    axes = _axes(shape)
    return AbstractMesh(shape, axes), mesh_lib.make_mesh(shape, axes)


@functools.lru_cache(maxsize=None)
def _model(arch):
    jc, tc = j_smoke(arch), t_smoke(arch)
    params, _ = j_tfm.init_model(jax.random.PRNGKey(0), jc)
    t_params = bridge.params_from_flat(_flatten(params), device="cpu")
    return jc, tc, params, t_params


@functools.lru_cache(maxsize=None)
def _banks(arch):
    jc, tc, params, t_params = _model(arch)
    j_bank = jax.eval_shape(
        lambda p: j_prepared.prepare_params(p, jc.compute_dtype, True),
        params)
    t_bank = t_prepared.prepare_params(t_params, tc.compute_dtype, True)
    return j_bank, t_bank


def _pairs(a, b, path=()):
    """(path, ref leaf, port leaf) of two nested-dict trees with the same
    keys."""
    if isinstance(b, dict):
        assert sorted(a) == sorted(b), path
        for k in sorted(b):
            yield from _pairs(a[k], b[k], path + (k,))
    else:
        yield path, a, b


def _spec(x):
    """A reference spec leaf (PartitionSpec or NamedSharding) as a tuple."""
    return tuple(getattr(x, "spec", x))


# --------------------------------------------------------- partition rule
GRID = list(itertools.product(
    [1, 2, 3, 4], [8, 12, 30], [8, 12, 30], [None, (1, 0)], [None, "row"],
    ["reduce_scatter", "psum", "ring"]))


@pytest.mark.parametrize("tp_", [1, 2, 3, 4])
def test_partition_rule_equals_reference(tp_):
    n = 0
    for t, K, N, perm, hint, coll in GRID:
        if t != tp_:
            continue
        want = j_backend.partition_rule(t, K, N, block_perm=perm,
                                        tp_hint=hint, collective=coll)
        got = t_backend.partition_rule(t, K, N, block_perm=perm,
                                       tp_hint=hint, collective=coll)
        assert got == want, (t, K, N, perm, hint, coll)
        n += 1
    assert n == 3 * 3 * 2 * 2 * 3
    assert t_backend.TP_COLLECTIVES == j_backend.TP_COLLECTIVES


def test_partition_rule_unknown_collective_raises():
    with pytest.raises(ValueError, match="unknown tp_collective"):
        j_backend.partition_rule(2, 8, 8, collective="allgather")
    with pytest.raises(ValueError, match="unknown tp_collective"):
        t_backend.partition_rule(2, 8, 8, collective="allgather")
    # tp <= 1 short-circuits before the check in both
    assert t_backend.partition_rule(1, 8, 8, collective="x") == \
        j_backend.partition_rule(1, 8, 8, collective="x") == "replicated"


# ------------------------------------------------------------ spec tables
@pytest.mark.parametrize("arch", ARCHS)
def test_model_specs_equal_reference(arch):
    jc, tc, _, t_params = _model(arch)
    want = j_tfm.model_specs(jc)
    got = tp.model_specs(t_params)
    pairs = list(_pairs(want, got))
    assert len(pairs) > 5
    for path, a, b in pairs:
        assert tuple(a) == b, path


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_tree_pspecs_equal_reference(arch, shape):
    jc, tc, params, t_params = _model(arch)
    jm, tm = _meshes(shape)
    specs = j_tfm.model_specs(jc)
    t_specs = tp.model_specs(t_params)
    for fsdp in (False, True):
        rj = jp.PartitionReport(dropped=[])
        rt = tp.PartitionReport(dropped=[])
        want = jp.param_shardings(params, specs, jm, fsdp, rj)
        got = tp.param_shardings(t_params, t_specs, tm, fsdp, rt)
        for path, a, b in _pairs(want, got):
            assert _spec(a) == b, (path, fsdp)
        assert rt.dropped == rj.dropped
        assert tp.dropped_summary(rt) == jp.dropped_summary(rj)
        for path, a, b in _pairs(jp.tree_pspecs(params, specs, jm, fsdp),
                                 tp.tree_pspecs(t_params, t_specs, tm,
                                                fsdp)):
            assert tuple(a) == b, path


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_bank_shardings_equal_reference(arch, shape):
    jc, _, _, t_params = _model(arch)
    j_bank, t_bank = _banks(arch)
    jm, tm = _meshes(shape)
    rj = jp.PartitionReport(dropped=[])
    rt = tp.PartitionReport(dropped=[])
    want = jp.bank_shardings(j_bank, j_tfm.model_specs(jc), jm, False, rj)
    got = tp.bank_shardings(t_bank, tp.model_specs(t_bank), tm, False, rt)
    n = 0
    for path, a, b in _pairs(want, got):
        if isinstance(b, t_prepared.PreparedTensor):
            assert isinstance(a, j_prepared.PreparedTensor), path
            assert b.tag == a.tag
            for f in t_prepared.FIELDS:
                assert _spec(getattr(a, f)) == getattr(b, f), (path, f)
            n += 1
        else:
            assert _spec(a) == b, path
    assert n > 0
    assert rt.dropped == rj.dropped


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_activation_pspecs_equal_reference(arch, shape):
    jc, tc, _, _ = _model(arch)
    jm, tm = _meshes(shape)
    for B, L in ((4, 16), (1, 16), (3, 24), (8, 64)):
        for path, a, b in _pairs(jp.cache_pspecs(jc, jm, B, L),
                                 tp.cache_pspecs(tc, tm, B, L)):
            assert tuple(a) == b, (path, B, L)
    assert tuple(jp.batch_pspec(jm)) == tp.batch_pspec(tm)
    for mode in ("seq", "hidden", "replicated"):
        assert tuple(jp.act_pspec(jm, mode)) == tp.act_pspec(tm, mode)
    assert jp.data_axes(jm) == tp.data_axes(tm)
    assert jp.dp_size(jm) == tp.dp_size(tm)
    assert tuple(jp.replicated(jm).spec) == tp.replicated(tm)


def test_dropped_summary_on_a_misdivided_mesh_equals_reference():
    from repro.configs.base import ModelConfig as JCfg
    from repro_torch.configs.base import ModelConfig as TCfg
    jc = JCfg(
        name="shard-drop", family="dense", num_layers=2, d_model=30,
        num_heads=3, num_kv_heads=3, d_ff=90, vocab_size=128,
        compute_dtype="float32")
    tc = TCfg(
        name="shard-drop", family="dense", num_layers=2, d_model=30,
        num_heads=3, num_kv_heads=3, d_ff=90, vocab_size=128,
        compute_dtype="float32")
    params, _ = j_tfm.init_model(jax.random.PRNGKey(0), jc)
    t_params = bridge.params_from_flat(_flatten(params), device="cpu")
    jm, tm = _meshes((1, 4))
    rj = jp.PartitionReport(dropped=[])
    rt = tp.PartitionReport(dropped=[])
    jp.param_shardings(params, j_tfm.model_specs(jc), jm, False, rj)
    tp.param_shardings(t_params, tp.model_specs(t_params), tm, False, rt)
    assert len(rj.dropped) > 6 and rt.dropped == rj.dropped
    assert tp.dropped_summary(rt) == jp.dropped_summary(rj)
    assert "(+" in tp.dropped_summary(rt)


# ------------------------------------------------------------------ meshes
@pytest.mark.parametrize("spec", ["2x", "0x2", "2x2x2x2", "abc", "2", "",
                                  (2,), (1, -1)])
def test_parse_mesh_errors(spec):
    with pytest.raises(ValueError, match="must be DxM or PxDxM"):
        mesh_lib.parse_mesh(spec)


def test_mesh_constructors():
    m = mesh_lib.parse_mesh("2x4")
    assert m.shape == {"data": 2, "model": 4} and m.size == 8
    assert not m.bound
    m3 = mesh_lib.parse_mesh((2, 1, 2))
    assert m3.axis_names == ("pod", "data", "model")
    one = mesh_lib.single_device_mesh()
    assert one.bound and one.size == 1 and one.coords == (0, 0)
    assert mesh_lib.parse_mesh("1x1") == one
    assert mesh_lib.make_mesh_auto(devices=8).shape == {"data": 2,
                                                        "model": 4}
    assert mesh_lib.make_mesh_auto(devices=6).shape == {"data": 3,
                                                        "model": 2}
    assert mesh_lib.make_mesh_auto(devices=1) == one
    with pytest.raises(RuntimeError, match="needs 256 devices"):
        mesh_lib.make_production_mesh(devices=8)
    with pytest.raises(RuntimeError, match="needs 512 devices"):
        mesh_lib.make_production_mesh(multi_pod=True, devices=256)
    assert mesh_lib.make_production_mesh(devices=256).shape == {
        "data": 16, "model": 16}
    assert mesh_lib.transport_for("cpu", 4) == "gloo"


def test_backend_mesh_rules():
    mesh = mesh_lib.parse_mesh("2x2")
    bk = t_backend.Backend("photonic", mesh=mesh)
    assert bk.mesh_active and not bk.use_flash(4096)
    assert t_backend.Backend("photonic").use_flash(4096)
    one = t_backend.Backend("photonic", mesh=mesh_lib.single_device_mesh())
    assert not one.mesh_active and one.use_flash(4096)
    noise = NoiseConfig(gain_sigma=0.01)
    with pytest.raises(NotImplementedError, match="single-device only"):
        t_backend.Backend("photonic", mesh=mesh, noise=noise)
    with pytest.raises(NotImplementedError, match="single-device only"):
        j_backend.Backend("photonic", mesh=AbstractMesh((2, 2), (
            "data", "model")), noise=_j_noise())
    # a 1x1 mesh keeps the fault model, as in the reference
    assert t_backend.Backend("photonic", mesh=mesh_lib.single_device_mesh(),
                             noise=noise).noise_active
    with pytest.raises(ValueError, match="unknown tp_collective"):
        t_backend.Backend("photonic", tp_collective="bogus")


def _j_noise():
    from repro.core.noise import NoiseConfig as JNoise
    return JNoise(gain_sigma=0.01)


# ------------------------------------------------------- data-parallel pool
def _bound(shape, coords):
    return mesh_lib.Mesh(_axes(shape), tuple(shape), coords=tuple(coords))


def _ops(seed, capacity, n):
    """A seeded sequence of allocate / free operations."""
    rng = np.random.default_rng(seed)
    return [("free" if rng.random() < 0.35 else "alloc") for _ in range(n)]


@pytest.mark.parametrize("shape,capacity", [((2, 2), 8), ((4, 1), 8),
                                            ((2, 1), 6), ((2, 2, 1), 8)])
def test_dp_slot_allocation_follows_the_reference_rule(shape, capacity):
    jc, tc, _, _ = _model("minitron-4b")
    dp = int(np.prod(shape[:-1]))
    ref = j_slots.SlotPool(jc, capacity, 8)
    ref.dp = dp                       # the reference's rule, off-mesh
    pools = [SlotPool(tc, capacity, 8, device="cpu",
                      mesh=_bound(shape, np.unravel_index(r, shape)))
             for r in range(int(np.prod(shape)))]
    assert pools[0].dp == dp and pools[0].rows == capacity // dp
    rng = np.random.default_rng(0)
    for step, op in enumerate(_ops(1, capacity, 60)):
        active = ref.active_slots()
        if op == "free" and active:
            slot = active[int(rng.integers(len(active)))]
            ref.free(slot)
            for p in pools:
                p.free(slot)
        elif ref.num_free:
            want = ref.allocate(j_slots.SlotState(rid=step, prompt_len=1,
                                                  max_new=1))
            for p in pools:
                assert p.allocate(SlotState(rid=step, prompt_len=1,
                                            max_new=1)) == want, step
    # each rank's caches hold its shard block
    leaf = pools[-1].caches["main"]["l0"]["k"]
    assert leaf.shape[2] == capacity // dp
    assert sorted({p.lo for p in pools}) == [i * (capacity // dp)
                                             for i in range(dp)]


def test_dp_pool_capacity_must_divide():
    _, tc, _, _ = _model("minitron-4b")
    with pytest.raises(ValueError, match="must divide over the mesh's 2"):
        SlotPool(tc, 3, 8, device="cpu", mesh=_bound((2, 2), (0, 0)))
    # a pure-TP mesh has one data shard: any capacity
    assert SlotPool(tc, 3, 8, device="cpu",
                    mesh=_bound((1, 2), (0, 1))).rows == 3


# ------------------------------------------------------------- bank pieces
@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4), (2, 2, 2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_bank_pieces_reassemble_bit_equal(arch, shape):
    _, t_bank = _banks(arch)
    specs = tp.model_specs(t_bank)
    ranks = [np.unravel_index(r, shape) for r in range(int(np.prod(shape)))]
    placed = {tuple(int(c) for c in co): tp.place_bank(
        t_bank, specs, _bound(shape, co)) for co in ranks}
    mesh_shape = dict(zip(_axes(shape), shape))
    n_split = 0
    for path, whole, _ in _pairs(t_bank, t_bank):
        if not isinstance(whole, t_prepared.PreparedTensor):
            continue
        pieces = {co: functools.reduce(lambda t, k: t[k], path, b)
                  for co, b in placed.items()}
        pl = next(iter(pieces.values())).placement
        assert pl.full_shape == tuple(whole.wq.shape)
        for f in t_prepared.FIELDS:
            spec = getattr(pl.specs, f)
            got = tp.assemble({co: getattr(p, f) for co, p in
                               pieces.items()}, spec, mesh_shape)
            assert torch.equal(got, getattr(whole, f)), (path, f)
            n_split += any(e is not None for e in spec)
        # the placement is field_specs of the weight's matrix spec
        wspec = tp.matrix_spec(tp.leaf_axes(path, whole.ndim), whole.shape,
                               _bound(shape, ranks[0]))
        assert pl.specs == t_prepared.PreparedTensor.field_specs(
            wspec, whole.ndim)
    assert n_split > 0
