"""The port's photonic-simulator, OBU, sharing and W8A8 helpers against the
JAX reference on the same numpy inputs: ``tests/test_core.py``'s helper
cases (the photonic matmul, the offset decomposition, the tiling counts,
the group shuffle), the write noise by property, ``stacked_init``,
``tree_stack``, ``identity_stack`` and ``param_count``, and the W8A8 PTQ
on a paper model's tree and a small transformer's.

Tolerances: the photonic matmul within 1e-5 rel-L2 of the reference's and
of ``w8a8_matmul_reference`` (float32 products in another summation
order); the offset recomposition within 1e-5; everything else exact: the
shuffles, the quantized weights and scales, the counts, the dequantized
trees and ``model_bytes`` (the W8A8 ops are abs-max, one divide, round
half to even and clip on both sides).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import ModelConfig as JModelConfig
from repro.core import obu as j_obu
from repro.core import photonic as j_ph
from repro.core import sharing as j_sharing
from repro.core.prm import ReuseConfig as JReuse
from repro.models import paper_models as j_pm
from repro.models import transformer as j_tfm
from repro.quant import w8a8 as j_w8a8
from repro.train import checkpoint as j_ckpt

from repro_torch import bridge
from repro_torch.core import obu as t_obu
from repro_torch.core import photonic as t_ph
from repro_torch.core import sharing as t_sharing
from repro_torch.quant import w8a8 as t_w8a8

torch.set_num_threads(2)
MATMUL_TOL = 1e-5


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _np(seed, shape, kind="normal"):
    r = np.random.default_rng(seed)
    if kind == "uniform":
        return r.uniform(-1.0, 1.0, size=shape).astype(np.float32)
    return r.normal(size=shape).astype(np.float32)


# ------------------------------------------------------------ photonic
@pytest.mark.parametrize("shape", [((4, 32), (32, 24)), ((2, 3, 40), (40, 8)),
                                   ((48,), (48, 16))])
def test_photonic_matmul_matches_reference_and_w8a8(shape):
    xs, ws = shape
    x, w = _np(0, xs), _np(1, ws)
    got = t_ph.photonic_matmul(torch.from_numpy(x), torch.from_numpy(w))
    want = j_ph.photonic_matmul(jnp.asarray(x), jnp.asarray(w))
    assert tuple(got.shape) == tuple(want.shape)
    assert _rel(got, want) <= MATMUL_TOL
    ref = t_ph.w8a8_matmul_reference(torch.from_numpy(x), torch.from_numpy(w))
    assert _rel(got, ref) <= MATMUL_TOL
    assert _rel(ref, j_ph.w8a8_matmul_reference(jnp.asarray(x),
                                                jnp.asarray(w))) <= MATMUL_TOL


def test_offset_decomposition_matches_reference():
    """W x == 2 (W' x - W0 x) (paper eq. 6); each half equal to JAX's."""
    w, x = _np(0, (16, 12), "uniform"), _np(1, (5, 16))
    wp = t_ph.offset_decompose(torch.from_numpy(w))
    assert float(wp.min()) >= 0.0 and float(wp.max()) <= 1.0
    np.testing.assert_array_equal(
        wp.numpy(), np.asarray(j_ph.offset_decompose(jnp.asarray(w))))
    xt = torch.from_numpy(x)
    y = t_ph.offset_recompose_mvm(xt @ wp, xt.sum(-1, keepdim=True))
    assert _rel(y, x @ w) <= MATMUL_TOL
    wmax_t = t_ph.normalize_weights(torch.from_numpy(w))
    wmax_j = j_ph.normalize_weights(jnp.asarray(w))
    for a, b in zip(wmax_t, wmax_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("axis", [None, (0,), (0, 1)])
def test_quantize_and_dequantize_bit_identical(axis):
    x = _np(3, (6, 5, 7)) * 3.0
    qt, st = t_ph.quantize_symmetric(torch.from_numpy(x), 8, axis=axis)
    qj, sj = j_ph.quantize_symmetric(jnp.asarray(x), 8, axis=axis)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(t_ph.dequantize(qt, st).numpy(),
                                  np.asarray(j_ph.dequantize(qj, sj)))


@pytest.mark.parametrize("rows,cols,tile", [(256, 256, 8), (250, 250, 8),
                                            (8, 8, 8), (784, 176, 8),
                                            (176, 10, 64), (1, 1, 1024)])
def test_tiling_counts_equal(rows, cols, tile):
    assert t_ph.mrr_tiles(rows, cols, tile) == j_ph.mrr_tiles(rows, cols,
                                                              tile)
    assert t_ph.mrr_write_count((rows, cols), tile) == \
        j_ph.mrr_write_count((rows, cols), tile)
    assert t_ph.crossbar_utilization((rows, cols), tile) == \
        j_ph.crossbar_utilization((rows, cols), tile)
    assert t_ph.mrr_tiles(256, 256, 8) == 32 * 32


def test_write_noise_by_property():
    """The port's noise stream is torch's, so a noisy output is held by what
    it must satisfy: it moves off the clean W8A8 output, by more at a larger
    sigma, deterministically for one generator seed, not at all without a
    generator; clipped rings keep |y| within the clean bound."""
    x, w = torch.from_numpy(_np(0, (4, 32))), torch.from_numpy(_np(1, (32, 24)))
    clean = t_ph.photonic_matmul(x, w)

    def noisy(sigma, seed):
        return t_ph.photonic_matmul(
            x, w, t_ph.PhotonicConfig(write_noise_sigma=sigma),
            generator=torch.Generator().manual_seed(seed))

    a, b = noisy(2.0, 2), noisy(2.0, 2)
    assert not torch.allclose(a, clean)
    assert torch.equal(a, b)
    assert not torch.equal(a, noisy(2.0, 3))
    assert torch.equal(t_ph.photonic_matmul(
        x, w, t_ph.PhotonicConfig(write_noise_sigma=2.0)), clean)
    gaps = [_rel(noisy(s, 5), clean) for s in (0.5, 4.0, 32.0)]
    assert 0 < gaps[0] < gaps[1] < gaps[2]
    xf = t_ph.dequantize(*t_ph.quantize_symmetric(x, 8))
    wmax = w.abs().amax(0)
    huge = noisy(1e6, 7)
    assert bool((huge.abs() <= xf.abs().sum(-1, keepdim=True) * wmax
                 * (1 + 1e-5)).all())


# ------------------------------------------------------------------ OBU
@pytest.mark.parametrize("groups,shape", [(4, (3, 5, 24)), (2, (7, 16)),
                                          (8, (64,))])
def test_group_shuffle_equals_reference_and_permutation(groups, shape):
    x = _np(0, shape)
    got = t_obu.group_shuffle(torch.from_numpy(x), groups)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_obu.group_shuffle(
                                      jnp.asarray(x), groups)))
    perm = t_obu.group_shuffle_permutation(shape[-1], groups)
    np.testing.assert_array_equal(
        got.numpy(),
        t_obu.apply_channel_permutation(torch.from_numpy(x), perm).numpy())
    with pytest.raises(ValueError):
        t_obu.group_shuffle(torch.zeros(2, 10), 4)


def test_optical_transpose_equals_reference():
    w = _np(0, (3, 5, 7))
    np.testing.assert_array_equal(
        t_obu.optical_transpose(torch.from_numpy(w)).numpy(),
        np.asarray(j_obu.optical_transpose(jnp.asarray(w))))


# -------------------------------------------------------------- sharing
def test_tree_stack_equals_reference():
    trees = [{"a": _np(i, (3, 4)), "b": {"c": _np(10 + i, (2,))}}
             for i in range(3)]
    got = t_sharing.tree_stack([{"a": torch.from_numpy(t["a"]),
                                 "b": {"c": torch.from_numpy(t["b"]["c"])}}
                                for t in trees])
    want = j_sharing.tree_stack([jax.tree.map(jnp.asarray, t)
                                 for t in trees])
    np.testing.assert_array_equal(got["a"].numpy(), np.asarray(want["a"]))
    np.testing.assert_array_equal(got["b"]["c"].numpy(),
                                  np.asarray(want["b"]["c"]))


def test_stacked_init_stacks_independent_draws():
    def one(g):
        return {"w": torch.randn(4, 3, generator=g), "n": torch.ones(3)}

    got = t_sharing.stacked_init(one, torch.Generator().manual_seed(1), 3)
    assert tuple(got["w"].shape) == (3, 4, 3)
    assert tuple(got["n"].shape) == (3, 3)
    g = torch.Generator().manual_seed(1)
    for r in range(3):
        assert torch.equal(got["w"][r], one(g)["w"])
    assert not torch.equal(got["w"][0], got["w"][1])
    want = j_sharing.stacked_init(
        lambda k: {"w": jax.random.normal(k, (4, 3)), "n": jnp.ones(3)},
        jax.random.PRNGKey(0), 3)
    assert jax.tree.map(jnp.shape, want) == \
        {k: tuple(v.shape) for k, v in got.items()}


@pytest.mark.parametrize("depth,channels", [(1, 8), (6, 176), (8, 128)])
def test_identity_stack_equals_reference(depth, channels):
    got = t_sharing.identity_stack(depth, channels)
    want = j_sharing.identity_stack(depth, channels)
    assert got.num_physical == want.num_physical == depth
    assert got.reuse_times == want.reuse_times == 1
    np.testing.assert_array_equal(got.perm_table, want.perm_table)
    np.testing.assert_array_equal(got.transpose_flags, want.transpose_flags)
    assert got.shuffle_active == want.shuffle_active == (False,)


def test_param_count_equals_reference():
    tree = {"a": _np(0, (3, 4)), "b": {"c": _np(1, (5,)),
                                       "d": _np(2, (2, 2, 2))}}
    port = {"a": torch.from_numpy(tree["a"]),
            "b": {k: torch.from_numpy(v) for k, v in tree["b"].items()}}
    assert t_sharing.param_count(port) == \
        j_sharing.param_count(jax.tree.map(jnp.asarray, tree)) == 25
    # the sharing count, like the reference's, has no rule for a leaf
    # without a shape (paper_models.param_count skips one)
    with pytest.raises(AttributeError):
        j_sharing.param_count({"a": jnp.ones(2), "m": [1, 2]})
    with pytest.raises(AttributeError):
        t_sharing.param_count({"a": torch.ones(2), "m": [1, 2]})


# ------------------------------------------------------------------ W8A8
def _mixer_trees():
    cfg = j_pm.MixerConfig(blocks=4, reuse=JReuse(
        num_basic=2, reuse_times=2, transforms=("identity", "transpose")))
    jp, _ = j_pm.mixer_init(jax.random.PRNGKey(3), cfg)
    return jp, bridge.paper_params_from_flat(j_ckpt._flatten(jp),
                                             device="cpu")


def _transformer_trees():
    cfg = JModelConfig(name="t", family="dense", num_layers=4, d_model=64,
                       num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
                       compute_dtype="float32")
    jp, _ = j_tfm.init_model(jax.random.PRNGKey(0), cfg)
    return jp, bridge.params_from_flat(j_ckpt._flatten(jp), device="cpu")


def _flat_np(tree):
    """Path -> numpy of a port tree (None kept)."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            out["/".join(path)] = None if node is None else node.numpy()
    walk(tree, ())
    return out


@pytest.mark.parametrize("trees", [_mixer_trees, _transformer_trees],
                         ids=["mixer", "transformer"])
def test_w8a8_bit_identical(trees):
    jp, tp = trees()
    qj, sj = j_w8a8.quantize_params(jp)
    qt, st = t_w8a8.quantize_params(tp)
    want_q = j_ckpt._flatten(qj)
    got_q = _flat_np(qt)
    assert sorted(got_q) == sorted(want_q)
    for k in want_q:
        assert got_q[k].dtype == want_q[k].dtype, k
        np.testing.assert_array_equal(got_q[k], want_q[k], err_msg=k)
    flat_sj = jax.tree_util.tree_flatten_with_path(
        sj, is_leaf=lambda x: x is None)[0]
    want_s = {"/".join(j_ckpt._key_str(p) for p in path):
              None if s is None else np.asarray(s) for path, s in flat_sj}
    got_s = _flat_np(st)
    assert sorted(got_s) == sorted(want_s)
    n_quant = 0
    for k in want_s:
        if want_s[k] is None:
            assert got_s[k] is None, k
            continue
        n_quant += 1
        assert got_s[k].dtype == np.float32
        np.testing.assert_array_equal(got_s[k], want_s[k], err_msg=k)
    assert n_quant >= 4
    got_dq = _flat_np(t_w8a8.dequantize_params(qt, st))
    want_dq = j_ckpt._flatten(j_w8a8.dequantize_params(qj, sj))
    for k in want_dq:
        np.testing.assert_array_equal(got_dq[k], want_dq[k], err_msg=k)
    assert t_w8a8.model_bytes(qt) == j_w8a8.model_bytes(qj)
    et, ej = t_w8a8.quantization_error(tp), j_w8a8.quantization_error(jp)
    assert et["max_rel_err"] == ej["max_rel_err"]
    assert et["mean_rel_err"] == pytest.approx(ej["mean_rel_err"], rel=1e-12)
    assert et["max_rel_err"] < 0.02


def test_w8a8_on_a_vgg_tree_keeps_the_shared_map():
    """A list-bearing tree: conv kernels quantize per output channel over
    H, W and Cin; ``shared_map``'s ints pass through untouched."""
    jp = j_pm.vgg13_init(jax.random.PRNGKey(0),
                         j_pm.VGGConfig(share_same_shape=True))
    tp = bridge.paper_params_from_flat(j_ckpt._flatten(jp), device="cpu")
    qt, st = t_w8a8.quantize_params(tp)
    assert qt["shared_map"] == jp["shared_map"]
    assert st["shared_map"] == [None] * len(jp["shared_map"])
    for i, w in enumerate(jp["convs"]):
        qj, sj = j_ph.quantize_symmetric(w, 8, axis=(0, 1, 2))
        np.testing.assert_array_equal(qt["convs"][i].numpy(), np.asarray(qj))
        np.testing.assert_array_equal(st["convs"][i].numpy(), np.asarray(sj))
