"""The paper's models in the port against the JAX reference on the same
weights (carried through ``bridge.paper_params_from_flat``) and the same
numpy images: MLP, MLP-Mixer (baseline, block-wise 1x8 and 2x4 with
shuffle and transpose), VGG-13 and ResNet-18 with and without sharing;
their parameter counts and cost-model weight shapes; the port's own init
trees against the reference's; and ``_conv``'s ``"SAME"`` padding at
stride 2 on even and odd sizes, which a symmetric pad gets wrong.

Tolerances: MLP and Mixer logits within 1e-5 rel-L2 (float32 matmuls in
another summation order); VGG-13, ResNet-18 and ``_conv`` within 1e-4
(float32 convolutions: oneDNN against XLA's, over up to 4608-term sums
through 10-17 layers); counts, shapes and ``_patchify`` exact.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from repro.core.prm import ReuseConfig as JReuse
from repro.models import paper_models as j_pm
from repro.train import checkpoint as j_ckpt

from repro_torch import bridge
from repro_torch.core.prm import ReuseConfig as TReuse
from repro_torch.models import paper_models as t_pm

torch.set_num_threads(2)
DENSE_TOL = 1e-5
CONV_TOL = 1e-4
MIXER_T = ("identity", "shuffle", "transpose", "shuffle")


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _images(seed, batch, size=32):
    return np.random.default_rng(seed).normal(
        size=(batch, size, size, 3)).astype(np.float32)


def _carry(jp):
    return bridge.paper_params_from_flat(j_ckpt._flatten(jp), device="cpu")


def _reuse(pair):
    """(reference, port) ReuseConfigs of one setting, or (None, None)."""
    if pair is None:
        return None, None
    R, T, tf = pair
    return (JReuse(num_basic=R, reuse_times=T, transforms=tf),
            TReuse(num_basic=R, reuse_times=T, transforms=tf))


MLP_CASES = {"baseline": None,
             "layer-wise 1x6": (1, 6, ("identity", "shuffle", "transpose"))}
MIXER_CASES = {"baseline": None, "block-wise 1x8": (1, 8, MIXER_T),
               "block-wise 2x4": (2, 4, MIXER_T),
               "2x4 shuffle_transpose": (2, 4, ("identity", "shuffle",
                                                "transpose",
                                                "shuffle_transpose"))}


@pytest.mark.parametrize("case", sorted(MLP_CASES))
def test_mlp_forward_matches_reference(case):
    jr, tr = _reuse(MLP_CASES[case])
    jc, tc = j_pm.MLPConfig(reuse=jr), t_pm.MLPConfig(reuse=tr)
    jp, jsh = j_pm.mlp_init(jax.random.PRNGKey(1), jc)
    tp, tsh = _carry(jp), t_pm.SharedStack.build(tc.depth, tc.width, tr)
    x = _images(0, 4).reshape(4, -1)[:, :784]
    want = j_pm.mlp_forward(jp, jc, jsh, jnp.asarray(x))
    got = t_pm.mlp_forward(tp, tc, tsh, torch.from_numpy(x))
    assert _rel(got, want) <= DENSE_TOL
    assert t_pm.param_count(tp) == j_pm.param_count(jp)
    assert t_pm.mlp_weight_shapes(tc) == j_pm.mlp_weight_shapes(jc)


@pytest.mark.parametrize("case", sorted(MIXER_CASES))
def test_mixer_forward_matches_reference(case):
    jr, tr = _reuse(MIXER_CASES[case])
    jc, tc = j_pm.MixerConfig(reuse=jr), t_pm.MixerConfig(reuse=tr)
    jp, jsh = j_pm.mixer_init(jax.random.PRNGKey(2), jc)
    tp = _carry(jp)
    _, tsh = t_pm.mixer_init(torch.Generator().manual_seed(0), tc)
    x = _images(1, 3)
    want = j_pm.mixer_forward(jp, jc, jsh, jnp.asarray(x))
    got = t_pm.mixer_forward(tp, tc, tsh, torch.from_numpy(x))
    assert _rel(got, want) <= DENSE_TOL
    assert t_pm.param_count(tp) == j_pm.param_count(jp)
    assert t_pm.mixer_weight_shapes(tc) == j_pm.mixer_weight_shapes(jc)
    np.testing.assert_array_equal(tsh.perm_table, jsh.perm_table)
    np.testing.assert_array_equal(tsh.transpose_flags, jsh.transpose_flags)


@pytest.mark.parametrize("shared", [False, True])
def test_vgg13_forward_matches_reference(shared):
    jc = j_pm.VGGConfig(share_same_shape=shared)
    tc = t_pm.VGGConfig(share_same_shape=shared)
    jp = j_pm.vgg13_init(jax.random.PRNGKey(3), jc)
    tp = _carry(jp)
    assert tp["shared_map"] == jp["shared_map"]
    assert all(type(i) is int for i in tp["shared_map"])
    assert len(tp["convs"]) == len(jp["convs"])
    x = _images(2, 2)
    want = j_pm.vgg13_forward(jp, jc, jnp.asarray(x))
    got = t_pm.vgg13_forward(tp, tc, torch.from_numpy(x))
    assert _rel(got, want) <= CONV_TOL
    assert t_pm.param_count(tp) == j_pm.param_count(jp)
    assert t_pm.vgg13_weight_shapes(tc, shared) == \
        j_pm.vgg13_weight_shapes(jc, shared)


@pytest.mark.parametrize("shared", [False, True])
def test_resnet18_forward_matches_reference(shared):
    jc = j_pm.ResNetConfig(share_within_stage=shared)
    tc = t_pm.ResNetConfig(share_within_stage=shared)
    jp = j_pm.resnet18_init(jax.random.PRNGKey(4), jc)
    tp = _carry(jp)
    assert [len(s) for s in tp["stages"]] == [len(s) for s in jp["stages"]]
    x = _images(3, 2)
    want = j_pm.resnet18_forward(jp, jc, jnp.asarray(x))
    got = t_pm.resnet18_forward(tp, tc, torch.from_numpy(x))
    assert _rel(got, want) <= CONV_TOL
    assert t_pm.param_count(tp) == j_pm.param_count(jp)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape) if hasattr(tree, "shape") else tree


@pytest.mark.parametrize("model", ["mlp", "mixer", "vgg", "vgg_shared",
                                   "resnet", "resnet_shared"])
def test_port_init_has_the_reference_tree(model):
    """The port's own init draws the reference's tree: same keys, lists,
    shapes and shared_map (the draws themselves are torch's)."""
    g = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    jr, tr = _reuse((2, 4, MIXER_T))
    if model == "mlp":
        tp = t_pm.mlp_init(g, t_pm.MLPConfig())[0]
        jp = j_pm.mlp_init(key, j_pm.MLPConfig())[0]
    elif model == "mixer":
        tp = t_pm.mixer_init(g, t_pm.MixerConfig(reuse=tr))[0]
        jp = j_pm.mixer_init(key, j_pm.MixerConfig(reuse=jr))[0]
    elif model.startswith("vgg"):
        s = model.endswith("shared")
        tp = t_pm.vgg13_init(g, t_pm.VGGConfig(share_same_shape=s))
        jp = j_pm.vgg13_init(key, j_pm.VGGConfig(share_same_shape=s))
    else:
        s = model.endswith("shared")
        tp = t_pm.resnet18_init(g, t_pm.ResNetConfig(share_within_stage=s))
        jp = j_pm.resnet18_init(key, j_pm.ResNetConfig(share_within_stage=s))
    assert _shapes(tp) == _shapes(jp)
    assert t_pm.param_count(tp) == j_pm.param_count(jp)


@pytest.mark.parametrize("size,k,stride", [(32, 3, 2), (33, 3, 2),
                                           (16, 3, 2), (7, 3, 2),
                                           (32, 1, 2), (31, 1, 2),
                                           (32, 3, 1), (5, 3, 1)])
def test_conv_same_padding_matches_reference(size, k, stride):
    r = np.random.default_rng(size * 10 + k)
    x = r.normal(size=(2, size, size, 5)).astype(np.float32)
    w = r.normal(size=(k, k, 5, 6)).astype(np.float32)
    want = j_pm._conv(jnp.asarray(x), jnp.asarray(w), stride=stride)
    got = t_pm._conv(torch.from_numpy(x), torch.from_numpy(w), stride=stride)
    assert tuple(got.shape) == tuple(want.shape)
    assert _rel(got, want) <= CONV_TOL
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    assert t_pm.same_pads(size, k, stride) == (total // 2,
                                               total - total // 2)


def test_symmetric_pad_at_stride_2_is_wrong():
    """The case the helper exists for: on an even size a 3x3 stride-2 SAME
    conv pads (0, 1); torch's symmetric padding=1 lands far off."""
    x = _images(5, 2)
    w = np.random.default_rng(6).normal(size=(3, 3, 3, 4)).astype(np.float32)
    want = j_pm._conv(jnp.asarray(x), jnp.asarray(w), stride=2)
    assert t_pm.same_pads(32, 3, 2) == (0, 1)
    sym = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(w).permute(3, 2, 0, 1), stride=2,
                   padding=1).permute(0, 2, 3, 1)
    assert _rel(sym, want) > 0.5
    got = t_pm._conv(torch.from_numpy(x), torch.from_numpy(w), stride=2)
    assert _rel(got, want) <= CONV_TOL


def test_patchify_and_max_pool_equal_reference():
    x = _images(7, 2)
    np.testing.assert_array_equal(
        t_pm._patchify(torch.from_numpy(x), 4).numpy(),
        np.asarray(j_pm._patchify(jnp.asarray(x), 4)))
    want = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max,
                                 (1, 2, 2, 1), (1, 2, 2, 1), "VALID")
    np.testing.assert_array_equal(t_pm._max_pool(torch.from_numpy(x)).numpy(),
                                  np.asarray(want))


def test_bridge_rebuilds_lists_and_static_ints():
    flat = {"convs/0": np.ones((1, 1, 3, 2), np.float32),
            "convs/1": np.zeros((1, 1, 2, 2), np.float32),
            "shared_map/0": np.asarray(0), "shared_map/1": np.asarray(1),
            "stages/0/0/c1": np.ones(2, np.float32),
            "stages/1/0/c1": np.ones(3, np.float32),
            "stages/1/1/c2": np.ones(4, np.float32),
            "head": np.ones((2, 2), np.float32)}
    p = bridge.paper_params_from_flat(flat, device="cpu")
    assert isinstance(p["convs"], list) and len(p["convs"]) == 2
    assert p["shared_map"] == [0, 1]
    assert all(type(i) is int for i in p["shared_map"])
    assert [len(s) for s in p["stages"]] == [1, 2]
    assert tuple(p["stages"][1][1]["c2"].shape) == (4,)
    assert isinstance(p["head"], torch.Tensor)
    with pytest.raises(ValueError):
        bridge.paper_params_from_flat({"convs/0": np.ones(1),
                                       "convs/2": np.ones(1)}, device="cpu")
