"""The port's prepared photonic banks against the JAX reference: int8 tiles,
gains, checksums and bank tags bitwise equal on a float32 config, the
read-back verification, and the bf16 bank agreement as measured."""
import numpy as np
import pytest
import torch

import jax

from repro import api as j_api
from repro.configs.base import ModelConfig as JCfg
from repro.core import prepared as j_prep
from repro.core.prm import ReuseConfig as JRC
from repro.models import transformer as j_tfm
from repro.train.checkpoint import _flatten

from repro_torch import api as t_api
from repro_torch import bridge
from repro_torch.configs.base import ModelConfig as TCfg
from repro_torch.core import prepared as t_prep
from repro_torch.core.prm import ReuseConfig as TRC

torch.set_num_threads(2)
FIELDS = ("wq", "scale", "wq_t", "scale_t", "w0_colsum", "w0_rowsum_t")


def _cfgs(dtype="float32", seed=0):
    tr = ("identity", "shuffle", "transpose", "shuffle")
    kw = dict(name="t", family="dense", num_layers=8, d_model=64,
              num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
              compute_dtype=dtype)
    jc = JCfg(reuse=JRC(num_basic=2, reuse_times=4, transforms=tr,
                        shuffle_groups=8), **kw)
    tc = TCfg(reuse=TRC(num_basic=2, reuse_times=4, transforms=tr,
                        shuffle_groups=8), **kw)
    params, _ = j_tfm.init_model(jax.random.PRNGKey(seed), jc)
    return jc, tc, params


def _banks(dtype, seed=0):
    jc, tc, params = _cfgs(dtype, seed)
    jb = j_api._prepare_cell(params, cfg=jc, photonic=True)
    tb = t_prep.prepare_params(
        bridge.params_from_flat(_flatten(params), device="cpu"), dtype, True)
    return jb, tb


def _leaves(jb, tb):
    """(keys, jax leaf, torch leaf) for every leaf of the JAX bank."""
    flat = jax.tree_util.tree_flatten_with_path(
        jb, is_leaf=lambda x: isinstance(x, j_prep.PreparedTensor))[0]
    for path, leaf in flat:
        keys = tuple(k.key for k in path)
        node = tb
        for k in keys:
            node = node[k]
        yield keys, leaf, node


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    return t.numpy()


def test_fp32_banks_and_tags_bitwise_equal():
    jb, tb = _banks("float32")
    n_banks = 0
    for keys, jl, tl in _leaves(jb, tb):
        if isinstance(jl, j_prep.PreparedTensor):
            n_banks += 1
            assert isinstance(tl, t_prep.PreparedTensor), keys
            assert tl.tag == jl.tag == t_prep.path_tag(keys), keys
            for f in FIELDS:
                a, b = np.asarray(getattr(jl, f)), _np(getattr(tl, f))
                assert a.dtype == b.dtype and a.shape == b.shape, (keys, f)
                np.testing.assert_array_equal(b, a, err_msg=f"{keys} {f}")
        else:
            assert not isinstance(tl, t_prep.PreparedTensor), keys
            np.testing.assert_array_equal(_np(tl), np.asarray(jl))
    # 7 matmul weights in the one shared group + the lm head
    assert n_banks == 8
    assert t_prep.prepared_stats(tb) == j_prep.prepared_stats(jb)


def test_path_tag_is_crc32_of_jax_keystr():
    path = ("segments", "main", "l0", "mixer", "wq")
    jpath = tuple(jax.tree_util.DictKey(k) for k in path)
    assert t_prep.path_tag(path) == j_prep.path_tag(jpath)
    assert t_prep.path_tag(("lm_head", "w")) == j_prep.path_tag(
        (jax.tree_util.DictKey("lm_head"), jax.tree_util.DictKey("w")))


@pytest.mark.parametrize("field", ["wq", "wq_t"])
def test_verify_banks_catches_a_corrupted_tile(field):
    jc, tc, params = _cfgs()
    prog = t_api.Program.build(
        tc, bridge.params_from_flat(_flatten(params), device="cpu"),
        execution="photonic", device="cpu")
    assert prog.verify_banks() < 1e-5
    bank = prog.bank["segments"]["main"]["l0"]["mixer"]["wo"]
    w = getattr(bank, field)
    w[1, 3, 5] = (int(w[1, 3, 5]) + 7) % 127        # one corrupted ring
    assert prog.verify_banks() >= 1.0 / (2 * 127) * 0.99


def test_bf16_banks_agree_as_measured():
    """The cast-then-quantize divide rounds to bf16 in torch, while XLA may
    keep that intermediate in f32 inside its fusion.  Measured on this
    config over seeds 0-2: 0 of 180224 int8 entries differ (both
    orientations), so the bound is exact agreement of the int8 tiles; the
    gains are bf16 maxima up-cast to f32 and must agree bitwise too."""
    for seed in (0, 1):
        jb, tb = _banks("bfloat16", seed)
        total = mismatched = 0
        for keys, jl, tl in _leaves(jb, tb):
            if not isinstance(jl, j_prep.PreparedTensor):
                continue
            for f in ("wq", "wq_t"):
                a = np.asarray(getattr(jl, f)).astype(np.int32)
                b = getattr(tl, f).numpy().astype(np.int32)
                total += a.size
                mismatched += int((a != b).sum())
                assert np.abs(a - b).max() <= 1, (keys, f)
            for f in ("scale", "scale_t"):
                np.testing.assert_array_equal(_np(getattr(tl, f)),
                                              np.asarray(getattr(jl, f)))
        assert total == 180224
        assert mismatched == 0


def test_quantize_weight_matches_reference_on_edge_values():
    w = np.array([[0.0, 1.0, -1.0], [0.5, -0.25, 2.0], [1e-9, 0.0, -3.0],
                  [127.5, 0.0, 0.0]], np.float32)
    jq, js = j_prep.quantize_weight(jax.numpy.asarray(w))
    tq, ts = t_prep.quantize_weight(torch.as_tensor(w))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jq, js = j_prep.quantize_weight_t(jax.numpy.asarray(w))
    tq, ts = t_prep.quantize_weight_t(torch.as_tensor(w))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_bridge_rebuilds_nested_params():
    jc, tc, params = _cfgs()
    flat = _flatten(params)
    tp = bridge.params_from_flat(flat, device="cpu")
    for key, arr in flat.items():
        node = tp
        for k in key.split("/"):
            node = node[k]
        np.testing.assert_array_equal(node.numpy(), np.asarray(arr))
    assert tuple(tp["segments"]["main"]["l0"]["mixer"]["wq"].shape) == (
        2, 64, 64)
    bf = bridge.params_from_flat(
        {"a/b": np.asarray(jax.numpy.asarray([1.5, -2.0],
                                             jax.numpy.bfloat16))},
        device="cpu")
    assert bf["a"]["b"].dtype == torch.bfloat16
    assert bf["a"]["b"].tolist() == [1.5, -2.0]


def test_a8_quantizer_matches_reference():
    from repro.core import photonic as j_ph
    from repro_torch.core import photonic as t_ph
    x = np.random.default_rng(0).standard_normal((5, 33)).astype(np.float32)
    for dt, tdt in ((jax.numpy.float32, torch.float32),
                    (jax.numpy.bfloat16, torch.bfloat16)):
        jx = jax.numpy.asarray(x, dt)
        tx = torch.as_tensor(x).to(tdt)
        jq, js = j_ph.quantize_symmetric(jx, 8)
        tq, ts = t_ph.quantize_symmetric(tx, 8)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert float(ts) == float(js)
        assert float(t_ph.a8_scale(tx)) == float(j_ph.a8_scale(jx))
        jq, js = j_ph.quantize_symmetric(jx, 8, axis=1)
        tq, ts = t_ph.quantize_symmetric(tx, 8, axis=1)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
