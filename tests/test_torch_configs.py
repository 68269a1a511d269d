"""The PyTorch port's copied configs, PRM/OBU schedule tables, cost model
and admission policy are equal, field for field, to the JAX reference."""
import dataclasses

import numpy as np
import pytest

from repro.configs import archs as j_archs
from repro.core import costmodel as j_cost
from repro.core import prm as j_prm
from repro.core import sharing as j_sharing
from repro.serve.scheduler import ReuseAwareAdmission as JAdmission

from repro_torch.configs import archs as t_archs
from repro_torch.core import costmodel as t_cost
from repro_torch.core import prm as t_prm
from repro_torch.core import sharing as t_sharing
from repro_torch.models import transformer as t_tfm
from repro_torch.serve.scheduler import ReuseAwareAdmission as TAdmission

ARCH_NAMES = sorted(j_archs.ARCHS)


def _as_dict(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_arch_configs_equal(name):
    assert sorted(t_archs.ARCHS) == ARCH_NAMES
    assert t_archs.RB_PLANS == j_archs.RB_PLANS
    for reuse in (False, True):
        assert (_as_dict(t_archs.get_arch(name, reuse=reuse))
                == _as_dict(j_archs.get_arch(name, reuse=reuse)))
    assert (_as_dict(t_archs.smoke_variant(name))
            == _as_dict(j_archs.smoke_variant(name)))


def test_smoke_variant_keeps_full_padded_vocab():
    """``smoke_variant`` carries the full arch's padded_vocab through
    ``dataclasses.replace``: the minitron smoke variant has a 256000-row
    table over a 211-token vocabulary, in both packages."""
    t = t_archs.smoke_variant("minitron-4b")
    j = j_archs.smoke_variant("minitron-4b")
    assert (t.vocab_size, t.padded_vocab) == (211, 256000)
    assert (j.vocab_size, j.padded_vocab) == (t.vocab_size, t.padded_vocab)


def test_minitron_rb_plan_is_the_served_shape():
    cfg = t_archs.get_arch("minitron-4b", reuse=True)
    assert (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.padded_vocab) == (3072, 24, 8, 128, 9216, 256000)
    assert (cfg.reuse.num_basic, cfg.reuse.reuse_times) == (8, 4)
    assert cfg.reuse.transforms == ("identity", "shuffle", "transpose",
                                    "shuffle")


@pytest.mark.parametrize("R,T,transforms,block", [
    (2, 4, ("identity", "shuffle", "transpose", "shuffle"), 0),
    (3, 2, ("identity", "shuffle_transpose"), 0),
    (1, 4, ("identity", "shuffle"), 8),
    (4, 1, ("identity",), 0),
])
def test_reuse_plan_and_shared_stack_tables_equal(R, T, transforms, block):
    kw = dict(granularity="block", num_basic=R, reuse_times=T,
              transforms=transforms, shuffle_groups=4, shuffle_block=block,
              seed=3)
    jc, tc = j_prm.ReuseConfig(**kw), t_prm.ReuseConfig(**kw)
    jp = j_prm.ReusePlan.build(R * T, jc)
    tp = t_prm.ReusePlan.build(R * T, tc)
    assert ([dataclasses.astuple(a) for a in tp.assignments]
            == [dataclasses.astuple(a) for a in jp.assignments])
    assert tp.param_reduction() == jp.param_reduction()
    tp.validate_cover()
    channels = 32
    js = j_sharing.SharedStack.build(R * T, channels, jc)
    ts = t_sharing.SharedStack.build(R * T, channels, tc)
    np.testing.assert_array_equal(ts.perm_table, js.perm_table)
    np.testing.assert_array_equal(ts.inv_perm_table, js.inv_perm_table)
    np.testing.assert_array_equal(ts.transpose_flags, js.transpose_flags)
    assert ts.shuffle_active == js.shuffle_active
    assert ts.block_perm_table == js.block_perm_table
    assert ts.shuffle_block == js.shuffle_block
    assert (ts.num_physical, ts.reuse_times) == (js.num_physical,
                                                js.reuse_times)


def test_reuse_config_validation_matches():
    for bad in (dict(granularity="tile"), dict(num_basic=0),
                dict(transforms=("rotate",))):
        with pytest.raises(ValueError):
            j_prm.ReuseConfig(**bad)
        with pytest.raises(ValueError):
            t_prm.ReuseConfig(**bad)


@pytest.mark.parametrize("rows,cols,tile", [(256, 256, 64), (3072, 3072, 256),
                                            (64, 8, 256), (9216, 3072, 1024)])
def test_costmodel_prices_equal(rows, cols, tile):
    assert (dataclasses.asdict(t_cost.CALIBRATED)
            == dataclasses.asdict(j_cost.CALIBRATED))
    assert (t_cost.CALIBRATED.write_cost(rows, cols, tile)
            == j_cost.CALIBRATED.write_cost(rows, cols, tile))
    assert (t_cost.CALIBRATED.compute_cost(rows, cols, tile)
            == j_cost.CALIBRATED.compute_cost(rows, cols, tile))
    assert (t_cost.unit_prices(rows, cols, tile)
            == j_cost.unit_prices(rows, cols, tile))
    assert (dataclasses.asdict(t_cost.matrix_cost(rows, cols, tile,
                                                  programs=2, passes=8))
            == dataclasses.asdict(j_cost.matrix_cost(rows, cols, tile,
                                                     programs=2, passes=8)))
    for method in ("mzi", "crosslight", "holylight", "ours"):
        assert (t_cost.table2_row(method, M=rows, N=cols, K=4, C=8, B=tile)
                == j_cost.table2_row(method, M=rows, N=cols, K=4, C=8,
                                     B=tile))


def test_stack_cost_equal():
    shapes = [(256, 256)] * 6
    jp = j_prm.ReusePlan.build(8, j_prm.ReuseConfig(num_basic=2,
                                                    reuse_times=4))
    tp = t_prm.ReusePlan.build(8, t_prm.ReuseConfig(num_basic=2,
                                                    reuse_times=4))
    assert (dataclasses.asdict(t_cost.stack_cost(shapes, tp, 64))
            == dataclasses.asdict(j_cost.stack_cost(shapes, jp, 64)))
    assert (dataclasses.asdict(t_cost.baseline_stack_cost(shapes, 8, 64))
            == dataclasses.asdict(j_cost.baseline_stack_cost(shapes, 8, 64)))


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_admission_min_population_equal(name):
    """Admission order decides batch composition, and with it the
    per-tensor A8 numerics: the policy must price every arch the same."""
    for reuse in (False, True):
        jc = j_archs.get_arch(name, reuse=reuse)
        tc = t_archs.get_arch(name, reuse=reuse)
        assert (TAdmission.build(tc).min_population
                == JAdmission.build(jc).min_population)
    t_adm = TAdmission(min_population=3, max_admit_per_step=1)
    j_adm = JAdmission(min_population=3, max_admit_per_step=1)
    for q, f, a in [(0, 4, 0), (5, 4, 0), (5, 4, 3), (2, 0, 1), (5, 2, 2)]:
        assert (t_adm.admit_count(queued=q, free=f, active=a)
                == j_adm.admit_count(queued=q, free=f, active=a))


def test_segments_match_reference_for_every_arch():
    from repro.models import transformer as j_tfm
    for name in ARCH_NAMES:
        for reuse in (False, True):
            jc = j_archs.get_arch(name, reuse=reuse)
            tc = t_archs.get_arch(name, reuse=reuse)
            assert ([dataclasses.asdict(s) for s in t_tfm.build_segments(tc)]
                    == [dataclasses.asdict(s)
                        for s in j_tfm.build_segments(jc)])


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_check_ported_admits_every_arch(name):
    """Every architecture of ``configs/archs.py``, as it is and with its R&B
    plan, at full width and as its smoke variant."""
    for cfg in (t_archs.get_arch(name), t_archs.get_arch(name, reuse=True),
                t_archs.smoke_variant(name)):
        t_tfm.check_ported(cfg)


def test_unported_families_raise():
    """Since the vlm and audio families are ported, what ``check_ported``
    still refuses is what the reference cannot build either: a family
    without the config it needs (an audio model without ``audio``, a vlm
    without ``vision``, an SSM family without ``ssm``), or an unknown
    norm or activation."""
    for name, change in (("whisper-medium", dict(audio=None)),
                         ("llama-3.2-vision-11b", dict(vision=None)),
                         ("mamba2-780m", dict(ssm=None)),
                         ("minitron-4b", dict(norm="batch")),
                         ("minitron-4b", dict(mlp_act="relu"))):
        cfg = dataclasses.replace(t_archs.smoke_variant(name), **change)
        with pytest.raises(NotImplementedError):
            t_tfm.init_model(cfg, device="cpu")
    t_tfm.check_ported(t_archs.smoke_variant("minitron-4b"))
