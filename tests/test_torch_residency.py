"""The port's bank residency, meter and metrics copies against the
reference on the same traces — eviction logs, hit sequences, endurance and
residency reports, ``PhotonicMeter.report()`` and the mapping plans must be
EQUAL (pure Python on both sides, so exact) — plus bank identities of a
built Program, single billing of calibration writes, and served tokens
with residency on and off."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax

from repro import api as j_api
from repro.configs.base import ModelConfig as JCfg
from repro.core.prm import ReuseConfig as JRC
from repro.models import transformer as j_tfm
from repro.obs import metrics as j_metrics
from repro.obs.meter import PhotonicMeter as JMeter
from repro.obs.meter import StackProfile as JProfile
from repro import resident as j_res
from repro.resident import cosched as j_cosched
from repro.serve.batcher import Request as JRequest
from repro.serve.scheduler import ContinuousScheduler as JScheduler
from repro.serve.scheduler import ReuseAwareAdmission as JAdmission
from repro.train.checkpoint import _flatten

from repro_torch import api as t_api
from repro_torch import bridge
from repro_torch.configs.base import ModelConfig as TCfg
from repro_torch.core import prepared as t_prep
from repro_torch.core.prm import ReuseConfig as TRC
from repro_torch.obs import metrics as t_metrics
from repro_torch.obs.meter import PhotonicMeter as TMeter
from repro_torch.obs.meter import StackProfile as TProfile
from repro_torch import resident as t_res
from repro_torch.resident import cosched as t_cosched
from repro_torch.serve.batcher import Request as TRequest
from repro_torch.serve.scheduler import ContinuousScheduler as TScheduler
from repro_torch.serve.scheduler import ReuseAwareAdmission as TAdmission

torch.set_num_threads(2)


def _specs(mod, n=8, rows=256, cols=256, mats=2):
    return [mod.BankSpec(key=f"b{i}", rows=rows + 128 * (i % 3), cols=cols,
                         mats=mats + i % 2) for i in range(n)]


def _trace(n_specs, n=300, seed=0):
    """The reference tests' zipf-skewed trace (``test_residency.py``):
    spec indices, low indices hot."""
    rng = np.random.default_rng(seed)
    w = np.array([1.0 / (i + 1) ** 1.3 for i in range(n_specs)])
    w /= w.sum()
    return [int(rng.choice(n_specs, p=w)) for _ in range(n)]


def _replay(mod, budget_mult, drift_weight, calibrate_every, seed):
    specs = _specs(mod)
    m = mod.BankResidencyManager(budget_mult * specs[0].tiles,
                                 drift_weight=drift_weight)
    outs = []
    for step, i in enumerate(_trace(len(specs), seed=seed)):
        a = m.access(specs[i])
        outs.append((a.hit, a.resident, a.writes, a.evicted))
        if calibrate_every and step % calibrate_every == 0:
            m.record_calibration(specs[i])
    scores = {k: m.retention_score(k) for k in sorted(m.known)}
    clock = mod.DriftClock(m, writes_per_access=37.0)
    return (m.eviction_log, outs, m.report(), m.endurance_report(), scores,
            clock.ages(sorted(m.known)))


@pytest.mark.parametrize("budget_mult,drift_weight,calibrate_every,seed", [
    (3, 0.0, 0, 0), (0, 0.0, 0, 1), (5, 0.0, 7, 2), (3, 5.0, 3, 3),
    (100, 0.0, 0, 4)])
def test_manager_replays_reference_trace_exactly(budget_mult, drift_weight,
                                                 calibrate_every, seed):
    want = _replay(j_res, budget_mult, drift_weight, calibrate_every, seed)
    got = _replay(t_res, budget_mult, drift_weight, calibrate_every, seed)
    assert got == want
    if budget_mult == 3 and not drift_weight:
        assert got[2]["evictions"] > 0             # pressure did evict


def _meter_trace(mod, metrics_mod, residency):
    prof = mod["Profile"](num_physical=4, depth=8, mats_per_block=2,
                          rows=256, cols=256, tile=256)
    reg = metrics_mod.MetricsRegistry()
    meter = mod["Meter"](prof, refresh_steps=3, registry=reg)
    res = None
    if residency:
        specs = mod["res"].specs_from_profile(prof, prefix="p")
        manager = mod["res"].BankResidencyManager(
            budget_tiles=2 * specs[0].tiles, registry=reg)
        res = mod["res"].ProgramResidency(manager, specs)
        res.bind_meter(meter)
    meter.on_prefill(16)
    if res:
        res.on_prefill(16)
    for i in range(11):
        meter.on_decode_step(4)
        if res:
            res.on_decode_step(4)
        if i % 4 == 3:
            meter.record_calibration_write(2)
    rep = meter.report()
    if res:
        rep["manager"] = res.manager.report()
    return rep, reg.snapshot(), reg.to_prometheus()


@pytest.mark.parametrize("residency", [False, True])
def test_meter_report_and_registry_equal_reference(residency):
    j = dict(Profile=JProfile, Meter=JMeter, res=j_res)
    t = dict(Profile=TProfile, Meter=TMeter, res=t_res)
    assert _meter_trace(t, t_metrics, residency) == \
        _meter_trace(j, j_metrics, residency)


def test_stack_profile_from_cfg_equals_reference():
    kw = dict(name="t", family="dense", num_layers=8, d_model=64,
              num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128)
    rc = dict(num_basic=2, reuse_times=4)
    assert dataclasses.asdict(TProfile.from_cfg(TCfg(reuse=TRC(**rc), **kw))) \
        == dataclasses.asdict(JProfile.from_cfg(JCfg(reuse=JRC(**rc), **kw)))


def test_histogram_and_counter_group_equal_reference():
    vals = np.random.default_rng(5).lognormal(0, 2, 500)
    hs = []
    for mod in (t_metrics, j_metrics):
        h = mod.Histogram()
        for v in vals:
            h.record(float(v))
        hs.append((h.summary(), h.merge(h).summary()))
    assert hs[0] == hs[1]
    g = t_metrics.CounterGroup("trace")
    g["prefill"] += 2
    assert dict(g) == {"prefill": 2} and g["missing"] == 0


def test_mapping_and_cosched_equal_reference():
    for budget_div in (1, 2, 5):
        plans = []
        for mod in (t_res, j_res):
            specs = [mod.BankSpec(key=f"b{i}", rows=128 * (i + 1), cols=256,
                                  mats=1 + i % 3) for i in range(7)]
            plans.append(dataclasses.asdict(mod.plan_hybrid_mapping(
                specs, sum(s.tiles for s in specs) // budget_div)))
        assert plans[0] == plans[1]
    items = [(f"k{i % 3}", i) for i in range(20)]
    for window in (1, 4, 8):
        assert t_cosched.group_by_affinity(items, lambda t: t[0], window) \
            == j_cosched.group_by_affinity(items, lambda t: t[0], window)
    traces = {"a": [1, 2], "b": [3], "c": [4, 5, 6]}
    assert t_cosched.interleave_fifo(traces) == \
        j_cosched.interleave_fifo(traces)


def test_residency_aware_admission_equals_reference():
    outs = []
    for mod, cos, adm_cls in ((t_res, t_cosched, TAdmission),
                              (j_res, j_cosched, JAdmission)):
        base = adm_cls(min_population=64, max_admit_per_step=1)
        specs = _specs(mod, n=3)
        manager = mod.BankResidencyManager(budget_tiles=10 ** 6)
        res = mod.ProgramResidency(manager, specs)
        adm = cos.ResidencyAwareAdmission.from_base(base, res)
        row = [adm.admit_count(queued=5, free=3, active=100)]
        for s in specs:
            manager.access(s)
        row += [res.all_resident(),
                adm.admit_count(queued=5, free=3, active=100),
                adm.admit_count(queued=2, free=3, active=100)]
        outs.append(row)
    assert outs[0] == outs[1] == [1, True, 3, 2]


# -------------------------------------------------------------------------
# bank identities of a built Program
# -------------------------------------------------------------------------
def _kw(**over):
    kw = dict(name="res-t", family="dense", num_layers=2, d_model=32,
              num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=128,
              compute_dtype="float32")
    kw.update(over)
    return kw


@functools.lru_cache(maxsize=None)
def _model(kind):
    over, jr, tr = {}, None, None
    if kind == "rb":
        over = dict(num_layers=8)
        t = ("identity", "shuffle", "transpose", "shuffle")
        jr = JRC(num_basic=2, reuse_times=4, transforms=t, shuffle_groups=8)
        tr = TRC(num_basic=2, reuse_times=4, transforms=t, shuffle_groups=8)
    jc, tc = JCfg(reuse=jr, **_kw(**over)), TCfg(reuse=tr, **_kw(**over))
    params, _ = j_tfm.init_model(jax.random.PRNGKey(0), jc)
    return jc, tc, params, bridge.params_from_flat(_flatten(params),
                                                   device="cpu")


@pytest.mark.parametrize("kind", ["dense", "rb"])
def test_bank_descriptors_and_specs_equal_reference(kind):
    from repro.core.prepared import bank_descriptors as j_desc
    jc, tc, params, tp = _model(kind)
    jprog = j_api.Program.build(jc, params, execution="photonic")
    tprog = t_api.Program.build(tc, tp, execution="photonic", device="cpu")
    want = j_desc(jprog.bank, prefix="p:")
    got = t_prep.bank_descriptors(tprog.bank, prefix="p:")
    assert got == want
    assert got[0]["path"].startswith("p:['")
    jspecs = j_res.specs_from_program(jprog)
    tspecs = t_res.specs_from_program(tprog)
    assert [dataclasses.asdict(s) for s in tspecs] == \
        [dataclasses.asdict(s) for s in jspecs]
    assert t_res.specs_from_program(
        t_api.Program.build(tc, tp, execution="xla", device="cpu")) == []


def test_calibration_writes_billed_exactly_once():
    prof = TProfile(num_physical=4, depth=8, mats_per_block=2, rows=256,
                    cols=256, tile=256)
    specs = t_res.specs_from_profile(prof, prefix="p")
    manager = t_res.BankResidencyManager(budget_tiles=10 ** 6)
    meter = TMeter(prof, external_writes=True)
    installs = 0
    for s in specs:
        acc = manager.access(s)
        meter.record_external_bank_write(acc.writes)
        installs += acc.writes
    repaired = specs[0]
    meter.record_calibration_write(repaired.mats)
    manager.record_calibration(repaired)
    assert meter.calibration_writes == repaired.mats
    assert meter.external_bank_writes == installs + repaired.mats
    assert meter.bank_writes == installs + repaired.mats
    assert manager.total_writes_mats == installs + repaired.mats
    assert manager.is_resident(repaired.key)
    assert manager.hits == 0 and manager.misses == len(specs)
    rep = meter.report()
    assert rep["calibration_fraction"] == pytest.approx(
        repaired.mats / (installs + repaired.mats))


# -------------------------------------------------------------------------
# serving: residency is accounting only
# -------------------------------------------------------------------------
def _reqs(mod, n=5, seed=7):
    rng = np.random.default_rng(seed)
    return [mod(rid=rid, prompt=rng.integers(1, 128, int(rng.integers(
        3, 12))).astype(np.int32), max_new=int(rng.integers(2, 6)))
        for rid in range(n)]


def test_served_tokens_identical_with_residency_and_ledgers_match_jax():
    jc, tc, params, tp = _model("dense")
    tprog = t_api.Program.build(tc, tp, execution="photonic", device="cpu")
    jprog = j_api.Program.build(jc, params, execution="photonic")
    out = {}
    for name, residency in (("plain", None), ("res", True)):
        manager = t_res.BankResidencyManager(budget_tiles=10 ** 9)
        res = (t_res.ProgramResidency(manager, t_res.specs_from_program(
            tprog)) if residency else None)
        sched = TScheduler(tprog, capacity=3, max_len=24, residency=res)
        for r in _reqs(TRequest):
            sched.submit(r)
        out[name] = {c.rid: c.tokens.tolist() for c in sched.drain()}
        if residency:
            t_report = manager.report()
    assert out["plain"] == out["res"]
    assert t_report["hits"] > 0 and t_report["misses"] > 0
    # the JAX scheduler with the same residency binding: same ledger
    manager = j_res.BankResidencyManager(budget_tiles=10 ** 9)
    res = j_res.ProgramResidency(manager, j_res.specs_from_program(jprog))
    sched = JScheduler(jprog, capacity=3, max_len=24, residency=res)
    for r in _reqs(JRequest):
        sched.submit(r)
    j_tokens = {c.rid: c.tokens.tolist() for c in sched.drain()}
    assert j_tokens == out["res"]
    assert manager.report() == t_report
