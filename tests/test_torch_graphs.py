"""The port's compiled decode step (``repro_torch.graphs.DecodeCell``) on
the CPU, where the cell runs its static-buffer code eagerly, against the
eager ``decode_sample`` and the JAX reference's decode cells on the same
weights, for the dense, moe (GQA and MLA), ssm and hybrid smoke configs.

A CUDA graph cannot be captured here; the capture-dependent logic (launch
counts taken back and added per replay, one capture per scheduler) runs
through a CPU stand-in for ``torch.cuda.graph`` that, like a capture,
leaves the caches as they were and, like a replay, reruns the recorded
step into the static output without running a kernel wrapper's count.

Tolerances: greedy tokens identical; logits against the reference's
``decode_cell`` rel-L2 <= 1e-5 on xla (float32 sums in another order) and
<= 1e-3 on photonic (a one-ulp difference can move an A8 rounding
boundary); the cell against the eager port bit for bit (the same ops).
"""
import functools

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from repro import api as j_api
from repro.configs import smoke_variant as j_smoke
from repro.configs.archs import rb as j_rb
from repro.models import transformer as j_tfm
from repro.train.checkpoint import _flatten

from repro_torch import api as t_api
from repro_torch import bridge, graphs
from repro_torch.configs import smoke_variant as t_smoke
from repro_torch.configs.archs import rb as t_rb
from repro_torch.core import backend as t_backend
from repro_torch.core import obu
from repro_torch.kernels import counts
from repro_torch.kernels import photonic_mvm as t_pm
from repro_torch.serve.batcher import Request
from repro_torch.serve.scheduler import ContinuousScheduler

torch.set_num_threads(2)
TOL = {"xla": 1e-5, "photonic": 1e-3}
# dense, moe, ssm (R&B 2 x 2: shuffle and transpose reuses), hybrid and
# MLA (its smoke model's 2-layer main segment as R&B 1 x 2)
FAMILIES = ["minitron-4b", "granite-moe-1b-a400m", "mamba2-780m",
            "jamba-v0.1-52b", "deepseek-v2-lite-16b"]
V = 211


@functools.lru_cache(maxsize=None)
def _model(name):
    jc, tc = j_smoke(name), t_smoke(name)
    if name == "deepseek-v2-lite-16b":
        jc, tc = j_rb(jc, 1, 2), t_rb(tc, 1, 2)
    elif name != "jamba-v0.1-52b":
        jc, tc = j_rb(jc, 2, 2), t_rb(tc, 2, 2)
    params, _ = j_tfm.init_model(jax.random.PRNGKey(0), jc)
    return jc, tc, params, bridge.params_from_flat(_flatten(params),
                                                   device="cpu")


@functools.lru_cache(maxsize=None)
def _programs(name, execution):
    jc, tc, params, tp = _model(name)
    return (j_api.Program.build(jc, params, execution=execution),
            t_api.Program.build(tc, tp, execution=execution, device="cpu"))


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _copy_into(dst, src):
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
        return
    dst.copy_(src)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def _prompts(seed, B=2, S=6):
    return np.random.default_rng(seed).integers(0, V, (B, S)).astype(
        np.int32)


class _CpuGraph:
    """CPU stand-in for a captured CUDA graph (see the module docstring)."""

    def __init__(self, fn, args, out):
        self.fn, self.args, self.out = fn, args, out

    def replay(self):
        before = counts.snapshot()
        self.out.copy_(self.fn(*self.args))
        counts.restore(before)


def _cpu_capture(fn, *args):
    cell = fn.__self__
    saved = _clone(cell.caches)
    out = fn(*args).clone()
    _copy_into(cell.caches, saved)
    return _CpuGraph(fn, args, out), out


@pytest.fixture
def cpu_capture(monkeypatch):
    """Make CPU cells take the capture path through ``_CpuGraph``."""
    monkeypatch.setattr(graphs, "_cuda_graph", _cpu_capture)
    monkeypatch.setattr(graphs, "eager_reason", lambda program: None)


def _eager_tokens(tp, prompt, steps):
    """Greedy tokens of eager steps at a scalar position (no cell)."""
    logits, caches = tp.prefill({"tokens": prompt}, prompt.shape[1] + steps)
    cur = t_api.sample(logits, tp.cfg.vocab_size).long()[:, None]
    out = [cur]
    for i in range(steps - 1):
        nxt, caches = tp.decode_sample(cur, caches, prompt.shape[1] + i)
        cur = nxt.long()[:, None]
        out.append(cur)
    return torch.cat(out, dim=1)


# -------------------------------------------------------------------------
@pytest.mark.parametrize("execution", ["xla", "photonic"])
@pytest.mark.parametrize("name", FAMILIES)
def test_cell_greedy_tokens_equal_eager_decode_sample(name, execution):
    """The cell (static buffers, a (B,) position vector) against eager
    ``decode_sample`` at a scalar position: the same greedy tokens, the
    same logits and caches bit for bit; ``generate`` runs the cell."""
    _, tp = _programs(name, execution)
    prompt = _prompts(1)
    B, S = prompt.shape
    logits, caches = tp.prefill({"tokens": prompt}, S + 5)
    eager = _clone(caches)
    cell = tp.decode_cell(caches)
    cur = t_api.sample(logits, V).long()[:, None]
    cur_e = cur.clone()
    for i in range(4):
        lg, _ = tp.decode(cur, caches, np.full(B, S + i))
        lg_e, _ = tp.decode(cur_e, eager, S + i)
        assert torch.equal(lg, lg_e)
        cur = t_api.sample(lg, V).long()[:, None]
        cur_e = t_api.sample(lg_e, V).long()[:, None]
    for a, b in zip(jax.tree.leaves(caches), jax.tree.leaves(eager)):
        assert torch.equal(a, b)
    assert cell.graph is None and cell.reason is not None      # CPU: eager
    got = tp.generate(prompt, 5)[:, S:]
    torch.testing.assert_close(got, _eager_tokens(tp, prompt, 5),
                               rtol=0, atol=0)


@pytest.mark.parametrize("execution", ["xla", "photonic"])
@pytest.mark.parametrize("name", FAMILIES)
def test_cell_logits_match_reference_decode_cells(name, execution):
    """One step of the cell from the reference's own prefill caches,
    against the reference's ``decode_cell`` logits and
    ``decode_sample_cell`` tokens at the same per-slot positions."""
    jp, tp = _programs(name, execution)
    prompt = _prompts(2, B=3)
    toks = np.array([[3], [17], [101]], np.int32)
    pos = np.array([6, 4, 5], np.int32)
    _, jcaches = jp.prefill({"tokens": jnp.asarray(prompt)}, 10)
    tcaches = _to_torch(jcaches)
    jl, _ = jp.decode(jnp.asarray(toks), jcaches, jnp.asarray(pos))
    jt, _ = jp.decode_sample(jnp.asarray(toks), jcaches, jnp.asarray(pos))
    cell = graphs.DecodeCell(tp, tcaches)
    logits = cell.step(toks, pos)
    assert tuple(logits.shape) == (3, tp.cfg.padded_vocab)
    assert _rel(logits.numpy(), jl) <= TOL[execution]
    np.testing.assert_array_equal(t_api.sample(logits, V).numpy(),
                                  np.asarray(jt))


class _ScalarReads(TorchDispatchMode):
    """Counts ``aten._local_scalar_dense``: ``.item()``, ``int(t)`` and
    ``bool(t)`` on a tensor, each a device-to-host sync on the card."""

    def __init__(self):
        super().__init__()
        self.n_ops = self.n_reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n_ops += 1
        self.n_reads += func is torch.ops.aten._local_scalar_dense.default
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("execution", ["xla", "photonic"])
@pytest.mark.parametrize("name", FAMILIES)
def test_decode_step_reads_no_scalar_back(name, execution):
    """A decode step with a tensor ``pos``, eager and through the cell,
    dispatches no ``_local_scalar_dense`` (a capture would fail on it)."""
    _, tp = _programs(name, execution)
    caches = tp.empty_caches(3, 12)
    toks = torch.tensor([[1], [2], [3]])
    pos = torch.tensor([4, 0, 9])
    cell = graphs.DecodeCell(tp, _clone(caches))
    with _ScalarReads() as mode:
        tp.decode(toks, caches, pos)
        cell.step(toks, pos)
    assert mode.n_ops > 100 and mode.n_reads == 0


def test_permutation_indices_built_once_per_device():
    """``obu.apply_channel_permutation`` and the xla epilogue's blocked
    gather copy their index to the device once per (permutation,
    device)."""
    obu.device_index.cache_clear()
    x = torch.arange(24, dtype=torch.float32).reshape(2, 12)
    perm = obu.group_shuffle_permutation(12, 3)
    for _ in range(3):
        y = obu.apply_channel_permutation(x, perm)
    assert torch.equal(y, x[:, torch.as_tensor(perm)])
    assert obu.device_index.cache_info().misses == 1
    obu.apply_channel_permutation(x, obu.group_shuffle_permutation(12, 4))
    assert obu.device_index.cache_info().misses == 2
    block_perm = (2, 0, 1)
    for _ in range(3):
        z = t_backend._epilogue_xla(x, None, block_perm, 4, "none")
    want = torch.cat([x[:, 8:12], x[:, 0:4], x[:, 4:8]], dim=1)
    assert torch.equal(z, want)
    info = obu.device_index.cache_info()
    assert info.misses == 3 and info.hits == 4


def test_launch_counts_helper():
    """snapshot / difference / add / restore over every wrapper's
    counter."""
    before = counts.snapshot()
    assert set(before) == set(counts.COUNTERS)
    try:
        t_pm.launches += 5
        t_pm.launches_resident += 2
        delta = counts.difference(before, counts.snapshot())
        assert delta["photonic_mvm_fused"] == 5
        assert delta["photonic_mvm_resident"] == 2
        assert sum(delta.values()) == 7
        counts.add(delta)
        assert t_pm.launches == before["photonic_mvm_fused"] + 10
        counts.reset()
        assert not any(counts.snapshot().values())
    finally:
        counts.restore(before)
    assert counts.snapshot() == before


def test_replays_add_the_captured_launch_difference(cpu_capture,
                                                    monkeypatch):
    """Through the capture path: the warm-up step counts its launches,
    the capture's are taken back, and each replay adds the captured
    difference, so the counts equal eager steps' (a stand-in forward
    counts 3 fused launches per step here, as the card's would)."""
    _, tp = _programs("minitron-4b", "photonic")
    forward = t_api.tfm.forward

    def counting_forward(*args, **kwargs):
        t_pm.launches += 3
        return forward(*args, **kwargs)

    monkeypatch.setattr(t_api.tfm, "forward", counting_forward)
    prompt = _prompts(3)
    B, S = prompt.shape
    _, caches = tp.prefill({"tokens": prompt}, S + 4)
    eager_caches = _clone(caches)
    captures = graphs.CAPTURE_COUNTS["decode"]
    cell = graphs.DecodeCell(tp, caches)
    before = counts.snapshot()
    toks = torch.tensor([[5], [7]])
    for i in range(4):
        got = cell.step(toks, S + i)
        assert t_pm.launches - before["photonic_mvm_fused"] == 3 * (i + 1)
        want, _ = tp.decode(toks, eager_caches, S + i)     # no cell
        assert torch.equal(got, want)
        t_pm.launches -= 3                  # the eager step's own count
    assert cell.graph is not None and cell.delta["photonic_mvm_fused"] == 3
    assert sum(cell.delta.values()) == 3
    assert graphs.CAPTURE_COUNTS["decode"] == captures + 1
    counts.restore(before)


def test_one_capture_per_scheduler(cpu_capture, monkeypatch):
    """Across a drain the pool's cell is captured once, and a second
    scheduler captures its own once (the reference's no-retrace tests);
    completions equal an uncaptured scheduler's token for token."""
    _, tp = _programs("granite-moe-1b-a400m", "photonic")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, V, n).astype(np.int32) for n in (5, 9, 3, 7)]

    def drain(**kw):
        ts = ContinuousScheduler(tp, capacity=2, max_len=24, **kw)
        for rid, p in enumerate(prompts):
            ts.submit(Request(rid=rid, prompt=p, max_new=4))
        return ts, {c.rid: c.tokens for c in ts.drain()}

    start = graphs.CAPTURE_COUNTS["decode"]
    ts, got = drain()
    assert ts.stats.decode_steps > 4 and ts.decode_cell.graph is not None
    assert graphs.CAPTURE_COUNTS["decode"] == start + 1
    _, again = drain(prefill_chunk=4)
    assert graphs.CAPTURE_COUNTS["decode"] == start + 2
    monkeypatch.setattr(graphs, "eager_reason",
                        lambda program: "uncaptured reference")
    ref, want = drain()
    assert ref.decode_cell.graph is None
    assert graphs.CAPTURE_COUNTS["decode"] == start + 2
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


def test_fault_model_program_runs_its_cell_eagerly():
    """The stated rule: a Program with the fault model on is not
    captured (``graphs.NOISE_RULE``), on any device."""
    from repro_torch.core.noise import NoiseConfig
    _, tc, _, tp = _model("minitron-4b")
    noisy = t_api.Program.build(
        tc, tp, device="cpu", execution=t_backend.Backend(
            "photonic", fused=False, noise=NoiseConfig(crosstalk=0.003)))
    cuda_like = type("P", (), {"device": torch.device("cuda"),
                               "backend": noisy.backend})()
    assert graphs.eager_reason(cuda_like) == graphs.NOISE_RULE
    clean = type("P", (), {"device": torch.device("cuda"),
                           "backend": t_backend.Backend("photonic")})()
    assert graphs.eager_reason(clean) is None
    assert graphs.eager_reason(noisy) is not None
