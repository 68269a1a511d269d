"""The jamba smoke model (SSM, attention and MoE layers in one group of 8)
on the photonic backend, float32, against the JAX reference on the same
weights: layer by layer, and what its end-to-end gap is made of.

The port's photonic model gate is rel-L2 <= 1e-3 on the logits.  On jamba
it holds for every layer on the same input as the reference's layer
(prefill with its cache on the reference's trajectory and on the port's
own, decode from the reference's prefill cache), but not end to end on
three of four prompt seeds.  One float32 ulp can flip a per-tensor A8
rounding, and the flip carries through the SSM recurrence and the later
layers: the reference's own logits move by more than the gate when its
input moves by one ulp.  The two witness tests at the end pin that
behaviour of the reference, and that the port's end-to-end gap is the
reference's response to such a change.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import api as j_api
from repro.configs import smoke_variant as j_smoke
from repro.core import backend as j_bk
from repro.models import layers as j_layers
from repro.models import transformer as j_tfm
from repro.train.checkpoint import _flatten

from repro_torch import bridge
from repro_torch.configs import smoke_variant as t_smoke
from repro_torch.core import backend as t_bk
from repro_torch.core import prepared as t_prep
from repro_torch.core.sharing import tree_index
from repro_torch.models import transformer as t_tfm

torch.set_num_threads(2)
TOL = {"xla": 1e-5, "photonic": 1e-3}
B, S, L = 2, 12, 16
V = 211


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


@functools.lru_cache(maxsize=None)
def _banks():
    """(jax cfg, torch cfg, jax bank, torch bank): the jamba smoke variant,
    photonic, on the weights of ``test_torch_ssm.py``."""
    jc, tc = j_smoke("jamba-v0.1-52b"), t_smoke("jamba-v0.1-52b")
    params, _ = j_tfm.init_model(jax.random.PRNGKey(0), jc)
    tp = bridge.params_from_flat(_flatten(params), device="cpu")
    return (jc, tc, j_api._prepare_cell(params, cfg=jc, photonic=True),
            t_prep.prepare_params(tp, "float32", True))


def _tokens(seed=0, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, V, shape).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jamba_layer_fn(mixer_kind, ffn_kind, mode):
    """The reference's jamba layer of one kind, photonic, jitted (one
    compile per kind and mode)."""
    jc = _banks()[0]
    bk = j_bk.resolve("photonic")

    def layer(p, h, cache, pos):
        h, cache, _ = j_tfm.apply_layer(
            p, jc, h, cache, jnp.float32(0), mode=mode, causal=True, pos=pos,
            ctx={"backend": bk}, mixer_kind=mixer_kind, ffn_kind=ffn_kind,
            transpose=False)
        return h, cache
    return jax.jit(layer)


def _jamba_layers(r=0):
    """[(reference layer fn, port layer fn)] of R slice ``r`` of the jamba
    smoke stack, photonic; each fn maps (h, cache, pos, mode) to (h,
    cache) in its own array type."""
    jc, tc, jbank, tbank = _banks()
    spec = j_tfm.build_segments(jc)[0]
    jp = jax.tree.map(lambda a: a[r], jbank["segments"]["main"])
    tp = tree_index(tbank["segments"]["main"], r)
    tbk = t_bk.resolve("photonic")
    out = []
    for i in range(spec.group_size):
        kinds = dict(mixer_kind=spec.mixer_kinds[i],
                     ffn_kind=spec.ffn_kinds[i])

        def ref(h, cache, pos, mode, i=i, kinds=kinds):
            fn = _jamba_layer_fn(kinds["mixer_kind"], kinds["ffn_kind"], mode)
            return fn(jp[f"l{i}"], jnp.asarray(h), cache, pos)

        def port(h, cache, pos, mode, i=i, kinds=kinds):
            h, cache, _ = t_tfm.apply_layer(
                tp[f"l{i}"], tc, torch.as_tensor(np.array(h)), cache,
                torch.zeros(()), mode=mode, causal=True, pos=pos,
                backend=tbk, transpose=False, **kinds)
            return h, cache
        out.append((ref, port))
    return out


def _jamba_head(h):
    """The reference's final norm and lm head on a hidden state."""
    jc, _, jbank, _ = _banks()
    h = j_layers.apply_norm(jbank["final_norm"], jnp.asarray(h), jc.norm,
                            jc.norm_eps)
    return np.asarray(j_tfm.unembed(jbank["lm_head"], h,
                                    backend=j_bk.resolve("photonic")))


def _torch_cache(cache):
    return {k: torch.as_tensor(np.array(v)) for k, v in cache.items()}


@pytest.mark.parametrize("seed", range(4))
def test_jamba_photonic_layers_match_reference_teacher_forced(seed):
    """Every layer of the jamba group (SSM + dense, SSM + MoE, attention +
    dense), photonic, in every R slice of the stack (the smoke stack holds
    one), held to the gate on the same input as the reference's layer:
    prefill (with its cache) along the reference's trajectory and along
    the port's own, and a decode step from the reference's prefill cache
    along the reference's decode trajectory."""
    jc, tc, jbank, _ = _banks()
    tol = TOL["photonic"]
    R = jax.tree.leaves(jbank["segments"]["main"])[0].shape[0]
    zeros = jax.tree.map(lambda a: a[0, 0], j_tfm.init_caches(
        jc, B, L, dtype=jnp.float32)["main"])
    table = jbank["embed"]["table"]
    for r in range(R):
        h_ref = h_port = table[jnp.asarray(_tokens(seed))]
        d_ref = table[jnp.asarray(_tokens(seed + 10, (B, 1)))]
        for i, (ref, port) in enumerate(_jamba_layers(r)):
            zero = zeros[f"l{i}"]
            jh, jcache = ref(h_ref, zero, None, "prefill")
            th, tcache = port(h_ref, _torch_cache(zero), None, "prefill")
            assert _rel(th, jh) <= tol, ("prefill", r, i, _rel(th, jh))
            for k, v in jcache.items():
                assert tuple(tcache[k].shape) == v.shape
                assert _rel(tcache[k], v) <= tol, ("prefill", r, i, k)
            jd, jdc = ref(d_ref, jcache, S, "decode")
            td, tdc = port(d_ref, _torch_cache(jcache), S, "decode")
            assert _rel(td, jd) <= tol, ("decode", r, i, _rel(td, jd))
            for k, v in jdc.items():
                assert tuple(tdc[k].shape) == v.shape
                assert _rel(tdc[k], v) <= tol, ("decode", r, i, k)
            jh2, _ = ref(h_port, zero, None, "prefill")
            th2, _ = port(h_port, _torch_cache(zero), None, "prefill")
            assert _rel(th2, jh2) <= tol, ("port input", r, i,
                                           _rel(th2, jh2))
            h_ref, d_ref, h_port = jh, jd, th2.numpy()


def _jamba_logits(seed):
    """(reference forward, reference layer by layer, port forward) logits
    of the jamba smoke model, photonic, on prompt seed ``seed``."""
    jc, tc, jbank, tbank = _banks()
    toks = _tokens(seed)
    jl, _, _ = j_tfm.forward(jbank, jc, {"tokens": jnp.asarray(toks)},
                             mode="train", execution="photonic")
    tl, _, _ = t_tfm.forward(tbank, tc,
                             {"tokens": torch.as_tensor(toks).long()},
                             mode="train", execution="photonic")
    h = jbank["embed"]["table"][jnp.asarray(toks)]
    for ref, _ in _jamba_layers():
        h, _ = ref(h, None, None, "train")
    return np.asarray(jl), _jamba_head(h), tl.numpy()


def test_jamba_photonic_reference_moves_under_one_ulp():
    """Why the jamba photonic logits are not held to 1e-3 end to end: the
    reference misses that gate against itself.  On prompt seed 3, moving
    every element of layer 1's input by one float32 ulp (four seeded draws
    of the directions) moves its logits by more than the gate each time
    and by more than 1e-2 at most; and its layers applied one by one
    without ``jit`` part from its compiled ``forward`` by more than the
    gate, while the port's logits sit within the gate of that eager
    evaluation."""
    tol = TOL["photonic"]
    jl, jl_layers, tl = _jamba_logits(3)
    assert _rel(jl_layers, jl) <= 1e-6      # jitted layers: the forward
    layers = _jamba_layers()
    h0 = _banks()[2]["embed"]["table"][jnp.asarray(_tokens(3))]
    h1 = np.asarray(layers[0][0](h0, None, None, "train")[0])
    spread = []
    for draw in range(4):
        up = np.random.default_rng(100 + draw).integers(0, 2, h1.shape)
        h = np.where(up == 1, np.nextafter(h1, np.float32(np.inf)),
                     np.nextafter(h1, np.float32(-np.inf)))
        for ref, _ in layers[1:]:
            h, _ = ref(h, None, None, "train")
        spread.append(_rel(_jamba_head(h), jl))
    assert min(spread) > tol and max(spread) > 1e-2, spread
    jc = _banks()[0]
    spec = j_tfm.build_segments(jc)[0]
    jp = jax.tree.map(lambda a: a[0], _banks()[2]["segments"]["main"])
    h = h0
    for i in range(spec.group_size):
        h, _, _ = j_tfm.apply_layer(
            jp[f"l{i}"], jc, h, None, jnp.float32(0), mode="train",
            causal=True, pos=None, ctx={"backend": j_bk.resolve("photonic")},
            mixer_kind=spec.mixer_kinds[i], ffn_kind=spec.ffn_kinds[i],
            transpose=False)
    eager = _jamba_head(h)
    assert _rel(eager, jl) > tol and _rel(tl, eager) <= tol


def test_jamba_photonic_gap_is_the_references_response():
    """On prompt seed 0 the port's first layer lands within 1e-6 of the
    reference's (ulps), and the reference's own remaining layers, fed that
    output, reproduce the port's logits within the gate while parting from
    the reference's own logits by more than it: the end-to-end gap is the
    reference's response to an ulp-sized input change."""
    tol = TOL["photonic"]
    jl, jl_layers, tl = _jamba_logits(0)
    assert _rel(tl, jl) > tol and _rel(jl_layers, jl) <= 1e-6
    layers = _jamba_layers()
    h0 = _banks()[2]["embed"]["table"][jnp.asarray(_tokens(0))]
    jh, _ = layers[0][0](h0, None, None, "train")
    th, _ = layers[0][1](np.asarray(h0), None, None, "train")
    assert _rel(th, jh) <= 1e-6
    h = th.numpy()
    for ref, _ in layers[1:]:
        h, _ = ref(h, None, None, "train")
    handed = _jamba_head(h)
    assert _rel(handed, tl) <= tol and _rel(handed, jl) > tol
