"""Sharded-vs-unsharded parity checker (port of
``repro.launch.shardcheck``).

Spawns the mesh's ranks (``launch.mesh.init_ranks``), runs the sharded
Program end to end on a small model and gates it against the unsharded
Program on the same weights, run in this process:

  * ``--mesh DxM`` — Program prefill + decode on the ranks must sit within
    rel-L2 ``--tol`` (the W8A8 parity bound, 0.055) of the unsharded
    program; every rank returns the whole batch's logits, and all ranks'
    must be equal; repeated sharded steps must repeat bit for bit;
  * a 1x1 mesh must be BIT-identical to the unsharded path (in-process);
  * ``--serve`` — data-parallel continuous batching over the mesh: greedy
    completions must be token-identical to the unsharded scheduler at the
    same capacity on every rank; the reference also gates them against
    unsharded solo generation, which holds on its weights (the tests gate
    it there, ``solo_gate``) but not on the port's seed-0 draw, where the
    unsharded scheduler itself differs from solo generation (the photonic
    A8 scale is per tensor over a decode batch): the line reports how many
    agree;
  * ``--check-dropped`` — a deliberately misdivided model must surface the
    one-line partition-report warning from ``Program.build`` (on a 1x4
    mesh of its own);
  * ``--collectives`` — row-parallel collective gates: ``reduce_scatter``
    BIT-identical to ``psum`` per dot and in whole-model prefill logits,
    ``ring`` within 1e-5 per dot and the W8A8 bound over the model, the
    post-scatter epilogue (bias, fused activation, blocked shuffle) within
    1e-5 of the unsharded backend;
  * ``--seq`` — the sequence-split caches: :func:`seq_cfg` (3 KV heads,
    which no "model" axis of 2 or 4 divides) prefills, decodes across the
    ranks' blocks of positions and at per-row positions (``SEQ_CASES``);
    its logits within 1e-5 of the unsharded program on xla (float32, the
    kernel's partial form joined over the ranks) and within ``--tol`` on
    photonic, each rank's caches holding its block of the positions
    (``partition.cache_pspecs``).

On every mesh the caches and attention follow ``cache_pspecs``: the small
model's 2 KV heads go over "model" (a rank projects and attends with its
own heads), the misdivided one's positions.

The reference's zero-retrace gates have no counterpart (the port compiles
no cells; its sharded decode steps run eagerly, ``graphs.MESH_RULE``).

Usage (``--device cpu`` runs the plain kernel versions on gloo ranks):
  python -m repro_torch.launch.shardcheck --mesh 2x2 --execution photonic \\
      --serve --collectives --seq --device cpu
"""
import argparse
import dataclasses
import sys
import warnings

import numpy as np
import torch

from repro_torch.api import Program
from repro_torch.configs.base import ModelConfig
from repro_torch.core import backend as backend_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as tfm
from repro_torch.sharding import partition

DOC = __doc__
SEQ = (4, 8, 14)          # B, S, cache length of the parity gates
# the sequence-split gate's (rows, cache length): 14 positions split over
# "model"; one row leaves the data axes to the positions as well where 16
# divides them all
SEQ_CASES = ((4, 14), (1, 16))
SEQ_PROMPT = 5            # then decode steps at positions 5, 6, 7 and one
                          # at per-row positions 8, 7, 6, 5
SEQ_TOL = 1e-5            # xla, float32


def _rel_l2(a, b):
    a = np.asarray(torch.as_tensor(a).double().cpu())
    b = np.asarray(torch.as_tensor(b).double().cpu())
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-9))


def small_cfg(**kw):
    return ModelConfig(name="shard-t", family="dense", num_layers=2,
                       d_model=32, num_heads=4, num_kv_heads=2, d_ff=64,
                       vocab_size=128, compute_dtype="float32", **kw)


def drop_cfg():
    """A model whose head channels (3 x 5) and d_ff (45) divide no model
    axis of size 2 or 4: those rules drop to replicated."""
    return ModelConfig(name="shard-drop", family="dense", num_layers=2,
                       d_model=30, num_heads=3, num_kv_heads=3, head_dim=5,
                       d_ff=45, vocab_size=128, compute_dtype="float32")


def seq_cfg():
    """:func:`drop_cfg` at an even head dim (RoPE rotates pairs; drop_cfg's
    5 only builds): its 3 KV heads divide no "model" axis of 2 or 4, so its
    caches split over the positions (``partition.cache_pspecs``), and its
    query channels (3 x 6) split mid-head."""
    return dataclasses.replace(drop_cfg(), name="shard-seq", head_dim=6)


def variant_cfgs() -> dict:
    """Models beside ``small_cfg`` whose sharded logits the gates hold to
    their unsharded ones: an R&B stack (2 basic groups x 4 reuses with
    shuffle and OBU-transpose transforms: square attention banks read
    transposed, so a rank regathers their fields) and a MoE stack with
    blended experts (the reuse-resident MVM; the expert FFN on the whole
    batch)."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.core.prm import ReuseConfig
    rb = dataclasses.replace(
        small_cfg(), name="shard-rb", num_layers=8,
        reuse=ReuseConfig(num_basic=2, reuse_times=4, shuffle_groups=8,
                          transforms=("identity", "shuffle", "transpose",
                                      "shuffle")))
    moe = dataclasses.replace(
        small_cfg(), name="shard-moe", family="moe",
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=32,
                      num_basic_experts=2, group_tokens=8))
    return {"rb": rb, "moe": moe}


def seq_steps(prog, cfg, B: int, L: int) -> dict:
    """The sequence-split gate's steps on ``prog`` (module docstring): a
    prefill of ``SEQ_PROMPT`` tokens into an ``L``-position cache, decode
    steps at positions ``SEQ_PROMPT``.. on the inputs' next tokens, then
    one at per-row positions.  Returns the logits of every step and the
    shape of the first layer's K cache."""
    toks = small_inputs(cfg)[:B].to(prog.device)
    S = toks.shape[1]
    logits, caches = prog.prefill({"tokens": toks[:, :SEQ_PROMPT]}, L)
    out = [logits]
    for pos in range(SEQ_PROMPT, S):
        lg, caches = prog.decode(toks[:, pos:pos + 1], caches, pos)
        out.append(lg)
    per_row = S - torch.arange(B, device=prog.device)
    lg, caches = prog.decode(toks[:, -1:], caches, per_row)
    out.append(lg)
    k = next(iter(caches.values()))["l0"]["k"]
    return {"logits": [_cpu(t) for t in out], "k_shape": tuple(k.shape)}


def small_inputs(cfg, seed: int = 1):
    B, S, _ = SEQ
    g = torch.Generator().manual_seed(seed)
    return torch.randint(1, cfg.vocab_size, (B, S), generator=g)


def small_requests(cfg, n: int = 6, seed: int = 7):
    """(rid, prompt, max_new) of the serving gate: prompts of 3-8 tokens,
    2-4 new tokens each."""
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(n):
        prompt = rng.integers(1, cfg.vocab_size,
                              int(rng.integers(3, 9))).astype(np.int32)
        out.append((rid, prompt, int(rng.integers(2, 5))))
    return out


def dot_case(execution: str):
    """The per-dot collective gate's operands: x (4, 1, 64), w (64, 64),
    a bias and a blocked permutation of 16-channel blocks."""
    g = torch.Generator().manual_seed(3)
    B, K, N = 4, 64, 64
    x = torch.randn((B, 1, K), generator=g)
    w = torch.randn((K, N), generator=g) / float(np.sqrt(K))
    bias = torch.randn((N,), generator=g)
    block = 16
    perm = tuple(int(i) for i in
                 np.random.default_rng(5).permutation(N // block))
    cases = [("plain", {}),
             ("bias+silu", dict(bias=bias, activation="silu")),
             ("blend-shuffle", dict(bias=bias, block_perm=perm,
                                    block=block))]
    return x, w, cases


def _on(t, dev):
    return t.to(dev) if isinstance(t, torch.Tensor) else t


def _cpu(t):
    return t.detach().cpu() if isinstance(t, torch.Tensor) else t


def _params_on(params, dev):
    if isinstance(params, dict):
        return {k: _params_on(v, dev) for k, v in params.items()}
    return params.to(dev)


# =========================================================================
# what a rank runs
# =========================================================================
def rank_checks(mesh, job: dict) -> dict:
    """One rank's part of every gate ``job`` asks for (run by
    ``init_ranks``): returns the sharded outputs, which the parent holds
    against the unsharded ones."""
    dev = mesh.device
    cfg, execution = job["cfg"], job["execution"]
    params = _params_on(job["params"], dev)
    toks = job["toks"].to(dev)
    B, S, L = SEQ
    out = {"transport": mesh.describe(), "coords": mesh.coords}
    prog = Program.build(cfg, params, execution=execution, mesh=mesh)
    lp, cp = prog.prefill({"tokens": toks}, L)
    dp_, cp = prog.decode(toks[:, :1], cp, S)
    l2, c2 = prog.prefill({"tokens": toks}, L)
    d2, _ = prog.decode(toks[:, :1], c2, S)
    out["prefill"], out["decode"] = _cpu(lp), _cpu(dp_)
    out["repeat_equal"] = bool(torch.equal(lp, l2) and torch.equal(dp_, d2))
    out["cache_rows"] = int(next(iter(next(iter(
        cp.values())).values()))["k"].shape[2])
    variants = {}
    for name, (vcfg, vparams) in job.get("variants", {}).items():
        vprog = Program.build(vcfg, _params_on(vparams, dev),
                              execution=execution, mesh=mesh)
        vl, vc = vprog.prefill({"tokens": toks}, L)
        vd, _ = vprog.decode(toks[:, :1], vc, S)
        variants[name] = (_cpu(vl), _cpu(vd))
    out["variants"] = variants
    if job.get("serve"):
        out["serve"] = _serve(prog, cfg, job["serve"], mesh)
    if job.get("collectives"):
        out["collectives"] = _collectives(mesh, cfg, params, toks, execution,
                                          job["dot"])
    if job.get("dropped"):
        out["dropped"] = _dropped(mesh)
    if job.get("seq"):
        scfg, sparams = job["seq"]
        sprog = Program.build(scfg, _params_on(sparams, dev),
                              execution=execution, mesh=mesh)
        out["seq"] = {case: seq_steps(sprog, scfg, *case)
                      for case in SEQ_CASES}
    if job.get("refusals"):
        out["refusals"] = _refusals(mesh, cfg, params, execution)
    return out


def _serve(prog, cfg, requests, mesh):
    from repro_torch.serve.batcher import Request
    from repro_torch.serve.scheduler import ContinuousScheduler

    dp = partition.dp_size(mesh)
    sched = ContinuousScheduler(prog, capacity=max(4, dp), max_len=24)
    for rid, prompt, max_new in requests:
        sched.submit(Request(rid=rid, prompt=prompt, max_new=max_new))
    comps = {c.rid: np.asarray(c.tokens) for c in sched.drain()}
    return {"tokens": comps, "pool_rows": sched.pool.rows,
            "pool_lo": sched.pool.lo}


def _collectives(mesh, cfg, params, toks, execution, dot):
    dev = mesh.device
    x, w, cases = dot
    x, w = x.to(dev), w.to(dev)
    per_dot = {}
    for label, kw in cases:
        kw = {k: _on(v, dev) for k, v in kw.items()}
        for c in backend_lib.TP_COLLECTIVES:
            bk = backend_lib.Backend(execution, mesh=mesh, tp_collective=c)
            per_dot[(label, c)] = _cpu(bk.dot(x, w, tp_hint="row", **kw))
    B, S, L = SEQ
    model = {}
    for c in ("psum", "reduce_scatter", "ring"):
        prog = Program.build(cfg, params, execution=backend_lib.Backend(
            execution, mesh=mesh, tp_collective=c))
        lp, cache = prog.prefill({"tokens": toks}, L)
        d, _ = prog.decode(toks[:, :1], cache, S)
        model[c] = (_cpu(lp), _cpu(d))
    return {"per_dot": per_dot, "model": model}


def _dropped(mesh):
    cfg = drop_cfg()
    params = tfm.init_model(cfg, seed=0, device=mesh.device)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        Program.build(cfg, params, mesh=mesh)
    return [str(w.message) for w in caught
            if "rule(s) dropped" in str(w.message)]


def _refusals(mesh, cfg, params, execution) -> dict:
    """Each refusal the mesh plumbing owes: the error type raised, or None
    when the call went through."""
    from repro_torch.core.noise import NoiseConfig
    from repro_torch.serve.scheduler import ContinuousScheduler

    def raised(fn):
        try:
            fn()
        except (ValueError, NotImplementedError) as e:
            return type(e).__name__
        return None

    noise = NoiseConfig(gain_sigma=0.01)
    other = mesh_lib.single_device_mesh()
    prog = Program.build(cfg, params, execution="photonic", mesh=mesh)
    plain = Program.build(cfg, params, execution=execution,
                          device=mesh.device)
    return {
        "conflicting_mesh": raised(lambda: Program.build(
            cfg, params, execution=backend_lib.Backend(execution, mesh=mesh),
            mesh=other)),
        "noise_backend": raised(lambda: backend_lib.Backend(
            "photonic", mesh=mesh, noise=noise)),
        "update_noise": raised(lambda: prog.update_noise(noise)),
        "scheduler_mesh_without_program_mesh": raised(
            lambda: ContinuousScheduler(plain, capacity=4, max_len=16,
                                        mesh=mesh)),
        "scheduler_conflicting_mesh": raised(
            lambda: ContinuousScheduler(prog, capacity=4, max_len=16,
                                        mesh=other)),
        "unbound_mesh": raised(lambda: Program.build(
            cfg, params, device=mesh.device,
            mesh=mesh_lib.parse_mesh("x".join(map(str, mesh.sizes))))),
    }


# =========================================================================
# the gates (parent process)
# =========================================================================
def run(mesh_spec, execution: str = "photonic", tol: float = 0.055, *,
        serve: bool = False, collectives: bool = False,
        dropped: bool = False, refusals: bool = False, variants=False,
        seq: bool = False, device=None, params=None,
        solo_gate: bool = False, threads=None):
    """Run the gates on one spawn of ``mesh_spec``'s ranks.  Returns (fails,
    report): the failed gates' messages and the per-rank outputs, with the
    unsharded references under ``"unsharded"``.  ``params`` default to
    the port's seed-0 init; ``solo_gate`` also gates DP serving against
    solo generate (for weights on which the unsharded scheduler meets it,
    as the reference's own do); ``variants`` also holds the
    :func:`variant_cfgs` models (seed-0 weights) to their unsharded
    logits; ``seq`` runs the sequence-split gate (:func:`seq_cfg`, seed-0
    weights)."""
    dev = torch.device("cuda" if device is None else device)
    cfg = small_cfg()
    if params is None:
        params = tfm.init_model(cfg, seed=0, device="cpu")
    toks = small_inputs(cfg)
    B, S, L = SEQ
    mesh = mesh_lib.parse_mesh(mesh_spec)
    fails = []

    ref = Program.build(cfg, params, execution=execution, device=dev)
    lr, cr = ref.prefill({"tokens": toks.to(dev)}, L)
    dr, _ = ref.decode(toks[:, :1].to(dev), cr, S)
    lr, dr = _cpu(lr), _cpu(dr)

    job = {"cfg": cfg, "params": params, "toks": toks,
           "execution": execution, "collectives": collectives,
           "dropped": dropped, "refusals": refusals,
           "dot": dot_case(execution)}
    if serve:
        job["serve"] = small_requests(cfg)
    if variants:
        job["variants"] = {
            name: (vcfg, tfm.init_model(vcfg, seed=0, device="cpu"))
            for name, vcfg in variant_cfgs().items()}
    if seq:
        job["seq"] = (seq_cfg(), tfm.init_model(seq_cfg(), seed=0,
                                                device="cpu"))
    if mesh.size == 1:
        ranks = [rank_checks(mesh_lib.Mesh(mesh.axis_names, mesh.sizes,
                                           coords=mesh.coords, device=dev),
                             job)]
    else:
        ranks = mesh_lib.init_ranks(rank_checks, mesh, device=str(dev),
                                    args=(job,), threads=threads)
    r0 = ranks[0]
    rel_p, rel_d = _rel_l2(r0["prefill"], lr), _rel_l2(r0["decode"], dr)
    print(f"[shardcheck] mesh {mesh.shape} {execution} on {dev} "
          f"({r0['transport']}): prefill rel-L2 {rel_p:.5f}, decode rel-L2 "
          f"{rel_d:.5f} (tol {tol})")
    if rel_p > tol or rel_d > tol:
        fails.append(f"parity {mesh_spec}: rel-L2 prefill {rel_p:.5f} / "
                     f"decode {rel_d:.5f} > {tol}")
    if not all(torch.equal(r["prefill"], r0["prefill"])
               and torch.equal(r["decode"], r0["decode"]) for r in ranks):
        fails.append("ranks returned different logits")
    if not all(r["repeat_equal"] for r in ranks):
        fails.append("repeated sharded steps differ")

    unsharded_variants = {}
    for name, (vcfg, vparams) in job.get("variants", {}).items():
        vref = Program.build(vcfg, vparams, execution=execution, device=dev)
        vl, vc = vref.prefill({"tokens": toks.to(dev)}, L)
        vd, _ = vref.decode(toks[:, :1].to(dev), vc, S)
        unsharded_variants[name] = (_cpu(vl), _cpu(vd))
        got_l, got_d = r0["variants"][name]
        rel_vp, rel_vd = _rel_l2(got_l, _cpu(vl)), _rel_l2(got_d, _cpu(vd))
        print(f"[shardcheck] {vcfg.name} on {mesh.shape}: prefill rel-L2 "
              f"{rel_vp:.5f}, decode rel-L2 {rel_vd:.5f} (tol {tol})")
        if rel_vp > tol or rel_vd > tol:
            fails.append(f"parity {vcfg.name} {mesh_spec}: rel-L2 prefill "
                         f"{rel_vp:.5f} / decode {rel_vd:.5f} > {tol}")

    # the 1x1 mesh is the unsharded path: BIT-identical
    one = Program.build(cfg, params, execution=execution, device=dev,
                        mesh=mesh_lib.single_device_mesh())
    lo, co = one.prefill({"tokens": toks.to(dev)}, L)
    do, _ = one.decode(toks[:, :1].to(dev), co, S)
    if not (torch.equal(_cpu(lo), lr) and torch.equal(_cpu(do), dr)):
        fails.append("1x1 mesh not bit-identical to the unsharded path")
    else:
        print("[shardcheck] 1x1 mesh bit-identical to unsharded: ok")

    if serve:
        fails += _gate_serve(ref, job["serve"], ranks, mesh,
                             solo=solo_gate)
    if dropped:
        msgs = [m for r in ranks for m in r["dropped"]]
        if len(msgs) < len(ranks):
            fails.append("no dropped-rule warning from Program.build on a "
                         "misdivided mesh")
        else:
            print(f"[shardcheck] dropped-rule warning surfaced: {msgs[0]}")
    if collectives:
        fails += _gate_collectives(ranks, mesh, execution, tol, dev)
    unsharded_seq = {}
    if seq:
        unsharded_seq, f = _gate_seq(job["seq"], ranks, mesh, execution,
                                     tol, dev)
        fails += f
    if refusals:
        bad = {k: v for r in ranks for k, v in r["refusals"].items()
               if v is None}
        if bad:
            fails.append(f"mesh plumbing accepted what it must refuse: "
                         f"{sorted(bad)}")
    return fails, {"unsharded": (lr, dr), "ranks": ranks,
                   "unsharded_variants": unsharded_variants,
                   "unsharded_seq": unsharded_seq}


def _gate_seq(seq, ranks, mesh, execution, tol, dev):
    """The sequence-split gate (module docstring): every rank's logits
    against the unsharded program's on the same steps, and each rank's K
    cache holding its block of the positions."""
    scfg, sparams = seq
    ref = Program.build(scfg, sparams, execution=execution, device=dev)
    gate = SEQ_TOL if execution == "xla" else tol
    fails, want = [], {}
    for B, L in SEQ_CASES:
        want[(B, L)] = seq_steps(ref, scfg, B, L)["logits"]
        spec = partition.cache_pspecs(scfg, mesh, B, L)["main"]["l0"]["k"]
        parts = mesh.axis_size(tuple(a for a in mesh.axis_names
                                     if a in (spec[3] or ())))
        worst = 0.0
        for r in ranks:
            got = r["seq"][(B, L)]
            worst = max([worst] + [_rel_l2(a, b) for a, b in
                                   zip(got["logits"], want[(B, L)])])
            if got["k_shape"][3] * parts != L or parts < 2:
                fails.append(f"seq B={B} L={L}: a rank's K cache "
                             f"{got['k_shape']} for {parts} blocks of the "
                             f"positions")
        print(f"[shardcheck] {scfg.name} B={B} L={L} on {mesh.shape}: "
              f"positions over {spec[3]}, worst rel-L2 {worst:.2e} "
              f"(tol {gate})")
        if worst > gate:
            fails.append(f"seq B={B} L={L}: rel-L2 {worst:.2e} > {gate}")
    return want, fails


def _gate_serve(ref, requests, ranks, mesh, solo: bool) -> list:
    """DP serving on every rank token-identical to the unsharded
    scheduler at the same capacity (the mesh's claim) and, with ``solo``,
    to unsharded solo ``generate`` per request (the reference's gate; its
    photonic A8 scale is per tensor over the decode batch, so it holds on
    the reference's weights, not on every draw)."""
    _, sched_tokens = _serve_unsharded(ref, requests, mesh)
    fails = []
    bad = sorted({rid for rid, _, _ in requests for r in ranks
                  if not np.array_equal(r["serve"]["tokens"][rid],
                                        sched_tokens[rid])})
    if bad:
        fails.append(f"DP serving tokens diverge from the unsharded "
                     f"scheduler: rids {bad}")
    solo_bad = []
    for rid, prompt, max_new in requests:
        want = ref.generate(torch.as_tensor(prompt)[None, :].long(),
                            max_new)[0].cpu().numpy()
        if not all(np.array_equal(r["serve"]["tokens"][rid], want)
                   for r in ranks):
            solo_bad.append(rid)
    if solo and solo_bad:
        fails.append(f"DP serving tokens diverge from solo generate: rids "
                     f"{solo_bad}")
    if not fails:
        print(f"[shardcheck] DP serving over {mesh.shape}: {len(requests)} "
              f"requests token-identical to the unsharded scheduler on "
              f"every rank; {len(requests) - len(solo_bad)} of them to solo "
              f"generate{'' if solo else ' (not gated on these weights)'}")
    return fails


def _serve_unsharded(ref, requests, mesh):
    from repro_torch.serve.batcher import Request
    from repro_torch.serve.scheduler import ContinuousScheduler

    sched = ContinuousScheduler(ref, capacity=max(4, partition.dp_size(mesh)),
                                max_len=24)
    for rid, prompt, max_new in requests:
        sched.submit(Request(rid=rid, prompt=prompt, max_new=max_new))
    return sched, {c.rid: np.asarray(c.tokens) for c in sched.drain()}


def _gate_collectives(ranks, mesh, execution, tol, dev) -> list:
    fails = []
    tp = mesh.shape.get("model", 1)
    x, w, cases = dot_case(execution)
    ref_bk = backend_lib.Backend(execution)
    r0 = ranks[0]["collectives"]
    for label, kw in cases:
        rule = backend_lib.partition_rule(
            tp, x.shape[-1], w.shape[-1], block_perm=kw.get("block_perm"),
            tp_hint="row", collective="reduce_scatter")
        kw_d = {k: _on(v, dev) for k, v in kw.items()}
        y_ref = _cpu(ref_bk.dot(x.to(dev), w.to(dev), tp_hint="row",
                                **kw_d))
        y_psum = r0["per_dot"][(label, "psum")]
        y_scat = r0["per_dot"][(label, "reduce_scatter")]
        y_ring = r0["per_dot"][(label, "ring")]
        n0 = len(fails)
        if not torch.equal(y_scat, y_psum):
            fails.append(f"collectives[{label}]: reduce_scatter not "
                         f"bit-identical to psum (rule={rule})")
        rel_ring = _rel_l2(y_ring, y_psum)
        if rel_ring > 1e-5:
            fails.append(f"collectives[{label}]: ring vs psum rel-L2 "
                         f"{rel_ring:.2e} > 1e-5")
        rel_ref = _rel_l2(y_scat, y_ref)
        if rel_ref > 1e-5:
            fails.append(f"collectives[{label}]: sharded epilogue vs "
                         f"unsharded rel-L2 {rel_ref:.2e} > 1e-5")
        if len(fails) == n0:
            print(f"[shardcheck] collectives[{label}] rule={rule}: "
                  f"scatter==psum bitwise, ring rel-L2 {rel_ring:.1e}, "
                  f"vs-unsharded rel-L2 {rel_ref:.1e}")
    model = r0["model"]
    if not torch.equal(model["reduce_scatter"][0], model["psum"][0]):
        fails.append("prefill logits: reduce_scatter not bit-identical to "
                     "psum")
    rel_dec = _rel_l2(model["reduce_scatter"][1], model["psum"][1])
    if rel_dec > 1e-5:
        fails.append(f"decode logits: reduce_scatter vs psum rel-L2 "
                     f"{rel_dec:.2e} > 1e-5")
    rel_ring = _rel_l2(model["ring"][1], model["psum"][1])
    if rel_ring > tol:
        fails.append(f"decode logits: ring vs psum rel-L2 {rel_ring:.4f} "
                     f"> {tol}")
    print(f"[shardcheck] logits reduce_scatter vs psum: prefill "
          f"{'bitwise' if not fails else 'DIFFERS'}, decode rel-L2 "
          f"{rel_dec:.1e}; ring decode rel-L2 {rel_ring:.1e}")
    return fails


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=DOC,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--mesh", default="1x2",
                    help="data x model (x pod leading for 3 dims)")
    ap.add_argument("--execution", default="photonic",
                    choices=["xla", "photonic"])
    ap.add_argument("--tol", type=float, default=0.055)
    ap.add_argument("--serve", action="store_true",
                    help="also gate DP continuous serving token-identity")
    ap.add_argument("--check-dropped", action="store_true",
                    help="also gate the partition-report warning (1x4)")
    ap.add_argument("--collectives", action="store_true",
                    help="also gate reduce-scatter/ring vs psum")
    ap.add_argument("--seq", action="store_true",
                    help="also gate the sequence-split caches")
    ap.add_argument("--device", default=None,
                    help="cuda (default; ranks share the card when there "
                         "are more ranks than cards) or cpu")
    args = ap.parse_args(argv)
    fails, _ = run(args.mesh, args.execution, args.tol, serve=args.serve,
                   collectives=args.collectives, seq=args.seq,
                   device=args.device)
    if args.check_dropped:
        f2, _ = run("1x4", args.execution, args.tol, dropped=True,
                    device=args.device)
        fails += f2
    for f in fails:
        print(f"[shardcheck] FAIL {f}")
    print(f"[shardcheck] {'FAIL' if fails else 'ok'}")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
