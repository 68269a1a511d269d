"""What the gloo ranks of ``tests/test_torch_train_mesh.py``,
``tests/test_torch_fsdp.py``, ``tests/test_torch_dryrun.py``,
``tests/test_torch_tp_attention.py``, ``tests/test_torch_tp_ssm_mla.py``,
``tests/test_torch_seq_parallel.py`` and
``tests/test_torch_seq_parallel_prefill.py`` run (``launch.mesh.init_ranks``
imports a rank's function in each child process).  This module imports the port
only, so a rank starts without JAX; the test files hold its results
against the reference."""
import dataclasses

import numpy as np
import torch

from repro_torch import api
from repro_torch import bridge
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.optim import adamw
from repro_torch.sharding import partition
from repro_torch.train import checkpoint
from repro_torch.train import trainer


def batches(vocab: int, B: int, S: int, steps: int) -> list:
    """The pipeline's first ``steps`` global batches (numpy; the
    reference's bit for bit)."""
    pipe = SyntheticPipeline(DataConfig(vocab_size=vocab, seq_len=S,
                                        global_batch=B))
    return [pipe.batch_for_step(s)["tokens"] for s in range(steps)]


def tensors(arrays) -> list:
    return [{"tokens": torch.as_tensor(b).long()} for b in arrays]


def np_tree(tree) -> dict:
    """``{path: float32 array}`` of a tree, in the checkpoint key format."""
    return {k: v.astype(np.float32)
            for k, v in checkpoint._flatten(tree).items()}


def train_rank(mesh, job, B, S, steps, tcfg, mbs, modes=None):
    """Per model of ``job`` ({name: (cfg, flat params)}) and per
    ``cfg.fsdp``: the rank's param pieces' shapes, ``loss_and_grads`` of
    the first batch (the gradients gathered whole), then ``steps`` steps
    with each microbatch count of ``mbs`` (one step without microbatches):
    metrics, the params and moments gathered whole.  The residual spec is
    ``partition.act_pspec(mesh)`` ("seq"), keyed ``(name, fsdp)``; with
    ``modes`` each of those modes', keyed ``(name, fsdp, mode)``."""
    torch.set_num_threads(1)
    out = {"collectives": grad_collectives(mesh), "coords": mesh.coords}
    for name, (tc, flat) in job.items():
        whole = bridge.params_from_flat(flat, device="cpu")
        data = tensors(batches(tc.vocab_size, B, S, steps))
        for fsdp in (False, True):
            cfg = dataclasses.replace(tc, fsdp=fsdp)
            if modes is None:
                out[(name, fsdp)] = _train_one(
                    mesh, cfg, whole, data, partition.act_pspec(mesh),
                    steps, tcfg, mbs)
                continue
            for mode in modes:
                out[(name, fsdp, mode)] = _train_one(
                    mesh, cfg, whole, data, partition.act_pspec(mesh, mode),
                    steps, tcfg, mbs)
    return out


def _train_one(mesh, cfg, whole, data, apspec, steps, tcfg, mbs):
    specs = trainer.param_specs(cfg, mesh)
    params = partition.local_tree(whole, specs, mesh)
    r = {"pieces": {k: tuple(v.shape) for k, v in
                    checkpoint._flatten(params).items()}}
    loss, ce, aux, g = trainer.loss_and_grads(
        params, cfg, data[0], remat=True, mesh=mesh, act_pspec=apspec)
    r["loss_and_grads"] = (float(loss), float(ce), float(aux),
                           np_tree(partition.gather_tree(g, specs, mesh)))
    for mb in mbs:
        step = trainer.make_train_step(
            cfg, TrainConfig(**tcfg, microbatch=mb), act_pspec=apspec,
            mesh=mesh)
        p, o = params, adamw.init(params)
        metrics = []
        for b in data[:steps if mb else 1]:
            p, o, m = step(p, o, b)
            metrics.append((float(m["loss"]), float(m["grad_norm"]),
                            float(m["lr"])))
        r[("steps", mb)] = (
            metrics, np_tree(partition.gather_tree(p, specs, mesh)),
            np_tree(partition.gather_tree(o.m, specs, mesh)),
            np_tree(partition.gather_tree(o.v, specs, mesh)),
            int(o.step))
    return r


def grad_collectives(mesh) -> dict:
    """The differentiable collectives over "data" on a rank: an all-gather
    of a (2, 3) tensor on dim 1 and a reduce-scatter of a (4, 2) tensor on
    dim 0, each under a loss weighted by ``w``: their outputs and the
    gradients of their inputs."""
    from repro_torch.sharding import collectives as coll

    i = mesh.index("data")
    x = (torch.arange(6.0).reshape(2, 3) + 10 * i).requires_grad_(True)
    y = coll.all_gather_grad(x, mesh, "data", dim=1)
    w = torch.arange(float(y.numel())).reshape(y.shape) * (i + 1)
    (y * w).sum().backward()
    u = (torch.arange(8.0).reshape(4, 2) - i).requires_grad_(True)
    z = coll.reduce_scatter_grad(u, mesh, "data", dim=0)
    v = torch.arange(float(z.numel())).reshape(z.shape) + i
    (z * v).sum().backward()
    return {"gathered": y.detach(), "x_grad": x.grad, "scattered":
            z.detach(), "u_grad": u.grad}


def bank_pieces(bank) -> dict:
    """``{path: shape}`` of a rank's bank: a ``PreparedTensor``'s fields
    as ``path/field``, fp leaves by their path."""
    from repro_torch.core import prepared

    out = {}
    for path, leaf in prepared.flatten_with_path(bank):
        key = "/".join(path)
        if isinstance(leaf, prepared.PreparedTensor):
            for f in prepared.FIELDS:
                out[f"{key}/{f}"] = tuple(getattr(leaf, f).shape)
        else:
            out[key] = tuple(leaf.shape)
    return out


def bank_bytes(bank) -> int:
    """The bytes this rank holds of a bank."""
    from repro_torch.core import prepared

    total = 0
    for leaf in prepared.tree_leaves(bank):
        ts = ([getattr(leaf, f) for f in prepared.FIELDS]
              if isinstance(leaf, prepared.PreparedTensor) else [leaf])
        total += sum(t.numel() * t.element_size() for t in ts)
    return total


def serve_rank(mesh, job):
    """Per (execution, model, ``cfg.fsdp``): ``Program.build`` on the
    rank's mesh, a prefill of ``job["tokens"]``, ``job["decode"]`` greedy
    decode steps, ``Program.loss`` of the tokens, the bank's pieces, bytes
    and checksum error."""
    torch.set_num_threads(1)
    toks = torch.as_tensor(job["tokens"]).long()
    B, S = toks.shape
    out = {}
    for execution in job["executions"]:
        for name, (tc, flat) in job["models"].items():
            whole = bridge.params_from_flat(flat, device="cpu")
            for fsdp in (False, True):
                cfg = dataclasses.replace(tc, fsdp=fsdp)
                prog = api.Program.build(cfg, whole, execution=execution,
                                         mesh=mesh)
                logits, caches = prog.prefill({"tokens": toks},
                                              S + job["decode"])
                steps = [logits]
                for i in range(job["decode"]):
                    tok = torch.argmax(steps[-1], dim=-1)[:, None]
                    lg, caches = prog.decode(tok, caches, S + i)
                    steps.append(lg)
                ce, aux = prog.loss({"tokens": toks})
                out[(execution, name, fsdp)] = {
                    "logits": steps, "ce": float(ce), "aux": float(aux),
                    "pieces": bank_pieces(prog.bank),
                    "bytes": bank_bytes(prog.bank),
                    "verify": prog.verify_banks()}
    return out


def run_rank(mesh, job):
    """``launch.train.run(..., mesh=mesh)`` on the CPU: ``job["steps"]``
    steps from seeded weights into ``job["dir"]`` (a run that finds a
    checkpoint there resumes from it), then the rank's pieces gathered
    whole and the run's losses."""
    from repro_torch.launch import train as launch

    torch.set_num_threads(1)
    cfg, tcfg = job["cfg"], job["tcfg"]
    params, opt, losses = launch.run(cfg, tcfg, batch=job["batch"],
                                     seq=job["seq"], steps=job["steps"],
                                     mesh=mesh, device="cpu")
    specs = trainer.state_specs(trainer.param_specs(cfg, mesh))
    return {"losses": losses,
            "pieces": {k: tuple(v.shape) for k, v in
                       checkpoint._flatten((params, opt)).items()},
            "state": checkpoint._flatten((params, opt), specs=specs,
                                         mesh=mesh)}


def census_rank(mesh, job):
    """Per cell of ``job`` ({name: (cfg, shape)} or {name: (cfg, shape,
    act_mode)}): the collectives a real rank records running the dry-run's
    step (``dryrun.rank_step``) on seeded weights and tokens, as ``(kind,
    result bytes)`` pairs."""
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import collectives as coll

    torch.set_num_threads(1)
    out = {}
    for name, (cfg, shape, *mode) in job.items():
        params = tfm.init_model(cfg, seed=0, device="cpu")
        B = shape.global_batch
        S = 1 if shape.kind == "decode" else shape.seq_len
        g = torch.Generator().manual_seed(1)
        batch = {"tokens": torch.randint(1, cfg.vocab_size, (B, S),
                                         generator=g, dtype=torch.int32)}
        run, _ = dryrun.rank_step(cfg, shape, mesh, params=params,
                                  batch=batch,
                                  act_mode=mode[0] if mode else "replicated")
        with coll.recording() as rec:
            run()
        out[name] = rec
    return out


def tp_attention_rank(mesh, job):
    """The tensor-parallel attention checks of
    ``tests/test_torch_tp_attention.py`` on one rank: per Program of
    ``job["programs"]`` ({name: (cfg, params, execution)}) the sequence-
    split gate's steps (``shardcheck.seq_steps``) at each of
    ``shardcheck.SEQ_CASES`` and the shapes of the caches a prefill makes;
    the Megatron pairing's dots against the unpaired ones on
    ``job["pairing"]``'s Program; ``job["drain"]`` ({name: requests}) drained
    by a ``ContinuousScheduler``; and the collectives of ``job["cells"]``
    (:func:`census_rank`)."""
    from repro_torch.core import backend as backend_lib
    from repro_torch.core.sharing import tree_index
    from repro_torch.launch import shardcheck as sc
    from repro_torch.models import attention, layers
    from repro_torch.serve.batcher import Request
    from repro_torch.serve.scheduler import ContinuousScheduler

    torch.set_num_threads(1)
    out = {"programs": {}, "drain": {}}
    progs = {}
    for name, (cfg, params, execution) in job["programs"].items():
        prog = api.Program.build(cfg, params, execution=execution, mesh=mesh)
        progs[name] = prog
        steps = {}
        for B, L in sc.SEQ_CASES:
            steps[(B, L)] = sc.seq_steps(prog, cfg, B, L)
            _, caches = prog.prefill(
                {"tokens": sc.small_inputs(cfg)[:B, :sc.SEQ_PROMPT]}, L)
            steps[(B, L)]["shapes"] = {
                (seg, layer, leaf): tuple(t.shape)
                for seg, group in caches.items()
                for layer, leaves in group.items()
                for leaf, t in leaves.items()}
        out["programs"][name] = steps
    if job.get("pairing"):
        prog = progs[job["pairing"]]
        bk = prog.backend

        class Unpaired(type(bk)):
            def pairs(self, n, w=None):
                return False

        unpaired = Unpaired(**{f.name: getattr(bk, f.name)
                               for f in dataclasses.fields(bk)})
        g = torch.Generator().manual_seed(5)
        d = prog.cfg.d_model
        x = torch.randn((4, 3, d), generator=g)
        p = tree_index(prog.bank["segments"]["main"], 0)["l0"]

        def piece(t):
            return backend_lib._piece(t, -1, mesh)

        eq = {}
        for leaf in ("wq", "wk", "wv"):
            w = p["mixer"][leaf]
            for transpose in (False, True):
                if transpose and w.shape[0] != w.shape[1]:
                    continue
                whole = bk.dot(x, w, transpose=transpose)
                local = bk.dot(x, w, transpose=transpose, local_out=True)
                eq[(leaf, transpose)] = bool(torch.equal(local, piece(whole)))
        raw = torch.randn((d, 2 * d), generator=g) / d ** 0.5
        whole = bk.dot(x, raw, activation="silu")
        eq[("in-step", False)] = bool(torch.equal(
            bk.dot(x, raw, activation="silu", local_out=True), piece(whole)))
        wo = p["mixer"]["wo"]
        o = torch.randn((4, 3, wo.shape[0]), generator=g)
        eq[("wo", False)] = bool(torch.equal(
            bk.dot(piece(o), wo, tp_hint="row", local_in=True),
            bk.dot(o, wo, tp_hint="row")))
        for transpose in (False, True):
            eq[("mlp", transpose)] = bool(torch.equal(
                layers.apply_mlp(p["ffn"], x, transpose=transpose,
                                 backend=bk),
                layers.apply_mlp(p["ffn"], x, transpose=transpose,
                                 backend=unpaired)))
        heads = api._with_kv(bk, prog.cfg, 4, 14)
        y_local, _ = attention.gqa_forward(p["mixer"], prog.cfg, x,
                                           backend=heads)
        y_whole, _ = attention.gqa_forward(p["mixer"], prog.cfg, x,
                                           backend=bk)
        out["pairing"] = {"bit_equal": eq, "heads": heads.kv.heads,
                          "attention": (y_local, y_whole)}
    for name, requests in job.get("drain", {}).items():
        sched = ContinuousScheduler(progs[name], capacity=4, max_len=24)
        for rid, prompt, max_new in requests:
            sched.submit(Request(rid=rid, prompt=prompt, max_new=max_new))
        out["drain"][name] = {c.rid: c.tokens.tolist()
                              for c in sched.drain()}
    if job.get("cells"):
        out["census"] = census_rank(mesh, job["cells"])
    return out


def leaf_tree(caches) -> dict:
    """``{(segment, layer, leaf): tensor}`` of a cache tree."""
    return {(seg, layer, leaf): t for seg, group in caches.items()
            for layer, leaves in group.items() for leaf, t in leaves.items()}


def ssm_mla_steps(prog, cfg, B: int, L: int, chunk=None) -> dict:
    """The SSM / MLA gates' steps on ``prog``: a prefill of the first
    ``shardcheck.SEQ_PROMPT`` tokens of ``B`` rows of the shardcheck inputs
    into ``L``-position caches (in chunks of ``chunk`` when given), decode
    steps at the positions after it on the inputs' next tokens, then one
    at per-row positions.  Returns the logits of every step, the shapes of
    the prefill's cache leaves and the leaves themselves (copies)."""
    from repro_torch.launch import shardcheck as sc

    toks = sc.small_inputs(cfg)[:B]
    S = toks.shape[1]
    batch = {"tokens": toks[:, :sc.SEQ_PROMPT]}
    if chunk is None:
        logits, caches = prog.prefill(batch, L)
    else:
        logits, caches = prog.prefill_chunked(batch, L, chunk)
    pieces = {k: t.clone() for k, t in leaf_tree(caches).items()}
    out = [logits]
    for pos in range(sc.SEQ_PROMPT, S):
        lg, caches = prog.decode(toks[:, pos:pos + 1], caches, pos)
        out.append(lg)
    lg, caches = prog.decode(toks[:, -1:], caches,
                             S - torch.arange(B))
    out.append(lg)
    return {"logits": out, "pieces": pieces,
            "shapes": {k: tuple(t.shape) for k, t in pieces.items()}}


def tp_ssm_mla_rank(mesh, job):
    """The SSM and MLA checks of ``tests/test_torch_tp_ssm_mla.py`` on one
    rank: per Program of ``job["programs"]`` ({name: (cfg, params,
    execution)}) :func:`ssm_mla_steps` at each (rows, cache length) of
    ``job["cases"]`` (``job["chunked"]``: names whose prefill also runs in
    chunks of 4), a decode step given whole caches on each Program of
    ``job["refuse"]`` (the error it raises, or None), ``job["drain"]``
    ({name: requests}) drained by a ``ContinuousScheduler`` and the
    collectives of ``job["cells"]`` (:func:`census_rank`)."""
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.batcher import Request
    from repro_torch.serve.scheduler import ContinuousScheduler

    torch.set_num_threads(1)
    out = {"programs": {}, "drain": {}}
    progs = {}
    for name, (cfg, params, execution) in job["programs"].items():
        prog = api.Program.build(cfg, params, execution=execution, mesh=mesh)
        progs[name] = prog
        steps = {case: ssm_mla_steps(prog, cfg, *case)
                 for case in job["cases"]}
        if name in job.get("chunked", ()):
            for B, L in job["cases"]:
                steps[("chunked", B, L)] = ssm_mla_steps(prog, cfg, B, L,
                                                         chunk=4)
        out["programs"][name] = steps
    out["refused"] = {}
    for name in job.get("refuse", ()):
        # caches made whole (no mesh) on a rank whose pieces are cut
        prog = progs[name]
        whole = tfm.init_caches(prog.cfg, 4, 16, dtype=torch.float32,
                                device="cpu")
        try:
            prog.decode(torch.ones((4, 1), dtype=torch.long), whole, 5)
            out["refused"][name] = None
        except ValueError as e:
            out["refused"][name] = str(e)
    for name, requests in job.get("drain", {}).items():
        sched = ContinuousScheduler(progs[name], capacity=4, max_len=24)
        for rid, prompt, max_new in requests:
            sched.submit(Request(rid=rid, prompt=prompt, max_new=max_new))
        out["drain"][name] = {c.rid: c.tokens.tolist()
                              for c in sched.drain()}
    if job.get("cells"):
        out["census"] = census_rank(mesh, job["cells"])
    return out


def prefill_rank(mesh, job):
    """Per model of ``job["models"]`` ({name: (cfg, flat params)}) and per
    execution of ``job["executions"]``: ``api.prefill_step_fn`` of
    ``job["tokens"]`` under the serving spec ("replicated") and the "seq"
    and "hidden" specs (``api._act_pspec_of``): the last logits, the
    rank's caches and the collectives recorded (the rank's rows), then
    one decode step from those caches under the same spec (its residual
    whole), fed the prompts' last tokens."""
    from repro_torch.core import backend as backend_lib
    from repro_torch.sharding import collectives as coll

    torch.set_num_threads(1)
    toks = torch.as_tensor(job["tokens"]).long()
    B, S = toks.shape
    out = {"coords": mesh.coords}
    for name, (cfg, flat) in job["models"].items():
        params = bridge.params_from_flat(flat, device="cpu")
        for execution in job["executions"]:
            bk = dataclasses.replace(backend_lib.resolve(execution),
                                     mesh=mesh)
            for mode in ("replicated", "seq", "hidden"):
                ap = (api._serve_act_pspec(bk, B) if mode == "replicated"
                      else api._act_pspec_of(bk, B, mode))
                fn = api.prefill_step_fn(cfg, S + 1, act_pspec=ap,
                                         execution=bk)
                with coll.recording() as rec:
                    logits, caches = fn(params, {"tokens": toks})
                kept = {k: v.clone() for k, v in leaf_tree(caches).items()}
                dec = api.decode_step_fn(cfg, act_pspec=ap, execution=bk)
                step, _ = dec(params, {"tokens": toks[:, -1:]}, caches, S)
                out[(name, execution, mode)] = {
                    "logits": logits, "decode": step,
                    "caches": kept, "collectives": rec}
    return out
