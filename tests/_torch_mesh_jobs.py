"""What the gloo ranks of ``tests/test_torch_train_mesh.py`` and
``tests/test_torch_fsdp.py`` run (``launch.mesh.init_ranks`` imports a
rank's function in each child process).  This module imports the port
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


def train_rank(mesh, job, B, S, steps, tcfg, mbs):
    """Per model of ``job`` ({name: (cfg, flat params)}) and per
    ``cfg.fsdp``: the rank's param pieces' shapes, ``loss_and_grads`` of
    the first batch (the gradients gathered whole), then ``steps`` steps
    with each microbatch count of ``mbs`` (one step without microbatches):
    metrics, the params and moments gathered whole."""
    torch.set_num_threads(1)
    apspec = partition.act_pspec(mesh)
    out = {"collectives": grad_collectives(mesh), "coords": mesh.coords}
    for name, (tc, flat) in job.items():
        whole = bridge.params_from_flat(flat, device="cpu")
        data = tensors(batches(tc.vocab_size, B, S, steps))
        for fsdp in (False, True):
            cfg = dataclasses.replace(tc, fsdp=fsdp)
            specs = trainer.param_specs(cfg, mesh)
            params = partition.local_tree(whole, specs, mesh)
            r = {"pieces": {k: tuple(v.shape) for k, v in
                            checkpoint._flatten(params).items()}}
            loss, ce, aux, g = trainer.loss_and_grads(
                params, cfg, data[0], remat=True, mesh=mesh,
                act_pspec=apspec)
            r["loss_and_grads"] = (float(loss), float(ce), float(aux),
                                   np_tree(partition.gather_tree(
                                       g, specs, mesh)))
            for mb in mbs:
                step = trainer.make_train_step(
                    cfg, TrainConfig(**tcfg, microbatch=mb),
                    act_pspec=apspec, mesh=mesh)
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
            out[(name, fsdp)] = r
    return out




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
    """Per cell of ``job`` ({name: (cfg, shape)}): the collectives a real
    rank records running the dry-run's step (``dryrun.rank_step``) on
    seeded weights and tokens, as ``(kind, result bytes)`` pairs."""
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import collectives as coll

    torch.set_num_threads(1)
    out = {}
    for name, (cfg, shape) in job.items():
        params = tfm.init_model(cfg, seed=0, device="cpu")
        B = shape.global_batch
        S = 1 if shape.kind == "decode" else shape.seq_len
        g = torch.Generator().manual_seed(1)
        batch = {"tokens": torch.randint(1, cfg.vocab_size, (B, S),
                                         generator=g, dtype=torch.int32)}
        run, _ = dryrun.rank_step(cfg, shape, mesh, params=params,
                                  batch=batch)
        with coll.recording() as rec:
            run()
        out[name] = rec
    return out
