"""What the gloo ranks of ``tests/test_torch_fsdp_layers.py`` run
(``launch.mesh.init_ranks`` imports a rank's function in each child
process).  Like ``_torch_mesh_jobs`` this module imports the port only.

Live gathered bytes are counted by ``sharding.fsdp.track_live``: weakref
finalizers on every tensor ``fsdp.gather_pieces`` returns, the one
function every FSDP gather goes through (the forward's and the backward's
under remat)."""
import dataclasses

import torch

from repro_torch import api
from repro_torch import bridge
from repro_torch.configs.base import TrainConfig
from repro_torch.optim import adamw
from repro_torch.sharding import fsdp
from repro_torch.sharding import partition
from repro_torch.train import trainer

import _torch_mesh_jobs as jobs


def gathered_bytes(pieces, specs, mesh, dtype=None) -> dict:
    """What the rank's FSDP gathers hold, from its pieces and their
    data-axes specs: ``block`` the most one block of a stack gathers,
    ``group`` the most one leaf group outside the stacks gathers (the
    table too: a tied head gathers it), ``whole`` every cut leaf gathered at once; float32 pieces counted in
    ``dtype`` (a train step's compute dtype) where it is given."""
    dp = partition.dp_size(mesh)

    def size(t, spec):
        if spec is None or not partition.cuts(spec):
            return 0
        dt = dtype if dtype is not None and t.dtype == torch.float32 \
            else t.dtype
        return t.numel() * dp * torch.empty((), dtype=dt).element_size()

    def total(tree, spec):
        if isinstance(tree, dict):
            return sum(total(tree[k], spec[k]) for k in tree)
        return size(tree, spec)

    block = 0
    for name, seg in pieces["segments"].items():
        R = next(t for t in _leaves(seg)).shape[0]
        block = max(block, total(seg, specs["segments"][name]) // R)
    groups = [total(pieces[k], specs[k]) for k in pieces
              if k != "segments"]
    whole = total(pieces, specs)
    return {"block": block, "group": max(groups), "whole": whole}


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def train_layers_rank(mesh, job, B, S, steps, tcfg, mbs):
    """Per model of ``job`` ({name: (cfg, flat params)}), with
    ``cfg.fsdp``: each microbatch count of ``mbs`` (one step without
    microbatches, ``steps`` with): per step the FSDP collectives and the most gathered bytes alive; the metrics, params and
    moments gathered whole after the steps; the planned collectives a
    microbatch and the rank's gathered-bytes bounds
    (:func:`gathered_bytes`)."""
    torch.set_num_threads(1)
    live = fsdp.track_live()
    out = {}
    for name, (tc, flat) in job.items():
        cfg = dataclasses.replace(tc, fsdp=True)
        whole = bridge.params_from_flat(flat, device="cpu")
        data = jobs.tensors(jobs.batches(cfg.vocab_size, B, S, steps))
        specs = trainer.param_specs(cfg, mesh)
        dspecs = partition.data_specs(specs, mesh)
        params = partition.local_tree(whole, specs, mesh)
        r = {"bytes": gathered_bytes(params, dspecs, mesh,
                                     torch.bfloat16 if cfg.compute_dtype
                                     == "bfloat16" else torch.float32)}
        for mb in mbs:
            r[("planned", mb)] = fsdp.planned(cfg, dspecs)
            step = trainer.make_train_step(
                cfg, TrainConfig(**tcfg, microbatch=mb),
                act_pspec=partition.act_pspec(mesh), mesh=mesh)
            p, o = params, adamw.init(params)
            metrics, per_step = [], []
            for b in data[:steps if mb else 1]:
                fsdp.reset_counts()
                fsdp.reset_live()
                p, o, m = step(p, o, b)
                per_step.append((fsdp.snapshot(), dict(live)))
                metrics.append((float(m["loss"]), float(m["grad_norm"]),
                                float(m["lr"])))
            r[("steps", mb)] = (
                metrics, jobs.np_tree(partition.gather_tree(p, specs, mesh)),
                jobs.np_tree(partition.gather_tree(o.m, specs, mesh)),
                jobs.np_tree(partition.gather_tree(o.v, specs, mesh)),
                int(o.step))
            r[("collectives", mb)] = per_step
        out[name] = r
    return out


def serve_layers_rank(mesh, job):
    """Per model of ``job["models"]``: an xla ``Program`` built on the
    rank's mesh with and without ``cfg.fsdp``, a prefill of
    ``job["tokens"]`` and ``job["decode"]`` greedy decode steps: the
    logits, and for the FSDP build the FSDP collectives, the most gathered
    bytes alive and the bounds of :func:`gathered_bytes` over its bank."""
    torch.set_num_threads(1)
    live = fsdp.track_live()
    toks = torch.as_tensor(job["tokens"]).long()
    B, S = toks.shape
    out = {}
    for name, (tc, flat) in job["models"].items():
        whole = bridge.params_from_flat(flat, device="cpu")
        for on in (False, True):
            cfg = dataclasses.replace(tc, fsdp=on)
            prog = api.Program.build(cfg, whole, execution="xla", mesh=mesh)
            fsdp.reset_counts()
            fsdp.reset_live()
            logits, caches = prog.prefill({"tokens": toks},
                                          S + job["decode"])
            steps = [logits]
            for i in range(job["decode"]):
                tok = torch.argmax(steps[-1], dim=-1)[:, None]
                lg, caches = prog.decode(tok, caches, S + i)
                steps.append(lg)
            r = {"logits": steps, "counts": fsdp.snapshot(),
                 "live": dict(live)}
            if on:
                r["bytes"] = gathered_bytes(prog.bank,
                                            prog.backend.fsdp.specs, mesh)
            out[(name, on)] = r
    return out
