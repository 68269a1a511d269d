"""What the gloo ranks of ``tests/test_torch_train_ep.py`` run
(``launch.mesh.init_ranks`` imports a rank's function in each child
process).  This module imports the port only, so a rank starts without
JAX; the test file holds its results against the reference."""
import contextlib
import dataclasses

import torch

from repro_torch import bridge
from repro_torch.sharding import collectives as coll
from repro_torch.sharding import partition

import _torch_mesh_jobs as mesh_jobs


@contextlib.contextmanager
def model_gathers(sink: list):
    """Record the result shape of every all-gather over "model" alone
    while the context is open (``collectives.all_gather``, which every
    differentiable gather calls)."""
    real = coll.all_gather

    def spy(x, mesh, axes, dim=-1):
        out = real(x, mesh, axes, dim=dim)
        if coll._axes(axes) == ("model",) and mesh.axis_size(axes) > 1:
            sink.append(tuple(out.shape))
        return out

    coll.all_gather = spy
    try:
        yield sink
    finally:
        coll.all_gather = real


def train_ep_rank(mesh, job, B, S, tcfg, mbs, fsdps):
    """Per model of ``job`` ({name: (cfg, flat params, steps)}) and per
    ``cfg.fsdp`` of ``fsdps``, in the reference's train layout
    (``partition.act_pspec(mesh)``, "seq"): the first batch's loss, CE,
    aux and gradients gathered whole, with the shapes every all-gather over
    "model" returned in that step; then ``steps`` steps with each
    microbatch count of ``mbs``: metrics, the params and moments gathered
    whole, and the step count (``_torch_mesh_jobs._train_one``'s
    layout)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.optim import adamw
    from repro_torch.train import trainer

    torch.set_num_threads(1)
    out = {}
    for name, (tc, flat, steps) in job.items():
        whole = bridge.params_from_flat(flat, device="cpu")
        data = mesh_jobs.tensors(mesh_jobs.batches(tc.vocab_size, B, S,
                                                   steps))
        for fsdp in fsdps:
            cfg = dataclasses.replace(tc, fsdp=fsdp)
            apspec = partition.act_pspec(mesh)
            specs = trainer.param_specs(cfg, mesh)
            params = partition.local_tree(whole, specs, mesh)
            with model_gathers([]) as shapes:
                loss, ce, aux, g = trainer.loss_and_grads(
                    params, cfg, data[0], remat=True, mesh=mesh,
                    act_pspec=apspec)
            r = {"model_gathers": shapes, "loss_and_grads": (
                float(loss), float(ce), float(aux), mesh_jobs.np_tree(
                    partition.gather_tree(g, specs, mesh)))}
            for mb in mbs:
                step = trainer.make_train_step(
                    cfg, TrainConfig(**tcfg, microbatch=mb),
                    act_pspec=apspec, mesh=mesh)
                p, o = params, adamw.init(params)
                metrics = []
                for b in data:
                    p, o, m = step(p, o, b)
                    metrics.append((float(m["loss"]), float(m["grad_norm"]),
                                    float(m["lr"])))
                r[("steps", mb)] = (metrics, *(
                    mesh_jobs.np_tree(partition.gather_tree(t, specs, mesh))
                    for t in (p, o.m, o.v)), int(o.step))
            out[(name, fsdp)] = r
    return out


def census_ssm_rank(mesh, job):
    """Per cell of ``job`` ({name: (cfg, shape)}): the collectives a real
    rank records running the dry-run's train step on seeded weights and
    tokens, and the ``ssd_chunk`` calls (plain on the CPU) with the heads
    of each call."""
    from repro_torch.kernels import ssd

    real = ssd._forward
    calls = []

    def spy(x, dA, B, C):
        calls.append(x.shape[3])
        return real(x, dA, B, C)

    ssd._forward = spy
    try:
        recs = mesh_jobs.census_rank(mesh, job)
    finally:
        ssd._forward = real
    return {"collectives": recs, "ssd_heads": calls}


def step_without_layouts(mesh, cfg, flat, B, S, tcfg):
    """One step (2 microbatches) with the expert and SSM layouts taken
    away, as before a rank ran its own experts and heads: the banks and
    SSM leaves gathered whole over "model".  Returns the shapes of the
    step's all-gathers over "model"."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.optim import adamw
    from repro_torch.train import trainer

    whole = bridge.params_from_flat(flat, device="cpu")
    specs = trainer.param_specs(cfg, mesh)
    params = partition.local_tree(whole, specs, mesh)
    data = mesh_jobs.tensors(mesh_jobs.batches(cfg.vocab_size, B, S, 1))
    step = trainer.make_train_step(cfg, TrainConfig(**tcfg, microbatch=2),
                                   act_pspec=partition.act_pspec(mesh),
                                   mesh=mesh)
    real = trainer._MeshStep.step_backend

    def whole_leaves(self, B_, S_):
        return dataclasses.replace(real(self, B_, S_), ssm=None,
                                   experts=None)

    partition._PIECE_AXES = frozenset()
    trainer._MeshStep.step_backend = whole_leaves
    with model_gathers([]) as shapes:
        step(params, adamw.init(params), data[0])
    return shapes
