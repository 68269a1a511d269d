"""Compiled decode steps: the counterpart of the reference's jit cells
``_decode_cells`` (``repro.api``), as CUDA graphs.

A :class:`DecodeCell` belongs to one cache tree of B rows and the Program
that decodes into it.  It owns static inputs on the device, the tokens
(B, 1) and the per-row positions (B,) int64, and after its capture one
static output, the logits (B, V).  Its first step runs eagerly on those
buffers (the warm-up: every lazily built device index, library and
workspace of the step exists after it), then captures the same
``transformer.forward(..., mode="decode")`` into a ``torch.cuda.graph`` on
a side stream; every later step copies its inputs into the static buffers
and replays the graph.  The graph holds the raw addresses of the cache
leaves, the banks and the kernels' shared workspaces, so a cell must not
outlive its caches, and replays and eager calls share one stream (stream
order keeps the split-K workspaces consistent).  A vlm or audio model's
cross-attention K/V, written by its prefill, are read by the step and
never written (``core/sharing.py`` skips them).  Sampling runs after the
replay, outside the graph, with the caller's ``torch.Generator``.

A replay runs no kernel wrapper, so it counts no launch: the capture's
difference of the launch counters is taken back and added on each replay
(``kernels/counts.py``), and the counts equal the eager steps'.

Where the cell does not capture (:func:`eager_reason`), the same
static-buffer code runs ``forward`` eagerly on every step: on a CPU device,
by rule for a Program whose backend has the fault model on, because
``core/noise.py`` reseeds a host ``torch.Generator`` at every DAC draw and
``Program.update_noise`` swaps the noise config between steps (the same
kernels run on the card either way), and by :data:`MESH_RULE` for a
Program on an active mesh, whose ``decode`` steps its rows eagerly and
never through a cell.  On a CUDA device a capture that
fails raises; there is no silent return to eager dispatch.

``CAPTURE_COUNTS["decode"]`` counts captures, as the reference's
``TRACE_COUNTS`` counts traces; it mirrors into the metrics registry as
``compile.capture.decode``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import counts
from repro_torch.obs.metrics import CounterGroup

CAPTURE_COUNTS: CounterGroup = CounterGroup("compile.capture")

NOISE_RULE = ("the fault model is not captured: core/noise.py reseeds a "
              "host torch.Generator at every DAC draw and "
              "Program.update_noise swaps the noise config between steps")


MESH_RULE = ("a decode step on an active mesh is not captured: its "
             "collectives run over gloo (ranks sharing a card), which a CUDA "
             "graph cannot hold; Program steps it eagerly on the rank's rows "
             "(a 1x1 mesh keeps its graph)")


def eager_reason(program) -> Optional[str]:
    """Why ``program``'s decode step runs eagerly, or None when a cell
    captures it."""
    if program.device.type != "cuda":
        return "CPU device: no CUDA graphs, the cell runs eagerly"
    if program.backend.mesh_active:
        return MESH_RULE
    if program.backend.noise_active:
        return NOISE_RULE
    return None


def _cuda_graph(fn, *args):
    """Capture ``fn(*args)`` into a CUDA graph (on ``torch.cuda.graph``'s
    side stream), with synchronizing calls made errors inside it.  Returns
    (graph, fn's output)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    return graph, out


def _batch(caches) -> int:
    """B of a cache tree (leaves [R, T, B, ...])."""
    while isinstance(caches, dict):
        caches = next(iter(caches.values()))
    return caches.shape[2]


class DecodeCell:
    """One captured decode step over ``caches`` (see the module
    docstring)."""

    def __init__(self, program, caches):
        self.program = program
        self.caches = caches
        self.batch = B = _batch(caches)
        dev = program.device
        self.tokens = torch.zeros((B, 1), dtype=torch.long, device=dev)
        self.pos = torch.zeros((B,), dtype=torch.long, device=dev)
        # host staging in pinned memory: the copies to the device do not
        # make the host wait; the event guards a staging buffer's reuse
        pin = dev.type == "cuda"
        self._host_tokens = torch.zeros((B, 1), dtype=torch.long,
                                        pin_memory=pin)
        self._host_pos = torch.zeros((B,), dtype=torch.long, pin_memory=pin)
        self._staged = torch.cuda.Event() if pin else None
        self._staged_pending = False
        self.graph = self.logits = self.delta = self.backend = None

    @property
    def reason(self) -> Optional[str]:
        """Why this cell runs eagerly (None: it captures)."""
        return eager_reason(self.program)

    def release(self) -> None:
        """Drop the graph and its static output (its memory pool)."""
        self.graph = self.logits = self.delta = self.backend = None

    # ------------------------------------------------------------ inputs
    def _stage(self, values) -> None:
        """Copy (tokens, pos) into the static inputs: a tensor on the
        cell's device as it is (in stream order); any host value through
        the cell's own pinned staging buffers, which are refilled only once
        their last copy has been read (a scalar ``pos`` fills every
        row)."""
        host = []
        for dst, staging, v in ((self.tokens, self._host_tokens, values[0]),
                                (self.pos, self._host_pos, values[1])):
            if (isinstance(v, torch.Tensor) and dst.device.type != "cpu"
                    and v.device == dst.device):
                dst.copy_(v.reshape(dst.shape), non_blocking=True)
            else:
                host.append((dst, staging, v))
        if not host:
            return
        if self._staged_pending:
            self._staged.synchronize()      # the last copy read them
        for dst, staging, v in host:
            if isinstance(v, torch.Tensor):
                v = v.numpy()
            staging.numpy()[...] = np.broadcast_to(np.asarray(v),
                                                   staging.shape)
            dst.copy_(staging, non_blocking=True)
        if self._staged is not None:
            self._staged.record()
            self._staged_pending = True

    # -------------------------------------------------------------- step
    def _forward(self, backend):
        return self.program._decode_forward(backend, self.tokens, self.caches,
                                           self.pos)

    def _capture(self, backend) -> None:
        before = counts.snapshot()
        try:
            self.graph, self.logits = _cuda_graph(self._forward, backend)
            self.delta = counts.difference(before, counts.snapshot())
        finally:
            # the capture recorded the launches; it ran none of them
            counts.restore(before)
        self.backend = backend
        CAPTURE_COUNTS["decode"] += 1

    @torch.no_grad()
    def step(self, tokens, pos) -> torch.Tensor:
        """Decode one token for every row: tokens (B, 1), pos an int or
        (B,) positions.  The caches are updated in place.  Returns the
        logits (B, V); after a capture they are the cell's static output,
        overwritten by its next step."""
        self._stage((tokens, pos))
        backend = self.program.backend
        if self.graph is not None:
            if backend is self.backend:
                self.graph.replay()
                counts.add(self.delta)
                return self.logits
            self.release()        # update_noise: recapture under the new one
        logits = self._forward(backend)
        if self.reason is None:
            self._capture(backend)
        return logits
