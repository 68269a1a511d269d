"""Execution backends — the seam between the model stack and the compute
substrate (partial port of ``repro.core.backend``).

Every weight matmul in ``models/*`` goes through ``Backend.dot``; the
PRM-blended MoE experts' stacked streams go through ``Backend.reuse_dot``;
the OBU activation shuffle in ``core/sharing.py`` goes through
``Backend.shuffle``; sequence attention goes through ``Backend.attention``.

  * ``"xla"`` (name kept from the reference) — plain torch matmuls with
    float32 accumulation (``obu.blend_dot``) and the einsum attention.
  * ``"photonic"`` — every matmul runs a W8A8 MVM kernel against a
    prepared bank (or the fp weight quantized in-step):
      - ``fused=True`` (default): the fused kernel
        (``kernels/photonic_mvm.photonic_mvm_fused``: A8 quantization in
        the prologue, the blend epilogue in the kernel);
      - ``fused=False``: the split comparator — the A8 pass, the split MVM
        kernel (``photonic_mvm`` / ``photonic_mvm_t``) with a float32
        output cast to the activation dtype, then the unfused epilogue
        (the blend kernel for blocked shuffles, torch ops otherwise).  Same
        numbers as the fused path with noise off;
      - an enabled ``noise`` (``core/noise.NoiseConfig``) reroutes every
        matmul through the split pipeline with the fault model applied to
        the raw MVM output, keyed by the bank's tag.
    ``reuse_dot`` streams T activation sets through one programmed bank
    in the reuse-resident kernel (``photonic_mvm_resident``), on every
    photonic configuration; with an enabled fault model, one perturbation
    keyed by the bank's tag covers all T streams.  Blocked OBU shuffles
    run the blend kernel; long-sequence attention runs the flash kernel
    (``kernels/flash_attention.py``).

**Sharded execution** (``mesh``: a bound ``launch.mesh.Mesh`` with more
than one position).  The port runs one process per mesh position.  Outside
the dots a rank holds its data shard's rows (``rows_sharded``, set by the
Program for the steps whose batch divides over the data axes), replicated
over "model".  Inside, each photonic dot takes the reference's rule from
:func:`partition_rule` (the rules decide the float summation order):

  * ``column``: the rank's N/tp columns of the bank, the kernel's fused
    epilogue, then an all-gather over "model" (none for a pair-first dot
    asked for its ``local_out``: the Megatron pairing below);
  * ``scatter``: the rank's K/tp slice of x and of the bank, the kernel
    without epilogue, a reduce-scatter, ``_epilogue_unfused`` on the
    rank's slice, then an all-gather;
  * ``ring``: tp chunk kernels with ring hops, in the reference's order;
  * ``psum``: an all-reduce, then the whole epilogue;
  * ``replicated``: the whole weight.

**The Megatron pairing** (the reference's lazy re-join of a column dot's
output, consumed sharded by the pair-second dot): a pair-first dot called
with ``local_out=True`` (``wq``/``wk``/``wv`` of a rank attending with its
own heads; ``w_gate``/``w_up``, or the transposed reuse's swapped pair, and
gelu's ``w_up`` when ``pairs`` holds) returns the rank's N/tp block of its
output columns: under ``column`` the kernel's output as it is, under any
other rule the whole output cut to the block.  The pair-second dot, called
with ``local_in=True`` (``tp_hint="row"``), takes that block as its K/tp
input without cutting x again, and all-reduces the block's abs-max over
"model" for the A8 scale (max is exact).  Each dot's arithmetic is the
unpaired one: a column block and ``g * u`` on blocks are bit-equal to
the blocks of the gathered tensors.  The xla backend, whose dots run
whole, cuts a ``local_out`` result and all-gathers a ``local_in`` input.

The A8 scale is the unsharded one: the abs-max is all-reduced (MAX) over
the data axes when rows are split, so the A8 grid is bitwise the single
device's.  The reuse-resident MVM splits the bank's columns when N
divides and never splits the T streams.  The blocked shuffle keeps the
channel axis whole (a rank's rows are already local).  Flash is off under
an active mesh (``use_flash``), as in the reference.  A fault model on a
multi-position mesh raises.  A 1x1 mesh takes the exact unsharded path.
The xla backend runs a serving step's dots whole on the rank's rows (the
reference leaves xla to GSPMD; no rule to follow); a train step's weight
pieces (``partition.ModelPiece``: the rank's "model" piece of a matrix)
run by :func:`partition_rule` (``Backend._xla_piece_dot``), every
collective differentiable in Megatron's convention.

**The residual layout** (``residual``, a ``partition.ResidualLayout`` of a
train or prefill step whose ``act_pspec`` is "seq" or "hidden"): a
pair-second dot (``tp_hint="row"``) under a row rule rejoins its partial
sums with a reduce-scatter over the positions (its epilogue then on the
rank's block of rows) or over the channels (the ``scatter`` rule without
its final all-gather), so its output lands in the layout's block; the
blocked shuffle of a "hidden" residual runs on the channels gathered
whole.  ``models/transformer.py`` cuts and gathers the stream around the
mixers.  A bank placed on a rank
(``core/prepared.Placement``) holds its ``field_specs`` piece; a rule that
reads a field in another layout gathers it over "model" once and keeps the
piece it reads.  Under ``cfg.fsdp`` a field's "embed" dim is cut over the
data axes as well: every dot all-gathers it over them at each use (the
reference's ``shard_map`` in-spec reshard), keeps nothing, and then runs
as above; the step's float leaves so cut are gathered where the model
stack uses them (``fsdp``, a ``sharding.fsdp.Layout``: block r of a stack
before its reuses, a leaf outside the stacks at its use).

Left out: the TPU tile plans (``bm/bk/bn``, ``adaptive``: the CUDA kernels
pick their own tiles).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import noise as noise_lib
from repro_torch.core import obu
from repro_torch.core.photonic import a8_scale_from_amax
from repro_torch.core.prepared import (PreparedTensor, quantize_weight,
                                       quantize_weight_t)
from repro_torch.kernels import ops
from repro_torch.kernels.photonic_mvm import apply_activation
from repro_torch.sharding import collectives as coll
from repro_torch.sharding import partition as _partition

EXECUTIONS = ("xla", "photonic")

# How a row-parallel (K-split) matmul rejoins its partial sums (the
# reference's ``TP_COLLECTIVES``):
#   * "reduce_scatter" — each rank keeps its own output slice, runs the
#     epilogue on it, and the slices are gathered; bitwise equal to "psum"
#     (the same partial sums are added);
#   * "psum" — the full all-reduce, epilogue after it; the only row-
#     parallel form when the output slices do not divide or a blocked
#     shuffle crosses them;
#   * "ring" — tp per-chunk kernels interleaved with ring hops.
TP_COLLECTIVES = ("reduce_scatter", "psum", "ring")


def partition_rule(tp: int, K: int, N: int, *, block_perm=None,
                   tp_hint=None, collective: str = "reduce_scatter") -> str:
    """The tensor-parallel rule of a (K, N) matmul on ``tp`` "model"
    ranks (the reference's decision table, unchanged): ``"column"``,
    ``"scatter"``, ``"ring"``, ``"psum"`` or ``"replicated"``.
    ``tp_hint="row"`` marks a pair-second matmul (w_down after up/gate, wo
    after qkv): it takes a row rule whenever K divides."""
    if tp <= 1:
        return "replicated"
    if collective not in TP_COLLECTIVES:
        raise ValueError(f"unknown tp_collective {collective!r}; "
                         f"have {TP_COLLECTIVES}")

    def row_rule():
        # scatter/ring need the output slices to divide and the epilogue
        # to be slice-local (a blocked shuffle crosses slices)
        if collective == "psum" or N % tp != 0 or block_perm is not None:
            return "psum"
        return "ring" if collective == "ring" else "scatter"

    row_ok = K % tp == 0
    if tp_hint == "row" and row_ok:
        return row_rule()
    if N % tp == 0 and block_perm is None:
        return "column"
    if row_ok:
        return row_rule()
    return "replicated"


def bank_field(prep, name: str, dim, mesh, cache: bool = True):
    """Field ``name`` of bank ``prep`` as a dot reads it on this rank:
    ``dim`` (-1 or -2) split over "model" into the rank's piece, or whole
    (``dim=None``).  A field cut over the data axes too (``cfg.fsdp``) is
    first all-gathered over them, at each use and never kept (a kept copy
    would undo what FSDP saves).  A piece the rank then holds is returned
    as it is; any other layout is gathered over "model", cut, and kept in
    the bank's placement cache (``cache=False``, or a field cut over the
    data axes: not kept)."""
    held = getattr(prep, name)
    pl = prep.placement
    ddim = pl.data_dim(name) if pl is not None else None
    if ddim is not None:
        held = coll.all_gather(held, mesh, _partition.data_axes(mesh),
                               dim=ddim)
        cache = False
    hdim = pl.model_dim(name) if pl is not None else None
    if hdim == dim:
        return held
    key = pl.key(name, dim) if pl is not None and cache else None
    if key is not None and key in pl.cache:
        return pl.cache[key]
    whole = held if hdim is None else coll.all_gather(held, mesh, "model",
                                                       dim=hdim)
    out = whole if dim is None else _piece(whole, dim, mesh).contiguous()
    if key is not None:
        pl.cache[key] = out
    return out


def _piece(t, dim: int, mesh):
    """This rank's block of ``t`` along ``dim`` over "model"."""
    tp = mesh.axis_size("model")
    n = t.shape[dim] // tp
    return t.narrow(dim, mesh.index("model") * n, n)


def _epilogue_unfused(y, bias, block_perm, block, activation):
    """The split blend epilogue: the blend kernel for blocked shuffles,
    torch ops for bias/activation-only epilogues."""
    if block_perm is not None:
        return ops.blend_shuffle(y, bias, block_perm, block=block,
                                 activation=activation or "none")
    if bias is not None:
        y = y + bias.to(y.dtype)
    return apply_activation(y, activation)


def _epilogue_xla(y, bias, block_perm, block, activation):
    """Reference epilogue on the xla backend (gather + torch ops)."""
    if block_perm is not None:
        perm = np.asarray(block_perm)
        C = y.shape[-1]
        if block <= 0 or C % block != 0 or perm.shape[0] * block != C:
            raise ValueError(f"blocked shuffle needs C % block == 0 and a "
                             f"full permutation, got C={C} block={block}")
        idx = (perm[:, None] * block + np.arange(block)[None, :]).reshape(-1)
        y = y.index_select(-1, obu.device_index(idx.astype(np.int64).tobytes(),
                                                str(y.device)))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return apply_activation(y, activation)


@dataclasses.dataclass(frozen=True)
class Backend:
    """Static description of the matmul substrate."""

    execution: str = "xla"
    fused: bool = True                # the fused kernel vs the split
                                      # quantize/MVM/blend pipeline
    noise: Any = None                 # core.noise.NoiseConfig | None — the
                                      # opt-in photonic fault model; None /
                                      # all-zero is the clean path
    flash: bool = True                # long photonic attention -> flash
    flash_min_seq: int = 512          # query lengths below this take the
                                      # einsum path
    mesh: Any = None                  # launch.mesh.Mesh | None: with more
                                      # than one position, dots run sharded
    tp_collective: str = "reduce_scatter"
                                      # row-parallel rejoin (TP_COLLECTIVES)
    rows_sharded: bool = False        # the step's rows are this rank's data
                                      # shard (set per step by the Program)
    kv: Any = None                    # partition.KVLayout of a serving
                                      # step's caches on an active mesh (set
                                      # per step by the Program): where a
                                      # rank's attention heads or positions
                                      # lie
    ssm: Any = None                   # partition.SSMLayout of the same
                                      # step: a rank's SSM heads and conv
                                      # channels
    residual: Any = None              # partition.ResidualLayout of a step
                                      # whose residual is cut over "model"
                                      # ("seq" / "hidden"), else None
    experts: Any = None               # partition.ExpertLayout of a train
                                      # step whose expert banks are the
                                      # rank's experts, else None
    fsdp: Any = None                  # sharding.fsdp.Layout of a step whose
                                      # params are cfg.fsdp pieces: where
                                      # the model stack gathers them (each
                                      # block where it runs), else None

    def __post_init__(self):
        if self.execution not in EXECUTIONS:
            raise ValueError(f"unknown execution backend "
                             f"{self.execution!r}; have {EXECUTIONS}")
        if self.tp_collective not in TP_COLLECTIVES:
            raise ValueError(f"unknown tp_collective "
                             f"{self.tp_collective!r}; have {TP_COLLECTIVES}")
        if self.noise_active and self.mesh_active:
            # the fault model perturbs the full output-channel axis; a rank
            # sees a slice and its per-tile random streams would diverge
            # from the single-device pattern (Program.build's and
            # update_noise's replace() re-run this)
            raise NotImplementedError(
                "NoiseConfig injection is single-device only; drop the "
                "noise or the multi-device mesh")

    @property
    def is_photonic(self) -> bool:
        return self.execution == "photonic"

    @property
    def noise_active(self) -> bool:
        """True when the fault model actually perturbs: photonic execution
        AND an enabled config.  Always False on xla."""
        return (self.is_photonic and self.noise is not None
                and self.noise.enabled)

    @property
    def mesh_active(self) -> bool:
        """True when dots run sharded: a mesh of more than one position.
        A 1x1 mesh takes the exact unsharded path."""
        return self.mesh is not None and self.mesh.size > 1

    @property
    def tp(self) -> int:
        """"model" ranks of an active mesh (1 off-mesh)."""
        return self.mesh.axis_size("model") if self.mesh_active else 1

    def pairs(self, n: int, w=None) -> bool:
        """Whether a pair-first dot of ``n`` output channels keeps its
        output local (the Megatron pairing): an active mesh whose "model"
        axis divides ``n``, on the photonic backend or for a train step's
        weight piece (``w`` a ``partition.ModelPiece``: its xla dots run
        tensor-parallel)."""
        tp_dots = self.is_photonic or isinstance(w, _partition.ModelPiece)
        return tp_dots and self.tp > 1 and n % self.tp == 0

    def _residual(self, tp_hint, y):
        """The active residual layout a pair-second dot's partial sums
        ``y`` rejoin into (a reduce-scatter over its positions or channels
        in place of the whole rejoin), else None."""
        lay = self.residual
        if tp_hint != "row" or lay is None or not lay.active:
            return None
        if y.ndim != 3 or y.shape[1] != lay.length \
                or y.shape[-1] != lay.width:
            return None
        return lay

    def _local_in(self, x, local_in: bool):
        """``x`` whole: a ``local_in`` block all-gathered over "model"."""
        if local_in and self.tp > 1:
            return coll.all_gather(x, self.mesh, "model", dim=-1)
        return x

    def _local_out(self, y, local_out: bool):
        """``y`` as the caller asked for it: the rank's block of its last
        dim when ``local_out``."""
        if local_out and self.tp > 1:
            return _piece(y, -1, self.mesh).contiguous()
        return y

    def whole_rows(self) -> "Backend":
        """This backend for rows gathered whole over the data axes."""
        if not self.rows_sharded:
            return self
        return dataclasses.replace(self, rows_sharded=False)

    # ----------------------------------------------------------- attention
    def use_flash(self, q_len: int) -> bool:
        """Photonic execution only, at or above ``flash_min_seq`` rows, and
        not under an active mesh (the reference keeps the einsum path
        there: GSPMD partitions it, the kernel would need a schedule)."""
        return (self.is_photonic and self.flash and not self.mesh_active
                and q_len >= self.flash_min_seq)

    def attention(self, q, k, v, *, causal: bool = True, q_offset=None):
        """q: (B, Sq, H, hd); k: (B, L, KV, hd); v: (B, L, KV, hd_v).
        Returns (B, Sq, H * hd_v).  Long photonic sequences run the flash
        kernel; everything else the einsum reference."""
        B, Sq, H, _ = q.shape
        hd_v = v.shape[-1]
        if self.use_flash(Sq):
            o = ops.flash_attention(q, k, v, causal=causal,
                                    q_offset=q_offset)
            return o.reshape(B, Sq, H * hd_v)
        from repro_torch.models import attention as _attn  # models -> core
        return _attn.attend_seq_xla(q, k, v, causal=causal,
                                    q_offset=q_offset)

    # ------------------------------------------------------------- matmuls
    def dot(self, x, w, *, transpose: bool = False, bias=None,
            block_perm=None, block: int = 0, activation=None, tp_hint=None,
            local_in: bool = False, local_out: bool = False):
        """``x @ w`` (w: (k, n)) or ``x @ w.T`` (w: (n, k)) plus an optional
        blend epilogue.  ``w`` may be a fp tensor or a PreparedTensor bank.
        ``tp_hint="row"`` marks a pair-second matmul for the sharded
        dispatch (:func:`partition_rule`); it has no effect off-mesh.
        ``local_in`` / ``local_out``: x is, and the result should be, this
        rank's block of the channels over "model" (the Megatron pairing,
        module docstring); no effect unless "model" has several ranks."""
        if isinstance(w, PreparedTensor):
            return self.dot_prepared(x, w, transpose=transpose, bias=bias,
                                     block_perm=block_perm, block=block,
                                     activation=activation, tp_hint=tp_hint,
                                     local_in=local_in, local_out=local_out)
        if isinstance(w, _partition.ModelPiece):
            return self._xla_piece_dot(
                x, w, transpose=transpose, bias=bias, block_perm=block_perm,
                block=block, activation=activation, tp_hint=tp_hint,
                local_in=local_in, local_out=local_out)
        if not self.is_photonic:
            y = obu.blend_dot(self._local_in(x, local_in), w,
                              transpose=transpose)
            return self._local_out(
                _epilogue_xla(y, bias, block_perm, block, activation),
                local_out)
        if transpose:
            if w.shape[-1] != x.shape[-1] * (self.tp if local_in else 1):
                raise ValueError(f"transpose blend needs square-compatible "
                                 f"dims, got x{tuple(x.shape)} "
                                 f"w{tuple(w.shape)}")
            wq, wscale = quantize_weight_t(w)
        else:
            wq, wscale = quantize_weight(w)
        if self.mesh_active:
            return self._photonic_matmul_sharded(
                x, None, (wq, wscale), transpose=transpose, bias=bias,
                block_perm=block_perm, block=block, activation=activation,
                tp_hint=tp_hint, local_in=local_in, local_out=local_out)
        return self._photonic_matmul(x, wq, wscale, transpose=transpose,
                                     bias=bias, block_perm=block_perm,
                                     block=block, activation=activation,
                                     bank_tag=None)

    def _xla_piece_dot(self, x, w, *, transpose, bias, block_perm, block,
                       activation, tp_hint, local_in, local_out):
        """A train step's dot on the xla backend against this rank's piece
        of its weight (``w`` a ``partition.ModelPiece``), by
        :func:`partition_rule`: ``column`` multiplies x by the rank's block
        of the output columns (kept local for ``local_out``, else
        all-gathered); a row rule multiplies the rank's block of x's
        channels by its block of the weight's rows and rejoins the partial
        sums (:meth:`_rejoin`); ``replicated`` the whole weight.  A piece cut
        on the other dim is gathered at its use (``ModelPiece.block``).
        Every collective is differentiable, in Megatron's convention
        (``sharding/collectives.py``): x, whole on every rank, enters a
        column block through ``copy_to_model`` and a row block through
        ``split_grad``, so a tensor every rank holds whole gets its whole
        gradient on each."""
        mesh = self.mesh
        tp = self.tp
        K = x.shape[-1] * (tp if local_in else 1)
        n_dim, k_dim = (-2, -1) if transpose else (-1, -2)
        N = w.shape[n_dim]
        rule = partition_rule(tp, K, N, block_perm=block_perm,
                              tp_hint=tp_hint, collective=self.tp_collective)
        if rule in ("scatter", "ring", "psum"):
            xl = x if local_in else coll.split_grad(x, mesh, "model")
            y = obu.blend_dot(xl, w.block(k_dim, mesh), transpose=transpose)
            y = self._rejoin(y, N, bias, block_perm, block, activation,
                             tp_hint, _epilogue_xla, grad=True)
            return coll.split_grad(y, mesh, "model") if local_out else y
        if local_in:
            x = coll.all_gather_split(x, mesh, "model", dim=-1)
        if rule == "column":
            y = obu.blend_dot(coll.copy_to_model(x, mesh),
                              w.block(n_dim, mesh), transpose=transpose)
            y = _epilogue_xla(y, None if bias is None else coll.split_grad(
                bias, mesh, "model"), None, 0, activation)
            return y if local_out else coll.all_gather_split(
                y, mesh, "model", dim=-1)
        y = _epilogue_xla(obu.blend_dot(x, w.block(None, mesh),
                                        transpose=transpose),
                          bias, block_perm, block, activation)
        return coll.split_grad(y, mesh, "model") if local_out else y

    def _rejoin(self, y, N, bias, block_perm, block, activation, tp_hint,
                epilogue, grad=False):
        """The partial sums ``y`` of a row-parallel dot summed over "model"
        and the epilogue run: a pair-second dot under an active residual
        layout reduce-scatters them over the positions ("seq": the
        epilogue on the rank's block of rows) or the channels ("hidden":
        on its block of channels, when they divide and no blocked shuffle
        crosses them) and returns that block; otherwise an all-reduce and
        the whole epilogue.  ``grad``: differentiable collectives (a bias
        every rank holds whole, added to the rank's rows, passes
        ``copy_to_model``; its block of channels, ``split_grad``)."""
        mesh = self.mesh
        lay = self._residual(tp_hint, y)
        if grad:
            scatter, join = coll.reduce_scatter_grad, coll.psum_grad
            copy, split = coll.copy_to_model, coll.split_grad
        else:
            scatter, join = coll.psum_scatter, coll.psum
            copy, split = (lambda t, m: t), coll.split_last
        if lay is not None and lay.mode == "seq":
            y = scatter(y, mesh, "model", dim=1)
            return epilogue(y, None if bias is None else copy(bias, mesh),
                            block_perm, block, activation)
        if (lay is not None and N % self.tp == 0 and block_perm is None):
            y = scatter(y, mesh, "model", dim=-1)
            return epilogue(y, None if bias is None else split(
                bias, mesh, "model"), None, 0, activation)
        y = join(y, mesh, "model")
        return epilogue(y, bias, block_perm, block, activation)

    def dot_prepared(self, x, prep: PreparedTensor, *,
                     transpose: bool = False, bias=None, block_perm=None,
                     block: int = 0, activation=None, tp_hint=None,
                     local_in: bool = False, local_out: bool = False):
        """``dot`` against a programmed bank: the transposed orientation
        uses the per-row image (``wq_t``/``scale_t``)."""
        wname, sname = ("wq_t", "scale_t") if transpose else ("wq", "scale")
        if not self.is_photonic:
            x = self._local_in(x, local_in)
            # xla pointed at a photonic bank: dequantize the W8 image
            wq, sc = self._whole(prep, wname), self._whole(prep, sname)
            if transpose:
                w = (wq.to(torch.float32)
                     * (sc / 127.0)[..., :, None]).to(x.dtype)
            else:
                w = (wq.to(torch.float32)
                     * (sc / 127.0)[..., None, :]).to(x.dtype)
            y = obu.blend_dot(x, w, transpose=transpose)
            return self._local_out(
                _epilogue_xla(y, bias, block_perm, block, activation),
                local_out)
        K = x.shape[-1] * (self.tp if local_in else 1)
        if transpose and prep.shape[-1] != K:
            raise ValueError(f"transpose blend needs square-compatible "
                             f"dims, got x{tuple(x.shape)} w{prep.shape}")
        if self.mesh_active:
            return self._photonic_matmul_sharded(
                x, prep, None, transpose=transpose, bias=bias,
                block_perm=block_perm, block=block, activation=activation,
                tp_hint=tp_hint, local_in=local_in, local_out=local_out)
        return self._photonic_matmul(x, getattr(prep, wname),
                                     getattr(prep, sname),
                                     transpose=transpose, bias=bias,
                                     block_perm=block_perm, block=block,
                                     activation=activation,
                                     bank_tag=prep.tag)

    def _whole(self, prep: PreparedTensor, name: str):
        """A bank field whole on this rank (gathered when it is placed in
        pieces; not kept)."""
        if prep.placement is None:
            return getattr(prep, name)
        return bank_field(prep, name, None, self.mesh, cache=False)

    def _photonic_matmul(self, x, wq, wscale, *, transpose, bias,
                         block_perm, block, activation, bank_tag):
        """The fused kernel, or the split quantize -> MVM -> epilogue
        pipeline; with an enabled fault model, the split pipeline with the
        ``core/noise.py`` perturbation on the raw MVM output.
        ``bank_tag`` (the PreparedTensor's path hash; None for in-step
        quantized weights) keys the bank's random streams and its age."""
        if self.noise_active:
            y = ops.photonic_matmul_noisy(x, wq, wscale, noise=self.noise,
                                          bank_tag=bank_tag,
                                          transpose=transpose)
            return _epilogue_unfused(y, bias, block_perm, block, activation)
        if self.fused:
            return ops.photonic_matmul_fused(
                x, wq, wscale, transpose=transpose, bias=bias,
                block_perm=block_perm, block=block,
                activation=activation or "none")
        mm = (ops.photonic_matmul_prepared_t if transpose
              else ops.photonic_matmul_prepared)
        return _epilogue_unfused(mm(x, wq, wscale), bias, block_perm, block,
                                 activation)

    def _rows_amax(self, x, local_in: bool = False):
        """|x|'s max over the step's rows: this rank's, all-reduced (MAX)
        over the data axes when the rows are split, and over "model" when
        ``x`` is the rank's block of the channels (``local_in``).  Max is
        exact, so the A8 grid is bitwise the single device's."""
        amax = x.abs().amax()
        axes = _partition.data_axes(self.mesh) if self.rows_sharded else ()
        if local_in:
            axes = axes + ("model",)
        if axes:
            amax = coll.pmax(amax, self.mesh, axes)
        return amax

    def _photonic_matmul_sharded(self, x, prep, whole, *, transpose, bias,
                                 block_perm, block, activation, tp_hint,
                                 local_in=False, local_out=False):
        """One photonic dot on this rank under :func:`partition_rule`
        (see the module docstring).  ``prep`` is a bank (possibly placed in
        pieces), or ``whole`` the (wq, wscale) of an in-step quantized
        weight, whole on every rank.  ``local_in`` / ``local_out``: the
        Megatron pairing (module docstring)."""
        mesh = self.mesh
        tp = mesh.axis_size("model")
        K = x.shape[-1] * (tp if local_in else 1)
        wname, sname = ("wq_t", "scale_t") if transpose else ("wq", "scale")
        if prep is not None:
            N = prep.shape[-2] if transpose else prep.shape[-1]
        else:
            N = whole[0].shape[-2] if transpose else whole[0].shape[-1]
        rule = partition_rule(tp, K, N, block_perm=block_perm,
                              tp_hint=tp_hint,
                              collective=self.tp_collective)
        col_dim = -2 if transpose else -1     # the weight's output dim
        red_dim = -1 if transpose else -2     # and its reduction dim
        red = rule in ("scatter", "ring", "psum")
        if local_in and not red:
            # a rule that reads whole rows: the block joins first
            x, local_in = coll.all_gather(x, mesh, "model", dim=-1), False

        def fetch(which, dim):
            if prep is not None:
                return bank_field(prep, wname if which == "w" else sname,
                                  dim, mesh)
            t = whole[0] if which == "w" else whole[1]
            return t if dim is None else _piece(t, dim, mesh).contiguous()

        xs = a8_scale_from_amax(self._rows_amax(x, local_in))
        xl = _piece(x, -1, mesh).contiguous() if red and not local_in \
            else x
        fused = self.fused

        def kernel(wl, sl, epilogue, bl=None):
            """One per-rank kernel call; ``epilogue=False`` leaves the raw
            (partial) MVM for the collective to finish."""
            if fused:
                return ops.photonic_matmul_fused(
                    xl, wl, sl, x_scale=xs, transpose=transpose,
                    bias=bl if epilogue else None,
                    block_perm=block_perm if epilogue else None,
                    block=block,
                    activation=(activation or "none") if epilogue
                    else "none")
            mm = (ops.photonic_matmul_prepared_t if transpose
                  else ops.photonic_matmul_prepared)
            y = mm(xl, wl, sl, x_scale=xs)
            if epilogue:
                y = _epilogue_unfused(y, bl, block_perm, block, activation)
            return y

        def my_bias():
            return None if bias is None else coll.split_last(bias, mesh,
                                                             "model")

        if rule == "column":
            y = kernel(fetch("w", col_dim), fetch("s", -1), True, my_bias())
            return y if local_out else coll.all_gather(y, mesh, "model",
                                                       dim=-1)
        if rule in ("scatter", "psum"):
            y = kernel(fetch("w", red_dim), fetch("s", None), False)
            if self._residual(tp_hint, y) is not None:
                # the pair-second dot lands in the step's residual layout
                return self._rejoin(y, N, bias, block_perm, block,
                                    activation, tp_hint, _epilogue_unfused)
        if rule == "scatter":
            y = coll.psum_scatter(y, mesh, "model")
            y = _epilogue_unfused(y, my_bias(), None, 0, activation)
            y = coll.all_gather(y, mesh, "model", dim=-1)
        elif rule == "ring":
            wl, sl = fetch("w", red_dim), fetch("s", None)
            chunk = N // tp
            me = mesh.index("model")

            def part(idx):
                # the partial of output chunk ``idx`` on this K-slice
                wc = wl.narrow(col_dim, idx * chunk, chunk).contiguous()
                sc = sl.narrow(-1, idx * chunk, chunk).contiguous()
                return kernel(wc, sc, False)

            # start on the chunk owned by the downstream neighbour, send
            # while computing the next: after tp-1 hops rank m holds the
            # fully reduced chunk m
            acc = part((me + tp - 1) % tp)
            for s in range(1, tp):
                acc = coll.ppermute_ring(acc, mesh, "model")
                acc = acc + part((me + tp - 1 - s) % tp)
            y = _epilogue_unfused(acc, my_bias(), None, 0, activation)
            y = coll.all_gather(y, mesh, "model", dim=-1)
        elif rule == "psum":
            y = coll.psum(y, mesh, "model")
            y = _epilogue_unfused(y, bias, block_perm, block, activation)
        else:
            # replicated: the whole weight, the kernel's own epilogue
            y = kernel(fetch("w", None), fetch("s", None), True, bias)
        return self._local_out(y, local_out)

    def reuse_dot(self, x_stack, w):
        """T independent activation streams through ONE weight: x_stack
        (T, ..., k) @ w (k, n).  Photonic: the weight is programmed once
        and all T streams pass through the resident bank tile."""
        if isinstance(w, PreparedTensor):
            return self.reuse_dot_prepared(x_stack, w)
        if not self.is_photonic:
            return obu.blend_dot(x_stack, w, transpose=False)
        if self.mesh_active:
            return self._reuse_dot_sharded(x_stack, None,
                                           quantize_weight(w))
        y = ops.reuse_resident_matmul(x_stack, w)
        return self._perturb_reuse(y, bank_tag=None)

    def reuse_dot_prepared(self, x_stack, prep: PreparedTensor):
        """Reuse-resident matmul against a programmed bank (neither the
        weight fetch nor its quantization repeats across the T streams).
        xla pointed at a bank dequantizes its W8 image, as ``dot_prepared``
        does."""
        if not self.is_photonic:
            w = (self._whole(prep, "wq").to(torch.float32)
                 * (self._whole(prep, "scale") / 127.0)[..., None, :]
                 ).to(x_stack.dtype)
            return obu.blend_dot(x_stack, w, transpose=False)
        if self.mesh_active:
            return self._reuse_dot_sharded(x_stack, prep, None)
        y = ops.reuse_resident_matmul_prepared(x_stack, prep.wq, prep.scale)
        return self._perturb_reuse(y, bank_tag=prep.tag)

    def _reuse_dot_sharded(self, x_stack, prep, whole):
        """The reuse-resident kernel on this rank: the bank's columns split
        over "model" when N divides (the rank keeps its slice resident for
        all T streams), else the whole bank; the T streams never split."""
        mesh = self.mesh
        tp = mesh.axis_size("model")
        N = prep.shape[-1] if prep is not None else whole[0].shape[-1]
        dim = -1 if tp > 1 and N % tp == 0 else None

        def fetch(i, name):
            if prep is not None:
                return bank_field(prep, name, dim, mesh)
            t = whole[i]
            return t if dim is None else _piece(t, -1, mesh).contiguous()

        y = ops.reuse_resident_matmul_prepared(x_stack, fetch(0, "wq"),
                                               fetch(1, "scale"))
        return y if dim is None else coll.all_gather(y, mesh, "model",
                                                     dim=-1)

    def _perturb_reuse(self, y, *, bank_tag):
        """Fault-model hook of the reuse-resident paths: one programmed bank
        serves all T streams, so one perturbation pattern (keyed by the
        bank tag) applies across the whole stack — every stream passes the
        same drifted rings.  No-op when noise is disabled."""
        if not self.noise_active:
            return y
        return noise_lib.perturb_mvm_output(y, self.noise, tag=bank_tag,
                                            transpose=False)

    # -------------------------------------------------------------- shuffle
    def shuffle(self, h, perm, block_perm=None, block: int = 0):
        """OBU electronic shuffle of the channel axis.  Photonic + blocked
        permutation (the paper's §3.2 method 1): the blend kernel, fused or
        split alike; under an active mesh on the rank's rows, the channel
        axis whole (the reference's mesh branch).  Otherwise the static
        index gather."""
        lay = self.residual
        if lay is not None and lay.active and lay.mode == "hidden":
            # a rank holds a block of the channels: shuffle them whole
            whole = coll.all_gather_split(h, self.mesh, "model", dim=-1)
            return coll.split_grad(dataclasses.replace(
                self, residual=None).shuffle(whole, perm, block_perm, block),
                self.mesh, "model")
        if self.is_photonic and block_perm is not None and block > 0:
            return ops.blend_shuffle(h, None, block_perm, block=block,
                                     activation="none")
        return obu.apply_channel_permutation(h, perm)


XLA = Backend("xla")
PHOTONIC = Backend("photonic")


def resolve(spec=None) -> Backend:
    """Backend from a Backend | name | config-with-.execution | None."""
    if spec is None:
        return XLA
    if isinstance(spec, Backend):
        return spec
    if isinstance(spec, str):
        return PHOTONIC if spec == "photonic" else Backend(spec)
    return resolve(getattr(spec, "execution", None))
