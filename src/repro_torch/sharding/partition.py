"""Logical-axis partitioning (port of ``repro.sharding.partition``): maps
the models' logical axis names onto mesh axes.

A spec is a tuple of entries, one per leading tensor dim (dims past its
end are whole), as ``tuple(jax.sharding.PartitionSpec(...))`` reads the
reference's spec: ``None`` (whole), a mesh axis name, or a tuple of names
(split over their product, row-major).  Each function builds its tuples
as the reference builds its specs (``spec_for`` trims trailing ``None``
entries, the activation and cache specs keep them).  The rule functions take any mesh with ``axis_names`` and a
``shape`` mapping (``launch.mesh.Mesh``; the tests pass the reference's
``AbstractMesh`` to the reference and a port mesh of the same shape here).

Parallelism styles the rules compose (the reference's DESIGN.md §3):
  TP    — "model" over heads / d_ff / vocab / experts / ssm inner dims
  DP    — batch over "data" (and "pod" in the 3-axis mesh)
  FSDP  — ``cfg.fsdp`` shards the weights' "embed" axis over the data axes
          ("all-gather on use, reduce-scatter on grads")

A rule that does not divide a concrete dim is dropped (replicated) and
recorded in a :class:`PartitionReport`.

On top of the rules, the port's ranks need a rank's piece of a tensor:
:func:`local_slice` cuts it from a spec, :func:`assemble` joins the ranks'
pieces back, and :func:`place_bank` gives a rank its piece of every
programmed bank (``core.prepared.PreparedTensor.field_specs``; under
``fsdp`` the matrices' and the float leaves' "embed" dims over the data
axes too).  For training, a rank holds the whole ``tree_pspecs`` piece of
every parameter ("model" entries too); :func:`data_specs` keeps the
data-axes part of a spec tree (what FSDP gathers where a leaf is used:
``sharding/fsdp.py``), :func:`local_tree` cuts a rank's pieces of a
parameter tree and :func:`gather_tree` all-gathers them back into the
logical layout; :func:`forward_leaf` gives a train step's forward each
leaf as its dots read it (a :class:`ModelPiece` for a matrix cut over
"model").
:func:`residual_layout` reads a step's residual placement ("seq" /
"hidden") from its activation spec (:class:`ResidualLayout`).  A rank's
caches are its pieces under :func:`cache_pspecs`, each made at
:func:`local_shape` and marked with
its spec and whole shape (:func:`mark_piece` / :func:`piece_of`);
:func:`positions_dim` names the dim of a leaf's positions by its key;
:func:`kv_layout` says where a step's attention heads or positions (MLA:
latent positions) lie, :func:`ssm_layout` where its SSM heads and conv
channels do.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np


def data_axes(mesh):
    """The data-parallel axes of the mesh ('pod' composes with 'data')."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def dp_size(mesh) -> int:
    """Total data-parallel degree: the product of the data axes' sizes."""
    d = data_axes(mesh)
    return int(np.prod([mesh.shape[a] for a in d])) if d else 1


def base_rules(mesh, fsdp: bool) -> dict:
    d = data_axes(mesh)
    return {
        "vocab": ("model",),
        "mlp": ("model",),
        "heads": ("model",),
        "kv": ("model",),
        "experts": ("model",),
        "experts_r": (),
        "kv_lora": (),
        "embed": d if fsdp else (),
        "layers": (),
        "ssm_in": ("model",),
        "ssm_conv": ("model",),
        "ssm_heads": ("model",),
        "ssm_inner": ("model",),
        "vision_in": (),
        "audio_in": (),
        None: (),
    }


@dataclasses.dataclass
class PartitionReport:
    dropped: list


def _trim(entries) -> tuple:
    entries = list(entries)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def spec_for(axes: tuple, shape: tuple, mesh, rules: dict,
             report: PartitionReport | None = None) -> tuple:
    """Spec for one param leaf.  A rule that does not divide the dim is
    dropped; a mesh axis already consumed by an earlier dim is dropped too
    (MoE expert tensors map both 'experts' and 'mlp' to "model": experts
    win)."""
    entries = []
    used: set = set()
    for dim, ax in zip(shape, axes):
        mapped = tuple(m for m in rules.get(ax, ()) if m not in used)
        if not mapped:
            entries.append(None)
            continue
        size = int(np.prod([mesh.shape[m] for m in mapped]))
        if dim % size != 0:
            if report is not None:
                report.dropped.append((ax, dim, mapped))
            entries.append(None)
        else:
            entries.append(mapped if len(mapped) > 1 else mapped[0])
            used.update(mapped)
    return _trim(entries)


def map_with_specs(fn, params: Any, specs: Any, path=()) -> Any:
    """Map ``fn(leaf, axes)`` over a nested-dict tree with the parallel spec
    tree (the same keys; spec leaves are tuples).  Keys in sorted order, as
    JAX flattens a dict, so a report lists drops in the reference's
    order."""
    if isinstance(params, dict):
        return {k: map_with_specs(fn, params[k], specs[k], path + (k,))
                for k in sorted(params)}
    return fn(params, specs)


def param_shardings(param_shapes: Any, specs: Any, mesh, fsdp: bool,
                    report: PartitionReport | None = None) -> Any:
    """Spec tree matching ``param_shapes`` (anything with ``.shape``)."""
    rules = base_rules(mesh, fsdp)
    return map_with_specs(
        lambda leaf, ax: spec_for(tuple(ax), tuple(leaf.shape), mesh, rules,
                                  report), param_shapes, specs)


def dropped_summary(report: PartitionReport, limit: int = 6) -> str:
    """One-line summary of the rules :func:`spec_for` replicated (a mesh
    axis that does not divide a concrete dim)."""
    items = [f"{ax}:{dim}%{'x'.join(str(m) for m in mapped)}"
             for ax, dim, mapped in report.dropped[:limit]]
    more = len(report.dropped) - len(items)
    tail = f" (+{more} more)" if more > 0 else ""
    return (f"sharding: {len(report.dropped)} rule(s) dropped — replicated "
            f"instead of sharded: {', '.join(items)}{tail}")


def bank_shardings(bank: Any, specs: Any, mesh, fsdp: bool,
                   report: PartitionReport | None = None) -> Any:
    """Spec tree for a ``Program.build`` bank: a ``PreparedTensor`` leaf
    becomes a PreparedTensor of field specs (``field_specs`` of its
    weight's spec), an fp leaf its :func:`spec_for`."""
    from repro_torch.core.prepared import PreparedTensor

    rules = base_rules(mesh, fsdp)

    def one(leaf, ax):
        ax = tuple(ax)
        if isinstance(leaf, PreparedTensor):
            wspec = spec_for(ax, tuple(leaf.wq.shape), mesh, rules, report)
            return PreparedTensor.field_specs(wspec, leaf.wq.ndim,
                                              tag=leaf.tag)
        return spec_for(ax, tuple(leaf.shape), mesh, rules, report)

    return map_with_specs(one, bank, specs)


def tree_pspecs(param_shapes: Any, specs: Any, mesh, fsdp: bool) -> Any:
    rules = base_rules(mesh, fsdp)
    return map_with_specs(
        lambda leaf, ax: spec_for(tuple(ax), tuple(leaf.shape), mesh, rules),
        param_shapes, specs)


# -------------------------------------------------------------- activations
def batch_pspec(mesh) -> tuple:
    """(batch, seq, ...) activations: batch over the data axes."""
    d = data_axes(mesh)
    return (d if len(d) > 1 else d[0],)


def act_pspec(mesh, mode: str = "seq") -> tuple:
    """Residual-stream spec (batch, seq, d_model): "seq" shards the
    sequence over "model", "hidden" d_model, "replicated" neither (batch
    over data only: the port's serving placement)."""
    d = data_axes(mesh)
    dd = d if len(d) > 1 else d[0]
    if mode == "seq":
        return (dd, "model", None)
    if mode == "hidden":
        return (dd, None, "model")
    return (dd,)


def residual_mode(spec) -> str:
    """The residual placement an activation spec asks for: ``"seq"`` (its
    positions entry is "model"), ``"hidden"`` (its d_model entry is) or
    ``"replicated"`` (neither; also ``None``)."""
    spec = tuple(spec or ())
    if len(spec) > 1 and "model" in _entry_axes(spec[1]):
        return "seq"
    if len(spec) > 2 and "model" in _entry_axes(spec[2]):
        return "hidden"
    return "replicated"


@dataclasses.dataclass(frozen=True)
class ResidualLayout:
    """How a step holds its residual stream (B, S, D) over "model" between
    the layers: ``mode`` "seq" (a rank's block of the ``length`` positions)
    or "hidden" (its block of the ``width`` channels), over ``tp`` ranks.
    ``active`` when that dim divides; otherwise the residual stays whole
    (a decode step's one position), as ``spec_for`` drops a rule that does
    not divide.  ``models/transformer.py`` cuts and gathers it; the
    pair-second dot rejoins into it (``core/backend.py``)."""
    mode: str
    length: int
    width: int
    tp: int

    @property
    def dim(self) -> int:
        """The residual dim that is cut: 1 (positions) or -1 (channels)."""
        return 1 if self.mode == "seq" else -1

    @property
    def active(self) -> bool:
        n = self.length if self.mode == "seq" else self.width
        return self.tp > 1 and n % self.tp == 0

    def for_length(self, length: int) -> "ResidualLayout":
        """The same layout for another stream (the encoder's frames)."""
        return dataclasses.replace(self, length=int(length))


def residual_layout(spec, mesh, length: int, width: int):
    """The :class:`ResidualLayout` of activation spec ``spec`` for a stream
    of ``length`` positions and ``width`` channels on ``mesh``, or None
    ("replicated", or a mesh whose "model" axis has one rank)."""
    mode = residual_mode(spec)
    tp = mesh.shape["model"] if "model" in mesh.axis_names else 1
    if mode == "replicated" or tp == 1:
        return None
    return ResidualLayout(mode, int(length), int(width), int(tp))


def _seq_axes(mesh, batch: int, L: int):
    """The spec entry of a length-``L`` sequence dim that the batch rows do
    not cut: the data axes and "model" when the batch leaves the data axes
    idle and ``L`` divides them all, else "model" when it divides, else
    whole (None)."""
    d = data_axes(mesh)
    model_n = mesh.shape["model"]
    dp_n = dp_size(mesh)
    if batch % dp_n != 0 and L % (dp_n * model_n) == 0:
        return tuple(d) + ("model",)
    if L % model_n == 0:
        return "model"
    return None


def _heads_ok(cfg, mesh) -> bool:
    """Whether "model" divides the KV heads (they go over it)."""
    kv_heads = cfg.num_kv_heads
    return kv_heads > 0 and kv_heads % mesh.shape["model"] == 0


def cache_pspecs(cfg, mesh, batch: int, seq_len: int) -> Any:
    """Spec tree matching ``models.transformer.init_caches``: leading
    [R, T] never sharded; batch over the data axes when divisible (else the
    sequence dim soaks them up); KV heads on "model" when divisible, else
    the sequence dim."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models.ssm import ssm_dims

    d = data_axes(mesh)
    dd = d if len(d) > 1 else d[0]
    model_n = mesh.shape["model"]
    batch_ok = batch % dp_size(mesh) == 0
    bspec = dd if batch_ok else None

    def seq_axes(L):
        return _seq_axes(mesh, batch, L)

    heads_ok = _heads_ok(cfg, mesh)

    def attn_spec():
        if heads_ok:
            return (None, None, bspec, None, "model", None)
        return (None, None, bspec, seq_axes(seq_len), None, None)

    def mixer(kind):
        if kind == "attn":
            if cfg.mla is not None:
                s = seq_axes(seq_len)
                return {"ckv": (None, None, bspec, s, None),
                        "kr": (None, None, bspec, s, None)}
            return {"k": attn_spec(), "v": attn_spec()}
        if kind == "ssm":
            _, H, conv_dim = ssm_dims(cfg)
            h_ax = "model" if H % model_n == 0 else None
            c_ax = "model" if conv_dim % model_n == 0 else None
            return {"h": (None, None, bspec, h_ax, None, None),
                    "conv": (None, None, bspec, None, c_ax)}
        if kind == "cross_attn":
            ax = "model" if heads_ok else None
            return {"ck": (None, None, bspec, None, ax, None),
                    "cv": (None, None, bspec, None, ax, None)}
        if kind == "attn_cross":
            return {"self": {"k": attn_spec(), "v": attn_spec()},
                    "cross": mixer("cross_attn")}
        raise ValueError(kind)

    out = {}
    for spec in tfm.build_segments(cfg):
        if spec.stream == "encoder":
            continue
        out[spec.name] = {f"l{i}": mixer(spec.mixer_kinds[i])
                          for i in range(spec.group_size)}
    return out


def replicated(mesh) -> tuple:
    return ()


# ------------------------------------------------------------ cache pieces
# the cache leaves whose dim 3 holds positions (self-attention K/V, MLA
# latents); an SSM state's dim 3 is its heads, a conv tail's its rows, a
# cross-attention leaf's the memory rows
_POSITION_LEAVES = ("k", "v", "ckv", "kr")


def positions_dim(name: str):
    """The positions dim of cache leaf ``name`` (3), or None."""
    return 3 if name in _POSITION_LEAVES else None


def local_shape(shape, spec: tuple, mesh) -> tuple:
    """The shape of this rank's piece of a ``shape`` tensor under
    ``spec``; raises when a cut dim does not divide."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        parts = mesh.axis_size(_entry_axes(entry))
        if out[dim] % parts:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not divide "
                             f"over {entry!r} ({parts} parts)")
        out[dim] //= parts
    return tuple(out)


def mark_piece(t, spec: tuple, whole_shape):
    """Record on ``t`` (a cache leaf made at a rank's local shape) the spec
    it was cut by and the whole tensor's shape (:func:`piece_of`): a step
    given the caches reads where its rows, heads, channels and positions
    lie.  A view of ``t`` does not carry the record."""
    t.repro_piece = (tuple(spec), tuple(int(n) for n in whole_shape))
    return t


def piece_of(t):
    """(spec, whole shape) recorded on ``t`` by :func:`mark_piece`, or
    None (a tensor made whole)."""
    return getattr(t, "repro_piece", None)


@dataclasses.dataclass(frozen=True)
class KVLayout:
    """Where a serving step's attention caches put their KV heads and
    positions on an active mesh (``cache_pspecs``):

      * ``heads``: "model" (of more than one rank) divides the KV heads; a
        rank holds its KV heads, projects their query heads and attends
        with them;
      * else ``seq_axes``: the axes the self-attention positions split over
        (empty: whole on every rank); a rank holds its block of
        ``length`` positions (:meth:`window`) and every head.
    """
    heads: bool
    seq_axes: tuple
    length: int

    def window(self, mesh) -> tuple:
        """(first position, positions) of this rank's block."""
        parts = mesh.axis_size(self.seq_axes)
        n = self.length // parts
        return mesh.index(self.seq_axes) * n, n


def kv_layout(cfg, mesh, batch: int, seq_len: int) -> KVLayout:
    """The :class:`KVLayout` of ``cfg``'s caches for a ``batch``-row step
    over ``seq_len`` positions on ``mesh``.  MLA latents always take the
    sequence entry (``cache_pspecs``: no head axis), even on a mesh whose
    "model" axis has one rank, where one row leaves the data axes to the
    positions; axes of one position in all cut nothing."""
    tp = mesh.shape["model"]
    if cfg.mla is not None:
        heads, seq = False, _entry_axes(_seq_axes(mesh, batch, seq_len))
    else:
        heads = tp > 1 and _heads_ok(cfg, mesh)
        seq = () if heads or tp == 1 else _entry_axes(
            _seq_axes(mesh, batch, seq_len))
    if mesh.axis_size(seq) == 1:
        seq = ()
    return KVLayout(heads, seq, int(seq_len))


@dataclasses.dataclass(frozen=True)
class SSMLayout:
    """Where a serving step's SSM caches put their heads and channels on
    an active mesh (``cache_pspecs``: ``h`` over "model" where it divides
    the H heads, ``conv`` where it divides the conv_dim channels):

      * ``heads``: a rank's ``h`` holds heads [head_lo, head_lo +
        n_heads); it scans only those through ``ssd_chunk``, with the B/C
        of groups [group_lo, group_lo + n_groups);
      * ``channels``: a rank's ``conv`` tail holds channels [chan_lo,
        chan_lo + n_chans); it runs the depthwise conv on those only.

    A part not cut is whole: the whole range on every rank.  A train step
    runs the same cuts: its SSM leaves cut over "model" (``conv_k`` on its
    channels, ``A_log``, ``D`` and ``dt_bias`` on their heads) arrive as
    the rank's pieces (:func:`forward_leaf`); a serving step's arrive
    whole and the step takes the rank's."""
    heads: bool
    channels: bool
    head_lo: int
    n_heads: int
    group_lo: int
    n_groups: int
    chan_lo: int
    n_chans: int


def ssm_layout(cfg, mesh) -> SSMLayout:
    """The :class:`SSMLayout` of ``cfg``'s SSM caches on ``mesh`` (it
    depends on neither the batch nor the length), and of a train step's
    SSM leaves (the same cuts: they are the leaves' "ssm_conv" and
    "ssm_heads" rules).  Where the heads are cut and ``n_groups > 1``, a rank's heads
    must lie within whole groups or within one group: a cut that would
    give a rank part of one group and part of another raises."""
    from repro_torch.models.ssm import ssm_dims

    _, H, conv_dim = ssm_dims(cfg)
    G = cfg.ssm.n_groups
    tp = mesh.shape["model"]
    i = mesh.index("model")
    heads = tp > 1 and H % tp == 0
    channels = tp > 1 and conv_dim % tp == 0
    head_lo, n_heads, group_lo, n_groups = 0, H, 0, G
    if heads:
        n_heads = H // tp
        head_lo = i * n_heads
        rep = H // G
        if n_heads % rep == 0:
            group_lo, n_groups = head_lo // rep, n_heads // rep
        elif rep % n_heads == 0:
            group_lo, n_groups = head_lo // rep, 1
        else:
            raise ValueError(
                f"{cfg.name}: {H} SSM heads over {tp} 'model' ranks give a "
                f"rank {n_heads} heads across groups of {rep} "
                f"(n_groups={G}): a cut that splits a group")
    chan_lo, n_chans = 0, conv_dim
    if channels:
        n_chans = conv_dim // tp
        chan_lo = i * n_chans
    return SSMLayout(heads, channels, head_lo, n_heads, group_lo, n_groups,
                     chan_lo, n_chans)


@dataclasses.dataclass(frozen=True)
class ExpertLayout:
    """Where a train step's MoE expert banks lie over "model": a rank
    holds basic banks [lo, lo + n) of R_e (``num_basic_experts``, or every
    expert), its piece of each bank cut on the experts (``"experts"``), and
    runs the logical experts e with e % R_e in that range
    (``models/moe.apply_moe``)."""
    lo: int
    n: int
    basic: int


def expert_layout(cfg, mesh):
    """The :class:`ExpertLayout` of ``cfg``'s expert banks on ``mesh``
    where "model" cuts them on their experts (it divides R_e; R_e must
    then divide the E logical experts, or this raises), else None (a bank
    not cut on its experts reaches the MoE whole)."""
    moe = cfg.moe
    tp = mesh.axis_size("model")
    if moe is None or tp == 1:
        return None
    basic = moe.num_basic_experts or moe.num_experts
    if basic % tp:
        return None
    if moe.num_experts % basic:
        raise ValueError(f"{cfg.name}: {moe.num_experts} experts blended "
                         f"from {basic} basic banks cut over {tp} 'model' "
                         f"ranks: the banks' reuses must divide")
    n = basic // tp
    return ExpertLayout(mesh.index("model") * n, n, basic)


# ------------------------------------------------------- logical-axis specs
# the logical axes of each parameter leaf, by its final key (the specs the
# reference's ``init_*`` functions return beside the params)
_LEAF_AXES = {
    "table": ("vocab", "embed"),
    "wq": ("embed", "heads"), "wk": ("embed", "kv"), "wv": ("embed", "kv"),
    "wo": ("heads", "embed"),
    "w_dkv": ("embed", "kv_lora"), "w_ukv": ("kv_lora", "heads"),
    "w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
    "w_down": ("mlp", "embed"),
    "router": ("embed", "experts_r"),
    "w_in": ("embed", "ssm_in"), "w_out": ("ssm_inner", "embed"),
    "conv_k": (None, "ssm_conv"), "A_log": ("ssm_heads",),
    "D": ("ssm_heads",), "dt_bias": ("ssm_heads",),
    "norm_scale": ("ssm_inner",),
    "scale": ("embed",), "bias": ("embed",),
}
# ``w`` leaves (linear layers) by their parent key
_LINEAR_AXES = {"lm_head": ("embed", "vocab"),
                "vision_proj": ("vision_in", "embed"),
                "audio_proj": ("audio_in", "embed")}


def leaf_axes(path: tuple, ndim: int) -> tuple:
    """Logical axes of the parameter at ``path`` (a tuple of dict keys)
    with ``ndim`` dims: a segment leaf leads with "layers" (its R axis),
    then "experts" for a MoE expert bank."""
    key = path[-1]
    base = (_LINEAR_AXES[path[-2]] if key == "w" else _LEAF_AXES[key])
    extra = ndim - len(base)
    if path[0] == "segments":
        lead = ("layers",) + ("experts",) * (extra - 1)
    else:
        lead = (None,) * extra
    return lead + tuple(base)


def model_specs(params: Any, path=()) -> Any:
    """Logical-axis spec tree of a parameter tree (nested dicts of tensors
    or banks; anything with ``.ndim``): the reference's
    ``transformer.model_specs`` for the same model."""
    if isinstance(params, dict):
        return {k: model_specs(v, path + (k,)) for k, v in params.items()}
    return leaf_axes(path, params.ndim)


# ------------------------------------------------------------ rank pieces
def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def cuts(spec: tuple) -> bool:
    """Whether ``spec`` splits any dim (else the tensor is whole)."""
    return any(_entry_axes(e) for e in spec)


def piece(mesh, entry) -> tuple:
    """(parts, index) of this rank's piece along a dim with spec ``entry``:
    the dim splits into ``parts`` blocks and the rank holds block
    ``index``."""
    axes = _entry_axes(entry)
    return mesh.axis_size(axes), mesh.index(axes)


def local_slice(t, spec: tuple, mesh):
    """This rank's piece of ``t`` (a tensor or a numpy array) under
    ``spec``: a view."""
    for dim, entry in enumerate(spec):
        parts, idx = piece(mesh, entry)
        if parts > 1:
            n = t.shape[dim] // parts
            t = t[(slice(None),) * dim + (slice(idx * n, (idx + 1) * n),)]
    return t


def assemble(pieces: dict, spec: tuple, mesh_shape: dict):
    """Join the pieces of every rank (``{coords: tensor}``, coords in the
    mesh's axis order) back into the whole tensor under ``spec``.  Ranks
    that hold the same piece must hold equal ones."""
    import torch

    names = tuple(mesh_shape)
    split = [d for d, e in enumerate(spec) if _entry_axes(e)]

    def block(coords):
        out = []
        for d in split:
            axes = _entry_axes(spec[d])
            pos = [coords[names.index(a)] for a in axes]
            out.append(int(np.ravel_multi_index(
                pos, [mesh_shape[a] for a in axes])))
        return tuple(out)

    blocks: dict = {}
    for coords, t in pieces.items():
        b = block(coords)
        if b in blocks:
            if not torch.equal(blocks[b], t):
                raise ValueError(f"ranks disagree on piece {b}")
        else:
            blocks[b] = t

    def join(prefix, level):
        if level == len(split):
            return blocks[tuple(prefix)]
        parts = int(np.prod([mesh_shape[a]
                             for a in _entry_axes(spec[split[level]])]))
        return torch.cat([join(prefix + [i], level + 1)
                          for i in range(parts)], dim=split[level])

    return join([], 0)


def matrix_spec(axes: tuple, shape: tuple, mesh, fsdp: bool = False) -> tuple:
    """The placement spec of a programmed bank on a rank: :func:`spec_for`
    of its two matrix dims (under ``fsdp`` the "embed" dim over the data
    axes too), its leading dims (the R stack, a MoE bank's experts) whole.
    Code indexes those by global id (``bank[r]``, ``w_bank[e]``), so a rank
    keeps all of them and splits each matrix; a dense leaf's spec equals
    :func:`spec_for` of the whole leaf, whose leading "layers" axis never
    shards."""
    lead = len(shape) - 2
    rules = base_rules(mesh, fsdp)
    return _trim((None,) * lead + spec_for(tuple(axes[lead:]),
                                           tuple(shape[lead:]), mesh,
                                           rules))


def data_spec(spec: tuple, mesh) -> tuple:
    """``spec`` with only its data-axes entries kept ("model" entries
    whole)."""
    d = set(data_axes(mesh))
    return _trim(e if _entry_axes(e) and set(_entry_axes(e)) <= d else None
                 for e in spec)


def data_specs(specs: Any, mesh) -> Any:
    """:func:`data_spec` of every leaf of a spec tree."""
    if isinstance(specs, dict):
        return {k: data_specs(v, mesh) for k, v in specs.items()}
    return data_spec(specs, mesh)


def fp_data_spec(axes: tuple, shape: tuple, mesh, fsdp: bool) -> tuple:
    """The data-axes spec of a bank's float leaf on a rank: ``()`` (whole)
    without ``fsdp``; with it, the data-axes part of the reference's
    ``bank_shardings(..., fsdp=True)`` spec (its "embed" dim, where the data
    axes divide it).  Every rank runs such a leaf whole, so "model" entries
    are dropped."""
    if not fsdp:
        return ()
    return data_spec(spec_for(tuple(axes), tuple(shape), mesh,
                              base_rules(mesh, True)), mesh)


def place_bank(bank: Any, specs: Any, mesh, fsdp: bool = False) -> Any:
    """A rank's bank: every ``PreparedTensor`` leaf cut to this rank's
    piece of each field (``PreparedTensor.local``, under
    ``field_specs(matrix_spec(...))``); every fp leaf (the embedding
    gather, norms, biases and the router run on every rank) to its
    :func:`fp_data_spec` piece, whole without ``fsdp`` (under it gathered
    where a step uses it: each block of a stack before its reuses, a leaf
    outside the stacks at its use, the embedding looked up by its columns;
    ``sharding/fsdp.py``)."""
    from repro_torch.core.prepared import PreparedTensor

    def one(leaf, ax):
        if isinstance(leaf, PreparedTensor):
            return leaf.local(matrix_spec(tuple(ax), leaf.shape, mesh, fsdp),
                              mesh)
        spec = fp_data_spec(ax, leaf.shape, mesh, fsdp)
        return local_slice(leaf, spec, mesh).clone() if cuts(spec) else leaf

    return map_with_specs(one, bank, specs)


def bank_data_specs(bank: Any, specs: Any, mesh, fsdp: bool) -> Any:
    """The :func:`fp_data_spec` of each fp leaf of a whole bank (``None``
    for a ``PreparedTensor``, whose dots gather it field by field)."""
    from repro_torch.core.prepared import PreparedTensor

    return map_with_specs(
        lambda leaf, ax: None if isinstance(leaf, PreparedTensor)
        else fp_data_spec(ax, leaf.shape, mesh, fsdp), bank, specs)


# ----------------------------------------------------- parameter pieces
# the leaves a train step's dots read (``Backend.dot``); under their
# "model" rule each stays the rank's piece in the forward (ModelPiece)
DOT_KEYS = frozenset({"wq", "wk", "wv", "wo", "w_dkv", "w_ukv", "w_gate",
                      "w_up", "w_down", "w_in", "w_out", "w", "table"})


def model_dim(spec: tuple):
    """The dim ``spec`` cuts over "model", or None."""
    for d, e in enumerate(spec):
        if "model" in _entry_axes(e):
            return d
    return None


@dataclasses.dataclass(frozen=True)
class ModelPiece:
    """A rank's piece ``t`` of a matrix parameter cut over "model" on dim
    ``dim`` (-1 or -2), as a train step's forward reads it: ``shape`` is
    the whole leaf's.  ``Backend.dot`` on the xla backend runs a dot on it
    by its rule (``core/backend.py``), the embedding looks its rows up
    vocab-parallel (``models/transformer.py``); indexing a leading dim and
    ``.to`` keep the record."""
    t: Any
    dim: int
    shape: tuple

    def __getitem__(self, i):
        if not isinstance(i, int):
            raise TypeError(f"a ModelPiece indexes one leading dim, got {i!r}")
        return ModelPiece(self.t[i], self.dim, tuple(self.shape[1:]))

    def to(self, dtype):
        return ModelPiece(self.t.to(dtype), self.dim, self.shape)

    def block(self, dim: int, mesh):
        """The rank's block of the whole leaf along ``dim`` (-1 or -2): the
        piece itself when it is cut there, else the whole leaf gathered over
        "model" (differentiably: its gradient comes back as the piece) and
        cut; ``dim=None``: the whole leaf."""
        from repro_torch.sharding import collectives as coll

        if dim == self.dim:
            return self.t
        whole = coll.all_gather_split(self.t, mesh, "model", dim=self.dim)
        if dim is None:
            return whole
        return coll.split_grad(whole, mesh, "model", dim=dim)


def forward_leaf(t, spec: tuple, path: tuple, mesh, lead: int = 0):
    """A train step's leaf as its forward reads it on this rank, given the
    rank's piece ``t`` under the whole ``tree_pspecs`` spec ``spec``: a
    leaf whole over "model" as it is; a matrix a dot reads (a
    :data:`DOT_KEYS` leaf cut on one of its two matrix dims, not a MoE
    expert bank) a :class:`ModelPiece`; a MoE expert bank cut on its
    experts (:class:`ExpertLayout`), the SSM's conv kernel cut on its
    channels and its per-head vectors cut on their heads
    (:class:`SSMLayout`) the piece itself, which the rank
    runs on its own experts, channels and heads; any other cut leaf (the
    SSM's norm scale, an expert bank cut on its matrices) all-gathered
    whole (``collectives.all_gather_split``: every rank runs it whole, and
    its gradient comes back as the rank's piece).  ``lead``: the leading
    dims of the leaf ``t`` was indexed out of (1 for block r of a stack;
    ``spec`` is the whole leaf's)."""
    from repro_torch.sharding import collectives as coll

    d = model_dim(spec)
    if d is None or mesh.axis_size("model") == 1:
        return t
    if d < lead:
        raise ValueError(f"{'/'.join(path)}: a leading dim cut over "
                         f"'model', spec {spec}")
    axes = leaf_axes(path, t.ndim + lead)
    if axes[d] in _PIECE_AXES:
        return t
    d -= lead
    if path[-1] in DOT_KEYS and "experts" not in axes and d >= t.ndim - 2:
        shape = list(t.shape)
        shape[d] *= mesh.axis_size("model")
        return ModelPiece(t, d - t.ndim, tuple(shape))
    return coll.all_gather_split(t, mesh, "model", dim=d)


# the logical axes whose "model" pieces a train step runs as they are
_PIECE_AXES = frozenset({"experts", "ssm_conv", "ssm_heads"})


def map_with_paths(fn, tree: Any, specs: Any, path=()) -> Any:
    """``fn(leaf, spec, path)`` over a nested-dict tree and its spec
    tree."""
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, tree[k], specs[k], path + (k,))
                for k in sorted(tree)}
    return fn(tree, specs, path)


def local_tree(tree: Any, specs: Any, mesh) -> Any:
    """This rank's piece of every leaf of ``tree`` under the parallel spec
    tree ``specs`` (each cut leaf an owned contiguous copy, so the whole
    can be freed; a leaf the mesh leaves whole is the leaf itself)."""
    def one(t, spec):
        p = local_slice(t, spec, mesh)
        return p.clone() if p.shape != t.shape else t

    return map_with_specs(one, tree, specs)


def gather_leaf(t, spec: tuple, mesh):
    """The whole tensor of this rank's piece ``t`` under ``spec``: an
    all-gather over each cut dim's axes (all ranks of those axes take
    part)."""
    from repro_torch.sharding import collectives as coll

    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if axes:
            t = coll.all_gather(t, mesh, axes, dim=dim)
    return t


def gather_tree(tree: Any, specs: Any, mesh) -> Any:
    """Every leaf of a tree of this rank's pieces gathered whole
    (:func:`gather_leaf`), in sorted-key order on every rank."""
    return map_with_specs(lambda t, spec: gather_leaf(t, spec, mesh),
                          tree, specs)
