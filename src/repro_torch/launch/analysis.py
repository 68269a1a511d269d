"""Dry-run analysis: roofline inputs from a walk of the step on meta tensors
(port of ``repro.launch.analysis``).

Three data sources, as in the reference:

1. **Analytic FLOPs and HBM bytes** (:func:`analytic_cost`, copied from the
   reference and held equal to it): 6/2 x active parameters x tokens, plus
   attention-context, SSD-chunk and MoE-dispatch terms; weight, optimiser,
   gradient, activation and KV-cache traffic.  The reference computes the
   compute term this way because XLA's ``cost_analysis`` counts a while
   body once; the port keeps the same accounting so that the two agree.

2. **The op census** (:class:`OpCensus`), the counterpart of the
   reference's HLO parsers.  The reference compiles the step and reads
   XLA's optimised HLO: ``split_computations``,
   ``_computation_multipliers``, ``collective_bytes_trip_corrected``,
   ``hbm_traffic_trip_corrected`` and ``parse_collectives`` find every
   instruction and scale it by the trip counts of the while loops around
   it.  The port makes no HLO: it runs the same Python step on meta
   tensors under a ``TorchDispatchMode`` that sees every aten op as it
   runs.  A Python loop over layers and reuses runs its body once per
   trip, so every op is seen as often as it runs and no trip correction
   is needed.  The census counts aten ops, FLOPs
   (``torch.utils.flop_counter``), the peak of live bytes, and modelled
   HBM traffic under the reference's rules: result bytes plus operand
   bytes; views free; slice and gather reads 2 x the result (plus the
   operands smaller than that: the indices); in-place index and slice
   writes 2 x the update; score-shaped buffers (:func:`_is_score_shape`)
   counted apart.  A kernel wrapper on meta tensors does no aten work of
   its own: it records a planned call with its operations and its bytes
   (``kernels/planned.py``), which the census adds.  Collective traffic
   is not HBM traffic here: it is the collectives' own term.

3. **The collective census**: every collective of the walk, from
   ``sharding/collectives.recording`` (result bytes per kind, as
   ``collective_bytes_trip_corrected`` counts them; a census mesh's
   collectives run per rank, so they are per-device bytes).
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels import planned

DTYPE_BYTES = {"f64": 8, "f32": 4, "f16": 2, "bf16": 2, "s64": 8, "u64": 8,
               "s32": 4, "u32": 4, "s16": 2, "u16": 2, "s8": 1, "u8": 1,
               "pred": 1, "f8e4m3fn": 1, "f8e5m2": 1}

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def _is_score_shape(shape, seq_len: int, exclude=()) -> bool:
    """Attention-score-shaped buffer (the reference's rule over a torch
    shape): trailing dim a small multiple of the kv length (heads-flattened
    layouts included) and a wide query dim before it.  These are the
    buffers a flash kernel keeps on chip; the ``kernelized`` memory term
    excludes them.  ``exclude`` lists model dims (d_model, d_ff, vocab)
    never taken for a score axis."""
    dims = [int(d) for d in shape]
    if len(dims) < 2 or dims[-2] < 1024:
        return False
    last = dims[-1]
    if last in exclude:
        return False
    return last >= seq_len and last % seq_len == 0 and last // seq_len <= 128


# =========================================================================
# the op census
# =========================================================================
_GATHERS = {"index.Tensor", "index_select.default", "gather.default",
            "embedding.default", "take.default"}
_INDEX_WRITES = {"index_put_.default", "index_put.default",
                 "_index_put_impl_.default", "index_copy_.default",
                 "index_copy.default", "scatter_.src", "scatter_.value",
                 "scatter.src", "scatter.value", "scatter_add_.default",
                 "scatter_add.default", "index_add_.default",
                 "index_add.default", "slice_scatter.default",
                 "select_scatter.default"}
_NO_TRAFFIC = {"empty.memory_format", "empty_like.default",
               "empty_strided.default", "new_empty.default",
               "new_empty_strided.default", "detach.default",
               "lift_fresh.default", "_local_scalar_dense.default"}


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    """The tensors of nested dicts, lists, tuples and dataclasses (an
    ``OptState``)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


class OpCensus(TorchDispatchMode):
    """Counts aten ops, modelled HBM traffic and live bytes of the meta
    tensors a walk makes (module docstring).  Use it inside a
    ``FlopCounterMode`` for FLOPs.

    ``seq_len`` and ``score_exclude`` drive :func:`_is_score_shape`.
    :meth:`arguments` registers the step's inputs before the walk;
    :meth:`outputs` measures the tensors it returned."""

    def __init__(self, seq_len=None, score_exclude=()):
        super().__init__()
        self.seq_len = seq_len
        self.score_exclude = tuple(score_exclude)
        self.ops = 0
        self.traffic = 0.0
        self.score_traffic = 0.0
        self.live = 0
        self.peak = 0
        self.argument_bytes = 0
        self._storages: dict = {}         # storage key -> bytes
        self._args: set = set()
        self._planned0 = planned.totals()

    # ----------------------------------------------------------- storages
    @staticmethod
    def _key(t: torch.Tensor):
        return t.untyped_storage()._cdata

    def _see(self, t: torch.Tensor) -> None:
        if t.device.type != "meta":
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._storages.pop(key, 0)

    def arguments(self, tree) -> int:
        """Register the walk's inputs as live; returns their bytes (each
        storage once)."""
        before = self.live
        for t in _tensors(tree):
            self._see(t)
            if t.device.type == "meta":
                self._args.add(self._key(t))
        self.argument_bytes += self.live - before
        return self.live - before

    def outputs(self, tree) -> int:
        """Bytes of the storages in ``tree`` that are not inputs (each
        once)."""
        seen, total = set(), 0
        for t in _tensors(tree):
            if t.device.type != "meta":
                continue
            key = self._key(t)
            if key in self._args or key in seen:
                continue
            seen.add(key)
            total += t.untyped_storage().nbytes()
        return total

    def planned_totals(self) -> tuple:
        """(operations, bytes) of the kernels' planned calls since the
        census began."""
        ops, nbytes = planned.totals()
        return ops - self._planned0[0], nbytes - self._planned0[1]

    # ------------------------------------------------------------ traffic
    def _traffic(self, func, ins, outs) -> float:
        name = func._overloadpacket.__name__ + "." + func._overloadname
        if name in _NO_TRAFFIC or func.is_view:
            return 0.0
        in_keys = {self._key(t) for t in ins if t.device.type == "meta"}
        mutable = func._schema.is_mutable
        if not mutable and outs and all(
                t.device.type == "meta" and self._key(t) in in_keys
                for t in outs):
            return 0.0                    # an alias of an input: a view
        res = sum(_bytes(t) for t in outs)
        opnd = [_bytes(t) for t in ins]
        if name in _GATHERS:
            return 2 * res + sum(b for b in opnd if b < 2 * res)
        if mutable and ins:
            dest = ins[0]
            full = (dest.untyped_storage().nbytes()
                    if dest.device.type == "meta" else _bytes(dest))
            if name in _INDEX_WRITES or _bytes(dest) < full:
                # written in place: the update region read and written
                return 2 * sum(b for b in opnd[1:] if b < full)
            return _bytes(dest) + sum(opnd)
        if name in _INDEX_WRITES:
            # a functional scatter: the whole result written, the update
            # read
            return res + sum(opnd[1:])
        return res + sum(opnd)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        for t in outs:
            self._see(t)
        traffic = self._traffic(func, ins, outs)
        self.traffic += traffic
        if self.seq_len and traffic and any(
                _is_score_shape(t.shape, self.seq_len, self.score_exclude)
                for t in outs):
            self.score_traffic += traffic
        return out


# =========================================================================
# analytic FLOPs / bytes (global, whole step) — the reference's, unchanged
# =========================================================================
@dataclasses.dataclass
class AnalyticCost:
    matmul_flops: float        # "useful" 6ND-style
    context_flops: float       # attention scores / SSD chunk terms
    overhead_flops: float      # MoE dispatch/combine einsums
    hbm_bytes: float

    @property
    def total_flops(self):
        return self.matmul_flops + self.context_flops + self.overhead_flops


def _layer_census(cfg: ModelConfig):
    n_attn = sum(1 for i in range(cfg.num_layers)
                 if cfg.layer_kind(i) in ("attn", "attn_cross",
                                          "cross_attn"))
    n_ssm = sum(1 for i in range(cfg.num_layers)
                if cfg.layer_kind(i) == "ssm")
    n_moe = sum(1 for i in range(cfg.num_layers)
                if cfg.ffn_kind(i) == "moe")
    if cfg.family == "audio":
        n_attn += cfg.audio.encoder_layers + cfg.num_layers  # enc self + dec cross
    return n_attn, n_ssm, n_moe


def analytic_cost(cfg: ModelConfig, shape: ShapeConfig,
                  active_params: dict, total_params: int) -> AnalyticCost:
    B = shape.global_batch
    S = shape.seq_len
    train = shape.kind == "train"
    bwd = 3.0 if train else 1.0          # fwd + 2x bwd
    n_attn, n_ssm, n_moe = _layer_census(cfg)
    H = max(cfg.num_heads, 1)
    hd = cfg.head_dim or 0

    tok_dec = B * (1 if shape.kind == "decode" else S)
    tok_enc = (B * cfg.audio.num_frames
               if cfg.family == "audio" and shape.kind != "decode" else 0)
    mult = 6.0 if train else 2.0
    matmul = mult * (active_params["decoder"] * tok_dec
                     + active_params["encoder"] * tok_enc)

    # sequence-mixer context terms
    if shape.kind == "decode":
        ctx_attn = n_attn * B * S * H * hd * 4.0          # QK^T + AV, 1 tok
    else:
        ctx_attn = n_attn * B * S * S * H * hd * 4.0 * 0.5 * bwd
    ctx_ssd = 0.0
    if cfg.ssm is not None and n_ssm:
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        Hs = d_in // s.head_dim
        if shape.kind == "decode":
            ctx_ssd = n_ssm * B * Hs * s.head_dim * s.d_state * 6.0
        else:
            per_tok = (s.chunk * (s.d_state + s.head_dim)        # scores+out
                       + 2 * s.d_state * s.head_dim)             # states
            ctx_ssd = n_ssm * B * S * Hs * per_tok * 2.0 * bwd

    # MoE dispatch/combine einsum overhead
    ovh = 0.0
    if cfg.moe is not None and n_moe:
        m = cfg.moe
        g = min(m.group_tokens, tok_dec)
        C = max(min(int(-(-g // m.num_experts) * m.top_k
                        * m.capacity_factor), g), m.top_k)
        # dispatch + combine einsums: 2 x (2*E*C*d) FLOPs per token
        ovh = n_moe * tok_dec * m.num_experts * C * cfg.d_model \
            * 2.0 * 2.0 * bwd

    # ---- HBM bytes ----
    P = total_params
    d = cfg.d_model
    if train:
        # bf16 weights read fwd + recompute + bwd; fp32 p/m/v read+write;
        # bf16 grads write+read
        w_traffic = P * (2 * 3 + 24 + 4)
        # residual stream per logical layer, bf16, fwd write+read + bwd pair
        act = cfg.num_layers * B * S * d * 2 * 4
        logits = B * S * cfg.padded_vocab * 2 * 3
        hbm = w_traffic + act + logits
    elif shape.kind == "prefill":
        w = P * 2
        act = cfg.num_layers * B * S * d * 2 * 3
        cache = _cache_bytes(cfg, B, S)
        hbm = w + act + cache
    else:
        w = P * 2
        cache = _cache_bytes(cfg, B, S) * 2   # read + write(update copy)
        hbm = w + cache + B * cfg.padded_vocab * 2
    return AnalyticCost(matmul, ctx_attn + ctx_ssd, ovh, float(hbm))


def _cache_bytes(cfg: ModelConfig, B: int, L: int) -> float:
    n_attn = sum(1 for i in range(cfg.num_layers)
                 if cfg.layer_kind(i) == "attn")
    n_ssm = sum(1 for i in range(cfg.num_layers)
                if cfg.layer_kind(i) == "ssm")
    total = 0.0
    if cfg.mla is not None:
        total += n_attn * B * L * (cfg.mla.kv_lora_rank
                                   + cfg.mla.qk_rope_dim) * 2
    else:
        total += n_attn * B * L * cfg.num_kv_heads * (cfg.head_dim or 0) \
            * 2 * 2
    if cfg.ssm is not None and n_ssm:
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        Hs = d_in // s.head_dim
        total += n_ssm * B * (Hs * s.head_dim * s.d_state * 4
                              + (s.conv_width - 1)
                              * (d_in + 2 * s.n_groups * s.d_state) * 2)
    if cfg.family == "audio":
        total += cfg.num_layers * B * cfg.audio.num_frames \
            * cfg.num_kv_heads * (cfg.head_dim or 0) * 2 * 2
    if cfg.family == "vlm":
        n_cross = sum(1 for i in range(cfg.num_layers)
                      if cfg.layer_kind(i) == "cross_attn")
        total += n_cross * B * cfg.vision.num_image_tokens \
            * cfg.num_kv_heads * (cfg.head_dim or 0) * 2 * 2
    return total


def collective_census(records) -> dict:
    """Per-kind bytes and counts of ``(kind, result bytes)`` records (the
    shape of the reference's ``collective_bytes_trip_corrected``)."""
    out = {k: 0 for k in COLLECTIVES}
    counts = {k: 0 for k in COLLECTIVES}
    for kind, nbytes in records:
        out[kind] += int(nbytes)
        counts[kind] += 1
    return {"bytes": out, "counts": counts,
            "total_bytes": int(sum(out.values()))}
