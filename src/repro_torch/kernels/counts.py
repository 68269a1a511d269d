"""The kernel wrappers' launch counters, read and written as one set.

Each wrapper adds one to its module-level counter on the host where it
launches its kernel.  A replayed CUDA graph launches its kernels without
running a wrapper, so a captured step counts nothing by itself: the cell
that owns the graph (``repro_torch.graphs.DecodeCell``) records the
difference its capture made (:func:`snapshot` before and after,
:func:`difference`), takes it back out (:func:`restore`: the capture
recorded the launches, it did not run them) and adds it on each replay
(:func:`add`).  The counts then equal those of the same steps run
eagerly.
"""
from __future__ import annotations

from repro_torch.kernels import blend as _blend
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import photonic_mvm as _pm
from repro_torch.kernels import ssd as _ssd

# name -> (module, attribute) of every launch counter
COUNTERS = {
    "photonic_mvm_fused": (_pm, "launches"),
    "photonic_mvm_fused_gemv": (_pm, "launches_gemv"),
    "photonic_mvm": (_pm, "launches_mvm"),
    "photonic_mvm_t": (_pm, "launches_mvm_t"),
    "photonic_mvm_resident": (_pm, "launches_resident"),
    "blend_shuffle": (_blend, "launches"),
    "flash_attention": (_fa, "launches"),
    "flash_attention_mma": (_fa, "launches_mma"),
    "flash_attention_causal": (_fa, "launches_causal"),
    "ssd_chunk": (_ssd, "launches"),
    "decode_attention": (_da, "launches"),
}


def snapshot() -> dict:
    """Every counter's current value, by name."""
    return {name: getattr(mod, attr) for name, (mod, attr) in
            COUNTERS.items()}


def difference(before: dict, after: dict) -> dict:
    """``after - before`` per counter."""
    return {name: after[name] - before[name] for name in COUNTERS}


def add(delta: dict) -> None:
    """Add ``delta`` to the counters (a replay's launches)."""
    for name, (mod, attr) in COUNTERS.items():
        setattr(mod, attr, getattr(mod, attr) + delta[name])


def restore(values: dict) -> None:
    """Set every counter to ``values``."""
    for name, (mod, attr) in COUNTERS.items():
        setattr(mod, attr, values[name])


def reset() -> None:
    """Set every counter to 0."""
    restore(dict.fromkeys(COUNTERS, 0))
