"""repro_torch.resident — global weight-bank residency (DESIGN.md §Bank
residency): the paper's write-amortization economics as a first-class
scheduling subsystem (copy of ``repro.resident``).

  * :mod:`repro_torch.resident.manager` — :class:`BankResidencyManager`, a
    bounded MRR-array bank cache (128-tile budget) with cost-model +
    aging-aware eviction, and :class:`ProgramResidency`, the per-Program
    binding the serving scheduler drives;
  * :mod:`repro_torch.resident.mapping` — layer-wise hybrid mapping of hot
    (resident) vs cold (streamed) layers under the array budget;
  * :mod:`repro_torch.resident.cosched` — residency-aware admission and the
    cross-Program bank-affine co-scheduler.

``manager`` and ``mapping`` import eagerly (leaves over ``core/``);
``cosched`` loads lazily — it imports the serving scheduler, which must
stay importable without this package.
"""
from repro_torch.resident.manager import (  # noqa: F401
    Access, BankResidencyManager, BankSpec, DriftClock, ProgramResidency,
    specs_from_profile, specs_from_program,
)
from repro_torch.resident.mapping import (  # noqa: F401
    MappingPlan, plan_hybrid_mapping,
)

_LAZY = {
    "ResidencyAwareAdmission": ("repro_torch.resident.cosched",
                                "ResidencyAwareAdmission"),
    "BankAffineCoScheduler": ("repro_torch.resident.cosched",
                              "BankAffineCoScheduler"),
    "group_by_affinity": ("repro_torch.resident.cosched", "group_by_affinity"),
    "interleave_fifo": ("repro_torch.resident.cosched", "interleave_fifo"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'repro_torch.resident' has no attribute {name!r}")
