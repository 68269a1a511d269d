"""Photonic Reuse Method (PRM) — paper §3.1.

PRM schedules weight writes so one *basic weight block* serves several logical
layers/blocks.  An ``M``-block network ``N_M = [b_1 .. b_M]`` is covered by
``R`` basic blocks, each reused ``T`` times (``M = R * T``), with an OBU
transform (identity / shuffle / transpose — §3.2) applied between reuses:

    [b_m, .., b_{m+P}] = [b_reuse^1, .., b_reuse^P]        (paper eq. 4/5)

On the photonic target this cuts MRR writes from ``min(N,B)*K*C`` to
``min(N,B)`` (paper Table 2).  On the GPU the same plan keeps one programmed
int8 bank per basic block that all ``T`` reuses stream through, so the bank
bytes held in device memory drop by the reuse factor ``T``.

A copy of ``repro.core.prm`` (framework-free; the port keeps its own).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

TRANSFORMS = ("identity", "shuffle", "transpose", "shuffle_transpose")


@dataclasses.dataclass(frozen=True)
class ReuseConfig:
    """Configuration of the PRM schedule for one homogeneous stack.

    Attributes:
      granularity: "layer" (eq. 5) or "block" (eq. 4).  A *block* is the
        architecture's minimal repeated unit (Mixer block, residual block,
        transformer block, jamba 8-layer group ...).
      num_basic:   R — number of physically-programmed basic blocks.
      reuse_times: T — times each basic block is (re)used.  R*T must equal the
        stack's logical depth.
      transforms:  cycle of OBU transforms; entry ``t`` is applied at reuse
        index ``t`` (index 0 is the first use and is normally "identity").
      shuffle_groups: ``g`` of the channel-group shuffle (paper §3.2 method 2).
      shuffle_block:  block size of the blocked random shuffle (method 1);
        0 selects the group-shuffle flavor.
      seed: RNG seed for the fixed random permutations (drawn once, static).
    """

    granularity: str = "block"
    num_basic: int = 1
    reuse_times: int = 1
    transforms: tuple[str, ...] = ("identity",)
    shuffle_groups: int = 4
    shuffle_block: int = 0
    seed: int = 0

    def __post_init__(self):
        if self.granularity not in ("layer", "block"):
            raise ValueError(f"bad granularity {self.granularity!r}")
        if self.num_basic < 1 or self.reuse_times < 1:
            raise ValueError("num_basic and reuse_times must be >= 1")
        for t in self.transforms:
            if t not in TRANSFORMS:
                raise ValueError(f"unknown OBU transform {t!r}")

    @property
    def logical_depth(self) -> int:
        return self.num_basic * self.reuse_times

    def transform_at(self, reuse_index: int) -> str:
        """OBU transform used at reuse index ``t`` (cycled)."""
        if not self.transforms:
            return "identity"
        return self.transforms[reuse_index % len(self.transforms)]


def no_reuse(depth: int) -> ReuseConfig:
    """The baseline schedule: every logical layer has its own weights."""
    return ReuseConfig(granularity="layer", num_basic=depth, reuse_times=1)


@dataclasses.dataclass(frozen=True)
class Assignment:
    """One logical layer's slot in the PRM schedule."""

    logical_index: int
    physical_index: int
    reuse_index: int
    transform: str


@dataclasses.dataclass(frozen=True)
class ReusePlan:
    """Fully-resolved PRM schedule for a stack of ``depth`` logical layers."""

    config: ReuseConfig
    depth: int
    assignments: tuple[Assignment, ...]

    @staticmethod
    def build(depth: int, config: ReuseConfig | None) -> "ReusePlan":
        config = config or no_reuse(depth)
        if config.logical_depth != depth:
            raise ValueError(
                f"ReuseConfig covers {config.logical_depth} logical layers "
                f"(R={config.num_basic} x T={config.reuse_times}) but the stack "
                f"has depth {depth}")
        assignments = []
        for i in range(depth):
            r, t = divmod(i, config.reuse_times)  # block-contiguous reuse
            assignments.append(Assignment(
                logical_index=i, physical_index=r, reuse_index=t,
                transform=config.transform_at(t)))
        return ReusePlan(config=config, depth=depth,
                         assignments=tuple(assignments))

    # ------------------------------------------------------------------ stats
    @property
    def num_physical(self) -> int:
        return self.config.num_basic

    @property
    def reuse_times(self) -> int:
        return self.config.reuse_times

    def param_reduction(self) -> float:
        """Fraction of stack parameters removed vs. the no-reuse baseline."""
        return 1.0 - self.num_physical / self.depth

    def mrr_write_programs(self) -> int:
        """Number of *weight-block programmings* (the paper's K after PRM)."""
        return self.num_physical

    def baseline_write_programs(self) -> int:
        return self.depth

    def validate_cover(self) -> None:
        """Every logical layer is assigned exactly once; physical blocks are
        used exactly ``reuse_times`` times each (invariant; property-tested)."""
        seen_logical = [a.logical_index for a in self.assignments]
        assert seen_logical == list(range(self.depth))
        counts: dict[int, int] = {}
        for a in self.assignments:
            counts[a.physical_index] = counts.get(a.physical_index, 0) + 1
        assert set(counts) == set(range(self.num_physical))
        assert all(c == self.reuse_times for c in counts.values())


def segment_plans(depths: Sequence[int],
                  configs: Sequence[ReuseConfig | None]) -> list[ReusePlan]:
    """Build one plan per independent stack segment (e.g. encoder + decoder)."""
    if len(depths) != len(configs):
        raise ValueError("depths and configs length mismatch")
    return [ReusePlan.build(d, c) for d, c in zip(depths, configs)]
