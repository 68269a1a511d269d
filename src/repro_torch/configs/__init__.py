"""Config registry: ``--arch <id>`` resolution (copy of ``repro.configs``
without the JAX-only input-spec helpers)."""
from __future__ import annotations

from repro_torch.configs.archs import (ARCHS, RB_PLANS, get_arch, rb,
                                       smoke_variant)
from repro_torch.configs.base import (AudioConfig, MLAConfig, ModelConfig,
                                      MoEConfig, SHAPES, ShapeConfig,
                                      SSMConfig, TrainConfig, VisionConfig)

__all__ = ["ARCHS", "RB_PLANS", "get_arch", "rb", "smoke_variant", "SHAPES",
           "ShapeConfig", "ModelConfig", "MoEConfig", "MLAConfig",
           "SSMConfig", "VisionConfig", "AudioConfig", "TrainConfig"]
