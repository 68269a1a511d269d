"""Config registry: ``--arch <id>`` resolution (copy of ``repro.configs``),
and the modality inputs' shapes and seeded stub embeddings (the torch
counterpart of its ``_modality_extras``)."""
from __future__ import annotations

import torch

from repro_torch.configs.archs import (ARCHS, RB_PLANS, get_arch, rb,
                                       smoke_variant)
from repro_torch.configs.base import (AudioConfig, MLAConfig, ModelConfig,
                                      MoEConfig, SHAPES, ShapeConfig,
                                      SSMConfig, TrainConfig, VisionConfig)

__all__ = ["ARCHS", "RB_PLANS", "get_arch", "rb", "smoke_variant", "SHAPES",
           "ShapeConfig", "ModelConfig", "MoEConfig", "MLAConfig",
           "SSMConfig", "VisionConfig", "AudioConfig", "TrainConfig",
           "modality_shapes", "stub_extras"]


def modality_shapes(cfg: ModelConfig, batch: int) -> dict:
    """Shapes of the modality extras a forward of ``batch`` rows takes:
    vlm ``image_embeds`` (B, image tokens, d_vision), audio
    ``audio_embeds`` (B, frames, d_audio); none for other families."""
    if cfg.family == "vlm":
        v = cfg.vision
        return {"image_embeds": (batch, v.num_image_tokens, v.d_vision)}
    if cfg.family == "audio":
        a = cfg.audio
        return {"audio_embeds": (batch, a.num_frames, a.d_audio)}
    return {}


def stub_extras(cfg: ModelConfig, batch: int,
                generator: torch.Generator) -> dict:
    """Seeded stub embeddings for the modality extras of ``batch`` rows:
    float32 N(0, 1) draws from ``generator``, on its device, as the
    reference's serving launcher and examples feed its stub frontends.
    Empty for families without a memory stream."""
    return {name: torch.randn(shp, generator=generator,
                              device=generator.device)
            for name, shp in modality_shapes(cfg, batch).items()}
