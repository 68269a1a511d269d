"""Config registry: ``--arch <id>`` resolution (copy of ``repro.configs``),
the modality inputs' shapes and seeded stub embeddings, and the per-(arch,
shape) input specs the dry-run walks against: ``shape_supported``,
``batch_specs`` and ``input_specs`` return meta tensors (shape and dtype,
no memory) where the reference returns ``jax.ShapeDtypeStruct``s."""
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
           "modality_shapes", "stub_extras", "input_specs", "batch_specs",
           "shape_supported"]


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


def shape_supported(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Grid-cell applicability (the reference's, unchanged)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "SKIP(full-attention: quadratic at 500k)"
    return True, ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _modality_extras(cfg: ModelConfig, batch: int, dtype) -> dict:
    return {name: _meta(shp, dtype)
            for name, shp in modality_shapes(cfg, batch).items()}


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Meta tensors for the data batch of one grid cell: int32 tokens (B, 1)
    for decode, (B, S) otherwise, and the modality extras in the compute
    dtype."""
    from repro_torch.device import torch_dtype
    B = shape.global_batch
    toks = (B, 1) if shape.kind == "decode" else (B, shape.seq_len)
    out = {"tokens": _meta(toks, torch.int32)}
    out.update(_modality_extras(cfg, B, torch_dtype(cfg.compute_dtype)))
    return out


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """All step-function inputs for the cell as meta tensors (batch, and
    for decode the caches of ``tfm.init_caches`` and an int32 0-d
    position)."""
    from repro_torch.device import torch_dtype
    from repro_torch.models import transformer as tfm
    specs = {"batch": batch_specs(cfg, shape)}
    if shape.kind == "decode":
        specs["caches"] = tfm.init_caches(
            cfg, shape.global_batch, shape.seq_len,
            dtype=torch_dtype(cfg.compute_dtype), device="meta")
        specs["pos"] = _meta((), torch.int32)
    return specs
