"""The 10 assigned architectures, exact configs from the assignment sheet.

A copy of ``repro.configs.archs`` (the port never imports the JAX package).

Each ``<id>()`` returns the published configuration; ``rb(cfg, R, T)`` wraps
any of them with a PRM reuse schedule (the paper's technique applied to that
arch — see DESIGN.md §Arch-applicability).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (AudioConfig, MLAConfig, ModelConfig,
                                MoEConfig, SSMConfig, VisionConfig)
from repro_torch.core.prm import ReuseConfig

DEFAULT_TRANSFORMS = ("identity", "shuffle", "transpose", "shuffle")
SSM_TRANSFORMS = ("identity", "shuffle")   # optical transpose has no analogue
                                           # inside the SSD scan (DESIGN.md)


def rb(cfg: ModelConfig, num_basic: int, reuse_times: int,
       transforms=None) -> ModelConfig:
    """R&B variant of an arch: share `num_basic` basic groups x `reuse_times`."""
    tr = transforms or (SSM_TRANSFORMS if cfg.family in ("ssm", "hybrid")
                        else DEFAULT_TRANSFORMS)
    return dataclasses.replace(
        cfg, reuse=ReuseConfig(granularity="block", num_basic=num_basic,
                               reuse_times=reuse_times, transforms=tr,
                               shuffle_groups=8))


# -------------------------------------------------------------------------
def jamba_v0_1_52b() -> ModelConfig:
    """Mamba+attn 1:7 interleave, MoE every 2 layers [arXiv:2403.19887]."""
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid", num_layers=32, d_model=4096,
        num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=65536,
        head_dim=128, attn_every=8, attn_offset=4, group_size=8,
        ssm=SSMConfig(d_state=16, head_dim=64, expand=2, chunk=256),
        moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336,
                      moe_every=2, moe_offset=1),
        fsdp=True, sub_quadratic=True)


def granite_moe_1b_a400m() -> ModelConfig:
    """32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base]."""
    return ModelConfig(
        name="granite-moe-1b-a400m", family="moe", num_layers=24,
        d_model=1024, num_heads=16, num_kv_heads=8, d_ff=512,
        vocab_size=49155, head_dim=64,
        # small experts (512-wide): small routing groups keep the dispatch
        # one-hots proportionally small (§Perf granite iteration)
        moe=MoEConfig(num_experts=32, top_k=8, d_ff_expert=512,
                      group_tokens=256),
        tie_embeddings=True)


def deepseek_v2_lite_16b() -> ModelConfig:
    """MLA kv_lora=512, 2 shared + 64 routed top-6 [arXiv:2405.04434]."""
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe", num_layers=27,
        d_model=2048, num_heads=16, num_kv_heads=16, d_ff=1408,
        vocab_size=102400, head_dim=192,
        mla=MLAConfig(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                      v_head_dim=128),
        moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                      num_shared=2, d_ff_shared=2816,
                      first_dense=1, first_dense_d_ff=10944))


def minitron_4b() -> ModelConfig:
    """Pruned nemotron [arXiv:2407.14679]."""
    return ModelConfig(
        name="minitron-4b", family="dense", num_layers=32, d_model=3072,
        num_heads=24, num_kv_heads=8, d_ff=9216, vocab_size=256000,
        head_dim=128)


def deepseek_7b() -> ModelConfig:
    """Llama-arch MHA [arXiv:2401.02954]."""
    return ModelConfig(
        name="deepseek-7b", family="dense", num_layers=30, d_model=4096,
        num_heads=32, num_kv_heads=32, d_ff=11008, vocab_size=102400,
        head_dim=128)


def mistral_large_123b() -> ModelConfig:
    """[hf:mistralai/Mistral-Large-Instruct-2407]."""
    return ModelConfig(
        name="mistral-large-123b", family="dense", num_layers=88,
        d_model=12288, num_heads=96, num_kv_heads=8, d_ff=28672,
        vocab_size=32768, head_dim=128, fsdp=True)


def phi3_medium_14b() -> ModelConfig:
    """RoPE SwiGLU GQA [arXiv:2404.14219]."""
    return ModelConfig(
        name="phi3-medium-14b", family="dense", num_layers=40, d_model=5120,
        num_heads=40, num_kv_heads=10, d_ff=17920, vocab_size=100352,
        head_dim=128)


def llama_3_2_vision_11b() -> ModelConfig:
    """Cross-attn image layers every 5th [hf:meta-llama/Llama-3.2-11B-Vision].
    Vision frontend is a stub: input_specs() provides patch embeddings."""
    return ModelConfig(
        name="llama-3.2-vision-11b", family="vlm", num_layers=40,
        d_model=4096, num_heads=32, num_kv_heads=8, d_ff=14336,
        vocab_size=128256, head_dim=128, group_size=5,
        vision=VisionConfig(num_image_tokens=1601, d_vision=7680,
                            cross_attn_every=5, cross_attn_offset=3))


def whisper_medium() -> ModelConfig:
    """Enc-dec; conv frontend stub supplies frame embeddings
    [arXiv:2212.04356].  Backbone-only per the assignment."""
    return ModelConfig(
        name="whisper-medium", family="audio", num_layers=24, d_model=1024,
        num_heads=16, num_kv_heads=16, d_ff=4096, vocab_size=51865,
        head_dim=64, norm="layer", mlp_act="gelu",
        audio=AudioConfig(num_frames=1500, d_audio=128, encoder_layers=24))


def mamba2_780m() -> ModelConfig:
    """SSD (state-space duality) [arXiv:2405.21060]."""
    return ModelConfig(
        name="mamba2-780m", family="ssm", num_layers=48, d_model=1536,
        num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=50280,
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=256),
        sub_quadratic=True)


ARCHS = {
    "jamba-v0.1-52b": jamba_v0_1_52b,
    "granite-moe-1b-a400m": granite_moe_1b_a400m,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
    "minitron-4b": minitron_4b,
    "deepseek-7b": deepseek_7b,
    "mistral-large-123b": mistral_large_123b,
    "phi3-medium-14b": phi3_medium_14b,
    "llama-3.2-vision-11b": llama_3_2_vision_11b,
    "whisper-medium": whisper_medium,
    "mamba2-780m": mamba2_780m,
}

# R&B (PRM-shared) variant of every arch: number of basic groups x reuses.
RB_PLANS = {
    "jamba-v0.1-52b": (2, 2),          # 4 scan groups of 8 layers
    "granite-moe-1b-a400m": (6, 4),
    "deepseek-v2-lite-16b": (13, 2),   # 26 shared MoE layers (1 dense pre)
    "minitron-4b": (8, 4),
    "deepseek-7b": (10, 3),
    "mistral-large-123b": (11, 8),
    "phi3-medium-14b": (10, 4),
    "llama-3.2-vision-11b": (4, 2),    # 8 scan groups of 5 layers
    "whisper-medium": (6, 4),          # applied to both 24-layer stacks
    "mamba2-780m": (12, 4),
}


def get_arch(name: str, reuse: bool = False) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    cfg = ARCHS[name]()
    if reuse:
        r, t = RB_PLANS[name]
        cfg = rb(cfg, r, t)
    return cfg


# -------------------------------------------------------------------------
# reduced smoke-test variants (same family topology, tiny dims)
# -------------------------------------------------------------------------
def smoke_variant(name: str) -> ModelConfig:
    cfg = get_arch(name)
    kw = dict(d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
              vocab_size=211, head_dim=16)
    if cfg.family == "hybrid":
        kw.update(num_layers=8, group_size=8, attn_every=8, attn_offset=4,
                  ssm=SSMConfig(d_state=8, head_dim=16, expand=2, chunk=8),
                  moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=32,
                                moe_every=2, moe_offset=1,
                                capacity_factor=4.0))
    elif cfg.family == "ssm":
        kw.update(num_layers=4, num_heads=0, num_kv_heads=0, d_ff=0,
                  ssm=SSMConfig(d_state=8, head_dim=16, expand=2, chunk=8))
    elif cfg.mla is not None:
        kw.update(num_layers=3, num_kv_heads=4,
                  mla=MLAConfig(kv_lora_rank=16, qk_nope_dim=8,
                                qk_rope_dim=4, v_head_dim=8),
                  moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=32,
                                num_shared=1, d_ff_shared=32, first_dense=1,
                                first_dense_d_ff=96, capacity_factor=4.0))
    elif cfg.family == "moe":
        kw.update(num_layers=4,
                  moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=32,
                                capacity_factor=4.0))
    elif cfg.family == "vlm":
        kw.update(num_layers=10, group_size=5,
                  vision=VisionConfig(num_image_tokens=9, d_vision=24,
                                      cross_attn_every=5,
                                      cross_attn_offset=3))
    elif cfg.family == "audio":
        kw.update(num_layers=2, num_kv_heads=4,
                  audio=AudioConfig(num_frames=13, d_audio=12,
                                    encoder_layers=2))
    else:  # dense
        kw.update(num_layers=4)
    kw["name"] = cfg.name + "-smoke"
    kw["compute_dtype"] = "float32"
    kw["fsdp"] = False
    return dataclasses.replace(cfg, reuse=None, **kw)
