"""Model / run configuration dataclasses shared by every architecture.

A copy of ``repro.configs.base``: the port keeps its own so that it never
imports the JAX package.  Field for field equal to the reference (tested)."""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.prm import ReuseConfig


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0          # always-on shared experts (DeepSeek-V2)
    d_ff_shared: int = 0
    moe_every: int = 1           # MoE FFN on layers where i % moe_every == moe_offset
    moe_offset: int = 0
    first_dense: int = 0         # first k layers use a dense FFN (DeepSeek-V2)
    first_dense_d_ff: int = 0
    capacity_factor: float = 1.25
    group_tokens: int = 1024     # routing-group size (GShard G dimension)
    router_dtype: str = "float32"
    num_basic_experts: int = 0   # PRM across experts: E experts blended
                                 # from this many basic experts via OBU
                                 # shuffles (0 = off; beyond-paper)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk: int = 256
    conv_width: int = 4
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    num_image_tokens: int = 1601   # precomputed patch embeddings (stub frontend)
    d_vision: int = 7680           # stub embedding width before projection
    cross_attn_every: int = 5      # cross-attn at layers i % every == offset
    cross_attn_offset: int = 3


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    num_frames: int = 1500         # post-conv frame embeddings (stub frontend)
    d_audio: int = 128             # stub mel/frame feature width before projection
    encoder_layers: int = 24


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    rope_theta: float = 1e4
    norm: str = "rms"              # rms | layer
    norm_eps: float = 1e-5
    mlp_act: str = "swiglu"        # swiglu | gelu
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    vision: Optional[VisionConfig] = None
    audio: Optional[AudioConfig] = None
    attn_every: int = 1            # hybrid: attention at i % attn_every == attn_offset
    attn_offset: int = 0
    group_size: int = 1            # scan-group size (hybrid/vlm repeat unit)
    reuse: Optional[ReuseConfig] = None   # PRM schedule (None = no sharing)
    tie_embeddings: bool = False
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    fsdp: bool = False             # additionally shard params over the data axis
    sub_quadratic: bool = False    # can run long_500k (ssm / hybrid)
    padded_vocab: int = 0          # vocab rounded up for clean TP sharding
                                   # (Megatron-style; loss/sampling mask the pad)
    execution: str = "xla"         # matmul substrate: "xla" plain torch
                                   # matmuls or "photonic" W8A8 CUDA kernels
                                   # (core/backend.py; inference-only; the
                                   # name "xla" is kept from the reference)

    def __post_init__(self):
        if self.execution not in ("xla", "photonic"):
            raise ValueError(f"unknown execution backend {self.execution!r}")
        if self.head_dim is None and self.num_heads > 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)
        if self.group_size > 1 and self.num_layers % self.group_size != 0:
            raise ValueError("num_layers must divide into scan groups")
        if self.padded_vocab == 0:
            object.__setattr__(self, "padded_vocab",
                               -(-self.vocab_size // 256) * 256)

    @property
    def num_groups(self) -> int:
        return self.num_layers // self.group_size

    def layer_kind(self, i: int) -> str:
        """Sequence-mixer kind of logical layer ``i``."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid":
            return ("attn" if i % self.attn_every == self.attn_offset
                    else "ssm")
        if self.family == "vlm" and self.vision is not None:
            v = self.vision
            if i % v.cross_attn_every == v.cross_attn_offset:
                return "cross_attn"
        return "attn"

    def ffn_kind(self, i: int) -> str:
        if self.moe is None:
            return "dense" if self.d_ff > 0 else "none"
        if i < self.moe.first_dense:
            return "dense_first"
        if i % self.moe.moe_every == self.moe.moe_offset:
            return "moe"
        return "dense"


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One cell of the (arch x input-shape) grid."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def is_training(self) -> bool:
        return self.kind == "train"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    weight_decay: float = 0.01
    warmup_steps: int = 100
    total_steps: int = 1000
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    microbatch: int = 0            # 0 = no gradient accumulation
    checkpoint_every: int = 100
    checkpoint_dir: str = "/tmp/repro_ckpt"
    grad_allreduce_dtype: str = "bfloat16"   # collective compression
    seed: int = 0
