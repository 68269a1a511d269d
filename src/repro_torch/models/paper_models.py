"""The paper's own evaluation models: MLP, MLP-Mixer, VGG-13, ResNet-18 —
each with PRM weight sharing + OBU transforms (port of
``repro.models.paper_models``).

These are the models behind Tables 4/5.  Dims the paper leaves unspecified
are the reference's, chosen to land on the paper's parameter counts:

  MLP        784-176-(176x176 x6)-10          -> 0.36M  (paper: 0.36M)
  MLP-Mixer  patch4 C=128 token64 ch256, 8 blk -> ~0.66M (paper: 0.68M)
  VGG-13     CIFAR conv stack                  -> ~9.4M  (paper: 9.42M)
  ResNet-18  CIFAR stem                        -> ~11.2M (paper: 9.22M*)
  (*the paper's count likely excludes some shortcuts; ours is the standard.)

Params are the reference's trees (nested dicts; VGG's ``convs`` and
``shared_map`` and ResNet's ``stages`` are lists), with its shapes:
images are NHWC and conv kernels HWIO, as in the reference, so
``param_count``, the flattened keys and ``bridge.paper_params_from_flat``
line up.  Each convolution permutes to torch's NCHW / OIHW at its
use-site (a view: an NHWC tensor is NCHW in channels-last strides), and
pads as XLA's ``"SAME"`` does (:func:`same_pads`), which at stride 2 is
asymmetric.  Init functions draw from the ``torch.Generator`` they are
given, on its device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.obu import blend_dot
from repro_torch.core.prm import ReuseConfig
from repro_torch.core.sharing import (SharedStack, run_stack, stacked_init,
                                      tree_leaves, tree_map)
from repro_torch.models.layers import apply_norm, dense_init, gelu, init_norm


# =========================================================================
# MLP (MNIST-scale)
# =========================================================================
@dataclasses.dataclass(frozen=True)
class MLPConfig:
    d_in: int = 784
    width: int = 176
    depth: int = 6                 # hidden width x width layers
    classes: int = 10
    reuse: Optional[ReuseConfig] = None


def mlp_init(generator: torch.Generator, cfg: MLPConfig):
    dev = generator.device
    shared = SharedStack.build(cfg.depth, cfg.width, cfg.reuse)
    params = {
        "w_in": dense_init((cfg.d_in, cfg.width), generator, dev),
        "hidden": stacked_init(
            lambda g: {"w": dense_init((cfg.width, cfg.width), g, dev)},
            generator, shared.num_physical),
        "w_out": dense_init((cfg.width, cfg.classes), generator, dev),
    }
    return params, shared


def mlp_forward(params, cfg: MLPConfig, shared: SharedStack, x):
    h = torch.relu(blend_dot(x, params["w_in"], transpose=False))

    def block(p, h, cache, aux, *, transpose, reuse_index):
        return torch.relu(blend_dot(h, p["w"], transpose=transpose)), \
            cache, aux

    h, _, _ = run_stack(block, params["hidden"], h, shared)
    return blend_dot(h, params["w_out"], transpose=False)


def mlp_weight_shapes(cfg: MLPConfig):
    """(rows, cols) of every matrix in one basic hidden block (cost model)."""
    return [(cfg.width, cfg.width)]


# =========================================================================
# MLP-Mixer (CIFAR-scale)
# =========================================================================
@dataclasses.dataclass(frozen=True)
class MixerConfig:
    image: int = 32
    patch: int = 4
    channels: int = 128
    token_mlp: int = 64
    channel_mlp: int = 256
    blocks: int = 8
    classes: int = 10
    reuse: Optional[ReuseConfig] = None

    @property
    def tokens(self) -> int:
        return (self.image // self.patch) ** 2


def mixer_init(generator: torch.Generator, cfg: MixerConfig):
    dev = generator.device
    shared = SharedStack.build(cfg.blocks, cfg.channels, cfg.reuse)
    S, C = cfg.tokens, cfg.channels

    def one_block(g):
        return {"tok_w1": dense_init((S, cfg.token_mlp), g, dev),
                "tok_w2": dense_init((cfg.token_mlp, S), g, dev),
                "ch_w1": dense_init((C, cfg.channel_mlp), g, dev),
                "ch_w2": dense_init((cfg.channel_mlp, C), g, dev),
                "norm1": init_norm(C, dev, kind="layer"),
                "norm2": init_norm(C, dev, kind="layer")}

    params = {
        "embed": dense_init((cfg.patch * cfg.patch * 3, C), generator, dev),
        "blocks": stacked_init(one_block, generator, shared.num_physical),
        "norm": init_norm(C, dev, kind="layer"),
        "head": dense_init((C, cfg.classes), generator, dev),
    }
    return params, shared


def _patchify(x, patch):
    B, H, W, C3 = x.shape
    hp, wp = H // patch, W // patch
    x = x.reshape(B, hp, patch, wp, patch, C3)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, hp * wp, patch * patch * C3)


def mixer_forward(params, cfg: MixerConfig, shared: SharedStack, images):
    h = blend_dot(_patchify(images, cfg.patch), params["embed"],
                  transpose=False)

    def block(p, h, cache, aux, *, transpose, reuse_index):
        # token mixing (the model's own inner transpose)
        y = apply_norm(p["norm1"], h, "layer")
        y = y.transpose(-1, -2)                           # (B, C, S)
        y = blend_dot(y, p["tok_w1"], transpose=False)
        y = blend_dot(gelu(y), p["tok_w2"], transpose=False)
        h = h + y.transpose(-1, -2)
        # channel mixing — OBU transpose swaps the ch-MLP in/out projections
        y = apply_norm(p["norm2"], h, "layer")
        if transpose:
            y = blend_dot(y, p["ch_w2"], transpose=True)
            y = blend_dot(gelu(y), p["ch_w1"], transpose=True)
        else:
            y = blend_dot(y, p["ch_w1"], transpose=False)
            y = blend_dot(gelu(y), p["ch_w2"], transpose=False)
        return h + y, cache, aux

    h, _, _ = run_stack(block, params["blocks"], h, shared)
    h = apply_norm(params["norm"], h, "layer")
    return blend_dot(h.mean(dim=1), params["head"], transpose=False)


def mixer_weight_shapes(cfg: MixerConfig):
    return [(cfg.tokens, cfg.token_mlp), (cfg.token_mlp, cfg.tokens),
            (cfg.channels, cfg.channel_mlp),
            (cfg.channel_mlp, cfg.channels)]


# =========================================================================
# conv helpers (VGG / ResNet)
# =========================================================================
def _conv_init(generator: torch.Generator, cin, cout, k=3):
    scale = 1.0 / math.sqrt(cin * k * k)
    return torch.randn((k, k, cin, cout), generator=generator,
                       dtype=torch.float32, device=generator.device) * scale


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: the output has
    ``ceil(size / stride)`` positions, the total pad is
    ``max((out - 1) * stride + k - size, 0)`` and the low side takes the
    floor of half.  At stride 2 on an even size that is (0, 1) for a 3x3
    kernel, where torch's symmetric ``padding=1`` would shift the grid."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride=1):
    """``conv_general_dilated(x, w, stride, "SAME")`` on NHWC x and HWIO w,
    returning NHWC."""
    kh, kw = w.shape[0], w.shape[1]
    (ht, hb), (wl, wr) = (same_pads(x.shape[1], kh, stride),
                          same_pads(x.shape[2], kw, stride))
    xc = x.permute(0, 3, 1, 2)                     # NCHW, channels-last view
    wc = w.permute(3, 2, 0, 1)                     # OIHW
    if ht == hb and wl == wr:
        y = F.conv2d(xc, wc, stride=stride, padding=(ht, wl))
    else:
        y = F.conv2d(F.pad(xc, (wl, wr, ht, hb)), wc, stride=stride)
    return y.permute(0, 2, 3, 1)


def _max_pool(x):
    """2x2 max over NHWC, stride 2, ``"VALID"``."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


VGG13_PLAN = [64, 64, "M", 128, 128, "M", 256, 256, "M",
              512, 512, "M", 512, 512, "M"]


@dataclasses.dataclass(frozen=True)
class VGGConfig:
    classes: int = 10
    share_same_shape: bool = False   # R&B: share same-shape conv pairs


def vgg13_init(generator: torch.Generator, cfg: VGGConfig):
    """``shared_map`` holds static Python ints (the physical conv of each
    logical one), never tensors."""
    params = {"convs": [], "shared_map": []}
    cin = 3
    seen: dict = {}
    for item in VGG13_PLAN:
        if item == "M":
            continue
        shape = (cin, item)
        if cfg.share_same_shape and shape in seen:
            params["shared_map"].append(seen[shape])      # reuse physical idx
        else:
            params["convs"].append(_conv_init(generator, cin, item))
            idx = len(params["convs"]) - 1
            params["shared_map"].append(idx)
            if cfg.share_same_shape:
                seen[shape] = idx
        cin = item
    params["head"] = dense_init((512, cfg.classes), generator,
                                generator.device)
    return params


def vgg13_forward(params, cfg: VGGConfig, x):
    ci = 0
    for item in VGG13_PLAN:
        if item == "M":
            x = _max_pool(x)
            continue
        w = params["convs"][params["shared_map"][ci]]
        x = torch.relu(_conv(x, w))
        ci += 1
    x = x.mean(dim=(1, 2))
    return blend_dot(x, params["head"], transpose=False)


def vgg13_weight_shapes(cfg: VGGConfig, shared: bool):
    """Flattened (rows, cols) matrices for the photonic cost model; conv
    kxkxCinxCout maps onto the crossbar as (k*k*Cin, Cout)."""
    shapes, programs = [], []
    cin = 3
    seen = {}
    for item in VGG13_PLAN:
        if item == "M":
            continue
        key = (cin, item)
        is_new = not (shared and key in seen)
        shapes.append((9 * cin, item))
        programs.append(1 if is_new else 0)
        seen[key] = True
        cin = item
    return shapes, programs


RESNET18_STAGES = [(64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2)]


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    classes: int = 10
    share_within_stage: bool = False   # R&B: 2nd block reuses the 1st


def resnet18_init(generator: torch.Generator, cfg: ResNetConfig):
    """CIFAR ResNet-18.  With ``share_within_stage`` every stage keeps only
    its downsampling block; the stride-1 residual blocks *reuse* the
    downsample block's (cout, cout) conv — valid same-shape PRM sharing."""
    params = {"stem": _conv_init(generator, 3, 64), "stages": []}
    cin = 64
    for cout, blocks, stride in RESNET18_STAGES:
        stage = [{"c1": _conv_init(generator, cin, cout),
                  "c2": _conv_init(generator, cout, cout)}]
        if stride != 1 or cin != cout:
            stage[0]["proj"] = _conv_init(generator, cin, cout, k=1)
        if not cfg.share_within_stage:
            for _ in range(blocks - 1):
                stage.append({"c1": _conv_init(generator, cout, cout),
                              "c2": _conv_init(generator, cout, cout)})
        params["stages"].append(stage)
        cin = cout
    params["head"] = dense_init((512, cfg.classes), generator,
                                generator.device)
    return params


def resnet18_forward(params, cfg: ResNetConfig, x):
    x = torch.relu(_conv(x, params["stem"]))
    for (cout, blocks, stride), stage in zip(RESNET18_STAGES,
                                             params["stages"]):
        blk0 = stage[0]
        h = torch.relu(_conv(x, blk0["c1"], stride=stride))
        h = _conv(h, blk0["c2"])
        sc = _conv(x, blk0["proj"], stride=stride) if "proj" in blk0 else x
        x = torch.relu(h + sc)
        for b in range(1, blocks):
            if cfg.share_within_stage:
                blk = {"c1": blk0["c2"], "c2": blk0["c2"]}  # PRM reuse
            else:
                blk = stage[b]
            h = torch.relu(_conv(x, blk["c1"]))
            h = _conv(h, blk["c2"])
            x = torch.relu(h + x)
    x = x.mean(dim=(1, 2))
    return blend_dot(x, params["head"], transpose=False)


def param_count(tree) -> int:
    """Elements over the leaves that have a shape (VGG's ``shared_map``
    ints are skipped)."""
    return int(sum(math.prod(x.shape) for x in tree_leaves(tree)
                   if hasattr(x, "shape")))


def to_device(tree, device):
    """The same tree with every tensor moved to ``device`` (ints stay)."""
    return tree_map(lambda t: t.to(device) if isinstance(t, torch.Tensor)
                    else t, tree)
