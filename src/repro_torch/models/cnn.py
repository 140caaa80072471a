"""Reduced CNN families for the paper's behavioural experiments (PyTorch port
of `repro.models.cnn`).

AlexNet / VGG16 / ResNet18 / MobileNetV3 at CIFAR scale, every conv/fc
lowered to im2col + matmul so the contraction routes through a
`rosa.Engine` with a per-layer execution plan, the knob the paper's hybrid
mapping turns.  Widths are the reference's; layer names match
`configs/paper_cnns.py`, so behavioural noise profiles join against the
full-size EDP table rows.

Layouts are the reference's, so its parameters carry across unchanged
(`models.model.params_from_reference`): images NHWC; a conv weight is
(C_in*k*k, C_out) with patch lanes in (C, kh, kw) order; a depthwise
weight is (C, k*k).

API:
    specs  = LITE_MODELS["alexnet"]
    skel   = cnn_def(specs)
    engine = rosa.Engine.from_config(cfg, layers=[s.name for s in specs])
    logits = cnn_apply(params, specs, images, engine)
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import rosa
from repro_torch.models.module import ParamDef


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    name: str
    kind: str              # conv | dwconv | fc
    c_in: int
    c_out: int
    k: int = 3
    stride: int = 1
    pool: int = 1          # avg-pool factor applied after activation
    act: bool = True


def same_padding(size: int, k: int, stride: int) -> tuple[int, int]:
    """(before, after) padding of one spatial axis under SAME: the output
    has ceil(size / stride) positions and the odd pixel goes after, as
    XLA pads (stride 2 on an even input: 0 before, 1 after for k = 3)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _im2col(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """x: (B, H, W, C) -> (B, H', W', C*k*k) patches (SAME padding), lanes
    in (C, kh, kw) order like `conv_general_dilated_patches`.  Pure
    indexing, so it runs on `meta` tensors and is exact."""
    _, h, w, _ = x.shape
    ph, pw = same_padding(h, k, stride), same_padding(w, k, stride)
    xp = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    ho, wo = -(-h // stride), -(-w // stride)
    taps = [xp[:, dy:dy + (ho - 1) * stride + 1:stride,
               dx:dx + (wo - 1) * stride + 1:stride, :]
            for dy in range(k) for dx in range(k)]
    patches = torch.stack(taps, dim=-1)              # (B, H', W', C, k*k)
    return patches.reshape(*patches.shape[:3], -1)


def cnn_def(specs: list[ConvSpec], n_classes: int = 10) -> dict:
    p: dict = {}
    for s in specs:
        if s.kind == "fc":
            p[s.name] = {"w": ParamDef((s.c_in, s.c_out), (None, None)),
                         "b": ParamDef((s.c_out,), (None,), "zeros")}
        elif s.kind == "dwconv":
            p[s.name] = {"w": ParamDef((s.c_in, s.k * s.k), (None, None)),
                         "b": ParamDef((s.c_in,), (None,), "zeros")}
        else:
            p[s.name] = {"w": ParamDef((s.c_in * s.k * s.k, s.c_out),
                                       (None, None)),
                         "b": ParamDef((s.c_out,), (None,), "zeros")}
    return p


def cnn_apply(params: dict, specs: list[ConvSpec], x: torch.Tensor,
              engine: rosa.Engine | None = None,
              key: torch.Generator | None = None,
              residual_from: dict[str, str] | None = None) -> torch.Tensor:
    """Forward; x: (B, 32, 32, 3) -> logits (B, n_classes).

    `engine` routes every contraction by layer name (None = all-dense);
    `key` overrides the engine's base key for this call (per-layer noise
    keys fold from it).  residual_from: {layer_name: earlier_layer_name}
    adds skip connections (ResNet family); spatial dims must match.
    """
    if engine is None:
        engine = rosa.Engine.dense()
    if key is not None:
        engine = engine.with_key(key)
    saved: dict[str, torch.Tensor] = {}

    for s in specs:
        p = params[s.name]
        if s.kind == "fc":
            if x.ndim > 2:
                x = x.mean(dim=(1, 2)) if x.shape[1] > 1 \
                    else x.reshape(x.shape[0], -1)
            y = engine.matmul(x, p["w"], name=s.name) + p["b"]
        elif s.kind == "dwconv":
            patches = _im2col(x, s.k, s.stride)
            b, h, w_, _ = patches.shape
            pr = patches.reshape(b, h, w_, s.c_in, s.k * s.k)
            # per-channel contraction: the weight is noise-placed by the
            # engine, the contraction is an einsum (C tiny sub-GEMMs)
            w_eff = engine.effective_weight(p["w"], name=s.name)
            y = torch.einsum("bhwck,ck->bhwc", pr, w_eff) + p["b"]
        else:
            patches = _im2col(x, s.k, s.stride)
            b, h, w_, kk = patches.shape
            y = engine.matmul(patches.reshape(-1, kk), p["w"], name=s.name)
            y = y.reshape(b, h, w_, s.c_out) + p["b"]
        if residual_from and s.name in residual_from:
            y = y + saved[residual_from[s.name]]
        if s.act:
            y = torch.relu(y)
        if s.pool > 1 and y.ndim == 4:
            b, h, w_, c = y.shape
            y = y.reshape(b, h // s.pool, s.pool, w_ // s.pool, s.pool, c
                          ).mean(dim=(2, 4))
        saved[s.name] = y
        x = y
    return x


# ---------------------------------------------------------------------------
# Reduced model zoo (names match configs/paper_cnns.py rows)
# ---------------------------------------------------------------------------
ALEXNET_LITE = [
    ConvSpec("conv1", "conv", 3, 24, pool=2),
    ConvSpec("conv2", "conv", 24, 48, pool=2),
    ConvSpec("conv3", "conv", 48, 64),
    ConvSpec("conv4", "conv", 64, 64),
    ConvSpec("conv5", "conv", 64, 48, pool=2),
    ConvSpec("fc1", "fc", 48, 128),
    ConvSpec("fc2", "fc", 128, 128),
    ConvSpec("fc3", "fc", 128, 10, act=False),
]

VGG16_LITE = [
    ConvSpec("conv1_1", "conv", 3, 16), ConvSpec("conv1_2", "conv", 16, 16, pool=2),
    ConvSpec("conv2_1", "conv", 16, 32), ConvSpec("conv2_2", "conv", 32, 32, pool=2),
    ConvSpec("conv3_1", "conv", 32, 48), ConvSpec("conv3_2", "conv", 48, 48),
    ConvSpec("conv3_3", "conv", 48, 48, pool=2),
    ConvSpec("conv4_1", "conv", 48, 64), ConvSpec("conv4_2", "conv", 64, 64),
    ConvSpec("conv4_3", "conv", 64, 64, pool=2),
    ConvSpec("conv5_1", "conv", 64, 64), ConvSpec("conv5_2", "conv", 64, 64),
    ConvSpec("conv5_3", "conv", 64, 64, pool=2),
    ConvSpec("fc1", "fc", 64, 96), ConvSpec("fc2", "fc", 96, 96),
    ConvSpec("fc3", "fc", 96, 10, act=False),
]

RESNET18_LITE = [
    ConvSpec("conv1", "conv", 3, 24),
    ConvSpec("l1_b1_c1", "conv", 24, 24), ConvSpec("l1_b1_c2", "conv", 24, 24),
    ConvSpec("l1_b2_c1", "conv", 24, 24), ConvSpec("l1_b2_c2", "conv", 24, 24),
    ConvSpec("l2_b1_c1", "conv", 24, 48, stride=2),
    ConvSpec("l2_b1_c2", "conv", 48, 48),
    ConvSpec("l2_b2_c1", "conv", 48, 48), ConvSpec("l2_b2_c2", "conv", 48, 48),
    ConvSpec("l3_b1_c1", "conv", 48, 64, stride=2),
    ConvSpec("l3_b1_c2", "conv", 64, 64),
    ConvSpec("l3_b2_c1", "conv", 64, 64), ConvSpec("l3_b2_c2", "conv", 64, 64),
    ConvSpec("l4_b1_c1", "conv", 64, 96, stride=2),
    ConvSpec("l4_b1_c2", "conv", 96, 96),
    ConvSpec("l4_b2_c1", "conv", 96, 96), ConvSpec("l4_b2_c2", "conv", 96, 96),
    ConvSpec("fc", "fc", 96, 10, act=False),
]
# the first blocks of layers 2-4 change the width and have no skip
RESNET18_SKIPS = {"l1_b1_c2": "conv1", "l1_b2_c2": "l1_b1_c2",
                  "l2_b2_c2": "l2_b1_c2", "l3_b2_c2": "l3_b1_c2",
                  "l4_b2_c2": "l4_b1_c2"}

MOBILENET_V3_LITE = [
    ConvSpec("conv_stem", "conv", 3, 16, pool=2),
    # mb1
    ConvSpec("mb1_exp", "conv", 16, 16, k=1),
    ConvSpec("mb1_dw", "dwconv", 16, 16),
    ConvSpec("mb1_prj", "conv", 16, 16, k=1, act=False),
    # mb2
    ConvSpec("mb2_exp", "conv", 16, 36, k=1),
    ConvSpec("mb2_dw", "dwconv", 36, 36, pool=2),
    ConvSpec("mb2_prj", "conv", 36, 24, k=1, act=False),
    # mb4
    ConvSpec("mb4_exp", "conv", 24, 48, k=1),
    ConvSpec("mb4_dw", "dwconv", 48, 48, k=5, pool=2),
    ConvSpec("mb4_prj", "conv", 48, 40, k=1, act=False),
    # mb6
    ConvSpec("mb6_exp", "conv", 40, 60, k=1),
    ConvSpec("mb6_dw", "dwconv", 60, 60, k=5),
    ConvSpec("mb6_prj", "conv", 60, 48, k=1, act=False),
    # head
    ConvSpec("head", "fc", 48, 96),
    ConvSpec("fc", "fc", 96, 10, act=False),
]

LITE_MODELS: dict[str, list[ConvSpec]] = {
    "alexnet": ALEXNET_LITE,
    "vgg16": VGG16_LITE,
    "resnet18": RESNET18_LITE,
    "mobilenet_v3": MOBILENET_V3_LITE,
}
LITE_SKIPS: dict[str, dict] = {"resnet18": RESNET18_SKIPS}
