"""GEMM-lowered layer tables for the paper's workloads (Sec. 4, Fig. 7);
a copy of `repro.configs.paper_cnns` for the port.

Convolutions are im2col'd: M = output pixels, K = C_in*kh*kw (per group),
N = C_out.  These tables drive the analytical energy/EDP model — Fig. 7's
array-size DSE aggregates over exactly this workload mix (AlexNet ->
MobileNet V3 + GPT-2 Medium + ViT), and Table 4 / Figs. 8-10 use the CNN
subsets.  CIFAR-10-scale spatial dims (32x32 inputs), matching the paper's
accuracy experiments; GPT-2M/ViT use seq_len=1024/197 tokens.

The REDUCED (trainable-on-CPU) behavioural variants live in
models/cnn.py::LITE_MODELS; layer names match one-to-one so the layer-wise
noise profiles measured on the lite nets can be joined against these
full-size EDP rows (DESIGN.md §8 records this calibration compromise).
"""

from __future__ import annotations

from repro_torch.core.energy import LayerShape


def _conv(name, hw, cin, cout, k=3, stride=1, groups=1):
    m = (hw // stride) ** 2
    return LayerShape(name, m=m, k=cin * k * k, n=cout, groups=groups,
                      kind="dwconv" if groups == cin else "conv")


def _fc(name, cin, cout):
    return LayerShape(name, m=1, k=cin, n=cout, kind="fc")


def _gemm(name, m, k, n):
    return LayerShape(name, m=m, k=k, n=n, kind="gemm")


ALEXNET = [
    _conv("conv1", 32, 3, 64),
    _conv("conv2", 16, 64, 192),
    _conv("conv3", 8, 192, 384),
    _conv("conv4", 8, 384, 256),
    _conv("conv5", 8, 256, 256),
    _fc("fc1", 256 * 4 * 4, 4096),
    _fc("fc2", 4096, 4096),
    _fc("fc3", 4096, 10),
]

VGG16 = (
    [_conv("conv1_1", 32, 3, 64), _conv("conv1_2", 32, 64, 64),
     _conv("conv2_1", 16, 64, 128), _conv("conv2_2", 16, 128, 128),
     _conv("conv3_1", 8, 128, 256), _conv("conv3_2", 8, 256, 256),
     _conv("conv3_3", 8, 256, 256),
     _conv("conv4_1", 4, 256, 512), _conv("conv4_2", 4, 512, 512),
     _conv("conv4_3", 4, 512, 512),
     _conv("conv5_1", 2, 512, 512), _conv("conv5_2", 2, 512, 512),
     _conv("conv5_3", 2, 512, 512)]
    + [_fc("fc1", 512, 512), _fc("fc2", 512, 512), _fc("fc3", 512, 10)]
)

RESNET18 = (
    [_conv("conv1", 32, 3, 64)]
    + [_conv(f"l1_b{b}_c{c}", 32, 64, 64)
       for b in (1, 2) for c in (1, 2)]
    + [_conv("l2_b1_c1", 16, 64, 128), _conv("l2_b1_c2", 16, 128, 128),
       _conv("l2_b2_c1", 16, 128, 128), _conv("l2_b2_c2", 16, 128, 128)]
    + [_conv("l3_b1_c1", 8, 128, 256), _conv("l3_b1_c2", 8, 256, 256),
       _conv("l3_b2_c1", 8, 256, 256), _conv("l3_b2_c2", 8, 256, 256)]
    + [_conv("l4_b1_c1", 4, 256, 512), _conv("l4_b1_c2", 4, 512, 512),
       _conv("l4_b2_c1", 4, 512, 512), _conv("l4_b2_c2", 4, 512, 512)]
    + [_fc("fc", 512, 10)]
)

# MobileNetV3-small-style: pointwise expand / depthwise / pointwise project.
# Small kernels + depthwise = the poor-utilization workload of Sec. 3.5.
def _mb_block(tag, hw, cin, cexp, cout, k=3):
    return [
        LayerShape(f"{tag}_exp", m=hw * hw, k=cin, n=cexp, kind="conv"),
        # depthwise: cexp independent (M, k*k, 1) sub-GEMMs
        LayerShape(f"{tag}_dw", m=hw * hw, k=cexp * k * k, n=cexp,
                   groups=cexp, kind="dwconv"),
        LayerShape(f"{tag}_prj", m=hw * hw, k=cexp, n=cout, kind="conv"),
    ]


MOBILENET_V3 = (
    [_conv("conv_stem", 32, 3, 16)]
    + _mb_block("mb1", 16, 16, 16, 16)
    + _mb_block("mb2", 16, 16, 72, 24)
    + _mb_block("mb3", 8, 24, 88, 24)
    + _mb_block("mb4", 8, 24, 96, 40, k=5)
    + _mb_block("mb5", 4, 40, 240, 40, k=5)
    + _mb_block("mb6", 4, 40, 120, 48, k=5)
    + _mb_block("mb7", 4, 48, 288, 96, k=5)
    + [_fc("head", 96, 576), _fc("fc", 576, 10)]
)

# GPT-2 Medium: 24L, d=1024; per-layer projection GEMMs at seq 1024.
_GPT2M_LAYER = lambda i: [
    _gemm(f"h{i}_qkv", 1024, 1024, 3072),
    _gemm(f"h{i}_proj", 1024, 1024, 1024),
    _gemm(f"h{i}_fc", 1024, 1024, 4096),
    _gemm(f"h{i}_out", 1024, 4096, 1024),
]
GPT2_MEDIUM = [l for i in range(24) for l in _GPT2M_LAYER(i)]

# ViT-Base/16 at 224px: 197 tokens, d=768, 12 layers.
_VIT_LAYER = lambda i: [
    _gemm(f"b{i}_qkv", 197, 768, 2304),
    _gemm(f"b{i}_proj", 197, 768, 768),
    _gemm(f"b{i}_fc", 197, 768, 3072),
    _gemm(f"b{i}_out", 197, 3072, 768),
]
VIT_BASE = [_gemm("patch_embed", 196, 768, 768)] \
    + [l for i in range(12) for l in _VIT_LAYER(i)]

WORKLOADS = {
    "alexnet": ALEXNET,
    "vgg16": VGG16,
    "resnet18": RESNET18,
    "mobilenet_v3": MOBILENET_V3,
    "gpt2_medium": GPT2_MEDIUM,
    "vit_base": VIT_BASE,
}

CNN_WORKLOADS = {k: WORKLOADS[k]
                 for k in ("alexnet", "vgg16", "resnet18", "mobilenet_v3")}
