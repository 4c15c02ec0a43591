"""Loop-nest workload representation (paper §IV: DNN operators as loop nests).

Every supported operator is expressed over the canonical 7-dim conv loop nest

    N  : batch
    K  : output channels
    C  : input channels (reduction)
    OY : output rows
    OX : output cols
    FY : filter rows
    FX : filter cols

GEMM  (M x K_red) @ (K_red x N_out)  is the special case
    N=M, K=N_out, C=K_red, OY=OX=FY=FX=1,
which is how every LM-architecture layer (attention projections, FFN mats,
MoE expert GEMMs, SSD block matmuls) enters MIREDO: the model frontend
(``core/frontend.py`` + ``core/lm_workloads.py``) lowers every registry
``ModelConfig`` under a ``ShapeSpec`` scenario to this form and feeds it
through the network pipeline. This module keeps only the canonical
representation and the conv-zoo tables.

Operand relevance (which dims index which tensor):
    I: N, C, IY(OY,FY), IX(OX,FX)       W: K, C, FY, FX       O: N, K, OY, OX
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping as TMapping

from repro_torch.core.arch import INPUT, OUTPUT, WEIGHT

DIMS = ("N", "K", "C", "OY", "OX", "FY", "FX")

# Dims that index each operand directly. Input rows/cols couple (OY,FY) and
# (OX,FX) through the sliding window — handled in `operand_tile_elems`.
RELEVANT = {
    INPUT: ("N", "C", "OY", "OX", "FY", "FX"),
    WEIGHT: ("K", "C", "FY", "FX"),
    OUTPUT: ("N", "K", "OY", "OX"),
}


def is_relevant(dim: str, operand: str) -> bool:
    return dim in RELEVANT[operand]


# Op kinds: which kernel primitive executes a layer on the measured-execution
# backend (`core/executor.py`). Every layer is still the same canonical loop
# nest for the MIP/latency stack; the kind only routes *execution*:
#   OP_GEMM      -> kernels/matmul_int8 (the CIM MVM primitive)
#   OP_ATTENTION -> attention projections; the executor additionally runs the
#                   score/AV stage on kernels/flash_attention per block
#   OP_SSD       -> SSD duality matmuls; the intra-chunk pair runs fused on
#                   kernels/ssd_scan, the state GEMMs on matmul_int8
#   OP_DGRAD     -> backward activation-grad GEMM (delta_X = delta_Y . W^T);
#                   plain matmul_int8 on the executor
#   OP_WGRAD     -> backward weight-grad GEMM (delta_W = X^T . delta_Y);
#                   plain matmul_int8, but its macro-resident operand is
#                   *produced* per step (``weight_written`` below)
OP_GEMM = "gemm"
OP_ATTENTION = "attention"
OP_SSD = "ssd"
OP_DGRAD = "dgrad"
OP_WGRAD = "wgrad"
OP_KINDS = (OP_GEMM, OP_ATTENTION, OP_SSD, OP_DGRAD, OP_WGRAD)


@dataclasses.dataclass(frozen=True)
class Layer:
    """One operator instance = loop bounds + stride + name (+ op kind).

    ``op`` tags the kernel family that executes this layer
    (`core/executor.py`); it is display/dispatch metadata like ``name``.
    ``weight_written`` marks a layer whose macro-resident ("weight"-slot)
    operand is *produced* by the step that uses it rather than preloaded
    from DRAM — wGrad GEMMs (the stationary operand is an activation
    gradient) and the backward of activation-activation matmuls. It IS
    structural: the scheduler's residency basis and the formulation's
    stationary-operand amortization are invalid for written operands, so
    `cache.layer_cache_key` (network dedup, record cache, scheduler basis
    memo) covers loop bounds + stride + weight_written."""

    name: str
    dims: TMapping[str, int]  # bound per canonical dim (>=1)
    stride: int = 1
    op: str = OP_GEMM
    weight_written: bool = False

    def __post_init__(self):
        assert self.op in OP_KINDS, (self.name, self.op)
        for d in DIMS:
            assert self.dims.get(d, 1) >= 1, (self.name, d)

    def bound(self, d: str) -> int:
        return int(self.dims.get(d, 1))

    @property
    def macs(self) -> int:
        return math.prod(self.bound(d) for d in DIMS)

    def operand_elems(self, operand: str) -> int:
        """Total element count of one operand tensor."""
        return operand_tile_elems(self, operand,
                                  {d: self.bound(d) for d in DIMS})

    @property
    def is_gemm(self) -> bool:
        return all(self.bound(d) == 1 for d in ("OY", "OX", "FY", "FX"))


def operand_tile_elems(layer: Layer, operand: str,
                       tile: TMapping[str, int]) -> int:
    """Element count of an operand tile given per-dim tile bounds.

    Input spatial extent uses the sliding-window relation
        IY = (oy - 1) * stride + fy   (and likewise IX),
    the standard Timeloop/ZigZag halo accounting.
    """
    t = lambda d: int(tile.get(d, 1))
    if operand == WEIGHT:
        return t("K") * t("C") * t("FY") * t("FX")
    if operand == OUTPUT:
        return t("N") * t("K") * t("OY") * t("OX")
    iy = (t("OY") - 1) * layer.stride + t("FY")
    ix = (t("OX") - 1) * layer.stride + t("FX")
    return t("N") * t("C") * iy * ix


def conv(name: str, n: int, k: int, c: int, oy: int, ox: int,
         fy: int, fx: int, stride: int = 1) -> Layer:
    return Layer(name, {"N": n, "K": k, "C": c, "OY": oy, "OX": ox,
                        "FY": fy, "FX": fx}, stride)


def gemm(name: str, m: int, n_out: int, k_red: int, op: str = OP_GEMM,
         weight_written: bool = False) -> Layer:
    """(m x k_red) @ (k_red x n_out)."""
    return Layer(name, {"N": m, "K": n_out, "C": k_red}, op=op,
                 weight_written=weight_written)


# ---------------------------------------------------------------------------
# Model workload tables.
# ---------------------------------------------------------------------------

def resnet18(batch: int = 1) -> list[Layer]:
    """ResNet-18 / ImageNet conv layers (the paper's baseline workload).

    Unique conv shapes with multiplicity folded into the name; INT8 W/A per
    the paper's setup. Downsample (1x1 stride-2) projections included.
    """
    ls: list[Layer] = [
        conv("conv1", batch, 64, 3, 112, 112, 7, 7, stride=2),
        conv("conv2_x", batch, 64, 64, 56, 56, 3, 3),        # x4
        conv("conv3_1", batch, 128, 64, 28, 28, 3, 3, stride=2),
        conv("conv3_ds", batch, 128, 64, 28, 28, 1, 1, stride=2),
        conv("conv3_x", batch, 128, 128, 28, 28, 3, 3),      # x3
        conv("conv4_1", batch, 256, 128, 14, 14, 3, 3, stride=2),
        conv("conv4_ds", batch, 256, 128, 14, 14, 1, 1, stride=2),
        conv("conv4_x", batch, 256, 256, 14, 14, 3, 3),      # x3
        conv("conv5_1", batch, 512, 256, 7, 7, 3, 3, stride=2),
        conv("conv5_ds", batch, 512, 256, 7, 7, 1, 1, stride=2),
        conv("conv5_x", batch, 512, 512, 7, 7, 3, 3),        # x3
        gemm("fc", batch, 1000, 512),
    ]
    return ls


RESNET18_MULTIPLICITY = {
    "conv2_x": 4, "conv3_x": 3, "conv4_x": 3, "conv5_x": 3,
}


def resnet50(batch: int = 1) -> list[Layer]:
    ls = [conv("conv1", batch, 64, 3, 112, 112, 7, 7, stride=2)]
    spec = [(64, 256, 56, 3), (128, 512, 28, 4), (256, 1024, 14, 6),
            (512, 2048, 7, 3)]
    cin = 64
    for i, (mid, out, hw, _reps) in enumerate(spec):
        s = 1 if i == 0 else 2
        ls += [
            conv(f"b{i}_red", batch, mid, cin, hw, hw, 1, 1, stride=s),
            conv(f"b{i}_3x3", batch, mid, mid, hw, hw, 3, 3),
            conv(f"b{i}_exp", batch, out, mid, hw, hw, 1, 1),
            conv(f"b{i}_ds", batch, out, cin, hw, hw, 1, 1, stride=s),
        ]
        cin = out
    ls.append(gemm("fc", batch, 1000, 2048))
    return ls


def mobilenet_v2_slice(batch: int = 1) -> list[Layer]:
    """Representative MobileNetV2 pointwise/expansion convs (depthwise convs
    are not MVM-shaped for a CIM macro and are executed on the SIMD unit —
    standard practice; see DESIGN.md)."""
    return [
        conv("pw1", batch, 96, 16, 112, 112, 1, 1),
        conv("pw2", batch, 144, 24, 56, 56, 1, 1),
        conv("pw3", batch, 192, 32, 28, 28, 1, 1),
        conv("pw4", batch, 384, 64, 14, 14, 1, 1),
        conv("pw5", batch, 960, 160, 7, 7, 1, 1),
        gemm("fc", batch, 1000, 1280),
    ]


def vgg16_slice(batch: int = 1) -> list[Layer]:
    return [
        conv("c1", batch, 64, 3, 224, 224, 3, 3),
        conv("c3", batch, 128, 128, 112, 112, 3, 3),
        conv("c6", batch, 256, 256, 56, 56, 3, 3),
        conv("c9", batch, 512, 512, 28, 28, 3, 3),
        conv("c13", batch, 512, 512, 14, 14, 3, 3),
        gemm("fc1", batch, 4096, 25088),
    ]


def bert_base_layer(seq: int = 128) -> list[Layer]:
    d, ff = 768, 3072
    return [
        gemm("qkv", seq, 3 * d, d),
        gemm("attn_out", seq, d, d),
        gemm("ffn_up", seq, ff, d),
        gemm("ffn_down", seq, d, ff),
    ]


def lm_block_gemms(name: str, d_model: int, n_heads: int, kv_heads: int,
                   d_ff: int, seq: int, *, gated: bool = True,
                   n_experts: int = 0, top_k: int = 0) -> list[Layer]:
    """GEMM workloads of one hand-parameterized LM transformer block.

    Kept for the fig5a block-level comparison; whole-model extraction from
    a registry ``ModelConfig`` (GQA KV sizing, shared experts, SSD blocks,
    scenarios) lives in ``core/frontend.py``."""
    head_dim = d_model // n_heads
    ls = [
        gemm(f"{name}.wq", seq, n_heads * head_dim, d_model),
        gemm(f"{name}.wk", seq, kv_heads * head_dim, d_model),
        gemm(f"{name}.wv", seq, kv_heads * head_dim, d_model),
        gemm(f"{name}.wo", seq, d_model, n_heads * head_dim),
    ]
    if n_experts:
        tok_per_exp = max(1, seq * top_k // n_experts)
        ls += [
            gemm(f"{name}.exp_up", tok_per_exp, d_ff * (2 if gated else 1),
                 d_model),
            gemm(f"{name}.exp_down", tok_per_exp, d_model, d_ff),
        ]
    elif d_ff:
        ls += [
            gemm(f"{name}.ffn_up", seq, d_ff * (2 if gated else 1), d_model),
            gemm(f"{name}.ffn_down", seq, d_model, d_ff),
        ]
    return ls


MODEL_ZOO = {
    "resnet18": resnet18,
    "resnet50": resnet50,
    "mobilenetv2": mobilenet_v2_slice,
    "vgg16": vgg16_slice,
    "bert-base": bert_base_layer,
}
