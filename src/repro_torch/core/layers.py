"""Layer descriptors: the op-level vocabulary of the partitioner's graph IR.

The paper ingests ONNX; offline we use a native IR at the same granularity.
A :class:`LayerInfo` records everything the cost models need about one node:
tensor shapes, parameter count, MACs, and the feature-map sizes of
Definition 3.  Shapes are static (inference partitioning is a compile-time
decision in the paper, too).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

# Op types understood by the cost models.  COMPUTE ops get a Timeloop-lite
# mapping; CHEAP ops are modeled as bandwidth-bound elementwise traffic.
CONV = "Conv"
GEMM = "Gemm"  # fully-connected / matmul
DWCONV = "DepthwiseConv"
POOL = "Pool"
GLOBALPOOL = "GlobalPool"
RELU = "Relu"
ADD = "Add"
MUL = "Mul"
CONCAT = "Concat"
FLATTEN = "Flatten"
SOFTMAX = "Softmax"
BN = "BatchNorm"
LN = "LayerNorm"
EMBED = "Embedding"
ATTENTION = "Attention"       # fused decoder-attention block node (LLM graphs)
SSM = "SSM"                   # fused Mamba2 mixer node
MOE = "MoE"                   # fused MoE FFN node
MLP = "Mlp"                   # fused transformer FFN node
IDENTITY = "Identity"

MACCY_OPS = frozenset({CONV, GEMM, DWCONV, ATTENTION, SSM, MOE, MLP, EMBED})


@dataclasses.dataclass(frozen=True)
class LayerInfo:
    """Static description of one graph node.

    Attributes:
      name: unique node name, e.g. ``Conv_45`` (paper naming convention).
      op: one of the op-type constants above.
      in_shape: primary input feature-map shape (no batch dim).
      out_shape: output feature-map shape (no batch dim).
      params: number of learnable scalars held by the node.
      macs: multiply-accumulates for one inference (batch=1).
      attrs: op-specific attributes (kernel size, stride, heads, ...).
    """

    name: str
    op: str
    in_shape: Tuple[int, ...]
    out_shape: Tuple[int, ...]
    params: int = 0
    macs: int = 0
    attrs: Dict[str, object] = dataclasses.field(default_factory=dict)

    # -- Definition 3 ingredients ------------------------------------------
    @property
    def fmap_in(self) -> int:
        """f_{j,in}: number of elements of the input feature map."""
        return int(math.prod(self.in_shape)) if self.in_shape else 0

    @property
    def fmap_out(self) -> int:
        """f_{j,out}: number of elements of the output feature map."""
        return int(math.prod(self.out_shape)) if self.out_shape else 0

    @property
    def activation_footprint(self) -> int:
        """a_j = f_{j,in} + f_{j,out} (Definition 3)."""
        return self.fmap_in + self.fmap_out

    @property
    def flops(self) -> int:
        """2 x MACs (multiply + accumulate)."""
        return 2 * self.macs

    def __repr__(self) -> str:  # compact for exploration logs
        return f"LayerInfo({self.name}, {self.op}, in={self.in_shape}, out={self.out_shape}, P={self.params}, MACs={self.macs})"


# ---------------------------------------------------------------------------
# Constructors that compute params/MACs from op hyper-parameters. These are
# used both by models/*.to_graph() and by unit tests as ground truth.
# ---------------------------------------------------------------------------

def conv_layer(name: str, cin: int, cout: int, hw_in: Tuple[int, int],
               kernel: int, stride: int = 1, padding: Optional[int] = None,
               groups: int = 1, bias: bool = True) -> LayerInfo:
    h, w = hw_in
    if padding is None:  # 'same'-style default
        padding = kernel // 2
    ho = (h + 2 * padding - kernel) // stride + 1
    wo = (w + 2 * padding - kernel) // stride + 1
    params = cout * (cin // groups) * kernel * kernel + (cout if bias else 0)
    macs = ho * wo * cout * (cin // groups) * kernel * kernel
    op = DWCONV if groups == cin and cin == cout and groups > 1 else CONV
    return LayerInfo(name, op, (cin, h, w), (cout, ho, wo), params, macs,
                     attrs={"kernel": kernel, "stride": stride,
                            "padding": padding, "groups": groups})


def gemm_layer(name: str, cin: int, cout: int, bias: bool = True) -> LayerInfo:
    params = cin * cout + (cout if bias else 0)
    return LayerInfo(name, GEMM, (cin,), (cout,), params, cin * cout)


def pool_layer(name: str, c: int, hw_in: Tuple[int, int], kernel: int,
               stride: Optional[int] = None, padding: int = 0,
               global_pool: bool = False) -> LayerInfo:
    h, w = hw_in
    if global_pool:
        return LayerInfo(name, GLOBALPOOL, (c, h, w), (c, 1, 1))
    stride = stride or kernel
    ho = (h + 2 * padding - kernel) // stride + 1
    wo = (w + 2 * padding - kernel) // stride + 1
    return LayerInfo(name, POOL, (c, h, w), (c, ho, wo),
                     attrs={"kernel": kernel, "stride": stride,
                            "padding": padding})


def elementwise_layer(name: str, op: str, shape: Tuple[int, ...]) -> LayerInfo:
    return LayerInfo(name, op, shape, shape)


def bn_layer(name: str, shape: Tuple[int, ...]) -> LayerInfo:
    c = shape[0]
    return LayerInfo(name, BN, shape, shape, params=4 * c)


def concat_layer(name: str, in_shapes, axis: int = 0) -> LayerInfo:
    out = list(in_shapes[0])
    out[axis] = sum(s[axis] for s in in_shapes)
    total_in = sum(int(math.prod(s)) for s in in_shapes)
    # in_shape is recorded as flat element count on axis-0 for Def. 3 purposes
    return LayerInfo(name, CONCAT, (total_in,), tuple(out),
                     attrs={"axis": axis, "n_inputs": len(in_shapes)})


def flatten_layer(name: str, in_shape: Tuple[int, ...]) -> LayerInfo:
    n = int(math.prod(in_shape))
    return LayerInfo(name, FLATTEN, in_shape, (n,))


# -- fused transformer-block nodes (LLM graphs operate per-block) -----------

def embed_layer(name: str, vocab: int, d_model: int, seq: int) -> LayerInfo:
    return LayerInfo(name, EMBED, (seq,), (seq, d_model),
                     params=vocab * d_model, macs=0,
                     attrs={"vocab": vocab, "d_model": d_model})


def attention_layer(name: str, d_model: int, n_heads: int, n_kv: int,
                    seq: int, head_dim: Optional[int] = None,
                    qkv_bias: bool = False, qk_norm: bool = False,
                    window: Optional[int] = None) -> LayerInfo:
    hd = head_dim or d_model // n_heads
    q_p = d_model * n_heads * hd
    kv_p = 2 * d_model * n_kv * hd
    o_p = n_heads * hd * d_model
    params = q_p + kv_p + o_p + (2 * d_model if qk_norm else 0)
    params += (n_heads * hd + 2 * n_kv * hd) if qkv_bias else 0
    ctx = min(seq, window) if window else seq
    proj_macs = seq * (q_p + kv_p + o_p)
    attn_macs = seq * ctx * n_heads * hd  # qk^T + av, triangular ~ /2 *2 = 1
    return LayerInfo(name, ATTENTION, (seq, d_model), (seq, d_model),
                     params=params, macs=proj_macs + attn_macs,
                     attrs={"n_heads": n_heads, "n_kv": n_kv, "head_dim": hd,
                            "window": window, "qk_norm": qk_norm})


def mlp_layer(name: str, d_model: int, d_ff: int, seq: int,
              gated: bool = True) -> LayerInfo:
    n_mats = 3 if gated else 2
    params = n_mats * d_model * d_ff
    return LayerInfo(name, MLP, (seq, d_model), (seq, d_model),
                     params=params, macs=seq * params,
                     attrs={"d_ff": d_ff, "gated": gated})


def moe_layer(name: str, d_model: int, d_ff: int, seq: int, n_experts: int,
              top_k: int, n_shared: int = 0, gated: bool = True) -> LayerInfo:
    n_mats = 3 if gated else 2
    per_expert = n_mats * d_model * d_ff
    params = (n_experts + n_shared) * per_expert + d_model * n_experts
    active = (top_k + n_shared) * per_expert
    return LayerInfo(name, MOE, (seq, d_model), (seq, d_model),
                     params=params, macs=seq * (active + d_model * n_experts),
                     attrs={"n_experts": n_experts, "top_k": top_k,
                            "n_shared": n_shared, "d_ff": d_ff,
                            "active_params": active})


def ssm_layer(name: str, d_model: int, d_state: int, seq: int,
              expand: int = 2, conv_kernel: int = 4,
              headdim: int = 64) -> LayerInfo:
    d_inner = expand * d_model
    n_heads = d_inner // headdim
    # in_proj produces z, x, B, C, dt ; out_proj back to d_model
    proj_in = d_model * (2 * d_inner + 2 * d_state + n_heads)
    proj_out = d_inner * d_model
    conv_p = conv_kernel * (d_inner + 2 * d_state)
    params = proj_in + proj_out + conv_p + n_heads * 2 + d_inner  # A,dt_bias,norm
    scan_macs = seq * d_inner * d_state * 2  # state update + output
    params_macs = seq * (proj_in + proj_out)
    return LayerInfo(name, SSM, (seq, d_model), (seq, d_model),
                     params=params, macs=scan_macs + params_macs,
                     attrs={"d_state": d_state, "d_inner": d_inner,
                            "n_heads": n_heads, "headdim": headdim})


def lm_head_layer(name: str, d_model: int, vocab: int, seq: int,
                  tied: bool = False) -> LayerInfo:
    return LayerInfo(name, GEMM, (seq, d_model), (seq, vocab),
                     params=0 if tied else d_model * vocab,
                     macs=seq * d_model * vocab, attrs={"tied": tied})


def norm_layer(name: str, shape: Tuple[int, ...], kind: str = LN) -> LayerInfo:
    d = shape[-1]
    return LayerInfo(name, kind, shape, shape, params=d)
