"""A plain EfficientNet-B0 (Tan & Le, arXiv:1905.11946), partitioned and
fake-quantized per stage (§IV-C), and its BatchNorm calibration.

Blocks: a 3x3/2 stem; MBConv blocks (1x1 expansion unless the ratio is 1,
k x k depthwise, squeeze-excite of a quarter of the block's input width
with silu then sigmoid, 1x1 projection, residual when the shape allows);
a 1x1 head; global average pooling and a dense classifier.  Convolutions
pad k // 2; BatchNorm uses its running statistics with eps 1e-5.

A cut vector (schedule positions, -1 for none) is laid out as blocks: each
position maps to the last block its schedule prefix holds whole, and a
platform whose share holds no block drops out with its width.  Each stage
runs on its weights fake-quantized per tensor (symmetric, min/max range)
at its platform's width (leaves of one dimension stay float), and the
activation leaving a stage is fake-quantized the same way at the
producer's width.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from bench.lib.weights import effnet_blocks
from bench.reference.costmodel.cnn_graph import cut_to_block, effnet_b0_graph
from bench.reference.costmodel.graph import linearize
from bench.reference.precision import precision_of, round_tf32

BN_EPS = 1e-5


def fake_quant(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Symmetric per-tensor quantize then dequantize; the result is formed
    as x + (dq - x), the value the straight-through form gives in float."""
    qmax = 2 ** (bits - 1) - 1
    amax = torch.maximum(x.min().abs(), x.max().abs())
    scale = torch.clamp_min(amax / qmax, 1e-12)
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax)
    return x + (q * scale - x)


def quantized(w: Dict[str, torch.Tensor], names: Sequence[str], bits):
    """Copies of the leaves ``names`` at ``bits`` (None: as they are)."""
    return {n: (w[n] if bits is None or w[n].dim() <= 1
                else fake_quant(w[n], bits)) for n in names}


def _tf32(t, em):
    return round_tf32(t) if em else t


def _conv_bn(x, w, p, stride, groups, act, calibrate, em=False):
    k = w[p + "conv.w"].shape[-1]
    x = F.conv2d(_tf32(x, em), _tf32(w[p + "conv.w"], em), None, stride,
                 k // 2, 1, groups)
    if calibrate:
        w[p + "bn.mean"].copy_(x.mean((0, 2, 3)))
        w[p + "bn.var"].copy_(x.var((0, 2, 3), unbiased=False))
    x = F.batch_norm(x, w[p + "bn.mean"], w[p + "bn.var"], w[p + "bn.scale"],
                     w[p + "bn.bias"], False, 0.0, BN_EPS)
    return F.silu(x) if act else x


def _linear(x, w, b, em):
    return F.linear(_tf32(x, em), _tf32(w, em), b)


def block(x, w, name, kind, a, calibrate=False, em=False):
    """One block; ``em``: emulate TF32 products by rounding operands."""
    p = name + "."
    if kind == "conv":
        return _conv_bn(x, w, p, a["stride"], 1, a["act"], calibrate, em)
    if kind == "classifier":
        return _linear(x.mean(dim=(2, 3)), w[p + "head.w"], w[p + "head.b"],
                       em)
    y = x
    if a["expand"] != 1:
        y = _conv_bn(y, w, p + "exp.", 1, 1, True, calibrate, em)
    y = _conv_bn(y, w, p + "dw.", a["stride"], a["mid"], True, calibrate, em)
    s = F.silu(_linear(y.mean(dim=(2, 3)), w[p + "se.fc1.w"],
                       w[p + "se.fc1.b"], em))
    s = torch.sigmoid(_linear(s, w[p + "se.fc2.w"], w[p + "se.fc2.b"], em))
    y = _conv_bn(y * s[:, :, None, None], w, p + "proj.", 1, 1, False,
                 calibrate, em)
    return y + x if a["skip"] else y


@torch.no_grad()
def calibrate_bn(w: Dict[str, torch.Tensor], cfg: dict,
                 images: torch.Tensor) -> None:
    """Set every BatchNorm's running mean and variance to those of its
    input in a float forward of ``images``."""
    x = images
    for name, kind, a in effnet_blocks(cfg):
        x = block(x, w, name, kind, a, calibrate=True)


@torch.no_grad()
def logits(w, cfg, images) -> torch.Tensor:
    x = images
    for name, kind, a in effnet_blocks(cfg):
        x = block(x, w, name, kind, a)
    return x


class Partitioned:
    """The partitioned, fake-quantized model of a configuration: its own
    schedule and block boundaries, rebuilt from the stage table."""

    def __init__(self, cfg: dict):
        self.cfg = cfg
        graph, self.block_ends = effnet_b0_graph(
            cfg["image_size"], cfg.get("width", 1.0), cfg["num_classes"],
            [tuple(s) for s in cfg["stages"]])
        self.schedule = linearize(graph, cfg["schedule_policy"])
        self.blocks = list(effnet_blocks(cfg))
        self.bits = [p["bits"] for p in cfg["platforms"]]

    def plan(self, cuts: Sequence[int]):
        """[(first block, last block, bits)] of the platforms that run a
        block, in order."""
        ends = [cut_to_block(self.schedule, self.block_ends, c) if c >= 0
                else -1 for c in cuts]
        bounds = [-1] + ends + [len(self.blocks) - 1]
        return [(bounds[k] + 1, bounds[k + 1], self.bits[k])
                for k in range(len(self.bits))
                if bounds[k + 1] >= bounds[k] + 1]

    @torch.no_grad()
    def logits(self, w, images, cuts, precision="float32"):
        stages = self.plan(cuts)
        x = images
        with precision_of(precision, images.device) as em:
            for i, (a, b, bits) in enumerate(stages):
                names = [n for n in w if n.split(".")[0] in
                         {self.blocks[j][0] for j in range(a, b + 1)}]
                q = dict(w)
                q.update(quantized(w, names, bits))
                for name, kind, arg in self.blocks[a:b + 1]:
                    x = block(x, q, name, kind, arg, em=em)
                if i < len(stages) - 1:
                    x = fake_quant(x, bits)
        return x

    def accuracy(self, w, images, labels, cuts, precision="float32") -> float:
        top = self.logits(w, images, cuts, precision).argmax(-1)
        return float((top == labels).to(torch.float32).mean())


def accuracies(model: Partitioned, w, images, labels, cut_list,
               precision="float32") -> List[float]:
    return [model.accuracy(w, images, labels, c, precision) for c in cut_list]
