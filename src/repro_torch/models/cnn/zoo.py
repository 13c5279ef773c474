"""The paper's six CNN workloads (§V-A): VGG-16, ResNet-50, SqueezeNet V1.1,
GoogLeNet, RegNetX-400MF, EfficientNet-B0.

Each model is an ``nn.Module`` (``model(x)`` gives the logits of an NCHW
batch; a model is built in eval mode, and in ``.train()`` mode its
BatchNorm layers take the batch's statistics and update their running
ones) *and* exports the partitioner's LayerGraph via
``to_graph()``; the full-size graphs drive the cost models exactly as the
paper's ONNX graphs do.  ``reduced_cnn`` gives the narrow, low-resolution
variants.

A model is built on the ``meta`` device, so building one of any size and
emitting its graph allocates no weights; ``init_weights(generator,
device)`` gives it storage on ``device`` and the JAX package's
initialisation, ``models.convert.load_reference_cnn`` the reference's own
weights.  Its blocks are registered under their names (``stem``,
``s1b0``, ``cls``), so parameter names are the reference's pytree paths
with ``.`` for ``/``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.graph import LayerGraph
from repro_torch.models.cnn.blocks import (Bottleneck, ConvBNAct, Fire,
                                           GraphBuilder, Inception, MBConv,
                                           XBlock)
from repro_torch.nn.layers import Dense, avg_pool, global_avg_pool, max_pool


class PoolBlock(nn.Module):
    def __init__(self, k, stride=None, padding=0, kind="max"):
        super().__init__()
        self.k, self.s, self.p, self.kind = k, stride or k, padding, kind

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fn = max_pool if self.kind == "max" else avg_pool
        return fn(x, self.k, self.s, self.p)

    def emit(self, gb, cin, hw, after):
        name, hw2 = gb.pool(cin, hw, self.k, self.s, self.p, after)
        return name, hw2, cin


class Classifier(nn.Module):
    """GlobalAvgPool -> flatten -> (fc relu)* -> fc logits."""

    def __init__(self, cin, hidden: Sequence[int], n_classes: int,
                 global_pool: bool = True, in_hw: Optional[int] = None):
        super().__init__()
        self.cin, self.hidden, self.n = cin, list(hidden), n_classes
        self.gp = global_pool
        self.in_hw = in_hw
        dims = ([cin] if global_pool else [cin * in_hw * in_hw]) + self.hidden
        self.fcs = []
        for i in range(len(self.hidden)):          # named fc0, fc1, ...
            fc = Dense(dims[i], dims[i + 1])
            self.add_module(f"fc{i}", fc)
            self.fcs.append(fc)
        self.head = Dense(dims[-1], n_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = global_avg_pool(x) if self.gp else x.reshape(x.shape[0], -1)
        for fc in self.fcs:
            x = F.relu(fc(x))
        return self.head(x)

    def emit(self, gb, cin, hw, after):
        if self.gp:
            name, hw = gb.pool(cin, hw, 0, after=after, global_pool=True)
            name, d = gb.flatten((cin, 1, 1), name)
        else:
            name, d = gb.flatten((cin, *hw), after)
        for d_out in self.hidden:
            name = gb.gemm(d, d_out, name)
            name = gb.relu(d_out, (1, 1), name)
            d = d_out
        name = gb.gemm(d, self.n, name)
        return name, (1, 1), self.n


class CNNModel(nn.Module):
    """Sequence of emit-capable blocks, each registered under its name."""

    def __init__(self, name: str, blocks: List[Tuple[str, nn.Module]],
                 in_hw: int, in_ch: int = 3):
        super().__init__()
        self.name = name
        self.blocks = blocks
        for n, b in blocks:
            self.add_module(n, b)
        self.in_hw, self.in_ch = in_hw, in_ch
        self.eval()     # BatchNorm on the running statistics until .train()

    @torch.no_grad()
    def init_weights(self, generator: Optional[torch.Generator] = None,
                     device="cuda") -> "CNNModel":
        """Give every parameter and buffer storage on ``device`` (the card
        by default; raises without one) and the JAX package's
        initialisation, weights drawn from ``generator``.  Returns the
        model."""
        from repro_torch.explore.runner import resolve_device
        self.to_empty(device=resolve_device(device))
        for m in self.modules():
            reset = getattr(m, "reset_parameters", None)
            if reset is not None:
                reset(generator)
        return self

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return run_blocks(self.blocks, x)

    def to_graph(self) -> LayerGraph:
        gb = GraphBuilder(self.name)
        name, hw, c = None, (self.in_hw, self.in_hw), self.in_ch
        self.graph_boundaries = []   # (block_idx, last node name) per block
        for bi, (_, b) in enumerate(self.blocks):
            name, hw, c = b.emit(gb, c, hw, name)
            self.graph_boundaries.append((bi, name))
        return gb.g

    def cut_to_block(self, schedule, cut_pos: int) -> int:
        """Map a graph cut position (index into ``schedule``) to the largest
        block index fully contained in the prefix — for executing a chosen
        partition with :class:`PartitionedCNNRunner`."""
        assert getattr(self, "graph_boundaries", None), "call to_graph() first"
        prefix = {l.name for l in schedule[: cut_pos + 1]}
        blk = -1
        for bi, node in self.graph_boundaries:
            if node in prefix:
                blk = bi
            else:
                break
        return blk


def run_blocks(blocks: Sequence[Tuple[str, nn.Module]],
               x: torch.Tensor) -> torch.Tensor:
    """``x`` through ``blocks`` (a slice of ``CNNModel.blocks``) in turn."""
    for _, b in blocks:
        x = b(x)
    return x


# ---------------------------------------------------------------------------
# the six models
# ---------------------------------------------------------------------------

def vgg16(n_classes=1000, in_hw=224, w=1.0, fc_dim=4096) -> CNNModel:
    cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
           512, 512, 512, "M", 512, 512, 512, "M"]
    blocks: List[Tuple[str, nn.Module]] = []
    cin, i = 3, 0
    for v in cfg:
        if v == "M":
            blocks.append((f"pool{i}", PoolBlock(2)))
        else:
            c = max(int(v * w), 8)
            blocks.append((f"conv{i}", ConvBNAct(cin, c, 3, bn=False)))
            cin = c
        i += 1
    out_hw = in_hw // 32
    blocks.append(("cls", Classifier(cin, [fc_dim, fc_dim], n_classes,
                                     global_pool=False, in_hw=out_hw)))
    return CNNModel("vgg16", blocks, in_hw)


def resnet50(n_classes=1000, in_hw=224, w=1.0,
             depths=(3, 4, 6, 3)) -> CNNModel:
    planes = [max(int(p * w), 8) for p in (64, 128, 256, 512)]
    blocks: List[Tuple[str, nn.Module]] = [
        ("stem", ConvBNAct(3, planes[0], 7, 2, 3)),
        ("pool0", PoolBlock(3, 2, 1)),
    ]
    cin = planes[0]
    for s, (pl, n) in enumerate(zip(planes, depths)):
        for b in range(n):
            stride = 2 if (s > 0 and b == 0) else 1
            blk = Bottleneck(cin, pl, stride)
            blocks.append((f"s{s}b{b}", blk))
            cin = blk.cout
    blocks.append(("cls", Classifier(cin, [], n_classes)))
    return CNNModel("resnet50", blocks, in_hw)


def squeezenet11(n_classes=1000, in_hw=224, w=1.0) -> CNNModel:
    def c(v):
        return max(int(v * w), 8)
    blocks: List[Tuple[str, nn.Module]] = [
        ("stem", ConvBNAct(3, c(64), 3, 2, 0, bn=False)),
        ("pool0", PoolBlock(3, 2)),
        ("fire1", Fire(c(64), c(16), c(64), c(64))),
        ("fire2", Fire(2 * c(64), c(16), c(64), c(64))),
        ("pool1", PoolBlock(3, 2)),
        ("fire3", Fire(2 * c(64), c(32), c(128), c(128))),
        ("fire4", Fire(2 * c(128), c(32), c(128), c(128))),
        ("pool2", PoolBlock(3, 2)),
        ("fire5", Fire(2 * c(128), c(48), c(192), c(192))),
        ("fire6", Fire(2 * c(192), c(48), c(192), c(192))),
        ("fire7", Fire(2 * c(192), c(64), c(256), c(256))),
        ("fire8", Fire(2 * c(256), c(64), c(256), c(256))),
        ("conv_f", ConvBNAct(2 * c(256), n_classes, 1, bn=False)),
        # squeezenet uses conv then global pool
        ("cls", _GPoolHead()),
    ]
    return CNNModel("squeezenet11", blocks, in_hw)


class _GPoolHead(nn.Module):
    """SqueezeNet head: global average pool of the class conv map."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return global_avg_pool(x)

    def emit(self, gb, cin, hw, after):
        name, _ = gb.pool(cin, hw, 0, after=after, global_pool=True)
        name, d = gb.flatten((cin, 1, 1), name)
        return name, (1, 1), cin


def googlenet(n_classes=1000, in_hw=224, w=1.0) -> CNNModel:
    def c(v):
        return max(int(v * w), 8)
    incep = [
        # cin, c1, c3r, c3, c5r, c5, pp
        (192, 64, 96, 128, 16, 32, 32),
        (256, 128, 128, 192, 32, 96, 64),
        (480, 192, 96, 208, 16, 48, 64),
        (512, 160, 112, 224, 24, 64, 64),
        (512, 128, 128, 256, 24, 64, 64),
        (512, 112, 144, 288, 32, 64, 64),
        (528, 256, 160, 320, 32, 128, 128),
        (832, 256, 160, 320, 32, 128, 128),
        (832, 384, 192, 384, 48, 128, 128),
    ]
    blocks: List[Tuple[str, nn.Module]] = [
        ("stem1", ConvBNAct(3, c(64), 7, 2, 3)),
        ("pool0", PoolBlock(3, 2, 1)),
        ("stem2", ConvBNAct(c(64), c(64), 1)),
        ("stem3", ConvBNAct(c(64), c(192), 3)),
        ("pool1", PoolBlock(3, 2, 1)),
    ]
    cin = c(192)
    for i, (ci, c1, c3r, c3, c5r, c5, pp) in enumerate(incep):
        blk = Inception(cin, c(c1), c(c3r), c(c3), c(c5r), c(c5), c(pp))
        blocks.append((f"incep{i}", blk))
        cin = blk.cout
        if i == 1:
            blocks.append(("pool2", PoolBlock(3, 2, 1)))
        if i == 6:
            blocks.append(("pool3", PoolBlock(3, 2, 1)))
    blocks.append(("cls", Classifier(cin, [], n_classes)))
    return CNNModel("googlenet", blocks, in_hw)


def regnetx_400mf(n_classes=1000, in_hw=224, w=1.0) -> CNNModel:
    widths = [max(int(v * w), 8) for v in (32, 64, 160, 384)]
    depths = (1, 2, 7, 12)
    gw = max(int(16 * w), 4)
    stem = widths[0] if w != 1.0 else 32
    blocks: List[Tuple[str, nn.Module]] = [("stem", ConvBNAct(3, stem, 3, 2))]
    cin = stem
    for s, (cw, n) in enumerate(zip(widths, depths)):
        for b in range(n):
            stride = 2 if b == 0 else 1
            blk = XBlock(cin, cw, stride, gw)
            blocks.append((f"s{s}b{b}", blk))
            cin = cw
    blocks.append(("cls", Classifier(cin, [], n_classes)))
    return CNNModel("regnetx_400mf", blocks, in_hw)


def efficientnet_b0(n_classes=1000, in_hw=224, w=1.0) -> CNNModel:
    # (expand, cout, repeats, kernel, stride)
    stages = [(1, 16, 1, 3, 1), (6, 24, 2, 3, 2), (6, 40, 2, 5, 2),
              (6, 80, 3, 3, 2), (6, 112, 3, 5, 1), (6, 192, 4, 5, 2),
              (6, 320, 1, 3, 1)]
    def c(v):
        return max(int(v * w), 8)
    blocks: List[Tuple[str, nn.Module]] = [
        ("stem", ConvBNAct(3, c(32), 3, 2, act="silu"))]
    cin = c(32)
    for s, (e, co, r, k, st) in enumerate(stages):
        for b in range(r):
            blk = MBConv(cin, c(co), k, st if b == 0 else 1, e)
            blocks.append((f"s{s}b{b}", blk))
            cin = c(co)
    blocks.append(("head", ConvBNAct(cin, c(1280), 1, act="silu")))
    blocks.append(("cls", Classifier(c(1280), [], n_classes)))
    return CNNModel("efficientnet_b0", blocks, in_hw)


CNN_ZOO = {
    "vgg16": vgg16,
    "resnet50": resnet50,
    "squeezenet11": squeezenet11,
    "googlenet": googlenet,
    "regnetx_400mf": regnetx_400mf,
    "efficientnet_b0": efficientnet_b0,
}


def build_cnn(name: str, **kw) -> CNNModel:
    return CNN_ZOO[name](**kw)


def reduced_cnn(name: str, n_classes: int = 10, in_hw: int = 32) -> CNNModel:
    """Small variants for CPU experiments (narrow widths, low resolution)."""
    kw = {"n_classes": n_classes, "in_hw": in_hw, "w": 0.25}
    if name == "vgg16":
        return vgg16(n_classes, in_hw, w=0.125, fc_dim=128)
    if name == "resnet50":
        return resnet50(n_classes, in_hw, w=0.25, depths=(1, 1, 1, 1))
    return CNN_ZOO[name](**kw)
