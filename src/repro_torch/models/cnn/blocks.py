"""CNN building blocks with two faces:

* each block is an ``nn.Module`` whose forward runs the block (BatchNorm
  on the running statistics in eval mode, on the batch's in training
  mode), with its parameters named after the JAX
  package's pytree keys (``exp.conv.w``, ``dw.bn.scale``, ``se.fc1.b``), and
* each block can ``emit`` its op-level nodes into a :class:`LayerGraph`
  for the partitioner, with ONNX-style names (``Conv_7``, ``Relu_3``, ...)
  matching the paper's naming of partition points.

Parameters are created on the ``meta`` device (``nn.layers``): emitting the
graph of a full-size model allocates no weights.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import layers as GL
from repro_torch.core.graph import LayerGraph
from repro_torch.kernels import ops
from repro_torch.nn.layers import BatchNorm2d, Conv2d, SqueezeExcite, max_pool


class GraphBuilder:
    """Accumulates LayerInfo nodes with ONNX-export-style running names."""

    def __init__(self, name: str):
        self.g = LayerGraph(name=name)
        self._counts = {}

    def _name(self, kind: str) -> str:
        i = self._counts.get(kind, 0)
        self._counts[kind] = i + 1
        return f"{kind}_{i}"

    def add(self, info: GL.LayerInfo, after) -> str:
        if isinstance(after, str):
            after = [after]
        self.g.add(info, after=after or None)
        return info.name

    def conv(self, cin, cout, hw, k, stride=1, padding=None, groups=1,
             bias=True, after=None) -> Tuple[str, Tuple[int, int], int]:
        info = GL.conv_layer(self._name("Conv"), cin, cout, hw, k, stride,
                             padding, groups, bias)
        name = self.add(info, after)
        return name, info.out_shape[1:], cout

    def bn(self, c, hw, after) -> str:
        return self.add(GL.bn_layer(self._name("BatchNormalization"),
                                    (c, *hw)), after)

    def relu(self, c, hw, after, kind="Relu") -> str:
        return self.add(GL.elementwise_layer(self._name(kind), GL.RELU,
                                             (c, *hw)), after)

    def add_op(self, c, hw, after: Sequence[str]) -> str:
        return self.add(GL.elementwise_layer(self._name("Add"), GL.ADD,
                                             (c, *hw)), list(after))

    def mul_op(self, c, hw, after: Sequence[str]) -> str:
        return self.add(GL.elementwise_layer(self._name("Mul"), GL.MUL,
                                             (c, *hw)), list(after))

    def pool(self, c, hw, k, stride=None, padding=0, after=None,
             global_pool=False) -> Tuple[str, Tuple[int, int]]:
        kind = "GlobalAveragePool" if global_pool else "MaxPool"
        info = GL.pool_layer(self._name(kind), c, hw, k, stride, padding,
                             global_pool)
        return self.add(info, after), info.out_shape[1:]

    def concat(self, shapes, after: Sequence[str]) -> Tuple[str, int]:
        info = GL.concat_layer(self._name("Concat"), shapes, axis=0)
        return self.add(info, list(after)), info.out_shape[0]

    def flatten(self, shape, after) -> Tuple[str, int]:
        info = GL.flatten_layer(self._name("Flatten"), shape)
        return self.add(info, after), info.out_shape[0]

    def gemm(self, cin, cout, after, bias=True) -> str:
        return self.add(GL.gemm_layer(self._name("Gemm"), cin, cout, bias),
                        after)


# ---------------------------------------------------------------------------
# composite blocks
# ---------------------------------------------------------------------------

class ConvBNAct(nn.Module):
    def __init__(self, cin, cout, k, stride=1, padding=None, groups=1,
                 act: str = "relu", bn: bool = True):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, stride, padding, groups, bias=not bn)
        self.bn = BatchNorm2d(cout) if bn else None
        self.act = act
        self.cfg = (cin, cout, k, stride, padding, groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.act == "relu":
            x = F.relu(x)
        elif self.act == "silu":
            x = F.silu(x)
        return x

    def emit(self, gb: GraphBuilder, cin, hw, after):
        _, cout, k, stride, padding, groups = self.cfg
        name, hw, c = gb.conv(cin, cout, hw, k, stride, padding, groups,
                              bias=self.bn is None, after=after)
        if self.bn:
            name = gb.bn(c, hw, name)
        if self.act != "none":
            name = gb.relu(c, hw, name)
        return name, hw, c


class Bottleneck(nn.Module):
    """ResNet-50 bottleneck (1x1 -> 3x3 -> 1x1 + skip)."""

    expansion = 4

    def __init__(self, cin, planes, stride=1):
        super().__init__()
        cout = planes * self.expansion
        self.b1 = ConvBNAct(cin, planes, 1)
        self.b2 = ConvBNAct(planes, planes, 3, stride)
        self.b3 = ConvBNAct(planes, cout, 1, act="none")
        self.down = (ConvBNAct(cin, cout, 1, stride, act="none")
                     if (stride != 1 or cin != cout) else None)
        self.cout = cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.b3(self.b2(self.b1(x)))
        idn = self.down(x) if self.down is not None else x
        return F.relu(y + idn)

    def emit(self, gb, cin, hw, after):
        n1, hw1, c1 = self.b1.emit(gb, cin, hw, after)
        n2, hw2, c2 = self.b2.emit(gb, c1, hw1, n1)
        n3, hw3, c3 = self.b3.emit(gb, c2, hw2, n2)
        skip = after
        if self.down:
            skip, _, _ = self.down.emit(gb, cin, hw, after)
        add = gb.add_op(c3, hw3, [n3] + ([skip] if skip else []))
        out = gb.relu(c3, hw3, add)
        return out, hw3, c3


class Fire(nn.Module):
    """SqueezeNet fire module."""

    def __init__(self, cin, squeeze, e1, e3):
        super().__init__()
        self.sq = ConvBNAct(cin, squeeze, 1, bn=False)
        self.e1 = ConvBNAct(squeeze, e1, 1, bn=False)
        self.e3 = ConvBNAct(squeeze, e3, 3, bn=False)
        self.cout = e1 + e3

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.sq(x)
        return torch.cat([self.e1(s), self.e3(s)], dim=1)

    def emit(self, gb, cin, hw, after):
        ns, hws, cs = self.sq.emit(gb, cin, hw, after)
        n1, hw1, c1 = self.e1.emit(gb, cs, hws, ns)
        n3, hw3, c3 = self.e3.emit(gb, cs, hws, ns)
        name, cout = gb.concat([(c1, *hw1), (c3, *hw3)], [n1, n3])
        return name, hw1, cout


class Inception(nn.Module):
    """GoogLeNet inception module (v1)."""

    def __init__(self, cin, c1, c3r, c3, c5r, c5, pp):
        super().__init__()
        self.b1 = ConvBNAct(cin, c1, 1)
        self.b3a = ConvBNAct(cin, c3r, 1)
        self.b3b = ConvBNAct(c3r, c3, 3)
        self.b5a = ConvBNAct(cin, c5r, 1)
        self.b5b = ConvBNAct(c5r, c5, 3)   # torchvision uses 3x3 here
        self.bp = ConvBNAct(cin, pp, 1)
        self.cout = c1 + c3 + c5 + pp

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.b1(x), self.b3b(self.b3a(x)),
                          self.b5b(self.b5a(x)), self.bp(max_pool(x, 3, 1, 1))],
                         dim=1)

    def emit(self, gb, cin, hw, after):
        n1, hw1, c1 = self.b1.emit(gb, cin, hw, after)
        n3, hw3, c3 = self.b3a.emit(gb, cin, hw, after)
        n3, hw3, c3 = self.b3b.emit(gb, c3, hw3, n3)
        n5, hw5, c5 = self.b5a.emit(gb, cin, hw, after)
        n5, hw5, c5 = self.b5b.emit(gb, c5, hw5, n5)
        np_, hwp = gb.pool(cin, hw, 3, 1, 1, after)
        np_, hwp, cp = self.bp.emit(gb, cin, hwp, np_)
        name, cout = gb.concat([(c1, *hw1), (c3, *hw3), (c5, *hw5),
                                (cp, *hwp)], [n1, n3, n5, np_])
        return name, hw1, cout


class MBConv(nn.Module):
    """EfficientNet MBConv with SE and silu.

    The depthwise unit (the expansion's BatchNorm and SiLU, the depthwise
    convolution, its BatchNorm and SiLU, the squeeze-excite mean) runs as
    one call of ``kernels.ops.mbconv_dw`` in eval mode with grad disabled:
    the hand-written kernel K8 on a CUDA tensor, its plain version (the
    same chain of ops) on the CPU.  In training mode (batch statistics) or
    with grad enabled the block runs its layers one by one."""

    def __init__(self, cin, cout, k, stride, expand, se_ratio=0.25):
        super().__init__()
        mid = cin * expand
        self.exp = ConvBNAct(cin, mid, 1, act="silu") if expand != 1 else None
        self.dw = ConvBNAct(mid, mid, k, stride, groups=mid, act="silu")
        self.se = SqueezeExcite(mid, max(1, int(cin * se_ratio)))
        self.proj = ConvBNAct(mid, cout, 1, act="none")
        self.skip = stride == 1 and cin == cout
        self.cout = cout
        self.mid = mid

    def dw_route(self, x: torch.Tensor) -> str:
        """Where the depthwise unit runs on ``x``: ``"cuda"`` (K8) or
        ``"ref"`` (the chain of ops, as one call or layer by layer)."""
        return ("cuda" if x.is_cuda and not self.training
                and not torch.is_grad_enabled() else "ref")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training or torch.is_grad_enabled():
            y = self.exp(x) if self.exp is not None else x
            y = self.proj(self.se(self.dw(y)))
        else:
            e = self.exp.conv(x) if self.exp is not None else x
            y, pooled = ops.mbconv_dw(
                e, self.dw.conv.w, self.dw.conv.stride,
                self.dw.bn.inference(),
                self.exp.bn.inference() if self.exp is not None else None)
            y = self.proj(self.se.excite(y, pooled))
        return y + x if self.skip else y

    def emit(self, gb, cin, hw, after):
        name, h, c = after, hw, cin
        if self.exp:
            name, h, c = self.exp.emit(gb, c, h, name)
        name, h, c = self.dw.emit(gb, c, h, name)
        # SE: gp -> fc -> fc -> mul
        gp, _ = gb.pool(c, h, 0, after=name, global_pool=True)
        f1 = gb.gemm(c, max(1, int(cin * 0.25)), gp)
        f2 = gb.gemm(max(1, int(cin * 0.25)), c, f1)
        name = gb.mul_op(c, h, [name, f2])
        name, h, c = self.proj.emit(gb, c, h, name)
        if self.skip:
            name = gb.add_op(c, h, [name, after])
        return name, h, c


class XBlock(nn.Module):
    """RegNetX block: 1x1 -> 3x3 group conv -> 1x1 + skip."""

    def __init__(self, cin, cout, stride, group_width):
        super().__init__()
        groups = max(cout // group_width, 1)
        self.a = ConvBNAct(cin, cout, 1)
        self.b = ConvBNAct(cout, cout, 3, stride, groups=groups)
        self.c = ConvBNAct(cout, cout, 1, act="none")
        self.down = (ConvBNAct(cin, cout, 1, stride, act="none")
                     if (stride != 1 or cin != cout) else None)
        self.cout = cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.c(self.b(self.a(x)))
        idn = self.down(x) if self.down is not None else x
        return F.relu(y + idn)

    def emit(self, gb, cin, hw, after):
        n, h, c = self.a.emit(gb, cin, hw, after)
        n, h, c = self.b.emit(gb, c, h, n)
        n, h, c = self.c.emit(gb, c, h, n)
        skip = after
        if self.down:
            skip, _, _ = self.down.emit(gb, cin, hw, after)
        add = gb.add_op(c, h, [n] + ([skip] if skip else []))
        out = gb.relu(c, h, add)
        return out, h, c
