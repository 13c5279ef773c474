"""EfficientNet-B0's layer graph from its stage table, without torch.

The nodes, their ONNX-style names and their order follow the graph that
the port's CNN zoo emits for the same model (stem, MBConv blocks with
squeeze-excite, head, classifier), so schedule positions and cut vectors
mean the same here and there.  ``block_ends`` gives, per block, the name
of its last node: the boundary a cut position maps onto.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from . import layers as GL
from .graph import LayerGraph

# (expand, cout, repeats, kernel, stride): Tan & Le, arXiv:1905.11946
EFFNET_B0_STAGES = ((1, 16, 1, 3, 1), (6, 24, 2, 3, 2), (6, 40, 2, 5, 2),
                    (6, 80, 3, 3, 2), (6, 112, 3, 5, 1), (6, 192, 4, 5, 2),
                    (6, 320, 1, 3, 1))


class _Builder:
    def __init__(self, name: str):
        self.g = LayerGraph(name=name)
        self._counts: Dict[str, int] = {}

    def _name(self, kind: str) -> str:
        i = self._counts.get(kind, 0)
        self._counts[kind] = i + 1
        return f"{kind}_{i}"

    def add(self, info, after) -> str:
        if isinstance(after, str):
            after = [after]
        self.g.add(info, after=after or None)
        return info.name

    def conv(self, cin, cout, hw, k, stride=1, groups=1, bias=False,
             after=None):
        info = GL.conv_layer(self._name("Conv"), cin, cout, hw, k, stride,
                             None, groups, bias)
        return self.add(info, after), info.out_shape[1:]

    def conv_bn_act(self, cin, cout, hw, k, stride=1, groups=1, act=True,
                    after=None):
        name, hw = self.conv(cin, cout, hw, k, stride, groups, after=after)
        name = self.add(GL.bn_layer(self._name("BatchNormalization"),
                                    (cout, *hw)), name)
        if act:
            name = self.add(GL.elementwise_layer(self._name("Relu"), GL.RELU,
                                                 (cout, *hw)), name)
        return name, hw

    def gpool(self, c, hw, after):
        info = GL.pool_layer(self._name("GlobalAveragePool"), c, hw, 0, None,
                             0, True)
        return self.add(info, after)

    def gemm(self, cin, cout, after):
        return self.add(GL.gemm_layer(self._name("Gemm"), cin, cout, True),
                        after)


def effnet_b0_graph(in_hw: int = 224, width: float = 1.0,
                    n_classes: int = 1000,
                    stages: Sequence[Tuple[int, ...]] = EFFNET_B0_STAGES
                    ) -> Tuple[LayerGraph, List[str]]:
    """(graph, block_ends): the model's layer graph and the last node of
    each of its blocks (stem, the MBConv blocks, head, classifier)."""
    def c(v):
        return max(int(v * width), 8)

    b = _Builder("efficientnet_b0")
    ends: List[str] = []
    hw = (in_hw, in_hw)
    name, hw = b.conv_bn_act(3, c(32), hw, 3, 2)
    ends.append(name)
    cin = c(32)
    for e, co, r, k, st in stages:
        for i in range(r):
            cout, stride = c(co), (st if i == 0 else 1)
            after, h, ch = name, hw, cin
            mid = cin * e
            if e != 1:
                name, h = b.conv_bn_act(ch, mid, h, 1, after=name)
                ch = mid
            name, h = b.conv_bn_act(ch, ch, h, k, stride, groups=ch,
                                    after=name)
            gp = b.gpool(ch, h, name)
            red = max(1, int(cin * 0.25))
            f1 = b.gemm(ch, red, gp)
            f2 = b.gemm(red, ch, f1)
            name = b.add(GL.elementwise_layer(b._name("Mul"), GL.MUL,
                                              (ch, *h)), [name, f2])
            name, h = b.conv_bn_act(ch, cout, h, 1, act=False, after=name)
            if stride == 1 and cin == cout:
                name = b.add(GL.elementwise_layer(b._name("Add"), GL.ADD,
                                                  (cout, *h)), [name, after])
            ends.append(name)
            hw, cin = h, cout
    name, hw = b.conv_bn_act(cin, c(1280), hw, 1, after=name)
    ends.append(name)
    gp = b.gpool(c(1280), hw, name)
    flat = b.add(GL.flatten_layer(b._name("Flatten"), (c(1280), 1, 1)), gp)
    ends.append(b.gemm(c(1280), n_classes, flat))
    return b.g, ends


def cut_to_block(schedule, block_ends: Sequence[str], cut_pos: int) -> int:
    """The last block whose nodes all lie in ``schedule[: cut_pos + 1]``,
    blocks taken in order (-1 when not even the first does)."""
    prefix = {l.name for l in schedule[: cut_pos + 1]}
    blk = -1
    for bi, node in enumerate(block_ends):
        if node not in prefix:
            break
        blk = bi
    return blk
