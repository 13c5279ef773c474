"""Weights drawn from the seed on the device, in a few large calls.

One ``randn`` fills every normally drawn leaf of a model as views of one
flat buffer, each view then scaled to its leaf's standard deviation; one
``rand`` gives the uniform leaves.  The program and the reference each get
the weights by calling these functions with the same seed, so neither
reads what the other made.  Names follow the port's parameter names.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from bench.lib import seeds

# (name, shape, kind, scale): kind "normal" (N(0, scale^2)), "uniform"
# (U(scale[0], scale[1])), "ones", or "stat" (filled in by calibration)
Leaf = Tuple[str, Tuple[int, ...], str, object]


def effnet_blocks(cfg: dict):
    """EfficientNet's blocks from the configuration's stage table: yields
    (name, kind, args) for the stem, each MBConv, the head and the
    classifier; widths scaled by ``width`` as the zoo scales them."""
    w = cfg.get("width", 1.0)

    def c(v):
        return max(int(v * w), 8)
    yield "stem", "conv", dict(cin=3, cout=c(32), k=3, stride=2, act=True)
    cin = c(32)
    for s, (e, co, r, k, st) in enumerate(cfg["stages"]):
        for b in range(r):
            cout, stride = c(co), (st if b == 0 else 1)
            yield f"s{s}b{b}", "mbconv", dict(
                cin=cin, cout=cout, k=k, stride=stride, expand=e,
                mid=cin * e, se=max(1, int(cin * 0.25)),
                skip=stride == 1 and cin == cout)
            cin = cout
    yield "head", "conv", dict(cin=cin, cout=c(1280), k=1, stride=1, act=True)
    yield "cls", "classifier", dict(cin=c(1280), n=cfg["num_classes"])


def _conv(p, cin, cout, k, groups=1) -> List[Leaf]:
    fan = (cin // groups) * k * k
    return [(p + "conv.w", (cout, cin // groups, k, k), "normal",
             math.sqrt(2.0 / fan)),
            (p + "bn.scale", (cout,), "uniform", (0.5, 1.5)),
            (p + "bn.bias", (cout,), "normal", 0.1),
            (p + "bn.mean", (cout,), "stat", None),
            (p + "bn.var", (cout,), "stat", None)]


def _dense(p, cin, cout) -> List[Leaf]:
    return [(p + "w", (cout, cin), "normal", math.sqrt(2.0 / cin)),
            (p + "b", (cout,), "normal", 0.1)]


def cnn_leaves(cfg: dict) -> List[Leaf]:
    """EfficientNet's leaves: He-normal convolutions and dense weights,
    biases and BatchNorm shifts N(0, 0.1^2), BatchNorm scales U(0.5, 1.5),
    running statistics measured later on calibration images (what a
    trained model has and a fresh init lacks)."""
    out: List[Leaf] = []
    for name, kind, a in effnet_blocks(cfg):
        p = name + "."
        if kind == "conv":
            out += _conv(p, a["cin"], a["cout"], a["k"])
        elif kind == "mbconv":
            if a["expand"] != 1:
                out += _conv(p + "exp.", a["cin"], a["mid"], 1)
            out += _conv(p + "dw.", a["mid"], a["mid"], a["k"], a["mid"])
            out += _dense(p + "se.fc1.", a["mid"], a["se"])
            out += _dense(p + "se.fc2.", a["se"], a["mid"])
            out += _conv(p + "proj.", a["mid"], a["cout"], 1)
        else:
            out += _dense(p + "head.", a["cin"], a["n"])
    return out


def draw(leaves: List[Leaf], seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf from ``seed``: the normal leaves as scaled views of one
    ``randn`` buffer, the uniform ones of one ``rand`` buffer."""
    g = torch.Generator(device=device)
    g.manual_seed(seeds.derive(seed, 23, bits=63))
    n_norm = sum(math.prod(s) for _, s, k, _ in leaves if k == "normal")
    n_unif = sum(math.prod(s) for _, s, k, _ in leaves if k == "uniform")
    normal = torch.randn(n_norm, generator=g, device=device)
    unif = torch.rand(max(n_unif, 1), generator=g, device=device)
    out: Dict[str, torch.Tensor] = {}
    i = j = 0
    with torch.no_grad():
        for name, shape, kind, scale in leaves:
            n = math.prod(shape)
            if kind == "normal":
                out[name] = normal[i:i + n].view(shape).mul_(scale)
                i += n
            elif kind == "uniform":
                lo, hi = scale
                out[name] = unif[j:j + n].view(shape).mul_(hi - lo).add_(lo)
                j += n
            elif kind == "ones":
                out[name] = torch.ones(shape, device=device)
            else:
                out[name] = torch.zeros(shape, device=device)
    return out
