"""The work a call needs, from its shapes alone: operations and bytes for
the rooflines and the ``mfu`` shares.

Each operation is counted once; a product or a convolution counts 2 x its
multiply-adds; a Deb domination test counts 2m float compares for a
pair of feasible individuals, 1 for a pair of infeasible ones, none for a
mixed pair, plus one feasibility test per row and column.  Bytes: each
input read once and each output written once.
"""

from __future__ import annotations

import math


# -- Pareto domination ------------------------------------------------------

def domination_ops(m: int, feas_rows: int, rows: int, feas_cols: int,
                   cols: int) -> int:
    return (feas_rows * feas_cols * 2 * m + (rows - feas_rows)
            * (cols - feas_cols) + rows + cols)


def packed_domination_bytes(rows: int, cols: int, m: int) -> int:
    """Objectives and violations of rows and columns, and the packed
    words written."""
    return 4 * ((rows + cols) * (m + 1) + math.ceil(rows / 32) * cols)


def domination_counts_bytes(n: int, m: int) -> int:
    """Objectives, violations and the alive mask read, counts written."""
    return 4 * (n * (m + 1) + 2 * n)


# -- EfficientNet -------------------------------------------------------------

def effnet_flops_per_image(cfg: dict) -> int:
    """Convolutions and dense layers of one image, from the stage table."""
    from bench.lib.weights import effnet_blocks
    hw = cfg["image_size"]
    total = 0

    def conv(cin, cout, k, stride, groups=1):
        nonlocal hw
        hw = (hw + 2 * (k // 2) - k) // stride + 1
        return 2 * hw * hw * cout * (cin // groups) * k * k

    for _, kind, a in effnet_blocks(cfg):
        if kind == "conv":
            total += conv(a["cin"], a["cout"], a["k"], a["stride"])
        elif kind == "mbconv":
            if a["expand"] != 1:
                total += conv(a["cin"], a["mid"], 1, 1)
            total += conv(a["mid"], a["mid"], a["k"], a["stride"], a["mid"])
            total += 2 * 2 * a["mid"] * a["se"]
            total += conv(a["mid"], a["cout"], 1, 1)
        else:
            total += 2 * a["cin"] * a["n"]
    return total
