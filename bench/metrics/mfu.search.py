"""The whole search's share of the chip: the domination tests of every
ranking in the traced search (K1's and K2's launches, counted from their
inputs) over the traced window, against the float32 CUDA-core peak
(comparisons have no tensor-core form)."""

from bench.lib import peaks


def read(ctx):
    tr, launches = ctx.trace, ctx.out.get("work", [])
    if tr is None or not launches or not tr.device:
        return None
    ops = sum(o for _, o, _ in launches)
    return {"value": 100.0 * ops / (tr.window_s * peaks.FP32_CUDA_CORE_OPS_S),
            "bound": "operations", "peak": peaks.FP32_NAME}
