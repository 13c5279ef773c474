"""The oracle's share of the chip on the hybrid LM with experts: the
products of the traced vectors' forwards (``bench/lib/granite_moe.py::
forward_flops``: the projections, the routers, the shared experts, the
head, the SSD scans and causal attention, each counted once, and the held
experts' gated products at the rows they computed, the program's counter
``moe_rows.held``), over the window, against the float32 CUDA-core peak
(the configuration keeps TF32 off)."""

from bench.lib import granite_moe, peaks


def read(ctx):
    tr, n = ctx.trace, ctx.out.get("traced_vectors")
    rows = ctx.out.get("counters", {}).get("moe_rows.held")
    if tr is None or not n or not tr.device or rows is None:
        return None
    flops = n * granite_moe.forward_flops(
        ctx.run.config, ctx.out["sequences"], ctx.out["tokens"],
        held_rows=rows / n)
    return {"value": 100.0 * flops / (tr.window_s
                                      * peaks.FP32_CUDA_CORE_OPS_S),
            "bound": "operations", "peak": peaks.FP32_NAME,
            "moe_rows_held": rows}
