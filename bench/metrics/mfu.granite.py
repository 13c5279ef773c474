"""The hybrid LM oracle's share of the chip: the products of one forward
of the evaluation sequences (``bench/lib/granite.py::forward_flops``: the
projections, MLPs and head, the SSD scans and causal attention, each
counted once) x the vectors scored in the traced window, over the window,
against the float32 CUDA-core peak (the configuration keeps TF32 off; the
fake-quantization passes are no products)."""

from bench.lib import granite, peaks


def read(ctx):
    tr, n = ctx.trace, ctx.out.get("traced_vectors")
    if tr is None or not n or not tr.device:
        return None
    flops = n * granite.forward_flops(ctx.run.config, ctx.out["sequences"],
                                      ctx.out["tokens"])
    return {"value": 100.0 * flops / (tr.window_s
                                      * peaks.FP32_CUDA_CORE_OPS_S),
            "bound": "operations", "peak": peaks.FP32_NAME}
