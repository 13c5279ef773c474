"""The oracle's share of the chip: EfficientNet-B0's convolution and
dense FLOPs an image x the images scored in the traced window, over the
window, against the TF32 dense tensor-core peak (the fake-quantization
passes are not counted: they are no products)."""

from bench.lib import peaks, work


def read(ctx):
    tr, n = ctx.trace, ctx.out.get("traced_vectors")
    if tr is None or not n or not tr.device:
        return None
    flops = n * ctx.out["images"] * work.effnet_flops_per_image(
        ctx.run.config)
    return {"value": 100.0 * flops / (tr.window_s * peaks.TF32_TENSOR_OPS_S),
            "bound": "operations", "peak": peaks.TF32_NAME}
