"""K1 (``packed_domination_kernel``) against its least time in the traced
search: each launch's domination tests (counted from its inputs) at the
float32 CUDA-core peak, or its bytes at HBM bandwidth, whichever is
larger, summed, over the kernel's device time from the profiler."""

from bench.lib import peaks


def read(ctx):
    tr = ctx.trace
    launches = [w for w in ctx.out.get("work", []) if w[0] == "K1"]
    if tr is None or not launches:
        return None
    kernels = tr.kernels("packed_domination_kernel")
    if not kernels:
        return None
    spent = sum(d for _, _, d in kernels) / 1e6
    t_ops = sum(ops for _, ops, _ in launches) / peaks.FP32_CUDA_CORE_OPS_S
    t_bytes = sum(b for _, _, b in launches) / peaks.HBM_BYTES_S
    least = sum(peaks.least_seconds(ops, b, peaks.FP32_CUDA_CORE_OPS_S)[0]
                for _, ops, b in launches)
    return {"value": 100.0 * least / spent,
            "bound": "operations" if t_ops >= t_bytes else "bytes",
            "peak": peaks.FP32_NAME, "launches": len(kernels)}
