"""K4 (the SSD scan kernel, ``ssd_*_kernel``: five launches a call)
against its least time in the traced window: each call's products
(``bench/lib/granite.py::ssd_work``, counted once) at the TF32
tensor-core peak or its bytes at HBM bandwidth, whichever is longer, x the
calls the program counted (``ssm_scan_calls.cuda``), over the device time
of the kernel's launches from the profiler."""

from bench.lib import granite, peaks


def read(ctx):
    tr, counters = ctx.trace, ctx.out.get("counters", {})
    calls = counters.get("ssm_scan_calls.cuda")
    if tr is None or not calls:
        return None
    kernels = [k for k in tr.kernels("ssd_") if "_kernel" in k[0]]
    if not kernels:
        return None
    c = ctx.run.config
    work = granite.ssd_work(ctx.out["sequences"], ctx.out["tokens"],
                            c["mamba_n_heads"], c["mamba_d_head"],
                            c["mamba_d_state"], c["mamba_chunk_size"])
    least, bound = peaks.least_seconds(work["ops"], work["bytes"],
                                       peaks.TF32_TENSOR_OPS_S)
    spent = sum(d for _, _, d in kernels) / 1e6
    return {"value": 100.0 * calls * least / spent, "bound": bound,
            "peak": peaks.TF32_NAME if bound == "operations"
            else peaks.HBM_NAME,
            "launches": len(kernels), "calls": calls,
            "ref_calls": counters.get("ssm_scan_calls.ref", 0)}
