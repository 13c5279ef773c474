"""Capture the §Perf hillclimb rows (the JAX package's
``repro.launch.hillclimb_capture``): baseline against optimized dry-run
rows for the reference's four pairs, on the ``meta`` device against the
H100's peaks, written to ``experiments/hillclimb_optimized.json`` under
the working directory.

  PYTHONPATH=src python -m repro_torch.launch.hillclimb_capture
"""

from __future__ import annotations

import os

from repro_torch.launch.dryrun import dryrun_one
from repro_torch.utils.atomicio import atomic_write_json

OUT = "experiments/hillclimb_optimized.json"

PAIRS = [
    # (arch, shape, final opts)
    ("qwen2-72b", "train_4k", ("fsdp",)),
    ("deepseek-v3-671b", "decode_32k", ("expert_ep",)),
    ("musicgen-large", "prefill_32k", ()),   # loop/layout fixes are default
    ("deepseek-v3-671b", "train_4k", ("attn_heads",)),  # bonus hillclimb D
]


def main():
    out = []
    for arch, shape, opts in PAIRS:
        base = dryrun_one(arch, shape, verbose=False, opts=())
        opt = dryrun_one(arch, shape, verbose=False, opts=opts) if opts else base
        row = {"arch": arch, "shape": shape, "opts": list(opts),
               "baseline": base, "optimized": opt}
        if "error" not in base and "error" not in opt:
            b, o = base["bound_s"], opt["bound_s"]
            row["speedup_on_bound"] = round(b / o, 2) if o else None
            print(f"{arch} × {shape}: bound {b:.3f}s -> {o:.3f}s "
                  f"({row['speedup_on_bound']}x) opts={list(opts)}")
        out.append(row)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    atomic_write_json(OUT, out)
    print(f"wrote {OUT}")
    return out


if __name__ == "__main__":
    main()
