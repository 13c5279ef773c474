"""The port's static analyzer (stdlib ``ast`` only: no torch, no jax).

Four rule families, one per contract surface whose breakage is silent or
runtime-only:

* **RPT1xx capture safety** — Python control flow / host syncs on device
  values inside ``torch.compile``, ``torch.jit`` and CUDA-graph capture
  regions, capture objects built inside a loop.
* **RPT2xx CUDA launch contracts** — kernel loads and launches outside
  ``repro_torch/kernels/``, launch arity against ``argtypes``, unchecked
  launch results, literal ``impl="ref"`` at call sites, builds at import
  time, launch counters, fallbacks to the plain version on a card.
* **RPR3xx fleet atomicity** — truncating writes bypassing
  ``repro_torch.utils.atomicio``, cross-filesystem tmp+replace, claim
  files without O_EXCL semantics.
* **RPR4xx monotonic clocks** — wall-clock durations in
  ``repro_torch/{serve,fleet,obs}/``.

CLI: ``python -m repro_torch.analysis [paths...] [--baseline FILE]``.
"""

from repro_torch.analysis.baseline import (Baseline, BaselineError,
                                           apply_baseline, load_baseline,
                                           write_baseline)
from repro_torch.analysis.core import (Finding, ModuleContext, Rule,
                                       all_rules, analyze_file,
                                       analyze_paths, rule)

__all__ = [
    "Baseline", "BaselineError", "Finding", "ModuleContext", "Rule",
    "all_rules", "analyze_file", "analyze_paths", "apply_baseline",
    "load_baseline", "rule", "write_baseline",
]
