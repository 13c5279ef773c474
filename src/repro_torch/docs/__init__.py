"""Public-API documentation of the PyTorch port: generated reference and
docstring gate (the JAX package's ``repro.docs``, for ``repro_torch``).

``PUBLIC_API`` names the port's supported surface: the search on the card
(``core.partition_torch``, ``core.nsga2_torch``, ``TorchNSGA2Search``), the
kernels' dispatch (``kernels.ops``), the serve runtime, observability, the
models, training and the optimizers.  From that one list this package
derives both artifacts:

* ``python -m repro_torch.docs``          writes ``docs/api_torch.md``
  (stdlib ``inspect`` only);
* ``python -m repro_torch.docs --check``  exits non-zero when any listed
  object, or any public method of a listed class, has no docstring.

Adding a name here makes it public: it must import from the stated module
and be documented.  ``docs/api.md`` is the JAX package's page.
"""

from __future__ import annotations

import importlib
import inspect
from typing import Iterator, List, Tuple

# (module, names): the supported public surface, grouped by layer from the
# search down to the kernels, then the model side
PUBLIC_API: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("repro_torch.core", (
        "LayerGraph", "LayerInfo", "SystemConfig", "Platform", "QuantSpec",
        "LinkModel", "get_link", "Constraints", "PartitionEvaluator",
        "ProxyAccuracy", "MeasuredAccuracy",
    )),
    ("repro_torch.core.partition_torch", (
        "EvalTables", "build_eval_tables", "make_batch_eval_fn",
        "make_runtime_eval_fn",
    )),
    ("repro_torch.core.nsga2_torch", (
        "torch_nsga2", "torch_nsga2_restarts", "warm_population",
        "nondominated_rank",
    )),
    ("repro_torch.explore", (
        "ExplorationSpec", "SearchSettings", "ModelRef", "PlatformSpec",
        "LinkSpec", "SystemSpec", "AccuracySpec", "SweepSpec", "Campaign",
        "ExplorationResult", "run_search", "run_spec", "explore_graph",
        "lm_block_cuts", "candidate_positions", "register_strategy",
        "SearchStrategy", "NSGA2Search", "TorchNSGA2Search",
        "OnlineRepartitioner", "RepartitionDecision", "degrade_link",
        "drop_node",
    )),
    ("repro_torch.kernels.ops", (
        "packed_domination", "domination_counts", "window_attn", "ssd_scan",
        "quant_matmul", "fake_quant_tensors", "mbconv_dw",
    )),
    ("repro_torch.serve", (
        "SlotScheduler", "PipelineServeEngine", "ReplicaRouter", "Request",
        "RequestRecord", "ServeReport", "ServeLink", "RequestStream",
        "poisson_traffic", "stream_of",
        "FaultPlan", "LinkDegrade", "StageStall", "ReplicaCrash",
        "ReplicaCrashError", "FaultTrace",
        "HealthMonitor", "Ewma", "FailureDetector", "DivergenceMonitor",
        "DriftSignal",
    )),
    ("repro_torch.obs", (
        "Obs", "Tracer", "NullTracer", "Span", "Laps", "MetricsRegistry",
        "Counter", "Gauge", "Histogram", "default_registry",
        "to_chrome_trace", "write_chrome_trace", "load_chrome_trace",
        "validate_chrome_trace", "percentile", "latency_summary",
        "mean_tail",
    )),
    ("repro_torch.configs.base", ("ModelConfig", "RopeScaling")),
    ("repro_torch.models.registry", (
        "get_config", "build_model", "model_graph",
    )),
    ("repro_torch.models.decoder", ("DecoderLM", "AttnUnit", "FfnUnit")),
    ("repro_torch.models.ssm_lm", ("SSMLM", "MixedLM", "MoeUnit")),
    ("repro_torch.nn.moe", ("MoEFFN",)),
    ("repro_torch.models.convert", (
        "load_reference_params", "reference_params", "load_reference_cnn",
    )),
    ("repro_torch.serving", (
        "GenerationEngine", "PartitionedLMRunner", "PartitionedCNNRunner",
    )),
    ("repro_torch.quantize", ("cnn_measured_accuracy",
                              "lm_measured_accuracy")),
    ("repro_torch.training", (
        "make_train_step", "lm_loss", "cross_entropy", "init_params",
        "make_classifier_train_step",
    )),
    ("repro_torch.optim", (
        "sgd", "adamw", "adafactor", "get_optimizer", "clip_by_global_norm",
        "apply_updates", "constant", "cosine_decay", "warmup_cosine",
    )),
)


def iter_api() -> Iterator[Tuple[str, str, object]]:
    """Yield ``(module_name, attr_name, object)`` for every PUBLIC_API
    entry; raises if a listed name fails to import (the list *is* the
    contract, so a stale entry is an error, not a skip)."""
    for mod_name, names in PUBLIC_API:
        mod = importlib.import_module(mod_name)
        for name in names:
            obj = getattr(mod, name, None)
            if obj is None:
                raise AttributeError(
                    f"PUBLIC_API lists {mod_name}.{name} but the module "
                    "does not export it")
            yield mod_name, name, obj


def _public_methods(cls) -> List[Tuple[str, object]]:
    out = []
    for name, member in vars(cls).items():
        if name.startswith("_"):
            continue
        fn = member
        if isinstance(member, (staticmethod, classmethod)):
            fn = member.__func__
        elif isinstance(member, property):
            fn = member.fget
        if not callable(fn):
            continue
        out.append((name, fn))
    return out


def missing_docstrings() -> List[str]:
    """Dotted paths of public objects (and public methods of public
    classes) whose ``__doc__`` is empty: the gate's finding list."""
    missing = []
    for mod_name, name, obj in iter_api():
        path = f"{mod_name}.{name}"
        if not inspect.getdoc(obj):
            missing.append(path)
        if inspect.isclass(obj):
            for mname, fn in _public_methods(obj):
                if not (fn.__doc__ or "").strip():
                    missing.append(f"{path}.{mname}")
    return missing


def _signature(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc_block(obj, indent: str = "") -> str:
    doc = inspect.getdoc(obj) or ""
    return "\n".join(indent + line if line else ""
                     for line in doc.splitlines())


def render_api_md() -> str:
    """The full ``docs/api_torch.md`` markdown, rendered from live
    docstrings."""
    lines = [
        "# API reference of the PyTorch port",
        "",
        "Generated by `PYTHONPATH=src python -m repro_torch.docs` from the",
        "`repro_torch.docs.PUBLIC_API` surface — edit docstrings, not this "
        "file.",
        "The JAX package's page is `docs/api.md`.  The page checks its own",
        "surface: every name imports, and every one is documented.",
        "",
        "```python",
        "from repro_torch.docs import missing_docstrings",
        "assert missing_docstrings() == []",
        "```",
        "",
    ]
    for mod_name, names in PUBLIC_API:
        mod = importlib.import_module(mod_name)
        lines += [f"## `{mod_name}`", ""]
        head = (inspect.getdoc(mod) or "").split("\n\n")[0]
        if head:
            lines += [head, ""]
        for name in names:
            obj = getattr(mod, name)
            if inspect.isclass(obj):
                init_sig = _signature(obj.__init__).replace("(self, ", "(") \
                    .replace("(self)", "()")
                lines += [f"### class `{name}{init_sig}`", "",
                          _doc_block(obj), ""]
                for mname, fn in sorted(_public_methods(obj)):
                    first = (inspect.getdoc(fn) or "").split("\n")[0]
                    lines.append(
                        f"- **`{mname}{_signature(fn)}`** — {first}")
                if _public_methods(obj):
                    lines.append("")
            else:
                lines += [f"### `{name}{_signature(obj)}`", "",
                          _doc_block(obj), ""]
    return "\n".join(lines).rstrip() + "\n"
