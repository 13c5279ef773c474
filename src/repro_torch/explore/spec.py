"""Declarative exploration specs — JSON-round-trippable descriptions of one
exploration run: *which model*, *which system*, *which objectives and
constraints*, *which search strategy*.

Everything here is data.  Resolution to live objects (layer graphs,
``SystemConfig``) happens in :meth:`ModelRef.build` / :meth:`SystemSpec.build`
so a spec can be stored, diffed, and shipped between machines, then executed
by :func:`repro_torch.explore.runner.run_spec` or fanned out by
:class:`repro_torch.explore.campaign.Campaign`.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple, Union

from repro_torch.core.link import LinkModel, get_link
from repro_torch.core.partition import Constraints, Platform, SystemConfig
from repro_torch.core.quant import QuantSpec

VALID_OBJECTIVES = ("latency", "energy", "throughput", "bandwidth",
                    "memory", "accuracy")
# built-in strategy names; names added via strategies.register_strategy are
# accepted too (SearchSettings falls back to the live registry)
VALID_STRATEGIES = ("auto", "exhaustive", "multicut", "nsga2",
                    "torch_nsga2")
# the JAX package's names for the same settings, mapped to the port's
REFERENCE_NAMES = {"strategy": {"jit_nsga2": "torch_nsga2"},
                   "rank_impl": {"pallas": "cuda"}}


@dataclasses.dataclass(frozen=True)
class ModelRef:
    """Reference to a model in one of the repo's registries.

    kind:
      * ``cnn``      — ``repro_torch.models.cnn.zoo`` (options: ``in_hw``,
        ``n_classes``, ``w`` …, forwarded to the zoo builder).
      * ``registry`` — ``repro_torch.models.registry`` LLM configs
        (options: ``seq`` (required for graph extraction), ``reduced``);
        the graph comes from the configuration alone, no weights are made.
        A hybrid model's shared block is returned as its shared groups, so
        that the memory model counts its weights once.
    """

    kind: str
    name: str
    options: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def label(self) -> str:
        """Display/report key for this model."""
        return self.name

    def build(self):
        """Resolve to ``(LayerGraph, shared_groups or None)``.

        Imports are lazy.
        """
        if self.kind == "cnn":
            from repro_torch.models.cnn.zoo import build_cnn
            return build_cnn(self.name, **self.options).to_graph(), None
        if self.kind == "registry":
            from repro_torch.models.registry import get_config, model_graph
            from repro_torch.models.ssm_lm import shared_groups
            opts = dict(self.options)
            seq = opts.pop("seq", 1024)
            reduced = opts.pop("reduced", False)
            cfg = get_config(self.name)
            if reduced:
                cfg = cfg.reduced()
            shared = shared_groups(cfg) if cfg.family == "hybrid" else None
            return model_graph(cfg, seq), shared
        raise ValueError(f"unknown model kind {self.kind!r} "
                         f"(expected 'cnn' or 'registry')")


@dataclasses.dataclass(frozen=True)
class PlatformSpec:
    """One compute node, by accelerator-registry name (see ``get_arch``)."""

    name: str
    arch: str
    bits: int = 8
    mem_capacity: Optional[int] = None

    def build(self) -> Platform:
        """Resolve the accelerator-registry name into a live Platform."""
        from repro_torch.core.hwmodel.arch import get_arch
        return Platform(self.name, get_arch(self.arch),
                        QuantSpec(bits=self.bits),
                        mem_capacity=self.mem_capacity)


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """A link-registry entry plus optional field overrides (e.g. a slower
    Ethernet for sensitivity sweeps)."""

    base: str = "gige"
    name: Optional[str] = None
    rate_bps: Optional[float] = None
    t_setup_s: Optional[float] = None
    payload_bytes: Optional[int] = None
    header_bytes: Optional[int] = None
    p_tx_w: Optional[float] = None
    p_rx_w: Optional[float] = None
    e_per_byte_j: Optional[float] = None

    _OVERRIDES = ("name", "rate_bps", "t_setup_s", "payload_bytes",
                  "header_bytes", "p_tx_w", "p_rx_w", "e_per_byte_j")

    def build(self) -> LinkModel:
        """The registry link with any non-None field overrides applied."""
        link = get_link(self.base)
        over = {f: getattr(self, f) for f in self._OVERRIDES
                if getattr(self, f) is not None}
        return dataclasses.replace(link, **over) if over else link


LinkLike = Union[str, LinkSpec]


def as_link_spec(link: LinkLike) -> LinkSpec:
    return LinkSpec(base=link) if isinstance(link, str) else link


@dataclasses.dataclass(frozen=True)
class SystemSpec:
    """A chain of platforms: ``platforms[i] --links[i]--> platforms[i+1]``."""

    platforms: Tuple[PlatformSpec, ...]
    links: Tuple[LinkSpec, ...]
    name: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "platforms", tuple(self.platforms))
        object.__setattr__(
            self, "links", tuple(as_link_spec(l) for l in self.links))
        if len(self.links) != len(self.platforms) - 1:
            raise ValueError(
                f"{len(self.platforms)} platforms need "
                f"{len(self.platforms) - 1} links, got {len(self.links)}")

    @property
    def label(self) -> str:
        """Display/report key: explicit name or the platform-name join."""
        return self.name or "+".join(p.name for p in self.platforms)

    def build(self) -> SystemConfig:
        """Materialize every platform and link into a SystemConfig."""
        return SystemConfig([p.build() for p in self.platforms],
                            [l.build() for l in self.links])

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SystemSpec":
        """Inverse of ``dataclasses.asdict``; links may be plain strings."""
        return cls(
            platforms=tuple(PlatformSpec(**p) for p in d["platforms"]),
            links=tuple(LinkSpec(**l) if isinstance(l, dict) else l
                        for l in d["links"]),
            name=d.get("name"))


@dataclasses.dataclass(frozen=True)
class AccuracySpec:
    """Declarative accuracy oracle selection.

    ``kind='proxy'`` (the default when the field is omitted) is the analytic
    :class:`~repro_torch.core.accuracy.ProxyAccuracy` noise model with its
    ``base_accuracy``/``noise_scale`` knobs.  ``kind='measured'`` wraps a
    factory registered via
    :func:`repro_torch.core.accuracy.register_accuracy_measure` — called as
    ``factory(graph=..., schedule=..., system=..., device=..., **options)``,
    ``device`` being the search's own — in a caching :class:`~repro_torch.core.accuracy.MeasuredAccuracy`.  Measured
    oracles run on the NumPy strategies; ``torch_nsga2`` keeps its documented
    fallback (it needs a tensor ``proxy_arrays`` oracle and downgrades to
    ``nsga2`` with a warning when accuracy is searched without one).
    """

    kind: str = "proxy"
    base_accuracy: float = 1.0        # proxy knobs
    noise_scale: float = 4.0
    measure: Optional[str] = None     # registered factory name (measured)
    options: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in ("proxy", "measured"):
            raise ValueError(f"unknown accuracy kind {self.kind!r}; "
                             f"expected 'proxy' or 'measured'")
        if self.kind == "measured" and not self.measure:
            raise ValueError("accuracy kind 'measured' requires a 'measure' "
                             "name registered via "
                             "repro_torch.core.accuracy.register_accuracy_measure")
        if self.kind == "proxy" and (self.measure or self.options):
            raise ValueError(
                "accuracy kind 'proxy' takes no 'measure'/'options' — did "
                "you mean kind='measured'?")

    def build(self, graph, schedule, system, device="cuda"):
        """Resolve to a live ``accuracy_fn(cuts) -> float`` oracle; a
        measured oracle's factory works on ``device``, the device the
        search runs on."""
        from repro_torch.core.accuracy import (MeasuredAccuracy, ProxyAccuracy,
                                         get_accuracy_measure)
        if self.kind == "proxy":
            return ProxyAccuracy(schedule, system,
                                 base_accuracy=self.base_accuracy,
                                 noise_scale=self.noise_scale)
        factory = get_accuracy_measure(self.measure)
        return MeasuredAccuracy(factory(graph=graph, schedule=schedule,
                                        system=system, device=device,
                                        **self.options))


@dataclasses.dataclass(frozen=True)
class SearchSettings:
    """Which :class:`~repro_torch.explore.strategies.SearchStrategy` runs and how.

    ``auto`` reproduces the legacy ``Explorer.run`` policy: exhaustive
    single-cut scan when the system has one link, NSGA-II on top when
    ``n_cuts > 1`` or the candidate list is large (override via
    ``use_nsga``).  ``torch_nsga2`` runs the same genetic search as tensor
    code on the search device (see ``TorchNSGA2Search``) — pick it for
    multi-thousand populations.  ``pop_size``/``n_gen`` of ``None`` scale
    with the schedule depth and cut count (see ``scaled_nsga_defaults``) —
    sized for the batched evaluator, not the old scalar loop.

    The ``torch_nsga2`` scaling knobs (ignored by the other strategies):

    * ``rank_block`` — inert: any value, ``0`` included, gives the same
      ranks, because the port always ranks in fixed tiles.  It stays a
      field so that the reference's specs load and ``to_dict``, a spec's
      ``spec_hash`` and a fleet manifest keep their content.
    * ``rank_impl`` — ``'auto' | 'ref' | 'cuda'`` kernel dispatch for the
      ranking primitive (``'auto'``: the CUDA kernel for a search on a CUDA
      device, the plain PyTorch version on the CPU).
    * ``n_restarts`` — > 1 runs that many independently seeded searches
      (seeds ``seed .. seed+n-1``) and merges the final fronts.
    * ``rank_devices`` — the ranking runs on the one search device; a value
      > 1 is clamped to 1 with a warning.
    * ``warm_start`` — allow the NSGA strategies to seed the initial
      population from a previous Pareto front when the caller provides one
      (``run_search(..., warm_cuts=...)``, as the online re-partitioner
      does).  ``False`` forces a cold uniform init even when warm cuts are
      available — the A/B switch behind the warm-vs-cold quality tests.

    The JAX package's names load as aliases (``REFERENCE_NAMES``):
    ``strategy="jit_nsga2"`` becomes ``"torch_nsga2"`` and
    ``rank_impl="pallas"`` becomes ``"cuda"``, so a spec written by the
    reference runs here.  The settings keep only the port's names, so
    ``to_dict``/``to_json`` and a sweep's ``spec_hash`` carry them: a spec
    loaded from the reference hashes like the same spec written with the
    port's names, and differs from the reference's own hash — a fleet
    manifest built by the reference is refused on resume, which is right,
    since the strategy that runs differs.
    """

    strategy: str = "auto"
    seed: int = 0
    pop_size: Optional[int] = None
    n_gen: Optional[int] = None
    use_nsga: Optional[bool] = None
    max_scan: int = 1_000_000     # MultiCutScan enumeration cap
    scan_chunk: int = 4096        # rows per evaluate_batch call in scans
    allow_multi_tensor_cuts: bool = False
    rank_block: Optional[int] = None
    rank_impl: str = "auto"
    n_restarts: int = 1
    rank_devices: Optional[int] = None
    warm_start: bool = True

    def __post_init__(self):
        for field, names in REFERENCE_NAMES.items():
            value = getattr(self, field)
            object.__setattr__(self, field, names.get(value, value))
        if self.rank_impl not in ("auto", "ref", "cuda"):
            raise ValueError(f"unknown rank_impl {self.rank_impl!r}; "
                             f"expected 'auto', 'ref' or 'cuda'")
        if self.n_restarts < 1:
            raise ValueError(f"n_restarts must be >= 1, got {self.n_restarts}")
        if self.strategy in VALID_STRATEGIES:
            return
        # names added at runtime via register_strategy are valid too
        # (lazy import: strategies.py imports this module)
        from repro_torch.explore.strategies import STRATEGIES
        if self.strategy not in STRATEGIES:
            raise ValueError(
                f"unknown strategy {self.strategy!r}; expected one of "
                f"{tuple(dict.fromkeys(VALID_STRATEGIES + tuple(STRATEGIES)))}")


@dataclasses.dataclass(frozen=True)
class ExplorationSpec:
    """One declarative exploration campaign unit: model × system × search.

    JSON-round-trippable (``to_json`` / ``from_json``); resolve and run with
    :func:`repro_torch.explore.runner.run_spec`.
    """

    model: ModelRef
    system: SystemSpec
    objectives: Tuple[str, ...] = ("latency", "energy")
    weights: Optional[Tuple[float, ...]] = None
    constraints: Constraints = dataclasses.field(default_factory=Constraints)
    search: SearchSettings = dataclasses.field(default_factory=SearchSettings)
    schedule_policy: str = "min_memory"
    batch: int = 1
    accuracy: Optional[AccuracySpec] = None   # None -> default proxy oracle

    def __post_init__(self):
        object.__setattr__(self, "objectives", tuple(self.objectives))
        if self.weights is not None:
            object.__setattr__(self, "weights", tuple(self.weights))
        for o in self.objectives:
            if o not in VALID_OBJECTIVES:
                raise ValueError(f"unknown objective {o!r}; "
                                 f"expected one of {VALID_OBJECTIVES}")
        if self.weights is not None and len(self.weights) != len(self.objectives):
            raise ValueError("weights must match objectives")

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        """Plain-dict form; round-trips through :meth:`from_dict`."""
        return dataclasses.asdict(self)

    def to_json(self, indent: Optional[int] = None) -> str:
        """JSON form of :meth:`to_dict` (the on-disk spec format)."""
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExplorationSpec":
        """Inverse of :meth:`to_dict`."""
        system = SystemSpec.from_dict(d["system"])
        weights = d.get("weights")
        acc = d.get("accuracy")
        return cls(
            model=ModelRef(**d["model"]),
            system=system,
            objectives=tuple(d.get("objectives", ("latency", "energy"))),
            weights=tuple(weights) if weights is not None else None,
            constraints=Constraints(**d.get("constraints", {})),
            search=SearchSettings(**d.get("search", {})),
            schedule_policy=d.get("schedule_policy", "min_memory"),
            batch=d.get("batch", 1),
            accuracy=AccuracySpec(**acc) if acc is not None else None)

    @classmethod
    def from_json(cls, s: str) -> "ExplorationSpec":
        """Inverse of :meth:`to_json`."""
        return cls.from_dict(json.loads(s))


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """A whole campaign as data: one spec template fanned across
    ``models`` × ``systems`` (defaulting to the template's own).

    This is the durable form a fleet manifest is built from
    (:meth:`repro_torch.explore.campaign.Campaign.to_manifest`): cell order is
    model-major / system-minor — exactly the serial
    :meth:`~repro_torch.explore.campaign.Campaign.run` iteration order — and
    :meth:`spec_hash` fingerprints the canonical JSON so workers refuse to
    execute against a manifest built from a different sweep.
    """

    template: ExplorationSpec
    models: Tuple[ModelRef, ...] = ()
    systems: Tuple[SystemSpec, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "models",
                           tuple(self.models) or (self.template.model,))
        object.__setattr__(self, "systems",
                           tuple(self.systems) or (self.template.system,))

    def cells(self) -> Tuple[Tuple[str, str], ...]:
        """(model label, system label) pairs in serial-run order."""
        return tuple((m.label, s.label)
                     for m in self.models for s in self.systems)

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        """JSON-clean plain-dict form; round-trips via :meth:`from_dict`."""
        return json.loads(json.dumps(dataclasses.asdict(self)))

    def to_json(self, indent: Optional[int] = None) -> str:
        """JSON form of :meth:`to_dict` (what the fleet manifest stores)."""
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SweepSpec":
        """Inverse of :meth:`to_dict`."""
        return cls(
            template=ExplorationSpec.from_dict(d["template"]),
            models=tuple(ModelRef(**m) for m in d.get("models", [])),
            systems=tuple(SystemSpec.from_dict(s)
                          for s in d.get("systems", [])))

    @classmethod
    def from_json(cls, s: str) -> "SweepSpec":
        """Inverse of :meth:`to_json`."""
        return cls.from_dict(json.loads(s))

    def spec_hash(self) -> str:
        """SHA-256 over the canonical JSON form — the fleet manifest's
        sweep identity (resume refuses a mismatching manifest)."""
        import hashlib
        canon = json.dumps(self.to_dict(), sort_keys=True,
                           separators=(",", ":"))
        return hashlib.sha256(canon.encode()).hexdigest()
