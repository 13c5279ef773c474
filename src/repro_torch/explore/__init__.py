"""Declarative exploration API for automated DNN partitioning, on PyTorch.

The paper's Fig.-1 framework as composable, declarative pieces — the
counterpart of the JAX package's ``repro.explore``:

========================================  ====================================
Paper stage (Fig. 1)                      API piece
========================================  ====================================
DNN model → layer graph                   :class:`ModelRef` (``spec.py``)
System description                        :class:`SystemSpec` /
                                          :class:`PlatformSpec` /
                                          :class:`LinkSpec`
Linear schedule (§IV-A)                   ``schedule_policy`` on
                                          :class:`ExplorationSpec`
Candidate cuts + memory/link filtering    ``filters.candidate_positions``
(§IV-B, Def. 1/3)                         + per-(link, position)
                                          ``filters.link_feasibility``
Metric evaluation (Table I)               ``repro_torch.core.partition``
                                          ``PartitionEvaluator`` (shared by
                                          all strategies)
Search / NSGA-II (§IV)                    :class:`SearchStrategy` protocol —
                                          :class:`ExhaustiveSearch`,
                                          :class:`MultiCutScan`,
                                          :class:`NSGA2Search`,
                                          :class:`TorchNSGA2Search` (the same
                                          search as tensor code on a device)
Pareto front + Def.-2 selection           ``runner.run_search`` →
                                          :class:`ExplorationResult`
Selected cuts → LM block cuts             ``deploy.lm_block_cuts``
Fleet-level studies (many models/         :class:`Campaign` →
systems, shared cost tables)              :class:`CampaignReport`
Re-partitioning under drift               :class:`OnlineRepartitioner`
========================================  ====================================

Specs are JSON-round-trippable (``ExplorationSpec.to_json``/``from_json``),
and strategies are drop-in interchangeable through
``SearchSettings.strategy``.  ``run_spec(spec, device=...)`` runs the tensor
strategy on ``device`` (default ``"cuda"``).
"""

from repro_torch.explore.deploy import lm_block_cuts
from repro_torch.explore.campaign import (Campaign, CampaignEntry,
                                          CampaignReport, CampaignResult,
                                          campaign_entry_dict)
from repro_torch.explore.online import (OnlineRepartitioner,
                                        RepartitionDecision, degrade_link,
                                        drop_node)
from repro_torch.explore.filters import (candidate_positions, feasible_cut_rows,
                                         link_feasibility, link_filter,
                                         memory_filter)
from repro_torch.explore.result import (ExplorationResult, eval_from_dict,
                                        eval_to_dict)
from repro_torch.explore.runner import (DEFAULT_OBJECTIVES, explore_graph,
                                        run_search, run_spec, select_weighted)
from repro_torch.explore.spec import (AccuracySpec, ExplorationSpec, LinkSpec,
                                      ModelRef, PlatformSpec, SearchSettings,
                                      SweepSpec, SystemSpec)
from repro_torch.explore.strategies import (ExhaustiveSearch, MultiCutScan,
                                            NSGA2Search, SearchContext,
                                            SearchStrategy, StrategyOutput,
                                            TorchNSGA2Search,
                                            register_strategy,
                                            scaled_nsga_defaults)

__all__ = [
    "AccuracySpec", "Campaign", "CampaignEntry", "CampaignReport",
    "CampaignResult", "DEFAULT_OBJECTIVES", "ExhaustiveSearch",
    "ExplorationResult", "ExplorationSpec", "LinkSpec", "ModelRef",
    "MultiCutScan", "NSGA2Search", "OnlineRepartitioner", "PlatformSpec",
    "RepartitionDecision", "SearchContext", "SearchSettings",
    "SearchStrategy", "StrategyOutput", "SweepSpec", "SystemSpec",
    "TorchNSGA2Search", "campaign_entry_dict", "candidate_positions",
    "degrade_link", "drop_node", "eval_from_dict", "eval_to_dict",
    "explore_graph", "feasible_cut_rows",
    "link_feasibility", "link_filter", "lm_block_cuts", "memory_filter",
    "register_strategy",
    "run_search", "run_spec", "scaled_nsga_defaults", "select_weighted",
]
