"""Architecture registry: config lookup, model factory and graphs."""

from __future__ import annotations

import importlib
from typing import List, Optional

import torch

from repro_torch.configs.base import INPUT_SHAPES, ModelConfig, ShapeConfig
from repro_torch.core.graph import LayerGraph

_CONFIG_MODULES = {
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "qwen2-72b": "repro_torch.configs.qwen2_72b",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
    "stablelm-12b": "repro_torch.configs.stablelm_12b",
}

# configurations of the port alone, with no twin in the JAX package:
# ``get_config`` finds them; the reference's grid (``ARCH_IDS``: the dry-run
# pairs, the parity tests) leaves them out
_PORT_CONFIG_MODULES = {
    "granite-4.0-h-micro": "repro_torch.configs.granite_4_0_h_micro",
    "granite-4.0-h-small": "repro_torch.configs.granite_4_0_h_small",
    "deepseek-v3": "repro_torch.configs.deepseek_v3",
}

ARCH_IDS: List[str] = list(_CONFIG_MODULES)
PORT_ARCH_IDS: List[str] = list(_PORT_CONFIG_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    """The published configuration of ``arch_id`` (one of ``ARCH_IDS`` or
    ``PORT_ARCH_IDS``)."""
    module = _CONFIG_MODULES.get(arch_id, _PORT_CONFIG_MODULES.get(arch_id))
    if module is None:
        raise KeyError(f"unknown arch {arch_id!r}; have "
                       f"{ARCH_IDS + PORT_ARCH_IDS}")
    return importlib.import_module(module).CONFIG


def build_model(cfg: ModelConfig, *, device="cuda",
                generator: Optional[torch.Generator] = None):
    """The model of ``cfg`` with weights drawn from ``generator``: an
    ``SSMLM`` for the ssm and hybrid families, a ``MixedLM`` for the mixed
    family, else a ``DecoderLM`` (the dense, moe with MLA and MTP, audio
    and vlm families)."""
    if cfg.family == "mixed":
        from repro_torch.models.ssm_lm import MixedLM
        return MixedLM(cfg, device=device, generator=generator)
    if cfg.family in ("ssm", "hybrid"):
        from repro_torch.models.ssm_lm import SSMLM
        return SSMLM(cfg, device=device, generator=generator)
    from repro_torch.models.decoder import DecoderLM
    return DecoderLM(cfg, device=device, generator=generator)


def model_graph(cfg: ModelConfig, seq: int) -> LayerGraph:
    """The partitioner's layer graph of ``cfg`` at ``seq`` tokens, from the
    configuration alone: no weights are allocated."""
    if cfg.family in ("ssm", "hybrid", "mixed"):
        from repro_torch.models.ssm_lm import ssm_graph
        return ssm_graph(cfg, seq)
    from repro_torch.models.decoder import lm_graph
    return lm_graph(cfg, seq)


def count_params_from_config(cfg: ModelConfig) -> int:
    return model_graph(cfg, seq=8).total_params


def shape_config(name: str) -> ShapeConfig:
    return INPUT_SHAPES[name]


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k needs sub-quadratic decode: SSM/hybrid state or a sliding
    window."""
    if shape.name != "long_500k":
        return True
    return cfg.family in ("ssm", "hybrid") or cfg.window is not None
