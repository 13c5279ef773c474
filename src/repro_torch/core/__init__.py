"""Core library: the paper's contribution — automated, hardware-aware DNN
inference partitioning for distributed systems."""

from repro_torch.core.accuracy import MeasuredAccuracy, ProxyAccuracy
from repro_torch.core.explorer import ExplorationResult, Explorer
from repro_torch.core.graph import LayerGraph, linearize
from repro_torch.core.layers import LayerInfo
from repro_torch.core.link import LinkModel, get_link
from repro_torch.core.memory import MemoryModel, segment_memory, split_memory
from repro_torch.core.partition import (Constraints, PartitionEval,
                                        PartitionEvaluator, Platform,
                                        SystemConfig, single_platform_eval)
from repro_torch.core.quant import QuantSpec
