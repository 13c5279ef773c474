"""Roofline terms of a step (the JAX package's ``repro.launch.roofline``),
against the peaks of one NVIDIA H100 SXM5.

Three terms per (arch x shape x mesh), all in seconds (per step):

  compute    = FLOPs_per_device / PEAK_FLOPS
  memory     = HBM_bytes_per_device / HBM_BW
  collective = collective_bytes_per_device / LINK_BW

The FLOPs and bytes come from ``launch/hlo_analysis.py``'s dispatch
counter of the port's eager step, divided evenly over the mesh.  A term
that only an SPMD partitioner could give (the collectives of a step split
over a logical pod mesh) is None, and ``bound_s`` is then the larger of
the other two; so a rule that only reshards (``fsdp``, ``expert_ep``,
``attn_heads``) leaves ``bound_s`` as it was.

Hardware constants: NVIDIA's H100 SXM5 data sheet — 989 TFLOP/s dense
bf16 on the tensor cores, 3.35 TB/s HBM3, 450 GB/s NVLink in each
direction (900 GB/s both ways).  They assume the full 700 W power limit.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

PEAK_FLOPS = 989e12          # bf16 dense, tensor cores / card
HBM_BW = 3.35e12             # B/s / card, HBM3
LINK_BW = 450e9              # B/s / card, NVLink, one direction


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    hbm_bytes_per_device: float
    coll_bytes_per_device: Optional[float]
    coll_breakdown: Optional[Dict[str, int]]
    n_devices: int
    model_flops: float = 0.0           # 6·N·D (train) / 2·N·D (inference)
    peak_memory_bytes: Optional[float] = 0.0

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> Optional[float]:
        if self.coll_bytes_per_device is None:
            return None
        return self.coll_bytes_per_device / LINK_BW

    def _terms(self) -> Dict[str, float]:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return {k: v for k, v in terms.items() if v is not None}

    @property
    def dominant(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self._terms().values())

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_device * self.n_devices
        return self.model_flops / total if total else 0.0

    def row(self) -> Dict[str, object]:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "bound_s": self.bound_s,
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "coll_breakdown": self.coll_breakdown,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "peak_memory_bytes": self.peak_memory_bytes,
            "n_devices": self.n_devices,
        }


def model_flops(cfg, shape, n_layers_equiv_params: int) -> float:
    """6·N·D for training, 2·N·D for inference (N = active params)."""
    d_tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                     else 1)
    mult = 6 if shape.kind == "train" else 2
    return mult * n_layers_equiv_params * d_tokens


def active_params(cfg) -> int:
    """Active (per-token) parameter count — MoE counts top-k+shared only.
    From the configuration's layer graph alone: no weights are built."""
    from repro_torch.models.registry import model_graph
    import dataclasses as dc
    if cfg.n_experts:
        # keep first_dense layers' real d_ff: approximate by weighting
        n_moe = cfg.n_layers - cfg.first_dense
        moe_ffn_params = 3 * cfg.d_model * (cfg.top_k + cfg.n_shared) * cfg.moe_d_ff
        dense_ffn_params = 3 * cfg.d_model * cfg.d_ff
        base = model_graph(dc.replace(cfg, n_experts=0, top_k=0,
                                      family="dense"), 8).total_params
        # base counted dense ffn everywhere; swap in moe active ffn
        return base - n_moe * dense_ffn_params + n_moe * moe_ffn_params
    return model_graph(cfg, 8).total_params


def analyze(costs, cfg, shape, n_devices: int,
            peak_memory_bytes: Optional[float] = None) -> Roofline:
    """The roofline of a step whose whole-step costs are ``costs``
    (``hlo_analysis.HloCosts``), split over ``n_devices``.

    The port runs a step on one device; on a mesh of more, its FLOPs and
    bytes are charged to each device evenly (the bound a perfect split
    reaches), and the collectives, which only an SPMD partitioner would
    insert, are None.  On one device every term is the step's own."""
    coll = ({k: int(v) for k, v in costs.coll_by_kind.items()}
            if n_devices == 1 else None)
    return Roofline(
        flops_per_device=costs.flops / n_devices,
        hbm_bytes_per_device=costs.write_bytes / n_devices,
        coll_bytes_per_device=(float(costs.coll_bytes) if n_devices == 1
                               else None),
        coll_breakdown=coll,
        n_devices=n_devices,
        model_flops=model_flops(cfg, shape, active_params(cfg)),
        peak_memory_bytes=peak_memory_bytes,
    )
