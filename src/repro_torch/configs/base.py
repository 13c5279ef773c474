"""Unified model/run configuration for the assigned architectures.

One :class:`ModelConfig` describes any of the 6 families (dense / moe / ssm /
hybrid / audio / vlm).  ``reduced()`` produces the CPU smoke-test variant
(≤2 layers, d_model ≤ 512, ≤4 experts) of the same family.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    vocab: int
    # attention
    n_heads: int = 0
    n_kv: int = 0
    head_dim: Optional[int] = None
    d_ff: int = 0
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    window: Optional[int] = None          # sliding-window attention
    tied_embeddings: bool = False
    # moe
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    moe_d_ff: int = 0                     # per-expert FFN width
    first_dense: int = 0                  # leading dense layers (DeepSeek)
    sigmoid_gate: bool = False
    use_mla: bool = False
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    mtp: int = 0                          # multi-token-prediction depth
    # ssm / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 128
    attn_every: int = 0                   # hybrid: shared attn block period
    # audio
    n_codebooks: int = 0
    # vlm
    mrope_sections: Optional[Tuple[int, int, int]] = None
    n_patches: int = 0                    # vision stub token count
    # numerics / training
    dtype: str = "float32"
    remat: bool = True
    optimizer: str = "adamw"              # adafactor for the 70B+ configs
    # citation for the config source
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks + head)."""
        from repro_torch.models.registry import count_params_from_config
        return count_params_from_config(self)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family/features, tiny dims."""
        d = 256 if self.d_model >= 256 else self.d_model
        heads = min(self.n_heads, 4) or 0
        kv = min(self.n_kv, heads) or 0
        if self.n_kv and self.n_heads and self.n_heads != self.n_kv:
            kv = max(1, heads // 2)       # keep GQA grouping
        layers = min(self.n_layers, 2)
        if self.family == "hybrid":
            layers = min(self.attn_every, 6)  # one full shared-attn group
        return dataclasses.replace(
            self,
            n_layers=layers,
            d_model=d,
            n_heads=heads, n_kv=kv,
            head_dim=64 if self.head_dim else None,
            d_ff=min(self.d_ff, 4 * d) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            n_shared=min(self.n_shared, 1),
            moe_d_ff=min(self.moe_d_ff, d) if self.moe_d_ff else 0,
            first_dense=min(self.first_dense, 1),
            q_lora_rank=min(self.q_lora_rank, 64),
            kv_lora_rank=min(self.kv_lora_rank, 32),
            qk_nope_dim=32 if self.use_mla else self.qk_nope_dim,
            qk_rope_dim=16 if self.use_mla else self.qk_rope_dim,
            v_head_dim=32 if self.use_mla else self.v_head_dim,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=min(self.ssm_headdim, 32) if self.ssm_state else 64,
            ssm_chunk=32,
            window=min(self.window, 64) if self.window else None,
            mrope_sections=(8, 12, 12) if self.mrope_sections else None,
            n_patches=min(self.n_patches, 16) if self.n_patches else 0,
            mtp=min(self.mtp, 1),
            remat=False,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
