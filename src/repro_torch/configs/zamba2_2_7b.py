"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, vocab=32_000,
    n_heads=32, n_kv=32, d_ff=10_240,
    ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_chunk=128,
    attn_every=6,                  # shared attn+MLP block applied every 6
    optimizer="adamw",
    source="arXiv:2411.15242 (Zamba2-2.7B: 54 Mamba2 blocks d2560, shared attn d_ff 10240)",
)
