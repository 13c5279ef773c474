"""qwen3-14b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, vocab=151_936,
    n_heads=40, n_kv=8, head_dim=128, d_ff=17_408,
    qk_norm=True, rope_theta=1e6,
    window=4096,
    optimizer="adamw",
    source="hf:Qwen/Qwen3-14B (40L d5120 40H kv8 ffn17408, qk_norm)",
)
