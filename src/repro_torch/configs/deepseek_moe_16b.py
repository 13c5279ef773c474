"""deepseek-moe-16b [moe] — 2 shared + 64 routed top-6, fine-grained
[arXiv:2401.06066]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, vocab=102_400,
    n_heads=16, n_kv=16, d_ff=1408 * 8,     # dense first layer FFN (10944≈8x)
    moe_d_ff=1408, n_experts=64, top_k=6, n_shared=2,
    first_dense=1,
    optimizer="adamw",
    source="arXiv:2401.06066 (DeepSeekMoE-16B: 28L d2048, 64e top-6 + 2 shared, expert ffn 1408)",
)
