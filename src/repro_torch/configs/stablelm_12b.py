"""stablelm-12b [dense] — [hf:stabilityai/stablelm-2-1_6b scaled family]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, vocab=100_352,
    n_heads=32, n_kv=8, d_ff=13_824,
    window=4096,
    optimizer="adamw",
    source="hf:stabilityai/stablelm-2-12b (40L d5120 32H kv8 ffn13824)",
)
