"""smollm-360m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM-135M]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="smollm-360m", family="dense",
    n_layers=32, d_model=960, vocab=49_152,
    n_heads=15, n_kv=5, d_ff=2560,
    tied_embeddings=True,
    window=4096,
    optimizer="adamw",
    source="hf:HuggingFaceTB/SmolLM-360M (32L d960 15H kv5 ffn2560)",
)
