"""musicgen-large [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284].  The EnCodec frontend is a stub: ``input_specs``
provides precomputed codebook token streams (delay-pattern applied)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="musicgen-large", family="audio",
    n_layers=48, d_model=2048, vocab=2048,          # per-codebook cardinality
    n_heads=32, n_kv=32, d_ff=8192,
    n_codebooks=4,
    optimizer="adamw",
    source="arXiv:2306.05284 (MusicGen large: 48L d2048 32H ffn8192, 4 RVQ books)",
)
