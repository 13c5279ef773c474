"""granite-4.0-h-micro [mixed] — IBM Granite 4.0-H Micro (3B): 36 Mamba2
mixers and 4 GQA attention layers without positional encoding, each layer
with its own gated MLP, muP multipliers on the embedding, the residual
branches and the logits
[hf:ibm-granite/granite-4.0-h-micro, model type granitemoehybrid]."""

from repro_torch.configs.base import ModelConfig

ATTENTION_LAYERS = (5, 15, 25, 35)

CONFIG = ModelConfig(
    arch_id="granite-4.0-h-micro", family="mixed",
    n_layers=40, d_model=2048, vocab=100_352,
    n_heads=32, n_kv=8, d_ff=8192,
    tied_embeddings=True,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_chunk=256,
    optimizer="adamw",
    source="https://huggingface.co/ibm-granite/granite-4.0-h-micro/blob/main/"
           "config.json (40 layers d2048: Mamba2 64x64 heads, N128, conv 4; "
           "GQA 32/8 at layers 5, 15, 25, 35; MLP 8192; vocab 100352)",
    layer_types=tuple("attention" if i in ATTENTION_LAYERS else "mamba"
                      for i in range(40)),
    embedding_multiplier=12.0, residual_multiplier=0.22, logits_scaling=8.0,
    attention_scale=0.015625, rope=False, norm_eps=1e-5,
)
