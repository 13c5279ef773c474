"""granite-4.0-h-small [mixed] — IBM Granite 4.0-H Small (32B-A9B): 36
Mamba2 mixers and 4 GQA attention layers without positional encoding, each
layer followed by an expert layer (72 routed gated experts of width 768,
top 10 with the softmax over the ten chosen logits, dropless, beside one
shared gated MLP of width 1536), muP multipliers on the embedding, the
residual branches and the logits
[hf:ibm-granite/granite-4.0-h-small, model type granitemoehybrid]."""

from repro_torch.configs.base import ModelConfig

ATTENTION_LAYERS = (5, 15, 25, 35)

CONFIG = ModelConfig(
    arch_id="granite-4.0-h-small", family="mixed",
    n_layers=40, d_model=4096, vocab=100_352,
    n_heads=32, n_kv=8, d_ff=1536,
    tied_embeddings=True,
    n_experts=72, top_k=10, n_shared=1, moe_d_ff=768,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_chunk=256,
    optimizer="adamw",
    source="https://huggingface.co/ibm-granite/granite-4.0-h-small/blob/main/"
           "config.json (40 layers d4096: Mamba2 128x64 heads, N128, conv 4; "
           "GQA 32/8 at layers 5, 15, 25, 35; 72 experts of 768, top 10, a "
           "shared MLP of 1536; vocab 100352)",
    layer_types=tuple("attention" if i in ATTENTION_LAYERS else "mamba"
                      for i in range(40)),
    embedding_multiplier=12.0, residual_multiplier=0.22, logits_scaling=16.0,
    attention_scale=0.0078125, rope=False, norm_eps=1e-5,
)
