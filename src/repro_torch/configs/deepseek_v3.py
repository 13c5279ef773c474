"""deepseek-v3 [moe] — DeepSeek-V3 as its public ``config.json`` states
it: 61 layers at d 7168, the first 3 dense (MLP of 18432), every layer
multi-head latent attention (128 heads, q_lora 1536, kv_lora 512, qk 128 +
64 rope, v 128) with YaRN (factor 40 over 4096 positions, beta_fast 32,
beta_slow 1, mscale = mscale_all_dim = 1), 58 expert layers of 256 routed
experts of width 2048 and one shared, routed by ``noaux_tc`` (sigmoid
scores plus a correction bias, the best 4 of 8 groups, top 8, the chosen
scores renormalised x 2.5, dropless), vocabulary 129280 untied, RMSNorm
eps 1e-6 [hf:deepseek-ai/DeepSeek-V3, arXiv:2412.19437].

The port's own configuration, beside the JAX package's twin
``deepseek-v3-671b`` (plain RoPE, the capacity route, MTP): the scored
forward has no multi-token-prediction module (``mtp`` 0; it serves
training and self-drafting only).  Its layer graph counts MLA as MLA
(``graph_mla``), where the twin keeps the JAX package's GQA count.
"""

from repro_torch.configs.base import ModelConfig, RopeScaling

CONFIG = ModelConfig(
    arch_id="deepseek-v3", family="moe",
    n_layers=61, d_model=7168, vocab=129_280,
    n_heads=128, n_kv=128, d_ff=18_432,
    moe_d_ff=2048, n_experts=256, top_k=8, n_shared=1,
    first_dense=3, sigmoid_gate=True,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    rope_theta=10000.0,
    mtp=0,
    optimizer="adafactor",
    source="https://huggingface.co/deepseek-ai/DeepSeek-V3/blob/main/"
           "config.json (61L d7168, 3 dense of 18432, MLA 128 heads with "
           "YaRN x40, 256 experts of 2048 top-8 in 8 groups top-4 + 1 "
           "shared, noaux_tc x2.5, vocab 129280)",
    norm_eps=1e-6,
    rope_scaling=RopeScaling(factor=40.0,
                             original_max_position_embeddings=4096,
                             beta_fast=32.0, beta_slow=1.0, mscale=1.0,
                             mscale_all_dim=1.0),
    n_group=8, topk_group=4, routed_scaling_factor=2.5,
    graph_mla=True,
)
