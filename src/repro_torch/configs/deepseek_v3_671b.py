"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP
[arXiv:2412.19437]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, vocab=129_280,
    n_heads=128, n_kv=128, d_ff=18_432,      # dense layers FFN
    moe_d_ff=2048, n_experts=256, top_k=8, n_shared=1,
    first_dense=3, sigmoid_gate=True,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    mtp=1,
    optimizer="adafactor",        # 671B total params: factored optimizer
    source="arXiv:2412.19437 (DeepSeek-V3: 61L d7168, MLA, 256e top-8 + 1 shared, MTP)",
)
