"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191].
ViT/SigLIP frontend is a stub: ``input_specs`` provides precomputed patch
embeddings of shape (B, n_patches, d_model)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, vocab=152_064,
    n_heads=28, n_kv=4, d_ff=18_944,
    qkv_bias=True, rope_theta=1e6,
    mrope_sections=(16, 24, 24),    # t/h/w half-dim bands, sum = head_dim/2
    n_patches=256,
    window=4096,
    optimizer="adamw",
    source="arXiv:2409.12191 (Qwen2-VL-7B: 28L d3584 28H kv4 ffn18944, M-RoPE)",
)
