"""qwen2-72b [dense] — GQA with QKV bias [arXiv:2407.10671]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-72b", family="dense",
    n_layers=80, d_model=8192, vocab=152_064,
    n_heads=64, n_kv=8, d_ff=29_568,
    qkv_bias=True, rope_theta=1e6,
    window=4096,                 # sliding-window variant enables long_500k
    optimizer="adafactor",       # 72B params: factored states to fit HBM
    source="arXiv:2407.10671 (Qwen2-72B: 80L d8192 64H kv8 ffn29568)",
)
