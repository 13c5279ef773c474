"""mamba2-370m [ssm] — SSD (state-space duality) [arXiv:2405.21060]."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, vocab=50_280,
    d_ff=0,                      # attention-free, no FFN (Mamba2 blocks only)
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_chunk=128,
    tied_embeddings=True,
    optimizer="adamw",
    source="arXiv:2405.21060 (Mamba2; 370m: 48L d1024 N128)",
)
