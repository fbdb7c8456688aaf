"""Mamba2-1.3B — pure SSM, SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    arch_type="ssm",
    source="arXiv:2405.21060",
    num_layers=48,
    d_model=2048,
    num_heads=0,                  # attention-free
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50288,             # 50280 padded to /16 for TP (§Perf)
    block_pattern=("mamba",),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    shared_attn_every=0,          # no shared attention (pure SSM)
    supports_long_context=True,
)
