"""Zamba2-7B — hybrid Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

81 Mamba2 layers; a *shared* (parameter-tied) attention+MLP block is applied
after every ``shared_attn_every``-th Mamba layer.  Its attention is full
causal (window 0); the sliding window serves only the long-context variant
(``force_window``).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    arch_type="hybrid",
    source="arXiv:2411.15242",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    block_pattern=("mamba",),      # shared attn handled via shared_attn_every
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    shared_attn_every=6,
    sliding_window=4096,
    supports_long_context=True,
    long_context_window=4096,
)
