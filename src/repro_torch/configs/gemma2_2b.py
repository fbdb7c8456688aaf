"""Gemma2-2B — dense, alternating local/global attention, logit softcaps
[arXiv:2408.00118].

Copied field for field from the JAX package's config, whose MLP is SwiGLU
where the published model's is GeGLU.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    arch_type="dense",
    source="arXiv:2408.00118",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    block_pattern=("attn_local", "attn"),
    sliding_window=4096,
    logit_softcap=50.0,
    final_logit_softcap=30.0,
    sandwich_norm=True,
    scale_embeddings=True,
    supports_long_context=True,
    long_context_window=4096,
)
