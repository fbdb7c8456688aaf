"""StarCoder2-3B — dense GQA decoder [arXiv:2402.19173].

Copied field for field from the JAX package's config, with its departures
from the published model: RMSNorm and a SwiGLU MLP (the published model
has LayerNorm with biases and a GELU MLP), and no sliding window (the
published model windows every layer at 4096 tokens).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    arch_type="dense",
    source="arXiv:2402.19173",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    block_pattern=("attn",),
    rope_theta=999999.0,
    supports_long_context=False,
)
