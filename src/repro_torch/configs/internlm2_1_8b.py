"""InternLM2-1.8B — dense GQA decoder [arXiv:2403.17297]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    arch_type="dense",
    source="arXiv:2403.17297",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92544,
    block_pattern=("attn",),
    rope_theta=1000000.0,
    supports_long_context=False,
)
