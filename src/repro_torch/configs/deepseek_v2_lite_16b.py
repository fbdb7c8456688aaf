"""DeepSeek-V2-Lite-16B — MLA (kv_lora=512) + MoE (2 shared + 64 routed,
top-6), first layer dense [arXiv:2405.04434].

Copied field for field from the JAX package's config.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    source="arXiv:2405.04434",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10944,                   # dense-layer FFN width
    vocab_size=102400,
    block_pattern=("mla_moe",),
    first_dense_layers=1,         # layer 0 is MLA + dense FFN
    num_experts=64,
    num_experts_per_tok=6,
    num_shared_experts=2,
    moe_d_ff=1408,
    kv_lora_rank=512,
    qk_rope_head_dim=64,
    qk_nope_head_dim=128,
    v_head_dim=128,
    supports_long_context=False,
)
