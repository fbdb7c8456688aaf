"""Qwen3-MoE-235B-A22B — 128 experts, top-8 [hf:Qwen/Qwen3-30B-A3B family].

Copied field for field from the JAX package's config.  Its 235 B params
(~470 GB in bf16) do not fit one card: ``chip_smoke.py`` runs it at full
width and 8 of its 94 layers.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    arch_type="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,                    # per-expert hidden
    vocab_size=151936,
    block_pattern=("moe",),
    num_experts=128,
    num_experts_per_tok=8,
    moe_d_ff=1536,
    qk_norm=True,
    rope_theta=1000000.0,
    supports_long_context=False,
)
