"""SCOPE's own estimator backbones.

``scope-qwen3-4b``: the paper's Qwen3-4B-Instruct-2507-shaped backbone.
``scope-tiny``: the CPU-trainable variant used by the end-to-end examples,
tests, and benchmarks (same family: dense GQA + RoPE + qk-norm).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="scope-qwen3-4b",
    arch_type="dense",
    source="arXiv:2505.09388 (Qwen3 technical report)",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    block_pattern=("attn",),
    qk_norm=True,
    rope_theta=1000000.0,
    supports_long_context=False,
)

TINY = ModelConfig(
    name="scope-tiny",
    arch_type="dense",
    source="reduced scope-qwen3-4b for CPU training",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=384,
    vocab_size=512,               # matches repro_torch.data.tokenizer VOCAB_SIZE
    block_pattern=("attn",),
    qk_norm=True,
    rope_theta=10000.0,
    dtype="float32",
    supports_long_context=False,
)
