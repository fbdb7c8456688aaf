"""Qwen2-VL-7B language backbone — M-RoPE, dynamic resolution
[arXiv:2409.12191].

Copied field for field from the JAX package's config.  The ViT vision
encoder and projector are a STUB: callers pass precomputed patch embeddings
``image_embeds`` (batch, num_stub_patches, d_model) in the model dtype,
which the model projects (``vision_proj``) into the first positions of the
token stream; ``positions_3d`` (3, batch, seq) carries the (t, h, w) M-RoPE
ids.  As in the JAX package the LM head is tied to the embedding, where the
published model's is not.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    arch_type="vlm",
    source="arXiv:2409.12191",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    block_pattern=("attn",),
    rope_kind="mrope",
    mrope_sections=(16, 56, 56),   # sums to head_dim 128
    rope_theta=1000000.0,
    num_stub_patches=256,
    supports_long_context=False,
)
