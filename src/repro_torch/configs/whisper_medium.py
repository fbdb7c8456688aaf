"""Whisper-medium transformer backbone — encoder-decoder [arXiv:2212.04356].

Copied field for field from the JAX package's config.  The mel-spectrogram
and conv frontend are a STUB: callers pass precomputed frame embeddings
``enc_features`` (batch, encoder_seq_len, d_model) in the model dtype.  No
RoPE: sinusoid positions are added to the embeddings of both stacks.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    arch_type="audio",
    source="arXiv:2212.04356",
    num_layers=24,                 # decoder layers
    num_encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51872,               # 51865 padded to a multiple of 16
    block_pattern=("attn",),
    is_encoder_decoder=True,
    encoder_seq_len=1500,
    rope_kind="none",              # whisper uses learned/sinusoidal positions
    tie_embeddings=True,
    mlp_kind="gelu",
    supports_long_context=False,
)
