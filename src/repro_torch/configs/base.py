"""Model configuration: ``repro.configs.base.ModelConfig`` for the ported
families.

Only the fields the ported configs set or rely on are kept — the SCOPE
estimator configs (``configs/scope_estimator``), the dense GQA stacks
(``configs/starcoder2_3b``, ``configs/internlm2_1_8b``), gemma2's
alternating local / global stacks with logit softcaps, sandwich norms and
scaled embeddings (``configs/gemma2_2b``, ``configs/gemma2_9b``), the
pure-SSM Mamba2 backbone (``configs/mamba2_1_3b``), the zamba2 hybrid
(``configs/zamba2_7b``: Mamba2 layers with a tied shared attention block),
the Qwen2-VL language backbone with M-RoPE and stub patch embeddings
(``configs/qwen2_vl_7b``) and the whisper encoder-decoder with stub frame
embeddings, sinusoid positions, cross-attention and a GELU MLP
(``configs/whisper_medium``), and the two mixture-of-experts backbones:
Qwen3-MoE's GQA + MoE stack (``configs/qwen3_moe_235b_a22b``) and
DeepSeek-V2's multi-head latent attention with shared and routed experts
and a dense first layer (``configs/deepseek_v2_lite_16b``) — with the JAX
package's defaults, so a config built here describes the same network as
its JAX twin.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

# "attn"      : global self-attention + MLP (the SCOPE estimator family)
# "attn_local": sliding-window self-attention + MLP (gemma2's local layers)
# "mla"       : multi-head latent attention (DeepSeek-V2) + MLP
# "moe"       : global self-attention + MoE FFN (Qwen3-MoE)
# "mla_moe"   : MLA attention + MoE FFN (DeepSeek-V2)
# "mamba"     : Mamba2 SSD block (attention-free)
VALID_BLOCK_KINDS = ("attn", "attn_local", "mla", "moe", "mla_moe", "mamba")
# the kinds with a GQA attention layer (and K/V caches): the reference's
# ``_is_attn``; MLA layers cache a latent instead
ATTN_KINDS = ("attn", "attn_local", "moe")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                  # dense | moe | ssm | hybrid | audio | vlm
    source: str = ""                    # paper / model card citation

    # Core transformer dims
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0                   # 0 -> d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1024

    # Layer stacking: the pattern repeats until num_layers blocks are placed.
    block_pattern: Tuple[str, ...] = ("attn",)

    # Attention options
    rope_theta: float = 10000.0
    rope_kind: str = "standard"         # standard | mrope | none
    mrope_sections: Tuple[int, ...] = (16, 24, 24)   # t/h/w head-dim split
    sliding_window: int = 4096          # used by attn_local blocks
    logit_softcap: float = 0.0          # gemma2: 50.0 on attention logits
    final_logit_softcap: float = 0.0    # gemma2: 30.0 on lm head
    attn_scale: float = 0.0             # 0 -> 1/sqrt(head_dim)
    qk_norm: bool = False

    # MLA (DeepSeek-V2)
    kv_lora_rank: int = 512
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0                   # per-expert hidden (0 -> d_ff)
    first_dense_layers: int = 0         # DeepSeek-V2: layer 0 dense
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_heads: int = 0                  # 0 -> d_inner // ssm_head_dim
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_conv_width: int = 4
    shared_attn_every: int = 6          # zamba2: shared attn after every k-th mamba

    # Encoder-decoder (whisper-style)
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq_len: int = 1500         # stub audio frame count

    # Multimodal stub frontend (vlm / audio)
    num_stub_patches: int = 0           # vlm: patch embeddings prepended

    # Norm / misc
    rmsnorm_eps: float = 1e-6
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    mlp_kind: str = "swiglu"            # swiglu | gelu
    sandwich_norm: bool = False         # gemma2 post-norms
    scale_embeddings: bool = False      # gemma2: embed * sqrt(d_model)
    force_window: int = 0               # >0: every attn layer windowed
                                        # (the long-context variant)

    # Long-context policy
    supports_long_context: bool = False     # may lower long_500k
    long_context_window: int = 4096         # window used by the long variant

    def __post_init__(self):
        for k in self.block_pattern:
            if k not in VALID_BLOCK_KINDS:
                raise ValueError(f"unknown block kind {k!r}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def resolved_moe_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def resolved_ssm_heads(self) -> int:
        return self.ssm_heads or self.d_inner // self.ssm_head_dim

    def layer_kinds(self) -> Tuple[str, ...]:
        """Expand block_pattern to exactly num_layers entries."""
        reps = math.ceil(self.num_layers / len(self.block_pattern))
        return tuple((self.block_pattern * reps)[: self.num_layers])

    def is_attention_free(self) -> bool:
        return all(k == "mamba" for k in self.layer_kinds())

    def has_moe(self) -> bool:
        return any(k in ("moe", "mla_moe") for k in self.layer_kinds())

    def has_mla(self) -> bool:
        return any(k.startswith("mla") for k in self.layer_kinds())

    def has_ssm(self) -> bool:
        return any(k.startswith("mamba") for k in self.layer_kinds())

    def reduced(self, *, num_layers: int = 2, d_model: int = 256,
                num_heads: int = 4, vocab_size: int = 512,
                max_experts: int = 4) -> "ModelConfig":
        """A smoke-test variant of the same family (CPU-runnable): the JAX
        ``reduced()`` on the fields the port has.  As there, the softcaps,
        ``attn_scale``, ``sandwich_norm`` and ``scale_embeddings`` stay as
        they are and the window shrinks to 64, an SSM config comes back
        with ``shared_attn_every=2`` (zamba2's hybrid layout): replace it
        with 0 for a pure-SSM variant; an encoder-decoder keeps 2 encoder
        layers over 32 frames, a VLM 8 stub patches, and M-RoPE's sections
        are re-split to the reduced head dim.  A MoE config keeps at most
        ``max_experts`` experts, top-2, at most one shared expert and one
        dense first layer, experts of width 2 d_model; MLA shrinks to a
        latent of 64, rope 16, nope 32 and v 32."""
        head_dim = max(32, d_model // num_heads)
        changes = {
            "num_layers": num_layers,
            "d_model": d_model,
            "num_heads": num_heads,
            "num_kv_heads": max(1, min(self.num_kv_heads, num_heads)),
            "head_dim": head_dim,
            "d_ff": d_model * 4,
            "vocab_size": vocab_size,
            "sliding_window": 64,
            "long_context_window": 64,
            "encoder_seq_len":
                32 if self.is_encoder_decoder else self.encoder_seq_len,
            "num_encoder_layers": 2 if self.is_encoder_decoder else 0,
            "num_stub_patches": 8 if self.num_stub_patches else 0,
            "dtype": "float32",
        }
        if self.has_moe():
            changes.update(
                num_experts=min(self.num_experts, max_experts),
                num_experts_per_tok=min(self.num_experts_per_tok, 2),
                num_shared_experts=min(self.num_shared_experts, 1),
                moe_d_ff=d_model * 2,
                first_dense_layers=min(self.first_dense_layers, 1))
        if self.has_ssm():
            changes.update(ssm_state=min(self.ssm_state or 16, 16),
                           ssm_head_dim=32, ssm_heads=0, ssm_chunk=16,
                           shared_attn_every=2)
        if self.rope_kind == "mrope":
            t = max(4, (head_dim // 4) // 2 * 2)
            hw = (head_dim - t) // 2
            changes.update(mrope_sections=(t, hw, head_dim - t - hw))
        if self.kv_lora_rank and self.has_mla():
            changes.update(kv_lora_rank=64, qk_rope_head_dim=16,
                           qk_nope_head_dim=32, v_head_dim=32)
        return dataclasses.replace(self, **changes)


# ---------------------------------------------------------------------------
# Input shapes (assigned): ``repro.configs.base``'s four planning shapes
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                           # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """Whether (arch, shape) should run; returns (ok, reason-if-skip)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("full-attention arch: long_500k requires "
                       "sub-quadratic attention")
    return True, ""


def long_context_variant(cfg: ModelConfig) -> ModelConfig:
    """Sub-quadratic variant for long_500k: every attention layer becomes
    sliding-window at ``long_context_window`` (SSM layers untouched)."""
    return dataclasses.replace(cfg, force_window=cfg.long_context_window)
