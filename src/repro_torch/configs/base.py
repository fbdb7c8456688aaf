"""Model configuration: the dense-family subset of ``repro.configs.base``.

Only the fields the SCOPE estimator configs (``configs/scope_estimator``)
set or rely on are kept, with the JAX package's defaults, so a config built
here describes the same network as its JAX twin.  Other families (sliding
windows, softcaps, MoE, MLA, SSM, encoder-decoder, multimodal) arrive with
their own port slices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

# "attn": global self-attention + MLP (the SCOPE estimator family)
VALID_BLOCK_KINDS = ("attn",)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                      # dense
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
    qk_norm: bool = False

    # Norm / misc
    rmsnorm_eps: float = 1e-6
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    supports_long_context: bool = False

    def __post_init__(self):
        for k in self.block_pattern:
            if k not in VALID_BLOCK_KINDS:
                raise ValueError(f"unknown block kind {k!r}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def layer_kinds(self) -> Tuple[str, ...]:
        """Expand block_pattern to exactly num_layers entries."""
        reps = math.ceil(self.num_layers / len(self.block_pattern))
        return tuple((self.block_pattern * reps)[: self.num_layers])
