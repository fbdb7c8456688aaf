"""Hot-path manifest and device-body index roots.

The port of ``repro/analysis/manifest.py``.  The serve hot path is
everything a request touches between admission and its routing decision:
the serving package (scheduler, runtime, sampler, KV pool, faults), the
CUDA kernels' wrappers, and the engine facade that dispatches them.  Rules
marked ``hot_path_only`` fire only in these modules — a wall-clock read in
``training/`` is fine, in ``serving/`` it is a determinism bug.

``DEVICE_BODIES`` names the functions that run once per decode step on the
card: what a CUDA graph of the step would capture.  They stand where the
reference has its jit roots and scan bodies: ``models/model.decode_step``,
the functions of the stack it reaches (attention, SSM, MLP, MoE, RoPE,
norms), ``models/tier0``'s forward, and every ``*_cuda`` wrapper in
``kernels/`` (``KERNEL_WRAPPER_SUFFIX``).
Same-module callees of a device body are device bodies too
(``astpass.ModuleContext``).

Paths are matched structurally (posix suffix under ``repro_torch/``) so the
manifest works for both ``src/repro_torch/...`` checkouts and installed
trees.
"""
from __future__ import annotations

import pathlib
from typing import FrozenSet, Optional

HOT_PATH_PREFIXES = (
    "repro_torch/serving/",
    "repro_torch/kernels/",
)
HOT_PATH_FILES = (
    "repro_torch/api/engine.py",
    "repro_torch/models/tier0.py",    # tier-0 pre-router: gates every request
)

# module -> qualified names of the device bodies defined in it (the index
# follows calls within a module, not across modules, so each module a
# decode step reaches names its own)
DEVICE_BODIES = {
    "repro_torch/models/model.py": ("decode_step",),
    "repro_torch/models/transformer.py": ("segment_decode", "block_decode"),
    "repro_torch/models/attention.py": ("gqa_decode", "gqa_decode_paged",
                                        "mla_decode", "cross_attend"),
    "repro_torch/models/ssm.py": ("mamba_decode",),
    "repro_torch/models/mlp.py": ("mlp_forward",),
    "repro_torch/models/moe.py": ("moe_forward",),
    "repro_torch/models/rope.py": ("rope_cos_sin", "mrope_cos_sin",
                                   "text_positions_3d", "apply_rope"),
    "repro_torch/models/common.py": ("rmsnorm", "softcap", "sinusoid_at",
                                     "promoted_matmul"),
    "repro_torch/models/tier0.py": ("tier0_forward",),
}
KERNEL_WRAPPER_DIR = "repro_torch/kernels/"
KERNEL_WRAPPER_SUFFIX = "_cuda"


def package_path(path: str) -> Optional[str]:
    """``path`` from ``repro_torch/`` on, or None outside the package."""
    p = pathlib.PurePath(path).as_posix()
    idx = p.rfind("repro_torch/")
    return None if idx < 0 else p[idx:]


def is_hot_path(path: str) -> bool:
    rel = package_path(path)
    if rel is None:
        return False
    if rel in HOT_PATH_FILES:
        return True
    return any(rel.startswith(pfx) for pfx in HOT_PATH_PREFIXES)


def device_body_names(path: str) -> FrozenSet[str]:
    """The manifest's device bodies of the module at ``path``."""
    rel = package_path(path)
    return frozenset(DEVICE_BODIES.get(rel, ())) if rel else frozenset()


def wraps_kernels(path: str) -> bool:
    """Whether ``path``'s ``*_cuda`` functions are kernel wrappers."""
    rel = package_path(path)
    return rel is not None and rel.startswith(KERNEL_WRAPPER_DIR)
