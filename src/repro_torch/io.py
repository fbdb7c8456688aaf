"""Weight bridge: JAX parameter pytrees and checkpoints -> port params.

Three ways in, all numpy-only (no JAX import):

  params_from_numpy(tree, cfg, device) — the JAX param pytree as numpy
      arrays (``jax.tree.map(np.asarray, params)``: nested dicts, the
      ``segments`` tuple, per-segment layer stacks on axis 0);
  load_checkpoint(npz_path, cfg, device) — the flat ``k:<name>|i:<idx>``
      archive written by ``repro.training.checkpoint.save``;
  tier0_params_from_numpy(tree, device) — the tier-0 head's flat param dict
      (``repro.models.tier0.init_tier0`` or a trained head's ``params``).

``flatten`` / ``unflatten`` are the checkpoint's key-path flattening in
the reference's leaf order (dict keys sorted, tuples in order), shared
with ``training.checkpoint`` and the optimizer; ``tree_map`` maps the
leaves of such a tree.

The port keeps the JAX layout leaf for leaf (weights stored (in, out) and
applied as ``x @ W``), so the bridge is a copy with dtypes preserved.
bfloat16 leaves arrive as ml_dtypes arrays (or, from an ``.npz``, as raw
2-byte records) and are reinterpreted bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import tier0 as T0
from repro_torch.models import transformer as tf
from repro_torch.models.common import dtype_of

_SEP = "|"


def to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    """A numpy leaf as a tensor on ``device``, bfloat16 bit for bit."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V"
                                        and arr.dtype.itemsize == 2):
        bits = torch.tensor(np.ascontiguousarray(arr).view(np.uint16))
        return bits.view(torch.bfloat16).to(device)
    return torch.tensor(arr, device=device)


def _check(params: Dict, cfg: ModelConfig) -> None:
    """The bridged tree must describe ``cfg``'s tied network: a
    ``shared_attn`` block exactly where ``cfg``'s plan runs one, and a
    segment for each of its segments, holding a stack of ``count`` layers
    at each of its unit's positions (gemma2's unit has two); in each
    attention block, the post-norms exactly where ``cfg`` has
    ``sandwich_norm``, a cross-attention exactly where it is an
    encoder-decoder, its ``mlp_kind``'s MLP leaves (a MoE block: the
    router and the expert stacks of ``num_experts`` experts of width
    ``resolved_moe_d_ff``, and a shared MLP exactly where the config has
    shared experts) and its kind's attention leaves (an MLA block: ``wq``,
    ``w_dkv``, ``kv_norm``, ``w_uk``, ``w_uv``, ``wo`` at the config's MLA
    dims); an ``encoder`` of
    ``num_encoder_layers`` stacked layers exactly for an encoder-decoder and
    a ``vision_proj`` exactly for a VLM (a block would otherwise skip
    leaves it was given, or miss leaves it needs)."""
    if "lm_head" in params or not cfg.tie_embeddings:
        raise NotImplementedError("untied LM heads are not ported yet")
    plan = tf.build_plan(cfg)
    hybrid = any("shared_attn" in unit for unit, _ in plan)
    if ("shared_attn" in params) != hybrid:
        raise ValueError(f"{cfg.name!r}: shared_attn block in the tree "
                         f"{'shared_attn' in params}, in its plan {hybrid}")
    for key, want in (("encoder", cfg.is_encoder_decoder),
                      ("vision_proj", cfg.num_stub_patches > 0)):
        if (key in params) != want:
            raise ValueError(f"{cfg.name!r}: {key} in the tree "
                             f"{key in params}, in its config {want}")
    d = cfg.d_model
    blocks = [(params["shared_attn"], "attn", 0)] if hybrid else []
    stacks = [("segments", params["segments"], plan, cfg.is_encoder_decoder)]
    if cfg.is_encoder_decoder:
        enc = params["encoder"]
        if set(enc) != {"frontend_proj", "segments", "final_norm"}:
            raise ValueError(f"encoder holds {sorted(enc)}")
        stacks.append(("encoder segments", enc["segments"],
                       [(("attn",), cfg.num_encoder_layers)], False))
        _check_shape("encoder frontend_proj", enc["frontend_proj"], (d, d))
    if "vision_proj" in params:
        _check_shape("vision_proj", params["vision_proj"], (d, d))
    for where, segments, seg_plan, cross in stacks:
        if len(segments) != len(seg_plan):
            raise ValueError(f"{len(segments)} {where}, {cfg.name!r} has "
                             f"{len(seg_plan)}")
        for i, (seg, (unit, count)) in enumerate(zip(segments, seg_plan,
                                                     strict=True)):
            positions = {str(j) for j, kind in enumerate(unit)
                         if kind != "shared_attn"}
            if set(seg) != positions:
                raise ValueError(f"{where} {i} holds positions {sorted(seg)}, "
                                 f"{cfg.name!r}'s unit {unit} "
                                 f"{sorted(positions)}")
            for j in sorted(positions):
                depth = {leaf.shape[0] for leaf in flatten(seg[j]).values()}
                if depth != {count}:
                    raise ValueError(f"{where} {i} position {j} stacks "
                                     f"{depth} layers, {cfg.name!r}'s plan "
                                     f"{count}")
                if unit[int(j)] != "mamba":
                    blocks.append((seg[j], unit[int(j)], 1))
                    if ("cross" in seg[j]) != cross or (
                            "cross_norm" in seg[j]) != cross:
                        raise ValueError(
                            f"{cfg.name!r}: cross-attention in {where} {i} "
                            f"position {j} {'cross' in seg[j]}, wanted "
                            f"{cross}")
    want_posts = (["post_attn_norm", "post_mlp_norm"] if cfg.sandwich_norm
                  else [])
    want_mlp = ({"w1", "w2"} if cfg.mlp_kind == "gelu"
                else {"wi_gate", "wi_up", "wo"})
    for block, kind, stacked in blocks:
        posts = sorted(k for k in block if k.startswith("post_"))
        if posts != want_posts:
            raise ValueError(f"{cfg.name!r}: post-norms {posts} in the tree, "
                             f"sandwich_norm {cfg.sandwich_norm}")
        ffn = "moe" if tf.is_moe(kind) else "mlp"
        if ffn not in block or {"mlp", "moe"} & set(block) != {ffn}:
            raise ValueError(f"{cfg.name!r}: a {kind!r} block holds "
                             f"{sorted(block)}, wanted its {ffn!r}")
        if ffn == "moe":
            _check_moe(block["moe"], cfg, stacked, want_mlp)
        elif set(block["mlp"]) != want_mlp:
            raise ValueError(f"{cfg.name!r}: MLP leaves {sorted(block['mlp'])}"
                             f", mlp_kind {cfg.mlp_kind!r}")
        if tf.is_mla(kind):
            _check_mla(block["attn"], cfg, stacked)
        elif "w_dkv" in block["attn"]:
            raise ValueError(f"{cfg.name!r}: MLA leaves in a {kind!r} "
                             "block")
    _check_shape("embed", params["embed"], (cfg.vocab_size, d))
    dt = dtype_of(cfg.dtype)
    if params["embed"].dtype != dt:
        raise ValueError(f"embed dtype {params['embed'].dtype} != {dt}")


def _check_moe(moe: Dict, cfg: ModelConfig, stacked: int,
               want_mlp) -> None:
    """A MoE block's leaves and shapes (behind ``stacked`` layer axes)."""
    d, e, f = cfg.d_model, cfg.num_experts, cfg.resolved_moe_d_ff
    want = {"router", "wi_gate", "wi_up", "wo"}
    if cfg.num_shared_experts > 0:
        want.add("shared")
    if set(moe) != want:
        raise ValueError(f"{cfg.name!r}: MoE leaves {sorted(moe)}, wanted "
                         f"{sorted(want)}")
    for name, shape in (("router", (d, e)), ("wi_gate", (e, d, f)),
                        ("wi_up", (e, d, f)), ("wo", (e, f, d))):
        _check_shape(f"moe {name}", moe[name], shape, stacked)
    if "shared" in moe and set(moe["shared"]) != want_mlp:
        raise ValueError(f"{cfg.name!r}: shared expert leaves "
                         f"{sorted(moe['shared'])}")


def _check_mla(attn: Dict, cfg: ModelConfig, stacked: int) -> None:
    """An MLA block's attention leaves and shapes."""
    d, h, lora = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank
    nope, rdim = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    want = {"wq": (d, h * (nope + rdim)), "w_dkv": (d, lora + rdim),
            "w_uk": (lora, h * nope), "w_uv": (lora, h * cfg.v_head_dim),
            "wo": (h * cfg.v_head_dim, d)}
    if set(attn) != {*want, "kv_norm"}:
        raise ValueError(f"{cfg.name!r}: MLA leaves {sorted(attn)}, wanted "
                         f"{sorted({*want, 'kv_norm'})}")
    for name, shape in want.items():
        _check_shape(f"mla {name}", attn[name], shape, stacked)
    _check_shape("mla kv_norm", attn["kv_norm"]["scale"], (lora,), stacked)


def _check_shape(name: str, leaf, want, lead: int = 0) -> None:
    """``leaf``'s shape behind its first ``lead`` (layer-stack) axes."""
    if tuple(leaf.shape)[lead:] != tuple(want):
        raise ValueError(f"{name} {tuple(leaf.shape)[lead:]} != "
                         f"{tuple(want)}")


def params_from_numpy(tree: Any, cfg: ModelConfig,
                      device: DeviceLike = None) -> Dict:
    """Convert a numpy-leaf JAX param pytree to the port's params dict."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return tuple(conv(v) for v in node)
        return to_tensor(node, dev)

    params = conv(tree)
    _check(params, cfg)
    return params


def flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Nested dicts / tuples -> ``{"k:a|i:0|k:b": leaf}`` in the reference's
    leaf order (``jax.tree.leaves``: dict keys sorted, tuples in order)."""
    if isinstance(tree, dict):
        items = [(f"k:{k}", tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (tuple, list)):
        items = [(f"i:{i}", v) for i, v in enumerate(tree)]
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for key, sub in items:
        out.update(flatten(sub, f"{prefix}{_SEP}{key}" if prefix else key))
    return out


def tree_map(fn, tree: Any) -> Any:
    """``fn`` applied to every leaf of nested dicts / tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(tree_map(fn, v) for v in tree)
    return fn(tree)


def unflatten(flat: Dict[str, Any]) -> Dict:
    """``k:a|i:0|k:b`` keyed leaves -> nested dicts (``i:`` levels become
    tuples), the inverse of ``flatten``."""
    root: Dict = {}
    for key, arr in flat.items():
        node = root
        parts = key.split(_SEP)
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr

    def build(node):
        if not isinstance(node, dict):
            return node
        if all(k.startswith("i:") for k in node):
            return tuple(build(node[k])
                         for k in sorted(node, key=lambda s: int(s[2:])))
        if not all(k.startswith("k:") for k in node):
            raise ValueError(f"unexpected checkpoint keys {sorted(node)}")
        return {k[2:]: build(v) for k, v in node.items()}

    return build(root)


def load_checkpoint(npz_path: str, cfg: ModelConfig,
                    device: DeviceLike = None) -> Dict:
    """Read a ``training/checkpoint.save`` archive into port params."""
    if not npz_path.endswith(".npz"):
        npz_path = npz_path + ".npz"
    with np.load(npz_path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    return params_from_numpy(unflatten(flat), cfg, device)


def tier0_params_from_numpy(tree: Dict[str, Any], device: DeviceLike = None,
                            cfg: Optional[T0.Tier0Config] = None
                            ) -> Dict[str, torch.Tensor]:
    """The reference tier-0 head's param dict (numpy leaves) as float32
    tensors in the same ``(in, out)`` layout, shapes checked against
    ``cfg`` (default ``Tier0Config()``)."""
    cfg = cfg if cfg is not None else T0.Tier0Config()
    want = T0.param_shapes(cfg)
    if set(tree) != set(want):
        raise ValueError(f"tier-0 params {sorted(tree)} != {sorted(want)}")
    dev = resolve_device(device)
    out = {}
    for name in T0.PARAM_NAMES:
        arr = np.asarray(tree[name])
        if tuple(arr.shape) != want[name]:
            raise ValueError(f"tier-0 {name} {tuple(arr.shape)} != "
                             f"{want[name]} for {cfg}")
        out[name] = torch.tensor(arr.astype(np.float32), device=dev)
    return out
