"""Per-architecture parameter / activation / cache sharding rules: the port
of ``repro/distributed/sharding.py``, and their placement with DTensor.

Strategy (MaxText-style 2D sharding, as in the reference):
  * tensor parallelism on ``model``: attention head projections, FFN hidden,
    vocab, MoE experts, Mamba heads;
  * FSDP on ``data`` (+ ``pod`` on the multi-pod mesh): the non-TP dim of
    every large matrix is additionally sharded;
  * activations: batch on (pod, data); heads/ffn/vocab/experts on model;
  * decode caches: batch on (pod, data) when divisible, cache sequence on
    model otherwise (long_500k with batch 1 spreads S over (data, model)).

Every rule is divisibility-checked against the mesh and dropped when a dim
does not divide, exactly as the reference's ``_fit`` drops it.

A spec is a tuple with one entry per tensor dim: ``None``, one axis name,
or a tuple of names — a ``PartitionSpec``'s entries.  ``param_specs`` and
``cache_specs`` return ``{key: spec}`` keyed by ``io.flatten``'s leaf keys
(the reference returns a pytree of the same leaves).  A mesh is anything
with ``axis_names`` and ``shape`` (``MeshSpec``, the planning meshes of
``launch.mesh``) or a ``DeviceMesh`` with ``mesh_dim_names``.

``placements`` turns a spec into DTensor placements: ``Shard(dim)`` on each
mesh dim the spec names, else ``Replicate()``.  Where a dim carries an axis
tuple, DTensor splits it over the mesh dims in mesh order, the first
outermost; JAX's ``NamedSharding`` splits it over the tuple's axes in the
tuple's order, the first outermost.  So the two blocks agree when the tuple
is in mesh order — every tuple these rules make is — and ``placements``
refuses any other.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Sequence, Tuple

import torch

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A mesh by its axis names and shape, with no devices behind it."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    return dict(zip(names, tuple(mesh.shape), strict=True))


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(axes, str):
        return sizes[axes]
    return math.prod(sizes[a] for a in axes)


def _fit(mesh, dim: int, axes):
    """Return axes if dim divides their product, else None."""
    if axes is None:
        return None
    return axes if dim % axis_size(mesh, axes) == 0 else None


def data_axes(mesh):
    return ("pod", "data") if "pod" in axis_sizes(mesh) else "data"


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------
_COL_PARALLEL = {"wq", "wk", "wv", "wi_gate", "wi_up", "w1", "w_uk", "w_uv",
                 "in_proj", "frontend_proj", "vision_proj", "lm_head"}
_ROW_PARALLEL = {"wo", "w2", "out_proj"}


def _param_spec(mesh, path: Tuple[str, ...], shape: Tuple[int, ...]) -> Spec:
    name = path[-1]
    in_moe_experts = ("moe" in path and "shared" not in path
                      and name in ("wi_gate", "wi_up", "wo"))
    fsdp = data_axes(mesh)

    if len(shape) == 0 or min(shape) == 0:
        return ()

    def pad(tail: Sequence) -> Spec:
        """Left-pad with None for stacked layer dims."""
        return tuple([None] * (len(shape) - len(tail)) + list(tail))

    if in_moe_experts:
        # (E, d, f) or (E, f, d): experts on model, fsdp on the inner dim
        e, a = shape[-3], shape[-2]
        return pad([_fit(mesh, e, "model"), _fit(mesh, a, fsdp), None])
    if name == "router":
        return pad([_fit(mesh, shape[-2], fsdp), None])
    if name == "embed":
        return (_fit(mesh, shape[0], "model"), _fit(mesh, shape[1], fsdp))
    if name in _COL_PARALLEL and len(shape) >= 2:
        return pad([_fit(mesh, shape[-2], fsdp),
                    _fit(mesh, shape[-1], "model")])
    if name in _ROW_PARALLEL and len(shape) >= 2:
        return pad([_fit(mesh, shape[-2], "model"),
                    _fit(mesh, shape[-1], fsdp)])
    if name == "w_dkv" and len(shape) >= 2:   # MLA down-proj: fsdp only
        return pad([_fit(mesh, shape[-2], fsdp), None])
    if name == "conv_w":
        return pad([None, _fit(mesh, shape[-1], "model")])
    # scales, biases, A_log, D, dt_bias, kv_norm ... replicated
    return (None,) * len(shape)


def _names(key: str) -> Tuple[str, ...]:
    """``k:segments|i:0|k:wq`` -> ("segments", "0", "wq"): the reference's
    key names (``_key_name``) of the same leaf."""
    return tuple(part.split(":", 1)[1] for part in key.split("|"))


def _map_keyed(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """``fn(key, leaf)`` over nested dicts / tuples, keyed as
    ``io.flatten`` keys them; the tree's structure is kept."""
    def join(part):
        return f"{prefix}|{part}" if prefix else part
    if isinstance(tree, dict):
        return {k: _map_keyed(fn, v, join(f"k:{k}")) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_map_keyed(fn, v, join(f"i:{i}"))
                     for i, v in enumerate(tree))
    return fn(prefix, tree)


def _keyed_leaves(tree) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    _map_keyed(out.__setitem__, tree)
    return out


def param_specs(mesh, params) -> Dict[str, Spec]:
    """``{leaf key: spec}`` of a param tree (tensors, meta tensors too)."""
    return {key: _param_spec(mesh, _names(key), tuple(leaf.shape))
            for key, leaf in _keyed_leaves(params).items()}


# ---------------------------------------------------------------------------
# Batch / cache specs
# ---------------------------------------------------------------------------
def batch_specs(mesh, batch_shapes: Dict[str, Any]) -> Dict[str, Spec]:
    da = data_axes(mesh)
    out = {}
    for k, v in batch_shapes.items():
        shape = tuple(v.shape)
        if k == "positions_3d":            # (3, b, s)
            out[k] = (None, _fit(mesh, shape[1], da), None)
        else:                               # (b, ...) leading batch
            out[k] = tuple([_fit(mesh, shape[0], da)]
                           + [None] * (len(shape) - 1))
    return out


def _with_model(da) -> Tuple[str, ...]:
    return (da, "model") if isinstance(da, str) else tuple(da) + ("model",)


def cache_specs(mesh, cache_shapes) -> Dict[str, Spec]:
    """Decode-cache specs: (layer-stack, batch, ...) leaves."""
    da = data_axes(mesh)
    out = {}
    for key, leaf in _keyed_leaves(cache_shapes).items():
        name = _names(key)[-1]
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        if len(shape) >= 2:
            spec[1] = _fit(mesh, shape[1], da)          # batch dim
        if name in ("k", "v", "ck", "cv") and len(shape) == 5:
            # (L, b, h, S, hd): heads on model if divisible, else seq
            h_ax = _fit(mesh, shape[2], "model")
            if h_ax is not None:
                spec[2] = h_ax
            else:
                spec[3] = _fit(mesh, shape[3], "model")
            if spec[1] is None and spec[3] is None:
                # batch unshardable (b=1): spread sequence over everything
                spec[3] = _fit(mesh, shape[3], _with_model(da))
                if spec[3] is not None:
                    spec[2] = None
        elif name in ("c_kv", "k_rope") and len(shape) == 4:
            # (L, b, S, dim): sequence on model
            spec[2] = _fit(mesh, shape[2], "model")
            if spec[1] is None and spec[2] is not None:
                alt = _fit(mesh, shape[2], _with_model(da))
                if alt is not None:
                    spec[2] = alt
        elif name == "ssm" and len(shape) == 5:
            spec[2] = _fit(mesh, shape[2], "model")     # heads
        elif name == "conv" and len(shape) == 4:
            spec[3] = _fit(mesh, shape[3], "model")     # channels
        out[key] = tuple(spec)
    return out


# ---------------------------------------------------------------------------
# Activation rules (the reference's models.common.activation_mesh rules)
# ---------------------------------------------------------------------------
def activation_rules(mesh) -> Dict[str, Any]:
    da = data_axes(mesh)
    return {"batch": da, "heads": "model", "ffn": "model",
            "vocab": "model", "expert": "model", "residual": "model"}


# ---------------------------------------------------------------------------
# Blocks, bytes and DTensor placement
# ---------------------------------------------------------------------------
def spec_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry, in order."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def split(mesh, spec: Spec) -> int:
    """How many blocks a leaf of ``spec`` is cut into."""
    return math.prod(axis_size(mesh, spec_axes(e)) for e in spec)


def local_bytes(mesh, tree, specs: Dict[str, Spec]) -> int:
    """Bytes one device holds of ``tree`` under ``specs``: each leaf's bytes
    over the product of its sharded axes' sizes."""
    return sum(leaf.numel() * leaf.element_size() // split(mesh, specs[key])
               for key, leaf in _keyed_leaves(tree).items())


def local_block(mesh, spec: Spec, shape: Sequence[int],
                coord: Sequence[int]) -> Tuple[slice, ...]:
    """The block of a ``shape`` tensor that the device at mesh coordinate
    ``coord`` holds under ``spec``: a dim over axes (a1, a2, ...) is cut
    into their product of equal blocks, a1 outermost, as ``NamedSharding``
    cuts it."""
    sizes = axis_sizes(mesh)
    at = dict(zip(sizes, coord, strict=True))
    out = []
    for dim, entry in zip(shape, spec, strict=True):
        idx, n = 0, 1
        for a in spec_axes(entry):
            idx, n = idx * sizes[a] + at[a], n * sizes[a]
        step = dim // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def placements(mesh, spec: Spec) -> list:
    """DTensor placements of ``spec`` on a ``DeviceMesh``: ``Shard(dim)`` on
    each mesh dim the spec names, ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    order = list(axis_sizes(mesh))
    out = [Replicate() for _ in order]
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        pos = [order.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(
                f"spec {spec}: axes {axes} on dim {dim} are not in the "
                f"mesh's order {tuple(order)}, so DTensor's blocks would "
                "not be NamedSharding's")
        for p in pos:
            if not isinstance(out[p], Replicate):
                raise ValueError(f"spec {spec} names mesh axis {order[p]!r} "
                                 "twice")
            out[p] = Shard(dim)
    return out


def distribute_tree(mesh, tree, specs: Dict[str, Spec]):
    """Every leaf of ``tree`` as a DTensor on ``mesh`` placed per ``specs``.
    ``distribute_tensor`` takes each leaf from the mesh's first rank, so
    the ranks need not hold equal copies."""
    from torch.distributed.tensor import distribute_tensor
    return _map_keyed(lambda key, leaf: distribute_tensor(
        leaf, mesh, placements(mesh, specs[key])), tree)


def gather_tree(tree):
    """Plain tensors of a tree of DTensors (``full_tensor`` per leaf, a
    collective every rank of the mesh must join); plain leaves pass."""
    from torch.distributed.tensor import DTensor
    return _map_keyed(lambda key, leaf: leaf.full_tensor()
                      if isinstance(leaf, DTensor) else leaf, tree)


# ---------------------------------------------------------------------------
# Rows of a batch over the serve mesh
# ---------------------------------------------------------------------------
def row_spec(mesh, b: int):
    """The batch-dim entry of a (b, ...) batch on ``mesh``: the data axes,
    or None where b does not divide (every rank then holds every row)."""
    return batch_specs(mesh, {"tokens": torch.empty((b, 1), device="meta")}
                       )["tokens"][0]


def local_rows(mesh, b: int) -> slice:
    """The rows of a (b, ...) batch that this rank computes."""
    return local_block(mesh, (row_spec(mesh, b),), (b,),
                       mesh.get_coordinate())[0]


def gather_rows(mesh, b: int, local: torch.Tensor) -> torch.Tensor:
    """All ``b`` rows on every rank from each rank's ``local_rows``: an
    all-gather over the data axes (ranks along ``model`` hold equal rows)."""
    spec = (row_spec(mesh, b),)
    if spec[0] is None:
        return local
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh, placements(mesh, spec),
                              run_check=False).full_tensor()
