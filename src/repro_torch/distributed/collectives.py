"""Collectives over a device mesh's axes, differentiable, and the layout
that computes a model on sharded params: the port of what XLA inserts for
``sharding.py``'s rules when the reference trains or serves on a mesh.

Params placed by ``sharding.distribute_tree`` are DTensors.  A rank holds
its block of each leaf and never the whole tree: the model gathers a
layer's leaves just before the layer runs (``Layout.block``), and drops
them after it.

  * ``data`` (FSDP): a leaf cut over ``data`` is all-gathered along its cut
    dim.  Where the ranks along ``data`` compute different rows of the
    batch (``rows_split``), the backward is a reduce-scatter (summed), and
    a leaf replicated over ``data`` has its gradient all-reduced (summed).
    Where every rank computes every row (rows, or a MoE batch's routing
    groups, that do not divide), each rank's gradient is already whole:
    the backward keeps the rank's own slice and sums nothing.
  * ``model`` (tensor parallelism, Megatron's pairs): a block that
    ``model_split`` reports split computes its own heads (GQA and MLA
    attention, Mamba's SSD) or columns (MLP).  Its column-parallel input
    passes ``enter`` (identity forward, all-reduce backward) and its
    row-parallel output ``leave`` (all-reduce forward, identity backward);
    ``q_norm`` / ``k_norm`` see only the local heads, so their gradients are
    summed over ``model``.  An MLA layer keeps its blocks of ``wq``,
    ``w_uk``, ``w_uv`` (columns) and ``wo`` (rows), and gathers ``w_dkv``
    and ``kv_norm`` whole: every rank computes the whole latent and uses it
    for its own heads only, so their gradients are summed over ``model``.
    A Mamba layer gathers ``in_proj`` and ``conv_w`` whole and
    uses the rank's heads' columns of them and the whole ``B`` / ``C``, so
    their gradients are summed over ``model`` (a reduce-scatter), as are
    those of its replicated per-head leaves; its gated norm runs over all
    of ``d_inner``, its sum of squares summed over ``model`` both ways
    (``shared_sum``).  Every other leaf cut over ``model`` is all-gathered
    there and its block computes redundantly; the loss is the same on every
    rank along ``model``, so that backward keeps the rank's slice.
  * the vocabulary: ``embed`` cut over ``model`` is looked up by its local
    rows (the others zero, then ``leave``), and the logits are the local
    vocabulary slice all-gathered along the last dim.

On a group of one rank every collective is skipped, so a world-1 mesh
computes exactly what one process computes.  Meshes have the axes
("data", "model"), as ``launch.mesh`` makes them.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import axis_sizes, local_rows, row_spec
from repro_torch.models.moe import routing_groups

_AXES = ("data", "model")
# leaves of an attention block that compute split over ``model`` and those
# whose gradients are partial there (a norm over each local head); the
# layer kinds whose GQA attention splits
_TP_ATTN = ("wq", "wk", "wv", "wo")
_TP_ATTN_PARTIAL = ("q_norm", "k_norm")
_GQA_KINDS = ("attn", "attn_local", "moe")
# the same for an MLA layer: its latent down-projection and norm are whole
# on every rank, each using it for its own heads
_TP_MLA = ("wq", "w_uk", "w_uv", "wo")
_TP_MLA_PARTIAL = ("w_dkv", "kv_norm")
_MLA_KINDS = ("mla", "mla_moe")
# the leaf of a Mamba layer that keeps its block over ``model`` (its rows
# are the rank's heads); the layer gathers its other leaves whole
_TP_SSM_ROWS = "out_proj"


# ---------------------------------------------------------------------------
# raw collectives (one module-level entry each, so a test can record them)
# ---------------------------------------------------------------------------
def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim``, in rank order."""
    n = _size(group)
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0], *src.shape[1:]))
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, src, group=group)
    # the whole tensor in its own layout, as one process holds it: a
    # product over a strided view may round otherwise
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over the ranks of ``x``, cut along ``dim``: this rank's
    block."""
    n = _size(group)
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
    scatter = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    scatter(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def _own(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim``."""
    n = _size(group)
    step = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * step, step).contiguous()


class _Gather(torch.autograd.Function):
    """All-gather forward; backward a reduce-scatter (``summed``) or this
    rank's slice."""

    @staticmethod
    def forward(ctx, x, dim, group, summed):
        ctx.dim, ctx.group, ctx.summed = dim, group, summed
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        fn = _reduce_scatter if ctx.summed else _own
        return fn(g, ctx.dim, ctx.group), None, None, None


class _Enter(torch.autograd.Function):
    """Identity forward, all-reduce (sum) backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Leave(torch.autograd.Function):
    """All-reduce (sum) forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SharedSum(torch.autograd.Function):
    """All-reduce (sum) forward and backward: a total that every rank then
    uses on its own share, so each rank's gradient of it is partial."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def gather(x: torch.Tensor, dim: int, group, *, summed: bool
           ) -> torch.Tensor:
    """``x`` all-gathered along ``dim`` over ``group`` (differentiable)."""
    return x if _size(group) == 1 else _Gather.apply(x, dim, group, summed)


def enter(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: the input of a split block (its gradient summed)."""
    return x if _size(group) == 1 else _Enter.apply(x, group)


def leave(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: the partial output of a split block, summed."""
    return x if _size(group) == 1 else _Leave.apply(x, group)


def shared_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` summed, where each rank goes on with the total on
    its own share of a row (a norm over heads split over ``model``): its
    gradient summed too."""
    return x if _size(group) == 1 else _SharedSum.apply(x, group)


# ---------------------------------------------------------------------------
# DTensor leaves and their blocks
# ---------------------------------------------------------------------------
class Block(NamedTuple):
    """One rank's block of a (layer of a) sharded leaf: the tensor, and for
    each mesh axis the leaf is cut over, the tensor dim of the cut."""
    local: torch.Tensor
    cuts: Tuple[Tuple[str, int], ...]


@functools.lru_cache(maxsize=None)
def _dtensor():
    from torch.distributed.tensor import DTensor
    return DTensor


def is_sharded(t) -> bool:
    return isinstance(t, _dtensor())


def local(t):
    """A DTensor's local block (differentiable), a plain tensor as is."""
    return t.to_local() if is_sharded(t) else t


def mesh_of(params) -> Optional[Any]:
    """The ``DeviceMesh`` a param tree is placed on, None for plain
    tensors (``embed`` is every backbone's)."""
    e = params["embed"]
    return e.device_mesh if is_sharded(e) else None


def _cuts(t, shift: int) -> Tuple[Tuple[str, int], ...]:
    names = t.device_mesh.mesh_dim_names
    if tuple(names) != _AXES:
        raise ValueError(f"a mesh of axes {names}: the sharded model runs "
                         f"on meshes of axes {_AXES}")
    return tuple((name, p.dim - shift)
                 for name, p in zip(names, t.placements, strict=True)
                 if p.is_shard())


def as_block(t):
    """An unstacked leaf: a ``Block`` when sharded, else the tensor."""
    return Block(local(t), _cuts(t, 0)) if is_sharded(t) else t


def unstack(t):
    """A stacked leaf as per-layer pieces, its local block unbound once:
    ``Block``s when sharded (the layer dim is never cut), else views."""
    if not is_sharded(t):
        return list(torch.unbind(t, 0))
    cuts = _cuts(t, 1)
    return [Block(x, cuts) for x in torch.unbind(local(t), 0)]


# ---------------------------------------------------------------------------
# which blocks compute split over ``model``
# ---------------------------------------------------------------------------
class Split(NamedTuple):
    """Whether attention (GQA or MLA), the MLP, the vocabulary and Mamba's
    SSD heads compute split over ``model``: each rank then holds whole
    heads, columns or rows."""
    attn: bool
    mlp: bool
    vocab: bool
    ssm: bool


def model_split(cfg: ModelConfig, mesh) -> Split:
    """For ``cfg`` on ``mesh``: GQA attention splits where ``num_heads`` and
    ``num_kv_heads`` divide the ``model`` size, MLA (a config whose
    attention is all MLA) where ``num_heads`` does — it has no K/V heads of
    its own, its latent being whole on every rank — the MLP where ``d_ff``
    does, the vocabulary where ``vocab_size`` does, a Mamba layer where its
    SSD heads do (as the reference's ``_fit`` keeps the heads rule of
    ``xh``); none at ``model`` = 1.  Other blocks (MoE experts,
    cross-attention) never split: their leaves are gathered over ``model``
    and computed on every rank, as is attention whose heads do not divide
    (``sharding._fit`` may still cut such a leaf mid-head)."""
    n = axis_sizes(mesh).get("model", 1)
    if n == 1:
        return Split(False, False, False, False)
    all_mla = all(k in _MLA_KINDS for k in cfg.layer_kinds())
    attn = (cfg.num_heads > 0 and cfg.num_heads % n == 0
            and (all_mla or cfg.num_kv_heads % n == 0))
    ssm = cfg.has_ssm() and cfg.resolved_ssm_heads % n == 0
    return Split(attn, cfg.d_ff % n == 0, cfg.vocab_size % n == 0, ssm)


class TP(NamedTuple):
    """A block's split over ``model``: the group, this rank's place in it
    and its size (a Mamba layer's heads are the rank's share), the
    attention's local config (its heads the rank's share; None: attention
    computes whole) and whether the MLP splits."""
    group: Any
    rank: int
    n: int
    attn_cfg: Optional[ModelConfig]
    mlp: bool


# ---------------------------------------------------------------------------
# the layout of one call
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Layout:
    """How one call computes on params placed on ``mesh``: ``rows_split``
    when the ranks along ``data`` hold different rows of the batch.  The
    axes' groups and sizes, and this rank's place along ``model``, are read
    once (``layout``)."""
    mesh: Any
    split: Split
    rows_split: bool
    data: Any
    model: Any
    n_data: int
    n_model: int
    model_rank: int

    def gather(self, x, *, keep_model: bool = False,
               model_partial: bool = False) -> torch.Tensor:
        """A plain tensor of ``x`` (a ``Block``; a plain tensor passes):
        gathered over ``data``, and over ``model`` unless ``keep_model``;
        ``model_partial`` sums its gradient over ``model`` (a leaf the
        rank uses only in part: where it is cut there, the gather's
        backward is a reduce-scatter)."""
        if not isinstance(x, Block):
            return x
        if self.n_data == self.n_model == 1:
            return x.local
        cuts = dict(x.cuts)
        t = x.local
        if "data" in cuts:
            t = gather(t, cuts["data"], self.data, summed=self.rows_split)
        elif self.rows_split:
            t = enter(t, self.data)
        if keep_model and "model" not in cuts and self.n_model > 1:
            raise ValueError(f"a leaf of cuts {x.cuts} computes split over "
                             "model, and its spec does not cut it there")
        if "model" in cuts and not keep_model:
            t = gather(t, cuts["model"], self.model, summed=model_partial)
        elif "model" not in cuts and model_partial:
            t = enter(t, self.model)
        return t

    def tree(self, tree, **how):
        """Every leaf of a dict of pieces (``Block``s, DTensors or plain
        tensors) gathered as ``gather`` does (whole by default)."""
        if isinstance(tree, dict):
            return {k: self.tree(v, **how) for k, v in tree.items()}
        return self.gather(as_block(tree), **how)

    def block(self, p: Dict, cfg: ModelConfig, kind: str
              ) -> Tuple[Dict, Optional[TP]]:
        """A layer's pieces as plain tensors and its split (None where it
        computes whole): attention keeps its local heads where the split
        allows and the block has no cross-attention (an MLA layer its
        blocks of ``wq``, ``w_uk``, ``w_uv`` and ``wo``, its latent's
        leaves whole with their gradients summed over ``model``), the MLP
        its local columns, a Mamba layer its rows of ``out_proj``, every
        other leaf of it whole with its gradient summed over ``model``."""
        mla = kind in _MLA_KINDS
        attn = (self.split.attn and (mla or kind in _GQA_KINDS)
                and "cross" not in p)
        mlp = self.split.mlp and "mlp" in p
        ssm = self.split.ssm and kind == "mamba"
        keep, partial = ((_TP_MLA, _TP_MLA_PARTIAL) if mla
                         else (_TP_ATTN, _TP_ATTN_PARTIAL))
        out = {}
        for name, sub in p.items():
            if name == "attn" and attn:
                out[name] = {k: self.tree(v, keep_model=k in keep,
                                          model_partial=k in partial)
                             for k, v in sub.items()}
            elif name == "mlp" and mlp:
                out[name] = self.tree(sub, keep_model=True)
            elif name == "mamba" and ssm:
                out[name] = {k: self.tree(
                    v, keep_model=k == _TP_SSM_ROWS,
                    model_partial=k != _TP_SSM_ROWS)
                    for k, v in sub.items()}
            else:
                out[name] = self.tree(sub)
        if not (attn or mlp or ssm):
            return out, None
        n = self.n_model
        # MLA reads no K/V heads: its rank's config changes the heads alone
        kv = {} if mla else {"num_kv_heads": cfg.num_kv_heads // n}
        acfg = dataclasses.replace(
            cfg, num_heads=cfg.num_heads // n,
            head_dim=cfg.resolved_head_dim, **kv) if attn else None
        return out, TP(self.model, self.model_rank, n, acfg, mlp)

    # -- the vocabulary ----------------------------------------------------
    def vocab(self, embed) -> Tuple[torch.Tensor, Optional[int]]:
        """``embed`` gathered over ``data``: (its rows, the first row's
        token id) — the local vocabulary slice where the vocabulary splits,
        else (every row, None)."""
        b = as_block(embed)
        split = self.split.vocab and isinstance(b, Block) \
            and ("model", 0) in b.cuts
        t = self.gather(b, keep_model=split)
        if not split:
            return t, None
        return t, self.model_rank * t.shape[0]

    def lookup(self, embed, tokens: torch.Tensor) -> torch.Tensor:
        """Embedding rows of ``tokens``: a vocabulary-parallel lookup (rows
        outside the local slice zero, then summed over ``model``) where the
        vocabulary splits."""
        rows, start = self.vocab(embed)
        if start is None:
            return rows[tokens]
        ids = tokens - start
        inside = (ids >= 0) & (ids < rows.shape[0])
        h = rows[torch.where(inside, ids, 0)]
        h = torch.where(inside[..., None], h, h.new_zeros(()))
        return leave(h, self.model)

    def logits(self, embed, x: torch.Tensor) -> torch.Tensor:
        """``x @ embed.T`` over the whole vocabulary: the local slice's
        logits all-gathered along the last dim where the vocabulary
        splits."""
        rows, start = self.vocab(embed)
        if start is None:
            return x @ rows.T
        part = enter(x, self.model) @ rows.T
        return gather(part, part.dim() - 1, self.model, summed=False)

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of a per-rank share over ``data`` where rows split
        (forward all-reduce, backward identity), else ``x``."""
        return leave(x, self.data) if self.rows_split else x

    def summed(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over ``data`` where rows split (no gradient)."""
        if not self.rows_split or self.n_data == 1:
            return x
        return _all_reduce(x.detach(), self.data)

    @property
    def row_ranks(self) -> int:
        """How many ranks share the batch's rows: ``n_data`` where rows
        split, else 1 (each rank computes all of them)."""
        return self.n_data if self.rows_split else 1


def layout(params, cfg: ModelConfig, *, rows_split: bool = False
           ) -> Optional[Layout]:
    """The layout of a call on ``params``: None for plain tensors."""
    mesh = mesh_of(params)
    if mesh is None:
        return None
    data, model = mesh.get_group("data"), mesh.get_group("model")
    return Layout(mesh, model_split(cfg, mesh), rows_split, data, model,
                  _size(data), _size(model), dist.get_rank(model))


def train_rows(mesh, cfg: ModelConfig, b: int, s: int) -> Optional[slice]:
    """The rows of a (b, s) training batch this rank computes: None where
    every rank computes all of them — rows that do not divide over
    ``data``, or a MoE backbone whose routing groups do not.  A MoE batch
    is routed in G = ``moe.routing_groups(b, s)`` groups of b * s / G
    tokens, rows in order; where G divides over ``data`` each rank's rows
    are whole groups, and its own b * s / n_data tokens regroup to the same
    group size (every divisor of the local total divides the global one),
    as the reference's groups are cut over the batch axes."""
    if row_spec(mesh, b) is None:
        return None
    if cfg.has_moe() and routing_groups(b, s) % axis_sizes(mesh).get(
            "data", 1):
        return None
    return local_rows(mesh, b)


def all_reduce_(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` summed over every rank of ``mesh``, in place (no gradient)."""
    for axis in _AXES:
        group = mesh.get_group(axis)
        if _size(group) > 1:
            dist.all_reduce(t, group=group)
    return t


def owns_replica(t, mesh) -> bool:
    """Whether this rank counts a sharded leaf's block once: its mesh
    coordinate is 0 along every axis the leaf is replicated over."""
    cut = {name for name, _ in _cuts(t, 0)}
    coord = mesh.get_coordinate()
    return all(c == 0 for name, c in zip(mesh.mesh_dim_names, coord,
                                         strict=True) if name not in cut)


def mesh_of_leaves(leaves) -> Optional[Any]:
    """The mesh of the first sharded leaf, None where none is."""
    for t in leaves:
        if is_sharded(t):
            return t.device_mesh
    return None
