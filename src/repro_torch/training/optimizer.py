"""AdamW with gradient clipping and LR schedules, over a tree of tensors.

The port of ``repro/training/optimizer.py``: the reference's warmup +
cosine (or constant) schedule, global-norm clipping and decoupled weight
decay, written out in float32 so one update matches the reference's.  A
tree is a dict of tensors, or nested dicts and tuples of them (the model's
params); leaves go in the reference's order (``io.flatten``).

``value_and_grad`` differentiates a loss at a tree of plain tensors.
``adamw_update`` runs under ``torch.no_grad`` and updates ``params`` and the
state's ``mu``/``nu`` IN PLACE, leaf by leaf and a large leaf in pieces
(the reference returns new trees): at full width, old and new moments side
by side and a float32 copy of every gradient would not fit the card.  It
returns the same ``params`` object and a state holding the same moment
trees.

Params sharded over a device mesh (DTensors) train as they are: the
gradients come back in the params' placement, ``mu`` / ``nu`` are DTensors
of the same placement, and each rank updates its own blocks with the same
float32 expressions.  ``global_norm`` sums each leaf's local squares, sums
them over the mesh, counting a leaf once where it is replicated, and adds
the leaves in the reference's order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.io import flatten, tree_map, unflatten

Tree = Any      # a dict of tensors, or nested dicts / tuples of them


class AdamWState(NamedTuple):
    step: int
    mu: Tree
    nu: Tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"          # cosine | constant


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step``, a float32 scalar on the CPU."""
    step = torch.as_tensor(step, dtype=torch.float32)
    one = torch.ones((), dtype=torch.float32)
    warm = torch.minimum(step / max(cfg.warmup_steps, 1), one)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, summed leaf by leaf in the
    reference's leaf order.  A sharded tree's per-leaf sums are its local
    blocks' summed over the mesh, each replicated block counted by one
    rank only."""
    leaves = list(flatten(tree).values())
    mesh = coll.mesh_of_leaves(leaves)
    if mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                              for leaf in leaves))
    parts = torch.stack([
        torch.sum(torch.square(coll.local(leaf).float()))
        if coll.owns_replica(leaf, mesh)
        else coll.local(leaf).new_zeros((), dtype=torch.float32)
        for leaf in leaves])
    parts = coll.all_reduce_(parts, mesh)
    return torch.sqrt(sum(parts.unbind()))


def value_and_grad(loss, params):
    """``loss(leaves) -> (value, aux)`` differentiated at ``params``: leaves
    that require grad are made for this call only, so the params stay plain
    tensors (the sampler writes caches in place beside them).  Returns
    (value, aux, grads) with grads in the params' structure, dtypes and,
    for sharded params, placement."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    value, aux = loss(leaves)
    flat = flatten(leaves)
    grads = torch.autograd.grad(value, list(flat.values()))
    return (value.detach(), {k: v.detach() for k, v in aux.items()},
            unflatten(dict(zip(flat, grads, strict=True))))


def adamw_init(params: Tree) -> AdamWState:
    def zeros(t):
        return torch.zeros_like(t, dtype=torch.float32)
    return AdamWState(step=0, mu=tree_map(zeros, params),
                      nu=tree_map(zeros, params))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Tree, state: AdamWState,
                 params: Tree) -> Tuple[Tree, AdamWState]:
    """One AdamW step, in place: ``params``, ``state.mu`` and ``state.nu``
    are overwritten leaf by leaf; ``grads`` is read only."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)

    step = state.step + 1
    # float32 scalars computed on the host, applied as Python floats (each
    # exactly a float32 value, so the products below stay float32's)
    step_f = torch.tensor(float(step), dtype=torch.float32)
    lr = float(lr_at(cfg, step))
    b1c = float(1.0 - torch.tensor(cfg.b1, dtype=torch.float32) ** step_f)
    b2c = float(1.0 - torch.tensor(cfg.b2, dtype=torch.float32) ** step_f)

    g_leaves, p_leaves = flatten(grads), flatten(params)
    mu_leaves, nu_leaves = flatten(state.mu), flatten(state.nu)
    if not (g_leaves.keys() == p_leaves.keys() == mu_leaves.keys()
            == nu_leaves.keys()):
        raise ValueError("grads, params and the AdamW state differ in "
                         "structure")
    for key, p in p_leaves.items():
        # a sharded leaf: this rank's blocks, written in place
        leaf = [coll.local(t) for t in (p, mu_leaves[key], nu_leaves[key],
                                        g_leaves[key])]
        dev_scale = scale.to(leaf[0].device)
        for p, m, v, g in _pieces(*leaf):
            g = g.float() * dev_scale
            # m = b1 m + (1 - b1) g ; v = b2 v + (1 - b2) g g, the
            # reference's float32 expressions evaluated in its order
            m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
            v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
            del g
            delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
                + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)


# the update's float32 temporaries come to several times the size of what
# it updates at once: a leaf goes in pieces of at most this many elements,
# so a stacked expert leaf needs a few hundred MB of scratch, not several
# times its own size
UPDATE_PIECE = 1 << 26


def _pieces(*leaf: torch.Tensor):
    """(p, m, v, g) views that cover a leaf's four tensors once, each at
    most ``UPDATE_PIECE`` elements: pieces of their flat views where all
    four are contiguous, else the tensors whole.  The update is element by
    element, so the pieces compute what the whole leaf does, bit for
    bit."""
    if leaf[0].numel() <= UPDATE_PIECE or not all(
            t.is_contiguous() for t in leaf):
        return [leaf]
    return list(zip(*(t.view(-1).split(UPDATE_PIECE) for t in leaf),
                    strict=True))
