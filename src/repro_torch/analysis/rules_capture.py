"""Rule: graph-capture-hazard.

Stands where the reference's ``recompile-hazard`` stands.  That rule guards
XLA's executable cache, which eager PyTorch does not have; what the port's
decode step has instead is the CUDA graph that would capture it (ROADMAP
item 8b).  A capture records the device work of one call and replays it,
so a device body must launch the same work, from the same buffers, whatever
the values on the card.  Statically visible hazards, inside a device body
(``astpass``):

- **a host->device tensor made there**: ``torch.tensor(..., device=)``,
  ``torch.as_tensor(..., device=)``, or ``.to(device)`` / ``.cuda()`` of a
  host value (``torch.from_numpy``, a numpy call, a list): a copy from
  pageable memory waits for the stream, and a replay would reuse the
  captured values;
- **a Python branch on a device value** (``if x.sum() > 0:``): it waits
  for the card, and a replay takes the captured branch whatever the value;
- **an allocation whose shape is a device value**: the same wait, and a
  shape no replay can change.

And anywhere: ``torch.compile(...)`` or ``build.load(...)`` constructed
inside a ``for`` / ``while`` body, which builds (or looks up) afresh on
every iteration — hoist it.
"""
from __future__ import annotations

import ast
from typing import Iterator, Set

from repro_torch.analysis.astpass import (ModuleContext, Rule, dotted,
                                          in_loop, kwarg)
from repro_torch.analysis.findings import Finding

_UPLOADS = frozenset({"torch.tensor", "torch.as_tensor"})
_HOST_MAKERS = frozenset({"torch.from_numpy", "torch.tensor",
                          "torch.as_tensor"})
_ALLOCS = frozenset({"torch.empty", "torch.zeros", "torch.ones",
                     "torch.full", "torch.arange", "torch.rand",
                     "torch.randn", "torch.randint"})
_NEW_ALLOCS = frozenset({"new_empty", "new_zeros", "new_ones", "new_full"})
_BUILDS = frozenset({"torch.compile", "build.load", "load"})
_DTYPES = frozenset({"float16", "float32", "float64", "bfloat16", "int8",
                     "int16", "int32", "int64", "uint8", "bool", "half",
                     "float", "double", "long", "int", "complex64"})


def _host_expr(node: ast.AST, host: Set[str]) -> bool:
    """Whether ``node`` evidently holds a host value."""
    if isinstance(node, ast.Name):
        return node.id in host
    if isinstance(node, (ast.List, ast.Tuple, ast.ListComp)):
        return True
    if isinstance(node, ast.Call):
        fname = dotted(node.func) or ""
        if fname in _HOST_MAKERS:
            return kwarg(node, "device") is None
        return fname.startswith(("np.", "numpy."))
    return False


def _host_names(fn: ast.AST) -> Set[str]:
    """Names a function binds to evident host values (to a fixpoint)."""
    host: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and \
                    _host_expr(node.value, host):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name) and tgt.id not in host:
                        host.add(tgt.id)
                        changed = True
    return host


def _moves_to_device(node: ast.Call) -> bool:
    """``x.cuda()``, or ``x.to(...)`` naming a device (not a dtype only)."""
    if not isinstance(node.func, ast.Attribute):
        return False
    if node.func.attr == "cuda":
        return True
    if node.func.attr != "to":
        return False
    if kwarg(node, "device") is not None:
        return True
    return any(not ((dotted(a) or "").startswith("torch.")
                    and (dotted(a) or "").split(".")[-1] in _DTYPES)
               for a in node.args)


class CaptureHazardRule(Rule):
    id = "graph-capture-hazard"
    description = ("host->device tensors, branches on device values or "
                   "device-valued shapes in device bodies; torch.compile / "
                   "build.load inside a loop")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        host_of = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                yield from self._check_build_in_loop(ctx, node)
                fn = ctx.device_fn(node)
                if fn is None or ctx.in_raise(node):
                    continue
                if fn.node not in host_of:
                    host_of[fn.node] = _host_names(fn.node)
                yield from self._check_call(ctx, node, host_of[fn.node])
            elif isinstance(node, (ast.If, ast.While)):
                yield from self._check_branch(ctx, node)

    def _check_build_in_loop(self, ctx: ModuleContext,
                               node: ast.Call) -> Iterator[Finding]:
        fname = dotted(node.func)
        if fname in _BUILDS and in_loop(ctx, node):
            yield ctx.finding(
                self.id, node,
                f"{fname}() inside a loop builds or looks up afresh on "
                "every iteration — hoist it out")

    def _check_call(self, ctx: ModuleContext, node: ast.Call,
                    host: Set[str]) -> Iterator[Finding]:
        fname = dotted(node.func)
        if fname in _UPLOADS and kwarg(node, "device") is not None:
            yield ctx.finding(
                self.id, node,
                f"{fname}(..., device=) inside a device body copies from "
                "the host at every call (and waits for the stream); a "
                "replay would reuse the captured values — pass a device "
                "tensor in")
            return
        if _moves_to_device(node) and _host_expr(node.func.value, host):
            yield ctx.finding(
                self.id, node,
                "a host value moved to the device inside a device body: "
                "a copy that waits for the stream, frozen by a capture")
            return
        taint = ctx.taint_at(node)
        shape_args = []
        if fname in _ALLOCS:
            shape_args = node.args
        elif isinstance(node.func, ast.Attribute) and \
                node.func.attr in _NEW_ALLOCS:
            shape_args = node.args[:1]
        if any(ctx.tainted(a, taint) for a in shape_args):
            yield ctx.finding(
                self.id, node,
                f"{fname or node.func.attr}() with a shape read from a "
                "device value waits for the card, and no replay can change "
                "the shape")

    def _check_branch(self, ctx: ModuleContext,
                      node: ast.AST) -> Iterator[Finding]:
        fn = ctx.device_fn(node)
        if fn is None:
            return
        test = node.test
        # bare-name truthiness belongs to host-sync-in-hot-path
        bare = test
        if isinstance(bare, ast.UnaryOp) and isinstance(bare.op, ast.Not):
            bare = bare.operand
        if isinstance(bare, ast.Name):
            return
        if ctx.tainted(test, ctx.tainted_names(fn.node)):
            yield ctx.finding(
                self.id, node,
                "Python branch on a device value waits for the card, and a "
                "captured graph replays the branch it took — use "
                "torch.where (branches on shapes and config are fine)")

    triggers = (
        """\
import numpy as np
import torch

def step_cuda(x, lens):
    ids = torch.as_tensor([1, 2], device=x.device)
    host = torch.from_numpy(np.arange(4))
    idx = host.to(x.device)
    if x.sum() > 0:
        x = -x
    out = torch.zeros(lens.max())
    return x, ids, idx, out

def build_all(names):
    fns = []
    for name in names:
        fns.append(torch.compile(lambda y: y * 2))
    return fns
""",
    )
    non_triggers = (
        """\
import torch

_step = torch.compile(lambda y: y * 2.0)

def step_cuda(x, pos, *, window: int = 0):
    rows = torch.arange(x.shape[0], device=x.device)
    out = torch.zeros((x.shape[0], 4), device=x.device)
    scale = torch.tensor(0.5, dtype=x.dtype).item()
    if window > 0 and x.shape[1] == window:
        pos = pos % window
    if x.device.type != "cuda" or any(t.stride(-1) != 1 for t in (x, pos)):
        raise ValueError("needs CUDA tensors")
    return x[rows, pos].to(torch.float32) * scale, out

def caller(x):
    for _ in range(3):
        x = _step(x)
    return x
""",
    )
