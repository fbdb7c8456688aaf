"""Rule: device-body-side-effect.

Stands where the reference's ``traced-body-side-effect`` stands.  There, a
traced body's Python runs once per compilation; here, a device body's
Python runs once per *capture* once the decode step is captured in a CUDA
graph (ROADMAP item 8b): a replay repeats the recorded device work and
never re-runs the Python.  Host state a device body mutates — module
globals, closed-over mutables, ``self`` — is therefore updated once at
capture and never on a replay.

Flagged inside device bodies:

- stores to a name the function declares ``global``, or ``nonlocal`` and
  bound outside the outermost device body;
- attribute / subscript stores and augmented assigns whose base object is
  defined outside that body (``self.n += 1``, ``COUNTS[k] += 1``);
- mutating method calls (``.append`` / ``.update`` / ``.add`` / ...) on
  such outside objects.

Writes into the body's own arguments and locals (a cache tensor updated in
place) are device work a replay repeats, and stay silent.  There is no
whitelist: the kernel wrappers' launch counters are flagged, and each
carries a waiver saying that a replay does not count them.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, Optional, Set

from repro_torch.analysis.astpass import ModuleContext, Rule, _FunctionNode
from repro_torch.analysis.findings import Finding

_MUTATORS = frozenset({
    "append", "extend", "insert", "add", "update", "setdefault", "pop",
    "popitem", "clear", "remove", "discard", "write", "appendleft",
})


def _base_name(node: ast.AST) -> Optional[str]:
    """Leftmost Name of an attribute/subscript chain (``a`` in ``a.b[c]``)."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _declared(ctx: ModuleContext, root: ast.AST) -> Dict[ast.AST, Set[str]]:
    """Function -> names it declares ``global`` / ``nonlocal``."""
    out: Dict[ast.AST, Set[str]] = {}
    for node in ast.walk(root):
        if isinstance(node, (ast.Nonlocal, ast.Global)):
            out.setdefault(ctx.enclosing_function(node), set()).update(
                node.names)
    return out


def _root_locals(ctx: ModuleContext, root: ast.AST,
                 declared: Dict[ast.AST, Set[str]]) -> Set[str]:
    """Every name bound anywhere within ``root`` (any nesting depth).

    Coarse by design: an object bound inside the device body is made
    afresh by each call.  Stores in a function that declares the name
    ``nonlocal`` / ``global`` do not count — those bind outside their
    scope.
    """
    names: Set[str] = set()
    for node in ast.walk(root):
        if isinstance(node, _FunctionNode):
            names.add(node.name)
            a = node.args
            names.update(p.arg for p in
                         (a.posonlyargs + a.args + a.kwonlyargs))
            if a.vararg:
                names.add(a.vararg.arg)
            if a.kwarg:
                names.add(a.kwarg.arg)
        elif isinstance(node, ast.Name) and \
                isinstance(node.ctx, (ast.Store, ast.Del)):
            fn = ctx.enclosing_function(node)
            if node.id not in declared.get(fn, ()):
                names.add(node.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                names.add((alias.asname or alias.name).split(".")[0])
        elif isinstance(node, ast.ExceptHandler) and node.name:
            names.add(node.name)
    return names


class DeviceSideEffectRule(Rule):
    id = "device-body-side-effect"
    description = ("mutation of host state outliving the call (globals, "
                   "closures, self) inside device bodies: a CUDA graph "
                   "replay never re-runs it")

    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        info = {}
        for node in ast.walk(ctx.tree):
            root = ctx.device_root(node)
            if root is None:
                continue
            if root not in info:
                declared = _declared(ctx, root)
                info[root] = (declared, _root_locals(ctx, root, declared))
            declared, rl = info[root]
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for tgt in targets:
                    yield from self._check_store(ctx, tgt, declared, rl)
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _MUTATORS:
                base = _base_name(node.func.value)
                if base is None or base in rl:
                    continue
                yield ctx.finding(
                    self.id, node,
                    f"'{base}.{node.func.attr}(...)' mutates an object "
                    "defined outside the device body — a graph replay "
                    "never repeats it")

    def _check_store(self, ctx: ModuleContext, tgt: ast.AST,
                     declared: Dict[ast.AST, Set[str]],
                     rl: Set[str]) -> Iterator[Finding]:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for elt in tgt.elts:
                yield from self._check_store(ctx, elt, declared, rl)
            return
        if isinstance(tgt, ast.Name):
            fn = ctx.enclosing_function(tgt)
            if tgt.id in declared.get(fn, ()) and tgt.id not in rl:
                yield ctx.finding(
                    self.id, tgt,
                    f"store to '{tgt.id}' outside the device body (global "
                    "/ nonlocal) runs at capture, never on a graph replay")
            return
        if not isinstance(tgt, (ast.Attribute, ast.Subscript)):
            return
        base = _base_name(tgt)
        if base is None or base in rl:
            return
        yield ctx.finding(
            self.id, tgt,
            f"store into '{base}' defined outside the device body mutates "
            "host state a graph replay never updates")

    triggers = (
        """\
from collections import Counter

launches = 0
shape_launches = Counter()
_CALLS = []

def step_cuda(x):
    global launches
    launches += 1
    shape_launches[x.shape] += 1
    _CALLS.append(1)
    return x * 2

def outer():
    total = 0

    def inner_cuda(x):
        nonlocal total
        total += 1
        return x

    return inner_cuda
""",
    )
    non_triggers = (
        """\
import torch

launches = 0

def step_cuda(x, cache):
    scratch = {}
    scratch["x"] = x
    cache["k"][0] = x
    cache["conv"].copy_(x)
    return x * 2

def count():
    global launches
    launches += 1
""",
    )
