"""Layer-1 infrastructure: module parsing, device-body index, taint, rule ABC.

The port of ``repro/analysis/astpass.py``.  The AST rules need to answer two
questions precisely, or they drown the repo in false positives:

1. **Which function bodies run once per decode step on the card?**  Eager
   PyTorch has no trace, so the manifest names them
   (``manifest.DEVICE_BODIES``: ``models/model.decode_step``, the stack's
   decode functions, ``models/tier0``'s forward) together with every
   ``*_cuda`` kernel wrapper in ``kernels/``.  Functions nested inside one,
   and — transitively — module-level functions *called* from one (the
   wrappers' ``check_args``, ``_gqa_qkv`` called from ``gqa_decode``), are
   device bodies too.  These are what a CUDA graph of the decode step
   would capture.

2. **Which names hold device values?**  The positional parameters of a
   manifest root seed the taint set; keyword-only ones are static, as the
   reference's partial-bound kernel knobs are (``int(window)``,
   ``float(softcap)`` in a wrapper), and so is a parameter annotated with a
   host type (``cfg: ModelConfig``, ``kind: str``, ``count: int``), as a
   jit's ``static_argnames`` would be.  Assignment propagates taint;
   a call of a same-module function annotated to return a host type
   (``_rows_fit(t) -> bool``) yields a host value;
   ``.shape`` / ``.ndim`` / ``.dtype`` / ``.device`` and ``.stride()`` /
   ``.numel()`` / ``.size()`` / ``len()`` stop it (metadata the host holds
   without reading the device), and so does an ``is None`` test.
   Parameters of functions that are only *transitively* device bodies are
   left untainted: their call sites may pass host values.

Each rule carries its own self-test corpus (``triggers`` must fire,
``non_triggers`` must stay silent) so ``--self-test`` proves every rule
alive without fixtures.
"""
from __future__ import annotations

import abc
import ast
import dataclasses
from typing import (ClassVar, Dict, FrozenSet, Iterator, List, Optional,
                    Set, Tuple)

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.manifest import (KERNEL_WRAPPER_SUFFIX,
                                           device_body_names, is_hot_path,
                                           wraps_kernels)
from repro_torch.analysis.suppress import Suppressions

# attribute reads the host answers from tensor metadata: they stop taint
STATIC_ATTRS = frozenset({"shape", "ndim", "dtype", "device", "is_cuda",
                          "layout", "itemsize", "requires_grad"})
# methods the host answers from tensor metadata
STATIC_METHODS = frozenset({"stride", "numel", "size", "dim", "data_ptr",
                            "is_contiguous", "element_size", "get_device",
                            "storage_offset"})
_STATIC_CALLS = frozenset({"len", "isinstance", "type", "id", "hasattr"})
# annotations of parameters that hold host values
_HOST_TYPES = frozenset({"int", "float", "bool", "str", "ModelConfig",
                         "Tier0Config", "PagedSpec"})
_CONTAINERS = frozenset({"Tuple", "tuple", "Sequence", "Optional"})

_FunctionNode = (ast.FunctionDef, ast.AsyncFunctionDef)
_COMPREHENSIONS = (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                   ast.DictComp)


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return None if base is None else f"{base}.{node.attr}"
    return None


def kwarg(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def host_annotation(node: Optional[ast.AST]) -> bool:
    """Whether an annotation names a host type (or a tuple of them)."""
    if node is None:
        return False
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        try:
            node = ast.parse(node.value, mode="eval").body
        except SyntaxError:
            return False
    name = dotted(node)
    if name is not None:
        return name.split(".")[-1] in _HOST_TYPES
    if isinstance(node, ast.Subscript) and \
            (dotted(node.value) or "").split(".")[-1] in _CONTAINERS:
        sl = node.slice
        elts = sl.elts if isinstance(sl, ast.Tuple) else [sl]
        return all(host_annotation(e) for e in elts
                   if not (isinstance(e, ast.Constant)
                           and e.value is Ellipsis))
    return False


def in_loop(ctx: "ModuleContext", node: ast.AST) -> bool:
    """Whether ``node`` runs in a ``for``/``while`` body of its own
    function (a loop outside the enclosing def does not re-run it)."""
    cur = ctx.parents.get(node)
    while cur is not None and not isinstance(cur, _FunctionNode):
        if isinstance(cur, (ast.For, ast.While, ast.AsyncFor)):
            return True
        cur = ctx.parents.get(cur)
    return False


@dataclasses.dataclass
class DeviceFn:
    node: ast.FunctionDef
    kind: str                       # root | wrapper | nested | transitive
    tainted_params: FrozenSet[str]


class ModuleContext:
    """One parsed module plus the derived indices the rules consume.

    ``csrc`` is the C source the ``cuda-kernel-contract`` rule holds the
    module's ctypes calls against; None reads ``csrc/*.cu`` of the
    ``repro_torch`` package the module lies in.
    """

    def __init__(self, source: str, path: str,
                 hot_path: Optional[bool] = None,
                 csrc: Optional[str] = None):
        self.source = source
        self.path = path
        self.csrc = csrc
        self.tree = ast.parse(source)
        self.hot_path = is_hot_path(path) if hot_path is None else hot_path
        self.suppressions = Suppressions.parse(source)
        self.parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
        self.device: Dict[ast.AST, DeviceFn] = {}
        self._taint_cache: Dict[ast.AST, FrozenSet[str]] = {}
        self._build_device_index()
        self.host_fns = self._host_functions()

    # -- device-body index -------------------------------------------------
    def _functions(self) -> List[ast.FunctionDef]:
        return [n for n in ast.walk(self.tree)
                if isinstance(n, _FunctionNode)]

    def qualname(self, fn: ast.AST) -> str:
        names = [fn.name]
        cur = self.parents.get(fn)
        while cur is not None:
            if isinstance(cur, _FunctionNode + (ast.ClassDef,)):
                names.append(cur.name)
            cur = self.parents.get(cur)
        return ".".join(reversed(names))

    def _root_taint(self, fn: ast.FunctionDef) -> Set[str]:
        """Positional parameters not annotated with a host type."""
        a = fn.args
        return {p.arg for p in (a.posonlyargs + a.args)
                if not host_annotation(p.annotation)}

    def _mark(self, fn: ast.FunctionDef, kind: str,
              tainted: Set[str]) -> None:
        if fn not in self.device:
            self.device[fn] = DeviceFn(fn, kind, frozenset(tainted))

    def _build_device_index(self) -> None:
        fns = self._functions()
        # 1) the manifest's roots and the kernel wrappers
        roots = device_body_names(self.path)
        wrappers = wraps_kernels(self.path)
        for fn in fns:
            if self.qualname(fn) in roots:
                self._mark(fn, "root", self._root_taint(fn))
            elif wrappers and fn.name.endswith(KERNEL_WRAPPER_SUFFIX):
                self._mark(fn, "wrapper", self._root_taint(fn))
        # 2) fixpoint: nested defs + same-module transitive callees
        module_fns = {f.name: f for f in self.tree.body
                      if isinstance(f, _FunctionNode)}
        changed = True
        while changed:
            changed = False
            for fn in fns:
                if fn in self.device:
                    continue
                enc = self.enclosing_function(fn)
                if enc is not None and enc in self.device:
                    self._mark(fn, "nested", set())
                    changed = True
            for fn in list(self.device):
                for call in ast.walk(fn):
                    if isinstance(call, ast.Call) and \
                            isinstance(call.func, ast.Name):
                        tgt = module_fns.get(call.func.id)
                        if tgt is not None and tgt not in self.device:
                            # params stay untainted: call sites may pass
                            # host values
                            self._mark(tgt, "transitive", set())
                            changed = True

    def _host_functions(self) -> FrozenSet[str]:
        """Module-level functions annotated to return a host type
        (``_rows_fit(t) -> bool``): their result is a host value whatever
        they are given."""
        return frozenset(f.name for f in self.tree.body
                         if isinstance(f, _FunctionNode)
                         and host_annotation(f.returns))

    def tainted(self, node: ast.AST, taint: FrozenSet[str]) -> bool:
        """``expr_tainted`` with this module's host-valued functions."""
        return expr_tainted(node, taint, self.host_fns)

    # -- queries -----------------------------------------------------------
    def enclosing_function(self, node: ast.AST) -> Optional[ast.FunctionDef]:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, _FunctionNode):
                return cur
            cur = self.parents.get(cur)
        return None

    def device_fn(self, node: ast.AST) -> Optional[DeviceFn]:
        """Innermost device body whose body contains ``node``."""
        fn = node if isinstance(node, _FunctionNode) else \
            self.enclosing_function(node)
        while fn is not None:
            if fn in self.device:
                return self.device[fn]
            fn = self.enclosing_function(fn)
        return None

    def device_root(self, node: ast.AST) -> Optional[ast.FunctionDef]:
        """Outermost device body containing ``node`` (the capture's edge)."""
        root = None
        fn = node if isinstance(node, _FunctionNode) else \
            self.enclosing_function(node)
        while fn is not None:
            if fn in self.device:
                root = fn
            fn = self.enclosing_function(fn)
        return root

    def in_raise(self, node: ast.AST) -> bool:
        """Whether ``node`` is part of a ``raise`` statement (the error
        path, off the hot path)."""
        cur = self.parents.get(node)
        while cur is not None and not isinstance(cur, _FunctionNode):
            if isinstance(cur, ast.Raise):
                return True
            cur = self.parents.get(cur)
        return False

    # -- taint -------------------------------------------------------------
    def tainted_names(self, fn: ast.FunctionDef) -> FrozenSet[str]:
        """Names (likely) bound to device values inside ``fn``'s own body.

        Seeded with the function's tainted params plus taint inherited from
        the enclosing device body (closures see its locals), then
        propagated through assignments and ``for`` targets to a fixpoint.
        """
        cached = self._taint_cache.get(fn)
        if cached is not None:
            return cached
        info = self.device.get(fn)
        taint: Set[str] = set(info.tainted_params) if info else set()
        enc = self.enclosing_function(fn)
        if enc is not None and enc in self.device:
            taint |= self.tainted_names(enc)
        own = [n for n in ast.walk(fn)
               if self.enclosing_function(n) is fn]
        changed = True
        while changed:
            changed = False
            for node in own:
                targets: List[ast.AST] = []
                value: Optional[ast.AST] = None
                if isinstance(node, ast.Assign):
                    targets, value = node.targets, node.value
                elif isinstance(node, (ast.AnnAssign, ast.AugAssign,
                                       ast.NamedExpr)) and node.value:
                    targets, value = [node.target], node.value
                elif isinstance(node, (ast.For, ast.AsyncFor)):
                    targets, value = [node.target], node.iter
                if value is None or not self.tainted(value, frozenset(taint)):
                    continue
                for tgt in targets:
                    for name in ast.walk(tgt):
                        if isinstance(name, ast.Name) and \
                                name.id not in taint:
                            taint.add(name.id)
                            changed = True
        out = frozenset(taint)
        self._taint_cache[fn] = out
        return out

    def taint_at(self, node: ast.AST) -> FrozenSet[str]:
        """The taint set of the device body around ``node`` (empty
        outside device bodies)."""
        fn = self.device_fn(node)
        return self.tainted_names(fn.node) if fn else frozenset()

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        return Finding(rule, self.path, getattr(node, "lineno", 0), message)


def expr_tainted(node: ast.AST, taint: FrozenSet[str],
                 host_fns: FrozenSet[str] = frozenset()) -> bool:
    """Does evaluating ``node`` read a tainted name as a (device) value?

    ``x.shape[0]``, ``x.stride(1)``, ``len(x)``, ``x is None`` read only
    host metadata and do not count, nor does a call of one of ``host_fns``;
    iterating a tuple of tensors in a comprehension reads none of them.
    """
    def rec(n: ast.AST, t: FrozenSet[str]) -> bool:
        return expr_tainted(n, t, host_fns)

    if isinstance(node, ast.Name):
        return node.id in taint
    if isinstance(node, ast.Attribute) and node.attr in STATIC_ATTRS:
        return False
    if isinstance(node, ast.Compare) and \
            all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
        return False
    if isinstance(node, _COMPREHENSIONS):
        inner = set(taint)
        for gen in node.generators:
            if rec(gen.iter, frozenset(inner)):
                inner |= {n.id for n in ast.walk(gen.target)
                          if isinstance(n, ast.Name)}
        inner_f = frozenset(inner)
        elts = [node.key, node.value] if isinstance(node, ast.DictComp) \
            else [node.elt]
        ifs = [c for gen in node.generators for c in gen.ifs]
        return any(rec(e, inner_f) for e in elts + ifs)
    if isinstance(node, ast.Call):
        fname = dotted(node.func)
        if fname in _STATIC_CALLS or fname in host_fns:
            return False
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in STATIC_METHODS:
            return False
        kids: List[ast.AST] = list(node.args) + \
            [kw.value for kw in node.keywords]
        # a method call on a tainted receiver yields a tainted value
        if isinstance(node.func, ast.Attribute):
            kids.append(node.func.value)
        return any(rec(k, taint) for k in kids)
    return any(rec(c, taint) for c in ast.iter_child_nodes(node))


class Rule(abc.ABC):
    """One scopelint-torch rule: a checker plus its self-test corpus.

    ``triggers`` are minimal snippets the rule MUST flag; ``non_triggers``
    are near-identical twins it MUST leave alone.  ``--self-test`` runs
    both sets for every registered rule, so a refactor that silently
    lobotomises a rule fails CI even with a clean tree.  ``corpus_csrc`` is
    the C source the corpus is read against (``ModuleContext.csrc``).
    """
    id: ClassVar[str]
    description: ClassVar[str]
    hot_path_only: ClassVar[bool] = False
    triggers: ClassVar[Tuple[str, ...]] = ()
    non_triggers: ClassVar[Tuple[str, ...]] = ()
    corpus_csrc: ClassVar[Optional[str]] = None

    @abc.abstractmethod
    def check(self, ctx: ModuleContext) -> Iterator[Finding]:
        ...

    def applies(self, ctx: ModuleContext) -> bool:
        return ctx.hot_path or not self.hot_path_only
