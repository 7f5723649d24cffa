"""Lightweight intra-package call graph for the analysis rules.

One pass over every parsed module collects:

* every function (including nested defs and lambdas) under a dotted
  qualname like ``repro_torch.core.daysim._row_stage.<locals>.stage``;
* import aliases per module, so ``daysim._step_math`` and
  ``np.asarray`` resolve to canonical dotted names;
* call edges between package functions (best-effort: bare names resolve
  through the enclosing lexical scopes, ``mod.fn`` attributes through
  the import table — dynamic dispatch is out of scope);
* which functions are *traced* (run per call on device tensors by a
  torch transform): bodies handed to ``torch.func.vmap`` / ``grad`` /
  ``grad_and_value`` / ``jacrev`` / ``jacfwd`` / ``functional_call``,
  ``torch.vmap`` and ``torch.utils.checkpoint.checkpoint`` (by
  decorator, ``functools.partial`` decorator, or call-site first
  argument), plus the ``forward`` / ``backward`` of every
  ``torch.autograd.Function`` subclass and the ``forward`` of every
  ``nn.Module`` subclass, each tagged with why.

``reachable_from`` closes a root set over call edges plus containment
(a traced function executes its nested defs), which is how R002 knows
the transitive hot set behind the day pipeline, the model steps and
every transformed body without any per-rule AST walking.
"""
from __future__ import annotations

import ast
import dataclasses

# call-sites / decorators whose function argument becomes a traced body
_TRACERS = {
    "torch.func.vmap": "vmap",
    "torch.vmap": "vmap",
    "torch.func.grad": "grad",
    "torch.func.grad_and_value": "grad",
    "torch.func.jacrev": "grad",
    "torch.func.jacfwd": "grad",
    "torch.func.functional_call": "call",
    "torch.utils.checkpoint.checkpoint": "remat",
}
# suffix fallbacks for aliased spellings (``from torch import func``)
_TRACER_SUFFIXES = {
    "func.vmap": "vmap",
    "func.grad_and_value": "grad",
    "utils.checkpoint.checkpoint": "remat",
}
# the argument of each tracer that is the traced body
_FN_ARG_INDEX = {"vmap": 0, "grad": 0, "call": 0, "remat": 0}
# class bases whose methods run per call on device tensors
_CLASS_TRACERS = {
    "torch.autograd.Function": ("autograd", ("forward", "backward")),
    "torch.nn.Module": ("module", ("forward",)),
}


@dataclasses.dataclass
class FuncInfo:
    qualname: str               # module-dotted, e.g. repro_torch.core.x.f
    module: str
    path: str
    node: ast.AST               # FunctionDef / AsyncFunctionDef / Lambda
    parent: str | None = None   # enclosing function qualname
    traced: set = dataclasses.field(default_factory=set)
    cached: bool = False        # lru_cache/cache decorated

    @property
    def name(self) -> str:
        return self.qualname.rsplit(".", 1)[-1]


def dotted_name(node: ast.AST) -> str | None:
    """`a.b.c` attribute chain as a string, None for anything fancier."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class Module:
    """Per-file symbol tables: alias map + top-level assigned globals."""

    def __init__(self, name: str, path: str, tree: ast.Module):
        self.name = name
        self.path = path
        self.tree = tree
        self.aliases: dict[str, str] = {}   # local name -> dotted target
        self.globals: set[str] = set()      # module-level assigned names
        pkg = name.rsplit(".", 1)[0] if "." in name else ""
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    up = name.split(".")
                    up = up[: len(up) - node.level]
                    base = ".".join(up + ([base] if base else []))
                for a in node.names:
                    if a.name == "*":
                        continue
                    self.aliases[a.asname or a.name] = f"{base}.{a.name}"
        for node in tree.body:
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    self.globals.add(t.id)
                elif isinstance(t, (ast.Tuple, ast.List)):
                    self.globals.update(e.id for e in t.elts
                                        if isinstance(e, ast.Name))

    def resolve(self, dotted: str | None) -> str | None:
        """Canonicalize a dotted name through the import aliases."""
        if not dotted:
            return None
        head, _, rest = dotted.partition(".")
        target = self.aliases.get(head)
        if target is None:
            return dotted
        return f"{target}.{rest}" if rest else target


class CallGraph:
    def __init__(self):
        self.modules: dict[str, Module] = {}
        self.functions: dict[str, FuncInfo] = {}
        self.edges: dict[str, set[str]] = {}
        self.children: dict[str, set[str]] = {}
        # builder qualname -> nested defs it returns (step factories:
        # `def make_x(): def x(...): ...; return x`)
        self.returns: dict[str, set[str]] = {}
        # (module, bare name) -> [qualnames] for cross-module Name lookup
        self._by_name: dict[tuple, list] = {}

    # -- construction ------------------------------------------------------
    def add_module(self, name: str, path: str, tree: ast.Module) -> None:
        mod = Module(name, path, tree)
        self.modules[name] = mod
        _Collector(self, mod).visit(tree)

    def finalize(self) -> None:
        for mod in self.modules.values():
            _EdgeWalker(self, mod).visit(mod.tree)

    def _register(self, info: FuncInfo) -> None:
        self.functions[info.qualname] = info
        self._by_name.setdefault((info.module, info.name), []).append(
            info.qualname)
        if info.parent:
            self.children.setdefault(info.parent, set()).add(info.qualname)

    # -- resolution --------------------------------------------------------
    def resolve_callee(self, mod: Module, scope: str | None,
                       node: ast.AST) -> str | None:
        """Map a call target AST to a known function qualname, if any."""
        if isinstance(node, ast.Name):
            # innermost enclosing scope first, then module top level
            q = scope
            while q:
                cand = f"{q}.<locals>.{node.id}"
                if cand in self.functions:
                    return cand
                q = self.functions[q].parent if q in self.functions else None
            cand = f"{mod.name}.{node.id}"
            if cand in self.functions:
                return cand
            target = mod.aliases.get(node.id)
            if target and target in self.functions:
                return target
            return None
        dotted = dotted_name(node)
        if dotted is None:
            return None
        full = mod.resolve(dotted)
        if full in self.functions:
            return full
        return None

    def tracer_kind(self, mod: Module, node: ast.AST) -> str | None:
        dotted = dotted_name(node)
        if dotted is None:
            return None
        full = mod.resolve(dotted) or dotted
        kind = _TRACERS.get(full)
        if kind:
            return kind
        for suffix, k in _TRACER_SUFFIXES.items():
            if dotted.endswith(suffix) or full.endswith(suffix):
                return k
        return None

    # -- queries -----------------------------------------------------------
    def traced_functions(self, kinds: tuple | None = None) -> set:
        return {q for q, f in self.functions.items()
                if f.traced and (kinds is None or f.traced & set(kinds))}

    def reachable_from(self, roots) -> set:
        """Close the root set over call + containment edges.

        Traversal stops at ``lru_cache``'d functions (unless they are
        roots themselves): a cached builder's body runs once per key,
        not once per trace, so it — and everything it calls — is setup
        work, not part of the per-call hot path."""
        roots = {r for r in roots if r in self.functions}
        seen = set()
        stack = list(roots)
        while stack:
            q = stack.pop()
            if q in seen:
                continue
            if self.functions[q].cached and q not in roots:
                continue
            seen.add(q)
            stack.extend(self.edges.get(q, ()))
            stack.extend(self.children.get(q, ()))
        return seen


_CACHE_DECOS = ("lru_cache", "cache")


class _Collector(ast.NodeVisitor):
    """First pass: register every function/lambda under its qualname.

    Methods keep the reference's qualnames (``module.method``: a class
    adds no scope); the class only decides whether a ``forward`` /
    ``backward`` is a traced body (``_CLASS_TRACERS``)."""

    def __init__(self, graph: CallGraph, mod: Module):
        self.graph = graph
        self.mod = mod
        self.scope: list[str] = []
        # innermost enclosing ClassDef's (kind, traced method names), or
        # None inside a def
        self.owner: list = []

    def visit_ClassDef(self, node):
        traced = None
        for base in node.bases:
            full = self.mod.resolve(dotted_name(base)) or ""
            for cls, spec in _CLASS_TRACERS.items():
                if full == cls or full.endswith("." + cls.split(".", 1)[1]):
                    traced = spec
        self.owner.append(traced or ("", ()))
        self.generic_visit(node)
        self.owner.pop()

    def _qual(self, name: str) -> str:
        if not self.scope:
            return f"{self.mod.name}.{name}"
        return f"{self.scope[-1]}.<locals>.{name}"

    def _handle_def(self, node, name: str):
        qual = self._qual(name)
        info = FuncInfo(qual, self.mod.name, self.mod.path, node,
                        parent=self.scope[-1] if self.scope else None)
        if self.owner and self.owner[-1] is not None:
            kind, methods = self.owner[-1]
            if name in methods:
                info.traced.add(kind)
        for deco in getattr(node, "decorator_list", ()):
            d = deco.func if isinstance(deco, ast.Call) else deco
            dotted = dotted_name(d) or ""
            if dotted.rsplit(".", 1)[-1] in _CACHE_DECOS:
                info.cached = True
            kind = self.graph.tracer_kind(self.mod, d)
            if kind:
                info.traced.add(kind)
            # @functools.partial(torch.func.vmap, ...) decorator form
            if (isinstance(deco, ast.Call)
                    and (dotted_name(deco.func) or "").endswith("partial")
                    and deco.args):
                k2 = self.graph.tracer_kind(self.mod, deco.args[0])
                if k2:
                    info.traced.add(k2)
        self.graph._register(info)
        self.scope.append(qual)
        self.owner.append(None)
        self.generic_visit(node)
        self.owner.pop()
        self.scope.pop()

    def visit_FunctionDef(self, node):
        self._handle_def(node, node.name)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        self._handle_def(node, f"<lambda:{node.lineno}:{node.col_offset}>")

    def visit_Return(self, node):
        # `return train_step` out of a builder: record the closure so a
        # later `torch.func.vmap(make_step(...))` (or the two-step local
        # binding of it) can mark the *returned body* as traced
        if self.scope and isinstance(node.value, ast.Name):
            target = self.graph.resolve_callee(
                self.mod, self.scope[-1], node.value)
            if target is not None:
                self.graph.returns.setdefault(
                    self.scope[-1], set()).add(target)
        self.generic_visit(node)


class _EdgeWalker(ast.NodeVisitor):
    """Second pass: call edges + traced-at-call-site marking."""

    def __init__(self, graph: CallGraph, mod: Module):
        self.graph = graph
        self.mod = mod
        self.scope: list[str] = []
        # (scope, local name) -> builder qualname whose result it holds
        self._builder_result: dict[tuple, str] = {}

    def _enter(self, node, name: str):
        if not self.scope:
            qual = f"{self.mod.name}.{name}"
        else:
            qual = f"{self.scope[-1]}.<locals>.{name}"
        self.scope.append(qual)
        self.generic_visit(node)
        self.scope.pop()

    def visit_FunctionDef(self, node):
        self._enter(node, node.name)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        self._enter(node, f"<lambda:{node.lineno}:{node.col_offset}>")

    def visit_Assign(self, node):
        # `step = make_train_step(...)` — remember which builder the
        # local holds, for a later `torch.func.vmap(step)`
        scope = self.scope[-1] if self.scope else None
        if (len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Call)):
            callee = self.graph.resolve_callee(self.mod, scope,
                                               node.value.func)
            if callee is not None and callee in self.graph.returns:
                self._builder_result[(scope, node.targets[0].id)] = callee
        self.generic_visit(node)

    def _returned_closures(self, scope, fn_arg) -> set:
        """Closures behind a traced arg that isn't itself a known def."""
        builder = None
        if isinstance(fn_arg, ast.Name):
            builder = self._builder_result.get((scope, fn_arg.id))
        elif isinstance(fn_arg, ast.Call):
            cand = self.graph.resolve_callee(self.mod, scope, fn_arg.func)
            if cand in self.graph.returns:
                builder = cand
        return self.graph.returns.get(builder, set()) if builder else set()

    def visit_Call(self, node):
        scope = self.scope[-1] if self.scope else None
        callee = self.graph.resolve_callee(self.mod, scope, node.func)
        if callee and scope:
            self.graph.edges.setdefault(scope, set()).add(callee)
        kind = self.graph.tracer_kind(self.mod, node.func)
        if kind is not None and node.args:
            fn_arg = node.args[_FN_ARG_INDEX[kind]]
            # unwrap functools.partial(fn, ...) around the traced body
            if (isinstance(fn_arg, ast.Call)
                    and (dotted_name(fn_arg.func) or "").endswith("partial")
                    and fn_arg.args):
                fn_arg = fn_arg.args[0]
            targets = set()
            target = self.graph.resolve_callee(self.mod, scope, fn_arg)
            if target is not None:
                targets.add(target)
            else:
                targets |= self._returned_closures(scope, fn_arg)
            for t in targets:
                self.graph.functions[t].traced.add(kind)
                if scope:
                    self.graph.edges.setdefault(scope, set()).add(t)
        self.generic_visit(node)
