"""The six repro_torch rules (R001–R006).

Each rule is a function ``rule(ctx) -> list[Finding]`` registered in
``RULES`` with the contract it guards.  Rules lean on the package call
graph (``ctx.hot``) instead of re-deriving reachability themselves, and
every heuristic is deliberately conservative: an expression the rule
cannot prove problematic is ignored, because a suppression-heavy linter
stops being read.

The port runs eagerly: a function of the hot set runs its Python on
every call, so a host sync there costs a round trip per call, and a
kernel build or a transform built there is rebuilt per call.  The
reference's test that a value can be device data is that it reads a
parameter of the hot function; in eager code it extends to the locals
derived from the parameters by value (``TensorNames``).
"""
from __future__ import annotations

import ast
import bisect
import collections
import re

from .callgraph import dotted_name
from .findings import Finding

RULES: dict[str, "Rule"] = {}


class Rule:
    def __init__(self, rule_id, title, contract, fn):
        self.id = rule_id
        self.title = title
        self.contract = contract
        self.fn = fn

    def run(self, ctx):
        return self.fn(ctx)


def rule(rule_id, title, contract):
    def deco(fn):
        RULES[rule_id] = Rule(rule_id, title, contract, fn)
        return fn
    return deco


# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
_LOOPS = (ast.For, ast.AsyncFor, ast.While)


def own_nodes(fnode):
    """Walk a function body without descending into nested defs."""
    stack = list(ast.iter_child_nodes(fnode))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, _FUNC_NODES):
            stack.extend(ast.iter_child_nodes(node))


def ordered_own_nodes(fnode):
    """Lexical-order variant (for linear dataflow like seed tracking)."""
    out = []

    def rec(node):
        for child in ast.iter_child_nodes(node):
            out.append(child)
            if not isinstance(child, _FUNC_NODES):
                rec(child)

    rec(fnode)
    return out


def param_names(fnode) -> set:
    a = fnode.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return set(names)


def _resolve(fctx, node) -> str | None:
    return fctx.mod.resolve(dotted_name(node))


def _finding(rule_id, fctx, node, message, suggestion=""):
    return Finding(rule_id, fctx.path, node.lineno,
                   getattr(node, "col_offset", 0), message,
                   suggestion=suggestion)


def _enclosing_chain(ctx, info):
    """FuncInfo ancestry, innermost first (including `info`)."""
    chain = []
    q = info.qualname
    while q is not None and q in ctx.graph.functions:
        chain.append(ctx.graph.functions[q])
        q = ctx.graph.functions[q].parent
    return chain


def _in_loop(fctx, node, stop_at_func=True):
    p = fctx.parent_of(node)
    while p is not None:
        if isinstance(p, _LOOPS):
            return True
        if stop_at_func and isinstance(p, _FUNC_NODES):
            return False
        p = fctx.parent_of(p)
    return False


def _chain_cached(ctx, fctx, node):
    """Is this AST site inside an lru_cache'd builder (or a lambda fed
    to a *cache* helper)?"""
    p = node
    while p is not None:
        if isinstance(p, _FUNC_NODES):
            info = ctx.func_of_node(p)
            if info is not None and any(
                    a.cached for a in _enclosing_chain(ctx, info)):
                return True
            if isinstance(p, ast.Lambda):
                gp = fctx.parent_of(p)
                if isinstance(gp, ast.Call):
                    name = dotted_name(gp.func) or ""
                    if "cache" in name.lower():
                        return True
        p = fctx.parent_of(p)
    return False


def _hot_functions(ctx):
    """(FuncInfo, FileCtx) of every function in the hot set."""
    for qual in sorted(ctx.hot):
        info = ctx.graph.functions[qual]
        fctx = ctx.file_of(info)
        if fctx is not None:
            yield info, fctx


def _hot_def(ctx, fctx, node):
    """The FuncInfo of the def enclosing `node` when it is hot."""
    d = ctx.enclosing_function(fctx, node)
    info = ctx.func_of_node(d) if d is not None else None
    return info if info is not None and info.qualname in ctx.hot else None


# ---------------------------------------------------------------------------
# tensor values: what a hot function reads from its parameters
# ---------------------------------------------------------------------------

# attributes and methods of a tensor that read its metadata, not its data
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                 "requires_grad", "is_leaf", "names"}
_STATIC_METHODS = {"size", "dim", "numel", "nelement", "stride",
                   "element_size", "is_contiguous", "is_floating_point",
                   "get_device", "data_ptr"}
_STATIC_CALLS = {"len", "isinstance", "getattr", "hasattr", "type", "id",
                 "callable", "range", "enumerate", "zip", "sorted"}
# parameters that carry no device data: `self`-like names, a host-typed
# annotation (any annotation naming none of _TENSORISH_ANN:
# `plat: PlatformSpec`, `n: int`), or a scalar default (`remat=False`)
_HOST_PARAMS = {"self", "cls", "ctx"}
_TENSORISH_ANN = {"torch.Tensor", "dict", "list", "tuple", "Any",
                  "typing.Any", "object", "typing.Mapping", "typing.Sequence",
                  "collections.abc.Mapping", "collections.abc.Sequence"}
# torch callables that return no tensor
_NON_TENSOR_TORCH = ("torch.device", "torch.dtype", "torch.Generator",
                     "torch.is_", "torch.no_grad", "torch.enable_grad",
                     "torch.inference_mode", "torch.Size", "torch.finfo",
                     "torch.iinfo", "torch.get_", "torch.set_", "torch.cuda.",
                     "torch.backends.", "torch.func.", "torch.utils.",
                     "torch.autograd.", "torch.profiler.", "torch.compiler.",
                     "torch.testing.", "torch.distributed.")
# calls whose result is a host value whatever they read
_HOST_RESULTS = {"float", "int", "bool", "str", "len", "repr", "hash",
                 "isinstance", "callable", "id"}
# tensor methods whose result is a host value (R002 flags the sync)
_TO_HOST_METHODS = {"item", "tolist", "numpy", "cpu"}
# methods of dicts, lists and strings: no device value
_CONTAINER_METHODS = {"get", "items", "keys", "values", "copy", "pop",
                      "setdefault", "update", "append", "extend", "count",
                      "index", "startswith", "endswith", "split", "strip",
                      "lower", "upper", "format", "join", "replace"}


def _chain_top(fctx, node):
    """The outermost Attribute of the attribute chain based at `node`."""
    top = node
    parent = fctx.parent_of(top)
    while isinstance(parent, ast.Attribute) and parent.value is top:
        top = parent
        parent = fctx.parent_of(top)
    return top


def _value_uses(fctx, expr, names):
    """Names of `names` that `expr` reads by value: not through a tensor's
    metadata (``x.shape``, ``x.size()``), a plain field read (``cfg.n``),
    a static call (``len``, ``isinstance``) or an ``is`` comparison."""
    hits = []
    for node in ast.walk(expr):
        if not (isinstance(node, ast.Name) and node.id in names
                and isinstance(node.ctx, ast.Load)):
            continue
        top = _chain_top(fctx, node)
        parent = fctx.parent_of(top)
        if top is not node:
            called = isinstance(parent, ast.Call) and parent.func is top
            if top.attr in _STATIC_ATTRS:
                continue
            if called and top.attr in _STATIC_METHODS:
                continue
            if (called and top.attr == "get" and len(parent.args) == 2
                    and isinstance(parent.args[1], ast.Constant)
                    and isinstance(parent.args[1].value, (int, float))):
                continue                # `d.get(k, 0.0)`: a host number
            if not called and not isinstance(parent, ast.Subscript):
                continue                # a field read: `cfg.n_layers`
        if (isinstance(parent, ast.Call) and parent.func is not top
                and (dotted_name(parent.func) or "") in _STATIC_CALLS):
            continue
        if (isinstance(parent, ast.Compare)
                and all(isinstance(op, (ast.Is, ast.IsNot))
                        for op in parent.ops)):
            continue
        hits.append(node)
    return hits


def _torch_tensor_call(fctx, node) -> bool:
    full = _resolve(fctx, node.func) or ""
    return (full.startswith("torch.")
            and not full.startswith(_NON_TENSOR_TORCH))


def _makes_tensor(fctx, expr) -> bool:
    """Does the expression call a torch function that returns a tensor?"""
    return any(isinstance(node, ast.Call) and _torch_tensor_call(fctx, node)
               for node in ast.walk(expr))


def _host_result(fctx, expr) -> bool:
    """Is the expression's own value a host one (``float(...)``,
    ``np.asarray(...)``, ``x.item()``) whatever it reads?"""
    if isinstance(expr, ast.Constant):
        return True
    if not isinstance(expr, ast.Call):
        return False
    if isinstance(expr.func, ast.Name) and expr.func.id in _HOST_RESULTS:
        return True
    if (isinstance(expr.func, ast.Attribute)
            and expr.func.attr in _TO_HOST_METHODS | _STATIC_METHODS):
        return True
    return (_resolve(fctx, expr.func) or "").startswith("numpy.")


def _bound_names(target) -> set:
    """Names a binding target writes: `a`, `a, (b, *c)`; the base `x` of
    `x[i] = ...` / `x.f = ...` (not the names its index reads)."""
    if isinstance(target, (ast.Tuple, ast.List)):
        return set().union(set(), *map(_bound_names, target.elts))
    if isinstance(target, ast.Starred):
        return _bound_names(target.value)
    while isinstance(target, (ast.Subscript, ast.Attribute)):
        target = target.value
    return {target.id} if isinstance(target, ast.Name) else set()


def _host_param(fctx, arg, default) -> bool:
    if arg.arg in _HOST_PARAMS:
        return True
    ann = arg.annotation
    if ann is not None:
        named = {_resolve(fctx, n) or dotted_name(n) or ""
                 for n in ast.walk(ann)
                 if isinstance(n, (ast.Name, ast.Attribute))}
        named.discard("None")
        if named and not named & _TENSORISH_ANN:
            return True
    return (isinstance(default, ast.Constant)
            and isinstance(default.value, (bool, int, float, str)))


def _end(node) -> tuple:
    return node.end_lineno, node.end_col_offset


_COMPS = (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)


def _binds(fnode):
    """(bound names, value, where it takes effect, in place) of every
    binding in the function's own body, in source order.  An in-place
    binding (`x += v`, `x[i] = v`, `x.f = v`) writes into what `x`
    already holds, so it can make `x` device data but never host data."""
    out = []
    for node in own_nodes(fnode):
        if isinstance(node, ast.Assign):
            out.append((set().union(*map(_bound_names, node.targets)),
                        node.value, _end(node),
                        any(isinstance(t, (ast.Subscript, ast.Attribute))
                            for t in node.targets)))
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign,
                               ast.NamedExpr)) and node.value is not None:
            out.append((_bound_names(node.target), node.value, _end(node),
                        isinstance(node, ast.AugAssign)))
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            out.append((_bound_names(node.target), node.iter,
                        _end(node.iter), False))
        elif isinstance(node, _COMPS):
            # a comprehension's variables are live from its first token
            for gen in node.generators:
                out.append((_bound_names(gen.target), gen.iter,
                            (node.lineno, node.col_offset), False))
        elif isinstance(node, ast.withitem) and node.optional_vars:
            out.append((_bound_names(node.optional_vars), node.context_expr,
                        _end(node.context_expr), False))
    return sorted(out, key=lambda b: b[2])


def _closure(binds, names, test) -> set:
    names = set(names)
    changed = True
    while changed:
        changed = False
        for targets, value, _, _ in binds:
            if not targets <= names and test(value, names):
                names |= targets
                changed = True
    return names


class TensorNames:
    """Names of a function that may hold device data at each point: its
    parameters (less the host-typed ones), then, in source order, each
    local bound by value from them or from a torch call (added) or from
    a host value (dropped) — the reference's "reads a parameter" carried
    through eager dataflow.  One pass: a loop's later bindings do not reach its
    earlier lines.  ``all`` is every name that ever may."""

    def __init__(self, fctx, fnode):
        init = set()
        if not isinstance(fnode, ast.Module):
            a = fnode.args
            pos = a.posonlyargs + a.args
            defaults = [None] * (len(pos) - len(a.defaults)) \
                + list(a.defaults)
            for arg, d in zip(pos + a.kwonlyargs,
                              defaults + list(a.kw_defaults)):
                if not _host_param(fctx, arg, d):
                    init.add(arg.arg)
            for arg in (a.vararg, a.kwarg):
                if arg is not None:
                    init.add(arg.arg)
        self._init = frozenset(init)
        self.all = set(init)
        self._where, self._states = [], []
        state = set(init)
        for targets, value, where, in_place in _binds(fnode):
            tensor = (in_place and bool(targets & state)) or (
                not _host_result(fctx, value)
                and (_value_uses(fctx, value, state)
                     or _makes_tensor(fctx, value)))
            state = state | targets if tensor else state - targets
            if tensor:
                self.all |= targets
            self._where.append(where)
            self._states.append(frozenset(state))

    def at(self, node) -> frozenset:
        if not hasattr(node, "lineno"):
            return self._init
        i = bisect.bisect_right(self._where,
                                (node.lineno, node.col_offset)) - 1
        return self._states[i] if i >= 0 else self._init


def _reads_tensor(fctx, expr, names) -> bool:
    return bool(_value_uses(fctx, expr, names)) or _makes_tensor(fctx, expr)


def _device_value(fctx, expr, names, strict) -> bool:
    """Is the expression's own value a tensor (so that Python's truth test
    of it syncs)?  `strict` are locals bound from such values; `names`
    (``TensorNames.all``) count only as the receiver of a tensor method."""
    if isinstance(expr, ast.Name):
        return expr.id in strict
    if isinstance(expr, ast.Subscript):
        return _device_value(fctx, expr.value, names, strict)
    if isinstance(expr, (ast.BoolOp, ast.BinOp, ast.UnaryOp, ast.Compare)):
        if isinstance(expr, ast.Compare) and any(
                isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                for op in expr.ops):
            return False
        parts = (expr.values if isinstance(expr, ast.BoolOp)
                 else [expr.left, expr.right] if isinstance(expr, ast.BinOp)
                 else [expr.operand] if isinstance(expr, ast.UnaryOp)
                 else [expr.left, *expr.comparators])
        return any(_device_value(fctx, p, names, strict) for p in parts)
    if isinstance(expr, ast.Call):
        if _torch_tensor_call(fctx, expr):
            return True
        f = expr.func
        if (isinstance(f, ast.Attribute)
                and f.attr not in _STATIC_METHODS | _TO_HOST_METHODS
                | _CONTAINER_METHODS
                and not _host_result(fctx, expr)):
            return (_reads_tensor(fctx, f.value, names)
                    or _device_value(fctx, f.value, names, strict))
    return False


def device_values(fctx, fnode, names) -> set:
    """Locals of `fnode` bound from tensor values (``_device_value``)."""
    return _closure(_binds(fnode), set(), lambda v, ns: (
        _device_value(fctx, v, names, ns)))


# ---------------------------------------------------------------------------
# R001 — per-call rebuild hazards
# ---------------------------------------------------------------------------

_UNHASHABLE_DEFAULTS = (ast.List, ast.Dict, ast.Set, ast.ListComp,
                        ast.DictComp, ast.SetComp)
# calls that compile or load a kernel library
_BUILDERS = {
    "ctypes.CDLL": "ctypes.CDLL loads a library",
    "ctypes.cdll.LoadLibrary": "ctypes.cdll.LoadLibrary loads a library",
    "torch.utils.cpp_extension.load": "cpp_extension.load compiles and "
                                      "loads an extension",
    "torch.utils.cpp_extension.load_inline": "cpp_extension.load_inline "
                                             "compiles and loads an "
                                             "extension",
}
# the port's own builders (`kernels/build.py`), by module suffix
_BUILD_SUFFIXES = {
    "kernels.build.build": "build.build compiles a kernel source",
    "kernels.build.build_all": "build.build_all compiles kernel sources",
    "kernels.build.load": "build.load builds and loads a kernel library",
}
_SUBPROCESS = {"subprocess.run", "subprocess.Popen", "subprocess.call",
               "subprocess.check_call", "subprocess.check_output"}
_TRANSFORM_KINDS = ("vmap", "grad")


def _builder_call(fctx, node) -> str | None:
    full = _resolve(fctx, node.func) or ""
    if full in _BUILDERS:
        return _BUILDERS[full]
    for suffix, what in _BUILD_SUFFIXES.items():
        if full == suffix or full.endswith("." + suffix):
            return what
    if full in _SUBPROCESS and any(
            "nvcc" in (n.value if isinstance(n, ast.Constant)
                       and isinstance(n.value, str) else
                       n.id if isinstance(n, ast.Name) else
                       n.attr if isinstance(n, ast.Attribute) else "")
            for a in node.args for n in ast.walk(a)):
        return f"{full.rsplit('.', 1)[-1]} of nvcc compiles a kernel"
    return None


@rule("R001", "per-call rebuild hazards",
      "zero-rebuild warm calls: kernels are built and loaded once (behind "
      "an lru_cache'd builder), torch.func transforms are not rebuilt per "
      "loop step, cached builders' keys hash, and tensor values do not "
      "feed Python control flow in hot functions")
def r001(ctx):
    out = []
    for fctx in ctx.files:
        for node in ast.walk(fctx.tree):
            if not isinstance(node, ast.Call):
                continue
            what = _builder_call(fctx, node)
            if what is not None:
                if _chain_cached(ctx, fctx, node):
                    continue
                if _in_loop(fctx, node):
                    out.append(_finding(
                        "R001", fctx, node,
                        f"{what} inside a loop — every iteration builds "
                        "or loads again; build once behind an "
                        "lru_cache'd builder"))
                elif _hot_def(ctx, fctx, node) is not None:
                    info = _hot_def(ctx, fctx, node)
                    out.append(_finding(
                        "R001", fctx, node,
                        f"{what} reached per call from hot function "
                        f"`{info.name}` — move it behind an lru_cache'd "
                        "builder"))
                continue
            kind = ctx.graph.tracer_kind(fctx.mod, node.func)
            if kind not in _TRANSFORM_KINDS:
                continue
            if _chain_cached(ctx, fctx, node):
                continue
            info = _hot_def(ctx, fctx, node)
            if info is not None and _in_loop(fctx, node):
                out.append(_finding(
                    "R001", fctx, node,
                    f"torch.func.{kind} built inside a loop of hot "
                    f"function `{info.name}` — every step wraps the body "
                    "again; build the transform once, outside the loop"))
        # unhashable defaults on lru_cache'd functions
        for node in ast.walk(fctx.tree):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if any((dotted_name(d.func if isinstance(d, ast.Call) else d)
                    or "").rsplit(".", 1)[-1] in ("lru_cache", "cache")
                   for d in node.decorator_list):
                out.extend(_unhashable_defaults(fctx, node))
    # Python control flow on tensor values, in hot functions
    for info, fctx in _hot_functions(ctx):
        if isinstance(info.node, ast.Lambda):
            continue
        names = TensorNames(fctx, info.node).all
        strict = device_values(fctx, info.node, names)
        for node in own_nodes(info.node):
            if not isinstance(node, (ast.If, ast.While, ast.Assert,
                                     ast.IfExp)):
                continue
            if _device_value(fctx, node.test, names, strict):
                what = ast.unparse(node.test)
                if len(what) > 40:
                    what = what[:37] + "..."
                what = f"`{what}`"
                stmt = {ast.If: "if", ast.While: "while",
                        ast.Assert: "assert", ast.IfExp: "if-expression"}[
                            type(node)]
                out.append(_finding(
                    "R001", fctx, node,
                    f"Python `{stmt}` on the value of {what} in hot "
                    f"function `{info.name}` — data-dependent control "
                    "flow syncs the host on every call; use torch.where "
                    "or keep the decision on the host"))
    return out


def _unhashable_defaults(fctx, fnode):
    out = []
    a = fnode.args
    pos = a.posonlyargs + a.args
    defaults = list(zip([p.arg for p in pos[len(pos) - len(a.defaults):]],
                        a.defaults))
    defaults += [(p.arg, d) for p, d in zip(a.kwonlyargs, a.kw_defaults)
                 if d is not None]
    for name, d in defaults:
        if isinstance(d, _UNHASHABLE_DEFAULTS):
            out.append(_finding(
                "R001", fctx, d,
                f"lru_cache'd `{fnode.name}` argument `{name}` defaults to "
                "an unhashable container — cache keys must hash; use a "
                "tuple/frozen value"))
    return out


# ---------------------------------------------------------------------------
# R002 — host syncs / host side effects inside the device-hot set
# ---------------------------------------------------------------------------

_HOST_CALLS = {
    "numpy.asarray": "numpy.asarray of a tensor copies it to the host",
    "numpy.array": "numpy.array of a tensor copies it to the host",
    "numpy.ascontiguousarray": "numpy.ascontiguousarray of a tensor "
                               "copies it to the host",
}
_HOST_METHODS = {
    "item": ".item() blocks on the device and pulls a scalar",
    "tolist": ".tolist() pulls the whole tensor to the host",
    "cpu": ".cpu() copies to the host and blocks on the device",
    "numpy": ".numpy() reads the tensor on the host",
}
_SCALARIZERS = {"float", "int", "bool", "complex"}
_SYNC_CALLS = {"torch.cuda.synchronize": "torch.cuda.synchronize() blocks "
                                         "the host on the device"}
# ops whose output size depends on the data: torch syncs to size it
_SIZED_BY_DATA = {"nonzero", "argwhere", "unique", "unique_consecutive",
                  "masked_select", "equal", "allclose"}
# tensor makers that copy host data (to `device=` when given)
_HOST_MAKERS = {"torch.tensor", "torch.as_tensor", "torch.asarray",
                "torch.from_numpy"}


def _device_kw(node):
    for k in node.keywords:
        if k.arg == "device":
            return k.value
    return None


def _host_made(fctx, expr, host) -> bool:
    """Is `expr` a tensor (or array) made on the host: a host maker
    without `device=`, a numpy call, or a local bound from one?"""
    if isinstance(expr, ast.Name):
        return expr.id in host
    if not isinstance(expr, ast.Call):
        return False
    full = _resolve(fctx, expr.func) or ""
    return (full.startswith("numpy.")
            or (full in _HOST_MAKERS and _device_kw(expr) is None))


def _to_device(node) -> bool:
    """`.cuda()`, or `.to(x)` / `.to(device=x)` for any x but "cpu" or a
    dtype."""
    if not isinstance(node.func, ast.Attribute):
        return False
    if node.func.attr == "cuda":
        return True
    if node.func.attr != "to" or _to_cpu(node):
        return False
    arg = _device_kw(node) or (node.args[0] if node.args else None)
    if arg is None:
        return False
    full = dotted_name(arg) or ""
    return not (full.startswith(("torch.float", "torch.int", "torch.bool",
                                 "torch.bfloat", "torch.half",
                                 "torch.double", "torch.long"))
                or full.endswith("dtype"))


def _to_cpu(node) -> bool:
    """`.to("cpu")`, `.to(device="cpu")` or `.to(torch.device("cpu"))`."""
    args = list(node.args) + [k.value for k in node.keywords
                              if k.arg == "device"]
    for a in args:
        if isinstance(a, ast.Call) and a.args:
            a = a.args[0]
        if isinstance(a, ast.Constant) and a.value == "cpu":
            return True
    return False


@rule("R002", "host sync in hot path",
      "the day pipeline, the model steps, the optimizer and the fleet "
      "step math stay device-resident: no copies to the host, "
      "scalarizations, synchronizes or host side effects on tensor "
      "values inside functions reachable from the hot roots")
def r002(ctx):
    out = []
    for info, fctx in _hot_functions(ctx):
        values = TensorNames(fctx, info.node)
        host = _closure(_binds(info.node), set(), lambda v, ns: (
            _host_made(fctx, v, ns)))
        for node in own_nodes(info.node):
            names = values.at(node)
            if isinstance(node, ast.Call):
                full = _resolve(fctx, node.func) or ""
                dev_kw = _device_kw(node)
                if (full in _HOST_MAKERS and dev_kw is not None
                        and not (isinstance(dev_kw, ast.Constant)
                                 and dev_kw.value in ("cpu", None))):
                    out.append(_finding(
                        "R002", fctx, node,
                        f"{full}(..., device=) copies host data to the "
                        f"device inside hot function `{info.name}` — a "
                        "copy from pageable memory blocks the host"))
                    continue
                if _to_device(node) and _host_made(fctx, node.func.value,
                                                   host):
                    out.append(_finding(
                        "R002", fctx, node,
                        f"host tensor moved to the device inside hot "
                        f"function `{info.name}` — a copy from pageable "
                        "memory blocks the host"))
                    continue
                leaf = (node.func.attr if isinstance(node.func, ast.Attribute)
                        else "")
                if ((full.startswith("torch.")
                     and full.rsplit(".", 1)[-1] in _SIZED_BY_DATA)
                        or (leaf in _SIZED_BY_DATA
                            and _reads_tensor(fctx, node.func.value, names))
                        or (full == "torch.where" and len(node.args) == 1)):
                    what = full if full.startswith("torch.") else f".{leaf}"
                    out.append(_finding(
                        "R002", fctx, node,
                        f"{what}() sizes its output by the data inside hot "
                        f"function `{info.name}` — torch syncs the host to "
                        "read the size"))
                    continue
                if full in _SYNC_CALLS:
                    out.append(_finding(
                        "R002", fctx, node,
                        f"{_SYNC_CALLS[full]} inside hot function "
                        f"`{info.name}`"))
                    continue
                if (full in _HOST_CALLS
                        and any(_reads_tensor(fctx, a, names)
                                for a in node.args)):
                    out.append(_finding(
                        "R002", fctx, node,
                        f"{_HOST_CALLS[full]} inside hot function "
                        f"`{info.name}` (reachable from a hot root)"))
                    continue
                if (isinstance(node.func, ast.Attribute)
                        and _reads_tensor(fctx, node.func.value, names)):
                    attr = node.func.attr
                    if attr in _HOST_METHODS and not node.args:
                        out.append(_finding(
                            "R002", fctx, node,
                            f"{_HOST_METHODS[attr]} inside hot function "
                            f"`{info.name}`"))
                        continue
                    if attr == "to" and _to_cpu(node):
                        out.append(_finding(
                            "R002", fctx, node,
                            f".to(\"cpu\") copies to the host and blocks "
                            f"on the device inside hot function "
                            f"`{info.name}`"))
                        continue
                if (isinstance(node.func, ast.Name)
                        and node.func.id in _SCALARIZERS
                        and node.args
                        and not isinstance(node.args[0], ast.Constant)
                        and _reads_tensor(fctx, node.args[0], names)):
                    out.append(_finding(
                        "R002", fctx, node,
                        f"{node.func.id}() of a tensor inside hot function "
                        f"`{info.name}` — scalarization is a blocking "
                        "host sync"))
                    continue
                if (isinstance(node.func, ast.Name)
                        and node.func.id == "print"
                        and any(_reads_tensor(fctx, a, names)
                                for a in node.args)):
                    out.append(_finding(
                        "R002", fctx, node,
                        f"print() of a tensor inside hot function "
                        f"`{info.name}` copies it to the host on every "
                        "call"))
                    continue
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets
                           if isinstance(node, ast.Assign)
                           else [node.target])
                value = node.value
                if isinstance(value, ast.UnaryOp):
                    value = value.operand
                if isinstance(node, ast.Assign) and isinstance(
                        value, ast.Constant) and isinstance(
                        value.value, (int, float)) and any(
                        isinstance(t, ast.Subscript)
                        and isinstance(t.value, ast.Name)
                        and t.value.id in names for t in targets):
                    out.append(_finding(
                        "R002", fctx, node,
                        f"a Python scalar written into a tensor inside "
                        f"hot function `{info.name}` — torch copies it "
                        "from the host and blocks; write a device value "
                        "(`x[i] = zero` with zero on the device, or "
                        "`x[i:].zero_()`)"))
                for t in targets:
                    base = t
                    while isinstance(base, (ast.Subscript, ast.Attribute)):
                        base = base.value
                    if (isinstance(base, ast.Name) and base is not t
                            and base.id in fctx.mod.globals):
                        out.append(_finding(
                            "R002", fctx, node,
                            f"mutation of module-level `{base.id}` "
                            f"inside hot function `{info.name}` — host "
                            "state written on every call"))
    return out


# ---------------------------------------------------------------------------
# R003 — RNG discipline
# ---------------------------------------------------------------------------

_NP_RANDOM_EQUIV = {
    "rand": "torch.rand(shape, generator=gen)",
    "random": "torch.rand(shape, generator=gen)",
    "randn": "torch.randn(shape, generator=gen)",
    "standard_normal": "torch.randn(shape, generator=gen)",
    "normal": "torch.randn(shape, generator=gen) * sigma + mu",
    "uniform": "lo + (hi - lo) * torch.rand(shape, generator=gen)",
    "randint": "torch.randint(low, high, shape, generator=gen)",
    "integers": "torch.randint(low, high, shape, generator=gen)",
    "choice": "torch.multinomial(p, n, generator=gen)",
    "permutation": "torch.randperm(n, generator=gen)",
    "shuffle": "x[torch.randperm(len(x), generator=gen)]",
    "seed": "draw on an explicit CPU generator: "
            "gen = torch.Generator().manual_seed(seed)",
    "RandomState": "draw on an explicit CPU generator: "
                   "gen = torch.Generator().manual_seed(seed)",
    "default_rng": "draw on an explicit CPU generator: "
                   "gen = torch.Generator().manual_seed(seed)",
}
# torch samplers that draw from the global generator unless given one
_TORCH_SAMPLERS = {"rand", "rand_like", "randn", "randn_like", "randint",
                   "randint_like", "randperm", "normal", "bernoulli",
                   "multinomial", "poisson"}
# in-place samplers of a tensor (and torch.nn.init's)
_INPLACE_SAMPLERS = {"uniform_", "normal_", "bernoulli_", "exponential_",
                     "random_", "geometric_", "log_normal_", "cauchy_",
                     "trunc_normal_"}
_GLOBAL_SEEDS = {"torch.manual_seed", "torch.seed", "torch.cuda.manual_seed",
                 "torch.cuda.manual_seed_all", "torch.cuda.seed",
                 "torch.cuda.seed_all", "torch.random.manual_seed"}


def _has_generator(node) -> bool:
    return any(k.arg == "generator" for k in node.keywords)


def _cuda_generator(node) -> bool:
    args = list(node.args[:1]) + [k.value for k in node.keywords
                                  if k.arg == "device"]
    for a in args:
        if isinstance(a, ast.Call) and a.args:
            a = a.args[0]
        if (isinstance(a, ast.Constant) and isinstance(a.value, str)
                and a.value.startswith("cuda")):
            return True
    return False


@rule("R003", "RNG discipline",
      "explicit-generator sampling: every draw goes through an explicit "
      "CPU torch.Generator (nn/core.host_generator) — no numpy or global "
      "RNG state, no CUDA generator, no constant seed re-used per step")
def r003(ctx):
    out = []
    for fctx in ctx.files:
        for node in ast.walk(fctx.tree):
            if isinstance(node, ast.Attribute):
                full = fctx.mod.resolve(dotted_name(node)) or ""
                if full.startswith("numpy.random."):
                    leaf = full.rsplit(".", 1)[-1]
                    # only flag the outermost np.random attribute chain;
                    # Generator/BitGenerator/SeedSequence leaves are type
                    # names (annotations), not RNG state consumption
                    parent = fctx.parent_of(node)
                    if (isinstance(parent, ast.Attribute)
                            or leaf in ("SeedSequence", "Generator",
                                        "BitGenerator")):
                        continue
                    sug = _NP_RANDOM_EQUIV.get(
                        leaf, "draw with torch on an explicit CPU "
                        "generator")
                    out.append(_finding(
                        "R003", fctx, node,
                        f"np.random.{leaf} — numpy RNG state sits outside "
                        "the port's explicit-generator contract",
                        suggestion=sug))
                continue
            if not isinstance(node, ast.Call):
                continue
            full = _resolve(fctx, node.func) or ""
            leaf = full.rsplit(".", 1)[-1]
            if full in _GLOBAL_SEEDS:
                out.append(_finding(
                    "R003", fctx, node,
                    f"{full}() seeds global RNG state — every later "
                    "global draw depends on call order",
                    suggestion="gen = torch.Generator().manual_seed(seed) "
                    "and pass generator=gen"))
            elif (full.startswith("torch.") and full.count(".") == 1
                  and leaf in _TORCH_SAMPLERS and not _has_generator(node)):
                out.append(_finding(
                    "R003", fctx, node,
                    f"torch.{leaf} without generator= draws from the "
                    "global generator",
                    suggestion=f"torch.{leaf}(..., generator=gen) with "
                    "gen = nn.core.host_generator(...)"))
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr in _INPLACE_SAMPLERS
                  and not _has_generator(node)):
                out.append(_finding(
                    "R003", fctx, node,
                    f".{node.func.attr}() without generator= draws from "
                    "the global generator",
                    suggestion=f".{node.func.attr}(..., generator=gen)"))
            elif full == "torch.Generator" and _cuda_generator(node):
                out.append(_finding(
                    "R003", fctx, node,
                    "torch.Generator on a CUDA device — the same seed "
                    "draws other values than on the CPU",
                    suggestion="draw on torch.Generator() (CPU) and move "
                    "the result: nn.core.host_generator"))
        for info in ctx.functions_in(fctx):
            out.extend(_seed_dataflow(fctx, info))
    return out


def _seed_of(node):
    """(generator expression dump, constant) of `<gen>.manual_seed(C)`."""
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "manual_seed" and len(node.args) == 1
            and isinstance(node.args[0], ast.Constant)):
        return ast.dump(node.func.value), node.args[0].value
    return None


def _seed_dataflow(fctx, info):
    out = []
    seen = collections.Counter()
    for node in ordered_own_nodes(info.node):
        seed = _seed_of(node)
        if seed is None:
            continue
        gen, value = seed
        if _in_loop(fctx, node):
            out.append(_finding(
                "R003", fctx, node,
                f"generator seeded with the constant {value!r} inside a "
                "loop — every iteration draws identical values",
                suggestion="seed once outside the loop, or fold the step "
                f"in: manual_seed(hash(({value!r}, step)))"))
        named = isinstance(node.func.value, ast.Name)
        if named:
            seen[seed] += 1
            if seen[seed] > 1:
                out.append(_finding(
                    "R003", fctx, node,
                    f"generator `{node.func.value.id}` re-seeded to "
                    f"{value!r} again — the draws after it repeat the "
                    "earlier ones (correlated samples)",
                    suggestion="keep drawing from the one generator, or "
                    "seed a second generator with another seed"))
    return out


# ---------------------------------------------------------------------------
# R004 — unit-suffix dimensional analysis
# ---------------------------------------------------------------------------

_UNIT_TOKENS = {"mw", "kw", "mwh", "kwh", "h", "s", "ms", "c", "mbps",
                "pods", "usd", "hz", "kgco2"}
_UNIT_ALIASES = {"hour": "h", "hours": "h", "sec": "s", "secs": "s"}
_DECOMPOSE = {"mwh": ("mw", "h"), "kwh": ("kw", "h")}


def _base_counter(token):
    c = collections.Counter()
    for t in _DECOMPOSE.get(token, (token,)):
        c[t] += 1
    return c


def _u_combine(a, b, sign):
    """Signed unit algebra.  Counter's own ``+``/``-`` drop non-positive
    counts, which silently erases denominator units (``mw/mbps`` would
    collapse to ``mw``); this keeps negative exponents and only drops
    exact zeros."""
    c = collections.Counter(a)
    for t, n in b.items():
        c[t] += sign * n
    for t in [t for t, n in c.items() if n == 0]:
        del c[t]
    return c


def parse_unit(ident: str):
    """Unit Counter for an identifier, None if it carries no unit.

    ``usd_per_kwh``-style names divide; the final ``_``-token otherwise
    decides (``bin_hours`` -> h).  Returns the string ``"ambiguous"``
    for names like ``pods_s`` where the trailing ``s`` reads as seconds
    but the stem is itself a unit (pluralization collision).
    """
    ident = ident.lower()
    if "_per_" in ident:
        left, _, right = ident.rpartition("_per_")
        lu = parse_unit(left)
        ru = parse_unit(right.split("_")[0])
        if (isinstance(lu, collections.Counter)
                and isinstance(ru, collections.Counter)):
            return _u_combine(lu, ru, -1)
        return None
    tokens = ident.split("_")
    last = _UNIT_ALIASES.get(tokens[-1], tokens[-1])
    if last not in _UNIT_TOKENS:
        return None
    # a bare one/two-letter identifier ("h", "s", "c", "kw") is far more
    # often a loop variable / kwargs dict than a unit — require a stem
    if len(tokens) == 1 and last in ("h", "s", "c", "kw", "ms"):
        return None
    if (last == "s" and len(tokens) >= 2
            and _UNIT_ALIASES.get(tokens[-2], tokens[-2]) in _UNIT_TOKENS):
        return "ambiguous"
    return _base_counter(last)


def _unit_str(c: collections.Counter) -> str:
    num = "*".join(sorted(t for t, n in c.items() for _ in range(n)
                          if n > 0)) or "1"
    den = "*".join(sorted(t for t, n in c.items() for _ in range(-n)
                          if n < 0))
    return f"{num}/{den}" if den else num


def _expr_unit(node):
    """Counter, None (unknown), or "ambiguous". Literals launder units
    (they are how conversions are written), so any constant factor
    makes the whole product unknown."""
    if isinstance(node, ast.Name):
        return parse_unit(node.id)
    if isinstance(node, ast.Attribute):
        return parse_unit(node.attr)
    if isinstance(node, ast.Subscript):
        if (isinstance(node.slice, ast.Constant)
                and isinstance(node.slice.value, str)):
            return parse_unit(node.slice.value)
        return _expr_unit(node.value)       # x_mwh[i] keeps x's unit
    if isinstance(node, ast.UnaryOp):
        return _expr_unit(node.operand)
    if isinstance(node, ast.BinOp):
        lu, ru = _expr_unit(node.left), _expr_unit(node.right)
        if "ambiguous" in (lu, ru):
            return None
        if isinstance(node.op, ast.Mult):
            if lu is None or ru is None:
                return None
            return _u_combine(lu, ru, 1)
        if isinstance(node.op, ast.Div):
            if lu is None or ru is None:
                return None
            return _u_combine(lu, ru, -1)
        if isinstance(node.op, (ast.Add, ast.Sub)):
            # the +/- check itself happens in r004; propagate left
            return lu if lu is not None else ru
        return None
    return None


def _counters(*units):
    return all(isinstance(u, collections.Counter) for u in units)


_R004_SUGGEST = {
    frozenset(("h", "s")): "convert explicitly (`x_s / 3600.0` or "
                           "`x_h * 3600.0`) and name the result's unit",
    frozenset(("mw", "mwh")): "integrate or differentiate over time "
                              "first: `p_mw * dt_h -> e_mwh`",
    frozenset(("kw", "mw")): "rescale explicitly (`x_kw * 1e3 -> x_mw`)",
    frozenset(("kwh", "mwh")): "rescale explicitly "
                               "(`x_kwh * 1e3 -> x_mwh`)",
}


def _suggest(lu, ru):
    key = frozenset(_unit_str(lu).split("*") + _unit_str(ru).split("*"))
    for pair, s in _R004_SUGGEST.items():
        if pair <= key:
            return s
    return "align the units explicitly before combining, or rename " \
           "the identifier to its true unit"


@rule("R004", "unit-suffix mixing",
      "the _mw/_mwh/_h/_s/_c/_mbps/_pods naming convention is "
      "load-bearing: adding, subtracting, or comparing identifiers "
      "with incompatible unit suffixes is a power-accounting bug")
def r004(ctx):
    out = []
    for fctx in ctx.files:
        for node in ast.walk(fctx.tree):
            if isinstance(node, ast.BinOp) and isinstance(
                    node.op, (ast.Add, ast.Sub)):
                lu, ru = _expr_unit(node.left), _expr_unit(node.right)
                if _counters(lu, ru) and lu != ru:
                    out.append(_finding(
                        "R004", fctx, node,
                        f"`{_unit_str(lu)}` {'+' if isinstance(node.op, ast.Add) else '-'} "
                        f"`{_unit_str(ru)}` mixes incompatible units",
                        suggestion=_suggest(lu, ru)))
            elif isinstance(node, ast.Compare):
                lu = _expr_unit(node.left)
                for comp in node.comparators:
                    ru = _expr_unit(comp)
                    if _counters(lu, ru) and lu != ru:
                        out.append(_finding(
                            "R004", fctx, node,
                            f"comparison between `{_unit_str(lu)}` and "
                            f"`{_unit_str(ru)}` — incompatible units",
                            suggestion=_suggest(lu, ru)))
            elif isinstance(node, ast.Assign):
                if (len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)):
                    tu = parse_unit(node.targets[0].id)
                    vu = _expr_unit(node.value)
                    if _counters(tu, vu) and tu != vu:
                        out.append(_finding(
                            "R004", fctx, node,
                            f"`{node.targets[0].id}` declares "
                            f"`{_unit_str(tu)}` but the right-hand side "
                            f"derives `{_unit_str(vu)}`",
                            suggestion=_suggest(tu, vu)))
            # ambiguous unit names at definition sites
            amb = None
            if (isinstance(node, ast.Name)
                    and isinstance(node.ctx, ast.Store)
                    and parse_unit(node.id) == "ambiguous"):
                amb = node.id
            elif isinstance(node, ast.arg) and \
                    parse_unit(node.arg) == "ambiguous":
                amb = node.arg
            elif (isinstance(node, ast.Dict)):
                for k in node.keys:
                    if (isinstance(k, ast.Constant)
                            and isinstance(k.value, str)
                            and parse_unit(k.value) == "ambiguous"):
                        out.append(_finding(
                            "R004", fctx, k,
                            f"`{k.value}` reads as "
                            f"{k.value.rsplit('_', 1)[0]}-seconds under "
                            "the suffix convention — ambiguous "
                            "pluralization",
                            suggestion="rename (e.g. "
                            f"`{k.value.rsplit('_', 1)[0]}_stream`) or "
                            "spell the unit out"))
            if amb is not None:
                out.append(_finding(
                    "R004", fctx, node,
                    f"`{amb}` reads as {amb.rsplit('_', 1)[0]}-seconds "
                    "under the suffix convention — ambiguous "
                    "pluralization",
                    suggestion=f"rename (e.g. "
                    f"`{amb.rsplit('_', 1)[0]}_stream`) or spell the "
                    "unit out"))
    return out


# ---------------------------------------------------------------------------
# R005 — cache-key hygiene
# ---------------------------------------------------------------------------

_CACHE_NAME_RE = re.compile(r"CACHE|PIPELINES|ASSEMBLIES|TABLES|CTX_IDS")
_ARRAY_MAKERS = {"numpy.asarray", "numpy.array", "torch.tensor",
                 "torch.as_tensor", "torch.from_numpy", "torch.asarray"}
_UNHASHABLE_ANN = {"list", "dict", "set", "bytearray",
                   "numpy.ndarray", "torch.Tensor"}


def _key_expr_problems(fctx, expr):
    problems = []
    wrapped = set()
    for node in ast.walk(expr):
        if (isinstance(node, ast.Call)
                and (dotted_name(node.func) or "").rsplit(".", 1)[-1]
                in ("tuple", "frozenset")):
            wrapped.update(ast.walk(node))
    for node in ast.walk(expr):
        if node in wrapped:
            continue
        if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                             ast.DictComp, ast.SetComp)):
            problems.append((node, "unhashable container in cache key"))
        elif isinstance(node, ast.Call):
            full = _resolve(fctx, node.func) or ""
            if full in _ARRAY_MAKERS:
                problems.append((
                    node, "tensor-valued cache-key component — tensors "
                    "hash by identity and carry values"))
            elif full == "id" or (isinstance(node.func, ast.Name)
                                  and node.func.id == "id"):
                problems.append((
                    node, "id()-keyed cache entry — object identity "
                    "outlives the object; key by value instead"))
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr == "data_ptr"):
                problems.append((
                    node, "data_ptr()-keyed cache entry — a freed "
                    "tensor's address is reused by the next allocation; "
                    "key by value instead"))
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr == "tobytes"):
                problems.append((
                    node, "raw array bytes as cache key — value-"
                    "carrying buffer; key by the static signature "
                    "(shape, dtype) instead"))
    return problems


@rule("R005", "cache-key hygiene",
      "_ROW_CACHE/_PIPELINES/_ASSEMBLIES/lru_cache keys must be hashable, "
      "value-stable, and free of tensor payloads — a bad key either "
      "crashes, leaks, or silently aliases distinct pipelines")
def r005(ctx):
    out = []
    for fctx in ctx.files:
        # local single-assignment map per function, for key = (...) sites
        assigns: dict[tuple, ast.AST] = {}
        for fnode in ast.walk(fctx.tree):
            if not isinstance(fnode, _FUNC_NODES + (ast.Module,)):
                continue
            for node in (own_nodes(fnode)
                         if not isinstance(fnode, ast.Module)
                         else ast.iter_child_nodes(fnode)):
                if (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)):
                    assigns[(id(fnode), node.targets[0].id)] = node.value

        for node in ast.walk(fctx.tree):
            key = None
            if (isinstance(node, ast.Subscript)
                    and isinstance(node.value, ast.Name)
                    and _CACHE_NAME_RE.search(node.value.id)
                    and node.value.id in fctx.mod.globals):
                key = node.slice
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Attribute)
                  and node.func.attr in ("get", "setdefault", "pop")
                  and isinstance(node.func.value, ast.Name)
                  and _CACHE_NAME_RE.search(node.func.value.id)
                  and node.func.value.id in fctx.mod.globals
                  and node.args):
                key = node.args[0]
            if key is None:
                continue
            exprs = [key]
            if isinstance(key, ast.Name):
                owner = fctx.enclosing_def(node)
                bound = assigns.get((id(owner), key.id))
                exprs = [bound] if bound is not None else []
            for expr in exprs:
                for bad, msg in _key_expr_problems(fctx, expr):
                    out.append(_finding("R005", fctx, bad, msg))
        # lru_cache'd functions with unhashable-annotated params
        for fnode in ast.walk(fctx.tree):
            if not isinstance(fnode, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                continue
            cached = any(
                (dotted_name(d.func if isinstance(d, ast.Call) else d)
                 or "").rsplit(".", 1)[-1] in ("lru_cache", "cache")
                for d in fnode.decorator_list)
            if not cached:
                continue
            for p in (fnode.args.posonlyargs + fnode.args.args
                      + fnode.args.kwonlyargs):
                ann = p.annotation
                if ann is None:
                    continue
                base = ann.value if isinstance(ann, ast.Subscript) else ann
                name = _resolve(fctx, base) or dotted_name(base) or ""
                if name in _UNHASHABLE_ANN:
                    out.append(_finding(
                        "R005", fctx, p,
                        f"lru_cache'd `{fnode.name}` takes "
                        f"`{p.arg}: {name}` — unhashable (or value-"
                        "carrying) cache key; pass a hashable "
                        "signature instead"))
    return out


# ---------------------------------------------------------------------------
# R006 — per-step allocation and dtype drift
# ---------------------------------------------------------------------------

_STEP_ALLOCATORS = {"torch.cat", "torch.concat", "torch.concatenate",
                    "torch.stack", "torch.hstack", "torch.vstack"}
_F64_NAMES = {"torch.float64", "torch.double", "numpy.float64"}


@rule("R006", "per-step allocation / dtype drift",
      "a Python loop in a hot function runs once per step: growing a "
      "tensor by cat/stack or a list of tensors per step allocates every "
      "step (O(T^2) for a growing carry), and any float64 reference "
      "doubles bandwidth and leaves the float32 contract")
def r006(ctx):
    out = []
    for info, fctx in _hot_functions(ctx):
        values = TensorNames(fctx, info.node)
        for node in own_nodes(info.node):
            names = values.at(node)
            if isinstance(node, ast.Call) and _in_loop(fctx, node):
                full = _resolve(fctx, node.func) or ""
                if full in _STEP_ALLOCATORS:
                    out.append(_finding(
                        "R006", fctx, node,
                        f"{full.rsplit('.', 1)[-1]} inside a per-step loop "
                        f"of hot function `{info.name}` allocates every "
                        "step — write into a pre-sized buffer or stack "
                        "once after the loop"))
                    continue
                if (isinstance(node.func, ast.Attribute)
                        and node.func.attr == "append"
                        and isinstance(node.func.value, (ast.Name,
                                                         ast.Subscript))
                        and node.args
                        and _reads_tensor(fctx, node.args[0], names)):
                    out.append(_finding(
                        "R006", fctx, node,
                        f"list append of a tensor inside a per-step loop "
                        f"of hot function `{info.name}` — one allocation "
                        "and one kernel chain per step; pre-size the "
                        "output"))
                    continue
            full = None
            if isinstance(node, ast.Attribute):
                full = _resolve(fctx, node)
            if full in _F64_NAMES:
                out.append(_finding(
                    "R006", fctx, node,
                    f"float64 reference inside hot function "
                    f"`{info.name}` — the device pipeline is float32; "
                    "float64 doubles bandwidth and runs at a fraction of "
                    "the float32 rate"))
            elif (isinstance(node, ast.Call)
                  and isinstance(node.func, ast.Attribute)
                  and node.func.attr == "double" and not node.args):
                out.append(_finding(
                    "R006", fctx, node,
                    f".double() inside hot function `{info.name}` — "
                    "float32 contract"))
            elif (isinstance(node, ast.keyword) and node.arg == "dtype"
                  and isinstance(node.value, ast.Constant)
                  and node.value.value == "float64"):
                out.append(_finding(
                    "R006", fctx, node.value,
                    f"dtype=\"float64\" inside hot function "
                    f"`{info.name}` — float32 contract"))
    return out
