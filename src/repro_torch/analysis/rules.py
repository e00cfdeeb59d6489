"""The port's AST lint rules: the JAX package's, read for torch.

Port copy of :mod:`repro.analysis.rules` (the port imports nothing of the
JAX package). Each rule encodes one of the engine's invariants:

  RPR001  no implicit device->host transfer in hot-path files
  RPR003  no torch (or jax) in gauge/sample paths (obs must never force a
          sync)
  RPR004  no wall-clock reads inside jitted or span-measured regions
  RPR006  `# repro: allow[...]` must carry a justification (emitted by
          lint.py itself, listed here for the catalogue)

RPR001 sees torch's transfers as ``sanitize.py`` patches them: ``.item()``,
``.tolist()``, ``.numpy()``, ``.cpu()``, ``.to("cpu")`` (or a ``device=``
of "cpu"), ``np.asarray``, ``float()`` on a non-literal (as the
reference), and ``bool()``, ``int()`` and a truth test (``if``, ``while``,
``and``, ``or``, ``not``, ``assert``) on a tensor expression. A tensor
expression is told apart syntactically: a call of a ``torch.`` function
that makes a tensor, a name bound to a tensor expression in its scope or
an enclosing one (or annotated ``torch.Tensor``), and what indexing,
methods and arithmetic make of one; ``int(n)`` on a host number is left
alone.

Two of the reference's rules have no torch meaning and are not ported:
RPR002 (``_block_step`` fenced by XLA's ``optimization_barrier``, which
pins a compilation context; eager torch compiles nothing) and RPR005
(``jax.jit`` in engine/ audited for donation; the port has no jit, and its
donation is checked at run time by ``sanitize.assert_donated``). An allow
naming either is an unknown rule here (RPR006).

Rules are syntactic by design: they run on every file in milliseconds,
with no imports of the code under analysis. The suppression mechanism
(`# repro: allow[RULE] why...`) is handled by lint.py; rules just report
candidate findings.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass

# File tags (standalone comments anywhere in the file):
#   # repro: hot-path    -- file contains the per-pass sweep hot loop
#   # repro: gauge-path  -- file is an obs gauge/sample path
TAG_HOT_PATH = "hot-path"
TAG_GAUGE_PATH = "gauge-path"

RULES = {
    "RPR001": "implicit device->host transfer in a hot-path file",
    "RPR003": "torch/jax use in a gauge/sample path",
    "RPR004": "wall-clock read inside a jitted or span-measured region",
    "RPR006": "repro: allow[...] without a justification",
}


@dataclass(frozen=True)
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


def _parents(tree: ast.AST) -> dict[ast.AST, ast.AST]:
    par: dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            par[child] = node
    return par


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name of a call target ('torch.cuda.sync' etc.)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


# --------------------------------------------------------------------------
# RPR001 — implicit device->host transfers in hot-path files
# --------------------------------------------------------------------------
# Each of these hands device data to the host, which waits for the device.
# In a hot-path file every such site must be a designed sync point,
# annotated with `# repro: allow[RPR001] <why this sync is intended>`.
_HOST_FNS = ("np.asarray", "numpy.asarray")
_HOST_METHODS = ("item", "tolist", "numpy", "cpu")
# torch.* calls whose result is no tensor
_TORCH_HOST = ("device", "Generator", "dtype", "Size", "is_tensor",
               "is_grad_enabled", "is_floating_point", "get_default_dtype",
               "finfo", "iinfo", "no_grad", "enable_grad", "inference_mode")
# a tensor's attributes and methods whose value lives on the host
_TENSOR_HOST = ("shape", "dtype", "device", "ndim", "numel", "dim", "size",
                "stride", "data_ptr", "is_cuda", "element_size", "nbytes",
                "is_contiguous", "requires_grad") + _HOST_METHODS


def _is_cpu(node: ast.AST) -> bool:
    """The constant "cpu", or torch.device("cpu")."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return (isinstance(node, ast.Call) and _dotted(node.func).endswith("device")
            and bool(node.args) and _is_cpu(node.args[0]))


def _is_tensor(node: ast.AST, names: set[str]) -> bool:
    if isinstance(node, ast.Name):
        return node.id in names
    if isinstance(node, ast.Call):
        dotted = _dotted(node.func)
        if dotted.startswith("torch."):
            return dotted.split(".")[-1] not in _TORCH_HOST
        return (isinstance(node.func, ast.Attribute)
                and node.func.attr not in _TENSOR_HOST
                and _is_tensor(node.func.value, names))
    if isinstance(node, ast.Attribute):
        return node.attr not in _TENSOR_HOST and _is_tensor(node.value, names)
    if isinstance(node, ast.Subscript):
        return _is_tensor(node.value, names)
    if isinstance(node, ast.BinOp):
        return _is_tensor(node.left, names) or _is_tensor(node.right, names)
    if isinstance(node, ast.UnaryOp):
        return _is_tensor(node.operand, names)
    if isinstance(node, ast.Compare):
        return any(_is_tensor(n, names) for n in [node.left, *node.comparators])
    return False


def _bound_names(target: ast.AST) -> list[str]:
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        return [n for t in target.elts for n in _bound_names(t)]
    return []


_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _scope_of(node, parents):
    cur = parents.get(node)
    while cur is not None and not isinstance(cur, (*_SCOPES, ast.Module)):
        cur = parents.get(cur)
    return cur


def tensor_names(tree: ast.AST, parents) -> dict[ast.AST, set[str]]:
    """For each scope (the module and each function), the names visible
    there that are bound to a tensor expression or annotated as a tensor:
    its own, and its enclosing scopes' that its parameters do not shadow.
    Found to a fixed point."""
    own: dict[ast.AST, set[str]] = {tree: set()}
    params: dict[ast.AST, set[str]] = {tree: set()}
    for node in ast.walk(tree):
        if isinstance(node, _SCOPES):
            args = node.args
            every = [*args.posonlyargs, *args.args, *args.kwonlyargs,
                     *filter(None, (args.vararg, args.kwarg))]
            params[node] = {a.arg for a in every}
            own[node] = {a.arg for a in every if a.annotation is not None
                         and _dotted(a.annotation).split(".")[-1] == "Tensor"}

    def visible(scope):
        if scope is tree:
            return own[tree]
        outer = visible(_scope_of(scope, parents)) - params[scope]
        return outer | own[scope]

    while True:
        before = sum(map(len, own.values()))
        for node in ast.walk(tree):
            if not isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                continue
            scope = _scope_of(node, parents)
            names = visible(scope)
            value = node.value
            if value is None:
                continue
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if _is_tensor(value, names):
                    own[scope].update(_bound_names(t))
                elif (isinstance(t, (ast.Tuple, ast.List))
                      and isinstance(value, (ast.Tuple, ast.List))
                      and len(t.elts) == len(value.elts)):
                    for tt, v in zip(t.elts, value.elts):
                        if _is_tensor(v, names):
                            own[scope].update(_bound_names(tt))
        if sum(map(len, own.values())) == before:
            return {scope: visible(scope) for scope in own}


def check_host_transfers(path, tree, lines, tags):
    if TAG_HOT_PATH not in tags:
        return
    parents = _parents(tree)
    scoped = tensor_names(tree, parents)
    for node in ast.walk(tree):
        names = scoped[_scope_of(node, parents)] if node is not tree else ()
        tests = []
        if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
            tests = [node.test]
        elif isinstance(node, ast.BoolOp):
            tests = node.values
        elif isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            tests = [node.operand]
        for t in tests:
            if _is_tensor(t, names):
                yield Finding(path, t.lineno, t.col_offset, "RPR001",
                              "a tensor's truth value forces a host sync")
        if not isinstance(node, ast.Call):
            continue
        dotted = _dotted(node.func)
        if dotted == "float" and node.args:
            if not isinstance(node.args[0], ast.Constant):
                yield Finding(path, node.lineno, node.col_offset, "RPR001",
                              f"{dotted}() on a non-literal forces a host sync")
        elif dotted in ("bool", "int") and node.args:
            if _is_tensor(node.args[0], names):
                yield Finding(path, node.lineno, node.col_offset, "RPR001",
                              f"{dotted}() on a tensor forces a host sync")
        elif dotted in _HOST_FNS:
            yield Finding(path, node.lineno, node.col_offset, "RPR001",
                          f"{dotted}() materialises device data on the host")
        elif (isinstance(node.func, ast.Attribute)
              and node.func.attr in _HOST_METHODS and not node.args):
            yield Finding(path, node.lineno, node.col_offset, "RPR001",
                          f".{node.func.attr}() forces a host sync")
        elif (isinstance(node.func, ast.Attribute) and node.func.attr == "to"
              and (any(_is_cpu(a) for a in node.args)
                   or any(kw.arg == "device" and _is_cpu(kw.value)
                          for kw in node.keywords))):
            yield Finding(path, node.lineno, node.col_offset, "RPR001",
                          '.to("cpu") copies device data to the host')


# --------------------------------------------------------------------------
# RPR003 — no torch (or jax) in gauge/sample paths
# --------------------------------------------------------------------------
# obs gauges sample engine state at scrape time; they must stay pure
# host/stdlib so that observing the engine can never add a device sync.
# Any torch (or jax) import or use in a gauge-path file is a bug.
_ARRAY_ROOTS = ("torch", "jax", "jaxlib")
_ARRAY_NAMES = ("torch", "jax", "jnp")


def check_gauge_path_arrays(path, tree, lines, tags):
    if TAG_GAUGE_PATH not in tags:
        return
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.split(".")[0] in _ARRAY_ROOTS:
                    yield Finding(path, node.lineno, node.col_offset, "RPR003",
                                  f"import {alias.name} in a gauge/sample path")
        elif isinstance(node, ast.ImportFrom):
            if (node.module or "").split(".")[0] in _ARRAY_ROOTS:
                yield Finding(path, node.lineno, node.col_offset, "RPR003",
                              f"from {node.module} import ... in a "
                              "gauge/sample path")
        elif isinstance(node, ast.Name) and node.id in _ARRAY_NAMES:
            yield Finding(path, node.lineno, node.col_offset, "RPR003",
                          f"use of {node.id} in a gauge/sample path")


# --------------------------------------------------------------------------
# RPR004 — wall-clock inside jitted or span-measured regions
# --------------------------------------------------------------------------
# A wall-clock read inside a jitted (or scripted) function burns a
# trace-time constant into it; inside a `with ...span()` block it pollutes
# the span's own measurement. Timing belongs to the tracer, outside
# measured regions.
_CLOCK_FNS = ("time.time", "time.time_ns", "datetime.now", "datetime.utcnow",
              "datetime.datetime.now", "datetime.datetime.utcnow")


def _is_jit_decorated(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> bool:
    for dec in fn.decorator_list:
        for sub in ast.walk(dec):
            if isinstance(sub, ast.Attribute) and sub.attr == "jit":
                return True
            if isinstance(sub, ast.Name) and sub.id == "jit":
                return True
    return False


def _is_span_with(node: ast.AST) -> bool:
    if not isinstance(node, ast.With):
        return False
    for item in node.items:
        expr = item.context_expr
        if isinstance(expr, ast.Call):
            tail = _dotted(expr.func).split(".")[-1]
            if tail == "span":
                return True
    return False


def check_wall_clock(path, tree, lines, tags):
    parents = _parents(tree)
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and _dotted(node.func) in _CLOCK_FNS):
            continue
        cur = parents.get(node)
        region = None
        while cur is not None:
            if _is_span_with(cur):
                region = "a span-measured region"
                break
            if (isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and _is_jit_decorated(cur)):
                region = f"jitted function {cur.name!r}"
                break
            cur = parents.get(cur)
        if region:
            yield Finding(path, node.lineno, node.col_offset, "RPR004",
                          f"wall-clock read inside {region}")


ALL_CHECKS = (
    check_host_transfers,
    check_gauge_path_arrays,
    check_wall_clock,
)
