"""jit-purity: no host impurity lexically inside a captured CUDA graph.

The port's compiled region is the captured CUDA graph, not a traced jit
body, but the leak is the same one: capture runs the program once and
bakes what it read into every replay. An `os.environ` / `time.*` /
`np.random` call inside a captured body executes once, at capture, so
the knob read or timestamp silently stops responding; `.item()` is a
device sync, which fails during capture (and its host value would be
baked in if it did not); `global` mutation from a captured body runs once
per capture, not once per replay.

What counts as a captured body:

* the callable passed to `capture_graph(...)` (serving/engine.py), as a
  lambda or by name — a `def` nested in the calling function first (the
  engine's bucket programs define `program` inside `__init__`), else a
  function of the same module;
* the body of `with torch.cuda.graph(...)`;
* everything lexically nested inside those bodies (inner `def`s run at
  capture too);
* plus functions defined in the same module and called by plain name
  from a captured body — one call deep, which is how a scoring helper
  gets pulled into the captured region.

Flagged inside those regions: `os.environ` / `os.getenv`, `time.*()`
calls, `np.random` / `numpy.random`, `.item()`, and `global`
statements.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from photon_ml_tpu_torch.analysis.core import (
    CHECKS,
    Context,
    Finding,
    SourceFile,
    dotted_name,
    register_check,
    terminal_name,
)

NAME = "jit-purity"

_CAPTURE_CALLS = {"capture_graph"}
_GRAPH_CONTEXTS = {"torch.cuda.graph", "cuda.graph"}

_IMPURE_DOTTED = {
    "os.environ": "reads os.environ (read once at capture, baked into "
    "every replay)",
    "np.random": "uses np.random (host RNG state, drawn once at capture)",
    "numpy.random": "uses numpy.random (host RNG state, drawn once at "
    "capture)",
}

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)


def is_graph_context(item: ast.withitem) -> bool:
    """`with torch.cuda.graph(...)` — the context manager that captures."""
    expr = item.context_expr
    return isinstance(expr, ast.Call) and dotted_name(expr.func) in _GRAPH_CONTEXTS


def _impurities(body: ast.AST) -> List[tuple]:
    """Impure nodes lexically inside `body` (inner defs included)."""
    out = []
    for node in ast.walk(body):
        if isinstance(node, ast.Attribute):
            # Exact chains only: `os.environ.get` also contains an inner
            # `os.environ` attribute node, which is the one reported.
            dn = dotted_name(node)
            if dn in _IMPURE_DOTTED:
                out.append((node, _IMPURE_DOTTED[dn]))
            elif dn == "os.getenv":
                out.append(
                    (node, "reads the environment via os.getenv (read once "
                     "at capture, baked into every replay)")
                )
        elif isinstance(node, ast.Call):
            func = node.func
            if (
                isinstance(func, ast.Attribute)
                and isinstance(func.value, ast.Name)
                and func.value.id == "time"
            ):
                out.append(
                    (node, f"calls time.{func.attr}() (host clock, read once at capture)")
                )
            elif (
                isinstance(func, ast.Attribute)
                and func.attr == "item"
                and not node.args
                and not node.keywords
            ):
                out.append(
                    (node, "calls .item() (a device sync, which fails during "
                     "capture)")
                )
        elif isinstance(node, ast.Global):
            out.append(
                (node, "declares `global` (mutation runs once at capture, "
                 "not once per replay)")
            )
    return out


def _module_defs(f: SourceFile) -> Dict[str, ast.AST]:
    return {n.name: n for n in ast.walk(f.tree) if isinstance(n, _FUNCS)}


def _enclosing_funcs(tree: ast.Module) -> Dict[int, ast.AST]:
    """id(node) -> the innermost function whose body holds it."""
    out: Dict[int, ast.AST] = {}

    def visit(node: ast.AST, fn: Optional[ast.AST]) -> None:
        for child in ast.iter_child_nodes(node):
            if fn is not None:
                out[id(child)] = fn
            visit(child, child if isinstance(child, _FUNCS) else fn)

    visit(tree, None)
    return out


def _resolve(name: str, caller: Optional[ast.AST], defs: Dict[str, ast.AST]) -> Optional[ast.AST]:
    """The function a name passed to capture_graph means: a def of that
    name nested in the calling function, else the module's."""
    if caller is not None:
        for n in ast.walk(caller):
            if isinstance(n, _FUNCS) and n is not caller and n.name == name:
                return n
    return defs.get(name)


def _called_names(body: ast.AST) -> Set[str]:
    return {
        n.func.id
        for n in ast.walk(body)
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
    }


def _label(region: ast.AST) -> str:
    if isinstance(region, ast.Module):  # a `with torch.cuda.graph` body
        return "with torch.cuda.graph(...)"
    return getattr(region, "name", "<lambda>")


@register_check(
    NAME,
    "no os.environ/time.*/np.random/.item()/global mutation inside "
    "a captured CUDA graph (the callable passed to capture_graph, a "
    "`with torch.cuda.graph` body), or in same-module helpers one call "
    "deep",
)
def check(ctx: Context) -> List[Finding]:
    findings: List[Finding] = []
    for f in ctx.in_scope(CHECKS[NAME]):
        if "capture_graph" not in f.text and "graph(" not in f.text:
            continue
        defs = _module_defs(f)
        enclosing = _enclosing_funcs(f.tree)
        roots: List[ast.AST] = []
        for node in ast.walk(f.tree):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                if any(is_graph_context(i) for i in node.items):
                    roots.append(ast.Module(body=node.body, type_ignores=[]))
            elif (
                isinstance(node, ast.Call)
                and terminal_name(node.func) in _CAPTURE_CALLS
                and node.args
            ):
                arg = node.args[0]
                if isinstance(arg, ast.Lambda):
                    roots.append(arg)
                elif isinstance(arg, ast.Name):
                    target = _resolve(arg.id, enclosing.get(id(node)), defs)
                    if target is not None:
                        roots.append(target)
        scanned: Set[int] = set()
        regions: List[tuple] = []  # (node, via) — via labels the hop
        for r in roots:
            if id(r) not in scanned:
                scanned.add(id(r))
                regions.append((r, None))
        for r in list(regions):
            for name in sorted(_called_names(r[0])):
                callee = defs.get(name)
                if callee is not None and id(callee) not in scanned:
                    scanned.add(id(callee))
                    regions.append((callee, _label(r[0])))
        for body, via in regions:
            for node, why in _impurities(body):
                suffix = (
                    f" — reachable one call deep from the captured body "
                    f"of {via!r}"
                    if via
                    else ""
                )
                findings.append(
                    Finding(NAME, f.rel, node.lineno, why + suffix)
                )
    return findings
