"""donation-aliasing: a graph's output is dead across the next replay.

The port has no `donate_argnums`; its counterpart is the captured CUDA
graph's static output. Every replay of a graph writes its result into the
same output tensor, so a name that holds that output (or a view of it) is
overwritten by the next replay just as a donated buffer is dead after the
donating call. Holding it across a replay reads the later replay's
answer under the earlier one's name — `results.append(out)` in a replay
loop keeps N references to one tensor — and on the CPU, where the port
runs the program eagerly, every call returns a fresh tensor, so the bug
ships silently through the test platform and fires on the card.

Rule: within one function, a name bound to a graph's output before a
`.replay()` of that graph is not read after the replay, until it is bound
again, except to copy out of it (`name.clone()`, `.cpu()`, `.to(...)`,
`.tolist()`, `.item()`, or `dst.copy_(name)`: the copy takes the
replay's answer and keeps no reference). The names that hold a
graph's output are

* the output target of `graph, out = capture_graph(...)`, and any name
  assigned inside a `with torch.cuda.graph(g):` body (the output of `g`)
  — tracked by dotted name across the file, since an engine builds
  `self.graph, self.out` in `__init__` and replays in another method;
* a name bound in the function to the output itself or a view of it: a
  subscript, attribute or non-copying method chain rooted at the output
  (`res = self.out[0]`, `v = out.view(-1)`); `.clone()`, `.cpu()`,
  `.to(...)`, `.tolist()` and `.item()` copy and end the alias.

The good form reads the output where it is not bound — in the method that
replays, right after the replay, copying it out
(`graph.replay(); host_out.copy_(self.out)`, serving/engine.py).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from photon_ml_tpu_torch.analysis.core import (
    CHECKS,
    Context,
    Finding,
    dotted_name,
    register_check,
    terminal_name,
)
from photon_ml_tpu_torch.analysis.jit_purity import is_graph_context

NAME = "donation-aliasing"

# Tensor methods that copy a CUDA output out (`.to` of a graph's output
# changes its device or dtype in practice; a same-device `.to` is a no-op).
_COPIES = frozenset({"clone", "cpu", "to", "tolist", "item"})

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _targets(t: ast.AST) -> List[ast.AST]:
    """The dotted-name targets of an assignment target (tuples unpacked)."""
    if isinstance(t, (ast.Tuple, ast.List)):
        return [x for e in t.elts for x in _targets(e)]
    return [t] if dotted_name(t) is not None else []


def _graph_outputs(tree: ast.Module) -> Dict[str, Set[str]]:
    """Graph dotted name -> the dotted names bound to its output."""
    out: Dict[str, Set[str]] = {}
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Assign)
            and isinstance(node.value, ast.Call)
            and terminal_name(node.value.func) == "capture_graph"
        ):
            for t in node.targets:
                if isinstance(t, (ast.Tuple, ast.List)) and len(t.elts) >= 2:
                    g, o = dotted_name(t.elts[0]), dotted_name(t.elts[1])
                    if g and o:
                        out.setdefault(g, set()).add(o)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if not (is_graph_context(item) and item.context_expr.args):
                    continue
                g = dotted_name(item.context_expr.args[0])
                if g is None:
                    continue
                for stmt in node.body:
                    for n in ast.walk(stmt):
                        if isinstance(n, (ast.Assign, ast.AnnAssign)):
                            ts = n.targets if isinstance(n, ast.Assign) else [n.target]
                            for t in ts:
                                for x in _targets(t):
                                    out.setdefault(g, set()).add(dotted_name(x))
    return out


def _view_root(node: ast.AST) -> Optional[str]:
    """The dotted name a value aliases: the root of a subscript, attribute
    or non-copying method chain; None for a copy or a fresh value."""
    while True:
        if isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr in _COPIES:
                return None
            node = node.func.value
        else:
            return dotted_name(node)


def _pos(node: ast.AST) -> Tuple[int, int]:
    return (node.lineno, node.col_offset)


def _end(node: ast.AST) -> Tuple[int, int]:
    return (getattr(node, "end_lineno", node.lineno), getattr(node, "end_col_offset", 0))


def _bindings(fn: ast.AST) -> List[Tuple[Tuple[int, int], str, Optional[ast.AST]]]:
    """(position, dotted target, value) for every binding in `fn`, sorted;
    the value is None where the target is one element of an unpacked
    tuple or a loop/with target. A binding takes effect at the end of its
    statement (a loop's at its head)."""
    out = []
    for n in ast.walk(fn):
        if isinstance(n, (ast.Assign, ast.AnnAssign)):
            if n.value is None:
                continue
            ts = n.targets if isinstance(n, ast.Assign) else [n.target]
            for t in ts:
                xs = _targets(t)
                whole = len(xs) == 1 and xs[0] is t
                for x in xs:
                    out.append((_end(n), dotted_name(x), n.value if whole else None))
        elif isinstance(n, (ast.For, ast.AsyncFor)):
            out += [(_pos(n), dotted_name(x), None) for x in _targets(n.target)]
        elif isinstance(n, (ast.With, ast.AsyncWith)):
            for i in n.items:
                if i.optional_vars is not None:
                    out += [(_pos(n), dotted_name(x), None) for x in _targets(i.optional_vars)]
    return sorted(out, key=lambda b: b[0])


def _parents(fn: ast.AST) -> Dict[int, ast.AST]:
    return {id(c): p for p in ast.walk(fn) for c in ast.iter_child_nodes(p)}


def _copies_out(use: ast.AST, parents: Dict[int, ast.AST]) -> bool:
    """`use.clone()` / `.cpu()` / ... or `dst.copy_(use)`: the read takes
    the output's current value and keeps no reference to it."""
    p = parents.get(id(use))
    if isinstance(p, ast.Attribute) and p.attr in _COPIES:
        call = parents.get(id(p))
        return isinstance(call, ast.Call) and call.func is p
    return (
        isinstance(p, ast.Call)
        and isinstance(p.func, ast.Attribute)
        and p.func.attr == "copy_"
        and any(a is use for a in p.args)
    )


def _check_replay(fn, call: ast.Call, graph: str, outputs: Set[str], rel: str) -> List[Finding]:
    findings: List[Finding] = []
    bindings = _bindings(fn)
    # The last binding of each name before the replay decides whether it
    # holds the output then; aliases of aliases resolve in order.
    holds: Dict[str, int] = {}
    for pos, name, value in bindings:
        if pos > _pos(call):
            break
        root = _view_root(value) if value is not None else None
        if name in outputs or (root is not None and (root in outputs or root in holds)):
            holds[name] = pos[0]
        else:
            holds.pop(name, None)
    if not holds:
        return findings
    parents = _parents(fn)
    after = _end(call)
    for name, bound_line in sorted(holds.items()):
        rebind = min((pos for pos, bname, _ in bindings if bname == name and pos > after),
                     default=None)
        uses = sorted(
            (n for n in ast.walk(fn)
             if isinstance(n, (ast.Name, ast.Attribute)) and isinstance(n.ctx, ast.Load)
             and dotted_name(n) == name and _pos(n) >= after),
            key=_pos,
        )
        for use in uses:
            if rebind is not None and _pos(use) >= rebind:
                break
            if _copies_out(use, parents):
                continue
            findings.append(
                Finding(
                    NAME,
                    rel,
                    use.lineno,
                    f"{name!r} holds the output of graph {graph!r} "
                    f"(bound on line {bound_line}) and is read here "
                    f"after {graph}.replay() on line {call.lineno} "
                    "rewrote that output in place — copy out what you "
                    "need (.clone(), dst.copy_(...)) or bind the name "
                    "again",
                )
            )
            break
    return findings


@register_check(
    NAME,
    "a name bound to a captured CUDA graph's output (or a view of it) "
    "must not be read after a later .replay() of that graph in the same "
    "function without being bound again",
)
def check(ctx: Context) -> List[Finding]:
    findings: List[Finding] = []
    for f in ctx.in_scope(CHECKS[NAME]):
        if "replay" not in f.text:
            continue
        outputs = _graph_outputs(f.tree)
        if not outputs:
            continue
        for fn in ast.walk(f.tree):
            if not isinstance(fn, _FUNCS):
                continue
            for node in ast.walk(fn):
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "replay"
                ):
                    graph = dotted_name(node.func.value)
                    if graph in outputs:
                        findings.extend(
                            _check_replay(fn, node, graph, outputs[graph], f.rel)
                        )
    return findings
