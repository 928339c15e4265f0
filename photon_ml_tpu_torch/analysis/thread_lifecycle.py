"""thread-lifecycle: every thread is nameable and joinable.

The bug class: an anonymous background thread that nobody joins keeps
running into interpreter teardown — a serving promotion worker
dispatching during shutdown aborts the whole process, and the fix is
precisely "name it, join it". Names are also what thread-leak guards and
operators' stack dumps key on: an unnamed `Thread-23` in a hang report is
undebuggable.

Rules, for every `threading.Thread(...)` construction (aliased imports
and `from threading import Thread` resolved):

1. It must pass `name=`.
2. A `.join(...)` call must be reachable in the same class (when the
   thread is built inside a class body) or else the same module.
   "Reachable" is lexical: some `.join` on a non-path, non-string
   receiver exists in that scope. Fire-and-forget designs whose
   completion is genuinely owned elsewhere (e.g. a Future the consumer
   blocks on) must say so with a reasoned disable pragma — the point is
   that the teardown story is WRITTEN, not assumed.
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
)

NAME = "thread-lifecycle"


def _thread_aliases(tree: ast.Module) -> tuple:
    """(module aliases for `threading`, direct names for Thread)."""
    mod_aliases: Set[str] = set()
    direct: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "threading":
                    mod_aliases.add(a.asname or a.name)
        elif isinstance(node, ast.ImportFrom):
            if node.module == "threading":
                for a in node.names:
                    if a.name == "Thread":
                        direct.add(a.asname or a.name)
    return mod_aliases, direct


def _is_thread_ctor(node: ast.Call, mod_aliases, direct) -> bool:
    f = node.func
    if isinstance(f, ast.Name):
        return f.id in direct
    if isinstance(f, ast.Attribute) and f.attr == "Thread":
        return isinstance(f.value, ast.Name) and f.value.id in mod_aliases
    return False


def _is_real_join(node: ast.Call) -> bool:
    """A `.join()` that could be a thread join. Excluded: str.join on a
    constant (", ".join), path joins (receiver chain contains 'path'),
    and the str.join CALL SHAPE — one positional argument that is not a
    numeric timeout (`sep.join(parts)`). Thread.join is `t.join()`,
    `t.join(5)`, or `t.join(timeout=...)`."""
    f = node.func
    if not (isinstance(f, ast.Attribute) and f.attr == "join"):
        return False
    recv = f.value
    if isinstance(recv, ast.Constant):
        return False
    dn = dotted_name(recv)
    if dn is not None and "path" in dn.split("."):
        return False
    if len(node.args) == 1 and not node.keywords:
        a = node.args[0]
        if not (
            isinstance(a, ast.Constant) and isinstance(a.value, (int, float))
        ):
            return False  # sep.join(iterable): a string join
    return True


def _enclosing_classes(tree: ast.Module) -> Dict[int, ast.ClassDef]:
    """id(node) -> the innermost class whose body holds it, in one pass."""
    out: Dict[int, ast.ClassDef] = {}

    def visit(node: ast.AST, cls: Optional[ast.ClassDef]) -> None:
        for child in ast.iter_child_nodes(node):
            if cls is not None:
                out[id(child)] = cls
            visit(child, child if isinstance(child, ast.ClassDef) else cls)

    visit(tree, None)
    return out


@register_check(
    NAME,
    "every threading.Thread(...) must pass name= and have a reachable "
    ".join() in the same class/module",
)
def check(ctx: Context) -> List[Finding]:
    findings: List[Finding] = []
    for f in ctx.in_scope(CHECKS[NAME]):
        mod_aliases, direct = _thread_aliases(f.tree)
        if not mod_aliases and not direct:
            continue
        ctors = [
            n
            for n in ast.walk(f.tree)
            if isinstance(n, ast.Call)
            and _is_thread_ctor(n, mod_aliases, direct)
        ]
        if not ctors:
            continue
        classes = _enclosing_classes(f.tree)
        module_has_join = any(
            isinstance(n, ast.Call) and _is_real_join(n)
            for n in ast.walk(f.tree)
        )
        for ctor in ctors:
            if not any(kw.arg == "name" for kw in ctor.keywords):
                findings.append(
                    Finding(
                        NAME,
                        f.rel,
                        ctor.lineno,
                        "threading.Thread(...) without name= — unnamed "
                        "threads are invisible to the leak guard and "
                        "undebuggable in hang reports",
                    )
                )
            cls = classes.get(id(ctor))
            if cls is not None:
                has_join = any(
                    isinstance(n, ast.Call) and _is_real_join(n)
                    for n in ast.walk(cls)
                )
                where = f"class {cls.name}"
            else:
                has_join = module_has_join
                where = "module"
            if not has_join:
                findings.append(
                    Finding(
                        NAME,
                        f.rel,
                        ctor.lineno,
                        f"thread constructed here is never joined in the "
                        f"same {where} — threads alive at interpreter "
                        "teardown abort the process (the "
                        "promotion-worker bug class)",
                    )
                )
    return findings
