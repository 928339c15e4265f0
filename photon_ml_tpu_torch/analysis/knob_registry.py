"""knob-registry: every PHOTON_* env read goes through utils/knobs.py.

The bug class: tuning knobs accreted as raw `os.environ.get` calls have
no declared type, default, or docs — a renamed or half-migrated knob
silently reads as unset and the tuning decision rots. Rules:

1. No raw `os.environ[...]` / `os.environ.get(...)` / `os.getenv(...)`
   read of a PHOTON_* name anywhere outside the registry module itself
   (the file found as utils/knobs.py is exempt — that is where the one
   sanctioned read lives). Env *writes* are not flagged: exporting a knob
   into a child process's environment is how subprocess harnesses
   configure workers, and the reader on the other side still goes
   through the registry. Indirection through a module-level string
   constant (`_DISABLE_ENV = "PHOTON_X"`) is resolved.

2. Every `get_knob("PHOTON_X")` literal must name a registered knob
   (only checkable when the registry module is in the analyzed set).

3. Every registered knob must have a ROW in the README knob table (a
   `| `PHOTON_X` |` markdown row — prose mentions do not count, so
   deleting a table row is caught even when the name appears elsewhere),
   and every table row must name a registered knob (stale rows for
   deleted knobs are flagged too). The repo's README holds the JAX
   package's table too, so the port's table sits between the
   `PORT_TABLE_BEGIN` / `PORT_TABLE_END` markers and, when the begin
   marker is present, only that section is read; a README without it (a
   fixture's) is read whole. The table is generated from the registry:
   `python -m photon_ml_tpu_torch.utils.knobs --table`.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from photon_ml_tpu_torch.analysis.core import (
    CHECKS,
    PACKAGE,
    Context,
    Finding,
    SourceFile,
    register_check,
    resolve_str_arg,
)

NAME = "knob-registry"

PORT_TABLE_BEGIN = "<!-- photon-lint: port knob table begin -->"
PORT_TABLE_END = "<!-- photon-lint: port knob table end -->"


def _environ_read_arg(node: ast.AST) -> Optional[ast.AST]:
    """The name-expression read from the environment, for reads only:
    `os.environ[k]` (Load), `os.environ.get(k, ...)`, `os.getenv(k, ...)`.
    Returns None for writes/dels/pops and non-environ expressions."""
    if isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Load):
        target = node.value
        if (
            isinstance(target, ast.Attribute)
            and target.attr == "environ"
            and isinstance(target.value, ast.Name)
            and target.value.id == "os"
        ):
            return node.slice
    if isinstance(node, ast.Call):
        func = node.func
        if (
            isinstance(func, ast.Attribute)
            and func.attr == "get"
            and isinstance(func.value, ast.Attribute)
            and func.value.attr == "environ"
            and isinstance(func.value.value, ast.Name)
            and func.value.value.id == "os"
            and node.args
        ):
            return node.args[0]
        if (
            isinstance(func, ast.Attribute)
            and func.attr == "getenv"
            and isinstance(func.value, ast.Name)
            and func.value.id == "os"
            and node.args
        ):
            return node.args[0]
    return None


def _registered_knobs(reg: SourceFile) -> List[Tuple[str, int]]:
    """(knob name, line) for every `_register("PHOTON_X", ...)` call in
    the registry module."""
    out: List[Tuple[str, int]] = []
    for node in ast.walk(reg.tree):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "_register"
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            out.append((node.args[0].value, node.lineno))
    return out


# A knob's ROW in the README markdown table. Substring presence is not
# enough: a deleted row would still "appear" via prose mentions or as a
# prefix of another knob's row (PHOTON_FAULTS inside PHOTON_FAULTS_SEED).
_TABLE_ROW_RE = re.compile(r"^\|\s*`(PHOTON_[A-Z0-9_]+)`\s*\|", re.MULTILINE)


def table_rows(readme_text: str) -> Dict[str, int]:
    """Knob name -> README line of its table row, read from the port's
    marked section when the README has one, else from the whole file."""
    start = readme_text.find(PORT_TABLE_BEGIN)
    end = len(readme_text)
    if start < 0:
        start = 0
    else:
        stop = readme_text.find(PORT_TABLE_END, start)
        if stop >= 0:
            end = stop
    rows: Dict[str, int] = {}
    for m in _TABLE_ROW_RE.finditer(readme_text, start, end):
        rows[m.group(1)] = readme_text.count("\n", 0, m.start()) + 1
    return rows


@register_check(
    NAME,
    "PHOTON_* env reads must go through utils/knobs.get_knob; the "
    "registry and the README knob table must stay in sync",
)
def check(ctx: Context) -> List[Finding]:
    findings: List[Finding] = []
    reg = ctx.find("utils/knobs.py", "knobs.py")
    registered: Set[str] = set()
    if reg is not None:
        entries = _registered_knobs(reg)
        registered = {name for name, _ in entries}
        if ctx.readme_text is not None:
            rows = table_rows(ctx.readme_text)
            for name, line in entries:
                if name not in rows:
                    findings.append(
                        Finding(
                            NAME,
                            reg.rel,
                            line,
                            f"knob {name} is registered but has no row in "
                            "the README knob table — regenerate it with "
                            f"`python -m {PACKAGE}.utils.knobs --table`",
                        )
                    )
            for name, line in sorted(rows.items()):
                if name not in registered:
                    findings.append(
                        Finding(
                            NAME,
                            ctx.readme_rel,
                            line,
                            f"README knob table row for {name} names an "
                            "unregistered knob — stale row; regenerate "
                            "the table from the registry",
                        )
                    )
    for f in ctx.in_scope(CHECKS[NAME]):
        if reg is not None and f.path == reg.path:
            continue  # the registry's own sanctioned read — ONLY that file
        for node in ast.walk(f.tree):
            arg = _environ_read_arg(node)
            if arg is not None:
                name = resolve_str_arg(arg, f)
                if name is not None and name.startswith("PHOTON_"):
                    findings.append(
                        Finding(
                            NAME,
                            f.rel,
                            node.lineno,
                            f"raw environment read of {name} — use "
                            f"{PACKAGE}.utils.knobs.get_knob so the "
                            "knob carries a type/default/doc and lands "
                            "in the README table",
                        )
                    )
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "get_knob"
                and node.args
                and registered
            ):
                name = resolve_str_arg(node.args[0], f)
                if name is not None and name not in registered:
                    findings.append(
                        Finding(
                            NAME,
                            f.rel,
                            node.lineno,
                            f"get_knob({name!r}) names an unregistered "
                            "knob — register it in "
                            f"{PACKAGE}.utils.knobs.KNOBS",
                        )
                    )
    return findings
