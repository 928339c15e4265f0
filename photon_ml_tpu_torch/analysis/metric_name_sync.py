"""metric-name-sync: incremented metric names == declared metric names.

The bug class (the fault-site-sync argument applied to telemetry): a
counter/histogram/gauge name incremented anywhere in the tree but missing
from `utils/telemetry.METRIC_DESCRIPTIONS` is a metric no dashboard,
profile, or phase contract can discover (and since the registry is
closed, it raises at runtime — on whatever rare path first increments
it). The reverse is as bad: a declared-but-never-incremented
name is advertised observability that does not exist, and a bench
contract asserting it zero is asserting nothing.

Rules, mirrored from fault-site-sync:

1. The increment surface is calls whose terminal name is `increment`,
   `observe`, or `set_gauge` (faults.COUNTERS and telemetry.METRICS
   both route through these). Their metric-name argument must be
   statically resolvable: a string literal, or an expression whose
   every branch is one (e.g. the conditional
   `counter="collective_retries" if mesh else "retries"`). Calls whose
   first argument is a non-string constant are instance-level
   recorders, not registry calls, and are skipped.
2. Every resolvable name must be a key of METRIC_DESCRIPTIONS in the
   telemetry registry module (any analyzed telemetry.py defining it
   counts, so fixtures carry a miniature registry).
3. Every declared name must be incremented somewhere in the analyzed
   set (finding anchored at the dict key in the registry).
4. `faults.retry(..., counter="...")` keyword literals and the
   str-literal default of a parameter named `counter` count as
   increment sites — they are where retry counter names actually
   enter the system. The default is read for positional and
   keyword-only parameters alike (the port's `faults.retry` declares
   `counter` after `*`).

The registry module itself and utils/faults.py are exempt from rule
1's literal requirement: they define the forwarding wrappers
(`MetricsRegistry.increment(name)`, `retry()`'s internal
`COUNTERS.increment(counter)`), which is definition, not use.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set

from photon_ml_tpu_torch.analysis.core import (
    CHECKS,
    Context,
    Finding,
    SourceFile,
    register_check,
    terminal_name,
)

NAME = "metric-name-sync"

_INCREMENT_CALLS = ("increment", "observe", "set_gauge")


def _metric_descriptions(reg: SourceFile) -> Dict[str, int]:
    """METRIC_DESCRIPTIONS keys -> line numbers, from the registry AST."""
    for node in reg.tree.body:
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "METRIC_DESCRIPTIONS"
            for t in node.targets
        ):
            if isinstance(node.value, ast.Dict):
                return {
                    k.value: k.lineno
                    for k in node.value.keys
                    if isinstance(k, ast.Constant)
                    and isinstance(k.value, str)
                }
    return {}


def _str_constants_in(node: ast.AST) -> Set[str]:
    return {
        n.value
        for n in ast.walk(node)
        if isinstance(n, ast.Constant) and isinstance(n.value, str)
    }


@register_check(
    NAME,
    "metric increment/observe/set_gauge names and "
    "utils/telemetry.METRIC_DESCRIPTIONS must agree in both directions, "
    "and names must be statically resolvable",
)
def check(ctx: Context) -> List[Finding]:
    findings: List[Finding] = []
    reg = ctx.find("utils/telemetry.py", "telemetry.py")
    declared: Dict[str, int] = _metric_descriptions(reg) if reg else {}
    faults_mod = ctx.find("utils/faults.py", "faults.py")
    exempt_paths = {
        f.path for f in (reg, faults_mod) if f is not None
    }
    planted: Set[str] = set()

    def _plant(names: Set[str], f: SourceFile, lineno: int) -> None:
        for name in names:
            planted.add(name)
            if declared and name not in declared:
                findings.append(
                    Finding(
                        NAME,
                        f.rel,
                        lineno,
                        f"metric {name!r} is not declared in "
                        "METRIC_DESCRIPTIONS — an undeclared name raises "
                        "at increment time and is invisible to the "
                        "metrics registry",
                    )
                )

    for f in ctx.in_scope(CHECKS[NAME]):
        for node in ast.walk(f.tree):
            if isinstance(node, ast.FunctionDef):
                # Rule 4: str default of a parameter named `counter`
                # (faults.retry's default) is a planted name.
                params = node.args.args
                defaults = node.args.defaults
                pairs = list(zip(params[len(params) - len(defaults):], defaults))
                pairs += zip(node.args.kwonlyargs, node.args.kw_defaults)
                for arg, default in pairs:
                    if (
                        arg.arg == "counter"
                        and isinstance(default, ast.Constant)
                        and isinstance(default.value, str)
                    ):
                        _plant({default.value}, f, node.lineno)
                continue
            if not isinstance(node, ast.Call):
                continue
            # Rule 4: counter="..." keywords on any call.
            for kw in node.keywords:
                if kw.arg == "counter":
                    names = _str_constants_in(kw.value)
                    if names:
                        _plant(names, f, node.lineno)
                    elif f.path not in exempt_paths:
                        findings.append(
                            Finding(
                                NAME,
                                f.rel,
                                node.lineno,
                                "counter= argument carries no resolvable "
                                "string literal — the retried counter "
                                "name is invisible to this sync check",
                            )
                        )
            if terminal_name(node.func) not in _INCREMENT_CALLS:
                continue
            if not node.args:
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and not isinstance(
                arg.value, str
            ):
                continue  # instance-level recorder (a value, not a name)
            names = _str_constants_in(arg)
            if names:
                _plant(names, f, node.lineno)
            elif f.path not in exempt_paths:
                findings.append(
                    Finding(
                        NAME,
                        f.rel,
                        node.lineno,
                        "metric name must be statically resolvable (a "
                        "string literal or an expression of literals) — "
                        "a computed name is invisible to "
                        "METRIC_DESCRIPTIONS and to this sync check",
                    )
                )
    if reg is not None:
        for name, line in declared.items():
            if name not in planted:
                findings.append(
                    Finding(
                        NAME,
                        reg.rel,
                        line,
                        f"metric {name!r} is declared in "
                        "METRIC_DESCRIPTIONS but nothing increments it — "
                        "advertised observability that does not exist",
                    )
                )
    return findings
