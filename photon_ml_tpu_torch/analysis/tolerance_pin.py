"""tolerance-pin: parity tolerances are pinned in contracts, not inlined.

The bug class: the port is held to the JAX package, and the precision
ladder to its characterized per-rung bounds, under recorded tolerances.
That contract is only auditable if the tolerances live in exactly one
place (`photon_ml_tpu_torch/contracts.py`'s PORT_TOLERANCES /
TIER_TOLERANCES); an `allclose(..., rtol=1e-2)` literal at a call site
is a parity bound nobody can find, compare, or tighten in one place.

Rule: a numeric literal passed as a tolerance to an allclose-style
parity comparison (`allclose`, `isclose`, `assert_allclose`) is a
finding, whether spelled as an `rtol=`/`atol=` keyword or positionally
(argument index >= 2 — both numpy signatures put rtol/atol there).
`contracts.py` is the tolerances' declared home and exempt. A site
that genuinely needs a local bound carries a reasoned disable pragma for
this check (`# photon-lint: disable=<check> — <why>`) — the suppression
is the documentation.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from photon_ml_tpu_torch.analysis.core import (
    CHECKS,
    PACKAGE,
    Context,
    Finding,
    SourceFile,
    register_check,
    terminal_name,
)

NAME = "tolerance-pin"

# Call terminal names that compare under a tolerance (numpy, torch, and
# numpy.testing spellings alike — terminal_name strips the module).
_PARITY_CALLS = frozenset({"allclose", "isclose", "assert_allclose"})
_TOLERANCE_KWARGS = frozenset({"rtol", "atol"})

# The tolerances' declared home.
_EXEMPT_SUFFIXES = ("contracts.py",)


def _numeric_literal(node: ast.AST) -> Optional[str]:
    """repr of the literal when `node` is a plain number (bool is a
    switch, not a magnitude); None otherwise."""
    if (
        isinstance(node, ast.Constant)
        and isinstance(node.value, (int, float))
        and not isinstance(node.value, bool)
    ):
        return repr(node.value)
    return None


def _exempt(f: SourceFile) -> bool:
    norm = f.rel.replace("\\", "/")
    return any(norm.endswith(s) for s in _EXEMPT_SUFFIXES)


def _finding(f: SourceFile, line: int, where: str, rendered: str) -> Finding:
    return Finding(
        NAME,
        f.rel,
        line,
        f"inline parity tolerance {where}={rendered} — pin it in "
        f"{PACKAGE}/contracts.py (PORT_TOLERANCES / TIER_TOLERANCES) "
        "so the characterized contract stays auditable in one place",
    )


@register_check(
    NAME,
    "allclose-style parity comparisons take their rtol/atol from "
    "contracts.py pinned tolerance tables, never inline numeric literals",
    scopes=("package", "bench"),
)
def check(ctx: Context) -> List[Finding]:
    findings: List[Finding] = []
    for f in ctx.in_scope(CHECKS[NAME]):
        if _exempt(f):
            continue
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Call):
                continue
            if terminal_name(node.func) not in _PARITY_CALLS:
                continue
            for kw in node.keywords:
                if kw.arg in _TOLERANCE_KWARGS:
                    rendered = _numeric_literal(kw.value)
                    if rendered is not None:
                        findings.append(
                            _finding(f, kw.value.lineno, kw.arg, rendered)
                        )
            for i, arg in enumerate(node.args):
                if i < 2:  # actual/desired operands
                    continue
                rendered = _numeric_literal(arg)
                if rendered is not None:
                    where = "rtol" if i == 2 else "atol"
                    findings.append(
                        _finding(f, arg.lineno, where, rendered)
                    )
    return findings
