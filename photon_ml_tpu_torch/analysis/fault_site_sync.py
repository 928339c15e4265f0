"""fault-site-sync: planted fault sites == described fault sites.

The bug class: a `fault_point("<site>")` naming a site missing from
`SITE_DESCRIPTIONS` is unreachable from any PHOTON_FAULTS plan (plans
naming unknown sites fail to parse) — a fault point no chaos test can
ever arm. The reverse is as bad: a described-but-unplanted site makes
`python -m photon_ml_tpu_torch.utils.faults --list-sites` advertise
coverage that does not exist, and a chaos spec arming it tests nothing.
This check holds BOTH directions statically.

Rules:

1. Every `fault_point(...)` argument must be a string literal — the
   sync is only decidable statically for literals, and a computed site
   name would also defeat `--list-sites`.
2. Every planted literal must be a key of `SITE_DESCRIPTIONS` in the
   faults registry module (photon_ml_tpu_torch/utils/faults.py; any
   analyzed file named faults.py defining SITE_DESCRIPTIONS counts, so
   fixtures can carry a miniature registry).
3. Every described site must be planted somewhere in the analyzed set
   (finding anchored at the dict key in the registry).
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

NAME = "fault-site-sync"


def _site_descriptions(reg: SourceFile) -> Dict[str, int]:
    """SITE_DESCRIPTIONS keys -> line numbers, from the registry AST."""
    for node in reg.tree.body:
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "SITE_DESCRIPTIONS"
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


@register_check(
    NAME,
    "fault_point() call sites and utils/faults.SITE_DESCRIPTIONS must "
    "agree in both directions, and sites must be string literals",
)
def check(ctx: Context) -> List[Finding]:
    findings: List[Finding] = []
    reg = ctx.find("utils/faults.py", "faults.py")
    described: Dict[str, int] = _site_descriptions(reg) if reg else {}
    planted: Set[str] = set()
    for f in ctx.in_scope(CHECKS[NAME]):
        for node in ast.walk(f.tree):
            if not (
                isinstance(node, ast.Call)
                and terminal_name(node.func) == "fault_point"
                and node.args
            ):
                continue
            arg = node.args[0]
            if not (
                isinstance(arg, ast.Constant) and isinstance(arg.value, str)
            ):
                # The registry module's own wrapper (`fault_point(site)`)
                # forwards its parameter; that is the definition, not a
                # plant.
                if reg is not None and f.path == reg.path:
                    continue
                findings.append(
                    Finding(
                        NAME,
                        f.rel,
                        node.lineno,
                        "fault_point() site must be a string literal — a "
                        "computed site name is invisible to --list-sites "
                        "and to this sync check",
                    )
                )
                continue
            site = arg.value
            planted.add(site)
            if described and site not in described:
                findings.append(
                    Finding(
                        NAME,
                        f.rel,
                        node.lineno,
                        f"fault site {site!r} is not registered in "
                        "SITE_DESCRIPTIONS — no PHOTON_FAULTS plan can "
                        "ever arm it",
                    )
                )
    if reg is not None:
        for site, line in described.items():
            if site not in planted:
                findings.append(
                    Finding(
                        NAME,
                        reg.rel,
                        line,
                        f"site {site!r} is described in SITE_DESCRIPTIONS "
                        "but no fault_point() plants it — advertised "
                        "chaos coverage that does not exist",
                    )
                )
    return findings
