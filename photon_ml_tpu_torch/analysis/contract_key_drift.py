"""contract-key-drift: required-key schemas are imported, never re-typed.

The bug class: chip_smoke.py's phases and the serving summary enforce
loud missing-key contracts. When the required-key tuple is re-typed at
every enforcement site, renaming a key updates the producer and N-1 of
the N copies — the stale copy either fails a healthy run or, worse,
keeps "passing" while no longer checking the renamed key. The port's
schemas live in photon_ml_tpu_torch/contracts.py (found as
`photon_ml_tpu_torch/contracts.py`, else any `contracts.py`); everyone
else imports them.

Rule: outside the contracts module, no tuple/list/set literal may
contain TWO or more string keys belonging to one contract schema.
(One shared key is everyday vocabulary — `"pack"` appears in many
contexts; two or more is a re-typed schema.) Dict literals and
subscripts (`m["p50_ms"]`) are untouched: reading one key is use, not
schema duplication.

The schemas are harvested statically from the contracts module's
top-level tuple assignments, `*NAME` splices resolved against earlier
assignments — the check never imports the code it analyzes.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set

from photon_ml_tpu_torch.analysis.core import (
    CHECKS,
    PACKAGE,
    Context,
    Finding,
    SourceFile,
    register_check,
)

NAME = "contract-key-drift"


def _contract_sets(reg: SourceFile) -> Dict[str, Set[str]]:
    """Top-level NAME = ("key", ..., *OTHER) tuple assignments."""
    out: Dict[str, Set[str]] = {}
    for node in reg.tree.body:
        if not (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and isinstance(node.value, ast.Tuple)
        ):
            continue
        keys: Set[str] = set()
        ok = True
        for elt in node.value.elts:
            if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                keys.add(elt.value)
            elif isinstance(elt, ast.Starred) and isinstance(
                elt.value, ast.Name
            ):
                spliced = out.get(elt.value.id)
                if spliced is None:
                    ok = False
                    break
                keys |= spliced
            else:
                ok = False
                break
        if ok and keys:
            out[node.targets[0].id] = keys
    return out


@register_check(
    NAME,
    "required-key tuples asserted by bench/tests must be imported from "
    "contracts.py, not re-typed as literals",
    scopes=("package", "bench", "tests"),
)
def check(ctx: Context) -> List[Finding]:
    reg = ctx.find(f"{PACKAGE}/contracts.py", "contracts.py")
    if reg is None:
        return []
    contracts = _contract_sets(reg)
    if not contracts:
        return []
    findings: List[Finding] = []
    for f in ctx.in_scope(CHECKS[NAME]):
        if f.path == reg.path:
            continue
        for node in ast.walk(f.tree):
            if not isinstance(node, (ast.Tuple, ast.List, ast.Set)):
                continue
            literals = {
                e.value
                for e in node.elts
                if isinstance(e, ast.Constant) and isinstance(e.value, str)
            }
            if len(literals) < 2:
                continue
            best_name, best_overlap = None, set()
            for cname, keys in contracts.items():
                overlap = literals & keys
                if len(overlap) > len(best_overlap):
                    best_name, best_overlap = cname, overlap
            if len(best_overlap) >= 2:
                sample = ", ".join(sorted(best_overlap)[:4])
                findings.append(
                    Finding(
                        NAME,
                        f.rel,
                        node.lineno,
                        f"re-types {len(best_overlap)} key(s) of "
                        f"contracts.{best_name} ({sample}, ...) — "
                        "import the schema instead so a key rename "
                        "cannot drift past this site",
                    )
                )
    return findings
