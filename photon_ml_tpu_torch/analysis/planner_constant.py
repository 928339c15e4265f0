"""planner-constant: planned runtime quantities are planned, not hard-coded.

The bug class: the adaptive runtime planner exists because the tree's
performance-critical quantities — micro-batch wait, ingest chunk-row
counts, prefetch depths, scan-fusion caps, bucket shape sets — were
fixed constants sprinkled across modules, each one a hand-tuning
decision nobody re-validates when the hardware changes. Those quantities
live in `photon_ml_tpu_torch/planner/` (DEFAULTS + rules) and the typed
knob registry; a magic-number literal for one of them anywhere else is a
site the planner silently cannot reach. The vocabulary is the JAX
package's, names the port does not plan (`prefetch_depth`,
`scan_fusion_max`, `bucket_shapes`) included: a literal bound to one is
a hard-coded quantity all the same.

Rule: a numeric literal (or a tuple/list of >= 2 numeric literals — a
bucket shape set) bound to a PLANNED-QUANTITY NAME is a finding, where
"bound" means any of:

  * an assignment (`max_wait_ms = 2.0`, `bucket_shapes = (64, 128)`),
  * a function-parameter default (`def flush(max_wait_ms=2.0)`),
  * a call keyword (`batcher(max_wait_ms=1.0)`).

Files under `planner/` and the registries (utils/knobs.py,
contracts.py) are the quantities' declared homes and exempt. Phases of
chip_smoke.py that deliberately pin a value for a measurement carry a
reasoned disable pragma for this check (`# photon-lint:
disable=<check> — <why>`) — the suppression is the documentation.
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
)

NAME = "planner-constant"

# The planned-quantity vocabulary: the JAX planner's DEFAULTS/KNOB_FOR
# decision names plus their call-site spellings.
PLANNED_NAMES = frozenset(
    {
        "max_wait_ms",
        "wait_ms",
        "prefetch_depth",
        "chunk_rows",
        "stream_chunk_rows",
        "ingest_chunk_rows",
        "scan_fusion_max",
        "score_reps",
        "bucket_shapes",
        "bucket_sizes",
        "serving_max_wait_ms",
        "serving_max_batch",
    }
)

# The quantities' declared homes.
_EXEMPT_SUFFIXES = (
    "utils/knobs.py",
    "contracts.py",
)
_EXEMPT_DIRS = ("planner/",)


def _numeric_literal(node: ast.AST) -> Optional[str]:
    """A rendering of the literal when `node` is a number or a >=2-element
    tuple/list of numbers (a shape set); None otherwise. bool is not a
    number here (True/False defaults are switches, not magnitudes)."""
    if isinstance(node, ast.Constant) and isinstance(
        node.value, (int, float)
    ) and not isinstance(node.value, bool):
        return repr(node.value)
    if isinstance(node, (ast.Tuple, ast.List)) and len(node.elts) >= 2:
        if all(
            isinstance(e, ast.Constant)
            and isinstance(e.value, (int, float))
            and not isinstance(e.value, bool)
            for e in node.elts
        ):
            return "(" + ", ".join(repr(e.value) for e in node.elts) + ")"
    return None


def _exempt(f: SourceFile) -> bool:
    norm = f.rel.replace("\\", "/")
    if any(norm.endswith(s) for s in _EXEMPT_SUFFIXES):
        return True
    return any(d in norm for d in _EXEMPT_DIRS)


def _finding(f: SourceFile, line: int, name: str, rendered: str) -> Finding:
    return Finding(
        NAME,
        f.rel,
        line,
        f"hard-coded planned quantity {name}={rendered} — route it "
        f"through {PACKAGE}.planner (planned_value/DEFAULTS) or the "
        "typed knob registry so the runtime plan can reach this site",
    )


@register_check(
    NAME,
    "planned runtime quantities (wait-ms, chunk rows, prefetch depth, "
    "fusion caps, bucket shape sets) must come from planner/ or the knob "
    "registry, not magic-number literals",
    scopes=("package", "bench"),
)
def check(ctx: Context) -> List[Finding]:
    findings: List[Finding] = []
    for f in ctx.in_scope(CHECKS[NAME]):
        if _exempt(f):
            continue
        for node in ast.walk(f.tree):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id in PLANNED_NAMES:
                        rendered = _numeric_literal(node.value)
                        if rendered is not None:
                            findings.append(
                                _finding(f, node.lineno, t.id, rendered)
                            )
            elif isinstance(node, ast.AnnAssign):
                t = node.target
                if (
                    isinstance(t, ast.Name)
                    and t.id in PLANNED_NAMES
                    and node.value is not None
                ):
                    rendered = _numeric_literal(node.value)
                    if rendered is not None:
                        findings.append(
                            _finding(f, node.lineno, t.id, rendered)
                        )
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                args = node.args
                pos = args.posonlyargs + args.args
                for arg, default in zip(pos[len(pos) - len(args.defaults):],
                                        args.defaults):
                    if arg.arg in PLANNED_NAMES:
                        rendered = _numeric_literal(default)
                        if rendered is not None:
                            findings.append(
                                _finding(f, default.lineno, arg.arg, rendered)
                            )
                for arg, default in zip(args.kwonlyargs, args.kw_defaults):
                    if default is not None and arg.arg in PLANNED_NAMES:
                        rendered = _numeric_literal(default)
                        if rendered is not None:
                            findings.append(
                                _finding(f, default.lineno, arg.arg, rendered)
                            )
            elif isinstance(node, ast.Call):
                for kw in node.keywords:
                    if kw.arg in PLANNED_NAMES:
                        rendered = _numeric_literal(kw.value)
                        if rendered is not None:
                            findings.append(
                                _finding(
                                    f, kw.value.lineno, kw.arg, rendered
                                )
                            )
    return findings
