"""`python -m photon_ml_tpu_torch.analysis` — run photon-lint over the port.

Exit status: 0 clean, 1 findings, 2 usage error — so the module works
unmodified as a pre-commit hook or CI gate. Mirrors the introspection
convention of `python -m photon_ml_tpu_torch.utils.faults --list-sites`
and `python -m photon_ml_tpu_torch.utils.knobs --table`.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from photon_ml_tpu_torch.analysis import CHECKS, run_checks


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m photon_ml_tpu_torch.analysis",
        description=(
            "photon-lint over the PyTorch port: AST-checked invariants "
            "(knobs, fault sites, captured-graph purity, thread lifecycle, "
            "graph outputs across replays, contract keys, metrics, planned "
            "quantities, tolerances)."
        ),
    )
    p.add_argument(
        "paths",
        nargs="*",
        help="files/directories to analyze (default: the live tree — "
        "photon_ml_tpu_torch/, chip_smoke.py, tools/ and "
        "tests/test_torch_*.py)",
    )
    p.add_argument(
        "--list-checks",
        action="store_true",
        help="print every registered check and exit",
    )
    p.add_argument(
        "--check",
        action="append",
        metavar="NAME",
        help="run only this check (repeatable)",
    )
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_checks:
        width = max(len(n) for n in CHECKS)
        for name in sorted(CHECKS):
            print(f"{name.ljust(width)}  {CHECKS[name].description}")
        return 0
    try:
        findings = run_checks(paths=args.paths or None, checks=args.check)
    except (KeyError, ValueError) as exc:
        print(f"error: {exc.args[0]}", file=sys.stderr)
        return 2
    for f in findings:
        print(f.render())
    n = len(findings)
    scope = "given paths" if args.paths else "live tree"
    if n:
        print(f"photon-lint: {n} finding(s) on the {scope}", file=sys.stderr)
        return 1
    print(f"photon-lint: clean ({scope})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
