"""photon-lint core for the port: files, pragmas, the check registry, and
the runner.

The port's copy of `photon_ml_tpu/analysis/core.py`. The port keeps the
same conventions as the JAX package (a typed knob registry, a fault-site
registry, a metric registry, pinned contracts), and this package turns
each convention into an AST-checked rule over the port's own tree, run as
`python -m photon_ml_tpu_torch.analysis` and gated in tier-1 by
tests/test_torch_analysis.py (zero findings on the live tree).

Vocabulary:

* A **check** is a named rule (`CHECKS`), registered with
  `@register_check`. Each check walks parsed `SourceFile`s and returns
  `Finding`s — file:line + message. Checks are *static*: they never
  import the code under analysis, so a broken tree can still be linted.

* **Scopes**: in auto-discovery mode every file is categorized
  (`package` = photon_ml_tpu_torch/, `bench` = chip_smoke.py and
  tools/*.py, `tests` = tests/test_torch_*.py), and each check declares
  which categories it scans — e.g. the knob-registry rule does not chase
  env reads through test monkeypatching, but contract-key-drift DOES
  police tests (a test re-typing a schema is exactly the drift the rule
  exists for). When the runner is handed explicit paths (a fixture
  corpus), every file is in scope for every selected check.

* **Pragmas**: `# photon-lint: disable=<check>[,<check>...] — <reason>`
  suppresses findings for those checks on the line it attaches to: the
  same line when the pragma trails code, else the next non-blank,
  non-comment line (so a pragma may sit atop the statement it excuses,
  with continuation comment lines in between). A pragma with an EMPTY
  reason suppresses nothing and is itself a finding — an unexplained
  suppression is how invariants die silently. `--` is accepted where the
  em-dash is hard to type.
"""

from __future__ import annotations

import ast
import dataclasses
import glob
import os
import re
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

# Checks a pragma may name. Filled by register_check at import time; the
# pragma validator reads it, so check modules must be imported before
# run_checks (analysis/__init__ does).
CHECKS: Dict[str, "Check"] = {}

PACKAGE = "photon_ml_tpu_torch"

# Directories that hold known-bad snippets on purpose; never live code.
FIXTURE_DIRS = ("analysis_fixtures",)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation, anchored to a file:line."""

    check: str
    path: str  # repo-relative (or as-given) display path
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.check}] {self.message}"


@dataclasses.dataclass
class Pragma:
    """One parsed disable pragma."""

    line: int  # line the pragma text sits on
    attach_line: int  # line whose findings it suppresses
    checks: Tuple[str, ...]
    reason: str


@dataclasses.dataclass
class SourceFile:
    """A parsed python file plus everything checks need from it."""

    path: str  # absolute
    rel: str  # display path
    category: str  # package | bench | tests | explicit
    text: str
    lines: List[str]
    tree: ast.Module
    pragmas: List[Pragma]
    # Module-level `NAME = "literal"` bindings, for resolving
    # os.environ.get(_DISABLE_ENV)-style indirection statically.
    str_constants: Dict[str, str]


@dataclasses.dataclass
class Context:
    """Cross-file context handed to every check."""

    files: List[SourceFile]
    readme_text: Optional[str] = None
    readme_rel: str = "README.md"

    def in_scope(self, check: "Check") -> List[SourceFile]:
        return [
            f
            for f in self.files
            if f.category == "explicit" or f.category in check.scopes
        ]

    def find(self, *suffixes: str) -> Optional[SourceFile]:
        """The first file whose path ends with any suffix — how checks
        locate registry modules (utils/faults.py, contracts.py) in both
        the live tree and a self-contained fixture directory."""
        for suffix in suffixes:
            for f in self.files:
                if f.path.endswith(suffix):
                    return f
        return None


@dataclasses.dataclass(frozen=True)
class Check:
    name: str
    description: str
    scopes: Tuple[str, ...]
    run: Callable[[Context], List[Finding]]


def register_check(
    name: str,
    description: str,
    scopes: Tuple[str, ...] = ("package", "bench"),
):
    """Decorator: register `fn(ctx) -> List[Finding]` as a named check."""

    def wrap(fn):
        if name in CHECKS:
            raise ValueError(f"duplicate check {name!r}")
        CHECKS[name] = Check(name, description, scopes, fn)
        return fn

    return wrap


# ------------------------------------------------------------------ pragmas

_PRAGMA_RE = re.compile(
    r"#\s*photon-lint:\s*disable=([A-Za-z0-9_,\-]+)\s*(.*)$"
)
_REASON_RE = re.compile(r"^(?:—|--)\s*(\S.*)$")


def _parse_pragmas(lines: List[str]) -> List[Pragma]:
    pragmas: List[Pragma] = []
    for i, raw in enumerate(lines, start=1):
        m = _PRAGMA_RE.search(raw)
        if not m:
            continue
        checks = tuple(c for c in m.group(1).split(",") if c)
        reason_m = _REASON_RE.match(m.group(2).strip())
        reason = reason_m.group(1).strip() if reason_m else ""
        before = raw[: m.start()].strip()
        if before:  # trailing pragma: attaches to its own line
            attach = i
        else:  # comment-line pragma: attaches to the next code line
            attach = i
            for j in range(i, len(lines)):
                nxt = lines[j].strip()
                if nxt and not nxt.startswith("#"):
                    attach = j + 1
                    break
        pragmas.append(Pragma(i, attach, checks, reason))
    return pragmas


def _pragma_findings(f: SourceFile) -> List[Finding]:
    """The pragma engine's own rules: every pragma must carry a non-empty
    reason and name only registered checks. Not suppressible."""
    out: List[Finding] = []
    for p in f.pragmas:
        if not p.reason:
            out.append(
                Finding(
                    "pragma",
                    f.rel,
                    p.line,
                    "disable pragma without a reason — write "
                    "`# photon-lint: disable=<check> — <why this is safe>`",
                )
            )
        for c in p.checks:
            if c not in CHECKS:
                out.append(
                    Finding(
                        "pragma",
                        f.rel,
                        p.line,
                        f"disable pragma names unknown check {c!r} "
                        f"(known: {', '.join(sorted(CHECKS))})",
                    )
                )
    return out


# -------------------------------------------------------------- file loading


def _module_str_constants(tree: ast.Module) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(
            node.value, ast.Constant
        ):
            if isinstance(node.value.value, str):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out[t.id] = node.value.value
    return out


def load_file(path: str, category: str, root: Optional[str]) -> SourceFile:
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    rel = os.path.relpath(path, root) if root else path
    tree = ast.parse(text, filename=path)
    lines = text.splitlines()
    return SourceFile(
        path=os.path.abspath(path),
        rel=rel,
        category=category,
        text=text,
        lines=lines,
        tree=tree,
        pragmas=_parse_pragmas(lines),
        str_constants=_module_str_constants(tree),
    )


def repo_root() -> str:
    """The tree this package lives in (parent of photon_ml_tpu_torch/)."""
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


def _walk_py(root: str, skip_dirs: Tuple[str, ...] = ()) -> List[str]:
    out: List[str] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(
            d
            for d in dirnames
            if d not in ("__pycache__", *skip_dirs) and not d.startswith(".")
        )
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                out.append(os.path.join(dirpath, fn))
    return out


def discover(root: Optional[str] = None) -> Tuple[List[SourceFile], Context]:
    """Auto-discovery over the port's live tree: the package, its drivers
    (chip_smoke.py and tools/*.py), and its tests (tests/test_torch_*.py;
    the JAX package's tests belong to the JAX lint). Directories named
    analysis_fixtures exist to CONTAIN violations and are skipped."""
    root = root or repo_root()
    files: List[SourceFile] = []
    for p in _walk_py(os.path.join(root, PACKAGE), skip_dirs=FIXTURE_DIRS):
        files.append(load_file(p, "package", root))
    bench = [os.path.join(root, "chip_smoke.py")]
    bench += sorted(glob.glob(os.path.join(root, "tools", "*.py")))
    for p in bench:
        if os.path.isfile(p):
            files.append(load_file(p, "bench", root))
    for p in sorted(glob.glob(os.path.join(root, "tests", "test_torch_*.py"))):
        files.append(load_file(p, "tests", root))
    readme = os.path.join(root, "README.md")
    readme_text = None
    if os.path.isfile(readme):
        with open(readme, encoding="utf-8") as fh:
            readme_text = fh.read()
    return files, Context(files=files, readme_text=readme_text)


def load_paths(paths: Sequence[str]) -> Tuple[List[SourceFile], Context]:
    """Explicit-path mode (a fixture corpus): every .py under the given
    files/dirs, all category `explicit`; a README.md sitting in a given
    directory joins the context so fixtures can exercise doc-sync rules."""
    files: List[SourceFile] = []
    readme_text = None
    readme_rel = "README.md"
    for p in paths:
        if os.path.isdir(p):
            for q in _walk_py(p):
                files.append(load_file(q, "explicit", None))
            cand = os.path.join(p, "README.md")
            if readme_text is None and os.path.isfile(cand):
                with open(cand, encoding="utf-8") as fh:
                    readme_text = fh.read()
                readme_rel = cand
        elif p.endswith(".py"):
            files.append(load_file(p, "explicit", None))
        elif os.path.basename(p) == "README.md":
            with open(p, encoding="utf-8") as fh:
                readme_text = fh.read()
            readme_rel = p
        else:
            raise ValueError(f"not a python file or directory: {p!r}")
    return files, Context(
        files=files, readme_text=readme_text, readme_rel=readme_rel
    )


# -------------------------------------------------------------------- runner


def _suppressed(f: SourceFile) -> Dict[Tuple[int, str], str]:
    """(line, check) -> reason, for pragmas that actually suppress."""
    out: Dict[Tuple[int, str], str] = {}
    for p in f.pragmas:
        if not p.reason:
            continue  # reasonless pragmas suppress nothing
        for c in p.checks:
            out[(p.attach_line, c)] = p.reason
    return out


def run_on(
    files: List[SourceFile],
    ctx: Context,
    checks: Optional[Iterable[str]] = None,
) -> List[Finding]:
    """Run the selected checks (default: all) over loaded files; returns
    unsuppressed findings sorted by location. Pragma hygiene
    (reasonless/unknown) is always enforced."""
    selected = sorted(checks) if checks else sorted(CHECKS)
    unknown = [c for c in selected if c not in CHECKS]
    if unknown:
        raise KeyError(
            f"unknown check(s) {unknown} (known: {', '.join(sorted(CHECKS))})"
        )
    findings: List[Finding] = []
    for f in files:
        findings.extend(_pragma_findings(f))
    by_path = {f.rel: _suppressed(f) for f in files}
    for name in selected:
        for finding in CHECKS[name].run(ctx):
            sup = by_path.get(finding.path, {})
            if (finding.line, finding.check) in sup:
                continue
            findings.append(finding)
    # Dedupe (a helper reachable from two captured bodies reports once)
    # and sort.
    return sorted(set(findings), key=lambda f: (f.path, f.line, f.check, f.message))


def run_checks(
    paths: Optional[Sequence[str]] = None,
    checks: Optional[Iterable[str]] = None,
    root: Optional[str] = None,
) -> List[Finding]:
    """Run the selected checks (default: all) over the port's live tree
    (default) or explicit paths."""
    files, ctx = load_paths(paths) if paths else discover(root)
    return run_on(files, ctx, checks)


# ----------------------------------------------------------- ast utilities


def dotted_name(node: ast.AST) -> Optional[str]:
    """`a.b.c` -> "a.b.c" for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def terminal_name(node: ast.AST) -> Optional[str]:
    """The last segment of a Name/Attribute chain (`torch.cuda.graph` ->
    "graph")."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def resolve_str_arg(node: ast.AST, f: SourceFile) -> Optional[str]:
    """A Constant str, or a Name bound to a module-level str constant."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        return f.str_constants.get(node.id)
    return None
