"""photon-lint over the port (photon_ml_tpu_torch/analysis/) against the
JAX package's (photon_ml_tpu/analysis/).

* The seven checks whose rule carries over, and the pragma engine, give
  the JAX lint's findings on its fixture corpus (tests/analysis_fixtures/):
  the same (check, file, line), and the same message once the reference's
  module paths are read as the port's.
* The two checks re-aimed at captured CUDA graphs (jit-purity,
  donation-aliasing) fire on each form in their own bad fixtures
  (tests/torch_lint/analysis_fixtures/) and stay silent on the good ones
  and on the serving engines that capture and replay.
* The port's live tree (the package, chip_smoke.py, tools/ and
  tests/test_torch_*.py) has zero findings: a tier-1 gate.
* The CLI's exit codes, `knobs --table` against README.md's port section,
  and `faults --list-sites` against the reference's.
"""

from __future__ import annotations

import os
import re

import pytest

import photon_ml_tpu.analysis as jax_lint
from photon_ml_tpu.utils import faults as jax_faults
from photon_ml_tpu_torch import analysis as lint
from photon_ml_tpu_torch.analysis import core
from photon_ml_tpu_torch.analysis.__main__ import main as lint_main
from photon_ml_tpu_torch.analysis.knob_registry import PORT_TABLE_BEGIN, PORT_TABLE_END
from photon_ml_tpu_torch.utils import faults, knobs

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
REFERENCE_FIXTURES = os.path.join(TESTS, "analysis_fixtures")
PORT_FIXTURES = os.path.join(TESTS, "torch_lint", "analysis_fixtures")

# Fixture directory -> the check it is run under (pragma/ is the pragma
# engine's, exercised through thread-lifecycle as the reference's test does).
CARRIED = {
    "knob_registry": "knob-registry",
    "fault_site_sync": "fault-site-sync",
    "thread_lifecycle": "thread-lifecycle",
    "contract_key_drift": "contract-key-drift",
    "metric_name_sync": "metric-name-sync",
    "planner_constant": "planner-constant",
    "tolerance_pin": "tolerance-pin",
    "pragma": "thread-lifecycle",
}

# The reference's module paths and pinned tables, as the port names them.
_PORT_NAMES = (
    ("photon_ml_tpu.", "photon_ml_tpu_torch."),
    ("photon_ml_tpu/", "photon_ml_tpu_torch/"),
    ("utils/contracts", "contracts"),
    ("TIER_TOLERANCES / PALLAS_GATE_TOLERANCES", "PORT_TOLERANCES / TIER_TOLERANCES"),
)
# A message's closing attribution to the change history it came from.
_ATTRIBUTION = re.compile(r" \(the [^()]*bug class\)$")


def _as_port(message: str) -> str:
    for ref, port in _PORT_NAMES:
        message = message.replace(ref, port)
    return _ATTRIBUTION.sub("", message)


def _rows(findings, normalise=lambda m: m):
    return [(f.check, f.path, f.line, _ATTRIBUTION.sub("", normalise(f.message))) for f in findings]


def test_the_port_registers_the_reference_checks():
    assert set(lint.CHECKS) == set(jax_lint.CHECKS)
    for name, check in lint.CHECKS.items():
        assert check.scopes == jax_lint.CHECKS[name].scopes, name


@pytest.mark.parametrize("kind", ["bad", "good"])
@pytest.mark.parametrize("fixture", sorted(CARRIED))
def test_carried_check_matches_the_reference_on_its_fixtures(fixture, kind):
    path = os.path.join(REFERENCE_FIXTURES, fixture, kind)
    check = CARRIED[fixture]
    ours = lint.run_checks(paths=[path], checks=[check])
    theirs = jax_lint.run_checks(paths=[path], checks=[check])
    assert _rows(ours) == _rows(theirs, _as_port)
    assert bool(ours) == (kind == "bad")


# ------------------------------------------------- checks re-aimed at graphs


def _port_fixture(check: str, kind: str) -> str:
    return os.path.join(PORT_FIXTURES, check.replace("-", "_"), kind)


def test_capture_purity_fires_on_each_form_and_impurity():
    found = lint.run_checks(paths=[_port_fixture("jit-purity", "bad")], checks=["jit-purity"])
    assert {f.check for f in found} == {"jit-purity"}
    msgs = "\n".join(f.message for f in found)
    for needle in ("os.getenv", "np.random", "time.perf_counter()", ".item()", "global",
                   "os.environ", "one call deep from the captured body of 'program'"):
        assert needle in msgs, needle
    lines = open(os.path.join(_port_fixture("jit-purity", "bad"), "app.py")).read().splitlines()
    flagged = {lines[f.line - 1].strip() for f in found}
    # The nested def, the lambda, the `with torch.cuda.graph` body, the helper.
    assert any("np.random" in s for s in flagged)
    assert any("lambda" in s for s in flagged)
    assert any("os.environ" in s for s in flagged) and "global CAPTURES" in flagged
    assert any("os.getenv" in s for s in flagged)


def test_graph_output_fires_on_each_form():
    found = lint.run_checks(paths=[_port_fixture("donation-aliasing", "bad")],
                            checks=["donation-aliasing"])
    lines = open(os.path.join(_port_fixture("donation-aliasing", "bad"), "app.py")).read().splitlines()
    flagged = [lines[f.line - 1].strip() for f in found]
    assert flagged == ["results.append(out)  # every entry is the one output tensor",
                       "return self.out[0] - first  # `first` is now the second replay's answer",
                       "seen.append(y)"]
    assert [m.message.split(" holds ")[0] for m in found] == ["'out'", "'first'", "'y'"]


@pytest.mark.parametrize("check", ["jit-purity", "donation-aliasing"])
def test_reaimed_check_is_silent_on_its_good_fixture(check):
    assert lint.run_checks(paths=[_port_fixture(check, "good")], checks=[check]) == []


@pytest.mark.parametrize("module", ["serving/engine.py", "serving/tenancy.py"])
def test_the_engines_that_capture_and_replay_are_silent(module):
    """engine.py captures each bucket program by a def nested in __init__
    and replays it with `replay(); host_out.copy_(self.out)`; tenancy.py's
    co-batch programs do the same."""
    path = os.path.join(REPO, "photon_ml_tpu_torch", module)
    text = open(path).read()
    assert "capture_graph(program, device)" in text and "host_out.copy_(self.out" in text
    assert lint.run_checks(paths=[path], checks=["jit-purity", "donation-aliasing"]) == []


def test_a_keyword_only_counter_default_is_a_plant():
    good = _port_fixture("metric-name-sync", "good")
    assert lint.run_checks(paths=[good], checks=["metric-name-sync"]) == []
    # The reference reads positional defaults only, so it misses the plant.
    theirs = jax_lint.run_checks(paths=[good], checks=["metric-name-sync"])
    assert [f.message.split(" is declared")[0] for f in theirs] == ["metric 'retries'"]
    bad = lint.run_checks(paths=[_port_fixture("metric-name-sync", "bad")], checks=["metric-name-sync"])
    assert sorted(f.message.split(" — ")[0] for f in bad) == [
        "metric 'retries' is declared in METRIC_DESCRIPTIONS but nothing increments it",
        "metric 'retrys' is not declared in METRIC_DESCRIPTIONS"]


# ---------------------------------------------------------------- live tree


@pytest.fixture(scope="module")
def live():
    files, ctx = core.discover()
    return files, core.run_on(files, ctx)


def test_the_port_tree_is_clean(live):
    """THE gate: zero findings over the port's package, its drivers and its
    tests (pragma hygiene cannot be suppressed, so no reasonless pragma
    exists either)."""
    _, findings = live
    assert not findings, "photon-lint findings on the port's tree:\n" + "\n".join(
        f.render() for f in findings)


def test_the_port_tree_is_the_ports_files(live):
    files, _ = live
    by_cat = {}
    for f in files:
        by_cat.setdefault(f.category, []).append(f.rel.replace(os.sep, "/"))
    assert set(by_cat) == {"package", "bench", "tests"}
    assert all(p.startswith("photon_ml_tpu_torch/") for p in by_cat["package"])
    assert "photon_ml_tpu_torch/analysis/core.py" in by_cat["package"]
    assert "chip_smoke.py" in by_cat["bench"] and "tools/chip_smoke_sweep.py" in by_cat["bench"]
    assert all(p == "chip_smoke.py" or p.startswith("tools/") for p in by_cat["bench"])
    assert "tests/test_torch_analysis.py" in by_cat["tests"]
    assert all(re.fullmatch(r"tests/test_torch_\w+\.py", p) for p in by_cat["tests"])
    assert not any("analysis_fixtures" in f.rel for f in files)


def test_pragmas_sit_only_where_the_finding_is_by_design(live):
    """The two fault sites the port never plants (SITE_DESCRIPTIONS stays
    the reference's) and the batcher waits chip_smoke.py pins for a
    measurement."""
    files, _ = live
    seen = []
    for f in files:
        for p in f.pragmas:
            target = f.lines[p.attach_line - 1].strip()
            seen.append((f.rel.replace(os.sep, "/"), p.checks))
            if p.checks == ("fault-site-sync",):
                assert target.startswith(('"pack":', '"upload":')), target
            else:
                assert p.checks == ("planner-constant",) and "max_wait_ms=" in target, target
    assert set(seen) == {("photon_ml_tpu_torch/utils/faults.py", ("fault-site-sync",)),
                         ("chip_smoke.py", ("planner-constant",))}
    assert seen.count(("photon_ml_tpu_torch/utils/faults.py", ("fault-site-sync",))) == 2


# ---------------------------------------------------------------------- CLI


def test_cli_list_checks_and_exit_codes(capsys):
    assert lint_main(["--list-checks"]) == 0
    out = capsys.readouterr().out
    for name in lint.CHECKS:
        assert name in out
    assert lint_main([_port_fixture("donation-aliasing", "bad")]) == 1
    assert "donation-aliasing" in capsys.readouterr().out
    assert lint_main([_port_fixture("donation-aliasing", "good")]) == 0
    # The re-aimed checks look for captured graphs; the reference's fixtures
    # (jax.jit, donate_argnums) have none.
    for check in ("jit-purity", "donation-aliasing"):
        path = os.path.join(REFERENCE_FIXTURES, check.replace("-", "_"), "bad")
        assert lint_main(["--check", check, path]) == 0
    assert lint_main(["--check", "no-such-check"]) == 2
    assert lint_main([os.path.join(REPO, "README.md.missing")]) == 2


def test_knobs_table_is_the_readme_port_section(capsys):
    readme = open(os.path.join(REPO, "README.md")).read()
    start = readme.index(PORT_TABLE_BEGIN) + len(PORT_TABLE_BEGIN)
    section = readme[start:readme.index(PORT_TABLE_END, start)].strip()
    assert knobs.main(["--table"]) == 0
    assert capsys.readouterr().out.strip() == section == knobs.readme_table()
    # Every row is a registered knob of the port, and of the JAX package.
    from photon_ml_tpu.utils import knobs as jax_knobs
    named = re.findall(r"^\| `(PHOTON_\w+)` \|", section, re.MULTILINE)
    assert named == sorted(knobs.KNOBS) and set(named) <= set(jax_knobs.KNOBS)


def test_faults_list_sites_lists_the_reference_sites(capsys):
    assert faults.main(["--list-sites"]) == 0
    ours = capsys.readouterr().out
    assert jax_faults.main(["--list-sites"]) == 0
    assert ours == capsys.readouterr().out
    listed = [line.split()[0] for line in ours.splitlines()[1:]]
    assert listed == list(jax_faults.KNOWN_SITES)
    assert faults.main([]) == 2
