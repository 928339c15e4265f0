"""The port's shadow deployment and online evaluation, on the CPU.

The cases of tests/test_shadow.py on the port, held against the JAX
package on the same numpy weights, streams and labels:

  * `StreamingWindowEvaluator` scores a window as the port's offline
    `EvaluationSuite` does, bit for bit, and within
    PORT_TOLERANCES["convert_scores"] of the JAX evaluator; grouped
    evaluators and empty windows are refused, `regression` points the
    reference's way;
  * the verdicts are the reference's on the same streams: a challenger with
    negated weights is rejected and removed, an identical one is promoted
    through the generation flip; the champion has no failed request and its
    solo engine's bits in both cases;
  * armed `shadow_mirror` and `label_join` faults degrade to champion-only
    serving (counted, never a failed request); a promotion that fails
    (`shadow_promote`) keeps the champion's old generation, bit-equal;
  * `cli.serve --shadow --labels` gives the JAX driver's shadow block and
    scores, and `cli.refresh --shadow-gate` commits a round.

Every wait is on a future, the controller's condition or its verdict
event, never on a clock.
"""

from __future__ import annotations

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.cli import serve as jax_serve
from photon_ml_tpu.evaluation.suite import EvaluationSuite as JaxEvaluationSuite
from photon_ml_tpu.evaluation.suite import EvaluatorType as JaxEvaluatorType
from photon_ml_tpu.evaluation.suite import StreamingWindowEvaluator as JaxStreamingWindowEvaluator
from photon_ml_tpu.game.model import Coefficients as JaxCoefficients
from photon_ml_tpu.game.model import FixedEffectModel as JaxFixedEffectModel
from photon_ml_tpu.game.model import GameModel as JaxGameModel
from photon_ml_tpu.game.model import RandomEffectModel as JaxRandomEffectModel
from photon_ml_tpu.serving import ScoreRequest as JaxScoreRequest
from photon_ml_tpu.serving import ServingBundle as JaxServingBundle
from photon_ml_tpu.serving.shadow import ShadowController as JaxShadowController
from photon_ml_tpu.serving.tenancy import TenantRegistry as JaxTenantRegistry
from photon_ml_tpu.transformers.game_transformer import CoordinateScoringSpec as JaxSpec
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu.utils import faults as jax_faults
from photon_ml_tpu.utils import telemetry as jax_telemetry
from photon_ml_tpu.utils.contracts import SERVING_SUMMARY_KEYS, SHADOW_BLOCK_KEYS
from photon_ml_tpu_torch.cli import refresh as refresh_cli
from photon_ml_tpu_torch.cli import serve as serve_cli
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.data.index_map import IndexMap
from photon_ml_tpu_torch.evaluation.suite import (
    EvaluationSuite,
    EvaluatorType,
    StreamingWindowEvaluator,
    regression,
)
from photon_ml_tpu_torch.game.model import Coefficients, FixedEffectModel, GameModel, RandomEffectModel
from photon_ml_tpu_torch.io import model_bridge, model_store, score_store
from photon_ml_tpu_torch.serving import ScoreRequest, ServingBundle, ServingEngine, ShadowController, TenantRegistry
from photon_ml_tpu_torch.transformers.game_transformer import CoordinateScoringSpec
from photon_ml_tpu_torch.types import TaskType
from photon_ml_tpu_torch.utils import faults, telemetry

pytestmark = pytest.mark.serving

TASK = TaskType.LOGISTIC_REGRESSION
JTASK = JaxTaskType.LOGISTIC_REGRESSION
D_FE, D_RE, E = 7, 5, 24
TOL = PORT_TOLERANCES["convert_scores"]  # float32 scoring and metrics in two frameworks


@pytest.fixture(autouse=True)
def _port_fault_hygiene(monkeypatch):
    """The port's fault plan and counters are its own process globals."""
    monkeypatch.setenv("PHOTON_RETRY_BASE_DELAY_S", "0.001")
    faults.clear()
    telemetry.METRICS.reset()
    yield
    faults.clear()
    telemetry.METRICS.reset()


def _weights(seed, scale=1.0):
    r = np.random.default_rng(seed)
    w = (scale * r.normal(size=D_FE)).astype(np.float32)
    M = np.zeros((E + 1, D_RE), np.float32)
    M[:E] = scale * r.normal(size=(E, D_RE))
    return w, M


def _specs():
    return {"fixed": CoordinateScoringSpec(shard="g"),
            "per-e": CoordinateScoringSpec(shard="re", random_effect_type="eid",
                                           entity_index={str(i): i for i in range(E)})}


def _port_model(seed, scale=1.0):
    w, M = _weights(seed, scale)
    return GameModel({"fixed": FixedEffectModel(Coefficients(torch.from_numpy(w)), TASK),
                      "per-e": RandomEffectModel(torch.from_numpy(M), None, TASK)})


def _bundle(seed, scale=1.0):
    return ServingBundle.from_model(_port_model(seed, scale), _specs(), TASK, device="cpu")


def _jax_bundle(seed, scale=1.0):
    w, M = _weights(seed, scale)
    model = JaxGameModel({"fixed": JaxFixedEffectModel(JaxCoefficients(jnp.asarray(w)), JTASK),
                          "per-e": JaxRandomEffectModel(jnp.asarray(M), None, JTASK)})
    specs = {"fixed": JaxSpec(shard="g"),
             "per-e": JaxSpec(shard="re", random_effect_type="eid",
                              entity_index={str(i): i for i in range(E)})}
    return JaxServingBundle.from_model(model, specs, JTASK)


def _docs(seed, n):
    """Offset-free traffic: a negated challenger scores the exact inverse."""
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, D_FE)).astype(np.float32)
    Xe = r.normal(size=(n, D_RE)).astype(np.float32)
    ids = r.integers(0, E + 6, size=n)
    return [dict(g=X[i], re=Xe[i], eid=str(int(ids[i])), uid=str(i)) for i in range(n)]


def _reqs(docs, cls=ScoreRequest):
    return [cls(features={"g": d["g"], "re": d["re"]}, entity_ids={"eid": d["eid"]}, uid=d["uid"])
            for d in docs]


def _solo(seed, reqs):
    with ServingEngine(_bundle(seed), max_batch=32) as eng:
        return [r.score for r in eng.score_batch(reqs)]


def _drive(reg, controller, reqs, labels):
    """Submit to the champion, mirror, join the label; the champion's
    scores (every future must resolve)."""
    futs = []
    for req, lab in zip(reqs, labels):
        fut = reg.submit("champ", req, block=True)
        futs.append(fut)
        if controller.mirror(req, fut):
            controller.record_label(req.uid, float(lab))
    return [f.result(timeout=60).score for f in futs]


# ---------------------------------------------------------- the evaluator


@pytest.mark.parametrize("name", ["AUC", "RMSE", "LOGISTIC_LOSS", "AUPR"])
def test_a_window_is_the_offline_suite_and_the_jax_evaluator(rng, name):
    n = 37
    scores = rng.normal(size=n).astype(np.float32)
    labels = (rng.uniform(size=n) < 0.5).astype(np.float32)
    weights = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    et = EvaluatorType.parse(name)
    got = StreamingWindowEvaluator([et]).evaluate_window(scores, labels, weights)
    offline = EvaluationSuite([et], torch.from_numpy(labels), torch.from_numpy(weights)).evaluate(
        torch.from_numpy(scores))
    assert got.results == offline.results
    want = JaxStreamingWindowEvaluator([JaxEvaluatorType.parse(name)]).evaluate_window(
        jnp.asarray(scores), jnp.asarray(labels), jnp.asarray(weights))
    ref = JaxEvaluationSuite([JaxEvaluatorType.parse(name)], jnp.asarray(labels),
                             jnp.asarray(weights)).evaluate(jnp.asarray(scores))
    assert want.results == ref.results
    np.testing.assert_allclose(got.primary_value, want.primary_value, rtol=TOL["rtol"], atol=TOL["atol"])


def test_grouped_evaluators_empty_windows_and_the_regression_direction():
    with pytest.raises(ValueError, match="grouped"):
        StreamingWindowEvaluator([EvaluatorType.parse("AUC:userId")])
    with pytest.raises(ValueError, match="at least one"):
        StreamingWindowEvaluator([])
    with pytest.raises(ValueError, match="empty evaluation window"):
        StreamingWindowEvaluator([EvaluatorType("AUC")]).evaluate_window(np.zeros(0), np.zeros(0))
    assert regression(EvaluatorType("AUC"), 0.7, 0.8) == pytest.approx(0.1)
    assert regression(EvaluatorType("RMSE"), 0.9, 0.8) == pytest.approx(0.1)


# ------------------------------------------------------------- verdicts


def _run_port(chall_scale, reqs, labels, **ctl):
    with TenantRegistry(max_batch=32, max_wait_ms=2.0) as reg:
        reg.admit("champ", _bundle(1))
        controller = ShadowController(reg, "champ", "cand", _bundle(1, chall_scale), window_size=8,
                                      min_windows=2, cooldown_s=0.0, **ctl)
        try:
            got = _drive(reg, controller, reqs, labels)
            verdict = controller.wait_for_verdict(timeout_s=60.0)
            controller.drain(timeout_s=60.0)
            block = controller.summary()
        finally:
            controller.close()
        after = [reg.submit("champ", r, block=True).result(timeout=60).score for r in reqs]
        m = reg.metrics()
        version = reg.tenant("champ").engine.bundle_version
        names = reg.tenant_names
    return dict(got=got, verdict=verdict, block=block, after=after, metrics=m, version=version,
                names=names)


def _run_jax(chall_scale, docs, labels):
    reqs = _reqs(docs, JaxScoreRequest)
    reg = JaxTenantRegistry(max_batch=32, max_wait_ms=2.0)
    try:
        reg.admit("champ", _jax_bundle(1))
        controller = JaxShadowController(reg, "champ", "cand", _jax_bundle(1, chall_scale),
                                         window_size=8, min_windows=2, cooldown_s=0.0)
        try:
            _drive(reg, controller, reqs, labels)
            verdict = controller.wait_for_verdict(timeout_s=60.0)
            block = controller.summary()
        finally:
            controller.close()
    finally:
        reg.close(release_bundles=True)
    jax_faults.clear()
    return verdict, block


@pytest.mark.parametrize("scale,verdict", [(-1.0, "reject"), (1.0, "promote")])
def test_the_verdicts_are_the_references_and_the_champion_is_untouched(scale, verdict):
    docs = _docs(41, 16)
    reqs = _reqs(docs)
    ref = _solo(1, reqs)
    labels = (np.asarray(ref) > 0.0).astype(np.float32)  # the champion separates them
    port = _run_port(scale, reqs, labels)
    want_verdict, want_block = _run_jax(scale, docs, labels)
    assert port["verdict"] == want_verdict == verdict
    block = port["block"]
    assert tuple(block) == SHADOW_BLOCK_KEYS
    exact = [k for k in SHADOW_BLOCK_KEYS if not isinstance(want_block[k], float)]  # the counts and names
    assert {k: block[k] for k in exact} == {k: want_block[k] for k in exact}
    np.testing.assert_allclose([block["champion_metric"], block["challenger_metric"]],
                               [want_block["champion_metric"], want_block["challenger_metric"]],
                               rtol=TOL["rtol"], atol=TOL["atol"])
    assert port["got"] == ref and port["metrics"]["tenants"]["champ"]["failed"] == 0
    assert port["names"] == ["champ"]  # the challenger is gone either way
    if verdict == "reject":
        assert port["version"] == 0 and port["after"] == ref
        assert faults.counters()["shadow_rollbacks"] == 1
    else:
        assert port["version"] == 1 and port["after"] == ref  # the same weights, a new generation
        assert telemetry.METRICS.get_counter("shadow_promotions") == 1
    assert port["metrics"]["cobatch_compiles_after_warmup"] == 0


def test_mirror_and_join_faults_serve_the_champion_only():
    reqs = _reqs(_docs(43, 24))
    ref = _solo(1, reqs)
    labels = (np.asarray(ref) > 0.0).astype(np.float32)
    with faults.inject("shadow_mirror@1+3+5+7,label_join@2+4"):
        port = _run_port(1.0, reqs, labels, auto_actuate=False)
    block = port["block"]
    assert port["got"] == ref and port["metrics"]["tenants"]["champ"]["failed"] == 0
    assert block["mirror_failures"] == 4 and block["label_join_failures"] == 2
    assert block["mirrored_requests"] == 20
    assert faults.counters()["shadow_mirror_failures"] == 4
    assert faults.counters()["label_join_failures"] == 2
    # 18 joined rows: two windows of 8, a promote verdict held for the caller.
    assert port["verdict"] == "promote" and block["status"] == "promote_ready" and port["version"] == 0


def test_a_failed_promotion_keeps_the_old_generation():
    reqs = _reqs(_docs(44, 16))
    ref = _solo(1, reqs)
    labels = (np.asarray(ref) > 0.0).astype(np.float32)
    with faults.inject("shadow_promote:99"):
        port = _run_port(1.0, reqs, labels)
    assert port["verdict"] == "promote" and port["block"]["status"] == "rejected"
    assert port["version"] == 0 and port["got"] == ref and port["after"] == ref
    assert port["names"] == ["champ"]
    assert faults.counters()["shadow_rollbacks"] == 1
    assert port["metrics"]["tenants"]["champ"]["failed"] == 0


# ---------------------------------------------------------------- drivers


def _save(mdir, seed, scale=1.0):
    art = model_bridge.artifact_from_game_model(_port_model(seed, scale), _specs(), TASK)
    maps = {"g": IndexMap.from_feature_names([f"f{i}" for i in range(D_FE)]),
            "re": IndexMap.from_feature_names([f"r{i}" for i in range(D_RE)])}
    model_store.save_game_model(str(mdir), art, maps)
    os.makedirs(mdir / "feature-indexes", exist_ok=True)
    for shard, imap in maps.items():
        imap.save(str(mdir / "feature-indexes" / f"{shard}.json"))


def _shadow_args(tmp_path, n):
    """An identical champion and challenger, n JSON-line requests and their
    labels; the `cli.serve --shadow --labels` arguments both drivers take."""
    _save(tmp_path / "champ", 1)
    _save(tmp_path / "cand", 1)
    docs = _docs(45, n)
    ref = _solo(1, _reqs(docs))
    with open(tmp_path / "r.jsonl", "w") as f:
        for d in docs:
            f.write(json.dumps({"uid": d["uid"], "ids": {"eid": d["eid"]},
                                "features": {"g": d["g"].tolist(), "re": d["re"].tolist()}}) + "\n")
    with open(tmp_path / "labels.jsonl", "w") as f:
        for d, s in zip(docs, ref):
            f.write(json.dumps({"uid": d["uid"], "label": float(s > 0.0)}) + "\n")
    return ["--model-input-directory", str(tmp_path / "champ"), "--shadow", f"cand={tmp_path / 'cand'}",
            "--labels", str(tmp_path / "labels.jsonl"), "--requests", str(tmp_path / "r.jsonl"),
            "--logging-level", "ERROR"]


def test_cli_serve_shadow_gives_the_jax_drivers_block_and_scores(tmp_path):
    common = [*_shadow_args(tmp_path, 160), "--shadow-window", "32", "--max-batch", "32",
              "--max-pending", "1024"]  # no mirror is shed
    port = serve_cli.main([*common, "--root-output-directory", str(tmp_path / "port"), "--device", "cpu"])
    jax_serve.main([*common, "--root-output-directory", str(tmp_path / "jax")])
    jax_faults.clear()
    with open(tmp_path / "jax" / "serving-summary.json") as f:
        want = json.load(f)
    assert sorted(port) == sorted(want) == sorted(SERVING_SUMMARY_KEYS)
    assert tuple(port["shadow"]) == tuple(want["shadow"]) == SHADOW_BLOCK_KEYS
    # The requests mirrored before the verdict stops the mirror depend on how
    # soon the evaluation thread acts; the windows to the verdict do not.
    exact = [k for k in SHADOW_BLOCK_KEYS
             if not isinstance(want["shadow"][k], float) and k != "mirrored_requests"]
    assert {k: port["shadow"][k] for k in exact} == {k: want["shadow"][k] for k in exact}
    assert port["shadow"]["status"] == "promoted" and port["failed_requests"] == want["failed_requests"] == 0
    ours, theirs = (score_store.load_score_columns(str(tmp_path / pkg / "scores")) for pkg in ("port", "jax"))
    by_uid = dict(zip(theirs.uids, theirs.scores))
    np.testing.assert_allclose(ours.scores, [by_uid[u] for u in ours.uids], rtol=TOL["rtol"], atol=TOL["atol"])
    types = [json.loads(line)["type"] for line in open(tmp_path / "port" / "journal.jsonl")]
    assert {"shadow_start", "shadow_window", "shadow_verdict", "shadow_promote"} <= set(types)
    assert telemetry.validate_journal(str(tmp_path / "port" / "journal.jsonl"))[1] == []


def test_cli_serve_shadow_at_the_default_quota_sheds_mirrors_as_the_reference_does(tmp_path):
    """At the default quota (PHOTON_TENANT_MAX_PENDING) the champion's
    submit waits for a slot while the mirror's does not, so a challenger
    that lags sheds mirrors; both drivers count each as a mirror failure
    and as a shed request, and no request fails. How many are shed
    depends on the threads' timing, in both packages."""
    common = [*_shadow_args(tmp_path, 2048), "--shadow-window", "128"]
    jax_telemetry.METRICS.reset()
    port = serve_cli.main([*common, "--root-output-directory", str(tmp_path / "port"), "--device", "cpu"])
    jax_serve.main([*common, "--root-output-directory", str(tmp_path / "jax")])
    jax_faults.clear()
    with open(tmp_path / "jax" / "serving-summary.json") as f:
        want = json.load(f)
    for summary in (port, want):
        counters = summary["robustness_counters"]
        assert summary["failed_requests"] == 0 and summary["num_requests"] == 2048
        assert summary["shadow"]["status"] == "promoted" and summary["shadow"]["label_join_failures"] == 0
        assert summary["shadow"]["mirror_failures"] == counters["shadow_mirror_failures"] \
            == counters.get("serving_shed_requests", 0)
        assert summary["tenants"]["champion"]["shed"] == 0


def test_cli_refresh_shadow_gate_commits_a_round(tmp_path, monkeypatch):
    # 8-row probe windows are noisier than the strict default tolerance.
    monkeypatch.setenv("PHOTON_SHADOW_REGRESSION_TOL", "0.35")
    refresh_cli.main(["--root-output-directory", str(tmp_path), "--synthetic", "--rounds", "1",
                      "--base-rows", "96", "--batch-rows", "48", "--entities", "8",
                      "--new-entities-per-round", "1", "--churn-entities", "2", "--shadow-gate",
                      "--probe-rows", "16", "--device", "cpu", "--logging-level", "WARNING"])
    with open(tmp_path / "refresh-summary.json") as f:
        (rec,) = json.load(f)["rounds"]
    assert rec["shadow_verdict"] == "promote" and rec["committed"] and rec["generation"] == 1
    assert tuple(rec["shadow"]) == SHADOW_BLOCK_KEYS and rec["shadow"]["status"] == "promote_ready"
    types = [json.loads(line)["type"] for line in open(tmp_path / "journal.jsonl")]
    assert types.count("delta_apply") == 1 and "delta_rollback" not in types
    assert telemetry.validate_journal(str(tmp_path / "journal.jsonl"))[1] == []
