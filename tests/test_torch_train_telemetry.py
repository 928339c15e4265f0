"""The training drivers' telemetry and the staged checkpoint write, the
port against the JAX package on the CPU.

  * `cli.train` on a small GLMix (a fixed effect and two random effects,
    a validation file, a checkpoint directory, PHOTON_TRACE=1) in both
    packages: the journals list the same lifecycle, each `profile.json`
    reads back through both packages' `read_profile(kind="fit")` with the
    same sections, and the port's `trace.json` holds the fit, its updates,
    each file's decode and every timed section, and covers the span names
    of the JAX run but those with no counterpart in the port.
  * A job that fails after set-up journals `failure` in both packages;
    `cli.glm_driver` journals the JAX driver's events.
  * The staged checkpoint write (`pipeline=True`): the models, the files
    and state.json's checksums equal those of the synchronous write; spent
    retries of the background write fall back to the synchronous write; a
    crash between the staged write and its commit resumes from the step
    before; ranks refuse it; the JAX package resumes a staged checkpoint.
  * An untraced fit opens no span; PHOTON_PIPELINE reads as the
    reference's `pipeline_enabled`.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from photon_ml_tpu.cli import glm_driver as jax_glm_driver
from photon_ml_tpu.cli import train as jax_train_cli
from photon_ml_tpu.data import pipeline as jax_pipeline
from photon_ml_tpu.game.coordinate_descent import run_coordinate_descent as jax_run
from photon_ml_tpu.utils import telemetry as jax_telemetry
from photon_ml_tpu.utils.contracts import JOURNAL_LINE_KEYS, PROFILE_FIT_KEYS
from photon_ml_tpu_torch.cli import glm_driver
from photon_ml_tpu_torch.cli import train as train_cli
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.data.game_dataset import FixedEffectDataConfig, RandomEffectDataConfig
from photon_ml_tpu_torch.estimators.game_estimator import GameEstimator
from photon_ml_tpu_torch.evaluation.suite import EvaluatorType
from photon_ml_tpu_torch.game import checkpoint
from photon_ml_tpu_torch.io.avro_data import FeatureShardConfig, read_game_dataset, write_training_examples
from photon_ml_tpu_torch.optimize.config import L2, CoordinateOptimizationConfig, OptimizerConfig
from photon_ml_tpu_torch.types import TaskType
from photon_ml_tpu_torch.utils import faults, knobs, telemetry

TOL = PORT_TOLERANCES["estimator"]
SHARD = "name=g,feature.bags=features,intercept=true"
COORDINATES = [
    "name=global,feature.shard=g,optimizer=LBFGS,tolerance=1e-7,max.iter=30,regularization=L2,"
    "reg.weights=1",
    "name=per-user,random.effect.type=userId,feature.shard=g,optimizer=LBFGS,max.iter=20,"
    "regularization=L2,reg.weights=10,min.bucket=4",
    "name=per-movie,random.effect.type=movieId,feature.shard=g,optimizer=LBFGS,max.iter=20,"
    "regularization=L2,reg.weights=10,min.bucket=4",
]
RE_IDS = ("per-user", "per-movie")
# JAX spans with no counterpart in the port: the host pipeline's background
# jobs and the bucketed pack's stages (the port's shards live on their
# device from ingest on, and it builds its sparse layouts there).
JAX_ONLY_SPANS = {"async_upload", "async_pack", "background_pack", "pack", "pack_device", "pack_host"}


def write_glmix_files(root: Path, n_train: int = 600, n_val: int = 200) -> Path:
    """train.avro and validation.avro: 4 features, 12 users and 8 movies,
    labels from a fixed, a per-user and a per-movie margin."""
    data = root / "data"
    data.mkdir(parents=True, exist_ok=True)
    w = np.random.default_rng(99).normal(size=4)
    bu = np.random.default_rng(98).normal(size=12)
    bm = np.random.default_rng(97).normal(size=8)
    for name, seed, n in (("train", 1, n_train), ("validation", 2, n_val)):
        rng = np.random.default_rng(seed)
        X = rng.normal(size=(n, 4))
        u, m = rng.integers(0, 12, size=n), rng.integers(0, 8, size=n)
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-(X @ w + bu[u] + bm[m])))).astype(np.float32)
        write_training_examples(str(data / f"{name}.avro"),
                                [[(f"f{j}", float(X[i, j])) for j in range(4)] for i in range(n)],
                                y.tolist(), uids=[f"uid{i}" for i in range(n)],
                                id_tags={"userId": [f"u{e}" for e in u], "movieId": [f"m{e}" for e in m]})
    return data


def train_args(data: Path, out: Path, checkpoint_dir: Path, iterations: int = 1):
    return ["--training-task", "LOGISTIC_REGRESSION",
            "--input-data-directories", str(data / "train.avro"),
            "--validation-data-directories", str(data / "validation.avro"),
            "--root-output-directory", str(out), "--override-output-directory",
            "--feature-shard-configurations", SHARD, "--coordinate-configurations", *COORDINATES,
            "--coordinate-descent-iterations", str(iterations), "--validation-evaluators", "AUC",
            "--checkpoint-directory", str(checkpoint_dir), "--output-mode", "BEST",
            "--logging-level", "WARNING"]


def run_both(root: Path, data: Path, traced: bool) -> dict:
    """cli.train of both packages on the same files; {"port", "jax"} ->
    output root."""
    outs = {k: root / k for k in ("port", "jax")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PHOTON_TRACE", "1" if traced else "0")
        train_cli.main(train_args(data, outs["port"], root / "port-ck") + ["--device", "cpu"])
        jax_train_cli.main(train_args(data, outs["jax"], root / "jax-ck"))
    return outs


def journal_lines(path: Path):
    return [json.loads(line) for line in path.read_text().splitlines() if line.strip()]


@pytest.fixture(autouse=True)
def _port_fault_hygiene():
    faults.clear()
    telemetry.METRICS.reset()
    yield
    faults.clear()
    telemetry.METRICS.reset()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_telemetry")
    data = write_glmix_files(root)
    return dict(data=data, **run_both(root, data, traced=True))


# ------------------------------------------------------------------- journal


def test_the_journals_list_the_same_lifecycle(runs):
    port = journal_lines(runs["port"] / "journal.jsonl")
    jax = journal_lines(runs["jax"] / "journal.jsonl")
    assert [d["type"] for d in port] == [d["type"] for d in jax]
    assert [d["type"] for d in port] == ["setup", "fit_start", "sweep_config"] + \
        ["coordinate_update", "checkpoint"] * 3 + ["fit_finish"]
    for a, b in zip(port, jax):
        assert set(a) == set(b) and set(JOURNAL_LINE_KEYS) <= set(a)
        if a["type"] == "setup":
            assert a["args"] and b["args"]
        elif a["type"] == "coordinate_update":
            assert (a["iteration"], a["coordinate"], a["accepted"]) == \
                (b["iteration"], b["coordinate"], b["accepted"])
            assert a["seconds"] > 0 and b["seconds"] > 0
        elif a["type"] == "fit_finish":
            assert a["num_configs"] == b["num_configs"] == 1
            assert abs(a["best_metric"] - b["best_metric"]) <= TOL["metric_atol"]
        elif a["type"] != "setup":
            assert {k: v for k, v in a.items() if k != "ts"} == {k: v for k, v in b.items() if k != "ts"}
    for k in ("port", "jax"):
        path = str(runs[k] / "journal.jsonl")
        assert telemetry.validate_journal(path) == jax_telemetry.validate_journal(path)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_a_job_that_fails_after_setup_journals_failure(runs, tmp_path, package):
    args = train_args(runs["data"], tmp_path / "out", tmp_path / "ck")
    args[args.index("--input-data-directories") + 1] = str(tmp_path / "missing.avro")
    with pytest.raises(Exception):
        if package == "port":
            train_cli.main(args + ["--device", "cpu"])
        else:
            jax_train_cli.main(args)
    lines = journal_lines(tmp_path / "out" / "journal.jsonl")
    assert [d["type"] for d in lines] == ["setup", "failure"]
    assert lines[-1]["error"]
    # The journal was closed and taken out of the ambient slot.
    assert telemetry.current_journal() is None and jax_telemetry.current_journal() is None
    assert telemetry.validate_journal(str(tmp_path / "out" / "journal.jsonl"))[1] == []


def test_the_glm_driver_journals_the_jax_drivers_events(tmp_path):
    rng = np.random.default_rng(4)
    w = rng.normal(size=6)
    for split, n in (("train", 300), ("test", 100)):
        X = rng.uniform(-1, 1, size=(n, 6))
        y = np.where(rng.uniform(size=n) < 1 / (1 + np.exp(-(X @ w))), 1, -1)
        (tmp_path / f"{split}.libsvm").write_text("".join(
            f"{y[i]} " + " ".join(f"{j + 1}:{X[i, j]:.6f}" for j in range(6)) + "\n" for i in range(n)))
    args = ["--training-data-directory", str(tmp_path / "train.libsvm"), "--format", "LIBSVM",
            "--validate-data-directory", str(tmp_path / "test.libsvm"),
            "--regularization-weights", "0.1,1,10"]
    glm_driver.run(glm_driver.build_parser().parse_args(
        args + ["--output-directory", str(tmp_path / "port"), "--device", "cpu"]))
    jax_glm_driver.run(jax_glm_driver.build_parser().parse_args(
        args + ["--output-directory", str(tmp_path / "jax")]))
    port, jax = (journal_lines(tmp_path / k / "journal.jsonl") for k in ("port", "jax"))
    strip = lambda d: {k: v for k, v in d.items() if k != "ts"}
    assert [strip(d) for d in port] == [strip(d) for d in jax] == [
        {"type": "fit_start", "num_samples": -1},
        {"type": "fit_finish", "num_configs": 3, "best_metric": None}]
    # A failed stage still closes the journal.
    with pytest.raises(ValueError):
        glm_driver.run(glm_driver.build_parser().parse_args(
            args[:-1] + [" ", "--output-directory", str(tmp_path / "bad"), "--device", "cpu"]))
    assert [d["type"] for d in journal_lines(tmp_path / "bad" / "journal.jsonl")] == ["fit_start"]


# ------------------------------------------------------------------- profile


def test_each_profile_reads_back_through_both_packages(runs):
    profiles = {}
    for k in ("port", "jax"):
        path = str(runs[k] / "profile.json")
        ours, theirs = telemetry.read_profile(path, kind="fit"), jax_telemetry.read_profile(path, kind="fit")
        assert ours == theirs
        profiles[k] = ours
    port, jax = profiles["port"], profiles["jax"]
    assert set(PROFILE_FIT_KEYS) <= set(port)
    # Both carry the planner's `plan` block: inactive on an unplanned fit.
    assert set(port) == set(jax) and port["plan"] == jax["plan"] == port["fit_timing"]["plan"]
    assert port["plan"]["active"] is False
    assert set(port["dispatch"]) == set(jax["dispatch"])
    assert set(port["dispatch"]["sharding"]) == set(jax["dispatch"]["sharding"])
    assert port["dispatch"]["sharding"]["rows_per_shard"] == jax["dispatch"]["sharding"]["rows_per_shard"]
    assert port["dispatch"]["pack_path"] == "none" and port["dispatch"]["layout"] == "csr_tiles"
    assert set(port["bucket_shapes"]) == set(jax["bucket_shapes"]) == set(RE_IDS)
    for cid in RE_IDS:
        assert sum(n for n, _ in port["bucket_shapes"][cid]) == sum(n for n, _ in jax["bucket_shapes"][cid])
    summary = json.loads((runs["port"] / "training-summary.json").read_text())
    assert port["fit_timing"] == summary["fit_timing"]
    assert port["device_topology"]["platform"] == "cpu" and port["ingest"]["ingest_path"].startswith("native")


@pytest.mark.parametrize("section", PROFILE_FIT_KEYS)
def test_a_dropped_profile_section_raises_in_both_packages(runs, tmp_path, section):
    profile = json.loads((runs["port"] / "profile.json").read_text())
    del profile[section]
    broken = tmp_path / "broken.json"
    broken.write_text(json.dumps(profile))
    for read in (telemetry.read_profile, jax_telemetry.read_profile):
        with pytest.raises(ValueError, match=section):
            read(str(broken))
        with pytest.raises(ValueError, match="kind"):
            read(str(runs["port"] / "profile.json"), kind="serve")
    with pytest.raises(ValueError, match=section):
        telemetry.write_profile(str(tmp_path / "again.json"), profile)


# --------------------------------------------------------------------- trace


def test_the_trace_covers_the_fit_and_the_jax_runs_spans(runs):
    spans = {}
    for k in ("port", "jax"):
        doc = json.loads((runs[k] / "trace.json").read_text())
        spans[k] = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    names = [e["name"] for e in spans["port"]]
    assert names.count("fit") == 1 and names.count("coordinate_update") == 3
    assert sorted(e["args"]["file"] for e in spans["port"] if e["name"] == "decode_file") == \
        ["train.avro", "validation.avro"]
    timed = set(json.loads((runs["port"] / "training-summary.json").read_text())["timings_s"])
    assert {t for t in timed if not t.startswith("coordinate ")} <= set(names)
    writes = [e for e in spans["port"] if e["name"] == "ckpt_write"]
    assert len(writes) == 3 and all(e["args"]["parent_id"] for e in writes)
    assert set(e["name"] for e in spans["jax"]) - JAX_ONLY_SPANS <= set(names)


# -------------------------------------------------------- staged model write


def _estimator_fit(data: Path, ck: Path, pipeline: bool, iterations: int = 2):
    shards = {"g": FeatureShardConfig(("features",), True)}
    train, imaps = read_game_dataset(str(data / "train.avro"), shards, id_tag_fields=["userId", "movieId"],
                                     device="cpu")
    val, _ = read_game_dataset(str(data / "validation.avro"), shards, index_maps=imaps,
                               id_tag_fields=["userId", "movieId"], device="cpu")
    fe = CoordinateOptimizationConfig(optimizer=OptimizerConfig(max_iterations=30, tolerance=1e-7),
                                      regularization=L2, reg_weight=1.0)
    re = CoordinateOptimizationConfig(optimizer=OptimizerConfig(max_iterations=20), regularization=L2,
                                      reg_weight=10.0)
    est = GameEstimator(
        TaskType.LOGISTIC_REGRESSION,
        {"global": FixedEffectDataConfig("g"),
         "per-user": RandomEffectDataConfig("userId", "g", min_bucket=4),
         "per-movie": RandomEffectDataConfig("movieId", "g", min_bucket=4)},
        coordinate_descent_iterations=iterations, validation_evaluators=[EvaluatorType("AUC")],
        checkpoint_dir=str(ck), pipeline=pipeline)
    return est.fit(train, val, [{"global": fe, "per-user": re, "per-movie": re}])[0]


def _host(model):
    out = {}
    for cid, m in model.models.items():
        a = m.coefficients_matrix if hasattr(m, "coefficients_matrix") else m.coefficients.means
        out[cid] = a.cpu().numpy()
    return out


def _files(ck: Path) -> dict:
    return {str(p.relative_to(ck)): p.read_bytes() for p in sorted(ck.rglob("*.npz"))}


def test_the_staged_write_gives_the_synchronous_bits(runs, tmp_path, monkeypatch):
    begun = []
    begin0 = checkpoint.CoordinateDescentCheckpoint.begin_model_write
    monkeypatch.setattr(checkpoint.CoordinateDescentCheckpoint, "begin_model_write",
                        lambda self, **kw: begun.append(kw["completed_steps"]) or begin0(self, **kw))
    staged = _estimator_fit(runs["data"], tmp_path / "staged", pipeline=True)
    assert begun == [1, 2, 3, 4, 5, 6]
    synchronous = _estimator_fit(runs["data"], tmp_path / "sync", pipeline=False)
    assert begun == [1, 2, 3, 4, 5, 6]  # the synchronous fit stages nothing
    for cid, a in _host(staged.model).items():
        assert np.array_equal(a, _host(synchronous.model)[cid])
    ck = {k: tmp_path / k / "config-0" for k in ("staged", "sync")}
    assert _files(ck["staged"]) == _files(ck["sync"]) and _files(ck["staged"])
    states = {k: json.loads((v / "state.json").read_text()) for k, v in ck.items()}
    assert states["staged"]["checksums"] == states["sync"]["checksums"]
    assert states["staged"]["model_files"] == states["sync"]["model_files"]


def test_spent_background_retries_fall_back_to_the_synchronous_write(runs, tmp_path, monkeypatch):
    monkeypatch.setenv("PHOTON_RETRY_BASE_DELAY_S", "0.001")
    straight = _estimator_fit(runs["data"], tmp_path / "straight", pipeline=False)
    # Step 1's background write is the first write: its three attempts fail.
    with faults.inject("checkpoint_write@1+2+3") as inj:
        first = _estimator_fit(runs["data"], tmp_path / "ck", pipeline=True, iterations=1)
    assert inj.injected["checkpoint_write"] == 3
    assert faults.COUNTERS.get("fallback_sync_ckpt_writes") == 1
    state = json.loads((tmp_path / "ck" / "config-0" / "state.json").read_text())
    assert state["completed_steps"] == 3 and set(state["model_files"]) == {"global", *RE_IDS}
    resumed = _estimator_fit(runs["data"], tmp_path / "ck", pipeline=True)
    for cid, a in _host(straight.model).items():
        assert np.array_equal(a, _host(resumed.model)[cid]), cid
    assert first.model is not None


def test_a_crash_between_the_staged_write_and_its_commit_resumes_from_the_step_before(
        runs, tmp_path, monkeypatch):
    straight = _estimator_fit(runs["data"], tmp_path / "straight", pipeline=True)
    save0 = checkpoint.CoordinateDescentCheckpoint.save

    def dying(self, **kw):
        if kw["completed_steps"] == 4:
            assert kw["staged"] is not None
            kw["staged"][4].join(timeout=60)  # the staged file is on disk, uncommitted
            assert not kw["staged"][4].is_alive()
            raise RuntimeError("simulated preemption")
        return save0(self, **kw)

    monkeypatch.setattr(checkpoint.CoordinateDescentCheckpoint, "save", dying)
    with pytest.raises(RuntimeError, match="simulated preemption"):
        _estimator_fit(runs["data"], tmp_path / "ck", pipeline=True)
    monkeypatch.setattr(checkpoint.CoordinateDescentCheckpoint, "save", save0)
    state = json.loads((tmp_path / "ck" / "config-0" / "state.json").read_text())
    assert state["completed_steps"] == 3
    assert (tmp_path / "ck" / "config-0" / "steps" / "4" / "global.npz").is_file()
    resumed = _estimator_fit(runs["data"], tmp_path / "ck", pipeline=True)
    for cid, a in _host(straight.model).items():
        assert np.array_equal(a, _host(resumed.model)[cid]), cid


def test_ranks_refuse_the_staged_write(tmp_path):
    from types import SimpleNamespace

    from photon_ml_tpu_torch.parallel.mesh import RankMesh

    mesh = RankMesh(0, 1, "gloo", torch.device("cpu"))
    coords = {"global": SimpleNamespace(dataset=SimpleNamespace(mesh=mesh))}
    ck = checkpoint.RankCheckpoint(str(tmp_path / "ck"), coords)
    with pytest.raises(NotImplementedError, match="collective"):
        ck.begin_model_write(completed_steps=1, cid="global", model=None)
    assert not (tmp_path / "ck").exists()


def test_the_jax_package_resumes_a_staged_checkpoint(tmp_path):
    """tests/test_torch_checkpoint.py's cross-package check on a checkpoint
    written through the staged write."""
    import test_torch_checkpoint as tc

    ds, val = tc._dataset(), tc._dataset(99)
    from photon_ml_tpu_torch.evaluation.suite import EvaluationSuite

    suite = EvaluationSuite([EvaluatorType("AUC")], val.labels, val.weights)
    coords = tc._coords(ds)

    def scorer(cid, model):
        if cid == "fixed":
            return val.shards["global"] @ model.coefficients.means
        from photon_ml_tpu_torch.game.model import random_effect_margins

        return random_effect_margins(val.shards["per_entity"], coords["per-entity"].re_dataset.sample_entity_rows,
                                     model.coefficients_matrix, None)

    ck = str(tmp_path / "ck")
    begun = []
    begin0 = checkpoint.CoordinateDescentCheckpoint.begin_model_write
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(checkpoint.CoordinateDescentCheckpoint, "begin_model_write",
                   lambda self, **kw: begun.append(kw["completed_steps"]) or begin0(self, **kw))
        from photon_ml_tpu_torch.game.coordinate_descent import run_coordinate_descent

        run_coordinate_descent(coords, 1, seed=3, checkpoint_dir=ck, validation_scorer=scorer,
                               validation_suite=suite, validation_offsets=val.offsets, prefetch=True)
    assert begun == [1, 2]
    resumed = jax_run(tc._jax_coords(), 2, seed=3, checkpoint_dir=ck)
    straight = jax_run(tc._jax_coords(), 2, seed=3)
    a, b = tc._jax_models_to_port(straight.model.models), tc._jax_models_to_port(resumed.model.models)
    for cid in a:
        np.testing.assert_allclose(b[cid], a[cid], atol=tc.GLMIX["coef_atol"], rtol=0)


# --------------------------------------------------------------- tracing off


def test_an_untraced_fit_opens_no_span(runs, tmp_path, monkeypatch):
    assert telemetry.current_tracer() is None

    class NoSpan:
        def __init__(self, *a, **kw):
            raise AssertionError("a span was opened with tracing off")

    monkeypatch.setattr(telemetry, "_Span", NoSpan)
    monkeypatch.setenv("PHOTON_TRACE", "0")
    train_cli.main(train_args(runs["data"], tmp_path / "out", tmp_path / "ck") + ["--device", "cpu"])
    assert telemetry.current_tracer() is None and not (tmp_path / "out" / "trace.json").exists()
    assert telemetry.span("x") is telemetry.span("y")  # the shared no-op


@pytest.mark.parametrize("env,override", [("", None), ("0", None), ("off", None), ("1", None),
                                          ("yes", None), ("0", True), ("1", False), ("bogus", None)])
def test_pipeline_enabled_reads_like_the_reference(monkeypatch, env, override):
    monkeypatch.setenv("PHOTON_PIPELINE", env)
    monkeypatch.delenv("PHOTON_HOST_THREADS", raising=False)
    assert knobs.pipeline_enabled(override) == jax_pipeline.pipeline_enabled(override)
