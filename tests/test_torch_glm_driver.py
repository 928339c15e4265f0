"""The port's legacy GLM driver (`photon_ml_tpu_torch.cli.glm_driver`)
against the JAX driver on the same files, on the CPU: the cases of the JAX
package's tests/test_glm_driver.py (on files the repo's generator writes,
in place of the reference's fixtures), with the summaries' metrics, the
text models and the model directories compared, and each package loading
the other's `models/<rw>`."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from photon_ml_tpu.cli import glm_driver as jax_glm_driver
from photon_ml_tpu.data.index_map import IndexMap as JaxIndexMap
from photon_ml_tpu.io import avro as jax_avro
from photon_ml_tpu.io import model_store as jax_model_store
from photon_ml_tpu_torch.cli import glm_driver, libsvm_to_avro
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.data.index_map import IndexMap
from photon_ml_tpu_torch.data.libsvm import read_libsvm
from photon_ml_tpu_torch.io import avro as avro_io
from photon_ml_tpu_torch.io import model_store
from photon_ml_tpu_torch.io.avro_data import write_training_examples

TOL = PORT_TOLERANCES["estimator"]
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("glm_driver")
    subprocess.run([sys.executable, str(REPO / "examples" / "generate_dataset.py"), str(root),
                    "--train", "1500", "--test", "600"], check=True, capture_output=True, timeout=120)
    for split in ("train", "test"):
        assert libsvm_to_avro.main([str(root / f"{split}.libsvm"), str(root / f"{split}.avro")]) == 0
    # A linear-regression pair (the reference's mg_train/mg_test stand-in).
    rng = np.random.default_rng(5)
    w = rng.normal(size=6)
    for split, n in (("mg_train", 400), ("mg_test", 150)):
        X = rng.uniform(-1, 1, size=(n, 6))
        y = X @ w + 0.2 + 0.1 * rng.normal(size=n)
        lines = [f"{y[i]:.6f} " + " ".join(f"{j + 1}:{X[i, j]:.6f}" for j in range(6)) for i in range(n)]
        (root / f"{split}.txt").write_text("\n".join(lines) + "\n")
    return root


def _both(args, root: Path):
    """Run `args` through the port (on the CPU) and the JAX driver, into
    <root>/port and <root>/jax; returns both summaries and the JAX driver's
    parsed arguments."""
    ours = glm_driver.run(glm_driver.build_parser().parse_args(
        args + ["--output-directory", str(root / "port"), "--device", "cpu"]))
    jargs = jax_glm_driver.build_parser().parse_args(args + ["--output-directory", str(root / "jax")])
    theirs = jax_glm_driver.run(jargs)
    return ours, theirs, jargs


def _assert_summaries_agree(ours, theirs, root: Path = None, jargs=None):
    """The same stages, sizes and selection; each validation metric of the
    port's summary is the JAX evaluation's of the port's own model (the
    models themselves are held within the solver's noise by
    `_assert_models_agree`, and a metric follows its model)."""
    assert ours["stages"] == theirs["stages"]
    for k in ("num_features", "num_training_samples", "regularization_weights"):
        assert ours[k] == theirs[k]
    if "validation_metrics" not in theirs:
        return
    assert ours["best_regularization_weight"] == theirs["best_regularization_weight"]
    assert ours["validation_metrics"].keys() == theirs["validation_metrics"].keys()
    from photon_ml_tpu.evaluation.legacy import evaluate_glm as jax_evaluate
    from photon_ml_tpu.models.glm import create_model as jax_create_model

    jmap = JaxIndexMap.load(str(root / "jax" / "feature-index.json"))
    val, _ = jax_glm_driver._read(jargs, jargs.validate_data_directory, index_map=jmap)
    for rw, m in ours["validation_metrics"].items():
        assert m.keys() == theirs["validation_metrics"][rw].keys()
        means = jax_model_store.load_game_model(str(root / "port" / "models" / rw),
                                                {"global": jmap}).coordinates["global"].means
        ref = jax_evaluate(jax_create_model(jargs.task, means.astype(np.float32)), val)
        for name, value in ref.items():
            assert abs(m[name] - value) <= TOL["metric_atol"] * max(1.0, abs(value)), (rw, name)


def _assert_models_agree(root: Path, weights):
    imap = IndexMap.load(str(root / "port" / "feature-index.json"))
    assert dict(imap.items()) == json.loads((root / "jax" / "feature-index.json").read_text())
    jmap = JaxIndexMap.load(str(root / "jax" / "feature-index.json"))
    for rw in weights:
        text = {k: (root / k / "learned-models-text" / f"model-{rw}.txt").read_text().splitlines()
                for k in ("port", "jax")}
        assert len(text["port"]) == len(text["jax"]) == imap.size
        vals = [float(line.split("\t")[2]) for line in text["port"]]
        assert vals == sorted(vals, reverse=True)
        assert all(line.split("\t")[3] == str(rw) for line in text["port"])
        ours = {tuple(l.split("\t")[:2]): float(l.split("\t")[2]) for l in text["port"]}
        theirs = {tuple(l.split("\t")[:2]): float(l.split("\t")[2]) for l in text["jax"]}
        assert ours.keys() == theirs.keys()
        assert max(abs(ours[k] - theirs[k]) for k in ours) <= TOL["coef_atol"]
        # Each package loads the other's model directory, exactly as its own.
        for k in ("port", "jax"):
            mdir = str(root / k / "models" / str(rw))
            a = model_store.load_game_model(mdir, {"global": imap}).coordinates["global"].means
            b = jax_model_store.load_game_model(mdir, {"global": jmap}).coordinates["global"].means
            np.testing.assert_array_equal(a, np.asarray(b))
        a = model_store.load_game_model(str(root / "port" / "models" / str(rw)), {"global": imap})
        b = model_store.load_game_model(str(root / "jax" / "models" / str(rw)), {"global": imap})
        assert np.abs(a.coordinates["global"].means - b.coordinates["global"].means).max() <= TOL["coef_atol"]


def test_avro_staged_run_with_validation(data, tmp_path):
    """Avro through all four stages: metrics per weight, model selection,
    text and store output, feature summarization (TRON)."""
    ours, theirs, jargs = _both([
        "--training-data-directory", str(data / "train.avro"),
        "--validate-data-directory", str(data / "test.avro"),
        "--task", "LOGISTIC_REGRESSION", "--optimizer", "TRON",
        "--regularization-weights", "0.1,1,10",
        "--summarization-output-dir", str(tmp_path / "summary"),
    ], tmp_path)
    assert ours["stages"] == ["INIT", "PREPROCESSED", "TRAINED", "VALIDATED"]
    assert set(ours["validation_metrics"]) == {"0.1", "1.0", "10.0"}
    m = ours["validation_metrics"][str(ours["best_regularization_weight"])]
    assert m["Area under ROC"] > 0.7 and "Peak F1 score" in m and "Per-datum log likelihood" in m
    _assert_summaries_agree(ours, theirs, tmp_path, jargs)
    _assert_models_agree(tmp_path, [0.1, 1.0, 10.0])
    _, recs = jax_avro.read_container(str(tmp_path / "summary" / "part-00000.avro"))
    imap = IndexMap.load(str(tmp_path / "port" / "feature-index.json"))
    assert len(recs) == imap.size - 1


@pytest.mark.parametrize("reg", [[], ["--regularization-type", "L1"],
                                 ["--regularization-type", "ELASTIC_NET", "--elastic-net-alpha", "0.5"]],
                         ids=["L2", "L1", "elastic_net"])
def test_libsvm_format_with_constraints(data, tmp_path, reg):
    """The LibSVM input format with an inline constraint string: the bound
    holds exactly, in both packages alike."""
    ours, theirs, jargs = _both([
        "--training-data-directory", str(data / "train.libsvm"),
        "--validate-data-directory", str(data / "test.libsvm"),
        "--format", "LIBSVM", "--regularization-weights", "1",
        "--coefficient-constraints",
        json.dumps([{"name": "1", "term": "", "lowerBound": -0.01, "upperBound": 0.01}]),
        *reg,
    ], tmp_path)
    assert ours["stages"][-1] == "VALIDATED"
    _assert_summaries_agree(ours, theirs, tmp_path, jargs)
    _assert_models_agree(tmp_path, [1.0])
    imap = IndexMap.load(str(tmp_path / "port" / "feature-index.json"))
    art = model_store.load_game_model(str(tmp_path / "port" / "models" / "1.0"), {"global": imap})
    assert np.float32(-0.01) <= art.coordinates["global"].means[imap.get_index("1")] <= np.float32(0.01)


@pytest.mark.parametrize("reg", [["--regularization-type", "L1"],
                                 ["--regularization-type", "ELASTIC_NET", "--elastic-net-alpha", "0.5"]],
                         ids=["L1", "elastic_net"])
def test_l1_and_elastic_net_sweeps_match_the_jax_driver(data, tmp_path, reg):
    """At the driver's default tolerance (1e-7) the relative function-value
    test fires on f32 noise in both packages: on this data the JAX sweep's
    L1 weight 10 stops after 28 iterations where the port's stops after 17,
    both at |f - f_prev| <= 1e-7 |f0|, 2.6e-6 apart in objective. Held to
    the estimator's coefficient tolerance, the sweep runs to 1e-10."""
    ours, theirs, jargs = _both([
        "--training-data-directory", str(data / "train.libsvm"),
        "--validate-data-directory", str(data / "test.libsvm"),
        "--format", "LIBSVM", "--regularization-weights", "1,10,30",
        "--tolerance", "1e-10", "--max-iterations", "500", *reg,
    ], tmp_path)
    _assert_summaries_agree(ours, theirs, tmp_path, jargs)
    _assert_models_agree(tmp_path, [1.0, 10.0, 30.0])
    imap = IndexMap.load(str(tmp_path / "port" / "feature-index.json"))
    art = model_store.load_game_model(str(tmp_path / "port" / "models" / "30.0"), {"global": imap})
    assert (art.coordinates["global"].means == 0).sum() > 0, "the L1 part should zero coefficients"


def test_stage_assertions():
    st = glm_driver._State()
    st.update(glm_driver.DriverStage.PREPROCESSED)
    with pytest.raises(RuntimeError, match="Expected driver stage INIT"):
        st.assert_stage(glm_driver.DriverStage.INIT)


def test_output_dir_guard(data, tmp_path):
    out = tmp_path / "out"
    out.mkdir()
    with pytest.raises(FileExistsError):
        glm_driver.run(glm_driver.build_parser().parse_args([
            "--training-data-directory", str(data / "train.avro"), "--output-directory", str(out),
            "--device", "cpu"]))


def test_linear_regression_on_libsvm(data, tmp_path):
    """The regression facet and RMSE-minimizing selection, against the JAX
    driver, and the best weight's RMSE against a closed-form ridge fit."""
    ours, theirs, jargs = _both([
        "--training-data-directory", str(data / "mg_train.txt"),
        "--validate-data-directory", str(data / "mg_test.txt"),
        "--format", "LIBSVM", "--task", "LINEAR_REGRESSION", "--optimizer", "TRON",
        "--regularization-weights", "0.01,1,100",
    ], tmp_path)
    best = str(ours["best_regularization_weight"])
    metrics = ours["validation_metrics"][best]
    assert {"Root mean square error", "Mean absolute error", "R-squared"} <= set(metrics)
    rmses = {w: m["Root mean square error"] for w, m in ours["validation_metrics"].items()}
    assert rmses[best] == min(rmses.values())
    _assert_summaries_agree(ours, theirs, tmp_path, jargs)
    _assert_models_agree(tmp_path, [0.01, 1.0, 100.0])
    tr = read_libsvm(str(data / "mg_train.txt"))
    te = read_libsvm(str(data / "mg_test.txt"), num_features=tr.dim - 1)
    X, y = tr.to_dense().astype(np.float64), tr.labels.astype(np.float64)
    w = np.linalg.solve(X.T @ X + float(best) * np.eye(X.shape[1]), X.T @ y)
    ridge = float(np.sqrt(np.mean((te.to_dense() @ w - te.labels) ** 2)))
    assert rmses[best] == pytest.approx(ridge, rel=0.02)


def test_selected_features_whitelist(tmp_path):
    """--selected-features-file keeps the listed (name, term) features and
    the intercept, in both packages; a missing file raises IOError."""
    rng = np.random.default_rng(0)
    n = 200
    X = rng.normal(size=(n, 3))
    y = (X[:, 0] + 0.1 * rng.normal(size=n) > 0).astype(float)
    feats = [[("fa", float(X[i, 0])), ("fb", float(X[i, 1])), ("fc", float(X[i, 2]))] for i in range(n)]
    train = str(tmp_path / "train.avro")
    write_training_examples(train, feats, y.tolist())
    sel = str(tmp_path / "selected.avro")
    avro_io.write_container(sel, {
        "type": "record", "name": "FeatureNameTermAvro",
        "namespace": "com.linkedin.photon.avro.generated",
        "fields": [{"name": "name", "type": "string"}, {"name": "term", "type": "string"}],
    }, [{"name": "fa", "term": ""}])
    ours, theirs, jargs = _both(["--training-data-directory", train, "--regularization-weights", "1",
                          "--selected-features-file", sel], tmp_path)
    imap = IndexMap.load(str(tmp_path / "port" / "feature-index.json"))
    assert imap.size == 2 and imap.get_index("fa") >= 0 and imap.get_index("fb") < 0
    _assert_summaries_agree(ours, theirs, tmp_path, jargs)
    _assert_models_agree(tmp_path, [1.0])
    (tmp_path / "sel.jsonl").write_text(json.dumps({"name": "fb", "term": ""}) + "\n")
    glm_driver.run(glm_driver.build_parser().parse_args([
        "--training-data-directory", train, "--output-directory", str(tmp_path / "json"),
        "--regularization-weights", "1", "--selected-features-file", str(tmp_path / "sel.jsonl"),
        "--device", "cpu"]))
    assert IndexMap.load(str(tmp_path / "json" / "feature-index.json")).get_index("fb") == 0
    with pytest.raises(IOError, match="Could not find"):
        glm_driver.run(glm_driver.build_parser().parse_args([
            "--training-data-directory", train, "--output-directory", str(tmp_path / "out2"),
            "--selected-features-file", str(tmp_path / "missing.avro"), "--device", "cpu"]))
    with pytest.raises(ValueError, match="requires --format TRAINING_EXAMPLE"):
        glm_driver.run(glm_driver.build_parser().parse_args([
            "--training-data-directory", train, "--output-directory", str(tmp_path / "out3"),
            "--format", "LIBSVM", "--selected-features-file", sel, "--device", "cpu"]))


def test_full_and_simple_variances_through_the_sweep_match_jax(data):
    """The sweep's variances (SIMPLE and FULL) against the JAX sweep's."""
    import jax.numpy as jnp
    import torch

    from photon_ml_tpu.data.containers import LabeledData as JaxLabeledData
    from photon_ml_tpu.data.containers import pack_csr_to_ell as jax_pack
    from photon_ml_tpu.data.libsvm import read_libsvm as jax_read
    from photon_ml_tpu.models.training import train_glm_sweep as jax_sweep
    from photon_ml_tpu.optimize import config as jax_config
    from photon_ml_tpu.types import VarianceComputationType as JaxVC
    from photon_ml_tpu_torch.data import sparse_layout
    from photon_ml_tpu_torch.data.containers import LabeledData, pack_csr_to_ell
    from photon_ml_tpu_torch.models.training import train_glm_sweep
    from photon_ml_tpu_torch.optimize import config
    from photon_ml_tpu_torch.types import TaskType, VarianceComputationType

    csr = read_libsvm(str(data / "train.libsvm"))
    ell = pack_csr_to_ell(csr.indptr, csr.indices, csr.values, csr.dim)
    n = csr.num_rows
    ours_data = LabeledData(sparse_layout.from_ell(ell), torch.from_numpy(csr.labels), torch.zeros(n),
                            torch.ones(n))
    jcsr = jax_read(str(data / "train.libsvm"))
    jdata = JaxLabeledData(jax_pack(jcsr.indptr, jcsr.indices, jcsr.values, jcsr.dim),
                           jnp.asarray(jcsr.labels), jnp.zeros(n), jnp.ones(n))
    for vc in ("SIMPLE", "FULL"):
        cfg = config.CoordinateOptimizationConfig(regularization=config.L2,
                                                  variance_computation=VarianceComputationType[vc])
        jcfg = jax_config.CoordinateOptimizationConfig(regularization=jax_config.L2,
                                                       variance_computation=JaxVC[vc])
        ours = train_glm_sweep(ours_data, TaskType.LOGISTIC_REGRESSION, cfg, [1.0, 10.0])
        from photon_ml_tpu.types import TaskType as JaxTask
        theirs = jax_sweep(jdata, JaxTask.LOGISTIC_REGRESSION, jcfg, [1.0, 10.0])
        for rw in (1.0, 10.0):
            a, b = ours.models[rw].coefficients, theirs.models[rw].coefficients
            assert np.abs(a.means.numpy() - np.asarray(b.means)).max() <= TOL["coef_atol"]
            np.testing.assert_allclose(a.variances.numpy(), np.asarray(b.variances),
                                       rtol=TOL["variance_rtol"])


@pytest.mark.parametrize("task", ["LOGISTIC_REGRESSION", "LINEAR_REGRESSION"])
def test_select_best_model_matches_jax(data, task):
    """The sweep's model selection on validation data, by the task's default
    evaluator, against the JAX package's."""
    import jax.numpy as jnp
    import torch

    from photon_ml_tpu.data.containers import LabeledData as JaxLabeledData
    from photon_ml_tpu.data.containers import pack_csr_to_ell as jax_pack
    from photon_ml_tpu.models.training import select_best_model as jax_select
    from photon_ml_tpu.models.training import train_glm_sweep as jax_sweep
    from photon_ml_tpu.optimize import config as jax_config
    from photon_ml_tpu.types import TaskType as JaxTask
    from photon_ml_tpu_torch.data import sparse_layout
    from photon_ml_tpu_torch.data.containers import LabeledData, pack_csr_to_ell
    from photon_ml_tpu_torch.models.training import select_best_model, train_glm_sweep
    from photon_ml_tpu_torch.optimize import config
    from photon_ml_tpu_torch.types import TaskType

    names = ("mg_train.txt", "mg_test.txt") if task == "LINEAR_REGRESSION" else ("train.libsvm", "test.libsvm")
    tr = read_libsvm(str(data / names[0]))
    te = read_libsvm(str(data / names[1]), num_features=tr.dim - 1)

    def port(csr):
        ell = pack_csr_to_ell(csr.indptr, csr.indices, csr.values, csr.dim)
        n = csr.num_rows
        return LabeledData(sparse_layout.from_ell(ell), torch.from_numpy(csr.labels), torch.zeros(n),
                           torch.ones(n))

    def jax(csr):
        n = csr.num_rows
        return JaxLabeledData(jax_pack(csr.indptr, csr.indices, csr.values, csr.dim),
                              jnp.asarray(csr.labels), jnp.zeros(n), jnp.ones(n))

    weights = [0.01, 1.0, 100.0, 3000.0]
    ours = train_glm_sweep(port(tr), TaskType[task], config.CoordinateOptimizationConfig(
        regularization=config.L2), weights)
    theirs = jax_sweep(jax(tr), JaxTask[task], jax_config.CoordinateOptimizationConfig(
        regularization=jax_config.L2), weights)
    rw, model, value = select_best_model(ours, port(te), TaskType[task])
    jrw, jmodel, jvalue = jax_select(theirs, jax(te), JaxTask[task])
    assert rw == jrw and isinstance(model, type(ours.models[rw]))
    assert abs(value - float(jvalue)) <= TOL["metric_atol"] * max(1.0, abs(float(jvalue)))
