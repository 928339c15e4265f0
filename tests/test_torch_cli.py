"""The port's drivers against the JAX package's, on the CPU.

  * The configuration DSL parses like the JAX module: the reference
    README's examples, round trips, the cross-product expansion and the
    same errors.
  * examples/run_glmix.sh's three steps (libsvm_to_avro, train, score) run
    through the port with `--device cpu`, and through the JAX drivers on the
    same files: the saved coefficients agree within
    PORT_TOLERANCES["estimator"]["coef_atol"], validation and scoring AUC
    within its "metric_atol", and each package scores the other's model
    directory as it scores its own, per uid, within "score_atol".
  * Warm start and partial retrain, the row validators, daily input
    directories, and the options of parts not ported yet (each raises
    naming its ROADMAP item, before any work), as in tests/test_cli.py;
    the options ported since (--checkpoint-directory, FULL variances,
    constraints.file, OWLQN, L1, elastic net, --offheap-indexmap-dir with
    PHIDX and PalDB stores, --hyper-parameter-tuning RANDOM and BAYESIAN)
    run through both drivers, and --offheap-indexmap-dir through both
    scoring drivers.
"""

from __future__ import annotations

import dataclasses
import datetime as dt
import enum
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_ml_tpu.cli import config as jax_config
from photon_ml_tpu.cli import libsvm_to_avro as jax_libsvm_to_avro
from photon_ml_tpu.cli import score as jax_score_cli
from photon_ml_tpu.cli import train as jax_train_cli
from photon_ml_tpu.data.game_dataset import GameDataset as JaxGameDataset
from photon_ml_tpu.data.validators import DataValidationError as JaxDataValidationError
from photon_ml_tpu.data.validators import validate_game_dataset as jax_validate
from photon_ml_tpu.io import avro as jax_avro
from photon_ml_tpu.io import score_store as jax_scores
from photon_ml_tpu.types import DataValidationType as JaxValidation
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu.utils import date_range as jax_date_range
from photon_ml_tpu_torch.cli import build_index, config
from photon_ml_tpu_torch.cli import libsvm_to_avro
from photon_ml_tpu_torch.cli import score as score_cli
from photon_ml_tpu_torch.cli import train as train_cli
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.data.game_dataset import GameDataset
from photon_ml_tpu_torch.data.index_map import IndexMap
from photon_ml_tpu_torch.data.validators import DataValidationError, validate_game_dataset
from photon_ml_tpu_torch.io import model_store, score_store
from photon_ml_tpu_torch.io.avro_data import write_training_examples
from photon_ml_tpu_torch.types import DataValidationType, TaskType
from photon_ml_tpu_torch.utils import date_range

TOL = PORT_TOLERANCES["estimator"]
REPO = Path(__file__).resolve().parent.parent
SHARD = "name=globalShard,feature.bags=features,intercept=true"

# ------------------------------------------------------------------------ DSL

COORDINATE_STRINGS = [
    # The reference README's fixed-effect example (README.md:283-292).
    "name=global,feature.shard=globalShard,min.partitions=4,optimizer=LBFGS,tolerance=1.0E-6,"
    "max.iter=50,regularization=L2,reg.weights=0.1|1|10|100",
    # Its random-effect example.
    "name=per-member,random.effect.type=memberId,feature.shard=memberShard,min.partitions=4,"
    "optimizer=LBFGS,tolerance=1.0E-6,max.iter=50,regularization=L2,reg.weights=0.1|1|10|100,"
    "active.data.lower.bound=1,active.data.upper.bound=100",
    "name=per-member,random.effect.type=memberId,feature.shard=memberShard,"
    "active.data.lower.bound=2,active.data.upper.bound=100,optimizer=TRON,regularization=L2,"
    "reg.weights=1,projector=RANDOM,projected.dim=16,min.bucket=4",
    "name=global,feature.shard=g,optimizer=OWLQN,tolerance=0.001,max.iter=20,regularization=L1,"
    "reg.weights=0.5|2.0",
    "name=re,random.effect.type=uid,feature.shard=s,optimizer=LBFGS,tolerance=1e-07,max.iter=100,"
    "regularization=NONE",
    "name=per-user,random.effect.type=userId,feature.shard=s,features.to.samples.ratio=0.5,"
    "optimizer=LBFGS,reg.weights=1",
    "name=e,feature.shard=s,regularization=ELASTIC_NET,reg.alpha=0.25,reg.weights=1|3,"
    "down.sampling.rate=0.5,constraints.file=/tmp/c.json",
    "name=fe,feature.shard=s,active.data.upper.bound=9,regularization=L2,reg.weights=2",
]

SHARD_STRINGS = [
    "name=globalShard,feature.bags=features|context,intercept=true",
    "name=s",
    "name=s,feature.bags=a,intercept=false",
]

COORDINATE_ERRORS = [
    "feature.shard=s",
    "name=a",
    "name=a,feature.shard=s,regularization=L2",
    "name=a,feature.shard=s,nope=1",
    "name=a,feature.shard=s,name=b",
    "name=a,feature.shard=s,max.iter",
    "name=a,feature.shard=s,optimizer=SGD",
]

SHARD_ERRORS = ["feature.bags=f1", "name=s,bogus.key=1", "name=s,intercept=maybe"]


def _plain(obj):
    """A configuration as plain values (enums by value), without the port's
    own `max_block_cells`, for comparing the two packages' parses."""
    if dataclasses.is_dataclass(obj):
        return {k: _plain(v) for k, v in dataclasses.asdict(obj).items() if k != "max_block_cells"}
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items() if k != "max_block_cells"}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


@pytest.mark.parametrize("s", COORDINATE_STRINGS)
def test_coordinate_dsl_parses_and_prints_like_the_jax_module(s):
    ours, theirs = config.parse_coordinate_config(s), jax_config.parse_coordinate_config(s)
    assert type(ours.data_config).__name__ == type(theirs.data_config).__name__
    assert _plain(ours) == _plain(theirs)
    printed = config.coordinate_config_to_string(ours)
    assert printed == jax_config.coordinate_config_to_string(theirs)
    assert _plain(config.parse_coordinate_config(printed)) == _plain(ours)
    assert [_plain(c) for c in ours.expand()] == [_plain(c) for c in theirs.expand()]


@pytest.mark.parametrize("s", SHARD_STRINGS)
def test_feature_shard_dsl_parses_and_prints_like_the_jax_module(s):
    name, cfg = config.parse_feature_shard_config(s)
    jname, jcfg = jax_config.parse_feature_shard_config(s)
    assert (name, _plain(cfg)) == (jname, _plain(jcfg))
    assert config.feature_shard_config_to_string(name, cfg) == \
        jax_config.feature_shard_config_to_string(jname, jcfg)


@pytest.mark.parametrize("s,parse", [(s, "coordinate") for s in COORDINATE_ERRORS]
                         + [(s, "feature_shard") for s in SHARD_ERRORS])
def test_dsl_errors_are_the_jax_module_errors(s, parse):
    with pytest.raises(Exception) as theirs:
        getattr(jax_config, f"parse_{parse}_config")(s)
    with pytest.raises(Exception) as ours:
        getattr(config, f"parse_{parse}_config")(s)
    assert type(ours.value) is type(theirs.value) and str(ours.value) == str(theirs.value)


def test_the_sweep_is_the_jax_cross_product():
    strings = {"a": "name=a,feature.shard=s,regularization=L2,reg.weights=1|10",
               "b": "name=b,feature.shard=s,regularization=L2,reg.weights=0.5|2|8",
               "c": "name=c,random.effect.type=u,feature.shard=s,regularization=NONE"}
    ours = config.expand_game_opt_configs({k: config.parse_coordinate_config(v) for k, v in strings.items()})
    theirs = jax_config.expand_game_opt_configs(
        {k: jax_config.parse_coordinate_config(v) for k, v in strings.items()})
    assert len(ours) == 6 and [_plain(c) for c in ours] == [_plain(c) for c in theirs]


# ------------------------------------------------------ run_glmix.sh, end to end


def _train_args(data: Path, out: Path, extra=()):
    return [
        "--training-task", "LOGISTIC_REGRESSION",
        "--input-data-directories", str(data / "train.avro"),
        "--validation-data-directories", str(data / "test.avro"),
        "--root-output-directory", str(out),
        "--override-output-directory",
        "--feature-shard-configurations", SHARD,
        "--coordinate-configurations",
        "name=global,feature.shard=globalShard,optimizer=LBFGS,tolerance=1.0E-7,max.iter=50,"
        "regularization=L2,reg.weights=1",
        "name=per-member,random.effect.type=memberId,feature.shard=globalShard,optimizer=LBFGS,"
        "max.iter=30,regularization=L2,reg.weights=10,min.bucket=8",
        "--coordinate-descent-iterations", "2",
        "--validation-evaluators", "AUC",
        "--output-mode", "BEST",
        *extra,
    ]


def _score_args(data: Path, model: Path, out: Path):
    return ["--input-data-directories", str(data / "test.avro"), "--model-input-directory", str(model),
            "--root-output-directory", str(out), "--feature-shard-configurations", SHARD,
            "--evaluators", "AUC"]


@pytest.fixture(scope="module")
def glmix(tmp_path_factory):
    """run_glmix.sh's steps: the dataset generator (run, as the script runs
    it), then each step through the port (`--device cpu`) and through the
    JAX drivers on the port's Avro files, and each package's scorer on the
    other's model directory."""
    root = tmp_path_factory.mktemp("glmix")
    data = root / "data"
    subprocess.run([sys.executable, str(REPO / "examples" / "generate_dataset.py"), str(data),
                    "--train", "2400", "--test", "800", "--entities", "24"],
                   check=True, capture_output=True, timeout=120)
    for split in ("train", "test"):
        assert libsvm_to_avro.main(["--tag-comments", str(data / f"{split}.libsvm"),
                                    str(data / f"{split}.avro")]) == 0
        jax_libsvm_to_avro.main(["--tag-comments", str(data / f"{split}.libsvm"),
                                 str(data / f"jax-{split}.avro")])
    port_summary = train_cli.main(_train_args(data, root / "port", [
        "--device", "cpu", "--data-summary-directory", str(root / "port-summary")]))
    jax_train_cli.main(_train_args(data, root / "jax", ["--data-summary-directory", str(root / "jax-summary")]))
    models = {k: root / k / "models" / "best" for k in ("port", "jax")}
    scored = {}
    for scorer, model in (("port", "port"), ("port", "jax"), ("jax", "jax"), ("jax", "port")):
        out = root / f"scores-{scorer}-on-{model}"
        if scorer == "port":
            score_cli.main(_score_args(data, models[model], out) + ["--device", "cpu"])
        else:
            jax_score_cli.main(_score_args(data, models[model], out))
        scored[scorer, model] = out
    return dict(root=root, data=data, models=models, scored=scored, port_summary=port_summary)


def test_run_glmix_steps_run_through_the_port(glmix):
    data = glmix["data"]
    for split in ("train", "test"):  # the converter writes the JAX converter's records
        assert jax_avro.read_container(str(data / f"{split}.avro"))[1] == \
            jax_avro.read_container(str(data / f"jax-{split}.avro"))[1]
    best = glmix["models"]["port"]
    assert (best / "model-metadata.json").is_file()
    assert (best / "fixed-effect" / "global" / "coefficients" / "part-00000.avro").is_file()
    assert (best / "random-effect" / "per-member" / "coefficients" / "part-00000.avro").is_file()
    assert (best / "feature-indexes" / "globalShard.json").is_file()
    summary = json.loads((glmix["root"] / "port" / "training-summary.json").read_text())
    assert summary == json.loads(json.dumps(glmix["port_summary"], default=str))
    assert summary["num_samples"] == 2400 and summary["num_explicit"] == 1
    for section in ("read data", "validate data", "train explicit configurations", "save models"):
        assert summary["timings_s"][section] >= 0.0
    assert "read data" in (glmix["root"] / "port" / "photon-ml-tpu.log").read_text()
    scoring = json.loads((glmix["scored"]["port", "port"] / "scoring-summary.json").read_text())
    assert scoring["num_scored"] == 800
    for section in ("load model", "read data", "transform", "write scores"):
        assert scoring["timings_s"][section] >= 0.0


def test_the_port_trains_the_jax_drivers_model(glmix):
    imaps = {"globalShard": IndexMap.load(str(glmix["models"]["port"] / "feature-indexes" / "globalShard.json"))}
    ours = model_store.load_game_model(str(glmix["models"]["port"]), imaps)
    theirs = model_store.load_game_model(str(glmix["models"]["jax"]), imaps)
    fe_err = np.abs(ours.coordinates["global"].means - theirs.coordinates["global"].means).max()
    assert fe_err <= TOL["coef_atol"]
    a, b = ours.coordinates["per-member"], theirs.coordinates["per-member"]
    assert a.entity_ids == b.entity_ids and len(a.entity_ids) == 24
    assert np.abs(a.means - b.means).max() <= TOL["coef_atol"]
    summaries = {k: json.loads((glmix["root"] / k / "training-summary.json").read_text()) for k in ("port", "jax")}
    assert abs(summaries["port"]["best_evaluation"]["AUC"] - summaries["jax"]["best_evaluation"]["AUC"]) \
        <= TOL["metric_atol"]
    scoring = {k: json.loads((glmix["scored"][k, k] / "scoring-summary.json").read_text())["evaluation"]["AUC"]
               for k in ("port", "jax")}
    assert abs(scoring["port"] - scoring["jax"]) <= TOL["metric_atol"]


def test_feature_summaries_are_the_jax_drivers(glmix):
    part = os.path.join("globalShard", "part-00000.avro")
    ours = jax_avro.read_container(str(glmix["root"] / "port-summary" / part))[1]
    theirs = jax_avro.read_container(str(glmix["root"] / "jax-summary" / part))[1]
    assert [(r["featureName"], r["featureTerm"]) for r in ours] == \
        [(r["featureName"], r["featureTerm"]) for r in theirs]
    tol = PORT_TOLERANCES["stats"]
    for a, b in zip(ours, theirs):
        assert a["metrics"].keys() == b["metrics"].keys()
        np.testing.assert_allclose([a["metrics"][k] for k in sorted(a["metrics"])],
                                   [b["metrics"][k] for k in sorted(b["metrics"])], **tol)


def test_driver_options_normalization_variances_output_modes_and_sparsity(glmix, tmp_path):
    """STANDARDIZATION and SIMPLE variances through the driver on a
    two-weight sweep saved under output mode ALL: the best model, scored in
    the original space, gives the validation AUC the training driver
    reported. A sparsity threshold drops the small coefficients; output
    mode NONE saves nothing."""
    data = glmix["data"]
    args = _train_args(data, tmp_path / "all", ["--device", "cpu", "--normalization", "STANDARDIZATION",
                                                "--variance-computation-type", "SIMPLE"])
    args[args.index("--output-mode") + 1] = "ALL"
    args[args.index("--coordinate-configurations") + 1] += "|10"
    summary = train_cli.main(args)
    models = tmp_path / "all" / "models"
    assert summary["num_explicit"] == 2
    assert sorted(os.listdir(models)) == ["best", "explicit-0", "explicit-1"]
    imaps = {"globalShard": IndexMap.load(str(models / "best" / "feature-indexes" / "globalShard.json"))}
    best = model_store.load_game_model(str(models / "best"), imaps)
    assert all(best.coordinates[cid].variances is not None for cid in ("global", "per-member"))
    scored = score_cli.main(_score_args(data, models / "best", tmp_path / "scores") + ["--device", "cpu"])
    assert abs(scored["evaluation"]["AUC"] - summary["best_evaluation"]["AUC"]) <= TOL["metric_atol"]

    sparse = _train_args(data, tmp_path / "sparse", ["--device", "cpu", "--model-sparsity-threshold", "0.05"])
    train_cli.main(sparse)
    kept = model_store.load_game_model(str(tmp_path / "sparse" / "models" / "best"), imaps)
    full = model_store.load_game_model(str(glmix["models"]["port"]), imaps)
    for cid in ("global", "per-member"):
        a, b = kept.coordinates[cid].means, full.coordinates[cid].means
        assert np.array_equal(a, np.where(np.abs(b) > np.float32(0.05), b, 0.0)) and (a == 0).sum() > (b == 0).sum()

    args[args.index("--output-mode") + 1] = "NONE"
    args[args.index("--root-output-directory") + 1] = str(tmp_path / "none")
    train_cli.main(args)
    assert not (tmp_path / "none" / "models").exists()
    assert (tmp_path / "none" / "training-summary.json").is_file()


@pytest.mark.parametrize("model", ["port", "jax"])
def test_each_package_scores_a_model_directory_the_same(glmix, model):
    per_uid = {}
    for scorer in ("port", "jax"):
        items = jax_scores.load_scores(str(glmix["scored"][scorer, model] / "scores"))
        per_uid[scorer] = {it.uid: it.prediction_score for it in items}
    assert len(per_uid["port"]) == 800 and per_uid["port"].keys() == per_uid["jax"].keys()
    err = max(abs(per_uid["port"][u] - per_uid["jax"][u]) for u in per_uid["port"])
    assert err <= TOL["score_atol"]


def test_warm_start_and_partial_retrain(glmix, tmp_path):
    data, best = glmix["data"], glmix["models"]["port"]
    imaps = {"globalShard": IndexMap.load(str(best / "feature-indexes" / "globalShard.json"))}
    # Partial retrain: the fixed effect is locked, and saved as it was loaded.
    out = tmp_path / "locked"
    train_cli.main(_train_args(data, out, ["--device", "cpu", "--model-input-directory", str(best),
                                           "--partial-retrain-locked-coordinates", "global"]))
    before = model_store.load_game_model(str(best), imaps)
    after = model_store.load_game_model(str(out / "models" / "best"), imaps)
    assert np.array_equal(after.coordinates["global"].means, before.coordinates["global"].means)
    assert after.coordinates["per-member"].entity_ids == before.coordinates["per-member"].entity_ids
    # Warm start of every coordinate from the same directory.
    warm = train_cli.main(_train_args(data, tmp_path / "warm", ["--device", "cpu", "--model-input-directory",
                                                                str(best)]))
    assert abs(warm["best_evaluation"]["AUC"] - glmix["port_summary"]["best_evaluation"]["AUC"]) < 5e-3
    with pytest.raises(ValueError, match="requires --model-input-directory"):
        train_cli.main(_train_args(data, tmp_path / "bad", ["--device", "cpu",
                                                            "--partial-retrain-locked-coordinates", "global"]))


# ---------------------------------------------------------------- validators


def _validation_sets(n: int, bad: bool):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    w = np.ones(n, np.float32)
    if bad:
        x[::37, 1] = np.nan
        y[5::41] = 3.0
        w[9::53] = -1.0
        w[11::97] = np.inf
    jds = JaxGameDataset.build({"s": jnp.asarray(x)}, y, weights=w)
    ds = GameDataset.build({"s": torch.from_numpy(x)}, y, weights=w, device="cpu")
    return jds, ds


@pytest.mark.parametrize("mode", ["VALIDATE_FULL", "VALIDATE_SAMPLE"])
@pytest.mark.parametrize("task", ["LOGISTIC_REGRESSION", "POISSON_REGRESSION", "LINEAR_REGRESSION"])
def test_validators_catch_the_rows_the_jax_validators_catch(mode, task):
    jds, ds = _validation_sets(2000, bad=True)
    with pytest.raises(JaxDataValidationError) as theirs:
        jax_validate(jds, JaxTaskType[task], JaxValidation[mode])
    with pytest.raises(DataValidationError) as ours:
        validate_game_dataset(ds, TaskType[task], DataValidationType[mode])
    assert ours.value.failures == theirs.value.failures
    assert ours.value.rows_checked == theirs.value.rows_checked
    assert str(ours.value) == str(theirs.value)
    validate_game_dataset(ds, TaskType[task], DataValidationType.VALIDATE_DISABLED)
    validate_game_dataset(_validation_sets(500, bad=False)[1], TaskType[task], DataValidationType[mode])


def test_validators_small_case_of_the_jax_tests():
    ds = GameDataset.build({"s": torch.tensor([[1.0], [float("nan")]])}, [1.0, 3.0], weights=[1.0, -1.0],
                           device="cpu")
    with pytest.raises(DataValidationError) as exc:
        validate_game_dataset(ds, TaskType.LOGISTIC_REGRESSION, DataValidationType.VALIDATE_FULL)
    names = [f[0] for f in exc.value.failures]
    assert "positive weight" in names and "binary label" in names
    assert any("finite features" in n for n in names)


# ----------------------------------------------------------- daily directories


def _write_glmix_avro(path, seed, n, n_entities=8):
    rng = np.random.default_rng(seed)
    w_true = np.random.default_rng(99).normal(size=4)
    X = rng.normal(size=(n, 4))
    entity = rng.integers(0, n_entities, size=n)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-(X @ w_true)))).astype(np.float32)
    write_training_examples(path, [[(f"f{j}", float(X[i, j])) for j in range(4)] for i in range(n)],
                            y.tolist(), uids=[f"uid{i}" for i in range(n)],
                            id_tags={"memberId": [f"m{e}" for e in entity]})


def test_daily_directories_and_multiple_inputs(tmp_path):
    base = tmp_path / "daily"
    d1, d2, extra = base / "2016" / "01" / "01", base / "2016" / "01" / "02", tmp_path / "extra"
    for d in (d1, d2, extra):
        d.mkdir(parents=True)
    _write_glmix_avro(str(d1 / "part-00000.avro"), 0, 150)
    _write_glmix_avro(str(d2 / "part-00000.avro"), 1, 150)
    _write_glmix_avro(str(extra / "part-00000.avro"), 2, 100)
    common = ["--training-task", "LOGISTIC_REGRESSION", "--feature-shard-configurations", SHARD,
              "--coordinate-configurations",
              "name=global,feature.shard=globalShard,optimizer=LBFGS,tolerance=1e-7,max.iter=20,"
              "regularization=L2,reg.weights=1", "--device", "cpu"]
    out = tmp_path / "out"
    s1 = train_cli.main(common + ["--input-data-directories", str(base), "--input-data-date-range",
                                  "20160101-20160131", "--root-output-directory", str(out)])
    assert s1["num_samples"] == 300  # both daily dirs, not extra
    s2 = train_cli.main(common + ["--input-data-directories", str(d1), str(extra),
                                  "--root-output-directory", str(tmp_path / "out2")])
    assert s2["num_samples"] == 250
    scored = score_cli.main(["--input-data-directories", str(base), "--input-data-date-range",
                             "20160101-20160102", "--model-input-directory", str(out / "models" / "best"),
                             "--root-output-directory", str(tmp_path / "scores"),
                             "--feature-shard-configurations", SHARD, "--device", "cpu"])
    assert scored["num_scored"] == 300
    items = score_store.load_scores(str(tmp_path / "scores" / "scores"))
    assert len(items) == 300 and items[0].uid.startswith("uid")


@pytest.mark.parametrize("date,days", [("20160101-20160131", None), (None, "40-38"), (None, None),
                                       ("20160105-20160101", None), ("20160101-20160102", "3-1")])
def test_date_ranges_resolve_like_the_jax_module(tmp_path, date, days):
    today = dt.date(2016, 2, 10)
    (tmp_path / "2016" / "01" / "02").mkdir(parents=True)
    (tmp_path / "2016" / "01" / "03").mkdir(parents=True)

    def resolve(mod):
        try:
            r = mod.resolve_range(date, days, today=today)
            return str(r), mod.paths_for_date_range([str(tmp_path)], r)
        except (ValueError, FileNotFoundError) as e:
            return type(e).__name__, str(e)

    assert resolve(date_range) == resolve(jax_date_range)


# ----------------------------------------------------------------- refusals


# Options whose parts are not ported raise, naming their ROADMAP item; the
# cases with no item were refused until they were ported, and now run
# through the port's driver and are held against the JAX driver's result.
# The multi-host options of item 9 are ported since: they run the
# supervisor or a worker, which first refuse, as the JAX driver's do, a
# command line outside the multi-host scope (here, one without a
# checkpoint directory); tests/test_torch_multihost.py runs them.
UNPORTED = [
    (["--hyper-parameter-tuning", "BAYESIAN"], None),
    (["--checkpoint-directory", "ckpt"], None),
    (["--offheap-indexmap-dir", "idx"], None),
    (["--multihost", "2"], "item 9"),
    (["--mh-worker"], "item 9"),
    (["--profile", "profile.json"], None),
    (["--variance-computation-type", "FULL"], None),
    (["--hyper-parameter-tuning", "RANDOM"], None),
]

UNPORTED_COORDINATES = [
    ("name=global,feature.shard=globalShard,regularization=L2,reg.weights=1,constraints.file=c.json", None),
    ("name=global,feature.shard=globalShard,optimizer=OWLQN,regularization=L2,reg.weights=1", None),
    ("name=global,feature.shard=globalShard,regularization=L1,reg.weights=1", None),
    ("name=global,feature.shard=globalShard,regularization=ELASTIC_NET,reg.alpha=0.5,reg.weights=1", None),
]


def _minimal_train(tmp_path, coordinate="name=global,feature.shard=globalShard,regularization=L2,reg.weights=1"):
    return ["--training-task", "LOGISTIC_REGRESSION", "--input-data-directories", str(tmp_path / "none.avro"),
            "--root-output-directory", str(tmp_path / "out"), "--feature-shard-configurations", SHARD,
            "--coordinate-configurations", coordinate, "--device", "cpu"]


def _both_drivers(args, root: Path, ckpt=None):
    """`args` (run_glmix.sh's training command with the option under test,
    "@OUT@" for the output root and "@CK@" for a checkpoint directory)
    through the port's driver on the CPU and through the JAX driver: the
    two best models and training summaries. `ckpt` maps each package to
    its checkpoint directory."""
    def sub(k):
        return [a.replace("@OUT@", str(root / k)).replace("@CK@", str((ckpt or {}).get(k))) for a in args]

    train_cli.main(sub("port") + ["--device", "cpu"])
    jax_train_cli.main(sub("jax"))
    best = root / "port" / "models" / "best"
    imaps = {"globalShard": IndexMap.load(str(best / "feature-indexes" / "globalShard.json"))}
    models = {k: model_store.load_game_model(str(root / k / "models" / "best"), imaps) for k in ("port", "jax")}
    summaries = {k: json.loads((root / k / "training-summary.json").read_text()) for k in ("port", "jax")}
    return models, summaries


def _assert_drivers_agree(models, summaries, variances: bool = False):
    for cid in ("global", "per-member"):
        a, b = models["port"].coordinates[cid], models["jax"].coordinates[cid]
        assert np.abs(a.means - b.means).max() <= TOL["coef_atol"]
        if variances:
            assert a.variances is not None and np.all(np.isfinite(a.variances))
            np.testing.assert_allclose(a.variances, b.variances, rtol=TOL["variance_rtol"])
    assert abs(summaries["port"]["best_evaluation"]["AUC"] - summaries["jax"]["best_evaluation"]["AUC"]) \
        <= TOL["metric_atol"]


def _build_index(data: Path, out: Path, fmt: str, partitions: int = 2) -> Path:
    assert build_index.main(["--input-data-directories", str(data / "train.avro"),
                             "--feature-shard-configurations", SHARD, "--num-partitions", str(partitions),
                             "--output-dir", str(out), "--output-format", fmt]) == 0
    return out


def _load_by_name(model_dir: Path, like: Path):
    """A model directory loaded through another directory's feature map, so
    two models whose feature ids differ compare by feature name."""
    imaps = {"globalShard": IndexMap.load(str(like / "feature-indexes" / "globalShard.json"))}
    return model_store.load_game_model(str(model_dir), imaps)


def _offheap_option(glmix, tmp_path, store: str):
    """Both drivers train through the port's PHIDX and PalDB stores of the
    training data: the same models as each other, the store's map shipped
    beside the model, and the in-memory map's model by feature name."""
    data = glmix["data"]
    for fmt in ("phidx", "paldb"):
        idx = _build_index(data, tmp_path / f"{store}-{fmt}", fmt)
        root = tmp_path / fmt
        models, summaries = _both_drivers(_train_args(data, Path("@OUT@"), ["--offheap-indexmap-dir", str(idx)]),
                                          root)
        _assert_drivers_agree(models, summaries)
        shipped = {k: json.loads((root / k / "models" / "best" / "feature-indexes" / "globalShard.json").read_text())
                   for k in ("port", "jax")}
        assert shipped["port"] == shipped["jax"]
        assert shipped["port"]["(INTERCEPT)"] == 0  # the store sorts the intercept first
        in_memory = _load_by_name(glmix["models"]["port"], glmix["models"]["port"])
        offheap = _load_by_name(root / "port" / "models" / "best", glmix["models"]["port"])
        for cid in ("global", "per-member"):
            assert np.abs(offheap.coordinates[cid].means - in_memory.coordinates[cid].means).max() <= TOL["coef_atol"]
        assert abs(summaries["port"]["best_evaluation"]["AUC"] - glmix["port_summary"]["best_evaluation"]["AUC"]) \
            <= TOL["metric_atol"]


def _tuning_option(glmix, tmp_path, mode: str):
    """Three trials after the explicit sweep, every model saved (ALL): the
    same trial weights as the JAX driver where the searchers propose the
    same points (every RANDOM trial, and BAYESIAN's Sobol trials), each
    trial's model within the estimator tolerance of the JAX driver's, and
    the best model chosen over explicit and tuned results."""
    args = _train_args(glmix["data"], Path("@OUT@"), ["--hyper-parameter-tuning", mode,
                                                      "--hyper-parameter-tuning-iter", "3"])
    args[args.index("--output-mode") + 1] = "ALL"
    models, summaries = _both_drivers(args, tmp_path)
    for k in ("port", "jax"):
        assert summaries[k]["num_explicit"] == 1 and summaries[k]["num_tuned"] == 3
        assert sorted(os.listdir(tmp_path / k / "models")) == ["best", "explicit-0", "tuned-0", "tuned-1",
                                                               "tuned-2"]
    like = tmp_path / "port" / "models" / "best"
    runs = {k: [_load_by_name(tmp_path / k / "models" / d, like) for d in ("explicit-0", "tuned-0", "tuned-1",
                                                                          "tuned-2")]
            for k in ("port", "jax")}
    weights = {k: [{c: m.opt_configs[c]["reg_weight"] for c in ("global", "per-member")} for m in runs[k]]
               for k in ("port", "jax")}
    trials = summaries["port"]["tuning_trials"]
    assert [t["reg_weights"] for t in trials] == weights["port"][1:]
    assert all(t["fit_s"] > 0 for t in trials)
    same = 4 if mode == "RANDOM" else 1 + 2  # BAYESIAN: the explicit fit and the two Sobol trials
    for i in range(4):
        if i < same:
            assert weights["port"][i] == weights["jax"][i]
            fe = {k: runs[k][i].coordinates["global"].means for k in ("port", "jax")}
            assert np.abs(fe["port"] - fe["jax"]).max() <= TOL["coef_atol"]
            # A random effect at a weight near 0 sits anywhere within its f32
            # stopping noise, ~sqrt(2 eps f / l2) (PORT_TOLERANCES["estimator"]),
            # so the trials' random effects compare on the metric the search
            # reads: each saved model scored on the validation file.
            auc = {}
            for k in ("port", "jax"):
                model = tmp_path / k / "models" / ("explicit-0" if i == 0 else f"tuned-{i - 1}")
                auc[k] = score_cli.main(_score_args(glmix["data"], model, tmp_path / f"scores-{k}-{i}")
                                        + ["--device", "cpu"])["evaluation"]["AUC"]
            assert abs(auc["port"] - auc["jax"]) <= TOL["metric_atol"]
            if i:
                assert abs(auc["port"] - trials[i - 1]["value"]) <= TOL["metric_atol"]
    aucs = [glmix["port_summary"]["best_evaluation"]["AUC"]] + [t["value"] for t in trials]
    assert summaries["port"]["best_index"] == int(np.argmax(aucs))
    assert summaries["port"]["best_evaluation"]["AUC"] == max(aucs)
    if mode == "RANDOM":
        assert summaries["port"]["best_index"] == summaries["jax"]["best_index"]
        _assert_drivers_agree(models, summaries)


def _profile_option(glmix, tmp_path):
    """The fixture's port run's profile.json plans a second run: the model is
    the unplanned one bit for bit, and the plan block is active, from the
    profile, in the summary, the profile and the journal."""
    from photon_ml_tpu_torch import planner

    profile = glmix["root"] / "port" / "profile.json"
    out = tmp_path / "planned"
    summary = train_cli.main(_train_args(glmix["data"], out, ["--profile", str(profile), "--device", "cpu"]))
    assert planner.current_plan() is None
    imaps = {"globalShard": IndexMap.load(str(glmix["models"]["port"] / "feature-indexes" / "globalShard.json"))}
    planned = model_store.load_game_model(str(out / "models" / "best"), imaps)
    unplanned = model_store.load_game_model(str(glmix["models"]["port"]), imaps)
    for cid in ("global", "per-member"):
        np.testing.assert_array_equal(planned.coordinates[cid].means, unplanned.coordinates[cid].means)
    plan = summary["fit_timing"]["plan"]
    assert plan["active"] and plan["source"] == "profile" and plan["profile"] == str(profile)
    assert [d["decision"] for d in plan["decisions"]] == ["ingest_chunk_rows"]
    assert glmix["port_summary"]["fit_timing"]["plan"] == planner.inactive_block()
    assert json.loads((out / "profile.json").read_text())["plan"] == plan
    types = [json.loads(x)["type"] for x in open(out / "journal.jsonl")]
    assert types[:2] == ["setup", "plan_decision"]


def _ported_train_option(glmix, tmp_path, extra):
    data = glmix["data"]
    if extra[0] == "--offheap-indexmap-dir":
        _offheap_option(glmix, tmp_path, extra[1])
    elif extra[0] == "--hyper-parameter-tuning":
        _tuning_option(glmix, tmp_path, extra[1])
    elif extra[0] == "--profile":
        _profile_option(glmix, tmp_path)
    elif extra[0] == "--checkpoint-directory":
        # One run writes the checkpoint, a rerun resumes from its end; both
        # give the uninterrupted fit's model.
        ckpt = {"port": tmp_path / extra[1], "jax": tmp_path / f"jax-{extra[1]}"}
        train_cli.main(_train_args(data, tmp_path / "first",
                                   ["--checkpoint-directory", str(ckpt["port"]), "--device", "cpu"]))
        assert (ckpt["port"] / "config-0" / "state.json").is_file()
        models, summaries = _both_drivers(
            _train_args(data, Path("@OUT@"), ["--checkpoint-directory", "@CK@"]), tmp_path, ckpt)
        imaps = {"globalShard": IndexMap.load(str(glmix["models"]["port"] / "feature-indexes" / "globalShard.json"))}
        straight = model_store.load_game_model(str(glmix["models"]["port"]), imaps)
        resume = PORT_TOLERANCES["checkpoint_resume"]
        for cid in ("global", "per-member"):
            np.testing.assert_allclose(models["port"].coordinates[cid].means,
                                       straight.coordinates[cid].means, **resume)
        _assert_drivers_agree(models, summaries)
    else:
        _assert_drivers_agree(*_both_drivers(_train_args(data, Path("@OUT@"), extra), tmp_path),
                              variances=True)


@pytest.mark.parametrize("extra,item", UNPORTED)
def test_each_unported_train_option_raises_before_any_work(glmix, tmp_path, extra, item):
    if item is None:
        _ported_train_option(glmix, tmp_path, extra)
        return
    if item == "item 9":
        with pytest.raises(ValueError, match="--checkpoint-directory is required"):
            train_cli.main(_minimal_train(tmp_path) + extra)
        assert not (tmp_path / "out").exists()
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 {item}\\)"):
        train_cli.main(_minimal_train(tmp_path) + extra)
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("coordinate,item", UNPORTED_COORDINATES)
def test_each_unported_coordinate_setting_raises_before_any_work(glmix, tmp_path, coordinate, item):
    if item is not None:
        with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 {item}\\)"):
            train_cli.main(_minimal_train(tmp_path, coordinate))
        assert not (tmp_path / "out").exists()
        return
    constraints = tmp_path / "c.json"
    constraints.write_text(json.dumps([{"name": "*", "term": "*", "lowerBound": -0.05,
                                        "upperBound": 0.2}]))
    args = _train_args(glmix["data"], Path("@OUT@"))
    at = args.index("--coordinate-configurations") + 1
    args[at] = coordinate.replace("c.json", str(constraints)) + ",tolerance=1.0E-7,max.iter=50"
    if "constraints.file" in coordinate:
        # The reference's projected L-BFGS stops at points that depend on its
        # path: offsets moved by 1e-5 move the JAX fixed effect of the second
        # sweep by ~0.09 (ROADMAP Queue 3), which is what the two packages'
        # first-sweep random effects differ by. One sweep gives both drivers
        # the same inputs.
        args[args.index("--coordinate-descent-iterations") + 1] = "1"
    models, summaries = _both_drivers(args, tmp_path)
    _assert_drivers_agree(models, summaries)
    means = models["port"].coordinates["global"].means
    if "constraints.file" in coordinate:  # the box holds exactly, and binds
        inner = np.delete(means, IndexMap.load(str(tmp_path / "port" / "models" / "best" / "feature-indexes"
                                                   / "globalShard.json")).intercept_index)
        assert inner.min() >= np.float32(-0.05) and inner.max() <= np.float32(0.2)
        assert np.any(inner == np.float32(-0.05)) or np.any(inner == np.float32(0.2))


def test_score_refuses_the_offheap_index_store(glmix, tmp_path):
    """Ported since: a model trained through a PHIDX store scores through
    that store in both packages' scoring drivers, per uid as through the
    JSON map saved beside it."""
    data = glmix["data"]
    idx = _build_index(data, tmp_path / "idx", "phidx", partitions=3)
    train_cli.main(_train_args(data, tmp_path / "train", ["--device", "cpu", "--offheap-indexmap-dir", str(idx)]))
    model = tmp_path / "train" / "models" / "best"
    per_uid = {}
    for name, extra in (("port", ["--offheap-indexmap-dir", str(idx), "--device", "cpu"]),
                        ("port-json", ["--device", "cpu"]), ("jax", ["--offheap-indexmap-dir", str(idx)])):
        out = tmp_path / f"scores-{name}"
        (jax_score_cli if name == "jax" else score_cli).main(_score_args(data, model, out) + extra)
        per_uid[name] = {it.uid: it.prediction_score for it in jax_scores.load_scores(str(out / "scores"))}
    assert len(per_uid["port"]) == 800 and per_uid["port"] == per_uid["port-json"]
    assert max(abs(per_uid["port"][u] - per_uid["jax"][u]) for u in per_uid["port"]) <= TOL["score_atol"]


def test_cuda_without_a_card_raises_in_both_drivers(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in _minimal_train(tmp_path) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        train_cli.main(args)
    assert not (tmp_path / "out").exists()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        score_cli.main(["--input-data-directories", "x", "--model-input-directory", "m",
                        "--root-output-directory", str(tmp_path / "out"),
                        "--feature-shard-configurations", SHARD])
