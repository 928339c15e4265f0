"""`cli.tune` on the CPU against the JAX driver and the port's `cli.train`.

examples/run_glmix.sh's job (examples/generate_dataset.py at its sizes:
2,400 training and 800 validation rows, 24 members; a fixed effect and a
per-member random effect, its solver settings) is tuned by the port's
`cli.tune --device cpu` (RANDOM rounds, stacked trials) and by the JAX
`cli.tune` on the same Avro files: `tuning-summary.json` carries the reference's keys, the journal is
valid under both packages' validators, both drivers try the same points and
pick the same winner, and the saved winners agree within
PORT_TOLERANCES["glmix"]. The port's `models/tuned-best` is bit-equal to
the port's `cli.train` at the winner's weights. `--profile` raises before
any data is read.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from photon_ml_tpu.cli import tune as jax_tune_cli
from photon_ml_tpu.utils import telemetry as jax_telemetry
from photon_ml_tpu_torch.cli import libsvm_to_avro
from photon_ml_tpu_torch.cli import train as train_cli
from photon_ml_tpu_torch.cli import tune as tune_cli
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.data.index_map import IndexMap
from photon_ml_tpu_torch.io import model_store
from photon_ml_tpu_torch.utils import faults, telemetry

TOL = PORT_TOLERANCES["glmix"]
REPO = Path(__file__).resolve().parent.parent
SHARD = "name=globalShard,feature.bags=features,intercept=true"
FE = "name=global,feature.shard=globalShard,optimizer=LBFGS,tolerance=1.0E-7,max.iter=50,regularization=L2"
RE = ("name=per-member,random.effect.type=memberId,feature.shard=globalShard,optimizer=LBFGS,"
      "max.iter=30,regularization=L2,min.bucket=8")


def _tune_args(data: Path, out: Path, extra=()):
    return [
        "--training-task", "LOGISTIC_REGRESSION",
        "--input-data-directories", str(data / "train.avro"),
        "--validation-data-directories", str(data / "test.avro"),
        "--root-output-directory", str(out),
        "--feature-shard-configurations", SHARD,
        "--coordinate-configurations", FE + ",reg.weights=1", RE + ",reg.weights=10",
        "--coordinate-descent-iterations", "2",
        "--validation-evaluators", "AUC",
        "--tuning-mode", "RANDOM", "--tuning-iter", "4", "--tuning-batch-size", "2",
        "--random-seed", "3", "--logging-level", "WARNING",
        *extra,
    ]


@pytest.fixture(scope="module")
def tuned(tmp_path_factory):
    faults.clear()
    telemetry.METRICS.reset()
    root = tmp_path_factory.mktemp("tune")
    data = root / "data"
    subprocess.run([sys.executable, str(REPO / "examples" / "generate_dataset.py"), str(data),
                    "--train", "2400", "--test", "800", "--entities", "24"],
                   check=True, capture_output=True, timeout=120)
    for split in ("train", "test"):
        assert libsvm_to_avro.main(["--tag-comments", str(data / f"{split}.libsvm"),
                                    str(data / f"{split}.avro")]) == 0
    port = tune_cli.main(_tune_args(data, root / "port", ["--device", "cpu"]))
    jax = jax_tune_cli.run(jax_tune_cli.build_parser().parse_args(
        _tune_args(data, root / "jax", ["--sweep-mode", "serial"])))
    return dict(root=root, data=data, port=port, jax=jax)


def _load(model_dir: Path):
    imaps = {"globalShard": IndexMap.load(str(model_dir / "feature-indexes" / "globalShard.json"))}
    return model_store.load_game_model(str(model_dir), imaps)


def test_the_summary_has_the_references_keys(tuned):
    ours, theirs = tuned["port"], tuned["jax"]
    assert set(ours) == set(theirs) | {"timings_s"}
    on_disk = json.loads((tuned["root"] / "port" / "tuning-summary.json").read_text())
    assert on_disk == json.loads(json.dumps(ours, default=str))
    assert ours["modes"] == ["stacked"] and ours["rounds"] == 2 and len(ours["trials"]) == 4
    assert ours["tuned_coordinates"] == ["global", "per-member"]
    assert ours["num_training_samples"] == 2400 and ours["num_validation_samples"] == 800
    assert [d["chunks"] for d in ours["stack_decisions"]] == [[2], [2]]
    for section in ("read data", "validate data", "prepare", "sweep", "save model"):
        assert ours["timings_s"][section] >= 0.0
    mdir = tuned["root"] / "port" / "models" / "tuned-best"
    assert (mdir / "model-metadata.json").is_file()
    assert (mdir / "feature-indexes" / "globalShard.json").is_file()


def test_the_journal_is_valid(tuned):
    path = str(tuned["root"] / "port" / "journal.jsonl")
    n_ok, errors = telemetry.validate_journal(path)
    assert errors == [] and jax_telemetry.validate_journal(path)[1] == []
    types = [json.loads(line)["type"] for line in open(path) if line.strip()]
    assert types.count("trial_start") == 4 and types.count("trial_finish") == 4
    assert n_ok == len(types)


def test_the_port_tries_the_jax_drivers_points(tuned):
    ours, theirs = tuned["port"], tuned["jax"]
    np.testing.assert_allclose([t["value"] for t in ours["trials"]],
                               [t["value"] for t in theirs["trials"]], atol=TOL["auc_atol"], rtol=0)
    assert ours["best_trial"] == theirs["best_trial"]
    assert ours["best_point"] == theirs["best_point"]
    assert abs(ours["winner_value"] - theirs["winner_value"]) <= TOL["auc_atol"]
    a = _load(tuned["root"] / "port" / "models" / "tuned-best")
    b = _load(tuned["root"] / "jax" / "models" / "tuned-best")
    np.testing.assert_allclose(a.coordinates["global"].means, b.coordinates["global"].means,
                               atol=TOL["coef_atol"], rtol=0)
    assert a.coordinates["per-member"].entity_ids == b.coordinates["per-member"].entity_ids
    np.testing.assert_allclose(a.coordinates["per-member"].means, b.coordinates["per-member"].means,
                               atol=TOL["coef_atol"], rtol=0)


def test_the_winner_is_cli_train_at_its_weights(tuned):
    w_fe, w_re = tuned["port"]["best_point"]
    out = tuned["root"] / "train-at-winner"
    train_cli.main([
        "--training-task", "LOGISTIC_REGRESSION",
        "--input-data-directories", str(tuned["data"] / "train.avro"),
        "--validation-data-directories", str(tuned["data"] / "test.avro"),
        "--root-output-directory", str(out),
        "--feature-shard-configurations", SHARD,
        "--coordinate-configurations", FE + f",reg.weights={w_fe!r}", RE + f",reg.weights={w_re!r}",
        "--coordinate-descent-iterations", "2", "--validation-evaluators", "AUC",
        "--random-seed", "3", "--device", "cpu", "--logging-level", "WARNING",
    ])
    a = _load(tuned["root"] / "port" / "models" / "tuned-best")
    b = _load(out / "models" / "best")
    np.testing.assert_array_equal(a.coordinates["global"].means, b.coordinates["global"].means)
    assert a.coordinates["per-member"].entity_ids == b.coordinates["per-member"].entity_ids
    np.testing.assert_array_equal(a.coordinates["per-member"].means, b.coordinates["per-member"].means)


def test_profile_raises_before_any_read(tmp_path):
    """`--profile` plans the sweep before the read: a profile of another
    topology (the JAX tests' 8-device mesh) is refused before anything is
    read; one of this run's topology installs its plan, and the failed read
    uninstalls it."""
    from photon_ml_tpu_torch import planner

    for name, topology in (("jax", jax_telemetry.device_topology()), ("port", telemetry.device_topology(None))):
        profile = telemetry.build_profile("serve", wall_s=1.0, stages={}, dispatch={"max_batch": 64},
                                          bucket_shapes={}, serving={"batch_size_p95": 3}, topology=topology)
        telemetry.write_profile(str(tmp_path / f"{name}.json"), profile)
    args = _tune_args(tmp_path / "no-such-data", tmp_path / "out",
                      ["--profile", str(tmp_path / "jax.json"), "--device", "cpu"])
    with pytest.raises(planner.PlanTopologyError, match="'device_count'"):
        tune_cli.main(args)
    assert not (tmp_path / "out" / "models").exists()
    args[args.index("--profile") + 1] = str(tmp_path / "port.json")
    with pytest.raises(FileNotFoundError, match="no-such-data"):
        tune_cli.main(args)
    assert planner.current_plan() is None
    lines = [json.loads(x)["type"] for x in open(tmp_path / "out" / "journal.jsonl")]
    assert lines == ["plan_decision", "plan_decision"]


def test_a_run_refuses_to_overwrite_models(tuned):
    args = _tune_args(tuned["data"], tuned["root"] / "port", ["--device", "cpu"])
    with pytest.raises(FileExistsError, match="override-output-directory"):
        tune_cli.main(args)
