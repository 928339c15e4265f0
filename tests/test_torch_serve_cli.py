"""`photon_ml_tpu_torch.cli.serve` on the CPU, against the port's cli.score
and the JAX package's cli.serve.

examples/run_glmix.sh's data (its generator, then the port's libsvm_to_avro)
trains a tiny GLMix model with each package's cli.train. The port's
cli.serve (`--device cpu`) replays the test file as Avro requests and as
JSON lines:

  * serving-summary.json carries every SERVING_SUMMARY_KEYS key, no failed
    request, health CLOSED, every clean-run counter 0, the reference's
    inactive plan block; journal.jsonl passes both packages' validators and
    profile.json the JAX reader; trace.json appears under PHOTON_TRACE;
  * the scores equal the port's cli.score by uid within
    PORT_TOLERANCES["convert_scores"], and the JAX cli.serve's on the same
    inputs; JSON and Avro requests give the same bits;
  * each package serves the model directory the other's cli.train wrote;
  * a malformed request line costs one record, and a corrupt Avro block
    its requests (quarantined and counted, as in the JAX cli.serve); each
    refused flag combination raises the reference's refusal, and each flag
    of a part not ported names its ROADMAP item (or the multi-host scope's
    refusal), before anything is staged.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from photon_ml_tpu import planner as jax_planner
from photon_ml_tpu.cli import serve as jax_serve_cli
from photon_ml_tpu.cli import train as jax_train_cli
from photon_ml_tpu.utils import contracts as jax_contracts
from photon_ml_tpu.utils import telemetry as jax_telemetry
from photon_ml_tpu_torch.cli import libsvm_to_avro
from photon_ml_tpu_torch.cli import score as score_cli
from photon_ml_tpu_torch.cli import serve as serve_cli
from photon_ml_tpu_torch.cli import train as train_cli
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.data.index_map import INTERCEPT_KEY, feature_key
from photon_ml_tpu_torch.io import avro, score_store
from photon_ml_tpu_torch.utils import faults, telemetry

pytestmark = pytest.mark.serving

REPO = Path(__file__).resolve().parent.parent
SHARD = "name=globalShard,feature.bags=features,intercept=true"
TOL = PORT_TOLERANCES["convert_scores"]


@pytest.fixture(autouse=True)
def _port_fault_hygiene():
    faults.clear()
    telemetry.METRICS.reset()
    yield
    faults.clear()
    telemetry.METRICS.reset()


def _train_args(data: Path, out: Path):
    return ["--training-task", "LOGISTIC_REGRESSION", "--input-data-directories", str(data / "train.avro"),
            "--root-output-directory", str(out), "--feature-shard-configurations", SHARD,
            "--coordinate-configurations",
            "name=global,feature.shard=globalShard,optimizer=LBFGS,tolerance=1.0E-7,max.iter=50,"
            "regularization=L2,reg.weights=1",
            "name=per-member,random.effect.type=memberId,feature.shard=globalShard,optimizer=LBFGS,"
            "max.iter=30,regularization=L2,reg.weights=10,min.bucket=8",
            "--coordinate-descent-iterations", "2", "--output-mode", "BEST"]


def _serve_args(model: Path, requests: Path, out: Path, avro_requests: bool = True):
    args = ["--model-input-directory", str(model), "--requests", str(requests),
            "--root-output-directory", str(out), "--max-batch", "16", "--max-wait-ms", "1"]
    return args + (["--feature-shard-configurations", SHARD] if avro_requests else [])


def _by_uid(scores_dir: Path) -> dict:
    cols = score_store.load_score_columns(str(scores_dir))
    return dict(zip(cols.uids, cols.scores.tolist()))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    # Set up before the per-test hygiene: start from no plan and zero counts,
    # whatever an earlier test file in this process left.
    faults.clear()
    telemetry.METRICS.reset()
    root = tmp_path_factory.mktemp("serve")
    data = root / "data"
    subprocess.run([sys.executable, str(REPO / "examples" / "generate_dataset.py"), str(data),
                    "--train", "1200", "--test", "400", "--entities", "12"],
                   check=True, capture_output=True, timeout=120)
    for split in ("train", "test"):
        assert libsvm_to_avro.main(["--tag-comments", str(data / f"{split}.libsvm"),
                                    str(data / f"{split}.avro")]) == 0
    train_cli.main(_train_args(data, root / "port") + ["--device", "cpu"])
    jax_train_cli.main(_train_args(data, root / "jax"))
    models = {k: root / k / "models" / "best" for k in ("port", "jax")}
    # The test file as JSON lines: named features with the intercept.
    records = avro.read_container(str(data / "test.avro"))[1]
    json_path = root / "requests.jsonl"
    with open(json_path, "w") as f:
        for rec in records:
            feats = {feature_key(x["name"], x["term"]): x["value"] for x in rec["features"]}
            feats[INTERCEPT_KEY] = 1.0
            f.write(json.dumps({"uid": rec["uid"], "offset": rec["offset"],
                                "ids": {"memberId": rec["metadataMap"]["memberId"]},
                                "features": {"globalShard": feats}}) + "\n")
    out = {}
    for name, model, requests, is_avro in (("avro", "port", data / "test.avro", True),
                                           ("json", "port", json_path, False),
                                           ("port-on-jax", "jax", data / "test.avro", True)):
        out[name] = root / f"served-{name}"
        serve_cli.main(_serve_args(models[model], requests, out[name], is_avro) + ["--device", "cpu"])
    for name, model in (("jax", "port"), ("jax-on-jax", "jax")):
        out[name] = root / f"served-{name}"
        jax_serve_cli.main(_serve_args(models[model], data / "test.avro", out[name]))
    scored = root / "scored"
    score_cli.main(["--input-data-directories", str(data / "test.avro"), "--model-input-directory",
                    str(models["port"]), "--root-output-directory", str(scored),
                    "--feature-shard-configurations", SHARD, "--device", "cpu"])
    return dict(root=root, data=data, models=models, out=out, scored=scored, json=json_path)


def test_the_summary_journal_and_profile(served):
    out = served["out"]["avro"]
    summary = json.loads((out / "serving-summary.json").read_text())
    assert sorted(summary) == sorted(jax_contracts.SERVING_SUMMARY_KEYS)
    assert summary["num_requests"] == 400 and summary["failed_requests"] == 0
    assert summary["malformed_records"] == 0
    serving = summary["serving"]
    assert all(serving[k] is not None for k in jax_contracts.SERVING_METRIC_KEYS)
    assert serving["recompiles_after_warmup"] == 0 and serving["compiles"] == 5  # buckets 1..16
    assert all(serving[k] == 0 for k in jax_contracts.SERVING_CLEAN_ZERO_KEYS)
    assert list(serving["sharding"]) == list(jax_contracts.SERVING_SHARDING_KEYS)
    assert summary["health"]["state"] == "CLOSED"
    assert all(summary["robustness_counters"][k] == 0 for k in jax_contracts.ROBUSTNESS_CLEAN_ZERO_KEYS)
    assert summary["plan"] == jax_planner.inactive_block()
    assert summary["tenants"] == summary["shadow"] == summary["autopilot"] == {}
    assert summary["provenance"]["origin"] == "artifact"
    n_ok, errors = jax_telemetry.validate_journal(str(out / "journal.jsonl"))
    assert errors == [] and n_ok >= 3  # READY, DRAINING, CLOSED
    assert telemetry.validate_journal(str(out / "journal.jsonl")) == (n_ok, [])
    profile = jax_telemetry.read_profile(str(out / "profile.json"), kind="serve")
    assert profile["dispatch"]["max_batch"] == 16 and profile["bucket_shapes"]["engine_buckets"] == [1, 2, 4, 8, 16]
    assert profile["device_topology"]["platform"] == "cpu"
    assert not (out / "trace.json").exists()


def test_scores_agree_with_cli_score_by_uid(served):
    ours, offline = _by_uid(served["out"]["avro"] / "scores"), _by_uid(served["scored"] / "scores")
    assert len(ours) == 400 and sorted(ours) == sorted(offline)
    uids = sorted(ours)
    np.testing.assert_allclose([ours[u] for u in uids], [offline[u] for u in uids], rtol=TOL["rtol"], atol=TOL["atol"])


def test_json_and_avro_requests_score_the_same_bits(served):
    assert _by_uid(served["out"]["json"] / "scores") == _by_uid(served["out"]["avro"] / "scores")


@pytest.mark.parametrize("ours,theirs", [("avro", "jax"), ("port-on-jax", "jax-on-jax")])
def test_scores_agree_with_the_jax_serve(served, ours, theirs):
    """The same model directory and requests through both packages' drivers;
    the second pair serves the directory the JAX cli.train wrote."""
    a, b = _by_uid(served["out"][ours] / "scores"), _by_uid(served["out"][theirs] / "scores")
    assert sorted(a) == sorted(b) and len(a) == 400
    uids = sorted(a)
    np.testing.assert_allclose([a[u] for u in uids], [b[u] for u in uids], rtol=TOL["rtol"], atol=TOL["atol"])
    jax_summary = json.loads((served["out"][theirs] / "serving-summary.json").read_text())
    assert jax_summary["failed_requests"] == 0


def test_a_malformed_request_costs_one_record_and_tracing_writes_a_trace(served, tmp_path, monkeypatch):
    lines = served["json"].read_text().splitlines()[:20]
    bad = tmp_path / "requests.jsonl"
    bad.write_text("\n".join(lines[:10] + ["{not json"] + lines[10:]) + "\n")
    monkeypatch.setenv("PHOTON_TRACE", "1")
    summary = serve_cli.main(_serve_args(served["models"]["port"], bad, tmp_path / "out", False)
                             + ["--device", "cpu"])
    assert summary["malformed_records"] == 1 and summary["num_requests"] == 20
    assert summary["failed_requests"] == 0
    trace = json.loads((tmp_path / "out" / "trace.json").read_text())
    names = {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"}
    assert {"serve_warmup", "serve_replay", "serving_batch", "serve_score"} <= names
    assert telemetry.current_tracer() is None and telemetry.current_journal() is None


# The reference's refusals of flag combinations come first, in its words
# (`--tenant`, `--shadow` and `--labels` are ported: tests/test_torch_tenancy.py
# and tests/test_torch_shadow.py run them); then the parts the port has not
# got raise, naming their ROADMAP item. The multi-host flags of item 9 are
# ported since: under them the supervisor or a worker first refuses, as the
# JAX driver's `_validate_scope` does, a command line outside the
# multi-host scope, and `run()` refuses them (they dispatch in `main()`);
# tests/test_torch_serve_multihost.py runs them. A row with `--tenant`
# names no model directory unless it lists one.
_SCOPE = "--multihost serve scope"


@pytest.mark.parametrize("extra,error,match", [
    (["--tenant", "a=x", "--reshard-to", "2"], ValueError, "--reshard-to is a single-tenant drill"),
    (["--shadow", "b=x", "--tenant", "a=x"], ValueError, "--shadow mirrors one champion's traffic"),
    (["--shadow", "b=x", "--reshard-to", "2"], ValueError, "--shadow and --reshard-to both drive"),
    (["--autopilot"], ValueError, "--autopilot supervises a multi-tenant fleet"),
    (["--tenant", "a=x", "--model-input-directory", "m"], ValueError, "pass exactly one of"),
    (["--reshard-to", "2"], NotImplementedError, "item 9"),
    (["--multihost", "2", "--tenant", "a=x"], ValueError, f"{_SCOPE}: --tenant .multi-tenant. has no multi-host"),
    (["--multihost", "2", "--multihost-devices-per-host", "4", "--reshard-to", "2"], ValueError,
     f"{_SCOPE}: --reshard-to is a single-process drill"),
    (["--mh-serve-worker", "--tenant", "a=x"], ValueError, f"{_SCOPE}: --tenant"),
    (["--mh-serve-worker", "--mh-host-id", "1", "--reshard-to", "2"], ValueError, f"{_SCOPE}: --reshard-to"),
    (["--multihost", "3", "--mh-resume-window", "3", "--multihost-devices-per-host", "0"], ValueError,
     "--multihost-devices-per-host 0")])
def test_each_refused_flag_raises_before_staging(tmp_path, extra, error, match):
    out = tmp_path / "out"
    model = [] if "--tenant" in extra else ["--model-input-directory", str(tmp_path / "no-model")]
    with pytest.raises(error, match=match):
        serve_cli.main([*model, "--requests", "r.jsonl", "--root-output-directory", str(out),
                        "--device", "cpu", *extra])
    assert not out.exists()


@pytest.mark.parametrize("extra", [["--multihost", "2"], ["--mh-serve-worker"]])
def test_run_is_the_single_process_path(tmp_path, extra):
    """`run()` refuses the multi-host flags (they dispatch in `main()`), as
    the JAX driver's does, and a missing model directory is the
    multi-host scope's first refusal."""
    args = serve_cli.build_parser().parse_args([
        "--model-input-directory", str(tmp_path / "m"), "--requests", "r.jsonl",
        "--root-output-directory", str(tmp_path / "out"), "--device", "cpu", *extra])
    with pytest.raises(ValueError, match="dispatches in serve.main"):
        serve_cli.run(args)
    with pytest.raises(ValueError, match=f"{_SCOPE}: --model-input-directory is required"):
        serve_cli.main(["--requests", "r.jsonl", "--root-output-directory", str(tmp_path / "out"), *extra])
    assert not (tmp_path / "out").exists()


def test_a_corrupt_request_block_costs_its_requests_as_in_the_jax_serve(served, tmp_path):
    """The test file rewritten in blocks of 50 records, one block broken:
    both packages' drivers replay the other 350 requests to the same scores
    and count the block in `quarantined_blocks`."""
    from photon_ml_tpu.utils import faults as jax_faults

    schema, records = avro.read_container(str(served["data"] / "test.avro"))
    path = tmp_path / "requests.avro"
    avro.write_container(str(path), schema, records, block_records=50)
    data = bytearray(path.read_bytes())
    _, _, sync, pos = avro.read_header(bytes(data), str(path))
    marks = [i for i in range(pos, len(data)) if bytes(data[i:i + 16]) == sync]
    dec = avro.BinaryDecoder(bytes(data), marks[2] + 16)  # the fourth block
    dec.read_long()
    dec.read_long()
    data[dec.pos] = 0x07  # a deflate block of the reserved type: its inflate fails
    path.write_bytes(bytes(data))
    theirs0 = jax_faults.COUNTERS.get("quarantined_blocks")
    ours = serve_cli.main(_serve_args(served["models"]["port"], path, tmp_path / "port") + ["--device", "cpu"])
    jax_serve_cli.main(_serve_args(served["models"]["port"], path, tmp_path / "jax"))
    theirs = json.loads((tmp_path / "jax" / "serving-summary.json").read_text())
    assert ours["num_requests"] == 350 and ours["failed_requests"] == 0
    assert ours["robustness_counters"]["quarantined_blocks"] == 1
    assert jax_faults.COUNTERS.get("quarantined_blocks") - theirs0 == 1
    a, b = _by_uid(tmp_path / "port" / "scores"), _by_uid(tmp_path / "jax" / "scores")
    assert sorted(a) == sorted(b) and len(a) == 350
    uids = sorted(a)
    np.testing.assert_allclose([a[u] for u in uids], [b[u] for u in uids], rtol=TOL["rtol"], atol=TOL["atol"])
    assert theirs["num_requests"] == 350 and theirs["failed_requests"] == 0


def test_cuda_without_a_card_raises(served, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        serve_cli.main(_serve_args(served["models"]["port"], served["json"], tmp_path / "out", False))
    assert not (tmp_path / "out").exists()
