"""Multi-host serving in the port (`cli.serve --multihost N`, cli/
serve_multihost.py), on the CPU.

In one process, against the JAX package: the same numpy model with two
random effects (carried across by `convert.py`) is staged by the JAX
package on the test run's 8-device CPU mesh and by the port as 8 row
blocks on one device. For host k of N (N = 2, 3) both packages'
`_mark_host_local` must own the same shards and rows, and the same
requests must lose a row (`n_lost > 0`), with scores within
PORT_TOLERANCES["convert_scores"]. Both packages' `_merge_scores` turn the
same result parts into the same score records. A worker's answer with no
lost row is bit-equal to one process's engine.

End to end, as a user runs it: a model with one random effect (as the
reference's anchor, `tests/test_multihost_prod.py`) trained by the port's
`cli.train`, then `cli.serve --multihost 2 --device cpu`, whose workers are
`python -m photon_ml_tpu_torch.cli.serve --mh-serve-worker` processes:
uninterrupted (every answer bit-equal to one process's `cli.serve`), with
worker 1 SIGKILLed and no retry budget (no failed request, the lost rows
answered FE-only by the survivor), and with a budget of one (the relaunch
restages through `host_join` and the scores are the uninterrupted ones).
A relaunch resumes at its last durable window (in process, with small
windows).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from photon_ml_tpu.cli import serve_multihost as jax_smh
from photon_ml_tpu.game.model import Coefficients as JaxCoefficients
from photon_ml_tpu.game.model import FixedEffectModel as JaxFixedEffectModel
from photon_ml_tpu.game.model import GameModel as JaxGameModel
from photon_ml_tpu.game.model import RandomEffectModel as JaxRandomEffectModel
from photon_ml_tpu.parallel.mesh import make_mesh
from photon_ml_tpu.serving import ScoreRequest as JaxScoreRequest
from photon_ml_tpu.serving import ServingBundle as JaxServingBundle
from photon_ml_tpu.serving import ServingEngine as JaxServingEngine
from photon_ml_tpu.transformers.game_transformer import CoordinateScoringSpec as JaxSpec
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu.utils import telemetry as jax_telemetry
from photon_ml_tpu_torch import convert
from photon_ml_tpu_torch.cli import libsvm_to_avro
from photon_ml_tpu_torch.cli import serve as serve_cli
from photon_ml_tpu_torch.cli import serve_multihost as smh
from photon_ml_tpu_torch.cli import train as train_cli
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.io import avro, score_store
from photon_ml_tpu_torch.serving import ScoreRequest, ServingBundle, ServingEngine
from photon_ml_tpu_torch.types import TaskType
from photon_ml_tpu_torch.utils import faults, telemetry

pytestmark = pytest.mark.serving

REPO = Path(__file__).resolve().parent.parent
TOL = PORT_TOLERANCES["convert_scores"]
SHARD = "name=globalShard,feature.bags=features,intercept=true"
D_FE, D_RE, USERS, ITEMS, N_REQ, S = 10, 4, 21, 10, 96, 8


@pytest.fixture(autouse=True)
def _port_fault_hygiene():
    faults.clear()
    telemetry.METRICS.reset()
    yield
    faults.clear()
    telemetry.METRICS.reset()


# ------------------------------------------------ in one process, against JAX


@pytest.fixture(scope="module")
def two_effects():
    """A numpy model (FE over "g", per-user over "ru", per-item over "ri"),
    in both packages, and N_REQ requests (a few unseen ids of each)."""
    rng = np.random.default_rng(61)
    w = rng.normal(size=D_FE).astype(np.float32)
    mats = {}
    for cid, e in (("per-user", USERS), ("per-item", ITEMS)):
        m = np.zeros((e + 1, D_RE), np.float32)
        m[:e] = rng.normal(size=(e, D_RE))
        mats[cid] = m
    index = {"per-user": {str(i): i for i in range(USERS)}, "per-item": {str(i): i for i in range(ITEMS)}}
    model, specs = convert.game_model_from_numpy({
        "fixed": convert.FixedEffectArrays("g", w),
        "per-user": convert.RandomEffectArrays("ru", "user", mats["per-user"], index["per-user"]),
        "per-item": convert.RandomEffectArrays("ri", "item", mats["per-item"], index["per-item"]),
    }, TaskType.LOGISTIC_REGRESSION, device="cpu")
    jt = JaxTaskType.LOGISTIC_REGRESSION
    jmodel = JaxGameModel({"fixed": JaxFixedEffectModel(JaxCoefficients(jnp.asarray(w)), jt),
                           **{cid: JaxRandomEffectModel(jnp.asarray(m), None, jt) for cid, m in mats.items()}})
    jspecs = {"fixed": JaxSpec(shard="g"),
              "per-user": JaxSpec(shard="ru", random_effect_type="user", entity_index=index["per-user"]),
              "per-item": JaxSpec(shard="ri", random_effect_type="item", entity_index=index["per-item"])}
    X, Xu, Xi = (rng.normal(size=(N_REQ, d)).astype(np.float32) for d in (D_FE, D_RE, D_RE))
    users, items = rng.integers(0, USERS + 2, size=N_REQ), rng.integers(0, ITEMS + 2, size=N_REQ)
    reqs = [dict(features={"g": X[i], "ru": Xu[i], "ri": Xi[i]},
                 entity_ids={"user": str(users[i]), "item": str(items[i])}, offset=0.1 * (i % 5), uid=f"q{i}")
            for i in range(N_REQ)]
    return dict(model=model, specs=specs, jmodel=jmodel, jspecs=jspecs, reqs=reqs)


def _reset(bundle):
    for c in bundle.coordinates.values():
        sh = getattr(c, "shard_health", None)
        for s in range(sh.n_shards if sh is not None else 0):
            sh.mark_ok(s)


@pytest.mark.parametrize("num_hosts", [2, 3])
def test_host_local_stores_match_the_jax_package(two_effects, num_hosts):
    t = two_effects
    port = ServingBundle.from_model(t["model"], t["specs"], TaskType.LOGISTIC_REGRESSION, device="cpu",
                                    row_blocks=S)
    jax_bundle = JaxServingBundle.from_model(t["jmodel"], t["jspecs"], JaxTaskType.LOGISTIC_REGRESSION,
                                             mesh=make_mesh())
    reqs = [ScoreRequest(**r) for r in t["reqs"]]
    jreqs = [JaxScoreRequest(**r) for r in t["reqs"]]
    with ServingEngine(port, max_batch=32) as eng, JaxServingEngine(jax_bundle, max_batch=32) as jeng:
        for host in range(num_hosts):
            _reset(port)
            _reset(jax_bundle)
            owned = smh._mark_host_local(port, host, num_hosts)
            assert owned == jax_smh._mark_host_local(jax_bundle, host, num_hosts)
            for cid in ("per-user", "per-item"):
                ours, theirs = port.coordinates[cid].shard_health, jax_bundle.coordinates[cid].shard_health
                assert (ours.n_shards, ours.rows_per_shard) == (theirs.n_shards, theirs.rows_per_shard)
                assert ours.lost == theirs.lost
                assert [ours.row_range(s) for s in range(S)] == [theirs.row_range(s) for s in range(S)]
                assert port.coordinates[cid].unseen_row == jax_bundle.coordinates[cid].unseen_row
            got, want = eng.score_batch(reqs), jeng.score_batch(jreqs)
            assert [r.n_lost for r in got] == [r.n_lost for r in want]
            assert [r.n_cold for r in got] == [r.n_cold for r in want]
            assert 0 < sum(r.n_lost > 0 for r in got) < N_REQ
            np.testing.assert_allclose([r.score for r in got], [r.score for r in want],
                                       rtol=TOL["rtol"], atol=TOL["atol"])


def test_an_answer_with_no_lost_row_is_one_process_bits(two_effects):
    """A host-local worker's engine against the whole-matrix engine: the
    same bits where no row was lost, and where one was, the bits of the
    request with that effect's id unseen."""
    t = two_effects
    reqs = [ScoreRequest(**r) for r in t["reqs"]]
    port = ServingBundle.from_model(t["model"], t["specs"], TaskType.LOGISTIC_REGRESSION, device="cpu",
                                    row_blocks=S)
    assert port.coordinates["per-user"].params.shape[0] == 24 and port.coordinates["per-user"].unseen_row == USERS
    smh._mark_host_local(port, 1, 2)
    with ServingEngine(port, max_batch=8) as eng:
        got = eng.score_batch(reqs)

    def unseen_where_lost(r):
        ids = dict(r.entity_ids)
        for c in port.coordinates.values():
            if c.is_random_effect:
                rows, _ = c.lookup_rows([ids[c.random_effect_type]])
                if rows[0] != c.unseen_row and c.shard_health.lost_mask(rows)[0]:
                    ids[c.random_effect_type] = "-1"
        return ScoreRequest(features=r.features, entity_ids=ids, offset=r.offset, uid=r.uid)

    whole = ServingBundle.from_model(t["model"], t["specs"], TaskType.LOGISTIC_REGRESSION, device="cpu")
    with ServingEngine(whole, max_batch=16) as eng:
        ref = eng.score_batch([unseen_where_lost(r) for r in reqs])
    assert 0 < sum(g.n_lost == 0 for g in got) < N_REQ
    assert [g.score for g in got] == [r.score for r in ref]
    assert [g.mean for g in got] == [r.mean for r in ref]


def _synthetic_parts():
    """Two hosts' answered windows: host 1 lost its second window (a kill),
    ties broken by n_cold and then by host."""
    def ln(i, score, n_lost, n_cold, uid=None):
        return dict(i=i, uid=uid, score=score, mean=1 / (1 + np.exp(-score)), cold=n_cold > 0, n_cold=n_cold,
                    n_lost=n_lost, fe=False)

    return {0: {0: [ln(0, 0.5, 0, 0, "a"), ln(1, -0.25, 1, 1), ln(2, 1.5, 1, 2, "c")],
                1: [ln(3, 0.75, 1, 1, "d"), ln(4, 2.0, 0, 1)]},
            1: {0: [ln(0, 0.5, 0, 0, "a"), ln(1, -0.125, 0, 0), ln(2, 1.25, 1, 1, "c")]}}


def test_merge_scores_writes_the_jax_packages_records(tmp_path):
    parts = _synthetic_parts()
    ours = smh._merge_scores(str(tmp_path / "port"), parts, "m1")
    theirs = jax_smh._merge_scores(str(tmp_path / "jax"), parts, "m1")
    assert ours == theirs == (5, 2, 2)
    a = avro.read_directory(str(tmp_path / "port" / "scores"))[1]
    b = avro.read_directory(str(tmp_path / "jax" / "scores"))[1]
    assert a == b and [r["uid"] for r in a] == ["a", "1", "c", "d", "4"]
    assert [r["predictionScore"] for r in a] == [0.5, -0.125, 1.25, 0.75, 2.0]


# ---------------------------------------------------------------- end to end


@pytest.fixture(scope="module")
def one_effect(tmp_path_factory):
    """examples/run_glmix.sh's data at a small size, a GLMix model (one
    random effect) from the port's cli.train, and one process's cli.serve
    of the test file."""
    root = tmp_path_factory.mktemp("serve_mh")
    data = root / "data"
    subprocess.run([sys.executable, str(REPO / "examples" / "generate_dataset.py"), str(data),
                    "--train", "1200", "--test", "400", "--entities", "12"],
                   check=True, capture_output=True, timeout=120)
    for split in ("train", "test"):
        assert libsvm_to_avro.main(["--tag-comments", str(data / f"{split}.libsvm"),
                                    str(data / f"{split}.avro")]) == 0
    train_cli.main(["--training-task", "LOGISTIC_REGRESSION", "--input-data-directories", str(data / "train.avro"),
                    "--root-output-directory", str(root / "fit"), "--feature-shard-configurations", SHARD,
                    "--coordinate-configurations",
                    "name=global,feature.shard=globalShard,optimizer=LBFGS,tolerance=1.0E-7,max.iter=50,"
                    "regularization=L2,reg.weights=1",
                    "name=per-member,random.effect.type=memberId,feature.shard=globalShard,optimizer=LBFGS,"
                    "max.iter=30,regularization=L2,reg.weights=10,min.bucket=8",
                    "--coordinate-descent-iterations", "2", "--output-mode", "BEST", "--device", "cpu",
                    "--logging-level", "WARNING"])
    model = root / "fit" / "models" / "best"
    serve_cli.main(_serve_args(model, data / "test.avro", root / "one"))
    return dict(root=root, data=data, model=model, ref=_by_uid(root / "one"))


def _serve_args(model, requests, out, *extra):
    return ["--model-input-directory", str(model), "--requests", str(requests), "--root-output-directory",
            str(out), "--feature-shard-configurations", SHARD, "--max-batch", "16", "--max-wait-ms", "1",
            "--device", "cpu", "--model-id", "m1", "--logging-level", "WARNING", *extra]


def _by_uid(out) -> dict:
    cols = score_store.load_score_columns(str(Path(out) / "scores"))
    return dict(zip(cols.uids, cols.scores.tolist()))


def _journal(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def _errs(out) -> str:
    tails = []
    for d in sorted((Path(out) / "hosts").glob("*")):
        err = d / "worker.err"
        if err.exists():
            tails.append(f"--- {d.name}\n" + "\n".join(err.read_text().splitlines()[-15:]))
    return "\n".join(tails)


def _drill(one_effect, out, retries: int):
    """`--multihost 2` with worker 1 SIGKILLed once its pid file appears
    (the load phase, as the reference's anchor kills it)."""
    env_before = os.environ.get("PHOTON_HOST_LOSS_RETRIES")
    os.environ["PHOTON_HOST_LOSS_RETRIES"] = str(retries)
    done, errors = [], []

    def supervise():
        try:
            done.append(serve_cli.main(_serve_args(one_effect["model"], one_effect["data"] / "test.avro", out,
                                                   "--multihost", "2")))
        except BaseException as exc:  # re-raised below
            errors.append(exc)

    sup = threading.Thread(target=supervise)
    try:
        sup.start()
        pid_file = Path(out) / "hosts" / "attempt0-host1" / "pid"
        deadline = time.monotonic() + 120
        while not pid_file.exists() or not pid_file.read_text():
            assert sup.is_alive() and time.monotonic() < deadline, f"{errors}\n{_errs(out)}"
            time.sleep(0.01)
        os.kill(int(pid_file.read_text()), signal.SIGKILL)
        sup.join(timeout=300)
    finally:
        if env_before is None:
            del os.environ["PHOTON_HOST_LOSS_RETRIES"]
        else:
            os.environ["PHOTON_HOST_LOSS_RETRIES"] = env_before
    assert not errors and done, f"{errors}\n{_errs(out)}"
    return done[0]


def test_two_hosts_answer_as_one_process_does(one_effect, tmp_path):
    out = tmp_path / "mh"
    summary = serve_cli.main(_serve_args(one_effect["model"], one_effect["data"] / "test.avro", out,
                                         "--multihost", "2"))
    assert summary["failed_requests"] == 0 and summary["num_requests"] == 400, _errs(out)
    mh = summary["multihost"]
    assert (mh["num_hosts"], mh["devices_per_host"], mh["host_losses"], mh["rejoins"]) == (2, 4, 0, 0)
    assert mh["survivor_hosts"] == 2 and mh["fe_only_answers"] == 0 and mh["attempts"] == {"0": 1, "1": 1}
    assert sum(mh["owned_rows"].values()) == 16  # 13 rows in 4 blocks of 4
    assert _by_uid(out) == one_effect["ref"]  # bit for bit
    for path in [out / "journal.jsonl", *sorted(out.glob("hosts/*/journal.jsonl"))]:
        assert jax_telemetry.validate_journal(str(path))[1] == []


def test_a_killed_host_costs_fidelity_not_requests(one_effect, tmp_path):
    out = tmp_path / "mh"
    summary = _drill(one_effect, out, retries=0)
    mh = summary["multihost"]
    assert summary["failed_requests"] == 0 and summary["num_requests"] == 400
    assert mh["host_losses"] == 1 and mh["survivor_hosts"] == 1 and mh["fe_only_answers"] > 0, mh
    assert summary["robustness_counters"]["host_losses"] == 1
    losses = [e for e in _journal(out / "journal.jsonl") if e["type"] == "host_loss"]
    assert len(losses) == 1 and losses[0]["source"] == "serve-supervisor" and losses[0]["host"] == 1
    got, ref = _by_uid(out), one_effect["ref"]
    assert set(got) == set(ref)
    differing = [u for u in ref if got[u] != ref[u]]
    assert 0 < len(differing) <= mh["fe_only_answers"]


def test_a_rejoined_host_restages_and_answers_as_before(one_effect, tmp_path):
    out = tmp_path / "mh"
    summary = _drill(one_effect, out, retries=1)
    mh = summary["multihost"]
    assert summary["failed_requests"] == 0 and mh["host_losses"] == 1 and mh["rejoins"] == 1
    assert mh["attempts"] == {"0": 1, "1": 2} and mh["survivor_hosts"] == 2 and mh["fe_only_answers"] == 0
    joins = [e for e in _journal(out / "hosts" / "attempt1-host1" / "journal.jsonl") if e["type"] == "host_join"]
    assert len(joins) == 1 and joins[0]["host"] == 1 and joins[0]["restaged_rows"] == 8
    assert _by_uid(out) == one_effect["ref"]


def test_a_relaunch_resumes_at_its_last_durable_window(one_effect, tmp_path, monkeypatch):
    """Worker 1 in process with windows of 64 requests: attempt 0 answers
    every window; a kill after window 2 is left behind as parts 0-1 and a
    progress marker of 2; attempt 1 resumes there, restages through
    host_join, and the merge is the uninterrupted one."""
    monkeypatch.setattr(serve_cli, "REPLAY_WINDOW", 64)
    out = tmp_path / "mh"
    base = _serve_args(one_effect["model"], one_effect["data"] / "test.avro", out)

    def worker(host, attempt, resume):
        args = serve_cli.build_parser().parse_args(base + [
            "--mh-serve-worker", "--mh-host-id", str(host), "--mh-num-hosts", "2",
            "--mh-attempt", str(attempt), "--mh-resume-window", str(resume)])
        assert smh.run_worker(args) == 0

    worker(0, 0, 0)
    worker(1, 0, 0)
    full = {k: smh._collect_parts(str(out), k, 0) for k in (0, 1)}
    assert len(full[1]) == 7  # 400 requests in windows of 64
    a0 = Path(smh._host_dir(str(out), 0, 1))
    for k in range(2, 7):
        (a0 / "results" / f"part-{k:05d}.jsonl").unlink()
    (a0 / "progress").write_text(json.dumps({"next_window": 2}))
    (a0 / "worker-summary.json").unlink()
    assert smh._read_progress(str(out), 1, 1) == 2
    worker(1, 1, smh._read_progress(str(out), 1, 1))
    a1 = Path(smh._host_dir(str(out), 1, 1))
    assert sorted(p.name for p in (a1 / "results").iterdir()) == [f"part-{k:05d}.jsonl" for k in range(2, 7)]
    assert [e["type"] for e in _journal(a1 / "journal.jsonl")].count("host_join") == 1
    resumed = {0: full[0], 1: smh._collect_parts(str(out), 1, 1)}
    assert resumed == full
    assert smh._merge_scores(str(tmp_path / "merged"), resumed, "m1")[0] == 400
    assert _by_uid(tmp_path / "merged") == one_effect["ref"]


def test_a_corrupt_request_block_is_quarantined_by_each_worker(one_effect, tmp_path):
    """A request file with one corrupt middle block: the merged summary
    counts it in `quarantined_blocks` (a worker's count: the supervisor
    reads no request), and the other blocks' answers are one process's
    cli.serve bit for bit. Each worker records its kernels' launches,
    none on the CPU, in its progress marker and its summary."""
    requests = tmp_path / "test.avro"
    schema, records = avro.read_container(str(one_effect["data"] / "test.avro"))
    avro.write_container(str(requests), schema, records, block_records=64)
    data = bytearray(requests.read_bytes())
    _, _, _, pos = avro.read_header(bytes(data), str(requests))
    dec, blocks = avro.BinaryDecoder(data, pos), []
    while dec.remaining > 0:
        dec.read_long()
        size = dec.read_long()
        blocks.append(dec.pos + size)
        dec.pos += size + avro.SYNC_SIZE
    assert len(blocks) >= 3, len(blocks)
    end = blocks[len(blocks) // 2]
    data[end - 40:end] = b"\xff" * 40  # the block's last records run off its end
    requests.write_bytes(bytes(data))

    out = tmp_path / "mh"
    summary = serve_cli.main(_serve_args(one_effect["model"], requests, out, "--multihost", "2"))
    assert summary["robustness_counters"]["quarantined_blocks"] == 1, _errs(out)
    assert faults.COUNTERS.get("quarantined_blocks") == 0  # the supervisor's own
    single = serve_cli.main(_serve_args(one_effect["model"], requests, tmp_path / "one"))
    assert single["robustness_counters"]["quarantined_blocks"] == 1
    assert summary["failed_requests"] == 0 and summary["num_requests"] == single["num_requests"] < 400
    assert _by_uid(out) == _by_uid(tmp_path / "one")
    for host in (0, 1):
        host_dir = Path(smh._host_dir(str(out), 0, host))
        progress = json.loads((host_dir / "progress").read_text())
        worker = json.loads((host_dir / "worker-summary.json").read_text())
        assert worker["counters"]["quarantined_blocks"] == 1
        for launches in (progress["launches"], worker["launches"]):
            assert set(launches) == set(smh.kernel_launches()) and not any(launches.values())
