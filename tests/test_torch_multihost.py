"""Multi-host training in the port: `cli.train --multihost N` (cli/
train_multihost.py) and its host layer (parallel/hostmesh.py), on the CPU.

One corpus of five Avro part files of unequal sizes and a PHIDX index
store built from them serve every test. The drivers run as a user runs
them: the supervisor in this process, each worker a `python -m
photon_ml_tpu_torch.cli.train --mh-worker` process on the CPU over gloo.
The 2-rank fit is held against the JAX package's one-process `cli.train`
on the same files and store, the 1-rank fit against the port's own, and a
drill that SIGKILLs a worker after the first commit against the
uninterrupted 2-rank fit. The host layer's pieces are held against the JAX
package's where it has them; `exchange_ingest` runs its ranks as threads
here (it reaches the other ranks through the filesystem alone).
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import threading
import time

import numpy as np
import pytest

from photon_ml_tpu_torch.cli import build_index
from photon_ml_tpu_torch.cli import train as train_cli
from photon_ml_tpu_torch.cli import train_multihost
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.data.containers import SparseFeatures
from photon_ml_tpu_torch.data.index_map import IndexMap
from photon_ml_tpu_torch.io import model_store
from photon_ml_tpu_torch.io.avro_data import FeatureShardConfig, read_game_dataset
from photon_ml_tpu_torch.io.paldb import resolve_offheap_index_maps
from photon_ml_tpu_torch.native.avro_writer import write_training_examples_columnar
from photon_ml_tpu_torch.parallel import hostmesh
from photon_ml_tpu_torch.utils import telemetry
from photon_ml_tpu_torch.utils.faults import HostLoss

GLMIX = PORT_TOLERANCES["glmix"]
SHARD = "name=g,feature.bags=features,intercept=true"
SHARD_CONFIGS = {"g": FeatureShardConfig(("features",), True)}
FILE_ROWS = (700, 500, 900, 600, 800)
D, K = 30, 6
RE = ("optimizer=LBFGS,tolerance=1.0E-4,max.iter=20,regularization=L2,reg.weights=10,"
      "projector=IDENTITY,min.bucket=16")
COORDINATES = [
    "name=global,feature.shard=g,optimizer=LBFGS,tolerance=1.0E-6,max.iter=40,regularization=L2,"
    "reg.weights=1",
    f"name=per-user,random.effect.type=userId,feature.shard=g,{RE},active.data.upper.bound=96",
    f"name=per-item,random.effect.type=itemId,feature.shard=g,{RE}",
]
TAGS = ["userId", "itemId"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Five part files (integer userId and itemId tags, 6 of 30 ids a row)
    and the PHIDX store of their features."""
    root = tmp_path_factory.mktemp("mh_corpus")
    data = root / "data"
    data.mkdir()
    rng0 = np.random.default_rng(99)
    w, user_eff, item_eff = rng0.normal(size=D) * 0.3, rng0.normal(size=40), rng0.normal(size=8)
    for fi, n in enumerate(FILE_ROWS):
        rng = np.random.default_rng(fi)
        users, items = rng.integers(0, 40, size=n), rng.integers(0, 8, size=n)
        ids = rng.integers(0, D, size=n * K).astype(np.int32)
        vals = rng.normal(size=n * K)
        margin = (vals * w[ids]).reshape(n, K).sum(1) + 0.7 * user_eff[users] + 0.7 * item_eff[items]
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(np.float64)
        write_training_examples_columnar(str(data / f"part-{fi}.avro"), y,
                                         np.arange(n + 1, dtype=np.int64) * K, ids, vals,
                                         [f"f{i}" for i in range(D)],
                                         int_tags={"userId": users, "itemId": items})
    index = root / "index"
    build_index.main(["--input-data-directories", str(data), "--feature-shard-configurations", SHARD,
                      "--num-partitions", "2", "--output-dir", str(index)])
    return {"data": str(data), "index": str(index),
            "files": sorted(str(data / f) for f in os.listdir(data))}


def train_args(corpus, out, *extra):
    return ["--training-task", "LOGISTIC_REGRESSION", "--input-data-directories", corpus["data"],
            "--root-output-directory", str(out), "--feature-shard-configurations", SHARD,
            "--coordinate-configurations", *COORDINATES, "--coordinate-descent-iterations", "3",
            "--offheap-indexmap-dir", corpus["index"], "--logging-level", "WARNING", *extra]


def multihost(corpus, out, n, *extra):
    return train_cli.main(train_args(corpus, out, "--multihost", str(n), "--device", "cpu",
                                     "--checkpoint-directory", str(out / "ckpt"), *extra))


def load_model(out, like):
    imaps = {"g": IndexMap.load(str(like / "models" / "best" / "feature-indexes" / "g.json"))}
    return model_store.load_game_model(str(out / "models" / "best"), imaps)


def coefficients(model):
    """{cid: {key: means}}: the fixed effect under None, random effects by entity id."""
    out = {}
    for cid, c in model.coordinates.items():
        ids = getattr(c, "entity_ids", None)
        means = np.asarray(c.means)
        out[cid] = {None: means} if ids is None else dict(zip(map(str, ids), means))
    return out


def max_gap(a, b):
    ca, cb = coefficients(a), coefficients(b)
    assert {c: sorted(map(str, v)) for c, v in ca.items()} == {c: sorted(map(str, v)) for c, v in cb.items()}
    return max(float(np.abs(ca[c][k] - cb[c][k]).max()) for c in ca for k in ca[c])


@pytest.fixture(scope="module")
def two_ranks(corpus, tmp_path_factory):
    out = tmp_path_factory.mktemp("mh2")
    return out, multihost(corpus, out, 2)


# ------------------------------------------------------------------ the driver


def test_two_ranks_agree_with_the_jax_one_process_driver(corpus, two_ranks, tmp_path):
    from photon_ml_tpu.cli import train as jax_train_cli

    out, summary = two_ranks
    assert summary["num_samples"] == sum(FILE_ROWS)
    assert summary["multihost"] == {"num_hosts": 2, "devices_per_host": 1, "attempts": 1,
                                    "host_losses": 0, "repeated_sweeps": 0, "final_hosts": 2,
                                    "attempt_log": summary["multihost"]["attempt_log"]}
    ranks = summary["ranks"]
    assert [(r["rank"], r["device"], r["backend"]) for r in ranks] == [(0, "cpu", "gloo"), (1, "cpu", "gloo")]
    assert sorted(f for r in ranks for f in r["files"]) == [os.path.basename(f) for f in corpus["files"]]
    assert sum(r["rows"] for r in ranks) == sum(FILE_ROWS)
    assert all(len(r["checkpoint_saves"]) == 9 for r in ranks)
    jax_train_cli.main(train_args(corpus, tmp_path / "jax"))
    assert max_gap(load_model(out, out), load_model(tmp_path / "jax", out)) <= GLMIX["coef_atol"]
    n, errors = telemetry.validate_journal(str(out / "hosts" / "attempt0-host0" / "journal.jsonl"))
    assert not errors and n > 0


def test_one_rank_is_bit_identical_to_the_one_process_driver(corpus, tmp_path):
    multihost(corpus, tmp_path / "mh1", 1)
    train_cli.main(train_args(corpus, tmp_path / "one", "--device", "cpu"))
    one, mh1 = load_model(tmp_path / "one", tmp_path / "one"), load_model(tmp_path / "mh1", tmp_path / "one")
    ca, cb = coefficients(one), coefficients(mh1)
    assert ca.keys() == cb.keys()
    for cid in ca:
        assert ca[cid].keys() == cb[cid].keys()
        assert all(np.array_equal(ca[cid][k], cb[cid][k]) for k in ca[cid]), cid


def test_a_killed_worker_costs_one_relaunch_and_one_sweep(corpus, two_ranks, tmp_path):
    """SIGKILL worker 1 once the first step is committed: the supervisor
    relaunches the survivor, which resumes from the 2-rank checkpoint."""
    out = tmp_path / "drill"
    done = []
    sup = threading.Thread(target=lambda: done.append(multihost(corpus, out, 2)))
    sup.start()
    state, pid = out / "ckpt" / "state.json", out / "hosts" / "attempt0-host1" / "pid"
    deadline = time.monotonic() + 120
    while not state.exists() and sup.is_alive() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert state.exists(), "no checkpoint commit"
    assert json.loads(state.read_text())["completed_steps"] < 9
    os.kill(int(pid.read_text()), signal.SIGKILL)
    sup.join(300)
    assert done, "the supervisor did not finish"
    mh = done[0]["multihost"]
    assert (mh["attempts"], mh["host_losses"], mh["repeated_sweeps"], mh["final_hosts"]) == (2, 1, 1, 1)
    events = [json.loads(line) for line in (out / "journal.jsonl").read_text().splitlines()]
    assert [(e["type"], e["host"], e["source"]) for e in events] == [("host_loss", 1, "supervisor")]
    assert max_gap(load_model(out, two_ranks[0]), load_model(two_ranks[0], two_ranks[0])) \
        <= GLMIX["coef_atol"]


def _jax_scope_error(argv):
    from photon_ml_tpu.cli import train as jax_train_cli
    from photon_ml_tpu.cli import train_multihost as jax_multihost

    with pytest.raises(ValueError) as err:
        jax_multihost._validate_scope(jax_train_cli.build_parser().parse_args(argv))
    return str(err.value)


# The reference's refusals, one each: options added (or, with None, left
# out), or a setting of the per-user coordinate changed (old, new).
SCOPE = [
    (["--checkpoint-directory", None], "--checkpoint-directory is required"),
    (["--offheap-indexmap-dir", None], "--offheap-indexmap-dir is required"),
    (["--validation-data-directories", "v.avro"], "validation data is single-host only"),
    (["--validation-evaluators", "AUC"], "validation evaluators are single-host only"),
    (["--hyper-parameter-tuning", "RANDOM"], "hyperparameter tuning is single-host only"),
    (["--variance-computation-type", "SIMPLE"], "coefficient variances are single-host only"),
    (["--normalization", "STANDARDIZATION"], "normalization is single-host only"),
    (["--model-input-directory", "m"], "warm start is single-host only"),
    (["--partial-retrain-locked-coordinates", "global"], "partial retrain is single-host only"),
    (("min.bucket=16", "min.bucket=16,constraints.file=c.json"), "constraints are single-host only"),
    (("reg.weights=10", "reg.weights=1|10"), "reg-weight sweeps are single-host only"),
    (("projector=IDENTITY", "projector=INDEX_MAP"), "only projector=IDENTITY is supported multi-host"),
]


@pytest.mark.parametrize("option,message", SCOPE, ids=[m.split(" ")[0] for _, m in SCOPE])
def test_each_scope_refusal_raises_the_reference_message(corpus, tmp_path, option, message):
    argv = train_args(corpus, tmp_path / "out", "--checkpoint-directory", str(tmp_path / "ckpt"))
    if isinstance(option, tuple):
        at = argv.index("--coordinate-configurations") + 2
        argv[at] = argv[at].replace(*option)
    elif option[1] is None:
        at = argv.index(option[0])
        del argv[at:at + 2]
    else:
        argv += option
    jax_message = _jax_scope_error(argv)
    assert message in jax_message
    with pytest.raises(ValueError) as err:
        train_cli.main(argv + ["--multihost", "2", "--device", "cpu"])
    assert str(err.value) == jax_message
    assert not (tmp_path / "out").exists()


def test_a_rank_has_one_device(corpus, tmp_path):
    with pytest.raises(ValueError, match="a rank of the PyTorch port drives one device"):
        multihost(corpus, tmp_path / "out", 2, "--multihost-devices-per-host", "4")


# ------------------------------------------------------------------ host layer


def test_partition_files_is_the_reference_split(corpus):
    from photon_ml_tpu.parallel import hostmesh as jax_hostmesh

    for n in (1, 2, 3, 4, 5):
        assert hostmesh.partition_files(corpus["files"], n) == jax_hostmesh.partition_files(corpus["files"], n)


def _ingest_on_threads(corpus, files, root, world):
    """exchange_ingest of `files` on `world` ranks, each a thread of this process."""
    imaps = resolve_offheap_index_maps(corpus["index"], SHARD_CONFIGS)
    outs, errors = [None] * world, []

    def rank(r):
        try:
            hm = hostmesh.HostMesh(None, r, world, str(root))
            outs[r] = hostmesh.exchange_ingest(hm, list(reversed(files)), SHARD_CONFIGS,
                                               index_maps=imaps, id_tag_fields=TAGS, timeout_s=60)
        except BaseException as exc:  # re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return outs, imaps


@pytest.mark.parametrize("world,daily", [(2, False), (3, False), (2, True)])
def test_exchange_ingest_is_one_read_of_the_sorted_files(corpus, tmp_path, world, daily):
    files = corpus["files"]
    if daily:  # two daily directories whose part files share their names
        copies = []
        for i, f in enumerate(files):
            day = tmp_path / "days" / f"0{1 + i % 2}"
            day.mkdir(parents=True, exist_ok=True)
            copies.append(str(day / f"part-{i // 2}.avro"))
            shutil.copy(f, copies[-1])
        files = sorted(copies)
    outs, imaps = _ingest_on_threads(corpus, files, tmp_path / "rdv", world)
    one, _ = read_game_dataset(files, SHARD_CONFIGS, index_maps=imaps, id_tag_fields=TAGS, device="cpu")
    mine = [o[1] for o in outs]
    assert sorted(f for m in mine for f in m) == files
    assert mine == hostmesh.partition_files(files, world)
    for ds, _, times in outs:
        a, b = ds.shards["g"], one.shards["g"]
        assert isinstance(a, SparseFeatures) and a.dim == b.dim
        assert a.indices.dtype == b.indices.dtype and np.array_equal(a.indices.numpy(), b.indices.numpy())
        assert np.array_equal(a.values.numpy(), b.values.numpy())
        for col in ("labels", "offsets", "weights"):
            assert np.array_equal(getattr(ds, col).numpy(), getattr(one, col).numpy())
        for tag in TAGS:
            (ca, ta), (cb, tb) = ds.tag_codes[tag], one.tag_codes[tag]
            assert ta.dtype == tb.dtype and np.array_equal(ta, tb) and np.array_equal(ca, cb)
            assert np.array_equal(ds.id_tags[tag], one.id_tags[tag])
        assert set(times) == {"decode_s", "publish_s", "barrier_s", "read_s", "concat_s"}


def test_a_barrier_names_the_rank_that_never_arrived(tmp_path):
    d = tmp_path / "barriers" / "fit-complete"
    d.mkdir(parents=True)
    (d / "host1.ok").write_text("1")
    with pytest.raises(HostLoss, match=r"'fit-complete': hosts \[2\] never arrived"):
        hostmesh.fs_barrier(hostmesh.HostMesh(None, 0, 3, str(tmp_path)), "fit-complete", timeout_s=0.2)


def test_the_heartbeat_declares_a_stalled_peer_lost(tmp_path):
    telemetry.METRICS.reset()
    losses = []
    journal = telemetry.install_journal(telemetry.RunJournal(str(tmp_path / "journal.jsonl")))
    try:
        beat = hostmesh.HostHeartbeat(hostmesh.HostMesh(None, 0, 2, str(tmp_path)), losses.append,
                                      period_ms=5, miss_threshold=3).start()
        deadline = time.monotonic() + 10
        while not losses and time.monotonic() < deadline:
            time.sleep(0.01)
        beat.stop()
    finally:
        telemetry.uninstall_journal()
        journal.close()
    assert len(losses) == 1 and isinstance(losses[0], HostLoss) and "host 1 lost" in str(losses[0])
    assert telemetry.METRICS.get_counter("host_losses") == 1
    assert telemetry.METRICS.get_counter("host_heartbeat_misses") == 3
    events = [json.loads(line) for line in (tmp_path / "journal.jsonl").read_text().splitlines()]
    assert events[-1]["type"] == "host_loss" and events[-1]["host"] == 1
    assert events[-1]["source"] == "heartbeat" and events[-1]["missed_beats"] == 3


def test_exit_codes_are_classified_as_the_reference_does():
    from photon_ml_tpu.parallel import hostmesh as jax_hostmesh

    codes = (0, 1, 2, 75, hostmesh.EXIT_HOST_LOSS, 77, 124, 137, -9, -15)
    assert [hostmesh.classify_exit(c) for c in codes] == [jax_hostmesh.classify_exit(c) for c in codes]
    assert hostmesh.EXIT_HOST_LOSS == jax_hostmesh.EXIT_HOST_LOSS
    assert hostmesh.MISS_THRESHOLD == jax_hostmesh.MISS_THRESHOLD


def test_worker_devices_and_backends_are_explicit(monkeypatch):
    import torch

    assert train_multihost.worker_device("cpu", 4, 2) == ("cpu", "gloo")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert train_multihost.worker_device("cuda", 4, 2) == ("cuda:2", "nccl")
    assert train_multihost.worker_device("cuda:0", 4, 2) == ("cuda:0", "gloo")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert train_multihost.worker_device("cuda", 4, 2) == ("cuda:0", "gloo")


def test_a_rank_loss_outranks_the_failures_it_causes(tmp_path):
    """Worker 1 is killed and worker 0 then fails (as a collective with a
    dead peer fails): the supervisor relaunches the survivor, whatever
    order it finds the two exits in."""
    import sys

    gone = tmp_path / "gone"

    def build_argv(attempt, coordinator, hosts, host_id):
        if attempt == 1:
            code = "pass"
        elif host_id == 1:
            code = f"import os, signal; open({str(gone)!r}, 'w').close(); os.kill(os.getpid(), signal.SIGKILL)"
        else:
            code = f"import os\nwhile not os.path.exists({str(gone)!r}): pass\nos._exit(1)"
        return [sys.executable, "-c", code]

    res = hostmesh.supervise(build_argv, num_hosts=2, rendezvous=str(tmp_path / "rdv"),
                             attempt_timeout_s=60)
    assert (res.attempts, res.host_losses, res.final_hosts) == (2, 1, 1)
    assert [(a["verdict"], a["host"], a["returncode"]) for a in res.attempt_log] == [
        ("host_loss", 1, -9), ("ok", -1, 0)]
