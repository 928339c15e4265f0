"""Sweep shard groups of several cards, on the CPU.

A shard group of several cards (here CPU ordinals: `parallel.mesh.
local_cards("cpu")` gives CPU_CARDS = 8, as the reference's tests have 8
host devices) replicates the sample data onto its cards and row-shards each
random effect's coefficient and variance store over them. Held here:

  * `ring_gather_rows` / `ring_scatter_rows` over CPU card meshes: bit for
    bit dense indexing, and the JAX package's ring collectives on its
    8-device CPU mesh (the counterparts of JAX tests/test_parallel.py:
    90-157), with the reference's wire-byte formulas;
  * `shard_random_effect_dataset`'s padded buckets against the JAX
    function's, slice by slice;
  * a random-effect coordinate over 2, 4 and 8 cards (down to one-lane
    slices): train and score bit-equal to the one-device coordinate, with
    SIMPLE variances and a warm start, and `sharding_info()` equal to the
    JAX coordinate's on the same layout;
  * the executor with shard groups of several cards: values and models
    (coefficients and variances) bit-equal to the serial executor, cold and
    warm, within PORT_TOLERANCES["glmix"] of the JAX serial executor, and
    the `collective` site retried with the same bits (a failure past the
    retries raises `MeshLoss`);
  * `cli.tune --sweep-mode shard_group --shard-groups 2 --device cpu`:
    `models/tuned-best` bit-equal to `--sweep-mode serial`'s.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.data import game_dataset as jax_gd
from photon_ml_tpu.game.coordinate import RandomEffectCoordinate as JaxRandomEffectCoordinate
from photon_ml_tpu.optimize import config as jax_config
from photon_ml_tpu.parallel import mesh as jax_mesh
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu_torch.cli import libsvm_to_avro
from photon_ml_tpu_torch.cli import tune as tune_cli
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.data.game_dataset import RandomEffectDataConfig, build_random_effect_dataset
from photon_ml_tpu_torch.game.coordinate import RandomEffectCoordinate
from photon_ml_tpu_torch.game.model import RandomEffectModel
from photon_ml_tpu_torch.optimize.config import L2, CoordinateOptimizationConfig, OptimizerConfig
from photon_ml_tpu_torch.parallel import mesh as pmesh
from photon_ml_tpu_torch.parallel.mesh import (
    RowShardedMatrix,
    ShardedEntityBlocks,
    make_mesh,
    put_row_sharded,
    ring_gather_rows,
    ring_scatter_rows,
    card_offsets,
    lanes_in_place,
    shard_random_effect_dataset,
)
from photon_ml_tpu_torch.types import TaskType, VarianceComputationType
from photon_ml_tpu_torch.utils import faults, telemetry

from tests.test_torch_sweep import (
    _POINTS,
    _POINTS2,
    _arrays,
    _assert_models_equal,
    _close_models,
    _executor,
    _jax_data,
    _jax_executor,
    _port_data,
)
from tests.test_torch_tune_cli import _load, _tune_args

TOL = PORT_TOLERANCES["glmix"]
REPO = Path(__file__).resolve().parent.parent
TASK = TaskType.LOGISTIC_REGRESSION
SIMPLE = VarianceComputationType.SIMPLE
RE_CFG = ("entityId", "per_entity")


@pytest.fixture(autouse=True)
def _port_fault_hygiene(monkeypatch):
    monkeypatch.setenv("PHOTON_RETRY_BASE_DELAY_S", "0.001")
    faults.clear()
    telemetry.METRICS.reset()
    yield
    faults.clear()
    telemetry.METRICS.reset()


def _cpu_mesh(n):
    return make_mesh(["cpu"] * n)


def _split(rows: np.ndarray, n: int):
    """`rows` cut into n contiguous slices, as a batch-sharded array is."""
    per = len(rows) // n
    return [torch.from_numpy(rows[k * per:(k + 1) * per]) for k in range(n)]


# ------------------------------------------------------------------ primitives


def test_ring_gather_is_dense_indexing_and_the_jax_ring():
    rng = np.random.default_rng(0)
    ndev = len(jax.devices())
    R, D, S = 4 * ndev, 6, 5 * ndev
    M = rng.normal(size=(R, D)).astype(np.float32)
    M[3, 2] = -0.0
    rows = rng.integers(0, R, size=S).astype(np.int64)
    rows[0] = 3
    jmesh = jax_mesh.make_mesh()
    want = np.array(jax_mesh.ring_gather_rows(
        jax.device_put(jnp.asarray(M), jax_mesh.matrix_row_sharding(jmesh)),
        jax.device_put(jnp.asarray(rows.astype(np.int32)), jax_mesh.batch_sharding(jmesh, 1)), jmesh))
    got = ring_gather_rows(put_row_sharded(M, _cpu_mesh(ndev)), _split(rows, ndev))
    got = torch.cat(got).numpy()
    assert got.tobytes() == M[rows].tobytes()
    # The reference's ring adds the row onto zeros, so -0.0 reads +0.0 there;
    # the port selects, so the sign is kept.
    assert np.signbit(got[0, 2]) and not np.signbit(want[0, 2])
    want[0, 2] = -0.0
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_ring_scatter_is_dense_assignment_and_the_jax_ring(shards):
    rng = np.random.default_rng(1)
    R, D, S = 4 * shards + 3, 5, 2 * shards
    M = rng.normal(size=(R, D)).astype(np.float32)
    rows = rng.choice(R, size=S, replace=False).astype(np.int64)
    vals = rng.normal(size=(S, D)).astype(np.float32)
    # Two padding lanes write the pinned row, with equal values.
    rows[-2:] = R - 1
    vals[-2:] = vals[-1]
    matrix = put_row_sharded(M, _cpu_mesh(shards))
    out = ring_scatter_rows(matrix, _split(rows, shards), _split(vals, shards))
    want = M.copy()
    want[rows] = vals
    assert out is matrix and out.host()[:R].tobytes() == want.tobytes()
    assert not out.host()[R:].any()
    if shards == len(jax.devices()):
        jmesh = jax_mesh.make_mesh()
        Mp = np.pad(M, ((0, matrix.shape[0] - R), (0, 0)))
        ref = np.asarray(jax_mesh.ring_scatter_rows(
            jax.device_put(jnp.asarray(Mp), jax_mesh.matrix_row_sharding(jmesh)),
            jax.device_put(jnp.asarray(rows.astype(np.int32)), jax_mesh.batch_sharding(jmesh, 1)),
            jax.device_put(jnp.asarray(vals), jax_mesh.batch_sharding(jmesh, 2)), jmesh))
        assert out.host().tobytes() == ref.tobytes()


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_wire_bytes_are_the_references(shards):
    jm, pm = jax_mesh.make_mesh(jax.devices()[:shards]), _cpu_mesh(shards)
    for n, d in ((40, 8), (1024, 201)):
        assert pmesh.ring_gather_wire_bytes(pm, n, d) == jax_mesh.ring_gather_wire_bytes(jm, n, d)
        assert pmesh.ring_scatter_wire_bytes(pm, n, d) == jax_mesh.ring_scatter_wire_bytes(jm, n, d)


# ------------------------------------------------------------- the bucket layout


def _port_red(n, e, seed=1):
    ds = _port_data(n, e, seed)
    return ds, build_random_effect_dataset(ds, RandomEffectDataConfig(*RE_CFG, min_bucket=4))


def _jax_red(n, e, seed=1):
    Xf, Xe, entity, y = _arrays(n, e, seed=seed)
    ds = jax_gd.GameDataset.build({"global": jnp.asarray(Xf), "per_entity": jnp.asarray(Xe)}, y,
                                  id_tags={"entityId": entity})
    return ds, jax_gd.build_random_effect_dataset(ds, jax_gd.RandomEffectDataConfig(*RE_CFG, min_bucket=4))


@pytest.mark.parametrize("shards", [4, 8])
def test_padded_buckets_are_the_references(shards):
    ds, red = _port_red(200, 13)
    _, jred = _jax_red(200, 13)
    mesh = _cpu_mesh(shards)
    sred = shard_random_effect_dataset(red, mesh, ds)
    jsred = jax_mesh.shard_random_effect_dataset(jred, jax_mesh.make_mesh(jax.devices()[:shards]),
                                                 replicate_sample_rows=True)
    assert sred.card_mesh is mesh and list(sred.card_replicas) == [torch.device("cpu")]
    assert sred.card_replicas[torch.device("cpu")].dataset is ds
    for b, jb, orig in zip(sred.buckets, jsred.buckets, red.buckets):
        assert isinstance(b, ShardedEntityBlocks) and len(b.slices) == shards
        assert b.real_entities == orig.num_entities and b.num_entities == jb.num_entities
        assert len({s.num_entities for s in b.slices}) == 1
        for name in ("gather", "mask", "entity_rows"):
            got = torch.cat([getattr(s, name) for s in b.slices]).numpy()
            np.testing.assert_array_equal(got, np.asarray(getattr(jb, name)))
        # Each shard's in-place block: the bucket's shape, its slice's real lanes live.
        per = b.slices[0].num_entities
        assert [lanes[0] for lanes in b.lanes] == [k * per for k in range(shards)]
        assert sum(lanes[1] for lanes in b.lanes) == orig.num_entities
        for (first, count), p in zip(b.lanes, b.placed):
            assert p.gather.shape == orig.gather.shape
            live = slice(first, first + count)
            assert torch.equal(p.gather[live], orig.gather[live])
            assert torch.equal(p.entity_rows[live], orig.entity_rows[live])
            assert int(p.mask.sum()) == int(orig.mask[live].sum())
    np.testing.assert_array_equal(sred.sample_entity_rows.numpy(), np.asarray(jsred.sample_entity_rows))
    with pytest.raises(ValueError, match="home card"):
        shard_random_effect_dataset(red, mesh, ds, replicate_sample_rows=False)


# --------------------------------------------------------------- the coordinate


@pytest.mark.parametrize("lanes", [(0, 1), (3, 4), (15, 16), (1, 4), (2, 7), (0, 16)],
                         ids=["first", "one", "last", "three", "five", "whole"])
def test_a_bucket_solved_in_place_gives_its_lanes_the_whole_buckets_bits(lanes):
    """`lanes_in_place` keeps the bucket's shape with lanes [lo, hi) live:
    the dummies gather row 0 under mask 0 and write the pinned row, and a
    solve from zeros there gives the live lanes the whole bucket's bits."""
    from photon_ml_tpu_torch.data.game_dataset import gather_block_data
    from photon_ml_tpu_torch.ops.losses import loss_for_task
    from photon_ml_tpu_torch.optimize import problem as port_problem

    ds, red = _port_red(200, 13)
    b = max(red.buckets, key=lambda b: b.num_entities)
    assert b.num_entities == 16
    lo, hi = lanes
    placed = lanes_in_place(b, lo, hi, red.num_entities)
    dead = torch.ones(16, dtype=torch.bool)
    dead[lo:hi] = False
    assert not placed.gather[dead].any() and not placed.mask[dead].any()
    assert (placed.entity_rows[dead] == red.num_entities).all()
    offsets = torch.from_numpy(np.random.default_rng(7).normal(size=200).astype(np.float32))
    loss = loss_for_task(TASK)

    def solve(blocks):
        block = gather_block_data(ds, red.feature_shard, blocks, offsets, red.feature_mask)
        w0 = torch.zeros((16, ds.shards[red.feature_shard].shape[-1]), dtype=torch.float32)
        return port_problem.solve(loss, block, _cfg(), w0, None, use_kernel=False).coefficients

    whole, got = solve(b), solve(placed)
    assert got[lo:hi].numpy().tobytes() == whole[lo:hi].numpy().tobytes()
    assert not got[dead].any()


def test_a_card_is_sent_only_the_offsets_its_blocks_read():
    """`card_offsets` over a replica with `rows`: the offsets at the rows its
    in-place blocks gather, zeros elsewhere, so its blocks are the home
    card's bit for bit; the dataset's own card reads the offsets as they are."""
    from photon_ml_tpu_torch.data.game_dataset import gather_block_data

    ds, red = _port_red(200, 13)
    sred = shard_random_effect_dataset(red, _cpu_mesh(4), ds)
    rep = sred.card_replicas[torch.device("cpu")]
    assert rep.rows is None
    offsets = torch.from_numpy(np.random.default_rng(9).normal(size=200).astype(np.float32))
    assert card_offsets(offsets, rep) is offsets
    for k in range(4):
        placed = [b.placed[k] for b in sred.buckets]
        rows = torch.unique(torch.cat([p.gather.flatten() for p in placed]))
        sent = card_offsets(offsets, pmesh.CardReplica(rep.dataset, rep.feature_mask, rows))
        unread = torch.ones(200, dtype=torch.bool)
        unread[rows] = False
        assert torch.equal(sent[rows], offsets[rows]) and not sent[unread].any()
        assert unread.any()
        for p in placed:
            a = gather_block_data(ds, red.feature_shard, p, offsets, red.feature_mask)
            c = gather_block_data(ds, red.feature_shard, p, sent, red.feature_mask)
            assert a.offsets.numpy().tobytes() == c.offsets.numpy().tobytes()


def _cfg(variance=VarianceComputationType.NONE, pkg=None):
    if pkg is None:
        return CoordinateOptimizationConfig(optimizer=OptimizerConfig(max_iterations=20, tolerance=1e-7),
                                            regularization=L2, reg_weight=0.7,
                                            variance_computation=variance)
    return jax_config.CoordinateOptimizationConfig(
        optimizer=jax_config.OptimizerConfig(max_iterations=20, tolerance=1e-7),
        regularization=jax_config.L2, reg_weight=0.7,
        variance_computation=getattr(jax_config.VarianceComputationType, variance.name))


def _models_equal(a: RandomEffectModel, b: RandomEffectModel):
    a, b = a.on_device("cpu"), b.on_device("cpu")
    assert a.coefficients_matrix.numpy().tobytes() == b.coefficients_matrix.numpy().tobytes()
    assert (a.variances_matrix is None) == (b.variances_matrix is None)
    if a.variances_matrix is not None:
        assert a.variances_matrix.numpy().tobytes() == b.variances_matrix.numpy().tobytes()


@pytest.mark.parametrize("variance", [VarianceComputationType.NONE, SIMPLE, VarianceComputationType.FULL],
                         ids=["none", "simple", "full"])
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_card_mesh_coordinate_trains_and_scores_the_one_device_bits(shards, variance):
    """At 8 shards every bucket of 8 entities is cut into one-lane slices."""
    ds, red = _port_red(200, 13)
    one = RandomEffectCoordinate(ds, red, _cfg(variance), TASK)
    sharded = RandomEffectCoordinate(ds, shard_random_effect_dataset(red, _cpu_mesh(shards), ds),
                                     _cfg(variance), TASK)
    assert sharded.entity_mesh is not None and sharded.entity_sharded and not one.entity_sharded
    if shards == 8:
        assert any(s.num_entities == 1 for b in sharded.re_dataset.buckets for s in b.slices)
    offsets = torch.from_numpy(np.random.default_rng(5).normal(size=200).astype(np.float32))
    m1, st1 = one.train(offsets)
    m2, st2 = sharded.train(offsets)
    assert isinstance(m2.coefficients_matrix, RowShardedMatrix)
    assert m2.coefficients_matrix.mesh.size == shards and st1 == st2
    _models_equal(m1, m2)
    assert one.score(m1).numpy().tobytes() == sharded.score(m2).numpy().tobytes()
    # Warm: each from its own model, at another weight.
    w1, _ = one.train(offsets * 0.5, m1, reg_weight=2.5)
    w2, _ = sharded.train(offsets * 0.5, m2, reg_weight=2.5)
    _models_equal(w1, w2)
    # A one-device model warm-starts the sharded store, too.
    w3, _ = sharded.train(offsets * 0.5, m1, reg_weight=2.5)
    _models_equal(w1, w3)
    assert one.gather_model(w1).coefficients_matrix.numpy().tobytes() == \
        sharded.gather_model(w2).coefficients_matrix.numpy().tobytes()


@pytest.mark.parametrize("variance", [VarianceComputationType.NONE, SIMPLE], ids=["none", "simple"])
@pytest.mark.parametrize("shards", [1, 4, 8])
def test_sharding_info_is_the_jax_coordinates(shards, variance):
    ds, red = _port_red(200, 13)
    jds, jred = _jax_red(200, 13)
    if shards > 1:
        red = shard_random_effect_dataset(red, _cpu_mesh(shards), ds)
        jred = jax_mesh.shard_random_effect_dataset(
            jred, jax_mesh.make_mesh(jax.devices()[:shards]), replicate_sample_rows=True)
    ours = RandomEffectCoordinate(ds, red, _cfg(variance), TASK).sharding_info()
    theirs = JaxRandomEffectCoordinate(jds, jred, _cfg(variance, jax_config),
                                       JaxTaskType.LOGISTIC_REGRESSION).sharding_info()
    assert ours == theirs
    assert ours["entity_sharded"] == (shards > 1)


def test_on_device_gives_the_logical_rows():
    M = np.arange(33, dtype=np.float32).reshape(11, 3)
    sharded = put_row_sharded(M, _cpu_mesh(4))
    model = RandomEffectModel(sharded, put_row_sharded(-M, _cpu_mesh(4)), TASK).on_device("cpu")
    assert model.coefficients_matrix.shape == (11, 3)
    assert model.coefficients_matrix.numpy().tobytes() == M.tobytes()
    assert model.variances_matrix.numpy().tobytes() == (-M).tobytes()


# ----------------------------------------------------------------- the executor


@pytest.fixture(scope="module")
def problem():
    return _port_data(96, 6, 1), _port_data(64, 6, 2)


@pytest.mark.parametrize("variance", [None, SIMPLE], ids=["none", "simple"])
@pytest.mark.parametrize("groups", [1, 2])
def test_groups_of_several_cards_give_the_serial_bits(problem, groups, variance):
    """Two groups of 4 CPU cards (2 lanes a slice), or one of 8 (one lane a
    slice): cold and warm rounds."""
    _, ex_serial = _executor(problem, "serial", variance=variance)
    _, ex_group = _executor(problem, "shard_group", shard_groups=groups, variance=variance)
    assert ex_serial.evaluate_batch(_POINTS) == ex_group.evaluate_batch(_POINTS)
    _assert_models_equal(ex_serial.last_trial_models, ex_group.last_trial_models, "cards cold")
    assert ex_serial.evaluate_batch(_POINTS2) == ex_group.evaluate_batch(_POINTS2)
    _assert_models_equal(ex_serial.last_trial_models, ex_group.last_trial_models, "cards warm")
    contexts = ex_group._groups()
    assert [len(c["devices"]) for c in contexts] == [8 // groups] * groups
    for ctx in contexts:
        re = ctx["coordinates"]["re"]
        assert re.entity_mesh.size == 8 // groups and re.sharding_info()["entity_sharded"]
        assert ctx["coordinates"]["fixed"].dataset.device == torch.device("cpu")
    if variance is not None:
        assert all(t["re"]["v"] is not None for t in ex_group.last_trial_models)


def test_groups_agree_with_the_jax_serial_executor(problem):
    ref = _jax_executor((_jax_data(96, 6, 1), _jax_data(64, 6, 2)))
    _, ours = _executor(problem, "shard_group", shard_groups=2)
    for pts in (_POINTS, _POINTS2):
        np.testing.assert_allclose(ours.evaluate_batch(pts), ref.evaluate_batch(pts),
                                   atol=TOL["auc_atol"], rtol=0)
        _close_models(ours.last_trial_models, ref.last_trial_models)


def test_the_collective_site_is_retried_with_the_same_bits(problem, monkeypatch):
    _, ex_serial = _executor(problem, "serial")
    want = ex_serial.evaluate_batch(_POINTS)
    _, ex_group = _executor(problem, "shard_group", shard_groups=2)
    with faults.inject("collective:1"):
        got = ex_group.evaluate_batch(_POINTS)
    assert got == want and faults.COUNTERS.get("collective_retries") == 1
    _assert_models_equal(ex_serial.last_trial_models, ex_group.last_trial_models, "retried")
    # Past the retries, the group is lost.
    monkeypatch.setenv("PHOTON_COLLECTIVE_RETRIES", "0")
    with faults.inject("collective:9999"), pytest.raises(faults.MeshLoss, match="entity-sharded"):
        ex_group.evaluate_batch(_POINTS)


# ---------------------------------------------------------------------- cli.tune


def test_cli_tune_shard_groups_save_the_serial_winner(tmp_path):
    data = tmp_path / "data"
    subprocess.run([sys.executable, str(REPO / "examples" / "generate_dataset.py"), str(data),
                    "--train", "400", "--test", "150", "--entities", "12"],
                   check=True, capture_output=True, timeout=120)
    for split in ("train", "test"):
        assert libsvm_to_avro.main(["--tag-comments", str(data / f"{split}.libsvm"),
                                    str(data / f"{split}.avro")]) == 0
    runs = {}
    for mode, extra in (("serial", []), ("shard_group", ["--shard-groups", "2"])):
        args = _tune_args(data, tmp_path / mode, ["--device", "cpu", "--sweep-mode", mode, *extra])
        # One round of two trials, one coordinate-descent pass.
        args[args.index("--tuning-iter") + 1] = "2"
        args[args.index("--coordinate-descent-iterations") + 1] = "1"
        runs[mode] = tune_cli.main(args)
    serial, group = runs["serial"], runs["shard_group"]
    assert group["modes"] == ["shard_group"] and serial["modes"] == ["serial"]
    assert [t["value"] for t in group["trials"]] == [t["value"] for t in serial["trials"]]
    assert group["best_point"] == serial["best_point"]
    a = _load(tmp_path / "shard_group" / "models" / "tuned-best")
    b = _load(tmp_path / "serial" / "models" / "tuned-best")
    np.testing.assert_array_equal(a.coordinates["global"].means, b.coordinates["global"].means)
    assert a.coordinates["per-member"].entity_ids == b.coordinates["per-member"].entity_ids
    np.testing.assert_array_equal(a.coordinates["per-member"].means, b.coordinates["per-member"].means)
    on_disk = json.loads((tmp_path / "shard_group" / "tuning-summary.json").read_text())
    assert on_disk["modes"] == ["shard_group"]
