"""Random effects over a sparse shard against the JAX package: the
per-entity solve on an ELL shard (coefficients per entity, scores), the
dense block a bucket's ELL block becomes (FULL variances) against the plain
ELL products, duplicates in a shard,
bit-identical reruns, the whole slice from Avro files (a fixed effect plus
per-user and per-movie random effects on one sparse shard, then AUC), and
a JAX model trained over a sparse shard carried into the port."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.data import containers as jax_containers
from photon_ml_tpu.data import game_dataset as jax_gd
from photon_ml_tpu.evaluation import metrics as jax_metrics
from photon_ml_tpu.game import coordinate as jax_coordinate
from photon_ml_tpu.game.coordinate_descent import run_coordinate_descent as jax_run_cd
from photon_ml_tpu.io import avro_data as jad
from photon_ml_tpu.optimize import config as jax_config
from photon_ml_tpu.transformers import game_transformer as jax_gt
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu_torch import convert
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.data import containers
from photon_ml_tpu_torch.data import game_dataset as gd
from photon_ml_tpu_torch.data.containers import SparseFeatures, pack_csr_to_ell
from photon_ml_tpu_torch.evaluation import metrics
from photon_ml_tpu_torch.game.coordinate import FixedEffectCoordinate, RandomEffectCoordinate
from photon_ml_tpu_torch.game.coordinate_descent import run_coordinate_descent
from photon_ml_tpu_torch.io import avro_data as pad
from photon_ml_tpu_torch.native.avro_writer import write_training_examples_columnar
from photon_ml_tpu_torch.ops import losses
from photon_ml_tpu_torch.optimize import config, problem
from photon_ml_tpu_torch.transformers.game_transformer import GameTransformer
from photon_ml_tpu_torch.types import TaskType

GLMIX = PORT_TOLERANCES["glmix"]
OBJ = PORT_TOLERANCES["objective"]
TASK, JTASK = TaskType.LOGISTIC_REGRESSION, JaxTaskType.LOGISTIC_REGRESSION
K_IDS, D_IDS = 8, 200


def e2e_arrays(rows, seed=23):
    """bench.py's e2e generator (bench.py:4671-4700) at `rows` rows:
    per-user and per-movie structure, 8 ids a row over dim 200."""
    n_users, n_movies = max(2, rows // 145), max(2, rows // 740)
    rng = np.random.default_rng(seed)
    users = rng.integers(0, n_users, size=rows)
    movies = rng.integers(0, n_movies, size=rows)
    indptr = np.arange(rows + 1, dtype=np.int64) * K_IDS
    ids = rng.integers(0, D_IDS, size=rows * K_IDS).astype(np.int32)
    vals = rng.normal(size=rows * K_IDS)
    w_true = rng.normal(size=D_IDS) * 0.3
    margin = ((vals * w_true[ids]).reshape(rows, K_IDS).sum(axis=1)
              + rng.normal(size=n_users)[users] * 0.7 + rng.normal(size=n_movies)[movies] * 0.7)
    labels = (rng.uniform(size=rows) < 1 / (1 + np.exp(-margin))).astype(np.float64)
    return users, movies, indptr, ids, vals, labels


def _configs(pkg, fe_iters=10, re_iters=5):
    fe = pkg.CoordinateOptimizationConfig(
        optimizer=pkg.OptimizerConfig(max_iterations=fe_iters, tolerance=1e-6),
        regularization=pkg.L2, reg_weight=1.0)
    re = pkg.CoordinateOptimizationConfig(
        optimizer=pkg.OptimizerConfig(max_iterations=re_iters, tolerance=1e-5),
        regularization=pkg.L2, reg_weight=10.0)
    return fe, re


def _ell_pair(rows, seed):
    """The same ELL shard (8 ids + an intercept column at 200) for both
    packages, and the users and labels."""
    users, _, indptr, ids, vals, labels = e2e_arrays(rows, seed)
    sf = pack_csr_to_ell(indptr, ids, vals.astype(np.float32), D_IDS + 1, extra_col=(D_IDS, 1.0))
    idx, val = sf.indices.numpy(), sf.values.numpy()
    jsf = jax_containers.SparseFeatures(idx, val, D_IDS + 1)
    jds = jax_gd.GameDataset.build({"g": jsf}, labels, id_tags={"userId": users})
    ds = gd.GameDataset.build({"g": sf}, labels, id_tags={"userId": users}, device="cpu")
    return ds, jds


RE_LAYOUT = dict(active_upper_bound=256, min_bucket=8)


def test_random_effect_over_a_sparse_shard_matches_jax():
    """Entities of ~145 rows (50+), offsets from a fixed margin: the
    per-entity coefficients and the margins match the JAX package's."""
    ds, jds = _ell_pair(8000, 3)
    rng = np.random.default_rng(4)
    offsets = (rng.normal(size=ds.num_samples) * 0.3).astype(np.float32)
    _, re_cfg = _configs(config, re_iters=20)
    _, jre_cfg = _configs(jax_config, re_iters=20)
    red = gd.build_random_effect_dataset(ds, gd.RandomEffectDataConfig("userId", "g", **RE_LAYOUT))
    jred = jax_gd.build_random_effect_dataset(jds, jax_gd.RandomEffectDataConfig("userId", "g", **RE_LAYOUT))
    assert red.entity_index == jred.entity_index
    coord = RandomEffectCoordinate(ds, red, re_cfg, TASK)
    jcoord = jax_coordinate.RandomEffectCoordinate(jds, jred, jre_cfg, JTASK)
    model, stats = coord.train(torch.from_numpy(offsets))
    jmodel, _ = jcoord.train(jds.offsets + offsets)
    assert coord.dim == D_IDS + 1 and stats["total_iterations"] > 0
    np.testing.assert_allclose(model.coefficients_matrix.numpy(),
                               np.asarray(jmodel.coefficients_matrix), atol=GLMIX["coef_atol"], rtol=0)
    np.testing.assert_allclose(coord.score(model).numpy(), np.asarray(jcoord.score(jmodel)),
                               atol=GLMIX["score_atol"], rtol=0)


def test_dense_block_matches_the_plain_ell_products():
    ds, _ = _ell_pair(3000, 5)
    red = gd.build_random_effect_dataset(ds, gd.RandomEffectDataConfig("userId", "g", **RE_LAYOUT))
    gen = torch.Generator().manual_seed(0)
    for blocks in red.buckets:
        block = gd.gather_block_data(ds, "g", blocks)
        ell = block.features
        assert isinstance(ell, SparseFeatures) and ell.indices.shape[:2] == blocks.gather.shape
        dense = containers.ell_block_to_dense(ell)
        assert dense.shape == (*blocks.gather.shape, D_IDS + 1)
        assert torch.equal(dense, containers.ell_block_to_dense(ell))
        # Exactly the sum of each row's entries at their columns.
        ref = np.zeros(dense.shape, np.float64)
        e, s, k = np.indices(ell.indices.shape)
        np.add.at(ref, (e, s, ell.indices.numpy()), ell.values.numpy())
        np.testing.assert_array_equal(dense.numpy(), ref.astype(np.float32))
        w = torch.randn(dense.shape[0], dense.shape[2], generator=gen)
        u = torch.randn(dense.shape[:2], generator=gen)
        plain_mv = torch.sum(ell.values * torch.gather(w, 1, ell.indices.long().flatten(1)).view_as(ell.values), -1)
        plain_rmv = torch.zeros_like(w).scatter_add_(
            1, ell.indices.long().flatten(1), (ell.values * u[..., None]).flatten(1))
        torch.testing.assert_close(torch.einsum("esd,ed->es", dense, w), plain_mv,
                                   rtol=OBJ["rtol"], atol=OBJ["atol"])
        torch.testing.assert_close(torch.einsum("es,esd->ed", u, dense), plain_rmv,
                                   rtol=OBJ["rtol"], atol=OBJ["atol"])


def test_sparse_random_effect_refuses_duplicates_and_an_oversize_block(monkeypatch):
    """A shard that names a feature twice in a row is accepted, as the
    reference accepts it: its block's products sum the entries (a^2 + b^2 in
    the squared one), and the dense form FULL variances build sums them in
    k order. `ell_block_to_dense` still refuses a block above
    MAX_DENSE_BLOCK_BYTES, where it runs."""
    idx = torch.tensor([[3, 1, 3, 0], [2, 0, 0, 0]], dtype=torch.int32)
    val = torch.tensor([[1.0, 2.0, 0.5, 0.0], [1.0, 0.0, 0.0, 0.0]])
    ds = gd.GameDataset.build({"g": SparseFeatures(idx, val, 5)}, np.zeros(2),
                              id_tags={"userId": np.array(["a", "a"])}, device="cpu")
    red = gd.build_random_effect_dataset(ds, gd.RandomEffectDataConfig("userId", "g"))
    ell = gd.gather_block_data(ds, "g", red.buckets[0]).features
    jell = jax_containers.SparseFeatures(ell.indices.numpy()[0], ell.values.numpy()[0], 5)
    u = torch.tensor([[0.5, -2.0] + [0.0] * (ell.values.shape[1] - 2)] * ell.values.shape[0])
    assert ell.rmatvec(u)[0].tolist() == np.asarray(jell.rmatvec(jnp.asarray(u[0]))).tolist()
    assert ell.sq_rmatvec(u)[0].tolist() == [0.0, 2.0, -2.0, 0.5 * (1.0 + 0.25), 0.0]
    np.testing.assert_array_equal(ell.sq_rmatvec(u)[0].numpy(), np.asarray(jell.sq_rmatvec(jnp.asarray(u[0]))))
    dense = containers.ell_block_to_dense(ell)
    assert dense[0, 0].tolist() == [0.0, 2.0, 0.0, 1.5, 0.0] and dense[0, 1].tolist() == [0.0, 0.0, 1.0, 0.0, 0.0]
    monkeypatch.setattr(containers, "MAX_DENSE_BLOCK_BYTES", dense.numel() * 4 - 1)
    with pytest.raises(ValueError, match="MAX_DENSE_BLOCK_BYTES"):
        containers.ell_block_to_dense(ell)


def _write_e2e_files(root, rows, seed=23):
    users, movies, indptr, ids, vals, labels = e2e_arrays(rows, seed)
    half = rows // 2
    for fi, (lo, hi) in enumerate([(0, half), (half, rows)]):
        write_training_examples_columnar(
            str(root / f"part-{fi}.avro"), labels[lo:hi], indptr[lo:hi + 1] - indptr[lo],
            ids[indptr[lo]:indptr[hi]], vals[indptr[lo]:indptr[hi]], [f"f{i}" for i in range(D_IDS)],
            int_tags={"userId": users[lo:hi], "movieId": movies[lo:hi]})
    return str(root)


def _coordinates(pkg, gdm, coord_mod, ds, task):
    fe, re = _configs(pkg)
    user = gdm.build_random_effect_dataset(ds, gdm.RandomEffectDataConfig(
        "userId", "g", active_upper_bound=256, min_bucket=8))
    movie = gdm.build_random_effect_dataset(ds, gdm.RandomEffectDataConfig(
        "movieId", "g", active_upper_bound=512, min_bucket=8))
    return {"global": coord_mod.FixedEffectCoordinate(ds, "g", fe, task),
            "per-user": coord_mod.RandomEffectCoordinate(ds, user, re, task),
            "per-movie": coord_mod.RandomEffectCoordinate(ds, movie, re, task)}


class _Ports:
    FixedEffectCoordinate = FixedEffectCoordinate
    RandomEffectCoordinate = RandomEffectCoordinate


@pytest.fixture(scope="module")
def e2e_pair(tmp_path_factory):
    """bench.py's e2e cell at 12,000 rows (about 82 users of ~145 rows and
    16 movies of ~740), from the same two Avro files, one sweep with the
    bench's configs (bench.py:4757-4789) in each package."""
    path = _write_e2e_files(tmp_path_factory.mktemp("e2e"), 12000)
    shard = {"g": (("features",), True)}
    ds, _ = pad.read_game_dataset(path, {k: pad.FeatureShardConfig(*v) for k, v in shard.items()},
                                  id_tag_fields=["userId", "movieId"], device="cpu")
    jds, _ = jad.read_game_dataset(path, {k: jad.FeatureShardConfig(*v) for k, v in shard.items()},
                                   id_tag_fields=["userId", "movieId"])
    coords = _coordinates(config, gd, _Ports, ds, TASK)
    jcoords = _coordinates(jax_config, jax_gd, jax_coordinate, jds, JTASK)
    return dict(ds=ds, jds=jds, coords=coords, jcoords=jcoords,
                res=run_coordinate_descent(coords, 1), jres=jax_run_cd(jcoords, 1))


def test_e2e_slice_from_avro_matches_jax(e2e_pair):
    res, jres = e2e_pair["res"], e2e_pair["jres"]
    c, jc = e2e_pair["coords"], e2e_pair["jcoords"]
    np.testing.assert_allclose(res.model["global"].coefficients.means.numpy(),
                               np.asarray(jres.model["global"].coefficients.means),
                               atol=GLMIX["coef_atol"], rtol=0)
    for cid in ("per-user", "per-movie"):
        assert c[cid].re_dataset.entity_index == jc[cid].re_dataset.entity_index
        np.testing.assert_allclose(res.model[cid].coefficients_matrix.numpy(),
                                   np.asarray(jres.model[cid].coefficients_matrix),
                                   atol=GLMIX["coef_atol"], rtol=0)
    scores = sum(c[k].score(res.model[k]) for k in c) + e2e_pair["ds"].offsets
    jscores = sum(jc[k].score(jres.model[k]) for k in jc) + e2e_pair["jds"].offsets
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), atol=GLMIX["score_atol"], rtol=0)
    auc = float(metrics.area_under_roc_curve(scores, e2e_pair["ds"].labels))
    jauc = float(jax_metrics.area_under_roc_curve(jscores, e2e_pair["jds"].labels))
    assert abs(auc - jauc) <= GLMIX["auc_atol"] and auc > 0.7


def test_e2e_slice_reruns_bit_identically(e2e_pair):
    again = run_coordinate_descent(e2e_pair["coords"], 1).model
    first = e2e_pair["res"].model
    assert torch.equal(again["global"].coefficients.means, first["global"].coefficients.means)
    for cid in ("per-user", "per-movie"):
        assert torch.equal(again[cid].coefficients_matrix, first[cid].coefficients_matrix)


def test_jax_sparse_random_effect_model_converts_and_scores_alike(e2e_pair):
    jres, jc, jds = e2e_pair["jres"], e2e_pair["jcoords"], e2e_pair["jds"]
    specs, arrays = {}, {}
    for cid, jcoord in jc.items():
        if cid == "global":
            specs[cid] = jax_gt.CoordinateScoringSpec("g")
            arrays[cid] = convert.FixedEffectArrays("g", np.asarray(jres.model[cid].coefficients.means))
        else:
            red = jcoord.re_dataset
            tag = red.config.random_effect_type
            specs[cid] = jax_gt.CoordinateScoringSpec("g", random_effect_type=tag,
                                                     entity_index=red.entity_index)
            matrix = np.asarray(jres.model[cid].coefficients_matrix)
            assert matrix.shape == (len(red.entity_index) + 1, D_IDS + 1)
            arrays[cid] = convert.RandomEffectArrays("g", tag, matrix, red.entity_index)
    ref = jax_gt.GameTransformer(jres.model, specs, JTASK).transform(jds)
    model, port_specs = convert.game_model_from_numpy(arrays, TASK, device="cpu")
    got = GameTransformer(model, port_specs, TASK).transform(e2e_pair["ds"])
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), **PORT_TOLERANCES["convert_scores"])


def test_re_solve_length_is_as_sensitive_in_the_reference():
    """The random effect's solve length against the JAX package's, on the
    same fixed-effect bits (the port's FE scores as both packages' offsets),
    at phase 3's settings (20 iterations, tol 1e-7, below f32 resolution):
    each lane's iteration count is within the solver tolerance of the
    reference's. Flipping the last bit of half the offsets changes some
    lanes' counts in both packages alike, so a batched solve's step count
    (the slowest lane's) moving after a change to the FE's low bits is the
    reference's behaviour too, not a fault of the port."""
    ds, jds = _ell_pair(8000, 7)
    fe, _ = _configs(config)
    re = config.CoordinateOptimizationConfig(optimizer=config.OptimizerConfig(max_iterations=20, tolerance=1e-7),
                                             regularization=config.L2, reg_weight=10.0)
    jre = jax_config.CoordinateOptimizationConfig(
        optimizer=jax_config.OptimizerConfig(max_iterations=20, tolerance=1e-7),
        regularization=jax_config.L2, reg_weight=10.0)
    fec = FixedEffectCoordinate(ds, "g", fe, TASK)
    fe_scores = fec.score(fec.train(ds.offsets)[0]).numpy()
    red = gd.build_random_effect_dataset(ds, gd.RandomEffectDataConfig("userId", "g", **RE_LAYOUT))
    jred = jax_gd.build_random_effect_dataset(jds, jax_gd.RandomEffectDataConfig("userId", "g", **RE_LAYOUT))
    jcoord = jax_coordinate.RandomEffectCoordinate(jds, jred, jre, JTASK)

    def lane_iterations(offsets):
        port, ref = [], []
        for b, jb in zip(red.buckets, jred.buckets):
            block = gd.gather_block_data(ds, "g", b, torch.from_numpy(offsets))
            w0 = torch.zeros(b.num_entities, D_IDS + 1)
            port.append(problem.solve(losses.LOGISTIC, block, re, w0, use_kernel=False).iterations.numpy())
            jblock = jax_gd.gather_block_data(jds, "g", jb, jds.offsets + offsets)
            jres = jcoord._train_bucket(jblock, jnp.zeros((jb.num_entities, D_IDS + 1)), jnp.float32(10.0))
            ref.append(np.asarray(jres.iterations))
        return np.concatenate(port), np.concatenate(ref)

    port, ref = lane_iterations(fe_scores)
    assert np.abs(port - ref).max() <= PORT_TOLERANCES["solver"]["iterations"]
    flipped = fe_scores.copy()
    bits = flipped.view(np.int32)
    bits[np.random.default_rng(0).uniform(size=bits.shape) < 0.5] ^= 1
    port2, ref2 = lane_iterations(flipped)
    assert np.abs(port2 - ref2).max() <= PORT_TOLERANCES["solver"]["iterations"]
    assert (port2 != port).any() and (ref2 != ref).any()
