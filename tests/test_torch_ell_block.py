"""A random effect solved on its (E, S, K) ELL block, against the JAX
package: the batched products per lane against the reference's vmapped
`SparseFeatures` products (padding lanes, explicit zeros, a feature named
twice), the transpose plan's order against the plain version's bits, and a
per-user random effect over 16,385 features whose dense block would pass
MAX_DENSE_BLOCK_BYTES: it trains, never densifies, matches the reference
and reruns bit for bit."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.data import containers as jax_containers
from photon_ml_tpu.data import game_dataset as jax_gd
from photon_ml_tpu.game import coordinate as jax_coordinate
from photon_ml_tpu.optimize import config as jax_config
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.data import containers
from photon_ml_tpu_torch.data import game_dataset as gd
from photon_ml_tpu_torch.data.containers import SparseFeatures, ell_transpose_plan, pack_csr_to_ell
from photon_ml_tpu_torch.game.coordinate import RandomEffectCoordinate
from photon_ml_tpu_torch.ops import ell_kernels, objective
from photon_ml_tpu_torch.ops.losses import LOGISTIC
from photon_ml_tpu_torch.optimize import config
from photon_ml_tpu_torch.types import TaskType

OBJ = PORT_TOLERANCES["objective"]
GLMIX = PORT_TOLERANCES["glmix"]


def _planes(seed: int, E: int = 4, S: int = 6, K: int = 5, D: int = 9):
    """(E, S, K) planes with what a bucket holds: padding entries (index 0,
    value 0), an explicit zero at a real index, a feature named twice in a
    row, and a last lane of padding rows only."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, D, size=(E, S, K)).astype(np.int32)
    val = rng.normal(size=(E, S, K)).astype(np.float32)
    idx[:, :, -1], val[:, :, -1] = 0, 0.0  # padding
    val[0, 1, 2] = 0.0  # an explicit zero
    idx[1, 2, 1], val[1, 2, 1] = idx[1, 2, 0], 0.75  # a duplicate
    idx[-1], val[-1] = 0, 0.0  # a padding lane
    return idx, val, D


@pytest.mark.parametrize("seed", [0, 1])
def test_batched_products_match_the_vmapped_reference(seed):
    idx, val, D = _planes(seed)
    E, S, _ = idx.shape
    rng = np.random.default_rng(seed + 10)
    w = rng.normal(size=(E, D)).astype(np.float32)
    u = rng.normal(size=(E, S)).astype(np.float32)
    block = SparseFeatures(torch.from_numpy(idx), torch.from_numpy(val), D)

    def ref(method, x):
        return np.asarray(jax.vmap(lambda i, v, a: getattr(jax_containers.SparseFeatures(i, v, D), method)(a))(
            jnp.asarray(idx), jnp.asarray(val), jnp.asarray(x)))

    got = {"matvec": block.matvec(torch.from_numpy(w)), "rmatvec": block.rmatvec(torch.from_numpy(u)),
           "sq_rmatvec": block.sq_rmatvec(torch.from_numpy(u))}
    for method, x in (("matvec", w), ("rmatvec", u), ("sq_rmatvec", u)):
        assert got[method].shape == ((E, S) if method == "matvec" else (E, D))
        np.testing.assert_allclose(got[method].numpy(), ref(method, x), rtol=OBJ["rtol"], atol=OBJ["atol"])
    # The duplicate's cell: a + b in X^T u, a^2 + b^2 in (X o X)^T u.
    f = idx[1, 2, 0]
    named = val[1, 2][idx[1, 2] == f].astype(np.float64)
    assert len(named) >= 2
    only = torch.zeros(E, S)
    only[1, 2] = 1.0
    assert float(block.sq_rmatvec(only)[1, f]) == pytest.approx(float((named ** 2).sum()), rel=1e-6)
    assert float(block.rmatvec(only)[1, f]) == pytest.approx(float(named.sum()), rel=1e-6)
    assert not got["rmatvec"][-1].any() and not got["matvec"][-1].any()


def _emulate_kernel(plan, block, u, square):
    """csrc/ell_block.cu's sums in numpy float32: each run from +0, its
    entries in plan order, each product rounded once."""
    K = plan.shape[2]
    vals, uu = block.values.numpy().reshape(-1), u.numpy().reshape(-1)
    order, ptr = plan.order.numpy(), plan.run_ptr.numpy()
    out = np.zeros(plan.shape[0] * plan.dim, np.float32)
    for r, cell in enumerate(plan.run_out.numpy()):
        acc = np.float32(0.0)
        for j in order[ptr[r]:ptr[r + 1]]:
            x = vals[j] * vals[j] if square else vals[j]
            acc = np.float32(acc + np.float32(x * uu[j // K]))
        out[cell] = acc
    return out.reshape(plan.shape[0], plan.dim)


@pytest.mark.parametrize("square", [False, True], ids=["rmatvec", "sq_rmatvec"])
def test_the_kernels_order_gives_the_plain_versions_bits(square):
    """The transpose plan sorts the live nonzero entries by (lane, feature),
    stably from (lane, k, s) order; a run a cell, in (k, s) order. The
    kernel's sums over it (emulated here) have the plain version's bits,
    when u is 0 on the rows the plan leaves out."""
    idx, val, D = _planes(3, E=6, S=12, K=7, D=5)  # narrow: long runs
    rng = np.random.default_rng(4)
    live = torch.from_numpy(rng.uniform(size=idx.shape[:2]) < 0.7)
    u = torch.from_numpy(rng.normal(size=idx.shape[:2]).astype(np.float32)) * live
    block = SparseFeatures(torch.from_numpy(idx), torch.from_numpy(val), D)
    plan = ell_transpose_plan(block.indices, block.values, D, live)
    E, S, K = plan.shape
    kept = (val != 0) & live.numpy()[..., None]
    order = plan.order.numpy()
    assert sorted(order.tolist()) == np.flatnonzero(kept.reshape(-1)).tolist()
    cells = (order // (S * K)) * D + idx.reshape(-1)[order]
    ptr = plan.run_ptr.numpy()
    assert ptr[0] == 0 and ptr[-1] == len(order) and (np.diff(ptr) > 0).all()
    assert (np.diff(plan.run_out.numpy()) > 0).all()
    for r, cell in enumerate(plan.run_out.numpy()):
        run = order[ptr[r]:ptr[r + 1]]
        ks = (run % K) * S + (run // K) % S  # the reference's (k, s) order within a lane
        assert (cells[ptr[r]:ptr[r + 1]] == cell).all() and (np.diff(ks) > 0).all()
    want = ell_kernels.rmatvec_plain(block, u, square)
    assert _emulate_kernel(plan, block, u, square).tobytes() == want.numpy().tobytes()


@pytest.mark.parametrize("lo,hi", [(0, 1), (3, 6), (5, 8)])
def test_lanes_in_place_leave_their_dummies_out_of_the_products(lo, hi):
    """A shard group's card solves its lanes in place (parallel/mesh.py
    `lanes_in_place`): every other lane gathers row 0 under mask 0. On the
    ELL route those dummies have no entry in the transpose plan and zero
    transposes, and the live lanes' solve has the whole bucket's bits."""
    from photon_ml_tpu_torch.optimize import problem
    from photon_ml_tpu_torch.parallel.mesh import lanes_in_place

    rng = np.random.default_rng(7)
    n, dim = 600, 40
    sf = pack_csr_to_ell(np.arange(n + 1) * 5, rng.integers(0, dim, n * 5).astype(np.int32),
                         rng.normal(size=n * 5).astype(np.float32), dim + 1, extra_col=(dim, 1.0))
    labels = (rng.uniform(size=n) < 0.5).astype(np.float64)
    ds = gd.GameDataset.build({"g": sf}, labels, id_tags={"userId": rng.integers(0, 12, n)}, device="cpu")
    red = gd.build_random_effect_dataset(ds, gd.RandomEffectDataConfig("userId", "g", min_bucket=8))
    bucket = red.buckets[0]
    placed = gd.gather_block_data(ds, "g", lanes_in_place(bucket, lo, hi, red.num_entities))
    feats = placed.features
    plan = ell_transpose_plan(feats.indices, feats.values, feats.dim, placed.weights != 0)
    lanes = plan.order.numpy() // (plan.shape[1] * plan.shape[2])
    assert len(lanes) and lo <= lanes.min() and lanes.max() < hi
    u = placed.weights * torch.from_numpy(rng.normal(size=tuple(placed.weights.shape)).astype(np.float32))
    for square in (False, True):
        got = ell_kernels.rmatvec_plain(feats, u, square)
        assert not got[:lo].any() and not got[hi:].any()
        assert _emulate_kernel(plan, feats, u, square).tobytes() == got.numpy().tobytes()
    cfg = _re_config(config)
    w0 = torch.zeros(bucket.num_entities, dim + 1)
    whole = problem.solve(LOGISTIC, gd.gather_block_data(ds, "g", bucket), cfg, w0, use_kernel=False)
    in_place = problem.solve(LOGISTIC, placed, cfg, w0, use_kernel=False)
    assert torch.equal(in_place.coefficients[lo:hi], whole.coefficients[lo:hi])
    assert not in_place.coefficients[:lo].any() and not in_place.coefficients[hi:].any()


# The refused case: a per-user random effect over 8 ids a row among 16,384
# and an intercept (IDENTITY: no projection), with the default
# max_block_cells. ~145 rows a user put ~66 users in the capacity-256
# bucket, padded to 128 lanes: 32,768 cells x 16,385 features x 4 bytes is
# just above MAX_DENSE_BLOCK_BYTES, so the dense route refused it.
WIDE_IDS, WIDE_ROWS, WIDE_K = 16_384, 10_500, 8
TASK, JTASK = TaskType.LOGISTIC_REGRESSION, JaxTaskType.LOGISTIC_REGRESSION
LAYOUT = dict(active_upper_bound=256, min_bucket=8)


def _re_config(pkg):
    return pkg.CoordinateOptimizationConfig(
        optimizer=pkg.OptimizerConfig(max_iterations=5, tolerance=1e-5), regularization=pkg.L2,
        reg_weight=10.0)


@pytest.fixture(scope="module")
def wide():
    rng = np.random.default_rng(25)
    n_users = WIDE_ROWS // 145
    users = rng.integers(0, n_users, size=WIDE_ROWS)
    ids = rng.integers(0, WIDE_IDS, size=WIDE_ROWS * WIDE_K).astype(np.int32)
    vals = rng.normal(size=WIDE_ROWS * WIDE_K).astype(np.float32)
    w_true, u_eff = rng.normal(size=WIDE_IDS) * 0.3, rng.normal(size=n_users)
    margin = (vals * w_true[ids]).reshape(WIDE_ROWS, WIDE_K).sum(1) + 0.7 * u_eff[users]
    labels = (rng.uniform(size=WIDE_ROWS) < 1 / (1 + np.exp(-margin))).astype(np.float64)
    offsets = (rng.normal(size=WIDE_ROWS) * 0.3).astype(np.float32)
    indptr = np.arange(WIDE_ROWS + 1, dtype=np.int64) * WIDE_K
    sf = pack_csr_to_ell(indptr, ids, vals, WIDE_IDS + 1, extra_col=(WIDE_IDS, 1.0))
    ds = gd.GameDataset.build({"g": sf}, labels, id_tags={"userId": users}, device="cpu")
    jds = jax_gd.GameDataset.build(
        {"g": jax_containers.SparseFeatures(sf.indices.numpy(), sf.values.numpy(), WIDE_IDS + 1)},
        labels, id_tags={"userId": users})
    red = gd.build_random_effect_dataset(ds, gd.RandomEffectDataConfig("userId", "g", **LAYOUT))
    jred = jax_gd.build_random_effect_dataset(jds, jax_gd.RandomEffectDataConfig("userId", "g", **LAYOUT))
    coord = RandomEffectCoordinate(ds, red, _re_config(config), TASK)
    jcoord = jax_coordinate.RandomEffectCoordinate(jds, jred, _re_config(jax_config), JTASK)
    jmodel, _ = jcoord.train(jds.offsets + offsets)
    out = dict(ds=ds, red=red, jred=jred, coord=coord, jcoord=jcoord, jmodel=jmodel,
               offsets=torch.from_numpy(offsets))
    with pytest.MonkeyPatch.context() as mp:
        out["model"], out["stats"] = _train_without_densifying(out, mp)
    return out


def _train_without_densifying(wide, monkeypatch):
    def refuse(block):
        raise AssertionError("a random effect's training densified its ELL block")

    monkeypatch.setattr(containers, "ell_block_to_dense", refuse)
    monkeypatch.setattr(objective, "ell_block_to_dense", refuse)
    return wide["coord"].train(wide["offsets"])


def test_a_random_effect_wider_than_a_dense_block_trains_as_the_reference(wide):
    """The fixture trained the port's coordinate with `ell_block_to_dense`
    raising; its model against the reference's."""
    red, coord, model = wide["red"], wide["coord"], wide["model"]
    dense_bytes = max(b.num_entities * b.capacity for b in red.buckets) * (WIDE_IDS + 1) * 4
    assert dense_bytes > containers.MAX_DENSE_BLOCK_BYTES
    assert red.entity_index == wide["jred"].entity_index
    assert wide["stats"]["total_iterations"] > 0
    assert model.coefficients_matrix.shape == (len(red.entity_index) + 1, WIDE_IDS + 1)
    np.testing.assert_allclose(model.coefficients_matrix.numpy(),
                               np.asarray(wide["jmodel"].coefficients_matrix), atol=GLMIX["coef_atol"], rtol=0)
    np.testing.assert_allclose(coord.score(model).numpy(), np.asarray(wide["jcoord"].score(wide["jmodel"])),
                               atol=GLMIX["score_atol"], rtol=0)


def test_a_wide_random_effect_reruns_bit_identically(wide, monkeypatch):
    again, _ = _train_without_densifying(wide, monkeypatch)
    assert again.coefficients_matrix.numpy().tobytes() == wide["model"].coefficients_matrix.numpy().tobytes()
