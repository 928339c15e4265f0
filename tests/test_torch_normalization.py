"""Per-entity normalization (ops/normalization.py) against the JAX
package's: `project_normalization` of a global context through index-map
slot tables, the row-wise maps between the normalized and original spaces,
and the batched objective with one (factors, shifts) row per lane against
the same objective lane by lane."""

from __future__ import annotations

import numpy as np
import torch

import jax.numpy as jnp

from photon_ml_tpu.ops.normalization import NormalizationContext as JaxContext
from photon_ml_tpu.ops.normalization import project_normalization as jax_project_normalization
from photon_ml_tpu_torch import convert
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.data.containers import LabeledData
from photon_ml_tpu_torch.ops import losses, objective
from photon_ml_tpu_torch.ops.normalization import NormalizationContext, project_normalization

OBJ = PORT_TOLERANCES["objective"]
D = 30


def _tables(seed=0, e=12, d_proj=16):
    """Slot tables with an increasing feature prefix a row (some rows with
    the intercept, D - 1, some without) and an empty unseen row."""
    rng = np.random.default_rng(seed)
    tables = np.full((e + 1, d_proj), -1, np.int64)
    for r in range(e):
        k = rng.integers(1, d_proj + 1)
        feats = np.sort(rng.choice(D - 1 if r % 3 else D, size=k, replace=False))
        tables[r, :k] = feats
    return tables


def _global(seed=1):
    rng = np.random.default_rng(seed)
    f = rng.uniform(0.5, 2.0, size=D).astype(np.float32)
    s = rng.normal(size=D).astype(np.float32)
    f[D - 1], s[D - 1] = 1.0, 0.0
    return f, s


def test_project_normalization_and_space_maps_match_jax():
    tables = _tables()
    f, s = _global()
    pen = project_normalization(NormalizationContext(torch.from_numpy(f), torch.from_numpy(s), D - 1),
                                torch.from_numpy(tables))
    jpen = jax_project_normalization(JaxContext(jnp.asarray(f), jnp.asarray(s), D - 1), tables)
    np.testing.assert_array_equal(pen.factors.numpy(), np.asarray(jpen.factors))
    np.testing.assert_array_equal(pen.shifts.numpy(), np.asarray(jpen.shifts))
    np.testing.assert_array_equal(pen.intercept_slots.numpy(), np.asarray(jpen.intercept_slots))
    assert (pen.intercept_slots.numpy() >= 0).any() and (pen.intercept_slots.numpy() < 0).any()
    m = np.random.default_rng(2).normal(size=tables.shape).astype(np.float32)
    v = np.random.default_rng(3).uniform(0.1, 1.0, size=tables.shape).astype(np.float32)
    orig, ovar = pen.matrix_to_original_space(torch.from_numpy(m), torch.from_numpy(v))
    jorig, jovar = jpen.matrix_to_original_space(jnp.asarray(m), jnp.asarray(v))
    np.testing.assert_allclose(orig.numpy(), np.asarray(jorig), rtol=OBJ["rtol"], atol=OBJ["atol"])
    np.testing.assert_allclose(ovar.numpy(), np.asarray(jovar), rtol=OBJ["rtol"], atol=OBJ["atol"])
    back = pen.matrix_to_transformed_space(orig)
    np.testing.assert_allclose(back.numpy(), np.asarray(jpen.matrix_to_transformed_space(jorig)),
                               rtol=OBJ["rtol"], atol=OBJ["atol"])
    np.testing.assert_allclose(back.numpy(), m, rtol=OBJ["rtol"], atol=OBJ["atol"])
    # Carried across from the reference's arrays, the same context.
    carried = convert.per_entity_normalization_from_numpy(
        np.asarray(jpen.factors), np.asarray(jpen.shifts), np.asarray(jpen.intercept_slots), device="cpu")
    for a, b in zip(carried, pen):
        assert torch.equal(a, b)


def test_batched_objective_takes_one_normalization_row_per_lane():
    tables = _tables(4, e=5, d_proj=8)
    f, s = _global(5)
    pen = project_normalization(NormalizationContext(torch.from_numpy(f), torch.from_numpy(s), D - 1),
                                torch.from_numpy(tables))
    rng = np.random.default_rng(6)
    e, n, d = 4, 20, tables.shape[1]
    rows = torch.tensor([3, 0, 2, 1])
    X = torch.from_numpy(rng.normal(size=(e, n, d)).astype(np.float32))
    y = torch.from_numpy((rng.uniform(size=(e, n)) < 0.5).astype(np.float32))
    data = LabeledData(X, y, torch.zeros(e, n), torch.ones(e, n))
    W = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32))
    V = torch.from_numpy(rng.normal(size=(e, d)).astype(np.float32))
    ctx = pen.rows_context(rows)
    f_b, g_b = objective.value_and_gradient(losses.LOGISTIC, W, data, ctx, 0.5)
    hv_b = objective.hessian_vector(losses.LOGISTIC, W, V, data, ctx, 0.5)
    diag_b = objective.hessian_diagonal(losses.LOGISTIC, W, data, ctx, 0.5)
    for lane in range(e):
        one = LabeledData(X[lane], y[lane], torch.zeros(n), torch.ones(n))
        c = NormalizationContext(pen.factors[rows[lane]], pen.shifts[rows[lane]], None)
        f1, g1 = objective.value_and_gradient(losses.LOGISTIC, W[lane], one, c, 0.5)
        torch.testing.assert_close(f_b[lane], f1, rtol=OBJ["rtol"], atol=OBJ["atol"])
        torch.testing.assert_close(g_b[lane], g1, rtol=OBJ["rtol"], atol=OBJ["atol"])
        torch.testing.assert_close(hv_b[lane], objective.hessian_vector(losses.LOGISTIC, W[lane], V[lane], one, c, 0.5),
                                   rtol=OBJ["rtol"], atol=OBJ["atol"])
        torch.testing.assert_close(diag_b[lane], objective.hessian_diagonal(losses.LOGISTIC, W[lane], one, c, 0.5),
                                   rtol=OBJ["rtol"], atol=OBJ["atol"])
