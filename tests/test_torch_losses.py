"""The port's pointwise losses against the JAX package's, on one grid of
margins (large |z| included, for the stable softplus) and labels."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops import losses as jax_losses
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.ops import losses
from photon_ml_tpu_torch.types import TaskType

TOL = PORT_TOLERANCES["losses"]
NAMES = ["logistic", "squared", "poisson", "smoothed_hinge"]
PORT = {l.name: l for l in (losses.LOGISTIC, losses.SQUARED, losses.POISSON, losses.SMOOTHED_HINGE)}
REF = {
    l.name: l
    for l in (jax_losses.LOGISTIC, jax_losses.SQUARED, jax_losses.POISSON, jax_losses.SMOOTHED_HINGE)
}


def _grid(name):
    z = np.concatenate([
        np.linspace(-3.0, 3.0, 61),
        np.array([-0.999, -1e-3, 0.0, 1e-3, 0.5, 0.999, 1.0, 1.001]),
    ])
    if name == "logistic":  # softplus must stay finite and exact far out
        z = np.concatenate([z, np.array([-100.0, -60.0, -30.0, 30.0, 60.0, 100.0])])
    z = z.astype(np.float32)
    zz = np.repeat(z, 2)
    yy = np.tile(np.array([0.0, 1.0], np.float32), len(z))
    if name in ("squared", "poisson"):
        yy = np.tile(np.array([0.0, 2.5], np.float32), len(z))
    return zz, yy


@pytest.mark.parametrize("part", ["loss", "d1", "d2"])
@pytest.mark.parametrize("name", NAMES)
def test_pointwise_matches_jax(name, part):
    z, y = _grid(name)
    ref = np.asarray(getattr(REF[name], part)(jnp.asarray(z), jnp.asarray(y)))
    got = getattr(PORT[name], part)(torch.from_numpy(z), torch.from_numpy(y)).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, rtol=TOL["rtol"], atol=TOL["atol"])


def test_task_mapping_and_means():
    z = np.linspace(-5, 5, 21).astype(np.float32)
    for task in TaskType:
        jt = JaxTaskType(task.value)
        assert losses.loss_for_task(task).name == jax_losses.loss_for_task(jt).name
        assert losses.loss_for_task(task).has_hessian == jax_losses.loss_for_task(jt).has_hessian
        ref = np.asarray(jax_losses.mean_for_task(jt, jnp.asarray(z)))
        got = losses.mean_for_task(task, torch.from_numpy(z)).numpy()
        np.testing.assert_allclose(got, ref, rtol=TOL["rtol"], atol=TOL["atol"])


def test_loss_ids_cover_every_loss():
    # The CUDA kernels select the loss by these ids; each loss needs one.
    assert sorted(losses.LOSS_IDS) == sorted(NAMES)
    assert sorted(losses.LOSS_IDS.values()) == [0, 1, 2, 3]
