"""The port's projectors (game/projector.py) against the JAX package's:
index-map slot tables and projected planes bit-equal to the reference's
host route and its device route (PHOTON_DEVICE_ASSEMBLY=1, as its own tests
run it on the CPU), unseen entities, the back-projection round trip,
per-entity coefficients, a random projection carried across by convert.py,
and the projected shard's registration."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_ml_tpu.data.containers import SparseFeatures as JaxSparseFeatures
from photon_ml_tpu.game import projector as jax_pj
from photon_ml_tpu_torch import convert
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.data import game_dataset as gd
from photon_ml_tpu_torch.data.containers import SparseFeatures
from photon_ml_tpu_torch.game import projector as pj
from photon_ml_tpu_torch.types import ProjectorType

OBJ = PORT_TOLERANCES["objective"]


def _planes(seed=1, n=3000, d=64, k=5, n_entities=120):
    rng = np.random.default_rng(seed)
    idx = np.argsort(rng.uniform(size=(n, d)), axis=1)[:, :k].astype(np.int32)
    val = rng.normal(size=(n, k)).astype(np.float32)
    val[rng.uniform(size=val.shape) < 0.2] = 0.0  # zeros never enter a table
    ent = rng.integers(0, n_entities, size=n).astype(np.int64)
    return idx, val, d, ent, n_entities


@pytest.fixture(params=["host", "device"], ids=["jax_host", "jax_device"])
def jax_route(request, monkeypatch):
    monkeypatch.setenv("PHOTON_DEVICE_ASSEMBLY", "1" if request.param == "device" else "0")
    return request.param


def test_slot_tables_and_projected_planes_are_the_jax_ones(jax_route):
    idx, val, d, ent, e = _planes()
    # Rows of entity e (the unseen row) in the data: their entries project to zeros.
    ent[::17] = e
    jproj = jax_pj.IndexMapProjector.build(JaxSparseFeatures(jnp.asarray(idx), jnp.asarray(val), d), ent, e)
    assert (jproj._device_mapper is not None) == (jax_route == "device")
    proj = pj.IndexMapProjector.build(SparseFeatures(torch.from_numpy(idx), torch.from_numpy(val), d),
                                      torch.from_numpy(ent), e)
    np.testing.assert_array_equal(proj.slot_tables.numpy(), np.asarray(jproj.slot_tables))
    assert proj.projected_dim == jproj.projected_dim and proj.projected_dim % 8 == 0
    jout = jproj.project_features(JaxSparseFeatures(jnp.asarray(idx), jnp.asarray(val), d), ent)
    out = proj.project_features(SparseFeatures(torch.from_numpy(idx), torch.from_numpy(val), d),
                                torch.from_numpy(ent))
    assert out.indices.dtype == torch.int32 and out.dim == proj.projected_dim
    np.testing.assert_array_equal(out.indices.numpy(), np.asarray(jout.indices))
    np.testing.assert_array_equal(out.values.numpy(), np.asarray(jout.values))
    unseen = ent == e
    assert np.all(out.values.numpy()[unseen] == 0) and np.all(out.indices.numpy()[unseen] == 0)
    # The reference's host sweep on its own tables gives the same planes too.
    hout, hval = jproj.project_arrays(idx, val, ent)
    np.testing.assert_array_equal(out.indices.numpy(), hout)
    np.testing.assert_array_equal(out.values.numpy(), hval)


def test_validation_rows_project_through_the_training_tables():
    idx, val, d, ent, e = _planes(2)
    jproj = jax_pj.IndexMapProjector.build(JaxSparseFeatures(jnp.asarray(idx), jnp.asarray(val), d), ent, e)
    proj = pj.IndexMapProjector.build(SparseFeatures(torch.from_numpy(idx), torch.from_numpy(val), d),
                                      torch.from_numpy(ent), e)
    # Other rows: features an entity never had in training drop out.
    vidx, vval, _, vent, _ = _planes(3, n=800)
    vent[::5] = e
    jout = jproj.project_features(JaxSparseFeatures(jnp.asarray(vidx), jnp.asarray(vval), d), vent)
    out = proj.project_features(SparseFeatures(torch.from_numpy(vidx), torch.from_numpy(vval), d),
                                torch.from_numpy(vent))
    np.testing.assert_array_equal(out.indices.numpy(), np.asarray(jout.indices))
    np.testing.assert_array_equal(out.values.numpy(), np.asarray(jout.values))
    assert (out.values.numpy() == 0).sum() > (vval == 0).sum()


def test_back_projection_round_trip_and_entity_coefficients():
    idx, val, d, ent, e = _planes(4)
    jproj = jax_pj.IndexMapProjector.build(JaxSparseFeatures(jnp.asarray(idx), jnp.asarray(val), d), ent, e)
    proj = convert.index_map_projector_from_numpy(np.asarray(jproj.slot_tables), d, device="cpu")
    rng = np.random.default_rng(5)
    m = rng.normal(size=(e + 1, proj.projected_dim)).astype(np.float32)
    m[np.asarray(jproj.slot_tables) < 0] = 0.0
    back = proj.back_project_matrix(torch.from_numpy(m))
    np.testing.assert_array_equal(back.numpy(), np.asarray(jproj.back_project_matrix(jnp.asarray(m))))
    assert back.shape == (e + 1, d)
    np.testing.assert_array_equal(proj.project_matrix(back).numpy(), m)
    np.testing.assert_array_equal(proj.project_matrix(back).numpy(),
                                  np.asarray(jproj.project_matrix(jnp.asarray(np.asarray(back)))))
    for row in (0, 7, e):
        assert proj.entity_coefficients(torch.from_numpy(m), row) == jproj.entity_coefficients(
            jnp.asarray(m), row)
    with pytest.raises(ValueError):
        convert.index_map_projector_from_numpy(np.asarray(jproj.slot_tables)[:, ::-1], d, device="cpu")


def test_random_projector_carried_from_the_jax_matrix():
    idx, val, d, ent, e = _planes(6, n=500)
    jproj = jax_pj.RandomProjector.build(d, 16, seed=3)
    proj = convert.random_projector_from_numpy(np.asarray(jproj.matrix), device="cpu")
    feats = SparseFeatures(torch.from_numpy(idx), torch.from_numpy(val), d)
    got = proj.project_features(feats, torch.from_numpy(ent))
    ref = jproj.project_features(JaxSparseFeatures(jnp.asarray(idx), jnp.asarray(val), d), ent)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=OBJ["rtol"], atol=OBJ["atol"])
    w = np.random.default_rng(7).normal(size=(e + 1, 16)).astype(np.float32)
    back = proj.back_project_matrix(torch.from_numpy(w))
    np.testing.assert_allclose(back.numpy(), np.asarray(jproj.back_project_matrix(jnp.asarray(w))),
                               rtol=OBJ["rtol"], atol=OBJ["atol"])
    # The least-squares warm start recovers a projected model exactly (P has full column rank).
    np.testing.assert_allclose(proj.project_matrix(back).numpy(), w, atol=1e-3)
    # The port's own draw: N(0, 1/d) entries, the same matrix on every call.
    own = pj.RandomProjector.build(d, 16, seed=3, device=torch.device("cpu"))
    assert torch.equal(own.matrix, pj.RandomProjector.build(d, 16, seed=3, device=torch.device("cpu")).matrix)
    assert abs(float(own.matrix.var()) - 1 / 16) < 0.01


def test_project_shard_registers_and_repoints():
    idx, val, d, ent, e = _planes(8, n=600, n_entities=30)
    ds = gd.GameDataset.build({"g": SparseFeatures(torch.from_numpy(idx), torch.from_numpy(val), d)},
                              np.zeros(600), id_tags={"u": ent}, device="cpu")
    names = []
    for _ in range(3):
        red = gd.build_random_effect_dataset(ds, gd.RandomEffectDataConfig("u", "g"))
        ps = pj.project_shard(ds, red, ProjectorType.INDEX_MAP)
        assert red.feature_shard == ps.shard_name and isinstance(ps.projector, pj.IndexMapProjector)
        names.append(ps.shard_name)
    assert names == ["g@u", "g@u#2", "g@u#3"]
    red = gd.build_random_effect_dataset(ds, gd.RandomEffectDataConfig("u", "g"))
    assert pj.project_shard(ds, red, ProjectorType.IDENTITY).shard_name == "g"
    with pytest.raises(ValueError):
        pj.project_shard(ds, red, ProjectorType.RANDOM)
    # INDEX_MAP on a dense shard has nothing to compact: the identity.
    assert isinstance(pj.build_projector(ProjectorType.INDEX_MAP, torch.zeros(4, 3), torch.zeros(4), 1),
                      pj.IdentityProjector)
