"""The port's random-effect assembly (data/device_assemble.py, torch ops on
the dataset's device) against the JAX package's two routes: its host loops
and its device `BlockAssembler` (PHOTON_DEVICE_ASSEMBLY=1, as the JAX
package's own tests run it on the CPU). Gathers, masks, entity rows, sample
rows and Pearson masks must be bit-equal."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from photon_ml_tpu.data import game_dataset as jax_gd
from photon_ml_tpu.data.containers import SparseFeatures as JaxSparseFeatures
from photon_ml_tpu_torch.data import device_assemble
from photon_ml_tpu_torch.data import game_dataset as gd
from photon_ml_tpu_torch.data.containers import SparseFeatures
from photon_ml_tpu_torch.timing import StageTimes


def _arrays(seed=1, n=4000, d=48, k=4, n_entities=250, skew=True, dense=False):
    rng = np.random.default_rng(seed)
    # Distinct features within a row (the port refuses duplicates).
    idx = np.argsort(rng.uniform(size=(n, d)), axis=1)[:, :k].astype(np.int32)
    val = rng.normal(size=(n, k)).astype(np.float32)
    val[rng.uniform(size=val.shape) < 0.15] = 0.0
    ents = rng.integers(0, n_entities, size=n).astype(str)
    if skew:  # one very frequent entity exercises the reservoir
        ents[: n // 4] = "0"
    labels = (rng.uniform(size=n) < 0.4).astype(np.float32)
    X = rng.normal(size=(n, 6)).astype(np.float32) if dense else None
    return idx, val, d, ents, labels, X


def _both(arrays, cfg_kw, monkeypatch, device_route):
    idx, val, d, ents, labels, X = arrays
    shards = {"g": JaxSparseFeatures(idx, val, d)}
    if X is not None:
        shards["x"] = X
    jds = jax_gd.GameDataset.build(shards, labels, id_tags={"e": ents})
    monkeypatch.setenv("PHOTON_DEVICE_ASSEMBLY", "1" if device_route else "0")
    shard = cfg_kw.pop("shard", "g")
    jred = jax_gd._build_random_effect_dataset(jds, jax_gd.RandomEffectDataConfig("e", shard, **cfg_kw))
    pshards = {"g": SparseFeatures(torch.from_numpy(idx), torch.from_numpy(val), d)}
    if X is not None:
        pshards["x"] = X
    ds = gd.GameDataset.build(pshards, labels, id_tags={"e": ents}, device="cpu")
    times = StageTimes()
    red = gd.build_random_effect_dataset(ds, gd.RandomEffectDataConfig("e", shard, **cfg_kw), times)
    assert times.get_note("re_path") == "device" and times.get("re_build") >= times.get("re_device") > 0
    return red, jred


def _assert_same(red, jred):
    assert red.entity_index == jred.entity_index
    assert len(red.buckets) == len(jred.buckets)
    for i, (b, jb) in enumerate(zip(red.buckets, jred.buckets)):
        np.testing.assert_array_equal(b.gather.numpy(), np.asarray(jb.gather), err_msg=f"gather {i}")
        np.testing.assert_array_equal(b.mask.numpy(), np.asarray(jb.mask), err_msg=f"mask {i}")
        np.testing.assert_array_equal(b.entity_rows.numpy(), np.asarray(jb.entity_rows),
                                      err_msg=f"entity rows {i}")
    np.testing.assert_array_equal(red.sample_entity_rows.numpy(), np.asarray(jred.sample_entity_rows))
    assert red.num_active_samples == jred.num_active_samples
    assert red.num_passive_samples == jred.num_passive_samples


CASES = {
    "no_caps": dict(),
    "reservoir": dict(active_upper_bound=16),
    "lower_bound": dict(active_lower_bound=5),
    "both_bounds": dict(active_upper_bound=16, active_lower_bound=3),
    "chunked": dict(active_upper_bound=8, max_block_cells=1 << 9),
}


@pytest.mark.parametrize("device_route", [False, True], ids=["jax_host", "jax_device"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_entity_blocks_are_the_jax_blocks(case, device_route, monkeypatch):
    red, jred = _both(_arrays(), dict(CASES[case]), monkeypatch, device_route)
    _assert_same(red, jred)


@pytest.mark.parametrize("device_route", [False, True], ids=["jax_host", "jax_device"])
def test_a_single_entity(device_route, monkeypatch):
    idx, val, d, ents, labels, X = _arrays(seed=3, n=300)
    ents[:] = "only"
    red, jred = _both((idx, val, d, ents, labels, X), dict(active_upper_bound=64), monkeypatch,
                      device_route)
    _assert_same(red, jred)
    assert red.num_entities == 1 and red.num_active_samples == 64


@pytest.mark.parametrize("shard", ["g", "x"], ids=["sparse", "dense"])
def test_pearson_masks_are_the_jax_masks(shard, monkeypatch):
    arrays = _arrays(seed=5, n=3000, n_entities=60, dense=True)
    cfg = dict(active_upper_bound=40, num_features_to_samples_ratio_upper_bound=0.2, shard=shard)
    red, jred = _both(arrays, cfg, monkeypatch, device_route=False)
    _assert_same(red, jred)
    assert jred.feature_mask is not None
    np.testing.assert_array_equal(red.feature_mask.numpy(), np.asarray(jred.feature_mask))
    assert 0 < float(red.feature_mask[:-1].mean()) < 1


def test_row_priorities_wrap_like_the_reference_uint64():
    codes = np.random.default_rng(0).integers(0, 1 << 20, size=5000)
    got = device_assemble.row_priorities(torch.from_numpy(codes)).numpy()
    want = jax_gd._row_priorities(codes, len(codes))
    np.testing.assert_array_equal((got ^ np.int64(-(1 << 63))).view(np.uint64), want)
    # Signed order of the flipped priorities is the unsigned order.
    np.testing.assert_array_equal(np.argsort(got, kind="stable"), np.argsort(want, kind="stable"))
