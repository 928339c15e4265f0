"""The port's online serving engine, on the CPU.

The cases of tests/test_serving.py, on the port: every score the engine,
the batcher or the fault-degraded per-request fallback gives is bit-equal
to the port's `GameTransformer.transform` on the same dense rows, from any
bucket (the margins reduce with `game.model.row_sum`, whose order depends
on the width alone). Then the port against the JAX package: the same numpy
model and requests through the JAX `ServingEngine` and the port's, within
PORT_TOLERANCES["convert_scores"], and a model directory saved by each
package served by the other.
"""

from __future__ import annotations

import os
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.data.index_map import IndexMap as JaxIndexMap
from photon_ml_tpu.game.model import Coefficients as JaxCoefficients
from photon_ml_tpu.game.model import FixedEffectModel as JaxFixedEffectModel
from photon_ml_tpu.game.model import GameModel as JaxGameModel
from photon_ml_tpu.game.model import RandomEffectModel as JaxRandomEffectModel
from photon_ml_tpu.io import model_bridge as jax_model_bridge
from photon_ml_tpu.io import model_store as jax_model_store
from photon_ml_tpu.serving import ScoreRequest as JaxScoreRequest
from photon_ml_tpu.serving import ServingBundle as JaxServingBundle
from photon_ml_tpu.serving import ServingEngine as JaxServingEngine
from photon_ml_tpu.serving import load_bundle as jax_load_bundle
from photon_ml_tpu.transformers.game_transformer import CoordinateScoringSpec as JaxSpec
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.data.game_dataset import GameDataset
from photon_ml_tpu_torch.data.index_map import INTERCEPT_KEY, IndexMap
from photon_ml_tpu_torch.game.model import (
    Coefficients,
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
    row_sum,
)
from photon_ml_tpu_torch.io import model_bridge, model_store
from photon_ml_tpu_torch.io.avro_data import FeatureShardConfig
from photon_ml_tpu_torch.serving import ScoreRequest, ServingBundle, ServingEngine, load_bundle
from photon_ml_tpu_torch.serving.bundle import request_from_record
from photon_ml_tpu_torch.transformers.game_transformer import CoordinateScoringSpec, GameTransformer
from photon_ml_tpu_torch.types import TaskType
from photon_ml_tpu_torch.utils import faults, telemetry

pytestmark = pytest.mark.serving

TASK = TaskType.LOGISTIC_REGRESSION
D_FE, D_RE, N_ENTITIES = 12, 5, 6
TOL = PORT_TOLERANCES["convert_scores"]


@pytest.fixture(autouse=True)
def _port_fault_hygiene():
    """The port's fault plan and counters are its own process globals: each
    test starts and ends with none armed and every count at zero."""
    faults.clear()
    telemetry.METRICS.reset()
    yield
    faults.clear()
    telemetry.METRICS.reset()


def _arrays(rng, n, entity_ids=None):
    X = rng.normal(size=(n, D_FE)).astype(np.float32)
    Xe = rng.normal(size=(n, D_RE)).astype(np.float32)
    if entity_ids is None:
        entity_ids = rng.integers(0, N_ENTITIES + 3, size=n)  # some >= E: cold
    offsets = rng.normal(size=n).astype(np.float32)
    w = rng.normal(size=D_FE).astype(np.float32)
    matrix = np.zeros((N_ENTITIES + 1, D_RE), np.float32)
    matrix[:N_ENTITIES] = rng.normal(size=(N_ENTITIES, D_RE))
    return dict(X=X, Xe=Xe, ids=np.asarray(entity_ids), offsets=offsets, w=w, matrix=matrix)


def _fixture(rng, n=13, entity_ids=None):
    """(model, specs, dataset, requests) on the CPU: one FE and one RE
    coordinate over dense shards, some entities unseen."""
    a = _arrays(rng, n, entity_ids)
    model = GameModel({"fixed": FixedEffectModel(Coefficients(torch.from_numpy(a["w"])), TASK),
                       "per-e": RandomEffectModel(torch.from_numpy(a["matrix"]), None, TASK)})
    specs = {"fixed": CoordinateScoringSpec(shard="g"),
             "per-e": CoordinateScoringSpec(shard="re", random_effect_type="eid",
                                            entity_index={str(i): i for i in range(N_ENTITIES)})}
    ds = GameDataset.build({"g": a["X"], "re": a["Xe"]}, np.zeros(n, np.float32), offsets=a["offsets"],
                           id_tags={"eid": a["ids"].astype(str)}, device="cpu")
    reqs = [ScoreRequest(features={"g": a["X"][i], "re": a["Xe"][i]}, entity_ids={"eid": str(a["ids"][i])},
                         offset=float(a["offsets"][i]), uid=str(i)) for i in range(n)]
    return model, specs, ds, reqs


def _engine(model, specs, max_batch, **kw):
    return ServingEngine(ServingBundle.from_model(model, specs, TASK, device="cpu"), max_batch=max_batch, **kw)


def _ref(model, specs, ds):
    return GameTransformer(model, specs, TASK).transform(ds).scores.numpy()


def _scores(results):
    return np.asarray([r.score for r in results], np.float32)


def _means(results):
    return np.asarray([r.mean for r in results], np.float32)


# ----------------------------------------------------------------- the row sum


@pytest.mark.parametrize("d", [1, 5, 16, 201, 512])
def test_row_sum_is_batch_invariant_and_a_sum(d):
    """Each row's sum has the same bits alone as inside 4,096 rows, and is a
    float32 sum of the row."""
    P = torch.from_numpy(np.random.default_rng(d).normal(size=(4096, d)).astype(np.float32))
    full = row_sum(P)
    for b in (1, 3, 256):
        assert torch.equal(torch.cat([row_sum(P[i:i + b]) for i in range(0, 64, b)])[:64], full[:64])
    np.testing.assert_allclose(full.double().numpy(), P.double().sum(-1).numpy(), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------- engine parity


class TestEngineParity:
    def test_engine_matches_transformer_bitwise(self, rng):
        model, specs, ds, reqs = _fixture(rng)
        ref = GameTransformer(model, specs, TASK).transform(ds)
        with _engine(model, specs, 16) as eng:
            res = eng.score_batch(reqs)
        assert (_scores(res) == ref.scores.numpy()).all()
        assert (_means(res) == ref.means.numpy()).all()

    def test_every_bucket_size_matches(self, rng):
        model, specs, ds, reqs = _fixture(rng, n=8)
        ref = _ref(model, specs, ds)
        with _engine(model, specs, 32) as eng:
            singles = np.concatenate([_scores(eng.score_batch([r])) for r in reqs])
            pairs = np.concatenate([_scores(eng.score_batch(reqs[i:i + 2])) for i in range(0, 8, 2)])
            triple = _scores(eng.score_batch(reqs[:3]))
            full = _scores(eng.score_batch(reqs))
        assert (singles == ref).all() and (pairs == ref).all()
        assert (triple == ref[:3]).all() and (full == ref).all()

    def test_duplicate_entities_in_one_batch(self, rng):
        model, specs, ds, reqs = _fixture(rng, n=7, entity_ids=[2, 2, 2, 0, 2, 1, 1])
        with _engine(model, specs, 8) as eng:
            assert (_scores(eng.score_batch(reqs)) == _ref(model, specs, ds)).all()

    def test_all_cold_start_batch_is_fixed_effect_only(self, rng):
        model, specs, ds, reqs = _fixture(rng, n=4, entity_ids=[99, 100, 101, 102])
        fe_ds = GameDataset.build({"g": ds.shards["g"].numpy()}, np.zeros(4, np.float32),
                                  offsets=ds.offsets.numpy(), device="cpu")
        fe_ref = GameTransformer(GameModel({"fixed": model["fixed"]}), {"fixed": specs["fixed"]},
                                 TASK).transform(fe_ds).scores.numpy()
        with _engine(model, specs, 8) as eng:
            res = eng.score_batch(reqs)
        assert all(r.cold_start and r.n_cold == 1 for r in res)
        assert (_scores(res) == _ref(model, specs, ds)).all()
        assert (_scores(res) == fe_ref).all()

    def test_missing_entity_id_is_cold(self, rng):
        model, specs, _, _ = _fixture(rng, n=2)
        req = ScoreRequest(features={"g": np.zeros(D_FE, np.float32), "re": np.ones(D_RE, np.float32)})
        with _engine(model, specs, 4) as eng:
            assert eng.score_batch([req])[0].cold_start

    def test_shared_shard_coordinates_match(self, rng):
        n = 7
        X = rng.normal(size=(n, D_RE)).astype(np.float32)
        ids = rng.integers(0, N_ENTITIES, size=n)
        w = rng.normal(size=D_RE).astype(np.float32)
        matrix = np.zeros((N_ENTITIES + 1, D_RE), np.float32)
        matrix[:N_ENTITIES] = rng.normal(size=(N_ENTITIES, D_RE))
        model = GameModel({"fixed": FixedEffectModel(Coefficients(torch.from_numpy(w)), TASK),
                           "per-e": RandomEffectModel(torch.from_numpy(matrix), None, TASK)})
        specs = {"fixed": CoordinateScoringSpec(shard="g"),
                 "per-e": CoordinateScoringSpec(shard="g", random_effect_type="eid",
                                                entity_index={str(i): i for i in range(N_ENTITIES)})}
        ds = GameDataset.build({"g": X}, np.zeros(n, np.float32), id_tags={"eid": ids.astype(str)},
                               device="cpu")
        reqs = [ScoreRequest(features={"g": X[i]}, entity_ids={"eid": str(ids[i])}) for i in range(n)]
        with _engine(model, specs, 8) as eng:
            assert (_scores(eng.score_batch(reqs)) == _ref(model, specs, ds)).all()

    def test_oversized_batch_splits(self, rng):
        model, specs, ds, reqs = _fixture(rng, n=13)
        with _engine(model, specs, 4) as eng:
            assert (_scores(eng.score_batch(reqs)) == _ref(model, specs, ds)).all()


class TestCompileSet:
    def test_zero_recompiles_after_warmup(self, rng):
        model, specs, _, reqs = _fixture(rng, n=13)
        with _engine(model, specs, 16) as eng:
            assert eng.buckets == (1, 2, 4, 8, 16)
            assert eng.recompiles_after_warmup is None
            assert eng.warmup() == len(eng.buckets)
            for size in (1, 3, 13, 7, 2, 16, 5, 11):
                eng.score_batch(reqs[:size])
            assert eng.recompiles_after_warmup == 0
            assert eng.metrics()["recompiles_after_warmup"] == 0
            assert eng.compiles == len(eng.buckets)

    def test_padding_waste_accounted(self, rng):
        model, specs, _, reqs = _fixture(rng, n=13)
        with _engine(model, specs, 16) as eng:
            eng.score_batch(reqs[:3])  # bucket 4: one padded slot
            m = eng.metrics()
        assert m["padding_waste"] == pytest.approx(0.25)

    def test_default_ceiling_and_static_buffer_bytes(self, rng):
        """No max_batch means the reference's 256 (nine buckets); the swap's
        budget charges every bucket's static inputs and output."""
        model, specs, _, _ = _fixture(rng, n=2)
        with _engine(model, specs, None) as eng:
            assert eng.buckets == (1, 2, 4, 8, 16, 32, 64, 128, 256)
            want = sum(4 * b + 4 * b * (D_FE + D_RE) + 8 * b + 8 * b for b in eng.buckets)
            assert eng.warmup_buffer_bytes() == want
            eng.warmup()
            assert sum(p.nbytes() for p in eng._state.programs.values()) == want


class TestBatcher:
    def test_batcher_matches_transformer_bitwise(self, rng):
        model, specs, ds, reqs = _fixture(rng, n=13)
        with _engine(model, specs, 4) as eng:
            with eng.batcher(max_wait_ms=1.0) as b:
                assert (_scores(b.score_all(reqs)) == _ref(model, specs, ds)).all()
                m = b.metrics()
        assert m["completed"] == 13 and m["degraded_batches"] == 0
        assert m["p50_ms"] is not None and m["p99_ms"] is not None

    def test_deadline_flushes_partial_batch(self, rng):
        model, specs, _, reqs = _fixture(rng, n=2)
        with _engine(model, specs, 64) as eng:
            with eng.batcher(max_wait_ms=5.0) as b:
                t0 = time.monotonic()
                res = b.submit(reqs[0]).result(timeout=20)
                wall = time.monotonic() - t0
        assert isinstance(res.score, float) and wall < 5.0

    def test_flush_thread_joined_on_engine_close(self, rng):
        model, specs, _, _ = _fixture(rng, n=2)
        eng = _engine(model, specs, 4)
        b = eng.batcher(max_wait_ms=1.0)
        assert any(t.name == "photon-serving-flush" for t in threading.enumerate())
        eng.close()
        assert b.closed
        assert not any(t.name == "photon-serving-flush" and t.is_alive() for t in threading.enumerate())

    def test_close_drains_pending(self, rng):
        model, specs, _, reqs = _fixture(rng, n=13)
        eng = _engine(model, specs, 4)
        b = eng.batcher(max_wait_ms=10_000.0)
        futures = [b.submit(r) for r in reqs[:3]]
        eng.close()
        assert all(isinstance(f.result(timeout=20).score, float) for f in futures)

    def test_submit_after_close_raises(self, rng):
        model, specs, _, reqs = _fixture(rng, n=2)
        eng = _engine(model, specs, 4)
        b = eng.batcher()
        eng.close()
        with pytest.raises(RuntimeError):
            b.submit(reqs[0])
        with pytest.raises(RuntimeError):
            eng.batcher()

    def test_cancelled_future_does_not_kill_flush_thread(self, rng):
        model, specs, _, reqs = _fixture(rng, n=13)
        with _engine(model, specs, 4) as eng:
            with eng.batcher(max_wait_ms=60_000.0, max_batch=4) as b:
                doomed = b.submit(reqs[0])
                assert doomed.cancel()
                later = [b.submit(r) for r in reqs[1:5]]
                results = [f.result(timeout=20) for f in later]
        assert all(isinstance(r.score, float) for r in results)
        assert doomed.cancelled()

    @pytest.mark.parametrize("max_batch", [8, 0, -1])
    def test_batcher_rejects_a_bad_max_batch(self, rng, max_batch):
        model, specs, _, _ = _fixture(rng, n=2)
        with _engine(model, specs, 4) as eng:
            with pytest.raises(ValueError):
                eng.batcher(max_batch=max_batch)


@pytest.mark.chaos
class TestServingFaultDomain:
    @pytest.mark.parametrize("spec", ["score:1", "lookup:1"])
    def test_a_fault_degrades_bitwise(self, rng, spec):
        model, specs, ds, reqs = _fixture(rng, n=9)
        with _engine(model, specs, 16) as eng:
            eng.warmup()
            with faults.inject(spec):
                with eng.batcher(max_wait_ms=1.0) as b:
                    res = b.score_all(reqs)
        assert (_scores(res) == _ref(model, specs, ds)).all()
        assert faults.COUNTERS.get("serving_degraded_batches") == 1
        assert faults.COUNTERS.get("injected_faults") == 1

    def test_odd_sizes_and_cold_under_probability_faults(self, rng):
        model, specs, ds, reqs = _fixture(rng, n=7, entity_ids=[0, 99, 1, 1, 99, 2, 3])
        with _engine(model, specs, 4) as eng:
            with faults.inject("score:p0.3,lookup:p0.2", seed=7):
                with eng.batcher(max_wait_ms=1.0) as b:
                    res = b.score_all(reqs)
        assert (_scores(res) == _ref(model, specs, ds)).all()

    def test_warmup_immune_to_armed_faults(self, rng):
        model, specs, ds, reqs = _fixture(rng, n=5)
        with faults.inject("score:1,lookup:1"):
            with _engine(model, specs, 8) as eng:
                eng.warmup()
                with eng.batcher(max_wait_ms=1.0) as b:
                    res = b.score_all(reqs)
        assert (_scores(res) == _ref(model, specs, ds)).all()
        assert faults.COUNTERS.get("serving_degraded_batches") >= 1

    def test_non_transient_error_fails_futures_not_thread(self, rng):
        model, specs, _, reqs = _fixture(rng, n=3)
        eng = _engine(model, specs, 4)

        def broken(requests, **kw):
            raise ValueError("programming error")

        eng.score_batch = broken  # type: ignore[assignment]
        with eng.batcher(max_wait_ms=1.0) as b:
            with pytest.raises(ValueError):
                b.submit(reqs[0]).result(timeout=20)
            assert b.metrics()["failed"] == 1
        eng.close()

    def test_lost_shard_answers_fe_only_then_restages_bitwise(self, rng):
        """A LOST shard's entities answer from the pinned zero row (counted,
        DEGRADED naming the shard); an in-place restage brings the same bits
        back with no program rebuilt."""
        model, specs, ds, reqs = _fixture(rng, n=9, entity_ids=[0, 1, 2, 3, 4, 5, 0, 1, 99])
        fe_ds = GameDataset.build({"g": ds.shards["g"].numpy()}, np.zeros(9, np.float32),
                                  offsets=ds.offsets.numpy(), device="cpu")
        fe_ref = GameTransformer(GameModel({"fixed": model["fixed"]}), {"fixed": specs["fixed"]},
                                 TASK).transform(fe_ds).scores.numpy()
        host_rows = model["per-e"].coefficients_matrix.numpy().copy()
        with _engine(model, specs, 16) as eng:
            eng.warmup()
            before = _scores(eng.score_batch(reqs))
            assert eng.mark_shard_lost("per-e", 0) == (0, N_ENTITIES + 1)
            lost = eng.score_batch(reqs)
            assert (_scores(lost) == fe_ref).all()
            assert [r.n_lost for r in lost] == [1] * 8 + [0]  # the cold start is not a loss
            assert eng.health.degraded_reasons == ["shard_loss:per-e/0"]
            eng.bundle.coordinates["per-e"].params.zero_()  # the resident rows are gone
            assert eng.restage_shard("per-e", 0, rows=host_rows) == host_rows.nbytes
            after = _scores(eng.score_batch(reqs))
            m = eng.metrics()
        assert (after == before).all()
        assert m["sharding"]["shard_loss_fallbacks"] == 8 and m["sharding"]["shards_lost"] == 0
        assert m["recompiles_after_warmup"] == 0

    def test_watchdog_trip_answers_fe_only_and_clears(self, rng):
        """A dispatch past the watchdog deadline raises DeviceHang (counted,
        DEGRADED); the batcher answers that batch FE-only; the next guarded
        dispatch inside its deadline clears the reason."""
        model, specs, ds, reqs = _fixture(rng, n=4, entity_ids=[0, 1, 2, 3])
        fe_ds = GameDataset.build({"g": ds.shards["g"].numpy()}, np.zeros(4, np.float32),
                                  offsets=ds.offsets.numpy(), device="cpu")
        fe_ref = GameTransformer(GameModel({"fixed": model["fixed"]}), {"fixed": specs["fixed"]},
                                 TASK).transform(fe_ds).scores.numpy()
        with _engine(model, specs, 4, watchdog_ms_override=20.0) as eng:
            eng.warmup()
            inner = eng._dispatch_device

            def stuck(packed, state):
                time.sleep(0.2)
                return inner(packed, state)

            eng._dispatch_device = stuck
            with eng.batcher(max_wait_ms=60_000.0) as b:  # only a full batch of 4 flushes
                res = b.score_all(reqs)
                assert eng.health.degraded_reasons == ["device_hang"]
                eng._dispatch_device = inner
                again = b.score_all(reqs)
        assert all(r.fe_only for r in res) and (_scores(res) == fe_ref).all()
        assert faults.COUNTERS.get("watchdog_trips") == 1
        assert not any(r.fe_only for r in again) and (_scores(again) == _ref(model, specs, ds)).all()
        assert eng.health.degraded_reasons == []


# ---------------------------------------------------------------------- bundle


class TestBundle:
    def test_projected_coordinate_rejected(self, rng):
        model, specs, _, _ = _fixture(rng, n=2)
        specs = dict(specs)
        specs["per-e"] = CoordinateScoringSpec(shard="re", random_effect_type="eid",
                                               entity_index=specs["per-e"].entity_index,
                                               projector=object())
        with pytest.raises(ValueError, match="projected space"):
            ServingBundle.from_model(model, specs, TASK, device="cpu")

    # The two-tier store is ported (tests/test_torch_two_tier.py); its
    # case here asks it for a rank's row shard, which is still item 9c.
    @pytest.mark.parametrize("kw", [{"mesh": object()}, {"hot_rows": 4, "row_shard": True},
                                    {"row_shard": True}])
    def test_unported_stores_raise_naming_item_9(self, rng, kw):
        model, specs, _, _ = _fixture(rng, n=2)
        if kw.pop("row_shard", False):  # a rank's store: fewer rows than the index has entities
            m = model["per-e"]
            model = GameModel({"fixed": model["fixed"],
                               "per-e": RandomEffectModel(m.coefficients_matrix[2:], None, TASK)})
        with pytest.raises(NotImplementedError, match="item 9"):
            ServingBundle.from_model(model, specs, TASK, device="cpu", **kw)

    @pytest.mark.parametrize("knob,value", [("PHOTON_SERVING_ENTITY_SHARD", "1"),
                                            ("PHOTON_SERVING_HOT_ROWS", "16")])
    def test_unported_store_knobs_raise_in_load_bundle(self, rng, tmp_path, monkeypatch, knob, value):
        monkeypatch.setenv(knob, value)
        if knob == "PHOTON_SERVING_HOT_ROWS":
            # Ported since: the knob stages the random effect two-tier (16
            # hot rows, capped at the entity count) and the answers keep the
            # single-tier bits.
            model, specs, ds, reqs = _fixture(rng, n=9)
            index_maps = {"g": IndexMap.from_feature_names([f"f{i}" for i in range(D_FE)]),
                          "re": IndexMap.from_feature_names([f"r{i}" for i in range(D_RE)])}
            mdir = _save_port_model(tmp_path / "model", model, specs, index_maps)
            bundle = load_bundle(str(mdir), device="cpu")
            store = bundle.coordinates["per-e"].store
            assert store is not None and store.capacity == N_ENTITIES
            with ServingEngine(bundle, max_batch=16) as eng:
                monkeypatch.delenv(knob)
                with ServingEngine(load_bundle(str(mdir), device="cpu"), max_batch=16) as single:
                    assert (_scores(eng.score_batch(reqs)) == _scores(single.score_batch(reqs))).all()
            bundle.release()
            return
        with pytest.raises(NotImplementedError, match="item 9"):
            load_bundle(str(tmp_path), device="cpu")

    def test_unported_kind_raises(self, rng):
        model, specs, _, reqs = _fixture(rng, n=2)
        eng = _engine(model, specs, 2)
        eng._state.kinds = ("fe", "re_i8")
        with pytest.raises(ValueError, match="not ported"):
            eng.score_batch(reqs[:1])
        eng.close()
        # The orchestrator is ported for one card (serving/reshard.py); a
        # reshard onto a mesh of cards is still item 9c.
        with pytest.raises(NotImplementedError, match="item 9"):
            eng.reshard_orchestrator.reshard(object())

    def test_cuda_without_a_card_raises(self, rng, monkeypatch):
        model, specs, _, _ = _fixture(rng, n=2)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="is_available"):
            ServingBundle.from_model(model, specs, TASK)

    def test_artifact_save_load_serve_parity(self, rng, tmp_path):
        model, specs, ds, reqs = _fixture(rng, n=9)
        index_maps = {"g": IndexMap.from_feature_names([f"f{i}" for i in range(D_FE)]),
                      "re": IndexMap.from_feature_names([f"r{i}" for i in range(D_RE)])}
        mdir = _save_port_model(tmp_path / "model", model, specs, index_maps)
        bundle = load_bundle(str(mdir), device="cpu")
        art = model_store.load_game_model(str(mdir), index_maps)
        model2, specs2 = model_bridge.game_model_from_artifact(art, "cpu")
        ref = GameTransformer(model2, specs2, art.task).transform(ds).scores.numpy()
        with ServingEngine(bundle, max_batch=16) as eng:
            assert (_scores(eng.score_batch(reqs)) == ref).all()
        assert bundle.upload_bytes == (D_FE + (N_ENTITIES + 1) * D_RE) * 4
        assert bundle.provenance["origin"] == "artifact"

    def test_encode_request_named_features(self, rng):
        model, specs, _, _ = _fixture(rng, n=2)
        imap = IndexMap.from_feature_names([f"f{i}" for i in range(D_FE)])
        bundle = ServingBundle.from_model(model, specs, TASK, device="cpu", index_maps={"g": imap})
        idx, vals = bundle.encode_request({"g": {"f0": 1.5, "f3": -2.0, "nope": 9.0}}, uid="x").features["g"]
        assert sorted(idx.tolist()) == sorted([imap.get_index("f0"), imap.get_index("f3")])
        assert set(vals.tolist()) == {1.5, -2.0}

    def test_sparse_duplicate_indices_accumulate(self, rng):
        model, specs, _, _ = _fixture(rng, n=2)
        req = ScoreRequest(features={"g": (np.asarray([1, 1, 2], np.int32),
                                           np.asarray([0.5, 0.25, 1.0], np.float32))},
                           entity_ids={"eid": "0"})
        dense = np.zeros(D_FE, np.float32)
        dense[1], dense[2] = 0.75, 1.0
        with _engine(model, specs, 4) as eng:
            sparse_score = eng.score_batch([req])[0].score
            dense_score = eng.score_batch([ScoreRequest(features={"g": dense}, entity_ids={"eid": "0"})])[0].score
        assert sparse_score == dense_score

    def test_request_from_record_applies_intercept(self, rng):
        model, specs, _, _ = _fixture(rng, n=2)
        imap = IndexMap.from_feature_names([f"f{i}" for i in range(D_FE - 1)], add_intercept=True)
        bundle = ServingBundle.from_model(model, specs, TASK, device="cpu", index_maps={"g": imap})
        rec = {"uid": "u1", "features": [{"name": "f0", "term": "", "value": 2.0}], "eid": "3"}
        req = request_from_record(bundle, rec, {"g": FeatureShardConfig(("features",), True)})
        assert imap.get_index(INTERCEPT_KEY) in req.features["g"][0].tolist()
        assert req.entity_ids["eid"] == "3" and req.uid == "u1"

    def test_request_from_record_missing_id_resolves_like_ingest(self, rng):
        model, specs, _, _ = _fixture(rng, n=2)
        specs = dict(specs)
        specs["per-e"] = CoordinateScoringSpec(shard="re", random_effect_type="eid",
                                               entity_index={"": 0, "m1": 1})
        m = model["per-e"].coefficients_matrix[:3]
        model = GameModel({"fixed": model["fixed"], "per-e": RandomEffectModel(m, None, TASK)})
        bundle = ServingBundle.from_model(
            model, specs, TASK, device="cpu",
            index_maps={"g": IndexMap.from_feature_names([f"f{i}" for i in range(D_FE)])})
        req = request_from_record(bundle, {"features": [], "metadataMap": None},
                                  {"g": FeatureShardConfig(("features",), False)})
        assert req.entity_ids["eid"] == ""
        rows, cold = bundle.coordinates["per-e"].lookup_rows([req.entity_ids["eid"]])
        assert rows[0] == 0 and cold == 0


# ------------------------------------------------------- against the JAX package


def _jax_model(model):
    jt = JaxTaskType.LOGISTIC_REGRESSION
    return JaxGameModel({
        "fixed": JaxFixedEffectModel(JaxCoefficients(jnp.asarray(model["fixed"].coefficients.means.numpy())), jt),
        "per-e": JaxRandomEffectModel(jnp.asarray(model["per-e"].coefficients_matrix.numpy()), None, jt)})


def _jax_specs(specs):
    return {"fixed": JaxSpec(shard="g"),
            "per-e": JaxSpec(shard="re", random_effect_type="eid", entity_index=dict(specs["per-e"].entity_index))}


def _jax_requests(reqs):
    return [JaxScoreRequest(features=dict(r.features), entity_ids=dict(r.entity_ids), offset=r.offset,
                            uid=r.uid) for r in reqs]


def _save_port_model(mdir, model, specs, index_maps):
    art = model_bridge.artifact_from_game_model(model, specs, TASK)
    model_store.save_game_model(str(mdir), art, index_maps)
    os.makedirs(mdir / "feature-indexes", exist_ok=True)
    for shard, imap in index_maps.items():
        imap.save(str(mdir / "feature-indexes" / f"{shard}.json"))
    return mdir


def test_the_port_engine_matches_the_jax_engine(rng):
    """The same numpy model and requests (odd sizes, duplicates, cold
    starts, sparse payloads) through both packages' engines and batchers."""
    model, specs, _, reqs = _fixture(rng, n=37)
    reqs[5] = ScoreRequest(features={"g": (np.asarray([1, 1, 7], np.int32), np.asarray([0.5, 0.25, -1.0], np.float32))},
                           entity_ids={"eid": "2"}, offset=0.5, uid="sparse")
    with JaxServingEngine(JaxServingBundle.from_model(_jax_model(model), _jax_specs(specs),
                                                      JaxTaskType.LOGISTIC_REGRESSION), max_batch=16) as jeng:
        jeng.warmup()
        theirs = jeng.score_batch(_jax_requests(reqs))
    with _engine(model, specs, 16) as eng:
        eng.warmup()
        with eng.batcher(max_wait_ms=1.0) as b:
            ours = b.score_all(reqs)
    np.testing.assert_allclose(_scores(ours), _scores(theirs), rtol=TOL["rtol"], atol=TOL["atol"])
    np.testing.assert_allclose(_means(ours), _means(theirs), rtol=TOL["rtol"], atol=TOL["atol"])
    assert [r.cold_start for r in ours] == [r.cold_start for r in theirs]
    assert [r.uid for r in ours] == [r.uid for r in theirs]


def test_model_directories_serve_across_packages(rng, tmp_path):
    """A model directory saved by the JAX package's store is served by the
    port, and the port's by the JAX package, to the same scores."""
    model, specs, _, reqs = _fixture(rng, n=21)
    names = {"g": [f"f{i}" for i in range(D_FE)], "re": [f"r{i}" for i in range(D_RE)]}
    port_dir = _save_port_model(tmp_path / "port", model, specs,
                                {s: IndexMap.from_feature_names(v) for s, v in names.items()})
    jax_maps = {s: JaxIndexMap.from_feature_names(v) for s, v in names.items()}
    jax_dir = tmp_path / "jax"
    jax_art = jax_model_bridge.artifact_from_game_model(_jax_model(model), _jax_specs(specs),
                                                        JaxTaskType.LOGISTIC_REGRESSION)
    jax_model_store.save_game_model(str(jax_dir), jax_art, jax_maps)
    os.makedirs(jax_dir / "feature-indexes")
    for shard, imap in jax_maps.items():
        imap.save(str(jax_dir / "feature-indexes" / f"{shard}.json"))
    scores = {}
    for pkg, mdir in (("port", port_dir), ("jax", jax_dir)):
        with ServingEngine(load_bundle(str(mdir), device="cpu"), max_batch=8) as eng:
            scores["port", pkg] = _scores(eng.score_batch(reqs))
        with JaxServingEngine(jax_load_bundle(str(mdir)), max_batch=8) as jeng:
            scores["jax", pkg] = _scores(jeng.score_batch(_jax_requests(reqs)))
    assert (scores["port", "port"] == scores["port", "jax"]).all()
    for key, got in scores.items():
        np.testing.assert_allclose(got, scores["port", "port"], rtol=TOL["rtol"], atol=TOL["atol"], err_msg=str(key))
