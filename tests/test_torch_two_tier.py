"""The port's two-tier serving store and host-tier demotion, on the CPU.

The cases of tests/test_serving_two_tier.py (TestTwoTierStore,
TestNormalizedParity, TestPromotionFaults) on the port, each held against
the JAX package on the same numpy weights:

  * a batch mixing hot-plane hits, cold-tier override rows and unknown
    entities scores bit-equal to the port's single-tier engine at every
    capacity (0 included), and within PORT_TOLERANCES["convert_scores"] of
    the JAX two-tier engine; the hit, promotion and eviction counters of a
    stream with drains between batches are the JAX store's;
  * the port writes promotions into the plane in place: a batch resolved
    before a promotion moved the store's epoch resolves again before it
    runs, and promotions racing batches on other threads never change an
    answer;
  * an armed `promote` fault keeps its rows cold and the answers bit-equal
    (counted, never fatal), as in the reference;
  * `demote_bundle_to_host_tier` / `promote_bundle_from_host_tier` round
    trips keep the bits, a normalized coordinate included; a bundle's
    device bytes charge the hot plane only.
"""

from __future__ import annotations

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.game.model import Coefficients as JaxCoefficients
from photon_ml_tpu.game.model import FixedEffectModel as JaxFixedEffectModel
from photon_ml_tpu.game.model import GameModel as JaxGameModel
from photon_ml_tpu.game.model import RandomEffectModel as JaxRandomEffectModel
from photon_ml_tpu.serving import ScoreRequest as JaxScoreRequest
from photon_ml_tpu.serving import ServingBundle as JaxServingBundle
from photon_ml_tpu.serving import ServingEngine as JaxServingEngine
from photon_ml_tpu.serving.bundle import demote_bundle_to_host_tier as jax_demote
from photon_ml_tpu.transformers.game_transformer import CoordinateScoringSpec as JaxSpec
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.game.model import Coefficients, FixedEffectModel, GameModel, RandomEffectModel
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.serving import ScoreRequest, ServingBundle, ServingEngine
from photon_ml_tpu_torch.serving.bundle import (
    TwoTierEntityStore,
    demote_bundle_to_host_tier,
    promote_bundle_from_host_tier,
)
from photon_ml_tpu_torch.transformers.game_transformer import CoordinateScoringSpec
from photon_ml_tpu_torch.types import TaskType
from photon_ml_tpu_torch.utils import faults, telemetry

pytestmark = pytest.mark.serving

TASK = TaskType.LOGISTIC_REGRESSION
D_FE, D_RE, E = 7, 5, 24
TOL = PORT_TOLERANCES["convert_scores"]  # float32 scoring in two frameworks


@pytest.fixture(autouse=True)
def _port_fault_hygiene(monkeypatch):
    """The port's fault plan and counters are its own process globals."""
    monkeypatch.setenv("PHOTON_RETRY_BASE_DELAY_S", "0.001")
    faults.clear()
    telemetry.METRICS.reset()
    yield
    faults.clear()
    telemetry.METRICS.reset()


def _weights(rng):
    w = rng.normal(size=D_FE).astype(np.float32)
    M = np.zeros((E + 1, D_RE), np.float32)
    M[:E] = rng.normal(size=(E, D_RE))
    return w, M


def _requests(rng, n=16):
    """Hot (the preloaded prefix), cold (the tail) and unknown entities in
    one stream: even ids below E are trained entities, the rest unknown."""
    X = rng.normal(size=(n, D_FE)).astype(np.float32)
    Xe = rng.normal(size=(n, D_RE)).astype(np.float32)
    ids = [str((2 * i) % (E + 6)) for i in range(n)]
    off = rng.normal(size=n).astype(np.float32)
    return [dict(g=X[i], re=Xe[i], eid=ids[i], offset=float(off[i]), uid=str(i)) for i in range(n)]


def _port(w, M, norm=None):
    model = GameModel({"fixed": FixedEffectModel(Coefficients(torch.from_numpy(w)), TASK),
                       "per-e": RandomEffectModel(torch.from_numpy(M), None, TASK)})
    specs = {"fixed": CoordinateScoringSpec(shard="g"),
             "per-e": CoordinateScoringSpec(shard="re", norm=norm, random_effect_type="eid",
                                            entity_index={str(i): i for i in range(E)})}
    return model, specs


def _port_reqs(docs):
    return [ScoreRequest(features={"g": d["g"], "re": d["re"]}, entity_ids={"eid": d["eid"]},
                         offset=d["offset"], uid=d["uid"]) for d in docs]


def _jax_bundle(w, M, hot_rows=None):
    model = JaxGameModel({"fixed": JaxFixedEffectModel(JaxCoefficients(jnp.asarray(w)),
                                                       JaxTaskType.LOGISTIC_REGRESSION),
                          "per-e": JaxRandomEffectModel(jnp.asarray(M), None,
                                                        JaxTaskType.LOGISTIC_REGRESSION)})
    specs = {"fixed": JaxSpec(shard="g"),
             "per-e": JaxSpec(shard="re", random_effect_type="eid",
                              entity_index={str(i): i for i in range(E)})}
    return JaxServingBundle.from_model(model, specs, JaxTaskType.LOGISTIC_REGRESSION, hot_rows=hot_rows)


def _jax_reqs(docs):
    return [JaxScoreRequest(features={"g": d["g"], "re": d["re"]}, entity_ids={"eid": d["eid"]},
                            offset=d["offset"], uid=d["uid"]) for d in docs]


def _scores(results):
    return np.asarray([r.score for r in results], np.float32)


def _single_tier(w, M, reqs, norm=None):
    model, specs = _port(w, M, norm)
    with ServingEngine(ServingBundle.from_model(model, specs, TASK, device="cpu"), max_batch=16) as eng:
        return _scores(eng.score_batch(reqs))


@pytest.mark.parametrize("hot_rows", [0, 1, 6, E])
def test_mixed_hot_cold_unknown_rows_are_single_tier_bits(rng, hot_rows):
    w, M = _weights(rng)
    docs = _requests(rng)
    reqs = _port_reqs(docs)
    ref = _single_tier(w, M, reqs)
    model, specs = _port(w, M)
    bundle = ServingBundle.from_model(model, specs, TASK, device="cpu", hot_rows=hot_rows)
    store = bundle.coordinates["per-e"].store
    assert store.capacity == hot_rows and tuple(bundle.coordinates["per-e"].params.shape) == (hot_rows + 1, D_RE)
    assert bundle.device_bytes() == (D_FE + (hot_rows + 1) * D_RE) * 4  # the hot plane only
    with ServingEngine(bundle, max_batch=16) as eng:
        assert eng._state.kinds == ("fe", "re2")
        first = _scores(eng.score_batch(reqs))
        store.drain()
        second = _scores(eng.score_batch(reqs))  # after the promotions
        singles = np.concatenate([_scores(eng.score_batch([r])) for r in reqs])
        m = eng.metrics()
    assert (first == ref).all() and (second == ref).all() and (singles == ref).all()
    assert m["cold_start_lookups"] > 0
    assert m["sharding"]["hot_set_fraction"] == round(hot_rows / E, 6)
    jax_bundle = _jax_bundle(w, M, hot_rows=hot_rows)
    with JaxServingEngine(jax_bundle, max_batch=16) as jeng:
        want = _scores(jeng.score_batch(_jax_reqs(docs)))
    np.testing.assert_allclose(first, want, rtol=TOL["rtol"], atol=TOL["atol"])
    bundle.release()
    jax_bundle.release()
    assert store._closed


def test_the_store_counters_are_the_reference_counters(rng):
    """The same stream, with every promotion drained between batches, moves
    the port's and the JAX store's counters alike (same LRU, same
    promotion batches)."""
    w, M = _weights(rng)
    docs = _requests(rng, n=24)
    port_bundle = ServingBundle.from_model(*_port(w, M), TASK, device="cpu", hot_rows=4)
    jax_bundle = _jax_bundle(w, M, hot_rows=4)
    got, want = [], []
    with ServingEngine(port_bundle, max_batch=8) as eng, JaxServingEngine(jax_bundle, max_batch=8) as jeng:
        for lo in range(0, len(docs), 8):
            eng.score_batch(_port_reqs(docs[lo:lo + 8]))
            port_bundle.coordinates["per-e"].store.drain()
            jeng.score_batch(_jax_reqs(docs[lo:lo + 8]))
            jax_bundle.coordinates["per-e"].store.drain()
            got.append(port_bundle.coordinates["per-e"].store.metrics())
            want.append(jax_bundle.coordinates["per-e"].store.metrics())
    assert got == want
    assert got[-1]["promotions"] > 0 and got[-1]["evictions"] > 0
    port_bundle.release()
    jax_bundle.release()


def test_a_batch_resolved_before_a_promotion_resolves_again(rng):
    """The hazard of the in-place plane: slots packed at one epoch, then a
    promotion evicts and rewrites them; the dispatch sees the epoch moved,
    resolves again under the device mutex and answers the single-tier bits."""
    w, M = _weights(rng)
    reqs = _port_reqs(_requests(rng))
    ref = _single_tier(w, M, reqs)
    bundle = ServingBundle.from_model(*_port(w, M), TASK, device="cpu", hot_rows=2)
    store = bundle.coordinates["per-e"].store
    with ServingEngine(bundle, max_batch=16) as eng:
        st = eng._state
        warm = _port_reqs([dict(g=np.zeros(D_FE, np.float32), re=np.zeros(D_RE, np.float32), eid=str(e),
                                offset=0.0, uid=None) for e in (0, 2)])
        eng.score_batch(warm)
        store.drain()
        packed = eng._pack(reqs, 16, st, inject=False)
        epoch = store.epoch
        store.drain()  # the batch's own cold hits promote, evicting rows 0 and 2
        assert store.epoch > epoch and store.evictions > 0
        # The same batch without its re-resolve reads the rewritten slots.
        wrong, _ = eng._dispatch(dict(packed, tiered={}), st, inject=False)
        scores, _ = eng._dispatch(packed, st, inject=False)
    assert (scores.astype(np.float32) == ref).all()
    assert not (wrong.astype(np.float32) == ref).all()
    bundle.release()


def test_promotions_racing_batches_never_change_an_answer(rng):
    w, M = _weights(rng)
    docs = _requests(rng, n=48)
    reqs = _port_reqs(docs)
    ref = _single_tier(w, M, reqs)
    bundle = ServingBundle.from_model(*_port(w, M), TASK, device="cpu", hot_rows=3)
    bad = []
    with ServingEngine(bundle, max_batch=8) as eng:
        def client(k):
            for rnd in range(12):
                lo = (8 * (k + rnd)) % len(reqs)
                got = _scores(eng.score_batch(reqs[lo:lo + 8]))
                if not (got == ref[lo:lo + 8]).all():
                    bad.append((k, rnd))

        threads = [threading.Thread(target=client, args=(k,), name=f"test-client-{k}") for k in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        m = eng.metrics()
    assert not bad
    assert m["promotions"] > 0 and m["evictions"] > 0
    bundle.release()


@pytest.mark.parametrize("spec", ["promote:1", "promote:9999"])
def test_a_failed_promotion_keeps_rows_cold_and_bit_equal(rng, spec):
    w, M = _weights(rng)
    reqs = _port_reqs(_requests(rng))
    ref = _single_tier(w, M, reqs)
    bundle = ServingBundle.from_model(*_port(w, M), TASK, device="cpu", hot_rows=6)
    store = bundle.coordinates["per-e"].store
    with faults.inject(spec):
        with ServingEngine(bundle, max_batch=16) as eng:
            for _ in range(3):
                assert (_scores(eng.score_batch(reqs)) == ref).all()
                store.drain()
            m = eng.metrics()
    assert m["promote_failures"] > 0 and not store._closed
    assert faults.counters()["promote_failures"] == m["promote_failures"]
    if spec == "promote:1":
        assert m["promotions"] > 0  # the worker lived on and a later touch promoted
    else:
        assert m["promotions"] == 0 and m["cold_tier_hits"] > 0
    bundle.release()


def test_demote_and_restore_round_trip_keeps_the_bits(rng):
    """A normalized coordinate with shifts, as TestNormalizedParity holds:
    single tier, demoted and restored give the same bits; the demoted
    bundle is the JAX demotion's within tolerance."""
    w, M = _weights(rng)
    reqs = _port_reqs(_requests(rng))
    norm = NormalizationContext(factors=torch.from_numpy(rng.uniform(0.5, 2.0, D_RE).astype(np.float32)),
                                shifts=torch.from_numpy(rng.normal(size=D_RE).astype(np.float32)))
    ref = _single_tier(w, M, reqs, norm)
    single = ServingBundle.from_model(*_port(w, M, norm), TASK, device="cpu")
    demoted = demote_bundle_to_host_tier(single, hot_rows=3)
    assert demoted.coordinates["fixed"] is single.coordinates["fixed"]  # carried by reference
    assert demoted.device_bytes() == (D_FE + 4 * D_RE) * 4
    restored = promote_bundle_from_host_tier(demoted)
    assert restored.coordinates["per-e"].store is None
    assert torch.equal(restored.coordinates["per-e"].params, single.coordinates["per-e"].params)
    for b in (demoted, restored):
        with ServingEngine(b, max_batch=16) as eng:
            assert (_scores(eng.score_batch(reqs)) == ref).all()
    jax_demoted = jax_demote(_jax_bundle(w, M), hot_rows=3)
    np.testing.assert_array_equal(jax_demoted.coordinates["per-e"].store.cold_matrix,
                                  demoted.coordinates["per-e"].store.cold_matrix)
    demoted.release()
    jax_demoted.release()


def test_the_store_unit_lru(rng):
    """Preload, LRU victim choice and the pinned zero slot, on the store
    alone, against the JAX store on the same rows. A lookup that touches
    every hot slot leaves them all at one tick, so the reference's choice
    gives one slot to several rows of the next round: the slot holds the
    last of them, as its index says."""
    from photon_ml_tpu.serving.bundle import TwoTierEntityStore as JaxStore

    cold = rng.normal(size=(9, 3)).astype(np.float32)
    cold[-1] = 0.0
    port, ref = TwoTierEntityStore(cold, 3, "cpu"), JaxStore(cold, 3)
    for rows in ([0, 1, 5, 8], [5, 6, 7], [0, 2, 3, 4], [0, 2, 3, 1, 4, 5, 6, 7]):
        a = port.lookup(np.asarray(rows), 8)
        b = ref.lookup(np.asarray(rows), 8)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])
        port.drain()
        ref.drain()
        np.testing.assert_array_equal(port.hot.numpy(), np.asarray(ref.snapshot()))
        for row, slot in port._slot_of_row.items():  # every mapped slot holds its row
            np.testing.assert_array_equal(port.hot[slot].numpy(), cold[row])
    assert port.metrics() == ref.metrics()
    assert (port.hot[port.zero_slot] == 0).all()
    port.close()
    ref.close()
