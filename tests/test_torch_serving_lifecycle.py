"""The port's serving under fire, on the CPU: the semantics of
tests/test_serving_lifecycle.py.

  * overload sheds with a typed `Overloaded`, and admitted requests
    complete; a blocking submit waits instead;
  * a request that expires in queue fails with `DeadlineExceeded` before it
    takes a slot, and its neighbours are answered;
  * a flush-thread death fails every pending future, refuses later
    submits and leaves the engine DEGRADED, and close() still joins;
  * the circuit breaker (unit cases), its FE-only answers bit-equal to the
    fixed-effect-only transformer, and the half-open probe's recovery;
  * a bundle hot-swap under live traffic fails no request and answers as a
    cold-started engine on the new bundle, building no program on the hot
    path; staging and commit faults roll back; the budget, an incompatible
    or released bundle refuse;
  * the health state machine.

Waits are on events and futures with timeouts; a stall inside a wrapped
score_batch stands for a slow device.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.data.game_dataset import GameDataset
from photon_ml_tpu_torch.game.model import Coefficients, FixedEffectModel, GameModel, RandomEffectModel
from photon_ml_tpu_torch.serving import (
    BatcherUnhealthy,
    CircuitBreaker,
    CircuitState,
    DeadlineExceeded,
    HbmBudgetExceeded,
    HealthStateMachine,
    Overloaded,
    ScoreRequest,
    ServingBundle,
    ServingEngine,
    ServingState,
    SwapIncompatible,
)
from photon_ml_tpu_torch.serving.lifecycle import device_memory_budget_bytes
from photon_ml_tpu_torch.transformers.game_transformer import CoordinateScoringSpec, GameTransformer
from photon_ml_tpu_torch.types import TaskType
from photon_ml_tpu_torch.utils import faults, telemetry

pytestmark = pytest.mark.serving

TASK = TaskType.LOGISTIC_REGRESSION
D_FE, D_RE, N_ENTITIES = 10, 4, 6
WAIT_S = 20.0  # the longest any test waits on an event or a future


@pytest.fixture(autouse=True)
def _port_fault_hygiene():
    faults.clear()
    telemetry.METRICS.reset()
    yield
    faults.clear()
    telemetry.METRICS.reset()


def _model(rng):
    w = rng.normal(size=D_FE).astype(np.float32)
    matrix = np.zeros((N_ENTITIES + 1, D_RE), np.float32)
    matrix[:N_ENTITIES] = rng.normal(size=(N_ENTITIES, D_RE))
    return GameModel({"fixed": FixedEffectModel(Coefficients(torch.from_numpy(w)), TASK),
                      "per-e": RandomEffectModel(torch.from_numpy(matrix), None, TASK)})


SPECS = {"fixed": CoordinateScoringSpec(shard="g"),
         "per-e": CoordinateScoringSpec(shard="re", random_effect_type="eid",
                                        entity_index={str(i): i for i in range(N_ENTITIES)})}


def _fixture(rng, n=9):
    X = rng.normal(size=(n, D_FE)).astype(np.float32)
    Xe = rng.normal(size=(n, D_RE)).astype(np.float32)
    ids = rng.integers(0, N_ENTITIES + 2, size=n)
    offsets = rng.normal(size=n).astype(np.float32)
    model = _model(rng)
    ds = GameDataset.build({"g": X, "re": Xe}, np.zeros(n, np.float32), offsets=offsets,
                           id_tags={"eid": ids.astype(str)}, device="cpu")
    reqs = [ScoreRequest(features={"g": X[i], "re": Xe[i]}, entity_ids={"eid": str(ids[i])},
                         offset=float(offsets[i]), uid=str(i)) for i in range(n)]
    return model, ds, reqs


def _bundle(model):
    return ServingBundle.from_model(model, SPECS, TASK, device="cpu")


def _ref(model, ds):
    return GameTransformer(model, SPECS, TASK).transform(ds).scores.numpy()


def _fe_only_ref(model, ds):
    n = ds.offsets.shape[0]
    fe_ds = GameDataset.build({"g": ds.shards["g"].numpy()}, np.zeros(n, np.float32),
                              offsets=ds.offsets.numpy(), device="cpu")
    return GameTransformer(GameModel({"fixed": model["fixed"]}), {"fixed": SPECS["fixed"]},
                           TASK).transform(fe_ds).scores.numpy()


def _scores(results):
    return np.asarray([r.score for r in results], np.float32)


def _slow_engine(eng, delay_s):
    """Stall score_batch by `delay_s` (the math is untouched); `eng.started`
    is set when a stalled batch has begun."""
    inner = eng.score_batch
    eng.started = threading.Event()

    def slow(requests, **kw):
        eng.started.set()
        threading.Event().wait(delay_s)
        return inner(requests, **kw)

    eng.score_batch = slow
    return eng


# ------------------------------------------------------------- admission


class TestAdmissionControl:
    def test_overload_sheds_typed_and_admitted_complete(self, rng):
        model, _, reqs = _fixture(rng, n=4)
        eng = _slow_engine(ServingEngine(_bundle(model), max_batch=4), 0.03)
        with eng, eng.batcher(max_wait_ms=1.0, max_pending=2) as b:
            futures, shed = [], 0
            for _ in range(40):
                try:
                    futures.append(b.submit(reqs[0]))
                except Overloaded:
                    shed += 1
            assert shed > 0
            assert all(isinstance(f.result(timeout=WAIT_S).score, float) for f in futures)
            m = b.metrics()
        assert m["shed"] == shed and m["completed"] == len(futures)
        assert faults.COUNTERS.get("serving_shed_requests") == shed

    def test_blocking_submit_backpressures_instead_of_shedding(self, rng):
        model, ds, reqs = _fixture(rng, n=9)
        eng = _slow_engine(ServingEngine(_bundle(model), max_batch=4), 0.01)
        with eng, eng.batcher(max_wait_ms=1.0, max_pending=2) as b:
            res = b.score_all(reqs)
            m = b.metrics()
        assert (_scores(res) == _ref(model, ds)).all()
        assert m["shed"] == 0

    def test_admit_fault_site_sheds_via_photon_faults(self, rng, monkeypatch):
        model, _, reqs = _fixture(rng, n=3)
        monkeypatch.setenv("PHOTON_FAULTS", "admit:2")
        faults.clear()  # read the environment again at the next fault_point
        with ServingEngine(_bundle(model), max_batch=4) as eng:
            with eng.batcher(max_wait_ms=1.0) as b:
                for r in reqs[:2]:
                    with pytest.raises(Overloaded):
                        b.submit(r)
                res = b.submit(reqs[2]).result(timeout=WAIT_S)
        assert isinstance(res.score, float)
        assert faults.COUNTERS.get("serving_shed_requests") == 2
        assert faults.COUNTERS.get("injected_faults") == 2

    def test_closed_batcher_beats_armed_admit_fault(self, rng):
        model, _, reqs = _fixture(rng, n=2)
        eng = ServingEngine(_bundle(model), max_batch=4)
        b = eng.batcher()
        eng.close()
        with faults.inject("admit:1"):
            with pytest.raises(RuntimeError, match="closed"):
                b.submit(reqs[0])
        assert faults.COUNTERS.get("serving_shed_requests") == 0
        assert faults.COUNTERS.get("injected_faults") == 0


# -------------------------------------------------------------- deadlines


class TestDeadlineEnforcement:
    @pytest.mark.parametrize("carried", [False, True])
    def test_expired_in_queue_fails_typed(self, rng, carried):
        """The budget comes from submit(deadline_ms=) or from the request."""
        model, _, reqs = _fixture(rng, n=2)
        eng = _slow_engine(ServingEngine(_bundle(model), max_batch=4), 0.15)
        with eng, eng.batcher(max_wait_ms=1.0) as b:
            blocker = b.submit(reqs[0])  # holds the flush thread for 150 ms
            assert eng.started.wait(WAIT_S)
            if carried:
                doomed = b.submit(ScoreRequest(features=dict(reqs[1].features),
                                               entity_ids=dict(reqs[1].entity_ids), deadline_ms=5.0))
            else:
                doomed = b.submit(reqs[1], deadline_ms=5.0)
            with pytest.raises(DeadlineExceeded):
                doomed.result(timeout=WAIT_S)
            assert isinstance(blocker.result(timeout=WAIT_S).score, float)
            m = b.metrics()
        assert m["deadline_missed"] == 1
        assert faults.COUNTERS.get("serving_deadline_misses") == 1

    def test_unexpired_neighbors_still_answered(self, rng):
        model, ds, reqs = _fixture(rng, n=3)
        ref = _ref(model, ds)
        eng = _slow_engine(ServingEngine(_bundle(model), max_batch=4), 0.1)
        with eng, eng.batcher(max_wait_ms=1.0) as b:
            f0 = b.submit(reqs[0])
            assert eng.started.wait(WAIT_S)
            f1 = b.submit(reqs[1], deadline_ms=5.0)
            f2 = b.submit(reqs[2])
            with pytest.raises(DeadlineExceeded):
                f1.result(timeout=WAIT_S)
            assert f0.result(timeout=WAIT_S).score == ref[0]
            assert f2.result(timeout=WAIT_S).score == ref[2]

    def test_stale_service_tail_decays_instead_of_wedging(self, rng):
        model, _, reqs = _fixture(rng, n=2)
        with ServingEngine(_bundle(model), max_batch=4) as eng:
            eng.warmup()
            with eng.batcher(max_wait_ms=1.0) as b:
                with b._cv:
                    b._service_tail_s = 30.0  # an absurd spike
                got_answer = False
                for _ in range(20):
                    try:
                        b.submit(reqs[0], deadline_ms=100.0).result(timeout=WAIT_S)
                        got_answer = True
                        break
                    except DeadlineExceeded:
                        continue
                assert got_answer, "the service-time margin wedged the batcher"

    def test_no_deadline_means_no_misses(self, rng):
        model, _, reqs = _fixture(rng, n=9)
        with ServingEngine(_bundle(model), max_batch=4) as eng:
            with eng.batcher(max_wait_ms=1.0) as b:
                b.score_all(reqs)
                m = b.metrics()
        assert m["deadline_missed"] == 0
        assert faults.COUNTERS.get("serving_deadline_misses") == 0


# ----------------------------------------------------- flush-thread death


class TestFlushThreadDeath:
    def test_pending_futures_failed_not_hung(self, rng):
        model, _, reqs = _fixture(rng, n=3)
        eng = ServingEngine(_bundle(model), max_batch=4)
        eng.warmup()
        b = eng.batcher(max_wait_ms=60_000.0, max_batch=4)  # only a full batch flushes

        def broken(batch):
            raise RuntimeError("flush bookkeeping bug")

        b._dispatch = broken
        futures = [b.submit(r) for r in reqs] + [b.submit(reqs[0])]  # the 4th fills the batch
        for f in futures:
            with pytest.raises(RuntimeError, match="flush bookkeeping bug"):
                f.result(timeout=WAIT_S)
        # The death is recorded before any future fails.
        with pytest.raises(BatcherUnhealthy):
            b.submit(reqs[0])
        assert not b.healthy
        assert faults.COUNTERS.get("serving_flush_thread_failures") == 1
        assert eng.health.state is ServingState.DEGRADED
        assert any("batcher_unhealthy" in r for r in eng.health.degraded_reasons)
        eng.close()
        assert b.closed


# --------------------------------------------------------- circuit breaker


class TestCircuitBreakerUnit:
    def test_opens_after_threshold_and_probes_single_file(self):
        t = [0.0]
        br = CircuitBreaker(threshold=3, probe_interval_s=10.0, clock=lambda: t[0])
        for _ in range(2):
            br.on_failure(br.acquire())
        assert br.state is CircuitState.CLOSED
        br.on_failure(br.acquire())
        assert br.state is CircuitState.OPEN
        assert br.acquire() is None
        t[0] = 11.0
        probe = br.acquire()
        assert probe is not None and probe.probe
        assert br.acquire() is None
        br.on_success(probe)
        assert br.state is CircuitState.CLOSED
        assert faults.COUNTERS.get("serving_circuit_opens") == 1

    def test_failed_probe_rearms_interval(self):
        t = [0.0]
        br = CircuitBreaker(threshold=1, probe_interval_s=5.0, clock=lambda: t[0])
        br.on_failure(br.acquire())
        t[0] = 6.0
        probe = br.acquire()
        assert probe is not None
        br.on_failure(probe)
        assert br.state is CircuitState.OPEN
        t[0] = 10.0
        assert br.acquire() is None
        t[0] = 11.5
        assert br.acquire() is not None

    def test_abandon_returns_probe_permit(self):
        t = [0.0]
        br = CircuitBreaker(threshold=1, probe_interval_s=1.0, clock=lambda: t[0])
        br.on_failure(br.acquire())
        t[0] = 2.0
        br.on_abandon(br.acquire())
        assert br.acquire() is not None

    def test_success_resets_consecutive_count(self):
        br = CircuitBreaker(threshold=2)
        br.on_failure(br.acquire())
        br.on_success(br.acquire())
        br.on_failure(br.acquire())
        assert br.state is CircuitState.CLOSED

    def test_stale_free_permit_cannot_clobber_inflight_probe(self):
        t = [0.0]
        br = CircuitBreaker(threshold=3, probe_interval_s=1.0, clock=lambda: t[0])
        stale = br.acquire()
        assert stale is not None and not stale.probe
        for _ in range(3):
            br.on_failure(br.acquire())
        t[0] = 2.0
        probe = br.acquire()
        assert probe is not None and probe.probe
        br.on_abandon(stale)
        assert br.acquire() is None
        br.on_failure(stale)
        assert br.acquire() is None
        br.on_success(probe)
        assert br.state is CircuitState.CLOSED

    def test_stale_free_permit_success_cannot_close_open_circuit(self):
        t = [0.0]
        br = CircuitBreaker(threshold=2, probe_interval_s=1.0, clock=lambda: t[0])
        stale = br.acquire()
        for _ in range(2):
            br.on_failure(br.acquire())
        assert br.state is CircuitState.OPEN
        br.on_success(stale)
        assert br.state is CircuitState.OPEN
        t[0] = 2.0
        probe = br.acquire()
        assert probe is not None and probe.probe
        br.on_success(probe)
        assert br.state is CircuitState.CLOSED

    def test_threshold_must_be_positive(self):
        with pytest.raises(ValueError):
            CircuitBreaker(threshold=0)


@pytest.mark.chaos
class TestCircuitBreakerServing:
    def test_open_circuit_serves_fe_only_bitwise(self, rng, monkeypatch):
        monkeypatch.setenv("PHOTON_RETRY_MAX_ATTEMPTS", "1")
        model, ds, reqs = _fixture(rng, n=9)
        fe_ref = _fe_only_ref(model, ds)
        with ServingEngine(_bundle(model), max_batch=4, circuit_threshold=2,
                           circuit_probe_interval_s=3600.0) as eng:
            eng.warmup()
            with faults.inject("score:1000"):  # the device stays down
                with eng.batcher(max_wait_ms=1.0) as b:
                    failed, fe_answers = 0, {}
                    for i, r in enumerate(reqs):
                        try:
                            fe_answers[i] = b.submit(r).result(timeout=WAIT_S)
                        except faults.InjectedFault:
                            failed += 1
                    m = b.metrics()
            assert failed == 2
            assert m["circuit_state"] == "OPEN" and m["circuit_opens"] == 1
            assert faults.COUNTERS.get("serving_circuit_opens") == 1
            assert eng.health.state is ServingState.DEGRADED
            assert "circuit_open" in eng.health.degraded_reasons
            assert all(res.fe_only and res.score == fe_ref[i] for i, res in fe_answers.items())
            assert m["fe_only_answers"] == len(fe_answers)

    def test_half_open_probe_recovers_full_path(self, rng, monkeypatch):
        monkeypatch.setenv("PHOTON_RETRY_MAX_ATTEMPTS", "1")
        model, ds, reqs = _fixture(rng, n=6)
        ref, fe_ref = _ref(model, ds), _fe_only_ref(model, ds)
        with ServingEngine(_bundle(model), max_batch=4, circuit_threshold=1,
                           circuit_probe_interval_s=10.0) as eng:
            eng.warmup()
            t = [0.0]
            eng.breaker._clock = lambda: t[0]  # the probe interval passes on this clock
            # Two faulted invocations: the batch and its per-request retry,
            # the one device failure that opens the circuit.
            with faults.inject("score:2"):
                with eng.batcher(max_wait_ms=1.0) as b:
                    with pytest.raises(faults.InjectedFault):
                        b.submit(reqs[0]).result(timeout=WAIT_S)
                    assert eng.breaker.state is CircuitState.OPEN
                    r1 = b.submit(reqs[1]).result(timeout=WAIT_S)
                    assert r1.fe_only and r1.score == fe_ref[1]
                    t[0] = 11.0
                    r2 = b.submit(reqs[2]).result(timeout=WAIT_S)  # the probe
                    assert not r2.fe_only and r2.score == ref[2]
                    assert eng.breaker.state is CircuitState.CLOSED
                    rest = b.score_all(reqs[3:])
            assert (_scores(rest) == ref[3:]).all()
            assert eng.health.state is ServingState.READY

    def test_malformed_request_never_trips_breaker(self, rng):
        model, ds, reqs = _fixture(rng, n=4)
        poison = ScoreRequest(features={"g": np.zeros((3, 3), np.float32)}, entity_ids={"eid": "0"})
        with ServingEngine(_bundle(model), max_batch=4, circuit_threshold=1) as eng:
            with eng.batcher(max_wait_ms=1.0) as b:
                futs = [b.submit(r) for r in reqs[:3]] + [b.submit(poison)]
                good = [f.result(timeout=WAIT_S) for f in futs[:3]]
                with pytest.raises(Exception) as ei:
                    futs[3].result(timeout=WAIT_S)
                assert not isinstance(ei.value, faults.InjectedFault)
            assert eng.breaker.state is CircuitState.CLOSED
        assert (_scores(good) == _ref(model, ds)[:3]).all()
        assert faults.COUNTERS.get("serving_circuit_opens") == 0


# ------------------------------------------------------------ bundle swap


class TestBundleHotSwap:
    def test_swap_under_live_traffic_zero_failures_bitwise(self, rng):
        model, _, reqs = _fixture(rng, n=9)
        model2 = _model(rng)
        with ServingEngine(_bundle(model), max_batch=8) as eng:
            eng.warmup()
            stop = threading.Event()
            failures: list = []
            answered = [0]
            marks = {20: threading.Event(), 60: threading.Event()}

            def traffic(b):
                i = 0
                while not stop.is_set():
                    try:
                        b.submit(reqs[i % len(reqs)], block=True).result(timeout=WAIT_S)
                        answered[0] += 1
                    except Exception as exc:  # recorded: the test wants none
                        failures.append(exc)
                    for k, ev in marks.items():
                        if answered[0] >= k:
                            ev.set()
                    i += 1

            with eng.batcher(max_wait_ms=0.5) as b:
                t = threading.Thread(target=traffic, args=(b,), name="test-serving-traffic")
                t.start()
                try:
                    assert marks[20].wait(WAIT_S)  # traffic against version 0
                    info = eng.bundle_manager.swap(lambda: _bundle(model2))
                    assert marks[60].wait(WAIT_S)  # and against version 1
                finally:
                    stop.set()
                    t.join(timeout=WAIT_S)
            assert not t.is_alive()
            assert failures == []
            assert info["version"] == 1 and info["old_released"]
            assert info["staging_compiles"] == len(eng.buckets)
            assert eng.bundle_version == 1
            with ServingEngine(_bundle(model2), max_batch=8) as cold:
                ref2 = _scores(cold.score_batch(reqs))
            assert (_scores(eng.score_batch(reqs)) == ref2).all()
            assert eng.recompiles_after_warmup == 0
            assert eng.metrics()["bundle_swaps"] == 1
        assert faults.COUNTERS.get("serving_swaps") == 1
        assert faults.COUNTERS.get("serving_swap_rollbacks") == 0

    @pytest.mark.parametrize("spec", ["swap_stage:1000", "swap_commit:1"])
    def test_a_stage_or_commit_fault_rolls_back(self, rng, monkeypatch, spec):
        monkeypatch.setenv("PHOTON_RETRY_MAX_ATTEMPTS", "2")
        monkeypatch.setenv("PHOTON_RETRY_BASE_DELAY_S", "0.001")
        model, ds, reqs = _fixture(rng, n=5)
        model2 = _model(rng)
        with ServingEngine(_bundle(model), max_batch=8) as eng:
            with faults.inject(spec):
                with pytest.raises(faults.InjectedFault):
                    eng.bundle_manager.swap(lambda: _bundle(model2))
            assert eng.bundle_version == 0
            assert (_scores(eng.score_batch(reqs)) == _ref(model, ds)).all()
            assert eng.metrics()["bundle_swap_rollbacks"] == 1
        assert faults.COUNTERS.get("serving_swap_rollbacks") == 1
        assert faults.COUNTERS.get("serving_swaps") == 0

    def test_transient_stage_fault_is_retried_through(self, rng, monkeypatch):
        monkeypatch.setenv("PHOTON_RETRY_BASE_DELAY_S", "0.001")
        model, _, _ = _fixture(rng, n=3)
        with ServingEngine(_bundle(model), max_batch=4) as eng:
            with faults.inject("swap_stage:1"):
                assert eng.bundle_manager.swap(lambda: _bundle(_model(rng)))["version"] == 1
        assert faults.COUNTERS.get("serving_swaps") == 1
        assert faults.COUNTERS.get("serving_swap_rollbacks") == 0
        assert faults.COUNTERS.get("retries") == 1

    def test_hbm_budget_refused_before_staging(self, rng):
        model, _, _ = _fixture(rng, n=2)
        built = [0]

        def builder():
            built[0] += 1
            return _bundle(model)

        with ServingEngine(_bundle(model), max_batch=4) as eng:
            with pytest.raises(HbmBudgetExceeded):
                eng.bundle_manager.swap(builder, expected_bytes=1 << 40, hbm_budget_bytes=1 << 20)
        assert built[0] == 0
        assert faults.COUNTERS.get("serving_swaps") == 0

    def test_budget_reads_the_knob_and_is_unknown_on_the_cpu(self, monkeypatch):
        assert device_memory_budget_bytes(torch.device("cpu")) is None
        monkeypatch.setenv("PHOTON_SERVING_HBM_BUDGET_BYTES", "123456")
        assert device_memory_budget_bytes(torch.device("cpu")) == 123456

    def test_incompatible_bundle_rejected(self, rng):
        model, _, _ = _fixture(rng, n=2)
        w = np.random.default_rng(99).normal(size=D_FE + 3).astype(np.float32)
        bad = GameModel({"fixed": FixedEffectModel(Coefficients(torch.from_numpy(w)), TASK)})
        bad_bundle = ServingBundle.from_model(bad, {"fixed": SPECS["fixed"]}, TASK, device="cpu")
        with ServingEngine(_bundle(model), max_batch=4) as eng:
            with pytest.raises(SwapIncompatible):
                eng.bundle_manager.swap(bad_bundle)
            assert eng.bundle_version == 0
        assert faults.COUNTERS.get("serving_swap_rollbacks") == 1

    def test_released_bundle_refused(self, rng):
        model, _, _ = _fixture(rng, n=2)
        bundle = _bundle(model)
        bundle.release()
        assert bundle.released
        with pytest.raises(RuntimeError, match="released"):
            ServingEngine(bundle, max_batch=4)


# ----------------------------------------------------------- health states


class TestHealthStateMachine:
    def test_engine_lifecycle_states(self, rng):
        model, _, _ = _fixture(rng, n=2)
        eng = ServingEngine(_bundle(model), max_batch=4)
        assert eng.health.state is ServingState.STARTING
        assert eng.metrics()["state"] == "STARTING"
        eng.warmup()
        assert eng.health.state is ServingState.READY
        eng.close()
        assert eng.health.state is ServingState.CLOSED
        assert [t["to"] for t in eng.health.snapshot()["transitions"]] == ["READY", "DRAINING", "CLOSED"]

    def test_close_drains_pending_then_closes(self, rng):
        model, _, reqs = _fixture(rng, n=5)
        eng = ServingEngine(_bundle(model), max_batch=4)
        eng.warmup()
        b = eng.batcher(max_wait_ms=10_000.0)
        futures = [b.submit(r) for r in reqs[:3]]
        eng.close()
        assert all(isinstance(f.result(timeout=WAIT_S).score, float) for f in futures)
        assert eng.health.state is ServingState.CLOSED

    def test_reason_tracked_degradation(self):
        h = HealthStateMachine()
        h.mark_ready()
        h.add_degraded("circuit_open")
        h.add_degraded("batcher_unhealthy: boom")
        assert h.state is ServingState.DEGRADED
        h.clear_degraded("circuit_open")
        assert h.state is ServingState.DEGRADED
        h.clear_degraded("batcher_unhealthy: boom")
        assert h.state is ServingState.READY

    def test_closed_is_terminal(self):
        h = HealthStateMachine()
        h.begin_drain()
        h.close()
        h.add_degraded("too late")
        h.mark_ready()
        assert h.state is ServingState.CLOSED
        h2 = HealthStateMachine()
        h2.mark_ready()
        h2.begin_drain()
        h2.clear_degraded("nothing")
        assert h2.state is ServingState.DRAINING
        h2.close()
        assert h2.state is ServingState.CLOSED

    def test_transitions_are_journalled(self, rng, tmp_path):
        model, _, _ = _fixture(rng, n=2)
        path = str(tmp_path / "journal.jsonl")
        journal = telemetry.install_journal(telemetry.RunJournal(path))
        try:
            eng = ServingEngine(_bundle(model), max_batch=2)
            eng.warmup()
            eng.close()
        finally:
            telemetry.uninstall_journal()
            journal.close()
        n_ok, errors = telemetry.validate_journal(path)
        assert errors == [] and n_ok == 3
