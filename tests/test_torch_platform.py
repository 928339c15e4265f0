"""The port's platform layers against the JAX package's, on the CPU.

  * knobs: every knob the port reads has the JAX registry's type and
    default, and parses the same strings the same way;
  * faults: the same site registry, the same failure schedule for the same
    spec strings and seeds, the same retry and classification (the CUDA
    runtime's errors count as transient, as the reference's XlaRuntimeError
    does);
  * the watchdog: a free no-op when off, a counted, journalled trip that
    raises DeviceHang at the scope's end;
  * telemetry: the same histogram buckets and quantiles on the same samples,
    spans across a thread hand-off, journals the JAX `validate_journal`
    accepts, serve profiles the JAX `read_profile` accepts;
  * the port's contract tuples equal the JAX package's.
"""

from __future__ import annotations

import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

from photon_ml_tpu.utils import contracts as jax_contracts
from photon_ml_tpu.utils import faults as jax_faults
from photon_ml_tpu.utils import knobs as jax_knobs
from photon_ml_tpu.utils import telemetry as jax_telemetry
from photon_ml_tpu_torch import contracts
from photon_ml_tpu_torch.utils import faults, knobs, telemetry
from photon_ml_tpu_torch.utils.observability import TimingRegistry, stage_scope, stage_timer
from photon_ml_tpu_torch.utils.watchdog import Watchdog, watchdog_ms

WAIT_S = 20.0


@pytest.fixture(autouse=True)
def _port_fault_hygiene():
    faults.clear()
    telemetry.METRICS.reset()
    yield
    faults.clear()
    telemetry.METRICS.reset()
    assert telemetry.current_tracer() is None and telemetry.current_journal() is None


# ---------------------------------------------------------------------- knobs


@pytest.mark.parametrize("name", sorted(knobs.KNOBS))
def test_knobs_have_the_reference_type_default_and_parsing(name, monkeypatch):
    ours, theirs = knobs.KNOBS[name], jax_knobs.KNOBS[name]
    assert (ours.type, ours.default) == (theirs.type, theirs.default)
    for raw in ("", "  ", "0", "1", "7", " 12 ", "-3", "2.5", "true", "off", "Yes", "nope", "score:1,admit@2"):
        assert knobs.get_knob(name, raw) == jax_knobs.get_knob(name, raw), raw
        monkeypatch.setenv(name, raw)
        assert knobs.knob_is_set(name) == jax_knobs.knob_is_set(name)
        assert knobs.get_knob(name) == jax_knobs.get_knob(name)


def test_an_unregistered_knob_raises():
    with pytest.raises(KeyError):
        knobs.get_knob("PHOTON_SWEEP_SCAN")  # the scan-dispatched bucket sweep the port has not got
    with pytest.raises(KeyError):
        knobs.knob_is_set("PHOTON_NOT_A_KNOB")
    assert knobs.get_knob("PHOTON_TIER_LADDER") is False  # the precision ladder's: registered


# --------------------------------------------------------------------- faults


def test_the_site_registry_is_the_reference_registry():
    assert faults.SITE_DESCRIPTIONS == jax_faults.SITE_DESCRIPTIONS
    for site in jax_faults.KNOWN_SITES:  # each parses from a spec string
        ours, theirs = faults.FaultPlan.parse(f"{site}:1"), jax_faults.FaultPlan.parse(f"{site}:1")
        assert {k: dataclasses.asdict(v) for k, v in ours.sites.items()} == \
            {k: dataclasses.asdict(v) for k, v in theirs.sites.items()}


@pytest.mark.parametrize("spec", ["nope:1", "score:1,typo@2"])
def test_an_unknown_site_is_refused_as_in_the_reference(spec):
    with pytest.raises(ValueError, match="unknown fault site"):
        faults.FaultPlan.parse(spec)
    with pytest.raises(ValueError, match="unknown fault site"):
        jax_faults.FaultPlan.parse(spec)


def _schedule(module, spec, seed, sites, n=60):
    """Which invocations of each site raise under `spec`."""
    inj = module.FaultInjector(module.FaultPlan.parse(spec, seed=seed))
    out = {}
    for site in sites:
        fired = []
        for k in range(1, n + 1):
            try:
                inj.fire(site)
            except module.InjectedFault:
                fired.append(k)
        out[site] = fired
    return out, dict(inj.injected)


@pytest.mark.parametrize("spec", ["lookup:3", "score@2+5+9", "admit:p0.3", "swap_stage:1,score:p0.25,lookup@4+7",
                                  "shard_upload:2,shard_upload@10", "swap_commit", "score:p0.05"])
@pytest.mark.parametrize("seed", [0, 7, 123456789])
def test_the_same_spec_and_seed_fire_at_the_same_invocations(spec, seed):
    sites = ("lookup", "score", "admit", "swap_stage", "swap_commit", "shard_upload")
    ours = _schedule(faults, spec, seed, sites)
    assert ours == _schedule(jax_faults, spec, seed, sites)
    assert sum(map(len, ours[0].values())) > 0


def test_mix64_is_the_reference_hash():
    rng = np.random.default_rng(5)
    for parts in rng.integers(-(2**62), 2**62, size=(50, 3)).tolist():
        assert faults._mix64(*parts) == jax_faults._mix64(*parts)


def test_the_environment_arms_a_plan(monkeypatch):
    monkeypatch.setenv("PHOTON_FAULTS", "admit@2")
    monkeypatch.setenv("PHOTON_FAULTS_SEED", "3")
    faults.clear()
    faults.fault_point("admit")
    with pytest.raises(faults.InjectedFault):
        faults.fault_point("admit")
    assert faults.active_injector().plan.seed == 3
    assert faults.COUNTERS.get("injected_faults") == 1


def test_the_retry_policy_is_the_reference_policy(monkeypatch):
    for k, v in (("PHOTON_RETRY_MAX_ATTEMPTS", "5"), ("PHOTON_RETRY_BASE_DELAY_S", "0.01"),
                 ("PHOTON_RETRY_MAX_DELAY_S", "0.05")):
        monkeypatch.setenv(k, v)
    ours, theirs = faults.default_policy(), jax_faults.default_policy()
    assert (ours.max_attempts, ours.base_delay_s, ours.max_delay_s, ours.backoff) == \
        (theirs.max_attempts, theirs.base_delay_s, theirs.max_delay_s, theirs.backoff)
    assert [ours.delay(k) for k in range(1, 8)] == [theirs.delay(k) for k in range(1, 8)]
    assert faults.bounded_policy(2).max_attempts == jax_faults.bounded_policy(2).max_attempts == 3


def test_retry_retries_transient_failures_and_counts_them():
    calls, slept = [0], []

    def flaky():
        calls[0] += 1
        if calls[0] < 3:
            raise faults.InjectedFault("blip")
        return "ok"

    assert faults.retry(flaky, faults.bounded_policy(4), counter="shard_upload_retries",
                        sleep=slept.append) == "ok"
    assert calls[0] == 3 and len(slept) == 2
    assert faults.COUNTERS.get("shard_upload_retries") == 2

    def bug():
        calls[0] += 1
        raise ValueError("a programming error")

    calls[0] = 0
    with pytest.raises(ValueError):
        faults.retry(bug, faults.bounded_policy(4), sleep=slept.append)
    assert calls[0] == 1  # never retried


def _cuda_runtime_error():
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None:
        try:
            return accel("CUDA error: an illegal memory access was encountered")
        except TypeError:  # a constructor that wants more than a message
            pass
    return RuntimeError("CUDA error: an illegal memory access was encountered")


@pytest.mark.parametrize("exc,device", [
    (faults.InjectedFault("x"), True), (faults.DeviceHang("x"), True), (OSError("x"), True),
    (ConnectionError("x"), True), (TimeoutError("x"), True),
    (RuntimeError("CUDA error: out of memory"), True), (RuntimeError("shape mismatch"), False),
    (ValueError("x"), False), (TypeError("x"), False), (KeyError("x"), False)])
def test_device_errors_are_classified_as_in_the_reference(exc, device):
    assert faults.is_device_error(exc) is device
    if not isinstance(exc, (faults.InjectedFault, faults.DeviceHang, RuntimeError)):
        assert jax_faults.is_device_error(exc) is device


def test_the_cuda_runtime_error_is_the_counterpart_of_xla_runtime_error():
    """Where the reference retries an XlaRuntimeError, the port retries the
    error torch raises for a CUDA runtime failure."""
    assert faults.is_device_error(_cuda_runtime_error())
    xla = type("XlaRuntimeError", (RuntimeError,), {})("INTERNAL: device lost")
    assert jax_faults.is_device_error(xla)


# ------------------------------------------------------------------- watchdog


def test_watchdog_off_is_free_and_starts_no_thread(monkeypatch):
    assert watchdog_ms() == 0.0
    monkeypatch.setenv("PHOTON_WATCHDOG_MS", "250")
    assert watchdog_ms() == 250.0
    wd = Watchdog()
    with wd.guard(0, "off"):
        pass
    assert wd._thread is None
    wd.close()


def test_watchdog_trip_is_counted_journalled_and_raises_at_scope_end(tmp_path):
    tripped = threading.Event()
    labels = []

    def on_trip(label):
        labels.append(label)
        tripped.set()

    path = str(tmp_path / "journal.jsonl")
    journal = telemetry.install_journal(telemetry.RunJournal(path))
    try:
        with Watchdog(on_trip=on_trip) as wd:
            with pytest.raises(faults.DeviceHang, match="watchdog deadline"):
                with wd.guard(5.0, "slow dispatch"):
                    assert tripped.wait(WAIT_S)  # trips while the scope is still open
            with wd.guard(60_000.0, "fast dispatch"):
                pass
            assert wd.trips == 1
        assert not wd._thread.is_alive()
    finally:
        telemetry.uninstall_journal()
        journal.close()
    assert labels == ["slow dispatch"]
    assert faults.COUNTERS.get("watchdog_trips") == 1
    assert jax_telemetry.validate_journal(path) == (1, [])


# ------------------------------------------------------------------ telemetry


def test_histogram_buckets_and_quantiles_are_the_reference():
    assert telemetry.BUCKET_BOUNDS == jax_telemetry.BUCKET_BOUNDS
    rng = np.random.default_rng(11)
    samples = np.concatenate([rng.lognormal(0.0, 2.0, 3000), [0.0, 1e-9, 5e8, 1.0]])
    ours, theirs = telemetry.Histogram(), jax_telemetry.Histogram()
    for v in samples:
        ours.record(v)
        theirs.record(v)
    a, b = ours.snapshot(), theirs.snapshot()
    assert a["buckets"] == b["buckets"] and (a["count"], a["min"], a["max"]) == (b["count"], b["min"], b["max"])
    for q in (0.0, 0.01, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert ours.quantile(q) == theirs.quantile(q)
        assert telemetry.snapshot_quantile(a, q) == jax_telemetry.snapshot_quantile(b, q)
    halves = [telemetry.Histogram(), telemetry.Histogram()]
    for i, v in enumerate(samples):
        halves[i % 2].record(v)
    merged = telemetry.merge_histogram_snapshots(*(h.snapshot() for h in halves))
    assert merged["buckets"] == a["buckets"] and merged["count"] == a["count"]
    assert merged == telemetry.merge_histogram_snapshots(*(h.snapshot() for h in reversed(halves)))
    assert jax_telemetry.merge_histogram_snapshots(*(h.snapshot() for h in halves))["buckets"] == merged["buckets"]


@pytest.mark.parametrize("n", [1, 7, 500, 6000])
def test_latency_percentiles_are_the_reference(n):
    rng = np.random.default_rng(n)
    ours, theirs = telemetry.LatencyStats(reservoir=4096), jax_telemetry.LatencyStats(reservoir=4096)
    for v in rng.gamma(2.0, 3.0, n):
        ours.record(v)
        theirs.record(v)
    for q in (50.0, 95.0, 99.0):
        assert ours.percentile(q) == theirs.percentile(q)


def test_metric_names_are_declared_and_are_the_reference_names():
    for name, doc in telemetry.METRIC_DESCRIPTIONS.items():
        assert jax_telemetry.METRIC_DESCRIPTIONS[name] == doc
    with pytest.raises(KeyError):
        telemetry.METRICS.increment("not_a_metric")
    with telemetry.metric_label_scope(tenant="a"):
        faults.COUNTERS.increment("serving_shed_requests", 2)
    faults.COUNTERS.increment("serving_shed_requests")
    assert faults.counters() == {"serving_shed_requests": 3}
    assert telemetry.METRICS.labeled_counters("serving_shed_requests") == {"tenant=a": 2}


def test_spans_parent_across_a_thread_handoff_and_export(tmp_path):
    assert telemetry.span("x") is telemetry.span("y")  # the shared no-op without a tracer
    tracer = telemetry.install_tracer(telemetry.Tracer())
    try:
        registry = TimingRegistry()
        with telemetry.span("outer", k=1):
            handoff = telemetry.span_handoff()

            def worker():
                with telemetry.adopt_span(handoff), telemetry.span("inner"):
                    pass

            t = threading.Thread(target=worker, name="test-span-worker")
            t.start()
            t.join(timeout=WAIT_S)
            assert not t.is_alive()
            with stage_scope(registry), stage_timer("serve_pack"):
                pass
    finally:
        telemetry.uninstall_tracer()
    spans = {s["name"]: s for s in tracer.spans()}
    outer = spans["outer"]["args"]["span_id"]
    assert spans["inner"]["args"]["parent_id"] == outer
    assert spans["serve_pack"]["args"]["parent_id"] == outer
    assert registry.get("serve_pack") > 0.0
    doc = json.loads(open(tracer.export(str(tmp_path / "trace.json"))).read())
    assert {e["args"]["name"] for e in doc["traceEvents"] if e["ph"] == "M"} >= {"test-span-worker"}


def test_a_port_journal_passes_the_reference_validator(tmp_path):
    """One line of each event type the port emits (the training lifecycle,
    the serving path, the sweep executor, the checkpoint, the multi-host
    layers, refresh, tenancy, the shadow, the planner, the autopilot, the
    one-card reshard and the precision ladder)."""
    fields = {"setup": dict(args="{'device': 'cpu'}"), "fit_start": dict(num_samples=-1),
              "sweep_config": dict(index=0, total=2),
              "coordinate_update": dict(iteration=0, coordinate="global", seconds=0.25, accepted=True),
              "fit_finish": dict(num_configs=2, best_metric=None), "failure": dict(error="ValueError()"),
              "health_transition": dict(from_state="READY", to_state="DEGRADED", reasons=["circuit_open"]),
              "bundle_swap": dict(version=1, outcome="committed"),
              "fault_retry": dict(label="x", counter="retries", attempt=1, error="InjectedFault()"),
              "fault_injected": dict(site="score", invocation=3), "watchdog_trip": dict(label="x"),
              "shard_loss": dict(coordinate="per-user", shard_index=0),
              "shard_restage": dict(coordinate="per-user", shard_index=0, bytes=64),
              "trial_start": dict(round=0, trial=0, mode="stacked"),
              "trial_finish": dict(round=0, trial=0, mode="stacked", seconds=0.5, value=0.75,
                                   diverged_steps=0),
              "checkpoint": dict(step=3, coordinate="per-user"),
              "mesh_loss": dict(iteration=1, coordinate="per-user", surviving_devices=None,
                                source="raised"),
              "host_loss": dict(host=2, missed_beats=0, num_hosts=4, source="supervisor"),
              "host_join": dict(host=2, num_hosts=4, restaged_rows=96),
              "multihost_barrier": dict(name="fit-complete", host=0, num_hosts=4, seconds=0.25),
              "delta_fit_start": dict(mode="delta", changed_coordinates=["per-user"], delta_rows=12,
                                      total_rows=76),
              "delta_fit_finish": dict(mode="delta", changed_coordinates=["per-user"],
                                       carried_coordinates=["global"], seconds=0.25, max_rel_diff=0.5),
              "delta_apply": dict(version=1, coordinates=["per-user"], rows=3, bytes=48,
                                  source="round-0"),
              "delta_rollback": dict(version=0, reason="InjectedFault()"),
              "reshard_commit": dict(old_shards=1, new_shards=1, version=1, restaged_bytes=48),
              "tenant_admit": dict(tenant="a", device_bytes=1024, demoted_tenants=["b"]),
              "tenant_evict": dict(tenant="b", reason="hbm_pressure", freed_bytes=512, hot_rows=0),
              "tenant_restore": dict(tenant="b", reason="manual", device_bytes=512),
              "tenant_degraded": dict(tenant="a", reasons=["circuit_open"]),
              "shadow_start": dict(champion="champion", challenger="cand", window_size=64,
                                   min_windows=3, mirror_fraction=1.0),
              "shadow_window": dict(champion="champion", challenger="cand", window=1, rows=64,
                                    champion_metric=0.75, challenger_metric=0.5, evaluator="AUC",
                                    healthy=False),
              "shadow_verdict": dict(champion="champion", challenger="cand", decision="reject",
                                     windows=3, champion_metric=0.75, challenger_metric=0.5,
                                     evaluator="AUC", reason="last 3 window(s) all regressed"),
              "shadow_promote": dict(champion="champion", challenger="cand", version=1),
              "shadow_rollback": dict(champion="champion", challenger="cand", reason="regression"),
              "reshard_start": dict(old_shards=1, new_shards=1, moved_rows=4, moved_bytes=64),
              "reshard_rollback": dict(old_shards=1, new_shards=1, reason="InjectedFault()"),
              "plan_decision": dict(decision="serving_max_batch", value=32, source="profile", fallback=256),
              "autopilot_decision": dict(rule="hbm-demote", action={"kind": "demote", "tenant": "a",
                                                                    "params": {"hot_rows": 0}},
                                         evidence={"signal": 0.9}, outcome="applied"),
              "autopilot_rollback": dict(rule="bad", action={"kind": "demote", "tenant": "a", "params": {}},
                                         reason="bitwise spot-check failed for tenant 'a'"),
              "rule_quarantined": dict(rule="bad", reason="bitwise spot-check failed", rollbacks=1),
              "tier_demote": dict(tenant="a", from_tier="f32", to_tier="bf16", reason="hbm_pressure",
                                  freed_bytes=256, evidence={"quant_error_max": 0.0025,
                                                             "quantized_coordinates": 1}),
              "tier_restore": dict(tenant="a", from_tier="bf16", to_tier="f32", reason="manual",
                                   repinned_bytes=256, evidence={"quantized_coordinates": 0})}
    assert set(fields) == set(contracts.JOURNAL_EVENT_SCHEMAS)
    for etype, schema in contracts.JOURNAL_EVENT_SCHEMAS.items():
        assert schema == jax_contracts.JOURNAL_EVENT_SCHEMAS[etype]
    path = str(tmp_path / "journal.jsonl")
    with telemetry.RunJournal(path) as journal:
        for etype, kw in fields.items():
            journal.emit(etype, **kw)
        with pytest.raises(ValueError):
            journal.emit("bundle_swap", version=2)  # a missing field is refused, not written
    assert jax_telemetry.validate_journal(path) == (len(fields), [])
    assert telemetry.validate_journal(path) == (len(fields), [])
    with open(path, "a") as f:
        f.write('{"ts": 1.0, "type": "nope"}\nnot json\n')
    assert len(telemetry.validate_journal(path)[1]) == 2


def test_a_serve_profile_passes_the_reference_reader(tmp_path):
    profile = telemetry.build_profile("serve", wall_s=1.5, stages={"warmup_s": 0.5, "replay_s": 1.0},
                                      dispatch={"max_batch": 256}, bucket_shapes={"engine_buckets": [1, 2]},
                                      serving={"completed": 3}, topology=telemetry.device_topology("cpu"))
    path = telemetry.write_profile(str(tmp_path / "profile.json"), profile)
    assert jax_telemetry.read_profile(path, kind="serve")["device_topology"]["platform"] == "cpu"
    assert telemetry.read_profile(path, kind="serve") == jax_telemetry.read_profile(path, kind="serve")
    with pytest.raises(ValueError, match="fit_timing"):  # a fit profile needs its own section
        telemetry.build_profile("fit", wall_s=1.0, stages={}, dispatch={}, bucket_shapes={}, serving={},
                                topology={})
    with pytest.raises(ValueError, match="missing contract keys"):
        telemetry.write_profile(str(tmp_path / "bad.json"), {"kind": "serve"})


# ------------------------------------------------------------------ contracts


@pytest.mark.parametrize("name", ["SERVING_METRIC_KEYS", "SERVING_SHARDING_KEYS", "SERVING_CLEAN_ZERO_KEYS",
                                  "ROBUSTNESS_CLEAN_ZERO_KEYS", "SERVING_SUMMARY_KEYS", "BUNDLE_PROVENANCE_KEYS",
                                  "JOURNAL_LINE_KEYS", "PROFILE_REQUIRED_KEYS", "PROFILE_SERVE_KEYS",
                                  "PROFILE_FIT_KEYS",
                                  "PLAN_BLOCK_KEYS", "DELTA_BUNDLE_KEYS", "CONTINUOUS_SECTION_KEYS",
                                  "TENANT_BLOCK_KEYS", "TIER_BLOCK_KEYS", "SHADOW_BLOCK_KEYS",
                                  "PLAN_DECISION_KEYS", "AUTOPILOT_BLOCK_KEYS"])
def test_contract_tuples_are_the_reference_tuples(name):
    assert getattr(contracts, name) == getattr(jax_contracts, name)
