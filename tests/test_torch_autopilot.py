"""The port's closed-loop controller (`photon_ml_tpu_torch/autopilot/`) and
its one-card actuators, against the JAX package's, on the CPU.

  * the same scripted SensorSnapshot series through `sensor_fn` gives both
    loops the same journaled decisions, outcomes and actions (hysteresis,
    cooldown, the action budget, a rollback under an armed
    `autopilot_act`, a probe regression undone, quarantine and
    `reset_rule`) and the same `autopilot` block; `shard_grow_rule` takes
    `devices=1` in both (the JAX tests run on an 8-device mesh);
  * on a small port TenantRegistry with a two-tier tenant, each actuator
    (demote, restore, rebalance, retune, reshard onto one card and onto
    two CPU cards) applies
    with every answer bit-equal before and after; the precision ladder's
    actions apply (a step to bf16 answers as the quantized bundle's own
    engine, a restore to f32 bit-equal to the answers before the demotion)
    and an armed `autopilot_act` rolls back and quarantines;
  * the sensors read per-tenant latency from the labelled histograms;
  * a worker that dies fails `close()`;
  * `cli.serve --tenant x2 --autopilot --profile` writes the `autopilot`
    block and a journal both packages' `cli.obs journal --validate` accept,
    and `cli.obs decisions` prints the JAX command's rows.

Every loop here is driven by `tick()` (start=False), with no sleeps.
"""

from __future__ import annotations

import json

import pytest

from photon_ml_tpu import autopilot as jax_autopilot
from photon_ml_tpu import planner as jax_planner
from photon_ml_tpu.cli import obs as jax_obs
from photon_ml_tpu.utils import faults as jax_faults
from photon_ml_tpu.utils import telemetry as jax_telemetry
from photon_ml_tpu.utils.contracts import AUTOPILOT_BLOCK_KEYS as JAX_AUTOPILOT_BLOCK_KEYS
from photon_ml_tpu_torch import autopilot, planner
from photon_ml_tpu_torch.cli import obs
from photon_ml_tpu_torch.cli import serve as serve_cli
from photon_ml_tpu_torch.contracts import AUTOPILOT_BLOCK_KEYS
from photon_ml_tpu_torch.parallel.mesh import surviving_mesh
from photon_ml_tpu_torch.serving import ServingEngine, TenantRegistry
from photon_ml_tpu_torch.serving.bundle import quantize_bundle_rows
from photon_ml_tpu_torch.utils import faults, telemetry

from tests.test_torch_tenancy import _bundle, _docs, _reqs, _save, _write_requests

pytestmark = pytest.mark.serving

PKGS = {"port": (autopilot, planner, faults, telemetry),
        "jax": (jax_autopilot, jax_planner, jax_faults, jax_telemetry)}


@pytest.fixture(autouse=True)
def _hygiene(monkeypatch):
    monkeypatch.setenv("PHOTON_RETRY_BASE_DELAY_S", "0.001")
    for k in ("PHOTON_PLAN", "PHOTON_PLAN_PROFILE", "PHOTON_AUTOPILOT_MS"):
        monkeypatch.delenv(k, raising=False)
    for _, pl, fl, tl in PKGS.values():
        pl.uninstall_plan()
        fl.clear()
    telemetry.METRICS.reset()
    yield
    for _, pl, fl, tl in PKGS.values():
        pl.uninstall_plan()
        fl.clear()
    telemetry.METRICS.reset()


# ------------------------------------------------------- scripted sensors


def _snapshot(sensors, step):
    """One scripted step as `sensors`' (either package's) SensorSnapshot:
    tenant "a" single-tier, "b" two-tier; a 1,000-byte budget."""
    pressure, load_a, promos_b, qwait = step
    coord = sensors.CoordinateSensors
    tenants = {
        "a": sensors.TenantSensors(
            name="a", demoted=False, can_demote=True, last_active=1.0, completed=10, failed=0,
            in_flight=0, pending=0, device_bytes=400, p95_ms=3.0, p99_ms=4.0,
            coords=(coord("per-e", 1, False, False, (load_a,), 0, 200),)),
        "b": sensors.TenantSensors(
            name="b", demoted=False, can_demote=True, last_active=2.0, completed=10, failed=0,
            in_flight=0, pending=0, device_bytes=100, p95_ms=2.0, p99_ms=5.0,
            coords=(coord("per-e", 1, False, True, (), promos_b, 60),)),
    }
    return sensors.SensorSnapshot(tenants=tenants, hbm_budget=1000, hbm_used=int(pressure * 1000),
                                  latency_p95_ms=3.0, latency_p99_ms=5.0, queue_wait_p95_ms=qwait,
                                  batch_p50=4.0, failed_requests=0)


class _Orchestrator:
    def __init__(self, log, name):
        self.log, self.name = log, name

    def reshard(self, new_mesh=None):
        self.log.append(("reshard", self.name, new_mesh))

    def rebalance(self, cid):
        self.log.append(("rebalance", self.name, cid))


class _Stub:
    """The registry surface the loops actuate, recording every call."""

    class _Tenant:
        def __init__(self, log, name):
            self.failed = 0
            self.engine = type("E", (), {})()
            self.engine.reshard_orchestrator = _Orchestrator(log, name)
            self.engine._state = type("S", (), {"bundle": type("B", (), {"coordinates": {}})()})()

    def __init__(self):
        self.log = []
        self._device = None
        self.wait = 2.0
        self._tenants = {n: self._Tenant(self.log, n) for n in ("a", "b")}
        self.tenant_names = list(self._tenants)

    def tenant(self, name):
        return self._tenants[name]

    def demote(self, name, hot_rows=0, reason=""):
        self.log.append(("demote", name, hot_rows, reason))

    def restore(self, name, reason=""):
        self.log.append(("restore", name, reason))

    def retune(self, max_wait_ms=None):
        prev, self.wait = self.wait, max_wait_ms
        self.log.append(("retune", max_wait_ms))
        return {"max_wait_ms": prev}


# (pressure, tenant a's load, tenant b's promotions, p95 queue wait ms)
LADDER = [(0.5, 0, 0, None), (0.9, 5000, 100, 20.0), (0.9, 10000, 200, 20.0),
          (0.5, 10000, 200, 20.0), (0.9, 20000, 300, 20.0)]


def _bad_rule(pkg, stub):
    """A rule whose action fails the probe (a failed request): undone."""
    ap = PKGS[pkg][0]

    def apply():
        stub.tenant("a").failed += 1

    def undo():
        stub.log.append(("undo-bad",))

    return ap.ControlRule(name="bad", signal=lambda c, p: 1.0, fire_above=0.5, rearm_below=0.1,
                          decide=lambda c, p, s: ap.Action(kind="demote", tenant="a", apply_fn=apply,
                                                           undo_fn=undo, evidence={"why": "test"}))


def _run_script(pkg, tmp_path, scenario):
    ap, pl, fl, tl = PKGS[pkg]
    stub = _Stub()
    journal = tl.RunJournal(str(tmp_path / f"{pkg}-{scenario}.jsonl"))
    tl.install_journal(journal)
    try:
        if scenario == "ladder":
            rules = [ap.hbm_demote_rule(), ap.hbm_restore_rule(), ap.shard_grow_rule(devices=1),
                     ap.rebalance_rule(), ap.retune_rule()]
            loop = ap.Autopilot(stub, rules=rules, cooldown_s=60.0, max_actions=3, start=False,
                                sensor_fn=lambda reg: _snapshot(ap.sensors, steps[i]))
            steps = LADDER
            for i in range(len(steps)):
                loop.tick()
        else:  # rollback, quarantine and reset
            rules = [ap.hbm_demote_rule(), ap.retune_rule(), _bad_rule(pkg, stub)]
            loop = ap.Autopilot(stub, rules=rules, cooldown_s=0.0, max_actions=100, start=False,
                                sensor_fn=lambda reg: _snapshot(ap.sensors, steps[i]))
            steps = [LADDER[0], LADDER[1], LADDER[3], LADDER[4], LADDER[4]]
            for i in range(len(steps)):
                if i == 1:
                    with fl.inject("autopilot_act:1"):
                        loop.tick()
                else:
                    if i == 4:
                        loop.reset_rule("hbm-demote")
                    loop.tick()
        loop.close()
        summary = loop.summary()
    finally:
        tl.uninstall_journal()
        journal.close()
    lines = [json.loads(x) for x in open(tmp_path / f"{pkg}-{scenario}.jsonl")]
    return [{k: v for k, v in d.items() if k != "ts"} for d in lines], stub.log, summary


@pytest.mark.parametrize("scenario", ["ladder", "rollback"])
def test_scripted_sensors_give_both_loops_the_same_decisions(scenario, tmp_path):
    port = _run_script("port", tmp_path, scenario)
    ref = _run_script("jax", tmp_path, scenario)
    assert port[0] == ref[0]  # every journal line: decisions, rollbacks, quarantines, plan lines
    assert port[1] == ref[1]  # the actuators' calls
    assert port[2] == ref[2] and tuple(port[2]) == AUTOPILOT_BLOCK_KEYS == JAX_AUTOPILOT_BLOCK_KEYS
    outcomes = [(d["rule"], d["outcome"]) for d in port[0] if d["type"] == "autopilot_decision"]
    if scenario == "ladder":
        assert outcomes == [("hbm-demote", "applied"), ("shard-grow", "applied"),
                            ("hot-row-rebalance", "applied"), ("wait-retune", "suppressed_budget"),
                            ("wait-retune", "suppressed_budget"), ("wait-retune", "suppressed_budget"),
                            ("hbm-demote", "suppressed_cooldown"), ("shard-grow", "suppressed_cooldown"),
                            ("hot-row-rebalance", "suppressed_cooldown"),
                            ("wait-retune", "suppressed_budget")]
        assert port[1] == [("demote", "a", 0, "autopilot"), ("reshard", "a", None),
                           ("rebalance", "b", "per-e")]
    else:
        # "bad" fires once (its probe sees a failed request: undone) and holds
        # disarmed after; hbm-demote's first firing meets the armed fault.
        assert outcomes == [("bad", "rolled_back"), ("hbm-demote", "rolled_back"),
                            ("wait-retune", "applied"), ("hbm-demote", "suppressed_quarantined"),
                            ("hbm-demote", "applied")]
        assert port[1] == [("undo-bad",), ("retune", 1.0), ("demote", "a", 0, "autopilot")]
        assert port[2]["quarantined"] == ["bad"] and port[2]["rollbacks"] == 2
        assert planner.planned_value("serving_max_wait_ms") == 1.0


# ------------------------------------------------- the port's actuators


def _scores(reg, names, reqs):
    futs = [(n, reg.submit(n, r, block=True)) for r in reqs for n in names]
    out = {n: [] for n in names}
    for n, f in futs:
        res = f.result(timeout=60)
        out[n].append((res.score, res.mean))
    return out


def _rule(kind, tenant, **params):
    # A ladder step names its rung as the built-in rules do: the probe holds
    # it to the coarser rung's tolerance.
    evidence = {"from_tier": "bf16"} if kind == "tier_restore" else {}
    return autopilot.ControlRule(
        name=kind, signal=lambda c, p: 1.0, fire_above=0.5, rearm_below=0.0,
        decide=lambda c, p, s: autopilot.Action(kind=kind, tenant=tenant, params=params,
                                                evidence=evidence))


ACTIONS = {
    "demote": ("a", {"hot_rows": 2}),
    "restore": ("a", {}),
    "rebalance": ("b", {"cid": "per-e"}),
    "retune": (None, {"serving_max_wait_ms": 0.5}),
    "reshard": ("a", {"devices": 1}),
    "reshard_cards": ("a", {"devices": 2}),
    "tier_demote": ("a", {"to": "bf16"}),
    "tier_restore": ("a", {"to": "f32"}),
    "fault": ("a", {"hot_rows": 0}),
}


@pytest.mark.parametrize("case", list(ACTIONS))
def test_each_actuator_keeps_every_answer_bit_equal(case):
    reqs = _reqs(_docs(5, 40))
    with TenantRegistry(max_batch=8, max_wait_ms=1.0) as reg:
        reg.admit("a", _bundle(0))
        reg.admit("b", _bundle(1, hot_rows=2))  # two-tier, solo
        store = reg.tenant("b").engine.bundle.coordinates["per-e"].store
        for _ in range(3):  # rows promoted, evicted and promoted again: the rebalance's stats
            _scores(reg, ["b"], reqs)
            store.drain()
        f32 = _scores(reg, ["a", "b"], reqs)
        if case == "restore":
            reg.demote("a")
        elif case == "tier_restore":
            reg.demote_tier("a", to="bf16")
        before = _scores(reg, ["a", "b"], reqs)
        tenant, params = ACTIONS[case]
        kind = {"fault": "demote", "reshard_cards": "reshard"}.get(case, case)
        pilot = autopilot.Autopilot(reg, rules=[_rule(kind, tenant, **params)], start=False,
                                    cooldown_s=0.0, probe_requests={"a": reqs[0], "b": reqs[1]})
        if case == "fault":
            with faults.inject("autopilot_act:1"):
                pilot.tick()
        else:
            pilot.tick()
        pilot.close()
        after = _scores(reg, ["a", "b"], reqs)
        summary = pilot.summary()
        metrics = {n: reg.tenant(n).engine.metrics() for n in ("a", "b")}
        reg_metrics = reg.metrics()
        demoted = reg.tenant("a").demoted
        tier = reg.tenant("a").tier
        new_store = reg.tenant("b").engine.bundle.coordinates["per-e"].store
        mesh = reg.tenant("a").engine.bundle.coordinates["per-e"].mesh
    assert (mesh is not None and mesh.size == 2) == (case == "reshard_cards")
    if case == "tier_demote":  # a ladder step: "a" answers from its bf16 rows, the others bit-equal
        assert after["b"] == before["b"] and tier == "bf16" and after["a"] != before["a"]
        with ServingEngine(quantize_bundle_rows(_bundle(0), "bf16")[0], max_batch=8) as eng:
            assert after["a"] == [(r.score, r.mean) for r in eng.score_batch(reqs)]
    elif case == "tier_restore":  # back on f32: bit-equal to the answers before the demotion
        assert after == f32 and tier == "f32"
    else:
        assert before == after  # every answer, bit for bit
    if case == "fault":
        assert summary["rollbacks"] == 1 and summary["quarantined"] == [kind]
        assert faults.COUNTERS.get("autopilot_quarantines") == 1 and not demoted
        return
    assert summary["actions"] == 1 and summary["rollbacks"] == 0 and summary["last_outcome"] == "applied"
    assert reg_metrics["cobatch_compiles_after_warmup"] == 0
    if case == "demote":
        assert demoted
    elif case == "restore":
        assert not demoted
    elif case == "rebalance":
        assert metrics["b"]["bundle_rebalances"] == 1 and new_store is not store
        stats = store.promotion_stats()
        assert set(new_store.preloaded_rows) <= {r for r, n in stats.items() if n >= 2}
        assert faults.COUNTERS.get("rebalanced_rows") == len(new_store.preloaded_rows) > 0
    elif case == "retune":
        assert reg.max_wait_s == 0.5e-3 and planner.planned_value("serving_max_wait_ms") == 0.5
    elif case in ("tier_demote", "tier_restore"):
        assert faults.COUNTERS.get("tier_demotions" if case == "tier_demote" else "tier_restores") == 1
    else:
        assert metrics["a"]["bundle_reshards"] == 1 and metrics["a"]["bundle_version"] == 1


def test_reshard_across_cards_and_the_ladder_raise_naming_their_items():
    # A reshard across cards is ported: onto two CPU cards and back, the
    # answers bit-equal, the sharded tenant solo (no co-batch signature).
    reqs = _reqs(_docs(5, 16))
    with TenantRegistry(max_batch=4) as reg:
        reg.admit("a", _bundle(0))
        orch = reg.tenant("a").engine.reshard_orchestrator
        before = _scores(reg, ["a"], reqs)
        assert orch.reshard(surviving_mesh(2, device="cpu"))["new_shards"] == 2
        assert reg.tenant("a").signature() is None and _scores(reg, ["a"], reqs) == before
        assert orch.reshard(None)["new_shards"] == 1 and _scores(reg, ["a"], reqs) == before
        with pytest.raises(ValueError, match="two-tier store"):
            orch.rebalance("per-e")
        # The precision ladder is ported: one rung down and back.
        assert reg.demote_tier("a") > 0 and reg.tenant("a").tier == "bf16"
        assert reg.restore_tier("a") > 0 and reg.tenant("a").tier == "f32"
        assert reg.tenant("a").engine.metrics()["bundle_reshard_rollbacks"] == 0


def test_a_failed_rebalance_rolls_back_and_keeps_serving():
    reqs = _reqs(_docs(6, 24))
    with TenantRegistry(max_batch=8, max_wait_ms=1.0) as reg:
        reg.admit("b", _bundle(1, hot_rows=2))
        store = reg.tenant("b").engine.bundle.coordinates["per-e"].store
        for _ in range(3):
            _scores(reg, ["b"], reqs)
            store.drain()
        before = _scores(reg, ["b"], reqs)
        with faults.inject("reshard_commit:1"), pytest.raises(faults.InjectedFault):
            reg.tenant("b").engine.reshard_orchestrator.rebalance("per-e")
        after = _scores(reg, ["b"], reqs)
        m = reg.tenant("b").engine.metrics()
        live = reg.tenant("b").engine.bundle.coordinates["per-e"].store
    assert before == after and live is store
    assert m["bundle_reshard_rollbacks"] == 1 and m["bundle_rebalances"] == 0 and m["bundle_version"] == 0
    assert faults.COUNTERS.get("reshard_rollbacks") == 1


def test_the_sensors_read_each_tenants_labelled_latency():
    reqs = _reqs(_docs(7, 16))
    with TenantRegistry(max_batch=8, max_wait_ms=1.0) as reg:
        reg.admit("a", _bundle(0))
        reg.admit("b", _bundle(1, hot_rows=2))
        _scores(reg, ["a", "b"], reqs)
        reg.tenant("b").engine.bundle.coordinates["per-e"].store.drain()
        snap = autopilot.read_sensors(reg)
    assert set(telemetry.METRICS.labeled_histograms("serving_latency_ms")) == {"tenant=a", "tenant=b"}
    for name in ("a", "b"):
        t = snap.tenants[name]
        assert t.completed == 16 and t.p95_ms is not None and t.p99_ms >= t.p95_ms
        assert t.tier == "f32" and t.can_quantize == (name == "a")  # "b" is two-tier
    assert snap.tenants["a"].coords[0].total_load > 0 and not snap.tenants["a"].coords[0].two_tier
    assert snap.tenants["b"].coords[0].two_tier and snap.tenants["b"].coords[0].promotions > 0
    assert snap.hbm_budget is None and snap.hbm_pressure is None  # no budget on the CPU
    assert snap.hbm_used == sum(t.device_bytes for t in snap.tenants.values())


def test_a_dead_worker_fails_close():
    def broken(reg):
        raise RuntimeError("sensor read failed")

    with TenantRegistry(max_batch=4) as reg:
        pilot = autopilot.Autopilot(reg, tick_ms=1, sensor_fn=broken)
        worker = pilot._worker
        worker.join(timeout=30)
        assert not worker.is_alive()
        with pytest.raises(autopilot.AutopilotFailure, match="sensor read failed"):
            pilot.close()


def _obs_out(main, argv, capsys):
    code = main(argv)
    return code, capsys.readouterr().out


def test_cli_serve_autopilot_writes_its_block_and_a_journal_both_readers_accept(tmp_path, monkeypatch,
                                                                                   capsys):
    for k in range(2):
        _save(tmp_path / f"m{k}", k)
    _write_requests(tmp_path / "r.jsonl", _docs(11, 40))
    common = ["--requests", str(tmp_path / "r.jsonl"), "--logging-level", "WARNING", "--device", "cpu",
              "--tenant", f"a={tmp_path / 'm0'}", "--tenant", f"b={tmp_path / 'm1'}"]
    first = serve_cli.main([*common, "--root-output-directory", str(tmp_path / "first")])
    monkeypatch.setenv("PHOTON_AUTOPILOT_MS", "1")
    out = tmp_path / "auto"
    summary = serve_cli.main([*common, "--root-output-directory", str(out), "--autopilot",
                              "--profile", str(tmp_path / "first" / "profile.json"), "--max-wait-ms", "1"])
    assert planner.current_plan() is None  # the run's plan is gone with it
    assert first["plan"] == planner.inactive_block() and first["autopilot"] == {}
    block = summary["autopilot"]
    assert tuple(block) == AUTOPILOT_BLOCK_KEYS and block["status"] == "stopped"
    assert block["rules"] == ["hbm-demote", "hbm-restore", "shard-grow", "hot-row-rebalance", "wait-retune"]
    assert block["tick_ms"] == 1 and block["rollbacks"] == 0 and block["quarantined"] == []
    assert summary["failed_requests"] == 0 and summary["num_requests"] == 40
    plan = summary["plan"]
    assert plan["active"] and plan["source"] == "profile"
    decisions = {d["decision"]: d for d in plan["decisions"]}
    assert decisions["serving_max_wait_ms"]["source"] == "knob"  # --max-wait-ms pins it
    assert decisions["serving_max_batch"]["source"] == "profile"
    assert summary["serving"]["max_batch"] == decisions["serving_max_batch"]["value"]
    journal = str(out / "journal.jsonl")
    for main in (obs.main, jax_obs.main):
        code, _ = _obs_out(main, ["journal", journal, "--validate"], capsys)
        assert code == 0
    ours = _obs_out(obs.main, ["decisions", journal], capsys)
    theirs = _obs_out(jax_obs.main, ["decisions", journal], capsys)
    assert ours == theirs and ours[0] == 0 and "plan      serving_max_batch" in ours[1]
    # The scripted loops' journals: rollbacks and quarantines under the rows.
    _run_script("port", tmp_path, "rollback")
    scripted = str(tmp_path / "port-rollback.jsonl")
    ours = _obs_out(obs.main, ["decisions", scripted], capsys)
    assert ours == _obs_out(jax_obs.main, ["decisions", scripted], capsys)
    assert "ROLLBACK  bad (demote)" in ours[1] and "QUARANTINE hbm-demote after 1 rollback(s)" in ours[1]
