"""The port's precision ladder (f32 -> bf16 -> int8 -> host) for served
random effects, against the JAX package's, on the CPU.

The cases of tests/test_precision_tiers.py on the port, at its shape (7
fixed-effect and 5 random-effect features, 24 entities), with weights and
requests drawn by numpy from a seed and given to both packages:

  * quantized planes, scales and round-trip errors equal the reference's
    bit for bit (both round on the host in numpy; bf16 to nearest even),
    dequantize within TIER_TOLERANCES, take the reference's device bytes,
    and restore bit-equal; a reshard refuses a quantized coordinate;
  * a tenant walked down the ladder answers within TIER_TOLERANCES[rung]
    of its f32 answers, within PORT_TOLERANCES["convert_scores"] of the JAX
    registry's answers at the same rung, and bit-equal after a restore;
    the int8 ceiling refuses before the commit; a quantized tenant is
    served solo; the pressure valve makes the reference's choices with the
    ladder on (a rung down before the host tier) and off (the host tier);
  * transient and terminal `quantize_stage`/`tier_restore` faults, and
    chaos confined to the transitioning tenant;
  * the journal passes both packages' validators, its transitions are the
    reference's, and `cli.obs decisions` prints the JAX command's rows;
  * the ladder-aware rules decide as the reference's on the same snapshots;
  * the autopilot holds a ladder step's probe to TIER_TOLERANCES (every
    other action stays bitwise), and rolls back an injected fault.

Every wait is on a future, never on a clock.
"""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu import autopilot as jax_autopilot
from photon_ml_tpu.cli import obs as jax_obs
from photon_ml_tpu.game.model import Coefficients as JaxCoefficients
from photon_ml_tpu.game.model import FixedEffectModel as JaxFixedEffectModel
from photon_ml_tpu.game.model import GameModel as JaxGameModel
from photon_ml_tpu.game.model import RandomEffectModel as JaxRandomEffectModel
from photon_ml_tpu.serving import ScoreRequest as JaxScoreRequest
from photon_ml_tpu.serving import ServingBundle as JaxServingBundle
from photon_ml_tpu.serving import bundle as jax_bundle
from photon_ml_tpu.serving.reshard import plan_coordinate_reshard
from photon_ml_tpu.serving.tenancy import TenantRegistry as JaxTenantRegistry
from photon_ml_tpu.serving.tenancy import TierErrorCeilingExceeded as JaxTierErrorCeilingExceeded
from photon_ml_tpu.transformers.game_transformer import CoordinateScoringSpec as JaxSpec
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu.utils import telemetry as jax_telemetry
from photon_ml_tpu.utils.contracts import JOURNAL_EVENT_SCHEMAS, TIER_BLOCK_KEYS
from photon_ml_tpu.utils.contracts import TIER_TOLERANCES as JAX_TIER_TOLERANCES
from photon_ml_tpu_torch import autopilot
from photon_ml_tpu_torch.cli import obs
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES, TIER_TOLERANCES
from photon_ml_tpu_torch.game.model import Coefficients, FixedEffectModel, GameModel, RandomEffectModel
from photon_ml_tpu_torch.serving import ScoreRequest, ServingBundle, ServingEngine, TenantRegistry
from photon_ml_tpu_torch.serving.bundle import (
    PRECISION_LADDER,
    quantize_bundle_rows,
    restore_bundle_precision,
)
from photon_ml_tpu_torch.serving.reshard import plan_reshard
from photon_ml_tpu_torch.serving.tenancy import TierErrorCeilingExceeded
from photon_ml_tpu_torch.transformers.game_transformer import CoordinateScoringSpec
from photon_ml_tpu_torch.types import TaskType
from photon_ml_tpu_torch.utils import faults, telemetry

pytestmark = pytest.mark.serving

TASK = TaskType.LOGISTIC_REGRESSION
JTASK = JaxTaskType.LOGISTIC_REGRESSION
D_FE, D_RE, E = 7, 5, 24
TOL = PORT_TOLERANCES["convert_scores"]  # float32 scoring in two frameworks
QUANTIZED = PRECISION_LADDER[1:]


@pytest.fixture(autouse=True)
def _hygiene(monkeypatch):
    """The port's fault plan and counters are its own process globals."""
    monkeypatch.setenv("PHOTON_RETRY_BASE_DELAY_S", "0.001")
    for k in ("PHOTON_TIER_LADDER", "PHOTON_TIER_INT8_ERROR_CEILING"):
        monkeypatch.delenv(k, raising=False)
    faults.clear()
    telemetry.METRICS.reset()
    yield
    faults.clear()
    telemetry.METRICS.reset()


def _weights(seed):
    r = np.random.default_rng(seed)
    w = r.normal(size=D_FE).astype(np.float32)
    M = np.zeros((E + 1, D_RE), np.float32)
    M[:E] = r.normal(size=(E, D_RE))
    return w, M


def _bundle(seed):
    w, M = _weights(seed)
    model = GameModel({"fixed": FixedEffectModel(Coefficients(torch.from_numpy(w)), TASK),
                       "per-e": RandomEffectModel(torch.from_numpy(M), None, TASK)})
    specs = {"fixed": CoordinateScoringSpec(shard="g"),
             "per-e": CoordinateScoringSpec(shard="re", random_effect_type="eid",
                                            entity_index={str(i): i for i in range(E)})}
    return ServingBundle.from_model(model, specs, TASK, device="cpu")


def _jax_bundle(seed):
    w, M = _weights(seed)
    model = JaxGameModel({"fixed": JaxFixedEffectModel(JaxCoefficients(jnp.asarray(w)), JTASK),
                          "per-e": JaxRandomEffectModel(jnp.asarray(M), None, JTASK)})
    specs = {"fixed": JaxSpec(shard="g"),
             "per-e": JaxSpec(shard="re", random_effect_type="eid",
                              entity_index={str(i): i for i in range(E)})}
    return JaxServingBundle.from_model(model, specs, JTASK)


def _requests(seed, n, cls=ScoreRequest):
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, D_FE)).astype(np.float32)
    Xe = r.normal(size=(n, D_RE)).astype(np.float32)
    ids = r.integers(0, E + 6, size=n)  # trained entities and cold starts
    return [cls(features={"g": X[i], "re": Xe[i]}, entity_ids={"eid": str(int(ids[i]))},
                offset=float(i) * 0.125, uid=str(i)) for i in range(n)]


def _scores(reg, name, reqs) -> np.ndarray:
    return np.asarray([reg.score(name, r).score for r in reqs], np.float64)


def _within(got, ref, tier) -> bool:
    tol = TIER_TOLERANCES[tier]
    return bool(np.allclose(got, ref, rtol=tol["rtol"], atol=tol["atol"]))


def _bits(plane) -> np.ndarray:
    """A plane's raw bits (bf16 as uint16) from either package."""
    if isinstance(plane, torch.Tensor):
        return plane.view(torch.int16).numpy().view(np.uint16) if plane.dtype == torch.bfloat16 \
            else plane.numpy()
    a = np.asarray(plane)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def test_the_tolerances_are_the_references():
    assert TIER_TOLERANCES == JAX_TIER_TOLERANCES and PRECISION_LADDER == jax_bundle.PRECISION_LADDER


# =========================================================== quantized planes


class TestQuantizedPlanes:
    @pytest.mark.parametrize("tier", QUANTIZED)
    def test_planes_scales_and_errors_are_the_references(self, tier):
        bundle, ref_bundle = _bundle(1), _jax_bundle(1)
        original = bundle.coordinates["per-e"].params.numpy().copy()
        q, errors = quantize_bundle_rows(bundle, tier)
        jq, jerrors = jax_bundle.quantize_bundle_rows(ref_bundle, tier)
        c, jc = q.coordinates["per-e"], jq.coordinates["per-e"]
        assert c.tier == jc.tier == tier and errors == jerrors and set(errors) == {"per-e"}
        assert np.array_equal(_bits(c.params), _bits(jc.params))
        if tier == "int8":
            assert c.params.dtype == torch.int8
            assert np.array_equal(c.scales.numpy(), np.asarray(jc.scales))
            deq = c.params.numpy().astype(np.float32) * c.scales.numpy()[:, None]
        else:
            assert c.params.dtype == torch.bfloat16 and c.scales is None and jc.scales is None
            deq = c.params.float().numpy()
        assert _within(deq, original, tier) and errors["per-e"] >= 0.0
        assert not deq[E].any()  # the pinned zero row stays zero
        assert np.array_equal(c.host_f32, original)  # the original rows, for the restore
        assert q.coordinates["fixed"] is bundle.coordinates["fixed"]  # carried by reference
        r = restore_bundle_precision(q)
        assert r.coordinates["per-e"].tier == "f32"
        assert np.array_equal(r.coordinates["per-e"].params.numpy(), original)
        for b in (r, q, bundle):
            b.release(close_stores=False)
        for b in (jq, ref_bundle):
            b.release(close_stores=False)

    def test_the_quantized_plane_is_smaller(self):
        bundle, ref_bundle = _bundle(2), _jax_bundle(2)
        sizes = {"f32": bundle.coordinates["per-e"].device_nbytes()}
        for tier in QUANTIZED:
            q, _ = quantize_bundle_rows(bundle, tier)
            jq, _ = jax_bundle.quantize_bundle_rows(ref_bundle, tier)
            sizes[tier] = q.coordinates["per-e"].device_nbytes()
            assert sizes[tier] == jq.coordinates["per-e"].device_nbytes()
            assert q.device_bytes() == jq.device_bytes_per_shard()
        # The int8 plane and its float32 scales still beat the bf16 plane.
        assert sizes["int8"] < sizes["bf16"] < sizes["f32"]

    def test_reshard_refuses_a_quantized_coordinate(self):
        q, _ = quantize_bundle_rows(_bundle(3), "bf16")
        jq, _ = jax_bundle.quantize_bundle_rows(_jax_bundle(3), "bf16")
        with pytest.raises(ValueError, match="quantized"):
            plan_reshard(q, None)
        with pytest.raises(ValueError, match="quantized"):
            plan_coordinate_reshard(jq.coordinates["per-e"], None)
        with pytest.raises(ValueError, match="quantized"):
            q.restage_shard("per-e", 0)


# ========================================================== serving parity


def _walk(reg, name, reqs, steps):
    """Scores and the tier block after each (method, kwargs) step."""
    out = []
    for method, kw in steps:
        getattr(reg, method)(name, reason="test", **kw)
        out.append((_scores(reg, name, reqs), dict(reg.metrics()["tenants"][name]["tier"])))
    return out


LADDER_WALK = [("demote_tier", {}), ("demote_tier", {}), ("demote_tier", {}), ("restore_tier", {})]


class TestServingParity:
    def test_ladder_down_within_tolerance_and_restore_bitwise(self):
        reqs, jreqs = _requests(7, 12), _requests(7, 12, JaxScoreRequest)
        with TenantRegistry(max_batch=4, max_wait_ms=1.0) as reg, \
                JaxTenantRegistry(max_batch=4, max_wait_ms=1.0) as jreg:
            reg.admit("a", _bundle(1))
            jreg.admit("a", _jax_bundle(1))
            ref = _scores(reg, "a", reqs)
            jref = _scores(jreg, "a", jreqs)
            ours = _walk(reg, "a", reqs, LADDER_WALK)
            theirs = _walk(jreg, "a", jreqs, LADDER_WALK)
            m = reg.metrics()["tenants"]["a"]
            jreg.close(release_bundles=True)
            reg.close(release_bundles=True)
        assert np.allclose(ref, jref, **TOL)
        for (got, block), (jgot, jblock), rung in zip(ours, theirs, ("bf16", "int8", "int8", "f32")):
            assert block == jblock and tuple(block) == TIER_BLOCK_KEYS
            assert _within(got, ref, rung) and np.allclose(got, jgot, **TOL)
        assert not np.array_equal(ours[0][0], ref)  # bf16 rows move answers
        assert np.array_equal(ours[2][0], ref)  # the host tier holds the original rows
        assert np.array_equal(ours[3][0], ref)  # and the restore lands on f32, bit-equal
        assert m["tier"]["demotions"] == 2 and m["tier"]["quant_error_max"] > 0
        assert m["failed"] == 0 and not m["demoted"]

    def test_direct_rung_restore_is_bitwise(self):
        reqs = _requests(9, 10)
        with TenantRegistry(max_batch=4, max_wait_ms=1.0) as reg:
            reg.admit("a", _bundle(4))
            ref = _scores(reg, "a", reqs)
            freed = reg.demote_tier("a", to="int8", reason="test")
            assert reg.tenant("a").tier == "int8" and freed > 0
            assert reg.restore_tier("a", reason="test") > 0
            assert reg.tenant("a").tier == "f32"
            assert np.array_equal(_scores(reg, "a", reqs), ref)
            assert faults.COUNTERS.get("tier_demotions") == 2
            assert faults.COUNTERS.get("tier_restores") == 2  # int8 -> bf16 -> f32
            reg.close(release_bundles=True)

    def test_int8_error_ceiling_refuses_before_the_commit(self, monkeypatch):
        monkeypatch.setenv("PHOTON_TIER_INT8_ERROR_CEILING", "1e-9")
        reqs, jreqs = _requests(11, 8), _requests(11, 8, JaxScoreRequest)
        with TenantRegistry(max_batch=4, max_wait_ms=1.0) as reg, \
                JaxTenantRegistry(max_batch=4, max_wait_ms=1.0) as jreg:
            reg.admit("a", _bundle(5))
            jreg.admit("a", _jax_bundle(5))
            ref = _scores(reg, "a", reqs)
            for r, exc in ((reg, TierErrorCeilingExceeded), (jreg, JaxTierErrorCeilingExceeded)):
                r.demote_tier("a", to="bf16", reason="test")
                with pytest.raises(exc):
                    r.demote_tier("a", to="int8", reason="test")
            t = reg.tenant("a")
            version = t.engine._state.version
            assert t.tier == "bf16" and t.tier_rollbacks == 1 and version == 1
            assert _within(_scores(reg, "a", reqs), ref, "bf16")
            # Walking past int8 to the host tier skips the refused rung.
            reg.demote_tier("a", to="host", reason="test")
            jreg.demote_tier("a", to="host", reason="test")
            assert t.demoted and np.array_equal(_scores(reg, "a", reqs), ref)
            block = reg.metrics()["tenants"]["a"]["tier"]
            assert block == jreg.metrics()["tenants"]["a"]["tier"]
            jreg.close(release_bundles=True)
            reg.close(release_bundles=True)

    def test_a_quantized_tenant_is_served_solo(self):
        reqs = _requests(13, 12)
        with TenantRegistry(max_batch=4, max_wait_ms=1.0) as reg:
            reg.admit("a", _bundle(1))
            reg.admit("b", _bundle(2))
            reg.demote_tier("b", reason="test")
            assert reg.tenant("a").signature() is not None and reg.tenant("b").signature() is None
            got = {n: _scores(reg, n, reqs) for n in ("a", "b")}
            m = reg.metrics()
            solo_b = reg.tenant("b").bundle
            with ServingEngine(solo_b, max_batch=4) as eng:
                alone = np.asarray([r.score for r in eng.score_batch(reqs)], np.float64)
            reg.close(release_bundles=True)
        assert m["tenants"]["b"]["cobatched_requests"] == 0 and m["tenants"]["a"]["cobatched_requests"] > 0
        assert m["tenants"]["b"]["tier"]["quantized_coords"] == 1
        assert np.array_equal(got["b"], alone)
        assert m["cobatch_compiles_after_warmup"] == 0

    @pytest.mark.parametrize("ladder", [True, False])
    def test_the_valve_makes_the_references_choices(self, ladder, monkeypatch):
        """Ladder on: the coldest tenant steps a rung down, not to the host
        tier. Ladder off: it is demoted to the host tier, as before."""
        if ladder:
            monkeypatch.setenv("PHOTON_TIER_LADDER", "1")
        per = _bundle(10).device_bytes()
        views = {}
        for label, cls, make, rq in (("port", TenantRegistry, _bundle, ScoreRequest),
                                     ("jax", JaxTenantRegistry, _jax_bundle, JaxScoreRequest)):
            with cls(max_batch=4, max_wait_ms=1.0, hbm_budget_bytes=int(per * 3 - 100)) as reg:
                reg.admit("cold", make(10))
                reg.admit("warm", make(11))
                reg.score("warm", _requests(62, 1, rq)[0])  # "cold" is the coldest
                reg.admit("new", make(12))  # over the budget
                m = reg.metrics()
                views[label] = {n: (b["demoted"], b["tier"]["tier"], b["device_bytes"])
                                for n, b in m["tenants"].items()}
                reg.close(release_bundles=True)
        assert views["port"] == views["jax"]
        cold = views["port"]["cold"]
        assert (cold[0], cold[1]) == ((False, "bf16") if ladder else (True, "f32"))
        assert views["port"]["warm"][1] == views["port"]["new"][1] == "f32"


# ======================================================== fault injection


@pytest.mark.chaos
class TestLadderFaults:
    def test_a_transient_quantize_fault_retries_and_commits(self):
        reqs = _requests(21, 8)
        with TenantRegistry(max_batch=4, max_wait_ms=1.0) as reg:
            reg.admit("a", _bundle(6))
            ref = _scores(reg, "a", reqs)
            with faults.inject("quantize_stage:1"):
                assert reg.demote_tier("a", reason="test") > 0
            t = reg.tenant("a")
            assert t.tier == "bf16" and t.tier_rollbacks == 0
            assert faults.COUNTERS.get("injected_faults") == 1
            assert _within(_scores(reg, "a", reqs), ref, "bf16")
            assert reg.metrics()["tenants"]["a"]["failed"] == 0
            reg.close(release_bundles=True)

    def test_a_terminal_quantize_fault_leaves_the_old_generation_bitwise(self):
        reqs = _requests(23, 8)
        with TenantRegistry(max_batch=4, max_wait_ms=1.0) as reg:
            reg.admit("a", _bundle(7))
            t = reg.tenant("a")
            ref = _scores(reg, "a", reqs)
            version = t.engine._state.version
            with faults.inject("quantize_stage:99"), pytest.raises(faults.InjectedFault):
                reg.demote_tier("a", reason="test")
            assert t.tier == "f32" and t.tier_rollbacks == 1
            assert t.engine._state.version == version  # no flip happened
            assert np.array_equal(_scores(reg, "a", reqs), ref)
            assert reg.metrics()["tenants"]["a"]["failed"] == 0
            assert faults.COUNTERS.get("tier_rollbacks") == 1
            assert faults.COUNTERS.get("tier_demotions") == 0
            reg.close(release_bundles=True)

    def test_a_terminal_restore_fault_keeps_the_quantized_generation(self):
        reqs = _requests(25, 8)
        with TenantRegistry(max_batch=4, max_wait_ms=1.0) as reg:
            reg.admit("a", _bundle(8))
            ref = _scores(reg, "a", reqs)
            reg.demote_tier("a", to="bf16", reason="test")
            with faults.inject("tier_restore:99"), pytest.raises(faults.InjectedFault):
                reg.restore_tier("a", reason="test")
            t = reg.tenant("a")
            assert t.tier == "bf16" and _within(_scores(reg, "a", reqs), ref, "bf16")
            assert reg.metrics()["tenants"]["a"]["failed"] == 0
            reg.restore_tier("a", reason="test")  # a clean restore still lands bit-equal
            assert np.array_equal(_scores(reg, "a", reqs), ref)
            reg.close(release_bundles=True)

    def test_chaos_is_confined_to_the_transitioning_tenant(self):
        req_a, req_b = _requests(27, 8), _requests(28, 8)
        with TenantRegistry(max_batch=4, max_wait_ms=1.0) as reg:
            reg.admit("chaos", _bundle(9))
            reg.admit("clean", _bundle(10))
            ref_a, ref_b = _scores(reg, "chaos", req_a), _scores(reg, "clean", req_b)
            with faults.inject("quantize_stage:99"), pytest.raises(faults.InjectedFault):
                reg.demote_tier("chaos", reason="test")
            assert np.array_equal(_scores(reg, "clean", req_b), ref_b)
            assert np.array_equal(_scores(reg, "chaos", req_a), ref_a)
            m = reg.metrics()
            assert m["tenants"]["clean"]["failed"] == m["tenants"]["chaos"]["failed"] == 0
            assert m["tenants"]["clean"]["tier"]["rollbacks"] == 0
            reg.close(release_bundles=True)


# ==================================================== telemetry / journal


def _ladder_journal(path, registry_cls, make):
    tl = telemetry if registry_cls is TenantRegistry else jax_telemetry
    journal = tl.install_journal(tl.RunJournal(path))
    try:
        with registry_cls(max_batch=4, max_wait_ms=1.0) as reg:
            reg.admit("a", make(11))
            reg.demote_tier("a", to="int8", reason="test")
            reg.restore_tier("a", reason="test")
            reg.close(release_bundles=True)
    finally:
        tl.uninstall_journal()
        journal.close()
    return [json.loads(x) for x in open(path) if x.strip()]


class TestLadderObservability:
    def test_the_journal_is_valid_and_its_transitions_the_references(self, tmp_path, capsys):
        ours = _ladder_journal(str(tmp_path / "port.jsonl"), TenantRegistry, _bundle)
        theirs = _ladder_journal(str(tmp_path / "jax.jsonl"), JaxTenantRegistry, _jax_bundle)
        for validate in (telemetry.validate_journal, jax_telemetry.validate_journal):
            assert validate(str(tmp_path / "port.jsonl"))[1] == []

        def ladder(events):
            return [{k: v for k, v in e.items() if k not in ("ts", "freed_bytes", "repinned_bytes")}
                    for e in events if e["type"] in JOURNAL_EVENT_SCHEMAS and e["type"].startswith("tier_")]

        assert ladder(ours) == ladder(theirs)
        moves = [(e["type"], e["from_tier"], e["to_tier"]) for e in ladder(ours)]
        assert [m[1:] for m in moves] == [("f32", "bf16"), ("bf16", "int8"), ("int8", "bf16"),
                                          ("bf16", "f32")]
        for e in ours:
            if e["type"].startswith("tier_"):
                assert all(k in e for k in JOURNAL_EVENT_SCHEMAS[e["type"]])
                assert (e.get("freed_bytes") or e.get("repinned_bytes")) > 0
        first = next(e for e in ours if e["type"] == "tier_demote")
        assert first["evidence"]["quant_error_max"] > 0.0
        assert "tenant=a" in telemetry.METRICS.labeled_histograms("tier_quant_error")
        for main in (obs.main, jax_obs.main):
            assert main(["journal", str(tmp_path / "port.jsonl"), "--validate"]) == 0
        capsys.readouterr()
        rows = []
        for main in (obs.main, jax_obs.main):
            assert main(["decisions", str(tmp_path / "port.jsonl")]) == 0
            rows.append(capsys.readouterr().out)
        assert rows[0] == rows[1]
        assert "tier v" in rows[0] and "tier ^" in rows[0] and "f32 -> bf16" in rows[0]


# ========================================================== autopilot rules


def _tsensors(pkg, name, *, tier="f32", can_quantize=True, last_active=0.0, demoted=False,
              can_demote=True):
    return pkg.sensors.TenantSensors(
        name=name, demoted=demoted, can_demote=can_demote, last_active=last_active, completed=0,
        failed=0, in_flight=0, pending=0, device_bytes=1000, p95_ms=None, p99_ms=None, coords=(),
        tier=tier, can_quantize=can_quantize)


def _snap(pkg, tenants, used=90, budget=100):
    return pkg.sensors.SensorSnapshot(
        tenants={t.name: t for t in tenants}, hbm_budget=budget, hbm_used=used, latency_p95_ms=None,
        latency_p99_ms=None, queue_wait_p95_ms=None, batch_p50=None, failed_requests=0)


# (rule, ladder knob, tenants as (name, tier, can_quantize, last_active), used, signal)
RULE_CASES = {
    "demote_prefers_bf16": ("hbm_demote_rule", True, [("a", "f32", True, 0.0)], 90, 0.90),
    "demote_int8_under_its_pressure": ("hbm_demote_rule", True, [("a", "bf16", True, 0.0)], 90, 0.90),
    "demote_int8_past_its_pressure": ("hbm_demote_rule", True, [("a", "bf16", True, 0.0)], 95, 0.95),
    "demote_coldest_quantizable": ("hbm_demote_rule", True,
                                   [("a", "int8", False, 0.0), ("b", "f32", True, 1.0)], 90, 0.90),
    "demote_host_tier_when_off": ("hbm_demote_rule", False, [("a", "f32", True, 0.0)], 90, 0.90),
    "restore_bf16_to_f32": ("hbm_restore_rule", False, [("a", "bf16", True, 0.0)], 40, 0.6),
    "restore_int8_to_bf16": ("hbm_restore_rule", False, [("a", "int8", False, 0.0)], 40, 0.6),
    "restore_refused_over_ceiling": ("hbm_restore_rule", False, [("a", "bf16", True, 0.0)], 85, 0.15),
}


class TestLadderRules:
    @pytest.mark.parametrize("case", sorted(RULE_CASES))
    def test_the_rules_decide_as_the_references(self, case, monkeypatch):
        rule_name, ladder, tenants, used, sig = RULE_CASES[case]
        if ladder:
            monkeypatch.setenv("PHOTON_TIER_LADDER", "1")
        got = []
        for pkg in (autopilot, jax_autopilot):
            snap = _snap(pkg, [_tsensors(pkg, n, tier=tr, can_quantize=q, last_active=la)
                               for n, tr, q, la in tenants], used=used)
            rule = getattr(pkg.rules, rule_name)()
            action = rule.decide(snap, None, sig)
            got.append(None if action is None else (action.kind, action.tenant, dict(action.params),
                                                    dict(action.evidence)))
            got.append(rule.signal(snap, None))
        assert got[0] == got[2] and got[1] == got[3]
        expected = {"demote_prefers_bf16": ("tier_demote", "bf16"),
                    "demote_int8_under_its_pressure": ("demote", None),
                    "demote_int8_past_its_pressure": ("tier_demote", "int8"),
                    "demote_coldest_quantizable": ("tier_demote", "bf16"),
                    "demote_host_tier_when_off": ("demote", None),
                    "restore_bf16_to_f32": ("tier_restore", "f32"),
                    "restore_int8_to_bf16": ("tier_restore", "bf16"),
                    "restore_refused_over_ceiling": None}[case]
        if expected is None:
            assert got[0] is None
        else:
            assert (got[0][0], got[0][2].get("to")) == expected

    def test_the_sensors_read_the_tier(self):
        with TenantRegistry(max_batch=4, max_wait_ms=1.0) as reg:
            reg.admit("a", _bundle(1))
            reg.admit("b", _bundle(2))
            reg.demote_tier("b", to="int8", reason="test")
            snap = autopilot.read_sensors(reg)
            reg.close(release_bundles=True)
        a, b = snap.tenants["a"], snap.tenants["b"]
        assert (a.tier, a.can_quantize) == ("f32", True)
        assert (b.tier, b.can_quantize) == ("int8", False)  # the last quantized rung
        assert b.device_bytes < a.device_bytes


# ============================================== autopilot actuation


def _drive(kind, params, from_tier="f32"):
    return autopilot.ControlRule(
        name=f"drive-{kind}", signal=lambda cur, prev: 12.0, fire_above=10.0, rearm_below=2.0,
        decide=lambda cur, prev, sig: autopilot.Action(kind=kind, tenant="a", params=dict(params),
                                                       evidence={"from_tier": from_tier}),
        cooldown_s=0.0)


class TestAutopilotLadderActuation:
    def test_a_ladder_step_passes_the_characterized_probe(self):
        reqs = _requests(41, 4)
        with TenantRegistry(max_batch=4, max_wait_ms=1.0) as reg:
            reg.admit("a", _bundle(13))
            ref = _scores(reg, "a", reqs)
            for rule, tier in ((_drive("tier_demote", {"to": "bf16"}), "bf16"),
                               (_drive("tier_restore", {"to": "f32"}, from_tier="bf16"), "f32")):
                pilot = autopilot.Autopilot(reg, rules=[rule], probe_requests={"a": reqs[0]},
                                            cooldown_s=0.0, max_actions=100, start=False)
                pilot.tick()
                pilot.close()
                s = pilot.summary()
                assert (s["actions"], s["rollbacks"], reg.tenant("a").tier) == (1, 0, tier)
            assert np.array_equal(_scores(reg, "a", reqs), ref)
            assert reg.metrics()["tenants"]["a"]["failed"] == 0
            reg.close(release_bundles=True)

    @pytest.mark.chaos
    def test_an_actuation_fault_rolls_back_the_ladder_step(self):
        reqs = _requests(43, 4)
        with TenantRegistry(max_batch=4, max_wait_ms=1.0) as reg:
            reg.admit("a", _bundle(14))
            ref = _scores(reg, "a", reqs)
            pilot = autopilot.Autopilot(reg, rules=[_drive("tier_demote", {"to": "bf16"})],
                                        probe_requests={"a": reqs[0]}, cooldown_s=0.0, max_actions=100,
                                        start=False)
            with faults.inject("autopilot_act:1"):
                pilot.tick()
            pilot.close()
            s = pilot.summary()
            assert s["rollbacks"] == 1 and s["actions"] == 0
            assert reg.tenant("a").tier == "f32"
            assert np.array_equal(_scores(reg, "a", reqs), ref)
            reg.close(release_bundles=True)

    def test_only_a_ladder_action_relaxes_the_probe(self):
        cases = [("tier_demote", {"to": "bf16"}, {"from_tier": "f32"}),
                 ("tier_demote", {"to": "int8"}, {"from_tier": "bf16"}),
                 ("tier_restore", {"to": "f32"}, {"from_tier": "int8"}),
                 ("demote", {"hot_rows": 0}, {}), ("restore", {}, {}), ("retune", {}, {})]
        for kind, params, evidence in cases:
            ours = autopilot.Autopilot._probe_tolerance(
                autopilot.Action(kind=kind, tenant="a", params=params, evidence=evidence))
            theirs = jax_autopilot.Autopilot._probe_tolerance(
                jax_autopilot.Action(kind=kind, tenant="a", params=params, evidence=evidence))
            assert ours == theirs
            assert (ours is None) == (not kind.startswith("tier_"))
        assert autopilot.Autopilot._probe_tolerance(None) is None
