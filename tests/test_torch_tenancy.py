"""The port's multi-tenant serving registry, on the CPU.

The cases of tests/test_tenancy.py on the port, held against the JAX
`TenantRegistry` on the same numpy weights where the reference has the
same decision to make:

  * co-batched answers are each tenant's solo engine's bits (a two-tier
    tenant, outside every signature, answers solo beside them), and within
    PORT_TOLERANCES["convert_scores"] of the JAX registry's; a member's swap
    mid-stream keeps the bits of the new generation and captures nothing on
    the dispatch path;
  * the weighted-fair claim splits the slots as the reference's does;
  * quota shedding is a typed `Overloaded` naming the tenant, deadlines are
    per tenant, a cancelled queued future frees its slot, and a malformed
    co-batched request fails alone without killing the dispatch thread;
  * chaos armed for one tenant leaves the others with no failed request, no
    degraded counter and the same bits;
  * the pressure valve demotes the tenant the reference demotes and its
    answers stay bit-equal (and after `restore`); nothing fits, admission
    refuses; the `tenant_admit` and `tenant_evict` faults roll back;
  * `remove` drains the tenant; the metrics blocks carry the reference's
    keys and the journal passes its validator;
  * `cli.serve --tenant` gives the JAX driver's summary blocks and scores.

Every wait is on a future or a condition, never on a clock.
"""

from __future__ import annotations

import json
import os
import threading
from concurrent.futures import Future

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.cli import serve as jax_serve
from photon_ml_tpu.game.model import Coefficients as JaxCoefficients
from photon_ml_tpu.game.model import FixedEffectModel as JaxFixedEffectModel
from photon_ml_tpu.game.model import GameModel as JaxGameModel
from photon_ml_tpu.game.model import RandomEffectModel as JaxRandomEffectModel
from photon_ml_tpu.serving import ScoreRequest as JaxScoreRequest
from photon_ml_tpu.serving import ServingBundle as JaxServingBundle
from photon_ml_tpu.serving.tenancy import TenantRegistry as JaxTenantRegistry
from photon_ml_tpu.transformers.game_transformer import CoordinateScoringSpec as JaxSpec
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu.utils import telemetry as jax_telemetry
from photon_ml_tpu.utils.contracts import SERVING_SUMMARY_KEYS, TENANT_BLOCK_KEYS, TIER_BLOCK_KEYS
from photon_ml_tpu_torch.cli import serve as serve_cli
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.data.index_map import IndexMap
from photon_ml_tpu_torch.game.model import Coefficients, FixedEffectModel, GameModel, RandomEffectModel
from photon_ml_tpu_torch.io import model_bridge, model_store
from photon_ml_tpu_torch.serving import (
    DeadlineExceeded,
    HbmBudgetExceeded,
    Overloaded,
    ScoreRequest,
    ServingBundle,
    ServingEngine,
    TenantRegistry,
)
from photon_ml_tpu_torch.transformers.game_transformer import CoordinateScoringSpec
from photon_ml_tpu_torch.types import TaskType
from photon_ml_tpu_torch.utils import faults, telemetry

pytestmark = pytest.mark.serving

TASK = TaskType.LOGISTIC_REGRESSION
JTASK = JaxTaskType.LOGISTIC_REGRESSION
D_FE, D_RE, E = 6, 4, 10
TOL = PORT_TOLERANCES["convert_scores"]  # float32 scoring in two frameworks
RE_BYTES = (E + 1) * D_RE * 4
TENANT_BYTES = D_FE * 4 + RE_BYTES


@pytest.fixture(autouse=True)
def _port_fault_hygiene(monkeypatch):
    """The port's fault plan and counters are its own process globals."""
    monkeypatch.setenv("PHOTON_RETRY_BASE_DELAY_S", "0.001")
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


def _specs():
    return {"fixed": CoordinateScoringSpec(shard="g"),
            "per-e": CoordinateScoringSpec(shard="re", random_effect_type="eid",
                                           entity_index={str(i): i for i in range(E)})}


def _port_model(seed):
    w, M = _weights(seed)
    return GameModel({"fixed": FixedEffectModel(Coefficients(torch.from_numpy(w)), TASK),
                      "per-e": RandomEffectModel(torch.from_numpy(M), None, TASK)})


def _bundle(seed, **kw):
    return ServingBundle.from_model(_port_model(seed), _specs(), TASK, device="cpu", **kw)


def _jax_bundle(seed):
    w, M = _weights(seed)
    model = JaxGameModel({"fixed": JaxFixedEffectModel(JaxCoefficients(jnp.asarray(w)), JTASK),
                          "per-e": JaxRandomEffectModel(jnp.asarray(M), None, JTASK)})
    specs = {"fixed": JaxSpec(shard="g"),
             "per-e": JaxSpec(shard="re", random_effect_type="eid",
                              entity_index={str(i): i for i in range(E)})}
    return JaxServingBundle.from_model(model, specs, JTASK)


def _docs(seed, n):
    r = np.random.default_rng(seed)
    return [dict(g=r.normal(size=D_FE).astype(np.float32), re=r.normal(size=D_RE).astype(np.float32),
                 eid=str(int(r.integers(0, E + 3))), offset=float(r.normal()), uid=f"u{i}")
            for i in range(n)]


def _reqs(docs, cls=ScoreRequest):
    return [cls(features={"g": d["g"], "re": d["re"]}, entity_ids={"eid": d["eid"]}, offset=d["offset"],
                uid=d["uid"]) for d in docs]


def _solo(seed, reqs):
    with ServingEngine(_bundle(seed), max_batch=8) as eng:
        return [r.score for r in eng.score_batch(reqs)]


def _replay(reg, names, reqs):
    """Every request to every tenant, interleaved; {tenant: [score]}."""
    futs = [(n, reg.submit(n, r, block=True)) for r in reqs for n in names]
    out = {n: [] for n in names}
    for n, f in futs:
        out[n].append(f.result(timeout=60).score)
    return out


def test_cobatched_answers_are_solo_bits_and_the_jax_registrys(rng):
    docs = _docs(1, 40)
    reqs = _reqs(docs)
    with TenantRegistry(max_batch=8, max_wait_ms=1.0) as reg:
        for k, name in enumerate("abc"):
            reg.admit(name, _bundle(k))
        reg.admit("solo", _bundle(0, hot_rows=2))  # two-tier: outside every signature
        assert reg.tenant("solo").signature() is None and reg.tenant("a").signature() is not None
        got = _replay(reg, ["a", "b", "c", "solo"], reqs)
        m = reg.metrics()
    for k, name in enumerate("abc"):
        assert got[name] == _solo(k, reqs), name
    assert got["solo"] == got["a"]
    assert m["cobatch_dispatches"] > 0 and m["cobatch_compiles_after_warmup"] == 0
    assert m["tenants"]["a"]["cobatched_requests"] == 40 and m["tenants"]["solo"]["cobatched_requests"] == 0
    assert m["cobatch_compiles"] == 3 * 4  # a group per admission, 4 buckets each
    jreg = JaxTenantRegistry(max_batch=8, max_wait_ms=1.0)
    try:
        for k, name in enumerate("abc"):
            jreg.admit(name, _jax_bundle(k))
        jreqs = _reqs(docs, JaxScoreRequest)
        jfuts = [(n, jreg.submit(n, r, block=True)) for r in jreqs for n in "abc"]
        want = {n: [] for n in "abc"}
        for n, f in jfuts:
            want[n].append(f.result(timeout=60).score)
    finally:
        jreg.close(release_bundles=True)
    for name in "abc":
        np.testing.assert_allclose(got[name], want[name], rtol=TOL["rtol"], atol=TOL["atol"])


def test_a_members_swap_mid_stream_keeps_the_new_generations_bits():
    reqs = _reqs(_docs(2, 48))
    with TenantRegistry(max_batch=8, max_wait_ms=1.0) as reg:
        for k, name in enumerate("ab"):
            reg.admit(name, _bundle(k))
        before = reg.metrics()["cobatch_compiles"]
        first = _replay(reg, ["a", "b"], reqs[:24])
        info = reg.tenant("b").engine.bundle_manager.swap(_bundle(7))
        second = _replay(reg, ["a", "b"], reqs[24:])
        m = reg.metrics()
    assert info["version"] == 1
    assert first["b"] == _solo(1, reqs[:24]) and second["b"] == _solo(7, reqs[24:])
    assert first["a"] + second["a"] == _solo(0, reqs)
    assert m["cobatch_compiles"] == before + 4  # the swap's pre-warm: the new group, every bucket
    assert m["cobatch_compiles_after_warmup"] == 0


@pytest.mark.parametrize("case", ["swap_rolled_back", "removed_and_readmitted", "admission_failed"])
def test_no_cobatch_program_outlives_the_generation_it_was_captured_for(case, monkeypatch):
    """A generation that never committed or has left (a swap rolled back at
    its commit site, a removed tenant, an admission whose captures failed)
    leaves no program behind, and the next generation under the same name
    and version answers with its own bits, one slot at a time and mixed."""
    reqs = _reqs(_docs(11, 16))
    name = "c" if case == "admission_failed" else "b"
    with TenantRegistry(max_batch=8, max_wait_ms=1.0) as reg:
        reg.admit("a", _bundle(0))
        reg.admit("b", _bundle(1))
        before = len(reg._programs)
        if case == "swap_rolled_back":
            manager = reg.tenant("b").engine.bundle_manager
            with faults.inject("swap_commit:1"):
                with pytest.raises(faults.InjectedFault):
                    manager.swap(_bundle(5))
            assert len(reg._programs) == before
            assert manager.swap(_bundle(6))["version"] == 1  # the rolled-back one's version
        elif case == "removed_and_readmitted":
            reg.remove("b", release_bundle=True)
            reg.admit("b", _bundle(6))  # version 0 again, the dispatch thread idle throughout
        else:
            real, calls = reg._build_program, []

            def capture_fails_at_the_last_bucket(sig, members, bucket):
                calls.append(bucket)
                if len(calls) == len(reg.buckets):
                    raise RuntimeError("capture failed")
                return real(sig, members, bucket)

            monkeypatch.setattr(reg, "_build_program", capture_fails_at_the_last_bucket)
            with pytest.raises(RuntimeError, match="capture failed"):
                reg.admit("c", _bundle(5))
            monkeypatch.setattr(reg, "_build_program", real)
            assert reg.tenant_names == ["a", "b"] and len(reg._programs) == before
            reg.admit("c", _bundle(6))
        one_by_one = [reg.submit(name, r, block=True).result(timeout=60).score for r in reqs]
        mixed = _replay(reg, ["a", name], reqs)
        m = reg.metrics()
    assert one_by_one == mixed[name] == _solo(6, reqs)
    assert mixed["a"] == _solo(0, reqs)
    assert m["tenants"][name]["cobatched_requests"] == 2 * len(reqs)
    assert m["cobatch_compiles_after_warmup"] == 0


def _claim_split(reg, weights, queued):
    """Fill each tenant's queue by hand and run one claim, holding the
    registry's condition so the dispatch thread cannot take them."""
    with reg._cv:
        for name, n in queued.items():
            t = reg._tenants[name]
            for _ in range(n):
                t.queue.append((None, Future(), 0.0, None))
                t.in_flight += 1
        claimed, expired = reg._claim_locked()
        split = {name: sum(1 for t, _ in claimed if t.name == name) for name in queued}
        for t in reg._tenants.values():
            t.queue.clear()
            t.in_flight = 0
    assert not expired
    return split


@pytest.mark.parametrize("weights,queued", [((3.0, 1.0), (20, 20)), ((1.0, 1.0), (3, 20)),
                                            ((1.0, 5.0), (20, 1))])
def test_weighted_fair_claims_give_the_reference_split(weights, queued):
    splits = []
    for cls, bundle in ((TenantRegistry, _bundle), (JaxTenantRegistry, _jax_bundle)):
        reg = cls(max_batch=8, max_wait_ms=1.0)
        try:
            for k, (name, wgt) in enumerate(zip("ab", weights)):
                reg.admit(name, bundle(k), weight=wgt, warm=False)
            rounds = [_claim_split(reg, weights, dict(zip("ab", queued))) for _ in range(3)]
        finally:
            reg.close(release_bundles=True)
        splits.append(rounds)
    assert splits[0] == splits[1]
    assert all(sum(r.values()) == min(8, sum(queued)) for r in splits[0])


def test_quota_sheds_typed_naming_the_tenant_and_deadlines_are_per_tenant():
    reqs = _reqs(_docs(3, 4))
    # A long flush wait: queued requests stay queued until close() answers them.
    with TenantRegistry(max_batch=64, max_wait_ms=60_000.0) as reg:
        reg.admit("a", _bundle(0), max_pending=2)
        reg.admit("b", _bundle(1), deadline_ms=0.0)
        held = [reg.submit("a", r) for r in reqs[:2]]
        with pytest.raises(Overloaded, match="tenant 'a' pending quota full") as exc:
            reg.submit("a", reqs[2])
        assert exc.value.tenant == "a"
        late = reg.submit("b", reqs[3])  # b's default deadline: expired at once
        with pytest.raises(DeadlineExceeded) as dexc:
            late.result(timeout=60)
        assert dexc.value.tenant == "b"
    assert [f.result(timeout=60).score for f in held] == _solo(0, reqs[:2])
    m_shed = telemetry.METRICS.labeled_counters("serving_shed_requests")
    assert m_shed == {"tenant=a": 1}


def test_a_cancelled_queued_future_frees_its_slot():
    reqs = _reqs(_docs(4, 2))
    # The flush wait leaves the cancel ample time to land before the claim.
    with TenantRegistry(max_batch=64, max_wait_ms=500.0) as reg:
        reg.admit("a", _bundle(0), max_pending=1)
        first = reg.submit("a", reqs[0])
        assert first.cancel()
        # The quota is full until the claim drops the cancelled future; then
        # this blocking submit is let in and answered.
        second = reg.submit("a", reqs[1], block=True)
        assert second.result(timeout=60).score == _solo(0, reqs[1:])[0]
        assert reg.tenant("a").in_flight == 0


def test_a_malformed_cobatched_request_never_kills_the_dispatch_thread():
    reqs = _reqs(_docs(5, 6))
    bad = ScoreRequest(features={"g": (np.asarray([999]), np.asarray([1.0], np.float32))},
                       entity_ids={"eid": "1"}, uid="bad")
    with TenantRegistry(max_batch=8, max_wait_ms=5.0) as reg:
        reg.admit("a", _bundle(0))
        reg.admit("b", _bundle(1))
        with reg._cv:  # one round holds all of them
            futs = [reg.submit("a", reqs[0]), reg.submit("b", reqs[1]), reg.submit("a", bad),
                    reg.submit("b", reqs[2])]
        assert futs[0].result(timeout=60).score == _solo(0, reqs[:1])[0]
        assert [futs[1].result(timeout=60).score, futs[3].result(timeout=60).score] == \
            _solo(1, [reqs[1], reqs[2]])
        with pytest.raises(IndexError):
            futs[2].result(timeout=60)
        assert reg._thread.is_alive()
        after = _replay(reg, ["a", "b"], reqs[3:])
        m = reg.metrics()
    assert after["a"] == _solo(0, reqs[3:])
    assert m["tenants"]["a"]["failed"] == 1 and m["tenants"]["b"]["failed"] == 0
    assert m["tenants"]["a"]["degraded_batches"] >= 1


def test_chaos_confined_to_one_tenant_leaves_the_others_clean():
    reqs = _reqs(_docs(6, 32))
    with TenantRegistry(max_batch=8, max_wait_ms=1.0) as reg:
        reg.admit("noisy", _bundle(0), max_pending=4)
        reg.admit("clean1", _bundle(1), inject_faults=False)
        reg.admit("clean2", _bundle(2), inject_faults=False)
        with faults.inject("lookup:p0.5,score:p0.5,admit:p0.2", seed=11):
            clean = _replay(reg, ["clean1", "clean2"], reqs)
            noisy = []
            for r in reqs:
                try:
                    noisy.append(reg.submit("noisy", r))
                except Overloaded:
                    pass  # the flood past its quota
        for f in noisy:
            try:
                f.result(timeout=60)
            except Exception:  # the noisy tenant's own outcomes
                pass
        m = reg.metrics()
    assert clean["clean1"] == _solo(1, reqs) and clean["clean2"] == _solo(2, reqs)
    for name in ("clean1", "clean2"):
        block = m["tenants"][name]
        assert block["failed"] == block["shed"] == block["degraded_batches"] == block["fe_only_answers"] == 0
    for counter in ("serving_degraded_batches", "serving_shed_requests", "serving_fe_only_requests"):
        assert not {k for k in telemetry.METRICS.labeled_counters(counter) if "clean" in k}, counter
    assert m["tenants"]["noisy"]["shed"] + m["tenants"]["noisy"]["degraded_batches"] > 0


def test_the_pressure_valve_demotes_the_reference_victim():
    budget = 2 * TENANT_BYTES + D_FE * 4 + 2 * D_RE * 4  # a third fits once two are demoted
    reqs = _reqs(_docs(7, 12))
    victims = []
    for cls, bundle, req_cls in ((TenantRegistry, _bundle, ScoreRequest),
                                 (JaxTenantRegistry, _jax_bundle, JaxScoreRequest)):
        reg = cls(max_batch=8, max_wait_ms=1.0, hbm_budget_bytes=budget)
        try:
            reg.admit("a", bundle(0))
            reg.admit("b", bundle(1))
            reg.submit("a", _reqs(_docs(7, 1), req_cls)[0], block=True).result(timeout=60)
            reg.admit("c", bundle(2))  # b is the colder: b goes to the host tier
            victims.append(sorted(n for n in reg.tenant_names if reg.tenant(n).demoted))
            if cls is TenantRegistry:
                assert reg.tenant("b").device_bytes() == D_FE * 4 + D_RE * 4
                got = _replay(reg, ["a", "b", "c"], reqs)
                assert [got[n] for n in "abc"] == [_solo(k, reqs) for k in range(3)]
                assert reg.restore("b") == RE_BYTES - D_RE * 4
                assert _replay(reg, ["b"], reqs)["b"] == _solo(1, reqs)
                assert reg.metrics()["cobatch_compiles_after_warmup"] == 0
        finally:
            reg.close(release_bundles=True)
        assert victims[-1] == ["b"]
    assert victims[0] == victims[1]
    # Nothing fits even with every resident tenant demoted: admission
    # refuses, in both packages, and keeps the demotion it made.
    for cls, bundle, error in ((TenantRegistry, _bundle, HbmBudgetExceeded),
                               (JaxTenantRegistry, _jax_bundle, Exception)):
        reg = cls(max_batch=8, max_wait_ms=1.0, hbm_budget_bytes=TENANT_BYTES + 8)
        try:
            reg.admit("a", bundle(0), warm=False)
            with pytest.raises(error, match="already on the host tier"):
                reg.admit("b", bundle(1), warm=False)
            assert reg.tenant_names == ["a"] and reg.tenant("a").demoted
        finally:
            reg.close(release_bundles=True)


@pytest.mark.parametrize("site", ["tenant_admit", "tenant_evict"])
def test_the_admit_and_evict_faults_roll_back(site):
    reqs = _reqs(_docs(8, 8))
    budget = TENANT_BYTES + D_FE * 4 + D_RE * 4 if site == "tenant_evict" else None
    with TenantRegistry(max_batch=8, max_wait_ms=1.0, hbm_budget_bytes=budget) as reg:
        reg.admit("a", _bundle(0))
        with faults.inject(f"{site}:99"):
            with pytest.raises(faults.InjectedFault):
                reg.admit("b", _bundle(1))
        assert reg.tenant_names == ["a"] and not reg.tenant("a").demoted
        assert reg.tenant("a").engine.bundle_version == 0
        assert _replay(reg, ["a"], reqs)["a"] == _solo(0, reqs)
        assert faults.counters()["retries"] > 0


def test_remove_drains_the_tenant_and_the_metrics_and_journal_are_the_references(tmp_path):
    path = str(tmp_path / "journal.jsonl")
    journal = telemetry.RunJournal(path)
    telemetry.install_journal(journal)
    reqs = _reqs(_docs(9, 16))
    try:
        with TenantRegistry(max_batch=8, max_wait_ms=1.0, hbm_budget_bytes=2 * TENANT_BYTES) as reg:
            reg.admit("a", _bundle(0))
            reg.admit("b", _bundle(1))
            pending = [reg.submit("b", r, block=True) for r in reqs]
            reg.remove("b", release_bundle=True)
            assert [f.result(timeout=0).score for f in pending] == _solo(1, reqs)
            with pytest.raises(KeyError):
                reg.submit("b", reqs[0])
            reg.admit("c", _bundle(2))
            reg.admit("d", _bundle(3))  # demotes a, then c: one alone does not make room
            m = reg.metrics()
            assert _replay(reg, ["a"], reqs)["a"] == _solo(0, reqs)
            assert reg.metrics()["cobatch_compiles_after_warmup"] == 0
    finally:
        telemetry.uninstall_journal()
        journal.close()
    assert set(m["tenants"]) == {"a", "c", "d"}
    for block in m["tenants"].values():
        assert tuple(block) == TENANT_BLOCK_KEYS and tuple(block["tier"]) == TIER_BLOCK_KEYS
        assert block["tier"]["tier"] == "f32" and block["tier"]["quant_error_max"] is None
    types = [json.loads(line)["type"] for line in open(path)]
    assert types.count("tenant_admit") == 4 and types.count("tenant_evict") == 2
    assert [n for n, b in m["tenants"].items() if b["demoted"]] == ["a", "c"]
    assert jax_telemetry.validate_journal(path) == (len(types), [])


def _save(mdir, seed):
    art = model_bridge.artifact_from_game_model(_port_model(seed), _specs(), TASK)
    maps = {"g": IndexMap.from_feature_names([f"f{i}" for i in range(D_FE)]),
            "re": IndexMap.from_feature_names([f"r{i}" for i in range(D_RE)])}
    model_store.save_game_model(str(mdir), art, maps)
    os.makedirs(mdir / "feature-indexes", exist_ok=True)
    for shard, imap in maps.items():
        imap.save(str(mdir / "feature-indexes" / f"{shard}.json"))


def _write_requests(path, docs):
    with open(path, "w") as f:
        for d in docs:
            f.write(json.dumps({"uid": d["uid"], "offset": d["offset"], "ids": {"eid": d["eid"]},
                                "features": {"g": d["g"].tolist(), "re": d["re"].tolist()}}) + "\n")


def test_cli_serve_tenants_give_the_jax_drivers_blocks_and_scores(tmp_path):
    from photon_ml_tpu_torch.io import score_store

    for k in range(2):
        _save(tmp_path / f"m{k}", k)
    _write_requests(tmp_path / "r.jsonl", _docs(10, 30))
    tenants = ["--tenant", f"a={tmp_path / 'm0'}", "--tenant", f"b={tmp_path / 'm1'}"]
    common = ["--requests", str(tmp_path / "r.jsonl"), "--max-batch", "16", "--max-wait-ms", "1",
              "--logging-level", "WARNING", *tenants]
    port = serve_cli.main([*common, "--root-output-directory", str(tmp_path / "port"), "--device", "cpu"])
    jax_serve.main([*common, "--root-output-directory", str(tmp_path / "jax")])
    with open(tmp_path / "jax" / "serving-summary.json") as f:
        ref = json.load(f)
    assert sorted(port) == sorted(ref) == sorted(SERVING_SUMMARY_KEYS)
    assert port["failed_requests"] == ref["failed_requests"] == 0
    assert port["num_requests"] == ref["num_requests"] == 30
    assert set(port["tenants"]) == set(ref["tenants"]) == {"a", "b"}
    for name in ("a", "b"):
        got, want = port["tenants"][name], ref["tenants"][name]
        assert tuple(got) == tuple(want) == TENANT_BLOCK_KEYS
        exact = [k for k in TENANT_BLOCK_KEYS if not isinstance(want[k], float)]  # all but latencies
        assert {k: got[k] for k in exact} == {k: want[k] for k in exact}
        assert got["cobatched_requests"] == 15
        ours, theirs = (score_store.load_score_columns(str(tmp_path / pkg / "scores" / name))
                        for pkg in ("port", "jax"))
        by_uid = dict(zip(theirs.uids, theirs.scores))
        np.testing.assert_allclose(ours.scores, [by_uid[u] for u in ours.uids], rtol=TOL["rtol"],
                                   atol=TOL["atol"])
    assert port["serving"]["cobatch_dispatches"] > 0
    assert sorted(port["health"]) == ["a", "b"] and port["shadow"] == port["autopilot"] == {}
    assert telemetry.validate_journal(str(tmp_path / "port" / "journal.jsonl"))[1] == []
