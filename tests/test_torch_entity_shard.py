"""The row-sharded serving store over the cards of one process, on the CPU.

A random effect's matrix row-sharded over 2, 4 and 8 CPU "cards"
(`parallel.mesh.make_mesh(["cpu"] * n)`: ordinals of the one device) is
served by the port's engine and scored by its transformer, and held:

  * bit for bit against the port's replicated engine and its
    `GameTransformer.transform`, staged by `mesh=`, by
    PHOTON_SERVING_ENTITY_SHARD in `load_bundle`, and from a model whose
    matrix is already a RowShardedMatrix;
  * against the JAX package's replicated engine within
    PORT_TOLERANCES["convert_scores"];
  * its reshard plans against the JAX `plan_coordinate_reshard` over the
    same shard counts on the JAX package's 8-device CPU mesh
    (tests/conftest.py), field for field;
  * through live reshards (shrink, regrow, replicate; under traffic),
    rollbacks on injected `reshard_stage` / `reshard_commit` faults, a lost
    card and its restage, per-card budget accounting, a delta apply, the
    `collective` site on the transformer's gather, and the journal lines
    both packages' `cli.obs journal --validate` accept.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.cli import obs as jax_obs
from photon_ml_tpu.game.model import Coefficients as JaxCoefficients
from photon_ml_tpu.game.model import FixedEffectModel as JaxFixedEffectModel
from photon_ml_tpu.game.model import GameModel as JaxGameModel
from photon_ml_tpu.game.model import RandomEffectModel as JaxRandomEffectModel
from photon_ml_tpu.parallel.mesh import make_mesh as jax_make_mesh
from photon_ml_tpu.serving import ScoreRequest as JaxScoreRequest
from photon_ml_tpu.serving import ServingBundle as JaxServingBundle
from photon_ml_tpu.serving import ServingEngine as JaxServingEngine
from photon_ml_tpu.serving.reshard import plan_coordinate_reshard as jax_plan_coordinate_reshard
from photon_ml_tpu.transformers.game_transformer import CoordinateScoringSpec as JaxSpec
from photon_ml_tpu.types import TaskType as JaxTaskType
from photon_ml_tpu.utils.contracts import SERVING_SHARDING_KEYS
from photon_ml_tpu_torch.cli import obs
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.data.game_dataset import GameDataset
from photon_ml_tpu_torch.data.index_map import IndexMap
from photon_ml_tpu_torch.game.model import Coefficients, FixedEffectModel, GameModel, RandomEffectModel
from photon_ml_tpu_torch.parallel import mesh as pmesh
from photon_ml_tpu_torch.parallel.mesh import RowShardedMatrix, make_mesh, put_row_sharded, surviving_mesh
from photon_ml_tpu_torch.serving import ScoreRequest, ServingBundle, ServingEngine, load_bundle
from photon_ml_tpu_torch.serving.bundle import demote_bundle_to_host_tier, quantize_bundle_rows
from photon_ml_tpu_torch.serving.delta import CoordinateDelta, DeltaBundle, apply_delta
from photon_ml_tpu_torch.serving.lifecycle import _bundle_device_bytes
from photon_ml_tpu_torch.serving.reshard import plan_coordinate_reshard, plan_reshard
from photon_ml_tpu_torch.transformers.game_transformer import CoordinateScoringSpec, GameTransformer
from photon_ml_tpu_torch.types import TaskType
from photon_ml_tpu_torch.utils import faults, telemetry

from tests.test_torch_serving import _save_port_model

pytestmark = pytest.mark.serving

TASK = TaskType.LOGISTIC_REGRESSION
E, D_RE, D_FE, N = 40, 8, 6, 48
TOL = PORT_TOLERANCES["convert_scores"]
CARDS = (2, 4, 8)


@pytest.fixture(autouse=True)
def _port_fault_hygiene(monkeypatch):
    monkeypatch.setenv("PHOTON_RETRY_BASE_DELAY_S", "0.001")
    faults.clear()
    telemetry.METRICS.reset()
    yield
    faults.clear()
    telemetry.METRICS.reset()


def _cpu(n):
    return make_mesh(["cpu"] * n)


@pytest.fixture(scope="module")
def fx():
    """(model, specs, dataset, requests, replicated scores): one FE and one
    RE coordinate, E = 40 entities of 8 features, some requests cold."""
    rng = np.random.default_rng(2022)
    w = rng.normal(size=D_FE).astype(np.float32)
    M = np.zeros((E + 1, D_RE), np.float32)
    M[:E] = rng.normal(size=(E, D_RE))
    M[5, 2] = -0.0  # a signed zero keeps its bits through the gather
    X = rng.normal(size=(N, D_FE)).astype(np.float32)
    Xe = rng.normal(size=(N, D_RE)).astype(np.float32)
    ids = rng.integers(0, E + 6, size=N)
    offsets = rng.normal(size=N).astype(np.float32)
    model = GameModel({"fixed": FixedEffectModel(Coefficients(torch.from_numpy(w)), TASK),
                       "per-e": RandomEffectModel(torch.from_numpy(M), None, TASK)})
    specs = {"fixed": CoordinateScoringSpec(shard="g"),
             "per-e": CoordinateScoringSpec(shard="re", random_effect_type="eid",
                                            entity_index={str(i): i for i in range(E)})}
    ds = GameDataset.build({"g": X, "re": Xe}, np.zeros(N, np.float32), offsets=offsets,
                           id_tags={"eid": ids.astype(str)}, device="cpu")
    reqs = [ScoreRequest(features={"g": X[i], "re": Xe[i]}, entity_ids={"eid": str(ids[i])},
                         offset=float(offsets[i]), uid=str(i)) for i in range(N)]
    with ServingEngine(ServingBundle.from_model(model, specs, TASK, device="cpu"), max_batch=16) as eng:
        ref = _scores(eng.score_batch(reqs))
    return dict(model=model, specs=specs, ds=ds, reqs=reqs, ref=ref, M=M, w=w)


def _scores(results):
    return np.asarray([r.score for r in results], np.float32)


def _sharded_model(fx, mesh):
    return GameModel({"fixed": fx["model"]["fixed"],
                      "per-e": RandomEffectModel(put_row_sharded(torch.from_numpy(fx["M"]), mesh), None, TASK)})


def _engine_scores(bundle, reqs, max_batch=16):
    with ServingEngine(bundle, max_batch=max_batch) as eng:
        eng.warmup()
        out = _scores(eng.score_batch(reqs))
        assert eng.recompiles_after_warmup == 0
        return out, eng.metrics()


# ------------------------------------------------------------ sharded == replicated


@pytest.mark.parametrize("n", CARDS)
@pytest.mark.parametrize("staging", ["mesh", "knob", "adopted"])
def test_sharded_store_is_the_replicated_bits(fx, tmp_path, monkeypatch, n, staging):
    """mesh=, PHOTON_SERVING_ENTITY_SHARD and an already row-sharded matrix
    each stage n card blocks whose answers, at every bucket, are the
    replicated engine's bits and GameTransformer's."""
    model, specs, reqs = fx["model"], fx["specs"], fx["reqs"]
    if staging == "mesh":
        bundle = ServingBundle.from_model(model, specs, TASK, device="cpu", mesh=_cpu(n))
    elif staging == "adopted":
        bundle = ServingBundle.from_model(_sharded_model(fx, _cpu(n)), specs, TASK, device="cpu")
    else:
        monkeypatch.setattr(pmesh, "CPU_CARDS", n)
        monkeypatch.setenv("PHOTON_SERVING_ENTITY_SHARD", "1")
        maps = {"g": IndexMap.from_feature_names([f"f{i}" for i in range(D_FE)]),
                "re": IndexMap.from_feature_names([f"r{i}" for i in range(D_RE)])}
        bundle = load_bundle(str(_save_port_model(tmp_path / "m", model, specs, maps)), device="cpu")
    c = bundle.coordinates["per-e"]
    per = -(-(E + 1) // n)
    assert c.mesh == _cpu(n) and isinstance(c.params, RowShardedMatrix)
    assert c.unseen_row == E and c.shard_health.n_shards == n and c.shard_health.rows_per_shard == per
    assert [tuple(b.shape) for b in c.params.blocks] == [(per, D_RE)] * n
    assert not c.params.host()[E + 1:].any()  # the padding is zeros
    for max_batch in (1, 3, 16):
        got, m = _engine_scores(bundle, reqs, max_batch)
        assert got.tobytes() == fx["ref"].tobytes(), max_batch
    sh = m["sharding"]
    assert tuple(sh) == SERVING_SHARDING_KEYS
    assert sh["entity_sharded"] is True and sh["axis_size"] == n and sh["rows_per_shard"] == per
    assert sh["all_to_all_bytes_per_batch"] == 2 * (n - 1) * 16 * D_RE * 4
    sharded = GameTransformer(_sharded_model(fx, _cpu(n)), specs, TASK).transform(fx["ds"]).scores
    assert sharded.numpy().tobytes() == GameTransformer(model, specs, TASK).transform(fx["ds"]).scores.numpy().tobytes()
    assert sharded.numpy().tobytes() == fx["ref"].tobytes()


def test_sharded_answers_match_the_jax_replicated_engine(fx):
    jt = JaxTaskType.LOGISTIC_REGRESSION
    jmodel = JaxGameModel({"fixed": JaxFixedEffectModel(JaxCoefficients(jnp.asarray(fx["w"])), jt),
                           "per-e": JaxRandomEffectModel(jnp.asarray(fx["M"]), None, jt)})
    jspecs = {"fixed": JaxSpec(shard="g"),
              "per-e": JaxSpec(shard="re", random_effect_type="eid",
                               entity_index=dict(fx["specs"]["per-e"].entity_index))}
    jreqs = [JaxScoreRequest(features=dict(r.features), entity_ids=dict(r.entity_ids), offset=r.offset,
                             uid=r.uid) for r in fx["reqs"]]
    with JaxServingEngine(JaxServingBundle.from_model(jmodel, jspecs, jt), max_batch=16) as jeng:
        theirs = _scores(jeng.score_batch(jreqs))
    for n in CARDS:
        ours, _ = _engine_scores(ServingBundle.from_model(fx["model"], fx["specs"], TASK, device="cpu",
                                                          mesh=_cpu(n)), fx["reqs"])
        np.testing.assert_allclose(ours, theirs, rtol=TOL["rtol"], atol=TOL["atol"])


# --------------------------------------------------------------------- the plan


def _jax_bundle(fx, n):
    jt = JaxTaskType.LOGISTIC_REGRESSION
    jmodel = JaxGameModel({"fixed": JaxFixedEffectModel(JaxCoefficients(jnp.asarray(fx["w"])), jt),
                           "per-e": JaxRandomEffectModel(jnp.asarray(fx["M"]), None, jt)})
    jspecs = {"fixed": JaxSpec(shard="g"),
              "per-e": JaxSpec(shard="re", random_effect_type="eid",
                               entity_index=dict(fx["specs"]["per-e"].entity_index))}
    mesh = jax_make_mesh(jax.devices()[:n]) if n > 1 else None
    return JaxServingBundle.from_model(jmodel, jspecs, jt, mesh=mesh)


@pytest.mark.parametrize("old,new", [(1, 2), (1, 8), (8, 4), (4, 8), (8, 1), (4, 2), (2, 3), (1, 1)])
def test_the_plan_is_the_reference_plan(fx, old, new):
    """Segments, moved rows and bytes, padding and loads, field for field,
    against the JAX plan over the same shard counts on its CPU devices."""
    ours_b = ServingBundle.from_model(fx["model"], fx["specs"], TASK, device="cpu",
                                      mesh=_cpu(old) if old > 1 else None)
    theirs_b = _jax_bundle(fx, old)
    ours = plan_coordinate_reshard(ours_b.coordinates["per-e"], _cpu(new) if new > 1 else None)
    theirs = jax_plan_coordinate_reshard(theirs_b.coordinates["per-e"],
                                         jax_make_mesh(jax.devices()[:new]) if new > 1 else None)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert (ours.moved_rows > 0) == (old != new)
    plan = plan_reshard(ours_b, _cpu(new) if new > 1 else None)
    assert (plan.old_shards, plan.new_shards, plan.moved_bytes) == (old, new, ours.moved_bytes)


# ------------------------------------------------------------- live reshards


def test_shrink_regrow_replicate_bitwise_and_under_traffic(fx):
    """8 -> 4 -> 8 -> replicated while a client scores through the batcher:
    every answer the replicated bits, none failed, no recompile after each
    pre-warm, the journal's shard counts the plan's."""
    reqs, ref = fx["reqs"], fx["ref"]
    bundle = ServingBundle.from_model(fx["model"], fx["specs"], TASK, device="cpu", mesh=_cpu(8))
    stop, bad, answered = threading.Event(), [], [0]
    with ServingEngine(bundle, max_batch=16) as eng:
        eng.warmup()

        def traffic(b):
            j = 0
            while not stop.is_set():
                try:
                    if np.float32(b.submit(reqs[j % N], block=True).result(timeout=60).score) != ref[j % N]:
                        bad.append(j)
                    answered[0] += 1
                except Exception as exc:  # noqa: BLE001 - counted: the drill wants none
                    bad.append(repr(exc))
                j += 1

        with eng.batcher(max_wait_ms=0.5) as b:
            th = threading.Thread(target=traffic, args=(b,), name="entity-shard-traffic")
            th.start()
            infos = []
            try:
                for target in (surviving_mesh(4, device="cpu"), make_mesh(device="cpu"), None):
                    time.sleep(0.02)
                    infos.append(eng.reshard_orchestrator.reshard(target))
                    assert _scores(eng.score_batch(reqs)).tobytes() == ref.tobytes()
                    assert eng.recompiles_after_warmup == 0
            finally:
                stop.set()
                th.join(timeout=60)
        m = eng.metrics()
    assert not bad and answered[0] > 0
    assert [(i["old_shards"], i["new_shards"]) for i in infos] == [(8, 4), (4, 8), (8, 1)]
    assert all(i["committed"] and i["old_released"] for i in infos) and infos[1]["moved_rows"] > 0
    assert m["bundle_reshards"] == 3 and m["bundle_version"] == 3
    assert m["sharding"]["entity_sharded"] is False and faults.COUNTERS.get("reshard_rollbacks") == 0


@pytest.mark.parametrize("site", ["reshard_stage:9999", "reshard_commit:1"])
def test_a_failed_reshard_rolls_back_with_the_old_generation_serving(fx, site):
    reqs, ref = fx["reqs"], fx["ref"]
    bundle = ServingBundle.from_model(fx["model"], fx["specs"], TASK, device="cpu", mesh=_cpu(8))
    with ServingEngine(bundle, max_batch=16) as eng:
        eng.warmup()
        with faults.inject(site):
            with pytest.raises(faults.InjectedFault):
                eng.reshard_orchestrator.reshard(surviving_mesh(4, device="cpu"))
            assert _scores(eng.score_batch(reqs)).tobytes() == ref.tobytes()
        m = eng.metrics()
        assert (m["bundle_version"], m["bundle_reshards"], m["bundle_reshard_rollbacks"]) == (0, 0, 1)
        assert eng.bundle.coordinates["per-e"].mesh.size == 8 and not eng.bundle.released
        assert faults.COUNTERS.get("reshard_rollbacks") == 1
        assert (faults.COUNTERS.get("reshard_retries") > 0) == site.startswith("reshard_stage")
        info = eng.reshard_orchestrator.reshard(surviving_mesh(4, device="cpu"))  # nothing wedged
        assert info["version"] == 1 and _scores(eng.score_batch(reqs)).tobytes() == ref.tobytes()


def test_reshard_journal_lines_validate(fx, tmp_path, capsys):
    path = str(tmp_path / "journal.jsonl")
    journal = telemetry.RunJournal(path)
    telemetry.install_journal(journal)
    try:
        bundle = ServingBundle.from_model(fx["model"], fx["specs"], TASK, device="cpu", mesh=_cpu(8))
        with ServingEngine(bundle, max_batch=16) as eng:
            eng.reshard_orchestrator.reshard(surviving_mesh(4, device="cpu"))
            with faults.inject("reshard_commit:1"):
                with pytest.raises(faults.InjectedFault):
                    eng.reshard_orchestrator.reshard(make_mesh(device="cpu"))
    finally:
        telemetry.uninstall_journal()
        journal.close()
    lines = [json.loads(line) for line in open(path) if line.strip()]
    by_type = {d["type"]: d for d in lines}
    assert (by_type["reshard_commit"]["old_shards"], by_type["reshard_commit"]["new_shards"]) == (8, 4)
    assert (by_type["reshard_rollback"]["old_shards"], by_type["reshard_rollback"]["new_shards"]) == (4, 8)
    assert by_type["reshard_start"]["moved_rows"] > 0
    for main in (obs.main, jax_obs.main):
        assert main(["journal", path, "--validate"]) == 0
        capsys.readouterr()


# ------------------------------------------------------------ loss, budget, delta


def test_a_lost_card_answers_its_entities_fe_only_until_restaged(fx):
    model, specs, reqs, ref = fx["model"], fx["specs"], fx["reqs"], fx["ref"]
    with ServingEngine(ServingBundle.from_model(model, specs, TASK, device="cpu"), max_batch=16) as eng:
        fe_only = _scores(eng.score_batch_fe_only(reqs))
    bundle = ServingBundle.from_model(model, specs, TASK, device="cpu", mesh=_cpu(4))
    c = bundle.coordinates["per-e"]
    with ServingEngine(bundle, max_batch=16) as eng:
        lo, hi = eng.mark_shard_lost("per-e", 1)
        degraded = _scores(eng.score_batch(reqs))
        rows, _ = c.lookup_rows([r.entity_ids["eid"] for r in reqs])
        lost = (rows >= lo) & (rows < hi)
        assert lost.any() and not lost.all()
        assert degraded.tobytes() == np.where(lost, fe_only, ref).tobytes()
        m = eng.metrics()
        assert m["state"] == "DEGRADED" and "shard_loss:per-e/1" in m["degraded_reasons"]
        assert (m["sharding"]["shards_lost"], m["sharding"]["shard_loss_fallbacks"]) == (1, int(lost.sum()))
        host = c.params.blocks[1].numpy().copy()
        c.params.blocks[1].zero_()  # the card's rows are gone
        assert eng.restage_shard("per-e", 1, rows=host) == (hi - lo) * D_RE * 4
        assert _scores(eng.score_batch(reqs)).tobytes() == ref.tobytes()
        assert eng.metrics()["state"] == "READY" and eng.recompiles_after_warmup in (None, 0)


def test_budgets_count_a_sharded_store_per_card(fx):
    repl = ServingBundle.from_model(fx["model"], fx["specs"], TASK, device="cpu")
    sh = ServingBundle.from_model(fx["model"], fx["specs"], TASK, device="cpu", mesh=_cpu(4))
    fe_bytes = D_FE * 4
    per = -(-(E + 1) // 4)
    assert sh.device_bytes() == fe_bytes + 4 * per * D_RE * 4
    assert sh.device_bytes_per_shard() == _bundle_device_bytes(sh) == fe_bytes + per * D_RE * 4
    assert fe_bytes <= sh.device_bytes_per_shard() < repl.device_bytes_per_shard() == repl.device_bytes()
    # The host tier and the precision ladder refuse a sharded coordinate, in the reference's words.
    with pytest.raises(ValueError, match="entity-sharded over a mesh; demotion"):
        demote_bundle_to_host_tier(sh)
    with pytest.raises(ValueError, match="entity-sharded over a mesh; precision-tier"):
        quantize_bundle_rows(sh, "bf16")
    with pytest.raises(ValueError, match="hot_rows and mesh staging are mutually exclusive"):
        ServingBundle.from_model(fx["model"], fx["specs"], TASK, device="cpu", mesh=_cpu(2), hot_rows=4)


def test_a_delta_on_a_sharded_bundle(fx):
    """Changed rows and an appended entity inside the padding apply card by
    card, bit-equal to the replicated engine on the new model; growth past
    the padding and a re-sort are refused in the reference's words."""
    M2 = np.zeros((E + 2, D_RE), np.float32)
    M2[:E] = fx["M"][:E]
    M2[3] += 1.0
    M2[E] = 0.5  # the new entity "40"
    index = {str(i): i for i in range(E + 1)}
    delta = DeltaBundle("test", "delta", {"per-e": CoordinateDelta(
        "per-e", rows=np.array([3, E]), values=M2[[3, E]], entity_index=index, logical_rows=E + 2)},
        delta_rows=2, total_rows=E + 1)
    reqs = fx["reqs"] + [ScoreRequest(features=dict(fx["reqs"][0].features), entity_ids={"eid": str(E)})]
    model2 = GameModel({"fixed": fx["model"]["fixed"], "per-e": RandomEffectModel(torch.from_numpy(M2), None, TASK)})
    specs2 = dict(fx["specs"], **{"per-e": CoordinateScoringSpec(shard="re", random_effect_type="eid",
                                                                 entity_index=index)})
    want, _ = _engine_scores(ServingBundle.from_model(model2, specs2, TASK, device="cpu"), reqs)
    with ServingEngine(ServingBundle.from_model(fx["model"], fx["specs"], TASK, device="cpu", mesh=_cpu(4)),
                       max_batch=16) as eng:
        info = apply_delta(eng, delta)
        assert info["committed"] and eng.bundle.coordinates["per-e"].mesh.size == 4
        assert _scores(eng.score_batch(reqs)).tobytes() == want.tobytes()
    with ServingEngine(ServingBundle.from_model(fx["model"], fx["specs"], TASK, device="cpu", mesh=_cpu(2)),
                       max_batch=16) as eng:  # 2 x 21 rows: E + 2 = 42 fits, E + 3 does not
        for d, match in ((dataclasses.replace(delta.coordinates["per-e"], logical_rows=E + 3), "past the mesh-padded"),
                         (dataclasses.replace(delta.coordinates["per-e"], carry_old=np.array([0, 1]),
                                              carry_new=np.array([1, 0])), "re-sorts carried entity rows")):
            with pytest.raises(ValueError, match=match):
                apply_delta(eng, dataclasses.replace(delta, coordinates={"per-e": d}))
        assert eng.bundle_version == 0 and faults.COUNTERS.get("delta_rollbacks") == 2


def test_the_collective_site_is_retried_and_counted(fx, monkeypatch):
    """The transformer's gather over a row-sharded matrix fires `collective`
    once a chunk: one failure is re-dispatched to the same bits and counted;
    past PHOTON_COLLECTIVE_RETRIES it propagates. The engine's gather fires
    no site."""
    t = GameTransformer(_sharded_model(fx, _cpu(4)), fx["specs"], TASK)
    with faults.inject("collective:1"):
        got = t.transform(fx["ds"]).scores.numpy()
    assert got.tobytes() == fx["ref"].tobytes() and faults.COUNTERS.get("collective_retries") == 1
    monkeypatch.setenv("PHOTON_COLLECTIVE_RETRIES", "0")
    with faults.inject("collective:1"):
        got, _ = _engine_scores(ServingBundle.from_model(fx["model"], fx["specs"], TASK, device="cpu",
                                                         mesh=_cpu(4)), fx["reqs"])
        with pytest.raises(faults.InjectedFault):  # the first invocation: the engine fired none
            t.transform(fx["ds"])
    assert got.tobytes() == fx["ref"].tobytes()
    with faults.inject("collective:9999"):
        with pmesh.collective_faults_suppressed():
            assert t.transform(fx["ds"]).scores.numpy().tobytes() == fx["ref"].tobytes()
    assert faults.COUNTERS.get("collective_retries") == 1
