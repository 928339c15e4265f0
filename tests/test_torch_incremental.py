"""Continuous refresh in the port against the JAX package, on the CPU.

The cases of tests/test_incremental.py on the port (fingerprint diffs, plan
modes, the knob default, growth through a re-sort with variances, the three
fit modes, the stale-checkpoint discard, the delta records and the
journal), held against the JAX package on the same numpy inputs:

  * `take_rows`, `concat_datasets` and the fingerprints give the
    reference's rows, ELL padding, tag tables and digests (byte for byte);
  * one JAX fit, carried into the port (`convert.fit_state_from_numpy`),
    refreshes in the port to the JAX refresh's plan and records, its
    unchanged entities bit-equal, its re-solved coefficients within
    PORT_TOLERANCES["glmix"];
  * delta bundles built by both packages from the same states have the
    same rows, carry maps and manifests;
  * a delta applied to a live port engine answers bit-equal to a cold
    engine of the new state, and the `shard_upload` and `reshard_commit`
    drills under traffic leave the old generation serving with no failed
    request;
  * a two-tier bundle takes a delta bit-equal to a cold engine, a
    row-block bundle's growth or re-sort is refused, and the per-tenant
    apply flips one tenant of a registry.
"""

from __future__ import annotations

import json
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.data import containers as jax_containers
from photon_ml_tpu.data import fingerprints as jax_fp
from photon_ml_tpu.data import game_dataset as jax_gd
from photon_ml_tpu.game import incremental as jax_inc
from photon_ml_tpu.game.checkpoint import read_delta_records as jax_read_delta_records
from photon_ml_tpu.game.model import RandomEffectModel as JaxREModel
from photon_ml_tpu.optimize import config as jax_config
from photon_ml_tpu.serving import delta as jax_delta
from photon_ml_tpu.types import TaskType as JaxTask
from photon_ml_tpu.utils import knobs as jax_knobs
from photon_ml_tpu.utils import telemetry as jax_telemetry
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.convert import FixedEffectArrays, RandomEffectArrays, fit_state_from_numpy
from photon_ml_tpu_torch.data.containers import SparseFeatures
from photon_ml_tpu_torch.data.fingerprints import diff_fingerprints, fingerprint_dataset
from photon_ml_tpu_torch.data.game_dataset import (
    FixedEffectDataConfig,
    GameDataset,
    RandomEffectDataConfig,
    concat_datasets,
    take_rows,
)
from photon_ml_tpu_torch.game import incremental
from photon_ml_tpu_torch.game.checkpoint import read_delta_records
from photon_ml_tpu_torch.game.model import GameModel, RandomEffectModel
from photon_ml_tpu_torch.optimize.config import L2, CoordinateOptimizationConfig, OptimizerConfig
from photon_ml_tpu_torch.serving import ScoreRequest, ServingBundle, ServingEngine
from photon_ml_tpu_torch.serving.delta import apply_delta, apply_delta_for_tenant, build_delta_bundle
from photon_ml_tpu_torch.types import TaskType
from photon_ml_tpu_torch.utils import faults, telemetry
from photon_ml_tpu_torch.utils.knobs import get_knob

pytestmark = pytest.mark.serving

TASK = TaskType.LOGISTIC_REGRESSION
D_FE, D_RE, E = 6, 4, 10
GLMIX = PORT_TOLERANCES["glmix"]

DATA_CONFIGS = {"fixed": FixedEffectDataConfig("g"),
                "per-e": RandomEffectDataConfig("eid", "re", min_bucket=4)}
_OC = CoordinateOptimizationConfig(optimizer=OptimizerConfig(max_iterations=25), regularization=L2,
                                   reg_weight=1.0)
OPT_CONFIGS = {"fixed": _OC, "per-e": _OC}

JAX_DATA_CONFIGS = {"fixed": jax_gd.FixedEffectDataConfig("g"),
                    "per-e": jax_gd.RandomEffectDataConfig("eid", "re", min_bucket=4)}
_JOC = jax_config.CoordinateOptimizationConfig(
    optimizer=jax_config.OptimizerConfig(max_iterations=25), regularization=jax_config.L2,
    reg_weight=1.0)
JAX_OPT_CONFIGS = {"fixed": _JOC, "per-e": _JOC}
JAX_TASK = JaxTask.LOGISTIC_REGRESSION


@pytest.fixture(autouse=True)
def _port_fault_hygiene():
    faults.clear()
    telemetry.METRICS.reset()
    yield
    faults.clear()
    telemetry.METRICS.reset()


def _arrays(rng, n, ent):
    return dict(g=rng.normal(size=(n, D_FE)).astype(np.float32),
                re=rng.normal(size=(n, D_RE)).astype(np.float32),
                y=(rng.uniform(size=n) < 0.5).astype(np.float32), eid=np.asarray(ent, np.int64))


def _port(a):
    return GameDataset.build({"g": a["g"], "re": a["re"]}, a["y"], id_tags={"eid": a["eid"]},
                             device="cpu")


def _jax(a):
    return jax_gd.GameDataset.build({"g": jnp.asarray(a["g"]), "re": jnp.asarray(a["re"])}, a["y"],
                                    id_tags={"eid": a["eid"]})


def _cat(a, b):
    return {k: np.concatenate([a[k], b[k]]) for k in a}


def _base(rng, n=64):
    return _arrays(rng, n, rng.integers(0, E, size=n))


def _delta_batch(rng, n=12, ent=(2, 5, E)):
    """n delta rows over the given entity pool (E: one new id)."""
    return _arrays(rng, n, np.resize(np.asarray(ent), n))


def _fit(ds, **kw):
    return incremental.full_fit(ds, DATA_CONFIGS, OPT_CONFIGS, TASK, **kw)


def _refit(merged, prev, **kw):
    return incremental.incremental_fit(merged, DATA_CONFIGS, OPT_CONFIGS, TASK, prev=prev, **kw)


def _carry(jax_state, port_ds):
    """A JAX FitState as the port's, through convert.fit_state_from_numpy."""
    arrays = {}
    for cid, m in jax_state.model.models.items():
        if isinstance(m, JaxREModel):
            arrays[cid] = RandomEffectArrays("re", "eid", np.asarray(m.coefficients_matrix),
                                             jax_state.entity_indices[cid])
        else:
            arrays[cid] = FixedEffectArrays("g", np.asarray(m.coefficients.means))
    return fit_state_from_numpy(arrays, TASK, port_ds, DATA_CONFIGS, device="cpu")


def _fp_fields(fp):
    """A DatasetFingerprints of either package as plain values."""
    return fp.num_samples, {cid: (c.digest, c.entity_digests, c.entity_rows)
                            for cid, c in fp.coordinates.items()}


def _diff_fields(diffs):
    return {cid: (d.changed, d.changed_entities, d.new_entities, d.delta_rows)
            for cid, d in diffs.items()}


def _plan_fields(plan):
    return (plan.mode, plan.changed_coordinates, plan.changed_entities, plan.new_entities,
            plan.delta_rows, plan.total_rows)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """One JAX round: a full fit of 64 rows, then 12 delta rows over entities
    -1 (sorts first: every carried row moves), 2, 5 and E (new), refit
    incrementally with a checkpoint directory and a journal, and its delta
    bundle."""
    rng = np.random.default_rng(20260729)
    base = _base(rng)
    batch = _delta_batch(rng, ent=(-1, 2, 5, E))
    merged = _cat(base, batch)
    ckpt = str(tmp_path_factory.mktemp("jax-ckpt"))
    journal_path = str(tmp_path_factory.mktemp("jax-journal") / "journal.jsonl")
    st = jax_inc.full_fit(_jax(base), JAX_DATA_CONFIGS, JAX_OPT_CONFIGS, JAX_TASK)
    journal = jax_telemetry.RunJournal(journal_path)
    jax_telemetry.install_journal(journal)
    try:
        res = jax_inc.incremental_fit(_jax(merged), JAX_DATA_CONFIGS, JAX_OPT_CONFIGS, JAX_TASK,
                                      prev=st, checkpoint_dir=ckpt)
    finally:
        jax_telemetry.uninstall_journal()
        journal.close()
    delta = jax_delta.build_delta_bundle(st, res.state, source="test", mode=res.plan.mode,
                                         delta_rows=res.plan.delta_rows,
                                         total_rows=res.plan.total_rows)
    return dict(base=base, merged=merged, st=st, res=res, delta=delta,
                records=jax_read_delta_records(ckpt), journal=journal_path)


@pytest.fixture(scope="module")
def port_round(ref, tmp_path_factory):
    """The same round in the port, from the JAX fit carried across."""
    prev = _carry(ref["st"], _port(ref["base"]))
    ckpt = str(tmp_path_factory.mktemp("port-ckpt"))
    journal_path = str(tmp_path_factory.mktemp("port-journal") / "journal.jsonl")
    journal = telemetry.RunJournal(journal_path)
    telemetry.install_journal(journal)
    try:
        res = _refit(_port(ref["merged"]), prev, checkpoint_dir=ckpt)
    finally:
        telemetry.uninstall_journal()
        journal.close()
    delta = build_delta_bundle(prev, res.state, source="test", mode=res.plan.mode,
                               delta_rows=res.plan.delta_rows, total_rows=res.plan.total_rows)
    return dict(prev=prev, res=res, delta=delta, records=read_delta_records(ckpt),
                journal=journal_path)


# ------------------------------------------------------------ datasets


def test_take_rows_and_concat_match_the_reference(rng):
    """Sparse planes of two widths (K 3 and 5) and a dense shard: concat
    pads the narrower ELL planes at the end with inert slots, and both
    functions keep sample order and every tag, as the JAX ones do."""
    def sparse(n, k):
        idx = np.stack([rng.choice(20, size=k, replace=False) for _ in range(n)]).astype(np.int32)
        return idx, rng.normal(size=(n, k)).astype(np.float32)

    parts = []
    for n, k in ((9, 3), (5, 5)):
        idx, val = sparse(n, k)
        a = _arrays(rng, n, rng.integers(0, 4, size=n) * 7)
        port = GameDataset.build({"s": SparseFeatures(torch.from_numpy(idx), torch.from_numpy(val), 20),
                                  "re": a["re"]}, a["y"], id_tags={"eid": a["eid"]}, device="cpu")
        jax = jax_gd.GameDataset.build(
            {"s": jax_containers.SparseFeatures(indices=jnp.asarray(idx), values=jnp.asarray(val),
                                                dim=20),
             "re": jnp.asarray(a["re"])}, a["y"], id_tags={"eid": a["eid"]})
        parts.append((port, jax))
    cat_p = concat_datasets(parts[0][0], parts[1][0])
    cat_j = jax_gd.concat_datasets(parts[0][1], parts[1][1])
    rows = np.array([13, 0, 4, 9, 2])
    for got, want in ((cat_p, cat_j), (take_rows(cat_p, rows), jax_gd.take_rows(cat_j, rows))):
        sp, sj = got.shards["s"], want.peek_shard("s")
        np.testing.assert_array_equal(sp.indices.numpy(), np.asarray(sj.indices))
        np.testing.assert_array_equal(sp.values.numpy(), np.asarray(sj.values))
        np.testing.assert_array_equal(got.shards["re"].numpy(), np.asarray(want.peek_shard("re")))
        np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
        np.testing.assert_array_equal(got.id_tags["eid"], np.asarray(want.id_tags["eid"]))
        codes, table = got.tag_codes["eid"]
        np.testing.assert_array_equal(table[codes], got.id_tags["eid"])
    # The merged tag table is the union, sorted; take_rows keeps it whole.
    np.testing.assert_array_equal(cat_p.tag_codes["eid"][1], np.unique(np.asarray(cat_j.id_tags["eid"])))
    assert take_rows(cat_p, rows).tag_codes["eid"][1] is cat_p.tag_codes["eid"][1]
    # The fingerprints read either package's planes to the same bytes.
    configs = {"s": FixedEffectDataConfig("s"), "per": RandomEffectDataConfig("eid", "s")}
    jconfigs = {"s": jax_gd.FixedEffectDataConfig("s"), "per": jax_gd.RandomEffectDataConfig("eid", "s")}
    assert (_fp_fields(fingerprint_dataset(cat_p, configs))
            == _fp_fields(jax_fp.fingerprint_dataset(cat_j, jconfigs)))


# ------------------------------------------------------------ fingerprints


def test_fingerprints_match_the_reference_byte_for_byte(ref, port_round):
    assert _fp_fields(port_round["prev"].fingerprints) == _fp_fields(ref["st"].fingerprints)
    assert _fp_fields(port_round["res"].state.fingerprints) == _fp_fields(ref["res"].state.fingerprints)


def test_diff_localizes_churned_and_new_entities(rng):
    base = _base(rng)
    merged = _cat(base, _delta_batch(rng, ent=(2, 5, E)))
    prev, new = (fingerprint_dataset(_port(a), DATA_CONFIGS) for a in (base, merged))
    diffs = diff_fingerprints(prev, new)
    assert diffs["fixed"].changed  # the fixed effect covers every row
    d = diffs["per-e"]
    assert set(d.changed_entities) == {2, 5, E} and d.new_entities == (E,)
    assert d.delta_rows == int(np.isin(merged["eid"], [2, 5, E]).sum())
    assert _diff_fields(diffs) == _diff_fields(jax_fp.diff_fingerprints(
        *(jax_fp.fingerprint_dataset(_jax(a), JAX_DATA_CONFIGS) for a in (base, merged))))


def test_identical_snapshot_diffs_clean(rng):
    base = _port(_base(rng))
    a, b = fingerprint_dataset(base, DATA_CONFIGS), fingerprint_dataset(base, DATA_CONFIGS)
    assert all(not d.changed for d in diff_fingerprints(a, b).values())


def test_entity_removal_is_loud(rng):
    base = _port(_base(rng))
    prev = fingerprint_dataset(base, DATA_CONFIGS)
    keep = np.nonzero(base.id_tags["eid"] != base.id_tags["eid"][0])[0]
    with pytest.raises(ValueError, match="append/update-only"):
        diff_fingerprints(prev, fingerprint_dataset(take_rows(base, keep), DATA_CONFIGS))


def _re_edit(a, scale):
    """`a` with entity a["eid"][0]'s random-effect rows scaled in place."""
    target = int(a["eid"][0])
    edited = dict(a, re=a["re"].copy())
    edited["re"][a["eid"] == target] *= scale
    return edited, target


def test_in_place_re_edit_localizes_to_one_entity(rng):
    base = _base(rng)
    edited, target = _re_edit(base, 2.0)
    diffs = diff_fingerprints(*(fingerprint_dataset(_port(a), DATA_CONFIGS) for a in (base, edited)))
    assert not diffs["fixed"].changed  # its shard, labels, offsets and weights are the same bytes
    assert diffs["per-e"].changed_entities == (target,) and diffs["per-e"].new_entities == ()


# ------------------------------------------------------------- plans


def test_plan_modes_and_the_knob_default(rng, monkeypatch):
    base = _base(rng)
    merged = _cat(base, _delta_batch(rng))
    prev, new = (fingerprint_dataset(_port(a), DATA_CONFIGS) for a in (base, merged))
    jprev, jnew = (jax_fp.fingerprint_dataset(_jax(a), JAX_DATA_CONFIGS) for a in (base, merged))
    same = incremental.plan_delta_fit(prev, prev)
    assert same.mode == "none" and same.changed_coordinates == ()
    for frac, mode in ((0.9, "delta"), (0.01, "full")):  # the escape hatch
        plan = incremental.plan_delta_fit(prev, new, max_delta_fraction=frac)
        assert plan.mode == mode
        assert _plan_fields(plan) == _plan_fields(jax_inc.plan_delta_fit(jprev, jnew,
                                                                         max_delta_fraction=frac))
    for name in ("PHOTON_REFRESH_MAX_DELTA_FRACTION", "PHOTON_REFRESH_BATCH_ROWS"):
        assert get_knob(name) == jax_knobs.get_knob(name)
    monkeypatch.setenv("PHOTON_REFRESH_MAX_DELTA_FRACTION", "0.0001")
    assert incremental.plan_delta_fit(prev, new).mode == "full"


# ------------------------------------------------------------ model growth


def test_grow_moves_rows_by_key_through_a_resort_with_variances(rng):
    mat = rng.normal(size=(4, D_RE)).astype(np.float32)
    mat[3] = 0.0
    var = rng.uniform(size=(4, D_RE)).astype(np.float32)
    prev_idx = {2: 0, 5: 1, 9: 2}
    new_idx = {-1: 0, 2: 1, 5: 2, 7: 3, 9: 4}  # -1 sorts first: every carried row moves
    got = incremental.grow_random_effect_model(
        RandomEffectModel(torch.from_numpy(mat), torch.from_numpy(var), TASK), prev_idx, new_idx)
    want = jax_inc.grow_random_effect_model(JaxREModel(jnp.asarray(mat), jnp.asarray(var), JAX_TASK),
                                            prev_idx, new_idx)
    np.testing.assert_array_equal(got.coefficients_matrix.numpy(), np.asarray(want.coefficients_matrix))
    np.testing.assert_array_equal(got.variances_matrix.numpy(), np.asarray(want.variances_matrix))
    for k, row in prev_idx.items():
        assert np.array_equal(got.coefficients_matrix[new_idx[k]].numpy(), mat[row])


# --------------------------------------------------------- incremental fit


def test_nothing_changed_carries_the_model_object(rng):
    base = _port(_base(rng))
    st = _fit(base)
    res = _refit(base, st)
    assert res.plan.mode == "none" and res.state.model is st.model and res.max_rel_diff == 0.0


def test_a_carried_jax_state_refreshes_to_the_reference_round(ref, port_round):
    """Plan, records and journal as the JAX round's; unchanged entities
    bit-equal to the carried JAX rows; re-solved coefficients within
    PORT_TOLERANCES["glmix"] of the JAX refresh's."""
    res, jres = port_round["res"], ref["res"]
    assert res.plan.mode == "delta"
    assert _plan_fields(res.plan) == _plan_fields(jres.plan)
    assert res.state.entity_indices == jres.state.entity_indices
    changed = set(res.plan.changed_entities["per-e"])
    prev_idx, new_idx = ref["st"].entity_indices["per-e"], res.state.entity_indices["per-e"]
    pm = np.asarray(ref["st"].model["per-e"].coefficients_matrix)
    nm = res.state.model["per-e"].coefficients_matrix.numpy()
    unchanged = [k for k in prev_idx if k not in changed]
    assert unchanged and all(np.array_equal(pm[prev_idx[k]], nm[new_idx[k]]) for k in unchanged)
    np.testing.assert_allclose(nm, np.asarray(jres.state.model["per-e"].coefficients_matrix), rtol=0,
                               atol=GLMIX["coef_atol"])
    np.testing.assert_allclose(res.state.model["fixed"].coefficients.means.numpy(),
                               np.asarray(jres.state.model["fixed"].coefficients.means), rtol=0,
                               atol=GLMIX["coef_atol"])
    assert nm[new_idx[E]].any() and nm[new_idx[-1]].any()  # the new entities learned something
    (rec,), (jrec,) = port_round["records"], ref["records"]
    assert rec.keys() == jrec.keys()
    # Every field but the two measured floats (seconds, max_rel_diff).
    assert {k: v for k, v in rec.items() if not isinstance(v, float)} == \
        {k: v for k, v in jrec.items() if not isinstance(v, float)}
    assert rec["max_rel_diff"] == res.max_rel_diff > 0.0
    types = [json.loads(line)["type"] for line in open(port_round["journal"]) if line.strip()]
    assert types == [json.loads(line)["type"] for line in open(ref["journal"]) if line.strip()]
    for validate in (telemetry.validate_journal, jax_telemetry.validate_journal):
        assert validate(port_round["journal"]) == (len(types), [])


def test_unchanged_coordinate_carried_bitwise(rng):
    """An in-place edit of one entity's random-effect rows: the fixed
    effect is carried as the same tensor, every other entity's row
    bit-equal."""
    base = _base(rng)
    st = _fit(_port(base))
    edited, target = _re_edit(base, 1.5)
    res = _refit(_port(edited), st)
    assert res.plan.mode == "delta" and res.plan.changed_coordinates == ("per-e",)
    assert "fixed" in res.carried_coordinates
    assert res.state.model["fixed"] is st.model["fixed"]
    pm = st.model["per-e"].coefficients_matrix
    nm = res.state.model["per-e"].coefficients_matrix
    row = st.entity_indices["per-e"][target]
    others = [r for k, r in st.entity_indices["per-e"].items() if k != target]
    assert torch.equal(pm[others], nm[others]) and not torch.equal(pm[row], nm[row])
    assert res.max_rel_diff > 0.0


def test_full_mode_grows_then_refits_and_discards_a_stale_checkpoint(rng, tmp_path):
    """Two full-mode rounds sharing one checkpoint directory (the refresh
    loop's shape): the second round's merged rows are a new configuration,
    so the first round's checkpoint is discarded, not resumed or refused."""
    ckpt = str(tmp_path / "ckpt")
    base = _base(rng)
    st = _fit(_port(base))
    merged1 = _cat(base, _delta_batch(rng))
    res1 = _refit(_port(merged1), st, max_delta_fraction=0.01, checkpoint_dir=ckpt)
    merged2 = _cat(merged1, _delta_batch(rng, ent=(3, E + 1)))
    res2 = _refit(_port(merged2), res1.state, max_delta_fraction=0.01, checkpoint_dir=ckpt)
    assert res1.plan.mode == res2.plan.mode == "full"
    assert set(res1.state.entity_indices["per-e"]) == set(np.unique(merged1["eid"]).tolist())
    assert set(res2.state.entity_indices["per-e"]) == set(np.unique(merged2["eid"]).tolist())
    assert [r["mode"] for r in read_delta_records(ckpt)] == ["full", "full"]


# ------------------------------------------------------------ delta bundles


def _assert_same_delta(got, want, values_exact: bool):
    assert got.manifest() == want.manifest()
    for cid, d in want.coordinates.items():
        g = got.coordinates[cid]
        if d.plane is not None:
            np.testing.assert_allclose(g.plane, d.plane, rtol=0, atol=0 if values_exact else GLMIX["coef_atol"])
            continue
        np.testing.assert_array_equal(g.rows, d.rows)
        for a, b in ((g.carry_old, d.carry_old), (g.carry_new, d.carry_new)):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
        assert g.entity_index == d.entity_index and g.logical_rows == d.logical_rows
        np.testing.assert_allclose(g.values, d.values, rtol=0, atol=0 if values_exact else GLMIX["coef_atol"])


def test_delta_bundles_of_both_packages_match(ref, port_round):
    """From the JAX states carried across, the port's bundle is the JAX
    bundle bit for bit; from the port's own refresh, the same rows, carry
    maps (the -1 prepend moves every carried row by one) and manifest."""
    jd = ref["delta"]
    prev, new = _carry(ref["st"], _port(ref["base"])), _carry(ref["res"].state, _port(ref["merged"]))
    carried = build_delta_bundle(prev, new, source="test", mode=jd.mode, delta_rows=jd.delta_rows,
                                 total_rows=jd.total_rows)
    _assert_same_delta(carried, jd, values_exact=True)
    _assert_same_delta(port_round["delta"], jd, values_exact=False)
    d = port_round["delta"].coordinates["per-e"]
    np.testing.assert_array_equal(d.carry_new, d.carry_old + 1)


def test_identical_states_make_an_empty_bundle_and_a_noop_apply(rng):
    st = _fit(_port(_base(rng)))
    delta = build_delta_bundle(st, st, source="noop", mode="none")
    assert delta.is_empty and delta.nbytes == 0
    with _engine(st) as eng:
        info = apply_delta(eng, delta)
        assert not info["committed"] and eng.bundle_version == 0
        assert eng.bundle.provenance["deltas_applied"] == 0


# ------------------------------------------------------- live delta apply


def _engine(state, **kw):
    specs = incremental.scoring_specs(DATA_CONFIGS, state.entity_indices)
    return ServingEngine(ServingBundle.from_model(state.model, specs, TASK, device="cpu", **kw),
                         max_batch=16)


def _requests(n=14):
    return [ScoreRequest(features={"g": np.full(D_FE, 0.25 * (i + 1), np.float32),
                                   "re": np.full(D_RE, 0.1 * (i + 1), np.float32)},
                         entity_ids={"eid": i % (E + 3) - 1}, uid=str(i))
            for i in range(n)]


def _scores(results):
    return [r.score for r in results]


def test_apply_matches_a_cold_engine_bitwise(port_round):
    prev, res, delta = port_round["prev"], port_round["res"], port_round["delta"]
    reqs = _requests()
    with _engine(res.state) as cold:
        want = _scores(cold.score_batch(reqs))
    eng = _engine(prev)
    try:
        eng.warmup()
        info = apply_delta(eng, delta)
        assert info["committed"] and info["version"] == 1
        assert info["delta_rows_staged"] == len(delta.coordinates["per-e"].rows)
        assert _scores(eng.score_batch(reqs)) == want
        assert eng.recompiles_after_warmup == 0
        prov = eng.bundle.provenance
        assert (prov["origin"], prov["deltas_applied"], prov["last_delta_source"],
                prov["generation"]) == ("incremental", 1, "test", 1)
        assert eng.metrics()["bundle_deltas"] == 1 and eng.metrics()["bundle_swaps"] == 0
        counts = faults.counters()
        assert counts["delta_applies"] == 1
        assert counts["delta_rows_staged"] == info["delta_rows_staged"]
        assert "serving_swaps" not in counts and "delta_rollbacks" not in counts
    finally:
        eng.close()
        eng.bundle.release()


@pytest.mark.parametrize("spec", ["shard_upload:9999", "reshard_commit:1"])
def test_a_failed_apply_rolls_back_under_traffic(port_round, spec, monkeypatch, tmp_path):
    """The rollback drill: a fault mid-apply leaves the old generation
    serving the same bits with no failed request, counts and journals the
    rollback; the same delta then commits."""
    monkeypatch.setenv("PHOTON_RETRY_BASE_DELAY_S", "0.001")
    reqs = _requests()
    eng = _engine(port_round["prev"])
    eng.warmup()
    ref = _scores(eng.score_batch(reqs))
    stop = threading.Event()
    failures: list = []
    answered = [0]

    def traffic(b):
        j = 0
        while not stop.is_set():
            try:
                if b.submit(reqs[j % len(reqs)], block=True).result(timeout=60).score != ref[j % len(reqs)]:
                    failures.append(f"drift at {j}")
                answered[0] += 1
            except Exception as exc:  # noqa: BLE001 - recorded
                failures.append(repr(exc))
            j += 1

    path = str(tmp_path / "journal.jsonl")
    journal = telemetry.RunJournal(path)
    telemetry.install_journal(journal)
    try:
        with eng, eng.batcher(max_wait_ms=0.5) as batcher:
            th = threading.Thread(target=traffic, args=(batcher,), name="photon-refresh-traffic")
            th.start()
            time.sleep(0.05)
            with faults.inject(spec):
                with pytest.raises(faults.InjectedFault):
                    apply_delta(eng, port_round["delta"])
            time.sleep(0.05)
            stop.set()
            th.join(timeout=60)
            assert not th.is_alive()
        assert not failures, failures[:3]
        assert answered[0] > 0 and eng.bundle_version == 0
        assert _scores(eng.score_batch(reqs)) == ref
        counts = faults.counters()
        assert counts["delta_rollbacks"] == 1 and "delta_applies" not in counts
        prov = eng.bundle.provenance
        assert prov["deltas_applied"] == 0 and prov["generation"] == 0
        assert apply_delta(eng, port_round["delta"])["committed"] and eng.bundle_version == 1
    finally:
        eng.bundle.release()
        telemetry.uninstall_journal()
        journal.close()
    types = [json.loads(line)["type"] for line in open(path) if line.strip()]
    assert "delta_rollback" in types and "delta_apply" in types
    assert jax_telemetry.validate_journal(path) == (len(types), [])


def test_the_two_tier_store_and_row_block_moves_are_refused(port_round, rng):
    """The two-tier store is ported since: its delta (the cold matrix
    rebuilt in host RAM, a new store of the same capacity) commits bit-equal
    to a cold single-tier engine of the new state. A row-block bundle
    follows the reference's mesh rules: a re-sort or growth past the padding
    is refused (the old generation keeps serving), a delta that fits commits
    bit-equal to a cold engine with the same blocks."""
    prev = port_round["prev"]
    with _engine(prev, hot_rows={"per-e": 4}) as eng:
        old_store = eng.bundle.coordinates["per-e"].store
        assert apply_delta(eng, port_round["delta"])["committed"]
        store = eng.bundle.coordinates["per-e"].store
        assert store is not old_store and store.capacity == 4 and old_store._closed
        reqs = _requests()
        with _engine(port_round["res"].state) as cold:
            assert _scores(eng.score_batch(reqs)) == _scores(cold.score_batch(reqs))
    eng.bundle.release()
    with _engine(prev, row_blocks=5) as eng:  # 15 rows: the growth fits, the re-sort does not
        with pytest.raises(ValueError, match="re-sorts carried entity rows"):
            apply_delta(eng, port_round["delta"])
        assert eng.bundle_version == 0 and faults.counters()["delta_rollbacks"] == 1
    # E + 1 = 11 rows in 2 blocks of 6: one appended entity fits, two do not.
    base = port_round["res"].state
    for n_new, fits in ((1, True), (2, False)):
        ent_idx = dict(prev.entity_indices["per-e"])
        new_idx = {**ent_idx, **{100 + i: len(ent_idx) + i for i in range(n_new)}}
        grown = incremental.grow_random_effect_model(prev.model["per-e"], ent_idx, new_idx)
        mat = grown.coefficients_matrix.clone()
        mat[len(ent_idx):len(new_idx)] = 0.5
        state = incremental.FitState(
            GameModel({"fixed": base.model["fixed"],
                                   "per-e": RandomEffectModel(mat, None, TASK)}),
            prev.fingerprints, {"fixed": None, "per-e": new_idx})
        delta = build_delta_bundle(prev, state, source="grow")
        assert delta.coordinates["per-e"].carry_old is None
        with _engine(prev, row_blocks=2) as eng:
            if fits:
                assert apply_delta(eng, delta)["committed"]
                with _engine(state, row_blocks=2) as cold:
                    reqs = _requests()
                    assert _scores(eng.score_batch(reqs)) == _scores(cold.score_batch(reqs))
            else:
                with pytest.raises(ValueError, match="mesh-padded"):
                    apply_delta(eng, delta)
                assert eng.bundle_version == 0


def test_the_per_tenant_apply_waits_for_tenancy(port_round):
    """Tenancy is ported: the per-tenant apply flips one tenant of a
    registry onto the delta, bit-equal to a cold engine of the new state,
    and leaves its neighbour's generation alone."""
    from photon_ml_tpu_torch.serving.tenancy import TenantRegistry

    prev, new = port_round["prev"], port_round["res"].state
    with TenantRegistry(max_batch=16) as reg:
        for name in ("fresh", "other"):
            reg.admit(name, ServingBundle.from_model(
                prev.model, incremental.scoring_specs(DATA_CONFIGS, prev.entity_indices), TASK,
                device="cpu"))
        info = apply_delta_for_tenant(reg, "fresh", port_round["delta"])
        assert info["committed"] and reg.tenant("fresh").engine.bundle_version == 1
        assert reg.tenant("other").engine.bundle_version == 0
        reqs = _requests()
        got = _scores([reg.submit("fresh", r, block=True).result() for r in reqs])
        with _engine(new) as cold:
            assert got == _scores(cold.score_batch(reqs))
        assert reg.metrics()["cobatch_compiles_after_warmup"] == 0
