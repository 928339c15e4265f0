"""The port's runtime planner (`photon_ml_tpu_torch/planner/`) against the
JAX package's, on the CPU.

  * the same fit and serve profile dicts, each with its package's own live
    topology, give the same decisions on the quantities the port plans
    (value, source, evidence, fallback);
  * precedence (knob > plan > default), `apply_online_decision` round trips
    and `plan_block(overrides=)` agree;
  * `ensure_ambient_plan`'s gates agree: PHOTON_PLAN=0, a missing
    PHOTON_PLAN_PROFILE runs unplanned, a missing `--profile` raises, a
    topology other than the run's raises, PHOTON_PLAN=1 calibrates;
  * with no plan installed every consulting site returns its default, and
    a plan moves the engine's, the batcher's and the registry's, and the
    Python Avro route's chunk (the same rows in any chunking).

The drivers' `--profile` runs are held elsewhere: `cli.train` in
tests/test_torch_cli.py (the planned model's bits), `cli.tune` in
tests/test_torch_tune_cli.py, `cli.serve` in tests/test_torch_autopilot.py.
"""

from __future__ import annotations

import json

import pytest
import torch

from photon_ml_tpu import planner as jax_planner
from photon_ml_tpu.utils import telemetry as jax_telemetry
from photon_ml_tpu.utils.contracts import PLAN_BLOCK_KEYS as JAX_PLAN_BLOCK_KEYS
from photon_ml_tpu.utils.contracts import PLAN_DECISION_KEYS as JAX_PLAN_DECISION_KEYS
from photon_ml_tpu_torch import planner
from photon_ml_tpu_torch.contracts import PLAN_BLOCK_KEYS, PLAN_DECISION_KEYS
from photon_ml_tpu_torch.utils import telemetry

# The quantities the port plans; the rest of the reference's have no
# counterpart (ROADMAP, Known differences).
PLANNED = ("ingest_chunk_rows", "serving_max_batch", "serving_max_wait_ms", "refresh_batch_rows",
           "refresh_max_delta_fraction", "tier_bf16_pressure", "tier_int8_pressure")
KNOBS = ("PHOTON_PLAN", "PHOTON_PLAN_PROFILE", "PHOTON_STREAM_CHUNK_ROWS", "PHOTON_REFRESH_BATCH_ROWS",
         "PHOTON_REFRESH_MAX_DELTA_FRACTION", "PHOTON_TIER_BF16_PRESSURE", "PHOTON_TIER_INT8_PRESSURE")


@pytest.fixture(autouse=True)
def _no_plans(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    planner.uninstall_plan()
    jax_planner.uninstall_plan()
    yield
    planner.uninstall_plan()
    jax_planner.uninstall_plan()


def _profile(kind: str, topology, **sections):
    """A profile of `kind` with the contract's keys and `sections` over them."""
    out = {"kind": kind, "wall_s": 1.0, "stages": {}, "dispatch": {}, "bucket_shapes": {},
           "device_topology": dict(topology), "roofline": {"hbm_gb_per_s": None}, "metrics": {}}
    if kind == "fit":
        out.update(fit_timing={}, ingest={})
    else:
        out.update(serving={})
    out.update(sections)
    return out


def _hist(values):
    h = telemetry.Histogram()
    for v in values:
        h.record(v)
    return h.snapshot()


PROFILES = {
    "fit-decode-bound": ("fit", dict(ingest={"streaming": True, "decode": 9.0, "assemble": 1.0})),
    "fit-assembly-bound": ("fit", dict(ingest={"streaming": True, "decode": 0.5, "assemble": 3.0})),
    "fit-balanced": ("fit", dict(ingest={"streaming": True, "decode": 1.0, "assemble": 1.5})),
    "fit-native": ("fit", dict(ingest={"ingest_path": "native", "streaming": False, "decode": 4.0})),
    "serve-small-batches": ("serve", dict(dispatch={"max_batch": 256, "max_wait_ms": 2.0},
                                          serving={"p50_ms": 1.6, "batch_size_p95": 3})),
    "serve-mid-batches": ("serve", dict(dispatch={"max_batch": 256, "max_wait_ms": 2.0},
                                        serving={"p50_ms": 40.0, "batch_size_p95": 100})),
    "serve-saturated": ("serve", dict(dispatch={"max_batch": 512, "max_wait_ms": 5.0},
                                      serving={"p50_ms": 7.0, "batch_size_p95": 512})),
    "serve-zero-wait": ("serve", dict(dispatch={"max_batch": 64, "max_wait_ms": 0.0}, serving={})),
    "serve-histogram": ("serve", dict(dispatch={"max_batch": 256, "max_wait_ms": 2.0},
                                      serving={"p50_ms": None},
                                      metrics={"histograms": {"serving_batch_size": _hist(
                                          [1, 2, 3, 5, 9, 17, 30, 33])}})),
}


@pytest.mark.parametrize("case", sorted(PROFILES))
def test_profile_rules_give_the_references_decisions(case):
    kind, sections = PROFILES[case]
    plan = planner.plan_from_profile(_profile(kind, telemetry.device_topology(None), **sections),
                                     "p.json")
    ref = jax_planner.plan_from_profile(_profile(kind, jax_telemetry.device_topology(), **sections),
                                       "p.json")
    assert plan.source == ref.source == "profile" and plan.profile_path == "p.json"
    assert set(plan.decisions) <= set(PLANNED) and plan.decisions
    for name, d in plan.decisions.items():
        assert d.as_dict() == ref.decisions[name].as_dict(), name
    assert tuple(plan.block()) == PLAN_BLOCK_KEYS == JAX_PLAN_BLOCK_KEYS
    assert PLAN_DECISION_KEYS == JAX_PLAN_DECISION_KEYS


@pytest.mark.parametrize("name", PLANNED)
def test_precedence_is_the_references(name, monkeypatch):
    for pkg in (planner, jax_planner):
        assert pkg.planned_value(name) == pkg.default_for(name)
    value = {"ingest_chunk_rows": 131_072, "serving_max_batch": 32, "serving_max_wait_ms": 0.5,
             "refresh_batch_rows": 1024, "refresh_max_delta_fraction": 0.75,
             "tier_bf16_pressure": 0.75, "tier_int8_pressure": 0.875}[name]
    got = [pkg.apply_online_decision(name, value, evidence={"why": "test"}) for pkg in (planner, jax_planner)]
    assert got[0].as_dict() == got[1].as_dict() and got[0].source == "autopilot"
    assert planner.planned_value(name) == jax_planner.planned_value(name) == value
    back = [pkg.apply_online_decision(name, d.fallback) for pkg, d in zip((planner, jax_planner), got)]
    assert back[0].as_dict() == back[1].as_dict()
    assert planner.planned_value(name) == planner.default_for(name)
    assert planner.plan_block() == jax_planner.plan_block()
    assert planner.plan_block(overrides={name: value}) == jax_planner.plan_block(overrides={name: value})
    knob = planner.KNOB_FOR.get(name)
    if knob is not None:  # an explicit knob pins the quantity and refuses online moves
        monkeypatch.setenv(knob, str(value * 2))
        assert planner.planned_value(name) == jax_planner.planned_value(name) == value * 2
        assert planner.apply_online_decision(name, value) is None
        assert jax_planner.apply_online_decision(name, value) is None
    for pkg in (planner, jax_planner):
        with pkg.plan_suppressed():
            assert pkg.plan_block() == pkg.inactive_block()


def test_unknown_and_unplanned_quantities_raise():
    for name in ("prefetch_depth", "sparse_layout", "no_such_quantity"):
        with pytest.raises(KeyError):
            planner.planned_value(name)
    for name in ("tier_bf16_pressure", "tier_int8_pressure"):  # planned, with the reference's knobs
        assert planner.KNOB_FOR[name] == jax_planner.KNOB_FOR[name]
        assert planner.planned_value(name) == jax_planner.planned_value(name)


def _write(path, profile):
    with open(path, "w") as f:
        json.dump(profile, f)
    return str(path)


@pytest.mark.parametrize("gate", ["plan_off", "env_profile_missing", "cli_profile_missing",
                                  "topology_mismatch", "env_profile", "calibration"])
def test_ensure_ambient_plan_gates_are_the_references(gate, tmp_path, monkeypatch):
    serve = dict(dispatch={"max_batch": 256, "max_wait_ms": 2.0}, serving={"p50_ms": 3.0, "batch_size_p95": 20})
    ours = _write(tmp_path / "port.json", _profile("serve", telemetry.device_topology(None), **serve))
    theirs = _write(tmp_path / "jax.json", _profile("serve", jax_telemetry.device_topology(), **serve))
    if gate == "plan_off":
        monkeypatch.setenv("PHOTON_PLAN", "0")
        assert planner.ensure_ambient_plan(ours) is None and jax_planner.ensure_ambient_plan(theirs) is None
    elif gate == "env_profile_missing":
        monkeypatch.setenv("PHOTON_PLAN_PROFILE", str(tmp_path / "later.json"))
        assert planner.ensure_ambient_plan() is None and jax_planner.ensure_ambient_plan() is None
    elif gate == "cli_profile_missing":
        for pkg in (planner, jax_planner):
            with pytest.raises(FileNotFoundError):
                pkg.ensure_ambient_plan(str(tmp_path / "absent.json"))
    elif gate == "topology_mismatch":
        # Each package refuses the other's profile: the port's runs on one CPU
        # device, the JAX tests' on an 8-device CPU mesh; and the port refuses
        # a profile of the card on the CPU.
        for pkg, path in ((planner, theirs), (jax_planner, ours)):
            with pytest.raises(pkg.PlanTopologyError, match="profile topology mismatch on 'device_count'"):
                pkg.ensure_ambient_plan(path)
        card = dict(telemetry.device_topology(None), platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
        with pytest.raises(planner.PlanTopologyError, match="on 'platform'"):
            planner.ensure_ambient_plan(_write(tmp_path / "card.json", _profile("serve", card, **serve)))
        assert planner.current_plan() is None
    elif gate == "env_profile":
        monkeypatch.setenv("PHOTON_PLAN_PROFILE", ours)
        plan = planner.ensure_ambient_plan()
        monkeypatch.setenv("PHOTON_PLAN_PROFILE", theirs)
        ref = jax_planner.ensure_ambient_plan()
        assert plan.profile_path == ours and planner.current_plan() is plan
        assert {k: d.as_dict() for k, d in plan.decisions.items()} == \
            {k: ref.decisions[k].as_dict() for k in plan.decisions}
        assert planner.planned_value("serving_max_batch") == 32
        assert planner.planned_value("serving_max_wait_ms") == 1.5
    else:
        monkeypatch.setenv("PHOTON_PLAN", "1")
        probe = planner.calibration_probe()
        assert probe["platform"] == "cpu" and probe["upload_gb_per_s"] > 0 and probe["dispatch_rtt_ms"] >= 0
        plan = planner.ensure_ambient_plan()
        ref = jax_planner.ensure_ambient_plan()
        assert plan.source == ref.source == "calibration"
        d, r = plan.decisions["ingest_chunk_rows"], ref.decisions["ingest_chunk_rows"]
        assert (d.value, d.source, d.fallback) == (r.value, r.source, r.fallback)
        assert set(d.evidence) == set(r.evidence) == {"host_parallelism"}


def test_owned_plan_uninstalls_what_it_installed_and_keeps_a_callers(tmp_path):
    path = _write(tmp_path / "p.json", _profile(
        "serve", telemetry.device_topology(None), dispatch={"max_batch": 256}, serving={"batch_size_p95": 3}))
    with pytest.raises(RuntimeError):
        with planner.owned_plan(path) as plan:
            assert plan is not None and planner.current_plan() is plan
            raise RuntimeError("any exit path")
    assert planner.current_plan() is None
    mine = planner.install_plan(planner.plan_from_profile(telemetry.read_profile(path), path))
    with planner.owned_plan(str(tmp_path / "ignored.json")) as plan:
        assert plan is mine
    assert planner.current_plan() is mine


def test_the_consulting_sites_default_with_no_plan_and_follow_a_plan():
    assert planner.planned_value("serving_max_batch") == 256
    assert planner.planned_value("serving_max_wait_ms") == 2.0
    assert planner.DEFAULTS == {k: jax_planner.DEFAULTS[k] for k in planner.DEFAULTS}
    for name in planner.KNOB_FOR:
        assert planner.KNOB_FOR[name] == jax_planner.KNOB_FOR[name]
        assert planner.default_for(name) == jax_planner.default_for(name)
    from photon_ml_tpu_torch.serving import ServingEngine, TenantRegistry

    from tests.test_torch_tenancy import _bundle

    plan = planner.plan_from_profile(_profile(
        "serve", telemetry.device_topology(None), dispatch={"max_batch": 256, "max_wait_ms": 2.0},
        serving={"p50_ms": 1.2, "batch_size_p95": 5}))
    assert plan.decisions["serving_max_batch"].value == 8
    assert plan.decisions["serving_max_wait_ms"].value == 0.6
    planner.install_plan(plan)
    with ServingEngine(_bundle(0)) as eng, eng.batcher() as b:
        assert eng.max_batch == 8 and eng.buckets == (1, 2, 4, 8) and b.max_wait_s == 0.6e-3
    with TenantRegistry() as reg:
        assert reg.max_batch == 8 and reg.max_wait_s == 0.6e-3
        assert reg.retune(max_wait_ms=0.3) == {"max_wait_ms": 0.6} and reg.max_wait_s == 0.3e-3


def test_a_planned_python_ingest_reads_the_same_rows(tmp_path, monkeypatch):
    """The Python Avro route's chunk is a planned quantity; chunk boundaries
    change nothing."""
    from photon_ml_tpu_torch.cli.config import parse_feature_shard_config
    from photon_ml_tpu_torch.io import avro_data, avro_fast

    from tests.test_torch_train_telemetry import write_glmix_files

    data = write_glmix_files(tmp_path, n_train=300, n_val=10)
    shards = dict([parse_feature_shard_config("name=g,feature.bags=features,intercept=true")])
    monkeypatch.setattr(avro_fast, "compile_native", lambda *a, **k: None)  # the Python route
    reads = {}
    for rows in (None, 64):
        if rows is not None:
            planner.apply_online_decision("ingest_chunk_rows", rows)
        reads[rows], _ = avro_data.read_game_dataset(str(data / "train.avro"), shards,
                                                     id_tag_fields=["userId"], device="cpu")
    assert reads[None].ingest_timing["ingest_path"] == reads[64].ingest_timing["ingest_path"] == "python"
    assert reads[64].ingest_timing["chunks"] == 5 and reads[None].ingest_timing["chunks"] == 1
    assert torch.equal(reads[64].labels, reads[None].labels)
    assert torch.equal(reads[64].shards["g"].indices, reads[None].shards["g"].indices)
    assert torch.equal(reads[64].shards["g"].values, reads[None].shards["g"].values)
