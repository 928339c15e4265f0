"""`python -m photon_ml_tpu_torch.cli.refresh` against the JAX package's
`cli.refresh`, on the CPU: `--synthetic --rounds 2 --seed 0` in both fits
the same rows (the port draws the reference's numpy stream in its order),
so the rounds' modes, delta manifests, `committed` flags and generations,
the delta records and the provenance block are the reference's; each
package's `cli.obs journal --validate` accepts both journals; the summary
keeps the reference's keys (an unplanned run's inactive `plan` block
among them) and adds each round's `stages_s`; a run without `--synthetic` is refused as the
reference words it, `--shadow-gate` or not (the gate itself runs in
tests/test_torch_shadow.py)."""

from __future__ import annotations

import json
import os

import pytest

from photon_ml_tpu.cli import obs as jax_obs
from photon_ml_tpu.cli import refresh as jax_refresh
from photon_ml_tpu.utils import telemetry as jax_telemetry
from photon_ml_tpu_torch.cli import obs, refresh
from photon_ml_tpu_torch.game.checkpoint import read_delta_records
from photon_ml_tpu_torch.utils import faults, telemetry

ARGS = ["--synthetic", "--rounds", "2", "--seed", "0", "--logging-level", "WARNING"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    faults.clear()
    telemetry.METRICS.reset()
    out = {}
    for name, main, extra in (("jax", jax_refresh.main, []), ("port", refresh.main, ["--device", "cpu"])):
        root = str(tmp_path_factory.mktemp(f"refresh-{name}"))
        main(["--root-output-directory", root, *ARGS, *extra])
        with open(os.path.join(root, "refresh-summary.json")) as f:
            out[name] = dict(root=root, summary=json.load(f))
    faults.clear()
    telemetry.METRICS.reset()
    return out


def test_the_rounds_are_the_reference_rounds(runs):
    port, ref = runs["port"]["summary"], runs["jax"]["summary"]
    assert len(port["rounds"]) == len(ref["rounds"]) == 2
    assert [r["mode"] for r in port["rounds"]] == ["full", "delta"]
    for got, want in zip(port["rounds"], ref["rounds"]):
        # Every field of the reference's but the measured floats (seconds,
        # max_rel_diff): the round, mode, manifest, committed and generation.
        assert {k: got[k] for k, v in want.items() if not isinstance(v, float)} == \
            {k: v for k, v in want.items() if not isinstance(v, float)}
    assert set(ref) - set(port) == set() and port["plan"] == ref["plan"] == {
        "active": False, "source": "off", "profile": None, "decisions": []}
    assert set(port) - set(ref) == {"device"} and port["device"] == "cpu"
    assert port["bundle_deltas"] == ref["bundle_deltas"] == 2
    skip = {"last_delta_ts"}
    assert {k: v for k, v in port["provenance"].items() if k not in skip} == \
        {k: v for k, v in ref["provenance"].items() if k not in skip}
    for r in port["rounds"]:
        stages = r["stages_s"]
        assert set(stages["solve"]) == {"fixed", "per-entity"}
        assert set(stages["apply"]) == {"upload", "prewarm", "flip"}
        assert all(v >= 0.0 for v in stages["apply"].values())
        assert stages["merge"] >= 0.0 and stages["fingerprint_hash"] >= 0.0


def test_the_delta_records_are_the_reference_records(runs):
    port = read_delta_records(os.path.join(runs["port"]["root"], "checkpoints"))
    ref = read_delta_records(os.path.join(runs["jax"]["root"], "checkpoints"))
    assert len(port) == len(ref) == 2
    for got, want in zip(port, ref):
        assert got.keys() == want.keys()
        assert {k: v for k, v in got.items() if not isinstance(v, float)} == \
            {k: v for k, v in want.items() if not isinstance(v, float)}


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_both_obs_readers_accept_both_journals(runs, reader, capsys):
    main = obs.main if reader == "port" else jax_obs.main
    types = []
    for name in ("port", "jax"):
        path = os.path.join(runs[name]["root"], "journal.jsonl")
        assert main(["journal", path, "--validate"]) == 0
        assert telemetry.validate_journal(path)[1] == jax_telemetry.validate_journal(path)[1] == []
        with open(path) as f:
            types.append([json.loads(line)["type"] for line in f])
    capsys.readouterr()
    assert types[0] == types[1]
    assert types[0].count("delta_apply") == types[0].count("reshard_commit") == 2


def test_the_shadow_gate_and_real_data_are_refused(tmp_path):
    # The shadow gate is ported; on real data it is refused with the run,
    # in both packages, before any fit or file.
    for main in (refresh.main, jax_refresh.main):
        with pytest.raises(SystemExit, match="only --synthetic data is supported"):
            main(["--root-output-directory", str(tmp_path), "--shadow-gate", "--logging-level",
                  "WARNING"])
    assert not os.listdir(tmp_path)
    with pytest.raises(SystemExit, match="only --synthetic data is supported"):
        refresh.main(["--root-output-directory", str(tmp_path), "--device", "cpu"])
    with pytest.raises(SystemExit, match="only --synthetic data is supported"):
        jax_refresh.main(["--root-output-directory", str(tmp_path)])
