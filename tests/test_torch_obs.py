"""`python -m photon_ml_tpu_torch.cli.obs` against the JAX package's
`cli.obs`, on the CPU: the same standard output and exit code for `trace`
(with `--min-coverage`), `journal --validate`, `profile` and `profile diff`
on files either package's `cli.train` wrote, and on broken ones (a journal
with a bad line, a profile without a section, two profiles of other kinds),
and for `decisions` on the journals (tests/test_torch_autopilot.py runs it
on planned and autopilot journals)."""

from __future__ import annotations

import json

import pytest

from photon_ml_tpu.cli import obs as jax_obs
from photon_ml_tpu_torch.cli import obs
from photon_ml_tpu_torch.utils import telemetry
from test_torch_train_telemetry import run_both, write_glmix_files


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("obs")
    outs = run_both(root, write_glmix_files(root), traced=True)
    broken = root / "broken"
    broken.mkdir()
    journal = (outs["port"] / "journal.jsonl").read_text()
    (broken / "journal.jsonl").write_text(journal + '{"ts": 1.0, "type": "nope"}\nnot json\n'
                                          + '{"type": "fit_start", "num_samples": 3}\n')
    profile = json.loads((outs["port"] / "profile.json").read_text())
    del profile["dispatch"]
    (broken / "profile.json").write_text(json.dumps(profile))
    serve = telemetry.build_profile("serve", wall_s=1.0, stages={"replay_s": 1.0}, dispatch={},
                                    bucket_shapes={}, serving={"completed": 1},
                                    topology=telemetry.device_topology("cpu"))
    telemetry.write_profile(str(broken / "serve.json"), serve)
    return {"port": outs["port"], "jax": outs["jax"], "broken": broken}


# (arguments, whether the command exits nonzero)
CASES = [
    (("trace", "port/trace.json", "--min-coverage", "90"), False),
    (("trace", "jax/trace.json", "--min-coverage", "90"), False),
    (("trace", "port/trace.json", "--min-coverage", "100.5"), True),
    (("trace", "port/trace.json"), False),
    (("journal", "port/journal.jsonl", "--validate"), False),
    (("journal", "jax/journal.jsonl", "--validate"), False),
    (("journal", "broken/journal.jsonl", "--validate"), True),
    (("journal", "broken/journal.jsonl"), False),
    (("profile", "port/profile.json"), False),
    (("profile", "jax/profile.json"), False),
    (("profile", "diff", "port/profile.json", "jax/profile.json"), False),
    (("profile", "diff", "jax/profile.json", "port/profile.json"), False),
    (("profile", "diff", "port/profile.json", "port/profile.json"), False),
    (("profile", "diff", "port/profile.json", "broken/profile.json"), True),
    (("profile", "diff", "port/profile.json", "broken/serve.json"), True),
    (("decisions", "port/journal.jsonl"), False),
    (("decisions", "jax/journal.jsonl"), False),
    (("decisions", "broken/journal.jsonl"), True),
]


@pytest.mark.parametrize("case,fails", CASES, ids=[" ".join(c) for c, _ in CASES])
def test_obs_prints_what_the_jax_obs_prints(files, capsys, case, fails):
    argv = [str(files[a.split("/")[0]] / a.split("/")[1]) if "/" in a else a for a in case]
    ours = obs.main(argv), capsys.readouterr().out
    theirs = jax_obs.main(argv), capsys.readouterr().out
    assert ours == theirs
    assert (ours[0] != 0) == fails, ours


def test_a_broken_profile_raises_in_both(files):
    path = str(files["broken"] / "profile.json")
    for main in (obs.main, jax_obs.main):
        with pytest.raises(ValueError, match="dispatch"):
            main(["profile", path])

