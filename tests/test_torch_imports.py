"""The port stands alone: every module of `photon_ml_tpu_torch` imports in a
fresh interpreter where `jax` and the JAX package cannot be imported; and
its entry points never pick the CPU by themselves."""

from __future__ import annotations

import os
import pkgutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import photon_ml_tpu_torch
from photon_ml_tpu_torch import resolve_device
from photon_ml_tpu_torch.data.game_dataset import GameDataset

REPO = Path(__file__).resolve().parent.parent


# Prepended to a script run in a fresh interpreter: importing jax, jaxlib or
# the JAX package raises there.
_BLOCK_JAX = textwrap.dedent(
    """
    import importlib, importlib.abc, runpy, sys

    BLOCKED = ("jax", "jaxlib", "photon_ml_tpu")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".") for b in BLOCKED):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    """
)


def _port_modules():
    return sorted(
        m.name
        for m in pkgutil.walk_packages(photon_ml_tpu_torch.__path__, "photon_ml_tpu_torch.")
    )


def test_every_port_module_imports_with_jax_blocked():
    modules = _port_modules()
    for name in ("ops.glm_kernels", "game.coordinate_descent", "ops.cuda_build", "ops.sparse_kernels",
                 "data.sparse_layout", "parallel.mesh", "parallel.launch", "io.avro", "io.avro_data",
                 "io.avro_fast", "io.schemas", "data.index_map", "native.build", "native.avro_reader",
                 "native.avro_writer", "timing", "data.stats", "data.sampling", "data.device_assemble",
                 "game.projector", "estimators.game_estimator", "evaluation.suite",
                 "io.model_store", "io.model_bridge", "io.score_store", "cli.config", "cli.train",
                 "cli.score", "cli.libsvm_to_avro", "data.libsvm", "data.validators",
                 "utils.date_range", "utils.observability", "optimize.constraints",
                 "game.checkpoint", "native.libsvm_parser", "models.glm", "models.training",
                 "evaluation.legacy", "cli.glm_driver", "native.index_store", "io.paldb",
                 "cli.build_index", "cli.name_and_term", "hyperparameter", "hyperparameter.kernels",
                 "hyperparameter.gp", "hyperparameter.slice_sampler", "hyperparameter.search",
                 "hyperparameter.tuner", "utils.knobs", "utils.faults", "utils.watchdog",
                 "utils.telemetry", "serving", "serving.bundle", "serving.engine", "serving.batcher",
                 "serving.lifecycle", "cli.serve", "hyperparameter.sweep", "cli.tune",
                 "parallel.hostmesh", "cli.train_multihost", "cli.serve_multihost", "cli.obs",
                 "data.fingerprints", "game.incremental", "serving.delta", "cli.refresh",
                 "serving.tenancy", "serving.shadow", "serving.reshard", "planner", "planner.plan",
                 "planner.rules", "autopilot.sensors", "autopilot.rules", "autopilot.loop",
                 "analysis", "analysis.core", "analysis.__main__", "analysis.knob_registry",
                 "analysis.fault_site_sync", "analysis.jit_purity", "analysis.thread_lifecycle",
                 "analysis.donation_aliasing", "analysis.contract_key_drift",
                 "analysis.metric_name_sync", "analysis.planner_constant", "analysis.tolerance_pin"):
        assert f"photon_ml_tpu_torch.{name}" in modules
    script = _BLOCK_JAX + textwrap.dedent(
        """
        for name in sys.argv[1:]:
            importlib.import_module(name)
        leaked = [m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
        assert not leaked, leaked
        print("imported", len(sys.argv) - 1)
        """
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", script, *modules], capture_output=True, text=True,
        cwd=str(REPO), env=env, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert f"imported {len(modules)}" in proc.stdout


def test_the_port_lint_runs_with_jax_blocked():
    """photon-lint over the port runs, not just imports, where jax and the
    JAX package cannot be imported: a bad fixture gives findings (exit 1)
    and a good one none (exit 0)."""
    script = _BLOCK_JAX + textwrap.dedent(
        """
        from photon_ml_tpu_torch.analysis.__main__ import main
        fixtures = sys.argv[1]
        assert main([fixtures + "/donation_aliasing/bad"]) == 1
        assert main([fixtures + "/jit_purity/good"]) == 0
        print("linted")
        """
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", script, str(REPO / "tests" / "torch_lint" / "analysis_fixtures")],
                          capture_output=True, text=True, cwd=str(REPO), env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "linted" in proc.stdout


def test_the_legacy_driver_and_a_checkpointed_fit_run_with_jax_blocked(tmp_path):
    """The new paths run, not just import, where jax cannot be imported: the
    LibSVM reader through the native parser, the legacy driver with an
    elastic-net sweep, and a coordinate descent that checkpoints and
    resumes."""
    (tmp_path / "train.libsvm").write_text("".join(
        f"{1 if i % 3 else -1} {1 + i % 5}:1 {6 + i % 4}:0.5\n" for i in range(60)))
    script = _BLOCK_JAX + textwrap.dedent(
        """
        import torch
        from photon_ml_tpu_torch.cli import glm_driver
        from photon_ml_tpu_torch.data.game_dataset import (
            GameDataset, RandomEffectDataConfig, build_random_effect_dataset)
        from photon_ml_tpu_torch.game.coordinate import FixedEffectCoordinate, RandomEffectCoordinate
        from photon_ml_tpu_torch.game.coordinate_descent import run_coordinate_descent
        from photon_ml_tpu_torch.optimize.config import L2, CoordinateOptimizationConfig
        from photon_ml_tpu_torch.types import TaskType

        root = sys.argv[1]
        s = glm_driver.main(["--training-data-directory", root + "/train.libsvm", "--format", "LIBSVM",
                             "--output-directory", root + "/out", "--regularization-type", "ELASTIC_NET",
                             "--elastic-net-alpha", "0.5", "--device", "cpu", "--logging-level", "ERROR"])
        assert s["stages"] == ["INIT", "PREPROCESSED", "TRAINED"], s
        g = torch.Generator().manual_seed(0)
        ds = GameDataset.build({"x": torch.randn(64, 3, generator=g)}, (torch.rand(64, generator=g) > 0.5).float(),
                               id_tags={"u": torch.arange(64) % 4}, device="cpu")
        cfg = CoordinateOptimizationConfig(regularization=L2, reg_weight=1.0)
        red = build_random_effect_dataset(ds, RandomEffectDataConfig("u", "x", min_bucket=4))
        coords = lambda: {"f": FixedEffectCoordinate(ds, "x", cfg, TaskType.LOGISTIC_REGRESSION),
                          "r": RandomEffectCoordinate(ds, red, cfg, TaskType.LOGISTIC_REGRESSION)}
        run_coordinate_descent(coords(), 1, checkpoint_dir=root + "/ck")
        resumed = run_coordinate_descent(coords(), 2, checkpoint_dir=root + "/ck")
        straight = run_coordinate_descent(coords(), 2)
        assert torch.allclose(resumed.model["f"].coefficients.means, straight.model["f"].coefficients.means,
                              rtol=1e-6, atol=1e-7)
        print("ran")
        """
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", script, str(tmp_path)], capture_output=True, text=True,
                          cwd=str(REPO), env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "ran" in proc.stdout


def test_the_index_store_and_tuning_run_with_jax_blocked(tmp_path):
    """cli.name_and_term, cli.build_index (PHIDX and PalDB), and cli.train
    through each store with RANDOM then BAYESIAN tuning, where jax cannot be
    imported."""
    script = _BLOCK_JAX + textwrap.dedent(
        """
        import numpy as np
        from photon_ml_tpu_torch.cli import build_index, name_and_term, train
        from photon_ml_tpu_torch.io.avro_data import write_training_examples

        root = sys.argv[1]
        rng = np.random.default_rng(0)
        x = rng.normal(size=(300, 3))
        y = (rng.uniform(size=300) < 1 / (1 + np.exp(-x @ [1.0, -1.0, 0.5]))).astype(float)
        rows = [[(f"f{j}", float(x[i, j])) for j in range(3)] for i in range(300)]
        write_training_examples(root + "/train.avro", rows[:200], y[:200].tolist())
        write_training_examples(root + "/val.avro", rows[200:], y[200:].tolist())
        shard = "name=s,feature.bags=features,intercept=true"
        name_and_term.main(["--input-data-directories", root + "/train.avro", "--feature-bags-keys",
                            "features", "--output-dir", root + "/nat"])
        for fmt, mode in (("phidx", "RANDOM"), ("paldb", "BAYESIAN")):
            build_index.main(["--name-and-term-directory", root + "/nat", "--feature-shard-configurations",
                              shard, "--num-partitions", "2", "--output-dir", root + "/" + fmt,
                              "--output-format", fmt])
            s = train.main(["--training-task", "LOGISTIC_REGRESSION", "--input-data-directories",
                            root + "/train.avro", "--validation-data-directories", root + "/val.avro",
                            "--root-output-directory", root + "/out-" + fmt, "--feature-shard-configurations",
                            shard, "--coordinate-configurations",
                            "name=g,feature.shard=s,regularization=L2,reg.weights=1",
                            "--validation-evaluators", "AUC", "--offheap-indexmap-dir", root + "/" + fmt,
                            "--hyper-parameter-tuning", mode, "--hyper-parameter-tuning-iter", "3",
                            "--device", "cpu", "--logging-level", "ERROR"])
            assert s["num_tuned"] == 3 and s["best_evaluation"]["AUC"] > 0.6, s
        print("ran")
        """
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", script, str(tmp_path)], capture_output=True, text=True,
                          cwd=str(REPO), env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "ran" in proc.stdout


def test_a_sweep_runs_with_jax_blocked(tmp_path):
    """cli.tune (stacked RANDOM rounds, the cold refit, the saved winner and
    its journal) where jax cannot be imported."""
    script = _BLOCK_JAX + textwrap.dedent(
        """
        import numpy as np
        from photon_ml_tpu_torch.cli import tune
        from photon_ml_tpu_torch.io.avro_data import write_training_examples
        from photon_ml_tpu_torch.utils import telemetry

        root = sys.argv[1]
        rng = np.random.default_rng(0)
        x = rng.normal(size=(300, 3))
        y = (rng.uniform(size=300) < 1 / (1 + np.exp(-x @ [1.0, -1.0, 0.5]))).astype(float)
        rows = [[(f"f{j}", float(x[i, j])) for j in range(3)] for i in range(300)]
        write_training_examples(root + "/train.avro", rows[:200], y[:200].tolist())
        write_training_examples(root + "/val.avro", rows[200:], y[200:].tolist())
        s = tune.main(["--training-task", "LOGISTIC_REGRESSION", "--input-data-directories",
                       root + "/train.avro", "--validation-data-directories", root + "/val.avro",
                       "--root-output-directory", root + "/out", "--feature-shard-configurations",
                       "name=s,feature.bags=features,intercept=true", "--coordinate-configurations",
                       "name=g,feature.shard=s,regularization=L2,reg.weights=1",
                       "--tuning-mode", "RANDOM", "--tuning-iter", "4", "--tuning-batch-size", "2",
                       "--device", "cpu",
                       "--logging-level", "ERROR"])
        assert s["modes"] == ["stacked"] and len(s["trials"]) == 4 and s["rounds"] == 2, s
        assert telemetry.validate_journal(root + "/out/journal.jsonl")[1] == []
        print("ran")
        """
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", script, str(tmp_path)], capture_output=True, text=True,
                          cwd=str(REPO), env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "ran" in proc.stdout


def test_port_sources_never_name_the_jax_package():
    for path in (REPO / "photon_ml_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            stripped = line.strip()
            if stripped.startswith(("import ", "from ")):
                assert "jax" not in stripped, f"{path}: {stripped}"
                assert "photon_ml_tpu." not in stripped and not stripped.startswith(
                    ("import photon_ml_tpu ", "from photon_ml_tpu ")
                ), f"{path}: {stripped}"


def test_cuda_is_the_default_and_is_never_swapped_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        GameDataset.build({"x": torch.zeros(4, 2)}, torch.zeros(4))
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


@pytest.mark.parametrize("driver", ["train", "score", "libsvm_to_avro", "glm_driver", "build_index",
                                    "name_and_term", "tune", "refresh"])
def test_each_driver_prints_its_help_with_jax_blocked(driver):
    script = _BLOCK_JAX + textwrap.dedent(
        """
        sys.argv = [sys.argv[1], "--help"]
        runpy.run_module(sys.argv[0], run_name="__main__")
        """
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", script, f"photon_ml_tpu_torch.cli.{driver}"], capture_output=True,
        text=True, cwd=str(REPO), env=env, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "usage:" in proc.stdout
    if driver not in ("libsvm_to_avro", "build_index", "name_and_term"):  # the host-only drivers
        assert "--device" in proc.stdout
