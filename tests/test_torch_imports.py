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
                 "utils.date_range", "utils.observability"):
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


@pytest.mark.parametrize("driver", ["train", "score", "libsvm_to_avro"])
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
    if driver != "libsvm_to_avro":
        assert "--device" in proc.stdout
