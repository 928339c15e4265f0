"""Hyperparameter tuner facade + factory.

The port's copy of `photon_ml_tpu/hyperparameter/tuner.py`: `search` runs
the reference's loop of one evaluation a trial, and `sweep` drives the
batched trial executor (hyperparameter/sweep.py). Counterpart of photon-api
hyperparameter/tuner/ (HyperparameterTuner.scala:25,
HyperparameterTunerFactory.scala:19-34, DummyTuner.scala, AtlasTuner.scala:
28-56) and the HyperparameterTuningMode enum. The reference decouples the OSS
build from LinkedIn's internal tuner by reflectively loading a class; here the
factory simply returns the in-repo searcher for RANDOM/BAYESIAN and a no-op
for NONE.
"""

from __future__ import annotations

import enum
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch.hyperparameter.search import (
    BatchEvaluationFunction,
    GaussianProcessSearch,
    HyperparameterConfig,
    RandomSearch,
    SearchResult,
)


class HyperparameterTuningMode(enum.Enum):
    """Reference: HyperparameterTuningMode.scala (NONE/RANDOM/BAYESIAN)."""

    NONE = "NONE"
    RANDOM = "RANDOM"
    BAYESIAN = "BAYESIAN"

    @classmethod
    def parse(cls, name: str) -> "HyperparameterTuningMode":
        return cls[name.strip().upper()]


class HyperparameterTuner:
    """search(n, configs, evaluation_function, priors) -> SearchResult
    (HyperparameterTuner.scala:25, AtlasTuner.search:31-56)."""

    def search(
        self,
        n: int,
        configs: Sequence[HyperparameterConfig],
        mode: HyperparameterTuningMode,
        evaluation_function: Callable[[np.ndarray], float],
        *,
        maximize: bool = False,
        priors: Optional[Sequence[Tuple[np.ndarray, float]]] = None,
        seed: int = 1,
        batch_size: int = 1,
        batch_evaluation_function: Optional[BatchEvaluationFunction] = None,
    ) -> Optional[SearchResult]:
        """`batch_size` > 1 runs trials in parallel rounds (constant-liar qEI
        for BAYESIAN, plain Sobol batches for RANDOM) over the reference's
        inherently serial search loop. See
        RandomSearch.find_batched."""
        if mode == HyperparameterTuningMode.NONE or n <= 0:
            return None
        cls = (
            GaussianProcessSearch
            if mode == HyperparameterTuningMode.BAYESIAN
            else RandomSearch
        )
        searcher = cls(configs, evaluation_function, maximize=maximize, seed=seed)
        if priors:
            searcher.seed_priors(priors)
        if batch_size > 1 or batch_evaluation_function is not None:
            return searcher.find_batched(n, batch_size, batch_evaluation_function)
        return searcher.find(n)

    def sweep(
        self,
        n: int,
        configs: Sequence[HyperparameterConfig],
        mode: HyperparameterTuningMode,
        executor,
        *,
        priors: Optional[Sequence[Tuple[np.ndarray, float]]] = None,
        seed: int = 1,
        batch_size: int = 4,
    ):
        """A batched sweep through a `hyperparameter.sweep.SweepExecutor`:
        each proposal round's (k, dim) candidate matrix is one
        `executor.evaluate_batch` (stacked, shard-group or serial trials),
        then `finalize()` refits the winner cold, so the returned model is
        bit-equal to a standalone fit of the winning configuration.

        Returns (SearchResult, SweepResult), or None for NONE or n <= 0.
        Build the executor with `GameEstimator.sweep_executor`."""
        if mode == HyperparameterTuningMode.NONE or n <= 0:
            return None
        cls = (
            GaussianProcessSearch
            if mode == HyperparameterTuningMode.BAYESIAN
            else RandomSearch
        )
        searcher = cls(configs, executor.evaluate_point, maximize=executor.maximize, seed=seed)
        if priors:
            searcher.seed_priors(priors)
        search_result = searcher.find_batched(n, batch_size, executor.evaluate_batch)
        return search_result, executor.finalize()


def get_tuner(mode: HyperparameterTuningMode) -> HyperparameterTuner:
    """HyperparameterTunerFactory: every supported mode maps to the in-repo
    tuner (the reference's ATLAS indirection collapses here)."""
    return HyperparameterTuner()
