"""Hyperparameter auto-tuning: Sobol random and GP/EI Bayesian search.

The port of `photon_ml_tpu/hyperparameter/`. The GP runs on the CPU in
float64 (gp.py); the trials it proposes are fits on the card, one at a time
(`HyperparameterTuner.search`) or as batched rounds through the trial
executor (sweep.py, `HyperparameterTuner.sweep`).
"""

from photon_ml_tpu_torch.hyperparameter.gp import GaussianProcessModel, fit_gp
from photon_ml_tpu_torch.hyperparameter.search import (
    GaussianProcessSearch,
    HyperparameterConfig,
    Observation,
    RandomSearch,
    SearchResult,
    backward_scale,
    config_from_json,
    forward_scale,
    priors_from_json,
    shrink_search_range,
)
from photon_ml_tpu_torch.hyperparameter.sweep import (
    SweepExecutor,
    SweepResult,
    TrialRecord,
)
from photon_ml_tpu_torch.hyperparameter.tuner import (
    HyperparameterTuner,
    HyperparameterTuningMode,
    get_tuner,
)
