"""The legacy single-GLM driver's validation metrics.

Port of `photon_ml_tpu/evaluation/legacy.py` (photon-client
evaluation/Evaluation.scala:31-196): one scoring pass through the model's
mean function, then every metric that applies to the task — the regression
facet (MAE, MSE, RMSE, R^2) or the binary facet (AUPR, AUC, peak F1), the
per-datum log likelihood for logistic and Poisson models, and the
small-sample-corrected Akaike information criterion — under the
reference's metric names, verbatim.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from photon_ml_tpu_torch.data.containers import LabeledData
from photon_ml_tpu_torch.evaluation import metrics
from photon_ml_tpu_torch.models.glm import (
    BinaryClassifier,
    GeneralizedLinearModel,
    LogisticRegressionModel,
    PoissonRegressionModel,
)

# Metric names, verbatim from Evaluation.scala:34-42.
MEAN_ABSOLUTE_ERROR = "Mean absolute error"
MEAN_SQUARE_ERROR = "Mean square error"
ROOT_MEAN_SQUARE_ERROR = "Root mean square error"
R_SQUARED = "R-squared"
AREA_UNDER_PRECISION_RECALL = "Area under precision/recall"
AREA_UNDER_ROC = "Area under ROC"
PEAK_F1_SCORE = "Peak F1 score"
DATA_LOG_LIKELIHOOD = "Per-datum log likelihood"
AKAIKE_INFORMATION_CRITERION = "Akaike information criterion"

_COEFF_EPS = 1e-9  # effective-parameter threshold (Evaluation.scala:109)


def evaluate_glm(model: GeneralizedLinearModel, data: LabeledData) -> Dict[str, float]:
    """Score once with the mean function; every applicable metric."""
    means = model.compute_mean(data.features, data.offsets)
    labels, weights = data.labels, data.weights
    out: Dict[str, float] = {}
    if not isinstance(model, BinaryClassifier):
        wsum = torch.sum(weights)
        err = labels - means
        out[MEAN_ABSOLUTE_ERROR] = float(torch.sum(weights * err.abs()) / wsum)
        mse = float(torch.sum(weights * err * err) / wsum)
        out[MEAN_SQUARE_ERROR] = mse
        out[ROOT_MEAN_SQUARE_ERROR] = math.sqrt(mse)
        out[R_SQUARED] = float(metrics.r_squared(means, labels, weights))
    else:
        out[AREA_UNDER_PRECISION_RECALL] = float(metrics.area_under_pr_curve(means, labels, weights))
        out[AREA_UNDER_ROC] = float(metrics.area_under_roc_curve(means, labels, weights))
        out[PEAK_F1_SCORE] = float(metrics.peak_f1(means, labels, weights))

    log_lik = None
    if isinstance(model, LogisticRegressionModel):
        p = torch.clamp(means, 1e-12, 1.0 - 1e-12)
        log_lik = float(torch.mean(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p)))
    elif isinstance(model, PoissonRegressionModel):
        z = torch.log(torch.clamp_min(means, 1e-30))  # the margin, for the exp link
        log_lik = float(torch.mean(labels * z - means - torch.lgamma(labels + 1.0)))
    if log_lik is not None:
        out[DATA_LOG_LIKELIHOOD] = log_lik
        # AICc (Evaluation.scala:104-118); undefined (infinite) at n <= k + 1.
        n = int(labels.shape[0])
        k = int((model.coefficients.means.abs() > _COEFF_EPS).sum())
        base = 2.0 * (k - n * log_lik)
        denom = n - k - 1.0
        out[AKAIKE_INFORMATION_CRITERION] = base + (2.0 * k * (k + 1) / denom if denom > 0
                                                    else float("inf"))
    return out
