"""Down-sampling as weight masking.

Port of `photon_ml_tpu/data/sampling.py`: a down-sampled solve keeps every
row and multiplies its weight by keep/rate, keep ~ Bernoulli(rate), so
dropped rows weigh 0 in every reduction and kept ones are rescaled (the
objective stays an unbiased estimate). Logistic and smoothed-hinge tasks
keep every positive (the binary-classification sampler). The draws come
from an explicit `torch.Generator`; they are not the reference's
jax.random bits, so a down-sampled fit matches it in distribution, not bit
for bit (the formula given one keep mask is `keep_weights`).
"""

from __future__ import annotations

import dataclasses

import torch

from photon_ml_tpu_torch.data.containers import LabeledData
from photon_ml_tpu_torch.types import TaskType

Tensor = torch.Tensor


def keep_weights(keep: Tensor, labels: Tensor, weights: Tensor, rate: float, *,
                 negatives_only: bool) -> Tensor:
    """The weights of a down-sampled solve given its keep mask."""
    rescaled = torch.where(keep, weights / rate, torch.zeros_like(weights))
    if negatives_only:
        return torch.where(labels > 0.5, weights, rescaled)
    return rescaled


def down_sample_weights(generator: torch.Generator, labels: Tensor, weights: Tensor, rate: float, *,
                        negatives_only: bool) -> Tensor:
    """New weights with rows dropped at probability 1 - rate (the generator
    lives on the labels' device)."""
    keep = torch.rand(labels.shape, generator=generator, device=labels.device) < rate
    return keep_weights(keep, labels, weights, rate, negatives_only=negatives_only)


def down_sampler_for_task(task: TaskType) -> bool:
    """Whether the task keeps every positive (negatives_only)."""
    return task in (TaskType.LOGISTIC_REGRESSION, TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM)


def down_sample(generator: torch.Generator, data: LabeledData, rate: float, task: TaskType) -> LabeledData:
    new_w = down_sample_weights(generator, data.labels, data.weights, rate,
                                negatives_only=down_sampler_for_task(task))
    return dataclasses.replace(data, weights=new_w)
