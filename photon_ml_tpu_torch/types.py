"""Shared enums of the PyTorch port.

The port's own copy of the JAX package's `types.py` enums (that package is
the reference and is never imported here). Values and parsing match it, so
configurations written for one package read the same in the other.
"""

from __future__ import annotations

import enum


class TaskType(enum.Enum):
    """Training objective family."""

    LINEAR_REGRESSION = "LINEAR_REGRESSION"
    POISSON_REGRESSION = "POISSON_REGRESSION"
    LOGISTIC_REGRESSION = "LOGISTIC_REGRESSION"
    SMOOTHED_HINGE_LOSS_LINEAR_SVM = "SMOOTHED_HINGE_LOSS_LINEAR_SVM"

    @classmethod
    def parse(cls, name: str) -> "TaskType":
        return cls[name.strip().upper()]


class OptimizerType(enum.Enum):
    LBFGS = "LBFGS"
    OWLQN = "OWLQN"
    LBFGSB = "LBFGSB"
    TRON = "TRON"

    @classmethod
    def parse(cls, name: str) -> "OptimizerType":
        return cls[name.strip().upper()]


class RegularizationType(enum.Enum):
    NONE = "NONE"
    L1 = "L1"
    L2 = "L2"
    ELASTIC_NET = "ELASTIC_NET"

    @classmethod
    def parse(cls, name: str) -> "RegularizationType":
        return cls[name.strip().upper()]


class NormalizationType(enum.Enum):
    NONE = "NONE"
    SCALE_WITH_STANDARD_DEVIATION = "SCALE_WITH_STANDARD_DEVIATION"
    SCALE_WITH_MAX_MAGNITUDE = "SCALE_WITH_MAX_MAGNITUDE"
    STANDARDIZATION = "STANDARDIZATION"

    @classmethod
    def parse(cls, name: str) -> "NormalizationType":
        return cls[name.strip().upper()]


class VarianceComputationType(enum.Enum):
    NONE = "NONE"
    SIMPLE = "SIMPLE"
    FULL = "FULL"

    @classmethod
    def parse(cls, name: str) -> "VarianceComputationType":
        return cls[name.strip().upper()]


class DataValidationType(enum.Enum):
    """How much of a dataset the drivers' row checks examine
    (data/validators.py)."""

    VALIDATE_FULL = "VALIDATE_FULL"
    VALIDATE_SAMPLE = "VALIDATE_SAMPLE"
    VALIDATE_DISABLED = "VALIDATE_DISABLED"


class ProjectorType(enum.Enum):
    """A random effect's feature-space projection (game/projector.py)."""

    INDEX_MAP = "INDEX_MAP"
    RANDOM = "RANDOM"
    IDENTITY = "IDENTITY"
