"""Optimization configuration (the port's own copy of
`photon_ml_tpu/optimize/config.py`): plain frozen dataclasses describing
which optimizer to run, how long, and how it is regularized."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from photon_ml_tpu_torch.types import (
    OptimizerType,
    RegularizationType,
    VarianceComputationType,
)


@dataclasses.dataclass(frozen=True)
class RegularizationContext:
    """Splits a total regularization weight into L1/L2 parts; ELASTIC_NET
    with mixing alpha gives L1 = alpha w and L2 = (1 - alpha) w."""

    reg_type: RegularizationType = RegularizationType.NONE
    elastic_net_alpha: Optional[float] = None

    def __post_init__(self):
        if self.reg_type == RegularizationType.ELASTIC_NET:
            a = self.elastic_net_alpha
            if a is None or not (0.0 <= a <= 1.0):
                raise ValueError(
                    f"ELASTIC_NET requires alpha in [0, 1], got {self.elastic_net_alpha}"
                )
        elif self.elastic_net_alpha is not None:
            raise ValueError("elastic_net_alpha only applies to ELASTIC_NET")

    def l1_weight(self, reg_weight: float) -> float:
        if self.reg_type == RegularizationType.L1:
            return reg_weight
        if self.reg_type == RegularizationType.ELASTIC_NET:
            return self.elastic_net_alpha * reg_weight
        return 0.0

    def l2_weight(self, reg_weight: float) -> float:
        if self.reg_type == RegularizationType.L2:
            return reg_weight
        if self.reg_type == RegularizationType.ELASTIC_NET:
            return (1.0 - self.elastic_net_alpha) * reg_weight
        return 0.0


L2 = RegularizationContext(RegularizationType.L2)
L1 = RegularizationContext(RegularizationType.L1)
NO_REG = RegularizationContext(RegularizationType.NONE)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    optimizer_type: OptimizerType = OptimizerType.LBFGS
    max_iterations: int = 100
    tolerance: float = 1e-7
    box_constraints: Optional[Tuple[object, object]] = None

    def validate(self, reg: RegularizationContext) -> None:
        """TRON supports L2/NONE only and no box constraints."""
        if self.optimizer_type == OptimizerType.TRON and reg.reg_type in (
            RegularizationType.L1,
            RegularizationType.ELASTIC_NET,
        ):
            raise ValueError("TRON supports only L2/NONE regularization")
        if self.optimizer_type == OptimizerType.TRON and self.box_constraints is not None:
            raise ValueError("TRON does not support box constraints — use LBFGS")


@dataclasses.dataclass(frozen=True)
class CoordinateOptimizationConfig:
    """Per-coordinate optimization settings. `down_sampling_rate` < 1 is
    accepted by the configuration but not ported yet (the coordinates raise)."""

    optimizer: OptimizerConfig = OptimizerConfig()
    regularization: RegularizationContext = NO_REG
    reg_weight: float = 0.0
    down_sampling_rate: float = 1.0
    variance_computation: VarianceComputationType = VarianceComputationType.NONE

    def __post_init__(self):
        if not (0.0 < self.down_sampling_rate <= 1.0):
            raise ValueError("down_sampling_rate must be in (0, 1]")
        if self.reg_weight < 0.0:
            raise ValueError("reg_weight must be non-negative")
        self.optimizer.validate(self.regularization)

    @property
    def l1_weight(self) -> float:
        return self.regularization.l1_weight(self.reg_weight)

    @property
    def l2_weight(self) -> float:
        return self.regularization.l2_weight(self.reg_weight)
