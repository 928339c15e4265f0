"""Row-level training-data sanity checks.

Port of `photon_ml_tpu/data/validators.py` (photon-client
DataValidators.scala:32-405): labels, offsets, weights and features are
checked before training, with per-task label rules (binary labels for
logistic/SVM, non-negative labels for Poisson). VALIDATE_FULL checks every
row, VALIDATE_SAMPLE the JAX package's deterministic ~10% sample,
VALIDATE_DISABLED nothing. Each check is one torch predicate over the
column on the dataset's device; only the failing rows' count and first
indices come back to the host.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.data.containers import SparseFeatures
from photon_ml_tpu_torch.data.game_dataset import GameDataset
from photon_ml_tpu_torch.types import DataValidationType, TaskType

SAMPLE_FRACTION = 0.1


class DataValidationError(ValueError):
    """Raised when training data fails sanity checks. `failures` lists every
    failed check as (check name, number of offending rows, example row
    indices); `rows_checked` is how many rows the mode examined."""

    def __init__(self, failures: List[Tuple[str, int, List[int]]],
                 rows_checked: Optional[int] = None, mode: Optional[str] = None):
        self.failures = failures
        self.rows_checked = rows_checked
        lines = []
        for name, count, examples in failures:
            frac = f" ({100.0 * count / rows_checked:.1f}%)" if rows_checked else ""
            lines.append(f"{name}: {count} rows{frac} (e.g. rows {examples})")
        scope = (
            f" ({len(failures)} failed check(s) over {rows_checked} rows"
            + (f", mode {mode}" if mode else "")
            + ")"
            if rows_checked
            else ""
        )
        super().__init__(f"Training data failed validation{scope}:\n  " + "\n  ".join(lines))


def _sample_rows(n: int, mode: DataValidationType) -> Optional[np.ndarray]:
    """The sampled rows (the JAX package's draw), or None for every row."""
    if mode == DataValidationType.VALIDATE_SAMPLE:
        rng = np.random.default_rng(0)
        k = max(1, int(n * SAMPLE_FRACTION))
        return np.sort(rng.choice(n, size=k, replace=False))
    return None


def validate_game_dataset(dataset: GameDataset, task: TaskType, mode: DataValidationType, *,
                          max_examples: int = 5) -> None:
    """sanityCheckDataFrameForTraining (DataValidators.scala:300+): runs
    every check and raises one DataValidationError naming each failed check
    with its offending-row count and first `max_examples` rows."""
    if mode == DataValidationType.VALIDATE_DISABLED:
        return
    n = dataset.num_samples
    sample = _sample_rows(n, mode)
    rows = None if sample is None else torch.as_tensor(sample).to(dataset.device)
    take = (lambda t: t) if rows is None else (lambda t: t[rows])
    labels, offsets, weights = take(dataset.labels), take(dataset.offsets), take(dataset.weights)
    failures: List[Tuple[str, int, List[int]]] = []

    def check(name: str, ok: torch.Tensor) -> None:
        bad = torch.nonzero(~ok).flatten()
        count = int(bad.numel())
        if count:
            first = bad[:max_examples]
            first = first if rows is None else rows[first]
            failures.append((name, count, first.cpu().tolist()))

    check("finite label", torch.isfinite(labels))
    check("finite offset", torch.isfinite(offsets))
    check("finite weight", torch.isfinite(weights))
    check("positive weight", weights > 0)
    if task in (TaskType.LOGISTIC_REGRESSION, TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM):
        check("binary label", (labels == 0.0) | (labels == 1.0))
    elif task == TaskType.POISSON_REGRESSION:
        check("non-negative label", labels >= 0.0)
    for shard, feats in dataset.shards.items():
        vals = take(feats.values if isinstance(feats, SparseFeatures) else feats)
        check(f"finite features in shard {shard!r}", torch.isfinite(vals).all(dim=-1))

    if failures:
        raise DataValidationError(failures, rows_checked=n if rows is None else len(rows),
                                  mode=mode.name)
