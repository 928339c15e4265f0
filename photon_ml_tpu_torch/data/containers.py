"""Columnar labeled data on a device.

Port of `photon_ml_tpu/data/containers.py` for dense features: a batch of N
labeled points is a struct of tensors, the (N, D) design matrix plus the
(N,) labels, offsets and weights. Weight 0 marks a padding row, so every
weighted reduction is mask-correct. Leading batch axes are allowed: a
random-effect bucket is one LabeledData of (E, S, D) features and (E, S)
vectors. The ELL sparse layout is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class LabeledData:
    features: Tensor  # (..., N, D), float32 or bfloat16
    labels: Tensor  # (..., N)
    offsets: Tensor  # (..., N)
    weights: Tensor  # (..., N)


def dense_data(
    X,
    y,
    *,
    offsets=None,
    weights=None,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = "cuda",
) -> LabeledData:
    """LabeledData from host arrays (numpy or tensors)."""
    dev = resolve_device(device)
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype).to(dev)
    y_t = as_t(y)
    n = y_t.shape[0]
    off = torch.zeros(n, dtype=dtype, device=dev) if offsets is None else as_t(offsets)
    wt = torch.ones(n, dtype=dtype, device=dev) if weights is None else as_t(weights)
    return LabeledData(as_t(X).contiguous(), y_t, off, wt)


def optional_tensor(a, device: torch.device) -> Optional[Tensor]:
    return None if a is None else torch.tensor(np.asarray(a), device=device)
