"""LibSVM text reader and writer.

Port of `photon_ml_tpu/data/libsvm.py`: `parse_libsvm_line` (the tokenizer
the Avro converter, cli/libsvm_to_avro.py, shares), `read_libsvm` into a
host CSR `CSRDataset` (labels mapped to {0, 1}, the intercept appended as
the last column) and `write_libsvm`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


def parse_libsvm_line(
    line: str, *, zero_based: bool = False
) -> Optional[Tuple[float, List[Tuple[int, float]], str]]:
    """One LibSVM line -> (label, [(index, value), ...], raw comment), or
    None for a blank or comment-only line. Indices come back 0-based; the
    comment is everything after '#', stripped."""
    body, _, comment = line.partition("#")
    body = body.strip()
    if not body:
        return None
    parts = body.split()
    label = float(parts[0])
    pairs = []
    for tok in parts[1:]:
        k, v = tok.split(":")
        pairs.append((int(k) - (0 if zero_based else 1), float(v)))
    return label, pairs, comment.strip()


@dataclasses.dataclass
class CSRDataset:
    """Host-side CSR design matrix and its labels."""

    indptr: np.ndarray
    indices: np.ndarray
    values: np.ndarray
    labels: np.ndarray
    dim: int

    @property
    def num_rows(self) -> int:
        return len(self.indptr) - 1

    def to_dense(self) -> np.ndarray:
        X = np.zeros((self.num_rows, self.dim), dtype=self.values.dtype)
        rows = np.repeat(np.arange(self.num_rows), np.diff(self.indptr))
        X[rows, self.indices] = self.values
        return X


def _parse_python(path: str, zero_based: bool, dtype):
    labels: List[float] = []
    indptr = [0]
    indices: List[int] = []
    values: List[float] = []
    max_idx = -1
    with open(path) as f:
        for line in f:
            parsed = parse_libsvm_line(line, zero_based=zero_based)
            if parsed is None:
                continue
            label, pairs, _ = parsed
            labels.append(label)
            for idx, v in pairs:
                indices.append(idx)
                values.append(v)
                max_idx = max(max_idx, idx)
            indptr.append(len(indices))
    return (np.asarray(labels, np.float64), np.asarray(indptr, np.int64),
            np.asarray(indices, np.int32), np.asarray(values, dtype), max_idx)


def read_libsvm(
    path: str,
    *,
    num_features: Optional[int] = None,
    add_intercept: bool = True,
    zero_based: bool = False,
    binary_labels_to_01: bool = True,
    dtype=np.float32,
) -> CSRDataset:
    """Parse a LibSVM file.

    Labels in {-1, +1} become {0, 1} (`binary_labels_to_01`); the
    intercept, when asked for, is the last column (index dim - 1) with
    value 1.0; with `num_features`, entries past that width are dropped (as
    the Avro reader drops unseen features). The native parser
    (native/libsvm_parser.cc) tokenizes; a file it refuses goes to the
    Python tokenizer, as in the JAX reader, which raises on malformed
    input."""
    from photon_ml_tpu_torch.native import libsvm_parser

    parsed = libsvm_parser.parse_file(path, zero_based=zero_based)
    if parsed is not None:
        labels_a, indptr_a, indices_a, values_a, max_idx = parsed
        values_a = values_a.astype(dtype, copy=False)
    else:
        labels_a, indptr_a, indices_a, values_a, max_idx = _parse_python(path, zero_based, dtype)

    base_dim = (max_idx + 1) if num_features is None else num_features
    if num_features is not None:
        # An out-of-range index kept would alias another column downstream.
        oob = indices_a >= base_dim
        if oob.any():
            indices_a = np.where(oob, 0, indices_a)
            values_a = np.where(oob, 0, values_a)
    dim = base_dim + (1 if add_intercept else 0)
    y = labels_a.astype(dtype)
    if binary_labels_to_01 and set(np.unique(y)) <= {-1.0, 1.0}:
        y = (y > 0).astype(dtype)

    if add_intercept:
        n = len(y)
        # The intercept entry at every row's end, in one vectorized insert.
        indices_a = np.insert(indices_a, indptr_a[1:], np.int32(dim - 1))
        values_a = np.insert(values_a, indptr_a[1:], dtype(1.0))
        indptr_a = indptr_a + np.arange(n + 1, dtype=np.int64)

    return CSRDataset(indptr_a, indices_a, values_a, y, dim)


def write_libsvm(path: str, data: CSRDataset, *, zero_based: bool = False) -> None:
    off = 0 if zero_based else 1
    with open(path, "w") as f:
        for r in range(data.num_rows):
            lo, hi = data.indptr[r], data.indptr[r + 1]
            feats = " ".join(
                f"{int(i) + off}:{v:g}"
                for i, v in zip(data.indices[lo:hi], data.values[lo:hi])
            )
            f.write(f"{data.labels[r]:g} {feats}\n")
