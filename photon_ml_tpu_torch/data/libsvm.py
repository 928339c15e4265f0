"""LibSVM text lines.

The part of `photon_ml_tpu/data/libsvm.py` the Avro converter needs
(cli/libsvm_to_avro.py): `parse_libsvm_line`. The LibSVM file reader and
its native parser belong to the GLM driver and are not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Tuple


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
