"""Box-constraint maps: JSON constraint strings -> per-feature bounds.

The port's own copy of `photon_ml_tpu/optimize/constraints.py`, over the
port's `data/index_map.py`; rules and error messages are the reference's
verbatim. Counterpart of photon-client io/deprecated/GLMSuite.createConstraintFeatureMap
(GLMSuite.scala:190-265) and ConstraintMapKeys.scala. The constraint string
is a JSON array of maps, each with mandatory "name"/"term" keys and optional
"lowerBound"/"upperBound" (missing = -Inf/+Inf):

    [{"name": "age", "term": "", "lowerBound": 0.0},
     {"name": "*",   "term": "*", "upperBound": 1.0}]

Wildcard rules, verbatim from the reference:
  * name == "*" requires term == "*" and applies the bound to every
    non-intercept feature; it must be the ONLY constraint.
  * term == "*" applies to every term of `name`.
  * Overlapping constraints for the same feature are an error.
  * lowerBound < upperBound required; both infinite is an error.

The resolved map feeds `bounds_arrays`, producing the (lower, upper) vectors
`OptimizerConfig.box_constraints` consumes (the projected L-BFGS of
optimize/lbfgs.py; reference LBFGS.scala:70-75 / LBFGSB).
"""

from __future__ import annotations

import json
import math
from typing import Dict, Optional, Tuple

import numpy as np

from photon_ml_tpu_torch.data.index_map import DELIMITER, INTERCEPT_KEY, IndexMap, feature_key

WILDCARD = "*"

_NAME = "name"
_TERM = "term"
_LOWER = "lowerBound"
_UPPER = "upperBound"


def create_constraint_feature_map(
    constraint_string: Optional[str], index_map: IndexMap
) -> Optional[Dict[int, Tuple[float, float]]]:
    """GLMSuite.createConstraintFeatureMap: JSON -> {feature id: (lb, ub)}.

    Returns None for an empty/absent constraint string or when nothing in the
    map resolves against the index map.
    """
    if not constraint_string:
        return None
    entries = json.loads(constraint_string)
    if not isinstance(entries, list):
        raise ValueError(f"constraint string must be a JSON array: {constraint_string!r}")

    cmap: Dict[int, Tuple[float, float]] = {}
    for entry in entries:
        if _NAME not in entry or _TERM not in entry:
            raise ValueError(
                "Each map in the constraint map is expected to have the "
                f"feature name and term fields specified; malformed map: {entry!r}"
            )
        name = str(entry[_NAME])
        term = str(entry[_TERM])
        lower = float(entry.get(_LOWER, -math.inf))
        upper = float(entry.get(_UPPER, math.inf))
        if not (lower > -math.inf or upper < math.inf):
            raise ValueError(
                f"The lower and upper bound are respectively -Inf and +Inf for "
                f"the feature with name [{name}] and term [{term}]."
            )
        if not lower < upper:
            raise ValueError(
                f"The lower bound [{lower}] is incorrectly specified as greater "
                f"than the upper bound [{upper}] for the feature with name "
                f"[{name}] and term [{term}]."
            )

        if name == WILDCARD:
            if term != WILDCARD:
                raise ValueError(
                    "We do not support wildcard in feature name alone; if the "
                    "name is a wildcard the term must also be a wildcard"
                )
            if cmap:
                raise ValueError(
                    "Potentially conflicting constraints: an all-feature "
                    "wildcard must be the only constraint"
                )
            for key, idx in index_map.items():
                if key != INTERCEPT_KEY:
                    cmap[idx] = (lower, upper)
        elif term == WILDCARD:
            prefix = name + DELIMITER
            for key, idx in index_map.items():
                if key == name or key.startswith(prefix):
                    if idx in cmap:
                        raise ValueError(
                            f"Conflicting bounds for feature name [{name}]: "
                            f"feature id {idx} already constrained"
                        )
                    cmap[idx] = (lower, upper)
        else:
            idx = index_map.get_index(feature_key(name, term))
            if idx >= 0:
                if idx in cmap:
                    raise ValueError(
                        f"Conflicting bounds for feature [{name}]/[{term}]"
                    )
                cmap[idx] = (lower, upper)
    return cmap or None


def bounds_arrays(
    cmap: Optional[Dict[int, Tuple[float, float]]], dim: int
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Constraint map -> dense (lower, upper) vectors for the optimizer
    (unconstrained features get (-Inf, +Inf))."""
    if not cmap:
        return None
    lower = np.full(dim, -np.inf, np.float32)
    upper = np.full(dim, np.inf, np.float32)
    for idx, (lb, ub) in cmap.items():
        lower[idx] = lb
        upper[idx] = ub
    return lower, upper
