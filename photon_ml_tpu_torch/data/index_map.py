"""Feature-name <-> integer-index maps.

Counterpart of photon-api index/ (IndexMap.scala:22, DefaultIndexMap.scala:27,
DefaultIndexMapLoader.scala, PalDBIndexMap.scala:43) and photon-client's
IdentityIndexMapLoader. Feature keys follow the reference convention
`name + INTERCEPT_DELIMITER + term` ("nameterm" union key,
AvroDataReader.readFeaturesFromRecord:274-352), with the special
"(INTERCEPT)" key for the intercept column (Constants.scala).

Two implementations:
  * IndexMap — in-memory dict (DefaultIndexMap equivalent), built from the
    distinct feature keys of a dataset shard.
  * the persistent, memory-mapped stores answer the same protocol:
    native/index_store.PartitionedIndexStore (PHIDX) and the PalDB loader
    io/paldb.load_index_map.

The port's own copy of `photon_ml_tpu/data/index_map.py`.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Iterator, List, Optional

DELIMITER = "\x01"  # reference Constants.DELIMITER between name and term
INTERCEPT_KEY = "(INTERCEPT)"  # reference Constants.INTERCEPT_KEY


def feature_key(name: str, term: str = "") -> str:
    """Join name and term into the canonical feature key (AvroUtils style)."""
    return f"{name}{DELIMITER}{term}" if term else name


class IndexMap:
    """Immutable feature-name -> contiguous-id map (DefaultIndexMap.scala:27).

    Also answers the reverse query `get_feature_name(idx)` needed by the model
    store (IndexMap.scala getFeatureName).
    """

    def __init__(self, name_to_index: Dict[str, int]):
        self._fwd = dict(name_to_index)
        self._rev: Optional[List[Optional[str]]] = None

    @classmethod
    def from_feature_names(cls, names: Iterable[str], add_intercept: bool = False) -> "IndexMap":
        """Build from distinct names, sorted for determinism
        (DefaultIndexMap builds via distinct().sort().zipWithIndex())."""
        distinct = sorted(set(names) - {INTERCEPT_KEY})
        if add_intercept:
            distinct.append(INTERCEPT_KEY)
        return cls({n: i for i, n in enumerate(distinct)})

    def __len__(self) -> int:
        return len(self._fwd)

    @property
    def size(self) -> int:
        return len(self._fwd)

    def __contains__(self, name: str) -> bool:
        return name in self._fwd

    def __iter__(self) -> Iterator[str]:
        return iter(self._fwd)

    def items(self):
        return self._fwd.items()

    def get_index(self, name: str, default: int = -1) -> int:
        return self._fwd.get(name, default)

    def __getitem__(self, name: str) -> int:
        return self._fwd[name]

    def get_feature_name(self, index: int) -> Optional[str]:
        if self._rev is None:
            rev: List[Optional[str]] = [None] * (max(self._fwd.values(), default=-1) + 1)
            for k, v in self._fwd.items():
                rev[v] = k
            self._rev = rev
        if 0 <= index < len(self._rev):
            return self._rev[index]
        return None

    @property
    def intercept_index(self) -> Optional[int]:
        idx = self._fwd.get(INTERCEPT_KEY, -1)
        return idx if idx >= 0 else None

    # -- persistence (JSON; the off-heap binary stores are in native/ and io/) -

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self._fwd, f)

    @classmethod
    def load(cls, path: str) -> "IndexMap":
        with open(path) as f:
            return cls(json.load(f))
