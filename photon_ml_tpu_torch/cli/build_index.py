"""Feature-indexing driver: build the persistent partitioned index store.

Port of `photon_ml_tpu/cli/build_index.py` (photon-client
index/FeatureIndexingDriver.scala:41-320): read training records, take the
distinct feature keys per feature shard (union of the shard's feature bags,
plus the intercept key when the shard has one), route each key to a hash
partition, and build one memory-mapped store partition per hash bucket:
`index-partition-<shard>-<k>.bin` (PHIDX, native/index_store.cc), or the
reference's PalDB v1 `paldb-partition-<shard>-<k>.dat` with
`--output-format paldb` (io/paldb.py). The stores are the JAX driver's, byte
for byte (a PalDB header carries the time of its write).

The input is raw Avro data, read through the port's Avro reader (the native
block decoder where the schema allows), or the per-bag text files of
cli/name_and_term.py (the NameAndTermFeatureBagsDriver output), the same
coupling the reference has between its two indexing drivers. All of it runs
on the host; the drivers read the stores with `--offheap-indexmap-dir`.

Usage:
    python -m photon_ml_tpu_torch.cli.build_index \
        --input-data-directories data/train \
        --feature-shard-configurations "name=globalShard,feature.bags=features" \
        --num-partitions 4 --output-dir out/index
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Dict, Iterable, List, Set

from photon_ml_tpu_torch.cli.config import parse_feature_shard_config
from photon_ml_tpu_torch.cli.name_and_term import read_name_and_term_file
from photon_ml_tpu_torch.data.index_map import INTERCEPT_KEY, feature_key
from photon_ml_tpu_torch.io import paldb
from photon_ml_tpu_torch.io.avro_data import FeatureShardConfig, distinct_feature_keys
from photon_ml_tpu_torch.native.index_store import METADATA_FILE, build_partitioned_store

logger = logging.getLogger("photon_ml_tpu_torch.cli.build_index")

FORMATS = ("phidx", "paldb")


def collect_shard_keys(records: Iterable[dict],
                       shard_configs: Dict[str, FeatureShardConfig]) -> Dict[str, Set[str]]:
    """Distinct feature keys per shard of decoded records (FeatureIndexingDriver
    partitionedUniqueFeatures:217-251, intercept injected like :243)."""
    keys: Dict[str, Set[str]] = {name: set() for name in shard_configs}
    for record in records:
        for shard_name, cfg in shard_configs.items():
            bucket = keys[shard_name]
            for bag in cfg.feature_bags:
                for f in record.get(bag) or ():
                    bucket.add(feature_key(f["name"], f.get("term", "") or ""))
    return _with_intercepts(keys, shard_configs)


def shard_keys_of_files(paths: List[str],
                        shard_configs: Dict[str, FeatureShardConfig]) -> Dict[str, Set[str]]:
    """`collect_shard_keys` over the Avro files under `paths`."""
    bags = distinct_feature_keys(paths, [b for cfg in shard_configs.values() for b in cfg.feature_bags])
    keys = {name: set().union(*(bags[b] for b in cfg.feature_bags))
            for name, cfg in shard_configs.items()}
    return _with_intercepts(keys, shard_configs)


def shard_keys_of_name_and_terms(directory: str,
                                 shard_configs: Dict[str, FeatureShardConfig]) -> Dict[str, Set[str]]:
    """Distinct feature keys per shard from per-bag name-and-term files."""
    keys: Dict[str, Set[str]] = {}
    for shard_name, cfg in shard_configs.items():
        keys[shard_name] = {feature_key(name, term) for bag in cfg.feature_bags
                            for name, term in read_name_and_term_file(os.path.join(directory, bag))}
    return _with_intercepts(keys, shard_configs)


def _with_intercepts(keys: Dict[str, Set[str]], shard_configs) -> Dict[str, Set[str]]:
    for shard_name, cfg in shard_configs.items():
        if cfg.has_intercept:
            keys[shard_name].add(INTERCEPT_KEY)
    return keys


def build_index_stores(shard_keys: Dict[str, Set[str]], output_dir: str, num_partitions: int,
                       store_format: str = "phidx") -> Dict[str, int]:
    """Build one partitioned store per shard namespace, and the metadata JSON.

    `store_format='paldb'` writes the reference's PalDB v1 partitions
    (loadable by PalDBIndexMap.scala:43-118) instead of PHIDX."""
    if store_format not in FORMATS:
        raise ValueError(f"store_format must be one of {FORMATS}, got {store_format!r}")
    os.makedirs(output_dir, exist_ok=True)
    counts: Dict[str, int] = {}
    for shard_name, keys in shard_keys.items():
        if store_format == "paldb":
            counts[shard_name] = len(paldb.write_index_map(output_dir, shard_name, sorted(keys),
                                                           num_partitions))
        else:
            counts[shard_name] = build_partitioned_store(output_dir, sorted(keys), num_partitions,
                                                         namespace=shard_name)
        logger.info("indexed %d features for shard %s (%d partitions)", counts[shard_name],
                    shard_name, num_partitions)
    with open(os.path.join(output_dir, METADATA_FILE), "w") as f:
        json.dump({"num_partitions": num_partitions,
                   "shards": {name: {"num_features": n} for name, n in counts.items()}}, f, indent=2)
    return counts


def main(argv: List[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="photon_ml_tpu_torch.cli.build_index",
        description="Build partitioned persistent feature-index stores "
                    "(FeatureIndexingDriver equivalent).")
    parser.add_argument("--input-data-directories", nargs="+", default=[],
                        help="Avro training-data files or directories.")
    parser.add_argument("--name-and-term-directory", default=None,
                        help="Directory of per-bag name-and-term text files "
                             "(NameAndTermFeatureBagsDriver output) to index instead of raw data.")
    parser.add_argument("--feature-shard-configurations", nargs="+", required=True,
                        help="Shard mini-DSL, e.g. 'name=globalShard,feature.bags=f1|f2'.")
    parser.add_argument("--num-partitions", type=int, default=1)
    parser.add_argument("--output-dir", required=True)
    parser.add_argument("--output-format", choices=FORMATS, default="phidx",
                        help="Store format: PHIDX (default) or the reference's PalDB v1 "
                             "partitions (readable by its PalDBIndexMap).")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    shard_configs = dict(parse_feature_shard_config(s) for s in args.feature_shard_configurations)
    if args.name_and_term_directory:
        shard_keys = shard_keys_of_name_and_terms(args.name_and_term_directory, shard_configs)
    elif args.input_data_directories:
        shard_keys = shard_keys_of_files(args.input_data_directories, shard_configs)
    else:
        parser.error("either --input-data-directories or --name-and-term-directory is required")
    build_index_stores(shard_keys, args.output_dir, args.num_partitions, args.output_format)
    return 0


if __name__ == "__main__":
    sys.exit(main())
