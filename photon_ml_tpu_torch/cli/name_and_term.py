"""Name-and-term feature-bag extraction driver.

Port of `photon_ml_tpu/cli/name_and_term.py` (photon-client
data/avro/NameAndTermFeatureBagsDriver.scala:32 with NameAndTerm.scala:25 /
NameAndTermFeatureMapUtils.scala:26): scan the input Avro records and write
the distinct (name, term) pairs of each feature bag as one merged text file
`<output>/<bagName>` with tab-delimited lines (NameAndTerm.STRING_DELIMITER
= "\\t", NameAndTerm.scala:39,63). These files feed the feature-indexing
driver (cli/build_index.py), so an index build does not scan the raw data
again. The records are read through the port's Avro reader
(`io/avro_data.distinct_feature_keys`: the native block decoder where the
schema allows). The files are the JAX driver's, byte for byte.

Usage:
    python -m photon_ml_tpu_torch.cli.name_and_term \
        --input-data-directories data/train \
        --feature-bags-keys features songFeatures \
        --output-dir out/name-and-term
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Dict, Iterable, List, Set, Tuple

from photon_ml_tpu_torch.data.index_map import DELIMITER
from photon_ml_tpu_torch.io.avro_data import distinct_feature_keys

logger = logging.getLogger("photon_ml_tpu_torch.cli.name_and_term")

STRING_DELIMITER = "\t"


def extract_name_and_terms(records: Iterable[dict], feature_bags: List[str]) -> Dict[str, Set[Tuple[str, str]]]:
    """Distinct (name, term) per bag of decoded records
    (NameAndTermFeatureMapUtils readNameAndTermFeatureMapFromRawRecords role)."""
    out: Dict[str, Set[Tuple[str, str]]] = {bag: set() for bag in feature_bags}
    for record in records:
        for bag in feature_bags:
            for f in record.get(bag) or ():
                out[bag].add((f["name"], f.get("term", "") or ""))
    return out


def name_and_terms_of_files(paths: List[str], feature_bags: List[str]) -> Dict[str, Set[Tuple[str, str]]]:
    """Distinct (name, term) per bag over the Avro files under `paths`."""
    keys = distinct_feature_keys(paths, feature_bags)
    out: Dict[str, Set[Tuple[str, str]]] = {}
    for bag in feature_bags:
        out[bag] = set()
        for key in keys[bag]:
            name, _, term = key.partition(DELIMITER)
            out[bag].add((name, term))
    return out


def write_name_and_term_file(path: str, pairs: Set[Tuple[str, str]]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for name, term in sorted(pairs):
            if "\t" in name or "\n" in name or "\t" in term or "\n" in term:
                # The text format cannot hold its delimiters; a silent write
                # would corrupt the round trip and the index.
                raise ValueError(
                    f"feature (name, term) ({name!r}, {term!r}) contains "
                    "tab/newline, unrepresentable in name-and-term text format")
            f.write(f"{name}{STRING_DELIMITER}{term}\n")


def read_name_and_term_file(path: str) -> List[Tuple[str, str]]:
    """Parse the text format back (readNameAndTermRDDFromTextFiles:136-146:
    1 field = name with empty term, 2 fields = name and term)."""
    pairs: List[Tuple[str, str]] = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split(STRING_DELIMITER)
            pairs.append((parts[0], "" if len(parts) == 1 else parts[1]))
    return pairs


def main(argv: List[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="photon_ml_tpu_torch.cli.name_and_term",
        description="Extract distinct (name, term) feature sets per bag "
                    "(NameAndTermFeatureBagsDriver equivalent).")
    parser.add_argument("--input-data-directories", nargs="+", required=True)
    parser.add_argument("--feature-bags-keys", nargs="+", required=True,
                        help="Feature bag field names to extract.")
    parser.add_argument("--output-dir", required=True)
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    bags = name_and_terms_of_files(args.input_data_directories, list(args.feature_bags_keys))
    for bag, pairs in bags.items():
        write_name_and_term_file(os.path.join(args.output_dir, bag), pairs)
        logger.info("wrote %d distinct (name, term) pairs for bag %s", len(pairs), bag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
