"""LibSVM text -> TrainingExample Avro converter.

Port of `photon_ml_tpu/cli/libsvm_to_avro.py`; it writes through the port's
`io/avro_data.write_training_examples`. Counterpart of the reference's only Python tool,
dev-scripts/libsvm_text_to_trainingexample_avro.py (README.md:330-334): each
LibSVM column index becomes a feature `name` with an empty `term`; binary
{-1,+1} labels map to {0,1} responses unless --regression is given.

Usage:
    python -m photon_ml_tpu_torch.cli.libsvm_to_avro INPUT OUTPUT [--regression] [--tag-comments]
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from photon_ml_tpu_torch.data.libsvm import parse_libsvm_line
from photon_ml_tpu_torch.io.avro_data import write_training_examples


def convert(
    input_path: str,
    output_path: str,
    *,
    regression: bool = False,
    zero_based: bool = False,
    tag_comments: bool = False,
) -> int:
    """Convert one LibSVM file (buffered in memory); returns the record count.

    Feature keys are the bare LibSVM indices as names (term empty), matching
    the reference converter's `{"name": id, "term": ""}` records. The
    intercept is NOT added here — the training driver's feature-shard config
    controls that (`intercept=true`), as with Avro data in the reference.

    Classification label mapping follows `read_libsvm`: {-1,+1} -> {0,1} only
    when EVERY label is in {-1,+1} (a whole-file property), so regression
    files that merely contain some ±1 targets are never silently corrupted.

    With `tag_comments`, trailing `# key=value[,key=value...]` comments are
    captured as id-tag fields (entity keys for GAME random effects) instead
    of being discarded — an extension over the reference converter so LibSVM
    sources can feed GLMix training.
    """
    features: List[List[tuple]] = []
    labels: List[float] = []
    tags: dict = {}
    with open(input_path) as f:
        for line in f:
            parsed = parse_libsvm_line(line, zero_based=zero_based)
            if parsed is None:
                continue
            label, pairs, comment = parsed
            row = [(str(idx), value) for idx, value in pairs]
            if tag_comments and comment:
                for pair in comment.split(","):
                    key, _, value = pair.partition("=")
                    if value:
                        tags.setdefault(key.strip(), {})[len(labels)] = value.strip()
            features.append(row)
            labels.append(label)
    if not regression and set(labels) <= {-1.0, 1.0}:
        labels = [1.0 if l > 0 else 0.0 for l in labels]
    n = len(labels)
    id_tags = {
        key: [by_row.get(i, "") for i in range(n)] for key, by_row in tags.items()
    }
    return write_training_examples(
        output_path,
        features,
        labels,
        uids=[str(i) for i in range(n)],
        id_tags=id_tags or None,
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="photon_ml_tpu_torch.cli.libsvm_to_avro",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("input", help="LibSVM text file")
    p.add_argument("output", help="output Avro file")
    p.add_argument(
        "--regression",
        action="store_true",
        help="keep labels as-is instead of mapping {-1,+1} to {0,1}",
    )
    p.add_argument(
        "--zero-based",
        action="store_true",
        help="LibSVM indices start at 0 (default: 1-based)",
    )
    p.add_argument(
        "--tag-comments",
        action="store_true",
        help="capture trailing '# key=value' comments as id-tag fields",
    )
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    n = convert(
        args.input,
        args.output,
        regression=args.regression,
        zero_based=args.zero_based,
        tag_comments=args.tag_comments,
    )
    print(f"wrote {n} records to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
