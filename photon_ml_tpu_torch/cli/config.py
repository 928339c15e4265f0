"""Compound-argument configuration mini-DSL + coordinate configurations.

The port's own copy of `photon_ml_tpu/cli/config.py`, with its key strings.
Counterpart of photon-client io/scopt/ScoptParserHelpers.scala:61-151 (the
`name=global,feature.shard=globalShard,...` expand/collapse DSL),
io/CoordinateConfiguration.scala (data config + opt config + reg-weight
sweep -> Seq[GameOptimizationConfiguration]) and
io/FeatureShardConfiguration.scala. The DSL strings are accepted verbatim
from the reference's README examples (README.md:283-292) so existing Photon
ML job configs port unchanged; parsers round-trip (`to_string`) for
reproducibility, as the scopt parsers print the effective config back out.

Delimiters (ScoptParserHelpers.scala:40-44): `=` key/value, `,` list,
`|` secondary list, `-` range.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Mapping, Optional, Tuple

from photon_ml_tpu_torch.data.game_dataset import (
    FixedEffectDataConfig,
    RandomEffectDataConfig,
)
from photon_ml_tpu_torch.io.avro_data import FeatureShardConfig
from photon_ml_tpu_torch.optimize.config import (
    CoordinateOptimizationConfig,
    OptimizerConfig,
    RegularizationContext,
)
from photon_ml_tpu_torch.types import OptimizerType, ProjectorType, RegularizationType

KV_DELIMITER = "="
LIST_DELIMITER = ","
SECONDARY_LIST_DELIMITER = "|"

# Feature-shard DSL keys (ScoptParserHelpers.scala:48-55).
FEATURE_SHARD_CONFIG_NAME = "name"
FEATURE_SHARD_CONFIG_FEATURE_BAGS = "feature.bags"
FEATURE_SHARD_CONFIG_INTERCEPT = "intercept"

# Coordinate DSL keys (ScoptParserHelpers.scala:57-76).
COORDINATE_CONFIG_NAME = "name"
COORDINATE_DATA_CONFIG_RANDOM_EFFECT_TYPE = "random.effect.type"
COORDINATE_DATA_CONFIG_FEATURE_SHARD = "feature.shard"
COORDINATE_DATA_CONFIG_MIN_PARTITIONS = "min.partitions"
COORDINATE_DATA_CONFIG_ACTIVE_DATA_LOWER_BOUND = "active.data.lower.bound"
COORDINATE_DATA_CONFIG_ACTIVE_DATA_UPPER_BOUND = "active.data.upper.bound"
COORDINATE_DATA_CONFIG_FEATURES_TO_SAMPLES_RATIO = "features.to.samples.ratio"
COORDINATE_OPT_CONFIG_OPTIMIZER = "optimizer"
COORDINATE_OPT_CONFIG_MAX_ITER = "max.iter"
COORDINATE_OPT_CONFIG_TOLERANCE = "tolerance"
COORDINATE_OPT_CONFIG_REGULARIZATION = "regularization"
COORDINATE_OPT_CONFIG_REG_ALPHA = "reg.alpha"
COORDINATE_OPT_CONFIG_REG_WEIGHTS = "reg.weights"
COORDINATE_OPT_CONFIG_DOWN_SAMPLING_RATE = "down.sampling.rate"
# Box-constraint map: path to a JSON file in the legacy constraint-string
# format (GLMSuite.scala:190-265; resolved against the shard's index map by
# the training driver).
COORDINATE_OPT_CONFIG_CONSTRAINTS_FILE = "constraints.file"
# TPU-build extensions (no reference equivalent; entity blocking replaces
# Spark partitioning, and projection is configured per coordinate).
COORDINATE_DATA_CONFIG_MIN_BUCKET = "min.bucket"
COORDINATE_DATA_CONFIG_PROJECTOR = "projector"
COORDINATE_DATA_CONFIG_PROJECTED_DIM = "projected.dim"


def parse_compound(arg: str) -> Dict[str, str]:
    """`k1=v1,k2=v2,...` -> dict (ScoptParserHelpers expand direction)."""
    out: Dict[str, str] = {}
    for piece in arg.split(LIST_DELIMITER):
        piece = piece.strip()
        if not piece:
            continue
        if KV_DELIMITER not in piece:
            raise ValueError(f"malformed `key=value` pair {piece!r} in {arg!r}")
        k, v = piece.split(KV_DELIMITER, 1)
        k, v = k.strip(), v.strip()
        if k in out:
            raise ValueError(f"duplicate key {k!r} in {arg!r}")
        out[k] = v
    return out


def _parse_bool(v: str) -> bool:
    if v.lower() in ("true", "1", "yes"):
        return True
    if v.lower() in ("false", "0", "no"):
        return False
    raise ValueError(f"not a boolean: {v!r}")


def parse_feature_shard_config(arg: str) -> Tuple[str, FeatureShardConfig]:
    """`name=shard,feature.bags=f1|f2,intercept=true` ->
    (shard id, FeatureShardConfiguration) (ScoptParserHelpers
    parseFeatureShardConfiguration:151+)."""
    kv = parse_compound(arg)
    try:
        name = kv.pop(FEATURE_SHARD_CONFIG_NAME)
    except KeyError:
        raise ValueError(f"feature shard config missing 'name': {arg!r}") from None
    bags = tuple(
        b for b in kv.pop(FEATURE_SHARD_CONFIG_FEATURE_BAGS, "features").split(
            SECONDARY_LIST_DELIMITER
        )
        if b
    )
    intercept = _parse_bool(kv.pop(FEATURE_SHARD_CONFIG_INTERCEPT, "true"))
    if kv:
        raise ValueError(f"unknown feature shard config keys {sorted(kv)} in {arg!r}")
    return name, FeatureShardConfig(feature_bags=bags, has_intercept=intercept)


def feature_shard_config_to_string(name: str, cfg: FeatureShardConfig) -> str:
    """Collapse direction (featureShardConfigsToStrings:358-390)."""
    parts = [f"{FEATURE_SHARD_CONFIG_NAME}{KV_DELIMITER}{name}"]
    parts.append(
        f"{FEATURE_SHARD_CONFIG_FEATURE_BAGS}{KV_DELIMITER}"
        + SECONDARY_LIST_DELIMITER.join(cfg.feature_bags)
    )
    parts.append(
        f"{FEATURE_SHARD_CONFIG_INTERCEPT}{KV_DELIMITER}{str(cfg.has_intercept).lower()}"
    )
    return LIST_DELIMITER.join(parts)


@dataclasses.dataclass
class CoordinateConfiguration:
    """Data config + opt config + regularization-weight sweep for one
    coordinate (io/CoordinateConfiguration.scala).

    `expand()` returns one CoordinateOptimizationConfig per reg weight,
    sorted DESCENDING (most regularization first — the warm-start-friendly
    order, CoordinateConfiguration.scala:71-77)."""

    name: str
    data_config: object  # FixedEffectDataConfig | RandomEffectDataConfig
    opt_config: CoordinateOptimizationConfig
    reg_weights: Tuple[float, ...] = (0.0,)
    constraint_file: Optional[str] = None  # JSON constraint map (GLMSuite.scala:46)

    def expand(self) -> List[CoordinateOptimizationConfig]:
        return [
            dataclasses.replace(self.opt_config, reg_weight=w)
            for w in sorted(set(self.reg_weights), reverse=True)
        ]


def parse_coordinate_config(arg: str) -> CoordinateConfiguration:
    """Parse one `--coordinate-configurations` DSL string
    (ScoptParserHelpers.parseCoordinateConfiguration:180-270)."""
    kv = parse_compound(arg)

    def pop(key: str, default: Optional[str] = None) -> Optional[str]:
        return kv.pop(key, default)

    try:
        name = kv.pop(COORDINATE_CONFIG_NAME)
        shard = kv.pop(COORDINATE_DATA_CONFIG_FEATURE_SHARD)
    except KeyError as e:
        raise ValueError(f"coordinate config missing {e.args[0]!r}: {arg!r}") from None

    # Spark partitioning is meaningless here; accepted and ignored for
    # compatibility with reference job configs.
    pop(COORDINATE_DATA_CONFIG_MIN_PARTITIONS)

    re_type = pop(COORDINATE_DATA_CONFIG_RANDOM_EFFECT_TYPE)
    lower = pop(COORDINATE_DATA_CONFIG_ACTIVE_DATA_LOWER_BOUND)
    upper = pop(COORDINATE_DATA_CONFIG_ACTIVE_DATA_UPPER_BOUND)
    ratio = pop(COORDINATE_DATA_CONFIG_FEATURES_TO_SAMPLES_RATIO)
    min_bucket = pop(COORDINATE_DATA_CONFIG_MIN_BUCKET)
    projector = pop(COORDINATE_DATA_CONFIG_PROJECTOR)
    projected_dim = pop(COORDINATE_DATA_CONFIG_PROJECTED_DIM)

    if re_type is not None:
        data_config = RandomEffectDataConfig(
            random_effect_type=re_type,
            feature_shard=shard,
            active_upper_bound=None if upper is None else int(upper),
            active_lower_bound=None if lower is None else int(lower),
            num_features_to_samples_ratio_upper_bound=(
                None if ratio is None else float(ratio)
            ),
            min_bucket=8 if min_bucket is None else int(min_bucket),
            projector_type=(
                ProjectorType.INDEX_MAP
                if projector is None
                else ProjectorType[projector.strip().upper()]
            ),
            projected_dim=None if projected_dim is None else int(projected_dim),
        )
    else:
        # Reference logs-and-ignores RE settings on FE coordinates
        # (ScoptParserHelpers.scala:248-267); mirror that leniency.
        import logging

        for key, val in ((COORDINATE_DATA_CONFIG_ACTIVE_DATA_LOWER_BOUND, lower),
                         (COORDINATE_DATA_CONFIG_ACTIVE_DATA_UPPER_BOUND, upper)):
            if val is not None:
                logging.getLogger(__name__).warning(
                    "ignoring random-effect setting %s=%s on fixed-effect "
                    "coordinate %r", key, val, name,
                )
        data_config = FixedEffectDataConfig(feature_shard=shard)

    optimizer = OptimizerType.parse(pop(COORDINATE_OPT_CONFIG_OPTIMIZER, "LBFGS"))
    max_iter = int(pop(COORDINATE_OPT_CONFIG_MAX_ITER, "100"))
    tolerance = float(pop(COORDINATE_OPT_CONFIG_TOLERANCE, "1e-7"))
    reg_type = RegularizationType.parse(pop(COORDINATE_OPT_CONFIG_REGULARIZATION, "NONE"))
    alpha = pop(COORDINATE_OPT_CONFIG_REG_ALPHA)
    weights_str = pop(COORDINATE_OPT_CONFIG_REG_WEIGHTS)
    down_sampling = float(pop(COORDINATE_OPT_CONFIG_DOWN_SAMPLING_RATE, "1.0"))
    constraint_file = pop(COORDINATE_OPT_CONFIG_CONSTRAINTS_FILE)
    if kv:
        raise ValueError(f"unknown coordinate config keys {sorted(kv)} in {arg!r}")

    reg = RegularizationContext(
        reg_type,
        elastic_net_alpha=(
            float(alpha)
            if alpha is not None and reg_type == RegularizationType.ELASTIC_NET
            else None
        ),
    )
    if reg_type == RegularizationType.NONE:
        reg_weights: Tuple[float, ...] = (0.0,)
    else:
        if weights_str is None:
            raise ValueError(
                f"regularization enabled but no '{COORDINATE_OPT_CONFIG_REG_WEIGHTS}' "
                f"given: {arg!r}"
            )
        reg_weights = tuple(
            float(w) for w in weights_str.split(SECONDARY_LIST_DELIMITER) if w
        )

    opt = CoordinateOptimizationConfig(
        optimizer=OptimizerConfig(
            optimizer_type=optimizer, max_iterations=max_iter, tolerance=tolerance
        ),
        regularization=reg,
        reg_weight=max(reg_weights),
        down_sampling_rate=down_sampling,
    )
    return CoordinateConfiguration(
        name, data_config, opt, reg_weights, constraint_file=constraint_file
    )


def coordinate_config_to_string(cfg: CoordinateConfiguration) -> str:
    """Collapse direction (coordinateConfigsToStrings:429+) — round-trips
    through parse_coordinate_config."""
    parts = [f"{COORDINATE_CONFIG_NAME}{KV_DELIMITER}{cfg.name}"]
    dc = cfg.data_config
    parts.append(f"{COORDINATE_DATA_CONFIG_FEATURE_SHARD}{KV_DELIMITER}{dc.feature_shard}")
    if isinstance(dc, RandomEffectDataConfig):
        parts.append(
            f"{COORDINATE_DATA_CONFIG_RANDOM_EFFECT_TYPE}{KV_DELIMITER}{dc.random_effect_type}"
        )
        if dc.active_lower_bound is not None:
            parts.append(
                f"{COORDINATE_DATA_CONFIG_ACTIVE_DATA_LOWER_BOUND}{KV_DELIMITER}{dc.active_lower_bound}"
            )
        if dc.active_upper_bound is not None:
            parts.append(
                f"{COORDINATE_DATA_CONFIG_ACTIVE_DATA_UPPER_BOUND}{KV_DELIMITER}{dc.active_upper_bound}"
            )
        if dc.num_features_to_samples_ratio_upper_bound is not None:
            parts.append(
                f"{COORDINATE_DATA_CONFIG_FEATURES_TO_SAMPLES_RATIO}{KV_DELIMITER}"
                f"{dc.num_features_to_samples_ratio_upper_bound}"
            )
        parts.append(f"{COORDINATE_DATA_CONFIG_MIN_BUCKET}{KV_DELIMITER}{dc.min_bucket}")
        parts.append(
            f"{COORDINATE_DATA_CONFIG_PROJECTOR}{KV_DELIMITER}{dc.projector_type.value}"
        )
        if dc.projected_dim is not None:
            parts.append(
                f"{COORDINATE_DATA_CONFIG_PROJECTED_DIM}{KV_DELIMITER}{dc.projected_dim}"
            )
    oc = cfg.opt_config
    parts.append(
        f"{COORDINATE_OPT_CONFIG_OPTIMIZER}{KV_DELIMITER}{oc.optimizer.optimizer_type.value}"
    )
    parts.append(f"{COORDINATE_OPT_CONFIG_TOLERANCE}{KV_DELIMITER}{oc.optimizer.tolerance}")
    parts.append(f"{COORDINATE_OPT_CONFIG_MAX_ITER}{KV_DELIMITER}{oc.optimizer.max_iterations}")
    parts.append(
        f"{COORDINATE_OPT_CONFIG_REGULARIZATION}{KV_DELIMITER}{oc.regularization.reg_type.value}"
    )
    if oc.regularization.elastic_net_alpha is not None:
        parts.append(
            f"{COORDINATE_OPT_CONFIG_REG_ALPHA}{KV_DELIMITER}{oc.regularization.elastic_net_alpha}"
        )
    if oc.regularization.reg_type != RegularizationType.NONE:
        parts.append(
            f"{COORDINATE_OPT_CONFIG_REG_WEIGHTS}{KV_DELIMITER}"
            + SECONDARY_LIST_DELIMITER.join(str(w) for w in cfg.reg_weights)
        )
    if oc.down_sampling_rate < 1.0:
        parts.append(
            f"{COORDINATE_OPT_CONFIG_DOWN_SAMPLING_RATE}{KV_DELIMITER}{oc.down_sampling_rate}"
        )
    if cfg.constraint_file:
        parts.append(
            f"{COORDINATE_OPT_CONFIG_CONSTRAINTS_FILE}{KV_DELIMITER}{cfg.constraint_file}"
        )
    return LIST_DELIMITER.join(parts)


def expand_game_opt_configs(
    coordinate_configs: Mapping[str, CoordinateConfiguration],
) -> List[Dict[str, CoordinateOptimizationConfig]]:
    """Cross product of every coordinate's reg-weight expansion
    (GameTrainingDriver.prepareGameOptConfigs — foldLeft cartesian product)."""
    ids = list(coordinate_configs.keys())
    expanded = [coordinate_configs[c].expand() for c in ids]
    return [
        dict(zip(ids, combo)) for combo in itertools.product(*expanded)
    ]
