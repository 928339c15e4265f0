"""The port's box-constraint maps (optimize/constraints.py) against the JAX
package's: every rule and error of tests/test_constraints.py, with the same
maps, the same bounds arrays and the same error types and messages; the
structural config key; and a constrained fit through the port's train
driver held against the JAX driver's."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from photon_ml_tpu.data.index_map import IndexMap as JaxIndexMap
from photon_ml_tpu.data.index_map import feature_key as jax_feature_key
from photon_ml_tpu.optimize import config as jax_config
from photon_ml_tpu.optimize import constraints as jax_constraints
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.data.index_map import IndexMap, feature_key
from photon_ml_tpu_torch.optimize import config, constraints


def _maps():
    keys = [feature_key("age", ""), feature_key("f", "a"), feature_key("f", "b")]
    jkeys = [jax_feature_key("age", ""), jax_feature_key("f", "a"), jax_feature_key("f", "b")]
    assert keys == jkeys
    return (IndexMap.from_feature_names(keys, add_intercept=True),
            JaxIndexMap.from_feature_names(jkeys, add_intercept=True))


VALID = {
    "explicit_feature": [{"name": "age", "term": "", "lowerBound": 0.0, "upperBound": 2.0}],
    "missing_bound_defaults_to_inf": [{"name": "age", "term": "", "lowerBound": 0.0}],
    "term_wildcard": [{"name": "f", "term": "*", "upperBound": 1.0}],
    "all_wildcard_excludes_intercept": [{"name": "*", "term": "*", "lowerBound": -1.0, "upperBound": 1.0}],
    "unknown_feature_resolves_to_nothing": [{"name": "zzz", "term": "", "upperBound": 1.0}],
    "two_features": [{"name": "f", "term": "a", "upperBound": 1.0},
                     {"name": "age", "term": "", "lowerBound": -3.0}],
}

ERRORS = {
    "no_name_or_term": [{"lowerBound": 1}],
    "both_bounds_infinite": [{"name": "age", "term": ""}],
    "lower_not_below_upper": [{"name": "age", "term": "", "lowerBound": 2, "upperBound": 1}],
    "name_wildcard_without_term_wildcard": [{"name": "*", "term": "x", "upperBound": 1}],
    "overlap": [{"name": "f", "term": "a", "upperBound": 1}, {"name": "f", "term": "*", "upperBound": 2}],
    "wildcard_plus_anything_else": [{"name": "f", "term": "a", "upperBound": 1},
                                    {"name": "*", "term": "*", "upperBound": 2}],
    "same_feature_twice": [{"name": "age", "term": "", "upperBound": 1},
                           {"name": "age", "term": "", "upperBound": 2}],
    "not_an_array": {"name": "age", "term": "", "upperBound": 1},
}


@pytest.mark.parametrize("case", sorted(VALID))
def test_constraint_maps_and_bounds_match_jax(case):
    imap, jmap = _maps()
    s = json.dumps(VALID[case])
    ours = constraints.create_constraint_feature_map(s, imap)
    theirs = jax_constraints.create_constraint_feature_map(s, jmap)
    assert ours == theirs
    got, ref = constraints.bounds_arrays(ours, imap.size), jax_constraints.bounds_arrays(theirs, jmap.size)
    if ref is None:
        assert got is None
    else:
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    if case == "all_wildcard_excludes_intercept":
        assert imap.intercept_index not in ours and len(ours) == imap.size - 1
    if case == "missing_bound_defaults_to_inf":
        assert list(ours.values()) == [(0.0, np.inf)]


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_constraint_errors_match_jax(case):
    imap, jmap = _maps()
    s = json.dumps(ERRORS[case])
    with pytest.raises(ValueError) as theirs:
        jax_constraints.create_constraint_feature_map(s, jmap)
    with pytest.raises(type(theirs.value)) as ours:
        constraints.create_constraint_feature_map(s, imap)
    assert str(ours.value) == str(theirs.value)


def test_empty_strings_and_maps():
    imap, _ = _maps()
    assert constraints.create_constraint_feature_map(None, imap) is None
    assert constraints.create_constraint_feature_map("", imap) is None
    assert constraints.bounds_arrays(None, 4) is None


def test_distinct_box_constraints_do_not_collide_in_the_static_key():
    """Two configs differing only in one elided bound get different keys,
    and the keys are the JAX package's."""
    d = 2000
    lo = np.full(d, -np.inf, np.float32)
    up1 = np.full(d, np.inf, np.float32)
    up2 = up1.copy()
    up2[d // 2] = 3.0
    c1 = config.CoordinateOptimizationConfig(optimizer=config.OptimizerConfig(box_constraints=(lo, up1)))
    c2 = config.CoordinateOptimizationConfig(optimizer=config.OptimizerConfig(box_constraints=(lo, up2)))
    c3 = config.CoordinateOptimizationConfig(
        optimizer=config.OptimizerConfig(box_constraints=(lo.copy(), up1.copy())))
    assert repr(c1) == repr(c2)
    assert config.static_config_key(c1) != config.static_config_key(c2)
    assert config.static_config_key(c1) == config.static_config_key(c3)
    j1 = jax_config.CoordinateOptimizationConfig(
        optimizer=jax_config.OptimizerConfig(box_constraints=(lo, up1)))
    assert repr(config.static_config_key(c1)) == repr(jax_config.static_config_key(j1))


def test_constrained_training_through_the_train_driver(tmp_path):
    """constraints.file in the coordinate DSL: the port's model respects the
    box (which binds) and matches the JAX driver's."""
    from photon_ml_tpu.cli import train as jax_train_cli
    from photon_ml_tpu.io.avro_data import write_training_examples
    from photon_ml_tpu_torch.cli import train as train_cli
    from photon_ml_tpu_torch.io import model_store

    rng = np.random.default_rng(0)
    X = rng.normal(size=(300, 4))
    w_true = np.random.default_rng(99).normal(size=4)
    y = (rng.uniform(size=300) < 1 / (1 + np.exp(-(X @ w_true)))).astype(np.float32)
    train_avro = str(tmp_path / "train.avro")
    write_training_examples(train_avro, [[(f"f{j}", float(X[i, j])) for j in range(4)] for i in range(300)],
                            y.tolist())
    cfile = tmp_path / "constraints.json"
    cfile.write_text(json.dumps([{"name": "f0", "term": "", "lowerBound": -0.05, "upperBound": 0.05},
                                 {"name": "f1", "term": "", "lowerBound": 0.0}]))

    def args(out, with_box=True):
        coord = ("name=global,feature.shard=globalShard,optimizer=LBFGS,tolerance=1e-7,max.iter=40,"
                 "regularization=L2,reg.weights=0.01")
        return ["--training-task", "LOGISTIC_REGRESSION", "--input-data-directories", train_avro,
                "--root-output-directory", str(out), "--feature-shard-configurations",
                "name=globalShard,feature.bags=features,intercept=true", "--coordinate-configurations",
                coord + (f",constraints.file={cfile}" if with_box else "")]

    train_cli.main(args(tmp_path / "port") + ["--device", "cpu"])
    jax_train_cli.main(args(tmp_path / "jax"))
    train_cli.main(args(tmp_path / "free", with_box=False) + ["--device", "cpu"])
    best = tmp_path / "port" / "models" / "best"
    imap = IndexMap.load(str(best / "feature-indexes" / "globalShard.json"))
    load = lambda k: model_store.load_game_model(str(tmp_path / k / "models" / "best"),
                                                 {"globalShard": imap}).coordinates["global"].means
    w, wj, free = load("port"), load("jax"), load("free")
    i0, i1 = imap.get_index("f0"), imap.get_index("f1")
    assert np.float32(-0.05) <= w[i0] <= np.float32(0.05) and w[i1] >= 0.0  # exactly, in f32
    assert abs(free[i0]) > 0.05  # the bound binds
    assert np.abs(w - wj).max() <= PORT_TOLERANCES["estimator"]["coef_atol"]


def test_constraints_refuse_normalization_and_a_projected_random_effect(tmp_path):
    from photon_ml_tpu_torch.cli import train as train_cli
    from photon_ml_tpu_torch.io.avro_data import write_training_examples

    train_avro = str(tmp_path / "train.avro")
    write_training_examples(train_avro, [[("f0", 1.0)], [("f0", -1.0)]], [1.0, 0.0],
                            id_tags={"memberId": ["a", "b"]})
    cfile = tmp_path / "c.json"
    cfile.write_text(json.dumps([{"name": "*", "term": "*", "upperBound": 1.0}]))
    base = ["--training-task", "LOGISTIC_REGRESSION", "--input-data-directories", train_avro,
            "--root-output-directory", str(tmp_path / "out"), "--feature-shard-configurations",
            "name=s,feature.bags=features,intercept=true", "--device", "cpu"]
    with pytest.raises(ValueError, match="cannot combine with --normalization"):
        train_cli.main(base + ["--normalization", "STANDARDIZATION", "--coordinate-configurations",
                               f"name=g,feature.shard=s,regularization=L2,reg.weights=1,constraints.file={cfile}"])
    with pytest.raises(ValueError, match="require the IDENTITY projector"):
        train_cli.main(base + ["--coordinate-configurations",
                               "name=r,random.effect.type=memberId,feature.shard=s,regularization=L2,"
                               f"reg.weights=1,constraints.file={cfile}"])
    assert not os.path.exists(tmp_path / "out" / "models")
