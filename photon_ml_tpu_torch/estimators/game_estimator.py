"""GameEstimator: fit(data, validation, configurations) -> [GameResult].

Port of `photon_ml_tpu/estimators/game_estimator.py`:

  * checks the coordinate configurations against the update sequence;
  * `prepare` builds every coordinate's training view once and reuses it
    across configurations: a random effect's entity blocks
    (data/game_dataset.py, on the dataset's device), its projected shard
    (game/projector.py; INDEX_MAP by default) and the normalization
    contexts from feature statistics (data/stats.py; a projected random
    effect gets the global context mapped into its entities' slots);
  * builds the validation view and `EvaluationSuite` (the task's default
    evaluator when none is named); validation rows go through the
    training projector, and an unseen entity scores on the pinned row;
  * runs coordinate descent for each configuration, warm-starting each
    from the previous one's model (the first from `initial_model`), with
    locked coordinates scored only;
  * records `fit_timing`: `prepare_s` and `solve_s`, the PREPARE_STAGES
    walls plus `other` (which tile `prepare_s`; every stage's clock stops
    after the device has finished), `re_device_s`, `re_host_s` and
    `re_path` (the assembly runs on the dataset's device, so `re_host_s`
    is 0.0), and `diverged_steps`.

Coordinates are cached by (coordinate, `static_config_key` of the
configuration: everything but its regularization weight, box constraints
by their bytes) and take each configuration's weight at train time, so
configurations that differ only in weights share coordinates.

`checkpoint_dir` checkpoints each configuration's coordinate descent under
`<checkpoint_dir>/config-<i>/` (game/checkpoint.py), as the JAX estimator
does; a rerun of the same fit resumes there.

`sweep_executor` wires the prepared coordinates, the validation scorers
and a shard-group factory (`_sweep_group_builder`: the prepared data cloned
onto one device) into a `hyperparameter.sweep.SweepExecutor`.

Telemetry: `fit` runs under a root `fit` span (utils/telemetry.py), and with
an `event_emitter` (utils/observability.py) it sends `fit_start`, a
`sweep_config` per configuration, coordinate descent's `coordinate_update`
and `checkpoint` events, and `fit_finish` with the best primary metric: the
record `cli.train` journals. `run_profile()` is the last fit's run profile
(`telemetry.write_profile`). `pipeline` (None: PHOTON_PIPELINE, else on
with more than one core) gates coordinate descent's staged checkpoint
write, the port's one host overlap.

The planner: `fit` installs a plan when PHOTON_PLAN / PHOTON_PLAN_PROFILE
ask for one and none is installed (the drivers install theirs earlier, so
the read is planned too), and uninstalls what it installed on every exit
path; `fit_timing["plan"]` and the run profile's `plan` block record the
active plan (inactive without one).

Not ported yet: groups of more than one device (ROADMAP item 9), the
prepare thread pool
(which moves only when host work runs) and the bucketed pack (the port
builds its sparse layouts on the device; the profile's `pack_path` is
"none").
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

import torch

from photon_ml_tpu_torch import planner
from photon_ml_tpu_torch.contracts import PREPARE_STAGES
from photon_ml_tpu_torch.data import sparse_layout
from photon_ml_tpu_torch.data.containers import SparseFeatures
from photon_ml_tpu_torch.data.game_dataset import (
    EntityBlocks,
    FixedEffectDataConfig,
    GameDataset,
    RandomEffectDataConfig,
    RandomEffectDataset,
    build_random_effect_dataset,
)
from photon_ml_tpu_torch.data.stats import summarize
from photon_ml_tpu_torch.evaluation.suite import (
    EvaluationResults,
    EvaluationSuite,
    EvaluatorType,
    better_than,
    default_evaluator_for_task,
)
from photon_ml_tpu_torch.game.coordinate import FixedEffectCoordinate, RandomEffectCoordinate
from photon_ml_tpu_torch.game.coordinate_descent import run_coordinate_descent
from photon_ml_tpu_torch.game.model import GameModel, random_effect_margins
from photon_ml_tpu_torch.game.projector import IndexMapProjector, ProjectedShard, project_shard
from photon_ml_tpu_torch.ops.normalization import (
    NormalizationContext,
    from_feature_stats,
    project_normalization,
)
from photon_ml_tpu_torch.optimize.config import CoordinateOptimizationConfig, static_config_key
from photon_ml_tpu_torch.timing import StageTimes
from photon_ml_tpu_torch.transformers.game_transformer import (
    CoordinateScoringSpec,
    GameTransformer,
    PreparedCoordinateData,
    coordinate_margins,
    fixed_effect_margins,
    prepare_coordinate_data,
)
from photon_ml_tpu_torch.types import NormalizationType, TaskType
from photon_ml_tpu_torch.utils import telemetry
from photon_ml_tpu_torch.utils.knobs import pipeline_enabled
from photon_ml_tpu_torch.utils.observability import (
    CheckpointEvent,
    CoordinateUpdateEvent,
    EventEmitter,
    SweepConfigEvent,
    TrainingFinishEvent,
    TrainingStartEvent,
)

logger = logging.getLogger(__name__)

GameOptimizationConfiguration = Mapping[str, CoordinateOptimizationConfig]


@dataclasses.dataclass
class GameResult:
    """One configuration's (model, configuration, validation) and the best
    model of its coordinate descent."""

    model: GameModel
    config: Dict[str, CoordinateOptimizationConfig]
    evaluation: Optional[EvaluationResults]
    best_model: GameModel
    timing: Dict[str, float]


@dataclasses.dataclass
class _PreparedCoordinate:
    """Training views of one coordinate, reused across configurations."""

    original_shard: str
    shard: str  # the projected shard for a random effect
    norm: Optional[object]  # NormalizationContext or PerEntityNormalization
    re_dataset: Optional[RandomEffectDataset] = None
    projector: Optional[object] = None


class GameEstimator:
    """`coordinate_data_configs` is an ordered mapping coordinate id ->
    FixedEffectDataConfig | RandomEffectDataConfig; its order is the update
    sequence unless `update_sequence` names another."""

    def __init__(
        self,
        task: TaskType,
        coordinate_data_configs: Mapping[str, object],
        *,
        update_sequence: Optional[Sequence[str]] = None,
        coordinate_descent_iterations: int = 1,
        normalization: NormalizationType = NormalizationType.NONE,
        validation_evaluators: Optional[Sequence[EvaluatorType]] = None,
        locked_coordinates: Optional[Set[str]] = None,
        intercept_indices: Optional[Mapping[str, int]] = None,
        seed: int = 0,
        checkpoint_dir: Optional[str] = None,
        pipeline: Optional[bool] = None,
        event_emitter: Optional[EventEmitter] = None,
    ):
        self.task = task
        self.data_configs = dict(coordinate_data_configs)
        self.update_sequence = list(update_sequence or self.data_configs.keys())
        unknown = [c for c in self.update_sequence if c not in self.data_configs]
        if unknown:
            raise ValueError(f"update sequence names unknown coordinates {unknown}")
        missing = [c for c in self.data_configs if c not in self.update_sequence]
        if missing:
            raise ValueError(f"coordinates missing from update sequence {missing}")
        self.cd_iterations = coordinate_descent_iterations
        self.normalization = normalization
        self.validation_evaluators = list(validation_evaluators or [])
        self.locked = set(locked_coordinates or ())
        self.intercept_indices = dict(intercept_indices or {})
        self.seed = seed
        # Each configuration checkpoints under <checkpoint_dir>/config-<i>/.
        self.checkpoint_dir = checkpoint_dir
        # The host overlap: None reads PHOTON_PIPELINE (else on with more
        # than one core); True/False forces. It moves only when a write runs.
        self.pipeline = pipeline
        # The lifecycle bus; None keeps fit() silent.
        self.event_emitter = event_emitter
        # Prepare-stage walls, accumulated over prepare and coordinate builds.
        self.times = StageTimes()
        self._prepared: Optional[Dict[str, _PreparedCoordinate]] = None
        self._prepared_dataset: Optional[GameDataset] = None
        self._coordinate_cache: Dict[Tuple, object] = {}

    # ------------------------------------------------------------------ prep

    def _norm_for_shard(self, dataset: GameDataset, shard: str, *,
                        intercept_shard: Optional[str] = None,
                        projected: bool = False) -> Optional[NormalizationContext]:
        """The context from `shard`'s statistics. `intercept_shard` is the
        original shard, under which intercepts are configured; a RANDOM
        projection mixes the intercept into every dimension, so only the
        factor-only types apply there."""
        if self.normalization == NormalizationType.NONE:
            return None
        intercept = self.intercept_indices.get(intercept_shard or shard)
        if projected:
            if self.normalization == NormalizationType.STANDARDIZATION:
                raise ValueError(
                    "STANDARDIZATION is not supported on randomly-projected shards (the "
                    "intercept column is mixed into every projected dimension); use a "
                    "factor-only normalization type, INDEX_MAP or IDENTITY projection")
            intercept = None
        stats = summarize(dataset.shards[shard], intercept_index=intercept)
        return from_feature_stats(self.normalization, mean=stats.mean, variance=stats.variance,
                                  max_abs=stats.max_abs, intercept_index=intercept)

    def _norm_for_projected_re(self, dataset: GameDataset, original_shard: str, ps: ProjectedShard):
        """INDEX_MAP maps the global context (the original shard's) into
        every entity's slots; a RANDOM projection takes the projected
        shard's own statistics."""
        if self.normalization == NormalizationType.NONE:
            return None
        if isinstance(ps.projector, IndexMapProjector):
            stats = ps.projector.original_stats  # from the projector's own pass
            intercept = self.intercept_indices.get(original_shard)
            global_norm = from_feature_stats(self.normalization, mean=stats.mean,
                                             variance=stats.variance, max_abs=stats.max_abs,
                                             intercept_index=intercept)
            return project_normalization(global_norm, ps.projector.slot_tables)
        return self._norm_for_shard(dataset, ps.shard_name, intercept_shard=original_shard,
                                    projected=True)

    def prepare(self, dataset: GameDataset) -> Dict[str, _PreparedCoordinate]:
        """Every coordinate's training views, built once. An estimator trains
        one dataset: a second one is refused."""
        if self._prepared is not None:
            if dataset is not self._prepared_dataset:
                raise ValueError("This GameEstimator already prepared a different training "
                                 "dataset; create a new estimator per training dataset")
            return self._prepared
        self._prepared_dataset = dataset
        dev = dataset.device
        prepared: Dict[str, _PreparedCoordinate] = {}
        for cid in self.update_sequence:
            cfg = self.data_configs[cid]
            if isinstance(cfg, RandomEffectDataConfig):
                red = build_random_effect_dataset(dataset, cfg, self.times)
                original_shard = cfg.feature_shard
                with self.times.stage("projector", dev):
                    ps = project_shard(dataset, red, cfg.projector_type,
                                       projected_dim=cfg.projected_dim, seed=self.seed,
                                       want_stats=self.normalization != NormalizationType.NONE)
                with self.times.stage("stats", dev):
                    if ps.shard_name != original_shard:
                        norm = self._norm_for_projected_re(dataset, original_shard, ps)
                    else:
                        norm = self._norm_for_shard(dataset, original_shard)
                prepared[cid] = _PreparedCoordinate(original_shard, ps.shard_name, norm, red, ps.projector)
                logger.info("coordinate %s: %d entities, %d active / %d passive samples, "
                            "projected dim %d", cid, red.num_entities, red.num_active_samples,
                            red.num_passive_samples, ps.projector.projected_dim)
            elif isinstance(cfg, FixedEffectDataConfig):
                with self.times.stage("stats", dev):
                    norm = self._norm_for_shard(dataset, cfg.feature_shard)
                prepared[cid] = _PreparedCoordinate(cfg.feature_shard, cfg.feature_shard, norm)
            else:
                raise TypeError(f"unknown data config for {cid}: {type(cfg)}")
        self._prepared = prepared
        return prepared

    # ----------------------------------------------------------- coordinates

    def _coordinate_for(self, dataset: GameDataset, cid: str, prep: _PreparedCoordinate,
                        opt_config: CoordinateOptimizationConfig):
        """The coordinate of (cid, configuration without its weight), built
        once; its construction (a sparse shard's layout, a bf16 copy) is the
        `compile` stage."""
        key = (cid, static_config_key(opt_config))
        coord = self._coordinate_cache.get(key)
        if coord is None:
            with self.times.stage("compile", dataset.device):
                coord = self._new_coordinate(dataset, prep, opt_config)
            self._coordinate_cache[key] = coord
        return coord

    def _new_coordinate(self, dataset: GameDataset, prep: _PreparedCoordinate,
                        opt_config: CoordinateOptimizationConfig):
        """A coordinate over `prep`'s views of `dataset`, its configuration
        without its weight (the weight comes with each train call)."""
        static_cfg = dataclasses.replace(opt_config, reg_weight=0.0)
        if prep.re_dataset is not None:
            return RandomEffectCoordinate(dataset, prep.re_dataset, static_cfg, self.task,
                                          prep.norm)
        return FixedEffectCoordinate(dataset, prep.shard, static_cfg, self.task, prep.norm)

    # ------------------------------------------------------------ validation

    def scoring_specs(self) -> Dict[str, CoordinateScoringSpec]:
        """Scoring metadata of the trained coordinates (GameTransformer's)."""
        if self._prepared is None:
            raise RuntimeError("fit()/prepare() must run first")
        specs = {}
        for cid, prep in self._prepared.items():
            if prep.re_dataset is not None:
                specs[cid] = CoordinateScoringSpec(
                    shard=prep.original_shard,
                    norm=prep.norm,
                    random_effect_type=prep.re_dataset.config.random_effect_type,
                    entity_index=prep.re_dataset.entity_index,
                    projector=prep.projector,
                )
            else:
                specs[cid] = CoordinateScoringSpec(shard=prep.shard, norm=prep.norm)
        return specs

    def training_prepared(self) -> Dict[str, PreparedCoordinateData]:
        """Scoring views of the training dataset from what `prepare` built
        (the projected shards and each random effect's sample rows), so
        scoring it does not project it again."""
        if self._prepared is None:
            raise RuntimeError("fit()/prepare() must run first")
        ds = self._prepared_dataset
        out: Dict[str, PreparedCoordinateData] = {}
        for cid, prep in self._prepared.items():
            if prep.re_dataset is not None:
                out[cid] = PreparedCoordinateData(ds.shards[prep.shard],
                                                  prep.re_dataset.sample_entity_rows)
            else:
                feats = next((coord.training_features for key, coord in self._coordinate_cache.items()
                              if key[0] == cid), None)
                if feats is None:
                    feats = prepare_coordinate_data(CoordinateScoringSpec(prep.shard), ds).features
                out[cid] = PreparedCoordinateData(feats, None)
        return out

    def _validation_suite(self, validation: GameDataset) -> EvaluationSuite:
        evaluators = self.validation_evaluators or [default_evaluator_for_task(self.task)]
        return EvaluationSuite(evaluators, validation.labels, validation.weights,
                               id_tag_values=validation.id_tags)

    # ------------------------------------------------------------------- fit

    def fit(
        self,
        data: GameDataset,
        validation_data: Optional[GameDataset],
        opt_configs: Sequence[GameOptimizationConfiguration],
        *,
        initial_model: Optional[GameModel] = None,
    ) -> List[GameResult]:
        """One GameModel per configuration, each warm-started from the one
        before; `initial_model` starts the first and must hold every locked
        coordinate's model. The fit runs under a root `fit` span and sends
        its lifecycle events to the `event_emitter`."""
        emit = self.event_emitter.send if self.event_emitter is not None else None
        with planner.owned_plan(device=data.device), telemetry.span("fit", num_configs=len(opt_configs)):
            if emit is not None:
                emit(TrainingStartEvent(num_samples=int(data.num_samples)))
            results = self._fit(data, validation_data, opt_configs, initial_model=initial_model)
            if emit is not None:
                best = select_best_result(results)[1].evaluation if results else None
                emit(TrainingFinishEvent(num_configs=len(results), best_metric=(
                    None if best is None else float(best.primary_value))))
            return results

    def _on_cd_event(self, etype: str, **fields) -> None:
        """Coordinate descent's hook, sent on as typed events (a listener's
        failure is isolated by `EventEmitter.send`)."""
        if etype == "coordinate":
            self.event_emitter.send(CoordinateUpdateEvent(**fields))
        elif etype == "checkpoint":
            self.event_emitter.send(CheckpointEvent(**fields))

    def _fit(
        self,
        data: GameDataset,
        validation_data: Optional[GameDataset],
        opt_configs: Sequence[GameOptimizationConfiguration],
        *,
        initial_model: Optional[GameModel] = None,
    ) -> List[GameResult]:
        if not opt_configs:
            raise ValueError("at least one optimization configuration required")
        dev = data.device
        sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
        t0 = time.perf_counter()
        base = dict(self.times.seconds)
        self.times.notes.pop("re_path", None)
        prepared = self.prepare(data)
        for cfgs in opt_configs:
            missing = [c for c in self.update_sequence if c not in cfgs and c not in self.locked]
            if missing:
                raise ValueError(f"optimization config missing coordinates {missing}")
        suite = self._validation_suite(validation_data) if validation_data is not None else None
        specs = self.scoring_specs()
        val_prep = None
        if validation_data is not None:
            with self.times.stage("projector", dev):
                val_prep = {cid: prepare_coordinate_data(specs[cid], validation_data)
                            for cid in self.update_sequence}
        sync()
        self.fit_timing: Dict[str, object] = {"prepare_s": time.perf_counter() - t0, "solve_s": 0.0}

        results: List[GameResult] = []
        prev_model = initial_model
        diverged_steps = 0
        default_cfg = CoordinateOptimizationConfig()
        pipelined = pipeline_enabled(self.pipeline)
        layouts: Set[str] = set()
        for ci, cfgs in enumerate(opt_configs):
            if self.event_emitter is not None:
                self.event_emitter.send(SweepConfigEvent(index=ci, total=len(opt_configs)))
            t_coord = time.perf_counter()
            coordinates = {
                cid: self._coordinate_for(data, cid, prepared[cid], cfgs.get(cid, default_cfg))
                for cid in self.update_sequence
            }
            self.fit_timing["prepare_s"] += time.perf_counter() - t_coord
            layouts.update(_layout_name(c) for c in coordinates.values()
                           if isinstance(getattr(c, "training_features", None),
                                         sparse_layout.SparseLayout))
            t_solve = time.perf_counter()
            validation_scorer = None
            if validation_data is not None:
                def validation_scorer(cid, model):
                    return coordinate_margins(specs[cid], model, val_prep[cid])
            cd = run_coordinate_descent(
                coordinates,
                self.cd_iterations,
                initial_models=prev_model,
                locked_coordinates=self.locked or None,
                validation_scorer=validation_scorer,
                validation_suite=suite,
                validation_offsets=None if validation_data is None else validation_data.offsets,
                reg_weights={cid: cfgs[cid].reg_weight for cid in cfgs},
                seed=self.seed + ci,
                checkpoint_dir=(None if self.checkpoint_dir is None
                                else f"{self.checkpoint_dir}/config-{ci}"),
                prefetch=pipelined,
                on_event=self._on_cd_event if self.event_emitter is not None else None,
            )
            evaluation = None
            if suite is not None:
                evaluation = GameTransformer(cd.model, specs, self.task).evaluate(
                    validation_data, suite, val_prep)
            results.append(GameResult(cd.model, dict(cfgs), evaluation, cd.best_model, cd.timing))
            prev_model = cd.model
            diverged_steps += cd.diverged_steps
            sync()
            self.fit_timing["solve_s"] += time.perf_counter() - t_solve
            logger.info("configuration %d/%d trained%s", ci + 1, len(opt_configs),
                        f": {evaluation.results}" if evaluation else "")
        stages = {k: self.times.get(k) - base.get(k, 0.0) for k in PREPARE_STAGES}
        stages["other"] = max(0.0, self.fit_timing["prepare_s"] - sum(stages.values()))
        self.fit_timing.update(stages)
        self.fit_timing["re_device_s"] = self.times.get("re_device") - base.get("re_device", 0.0)
        self.fit_timing["re_host_s"] = 0.0
        self.fit_timing["re_path"] = self.times.get_note("re_path") or "none"
        self.fit_timing["diverged_steps"] = diverged_steps
        self.fit_timing["plan"] = planner.plan_block()
        self._fit_dispatch = {
            "pipeline": pipelined,
            "layout": (layouts.pop() if len(layouts) == 1 else "mixed") if layouts else "none",
        }
        return results

    # ---------------------------------------------------------- run profile

    def run_profile(self) -> Dict[str, object]:
        """The last fit's run profile, the reference's sections: the
        prepare stages, `prepare_s` and `solve_s`; the dispatch decisions
        (`pack_path` "none", as the port has no bucketed pack; `re_path`;
        `sharding`, one process with each random effect's rows on one
        device; `pipeline`; `layout`, the sparse layout the fit's fixed
        effects trained on, "none" without one); each random effect's
        `[num_entities, capacity]` a bucket; the device topology;
        `fit_timing`; the dataset's ingest timing where it was read from
        files. Write it with `telemetry.write_profile`."""
        if not hasattr(self, "fit_timing"):
            raise RuntimeError("run_profile() needs a completed fit()")
        ft = dict(self.fit_timing)
        stages = {k: round(float(ft[k]), 4) for k in (*PREPARE_STAGES, "other")}
        stages["prepare_s"] = round(float(ft["prepare_s"]), 4)
        stages["solve_s"] = round(float(ft["solve_s"]), 4)
        bucket_shapes: Dict[str, object] = {}
        for cid, prep in (self._prepared or {}).items():
            if prep.re_dataset is not None:
                bucket_shapes[cid] = [[b.num_entities, b.capacity] for b in prep.re_dataset.buckets]
        dispatch = {
            "pack_path": "none",
            "re_path": ft["re_path"],
            "sharding": {
                "entity_sharded": False,
                "axis_size": 1,
                "rows_per_shard": {cid: int(prep.re_dataset.num_entities) + 1
                                   for cid, prep in (self._prepared or {}).items()
                                   if prep.re_dataset is not None},
                "collective_bytes_per_sweep": 0,
                "collective_bytes_total": 0,
            },
            **self._fit_dispatch,
        }
        data = self._prepared_dataset
        profile = telemetry.build_profile(
            "fit", wall_s=float(ft["prepare_s"]) + float(ft["solve_s"]), stages=stages,
            dispatch=dispatch, bucket_shapes=bucket_shapes, fit_timing=ft,
            ingest=dict(getattr(data, "ingest_timing", None) or {}),
            topology=telemetry.device_topology(data.device))
        # The plan rides the profile too (not a contract key: a profile
        # without it still loads).
        profile["plan"] = dict(ft["plan"])
        return profile

    # -------------------------------------------------------------- sweeps

    def sweep_executor(
        self,
        data: GameDataset,
        validation_data: GameDataset,
        base_config: GameOptimizationConfiguration,
        tuned_ids: Optional[Sequence[str]] = None,
        *,
        mode: Optional[str] = None,
        warm_start: bool = True,
        max_stack: Optional[int] = None,
        shard_groups: Optional[int] = None,
        on_event=None,
    ):
        """The batched trial executor for hyperparameter sweeps: this
        estimator's prepared coordinates, validation scorers and shard-group
        builder wired into a `hyperparameter.sweep.SweepExecutor`.

        `base_config` fixes every coordinate's optimizer settings (and the
        reg weight of untuned coordinates); `tuned_ids` (default: every
        coordinate) names the coordinates whose reg weight the candidate
        columns set, in column order. The trial value is the validation
        suite's primary metric of each trial's final model."""
        from photon_ml_tpu_torch.hyperparameter.sweep import SweepExecutor

        if validation_data is None:
            raise ValueError("sweep_executor needs validation data: the trial value is the "
                             "validation suite's primary metric")
        if self.locked:
            raise ValueError("hyperparameter sweeps retrain every coordinate; locked "
                             "coordinates are not supported")
        missing = [c for c in self.update_sequence if c not in base_config]
        if missing:
            raise ValueError(f"base configuration missing coordinates {missing}")
        prepared = self.prepare(data)
        coordinates = {cid: self._coordinate_for(data, cid, prepared[cid], base_config[cid])
                       for cid in self.update_sequence}
        suite = self._validation_suite(validation_data)
        specs = self.scoring_specs()
        with self.times.stage("projector", validation_data.device):
            val_prep = {cid: prepare_coordinate_data(specs[cid], validation_data)
                        for cid in self.update_sequence}
        # Model arrays -> validation margins through the functions the
        # validation path (coordinate_margins) runs.
        trial_scorers = {}
        for cid in self.update_sequence:
            spec, vp = specs[cid], val_prep[cid]
            if spec.is_random_effect:
                def scorer(arrays, _f=vp.features, _r=vp.entity_rows, _n=spec.norm):
                    return random_effect_margins(_f, _r, arrays["m"], _n)
            else:
                def scorer(arrays, _f=vp.features, _n=spec.norm):
                    return fixed_effect_margins(_f, arrays["w"], _n)
            trial_scorers[cid] = scorer
        return SweepExecutor(
            coordinates,
            list(tuned_ids) if tuned_ids is not None else list(self.update_sequence),
            self.cd_iterations,
            task=self.task,
            base_reg_weights={cid: base_config[cid].reg_weight for cid in self.update_sequence},
            validation_suite=suite,
            validation_offsets=validation_data.offsets,
            num_validation_samples=validation_data.num_samples,
            trial_scorers=trial_scorers,
            maximize=better_than(suite.primary, 1.0, 0.0),
            seed=self.seed,
            mode=mode,
            warm_start=warm_start,
            max_stack=max_stack,
            shard_groups=shard_groups,
            group_builder=self._sweep_group_builder(data, base_config),
            on_event=on_event,
        )

    def _sweep_group_builder(self, data: GameDataset, base_config: GameOptimizationConfiguration):
        """Shard-group coordinate factory: `build(devices)` clones the
        prepared dataset, the random effects' buckets and the normalization
        onto a one-device group (each tensor moved to that device by name,
        never to the current device), so a trial's serial fit runs there
        with the same programs. A group of more than one device raises."""

        def build(devices):
            if len(devices) != 1:
                raise NotImplementedError(
                    "shard groups of more than one device (the entity-sharded sweep inside "
                    "a group) are not ported yet (ROADMAP Queue 1 item 9)")
            dev = torch.device(devices[0])
            prepared = self._prepared
            if prepared is None:
                raise RuntimeError("prepare() must run before group builds")
            put = lambda a: None if a is None else a.to(dev)

            def put_feat(f):
                if isinstance(f, SparseFeatures):
                    return dataclasses.replace(f, indices=put(f.indices), values=put(f.values))
                return put(f)

            ds_g = GameDataset(
                shards={name: put_feat(data.shards[name])
                        for name in {p.shard for p in prepared.values()}},
                labels=put(data.labels),
                offsets=put(data.offsets),
                weights=put(data.weights),
                id_tags=data.id_tags,
                tag_codes=data.tag_codes,
            )
            coords = {}
            for cid in self.update_sequence:
                prep = prepared[cid]
                red = prep.re_dataset
                if red is not None:
                    red = dataclasses.replace(
                        red,
                        buckets=[EntityBlocks(put(b.gather), put(b.mask), put(b.entity_rows))
                                 for b in red.buckets],
                        sample_entity_rows=put(red.sample_entity_rows),
                        feature_mask=put(red.feature_mask),
                        owned_entities=put(red.owned_entities),
                    )
                norm = None if prep.norm is None else prep.norm.to(dev)
                prep_g = dataclasses.replace(prep, norm=norm, re_dataset=red)
                coords[cid] = self._new_coordinate(ds_g, prep_g, base_config[cid])
            return coords

        return build


def _layout_name(coordinate) -> str:
    """The sparse layout a fixed effect trains on: its CSR row tiles, with
    the CSC copy where one was built."""
    return "csr_tiles+csc" if coordinate.training_features.has_csc else "csr_tiles"


def select_best_result(results: Sequence[GameResult]) -> Tuple[int, GameResult]:
    """The configuration with the best validation metric; the last one when
    no validation ran."""
    best_i = len(results) - 1
    best: Optional[EvaluationResults] = None
    for i, r in enumerate(results):
        if r.evaluation is not None and r.evaluation.better_than(best):
            best, best_i = r.evaluation, i
    return best_i, results[best_i]
