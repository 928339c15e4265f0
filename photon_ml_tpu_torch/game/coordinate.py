"""GAME coordinates: per-coordinate training and scoring.

Port of the single-device path of `photon_ml_tpu/game/coordinate.py`:

  * FixedEffectCoordinate: one GLM solve over the whole sample axis. A CUDA
    float32 design matrix is stored bf16 once (the JAX package's
    PHOTON_DENSE_BF16X default) and that copy is used for both training and
    scoring, so the coordinate-descent residuals stay consistent; the
    objective then runs the fused CUDA kernels on it (half the bytes of X
    per pass). A sparse shard trains and scores on its sparse layout
    (data/sparse_layout.py), built once per dataset and cached there; on
    the card that is the sparse CUDA kernels, with no size or padding gate.
    SIMPLE or FULL coefficient variances are computed after the solve when
    the config asks for them (FULL forms the D x D Hessian over row chunks).
    The optimizer is the config's: L-BFGS, OWLQN (L1, elastic net), with a
    box when the config carries one, or TRON (optimize/problem.py). A
    `down_sampling_rate` below 1 solves on weights down-sampled from the
    generator the caller passes (data/sampling.py); the variances use the
    full weights, as in the reference.
  * RandomEffectCoordinate: the per-bucket loop. Each bucket of entities is
    one batched L-BFGS/TRON call over its (E, S, D) block, warm-started from
    the previous coefficient matrix rows, on the plain batched objective
    (the JAX package runs these vmapped solves on XLA, not on its kernels).
    Over a sparse shard the bucket's (E, S, K) ELL block is made dense on
    the device first (containers.ell_block_to_dense: exact and the same bits
    on every run), and the same dense batched solve runs on it. A Pearson
    feature mask multiplies each lane's features in the gather; a
    per-entity normalization (a projected shard's) gives each lane its own
    (factors, shifts) row; SIMPLE variances are one more batched pass per
    bucket, one lane per entity, and FULL variances a batched Cholesky per
    chunk of lanes.

On a dataset sharded over ranks (parallel/mesh.py), both coordinates take
and return per-row values on this rank's rows. The fixed effect's
coefficients are replicated: its objective sums cross the ranks
(ops/objective.py), and every rank takes the same optimizer steps. A random
effect solves the lanes of the entities this rank owns in its own layout;
the solve has no collective inside. The random effect the rows follow
trains on this rank's rows; any other trains on its row view (the rows of
its owned entities), so `train` first exchanges the residual offsets to
the view and `score` exchanges the view's margins back, one collective
each (`RankMesh.exchange`). Its model is this rank's store, (entities
owned + 1, D), the owned entities' rows and the pinned zero row (the
counterpart of the row-sharded store of the JAX package's
coordinate.py:752-790); `gather_model` assembles the global (E + 1, D)
coefficient and variance matrices, `local_model` cuts a rank's store out of
them (a resume from a checkpoint), and `row_block` moves the store's rows
to the contiguous row block this rank writes into the elastic checkpoint.

The sweep executor (hyperparameter/sweep.py) fits its trials through
`train`/`score` as coordinate descent does; the reference's stacked-trial
hooks have no counterpart here. The `solve` fault site and its retry live
in game/coordinate_descent.py.

Not ported yet: the planner's fusion chunks. A random effect does not
down-sample (the reference's random-effect coordinate takes no sampling
key).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from photon_ml_tpu_torch.data.containers import (
    Features,
    LabeledData,
    SparseFeatures,
    ell_block_to_dense,
)
from photon_ml_tpu_torch.data.game_dataset import (
    GameDataset,
    RandomEffectDataset,
    gather_block_data,
)
from photon_ml_tpu_torch.data.sampling import down_sample_weights, down_sampler_for_task
from photon_ml_tpu_torch.game.model import (
    Coefficients,
    FixedEffectModel,
    RandomEffectModel,
    library_row_sum,
    random_effect_margins,
)
from photon_ml_tpu_torch.ops.losses import PointwiseLoss, loss_for_task
from photon_ml_tpu_torch.ops.normalization import NormalizationContext, PerEntityNormalization
from photon_ml_tpu_torch.optimize import problem
from photon_ml_tpu_torch.optimize.common import OptResult
from photon_ml_tpu_torch.optimize.config import CoordinateOptimizationConfig
from photon_ml_tpu_torch.transformers.game_transformer import fixed_effect_margins
from photon_ml_tpu_torch.types import TaskType, VarianceComputationType

Tensor = torch.Tensor


def _with_weight(config: CoordinateOptimizationConfig,
                 reg_weight: Optional[float]) -> CoordinateOptimizationConfig:
    return config if reg_weight is None else dataclasses.replace(config, reg_weight=reg_weight)


def _norm_on(norm, device):
    return None if norm is None else norm.to(device)


def _with_variances(model: RandomEffectModel) -> Tensor:
    """The coefficient rows, with the variance rows beside them when the
    model has them (so one collective moves both)."""
    if model.variances_matrix is None:
        return model.coefficients_matrix
    return torch.cat([model.coefficients_matrix, model.variances_matrix], 1)


def _split_variances(rows: Tensor, like: RandomEffectModel) -> RandomEffectModel:
    """`_with_variances`'s rows back as a model of `like`'s kind."""
    if like.variances_matrix is None:
        return RandomEffectModel(rows, None, like.task)
    d = like.coefficients_matrix.shape[1]
    return RandomEffectModel(rows[:, :d].contiguous(), rows[:, d:].contiguous(), like.task)


class FixedEffectCoordinate:
    def __init__(
        self,
        dataset: GameDataset,
        config_data_shard: str,
        opt_config: CoordinateOptimizationConfig,
        task: TaskType,
        norm: Optional[NormalizationContext] = None,
    ):
        self.dataset = dataset
        self.shard = config_data_shard
        self.config = opt_config
        self.task = task
        self.loss: PointwiseLoss = loss_for_task(task)
        self.norm = _norm_on(norm, dataset.device)
        feats = dataset.shards[config_data_shard]
        if isinstance(feats, SparseFeatures):
            feats = dataset.sparse_layout(config_data_shard)
        elif feats.is_cuda and feats.dtype == torch.float32:
            key = ("bf16x", config_data_shard)
            if key not in dataset.cache:
                dataset.cache[key] = feats.to(torch.bfloat16)
            feats = dataset.cache[key]
        self._features = feats

    @property
    def training_features(self) -> Features:
        """What training and scoring run on: the dense matrix (its bf16 copy
        on CUDA) or a sparse shard's layout."""
        return self._features

    @property
    def dim(self) -> int:
        return int(self._features.shape[-1])

    def train(
        self,
        offsets: Tensor,
        initial_model: Optional[FixedEffectModel] = None,
        *,
        reg_weight: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[FixedEffectModel, OptResult]:
        """`reg_weight` overrides the config's; `generator` (on the dataset's
        device) draws the down-sample, and is required when the config asks
        for one."""
        ds = self.dataset
        cfg = _with_weight(self.config, reg_weight)
        w0 = (
            initial_model.coefficients.means.to(ds.device)
            if initial_model is not None
            else torch.zeros(self._features.shape[-1], dtype=ds.labels.dtype, device=ds.device)
        )
        data = LabeledData(self._features, ds.labels, offsets, ds.weights, ds.mesh)
        solve_data = data
        if cfg.down_sampling_rate < 1.0:
            if generator is None:
                raise ValueError("down_sampling_rate < 1 needs a generator")
            solve_data = dataclasses.replace(data, weights=down_sample_weights(
                generator, ds.labels, ds.weights, cfg.down_sampling_rate,
                negatives_only=down_sampler_for_task(self.task)))
        res = problem.solve(self.loss, solve_data, cfg, w0, self.norm)
        variances = problem.compute_variances(self.loss, data, cfg, res.coefficients, self.norm)
        return FixedEffectModel(Coefficients(res.coefficients, variances), self.task), res

    def score(self, model: FixedEffectModel) -> Tensor:
        """Raw per-sample margins x.w (no offsets)."""
        return fixed_effect_margins(self._features, model.coefficients.means, self.norm,
                                    library_row_sum)

    def gather_model(self, model: FixedEffectModel) -> FixedEffectModel:
        """The model of all ranks: the replicated coefficients themselves."""
        return model

    def local_model(self, model: FixedEffectModel) -> FixedEffectModel:
        """This rank's model of the model of all ranks: the same coefficients."""
        return model


class RandomEffectCoordinate:
    def __init__(
        self,
        dataset: GameDataset,
        re_dataset: RandomEffectDataset,
        opt_config: CoordinateOptimizationConfig,
        task: TaskType,
        norm: Optional[NormalizationContext] = None,
    ):
        if opt_config.down_sampling_rate < 1.0:
            raise ValueError("down-sampling applies to fixed effects; a random effect trains on "
                             "every active row")
        self.dataset = dataset
        self.re_dataset = re_dataset
        self.config = opt_config
        self.task = task
        self.loss = loss_for_task(task)
        # A NormalizationContext (one for every lane) or, on a projected
        # shard, a PerEntityNormalization (one row per entity).
        self.norm = _norm_on(norm, dataset.device)
        self.dim = dataset.shards[re_dataset.feature_shard].shape[-1]

    @property
    def entity_sharded(self) -> bool:
        """True on ranks: the store holds this rank's entities alone."""
        return self.dataset.mesh is not None

    def _lane_norm(self, entity_rows: Tensor) -> Optional[NormalizationContext]:
        if isinstance(self.norm, PerEntityNormalization):
            return self.norm.rows_context(entity_rows)
        return self.norm

    def train(
        self,
        offsets: Tensor,
        initial_model: Optional[RandomEffectModel] = None,
        *,
        reg_weight: Optional[float] = None,
    ) -> Tuple[RandomEffectModel, dict]:
        """Train every entity bucket; per-entity warm start from the
        previous matrix's rows (on a rank, a model of this rank's store, as
        `train` returns it). `offsets` are per row of the dataset; over a
        row view they are exchanged to it first. `reg_weight` overrides the
        config's."""
        ds, red = self.dataset, self.re_dataset
        rows_ds = ds
        if red.view is not None:
            offsets = ds.mesh.exchange(offsets, red.view.to_view)
            rows_ds = red.view.dataset
        cfg = _with_weight(self.config, reg_weight)
        e_total = red.num_store_rows
        if initial_model is not None:
            matrix = initial_model.coefficients_matrix.to(ds.device).clone()
            if matrix.shape[0] != e_total + 1:
                raise ValueError(f"the initial matrix has {matrix.shape[0]} rows; this "
                                 f"coordinate's store has {e_total} entities and the pinned row")
        else:
            matrix = torch.zeros((e_total + 1, self.dim), dtype=ds.labels.dtype, device=ds.device)
        var_matrix = None
        if cfg.variance_computation != VarianceComputationType.NONE:
            var_matrix = torch.zeros_like(matrix)
        bucket_iters = []
        for blocks in red.buckets:
            block = gather_block_data(rows_ds, red.feature_shard, blocks, offsets, red.feature_mask)
            if isinstance(block.features, SparseFeatures):
                block = dataclasses.replace(block, features=ell_block_to_dense(block.features))
            w0 = matrix[blocks.entity_rows]
            norm = self._lane_norm(blocks.entity_rows)
            res = problem.solve(self.loss, block, cfg, w0, norm, use_kernel=False)
            # Dummy (padding) entities all write the unseen row, re-zeroed below.
            matrix[blocks.entity_rows] = res.coefficients
            if var_matrix is not None:
                var_matrix[blocks.entity_rows] = problem.compute_variances(
                    self.loss, block, cfg, res.coefficients, norm)
            bucket_iters.append(res.iterations)
        matrix[e_total] = 0.0
        if var_matrix is not None:
            var_matrix[e_total] = 0.0
        stats = {
            "buckets": [
                dict(capacity=b.capacity, entities=b.num_entities,
                     mean_iterations=float(its.float().mean()))
                for b, its in zip(red.buckets, bucket_iters)
            ],
            "total_iterations": int(sum(int(its.sum()) for its in bucket_iters)),
        }
        return RandomEffectModel(matrix, var_matrix, self.task), stats

    def gather_model(self, model: RandomEffectModel) -> RandomEffectModel:
        """The model of all ranks: every rank's store rows, coefficients and
        variances, placed at its entities' rows of one (E + 1, D) matrix each
        (each row has one owner, so the assembly is exact; one collective).
        Without a mesh, the model itself."""
        mesh, red = self.dataset.mesh, self.re_dataset
        if mesh is None:
            return model
        rows = _with_variances(model)[:-1]
        placed = mesh.owned_to_global(rows, red.owned_entities, red.num_entities + 1)
        return _split_variances(placed, model)

    def local_model(self, model: RandomEffectModel) -> RandomEffectModel:
        """This rank's store of a model of all ranks ((E + 1, D) matrices,
        as `gather_model` and the checkpoint give them): the rows of the
        entities it owns and the pinned zero row, coefficients and
        variances, on the dataset's device. Without a mesh, the model on
        that device."""
        red, dev = self.re_dataset, self.dataset.device
        if model.coefficients_matrix.shape[0] != red.num_entities + 1:
            raise ValueError(f"the model has {model.coefficients_matrix.shape[0]} rows; this "
                             f"random effect has {red.num_entities} entities and the pinned row")
        var = model.variances_matrix
        if red.owned_entities is None:
            return RandomEffectModel(model.coefficients_matrix.to(dev),
                                     None if var is None else var.to(dev), model.task)
        rows = torch.cat([red.owned_entities.to(dev),
                          torch.tensor([red.num_entities], dtype=torch.int64, device=dev)])
        return RandomEffectModel(model.coefficients_matrix.to(dev)[rows],
                                 None if var is None else var.to(dev)[rows], model.task)

    def row_block(self, model: RandomEffectModel):
        """This rank's block of the model of all ranks, as the elastic
        checkpoint writes it: (block index, block count, first global row,
        coefficient rows, variance rows or None). Every rank's store rows move
        to the rank that writes them in one exchange (a collective, so every
        rank calls it; parallel/mesh.py `RowBlocks`)."""
        blocks = self.dataset.sharding.row_blocks(self.re_dataset.config)
        mesh = self.dataset.mesh
        block = mesh.exchange(_with_variances(model)[:blocks.plan.num_src], blocks.plan)
        placed = _split_variances(block, model)
        return (mesh.rank, mesh.world_size, int(blocks.bounds[mesh.rank]),
                placed.coefficients_matrix, placed.variances_matrix)

    def score(self, model: RandomEffectModel) -> Tensor:
        """Raw per-row margins of the dataset's rows (over a row view,
        computed on the view and exchanged back)."""
        red = self.re_dataset
        rows_ds = self.dataset if red.view is None else red.view.dataset
        margins = random_effect_margins(
            rows_ds.shards[red.feature_shard],
            red.sample_entity_rows,
            model.coefficients_matrix,
            self.norm,
            library_row_sum,
        )
        if red.view is not None:
            margins = self.dataset.mesh.exchange(margins, red.view.from_view)
        return margins
