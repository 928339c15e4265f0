"""PyTorch/CUDA port of photon-ml-tpu.

GLMix training from Avro files or arrays (a dense or sparse fixed effect
plus per-entity random effects, by cyclic coordinate descent, through
`estimators.game_estimator.GameEstimator`; Avro ingest in `io/` with a
g++-built native decoder in `native/`; the random effects' layouts and
projections built by torch ops on the card), with the fixed
effect's GLM objective written as hand-made CUDA kernels for Hopper
(`csrc/glm_fused.cu` for dense X, `csrc/sparse_glm.cu` for sparse X). The
layout mirrors
the JAX package `photon_ml_tpu`, which stays the reference and is never
imported from here.
"""

from photon_ml_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
