// The four pointwise GLM losses and a warp sum, shared by the port's CUDA
// sources (glm_fused.cu, sparse_glm.cu). The formulas are the __device__
// copies of photon_ml_tpu_torch/ops/losses.py; LossId matches its LOSS_IDS.
#pragma once

#include <cuda_runtime.h>

namespace glm {

enum LossId { kLogistic = 0, kSquared = 1, kPoisson = 2, kSmoothedHinge = 3 };

__device__ __forceinline__ float softplus_stable(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid_stable(float z) {
  if (z >= 0.0f) {
    return 1.0f / (1.0f + expf(-z));
  }
  const float e = expf(z);
  return e / (1.0f + e);
}

__device__ __forceinline__ float label_sign(float y) { return y > 0.5f ? 1.0f : -1.0f; }

template <int LOSS>
__device__ __forceinline__ float loss_l(float z, float y) {
  if constexpr (LOSS == kLogistic) {
    return softplus_stable(-label_sign(y) * z);
  } else if constexpr (LOSS == kSquared) {
    const float d = z - y;
    return 0.5f * d * d;
  } else if constexpr (LOSS == kPoisson) {
    return expf(z) - y * z;
  } else {
    const float m = label_sign(y) * z;
    if (m <= 0.0f) return 0.5f - m;
    if (m < 1.0f) return 0.5f * (1.0f - m) * (1.0f - m);
    return 0.0f;
  }
}

template <int LOSS>
__device__ __forceinline__ float loss_d1(float z, float y) {
  if constexpr (LOSS == kLogistic) {
    return sigmoid_stable(z) - (y > 0.5f ? 1.0f : 0.0f);
  } else if constexpr (LOSS == kSquared) {
    return z - y;
  } else if constexpr (LOSS == kPoisson) {
    return expf(z) - y;
  } else {
    const float s = label_sign(y);
    const float m = s * z;
    const float dm = m < 0.0f ? -1.0f : (m < 1.0f ? m - 1.0f : 0.0f);
    return s * dm;
  }
}

template <int LOSS>
__device__ __forceinline__ float loss_d2(float z, float y) {
  if constexpr (LOSS == kLogistic) {
    const float s = sigmoid_stable(z);
    return s * (1.0f - s);
  } else if constexpr (LOSS == kSquared) {
    return 1.0f;
  } else if constexpr (LOSS == kPoisson) {
    return expf(z);
  } else {
    const float m = label_sign(y) * z;
    return (m > 0.0f && m < 1.0f) ? 1.0f : 0.0f;
  }
}

// Butterfly sum over the 32 lanes: a fixed order, the same total in every lane.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace glm
