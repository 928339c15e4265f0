// The rank-ordered add of the exact cross-rank sum, for Hopper (sm_90a).
//
// Part of the port of kernel #3, photon_ml_tpu/ops/pallas_glm.py:705
// sharded_value_gradient_sums and :746 sharded_hessian_vector_sums, whose
// per-device raw sums are psum-med under shard_map. The port gathers every
// rank's float64 sums into a (W, k) buffer (RankMesh.exact_sum,
// photon_ml_tpu_torch/parallel/mesh.py) and adds them here:
//     out[c] = ((rows[0][c] + rows[1][c]) + rows[2][c]) + ... + rows[W-1][c]
// in float64, in rank order, rounded once to the output type (float64 or
// float32). Every rank adds the same gathered bits in the same order, so
// every rank holds the same result.
//
// What bounds it on this card: nothing but its launch. It reads W k 8 bytes
// and writes k 4 or 8 (about 16 KiB for a 514-wide gradient on 4 ranks).
// What the design does about it: one launch in place of a clone, W - 1 adds
// and a cast per part.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libexact_sum.so exact_sum.cu
// Interface: plain C functions below, bound with ctypes in
// photon_ml_tpu_torch/parallel/mesh.py. The launch function returns the
// cudaError_t of its launch (cudaGetLastError) as an int.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename Out>
__global__ void __launch_bounds__(kThreads)
    rank_sum_kernel(const double* __restrict__ rows, int world, long long k, Out* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long c = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; c < k; c += stride) {
    double s = rows[c];
    for (int r = 1; r < world; ++r) s += rows[static_cast<long long>(r) * k + c];
    out[c] = static_cast<Out>(s);
  }
}

}  // namespace

extern "C" {

// rows: (world, k) float64, row-major; out: (k,) float32 (out_f32) or float64.
int exact_rank_sum(const double* rows, int world, long long k, void* out, int out_f32,
                   void* stream) {
  if (world < 1 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (k == 0) return 0;
  long long blocks = (k + kThreads - 1) / kThreads;
  if (blocks > 1024) blocks = 1024;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_f32) {
    rank_sum_kernel<float><<<static_cast<int>(blocks), kThreads, 0, s>>>(rows, world, k,
                                                                         static_cast<float*>(out));
  } else {
    rank_sum_kernel<double><<<static_cast<int>(blocks), kThreads, 0, s>>>(rows, world, k,
                                                                          static_cast<double*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

const char* exact_sum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
