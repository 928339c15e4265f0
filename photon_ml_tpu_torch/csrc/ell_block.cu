// The transpose products of a random effect's batched ELL block, per lane,
// in a fixed order, for Hopper (sm_90a).
//
// Port only: the reference has no TPU kernel here. It solves a random effect
// on its (E, S, K) ELL block with SparseFeatures.rmatvec and .sq_rmatvec
// (photon_ml_tpu/data/containers.py:73 and :97), vmapped per lane, which
// XLA runs as a scatter-add. This kernel computes, for every lane e and
// feature f of a block of `dim` features,
//     out[e * dim + f] = sum of values[e, s, k] * u[e, s]      (square = 0)
//                     or values[e, s, k]^2 * u[e, s]          (square = 1)
// over the entries (s, k) of lane e with indices[e, s, k] == f, added in
// (k, s) order from +0, the order of the reference's scatter over its
// (E, K, S) blocks. Each product is rounded once (no fused multiply-add),
// so the result has the bits of the plain version on the CPU (scatter_add_
// one ELL position at a time, photon_ml_tpu_torch/ops/ell_kernels.py) on
// the same inputs, on every run. Scatter-add with float atomics would add in another order on
// every run.
//
// The entries come sorted by (lane, feature), once per block, by
// photon_ml_tpu_torch/data/containers.py `ell_transpose_plan`: `order` holds
// the flat positions (e * S + s) * K + k of the entries in that order (a
// stable sort from (e, k, s) order, so (k, s) order within a run of one
// (lane, feature)),
// `run_ptr` the start of each run, `run_out` its output cell e * dim + f.
// The plan leaves out entries that add nothing (zero values, and rows of
// weight 0, whose u is 0), and the block's structure does not change over
// the solve, so every product of the solve reuses it.
//
// What bounds it on this card: the bytes of the entries it reads, a 4-byte
// position, a 4-byte value gathered through it and a 4-byte u gathered per
// row, and the cells it writes. The design is the simple one: one thread a
// run, adding its entries one by one; output cells without a run stay as the
// caller's zeros.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libell_block.so ell_block.cu
// Interface: plain C functions below, bound with ctypes in
// photon_ml_tpu_torch/ops/ell_kernels.py. The launch function returns the
// cudaError_t of its launch (cudaGetLastError) as an int.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T, bool kSquare>
__global__ void __launch_bounds__(kThreads)
    ell_run_sum_kernel(long long runs, const int32_t* __restrict__ order,
                       const int32_t* __restrict__ run_ptr, const int64_t* __restrict__ run_out,
                       const T* __restrict__ values, const T* __restrict__ u, int k,
                       T* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long r = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; r < runs;
       r += stride) {
    const int32_t end = run_ptr[r + 1];
    T acc = T(0);
    for (int32_t i = run_ptr[r]; i < end; ++i) {
      const int32_t j = order[i];
      const T v = values[j];
      const T x = kSquare ? mul_rn(v, v) : v;
      acc = add_rn(acc, mul_rn(x, u[j / k]));
    }
    out[run_out[r]] = acc;
  }
}

template <typename T>
void launch(int square, long long runs, const int32_t* order, const int32_t* run_ptr,
            const int64_t* run_out, const void* values, const void* u, int k, void* out,
            cudaStream_t s) {
  long long blocks = (runs + kThreads - 1) / kThreads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  const T* v = static_cast<const T*>(values);
  const T* uu = static_cast<const T*>(u);
  T* o = static_cast<T*>(out);
  if (square) {
    ell_run_sum_kernel<T, true><<<static_cast<int>(blocks), kThreads, 0, s>>>(
        runs, order, run_ptr, run_out, v, uu, k, o);
  } else {
    ell_run_sum_kernel<T, false><<<static_cast<int>(blocks), kThreads, 0, s>>>(
        runs, order, run_ptr, run_out, v, uu, k, o);
  }
}

}  // namespace

extern "C" {

// order: (nnz,) int32 flat entry positions; run_ptr: (runs + 1,) int32;
// run_out: (runs,) int64 output cells; values: the block's (E * S * K,)
// values; u: (E * S,); out: (E * dim,), zeroed by the caller. f64 selects
// double for values, u and out (else float).
int ell_rmatvec_runs(int f64, int square, long long runs, const int32_t* order,
                     const int32_t* run_ptr, const int64_t* run_out, const void* values,
                     const void* u, int k, void* out, void* stream) {
  if (runs < 0 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (runs == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64) {
    launch<double>(square, runs, order, run_ptr, run_out, values, u, k, out, s);
  } else {
    launch<float>(square, runs, order, run_ptr, run_out, values, u, k, out, s);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ell_block_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
