// Sparse GLM kernels for Hopper (sm_90a): X w, X^T u and the fused
// value/gradient sums over a sparse fixed-effect design matrix.
//
// Replaces the three TPU kernels of photon_ml_tpu/ops/pallas_sparse.py:
//   * _matvec_kernel  (pallas_sparse.py:216, entry matvec :650):  z = X w
//   * _rmatvec_kernel (pallas_sparse.py:255, entry rmatvec :665): g = X^T u,
//       or (X o X)^T u with square (Hessian diagonals)
//   * _fused_kernel   (pallas_sparse.py:690, entry fused_value_gradient_sums
//       :784): z = X w + offset + shift; value = sum wt l(z, y);
//       u = wt l'(z, y); grad_raw = X^T u; sum_u = sum u
// The contract is the raw sums over all entries; normalization and L2 stay
// with the caller (photon_ml_tpu_torch/ops/objective.py).
//
// Layout (photon_ml_tpu_torch/data/sparse_layout.py): every nonzero entry
// once in row-major CSR (row_ptr, col_idx, row_val) for the forward pass and
// once in column-major CSC (col_ptr, row_idx, col_val) for the backward
// pass; padding is dropped and duplicate (row, col) pairs are summed when the
// layout is built. The CSC entries are cut into chunks of at most
// sparse_layout.CHUNK entries that never straddle a column: chunk k covers
// CSC entries [chunk_start[k], chunk_start[k+1]) and the chunks of column c
// are [chunk_ptr[c], chunk_ptr[c+1]).
//
// What bounds it on this card: the entry bytes. A pass must read each entry
// (a 4-byte index and a 4-byte value) once, nnz * 8 bytes (512 MiB at
// 1,048,576 rows x 64 entries), against 2 float operations per entry, far
// below the card's operations-per-byte ridge. The gathers of w (forward)
// and u (backward) hit a vector of 64 KiB (w, staged in shared memory when
// it fits) or 4 MiB (u, L2-resident), not device memory.
//
// What the design does about it:
//   * forward (matvec, and the fused kernel's first half): one warp per row
//     in a grid-stride loop over rows, lanes striding the row's entries, so
//     each warp's index and value loads are contiguous; a butterfly warp sum
//     gives the row's dot product in a fixed order. When dim <= kSmemWMaxDim
//     each block stages w in shared memory once; wider w is read through the
//     read-only path (__ldg) from L2.
//   * backward (rmatvec, and the fused kernel's second half): one warp per
//     CSC chunk writes the chunk's sum; a second kernel adds each column's
//     chunks in order (in double). A hot column (millions of entries) is
//     many chunks, so no warp stalls on it.
//   * fused: the forward pass writes u (n floats) and each block's partial
//     value and sum of u; the backward pass reads u; a last kernel adds the
//     block partials in a fixed order, in double, as glm_fused.cu does. The
//     entries are read twice per evaluation (once per pass), where the TPU
//     kernel streams them once (pallas_sparse.py:707-714).
// No float atomics anywhere: every sum is taken in an order fixed by the
// layout and the grid, so two calls on the same inputs give bit-identical
// results, which the L-BFGS line search and the coordinate-descent
// residuals rely on. Empty rows and columns give exact zeros.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsparse_glm.so sparse_glm.cu
// Interface: plain C functions below, bound with ctypes in
// photon_ml_tpu_torch/ops/sparse_kernels.py. Each launch function returns
// the cudaError_t of its launches (cudaGetLastError) as an int.

#include <cuda_runtime.h>
#include <stdint.h>

#include "glm_losses.cuh"

namespace {

using namespace glm;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// Widest w staged in shared memory: 96 KiB, two blocks of 512 threads per SM.
constexpr int kSmemWMaxDim = 24576;
// Largest forward grid (the fused kernel's partials are (blocks, 2)).
constexpr int kMaxForwardBlocks = 4096;

// ---- forward: one warp per CSR row -----------------------------------------
//
// FUSED = false: out[row] = x_row . w.
// FUSED = true:  z = x_row . w + off[row] + *shift; out[row] = u =
//   wt l'(z, y); partial[2 b] / [2 b + 1] = block b's sum of wt l(z, y) / u.
template <int LOSS, bool FUSED, bool SMEM_W>
__global__ void __launch_bounds__(kThreads)
    csr_forward_kernel(int64_t n, int dim, const int64_t* __restrict__ row_ptr,
                       const int* __restrict__ col_idx, const float* __restrict__ val,
                       const float* __restrict__ w, const float* __restrict__ y,
                       const float* __restrict__ off, const float* __restrict__ wt,
                       const float* __restrict__ shift, float* __restrict__ out,
                       float* __restrict__ partial) {
  extern __shared__ float w_sh[];
  __shared__ float red[2 * kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if constexpr (SMEM_W) {
    for (int c = threadIdx.x; c < dim; c += kThreads) w_sh[c] = w[c];
    __syncthreads();
  }
  const float z_shift = FUSED ? *shift : 0.0f;
  float acc_value = 0.0f;  // lane 0 of each warp, over the warp's rows
  float acc_u = 0.0f;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + warp; row < n; row += step) {
    const int64_t e = row_ptr[row + 1];
    float p = 0.0f;
    for (int64_t k = row_ptr[row] + lane; k < e; k += 32) {
      const int c = col_idx[k];
      const float wc = SMEM_W ? w_sh[c] : __ldg(w + c);
      p = fmaf(val[k], wc, p);
    }
    p = warp_sum(p);
    if (lane == 0) {
      if constexpr (FUSED) {
        const float z = p + off[row] + z_shift;
        const float yi = y[row];
        const float wi = wt[row];
        const float u = wi * loss_d1<LOSS>(z, yi);
        acc_value += wi * loss_l<LOSS>(z, yi);
        acc_u += u;
        out[row] = u;
      } else {
        out[row] = p;
      }
    }
  }
  if constexpr (FUSED) {
    if (lane == 0) {
      red[2 * warp] = acc_value;
      red[2 * warp + 1] = acc_u;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float s_value = 0.0f;
      float s_u = 0.0f;
      for (int i = 0; i < kWarps; ++i) {
        s_value += red[2 * i];
        s_u += red[2 * i + 1];
      }
      partial[2 * static_cast<int64_t>(blockIdx.x)] = s_value;
      partial[2 * static_cast<int64_t>(blockIdx.x) + 1] = s_u;
    }
  }
}

// ---- backward: one warp per CSC chunk, then the chunks of each column ------

template <bool SQUARE>
__global__ void __launch_bounds__(kThreads)
    csc_chunk_kernel(int64_t n_chunks, const int64_t* __restrict__ chunk_start,
                     const int* __restrict__ row_idx, const float* __restrict__ val,
                     const float* __restrict__ u, float* __restrict__ chunk_sum) {
  const int lane = threadIdx.x & 31;
  const int64_t chunk = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (chunk >= n_chunks) return;  // whole warps leave together
  const int64_t e = chunk_start[chunk + 1];
  float p = 0.0f;
  for (int64_t k = chunk_start[chunk] + lane; k < e; k += 32) {
    float v = val[k];
    if (SQUARE) v *= v;
    p = fmaf(v, __ldg(u + row_idx[k]), p);
  }
  p = warp_sum(p);
  if (lane == 0) chunk_sum[chunk] = p;
}

__global__ void column_sum_kernel(int dim, const int64_t* __restrict__ chunk_ptr,
                                  const float* __restrict__ chunk_sum, float* __restrict__ g) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= dim) return;
  double s = 0.0;
  const int64_t e = chunk_ptr[c + 1];
  for (int64_t k = chunk_ptr[c]; k < e; ++k) s += chunk_sum[k];
  g[c] = static_cast<float>(s);
}

// out[0] = sum of partial[2 b], out[1] = sum of partial[2 b + 1], b in order.
__global__ void stats_sum_kernel(const float* __restrict__ partial, int blocks,
                                 float* __restrict__ out) {
  const int j = threadIdx.x;
  if (j >= 2) return;
  double s = 0.0;
  for (int b = 0; b < blocks; ++b) s += partial[2 * b + j];
  out[j] = static_cast<float>(s);
}

// ---- launch helpers ------------------------------------------------------------

struct Forward {
  int64_t n;
  int dim;
  const int64_t* row_ptr;
  const int* col_idx;
  const float* val;
  const float* w;
  const float* y;
  const float* off;
  const float* wt;
  const float* shift;
  float* out;
  float* partial;
  cudaStream_t stream;
};

// Launches the forward kernel; *blocks receives the grid size.
template <int LOSS, bool FUSED, bool SMEM_W>
int launch_forward(const Forward& a, int* blocks) {
  auto kern = csr_forward_kernel<LOSS, FUSED, SMEM_W>;
  const int smem = SMEM_W ? a.dim * static_cast<int>(sizeof(float)) : 0;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0;
  int sms = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t want = (a.n + kWarps - 1) / kWarps;
  int64_t b = static_cast<int64_t>(per_sm) * sms;
  if (b > kMaxForwardBlocks) b = kMaxForwardBlocks;
  if (b > want) b = want;
  if (b < 1) b = 1;
  *blocks = static_cast<int>(b);
  kern<<<*blocks, kThreads, smem, a.stream>>>(a.n, a.dim, a.row_ptr, a.col_idx, a.val, a.w, a.y,
                                              a.off, a.wt, a.shift, a.out, a.partial);
  return static_cast<int>(cudaGetLastError());
}

template <int LOSS, bool FUSED>
int forward_by_width(const Forward& a, int* blocks) {
  return a.dim <= kSmemWMaxDim ? launch_forward<LOSS, FUSED, true>(a, blocks)
                               : launch_forward<LOSS, FUSED, false>(a, blocks);
}

int fused_forward(int loss, const Forward& a, int* blocks) {
  switch (loss) {
    case kLogistic:
      return forward_by_width<kLogistic, true>(a, blocks);
    case kSquared:
      return forward_by_width<kSquared, true>(a, blocks);
    case kPoisson:
      return forward_by_width<kPoisson, true>(a, blocks);
    case kSmoothedHinge:
      return forward_by_width<kSmoothedHinge, true>(a, blocks);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_backward(bool square, int dim, int64_t n_chunks, const int64_t* chunk_start,
                    const int64_t* chunk_ptr, const int* row_idx, const float* val,
                    const float* u, float* chunk_sum, float* g, cudaStream_t stream) {
  if (n_chunks > 0) {
    const unsigned grid = static_cast<unsigned>((n_chunks + kWarps - 1) / kWarps);
    if (square) {
      csc_chunk_kernel<true><<<grid, kThreads, 0, stream>>>(n_chunks, chunk_start, row_idx, val,
                                                            u, chunk_sum);
    } else {
      csc_chunk_kernel<false><<<grid, kThreads, 0, stream>>>(n_chunks, chunk_start, row_idx,
                                                             val, u, chunk_sum);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (dim > 0) {
    column_sum_kernel<<<(dim + 255) / 256, 256, 0, stream>>>(dim, chunk_ptr, chunk_sum, g);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int sparse_max_forward_blocks() { return kMaxForwardBlocks; }

// z (n) = X w over the CSR copy.
int sparse_matvec(long long n, int dim, const int64_t* row_ptr, const int* col_idx,
                  const float* row_val, const float* w, float* z, void* stream) {
  if (n == 0) return 0;
  const Forward a{static_cast<int64_t>(n), dim, row_ptr, col_idx, row_val, w, nullptr, nullptr,
                  nullptr, nullptr, z, nullptr, static_cast<cudaStream_t>(stream)};
  int blocks = 0;
  return a.dim <= kSmemWMaxDim ? launch_forward<kLogistic, false, true>(a, &blocks)
                               : launch_forward<kLogistic, false, false>(a, &blocks);
}

// g (dim) = X^T u, or (X o X)^T u when square, over the CSC copy;
// chunk_sum is n_chunks floats of scratch.
int sparse_rmatvec(int square, int dim, long long n_chunks, const int64_t* chunk_start,
                   const int64_t* chunk_ptr, const int* row_idx, const float* col_val,
                   const float* u, float* chunk_sum, float* g, void* stream) {
  return launch_backward(square != 0, dim, n_chunks, chunk_start, chunk_ptr, row_idx, col_val, u,
                         chunk_sum, g, static_cast<cudaStream_t>(stream));
}

// out (dim + 2) = [grad_raw, value, sum_u]; u (n), partial
// (2 * sparse_max_forward_blocks()) and chunk_sum (n_chunks) are scratch.
int sparse_fused(int loss, long long n, int dim, const int64_t* row_ptr, const int* col_idx,
                 const float* row_val, const float* w, const float* y, const float* off,
                 const float* wt, const float* shift, float* u, float* partial,
                 long long n_chunks, const int64_t* chunk_start, const int64_t* chunk_ptr,
                 const int* row_idx, const float* col_val, float* chunk_sum, float* out,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int blocks = 0;
  if (n > 0) {
    const Forward a{static_cast<int64_t>(n), dim, row_ptr, col_idx, row_val, w, y, off, wt, shift,
                    u, partial, s};
    const int rc = fused_forward(loss, a, &blocks);
    if (rc != 0) return rc;
  }
  const int rc = launch_backward(false, dim, n_chunks, chunk_start, chunk_ptr, row_idx, col_val,
                                 u, chunk_sum, out, s);
  if (rc != 0) return rc;
  if (blocks == 0) return static_cast<int>(cudaMemsetAsync(out + dim, 0, 2 * sizeof(float), s));
  stats_sum_kernel<<<1, 32, 0, s>>>(partial, blocks, out + dim);
  return static_cast<int>(cudaGetLastError());
}

const char* sparse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
