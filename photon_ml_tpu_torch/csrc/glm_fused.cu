// Fused dense GLM objective kernels for Hopper (sm_90a).
//
// Replaces the two TPU kernels of photon_ml_tpu/ops/pallas_glm.py:
//   * _value_grad_kernel (pallas_glm.py:506, entry value_gradient_sums):
//       z = X w + offset + shift;  value = sum wt * l(z, y);
//       u = wt * l'(z, y);  grad_raw = X^T u;  sum_u = sum u
//   * _hvp_kernel (pallas_glm.py:542, entry hessian_vector_sums):
//       z = X w + offset + shift;  q = X v + v_shift;
//       r = wt * l''(z, y) * q;  hv_raw = X^T r;  sum_r = sum r
// The contract is the raw sums; normalization and L2 are applied by the
// caller (photon_ml_tpu_torch/ops/objective.py), as in the JAX package.
//
// What bounds it on this card: the bytes of X. Each call must read X once,
// n * d * itemsize bytes (1 GiB for 1,048,576 x 512 bf16), against about
// 4 n d (value/gradient) or 6 n d (Hessian-vector) float operations, far
// below the card's operations-per-byte ridge. A width-1 or width-2
// right-hand side is a memory-bound matrix-vector product, not a
// tensor-core GEMM, so the kernels use plain f32 FMAs.
//
// What the design does about it: X is read from device memory exactly once
// per call. A block copies a tile of kTileRows rows (kChunkCols columns at
// a time) into shared memory with cp.async, computes the tile's margins from
// it (one warp per row, warp-shuffle reduction), then u (or r), then the
// tile's share of X^T u from the same resident copy. Rows past n are zero
// in the tile and get u = 0, so they add exact zeros. When d > kChunkCols
// the margins need every column chunk before u is known, so the chunks other
// than the last one are read a second time for the gradient; for
// d <= kChunkCols (the main path's d = 512) there is a single read.
// Blocks run in no order, so each block adds its tiles into its own row of
// a (blocks, d + stats) scratch, and a second small kernel sums the rows in
// a fixed order (in double). No atomics: results are reproducible run to
// run, which the L-BFGS line search and the coordinate-descent residuals
// rely on. bf16 X is read as stored and widened to f32 before each FMA;
// all accumulation is f32 (the TPU kernel's dtype contract).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libglm_fused.so glm_fused.cu
// Interface: plain C functions below, bound with ctypes in
// photon_ml_tpu_torch/ops/glm_kernels.py. Each launch function returns the
// cudaError_t of its launches (cudaGetLastError) as an int.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "glm_losses.cuh"

namespace {

using namespace glm;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 32;
constexpr int kChunkCols = 512;  // multiple of kThreads: column ownership is tid-fixed

enum DType { kF32 = 0, kBF16 = 1 };

// ---- helpers ---------------------------------------------------------------

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T zero_value();
template <>
__device__ __forceinline__ float zero_value<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_value<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

// 16-byte global->shared copy; src_size 0 writes zeros (rows past n).
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  const int src_size = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem_src),
               "r"(src_size)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy rows [row0, row0 + kTileRows) x columns [c0, c0 + cw) of X into the
// tile (row stride kChunkCols). Rows at or past `rows` are zero-filled.
// `vec` (16-byte rows and base) takes the cp.async path; otherwise scalar.
template <typename T>
__device__ __forceinline__ void load_chunk(T* tile, const T* __restrict__ X, int64_t row0,
                                           int rows, int d, int c0, int cw, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int kPer = 16 / sizeof(T);  // elements per 16-byte unit
    const int nu = cw / kPer;             // units per row (cw*sizeof(T) % 16 == 0)
    const int total = kTileRows * nu;
    int r = tid / nu;
    int c = tid - r * nu;
    const int rstep = kThreads / nu;
    const int cstep = kThreads - rstep * nu;
    for (int idx = tid; idx < total; idx += kThreads) {
      const bool ok = r < rows;
      const T* src = ok ? X + (row0 + r) * static_cast<int64_t>(d) + c0 + c * kPer : X;
      cp_async16(tile + r * kChunkCols + c * kPer, src, ok);
      c += cstep;
      r += rstep;
      if (c >= nu) {
        c -= nu;
        ++r;
      }
    }
    cp_async_wait_all();
  } else {
    for (int r = 0; r < kTileRows; ++r) {
      T* dst = tile + r * kChunkCols;
      if (r < rows) {
        const T* src = X + (row0 + r) * static_cast<int64_t>(d) + c0;
        for (int c = tid; c < cw; c += kThreads) dst[c] = src[c];
      } else {
        for (int c = tid; c < cw; c += kThreads) dst[c] = zero_value<T>();
      }
    }
  }
}

template <typename T, bool HVP>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(kTileRows) * kChunkCols * sizeof(T)  // tile
         + (HVP ? 2 : 1) * kChunkCols * sizeof(float)             // w (and v) chunk
         + 3 * kTileRows * sizeof(float);                         // z, q, u/r
}

// ---- the fused kernel --------------------------------------------------------
//
// partial: (gridDim.x, width) with width = d + 2 (value/gradient: grad_raw,
// value, sum_u) or d + 1 (Hessian-vector: hv_raw, sum_r). Column g of a row
// is only ever touched by thread g % kThreads until the final stats write,
// which follows a __syncthreads.
template <typename T, int LOSS, bool HVP>
__global__ void __launch_bounds__(kThreads)
    glm_fused_kernel(const T* __restrict__ X, int64_t n, int d, const float* __restrict__ y,
                     const float* __restrict__ off, const float* __restrict__ wt,
                     const float* __restrict__ w, const float* __restrict__ v,
                     const float* __restrict__ shift, const float* __restrict__ v_shift,
                     float* __restrict__ partial, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  float* w_sh = reinterpret_cast<float*>(smem_raw + sizeof(T) * kTileRows * kChunkCols);
  float* v_sh = w_sh + kChunkCols;  // used only when HVP
  float* z_sh = w_sh + (HVP ? 2 : 1) * kChunkCols;
  float* q_sh = z_sh + kTileRows;
  float* c_sh = q_sh + kTileRows;  // u (value/gradient) or r (Hessian-vector)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int width = d + (HVP ? 1 : 2);
  float* my_partial = partial + static_cast<int64_t>(blockIdx.x) * width;
  for (int c = tid; c < width; c += kThreads) my_partial[c] = 0.0f;

  const float z_shift = *shift;
  const float q_shift = HVP ? *v_shift : 0.0f;
  const int nchunks = (d + kChunkCols - 1) / kChunkCols;
  const bool use_vec = vec != 0;
  float acc_value = 0.0f;  // per row-thread (tid < kTileRows), across tiles
  float acc_coef = 0.0f;

  const int64_t row_step = static_cast<int64_t>(gridDim.x) * kTileRows;
  for (int64_t row0 = static_cast<int64_t>(blockIdx.x) * kTileRows; row0 < n; row0 += row_step) {
    const int rows = static_cast<int>(n - row0 < kTileRows ? n - row0 : kTileRows);
    if (tid < kTileRows) {
      z_sh[tid] = 0.0f;
      q_sh[tid] = 0.0f;
    }
    // Phase A: margins (and q) for the tile's rows, chunk by chunk.
    for (int ch = 0; ch < nchunks; ++ch) {
      const int c0 = ch * kChunkCols;
      const int cw = min(kChunkCols, d - c0);
      __syncthreads();  // every thread is done with the previous tile/chunk
      load_chunk<T>(tile, X, row0, rows, d, c0, cw, use_vec);
      for (int c = tid; c < cw; c += kThreads) {
        w_sh[c] = w[c0 + c];
        if (HVP) v_sh[c] = v[c0 + c];
      }
      __syncthreads();
      for (int r = warp; r < kTileRows; r += kWarps) {
        const T* trow = tile + r * kChunkCols;
        float pz = 0.0f;
        float pq = 0.0f;
        for (int c = lane; c < cw; c += 32) {
          const float x = to_f32(trow[c]);
          pz = fmaf(x, w_sh[c], pz);
          if (HVP) pq = fmaf(x, v_sh[c], pq);
        }
        pz = warp_sum(pz);
        if (HVP) pq = warp_sum(pq);
        if (lane == 0) {
          z_sh[r] += pz;
          if (HVP) q_sh[r] += pq;
        }
      }
    }
    __syncthreads();
    // Per-row coefficient: u = wt l'(z, y) or r = wt l''(z, y) (q + v_shift).
    if (tid < kTileRows) {
      float coef = 0.0f;
      if (tid < rows) {
        const int64_t i = row0 + tid;
        const float z = z_sh[tid] + off[i] + z_shift;
        const float yi = y[i];
        const float wi = wt[i];
        if (HVP) {
          coef = wi * loss_d2<LOSS>(z, yi) * (q_sh[tid] + q_shift);
        } else {
          acc_value += wi * loss_l<LOSS>(z, yi);
          coef = wi * loss_d1<LOSS>(z, yi);
        }
      }
      c_sh[tid] = coef;
      acc_coef += coef;
    }
    __syncthreads();
    // Phase B: the tile's share of X^T coef, from the resident last chunk
    // first; earlier chunks (d > kChunkCols only) are read again.
    for (int ch = nchunks - 1; ch >= 0; --ch) {
      const int c0 = ch * kChunkCols;
      const int cw = min(kChunkCols, d - c0);
      if (ch != nchunks - 1) {
        __syncthreads();
        load_chunk<T>(tile, X, row0, rows, d, c0, cw, use_vec);
        __syncthreads();
      }
      for (int c = tid; c < cw; c += kThreads) {
        float s = 0.0f;
#pragma unroll 8
        for (int r = 0; r < kTileRows; ++r) s = fmaf(to_f32(tile[r * kChunkCols + c]), c_sh[r], s);
        my_partial[c0 + c] += s;
      }
    }
  }
  // Block totals of the per-row sums (threads 0..31 are warp 0).
  __syncthreads();
  if (warp == 0) {
    const float tot_value = warp_sum(acc_value);
    const float tot_coef = warp_sum(acc_coef);
    if (lane == 0) {
      if (HVP) {
        my_partial[d] = tot_coef;
      } else {
        my_partial[d] = tot_value;
        my_partial[d + 1] = tot_coef;
      }
    }
  }
}

// Column sums of the (blocks, width) scratch in a fixed block order.
__global__ void reduce_partials_kernel(const float* __restrict__ partial, int blocks, int width,
                                       float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= width) return;
  double s = 0.0;
  for (int b = 0; b < blocks; ++b) s += partial[static_cast<int64_t>(b) * width + c];
  out[c] = static_cast<float>(s);
}

struct Args {
  const void* X;
  int64_t n;
  int d;
  const float* y;
  const float* off;
  const float* wt;
  const float* w;
  const float* v;
  const float* shift;
  const float* v_shift;
  float* partial;
  int blocks;
  float* out;
  cudaStream_t stream;
};

template <typename T, int LOSS, bool HVP>
struct Fused {
  static int max_resident_blocks(int* out) {
    auto kern = glm_fused_kernel<T, LOSS, HVP>;
    const int smem = static_cast<int>(smem_bytes<T, HVP>());
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
    *out = per_sm * sms;
    return 0;
  }

  static int launch(const Args& a) {
    auto kern = glm_fused_kernel<T, LOSS, HVP>;
    const int smem = static_cast<int>(smem_bytes<T, HVP>());
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const bool vec = (static_cast<int64_t>(a.d) * sizeof(T)) % 16 == 0 &&
                     (reinterpret_cast<uintptr_t>(a.X) % 16) == 0;
    kern<<<a.blocks, kThreads, smem, a.stream>>>(static_cast<const T*>(a.X), a.n, a.d, a.y, a.off,
                                                  a.wt, a.w, a.v, a.shift, a.v_shift, a.partial,
                                                  vec ? 1 : 0);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const int width = a.d + (HVP ? 1 : 2);
    reduce_partials_kernel<<<(width + 255) / 256, 256, 0, a.stream>>>(a.partial, a.blocks, width,
                                                                       a.out);
    return static_cast<int>(cudaGetLastError());
  }
};

// Select the instantiation for (dtype, loss, hvp) and call F<...>::fn.
template <typename T, bool HVP>
int dispatch_loss(int loss, int op, const Args* a, int* out) {
  switch (loss) {
    case kLogistic:
      return op ? Fused<T, kLogistic, HVP>::launch(*a) : Fused<T, kLogistic, HVP>::max_resident_blocks(out);
    case kSquared:
      return op ? Fused<T, kSquared, HVP>::launch(*a) : Fused<T, kSquared, HVP>::max_resident_blocks(out);
    case kPoisson:
      return op ? Fused<T, kPoisson, HVP>::launch(*a) : Fused<T, kPoisson, HVP>::max_resident_blocks(out);
    case kSmoothedHinge:
      return op ? Fused<T, kSmoothedHinge, HVP>::launch(*a)
                : Fused<T, kSmoothedHinge, HVP>::max_resident_blocks(out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch(int dtype, int loss, bool hvp, int op, const Args* a, int* out) {
  if (dtype == kF32) {
    return hvp ? dispatch_loss<float, true>(loss, op, a, out)
               : dispatch_loss<float, false>(loss, op, a, out);
  }
  if (dtype == kBF16) {
    return hvp ? dispatch_loss<__nv_bfloat16, true>(loss, op, a, out)
               : dispatch_loss<__nv_bfloat16, false>(loss, op, a, out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int glm_tile_rows() { return kTileRows; }

// Most blocks of one instantiation that fit on the card at once; the
// wrapper launches min(ceil(n / kTileRows), this) blocks.
int glm_max_blocks(int dtype, int loss, int hvp, int* out) {
  return dispatch(dtype, loss, hvp != 0, 0, nullptr, out);
}

int glm_value_grad(int dtype, int loss, const void* X, long long n, int d, const float* y,
                   const float* off, const float* wt, const float* w, const float* shift,
                   float* partial, int blocks, float* out, void* stream) {
  const Args a{X,     n,       d,      y,   off,  wt, w, nullptr, shift, nullptr,
               partial, blocks, out, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, loss, false, 1, &a, nullptr);
}

int glm_hvp(int dtype, int loss, const void* X, long long n, int d, const float* y,
            const float* off, const float* wt, const float* w, const float* v, const float* shift,
            const float* v_shift, float* partial, int blocks, float* out, void* stream) {
  const Args a{X,     n,       d,      y,   off,  wt, w, v, shift, v_shift,
               partial, blocks, out, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, loss, true, 1, &a, nullptr);
}

const char* glm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
