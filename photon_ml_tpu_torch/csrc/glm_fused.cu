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
// tensor-core GEMM, so the kernels use plain f32 FMAs. At the card's rate a
// 32 KiB tile of X reaches an SM every ~2,260 cycles, so the work an SM
// does on a tile, shared-memory instructions first, must stay under that.
//
// Three routes, chosen from d and the dtype before launch (glm_route):
//
//  * rows (d <= kRowsMaxCols, the main path's d = 512 among them): one
//    persistent block an SM, a producer warp and 8 or 16 consumer warps. X
//    is row-major, so a tile of R consecutive rows is one contiguous span:
//    the producer's lane 0 copies it with one 1-D TMA bulk copy
//    (cp.async.bulk, no tensor map), with the tile's y, offset and weight
//    spans, into a ring of kRowsStages stages of shared memory, each with
//    its own full and empty mbarrier, and refills a stage as soon as every
//    consumer warp has released it. R fills a stage's kStageX bytes (at most
//    kMaxRows rows). Each consumer lane holds its slice of w (and v) in
//    registers for the whole kernel: K 16-byte vectors of a row, vector j =
//    lane + 32 k (columns 8 j .. 8 j + 7 in bf16, 4 j .. 4 j + 3 in f32), so
//    a warp's loads of a row are contiguous. A warp takes a row, reads its
//    slice of it from the stage once as 16-byte vectors into registers,
//    forms the partial z (and q), sums them with the butterfly warp_sum,
//    computes u (or r) in every lane, and adds u x into the lane's gradient
//    registers from the same registers. Each element of X costs one
//    shared-memory load and no shared load of w or v. Rows whose bytes do not
//    start on 16 (d * itemsize % 16 != 0) are read element by element in the
//    same lane order. At the end each block adds its warps' gradient
//    registers in warp order into its row of a (blocks, d + stats) scratch,
//    once.
//  * wide (kRowsMaxCols < d <= kWideMaxCols): the same ring and producer
//    with kWideStages stages of kWideStageX bytes, so a stage holds at
//    least one whole row; a row is read from HBM once. Consumer thread t
//    owns columns t, t + 512, ... and holds their w, v and gradient in
//    registers. The margin pass reads each element once from the stage
//    (the warps' sums added in warp order); the gradient pass reads it
//    again there. Each column has one owner, so no block reduction.
//  * chunked (wider rows): a block copies a tile of kTileRows rows,
//    kChunkCols columns at a time, into shared memory with cp.async,
//    computes the tile's margins chunk by chunk (one warp per row), then u
//    (or r), then the tile's share of X^T u, reading every chunk but the
//    last a second time from device memory; each tile adds into the block's
//    scratch row.
//
// Every route: rows past n are never read; blocks take tiles t = block,
// block + blocks, ... in order, and a second small kernel sums the scratch
// rows in a fixed order (in double). No atomics: two calls on the same
// inputs give the same bits, which the L-BFGS and TRON line searches and
// the coordinate-descent residuals rely on. bf16 X is read as stored and
// widened to f32 before each FMA; all accumulation is f32 (the TPU kernel's
// dtype contract).
//
// The TMA copies read up to 15 bytes before and after the span they need,
// never outside the 16-byte-aligned granules of the tensor's allocation
// (PyTorch allocates in multiples of 512 bytes at 512-byte alignment).
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
#include "tma_ring.cuh"

namespace {

using namespace glm;

enum DType { kF32 = 0, kBF16 = 1 };

struct Args {
  const void* X;
  int64_t n;
  int d;
  int loss;
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

// ---- rows route ----------------------------------------------------------------

constexpr int kRowsMaxCols = 1024;  // widest row a lane's registers take
constexpr int kRowsStages = 6;
constexpr int kStageX = 32768;                // bytes of X rows a stage takes
constexpr int kMaxRows = 128;                 // rows a stage takes
constexpr int kXRegion = kStageX + 32;        // + the cover's <= 15 bytes each side
constexpr int kRowSpan = (kMaxRows + 8) * 4;  // a cover of y, offset or weight
constexpr int kStageBytes = kXRegion + 3 * kRowSpan;
static_assert(kXRegion % 16 == 0 && kRowSpan % 16 == 0, "TMA alignment");

// The rows route's warps and shared memory for K 16-byte vectors a lane:
// barriers (full and empty per stage), then the ring, which the block
// reduction reuses at the end (a warp's gradient row of 32 kCols floats,
// then two stats a warp).
template <typename T, int K>
struct RowsPlan {
  static constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // elements a vector
  static constexpr int kCols = K * kPer;                          // columns a lane holds
  static constexpr int kWarps = kCols <= 16 ? 16 : 8;             // consumer warps
  static constexpr int kThreads = 32 * (kWarps + 1);              // + one producer warp
  static constexpr int kFull = 0;
  static constexpr int kEmpty = 8 * kRowsStages;
  static constexpr int kRing = 128;
  static constexpr int kSmem = kRing + kRowsStages * kStageBytes;
  static constexpr int kPad = 32 * kCols;
  static_assert(kEmpty + 8 * kRowsStages <= kRing, "barriers fit before the ring");
  static_assert((kWarps * kPad + 2 * kWarps) * 4 <= kRowsStages * kStageBytes,
                "the block reduction fits in the ring");
  static_assert(kSmem <= 232448, "does not fit one block");
};

// Rows a stage of the rows route takes for a row of row_bytes.
int rows_tile_rows(int row_bytes) {
  const int r = kStageX / (row_bytes > 0 ? row_bytes : 1);
  return r < kMaxRows ? r : kMaxRows;
}

// Vectors a lane holds for d columns (a power of two), 0 past kRowsMaxCols.
int rows_k(int dtype, int d) {
  if (d > kRowsMaxCols) return 0;
  const int per = dtype == kBF16 ? 8 : 4;
  const int vectors = (d + per - 1) / per;
  int k = 1;
  while (32 * k < vectors) k *= 2;
  return k;
}

// Element e of a 16-byte vector, as f32.
template <typename T>
__device__ __forceinline__ float elem(const uint4& v, int e);
template <>
__device__ __forceinline__ float elem<float>(const uint4& v, int e) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  return __uint_as_float(w[e]);
}
template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& v, int e) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  const uint32_t word = w[e >> 1];
  return __uint_as_float((e & 1) ? (word & 0xffff0000u) : (word << 16));
}

// The lane's K vectors of row r of a stage (xs: the stage's first row),
// zero past column d. vec: rows start on 16 bytes and d fills whole
// vectors, so a vector is one 16-byte load; otherwise element by element.
template <typename T, int K>
__device__ __forceinline__ void load_row(uint4 (&raw)[K], const T* xs, int r, int d, int lane,
                                         bool vec) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  const T* row = xs + r * d;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c0 = (lane + 32 * k) * kPer;
    if (vec) {
      raw[k] = c0 < d ? *reinterpret_cast<const uint4*>(row + c0) : make_uint4(0, 0, 0, 0);
    } else {
      uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        if (c0 + e < d) {
          if constexpr (sizeof(T) == 4) {
            w[e] = reinterpret_cast<const uint32_t*>(row)[c0 + e];
          } else {
            const uint32_t h = reinterpret_cast<const uint16_t*>(row)[c0 + e];
            w[e >> 1] |= (e & 1) ? (h << 16) : h;
          }
        }
      }
      raw[k] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

template <int LOSS, bool HVP>
__device__ __forceinline__ float coef_of(float z, float yi, float wi, float q, float& value) {
  if constexpr (HVP) {
    return wi * loss_d2<LOSS>(z, yi) * q;
  } else {
    value += wi * loss_l<LOSS>(z, yi);
    return wi * loss_d1<LOSS>(z, yi);
  }
}

// A row's u = wt l'(z, y) (adding wt l(z, y) to value), or r = wt l''(z, y) q.
template <bool HVP>
__device__ __forceinline__ float row_coef(int loss, float z, float yi, float wi, float q,
                                          float& value) {
  switch (loss) {
    case kSquared:
      return coef_of<kSquared, HVP>(z, yi, wi, q, value);
    case kPoisson:
      return coef_of<kPoisson, HVP>(z, yi, wi, q, value);
    case kSmoothedHinge:
      return coef_of<kSmoothedHinge, HVP>(z, yi, wi, q, value);
    default:
      return coef_of<kLogistic, HVP>(z, yi, wi, q, value);
  }
}

// partial: (gridDim.x, width) with width = d + 2 (value/gradient: grad_raw,
// value, sum_u) or d + 1 (Hessian-vector: hv_raw, sum_r).
template <typename T, bool HVP, int K>
__global__ void __launch_bounds__(RowsPlan<T, K>::kThreads, 1)
    glm_rows_kernel(const Args a, int tile_rows, int vec) {
  using P = RowsPlan<T, K>;
  constexpr int kPer = P::kPer;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::kFull);
  uint64_t* empty = reinterpret_cast<uint64_t*>(smem + P::kEmpty);
  unsigned char* ring = smem + P::kRing;
  const T* X = static_cast<const T*>(a.X);
  const int d = a.d;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long R = tile_rows;
  const long long n_tiles = (a.n + R - 1) / R;

  if (tid == 0) {
    for (int s = 0; s < kRowsStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], P::kWarps);
    }
    fence_mbarrier_init();
  }
  __syncthreads();

  float acc_value = 0.0f;  // a consumer warp's per-row sums (the same in every lane)
  float acc_coef = 0.0f;
  float g[P::kCols];
  if (warp == P::kWarps) {
    // The producer: tile i of this block goes to stage i % kRowsStages.
    if (lane == 0) {
      int i = 0;
      for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x, ++i) {
        const int s = i % kRowsStages;
        if (i >= kRowsStages) mbar_wait(&empty[s], static_cast<uint32_t>((i / kRowsStages - 1) & 1));
        const long long row0 = t * R;
        const long long row1 = min(row0 + R, static_cast<long long>(a.n));
        unsigned char* st = ring + s * kStageBytes;
        const Cover cx = cover(X, sizeof(T), row0 * d, row1 * d);
        const Cover cy = cover(a.y, 4, row0, row1);
        const Cover co = cover(a.off, 4, row0, row1);
        const Cover cw = cover(a.wt, 4, row0, row1);
        fence_proxy_async();
        mbar_arrive_expect_tx(&full[s], cx.bytes + cy.bytes + co.bytes + cw.bytes);
        bulk_copy(st, cx, &full[s]);
        bulk_copy(st + kXRegion, cy, &full[s]);
        bulk_copy(st + kXRegion + kRowSpan, co, &full[s]);
        bulk_copy(st + kXRegion + 2 * kRowSpan, cw, &full[s]);
      }
    }
  } else {
    // A consumer warp: rows warp, warp + kWarps, ... of each of the block's tiles.
    float wr[P::kCols];
    float vr[HVP ? P::kCols : 1];
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int c = (lane + 32 * k) * kPer + e;
        wr[k * kPer + e] = c < d ? a.w[c] : 0.0f;
        if constexpr (HVP) vr[k * kPer + e] = c < d ? a.v[c] : 0.0f;
        g[k * kPer + e] = 0.0f;
      }
    }
    const float z_shift = *a.shift;
    const float q_shift = HVP ? *a.v_shift : 0.0f;
    int i = 0;
    for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x, ++i) {
      const int s = i % kRowsStages;
      mbar_wait(&full[s], static_cast<uint32_t>((i / kRowsStages) & 1));
      const long long row0 = t * R;
      const int rows = static_cast<int>(min(R, static_cast<long long>(a.n) - row0));
      const unsigned char* st = ring + s * kStageBytes;
      const T* xs = reinterpret_cast<const T*>(st) + cover_skip(X, sizeof(T), row0 * d);
      const float* ys = reinterpret_cast<const float*>(st + kXRegion) + cover_skip(a.y, 4, row0);
      const float* os =
          reinterpret_cast<const float*>(st + kXRegion + kRowSpan) + cover_skip(a.off, 4, row0);
      const float* ws =
          reinterpret_cast<const float*>(st + kXRegion + 2 * kRowSpan) + cover_skip(a.wt, 4, row0);
      for (int r = warp; r < rows; r += P::kWarps) {
        uint4 raw[K];
        load_row<T, K>(raw, xs, r, d, lane, vec != 0);
        float pz = 0.0f;
        float pq = 0.0f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
#pragma unroll
          for (int e = 0; e < kPer; ++e) {
            const float x = elem<T>(raw[k], e);
            pz = fmaf(x, wr[k * kPer + e], pz);
            if constexpr (HVP) pq = fmaf(x, vr[k * kPer + e], pq);
          }
        }
        pz = warp_sum(pz);
        if constexpr (HVP) pq = warp_sum(pq);
        const float z = pz + os[r] + z_shift;
        const float coef = row_coef<HVP>(a.loss, z, ys[r], ws[r], pq + q_shift, acc_value);
        acc_coef += coef;
#pragma unroll
        for (int k = 0; k < K; ++k) {
#pragma unroll
          for (int e = 0; e < kPer; ++e) {
            g[k * kPer + e] = fmaf(elem<T>(raw[k], e), coef, g[k * kPer + e]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
  }

  // Every copy this block started has been waited for: the ring is free.
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);
  float* stats = red + P::kWarps * P::kPad;
  if (warp < P::kWarps) {
    float* mine = red + warp * P::kPad;
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int e = 0; e < kPer; e += 4) {
        const int j = k * kPer + e;
        *reinterpret_cast<float4*>(mine + (lane + 32 * k) * kPer + e) =
            make_float4(g[j], g[j + 1], g[j + 2], g[j + 3]);
      }
    }
    if (lane == 0) {
      stats[warp] = acc_value;
      stats[P::kWarps + warp] = acc_coef;
    }
  }
  __syncthreads();
  const int width = d + (HVP ? 1 : 2);
  float* my_partial = a.partial + static_cast<int64_t>(blockIdx.x) * width;
  for (int c = tid; c < d; c += P::kThreads) {
    float s = red[c];
    for (int w = 1; w < P::kWarps; ++w) s += red[w * P::kPad + c];
    my_partial[c] = s;
  }
  if (tid == 0) {
    float tot_value = stats[0];
    float tot_coef = stats[P::kWarps];
    for (int w = 1; w < P::kWarps; ++w) {
      tot_value += stats[w];
      tot_coef += stats[P::kWarps + w];
    }
    if (HVP) {
      my_partial[d] = tot_coef;
    } else {
      my_partial[d] = tot_value;
      my_partial[d + 1] = tot_coef;
    }
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// ---- wide route ----------------------------------------------------------------

constexpr int kWideMaxCols = 16384;  // widest row whose columns a thread's registers take
constexpr int kWideConsumers = 512;  // consumer threads: column c belongs to thread c % 512
constexpr int kWideWarps = kWideConsumers / 32;
constexpr int kWideStages = 3;
constexpr int kWideStageX = 65536;  // bytes of X rows a stage takes: one f32 row of 16,384
constexpr int kWideMaxRows = 64;
constexpr int kWideXRegion = kWideStageX + 32;
constexpr int kWideRowSpan = (kWideMaxRows + 8) * 4;
constexpr int kWideStageBytes = kWideXRegion + 3 * kWideRowSpan;
static_assert(kWideXRegion % 16 == 0 && kWideRowSpan % 16 == 0, "TMA alignment");

// The wide route's shared memory: barriers, the ring, the warps' partial z
// and q of a tile's rows, the rows' u (or r), and the stats at the end.
struct WidePlan {
  static constexpr int kThreads = kWideConsumers + 32;  // + one producer warp
  static constexpr int kFull = 0;
  static constexpr int kEmpty = 8 * kWideStages;
  static constexpr int kRing = 128;
  static constexpr int kRed = kRing + kWideStages * kWideStageBytes;
  static constexpr int kCoef = kRed + 2 * kWideWarps * kWideMaxRows * 4;
  static constexpr int kStats = kCoef + kWideMaxRows * 4;
  static constexpr int kSmem = kStats + 2 * kWideMaxRows * 4;
  static_assert(kEmpty + 8 * kWideStages <= kRing, "barriers fit before the ring");
  static_assert(kSmem <= 232448, "does not fit one block");
};

// Rows a stage of the wide route takes for a row of row_bytes.
int wide_tile_rows(int row_bytes) {
  const int r = kWideStageX / (row_bytes > 0 ? row_bytes : 1);
  return r < kWideMaxRows ? r : kWideMaxRows;
}

// Columns a consumer thread holds for d columns (a power of two, >= 4), 0
// past kWideMaxCols.
int wide_j(int d) {
  if (d > kWideMaxCols) return 0;
  int j = 4;
  while (kWideConsumers * j < d) j *= 2;
  return j;
}

// Named barrier 1 for the consumer threads alone (the producer warp never
// waits on it).
__device__ __forceinline__ void wide_consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kWideConsumers) : "memory");
}

// The wide route (kRowsMaxCols < d <= kWideMaxCols): the rows route's ring
// and producer, with whole rows resident in a stage; consumer thread t owns
// columns t, t + 512, ... and holds their w, v and gradient in registers
// (J of each). Per tile: every thread adds its columns' products of each
// row, a butterfly sums a warp's and the warps' sums are added in warp
// order (the margin pass: one shared load per element); thread r computes
// row r's u (or r); then every thread adds u x into its columns from the
// same resident rows (the gradient pass: a second shared load). Each
// column has one owner, so the block writes its gradient row with no
// reduction. partial as in glm_rows_kernel.
template <typename T, bool HVP, int J>
__global__ void __launch_bounds__(WidePlan::kThreads, 1)
    glm_wide_kernel(const Args a, int tile_rows) {
  using P = WidePlan;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::kFull);
  uint64_t* empty = reinterpret_cast<uint64_t*>(smem + P::kEmpty);
  unsigned char* ring = smem + P::kRing;
  float* red_z = reinterpret_cast<float*>(smem + P::kRed);
  float* red_q = red_z + kWideWarps * kWideMaxRows;
  float* coef_sh = reinterpret_cast<float*>(smem + P::kCoef);
  float* stats = reinterpret_cast<float*>(smem + P::kStats);
  const T* X = static_cast<const T*>(a.X);
  const int d = a.d;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long R = tile_rows;
  const long long n_tiles = (a.n + R - 1) / R;

  if (tid == 0) {
    for (int s = 0; s < kWideStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWideWarps);
    }
    fence_mbarrier_init();
  }
  __syncthreads();

  if (warp == kWideWarps) {
    if (lane == 0) {
      int i = 0;
      for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x, ++i) {
        const int s = i % kWideStages;
        if (i >= kWideStages) mbar_wait(&empty[s], static_cast<uint32_t>((i / kWideStages - 1) & 1));
        const long long row0 = t * R;
        const long long row1 = min(row0 + R, static_cast<long long>(a.n));
        unsigned char* st = ring + s * kWideStageBytes;
        const Cover cx = cover(X, sizeof(T), row0 * d, row1 * d);
        const Cover cy = cover(a.y, 4, row0, row1);
        const Cover co = cover(a.off, 4, row0, row1);
        const Cover cw = cover(a.wt, 4, row0, row1);
        fence_proxy_async();
        mbar_arrive_expect_tx(&full[s], cx.bytes + cy.bytes + co.bytes + cw.bytes);
        bulk_copy(st, cx, &full[s]);
        bulk_copy(st + kWideXRegion, cy, &full[s]);
        bulk_copy(st + kWideXRegion + kWideRowSpan, co, &full[s]);
        bulk_copy(st + kWideXRegion + 2 * kWideRowSpan, cw, &full[s]);
      }
    }
  } else {
    float wr[J];
    float vr[HVP ? J : 1];
    float g[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = tid + kWideConsumers * j;
      wr[j] = c < d ? a.w[c] : 0.0f;
      if constexpr (HVP) vr[j] = c < d ? a.v[c] : 0.0f;
      g[j] = 0.0f;
    }
    const float z_shift = *a.shift;
    const float q_shift = HVP ? *a.v_shift : 0.0f;
    float acc_value = 0.0f;  // thread r: row r of each tile
    float acc_coef = 0.0f;
    int i = 0;
    for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x, ++i) {
      const int s = i % kWideStages;
      mbar_wait(&full[s], static_cast<uint32_t>((i / kWideStages) & 1));
      const long long row0 = t * R;
      const int rows = static_cast<int>(min(R, static_cast<long long>(a.n) - row0));
      const unsigned char* st = ring + s * kWideStageBytes;
      const T* xs = reinterpret_cast<const T*>(st) + cover_skip(X, sizeof(T), row0 * d);
      for (int r = 0; r < rows; ++r) {
        const T* row = xs + r * d;
        float pz = 0.0f;
        float pq = 0.0f;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int c = tid + kWideConsumers * j;
          if (c < d) {
            const float x = to_f32(row[c]);
            pz = fmaf(x, wr[j], pz);
            if constexpr (HVP) pq = fmaf(x, vr[j], pq);
          }
        }
        pz = warp_sum(pz);
        if constexpr (HVP) pq = warp_sum(pq);
        if (lane == 0) {
          red_z[warp * kWideMaxRows + r] = pz;
          red_q[warp * kWideMaxRows + r] = pq;
        }
      }
      wide_consumer_sync();
      if (tid < rows) {
        float z = red_z[tid];
        float q = red_q[tid];
        for (int w = 1; w < kWideWarps; ++w) {
          z += red_z[w * kWideMaxRows + tid];
          q += red_q[w * kWideMaxRows + tid];
        }
        const float* ys = reinterpret_cast<const float*>(st + kWideXRegion) + cover_skip(a.y, 4, row0);
        const float* os = reinterpret_cast<const float*>(st + kWideXRegion + kWideRowSpan) +
                          cover_skip(a.off, 4, row0);
        const float* ws = reinterpret_cast<const float*>(st + kWideXRegion + 2 * kWideRowSpan) +
                          cover_skip(a.wt, 4, row0);
        const float coef = row_coef<HVP>(a.loss, z + os[tid] + z_shift, ys[tid], ws[tid],
                                         q + q_shift, acc_value);
        acc_coef += coef;
        coef_sh[tid] = coef;
      }
      wide_consumer_sync();
      for (int r = 0; r < rows; ++r) {
        const T* row = xs + r * d;
        const float cr = coef_sh[r];
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int c = tid + kWideConsumers * j;
          if (c < d) g[j] = fmaf(to_f32(row[c]), cr, g[j]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    const int width = d + (HVP ? 1 : 2);
    float* my_partial = a.partial + static_cast<int64_t>(blockIdx.x) * width;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = tid + kWideConsumers * j;
      if (c < d) my_partial[c] = g[j];
    }
    if (tid < kWideMaxRows) {
      stats[tid] = acc_value;
      stats[kWideMaxRows + tid] = acc_coef;
    }
  }
  __syncthreads();
  if (tid == 0) {
    const int width = d + (HVP ? 1 : 2);
    float* my_partial = a.partial + static_cast<int64_t>(blockIdx.x) * width;
    const int m = tile_rows < kWideMaxRows ? tile_rows : kWideMaxRows;
    float tot_value = stats[0];
    float tot_coef = stats[kWideMaxRows];
    for (int r = 1; r < m; ++r) {
      tot_value += stats[r];
      tot_coef += stats[kWideMaxRows + r];
    }
    if (HVP) {
      my_partial[d] = tot_coef;
    } else {
      my_partial[d] = tot_value;
      my_partial[d + 1] = tot_coef;
    }
  }
}

// ---- chunked route -------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 32;
constexpr int kChunkCols = 512;  // multiple of kThreads: column ownership is tid-fixed

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
constexpr size_t chunked_smem_bytes() {
  return static_cast<size_t>(kTileRows) * kChunkCols * sizeof(T)  // tile
         + (HVP ? 2 : 1) * kChunkCols * sizeof(float)             // w (and v) chunk
         + 3 * kTileRows * sizeof(float);                         // z, q, u/r
}

// partial as in glm_rows_kernel. Column g of a row is only ever touched by
// thread g % kThreads until the final stats write, which follows a
// __syncthreads.
template <typename T, int LOSS, bool HVP>
__global__ void __launch_bounds__(kThreads)
    glm_chunked_kernel(const T* __restrict__ X, int64_t n, int d, const float* __restrict__ y,
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
        coef = coef_of<LOSS, HVP>(z, y[i], wt[i], q_sh[tid] + q_shift, acc_value);
      }
      c_sh[tid] = coef;
      acc_coef += coef;
    }
    __syncthreads();
    // Phase B: the tile's share of X^T coef, from the resident last chunk
    // first; earlier chunks are read again.
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

// ---- host side -----------------------------------------------------------------

int blocks_per_card(const void* kern, int threads, int smem, int* out) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
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

int reduce_partials(const Args& a, bool hvp) {
  const int width = a.d + (hvp ? 1 : 2);
  reduce_partials_kernel<<<(width + 255) / 256, 256, 0, a.stream>>>(a.partial, a.blocks, width,
                                                                     a.out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool HVP, int K>
struct Rows {
  using P = RowsPlan<T, K>;
  // op 0: the most blocks that fit on the card at once; op 1: launch.
  static int run(int op, const Args& a, int* out) {
    const void* kern = reinterpret_cast<const void*>(glm_rows_kernel<T, HVP, K>);
    if (op == 0) return blocks_per_card(kern, P::kThreads, P::kSmem, out);
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int row_bytes = a.d * static_cast<int>(sizeof(T));
    const bool vec = row_bytes % 16 == 0 && (reinterpret_cast<uintptr_t>(a.X) % 16) == 0;
    glm_rows_kernel<T, HVP, K><<<a.blocks, P::kThreads, P::kSmem, a.stream>>>(
        a, rows_tile_rows(row_bytes), vec ? 1 : 0);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    return reduce_partials(a, HVP);
  }
};

template <typename T, int LOSS, bool HVP>
struct Chunked {
  static int run(int op, const Args& a, int* out) {
    auto kern = glm_chunked_kernel<T, LOSS, HVP>;
    const int smem = static_cast<int>(chunked_smem_bytes<T, HVP>());
    if (op == 0) return blocks_per_card(reinterpret_cast<const void*>(kern), kThreads, smem, out);
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const bool vec = (static_cast<int64_t>(a.d) * sizeof(T)) % 16 == 0 &&
                     (reinterpret_cast<uintptr_t>(a.X) % 16) == 0;
    kern<<<a.blocks, kThreads, smem, a.stream>>>(static_cast<const T*>(a.X), a.n, a.d, a.y, a.off,
                                                  a.wt, a.w, a.v, a.shift, a.v_shift, a.partial,
                                                  vec ? 1 : 0);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    return reduce_partials(a, HVP);
  }
};

template <typename T, bool HVP, int J>
struct Wide {
  static int run(int op, const Args& a, int* out) {
    const void* kern = reinterpret_cast<const void*>(glm_wide_kernel<T, HVP, J>);
    if (op == 0) return blocks_per_card(kern, WidePlan::kThreads, WidePlan::kSmem, out);
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, WidePlan::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    glm_wide_kernel<T, HVP, J><<<a.blocks, WidePlan::kThreads, WidePlan::kSmem, a.stream>>>(
        a, wide_tile_rows(a.d * static_cast<int>(sizeof(T))));
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    return reduce_partials(a, HVP);
  }
};

template <typename T, bool HVP>
int dispatch_wide(int op, const Args& a, int* out) {
  switch (wide_j(a.d)) {
    case 4:
      return Wide<T, HVP, 4>::run(op, a, out);
    case 8:
      return Wide<T, HVP, 8>::run(op, a, out);
    case 16:
      return Wide<T, HVP, 16>::run(op, a, out);
    case 32:
      return Wide<T, HVP, 32>::run(op, a, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, bool HVP>
int dispatch_rows(int k, int op, const Args& a, int* out) {
  switch (k) {
    case 1:
      return Rows<T, HVP, 1>::run(op, a, out);
    case 2:
      return Rows<T, HVP, 2>::run(op, a, out);
    case 4:
      return Rows<T, HVP, 4>::run(op, a, out);
    case 8:
      if constexpr (sizeof(T) == 4) return Rows<T, HVP, 8>::run(op, a, out);
      break;
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, bool HVP>
int dispatch_chunked(int op, const Args& a, int* out) {
  switch (a.loss) {
    case kLogistic:
      return Chunked<T, kLogistic, HVP>::run(op, a, out);
    case kSquared:
      return Chunked<T, kSquared, HVP>::run(op, a, out);
    case kPoisson:
      return Chunked<T, kPoisson, HVP>::run(op, a, out);
    case kSmoothedHinge:
      return Chunked<T, kSmoothedHinge, HVP>::run(op, a, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

enum Route { kChunked = 0, kRows = 1, kWide = 2 };

Route route_of(int dtype, int d) {
  if (rows_k(dtype, d)) return kRows;
  return wide_j(d) ? kWide : kChunked;
}

// The route for (dtype, d) and, op 0, its most blocks on the card, or, op 1,
// its launch with a.
template <typename T, bool HVP>
int dispatch_route(int dtype, int op, const Args& a, int* out) {
  if (a.loss < kLogistic || a.loss > kSmoothedHinge) return static_cast<int>(cudaErrorInvalidValue);
  switch (route_of(dtype, a.d)) {
    case kRows:
      return dispatch_rows<T, HVP>(rows_k(dtype, a.d), op, a, out);
    case kWide:
      return dispatch_wide<T, HVP>(op, a, out);
    default:
      return dispatch_chunked<T, HVP>(op, a, out);
  }
}

int dispatch(int dtype, bool hvp, int op, const Args& a, int* out) {
  if (dtype == kF32) {
    return hvp ? dispatch_route<float, true>(dtype, op, a, out)
               : dispatch_route<float, false>(dtype, op, a, out);
  }
  if (dtype == kBF16) {
    return hvp ? dispatch_route<__nv_bfloat16, true>(dtype, op, a, out)
               : dispatch_route<__nv_bfloat16, false>(dtype, op, a, out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// The route for (dtype, d): 1 rows, 2 wide, 0 chunked.
int glm_route(int dtype, int d) { return route_of(dtype, d); }

// Rows a block's tile takes: the wrapper launches min(ceil(n / this),
// glm_max_blocks) blocks.
int glm_tile_rows(int dtype, int d) {
  const int row_bytes = d * (dtype == kBF16 ? 2 : 4);
  switch (route_of(dtype, d)) {
    case kRows:
      return rows_tile_rows(row_bytes);
    case kWide:
      return wide_tile_rows(row_bytes);
    default:
      return kTileRows;
  }
}

// Most blocks of the (dtype, loss, hvp, d) launch that fit on the card at once.
int glm_max_blocks(int dtype, int loss, int hvp, int d, int* out) {
  Args a{};
  a.d = d;
  a.loss = loss;
  return dispatch(dtype, hvp != 0, 0, a, out);
}

int glm_value_grad(int dtype, int loss, const void* X, long long n, int d, const float* y,
                   const float* off, const float* wt, const float* w, const float* shift,
                   float* partial, int blocks, float* out, void* stream) {
  const Args a{X,       n,       d,      loss, y,   off, wt, w, nullptr, shift, nullptr,
               partial, blocks, out,    static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, false, 1, a, nullptr);
}

int glm_hvp(int dtype, int loss, const void* X, long long n, int d, const float* y,
            const float* off, const float* wt, const float* w, const float* v, const float* shift,
            const float* v_shift, float* partial, int blocks, float* out, void* stream) {
  const Args a{X,       n,       d,      loss, y,   off, wt, w, v, shift, v_shift,
               partial, blocks, out,    static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, true, 1, a, nullptr);
}

const char* glm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
