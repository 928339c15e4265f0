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
// What bounds them on this card: the entry bytes. A pass must read each
// entry (a 4-byte index and a 4-byte value) once, nnz * 8 bytes (511 MiB at
// 1,048,576 rows x 64 entries), against 2 float operations per entry, far
// below the card's operations-per-byte ridge. The gathers of w and u hit a
// vector that fits on chip. Reaching the bytes bound needs ~2-3 MB of loads
// in flight across the card at once, which warps that each walk one row at
// a time do not keep up; and a fused pass must not read the entries twice.
//
// Layout (photon_ml_tpu_torch/data/sparse_layout.py): every nonzero entry
// once in row-major CSR (row_ptr, col_idx, row_val), cut into row tiles of
// at most kTile entries and kTileRows rows (a longer row is a tile of its
// own), with each entry's 16-bit position in its tile's stable sort by
// column (tile_perm) and slabs of tiles of about equal work (slab_tile); and,
// where a two-pass route may need it (dims above a single-stream width),
// once in column-major CSC (col_ptr, row_idx, col_val), cut into chunks of
// at most CHUNK entries that never straddle a column (chunk_start,
// chunk_ptr).
//
// Two routes, chosen by the wrapper from dim alone before launch:
//   * single stream (dim <= Plan<true>::kMaxDim for the fused sums,
//     <= Plan<false>::kMaxDim for X w, <= RmatvecPlan::kMaxDim for X^T u;
//     X^T u is described apart below): one persistent block per slab (one
//     per SM). The block stages w in shared memory once and, for the fused
//     sums, zeroes a private float gradient accumulator there. A producer
//     warp walks the slab's tiles and keeps a ring of tile copies in flight
//     (six stages for X w, three beside the accumulator): each stage is a
//     set of 1-D TMA bulk copies (cp.async.bulk + mbarrier) of the tile's
//     col_idx, row_val, row_ptr and, fused, tile_perm; each copy covers the
//     16-byte-aligned span around the tile's range, and the consumers skip
//     into it. The bytes in flight do not depend on how many warps are
//     resident. Sixteen consumer warps then, per tile: a warp per row (two
//     rows a warp at once) sums the row's entries from shared memory
//     (lane-strided, then a butterfly warp sum: the order of the two-pass
//     route's forward, so z is bit-identical between routes). Fused, the
//     forward also writes each entry (column and local row in one word, and
//     the value) to its place in the tile's column order, a store that no
//     later load waits on, and the stage goes back to the producer. The
//     producer, holding the tile's y, offset and weight in registers (read
//     from device memory a tile ahead), evaluates z, the loss and u of every
//     row, empty rows included (z = offset + shift), while the consumers run
//     the next tile's forward; u stays in shared memory. The consumers'
//     backward runs a tile behind: each thread takes four consecutive column-ordered
//     entries, and the thread holding the first entry of a run of one
//     column sums the run in order (val * u[local row]) and adds it to
//     acc[col] once per tile. Each block writes its accumulator and its
//     value and sum-of-u partials; a last kernel adds the slabs' partials in
//     slab order, in double. The entries are read from device memory once
//     per evaluation, u never leaves shared memory, and no CSC array is
//     read. What is left to bound the fused pass is the consumers' shared-
//     memory work per entry (the w gather, the scatter into column order,
//     the accumulator's read and write), not its 10.3 bytes an entry. A row
//     longer than kTile does not fit a stage: the consumers read it straight
//     from device memory, forward then backward (its columns are distinct,
//     so the backward adds to acc without conflicts); its entries are read
//     twice, the second time mostly from L2.
//     X^T u on the single stream is the fused kernel's backward alone: u is
//     an input, so there is no loss to wait for and no lag. Shared memory
//     holds the gradient accumulator and no w, and each stage carries a
//     fifth copy, the tile's u[r0, r1). Per tile the consumers write each
//     entry's term (val * u, or val * val * u with square) and its column
//     to the entry's place in the tile's column order (a warp per row, two
//     rows a warp at once), meet at one barrier, and sum each run of one
//     column in order into the accumulator, as the fused backward does. The
//     column order is double-buffered, so one thread's scatter of the next
//     tile runs beside another's backward of this one. A row longer than
//     kTile adds its terms straight from device memory, after a barrier.
//     Slabs add in slab order, in double, as above.
//   * two pass (wider dims): the forward is one warp per CSR row in a
//     grid-stride loop, w staged in shared memory when dim <= kSmemWMaxDim
//     and read through the read-only path (__ldg) above; the backward (and
//     X^T u itself) is one warp per CSC chunk writing the chunk's sum, then
//     a kernel adding each column's chunks in order, in double. The fused
//     sums write u (n floats) in the forward and read it in the backward:
//     the entries are read twice, once in each order.
// No float atomics anywhere: every sum is taken in an order fixed by the
// layout and the grid, so two calls on the same inputs give bit-identical
// results, which the L-BFGS line search and the coordinate-descent
// residuals rely on. Empty rows and columns give exact zeros.
//
// The TMA copies read up to 15 bytes before and after the span they need,
// never outside the 16-byte-aligned granules of the tensor's allocation
// (PyTorch allocates in multiples of 512 bytes at 512-byte alignment).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsparse_glm.so sparse_glm.cu
// Interface: plain C functions below, bound with ctypes in
// photon_ml_tpu_torch/ops/sparse_kernels.py. Each launch function returns
// the cudaError_t of its launches (cudaGetLastError) as an int.

#include <cuda_runtime.h>
#include <stdint.h>

#include "glm_losses.cuh"
#include "tma_ring.cuh"

namespace {

using namespace glm;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// Widest w staged in shared memory by the two-pass forward: 96 KiB, two
// blocks of 512 threads per SM.
constexpr int kSmemWMaxDim = 24576;
// Largest two-pass forward grid (the fused kernel's partials are (blocks, 2)).
constexpr int kMaxForwardBlocks = 4096;

// ---- single stream: the tile ring -----------------------------------------------

constexpr int kTile = 2048;     // sparse_layout.TILE
constexpr int kTileRows = 128;  // sparse_layout.TILE_ROWS
constexpr int kSmemOptin = 232448;  // an H100 block's shared memory

// A stage holds the 16-byte-aligned covers of one tile's arrays.
constexpr int kColBytes = (kTile + 8) * 4;         // col_idx or row_val: <= 3 extra each side
constexpr int kRowPtrBytes = (kTileRows + 4) * 8;  // row_ptr[r0 .. r1]
constexpr int kPermBytes = (kTile + 16) * 2;       // tile_perm: <= 7 extra each side
constexpr int kUBytes = (kTileRows + 8) * 4;       // u[r0 .. r1): <= 3 extra each side

// The plan of a single-stream kernel: its warps and its shared memory. Both
// keep w; the fused one keeps the gradient accumulator too, so it has room
// for three stages where the matvec has six. Shared memory: barriers (full
// and empty per stage; fused, z-ready and u-ready per buffer), stage
// headers, reduction scratch, the ring and, fused, two buffers each of a
// tile's entries in column order (8 bytes an entry: column << 8 | local
// row, and the value) and of z, then u, by local row.
template <bool FUSED>
struct Plan {
  static constexpr int kWarps = 16;  // consumer warps
  static constexpr int kConsumers = 32 * kWarps;
  static constexpr int kThreads = kConsumers + 32;  // + one producer warp
  static constexpr int kStages = FUSED ? 3 : 6;
  static constexpr int kCol = 0;
  static constexpr int kVal = kCol + kColBytes;
  static constexpr int kRowPtr = kVal + kColBytes;
  static constexpr int kPerm = kRowPtr + kRowPtrBytes;
  static constexpr int kStageBytes = FUSED ? kPerm + kPermBytes : kPerm;
  static constexpr bool kHasPerm = FUSED;
  static constexpr bool kHasU = false;
  static constexpr int kU = kStageBytes;
  static constexpr int kFull = 0;
  static constexpr int kEmpty = kFull + 8 * kStages;
  static constexpr int kZReady = kEmpty + 8 * kStages;
  static constexpr int kUReady = kZReady + 16;
  static constexpr int kHdr = kUReady + 16;
  static constexpr int kRed = kHdr + 32 * kStages;
  static constexpr int kRing = ((kRed + 4 * 32 + 127) / 128) * 128;
  static constexpr int kSorted = kRing + kStages * kStageBytes;
  static constexpr int kZu = kSorted + (FUSED ? 2 * 8 * kTile : 0);
  static constexpr int kW = kZu + (FUSED ? 2 * 4 * kTileRows : 0);
  static constexpr int kMaxDim = FUSED ? 16384 : 28672;
  static_assert(kStageBytes % 16 == 0 && kRing % 16 == 0 && kW % 16 == 0, "TMA alignment");
  static_assert(kW + (FUSED ? 8 : 4) * kMaxDim <= kSmemOptin, "does not fit one block");
  static int smem_bytes(int dim) { return kW + ((dim + 3) & ~3) * 4 * (FUSED ? 2 : 1); }
};
static_assert(kTileRows <= 256 && kTileRows % 32 == 0,
              "8-bit local rows; a producer lane's rows in registers");
static_assert(kTile < 32768 && kTile % 4 == 0 && kTile <= 4 * Plan<true>::kConsumers,
              "int16 positions; one four-entry chunk a consumer thread");
static_assert(Plan<true>::kMaxDim < (1 << 23), "column << 8 fits an int");

// The plan of the single-stream X^T u: the gradient accumulator and no w;
// each stage also carries the tile's u. Shared memory: barriers (full and
// empty per stage), stage headers, the ring, two buffers of a tile's terms
// in column order (8 bytes an entry: the column and val * u) and the
// accumulator. Its consumers, not the bytes in flight, set its time (three,
// four and six stages ran within a few percent of each other on the card),
// so four stages, which leave the accumulator room for 27,648 columns (the
// largest multiple of 1,024 that fits).
struct RmatvecPlan {
  static constexpr int kWarps = 16;  // consumer warps
  static constexpr int kConsumers = 32 * kWarps;
  static constexpr int kThreads = kConsumers + 32;  // + one producer warp
  static constexpr int kStages = 4;
  static constexpr int kCol = 0;
  static constexpr int kVal = kCol + kColBytes;
  static constexpr int kRowPtr = kVal + kColBytes;
  static constexpr int kPerm = kRowPtr + kRowPtrBytes;
  static constexpr int kU = kPerm + kPermBytes;
  static constexpr int kStageBytes = kU + kUBytes;
  static constexpr bool kHasPerm = true;
  static constexpr bool kHasU = true;
  static constexpr int kFull = 0;
  static constexpr int kEmpty = kFull + 8 * kStages;
  static constexpr int kHdr = kEmpty + 8 * kStages;
  static constexpr int kRing = ((kHdr + 32 * kStages + 127) / 128) * 128;
  static constexpr int kSorted = kRing + kStages * kStageBytes;
  static constexpr int kAcc = kSorted + 2 * 8 * kTile;
  static constexpr int kMaxDim = 27648;
  static_assert(kStageBytes % 16 == 0 && kU % 16 == 0 && kAcc % 16 == 0, "TMA alignment");
  static_assert(kAcc + 4 * kMaxDim <= kSmemOptin, "does not fit one block");
  static_assert(kTile <= 4 * kConsumers, "one four-entry chunk a consumer thread");
  static int smem_bytes(int dim) { return kAcc + ((dim + 3) & ~3) * 4; }
};

struct StreamHeader {
  long long r0, r1, e0, e1;  // the tile's rows [r0, r1) and entries [e0, e1)
};

struct StreamArgs {
  int dim;
  const int64_t* row_ptr;
  const int* col_idx;
  const float* val;
  const int16_t* perm;
  const int64_t* tile_row;
  const int64_t* tile_ptr;
  const int64_t* slab_tile;
  const float* w;
  const float* y;
  const float* off;
  const float* wt;
  const float* shift;
  float* out;    // z (n); fused and X^T u: the slabs' gradient partials (n_slabs, dim)
  float* stats;  // fused: the slabs' (value, sum_u) partials (n_slabs, 2)
  const float* u;  // X^T u: u (n)
};

// Named barriers after the warps part ways: 1 for the N consumer threads
// alone, 2 for the whole block at the end.
template <int N>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void block_sync_end() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(N) : "memory");
}

// The tile bounds of a slab, loaded 32 tiles at a time (a tile a lane) and
// handed out in order; the next 32 are loaded while these are used.
struct TileBounds {
  const StreamArgs& a;
  long long t_end, base, r0, r1, e0, e1, nr0, nr1, ne0, ne1;

  __device__ void load(long long from, long long& lr0, long long& lr1, long long& le0,
                       long long& le1) const {
    const long long t = from + (threadIdx.x & 31);
    lr0 = lr1 = le0 = le1 = 0;
    if (t < t_end) {
      lr0 = a.tile_row[t];
      lr1 = a.tile_row[t + 1];
      le0 = a.tile_ptr[t];
      le1 = a.tile_ptr[t + 1];
    }
  }
  __device__ TileBounds(const StreamArgs& args, long long t_begin, long long end)
      : a(args), t_end(end), base(t_begin) {
    load(base, r0, r1, e0, e1);
    load(base + 32, nr0, nr1, ne0, ne1);
  }
  // Tile t's bounds, for t = t_begin, t_begin + 1, ... in turn (whole warp).
  __device__ StreamHeader get(long long t) {
    if (t >= base + 32) {
      base += 32;
      r0 = nr0, r1 = nr1, e0 = ne0, e1 = ne1;
      load(base + 32, nr0, nr1, ne0, ne1);
    }
    const int j = static_cast<int>(t - base);
    return {__shfl_sync(0xffffffffu, r0, j), __shfl_sync(0xffffffffu, r1, j),
            __shfl_sync(0xffffffffu, e0, j), __shfl_sync(0xffffffffu, e1, j)};
  }
};

// Lane 0 of the producer: writes tile h's header into stage s of plan P and
// starts its copies. A tile longer than kTile gets a header only: the
// consumers read its one row from device memory.
template <class P>
__device__ void fill_stage(const StreamArgs& a, const StreamHeader& h, int s, unsigned char* smem) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::kFull) + s;
  reinterpret_cast<StreamHeader*>(smem + P::kHdr)[s] = h;
  if (h.e1 - h.e0 > kTile) {
    mbar_arrive(full);
    return;
  }
  unsigned char* st = smem + P::kRing + s * P::kStageBytes;
  const Cover c_col = cover(a.col_idx, 4, h.e0, h.e1);
  const Cover c_val = cover(a.val, 4, h.e0, h.e1);
  const Cover c_rp = cover(a.row_ptr, 8, h.r0, h.r1 + 1);
  const Cover c_perm = P::kHasPerm ? cover(a.perm, 2, h.e0, h.e1) : Cover{0, 0};
  const Cover c_u = P::kHasU ? cover(a.u, 4, h.r0, h.r1) : Cover{0, 0};
  // The last reads of this stage were released through its empty barrier;
  // order them before the async writes.
  fence_proxy_async();
  mbar_arrive_expect_tx(full, c_col.bytes + c_val.bytes + c_rp.bytes + c_perm.bytes + c_u.bytes);
  bulk_copy(st + P::kCol, c_col, full);
  bulk_copy(st + P::kVal, c_val, full);
  bulk_copy(st + P::kRowPtr, c_rp, full);
  bulk_copy(st + P::kPerm, c_perm, full);
  bulk_copy(st + P::kU, c_u, full);
}

// The producer warp of a plan without a loss (X w, X^T u): fills the ring,
// then refills each tile's stage with the tile kStages ahead as soon as the
// consumers have read it.
template <class P>
__device__ void ring_producer(const StreamArgs& a, long long t_begin, long long t_end,
                              unsigned char* smem) {
  uint64_t* empty = reinterpret_cast<uint64_t*>(smem + P::kEmpty);
  const int lane = threadIdx.x & 31;
  TileBounds bounds(a, t_begin, t_end);
  const long long n_tiles = t_end - t_begin;
  for (long long k = 0; k < n_tiles && k < P::kStages; ++k) {
    const StreamHeader h = bounds.get(t_begin + k);
    if (lane == 0) fill_stage<P>(a, h, static_cast<int>(k), smem);
  }
  for (long long k = 0; k + P::kStages < n_tiles; ++k) {
    const int s = static_cast<int>(k % P::kStages);
    const StreamHeader next = bounds.get(t_begin + k + P::kStages);
    if (lane == 0) {
      mbar_wait(&empty[s], static_cast<uint32_t>((k / P::kStages) & 1));
      fill_stage<P>(a, next, s, smem);
    }
    __syncwarp();
  }
}

// The producer warp of the fused sums. It fills the ring, then for each
// tile in turn: refills the tile's stage with the tile kStages ahead as
// soon as the consumers have read it; then waits until the consumers have
// the tile's z, evaluates the loss and u of every row of the tile, empty
// rows included, a lane a row, and hands u back; then loads the next tile's
// y, offset and weight into registers, where they arrive while it waits.
// The loss thus runs beside the consumers' next forward, off their path.
// Returns this warp's (value, sum_u) partials in every lane.
template <int LOSS>
__device__ float2 fused_producer(const StreamArgs& a, long long t_begin, long long t_end,
                                 unsigned char* smem) {
  using P = Plan<true>;
  constexpr int kRowsPerLane = kTileRows / 32;
  uint64_t* empty = reinterpret_cast<uint64_t*>(smem + P::kEmpty);
  uint64_t* z_ready = reinterpret_cast<uint64_t*>(smem + P::kZReady);
  uint64_t* u_ready = reinterpret_cast<uint64_t*>(smem + P::kUReady);
  const StreamHeader* hdr = reinterpret_cast<const StreamHeader*>(smem + P::kHdr);
  float* zu0 = reinterpret_cast<float*>(smem + P::kZu);
  const int lane = threadIdx.x & 31;
  const float shift = *a.shift;
  float acc_value = 0.0f;  // lane l: row slots l, l + 32, ... of every tile, in tile order
  float acc_u = 0.0f;
  float y[kRowsPerLane], off[kRowsPerLane], wt[kRowsPerLane];  // this lane's rows of a tile
  auto prefetch = [&](const StreamHeader& h) {
    if (h.e1 - h.e0 > kTile) return;  // a long row's loss is the consumers'
#pragma unroll
    for (int m = 0; m < kRowsPerLane; ++m) {
      const long long r = h.r0 + lane + 32 * m;
      if (r < h.r1) {
        y[m] = __ldg(a.y + r);
        off[m] = __ldg(a.off + r);
        wt[m] = __ldg(a.wt + r);
      }
    }
  };
  TileBounds bounds(a, t_begin, t_end);
  const long long n_tiles = t_end - t_begin;
  for (long long k = 0; k < n_tiles && k < P::kStages; ++k) {
    const StreamHeader h = bounds.get(t_begin + k);
    if (lane == 0) fill_stage<P>(a, h, static_cast<int>(k), smem);
  }
  __syncwarp();  // the headers lane 0 wrote
  if (n_tiles > 0) prefetch(hdr[0]);
  long long nk = 0;  // tiles that went through the buffers
  for (long long k = 0; k < n_tiles; ++k) {
    const int s = static_cast<int>(k % P::kStages);
    const StreamHeader h = hdr[s];
    if (k + P::kStages < n_tiles) {
      const StreamHeader next = bounds.get(t_begin + k + P::kStages);
      if (lane == 0) {
        mbar_wait(&empty[s], static_cast<uint32_t>((k / P::kStages) & 1));
        fill_stage<P>(a, next, s, smem);
      }
      __syncwarp();
    }
    if (h.e1 - h.e0 <= kTile) {
      const int b = static_cast<int>(nk & 1);
      mbar_wait(&z_ready[b], static_cast<uint32_t>((nk >> 1) & 1));
      float* zu = zu0 + b * kTileRows;
      const int R = static_cast<int>(h.r1 - h.r0);
#pragma unroll
      for (int m = 0; m < kRowsPerLane; ++m) {
        const int i = lane + 32 * m;
        if (i < R) {
          const float z = zu[i] + off[m] + shift;
          const float u = wt[m] * loss_d1<LOSS>(z, y[m]);
          acc_value += wt[m] * loss_l<LOSS>(z, y[m]);
          acc_u += u;
          zu[i] = u;
        }
      }
      mbar_arrive(&u_ready[b]);  // every lane, after its own writes of u
      ++nk;
    }
    if (k + 1 < n_tiles) prefetch(hdr[(k + 1) % P::kStages]);
  }
  return make_float2(warp_sum(acc_value), warp_sum(acc_u));
}

// The backward of one tile: its E entries in column order (column << 8 |
// local row, and the value), u by local row; or, with TERMS, (column, the
// entry's term) and no u; four consecutive positions a thread. Each run of
// one column is summed in order by the thread whose chunk holds its first
// entry (reading on past its chunk if the run goes on) and added to acc
// once; a column is one run of the tile, so no two threads add to one
// column. With TERMS each u is 1: a term times 1 is the term, and
// fmaf(term, 1, run) is the rounded run + term.
template <int CONSUMERS, bool TERMS = false>
__device__ __forceinline__ void tile_backward(const int2* sorted, const float* zu, int E,
                                              float* acc, int tid) {
  auto column = [](int key) { return TERMS ? key : key >> 8; };
  auto u_of = [&](int key) { return TERMS ? 1.0f : zu[key & 255]; };
  const int lane = tid & 31;
  const int i0 = 4 * tid;  // kTile <= 4 CONSUMERS: one chunk a thread
  int c[4];
  float v[4];
  float u[4];
  int4 lo = make_int4(0, 0, 0, 0);
  int4 hi = lo;
  if (i0 < E) {
    lo = reinterpret_cast<const int4*>(sorted)[2 * tid];
    hi = reinterpret_cast<const int4*>(sorted)[2 * tid + 1];  // kTile % 4 == 0: in the buffer
  }
  const int key[4] = {lo.x, lo.z, hi.x, hi.z};
  const int bits[4] = {lo.y, lo.w, hi.y, hi.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool in = i0 + j < E;
    c[j] = in ? column(key[j]) : -1;
    v[j] = __int_as_float(bits[j]);
    u[j] = in ? u_of(key[j]) : 0.0f;
  }
  int c_prev = __shfl_up_sync(0xffffffffu, c[3], 1);   // the position before the chunk
  int c_after = __shfl_down_sync(0xffffffffu, c[0], 1);  // the position after it
  if (lane == 0) c_prev = i0 > 0 && i0 - 1 < E ? column(sorted[i0 - 1].x) : -2;
  if (lane == 31) c_after = i0 + 4 < E ? column(sorted[i0 + 4].x) : -3;
  float run = 0.0f;
  int rc = -1;  // the column of the run opened in this chunk, if any
  int prev = c_prev;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (i0 + j < E) {
      if (c[j] != prev) {
        if (rc >= 0) acc[rc] += run;
        rc = c[j];
        run = v[j] * u[j];
      } else if (rc >= 0) {
        run = fmaf(v[j], u[j], run);
      }
      prev = c[j];
    }
  }
  if (rc >= 0) {
    if (c_after == rc) {
      for (int q = i0 + 4; q < E; ++q) {
        const int2 e = sorted[q];
        if (column(e.x) != rc) break;
        run = fmaf(__int_as_float(e.y), u_of(e.x), run);
      }
    }
    acc[rc] += run;
  }
}

// FUSED = false: out[row] = x_row . w for every row of the slab's tiles.
// FUSED = true: the slab's gradient partial into out[slab * dim ...], its
//   (value, sum_u) into stats[2 slab ...].
template <int LOSS, bool FUSED>
__global__ void __launch_bounds__(Plan<FUSED>::kThreads, 1) stream_kernel(const StreamArgs a) {
  using P = Plan<FUSED>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::kFull);
  uint64_t* empty = reinterpret_cast<uint64_t*>(smem + P::kEmpty);
  uint64_t* z_ready = reinterpret_cast<uint64_t*>(smem + P::kZReady);
  uint64_t* u_ready = reinterpret_cast<uint64_t*>(smem + P::kUReady);
  const StreamHeader* hdr = reinterpret_cast<const StreamHeader*>(smem + P::kHdr);
  float* red = reinterpret_cast<float*>(smem + P::kRed);
  int2* sorted0 = reinterpret_cast<int2*>(smem + P::kSorted);
  float* zu0 = reinterpret_cast<float*>(smem + P::kZu);
  float* w_sh = reinterpret_cast<float*>(smem + P::kW);
  float* acc = w_sh + ((a.dim + 3) & ~3);
  const int dim = a.dim;
  const int tid = threadIdx.x;
  const long long t_begin = a.slab_tile[blockIdx.x];
  const long long t_end = a.slab_tile[blockIdx.x + 1];

  if (tid == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], P::kWarps);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&z_ready[b], P::kWarps);
      mbar_init(&u_ready[b], 32);
    }
    fence_mbarrier_init();
  }
  for (int c = tid; c < dim; c += P::kThreads) {
    w_sh[c] = a.w[c];
    if (FUSED) acc[c] = 0.0f;
  }
  __syncthreads();
  if (tid >= P::kConsumers) {
    if constexpr (FUSED) {
      const float2 part = fused_producer<LOSS>(a, t_begin, t_end, smem);
      if (tid == P::kConsumers) red[0] = part.x, red[1] = part.y;
      block_sync_end<P::kThreads>();
    } else {
      ring_producer<P>(a, t_begin, t_end, smem);
    }
    return;
  }

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float shift = FUSED ? *a.shift : 0.0f;
  float acc_value = 0.0f;  // thread 0: the rows longer than a tile
  float acc_u = 0.0f;
  // The backward runs one tile behind the forward: a tile's u comes from the
  // producer while the consumers run the next tile's forward.
  long long pending = -1;  // the buffered tile whose backward is still to run
  int pending_e = 0;
  auto run_pending = [&]() {
    if (pending >= 0) {
      const int b = static_cast<int>(pending & 1);
      mbar_wait(&u_ready[b], static_cast<uint32_t>((pending >> 1) & 1));
      tile_backward<P::kConsumers>(sorted0 + b * kTile, zu0 + b * kTileRows, pending_e, acc, tid);
      pending = -1;
    }
  };
  long long nk = 0;  // tiles that went through the buffers
  for (long long k = 0; k < t_end - t_begin; ++k) {
    const int s = static_cast<int>(k % P::kStages);
    mbar_wait(&full[s], static_cast<uint32_t>((k / P::kStages) & 1));
    const StreamHeader h = hdr[s];
    if (h.e1 - h.e0 > kTile) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // a header alone
      if constexpr (FUSED) run_pending();
      // One row longer than a stage, from device memory: the forward (a
      // fixed thread-strided order, then warps in order), then the backward.
      float p = 0.0f;
      for (long long q = h.e0 + tid; q < h.e1; q += P::kConsumers) {
        p = fmaf(__ldg(a.val + q), w_sh[__ldg(a.col_idx + q)], p);
      }
      p = warp_sum(p);
      if (lane == 0) red[2 + warp] = p;
      consumer_sync<P::kConsumers>();
      if (tid == 0) {
        float z = 0.0f;
        for (int i = 0; i < P::kWarps; ++i) z += red[2 + i];
        if constexpr (FUSED) {
          z = z + a.off[h.r0] + shift;
          const float yi = a.y[h.r0];
          const float wi = a.wt[h.r0];
          const float u = wi * loss_d1<LOSS>(z, yi);
          acc_value += wi * loss_l<LOSS>(z, yi);
          acc_u += u;
          red[2 + P::kWarps] = u;
        } else {
          a.out[h.r0] = z;
        }
      }
      consumer_sync<P::kConsumers>();
      if constexpr (FUSED) {
        const float u = red[2 + P::kWarps];
        for (long long q = h.e0 + tid; q < h.e1; q += P::kConsumers) {
          acc[__ldg(a.col_idx + q)] += __ldg(a.val + q) * u;  // a row's columns are distinct
        }
      }
      continue;
    }
    const unsigned char* st = smem + P::kRing + s * P::kStageBytes;
    const int* col = reinterpret_cast<const int*>(st + P::kCol) + cover_skip(a.col_idx, 4, h.e0);
    const float* val = reinterpret_cast<const float*>(st + P::kVal) + cover_skip(a.val, 4, h.e0);
    const long long* rp =
        reinterpret_cast<const long long*>(st + P::kRowPtr) + cover_skip(a.row_ptr, 8, h.r0);
    const int16_t* pos =
        reinterpret_cast<const int16_t*>(st + P::kPerm) + cover_skip(a.perm, 2, h.e0);
    int2* sorted = sorted0 + (nk & 1) * kTile;
    float* zu = zu0 + (nk & 1) * kTileRows;
    const int R = static_cast<int>(h.r1 - h.r0);
    // Forward: a warp per row, two rows a warp at once, lanes striding each
    // row's entries; fused, each entry is also written to its place in the
    // tile's column order.
    auto entry = [&](int q, int i, float& p) {
      const int c = col[q];
      const float v = val[q];
      p = fmaf(v, w_sh[c], p);
      if (FUSED) sorted[pos[q]] = make_int2(c << 8 | i, __float_as_int(v));
    };
    for (int i = warp; i < R; i += 2 * P::kWarps) {
      const int i2 = i + P::kWarps;
      const bool two = i2 < R;
      const int b0 = static_cast<int>(rp[i + 1] - h.e0);
      const int b1 = two ? static_cast<int>(rp[i2 + 1] - h.e0) : 0;
      int q0 = static_cast<int>(rp[i] - h.e0) + lane;
      int q1 = two ? static_cast<int>(rp[i2] - h.e0) + lane : 0;
      float p0 = 0.0f;
      float p1 = 0.0f;
      while (q0 < b0 || q1 < b1) {
        if (q0 < b0) entry(q0, i, p0);
        if (q1 < b1) entry(q1, i2, p1);
        q0 += 32;
        q1 += 32;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {  // warp_sum of each row, interleaved
        p0 += __shfl_xor_sync(0xffffffffu, p0, o);
        p1 += __shfl_xor_sync(0xffffffffu, p1, o);
      }
      if (lane == 0) {
        if (FUSED) {
          zu[i] = p0;
          if (two) zu[i2] = p1;
        } else {
          a.out[h.r0 + i] = p0;
          if (two) a.out[h.r0 + i2] = p1;
        }
      }
    }
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(&empty[s]);  // the stage is read (the producer's loss reads y, offset, weight)
      if (FUSED) mbar_arrive(&z_ready[nk & 1]);
    }
    if constexpr (FUSED) {
      run_pending();
      consumer_sync<P::kConsumers>();  // this tile's buffers are written, the last one's read
      pending = nk;
      pending_e = static_cast<int>(h.e1 - h.e0);
      ++nk;
    }
  }

  if constexpr (FUSED) {
    run_pending();
    block_sync_end<P::kThreads>();  // every backward is done; the producer's partials are in red
    if (tid == 0) {
      a.stats[2 * static_cast<int64_t>(blockIdx.x)] = red[0] + acc_value;
      a.stats[2 * static_cast<int64_t>(blockIdx.x) + 1] = red[1] + acc_u;
    }
    float* g = a.out + static_cast<int64_t>(blockIdx.x) * dim;
    for (int c = tid; c < dim; c += P::kConsumers) g[c] = acc[c];
  }
}

// An entry's term of X^T u: val * u, or (val * val) * u with SQUARE, each
// product rounded on its own (no contraction into an fma).
template <bool SQUARE>
__device__ __forceinline__ float rmatvec_term(float v, float u) {
  return __fmul_rn(SQUARE ? __fmul_rn(v, v) : v, u);
}

// X^T u (or (X o X)^T u with SQUARE) over the row tiles: the slab's gradient
// partial into out[slab * dim ...].
template <bool SQUARE>
__global__ void __launch_bounds__(RmatvecPlan::kThreads, 1)
    rmatvec_stream_kernel(const StreamArgs a) {
  using P = RmatvecPlan;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::kFull);
  uint64_t* empty = reinterpret_cast<uint64_t*>(smem + P::kEmpty);
  const StreamHeader* hdr = reinterpret_cast<const StreamHeader*>(smem + P::kHdr);
  int2* sorted0 = reinterpret_cast<int2*>(smem + P::kSorted);
  float* acc = reinterpret_cast<float*>(smem + P::kAcc);
  const int dim = a.dim;
  const int tid = threadIdx.x;
  const long long t_begin = a.slab_tile[blockIdx.x];
  const long long t_end = a.slab_tile[blockIdx.x + 1];

  if (tid == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], P::kWarps);
    }
    fence_mbarrier_init();
  }
  for (int c = tid; c < dim; c += P::kThreads) acc[c] = 0.0f;
  __syncthreads();
  if (tid >= P::kConsumers) {
    ring_producer<P>(a, t_begin, t_end, smem);
    return;
  }

  const int lane = tid & 31;
  const int warp = tid >> 5;
  long long nk = 0;  // tiles that went through the column-order buffers
  for (long long k = 0; k < t_end - t_begin; ++k) {
    const int s = static_cast<int>(k % P::kStages);
    mbar_wait(&full[s], static_cast<uint32_t>((k / P::kStages) & 1));
    const StreamHeader h = hdr[s];
    if (h.e1 - h.e0 > kTile) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // a header alone
      consumer_sync<P::kConsumers>();  // the last tile's backward is done with acc
      // One row longer than a stage, from device memory; its columns are
      // distinct, so no two threads add to one column.
      const float u = __ldg(a.u + h.r0);
      for (long long q = h.e0 + tid; q < h.e1; q += P::kConsumers) {
        const int c = __ldg(a.col_idx + q);
        acc[c] = __fadd_rn(acc[c], rmatvec_term<SQUARE>(__ldg(a.val + q), u));
      }
      continue;
    }
    const unsigned char* st = smem + P::kRing + s * P::kStageBytes;
    const int* col = reinterpret_cast<const int*>(st + P::kCol) + cover_skip(a.col_idx, 4, h.e0);
    const float* val = reinterpret_cast<const float*>(st + P::kVal) + cover_skip(a.val, 4, h.e0);
    const long long* rp =
        reinterpret_cast<const long long*>(st + P::kRowPtr) + cover_skip(a.row_ptr, 8, h.r0);
    const int16_t* pos =
        reinterpret_cast<const int16_t*>(st + P::kPerm) + cover_skip(a.perm, 2, h.e0);
    const float* uu = reinterpret_cast<const float*>(st + P::kU) + cover_skip(a.u, 4, h.r0);
    int2* sorted = sorted0 + (nk & 1) * kTile;
    const int R = static_cast<int>(h.r1 - h.r0);
    // Each entry's term to its place in the tile's column order: a warp per
    // row, two rows a warp at once, lanes striding each row's entries.
    auto scatter = [&](int q, float u) {
      sorted[pos[q]] = make_int2(col[q], __float_as_int(rmatvec_term<SQUARE>(val[q], u)));
    };
    for (int i = warp; i < R; i += 2 * P::kWarps) {
      const int i2 = i + P::kWarps;
      const bool two = i2 < R;
      const float u0 = uu[i];
      const float u1 = two ? uu[i2] : 0.0f;
      const int b0 = static_cast<int>(rp[i + 1] - h.e0);
      const int b1 = two ? static_cast<int>(rp[i2 + 1] - h.e0) : 0;
      int q0 = static_cast<int>(rp[i] - h.e0) + lane;
      int q1 = two ? static_cast<int>(rp[i2] - h.e0) + lane : 0;
      while (q0 < b0 || q1 < b1) {
        if (q0 < b0) scatter(q0, u0);
        if (q1 < b1) scatter(q1, u1);
        q0 += 32;
        q1 += 32;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // the stage is read
    // This tile's terms are all in place, and the last tile's backward (the
    // other buffer) is done.
    consumer_sync<P::kConsumers>();
    tile_backward<P::kConsumers, true>(sorted, nullptr, static_cast<int>(h.e1 - h.e0), acc, tid);
    ++nk;
  }
  consumer_sync<P::kConsumers>();  // every backward is done
  float* g = a.out + static_cast<int64_t>(blockIdx.x) * dim;
  for (int c = tid; c < dim; c += P::kConsumers) g[c] = acc[c];
}

// g[c] = sum over slabs b, in order, of partial[b * dim + c] (in double).
__global__ void slab_sum_kernel(int dim, int slabs, const float* __restrict__ partial,
                                float* __restrict__ g) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= dim) return;
  double s = 0.0;
  for (int b = 0; b < slabs; ++b) s += partial[static_cast<int64_t>(b) * dim + c];
  g[c] = static_cast<float>(s);
}

// ---- two pass, forward: one warp per CSR row -----------------------------------
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

// ---- two pass, backward: one warp per CSC chunk, then the chunks of each column

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

template <int LOSS, bool FUSED>
int launch_stream(const StreamArgs& a, int slabs, cudaStream_t stream) {
  using P = Plan<FUSED>;
  if (a.dim < 1 || a.dim > P::kMaxDim || slabs < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = stream_kernel<LOSS, FUSED>;
  const int smem = P::smem_bytes(a.dim);
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<slabs, P::kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool SQUARE>
int launch_rmatvec_stream(const StreamArgs& a, int slabs, cudaStream_t stream) {
  using P = RmatvecPlan;
  if (a.dim < 1 || a.dim > P::kMaxDim || slabs < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = rmatvec_stream_kernel<SQUARE>;
  const int smem = P::smem_bytes(a.dim);
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<slabs, P::kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int stream_fused(int loss, const StreamArgs& a, int slabs, cudaStream_t stream) {
  switch (loss) {
    case kLogistic:
      return launch_stream<kLogistic, true>(a, slabs, stream);
    case kSquared:
      return launch_stream<kSquared, true>(a, slabs, stream);
    case kPoisson:
      return launch_stream<kPoisson, true>(a, slabs, stream);
    case kSmoothedHinge:
      return launch_stream<kSmoothedHinge, true>(a, slabs, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

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

// Launches the two-pass forward kernel; *blocks receives the grid size.
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

// Widest dim of the single-stream route: kernel 0 for X w, 1 for the fused
// sums, 2 for X^T u (-1 for another number). The wrapper mirrors all three.
int sparse_stream_max_dim(int kernel) {
  switch (kernel) {
    case 0:
      return Plan<false>::kMaxDim;
    case 1:
      return Plan<true>::kMaxDim;
    case 2:
      return RmatvecPlan::kMaxDim;
    default:
      return -1;
  }
}

// Single stream: z (n) = X w over the row tiles; one block per slab.
int sparse_matvec_tiles(long long n, int dim, const int64_t* row_ptr, const int* col_idx,
                        const float* row_val, const int64_t* tile_row, const int64_t* tile_ptr,
                        int n_slabs, const int64_t* slab_tile, const float* w, float* z,
                        void* stream) {
  if (n == 0) return 0;
  const StreamArgs a{dim,     row_ptr, col_idx, row_val, nullptr, tile_row, tile_ptr, slab_tile,
                     w,       nullptr, nullptr, nullptr, nullptr, z,        nullptr};
  return launch_stream<kLogistic, false>(a, n_slabs, static_cast<cudaStream_t>(stream));
}

// Single stream: out (dim + 2) = [grad_raw, value, sum_u] over the row
// tiles; partial (n_slabs * dim) and stats (2 * n_slabs) are scratch. No
// CSC array is read.
int sparse_fused_tiles(int loss, int dim, const int64_t* row_ptr, const int* col_idx,
                       const float* row_val, const int16_t* tile_perm, const int64_t* tile_row,
                       const int64_t* tile_ptr, int n_slabs, const int64_t* slab_tile,
                       const float* w, const float* y, const float* off, const float* wt,
                       const float* shift, float* partial, float* stats, float* out,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const StreamArgs a{dim, row_ptr, col_idx, row_val, tile_perm, tile_row, tile_ptr, slab_tile,
                     w,   y,       off,     wt,      shift,     partial,  stats};
  int rc = stream_fused(loss, a, n_slabs, s);
  if (rc != 0) return rc;
  slab_sum_kernel<<<(dim + 255) / 256, 256, 0, s>>>(dim, n_slabs, partial, out);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  stats_sum_kernel<<<1, 32, 0, s>>>(stats, n_slabs, out + dim);
  return static_cast<int>(cudaGetLastError());
}

// Two pass: z (n) = X w over the CSR rows, a warp per row.
int sparse_matvec_rows(long long n, int dim, const int64_t* row_ptr, const int* col_idx,
                       const float* row_val, const float* w, float* z, void* stream) {
  if (n == 0) return 0;
  const Forward a{static_cast<int64_t>(n), dim, row_ptr, col_idx, row_val, w, nullptr, nullptr,
                  nullptr, nullptr, z, nullptr, static_cast<cudaStream_t>(stream)};
  int blocks = 0;
  return a.dim <= kSmemWMaxDim ? launch_forward<kLogistic, false, true>(a, &blocks)
                               : launch_forward<kLogistic, false, false>(a, &blocks);
}

// Single stream: g (dim) = X^T u, or (X o X)^T u when square, over the row
// tiles; partial (n_slabs * dim) is scratch. No CSC array is read.
int sparse_rmatvec_tiles(int square, int dim, const int64_t* row_ptr, const int* col_idx,
                         const float* row_val, const int16_t* tile_perm, const int64_t* tile_row,
                         const int64_t* tile_ptr, int n_slabs, const int64_t* slab_tile,
                         const float* u, float* partial, float* g, void* stream) {
  if (dim == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const StreamArgs a{dim,     row_ptr, col_idx, row_val, tile_perm, tile_row, tile_ptr, slab_tile,
                     nullptr, nullptr, nullptr, nullptr, nullptr,   partial,  nullptr,  u};
  int rc = square != 0 ? launch_rmatvec_stream<true>(a, n_slabs, s)
                       : launch_rmatvec_stream<false>(a, n_slabs, s);
  if (rc != 0) return rc;
  slab_sum_kernel<<<(dim + 255) / 256, 256, 0, s>>>(dim, n_slabs, partial, g);
  return static_cast<int>(cudaGetLastError());
}

// Two pass: g (dim) = X^T u, or (X o X)^T u when square, over the CSC copy;
// chunk_sum is n_chunks floats of scratch.
int sparse_rmatvec_chunks(int square, int dim, long long n_chunks, const int64_t* chunk_start,
                   const int64_t* chunk_ptr, const int* row_idx, const float* col_val,
                   const float* u, float* chunk_sum, float* g, void* stream) {
  return launch_backward(square != 0, dim, n_chunks, chunk_start, chunk_ptr, row_idx, col_val, u,
                         chunk_sum, g, static_cast<cudaStream_t>(stream));
}

// Two pass: out (dim + 2) = [grad_raw, value, sum_u]; u (n), partial
// (2 * sparse_max_forward_blocks()) and chunk_sum (n_chunks) are scratch.
int sparse_fused_two_pass(int loss, long long n, int dim, const int64_t* row_ptr,
                          const int* col_idx, const float* row_val, const float* w, const float* y,
                          const float* off, const float* wt, const float* shift, float* u,
                          float* partial, long long n_chunks, const int64_t* chunk_start,
                          const int64_t* chunk_ptr, const int* row_idx, const float* col_val,
                          float* chunk_sum, float* out, void* stream) {
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
