// The Lovász-softmax's gradient scan and per-class dot product over a
// class-major sort, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's deepviewagg_tpu/models/losses.py
// (_lovasz_grad) leaves the scan to XLA (jnp.cumsum).  It was added because
// PyTorch runs the same cumsum over the [N, C] sorted errors on dim 0 as its
// outer-dimension scan, one thread block per class column: 13 blocks walking
// 1.2M rows each on 132 SMs, 0.77 s of a 1.9 s Point Transformer V3 train
// step on an H100.  Its innermost-dimension scan would give 32 rows to one
// block, so a [13, N] transpose alone would still run in one block.
//
// Inputs are class-major: err [C, N] float32, each class's errors sorted in
// descending order, and fg [C, N] uint8, its foreground (0 / 1) in the same
// order.  For class c and sorted position i, with cum_i = fg[0] + ... +
// fg[i] and gts the class's total:
//
//   jac_i   = 1 - (gts - cum_i) / max(gts + (i + 1 - cum_i), 1)
//   w[c, i] = jac_i - jac_{i-1}              (w[c, 0] = jac_0)
//   loss[c] = sum_i err[c, i] * w[c, i]
//
// The counts are int32 and exact at any N.  Below 2^24 rows their float32
// values are exact, as the plain path's float32 cumsum of 0 / 1 values is,
// and the division is IEEE (no fast math): w equals the plain formula's
// (ops/lovasz.py::lovasz_grad) bit for bit on the same sorted input.
//
// Bound: bytes.  The call must read err (4 C N) and fg (C N) and write w
// (4 C N): 9 C N bytes, 144 MB at [13, 1,228,800], 43 us at 3.35 TB/s.  The
// count pass reads fg a second time (another C N).
//
// Design: tiles of kTile consecutive sorted rows of one class, grid (tiles,
// C); the join across tiles is a second small pass over the tile counts (not
// a decoupled look-back), so that no block waits on another:
//
//   1. lovasz_count_kernel: each tile's foreground count, int32 [C, tiles].
//   2. lovasz_weights_kernel: a block sums its class's counts before its
//      tile (its offset) and of every tile (gts): at most N / kTile int32
//      from L2.  It stages its tile in shared memory (coalesced), each
//      thread scans kPer consecutive rows after a block-wide exclusive scan
//      of the threads' counts, recomputes jac_{i-1} at its first row from
//      the prefix, writes w (coalesced, from shared memory) and the tile's
//      dot product in float64 to `partial` [C, tiles].
//   3. lovasz_dot_kernel: one block a class sums its partials in a fixed
//      order (float64) and rounds to loss[c]: deterministic, no atomics.
//
// Measured by chip_smoke.py (phase 14, the kernel alone from a replayed CUDA
// graph) on an NVIDIA H100 80GB HBM3, 700 W limit, at [13, 1,228,800]:
// 0.0886 ms, 48% of the byte bound; the plain formula's outer-dimension
// cumsum took 782 ms there (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                     // consecutive rows a thread
constexpr int kTile = kThreads * kPer;      // rows a block
constexpr unsigned kFull = 0xffffffffu;

// shared-memory slot of tile row j: one pad word every 32, so that both the
// coalesced staging (j = thread + 256 m) and the threads' runs (j = 8 thread
// + k) are free of bank conflicts
__device__ __forceinline__ int slot(int j) { return j + (j >> 5); }

// Sum of v over the block, in a fixed order, returned to every thread.
// `shared` holds kWarps values; the call ends with a barrier, so it may be
// reused at once.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* shared) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  if ((threadIdx.x & 31) == 0) shared[threadIdx.x >> 5] = v;
  __syncthreads();
  T total = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) total += shared[k];
  __syncthreads();
  return total;
}

__device__ __forceinline__ float jaccard(int64_t gts, int64_t cum, int64_t i) {
  const float inter = static_cast<float>(gts - cum);
  const float uni = static_cast<float>(gts + (i + 1 - cum));
  return 1.0f - inter / fmaxf(uni, 1.0f);
}

__global__ void __launch_bounds__(kThreads)
lovasz_count_kernel(const uint8_t* __restrict__ fg,
                    int32_t* __restrict__ counts, int n, int tiles) {
  __shared__ int shared[kWarps];
  const int t = blockIdx.x;
  const int c = blockIdx.y;
  const uint8_t* __restrict__ row = fg + static_cast<int64_t>(c) * n;
  const int t0 = t * kTile;
  const int t1 = min(t0 + kTile, n);
  int cnt = 0;
  for (int i = t0 + threadIdx.x; i < t1; i += kThreads) cnt += row[i] != 0;
  cnt = block_sum(cnt, shared);
  if (threadIdx.x == 0) counts[static_cast<int64_t>(c) * tiles + t] = cnt;
}

__global__ void __launch_bounds__(kThreads)
lovasz_weights_kernel(const float* __restrict__ err,
                      const uint8_t* __restrict__ fg,
                      const int32_t* __restrict__ counts,
                      float* __restrict__ w, double* __restrict__ partial,
                      int n, int tiles) {
  __shared__ float s_val[kTile + kTile / 32];     // errors, then weights
  __shared__ uint8_t s_fg[kTile + kTile / 32];
  __shared__ int s_int[kWarps];
  __shared__ double s_dbl[kWarps];
  const int t = blockIdx.x;
  const int c = blockIdx.y;
  const int64_t base = static_cast<int64_t>(c) * n;
  const int t0 = t * kTile;
  const int len = min(kTile, n - t0);

  // the class's foreground before this tile, and in all
  const int32_t* __restrict__ cc = counts + static_cast<int64_t>(c) * tiles;
  int before = 0, total = 0;
  for (int j = threadIdx.x; j < tiles; j += kThreads) {
    const int v = cc[j];
    total += v;
    before += j < t ? v : 0;
  }
  before = block_sum(before, s_int);
  total = block_sum(total, s_int);

  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const bool in = j < len;
    s_val[slot(j)] = in ? err[base + t0 + j] : 0.0f;
    s_fg[slot(j)] = in ? static_cast<uint8_t>(fg[base + t0 + j] != 0) : 0;
  }
  __syncthreads();

  // exclusive scan of the threads' counts over the block
  const int j0 = threadIdx.x * kPer;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int mine = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) mine += s_fg[slot(j0 + k)];
  int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_int[warp] = incl;
  __syncthreads();
  int warps_before = 0;
  for (int k = 0; k < warp; ++k) warps_before += s_int[k];

  // this thread's rows: cum through the row before its first, and that
  // row's jaccard (0 before the class's first row)
  const int64_t gts = total;
  int64_t cum = static_cast<int64_t>(before) + warps_before + incl - mine;
  const int64_t i0 = static_cast<int64_t>(t0) + j0;
  float prev = i0 > 0 ? jaccard(gts, cum, i0 - 1) : 0.0f;
  double dot = 0.0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = j0 + k;
    if (j < len) {
      cum += s_fg[slot(j)];
      const float jac = jaccard(gts, cum, i0 + k);
      const float wk = jac - prev;
      prev = jac;
      dot += static_cast<double>(s_val[slot(j)]) * static_cast<double>(wk);
      s_val[slot(j)] = wk;   // only this thread reads or writes slot j here
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < len; j += kThreads) {
    w[base + t0 + j] = s_val[slot(j)];
  }
  dot = block_sum(dot, s_dbl);
  if (threadIdx.x == 0) partial[static_cast<int64_t>(c) * tiles + t] = dot;
}

__global__ void __launch_bounds__(kThreads)
lovasz_dot_kernel(const double* __restrict__ partial, float* __restrict__ loss,
                  int tiles) {
  __shared__ double shared[kWarps];
  const int c = blockIdx.x;
  const double* __restrict__ p = partial + static_cast<int64_t>(c) * tiles;
  double v = 0.0;
  for (int j = threadIdx.x; j < tiles; j += kThreads) v += p[j];
  v = block_sum(v, shared);
  if (threadIdx.x == 0) loss[c] = static_cast<float>(v);
}

}  // namespace

// Rows of one tile: the scratch of a call holds classes * ceil(n / tile)
// int32 counts and as many float64 partials.
extern "C" int lovasz_tile_rows() { return kTile; }

// err: f32 [classes, n] row-major, each row sorted descending; fg: uint8
// [classes, n] in the same order (nonzero = foreground); w: f32 [classes, n];
// loss: f32 [classes]; counts: int32 and partial: f64 scratch of classes *
// ceil(n / lovasz_tile_rows()) each.  n < 2^30, classes <= 65535.  Launches
// on `stream` without synchronising; returns cudaGetLastError() of the
// launches.
extern "C" int lovasz_f32(const void* err, const void* fg, void* w, void* loss,
                          void* counts, void* partial, int classes, int n,
                          void* stream) {
  if (classes <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const int tiles = n > 0 ? (n + kTile - 1) / kTile : 0;
  auto* cnt = static_cast<int32_t*>(counts);
  auto* part = static_cast<double*>(partial);
  if (tiles > 0) {
    const dim3 grid(static_cast<unsigned>(tiles),
                    static_cast<unsigned>(classes));
    lovasz_count_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(fg), cnt, n, tiles);
    lovasz_weights_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(err), static_cast<const uint8_t*>(fg), cnt,
        static_cast<float*>(w), part, n, tiles);
  }
  lovasz_dot_kernel<<<classes, kThreads, 0, s>>>(
      part, static_cast<float*>(loss), tiles);
  return static_cast<int>(cudaGetLastError());
}
