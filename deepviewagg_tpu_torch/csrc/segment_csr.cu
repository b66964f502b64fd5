// Sorted-segment (CSR) sum / max of float32 rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel deepviewagg_tpu/ops/pallas_segment.py::_scan_kernel
// (launched by _scan, pl.pallas_call at :109): there, a sorted-segment
// reduction is an inclusive segmented scan over 512-row chunks with a
// (value, id) carry between sequential grid steps, then a gather of row
// ptr[s+1]-1.  Hopper runs blocks in parallel with no carry, and collate
// already ships the CSR pointer, so here
//
//   out[s, c] = reduce_{r in [ptr[s], ptr[s+1]), valid[r]} x[r, c]
//
// with 0 for an empty or all-masked segment (and, for max, for any result at
// or below -5e29, as ops/segment.py's XLA path does).  Rows outside
// [ptr[0], ptr[S]) are ignored.  Accumulation is f32 in a fixed order:
// deterministic, no atomics on values (one shared integer counter hands out
// the slots of a tile's item list, whose order enters no result).
//
// Bound: bytes.  The call must read L*C*4 (its L live rows: valid and inside
// [ptr[0], ptr[S]); a masked row need not be read) + E (valid) + 4*(S+1)
// (ptr) bytes and write S*C*4; at the flagship atomic pool (~389k x 128
// rows, ~35k of them masked, -> ~83k views) that is ~224 MB, ~67 us at 3.35
// TB/s.  There is no reuse to exploit, so the design reads every live row
// once, skips masked rows without reading them, and writes every output
// once.
//
// Design: the work is cut by ROWS, not by segments, so that the time follows
// the call's bytes and not its longest segment (collate sorts every padding
// row, ~10% of all rows, into ONE last "drop" segment; a point seen by many
// views is another long one).
//
//   1. segment_csr_tile_kernel: a block takes a tile of `tile` consecutive
//      rows.  It reads the tile's validity bytes coalesced and keeps them as
//      one 32-bit mask per 32-row window in shared memory, so a window or a
//      whole tile without a live row costs no read of x.  From ptr (a search
//      by the whole block, 512 probes a level) it finds the segments that
//      START in the tile; those are the tile's own, and the ones that hold a
//      row are listed in shared memory.  Every own segment that also ends in
//      the tile is reduced and written to `out` once.  At most two segments
//      cross the tile's edges: the one that comes in from the tile before
//      (the "head") and the last own one when it runs on (the "tail").
//      Their partial results go, unfinished, to scratch[tile][0] and
//      scratch[tile][1]; where the head ends in the tile, the block notes
//      the segment and the tile it started in.
//   2. segment_csr_finish_kernel, behind it on the same stream (started
//      early by programmatic dependent launch): one warp per tile.
//      Where a tile's head segment ends in the tile, the warp folds
//      tail(first tile), head(next tile), ..., head(this tile) in tile order
//      and writes the segment's row of `out`.  A segment longer than a tile
//      is just a run of such partials; the fixed order keeps the result
//      bit-reproducible.  The same kernel zeroes the rows of the empty
//      segments, cut by segment index.
//
// Inside a tile kL lanes cover a row's channels (float4 when C % 4 == 0), so
// the block's 512 / kL lane groups reduce 512 / kL short items (segments
// clipped to the tile) side by side: at C = 4 a thread per segment, at
// C = 128 a warp per segment.  An item longer than 32 rows is taken by a
// whole warp instead, its lane groups sharing the rows round-robin and
// meeting in a fixed xor-shuffle tree.  Rows are visited through the window
// masks' set bits, four loads in flight per lane.
//
// Measured by chip_smoke.py (phase 2, device time of both kernels from a
// replayed CUDA graph) on an NVIDIA H100 80GB HBM3, 700 W limit: 0.106 ms at
// the atomic pool (63% of its byte bound; one warp per segment took 0.155
// ms, all but the bound's share of it in the drop segment's walk), 7-9 us
// for the [82688, 1] and [82688, 4] calls (about 27 us before).  Copying
// each tile into shared memory first (cp.async) measured slower at every
// width, 0.133 ms at the atomic pool, and was dropped.  Tile sizes per
// width: ops/segment.py::kernel_tile_rows; all times: PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxTile = 2048;   // rows; bounds the shared masks and items
constexpr int kLongRows = 32;    // items longer than this take a whole warp
// item kinds beside an output row (>= 0): partials of the tile
constexpr int kHead = -1, kTail = -2;

template <bool kMax>
__device__ __forceinline__ float combine1(float a, float b) {
  return kMax ? fmaxf(a, b) : a + b;
}

template <bool kMax>
__device__ __forceinline__ float finish1(float a) {
  return (kMax && a <= kNeg / 2) ? 0.0f : a;
}

// A row slice of 1 (float) or 4 (float4) channels, with lane-wise helpers.
template <int kVec>
struct Vec;

template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T fill(float v) { return v; }
  template <bool kMax>
  static __device__ __forceinline__ T combine(T a, T b) {
    return combine1<kMax>(a, b);
  }
  static __device__ __forceinline__ T shfl_xor(T a, int m) {
    return __shfl_xor_sync(kFull, a, m);
  }
  template <bool kMax>
  static __device__ __forceinline__ T finish(T a) {
    return finish1<kMax>(a);
  }
};

template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T fill(float v) {
    return make_float4(v, v, v, v);
  }
  template <bool kMax>
  static __device__ __forceinline__ T combine(T a, T b) {
    return make_float4(combine1<kMax>(a.x, b.x), combine1<kMax>(a.y, b.y),
                       combine1<kMax>(a.z, b.z), combine1<kMax>(a.w, b.w));
  }
  static __device__ __forceinline__ T shfl_xor(T a, int m) {
    return make_float4(__shfl_xor_sync(kFull, a.x, m),
                       __shfl_xor_sync(kFull, a.y, m),
                       __shfl_xor_sync(kFull, a.z, m),
                       __shfl_xor_sync(kFull, a.w, m));
  }
  template <bool kMax>
  static __device__ __forceinline__ T finish(T a) {
    return make_float4(finish1<kMax>(a.x), finish1<kMax>(a.y),
                       finish1<kMax>(a.z), finish1<kMax>(a.w));
  }
};

// lower_bound(r) = the first index i in [0, n] with ptr[i] >= r, or n + 1 when
// there is none (ptr has n + 1 entries), for r = r0 and r = r1 at once.  The
// whole block searches together: 512 probes a level narrow each range
// 512-fold, so 83k segments take 2 dependent loads where a thread alone
// would take 17.  Every thread of the block must call it.
__device__ __forceinline__ void block_lower_bounds(
    const int32_t* __restrict__ ptr, int n, int64_t r0, int64_t r1,
    int* found0, int* found1) {
  int lo[2] = {0, 0}, hi[2] = {n + 1, n + 1};  // each answer in [lo, hi]
  const int64_t r[2] = {r0, r1};
  while (lo[0] < hi[0] || lo[1] < hi[1]) {  // block-uniform
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int step = (hi[k] - lo[k] + kThreads - 1) / kThreads;
      const int64_t probe = lo[k] + static_cast<int64_t>(threadIdx.x) * step;
      // over the threads: true ... true false ... false
      const bool below = lo[k] < hi[k] && probe < hi[k] && ptr[probe] < r[k];
      const int nt = __syncthreads_count(below);
      if (nt == 0) {
        hi[k] = lo[k];
      } else {
        const int64_t next = lo[k] + static_cast<int64_t>(nt) * step;
        lo[k] = lo[k] + (nt - 1) * step + 1;
        hi[k] = next < hi[k] ? static_cast<int>(next) : hi[k];
      }
    }
  }
  *found0 = lo[0];
  *found1 = lo[1];
}

// Reduce the live rows [a, b) of a tile (tile-relative) over one channel
// slice.  `rows` points at the tile's first row, this lane's channel; `live`
// holds one mask per 32-row window.  Of every window's rows only those at
// positions shift + k with bit k of `pat` set are taken (shift 0 and a full
// pattern: all rows).  The rows are taken kBatch at a time, across window
// borders, so that kBatch loads are in flight however few a window gives.
template <bool kMax, int kVec>
__device__ __forceinline__ typename Vec<kVec>::T walk(
    const typename Vec<kVec>::T* __restrict__ rows, int units,
    const uint32_t* live, int a, int b, int shift, unsigned pat) {
  using V = Vec<kVec>;
  using T = typename V::T;
  constexpr int kBatch = 4;  // row loads in flight per lane
  T acc = V::fill(kMax ? kNeg : 0.0f);
  if (a >= b) return acc;
  const int w_last = (b - 1) >> 5;
  const auto taken = [&](int w) -> unsigned {  // this lane's rows of window w
    const int lo = max(a - 32 * w, 0);   // 0..31
    const int hi = min(b - 32 * w, 32);  // 1..32
    const unsigned m = live[w] & (kFull >> (32 - hi)) & (kFull << lo);
    return (m >> shift) & pat;
  };
  int w = a >> 5;
  unsigned m = taken(w);
  for (bool more = true; more;) {
    T v[kBatch];
    bool on[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      while (m == 0u && w < w_last) m = taken(++w);
      on[u] = m != 0u;
      if (on[u]) {
        const int64_t row = 32 * w + shift + __ffs(m) - 1;
        m &= m - 1u;
        v[u] = rows[row * units];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (on[u]) acc = V::template combine<kMax>(acc, v[u]);
    }
    more = on[kBatch - 1];
  }
  return acc;
}

// Where an item's result goes: finished into its output row, or unfinished
// into the tile's head or tail partial.
template <bool kMax, int kVec>
__device__ __forceinline__ void put(typename Vec<kVec>::T acc, int kind,
                                    typename Vec<kVec>::T* __restrict__ ov,
                                    typename Vec<kVec>::T* __restrict__ sv,
                                    int units, int c) {
  if (kind >= 0) {
    ov[static_cast<int64_t>(kind) * units + c] =
        Vec<kVec>::template finish<kMax>(acc);
  } else {
    sv[(kind == kHead ? 0 : units) + c] = acc;
  }
}

// kVec: channels per lane load (1 or 4); kL: lanes per row (power of two).
// `units` = channels / kVec.  scratch: [tiles, 2, units] of T.  meta:
// [tiles, 2] int32; where a tile's head segment ends in the tile, its
// segment and the tile it started in, else -1.
template <bool kMax, int kVec, int kL>
__global__ void __launch_bounds__(kThreads)
segment_csr_tile_kernel(const float* __restrict__ x,
                        const int32_t* __restrict__ ptr,
                        const uint8_t* __restrict__ valid,
                        float* __restrict__ out, float* __restrict__ scratch,
                        int32_t* __restrict__ meta, int num_rows,
                        int num_segments, int units, int tile) {
  using V = Vec<kVec>;
  using T = typename V::T;
  constexpr int kGroups = 32 / kL;
  // bit k * kGroups for every k: the rows one lane group takes of a window
  // when the whole warp shares an item
  constexpr unsigned kPattern =
      kGroups == 1 ? kFull
                   : static_cast<unsigned>(0xffffffffffffffffull /
                                           ((1ull << kGroups) - 1ull));
  __shared__ uint32_t live[kMaxTile / 32];
  // the tile's items: the head and the own segments that hold a row.  An
  // item's rows [a, b) of the tile as a | b << 16, and its kind: an output
  // row (>= 0), kHead or kTail.
  __shared__ int32_t item_rows[kMaxTile + 1];
  __shared__ int32_t item_kind[kMaxTile + 1];
  __shared__ int item_count;

  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * tile;
  const bool last_tile = blockIdx.x == gridDim.x - 1;
  const int64_t t1 = last_tile ? num_rows : t0 + tile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int group = lane / kL;
  const int sub = lane % kL;

  if (threadIdx.x == 0) item_count = 0;  // barriers follow, in the search
  // Let the finish kernel start: what it does before it waits for this grid
  // (the empty segments) touches nothing this grid touches.
  asm volatile("griddepcontrol.launch_dependents;\n" ::);

  // validity -> one mask per window (tile is a multiple of 32).  All of a
  // thread's bytes are asked for before the first is used, and the masks
  // are built only after the search, so that the loads of both are in flight
  // together.
  constexpr int kSpan = kMaxTile / kThreads;  // windows per warp
  bool on[kSpan];
#pragma unroll
  for (int i = 0; i < kSpan; ++i) {
    const int64_t r = t0 + 32 * (warp + i * kWarps) + lane;
    on[i] = r < t1 && (valid == nullptr || valid[r] != 0);
  }
  // own segments [first, end): those that start in the tile
  int first, end;
  block_lower_bounds(ptr, num_segments, t0, t1, &first, &end);
  if (end > num_segments) end = num_segments;
  const int owned = end > first ? end - first : 0;
#pragma unroll
  for (int i = 0; i < kSpan; ++i) {
    const int w = warp + i * kWarps;
    const unsigned m = __ballot_sync(kFull, on[i]);
    if (lane == 0 && w < tile / 32) live[w] = m;
  }

  // the head: segment first - 1 when it comes in from an earlier tile, that
  // is ptr[first - 1] < t0 < ptr[first]
  if (threadIdx.x == 0) {
    int ends_with = -1;
    if (first >= 1 && first <= num_segments) {
      const int64_t stop = ptr[first];
      if (stop > t0) {
        const bool ends = stop <= t1;
        const int at = atomicAdd(&item_count, 1);
        item_rows[at] = static_cast<int>((ends ? stop : t1) - t0) << 16;
        item_kind[at] = kHead;
        if (ends) {
          ends_with = first - 1;
          meta[2 * blockIdx.x + 1] = ptr[first - 1] / tile;
        }
      }
    }
    meta[2 * blockIdx.x] = ends_with;
  }
  // the own segments that hold a row (the empty ones are zeroed by the
  // finish kernel): at most `tile` of them, however many the tile owns.
  // Their order in the list is free, so nothing orders the threads here and
  // the loads of a thread's turns are in flight together.
#pragma unroll 4
  for (int k = threadIdx.x; k < owned; k += kThreads) {
    const int64_t r0 = ptr[first + k];
    const int64_t r1 = ptr[first + k + 1];
    if (r1 > r0) {
      const bool runs_on = r1 > t1;
      const int at = atomicAdd(&item_count, 1);
      item_rows[at] = static_cast<int>(r0 - t0) |
                      static_cast<int>((runs_on ? t1 : r1) - t0) << 16;
      item_kind[at] = runs_on ? kTail : first + k;
    }
  }
  __syncthreads();
  const int items = item_count;

  const T* __restrict__ xv = reinterpret_cast<const T*>(x) + t0 * units;
  T* __restrict__ ov = reinterpret_cast<T*>(out);
  T* __restrict__ sv = reinterpret_cast<T*>(scratch) +
                       static_cast<int64_t>(blockIdx.x) * 2 * units;

  // short items: one lane group each, all the block's groups side by side
  for (int it = warp * kGroups + group; it < items; it += kWarps * kGroups) {
    const int rows = item_rows[it];
    const int a = rows & 0xffff, b = rows >> 16;
    if (kGroups > 1 && b - a > kLongRows) continue;
    const int kind = item_kind[it];
    for (int c = sub; c < units; c += kL) {
      put<kMax, kVec>(
          walk<kMax, kVec>(xv + c, units, live, a, b, 0, kFull), kind,
          ov, sv, units, c);
    }
  }
  // long items: a whole warp each, its lane groups sharing the rows
  for (int base = warp * 32; kGroups > 1 && base < items;
       base += kWarps * 32) {
    const int mine = base + lane < items ? item_rows[base + lane] : 0;
    unsigned todo =
        __ballot_sync(kFull, (mine >> 16) - (mine & 0xffff) > kLongRows);
    for (; todo != 0u; todo &= todo - 1u) {
      const int it = base + __ffs(todo) - 1;
      const int rows = item_rows[it];
      const int a = rows & 0xffff, b = rows >> 16;
      const int kind = item_kind[it];
      for (int c0 = 0; c0 < units; c0 += kL) {  // warp-uniform
        const int c = c0 + sub;
        T acc = V::fill(kMax ? kNeg : 0.0f);
        if (c < units) {
          acc = walk<kMax, kVec>(xv + c, units, live, a, b, group,
                                 kPattern);
        }
#pragma unroll
        for (int m = kL; m < 32; m <<= 1) {
          acc = V::template combine<kMax>(acc, V::shfl_xor(acc, m));
        }
        if (group == 0 && c < units) {
          put<kMax, kVec>(acc, kind, ov, sv, units, c);
        }
      }
    }
  }
}

// What the tiles leave open.  Warp t < tiles: where tile t's head segment
// ends in it, fold the segment's partials in tile order (the tail of the tile
// it started in, then the heads) and write its output row.  Warp w, besides:
// zero the output rows of the empty segments among [32 w, 32 w + 32).  (The
// padding points and views of a batch are empty segments, thousands of them
// at ONE row position: spread by segment index, not by row, they cost every
// warp the same.)
template <bool kMax, int kVec>
__global__ void __launch_bounds__(kThreads)
segment_csr_finish_kernel(const int32_t* __restrict__ ptr,
                          const float* __restrict__ scratch,
                          const int32_t* __restrict__ meta,
                          float* __restrict__ out, int num_segments,
                          int units, int tiles) {
  using V = Vec<kVec>;
  using T = typename V::T;
  const int w = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  T* __restrict__ ov = reinterpret_cast<T*>(out);
  {  // before the tile kernel's grid is done: it never touches these rows
    const int s = 32 * w + lane;
    const unsigned empty =
        __ballot_sync(kFull, s < num_segments && ptr[s] == ptr[s + 1]);
    if (empty != 0u) {
      T* __restrict__ rows = ov + static_cast<int64_t>(32 * w) * units;
      for (int f = lane; f < 32 * units; f += 32) {
        if ((empty >> (f / units)) & 1u) rows[f] = V::fill(0.0f);
      }
    }
  }
  if (w >= tiles) return;
  // the tile kernel's grid is done and its writes are visible from here on
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int s = meta[2 * w];
  if (s < 0) return;
  const int t_start = meta[2 * w + 1];
  const T* __restrict__ sv = reinterpret_cast<const T*>(scratch);
  for (int c = lane; c < units; c += 32) {
    T acc = sv[(static_cast<int64_t>(t_start) * 2 + 1) * units + c];  // tail
#pragma unroll 4
    for (int u = t_start + 1; u <= w; ++u) {  // heads, in tile order
      acc = V::template combine<kMax>(
          acc, sv[static_cast<int64_t>(u) * 2 * units + c]);
    }
    ov[static_cast<int64_t>(s) * units + c] = V::template finish<kMax>(acc);
  }
}

template <bool kMax, int kVec, int kL>
cudaError_t launch_l(const float* x, const int32_t* ptr, const uint8_t* valid,
                     float* out, float* scratch, int num_rows,
                     int num_segments, int units, int tile,
                     cudaStream_t stream) {
  const int tiles = static_cast<int>(
      (static_cast<int64_t>(num_rows) + tile - 1) / tile);
  auto* meta = reinterpret_cast<int32_t*>(
      scratch + static_cast<int64_t>(tiles) * 2 * units * kVec);
  segment_csr_tile_kernel<kMax, kVec, kL><<<tiles, kThreads, 0, stream>>>(
      x, ptr, valid, out, scratch, meta, num_rows, num_segments, units, tile);
  // The finish kernel may start while the tile kernel still runs
  // (programmatic dependent launch): it waits for that grid itself, after
  // the part that does not depend on it.
  const int warps = max(tiles, (num_segments + 31) / 32);
  cudaLaunchAttribute early;
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((warps + kWarps - 1) / kWarps);
  config.blockDim = dim3(kThreads);
  config.stream = stream;
  config.attrs = &early;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, segment_csr_finish_kernel<kMax, kVec>,
                            ptr, static_cast<const float*>(scratch),
                            static_cast<const int32_t*>(meta), out,
                            num_segments, units, tiles);
}

template <bool kMax, int kVec>
cudaError_t launch_v(const float* x, const int32_t* ptr, const uint8_t* valid,
                     float* out, float* scratch, int num_rows,
                     int num_segments, int units, int tile,
                     cudaStream_t stream) {
#define DVA_LAUNCH(L)                                                    \
  return launch_l<kMax, kVec, L>(x, ptr, valid, out, scratch, num_rows, \
                                 num_segments, units, tile, stream)
  if (units <= 1) DVA_LAUNCH(1);
  if (units <= 2) DVA_LAUNCH(2);
  if (units <= 4) DVA_LAUNCH(4);
  if (units <= 8) DVA_LAUNCH(8);
  if (units <= 16) DVA_LAUNCH(16);
  DVA_LAUNCH(32);
#undef DVA_LAUNCH
}

template <bool kMax>
cudaError_t launch(const float* x, const int32_t* ptr, const uint8_t* valid,
                   float* out, float* scratch, int num_rows, int num_segments,
                   int channels, int tile, cudaStream_t stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec4 =
      channels % 4 == 0 && aligned(x) && aligned(out) && aligned(scratch);
  if (vec4) {
    return launch_v<kMax, 4>(x, ptr, valid, out, scratch, num_rows,
                             num_segments, channels / 4, tile, stream);
  }
  return launch_v<kMax, 1>(x, ptr, valid, out, scratch, num_rows,
                           num_segments, channels, tile, stream);
}

}  // namespace

// x: f32 [E, C] row-major; ptr: int32 [S+1], non-decreasing, 0 <= ptr[0],
// ptr[S] <= E; valid: bool [E] or null; out: f32 [S, C]; scratch: 4-byte
// words [ceil(E / tile_rows), 2 C + 2], uninitialised (the partials, then
// two int32 per tile); tile_rows: a multiple of 32 in [32, 2048].
// reduce_max: 0 = sum, 1 = max.  Launches on `stream` without
// synchronising; returns cudaGetLastError() of the launches, or
// cudaErrorInvalidValue for a tile size it does not take.
extern "C" int segment_csr_f32(const void* x, const void* ptr,
                               const void* valid, void* out, void* scratch,
                               int num_rows, int num_segments, int channels,
                               int reduce_max, int tile_rows, void* stream) {
  if (num_segments <= 0 || channels <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (num_rows <= 0) {  // no tile: every segment is empty
    return static_cast<int>(cudaMemsetAsync(
        out, 0, sizeof(float) * num_segments * static_cast<size_t>(channels),
        s));
  }
  if (tile_rows < 32 || tile_rows > kMaxTile || tile_rows % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* xf = static_cast<const float*>(x);
  const auto* p = static_cast<const int32_t*>(ptr);
  const auto* v = static_cast<const uint8_t*>(valid);
  auto* o = static_cast<float*>(out);
  auto* sc = static_cast<float*>(scratch);
  const cudaError_t rc =
      reduce_max ? launch<true>(xf, p, v, o, sc, num_rows, num_segments,
                                channels, tile_rows, s)
                 : launch<false>(xf, p, v, o, sc, num_rows, num_segments,
                                 channels, tile_rows, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}
