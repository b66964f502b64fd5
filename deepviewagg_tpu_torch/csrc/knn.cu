// Exact k nearest neighbours of every point among the points of its own
// sample, over a grid of cells, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package searches on the host
// (native/kernelmap.cpp's cell lists, there stopped 16 rings out) or by
// brute force (ops/knn.py::knn).  It was added for Point Transformer V2,
// which searches the 8 or 16 nearest points of every point of every level
// in the forward (Pointcept's pointops.knn_query): 1.2 million points at
// level 0 of the benchmark's batch, where the brute force takes seconds.
//
// Inputs: pos f32 [n, 3], the rows of each sample contiguous, sample b's
// rows [off[b], off[b + 1]).  Per sample the wrapper (ops/knn.py) gives the
// minimum corner lo[b] and a cell edge h[b] (> 0), with ncell[b] cells a
// side (each below 2^14).  A point's cell is floor((p - lo) / h) on each
// axis, rounded as IEEE float32 (cell_of), and its key
//
//   b << 42 | cz << 28 | cy << 14 | cx
//
// sorts the points by sample, then z, y, x (the wrapper sorts the keys
// with torch.sort).  The cells of one (b, z, y) row are one run of keys.
//
// knn_search_kernel: one thread a query, the queries in key order (threads
// of a warp share cells).  The thread keeps the K best candidates in
// registers, ordered by (squared distance, row), and searches rings of
// cells around its own: ring r is the cells at Chebyshev distance r, found
// by one binary search a (z, y) row of the ring (the rows inside the ring
// give their two end cells).  After ring r every point closer than the
// query's distance to the faces of the searched box of cells has been
// seen; the search stops when the K-th best lies inside that distance (less
// a margin of 1/512 cell for the rounding of cell_of), or when the box
// covers the sample.  Beyond kMaxRing rings (a query far from the others of
// its sample) it starts again over the sample's whole row range, which is
// exact too.
//
// Distances are dx*dx + dy*dy + dz*dz in float32 in that order, with d =
// p_j - p_i, each product and sum rounded on its own (no fused multiply-add:
// the __fmul_rn / __fadd_rn intrinsics), and ties go to the lower row, so
// that the result equals the plain brute force (ops/knn.py::
// knn_points_plain) index for index.  Slots beyond the sample's size read
// row -1.
//
// Bound: bytes.  A call must read the points (12 B a row) and write the
// table (4 K B a row): at 1.2 million rows and K = 16, 93 MB, 28 us at 3.35
// TB/s.  The candidates a query reads come from L1 / L2: each cell is read
// by every query of the cells around it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRing = 6;
constexpr int kShiftY = 14;
constexpr int kShiftZ = 28;
constexpr int kShiftB = 42;
constexpr int64_t kAxisMask = (int64_t{1} << 14) - 1;
constexpr float kMargin = 1.0f / 512.0f;   // cells
// the candidates a query keeps: Point Transformer V2's widest table (its
// narrower one, 8, is the first 8 columns of this exact table)
constexpr int K = 16;

__device__ __forceinline__ int cell_of(float p, float lo, float h, int n) {
  const int c = static_cast<int>(floorf(__fdiv_rn(__fsub_rn(p, lo), h)));
  return c < 0 ? 0 : (c >= n ? n - 1 : c);
}

__device__ __forceinline__ int64_t make_key(int64_t b, int z, int y, int x) {
  return (b << kShiftB) | (static_cast<int64_t>(z) << kShiftZ) |
         (static_cast<int64_t>(y) << kShiftY) | static_cast<int64_t>(x);
}

// rows -> sample ids and keys
__global__ void knn_keys_kernel(const float* __restrict__ pos,
                                const int* __restrict__ sample,
                                const float* __restrict__ lo,
                                const float* __restrict__ h,
                                const int* __restrict__ ncell,
                                int64_t* __restrict__ keys, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int b = sample[i];
  const float hb = h[b];
  const int cx = cell_of(pos[3 * i], lo[3 * b], hb, ncell[3 * b]);
  const int cy = cell_of(pos[3 * i + 1], lo[3 * b + 1], hb, ncell[3 * b + 1]);
  const int cz = cell_of(pos[3 * i + 2], lo[3 * b + 2], hb, ncell[3 * b + 2]);
  keys[i] = make_key(b, cz, cy, cx);
}

struct TopK {
  float d[K];
  int id[K];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      d[s] = INFINITY;
      id[s] = INT32_MAX;
    }
  }

  // insert (dist, row) if it beats the K-th; the array stays sorted
  __device__ __forceinline__ void push(float dist, int row) {
    if (dist > d[K - 1] || (dist == d[K - 1] && row >= id[K - 1])) return;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const bool lt = dist < d[s] || (dist == d[s] && row < id[s]);
      if (lt) {
        const float td = d[s];
        const int ti = id[s];
        d[s] = dist;
        id[s] = row;
        dist = td;
        row = ti;
      }
    }
  }
};

__device__ __forceinline__ int lower_bound(const int64_t* __restrict__ keys,
                                           int lo, int hi, int64_t key) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (keys[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ void visit(const float* __restrict__ spos,
                                      const int* __restrict__ perm, int j,
                                      float qx, float qy, float qz,
                                      TopK& best) {
  const float dx = __fsub_rn(spos[3 * j], qx);
  const float dy = __fsub_rn(spos[3 * j + 1], qy);
  const float dz = __fsub_rn(spos[3 * j + 2], qz);
  const float dist = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                               __fmul_rn(dz, dz));
  best.push(dist, perm[j]);
}

// every point of the key run [k0, k1] of the sorted range [lo, hi)
__device__ __forceinline__ void scan_run(const int64_t* __restrict__ skey,
                                         const float* __restrict__ spos,
                                         const int* __restrict__ perm, int lo,
                                         int hi, int64_t k0, int64_t k1,
                                         float qx, float qy, float qz,
                                         TopK& best) {
  for (int j = lower_bound(skey, lo, hi, k0); j < hi && skey[j] <= k1; ++j) {
    visit(spos, perm, j, qx, qy, qz, best);
  }
}

__global__ void __launch_bounds__(kThreads)
    knn_search_kernel(const float* __restrict__ spos,
                      const int64_t* __restrict__ skey,
                      const int* __restrict__ perm,
                      const int* __restrict__ off, const float* __restrict__ lo,
                      const float* __restrict__ h,
                      const int* __restrict__ ncell, int* __restrict__ out,
                      int n) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const int64_t key = skey[t];
  const int b = static_cast<int>(key >> kShiftB);
  const int cx = static_cast<int>(key & kAxisMask);
  const int cy = static_cast<int>((key >> kShiftY) & kAxisMask);
  const int cz = static_cast<int>((key >> kShiftZ) & kAxisMask);
  const int nx = ncell[3 * b], ny = ncell[3 * b + 1], nz = ncell[3 * b + 2];
  const int lo_row = off[b], hi_row = off[b + 1];
  const float qx = spos[3 * t], qy = spos[3 * t + 1], qz = spos[3 * t + 2];
  const float hb = h[b];
  // the query's place in its cell, in cells
  const float ux = __fdiv_rn(__fsub_rn(qx, lo[3 * b]), hb);
  const float uy = __fdiv_rn(__fsub_rn(qy, lo[3 * b + 1]), hb);
  const float uz = __fdiv_rn(__fsub_rn(qz, lo[3 * b + 2]), hb);
  TopK best;
  best.clear();
  bool done = false;
  for (int r = 0; r <= kMaxRing && !done; ++r) {
    for (int dz = -r; dz <= r; ++dz) {
      const int z = cz + dz;
      if (z < 0 || z >= nz) continue;
      for (int dy = -r; dy <= r; ++dy) {
        const int y = cy + dy;
        if (y < 0 || y >= ny) continue;
        const int x0 = max(cx - r, 0), x1 = min(cx + r, nx - 1);
        if (max(abs(dz), abs(dy)) == r) {
          scan_run(skey, spos, perm, lo_row, hi_row, make_key(b, z, y, x0),
                      make_key(b, z, y, x1), qx, qy, qz, best);
        } else {
          if (cx - r >= 0) {
            const int64_t k = make_key(b, z, y, cx - r);
            scan_run(skey, spos, perm, lo_row, hi_row, k, k, qx, qy, qz,
                        best);
          }
          if (cx + r < nx) {
            const int64_t k = make_key(b, z, y, cx + r);
            scan_run(skey, spos, perm, lo_row, hi_row, k, k, qx, qy, qz,
                        best);
          }
        }
      }
    }
    // the distance, in cells, from the query to the faces of the searched
    // box that have cells of the sample beyond them
    float gap = INFINITY;
    if (cx - r > 0) gap = fminf(gap, ux - static_cast<float>(cx - r));
    if (cx + r < nx - 1) gap = fminf(gap, static_cast<float>(cx + r + 1) - ux);
    if (cy - r > 0) gap = fminf(gap, uy - static_cast<float>(cy - r));
    if (cy + r < ny - 1) gap = fminf(gap, static_cast<float>(cy + r + 1) - uy);
    if (cz - r > 0) gap = fminf(gap, uz - static_cast<float>(cz - r));
    if (cz + r < nz - 1) gap = fminf(gap, static_cast<float>(cz + r + 1) - uz);
    if (gap == INFINITY) {
      done = true;                     // the box covers the sample
    } else if (gap > kMargin) {
      const float reach = (gap - kMargin) * hb;
      done = best.d[K - 1] <= reach * reach;
    }
  }
  if (!done) {
    best.clear();
    for (int j = lo_row; j < hi_row; ++j) {
      visit(spos, perm, j, qx, qy, qz, best);
    }
  }
  const int q = perm[t];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    out[static_cast<int64_t>(q) * K + s] =
        best.id[s] != INT32_MAX ? best.id[s] : -1;
  }
}

}  // namespace

// pos: f32 [n, 3]; sample: int32 [n], each row's sample; lo: f32 [B, 3];
// h: f32 [B]; ncell: int32 [B, 3]; keys: int64 [n] out.  Launches on
// `stream` without synchronising; returns cudaGetLastError().
extern "C" int knn_keys_f32(const void* pos, const void* sample, const void* lo,
                            const void* h, const void* ncell, void* keys, int n,
                            void* stream) {
  if (n <= 0) return 0;
  knn_keys_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<const int*>(sample),
      static_cast<const float*>(lo), static_cast<const float*>(h),
      static_cast<const int*>(ncell), static_cast<int64_t*>(keys), n);
  return static_cast<int>(cudaGetLastError());
}

// spos: f32 [n, 3], the points in key order; skey: int64 [n], their sorted
// keys; perm: int32 [n], their rows; off: int32 [B + 1]; lo, h, ncell as for
// knn_keys_f32; out: int32 [n, 16] by row.  Launches on `stream` without
// synchronising; returns cudaGetLastError().
extern "C" int knn_search_f32(const void* spos, const void* skey,
                              const void* perm, const void* off, const void* lo,
                              const void* h, const void* ncell, void* out,
                              int n, void* stream) {
  if (n <= 0) return 0;
  knn_search_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(spos), static_cast<const int64_t*>(skey),
      static_cast<const int*>(perm), static_cast<const int*>(off),
      static_cast<const float*>(lo), static_cast<const float*>(h),
      static_cast<const int*>(ncell), static_cast<int*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
