// Gradient of the sorted-segment (CSR) sum / max of float32 rows, for Hopper
// (sm_90a): the backward of segment_csr.cu.
//
// Replaces the hand-written backwards of the TPU kernel
// deepviewagg_tpu/ops/pallas_segment.py::_scan_kernel (_sum_bwd :177,
// _max_bwd :200): there, one row gather of the cotangent (sum), or of the
// concatenated (max, cotangent) table with an equality mask (max).  Here, for
// row r in segment s(r) = the s with ptr[s] <= r < ptr[s+1]:
//
//   sum:  gx[r, c] = valid[r] ? g[s(r), c] : 0
//   max:  gx[r, c] = valid[r] && x[r, c] == out[s(r), c] && x[r, c] > -5e29
//                    ? g[s(r), c] : 0
//
// Every element that attains its segment's maximum gets the whole cotangent
// (ties are not split); the equality is exact because the forward never
// rounds; the -5e29 guard keeps gradient out of masked fills and all-masked
// segments.  Rows outside [ptr[0], ptr[S]) get 0.  gx is written everywhere,
// once; there are no atomics, so the result is bit-reproducible.
//
// Bound: bytes.  Sum must read S*C*4 (g) + E (valid) + 4*(S+1) (ptr) and
// write E*C*4; max also reads E*C*4 (x) and S*C*4 (out).  At the flagship
// atomic pool (~389k x 128 rows, ~82k views) that is ~0.5 GB for max, ~0.14
// ms at 3.35 TB/s.  (The forward's formula is in segment_csr.cu: E*C*4 + E +
// 4*(S+1) read, S*C*4 written.)
//
// Design: row-parallel, s(r) found from ptr.  The forward's one warp per
// segment would meet its old wall here: collate sorts the ~10% padding rows
// into ONE last segment, and the backward must write (zeros to) all of them,
// so one warp would walk ~35k rows alone.  With one warp per tile of 32
// consecutive rows there is no long segment at all.  Lane i of the warp finds
// the segment of row base + i by a binary search in ptr (the same ptr the
// forward reduced over, so forward and backward route exactly the same rows;
// the callers' per-row ids are clamped and padded differently and would have
// to be trusted to agree).  ptr is 4*(S+1) bytes, far less than 4*E of ids,
// and neighbouring lanes walk the same few cache lines of it.  Masked rows
// skip the search and read nothing: they only write zeros.  Then the warp
// walks its 32 rows: L lanes cover a row's channels (float4 when C % 4 == 0)
// and the 32 / L lane groups take the rows round-robin, the segment id coming
// from the searching lane by shuffle, so narrow inputs (C = 1 or 4: counts
// and softmax logits) use every lane.  Rows of one segment are neighbours, so
// their reads of g and out hit in cache after the first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;  // the forward's masked fill
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

template <bool kMax>
__device__ __forceinline__ float pick1(float g, float x, float o) {
  return (!kMax || (x == o && x > kNeg / 2)) ? g : 0.0f;
}

// A row slice of 1 (float) or 4 (float4) channels.
template <int kVec>
struct Vec;

template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.0f; }
  template <bool kMax>
  static __device__ __forceinline__ T pick(T g, T x, T o) {
    return pick1<kMax>(g, x, o);
  }
};

template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() {
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  template <bool kMax>
  static __device__ __forceinline__ T pick(T g, T x, T o) {
    return make_float4(pick1<kMax>(g.x, x.x, o.x), pick1<kMax>(g.y, x.y, o.y),
                       pick1<kMax>(g.z, x.z, o.z), pick1<kMax>(g.w, x.w, o.w));
  }
};

// The segment of row r: the last s with ptr[s] <= r (an upper bound minus
// one, so empty segments are skipped), or -1 outside [ptr[0], ptr[S]).
__device__ __forceinline__ int find_segment(const int32_t* __restrict__ ptr,
                                            int num_segments, int r) {
  int lo = 0, hi = num_segments + 1;  // first index with ptr[index] > r
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ptr[mid] <= r) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int s = lo - 1;
  return s < num_segments ? s : -1;
}

// kVec: channels per lane access (1 or 4); kL: lanes per row (power of two).
// `units` = channels / kVec.
template <bool kMax, int kVec, int kL>
__global__ void __launch_bounds__(kThreads)
segment_csr_bwd_kernel(const float* __restrict__ g, const float* __restrict__ x,
                       const float* __restrict__ out,
                       const int32_t* __restrict__ ptr,
                       const uint8_t* __restrict__ valid,
                       float* __restrict__ gx, int num_rows, int num_segments,
                       int units) {
  using V = Vec<kVec>;
  using T = typename V::T;
  constexpr int kGroups = 32 / kL;
  const int64_t base =
      (static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32) * 32;
  if (base >= num_rows) return;  // whole warp: base is warp-uniform
  const int lane = threadIdx.x & 31;
  const int group = lane / kL;
  const int sub = lane % kL;

  // lane i: the segment of row base + i, or -1 for a row that gets zeros
  int seg = -1;
  {
    const int64_t r = base + lane;
    if (r < num_rows && (valid == nullptr || valid[r] != 0)) {
      seg = find_segment(ptr, num_segments, static_cast<int>(r));
    }
  }

  const T* __restrict__ gv = reinterpret_cast<const T*>(g);
  const T* __restrict__ xv = reinterpret_cast<const T*>(x);
  const T* __restrict__ ov = reinterpret_cast<const T*>(out);
  T* __restrict__ gxv = reinterpret_cast<T*>(gx);

#pragma unroll 4
  for (int k = 0; k < kL; ++k) {  // this group's rows of the tile
    const int j = group + k * kGroups;
    const int s = __shfl_sync(kFull, seg, j);  // every lane takes part
    const int64_t r = base + j;
    if (r >= num_rows) continue;
    for (int c = sub; c < units; c += kL) {
      T v = V::zero();
      if (s >= 0) {
        const int64_t so = static_cast<int64_t>(s) * units + c;
        if (kMax) {
          v = V::template pick<true>(gv[so], xv[r * units + c], ov[so]);
        } else {
          v = gv[so];
        }
      }
      gxv[r * units + c] = v;
    }
  }
}

template <bool kMax, int kVec, int kL>
void launch_l(const float* g, const float* x, const float* out,
              const int32_t* ptr, const uint8_t* valid, float* gx,
              int num_rows, int num_segments, int units, cudaStream_t stream) {
  const int64_t tiles = (static_cast<int64_t>(num_rows) + 31) / 32;
  const dim3 grid(static_cast<unsigned>((tiles + kWarps - 1) / kWarps));
  segment_csr_bwd_kernel<kMax, kVec, kL><<<grid, kThreads, 0, stream>>>(
      g, x, out, ptr, valid, gx, num_rows, num_segments, units);
}

template <bool kMax, int kVec>
void launch_v(const float* g, const float* x, const float* out,
              const int32_t* ptr, const uint8_t* valid, float* gx,
              int num_rows, int num_segments, int units, cudaStream_t stream) {
  if (units <= 1) {
    launch_l<kMax, kVec, 1>(g, x, out, ptr, valid, gx, num_rows, num_segments,
                            units, stream);
  } else if (units <= 2) {
    launch_l<kMax, kVec, 2>(g, x, out, ptr, valid, gx, num_rows, num_segments,
                            units, stream);
  } else if (units <= 4) {
    launch_l<kMax, kVec, 4>(g, x, out, ptr, valid, gx, num_rows, num_segments,
                            units, stream);
  } else if (units <= 8) {
    launch_l<kMax, kVec, 8>(g, x, out, ptr, valid, gx, num_rows, num_segments,
                            units, stream);
  } else if (units <= 16) {
    launch_l<kMax, kVec, 16>(g, x, out, ptr, valid, gx, num_rows, num_segments,
                             units, stream);
  } else {
    launch_l<kMax, kVec, 32>(g, x, out, ptr, valid, gx, num_rows, num_segments,
                             units, stream);
  }
}

template <bool kMax>
void launch(const float* g, const float* x, const float* out,
            const int32_t* ptr, const uint8_t* valid, float* gx, int num_rows,
            int num_segments, int channels, cudaStream_t stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec4 = channels % 4 == 0 && aligned(g) && aligned(gx) &&
                    (!kMax || (aligned(x) && aligned(out)));
  if (vec4) {
    launch_v<kMax, 4>(g, x, out, ptr, valid, gx, num_rows, num_segments,
                      channels / 4, stream);
  } else {
    launch_v<kMax, 1>(g, x, out, ptr, valid, gx, num_rows, num_segments,
                      channels, stream);
  }
}

}  // namespace

// g: f32 [S, C] row-major, the cotangent of the forward's result; x: f32
// [E, C] and out: f32 [S, C], the forward's input and result (read for max
// only; may be null for sum); ptr: int32 [S+1], non-decreasing, ptr[S] <= E;
// valid: bool [E] or null; gx: f32 [E, C].  reduce_max: 0 = sum, 1 = max.
// Launches on `stream` without synchronising; returns cudaGetLastError() of
// the launch.
extern "C" int segment_csr_bwd_f32(const void* g, const void* x,
                                   const void* out, const void* ptr,
                                   const void* valid, void* gx, int num_rows,
                                   int num_segments, int channels,
                                   int reduce_max, void* stream) {
  if (num_rows <= 0 || channels <= 0) return 0;
  const auto* gf = static_cast<const float*>(g);
  const auto* xf = static_cast<const float*>(x);
  const auto* of = static_cast<const float*>(out);
  const auto* p = static_cast<const int32_t*>(ptr);
  const auto* v = static_cast<const uint8_t*>(valid);
  auto* o = static_cast<float*>(gx);
  auto s = static_cast<cudaStream_t>(stream);
  if (reduce_max) {
    launch<true>(gf, xf, of, p, v, o, num_rows, num_segments, channels, s);
  } else {
    launch<false>(gf, xf, of, p, v, o, num_rows, num_segments, channels, s);
  }
  return static_cast<int>(cudaGetLastError());
}
