// Sorted-segment (CSR) sum / max of float32 rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel deepviewagg_tpu/ops/pallas_segment.py::_scan_kernel
// (launched by _scan, pl.pallas_call at :109): there, a sorted-segment
// reduction is an inclusive segmented scan over 512-row chunks with a
// (value, id) carry between sequential grid steps, then a gather of row
// ptr[s+1]-1.  Hopper runs blocks in parallel with no carry, and collate
// already ships the CSR pointer, so here each segment is reduced directly:
//
//   out[s, c] = reduce_{r in [ptr[s], ptr[s+1]), valid[r]} x[r, c]
//
// with 0 for an empty or all-masked segment (and, for max, for any result at
// or below -5e29, as ops/segment.py's XLA path does).  Accumulation is f32 in
// a fixed order: deterministic, no atomics.
//
// Bound: bytes.  The call must read E*C*4 + E (valid) + 4*(S+1) (ptr) bytes
// and write S*C*4; at the flagship atomic pool (~389k x 128 rows -> ~83k
// views) that is ~240 MB, ~72 us at 3.35 TB/s.  There is no reuse to
// exploit, so the design reads every row at most once, with neighbouring
// lanes on neighbouring 16-byte addresses, skips masked rows without reading
// them, and writes every output once.
//
// Design: one warp per segment.  The warp walks its rows in windows of 32:
// each lane reads one validity byte per window, eight windows at once, and
// a ballot gives each window's mask of live rows, so a run of masked rows
// (the padding rows that collate sorts into the last, "drop" segment: ~10%
// of all rows, in ONE segment) costs one coalesced byte load per 32 rows,
// eight in flight, instead of a serial walk over the rows.  Within the
// warp, L lanes cover a row's channels (float4 when C % 4 == 0) and the
// 32 / L lane groups take the window's rows round-robin, so narrow inputs
// (C = 1 or 4: counts and softmax logits) use every lane; the groups'
// partials meet in a fixed xor-shuffle tree.  L is a template parameter
// (the smallest power of two covering the row, at most 32), so the row loop
// unrolls and its loads are in flight together.  Warps take the segments in
// reverse order, so the long padding segment starts first.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 (700 W limit): 0.155
// ms at the atomic pool, 2.1x its byte bound; a first version that walked
// each segment's rows one by one took 1.70 ms there, all of it in the
// padding segment.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSpan = 8;  // 32-row windows whose validity is read at once

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

// kVec: channels per lane load (1 or 4); kL: lanes per row (power of two).
// `units` = channels / kVec.
template <bool kMax, int kVec, int kL>
__global__ void __launch_bounds__(kThreads)
segment_csr_kernel(const float* __restrict__ x, const int32_t* __restrict__ ptr,
                   const uint8_t* __restrict__ valid, float* __restrict__ out,
                   int num_segments, int units) {
  using V = Vec<kVec>;
  using T = typename V::T;
  constexpr int kGroups = 32 / kL;
  // Segments in reverse order: the long padding segment is the LAST one, so
  // it starts first and overlaps the rest instead of running alone at the
  // end of the grid.
  const int seg = num_segments - 1 - (blockIdx.x * kWarps + threadIdx.x / 32);
  if (seg < 0) return;  // whole warp: seg is warp-uniform
  const int lane = threadIdx.x & 31;
  const int group = lane / kL;
  const int sub = lane % kL;
  const int r0 = ptr[seg];
  const int r1 = ptr[seg + 1];
  const T* __restrict__ xv = reinterpret_cast<const T*>(x);
  T* __restrict__ ov = reinterpret_cast<T*>(out);

  for (int c0 = 0; c0 < units; c0 += kL) {  // warp-uniform channel blocks
    const int c = c0 + sub;
    const bool active = c < units;
    T acc = V::fill(kMax ? kNeg : 0.0f);
    for (int base = r0; base < r1; base += 32 * kSpan) {  // warp-uniform
      // bit u of `live`: is row base + 32 u + lane present and unmasked?
      // The kSpan validity loads are independent, so they are in flight
      // together.
      unsigned live = 0u;
#pragma unroll
      for (int u = 0; u < kSpan; ++u) {
        const int r = base + 32 * u + lane;
        if (r < r1 && (valid == nullptr || valid[r] != 0)) live |= 1u << u;
      }
      if (__ballot_sync(kFull, live != 0u) == 0u) continue;
#pragma unroll(kL <= 4 ? kSpan : 1)
      for (int u = 0; u < kSpan && base + 32 * u < r1; ++u) {
        const unsigned mask = __ballot_sync(kFull, (live >> u) & 1u);
        if (mask == 0u) continue;
        const int64_t row0 = base + 32 * u;
#pragma unroll 8
        for (int k = 0; k < kL; ++k) {  // this group's rows of the window
          const int j = group + k * kGroups;
          if (active && ((mask >> j) & 1u)) {
            acc = V::template combine<kMax>(acc, xv[(row0 + j) * units + c]);
          }
        }
      }
    }
#pragma unroll
    for (int m = kL; m < 32; m <<= 1) {
      acc = V::template combine<kMax>(acc, V::shfl_xor(acc, m));
    }
    if (group == 0 && active) {
      ov[static_cast<int64_t>(seg) * units + c] = V::template finish<kMax>(acc);
    }
  }
}

template <bool kMax, int kVec, int kL>
void launch_l(const float* x, const int32_t* ptr, const uint8_t* valid,
              float* out, int num_segments, int units, cudaStream_t stream) {
  const dim3 grid((num_segments + kWarps - 1) / kWarps);
  segment_csr_kernel<kMax, kVec, kL><<<grid, kThreads, 0, stream>>>(
      x, ptr, valid, out, num_segments, units);
}

template <bool kMax, int kVec>
void launch_v(const float* x, const int32_t* ptr, const uint8_t* valid,
              float* out, int num_segments, int units, cudaStream_t stream) {
  if (units <= 1) {
    launch_l<kMax, kVec, 1>(x, ptr, valid, out, num_segments, units, stream);
  } else if (units <= 2) {
    launch_l<kMax, kVec, 2>(x, ptr, valid, out, num_segments, units, stream);
  } else if (units <= 4) {
    launch_l<kMax, kVec, 4>(x, ptr, valid, out, num_segments, units, stream);
  } else if (units <= 8) {
    launch_l<kMax, kVec, 8>(x, ptr, valid, out, num_segments, units, stream);
  } else if (units <= 16) {
    launch_l<kMax, kVec, 16>(x, ptr, valid, out, num_segments, units, stream);
  } else {
    launch_l<kMax, kVec, 32>(x, ptr, valid, out, num_segments, units, stream);
  }
}

template <bool kMax>
void launch(const float* x, const int32_t* ptr, const uint8_t* valid,
            float* out, int num_segments, int channels, cudaStream_t stream) {
  const bool vec4 = channels % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec4) {
    launch_v<kMax, 4>(x, ptr, valid, out, num_segments, channels / 4, stream);
  } else {
    launch_v<kMax, 1>(x, ptr, valid, out, num_segments, channels, stream);
  }
}

}  // namespace

// x: f32 [E, C] row-major; ptr: int32 [S+1], non-decreasing, ptr[S] <= E;
// valid: bool [E] or null; out: f32 [S, C].  reduce_max: 0 = sum, 1 = max.
// Launches on `stream` without synchronising; returns cudaGetLastError() of
// the launch.
extern "C" int segment_csr_f32(const void* x, const void* ptr,
                               const void* valid, void* out, int num_segments,
                               int channels, int reduce_max, void* stream) {
  if (num_segments <= 0 || channels <= 0) return 0;
  const auto* xf = static_cast<const float*>(x);
  const auto* p = static_cast<const int32_t*>(ptr);
  const auto* v = static_cast<const uint8_t*>(valid);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (reduce_max) {
    launch<true>(xf, p, v, o, num_segments, channels, s);
  } else {
    launch<false>(xf, p, v, o, num_segments, channels, s);
  }
  return static_cast<int>(cudaGetLastError());
}
