// A sample's colour jitter and ImageNet normalisation in one host pass,
// behind a plain C ABI.
//
// The numpy chain it replaces (data/transforms2d.py) is
// normalize_images(color_jitter(images)) on a raw [n, W, H, 3] stack, uint8
// or float32: the value (over 255 for uint8, and for a float stack whose
// max passes 1.5), then brightness, contrast and saturation in a drawn
// order with one float32 factor per image, a clip to [0, 1] and
// (v - mean) / std per channel; normalize_images alone has no clip.  Every
// step here is the same float32 operation in the same order, so the bytes
// out are numpy's: no FMA contraction (the library is built with
// -ffp-contract=off), no fast-math, true divisions.
//
// Contrast needs the mean of each image's gray plane before it, a
// reduction whose summation order is numpy's own.  So the caller
// (native/images.py) runs two passes: dva_jitter_gray writes the gray plane
// of the image as it stands before contrast, numpy takes its mean, and
// dva_jitter_normalize applies every op, the clip and the normalisation.
// Both passes start again from the input pixels (no intermediate).
//
// Threads split the pixels in contiguous chunks; each output element is
// written by one thread, so the bytes do not depend on the thread count.

#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

// op codes (see native/images.py)
constexpr int32_t BRIGHTNESS = 0;
constexpr int32_t CONTRAST = 1;
constexpr int32_t SATURATION = 2;

// input kinds (see native/images.py)
constexpr int32_t UINT8 = 0;        // u8 / 255
constexpr int32_t UNIT_FLOAT = 1;   // float32 as it is
constexpr int32_t BYTE_FLOAT = 2;   // float32 / 255

constexpr int OK = 0;
constexpr int BAD_ARGUMENT = 3;

// numpy multiplies a float32 array by the Python float 0.299 cast to
// float32: round the double, not the decimal
const float GRAY_R = (float)0.299;
const float GRAY_G = (float)0.587;
const float GRAY_B = (float)0.114;

constexpr int64_t TILE = 1024;          // pixels per vector pass
constexpr int64_t MIN_PARALLEL = 1 << 16;

inline float gray(float r, float g, float b) {
  return (GRAY_R * r + GRAY_G * g) + GRAY_B * b;
}

int64_t thread_count(int threads, int64_t work) {
  const size_t hw = threads > 0
                        ? (size_t)threads
                        : std::max(1u, std::thread::hardware_concurrency());
  return (int64_t)std::min<size_t>({hw, (size_t)std::max<int64_t>(work, 1),
                                    (size_t)16});
}

// Runs fn(image, lo, hi) over the pixels [0, n * pixels), cut into chunks
// that never cross an image.
template <typename Fn>
void for_pixels(int64_t n, int64_t pixels, int threads, Fn fn) {
  const int64_t total = n * pixels;
  const int64_t n_threads =
      total < MIN_PARALLEL ? 1 : thread_count(threads, total / MIN_PARALLEL);
  const int64_t chunk = (total + n_threads - 1) / n_threads;
  auto run = [&](int64_t lo, int64_t hi) {
    while (lo < hi) {
      const int64_t i = lo / pixels;
      const int64_t end = std::min(hi, (i + 1) * pixels);
      fn(i, lo - i * pixels, end - i * pixels);
      lo = end;
    }
  };
  if (n_threads <= 1) {
    run(0, total);
    return;
  }
  std::vector<std::thread> pool;
  for (int64_t t = 0; t < n_threads; ++t) {
    const int64_t lo = t * chunk, hi = std::min(total, lo + chunk);
    if (lo < hi) pool.emplace_back(run, lo, hi);
  }
  for (auto& th : pool) th.join();
}

// One tile of image i as float32 planes: m input pixels from pixel q on,
// read as `kind` says, then ops[0, n_ops) with image i's factors
// (factors[k * n + i]) and contrast means (means[i]).
struct Tile {
  float r[TILE], g[TILE], b[TILE];

  template <typename T>
  void read(const T* px, int64_t m, bool divide) {
    for (int64_t j = 0; j < m; ++j) {
      r[j] = (float)px[3 * j];
      g[j] = (float)px[3 * j + 1];
      b[j] = (float)px[3 * j + 2];
    }
    if (divide)
      for (int64_t j = 0; j < m; ++j) {
        r[j] = r[j] / 255.0f;
        g[j] = g[j] / 255.0f;
        b[j] = b[j] / 255.0f;
      }
  }

  void load(const void* img, int32_t kind, int64_t q, int64_t m) {
    if (kind == UINT8)
      read((const uint8_t*)img + 3 * q, m, true);
    else
      read((const float*)img + 3 * q, m, kind == BYTE_FLOAT);
  }

  void apply(const int32_t* ops, int32_t n_ops, const float* factors,
             const float* means, int64_t n, int64_t i, int64_t m) {
    for (int32_t k = 0; k < n_ops; ++k) {
      const float f = factors[k * n + i];
      if (ops[k] == BRIGHTNESS) {
        for (int64_t j = 0; j < m; ++j) {
          r[j] = r[j] * f;
          g[j] = g[j] * f;
          b[j] = b[j] * f;
        }
      } else if (ops[k] == CONTRAST) {
        const float mu = means[i];
        for (int64_t j = 0; j < m; ++j) {
          r[j] = (r[j] - mu) * f + mu;
          g[j] = (g[j] - mu) * f + mu;
          b[j] = (b[j] - mu) * f + mu;
        }
      } else {
        const float rest = 1.0f - f;
        for (int64_t j = 0; j < m; ++j) {
          const float y = gray(r[j], g[j], b[j]) * rest;
          r[j] = r[j] * f + y;
          g[j] = g[j] * f + y;
          b[j] = b[j] * f + y;
        }
      }
    }
  }
};

bool valid(int32_t kind, const int32_t* ops, int32_t n_ops) {
  if (kind < UINT8 || kind > BYTE_FLOAT) return false;
  for (int32_t k = 0; k < n_ops; ++k)
    if (ops[k] < BRIGHTNESS || ops[k] > SATURATION) return false;
  return true;
}

}  // namespace

extern "C" {

// gray [n, pixels]: the gray plane of each image of img [n, pixels, 3]
// (of `kind`) after ops[0, n_ops) (the ops drawn before contrast; no
// contrast here).
int dva_jitter_gray(const void* img, int32_t kind, int64_t n, int64_t pixels,
                    const int32_t* ops, int32_t n_ops, const float* factors,
                    float* out, int threads) {
  if (n < 0 || pixels < 0 || n_ops < 0 || !valid(kind, ops, n_ops))
    return BAD_ARGUMENT;
  for (int32_t k = 0; k < n_ops; ++k)
    if (ops[k] == CONTRAST) return BAD_ARGUMENT;
  for_pixels(n, pixels, threads, [&](int64_t i, int64_t lo, int64_t hi) {
    Tile t;
    for (int64_t p = lo; p < hi; p += TILE) {
      const int64_t m = std::min(TILE, hi - p);
      t.load(img, kind, i * pixels + p, m);
      t.apply(ops, n_ops, factors, nullptr, n, i, m);
      float* o = out + i * pixels + p;
      for (int64_t j = 0; j < m; ++j) o[j] = gray(t.r[j], t.g[j], t.b[j]);
    }
  });
  return OK;
}

// out [n, pixels, 3] = (clip(ops(img), 0, 1) - mean) / std (no clip unless
// `clip`), with img read as `kind` says and means[i] the contrast mean of
// image i (unread without a contrast op).
int dva_jitter_normalize(const void* img, int32_t kind, int64_t n,
                         int64_t pixels, const int32_t* ops, int32_t n_ops,
                         const float* factors, const float* means,
                         int32_t clip, const float* mean, const float* std_,
                         float* out, int threads) {
  if (n < 0 || pixels < 0 || n_ops < 0 || !valid(kind, ops, n_ops))
    return BAD_ARGUMENT;
  const float m0 = mean[0], m1 = mean[1], m2 = mean[2];
  const float s0 = std_[0], s1 = std_[1], s2 = std_[2];
  for_pixels(n, pixels, threads, [&](int64_t i, int64_t lo, int64_t hi) {
    Tile t;
    for (int64_t p = lo; p < hi; p += TILE) {
      const int64_t m = std::min(TILE, hi - p);
      t.load(img, kind, i * pixels + p, m);
      t.apply(ops, n_ops, factors, means, n, i, m);
      if (clip)
        for (int64_t j = 0; j < m; ++j) {
          t.r[j] = std::min(std::max(t.r[j], 0.0f), 1.0f);
          t.g[j] = std::min(std::max(t.g[j], 0.0f), 1.0f);
          t.b[j] = std::min(std::max(t.b[j], 0.0f), 1.0f);
        }
      float* o = out + 3 * (i * pixels + p);
      for (int64_t j = 0; j < m; ++j) {
        o[3 * j] = (t.r[j] - m0) / s0;
        o[3 * j + 1] = (t.g[j] - m1) / s1;
        o[3 * j + 2] = (t.b[j] - m2) / s2;
      }
    }
  });
  return OK;
}

}  // extern "C"
