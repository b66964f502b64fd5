// Host-side voxel hashing, kernel maps and grid kNN, behind a plain C ABI.
//
// The port's copy of deepviewagg_tpu/native/kernelmap.cpp: the same
// algorithms and the same bytes out, but no CPython or numpy headers.  The
// caller (deepviewagg_tpu_torch/native/__init__.py, through ctypes) checks
// shapes and dtypes, allocates every output and passes raw pointers; each
// function returns 0, or a code that the caller turns into an exception.
//
// The role is that of torchsparse's sphash / sphashquery in the reference
// (modules/SparseConv3d/nn/torchsparse.py; modules/multimodal/modules.py:
// 194-211): the dense neighbour tables the gather-GEMM sparse convolution
// reads, built on the host at collate time by an open-addressing hash table
// (O(N + K*M)) instead of a per-offset sort + searchsorted (O(K*M log N)).
//
// Keys pack (batch, x, y, z) as ops/voxel.py does: 19 bits per spatial axis
// (bias 2^18), the batch in the top bits.  The same int64 keys give the same
// sorted-unique order as the numpy path.

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <utility>
#include <vector>

namespace {

constexpr int SHIFT = 19;
constexpr int64_t BIAS = 1 << (SHIFT - 1);
constexpr int32_t MAX_COORD = (int32_t)(BIAS - 1);
constexpr int64_t MAX_BATCH = (int64_t)1 << (63 - 3 * SHIFT);

// return codes (see native/__init__.py)
constexpr int OK = 0;
constexpr int FIRST_OUT_OF_RANGE = 1;   // a row of the first coordinate array
constexpr int SECOND_OUT_OF_RANGE = 2;  // a row of the second one
constexpr int BAD_ARGUMENT = 3;

inline int64_t pack(const int32_t* row) {
  int64_t key = row[0];
  for (int i = 1; i < 4; ++i) key = (key << SHIFT) | (row[i] + BIAS);
  return key;
}

// The first row whose coordinates would corrupt a packed key, or -1.
int64_t first_out_of_range(const int32_t* c, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* row = c + 4 * i;
    if (row[0] < 0 || (int64_t)row[0] >= MAX_BATCH ||
        std::abs(row[1]) > MAX_COORD || std::abs(row[2]) > MAX_COORD ||
        std::abs(row[3]) > MAX_COORD)
      return i;
  }
  return -1;
}

// open-addressing hash table: int64 key -> int32 value
struct HashTable {
  std::vector<int64_t> keys;
  std::vector<int32_t> vals;
  uint64_t mask;

  explicit HashTable(size_t n) {
    size_t cap = 16;
    while (cap < 2 * n + 1) cap <<= 1;
    keys.assign(cap, -1);
    vals.assign(cap, -1);
    mask = cap - 1;
  }

  static inline uint64_t mix(int64_t k) {
    uint64_t h = (uint64_t)k;
    h ^= h >> 33;
    h *= 0xff51afd7ed558ccdULL;
    h ^= h >> 33;
    h *= 0xc4ceb9fe1a85ec53ULL;
    h ^= h >> 33;
    return h;
  }

  inline void insert(int64_t key, int32_t val) {
    uint64_t i = mix(key) & mask;
    while (keys[i] != -1 && keys[i] != key) i = (i + 1) & mask;
    if (keys[i] == -1) {
      keys[i] = key;
      vals[i] = val;
    }
    // duplicate keys keep the first value (coords are unique by contract)
  }

  inline int32_t find(int64_t key) const {
    uint64_t i = mix(key) & mask;
    while (keys[i] != -1) {
      if (keys[i] == key) return vals[i];
      i = (i + 1) & mask;
    }
    return -1;
  }
};

// Threads for `work` items: `threads` if positive, else the host's cores;
// at most 16 and at most one per item.
int64_t thread_count(int threads, int64_t work) {
  const size_t hw = threads > 0
                        ? (size_t)threads
                        : std::max(1u, std::thread::hardware_concurrency());
  return (int64_t)std::min<size_t>({hw, (size_t)std::max<int64_t>(work, 1),
                                    (size_t)16});
}

// Runs fn(lo, hi) over [0, n) in n_threads contiguous chunks.  Each output
// row is written by one thread, so the bytes do not depend on the count.
template <typename Fn>
void parallel_chunks(int64_t n, int64_t n_threads, Fn fn) {
  std::vector<std::thread> pool;
  const int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    const int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
    if (lo < hi) pool.emplace_back(fn, lo, hi);
  }
  for (auto& th : pool) th.join();
}

// ------------------------------------------------------------------------
// Grid-cell exact kNN for host-side preprocessing at scale.
//
// The reference leans on KDTree / FAISS for its per-point PCA neighbourhoods
// (core/data_transform/features.py:360); a blocked brute-force kNN is
// O(N^2).  Cell lists give exact kNN in O(N * ring candidates): bucket
// points into cubic cells, expand Chebyshev rings around each query until
// the k-th best distance beats the next ring's least possible distance.
// floor(p / cell) is packed with no range check: past 2^18 cells per axis
// (tiny cells or far coordinates) cells alias, which only adds candidates
// (the distances are computed exactly).

struct CellIndex {
  HashTable cells;               // cell key -> bucket id
  std::vector<int32_t> starts;   // CSR over buckets
  std::vector<int32_t> members;  // point ids per bucket
  float cell;

  CellIndex(const float* pts, int64_t n, float cell_size)
      : cells((size_t)n), cell(cell_size) {
    std::vector<int64_t> keys((size_t)n);
    int32_t n_cells = 0;
    std::vector<int32_t> bucket_of((size_t)n);
    for (int64_t i = 0; i < n; ++i) {
      keys[i] = key_of(pts + 3 * i);
      int32_t b = cells.find(keys[i]);
      if (b < 0) {
        b = n_cells++;
        cells.insert(keys[i], b);
      }
      bucket_of[i] = b;
    }
    std::vector<int32_t> counts((size_t)n_cells, 0);
    for (int64_t i = 0; i < n; ++i) counts[bucket_of[i]]++;
    starts.assign((size_t)n_cells + 1, 0);
    for (int32_t b = 0; b < n_cells; ++b) starts[b + 1] = starts[b] + counts[b];
    members.resize((size_t)n);
    std::vector<int32_t> cursor(starts.begin(), starts.end() - 1);
    for (int64_t i = 0; i < n; ++i) members[cursor[bucket_of[i]]++] = (int32_t)i;
  }

  inline int64_t key_of(const float* p) const {
    int32_t c[4] = {0, (int32_t)std::floor(p[0] / cell),
                    (int32_t)std::floor(p[1] / cell),
                    (int32_t)std::floor(p[2] / cell)};
    return pack(c);
  }

  inline int64_t key_at(int32_t cx, int32_t cy, int32_t cz) const {
    int32_t c[4] = {0, cx, cy, cz};
    return pack(c);
  }
};

}  // namespace

extern "C" {

// nbr [k, cap_out] (row-major) = the row of in_coords [n, 4] at
// out_coords[o] + offsets[kk] * stride, or pad = cap_in; columns past m are
// pad.  Writing straight into the padded capacity spares the collate the
// copies a re-pad would cost.  *bad_row: the offending row on codes 1 / 2.
int dva_build_kernel_map(const int32_t* in_c, int64_t n, const int32_t* out_c,
                         int64_t m, const int32_t* offs, int64_t k,
                         int32_t stride, int64_t cap_in, int64_t cap_out,
                         int32_t* nbr, int threads, int64_t* bad_row) {
  if ((*bad_row = first_out_of_range(in_c, n)) >= 0) return FIRST_OUT_OF_RANGE;
  if ((*bad_row = first_out_of_range(out_c, m)) >= 0)
    return SECOND_OUT_OF_RANGE;
  if (cap_in < n || cap_out < m || cap_in > INT32_MAX) return BAD_ARGUMENT;
  const int32_t pad = (int32_t)cap_in;
  HashTable table((size_t)n);
  for (int64_t i = 0; i < n; ++i) table.insert(pack(in_c + 4 * i), (int32_t)i);
  auto probe_rows = [&](int64_t k_lo, int64_t k_hi) {
    // the table is read-only here: rows are probed concurrently
    for (int64_t kk = k_lo; kk < k_hi; ++kk) {
      const int32_t ox = offs[3 * kk] * stride;
      const int32_t oy = offs[3 * kk + 1] * stride;
      const int32_t oz = offs[3 * kk + 2] * stride;
      int32_t* row = nbr + kk * cap_out;
      for (int64_t o = 0; o < m; ++o) {
        const int32_t* oc = out_c + 4 * o;
        int32_t q[4] = {oc[0], oc[1] + ox, oc[2] + oy, oc[3] + oz};
        int32_t hit = table.find(pack(q));
        row[o] = hit >= 0 ? hit : pad;
      }
      for (int64_t o = m; o < cap_out; ++o) row[o] = pad;
    }
  };
  const int64_t n_threads = thread_count(threads, k);
  if (n_threads <= 1 || k * m < (1 << 18))
    probe_rows(0, k);
  else
    parallel_chunks(k, n_threads, probe_rows);
  return OK;
}

// uniq [n, 4] (its first *m_out rows) in ascending key order, each the first
// occurrence of its key; inverse [n]: the unique row of every input row.
int dva_unique_inverse(const int32_t* c, int64_t n, int32_t* uniq,
                       int32_t* inverse, int64_t* m_out, int64_t* bad_row) {
  if ((*bad_row = first_out_of_range(c, n)) >= 0) return FIRST_OUT_OF_RANGE;
  std::vector<int64_t> keys((size_t)n);
  std::vector<int32_t> order((size_t)n);
  for (int64_t i = 0; i < n; ++i) {
    keys[i] = pack(c + 4 * i);
    order[i] = (int32_t)i;
  }
  std::stable_sort(order.begin(), order.end(),
                   [&](int32_t a, int32_t b) { return keys[a] < keys[b]; });
  int64_t m = 0;
  int64_t prev = INT64_MIN;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t idx = order[i];
    if (keys[idx] != prev) {
      prev = keys[idx];
      // first occurrence in key order
      std::memcpy(uniq + 4 * m, c + 4 * (int64_t)idx, 4 * sizeof(int32_t));
      ++m;
    }
    inverse[idx] = (int32_t)(m - 1);
  }
  *m_out = m;
  return OK;
}

// out [m]: the row of table [n, 4] (unique rows) equal to each query, or -1.
int dva_query_coords(const int32_t* tab, int64_t n, const int32_t* q,
                     int64_t m, int32_t* out, int64_t* bad_row) {
  if ((*bad_row = first_out_of_range(tab, n)) >= 0) return FIRST_OUT_OF_RANGE;
  if ((*bad_row = first_out_of_range(q, m)) >= 0) return SECOND_OUT_OF_RANGE;
  HashTable table((size_t)n);
  for (int64_t i = 0; i < n; ++i) table.insert(pack(tab + 4 * i), (int32_t)i);
  for (int64_t i = 0; i < m; ++i) out[i] = table.find(pack(q + 4 * i));
  return OK;
}

// d2 [m, k] ascending and idx [m, k] of the k nearest of points [n, 3] to
// each query [m, 3]; a neighbourhood shorter than k (fewer than k points
// within R_MAX rings) is padded by repeating its nearest hit (covariance-
// shrinking semantics, like pca_features' r_search clamp); a query with no
// point within R_MAX rings gets idx -1.
int dva_knn_grid(const float* pts, int64_t n, const float* qs, int64_t m,
                 int64_t k, double cell, float* d2_out, int32_t* idx_out,
                 int threads) {
  if (n < 1 || k < 1 || !(cell > 0)) return BAD_ARGUMENT;
  CellIndex index(pts, n, (float)cell);
  constexpr int R_MAX = 16;
  auto run = [&](int64_t lo, int64_t hi) {
    std::vector<std::pair<float, int32_t>> heap;  // max-heap on d2
    heap.reserve((size_t)k);
    for (int64_t qi = lo; qi < hi; ++qi) {
      const float* q = qs + 3 * qi;
      const int32_t qcx = (int32_t)std::floor(q[0] / index.cell);
      const int32_t qcy = (int32_t)std::floor(q[1] / index.cell);
      const int32_t qcz = (int32_t)std::floor(q[2] / index.cell);
      heap.clear();
      for (int r = 0; r <= R_MAX; ++r) {
        for (int dx = -r; dx <= r; ++dx)
          for (int dy = -r; dy <= r; ++dy)
            for (int dz = -r; dz <= r; ++dz) {
              if (std::max({std::abs(dx), std::abs(dy), std::abs(dz)}) != r)
                continue;
              const int32_t b = index.cells.find(
                  index.key_at(qcx + dx, qcy + dy, qcz + dz));
              if (b < 0) continue;
              for (int32_t s = index.starts[b]; s < index.starts[b + 1]; ++s) {
                const int32_t pi = index.members[s];
                const float* p = pts + 3 * (int64_t)pi;
                const float ddx = p[0] - q[0], ddy = p[1] - q[1],
                            ddz = p[2] - q[2];
                const float d2 = ddx * ddx + ddy * ddy + ddz * ddz;
                if ((int64_t)heap.size() < k) {
                  heap.emplace_back(d2, pi);
                  std::push_heap(heap.begin(), heap.end());
                } else if (d2 < heap.front().first) {
                  std::pop_heap(heap.begin(), heap.end());
                  heap.back() = {d2, pi};
                  std::push_heap(heap.begin(), heap.end());
                }
              }
            }
        // unexplored cells sit at Chebyshev >= r+1: their points are at
        // least r*cell away from anywhere inside the query's cell
        if ((int64_t)heap.size() == k) {
          const float ring_min = (float)r * index.cell;
          if (heap.front().first <= ring_min * ring_min) break;
        }
      }
      std::sort_heap(heap.begin(), heap.end());  // ascending d2
      const int64_t found = (int64_t)heap.size();
      if (found == 0) {
        // no point within R_MAX rings: idx -1 (the caller raises)
        std::fill(d2_out + qi * k, d2_out + (qi + 1) * k, INFINITY);
        std::fill(idx_out + qi * k, idx_out + (qi + 1) * k, -1);
        continue;
      }
      for (int64_t j = 0; j < k; ++j) {
        const auto& e = heap[(size_t)std::min(j, found - 1)];
        d2_out[qi * k + j] = e.first;
        idx_out[qi * k + j] = e.second;
      }
    }
  };
  const int64_t n_threads = thread_count(threads, m);
  if (n_threads <= 1 || m < 4096)
    run(0, m);
  else
    parallel_chunks(m, n_threads, run);
  return OK;
}

}  // extern "C"
