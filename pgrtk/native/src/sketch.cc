// SHIMMER sketching, exact semantics of reference
// pgr-db/src/shmmrutils.rs:417-669 (re-derived, not translated).
#include "pgrtk.h"

#include <atomic>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint64_t U64MAX = ~0ULL;

inline uint64_t u64hash(uint64_t key) {
  // Thomas Wang 64-bit mix (reference: shmmrutils.rs:271-280)
  key = (~key) + (key << 21);
  key = key ^ (key >> 24);
  key = (key + (key << 3)) + (key << 8);
  key = key ^ (key >> 14);
  key = (key + (key << 2)) + (key << 4);
  key = key ^ (key >> 28);
  key = key + (key << 31);
  return key;
}

struct MM128 {
  uint64_t x, y;
};

inline uint32_t mm_pos(const MM128 &m) {
  return (uint32_t)((m.y & 0xFFFFFFFFULL) >> 1);
}

// byte -> 2-bit code table (reference: shmmrutils.rs:426-436)
struct Base2Bits {
  uint64_t t[256];
  Base2Bits() {
    for (int i = 0; i < 256; ++i) t[i] = 4;
    t[0] = 0; t[1] = 1; t[2] = 2; t[3] = 3;
    t['A'] = 0; t['C'] = 1; t['G'] = 2; t['T'] = 3;
    t['a'] = 0; t['c'] = 1; t['g'] = 2; t['t'] = 3;
  }
};
const Base2Bits B2B;

struct Ring {
  std::vector<MM128> v;
  size_t size, start, end, len;
  explicit Ring(size_t n) : v(n, MM128{U64MAX, U64MAX}), size(n), start(0), end(0), len(0) {}
  inline void push(const MM128 &m) {
    v[end] = m;
    end = (end + 1) % size;
    if (len < size) {
      ++len;
    } else {
      start = (start + 1) % size;
    }
  }
  inline uint64_t min_x() const {
    uint64_t mn = U64MAX;
    for (size_t i = 0; i < len; ++i)
      if (v[i].x < mn) mn = v[i].x;
    return mn;
  }
  inline const MM128 &get(size_t i) const { return v[(start + i) % size]; }
};

// Hierarchical reduction (reference: shmmrutils.rs:359-415)
std::vector<MM128> reduce_shmmr(const std::vector<MM128> &in, uint32_t r,
                                bool padding) {
  std::vector<MM128> mers;
  const std::vector<MM128> *src = &in;
  if (padding) {
    mers.reserve(in.size() + 2 * (r - 1));
    for (uint32_t i = 0; i + 1 < r; ++i) mers.push_back(MM128{U64MAX, U64MAX});
    mers.insert(mers.end(), in.begin(), in.end());
    for (uint32_t i = 0; i + 1 < r; ++i) mers.push_back(MM128{U64MAX, U64MAX});
    src = &mers;
  }
  std::vector<MM128> out;
  Ring rbuf(r);
  uint64_t min_x = U64MAX;
  size_t mdist = 0;
  for (size_t pos = 0; pos < src->size(); ++pos) {
    const MM128 &m = (*src)[pos];
    rbuf.push(m);
    if (mdist == (size_t)(r - 1)) {
      min_x = rbuf.min_x();
      size_t last_i = 0;
      for (size_t i = 0; i < rbuf.size; ++i) {
        const MM128 &mm = rbuf.get(i);
        if (mm.x == min_x) {
          out.push_back(mm);
          min_x = mm.x;
          last_i = i;
        }
      }
      mdist = (size_t)r - 1 - last_i;
    } else if (m.x <= min_x && pos >= (size_t)r) {
      out.push_back(m);
      min_x = m.x;
      mdist = 0;
    } else {
      ++mdist;
    }
  }
  return out;
}

// Spacing/distinctness filter (reference: shmmrutils.rs:536-555)
std::vector<MM128> min_span_filter(const std::vector<MM128> &in,
                                   uint32_t min_span) {
  std::vector<MM128> out;
  const size_t n = in.size();
  out.reserve(n);
  for (size_t i = 0; i < n; ++i) {
    if (i == 0 || i == n - 1) {
      out.push_back(in[i]);
      continue;
    }
    uint32_t p_pos = mm_pos(in[i - 1]);
    uint32_t pos = mm_pos(in[i]);
    uint32_t n_pos = mm_pos(in[i + 1]);
    if (pos - p_pos > min_span && n_pos - pos > min_span &&
        in[i - 1].x != in[i].x && in[i].x != in[i + 1].x)
      out.push_back(in[i]);
  }
  return out;
}

// Shared k-mer register walk driving both modes. Emit is called with each
// non-palindromic mer at pos >= k (stale registers on non-ACGT bases).
// emit(pos, mer, full_hash): mode 2 thresholds on the full 64-bit hash,
// before the top 8 bits are dropped by the x packing.
template <typename F>
inline void mer_walk(uint32_t rid, const uint8_t *seq, int64_t len, uint32_t k,
                     F &&emit) {
  const uint32_t shift = k - 1;
  const uint64_t mask = U64MAX >> (64 - k);
  uint64_t f0 = 0, f1 = 0, r0 = 0, r1 = 0;
  for (int64_t pos = 0; pos < len; ++pos) {
    uint64_t c = B2B.t[seq[pos]];
    if (c < 4) {
      f0 = ((f0 << 1) | (c & 1)) & mask;
      f1 = ((f1 << 1) | ((c & 2) >> 1)) & mask;
      uint64_t rc = 3 ^ c;
      r0 = ((r0 >> 1) | ((rc & 1) << shift)) & mask;
      r1 = ((r1 >> 1) | (((rc & 2) >> 1) << shift)) & mask;
    }
    if (f0 == r0 && f1 == r1) continue;
    if (pos < (int64_t)k) continue;
    uint64_t h;
    uint64_t strand;
    if (r0 < f0) {
      h = u64hash(r0) ^ u64hash(r1 ^ 0xAD12CF59ULL);
      strand = 1;
    } else {
      h = u64hash(f0) ^ u64hash(f1 ^ 0xAD12CF59ULL);
      strand = 0;
    }
    MM128 m{(h << 8) | (uint64_t)k,
            ((uint64_t)rid << 32) | ((uint64_t)pos << 1) | strand};
    emit(pos, m, h);
  }
}

// Windowed-minimizer mode (reference: shmmrutils.rs:417-556)
std::vector<MM128> shmmrs_mode1(uint32_t rid, const uint8_t *seq, int64_t len,
                                uint32_t w, uint32_t k, uint32_t r,
                                uint32_t min_span, bool padding) {
  std::vector<MM128> shmmrs;
  Ring rbuf(w);
  uint64_t min_x = U64MAX;
  uint32_t min_pos = 0;
  int64_t mdist = 0;
  mer_walk(rid, seq, len, k, [&](int64_t pos, const MM128 &m, uint64_t) {
    rbuf.push(m);
    if (mdist == (int64_t)(w - 1)) {
      uint64_t mn = rbuf.min_x();
      for (size_t i = 0; i < rbuf.size; ++i) {
        const MM128 &mm = rbuf.get(i);
        if (mm.x == mn) {
          shmmrs.push_back(mm);
          min_x = mm.x;
          min_pos = mm_pos(mm);
        }
      }
      mdist = pos - (int64_t)min_pos;
    } else if (m.x <= min_x && pos >= (int64_t)(w + k) &&
               pos < len - (int64_t)w + (int64_t)k) {
      shmmrs.push_back(m);
      min_x = m.x;
      min_pos = mm_pos(m);
      mdist = 0;
    } else {
      ++mdist;
    }
  });
  if (r > 1) shmmrs = reduce_shmmr(reduce_shmmr(shmmrs, r, padding), r, padding);
  return min_span_filter(shmmrs, min_span);
}

// Hash-threshold sketch mode (reference: shmmrutils.rs:558-655)
std::vector<MM128> shmmrs_mode2(uint32_t rid, const uint8_t *seq, int64_t len,
                                uint32_t k, uint32_t r, uint32_t min_span) {
  std::vector<MM128> shmmrs;
  const uint64_t threshold = (U64MAX >> 4) >> r;
  mer_walk(rid, seq, len, k, [&](int64_t, const MM128 &m, uint64_t h) {
    if (h < threshold) shmmrs.push_back(m);
  });
  return min_span_filter(shmmrs, min_span);
}

std::vector<MM128> sketch_one(uint32_t rid, const uint8_t *seq, int64_t len,
                              const pgr_spec &spec) {
  if (spec.sketch)
    return shmmrs_mode2(rid, seq, len, spec.k, spec.r, spec.min_span);
  return shmmrs_mode1(rid, seq, len, spec.w, spec.k, spec.r, spec.min_span,
                      spec.padding != 0);
}

pgr_mm128 *to_c(const std::vector<MM128> &v) {
  pgr_mm128 *out = (pgr_mm128 *)std::malloc(sizeof(pgr_mm128) * (v.size() ? v.size() : 1));
  std::memcpy(out, v.data(), sizeof(pgr_mm128) * v.size());
  return out;
}

}  // namespace

extern "C" {

int64_t pgr_sketch(const uint8_t *seq, int64_t len, uint32_t rid,
                   const pgr_spec *spec, pgr_mm128 **out) {
  auto v = sketch_one(rid, seq, len, *spec);
  *out = to_c(v);
  return (int64_t)v.size();
}

void pgr_sketch_batch(const uint8_t *seqs, const int64_t *offsets,
                      const uint32_t *rids, int64_t n, const pgr_spec *spec,
                      int nthreads, pgr_mm128 **outs, int64_t *counts) {
  if (nthreads <= 0) nthreads = (int)std::thread::hardware_concurrency();
  if (nthreads < 1) nthreads = 1;
  if (nthreads > n) nthreads = (int)(n ? n : 1);
  std::vector<std::thread> threads;
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      auto v = sketch_one(rids[i], seqs + offsets[i], offsets[i + 1] - offsets[i],
                          *spec);
      outs[i] = to_c(v);
      counts[i] = (int64_t)v.size();
    }
  };
  for (int t = 0; t < nthreads; ++t) threads.emplace_back(worker);
  for (auto &t : threads) t.join();
}

void pgr_free(void *p) { std::free(p); }

const char *pgr_version(void) { return "pgrtk-native 0.1.0"; }

}  // extern "C"

extern "C" {

// Hierarchical reduction + min_span filter on an already-emitted mer
// stream (used by the device mode-1 sketch path: the device computes the
// raw windowed-minimizer stream; this finishes reduce_shmmr x2 + the
// spacing filter exactly as sketch_one does).
int64_t pgr_reduce_and_filter(const pgr_mm128 *mers, int64_t n, uint32_t r,
                              uint32_t min_span, int padding,
                              pgr_mm128 **out) {
  std::vector<MM128> v(n);
  std::memcpy(v.data(), mers, sizeof(MM128) * (size_t)n);
  if (r > 1) v = reduce_shmmr(reduce_shmmr(v, r, padding != 0), r, padding != 0);
  v = min_span_filter(v, min_span);
  *out = to_c(v);
  return (int64_t)v.size();
}

}  // extern "C"
