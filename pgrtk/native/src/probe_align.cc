// Bucket-padding scan for the aligned probe layout
// (pgrtk/ops/probe.py::build_probe_table_aligned): assign each
// bucket a start offset, advancing to the next 128-slot row boundary
// whenever the bucket would straddle one.  Sequential recurrence —
// trivial in C++, ~8 s in Python at 32M keys / 1M buckets (and ~3 min
// projected at HPRC's 730M keys), so index builds call this instead.
#include <cstdint>

extern "C" {

// counts: per-bucket key counts (each <= 128, caller-validated)
// starts: out, per-bucket padded start offsets
// returns n_padded (total padded slots)
int64_t pgr_probe_align_starts(const int64_t *counts, int64_t n_buckets,
                               int64_t *starts) {
  int64_t off = 0;
  for (int64_t b = 0; b < n_buckets; ++b) {
    if ((off & 127) + counts[b] > 128) off = (off + 127) & ~int64_t(127);
    starts[b] = off;
    off += counts[b];
  }
  return off;
}

}  // extern "C"
