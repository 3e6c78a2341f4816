/* C ABI for the pgrtk native runtime library.
 *
 * Host-side exact implementations of the hot scalar kernels:
 *   - SHIMMER sketching, both modes
 *     (semantics of reference pgr-db/src/shmmrutils.rs:417-669)
 *   - O(nD) greedy diff alignment ("match_reads", shmmrutils.rs:57-223)
 *   - sparse anchor-chaining DP ("sparse_aln", pgr-db/src/aln.rs:12-142)
 *
 * All functions are thread-safe; batch entry points parallelize across
 * sequences with an internal thread pool (the reference parallelizes the
 * same axis with rayon, seq_db.rs:456-469).
 */
#ifndef PGRTK_H
#define PGRTK_H

#include <stdint.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct {
  uint64_t x; /* hash << 8 | span */
  uint64_t y; /* rid << 32 | pos << 1 | strand */
} pgr_mm128;

typedef struct {
  uint32_t w, k, r, min_span;
  int32_t sketch;   /* 0: windowed minimizer, 1: hash threshold */
  int32_t padding;  /* padding flag for reduce_shmmr */
} pgr_spec;

/* Sketch one sequence. Returns number of mers; *out is malloc'd (caller
 * frees with pgr_free). */
int64_t pgr_sketch(const uint8_t *seq, int64_t len, uint32_t rid,
                   const pgr_spec *spec, pgr_mm128 **out);

/* Sketch n sequences in parallel. seqs is a concatenated buffer with
 * offsets[i]..offsets[i+1] delimiting sequence i (offsets has n+1 entries).
 * outs[i] receives a malloc'd array of counts[i] mers. */
void pgr_sketch_batch(const uint8_t *seqs, const int64_t *offsets,
                      const uint32_t *rids, int64_t n, const pgr_spec *spec,
                      int nthreads, pgr_mm128 **outs, int64_t *counts);

void pgr_free(void *p);

/* ---- O(nD) diff alignment ---- */
typedef struct {
  uint32_t x, y;
  int32_t dk;
} pgr_delta;

typedef struct {
  uint32_t m_size, dist, bgn0, end0, bgn1, end1, m_end0, m_end1;
  pgr_delta *deltas; /* malloc'd, n_deltas entries (NULL if !get_delta) */
  int64_t n_deltas;
  int32_t matched; /* 0 => no match (other fields undefined) */
} pgr_ovlp;

void pgr_match_reads(const uint8_t *seq0, int64_t len0, const uint8_t *seq1,
                     int64_t len1, int get_delta, double tol,
                     uint32_t min_match_len, uint32_t min_match_start,
                     uint32_t bandwidth, pgr_ovlp *out);

/* ---- sparse anchor chain DP ----
 * hits: n x 6 uint32 (q_bgn, q_end, q_ori, t_bgn, t_end, t_ori).
 * Output blob layout (malloc'd into *out, length written to *out_len,
 * all 4-byte words):
 *   [n_chains]
 *   per chain: [score_f32][n_hits][n_hits * 6 x u32 hitpair]
 * Returns n_chains. */
int64_t pgr_sparse_aln(const uint32_t *hits, int64_t n, uint32_t max_span,
                       float penalty, int64_t max_gap /* <0 => none */,
                       int oriented, uint32_t **out, int64_t *out_len);

const char *pgr_version(void);

#ifdef __cplusplus
}
#endif
#endif /* PGRTK_H */
