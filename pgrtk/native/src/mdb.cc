// Offsets-only scan of a .mdb SHIMMER index file (the lazy-load path).
//
// The reference queries multi-GB .mdb files without materializing them
// (pgr-db/src/seq_db.rs:1409-1504, read_mdb_file_parallel :1506-1523);
// the equivalent here is an mmap'd file + this one fast walk that
// records (hash0, hash1, byte_offset, count) per key and never touches
// the posting bytes — postings are then fetched on demand through the
// mapping (core/mdb.py MdbLazy).
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Scan {
  uint64_t *keys;     // 2 * nkeys (hash0, hash1)
  int64_t *starts;    // byte offset of each key's posting block
  int64_t *counts;    // posting count per key
  uint64_t nkeys;
};

}  // namespace

extern "C" {

// Returns 0 on success.  Outputs are malloc'd; caller frees via pgr_free.
// header_out: [w, k, r, min_span, sketch_flag] (5 x u32).
int pgr_mdb_scan(const char *path, uint32_t *header_out, uint64_t **keys_out,
                 int64_t **starts_out, int64_t **counts_out,
                 uint64_t *nkeys_out) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return -1;
  }
  size_t size = static_cast<size_t>(st.st_size);
  if (size < 31) {
    ::close(fd);
    return -2;
  }
  const uint8_t *base = static_cast<const uint8_t *>(
      mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0));
  ::close(fd);
  if (base == MAP_FAILED) return -1;
  // the walk only reads 24-byte record headers; advise random to keep
  // the kernel from readahead-faulting the (skipped) posting pages
  madvise(const_cast<uint8_t *>(base), size, MADV_RANDOM);

  int rc = 0;
  uint64_t nkeys = 0;
  uint64_t *keys = nullptr;
  int64_t *starts = nullptr, *counts = nullptr;
  do {
    if (memcmp(base, "mdb", 3) != 0) {
      rc = -2;
      break;
    }
    memcpy(header_out, base + 3, 5 * sizeof(uint32_t));
    memcpy(&nkeys, base + 23, sizeof(uint64_t));
    // every key record needs >= 24 bytes: a count beyond that is crafted
    // input — reject BEFORE the mallocs (2*nkeys*8 would wrap size_t and
    // under-allocate, turning the loop's writes into a heap overflow)
    if (nkeys > (size - 31) / 24) {
      rc = -2;
      break;
    }
    keys = static_cast<uint64_t *>(malloc(2 * nkeys * sizeof(uint64_t)));
    starts = static_cast<int64_t *>(malloc(nkeys * sizeof(int64_t)));
    counts = static_cast<int64_t *>(malloc(nkeys * sizeof(int64_t)));
    if (nkeys && (!keys || !starts || !counts)) {
      rc = -3;
      break;
    }
    size_t cursor = 31;
    for (uint64_t i = 0; i < nkeys; i++) {
      if (cursor + 24 > size) {
        rc = -2;
        break;
      }
      uint64_t k0, k1, n;
      memcpy(&k0, base + cursor, 8);
      memcpy(&k1, base + cursor + 8, 8);
      memcpy(&n, base + cursor + 16, 8);
      cursor += 24;
      // division form: 17*n on a crafted count wraps uint64 and the
      // sum check would pass with a bogus small product
      if (n > (size - cursor) / 17) {
        rc = -2;
        break;
      }
      keys[2 * i] = k0;
      keys[2 * i + 1] = k1;
      starts[i] = static_cast<int64_t>(cursor);
      counts[i] = static_cast<int64_t>(n);
      cursor += 17 * n;
    }
  } while (false);

  munmap(const_cast<uint8_t *>(base), size);
  if (rc != 0) {
    free(keys);
    free(starts);
    free(counts);
    return rc;
  }
  *keys_out = keys;
  *starts_out = starts;
  *counts_out = counts;
  *nkeys_out = nkeys;
  return 0;
}

}  // extern "C"
