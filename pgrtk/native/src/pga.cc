// PGA — Pan-Genome Archive.
//
// C++ compressed pangenome archive with the same API surface as the
// reference's AGC dependency (open / list samples / list contigs /
// get length / fetch [sub]sequence; reference FFI surface:
// pgr-db/src/agc_io.rs:62-181, C API in agc/src/lib-cxx/agc-api.h).
// Own on-disk format (the AGC submodule is external to the reference
// repo): zstd-compressed fixed-size segments with random access.
//
// Layout:
//   "PGA:0.1\0"                       8-byte magic
//   u64 index_offset                  (LE)
//   [segments...]                     zstd frames
//   index at index_offset:
//     u32 n_samples
//     per sample: u16 name_len, name, u32 n_contigs
//       per contig: u16 name_len, name, u64 seq_len, u64 global_start
//     u64 n_segs_total
//     per seg: u64 file_offset, u32 comp_size, u32 raw_size
//
// All contigs are concatenated into ONE global base stream which is cut
// into fixed SEG_RAW segments: similar contigs land in the same zstd
// window, so near-identical haplotypes compress against each other
// (the property that makes the reference\'s AGC archives small).
// Segment k covers global bytes [k*SEG_RAW, (k+1)*SEG_RAW).
#include "pgrtk.h"

#include "zstd_api.h"

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <map>
#include <mutex>
#include <string>
#include <vector>

namespace {

constexpr char MAGIC[8] = {'P', 'G', 'A', ':', '0', '.', '1', '\0'};
constexpr uint64_t SEG_RAW = 1 << 20;  // 1 MiB raw bases per segment

struct SegInfo {
  uint64_t offset;
  uint32_t comp_size;
  uint32_t raw_size;
};

struct ContigInfo {
  std::string name;
  uint64_t seq_len;
  uint64_t global_start;
};

struct SampleInfo {
  std::string name;
  std::vector<ContigInfo> contigs;
};

struct Archive {
  FILE *f = nullptr;
  std::mutex io_mutex;
  std::vector<SampleInfo> samples;
  std::vector<SegInfo> segs;
  std::map<std::pair<std::string, std::string>, const ContigInfo *> by_name;

  ~Archive() {
    if (f) std::fclose(f);
  }
};

bool read_exact(FILE *f, void *p, size_t n) {
  return std::fread(p, 1, n, f) == n;
}

template <typename T>
bool read_pod(FILE *f, T &v) {
  return read_exact(f, &v, sizeof(T));
}

bool read_str_ck(FILE *f, std::string &out) {
  uint16_t n;
  if (!read_pod(f, n)) return false;
  out.assign(n, '\0');
  return read_exact(f, out.data(), n);
}

}  // namespace

extern "C" {

void *pga_open(const char *path) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return nullptr;
  // Hardening: every index count is bounded by the file size BEFORE any
  // resize (a crafted count otherwise drives a multi-GB allocation —
  // bad_alloc across the extern-C boundary — or billions of at-EOF
  // read iterations), and every read failure aborts the open cleanly.
  std::fseek(f, 0, SEEK_END);
  const long fsz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  char magic[8];
  if (!read_exact(f, magic, 8) || std::memcmp(magic, MAGIC, 8) != 0) {
    std::fclose(f);
    return nullptr;
  }
  uint64_t index_offset;
  if (!read_pod(f, index_offset) || index_offset > (uint64_t)fsz) {
    std::fclose(f);
    return nullptr;
  }
  auto *a = new Archive();
  a->f = f;
  std::fseek(f, (long)index_offset, SEEK_SET);
  const uint64_t idx_bytes = (uint64_t)fsz - index_offset;
  bool ok = true;
  uint32_t n_samples = 0;
  ok = ok && read_pod(f, n_samples);
  // sample record >= 6 bytes (name_len + n_ctg), contig >= 18, seg = 16
  ok = ok && (uint64_t)n_samples <= idx_bytes / 6;
  if (ok) a->samples.resize(n_samples);
  for (auto &s : a->samples) {
    if (!ok) break;
    uint32_t n_ctg = 0;
    ok = read_str_ck(f, s.name) && read_pod(f, n_ctg)
         && (uint64_t)n_ctg <= idx_bytes / 18;
    if (ok) s.contigs.resize(n_ctg);
    for (auto &c : s.contigs) {
      if (!ok) break;
      ok = read_str_ck(f, c.name) && read_pod(f, c.seq_len)
           && read_pod(f, c.global_start);
    }
  }
  uint64_t n_segs = 0;
  ok = ok && read_pod(f, n_segs) && n_segs <= idx_bytes / 16;
  if (ok) a->segs.resize(n_segs);
  for (auto &sg : a->segs) {
    if (!ok) break;
    ok = read_pod(f, sg.offset) && read_pod(f, sg.comp_size)
         && read_pod(f, sg.raw_size);
    // a segment's payload must lie inside the data region and its raw
    // size inside one SEG_RAW window (subtraction form: the sum wraps
    // uint64 on crafted offsets)
    ok = ok && sg.offset <= index_offset
         && sg.comp_size <= index_offset - sg.offset
         && sg.raw_size <= SEG_RAW;
  }
  if (!ok) {
    delete a;  // closes f
    return nullptr;
  }
  for (auto &s : a->samples)
    for (auto &c : s.contigs) a->by_name[{s.name, c.name}] = &c;
  return a;
}

void pga_close(void *h) { delete (Archive *)h; }

int64_t pga_n_samples(void *h) {
  return (int64_t)((Archive *)h)->samples.size();
}

// Writes sample names joined by '\n' into a malloc'd buffer.
char *pga_list_samples(void *h) {
  auto *a = (Archive *)h;
  std::string out;
  for (auto &s : a->samples) {
    out += s.name;
    out += '\n';
  }
  char *buf = (char *)std::malloc(out.size() + 1);
  std::memcpy(buf, out.c_str(), out.size() + 1);
  return buf;
}

// Lines of "ctg_name\tlen" for one sample.
char *pga_list_ctgs(void *h, const char *sample) {
  auto *a = (Archive *)h;
  std::string out;
  for (auto &s : a->samples) {
    if (s.name != sample) continue;
    for (auto &c : s.contigs) {
      out += c.name;
      out += '\t';
      out += std::to_string(c.seq_len);
      out += '\n';
    }
  }
  char *buf = (char *)std::malloc(out.size() + 1);
  std::memcpy(buf, out.c_str(), out.size() + 1);
  return buf;
}

int64_t pga_get_ctg_len(void *h, const char *sample, const char *ctg) {
  auto *a = (Archive *)h;
  auto it = a->by_name.find({sample, ctg});
  return it == a->by_name.end() ? -1 : (int64_t)it->second->seq_len;
}

// Fetch [bgn, end) of a contig into a malloc'd buffer; returns length or -1.
int64_t pga_get_sub_seq(void *h, const char *sample, const char *ctg,
                        int64_t bgn, int64_t end, uint8_t **out) {
  auto *a = (Archive *)h;
  auto it = a->by_name.find({sample, ctg});
  if (it == a->by_name.end()) return -1;
  const ContigInfo *c = it->second;
  if (bgn < 0) bgn = 0;
  if (end < 0 || end > (int64_t)c->seq_len) end = (int64_t)c->seq_len;
  if (bgn >= end) {
    *out = (uint8_t *)std::malloc(1);
    return 0;
  }
  const int64_t n = end - bgn;
  uint8_t *buf = (uint8_t *)std::malloc((size_t)n);
  const uint64_t g_bgn = c->global_start + (uint64_t)bgn;
  const uint64_t g_end = c->global_start + (uint64_t)end;
  const uint64_t first_seg = g_bgn / SEG_RAW;
  const uint64_t last_seg = (g_end - 1) / SEG_RAW;
  // corrupt contig metadata can point past the segment table
  if (last_seg >= a->segs.size()) {
    std::free(buf);
    return -1;
  }
  std::vector<uint8_t> comp, raw;
  int64_t written = 0;
  for (uint64_t sj = first_seg; sj <= last_seg; ++sj) {
    const SegInfo &sg = a->segs[sj];
    comp.resize(sg.comp_size);
    {
      std::lock_guard<std::mutex> lk(a->io_mutex);
      std::fseek(a->f, (long)sg.offset, SEEK_SET);
      if (!read_exact(a->f, comp.data(), sg.comp_size)) {
        std::free(buf);
        return -1;
      }
    }
    raw.resize(sg.raw_size);
    size_t r = ZSTD_decompress(raw.data(), sg.raw_size, comp.data(),
                               sg.comp_size);
    if (ZSTD_isError(r) || r != sg.raw_size) {
      std::free(buf);
      return -1;
    }
    const uint64_t seg_base = sj * SEG_RAW;
    uint64_t s = g_bgn > seg_base ? g_bgn - seg_base : 0;
    uint64_t e = g_end - seg_base < (uint64_t)sg.raw_size
                     ? g_end - seg_base
                     : (uint64_t)sg.raw_size;
    // corrupt lengths can place the window outside the segment or
    // overflow the output buffer
    if (s > e || written + (int64_t)(e - s) > n) {
      std::free(buf);
      return -1;
    }
    std::memcpy(buf + written, raw.data() + s, (size_t)(e - s));
    written += (int64_t)(e - s);
  }
  *out = buf;
  return written;
}

// ---- writer ----
// Streaming creation: call pga_create, then pga_add_contig repeatedly,
// then pga_finish.
struct Writer {
  FILE *f;
  std::vector<SampleInfo> samples;
  std::vector<SegInfo> segs;
  std::vector<uint8_t> pending;  // global stream tail not yet segmented
  uint64_t global_len = 0;
  int level;
};

static void flush_segments(Writer *w, bool final_flush) {
  std::vector<uint8_t> comp;
  size_t off = 0;
  while (w->pending.size() - off >= SEG_RAW ||
         (final_flush && w->pending.size() > off)) {
    const size_t raw_n = std::min((size_t)SEG_RAW, w->pending.size() - off);
    comp.resize(ZSTD_compressBound(raw_n));
    size_t cs = ZSTD_compress(comp.data(), comp.size(), w->pending.data() + off,
                              raw_n, w->level);
    SegInfo sg;
    sg.offset = (uint64_t)std::ftell(w->f);
    sg.comp_size = (uint32_t)cs;
    sg.raw_size = (uint32_t)raw_n;
    std::fwrite(comp.data(), 1, cs, w->f);
    w->segs.push_back(sg);
    off += raw_n;
  }
  w->pending.erase(w->pending.begin(), w->pending.begin() + (long)off);
}

void *pga_create(const char *path, int level) {
  FILE *f = std::fopen(path, "wb");
  if (!f) return nullptr;
  std::fwrite(MAGIC, 1, 8, f);
  uint64_t placeholder = 0;
  std::fwrite(&placeholder, 8, 1, f);
  auto *w = new Writer();
  w->f = f;
  w->level = level > 0 ? level : 6;
  return w;
}

int pga_add_contig(void *h, const char *sample, const char *ctg,
                   const uint8_t *seq, int64_t len) {
  auto *w = (Writer *)h;
  if (w->samples.empty() || w->samples.back().name != sample) {
    SampleInfo s;
    s.name = sample;
    w->samples.push_back(std::move(s));
  }
  ContigInfo c;
  c.name = ctg;
  c.seq_len = (uint64_t)len;
  c.global_start = w->global_len;
  w->pending.insert(w->pending.end(), seq, seq + len);
  w->global_len += (uint64_t)len;
  flush_segments(w, false);
  w->samples.back().contigs.push_back(std::move(c));
  return 0;
}

int pga_finish(void *h) {
  auto *w = (Writer *)h;
  flush_segments(w, true);
  uint64_t index_offset = (uint64_t)std::ftell(w->f);
  uint32_t n_samples = (uint32_t)w->samples.size();
  std::fwrite(&n_samples, 4, 1, w->f);
  auto wstr = [&](const std::string &s) {
    uint16_t n = (uint16_t)s.size();
    std::fwrite(&n, 2, 1, w->f);
    std::fwrite(s.data(), 1, n, w->f);
  };
  for (auto &s : w->samples) {
    wstr(s.name);
    uint32_t n_ctg = (uint32_t)s.contigs.size();
    std::fwrite(&n_ctg, 4, 1, w->f);
    for (auto &c : s.contigs) {
      wstr(c.name);
      std::fwrite(&c.seq_len, 8, 1, w->f);
      std::fwrite(&c.global_start, 8, 1, w->f);
    }
  }
  uint64_t n_segs = (uint64_t)w->segs.size();
  std::fwrite(&n_segs, 8, 1, w->f);
  for (auto &sg : w->segs) {
    std::fwrite(&sg.offset, 8, 1, w->f);
    std::fwrite(&sg.comp_size, 4, 1, w->f);
    std::fwrite(&sg.raw_size, 4, 1, w->f);
  }
  std::fseek(w->f, 8, SEEK_SET);
  std::fwrite(&index_offset, 8, 1, w->f);
  int rc = std::fclose(w->f);
  delete w;
  return rc;
}

}  // extern "C"
