// Read-only AGC v2 archive reader.
//
// The reference links the external AGC C++ library (Assembled Genomes
// Compressor) for its compressed-archive backend (built by
// pgr-db/build.rs:20-54, FFI surface agc_open/get_ctg_seq/... used at
// pgr-db/src/agc_io.rs:139-171).  The AGC sources are a git submodule
// that is not vendored in the reference tree, so this reader was
// implemented from the on-disk format of AGC v2.0 archives, derived
// empirically from pgr-db/test/test_data/test.agc (produced by
// `agc create test_agc_ref.fa test_agc_seqs.fa`, see gen_agc.sh) and
// validated byte-exactly against the fastas it was built from.
//
// == Container ==
// A flat stream of "parts" followed by a footer:
//   part   := varint(metadata) ++ payload-bytes
//   varint := u8 n ++ n bytes big-endian          (n = 0 encodes 0)
//   footer := varint(n_streams)
//             { cstring(name) varint(n_parts) varint(raw_size)
//               { varint(offset) varint(size) } * n_parts } * n_streams
//   file   := parts... footer u64le(footer_size)
// part offsets address the varint(metadata) byte; `size` counts only
// the payload.
//
// == Streams ==
//   "params"             u32le k, min_match_len, pack_cardinality, segment_size
//   "file_type_info"     \0-separated key/value text (version check)
//   "splitters"          meta = count; u64le splitter k-mers
//   "segment-splitters"  meta = count; { u64le kmer1, u64le kmer2, u32le group }
//                        kmer2 == ~0 marks a contig-terminal (flank) group
//   "collection-main"    zstd; names + per-contig segment counts
//   "collection-details" zstd; 4 columns of per-segment records
//   "seg-<g>-ref"        the group's reference segment
//   "seg-<g>-delta"      LZ-diff encoded member segments, packed
//                        `pack_cardinality` per part
//
// K-mer values are (2-bit MSB-first base codes) << (64 - 2k), canonical
// = min(direct, revcomp); segments are stored in canonical orientation.
//
// == collection-main == (after zstd)
//   prefix_varint(header)            (ignored by this reader)
//   prefix_varint(n_samples)
//   { cstring(sample) prefix_varint(n_contigs)
//     { cstring(contig) prefix_varint(n_segments) } } *
//   prefix_varint(n_cmd_lines) { cstring } *      (creation history)
// prefix_varint: b0<0x80 -> b0; b0<0xC0 -> ((b0-0x80)<<8|b1)+0x80;
//   b0<0xE0 -> 3 bytes + 0x4080; b0<0xF0 -> 4 bytes + 0x204080; ...
//
// == collection-details == (after zstd) — four columns over all segments
// in contig order: groups, in-group ids, raw lengths, orientations.
//   groups:  first segment raw, rest zigzag delta vs previous
//   igids:   first raw; subsequent raw if the PREVIOUS segment's group is
//            a flank group, else zigzag delta vs previous  (flank groups
//            share one reference segment so their igid predicts nothing)
//   lens:    same rule as igids
//   oris:    raw 0/1 per segment (1 = reverse-complement the stored
//            segment when placing it into the contig)
//   zigzag:  even v -> +v/2, odd v -> -(v+1)/2
//
// == segment payloads ==
// Compressed payloads are one zstd frame followed by one trailing
// marker byte (0x01 observed); raw payloads have no marker.
//   ref part:   meta == 0 -> raw base codes (one per byte);
//               else zstd of 2-bit packed codes, meta = base count,
//               4 codes/byte MSB-first, final partial byte right-aligned
//               in its low bits, one trailing byte (ignored)
//   delta part: meta = zstd raw size (0 -> stored raw); payload is
//               0xff-separated LZ-diff records, record i covers
//               in_group_id = part_index*pack_cardinality + i + 1
//
// == LZ-diff record == (vs the group's ref segment; pred starts at 0)
//   "<d>,<l>."  copy ref[pred+d : pred+d+l+min_match_len], d may be
//               negative ("-12,3."); pred moves past the copy
//   "<d>."      copy ref[pred+d :] to the end of the ref (final op)
//   'A'+c       literal base code c (A/B/C/D = A/C/G/T); pred += 1
//   '!'         copy single base ref[pred]; pred += 1
//
// Contig reconstruction: segments overlap by k bases at splitters;
// contig = seg0 ++ seg1[k:] ++ seg2[k:] ++ ...
#include "pgrtk.h"

#include "zstd_api.h"

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <list>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct Part {
  uint64_t offset;
  uint64_t size;
};

struct AgcSegment {
  uint32_t group;
  uint32_t igid;
  uint32_t len;
  uint8_t is_rc;
};

struct AgcContig {
  std::string name;
  uint64_t len;
  std::vector<AgcSegment> segs;
};

struct AgcSample {
  std::string name;
  std::vector<AgcContig> contigs;
};

struct AgcArchive {
  FILE *f = nullptr;
  uint64_t file_size = 0;  // bounds every part read (corrupt-input guard)
  std::mutex io_mu;
  uint32_t kmer_len = 0, min_match = 0, pack_card = 0, seg_size = 0;
  std::map<std::string, std::vector<Part>> streams;
  std::unordered_set<uint32_t> full_groups;  // two-splitter groups
  std::vector<AgcSample> samples;
  std::map<std::pair<std::string, std::string>, const AgcContig *> by_name;

  // decode caches (segment-level random access re-reads group data)
  std::mutex cache_mu;
  std::unordered_map<uint32_t, std::string> ref_cache;
  // shared_ptr so a pack returned to a caller survives LRU eviction by a
  // concurrent thread (the archive is shared across server threads)
  std::map<std::pair<uint32_t, uint32_t>,
           std::shared_ptr<const std::vector<std::string>>> pack_cache;
  std::list<std::pair<uint32_t, uint32_t>> pack_lru;
  static constexpr size_t kMaxPacks = 64;

  ~AgcArchive() {
    if (f) std::fclose(f);
  }
};

constexpr const char kBase[4] = {'A', 'C', 'G', 'T'};

// footer varint: u8 length + big-endian bytes
uint64_t read_varint(const uint8_t *buf, size_t len, size_t &p, bool &ok) {
  if (p >= len) { ok = false; return 0; }
  unsigned n = buf[p++];
  if (n > 8 || p + n > len) { ok = false; return 0; }
  uint64_t v = 0;
  for (unsigned i = 0; i < n; ++i) v = (v << 8) | buf[p++];
  return v;
}

// collection prefix varint (see header comment)
uint64_t read_pvarint(const uint8_t *buf, size_t len, size_t &p, bool &ok) {
  if (p >= len) { ok = false; return 0; }
  uint8_t b0 = buf[p];
  unsigned extra;
  uint64_t base, hi;
  if (b0 < 0x80) { p += 1; return b0; }
  if (b0 < 0xC0) { extra = 1; hi = b0 - 0x80; base = 0x80; }
  else if (b0 < 0xE0) { extra = 2; hi = b0 - 0xC0; base = 0x4080; }
  else if (b0 < 0xF0) { extra = 3; hi = b0 - 0xE0; base = 0x204080; }
  else if (b0 < 0xF8) { extra = 4; hi = b0 - 0xF0; base = 0x10204080; }
  else { extra = 5; hi = b0 - 0xF8; base = 0x0810204080ULL; }
  if (p + 1 + extra > len) { ok = false; return 0; }
  uint64_t v = hi;
  for (unsigned i = 1; i <= extra; ++i) v = (v << 8) | buf[p + i];
  p += 1 + extra;
  return v + base;
}

int64_t unzigzag(uint64_t v) {
  return (v & 1) ? -(int64_t)((v + 1) >> 1) : (int64_t)(v >> 1);
}

std::string read_cstring(const uint8_t *buf, size_t len, size_t &p, bool &ok) {
  size_t e = p;
  while (e < len && buf[e] != 0) ++e;
  if (e >= len) { ok = false; return {}; }
  std::string s((const char *)buf + p, e - p);
  p = e + 1;
  return s;
}

// Reads one part: metadata varint + payload.
bool read_part(AgcArchive *a, const Part &part, uint64_t &meta,
               std::vector<uint8_t> &payload) {
  // crafted footers can claim multi-GB parts: bound by the file size
  // BEFORE the resize (a huge resize throws across the extern-C edge)
  if (part.offset > a->file_size ||
      part.size > a->file_size - part.offset)
    return false;
  std::lock_guard<std::mutex> lk(a->io_mu);
  if (std::fseek(a->f, (long)part.offset, SEEK_SET) != 0) return false;
  uint8_t nb;
  if (std::fread(&nb, 1, 1, a->f) != 1 || nb > 8) return false;
  uint8_t mb[8];
  if (nb && std::fread(mb, 1, nb, a->f) != nb) return false;
  meta = 0;
  for (unsigned i = 0; i < nb; ++i) meta = (meta << 8) | mb[i];
  payload.resize(part.size);
  return part.size == 0 ||
         std::fread(payload.data(), 1, part.size, a->f) == part.size;
}

// Part payloads carry one trailing marker byte AFTER the zstd frame
// (0x01 observed = "zstd-compressed"), so decompress exactly the frame.
bool zstd_decode(const std::vector<uint8_t> &in, size_t out_cap,
                 std::vector<uint8_t> &out) {
  // out_cap comes from file metadata; a crafted value drives a huge
  // allocation.  No legitimate AGC stream (collection blob or packed
  // segment) approaches 2 GB decompressed.
  if (out_cap > (size_t{1} << 31)) return false;
  size_t fs = ZSTD_findFrameCompressedSize(in.data(), in.size());
  if (ZSTD_isError(fs)) return false;
  out.resize(out_cap);
  size_t r = ZSTD_decompress(out.data(), out_cap, in.data(), fs);
  if (ZSTD_isError(r)) return false;
  out.resize(r);
  return true;
}

// group ref segment as ASCII bases
const std::string *get_ref_segment(AgcArchive *a, uint32_t group) {
  {
    std::lock_guard<std::mutex> lk(a->cache_mu);
    auto it = a->ref_cache.find(group);
    if (it != a->ref_cache.end()) return &it->second;
  }
  auto sit = a->streams.find("seg-" + std::to_string(group) + "-ref");
  if (sit == a->streams.end() || sit->second.empty()) return nullptr;
  uint64_t meta;
  std::vector<uint8_t> payload;
  if (!read_part(a, sit->second[0], meta, payload)) return nullptr;
  std::string seq;
  if (meta == 0) {
    // stored as raw base codes
    seq.resize(payload.size());
    for (size_t i = 0; i < payload.size(); ++i)
      seq[i] = payload[i] < 4 ? kBase[payload[i]] : 'N';
  } else {
    // zstd of 2-bit packed codes; meta = number of bases.  The packed
    // buffer is ceil(meta/4) code bytes + 1 trailing byte (ignored).
    std::vector<uint8_t> packed;
    if (!zstd_decode(payload, meta / 4 + 16, packed)) return nullptr;
    seq.resize(meta);
    size_t full = meta / 4, left = meta % 4;
    if (packed.size() < full + (left ? 1 : 0)) return nullptr;
    for (size_t i = 0; i < full; ++i) {
      uint8_t b = packed[i];
      seq[4 * i] = kBase[(b >> 6) & 3];
      seq[4 * i + 1] = kBase[(b >> 4) & 3];
      seq[4 * i + 2] = kBase[(b >> 2) & 3];
      seq[4 * i + 3] = kBase[b & 3];
    }
    if (left) {
      uint8_t b = packed[full];
      for (size_t j = 0; j < left; ++j)
        seq[4 * full + j] = kBase[(b >> (2 * (left - 1 - j))) & 3];
    }
  }
  std::lock_guard<std::mutex> lk(a->cache_mu);
  return &a->ref_cache.emplace(group, std::move(seq)).first->second;
}

// decode one LZ-diff record against the group ref
bool lz_decode(const std::string &rec, const std::string &ref,
               uint32_t min_match, std::string &out) {
  int64_t pred = 0;
  size_t i = 0, n = rec.size();
  const int64_t rn = (int64_t)ref.size();
  while (i < n) {
    char c = rec[i];
    if (c == '-' || (c >= '0' && c <= '9')) {
      bool neg = c == '-';
      if (neg) ++i;
      int64_t d = 0;
      while (i < n && rec[i] >= '0' && rec[i] <= '9') d = d * 10 + (rec[i++] - '0');
      if (neg) d = -d;
      if (i < n && rec[i] == ',') {
        ++i;
        int64_t l = 0;
        while (i < n && rec[i] >= '0' && rec[i] <= '9')
          l = l * 10 + (rec[i++] - '0');
        if (i >= n || rec[i] != '.') return false;
        ++i;
        l += min_match;
        int64_t p0 = pred + d;
        if (p0 < 0 || p0 + l > rn) return false;
        out.append(ref, (size_t)p0, (size_t)l);
        pred = p0 + l;
      } else if (i < n && rec[i] == '.') {
        ++i;  // copy to end of ref
        int64_t p0 = pred + d;
        if (p0 < 0 || p0 > rn) return false;
        out.append(ref, (size_t)p0, (size_t)(rn - p0));
        pred = rn;
      } else {
        return false;
      }
    } else if (c == '!') {
      if (pred < 0 || pred >= rn) return false;
      out.push_back(ref[(size_t)pred]);
      ++pred;
      ++i;
    } else {
      unsigned code = (unsigned char)c - 'A';
      out.push_back(code < 4 ? kBase[code] : 'N');
      ++pred;
      ++i;
    }
  }
  return true;
}

std::shared_ptr<const std::vector<std::string>> get_delta_pack(
    AgcArchive *a, uint32_t group, uint32_t part_idx) {
  auto key = std::make_pair(group, part_idx);
  {
    std::lock_guard<std::mutex> lk(a->cache_mu);
    auto it = a->pack_cache.find(key);
    if (it != a->pack_cache.end()) return it->second;
  }
  auto sit = a->streams.find("seg-" + std::to_string(group) + "-delta");
  if (sit == a->streams.end() || part_idx >= sit->second.size()) return nullptr;
  uint64_t meta;
  std::vector<uint8_t> payload;
  if (!read_part(a, sit->second[part_idx], meta, payload)) return nullptr;
  std::vector<uint8_t> raw;
  if (meta == 0) {
    raw = std::move(payload);
  } else if (!zstd_decode(payload, meta, raw) || raw.size() != meta) {
    return nullptr;
  }
  std::vector<std::string> recs;
  size_t start = 0;
  for (size_t i = 0; i <= raw.size(); ++i) {
    if (i == raw.size() || raw[i] == 0xff) {
      recs.emplace_back((const char *)raw.data() + start, i - start);
      start = i + 1;
    }
  }
  auto pack = std::make_shared<const std::vector<std::string>>(std::move(recs));
  std::lock_guard<std::mutex> lk(a->cache_mu);
  if (a->pack_cache.size() >= AgcArchive::kMaxPacks && !a->pack_lru.empty()) {
    a->pack_cache.erase(a->pack_lru.front());
    a->pack_lru.pop_front();
  }
  auto ins = a->pack_cache.emplace(key, pack);
  if (ins.second) a->pack_lru.push_back(key);
  return ins.first->second;
}

// one decoded segment (stored orientation) as ASCII bases
bool get_segment(AgcArchive *a, const AgcSegment &sg, std::string &out) {
  const std::string *ref = get_ref_segment(a, sg.group);
  if (sg.igid == 0) {
    if (!ref) return false;
    out = *ref;
    return true;
  }
  uint32_t part_idx = (sg.igid - 1) / a->pack_card;
  uint32_t rec_idx = (sg.igid - 1) % a->pack_card;
  auto pack = get_delta_pack(a, sg.group, part_idx);
  if (!pack || rec_idx >= pack->size()) return false;
  static const std::string kEmpty;
  out.clear();
  return lz_decode((*pack)[rec_idx], ref ? *ref : kEmpty, a->min_match, out);
}

void rc_inplace(std::string &s) {
  size_t i = 0, j = s.size();
  auto comp = [](char c) {
    switch (c) {
      case 'A': return 'T';
      case 'C': return 'G';
      case 'G': return 'C';
      case 'T': return 'A';
      default: return c;
    }
  };
  while (i + 1 < j) {
    char t = comp(s[i]);
    s[i] = comp(s[j - 1]);
    s[j - 1] = t;
    ++i;
    --j;
  }
  if (i + 1 == j) s[i] = comp(s[i]);
}

bool load_collection(AgcArchive *a) {
  auto main_it = a->streams.find("collection-main");
  auto det_it = a->streams.find("collection-details");
  if (main_it == a->streams.end() || det_it == a->streams.end()) return false;

  uint64_t meta;
  std::vector<uint8_t> comp, main_buf, det_buf;
  if (!read_part(a, main_it->second[0], meta, comp)) return false;
  if (!zstd_decode(comp, meta, main_buf)) return false;
  if (!read_part(a, det_it->second[0], meta, comp)) return false;
  if (!zstd_decode(comp, meta, det_buf)) return false;

  bool ok = true;
  size_t p = 0;
  const uint8_t *mb = main_buf.data();
  size_t ml = main_buf.size();
  read_pvarint(mb, ml, p, ok);  // header value; not needed for reading
  uint64_t n_samples = read_pvarint(mb, ml, p, ok);
  // count bounds: each sample/contig consumes >= 2 main-buffer bytes,
  // each segment >= 1 details byte per column — crafted counts must
  // fail BEFORE the resizes (zstd-valid payloads reach this parser)
  if (!ok || n_samples > ml / 2) return false;
  a->samples.resize(n_samples);
  size_t total_segs = 0;
  for (auto &s : a->samples) {
    s.name = read_cstring(mb, ml, p, ok);
    uint64_t nc = read_pvarint(mb, ml, p, ok);
    if (!ok || nc > ml / 2) return false;
    s.contigs.resize(nc);
    for (auto &c : s.contigs) {
      c.name = read_cstring(mb, ml, p, ok);
      uint64_t ns = read_pvarint(mb, ml, p, ok);
      // each segment consumes >= 4 details bytes (1 per column), and
      // the RUNNING total must hold before every resize — allocations
      // otherwise accumulate across contigs (AgcSegment is 16 bytes:
      // a zstd-bomb details blob could request terabytes mid-loop)
      total_segs += ns;
      if (!ok || total_segs > det_buf.size() / 4 ||
          total_segs > (size_t{1} << 26))
        return false;
      c.segs.resize(ns);
    }
  }

  // details: four columns over all segments in collection order
  const uint8_t *db = det_buf.data();
  size_t dl = det_buf.size();
  p = 0;
  // column 1: groups
  for (auto &s : a->samples)
    for (auto &c : s.contigs)
      for (size_t i = 0; i < c.segs.size(); ++i) {
        uint64_t v = read_pvarint(db, dl, p, ok);
        c.segs[i].group =
            i == 0 ? (uint32_t)v
                   : (uint32_t)((int64_t)c.segs[i - 1].group + unzigzag(v));
      }
  // columns 2+3: in-group ids, raw lengths (flank-predictor rule)
  auto read_col = [&](auto field) {
    for (auto &s : a->samples)
      for (auto &c : s.contigs)
        for (size_t i = 0; i < c.segs.size(); ++i) {
          uint64_t v = read_pvarint(db, dl, p, ok);
          if (i == 0 || !a->full_groups.count(c.segs[i - 1].group)) {
            field(c.segs[i]) = (uint32_t)v;
          } else {
            field(c.segs[i]) = (uint32_t)((int64_t)field(c.segs[i - 1]) +
                                          unzigzag(v));
          }
        }
  };
  read_col([](AgcSegment &sg) -> uint32_t & { return sg.igid; });
  read_col([](AgcSegment &sg) -> uint32_t & { return sg.len; });
  // column 4: orientations
  for (auto &s : a->samples)
    for (auto &c : s.contigs)
      for (auto &sg : c.segs)
        sg.is_rc = (uint8_t)read_pvarint(db, dl, p, ok);
  if (!ok) return false;

  for (auto &s : a->samples)
    for (auto &c : s.contigs) {
      uint64_t total = 0;
      for (size_t i = 0; i < c.segs.size(); ++i)
        total += i == 0 ? c.segs[i].len
                        : (uint64_t)c.segs[i].len - a->kmer_len;
      c.len = total;
      a->by_name[{s.name, c.name}] = &c;
    }
  return true;
}

const AgcContig *find_contig(AgcArchive *a, const char *sample,
                             const char *ctg) {
  if (sample && sample[0]) {
    auto it = a->by_name.find({sample, ctg});
    return it == a->by_name.end() ? nullptr : it->second;
  }
  // empty sample: search all samples (reference agc behavior)
  for (auto &s : a->samples) {
    auto it = a->by_name.find({s.name, ctg});
    if (it != a->by_name.end()) return it->second;
  }
  return nullptr;
}

}  // namespace

extern "C" {

void *agc_open(const char *path) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return nullptr;
  if (std::fseek(f, -8, SEEK_END) != 0) { std::fclose(f); return nullptr; }
  long fsize = std::ftell(f) + 8;
  uint64_t footer_size = 0;
  if (std::fread(&footer_size, 8, 1, f) != 1 ||
      footer_size > (uint64_t)fsize - 8) {  // subtraction form: +8 wraps
    std::fclose(f);
    return nullptr;
  }
  std::vector<uint8_t> foot(footer_size);
  std::fseek(f, (long)(fsize - 8 - (long)footer_size), SEEK_SET);
  if (std::fread(foot.data(), 1, footer_size, f) != footer_size) {
    std::fclose(f);
    return nullptr;
  }
  auto a = std::make_unique<AgcArchive>();
  a->f = f;
  a->file_size = (uint64_t)fsize;
  bool ok = true;
  size_t p = 0;
  uint64_t n_streams = read_varint(foot.data(), foot.size(), p, ok);
  for (uint64_t i = 0; ok && i < n_streams; ++i) {
    std::string name = read_cstring(foot.data(), foot.size(), p, ok);
    uint64_t n_parts = read_varint(foot.data(), foot.size(), p, ok);
    read_varint(foot.data(), foot.size(), p, ok);  // raw_size (unused)
    // each part record needs >= 2 footer bytes: reject crafted counts
    // before the resize
    if (!ok || n_parts > footer_size / 2) return nullptr;
    auto &parts = a->streams[name];
    parts.resize(n_parts);
    for (auto &pt : parts) {
      pt.offset = read_varint(foot.data(), foot.size(), p, ok);
      pt.size = read_varint(foot.data(), foot.size(), p, ok);
    }
  }
  if (!ok || !a->streams.count("params") ||
      !a->streams.count("collection-main"))
    return nullptr;

  uint64_t meta;
  std::vector<uint8_t> buf;
  if (!read_part(a.get(), a->streams["params"][0], meta, buf) ||
      buf.size() < 16)
    return nullptr;
  std::memcpy(&a->kmer_len, buf.data(), 4);
  std::memcpy(&a->min_match, buf.data() + 4, 4);
  std::memcpy(&a->pack_card, buf.data() + 8, 4);
  std::memcpy(&a->seg_size, buf.data() + 12, 4);
  if (a->pack_card == 0) return nullptr;

  if (a->streams.count("segment-splitters")) {
    if (!read_part(a.get(), a->streams["segment-splitters"][0], meta, buf))
      return nullptr;
    for (uint64_t i = 0; i < meta && 20 * (i + 1) <= buf.size(); ++i) {
      uint64_t k2;
      uint32_t gid;
      std::memcpy(&k2, buf.data() + 20 * i + 8, 8);
      std::memcpy(&gid, buf.data() + 20 * i + 16, 4);
      if (k2 != ~0ULL) a->full_groups.insert(gid);
    }
  }

  if (!load_collection(a.get())) return nullptr;
  return a.release();
}

void agc_close(void *h) { delete (AgcArchive *)h; }

int64_t agc_n_samples(void *h) {
  return (int64_t)((AgcArchive *)h)->samples.size();
}

char *agc_list_samples(void *h) {
  auto *a = (AgcArchive *)h;
  std::string out;
  for (auto &s : a->samples) {
    out += s.name;
    out += '\n';
  }
  char *buf = (char *)std::malloc(out.size() + 1);
  std::memcpy(buf, out.c_str(), out.size() + 1);
  return buf;
}

char *agc_list_ctgs(void *h, const char *sample) {
  auto *a = (AgcArchive *)h;
  std::string out;
  for (auto &s : a->samples) {
    if (s.name != sample) continue;
    for (auto &c : s.contigs) {
      out += c.name;
      out += '\t';
      out += std::to_string(c.len);
      out += '\n';
    }
  }
  char *buf = (char *)std::malloc(out.size() + 1);
  std::memcpy(buf, out.c_str(), out.size() + 1);
  return buf;
}

int64_t agc_get_ctg_len(void *h, const char *sample, const char *ctg) {
  const AgcContig *c = find_contig((AgcArchive *)h, sample, ctg);
  return c ? (int64_t)c->len : -1;
}

// Fetch [bgn, end) into a malloc'd buffer; end < 0 means contig end.
// Decodes only the segments overlapping the range.
int64_t agc_get_sub_seq(void *h, const char *sample, const char *ctg,
                        int64_t bgn, int64_t end, uint8_t **out) {
  auto *a = (AgcArchive *)h;
  const AgcContig *c = find_contig(a, sample, ctg);
  if (!c) return -1;
  if (bgn < 0) bgn = 0;
  if (end < 0 || end > (int64_t)c->len) end = (int64_t)c->len;
  if (bgn >= end) {
    *out = (uint8_t *)std::malloc(1);
    return 0;
  }
  std::string piece;
  std::string result;
  result.reserve((size_t)(end - bgn));
  int64_t cpos = 0;  // contig coordinate where the current segment starts
  for (size_t i = 0; i < c->segs.size() && cpos < end; ++i) {
    const AgcSegment &sg = c->segs[i];
    int64_t skip = i == 0 ? 0 : a->kmer_len;          // overlap with prev
    int64_t contrib = (int64_t)sg.len - skip;          // bases this seg adds
    if (cpos + contrib <= bgn) {
      cpos += contrib;
      continue;
    }
    piece.clear();
    if (!get_segment(a, sg, piece) || (int64_t)piece.size() != (int64_t)sg.len)
      return -1;
    if (sg.is_rc) rc_inplace(piece);
    int64_t s = skip + (bgn > cpos ? bgn - cpos : 0);
    int64_t e = skip + (end - cpos < contrib ? end - cpos : contrib);
    result.append(piece, (size_t)s, (size_t)(e - s));
    cpos += contrib;
  }
  if ((int64_t)result.size() != end - bgn) return -1;
  uint8_t *buf = (uint8_t *)std::malloc(result.size() + 1);
  std::memcpy(buf, result.data(), result.size() + 1);
  *out = buf;
  return (int64_t)result.size();
}

}  // extern "C"
