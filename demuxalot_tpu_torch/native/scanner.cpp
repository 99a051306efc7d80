// Native BAM region scanner: the hot ingest path of the SNP counter.
//
// Fuses BGZF decompression, BAM record decoding, read filtering (alignment
// score / NH / UMI / mapq / barcode whitelist), molecule grouping by
// (cell barcode, UMI), and consensus base calling into one C++ pass —
// replacing the per-read Python loop (frontend/snp_counter.py). The
// numeric chain matches the Python implementation exactly (IEEE doubles,
// same operation order): p_wrong *= 0.1^(0.1*min(qual,40)), duplicate skip
// by (start, end, AS), the x1000 conflict cutoff, and stream flushing every
// SEGMENT_LENGTH bp.
//
// Driven from Python via ctypes (region chunks come from the Python-side
// BAI index); one call per region-shard task, GIL released for the call.

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include <zlib.h>

namespace {

constexpr int SEGMENT_LENGTH = 1000;
constexpr uint64_t UMI_PRIME = 2147483629ULL;

// ---------------------------------------------------------------------------
// BGZF stream positioned by virtual offsets
// ---------------------------------------------------------------------------
struct BgzfStream {
  FILE* fp = nullptr;
  uint64_t block_coffset = UINT64_MAX;  // compressed offset of current block
  uint32_t block_csize = 0;
  std::vector<uint8_t> payload;
  size_t upos = 0;  // position within payload
  uint64_t file_size = 0;
  // set when a block that exists on disk fails to parse/inflate/CRC-check;
  // distinguishes corruption from clean EOF so entry points can report an
  // error instead of silently returning partial results
  bool corrupt = false;

  bool open(const char* path) {
    fp = fopen(path, "rb");
    if (!fp) return false;
    fseek(fp, 0, SEEK_END);
    file_size = ftell(fp);
    return true;
  }
  ~BgzfStream() {
    if (fp) fclose(fp);
  }

  // a block that exists on disk but cannot be parsed is corruption, not
  // EOF: poison the stream so reads stop AND the caller can tell the two
  // apart (silent partial results are the failure mode this prevents)
  bool fail_corrupt() {
    corrupt = true;
    payload.clear();
    upos = 0;
    return false;
  }

  // load the BGZF block starting at compressed offset `coffset`
  bool load_block(uint64_t coffset) {
    if (coffset >= file_size) {
      payload.clear();
      upos = 0;
      block_coffset = coffset;
      block_csize = 0;
      return false;
    }
    uint8_t header[18];
    fseek(fp, (long)coffset, SEEK_SET);
    if (fread(header, 1, 18, fp) != 18) return fail_corrupt();
    if (header[0] != 0x1f || header[1] != 0x8b) return fail_corrupt();
    uint16_t xlen = header[10] | (header[11] << 8);
    // scan extra subfields for BC (BSIZE)
    std::vector<uint8_t> extra(xlen);
    size_t from_header = std::min<size_t>(xlen, 6);
    memcpy(extra.data(), header + 12, from_header);
    if (xlen > 6) {
      if (fread(extra.data() + 6, 1, xlen - 6, fp) != (size_t)(xlen - 6)) return fail_corrupt();
    } else if (xlen < 6) {
      // consumed more header bytes than the extra field holds: rewind
      fseek(fp, (long)(coffset + 12 + xlen), SEEK_SET);
    }
    uint32_t bsize = 0;
    for (size_t p = 0; p + 4 <= extra.size();) {
      uint8_t si1 = extra[p], si2 = extra[p + 1];
      uint16_t slen = extra[p + 2] | (extra[p + 3] << 8);
      if (si1 == 66 && si2 == 67 && slen == 2) {
        bsize = (extra[p + 4] | (extra[p + 5] << 8)) + 1;
      }
      p += 4 + slen;
    }
    if (bsize == 0) return fail_corrupt();
    uint32_t cdata_len = bsize - 12 - xlen - 8;
    std::vector<uint8_t> cdata(cdata_len);
    fseek(fp, (long)(coffset + 12 + xlen), SEEK_SET);
    if (fread(cdata.data(), 1, cdata_len, fp) != cdata_len) return fail_corrupt();
    uint32_t crc_expect, isize;
    fseek(fp, (long)(coffset + bsize - 8), SEEK_SET);
    if (fread(&crc_expect, 4, 1, fp) != 1) return fail_corrupt();
    if (fread(&isize, 4, 1, fp) != 1) return fail_corrupt();

    payload.resize(isize);
    if (isize > 0) {
      z_stream zs{};
      inflateInit2(&zs, -15);
      zs.next_in = cdata.data();
      zs.avail_in = cdata_len;
      zs.next_out = payload.data();
      zs.avail_out = isize;
      int ret = inflate(&zs, Z_FINISH);
      inflateEnd(&zs);
      if (ret != Z_STREAM_END) return fail_corrupt();
      // bit-flipped cdata can still inflate to isize bytes; the gzip CRC32
      // trailer is the only check that catches silent corruption
      if (crc32(0L, payload.data(), isize) != crc_expect) return fail_corrupt();
    }
    block_coffset = coffset;
    block_csize = bsize;
    upos = 0;
    return true;
  }

  void seek_virtual(uint64_t voffset) {
    uint64_t coffset = voffset >> 16;
    if (coffset != block_coffset && !load_block(coffset)) {
      // failed target block (corrupt or past EOF): poison rather than
      // leaving upos pointing into the PREVIOUS block's stale payload
      if (!corrupt && coffset < file_size) corrupt = true;
      payload.clear();
      upos = 0;
      return;
    }
    upos = voffset & 0xffff;
    if (upos > payload.size()) {
      // in-block offset beyond the decompressed payload is a corrupt index
      corrupt = true;
      payload.clear();
      upos = 0;
    }
  }

  uint64_t virtual_offset() const { return (block_coffset << 16) | upos; }

  // read exactly n bytes (crossing block boundaries); false on EOF
  bool read(uint8_t* dst, size_t n) {
    size_t got = 0;
    while (got < n) {
      if (corrupt) return false;
      size_t avail = upos < payload.size() ? payload.size() - upos : 0;
      if (avail == 0) {
        uint64_t next = block_coffset + block_csize;
        if (next >= file_size) return false;
        if (!load_block(next)) return false;
        if (payload.empty()) continue;  // EOF marker block
        continue;
      }
      size_t take = std::min(avail, n - got);
      memcpy(dst + got, payload.data() + upos, take);
      upos += take;
      got += take;
    }
    return true;
  }
};

// ---------------------------------------------------------------------------
// Scan state
// ---------------------------------------------------------------------------
struct ReadEvidence {
  int32_t start, end, as_score;
  double p_misaligned;
  // SNP observations of this read: (position, base_index 0..4, qual)
  std::vector<std::array<int32_t, 3>> snps;
};

struct MoleculeGroup {
  int32_t max_end = -1;
  std::vector<ReadEvidence> reads;
};

struct CallRow {
  int32_t molecule_index, position;
  uint8_t base;
  float p_wrong;
};

struct MolRow {
  int32_t cb, ub;
  float p_misaligned;
};

struct ScanResult {
  std::vector<MolRow> molecules;
  std::vector<CallRow> calls;
};

struct SnpLookup {
  const int32_t* positions;
  int n;
  // cumulative count lookup: snps in [a, b) ?
  bool any_in(int32_t a, int32_t b) const {
    const int32_t* lo = std::lower_bound(positions, positions + n, a);
    return lo != positions + n && *lo < b;
  }
};

int base_index_of(uint8_t bam4bit) {
  // BAM 4-bit code -> ACGTN index (0..4); anything else N
  switch (bam4bit) {
    case 1: return 0;   // A
    case 2: return 1;   // C
    case 4: return 2;   // G
    case 8: return 3;   // T
    default: return 4;  // N and ambiguity codes
  }
}

struct TagValues {
  bool has_cb = false, has_umi = false, has_nh = false, has_as = false;
  std::string cb;
  std::string umi;
  int64_t nh = 0, as_score = 0;
};

// parse the tag block; returns false on malformed data (all fixed-width
// reads are bounds-checked so corrupt records cannot overread the buffer)
bool parse_tags(const uint8_t* p, const uint8_t* end, const char* cb_tag,
                const char* umi_tag, const char* nh_tag, const char* as_tag,
                TagValues& out) {
  while (p + 3 <= end) {
    char t0 = p[0], t1 = p[1], typ = p[2];
    p += 3;
    int64_t ival = 0;
    const char* sval = nullptr;
    size_t slen = 0;
    switch (typ) {
      // 'A' is a printable character per the SAM spec; expose it as a
      // one-char string so an A-typed CB/UMI matches the Python path
      // (pysam-style get_tag returns str for 'A')
      case 'A': if (p + 1 > end) return false; sval = (const char*)p; slen = 1; p += 1; break;
      case 'c': if (p + 1 > end) return false; ival = *(int8_t*)p; p += 1; break;
      case 'C': if (p + 1 > end) return false; ival = *(uint8_t*)p; p += 1; break;
      case 's': { if (p + 2 > end) return false; int16_t v; memcpy(&v, p, 2); ival = v; p += 2; break; }
      case 'S': { if (p + 2 > end) return false; uint16_t v; memcpy(&v, p, 2); ival = v; p += 2; break; }
      case 'i': { if (p + 4 > end) return false; int32_t v; memcpy(&v, p, 4); ival = v; p += 4; break; }
      case 'I': { if (p + 4 > end) return false; uint32_t v; memcpy(&v, p, 4); ival = v; p += 4; break; }
      case 'f': if (p + 4 > end) return false; p += 4; break;
      case 'Z': case 'H': {
        sval = (const char*)p;
        while (p < end && *p) p++;
        if (p >= end) return false;  // missing NUL terminator
        slen = (const uint8_t*)p - (const uint8_t*)sval;
        p += 1;
        break;
      }
      case 'B': {
        if (p + 5 > end) return false;
        char sub = (char)*p;
        p += 1;
        uint32_t count;
        memcpy(&count, p, 4);
        p += 4;
        size_t esize = (sub == 'c' || sub == 'C') ? 1 : (sub == 's' || sub == 'S') ? 2 : 4;
        if ((uint64_t)(end - p) < (uint64_t)esize * count) return false;
        p += esize * count;
        break;
      }
      default:
        return false;
    }
    if (t0 == cb_tag[0] && t1 == cb_tag[1] && sval) {
      out.cb.assign(sval, slen);
      out.has_cb = true;
    } else if (t0 == umi_tag[0] && t1 == umi_tag[1] && sval) {
      out.umi.assign(sval, slen);
      out.has_umi = true;
    } else if (t0 == nh_tag[0] && t1 == nh_tag[1] && !sval) {
      out.nh = ival;
      out.has_nh = true;
    } else if (t0 == as_tag[0] && t1 == as_tag[1] && !sval) {
      out.as_score = ival;
      out.has_as = true;
    }
  }
  return true;
}

int32_t umi_hash(const std::string& s) {
  uint64_t r = 0;
  for (unsigned char c : s) r = (r * 5 + c) % UMI_PRIME;
  return (int32_t)r;
}

// qual -> 0.1^(0.1*min(qual,40)), precomputed with the identical pow call so
// results are bit-equal to the direct computation
struct QualTable {
  double factor[256];
  QualTable() {
    for (int q = 0; q < 256; q++) factor[q] = std::pow(0.1, 0.1 * std::min(q, 40));
  }
};
const QualTable kQualTable;

// consensus-call one molecule; matches compress_molecule_reads_to_snips
void consensus_and_emit(int32_t cb, int32_t ub, MoleculeGroup& group,
                        const SnpLookup& lookup, ScanResult& out) {
  int32_t span_start = INT32_MAX, span_end = INT32_MIN;
  for (auto& r : group.reads) {
    span_start = std::min(span_start, r.start);
    span_end = std::max(span_end, r.end);
  }
  if (!lookup.any_in(span_start, span_end + 1)) return;

  // fast path: one read per molecule (the common case) — every covered
  // position yields exactly one candidate base, no conflict handling needed
  if (group.reads.size() == 1) {
    auto& r = group.reads[0];
    if (r.snps.empty()) return;
    int32_t mol_index = (int32_t)out.molecules.size();
    out.molecules.push_back({cb, ub, (float)r.p_misaligned});
    for (auto& s : r.snps) {
      out.calls.push_back({mol_index, s[0], (uint8_t)s[1], (float)kQualTable.factor[s[2] & 0xff]});
    }
    return;
  }

  double p_group_misaligned = 1.0;
  // duplicate skip by exact (start, end, AS) triple
  std::vector<std::array<int32_t, 3>> seen;
  // position -> (base -> p_wrong) kept in first-seen order like Python dicts
  std::vector<int32_t> positions_order;
  std::unordered_map<int32_t, std::vector<std::pair<int, double>>> pos2bases;

  for (auto& r : group.reads) {
    std::array<int32_t, 3> key{r.start, r.end, r.as_score};
    bool dup = false;
    for (auto& k : seen)
      if (k == key) { dup = true; break; }
    if (dup) continue;
    seen.push_back(key);
    p_group_misaligned *= r.p_misaligned;

    for (auto& s : r.snps) {
      auto& bases = pos2bases[s[0]];
      if (bases.empty()) positions_order.push_back(s[0]);
      double factor = kQualTable.factor[s[2] & 0xff];
      bool found = false;
      for (auto& bp : bases) {
        if (bp.first == s[1]) {
          bp.second *= factor;
          found = true;
          break;
        }
      }
      if (!found) bases.emplace_back(s[1], factor);
    }
  }

  // emit consensus calls
  int32_t mol_index = -1;
  for (int32_t pos : positions_order) {
    auto& bases = pos2bases[pos];
    if (bases.size() > 1) {
      double best = bases[0].second;
      for (auto& bp : bases) best = std::min(best, bp.second);
      size_t kept = 0;
      int keep_base = 0;
      double keep_p = 0;
      for (auto& bp : bases)
        if (bp.second <= best * 1000.0) { kept++; keep_base = bp.first; keep_p = bp.second; }
      if (kept != 1) continue;
      bases.resize(1);
      bases[0] = {keep_base, keep_p};
    }
    if (bases.size() != 1) continue;
    if (mol_index < 0) {
      mol_index = (int32_t)out.molecules.size();
      out.molecules.push_back({cb, ub, (float)p_group_misaligned});
    }
    out.calls.push_back({mol_index, pos, (uint8_t)bases[0].first, (float)bases[0].second});
  }
}

struct Scanner {
  ScanResult result;
};

}  // namespace

extern "C" {

// Scan one region of one chromosome. Returns an opaque handle (or nullptr).
void* scan_region(
    const char* bam_path,
    const uint64_t* chunk_vbeg, const uint64_t* chunk_vend, int n_chunks,
    int32_t ref_id, int32_t region_start, int32_t region_stop,
    const int32_t* snp_positions, int n_positions,
    const char* const* barcodes, int n_barcodes,
    const char* cb_tag, const char* umi_tag, const char* nh_tag, const char* as_tag,
    int score_diff_max, int mapq_threshold, double p_misaligned_default) {
  BgzfStream bgzf;
  if (!bgzf.open(bam_path)) return nullptr;

  std::unordered_map<std::string, int32_t> whitelist;
  whitelist.reserve(n_barcodes * 2);
  for (int i = 0; i < n_barcodes; i++) whitelist.emplace(barcodes[i], i);

  SnpLookup lookup{snp_positions, n_positions};
  auto scanner = new Scanner();

  // molecule groups keyed by (cb, ub), iterated in insertion order on flush
  std::unordered_map<uint64_t, MoleculeGroup> groups;
  std::vector<uint64_t> group_order;
  int64_t prev_segment = INT64_MIN;

  auto flush = [&](double threshold) {
    std::vector<uint64_t> remaining_order;
    remaining_order.reserve(group_order.size());
    for (uint64_t key : group_order) {
      auto it = groups.find(key);
      if (it == groups.end()) continue;
      if ((double)it->second.max_end < threshold) {
        consensus_and_emit((int32_t)(key >> 32), (int32_t)(key & 0xffffffff),
                           it->second, lookup, scanner->result);
        groups.erase(it);
      } else {
        remaining_order.push_back(key);
      }
    }
    group_order.swap(remaining_order);
  };

  std::vector<uint8_t> rec;
  for (int c = 0; c < n_chunks; c++) {
    bgzf.seek_virtual(chunk_vbeg[c]);
    while (bgzf.virtual_offset() < chunk_vend[c]) {
      uint32_t block_size;
      if (!bgzf.read((uint8_t*)&block_size, 4)) goto done;
      rec.resize(block_size);
      if (!bgzf.read(rec.data(), block_size)) goto done;

      int32_t r_ref, r_pos;
      memcpy(&r_ref, rec.data(), 4);
      memcpy(&r_pos, rec.data() + 4, 4);
      if (r_ref != ref_id) {
        if (r_ref > ref_id || r_ref == -1) goto next_chunk;
        continue;
      }
      if (r_pos >= region_stop) goto next_chunk;

      uint8_t l_read_name = rec[8];
      uint8_t mapq = rec[9];
      uint16_t n_cigar;
      memcpy(&n_cigar, rec.data() + 12, 2);
      uint16_t flag;
      memcpy(&flag, rec.data() + 14, 2);
      uint32_t l_seq;
      memcpy(&l_seq, rec.data() + 16, 4);
      if (flag & 0x4) continue;  // unmapped

      const uint8_t* cigar = rec.data() + 32 + l_read_name;
      const uint8_t* seq4 = cigar + 4 * n_cigar;
      const uint8_t* qual = seq4 + (l_seq + 1) / 2;
      const uint8_t* tags = qual + l_seq;
      const uint8_t* rec_end = rec.data() + block_size;

      // reference span
      int32_t span = 0;
      for (int i = 0; i < n_cigar; i++) {
        uint32_t v;
        memcpy(&v, cigar + 4 * i, 4);
        uint32_t op = v & 0xf;
        if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8) span += v >> 4;
      }
      int32_t r_end = r_pos + span;
      if (r_end <= region_start) continue;  // no overlap with region

      // filters (parse_read semantics)
      TagValues tv;
      if (!parse_tags(tags, rec_end, cb_tag, umi_tag, nh_tag, as_tag, tv)) continue;
      if (!tv.has_as || tv.as_score <= (int64_t)l_seq - score_diff_max) continue;
      if (!tv.has_nh || tv.nh > 1) continue;
      if (!tv.has_umi) continue;
      if (mapq < mapq_threshold) continue;
      if (!tv.has_cb) continue;
      auto wit = whitelist.find(tv.cb);
      if (wit == whitelist.end()) continue;

      {
        int32_t cb_index = wit->second;
        int32_t ub = umi_hash(tv.umi);

        ReadEvidence ev;
        ev.start = r_pos;
        ev.end = r_end;
        ev.as_score = (int32_t)tv.as_score;
        ev.p_misaligned = p_misaligned_default;

        // CIGAR walk extracting bases at SNP positions
        if (lookup.any_in(r_pos, r_end + 1)) {
          int32_t read_pos = 0, ref_pos = r_pos;
          for (int i = 0; i < n_cigar; i++) {
            uint32_t v;
            memcpy(&v, cigar + 4 * i, 4);
            uint32_t op = v & 0xf, len = v >> 4;
            if (op == 0 || op == 7 || op == 8) {
              const int32_t* lo =
                  std::lower_bound(snp_positions, snp_positions + n_positions, ref_pos);
              const int32_t* hi = std::lower_bound(lo, snp_positions + n_positions,
                                                   ref_pos + (int32_t)len);
              for (const int32_t* pp = lo; pp != hi; ++pp) {
                int32_t in_read = read_pos + (*pp - ref_pos);
                uint8_t b4 = seq4[in_read >> 1];
                uint8_t code = (in_read & 1) ? (b4 & 0xf) : (b4 >> 4);
                ev.snps.push_back({*pp, base_index_of(code), (int32_t)qual[in_read]});
              }
              ref_pos += len;
              read_pos += len;
            } else if (op == 2 || op == 3) {
              ref_pos += len;
            } else if (op == 1 || op == 4) {
              // I/S consume query bases; H/P (5/6) consume nothing
              read_pos += len;
            }
          }
        }

        uint64_t key = ((uint64_t)(uint32_t)cb_index << 32) | (uint32_t)ub;
        auto git = groups.find(key);
        if (git == groups.end()) {
          auto& g = groups[key];
          g.max_end = r_end;
          g.reads.push_back(std::move(ev));
          group_order.push_back(key);
        } else {
          git->second.max_end = std::max(git->second.max_end, r_end);
          git->second.reads.push_back(std::move(ev));
        }

        int64_t curr_segment = r_pos / SEGMENT_LENGTH;
        if (curr_segment != prev_segment) {
          flush((double)r_pos - SEGMENT_LENGTH);
          prev_segment = curr_segment;
        }
      }
    }
  next_chunk:;
  }
done:
  if (bgzf.corrupt) {
    delete scanner;
    return nullptr;  // python side raises; partial results must not pass as complete
  }
  flush(1e300);
  return scanner;
}

// Per-position A/C/G/T coverage over [region_start, region_stop) — the
// pileup stage of SNP discovery (pysam count_coverage work-alike: reads
// must pass the tag filter, bases below quality_threshold are skipped).
// counts: int64[4 * (region_stop - region_start)], row-major by base.
int count_coverage(
    const char* bam_path,
    const uint64_t* chunk_vbeg, const uint64_t* chunk_vend, int n_chunks,
    int32_t ref_id, int32_t region_start, int32_t region_stop,
    const char* umi_tag, const char* nh_tag, const char* as_tag,
    int score_diff_max, int mapq_threshold, int quality_threshold,
    int64_t* counts) {
  BgzfStream bgzf;
  if (!bgzf.open(bam_path)) return -1;
  const char* cb_tag = "CB";  // unused for filtering here; parse_tags needs one
  int32_t length = region_stop - region_start;

  std::vector<uint8_t> rec;
  for (int c = 0; c < n_chunks; c++) {
    bgzf.seek_virtual(chunk_vbeg[c]);
    while (bgzf.virtual_offset() < chunk_vend[c]) {
      uint32_t block_size;
      if (!bgzf.read((uint8_t*)&block_size, 4)) return bgzf.corrupt ? -1 : 0;
      rec.resize(block_size);
      if (!bgzf.read(rec.data(), block_size)) return bgzf.corrupt ? -1 : 0;

      int32_t r_ref, r_pos;
      memcpy(&r_ref, rec.data(), 4);
      memcpy(&r_pos, rec.data() + 4, 4);
      if (r_ref != ref_id) {
        if (r_ref > ref_id || r_ref == -1) goto next_chunk;
        continue;
      }
      if (r_pos >= region_stop) goto next_chunk;

      {
        uint8_t l_read_name = rec[8];
        uint8_t mapq = rec[9];
        uint16_t n_cigar;
        memcpy(&n_cigar, rec.data() + 12, 2);
        uint16_t flag;
        memcpy(&flag, rec.data() + 14, 2);
        uint32_t l_seq;
        memcpy(&l_seq, rec.data() + 16, 4);
        if (flag & 0x4) continue;

        const uint8_t* cigar = rec.data() + 32 + l_read_name;
        const uint8_t* seq4 = cigar + 4 * n_cigar;
        const uint8_t* qual = seq4 + (l_seq + 1) / 2;
        const uint8_t* tags = qual + l_seq;
        const uint8_t* rec_end = rec.data() + block_size;

        TagValues tv;
        if (!parse_tags(tags, rec_end, cb_tag, umi_tag, nh_tag, as_tag, tv)) continue;
        if (!tv.has_as || tv.as_score <= (int64_t)l_seq - score_diff_max) continue;
        if (!tv.has_nh || tv.nh > 1) continue;
        if (!tv.has_umi) continue;
        if (mapq < mapq_threshold) continue;

        int32_t read_pos = 0, ref_pos = r_pos;
        for (int i = 0; i < n_cigar; i++) {
          uint32_t v;
          memcpy(&v, cigar + 4 * i, 4);
          uint32_t op = v & 0xf, len = v >> 4;
          if (op == 0 || op == 7 || op == 8) {
            int32_t lo = std::max(ref_pos, region_start);
            int32_t hi = std::min(ref_pos + (int32_t)len, region_stop);
            for (int32_t rp = lo; rp < hi; rp++) {
              int32_t qp = read_pos + (rp - ref_pos);
              if (qual[qp] < quality_threshold) continue;
              uint8_t b4 = seq4[qp >> 1];
              uint8_t code = (qp & 1) ? (b4 & 0xf) : (b4 >> 4);
              int bi = base_index_of(code);
              if (bi < 4) counts[(int64_t)bi * length + (rp - region_start)] += 1;
            }
            ref_pos += len;
            read_pos += len;
          } else if (op == 2 || op == 3) {
            ref_pos += len;
          } else if (op == 1 || op == 4) {
            read_pos += len;
          }
        }
      }
    }
  next_chunk:;
  }
  return 0;
}

int64_t scan_n_molecules(void* h) { return ((Scanner*)h)->result.molecules.size(); }
int64_t scan_n_calls(void* h) { return ((Scanner*)h)->result.calls.size(); }

void scan_fill(void* h, int32_t* mol_cb, int32_t* mol_ub, float* mol_p,
               int32_t* call_mol, int32_t* call_pos, uint8_t* call_base,
               float* call_p) {
  auto* s = (Scanner*)h;
  for (size_t i = 0; i < s->result.molecules.size(); i++) {
    mol_cb[i] = s->result.molecules[i].cb;
    mol_ub[i] = s->result.molecules[i].ub;
    mol_p[i] = s->result.molecules[i].p_misaligned;
  }
  for (size_t i = 0; i < s->result.calls.size(); i++) {
    call_mol[i] = s->result.calls[i].molecule_index;
    call_pos[i] = s->result.calls[i].position;
    call_base[i] = s->result.calls[i].base;
    call_p[i] = s->result.calls[i].p_wrong;
  }
}

void scan_free(void* h) { delete (Scanner*)h; }

}  // extern "C"
