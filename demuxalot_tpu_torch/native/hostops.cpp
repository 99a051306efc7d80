// Host-side packing primitives: stable radix argsort and hash join.
//
// The packing layer (ops/packing.py) and the kernel layout builders
// (ops/tiling.py, models/demux.py) are dominated by two numpy calls at
// product scale (~9M calls): np.argsort(kind="stable") on integer keys
// (~1.7 s) and np.searchsorted of calls into the variant registry
// (~1.4 s). Both are memory-shaped problems a specialized C++ routine
// beats ~10x: an LSD radix sort that only visits occupied bytes, and an
// open-addressing hash join whose table fits in L2.
//
// The reference has no counterpart (its packing is numpy end to end,
// demuxalot/demux.py:276-392); this is the "native runtime around the
// device compute path" layer of the TPU build.
//
// Build: g++ -O3 -march=native -std=c++17 -shared -fPIC hostops.cpp -o libdemuxhost.so
// (no external dependencies; see native/__init__.py for the on-demand build)

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#ifdef __linux__
#include <sys/mman.h>
#endif

namespace {

// This VM stalls hard on transparent-huge-page faults (compaction): a fresh
// ~300 MB allocation's first touch costs seconds (same pathology
// utils/platform.py:tune_numpy_allocator fixes for numpy). Opt the scratch
// buffers out BEFORE first touch.
template <typename T>
std::unique_ptr<T[]> alloc_nohuge(int64_t n) {
  // new T[n] without () leaves the memory untouched (no value-init)
  std::unique_ptr<T[]> p(new T[n]);
#ifdef __linux__
  auto addr = (uintptr_t)p.get();
  auto base = addr & ~(uintptr_t)4095;
  madvise((void*)base, (size_t)n * sizeof(T) + (addr - base), MADV_NOHUGEPAGE);
#endif
  return p;
}

int pick_threads(int64_t n) {
  const int hw = (int)std::thread::hardware_concurrency();
  return std::max(1, std::min<int>(hw ? hw : 1, (int)(n / 1'000'000)));
}

template <typename Fn>
void run_threaded(int n_threads, Fn&& fn) {
  if (n_threads == 1) {
    fn(0);
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(n_threads);
  for (int t = 0; t < n_threads; t++) ts.emplace_back(fn, t);
  for (auto& th : ts) th.join();
}

// Persistent grow-only scratch arena. glibc serves the multi-hundred-MB
// scratch buffers these routines need straight from mmap and unmaps them on
// delete, so EVERY call used to re-fault its whole working set — ~250k minor
// faults whose kernel servicing on this VM is erratic (measured 0.5-3.6 s
// of stime for identical work back to back). Keeping one pre-touched arena
// alive across calls removes the faults entirely after the first use.
// Callers hold g_arena_mu for the duration of the call (the Python wrappers
// release the GIL inside ctypes, so two Python threads could otherwise race;
// in practice hostops calls are serial and the lock is uncontended).
std::mutex g_arena_mu;

class Arena {
 public:
  char* ensure(size_t bytes) {
    if (bytes > cap_) {
      buf_.reset();  // free before alloc: no doubled peak
      size_t newcap = bytes + bytes / 8;
      buf_ = alloc_nohuge<char>(newcap);
      // pre-fault in parallel once; later calls reuse the warm pages
      // (~64 MB of fresh pages per thread; pick_threads' 1M divisor is
      // element-count oriented and would stay single-threaded here)
      const int hw = (int)std::thread::hardware_concurrency();
      const int n_threads = std::max(
          1, std::min<int>(hw ? hw : 1, (int)(newcap / (64u << 20)) + 1));
      char* p = buf_.get();
      const size_t block = (newcap + n_threads - 1) / n_threads;
      run_threaded(n_threads, [&](int t) {
        size_t lo = t * block, hi = std::min(newcap, lo + block);
        if (lo < hi) std::memset(p + lo, 0, hi - lo);
      });
      cap_ = newcap;
    }
    used_ = 0;
    return buf_.get();
  }
  // carve a sub-buffer (64-byte aligned) out of the ensured region
  template <typename T>
  T* take(int64_t count) {
    size_t bytes = ((size_t)count * sizeof(T) + 63) & ~(size_t)63;
    char* p = buf_.get() + used_;
    used_ += bytes;
    return (T*)p;
  }

 private:
  std::unique_ptr<char[]> buf_;
  size_t cap_ = 0;
  size_t used_ = 0;
};

Arena g_arena;

}  // namespace

namespace {

// LSD radix passes over (key, 8-byte payload) pairs with 11-bit digits,
// visiting only the occupied bit range: keys at demux scale occupy <= ~35
// bits (variant_id * cb_span + cb), so the sort costs 3-4 passes instead of
// numpy's comparison sort. Threaded per pass: per-block histograms, a
// (block, bucket) exclusive scan in bucket-major order (keeps the sort
// stable — lower blocks write a bucket's lower slots), then a parallel
// scatter. Returns the buffer pair holding the sorted result (may be either
// of cur/nxt depending on pass parity).
struct RadixBufs {
  uint64_t* keys;
  uint64_t* payload;
};

RadixBufs radix_pairs(uint64_t* cur_keys, uint64_t* cur_pay,
                      uint64_t* nxt_keys, uint64_t* nxt_pay, int64_t n) {
  constexpr int kDigitBits = 11;
  constexpr int kBuckets = 1 << kDigitBits;
  // occupied-bits scan threaded like every other full-array sweep here
  // (at 22M keys the serial version was one extra ~176 MB memory pass)
  uint64_t or_all = 0;
  {
    const int nt = pick_threads(n);
    const int64_t blk = (n + nt - 1) / nt;
    std::vector<uint64_t> partial(nt, 0);
    run_threaded(nt, [&](int t) {
      uint64_t acc = 0;
      const int64_t lo = t * blk, hi = std::min<int64_t>(n, lo + blk);
      for (int64_t i = lo; i < hi; i++) acc |= cur_keys[i];
      partial[t] = acc;
    });
    for (uint64_t v : partial) or_all |= v;
  }
  int top_bit = 0;
  while (top_bit < 64 && (or_all >> top_bit)) top_bit++;  // bits actually used
  // (the < 64 guard keeps a stray sign bit from shifting by >= 64 — UB that
  // on x86 wraps the shift count and would loop forever; negative keys are
  // rejected by the Python wrappers, this is defense in depth)

  const int n_threads = pick_threads(n);
  const int64_t block = (n + n_threads - 1) / n_threads;
  std::vector<int64_t> hist((size_t)n_threads * kBuckets);

  for (int shift = 0; shift < top_bit; shift += kDigitBits) {
    run_threaded(n_threads, [&](int t) {
      int64_t* h = hist.data() + (size_t)t * kBuckets;
      std::memset(h, 0, kBuckets * sizeof(int64_t));
      const int64_t lo = t * block, hi = std::min<int64_t>(n, lo + block);
      for (int64_t i = lo; i < hi; i++) h[(cur_keys[i] >> shift) & (kBuckets - 1)]++;
    });
    int64_t sum = 0;
    for (int b = 0; b < kBuckets; b++)
      for (int t = 0; t < n_threads; t++) {
        int64_t& slot = hist[(size_t)t * kBuckets + b];
        int64_t c = slot;
        slot = sum;
        sum += c;
      }
    run_threaded(n_threads, [&](int t) {
      int64_t* h = hist.data() + (size_t)t * kBuckets;
      const int64_t lo = t * block, hi = std::min<int64_t>(n, lo + block);
      for (int64_t i = lo; i < hi; i++) {
        int64_t dst = h[(cur_keys[i] >> shift) & (kBuckets - 1)]++;
        nxt_keys[dst] = cur_keys[i];
        nxt_pay[dst] = cur_pay[i];
      }
    });
    std::swap(cur_keys, nxt_keys);
    std::swap(cur_pay, nxt_pay);
  }
  return {cur_keys, cur_pay};
}

}  // namespace

extern "C" {

// Stable ascending argsort of non-negative int64 keys.
// out_order must hold n int64 slots. Scratch comes from the persistent
// arena so repeat calls touch no new pages.
void demux_radix_argsort_i64(const int64_t* keys, int64_t n, int64_t* out_order) {
  if (n <= 0) return;
  std::lock_guard<std::mutex> lock(g_arena_mu);
  g_arena.ensure((size_t)n * 32 + 256);
  uint64_t* cur_keys = g_arena.take<uint64_t>(n);
  uint64_t* nxt_keys = g_arena.take<uint64_t>(n);
  uint64_t* cur_idx = g_arena.take<uint64_t>(n);
  uint64_t* nxt_idx = g_arena.take<uint64_t>(n);
  for (int64_t i = 0; i < n; i++) {
    cur_keys[i] = (uint64_t)keys[i];
    cur_idx[i] = (uint64_t)i;
  }
  RadixBufs sorted = radix_pairs(cur_keys, cur_idx, nxt_keys, nxt_idx, n);
  std::memcpy(out_order, sorted.payload, (size_t)n * sizeof(int64_t));
}

// Hash join: out[i] = value of the table entry whose key equals query[i],
// or -1 when absent. Table keys must be unique and non-negative.
// Open addressing with linear probing at load factor <= 0.5; the slot
// array for a 131k-variant registry is ~4 MB (L2/L3-resident), so the
// 9M-query loop runs at ~1-2 probes per lookup.
void demux_hash_match_i64(const int64_t* table_keys, const int64_t* table_vals,
                          int64_t m, const int64_t* query, int64_t n,
                          int64_t* out) {
  uint64_t cap = 1;
  while (cap < (uint64_t)(m * 2 + 1)) cap <<= 1;
  const uint64_t mask = cap - 1;
  // key+1 so 0 marks an empty slot (keys are non-negative)
  auto slot_key_p = alloc_nohuge<uint64_t>(cap);
  auto slot_val_p = alloc_nohuge<int64_t>(cap);
  uint64_t* slot_key = slot_key_p.get();
  int64_t* slot_val = slot_val_p.get();
  std::memset(slot_key, 0, cap * sizeof(uint64_t));
  auto mix = [](uint64_t x) {
    x ^= x >> 33;
    x *= 0xff51afd7ed558ccdull;
    x ^= x >> 33;
    return x;
  };
  for (int64_t j = 0; j < m; j++) {
    uint64_t k = (uint64_t)table_keys[j] + 1;
    uint64_t h = mix(k) & mask;
    while (slot_key[h] != 0) h = (h + 1) & mask;
    slot_key[h] = k;
    slot_val[h] = table_vals[j];
  }
  for (int64_t i = 0; i < n; i++) {
    uint64_t k = (uint64_t)query[i] + 1;
    uint64_t h = mix(k) & mask;
    int64_t v = -1;
    while (slot_key[h] != 0) {
      if (slot_key[h] == k) {
        v = slot_val[h];
        break;
      }
      h = (h + 1) & mask;
    }
    out[i] = v;
  }
}

// Fused calls->variants join for match_calls_to_variants: key construction
// (pos*6 + base), hash lookup against the chromosome's variant registry,
// match compaction, and the per-call molecule-field gathers — one pass
// instead of five numpy array passes. Returns the number of matched calls.
// Threaded over call ranges (the probe loop is memory-latency bound on the
// table + molecule gathers): each thread emits into a per-range scratch
// slab at its range offset, then slabs are compacted to the final offsets
// in parallel — output stays in exact call order.
//
// The *_strided entry reads the call/molecule fields straight out of the
// packed numpy record buffers (SNP_CALL_DTYPE is 13-byte records): numpy's
// per-field strided extraction costs ~3.4 s at 22M calls because each of
// the six extractions re-reads the whole record buffer; unaligned in-place
// loads in the join loop read it once.
int64_t demux_match_compact_strided(
    const int64_t* table_keys, const int64_t* table_vids, int64_t m,
    const char* call_rec, int64_t call_stride,
    int64_t off_pos, int64_t off_base, int64_t off_pwrong, int64_t off_mol,
    const char* mol_rec, int64_t mol_stride, int64_t off_cb, int64_t off_mp,
    int64_t n_mol, int64_t n,
    int32_t* out_vid, int32_t* out_cb, int32_t* out_mol,
    float* out_p, float* out_pmol) {
  if (n <= 0) return 0;
  auto ld_i32 = [](const char* p) {
    int32_t v;
    std::memcpy(&v, p, 4);
    return v;
  };
  auto ld_f32 = [](const char* p) {
    float v;
    std::memcpy(&v, p, 4);
    return v;
  };
  uint64_t cap = 1;
  while (cap < (uint64_t)(m * 2 + 1)) cap <<= 1;
  const uint64_t mask = cap - 1;
  std::lock_guard<std::mutex> lock(g_arena_mu);
  g_arena.ensure(cap * 16 + (size_t)n * 20 + 512);
  uint64_t* slot_key = g_arena.take<uint64_t>(cap);
  int64_t* slot_val = g_arena.take<int64_t>(cap);
  int32_t* s_vid = g_arena.take<int32_t>(n);
  int32_t* s_cb = g_arena.take<int32_t>(n);
  int32_t* s_mol = g_arena.take<int32_t>(n);
  float* s_p = g_arena.take<float>(n);
  float* s_pmol = g_arena.take<float>(n);
  std::memset(slot_key, 0, cap * sizeof(uint64_t));
  auto mix = [](uint64_t x) {
    x ^= x >> 33;
    x *= 0xff51afd7ed558ccdull;
    x ^= x >> 33;
    return x;
  };
  for (int64_t j = 0; j < m; j++) {
    uint64_t k = (uint64_t)table_keys[j] + 1;
    uint64_t h = mix(k) & mask;
    while (slot_key[h] != 0) h = (h + 1) & mask;
    slot_key[h] = k;
    slot_val[h] = table_vids[j];
  }
  const int n_threads = pick_threads(n);
  const int64_t block = (n + n_threads - 1) / n_threads;
  std::vector<int64_t> matched(n_threads + 1, 0);
  // a molecule_index outside [0, n_mol) is a caller bug: report it (the
  // wrapper raises like the numpy path's IndexError) instead of an
  // unchecked strided read
  std::atomic<int> bad_index{0};
  run_threaded(n_threads, [&](int t) {
    const int64_t lo = t * block, hi = std::min<int64_t>(n, lo + block);
    int64_t out = lo;
    for (int64_t i = lo; i < hi; i++) {
      const char* cr = call_rec + i * call_stride;
      uint64_t k =
          (uint64_t)ld_i32(cr + off_pos) * 6 + (uint8_t)cr[off_base] + 1;
      uint64_t h = mix(k) & mask;
      while (slot_key[h] != 0) {
        if (slot_key[h] == k) {
          int32_t mi = ld_i32(cr + off_mol);
          if ((uint64_t)mi >= (uint64_t)n_mol) {
            bad_index.store(1, std::memory_order_relaxed);
            break;
          }
          const char* mr = mol_rec + (int64_t)mi * mol_stride;
          s_vid[out] = (int32_t)slot_val[h];
          s_cb[out] = ld_i32(mr + off_cb);
          s_mol[out] = mi;
          s_p[out] = ld_f32(cr + off_pwrong);
          s_pmol[out] = ld_f32(mr + off_mp);
          out++;
          break;
        }
        h = (h + 1) & mask;
      }
    }
    matched[t + 1] = out - lo;
  });
  if (bad_index.load(std::memory_order_relaxed)) return -1;
  for (int t = 0; t < n_threads; t++) matched[t + 1] += matched[t];
  run_threaded(n_threads, [&](int t) {
    const int64_t lo = t * block;
    const int64_t cnt = matched[t + 1] - matched[t];
    const int64_t dst = matched[t];
    std::memcpy(out_vid + dst, s_vid + lo, cnt * sizeof(int32_t));
    std::memcpy(out_cb + dst, s_cb + lo, cnt * sizeof(int32_t));
    std::memcpy(out_mol + dst, s_mol + lo, cnt * sizeof(int32_t));
    std::memcpy(out_p + dst, s_p + lo, cnt * sizeof(float));
    std::memcpy(out_pmol + dst, s_pmol + lo, cnt * sizeof(float));
  });
  return matched[n_threads];
}


// Collapse molecule calls to unique (variant, barcode) rows: the packing
// layer's hottest stage (ops/packing.py molecule_calls_to_barcode_calls),
// fused into one native pass — radix sort by (vid, cb), then one sweep
// emitting per-group vid/cb/snp, the float32 product of p over the group's
// members IN STABLE ORDER (bit-identical to numpy multiply.reduceat), and
// the member count. Returns the number of groups. Output arrays must hold
// n entries (upper bound).
int64_t demux_collapse_calls(const int32_t* vid, const int32_t* cb,
                             const int32_t* snp, const float* p, int64_t n,
                             int32_t* out_vid, int32_t* out_cb,
                             int32_t* out_snp, float* out_p,
                             int64_t* out_count) {
  if (n <= 0) return 0;
  std::lock_guard<std::mutex> lock(g_arena_mu);
  g_arena.ensure((size_t)n * 32 + 256);
  uint64_t* cur_keys = g_arena.take<uint64_t>(n);
  uint64_t* nxt_keys = g_arena.take<uint64_t>(n);
  uint64_t* cur_idx = g_arena.take<uint64_t>(n);
  uint64_t* nxt_idx = g_arena.take<uint64_t>(n);
  for (int64_t i = 0; i < n; i++) {
    cur_keys[i] = ((uint64_t)(uint32_t)vid[i] << 32) | (uint32_t)cb[i];
    cur_idx[i] = (uint64_t)i;
  }
  RadixBufs sorted = radix_pairs(cur_keys, cur_idx, nxt_keys, nxt_idx, n);
  const uint64_t* keys = sorted.keys;
  const uint64_t* idx = sorted.payload;

  // threaded emit: ranges aligned to group boundaries (a group never spans
  // two ranges, so per-group products keep their stable member order);
  // pass A counts each range's groups, pass B emits at prefix offsets
  const int n_threads = pick_threads(n);
  std::vector<int64_t> range_lo(n_threads + 1);
  range_lo[0] = 0;
  range_lo[n_threads] = n;
  const int64_t block = (n + n_threads - 1) / n_threads;
  for (int t = 1; t < n_threads; t++) {
    int64_t i = std::min<int64_t>(n, t * block);
    while (i < n && i > 0 && keys[i] == keys[i - 1]) i++;
    range_lo[t] = std::max(i, range_lo[t - 1]);
  }
  std::vector<int64_t> groups_at(n_threads + 1, 0);
  run_threaded(n_threads, [&](int t) {
    int64_t g = 0;
    for (int64_t i = range_lo[t]; i < range_lo[t + 1]; i++)
      if (i == range_lo[t] || keys[i] != keys[i - 1]) g++;
    groups_at[t + 1] = g;
  });
  for (int t = 0; t < n_threads; t++) groups_at[t + 1] += groups_at[t];
  run_threaded(n_threads, [&](int t) {
    int64_t g = groups_at[t] - 1;
    uint64_t prev = 0;
    for (int64_t i = range_lo[t]; i < range_lo[t + 1]; i++) {
      int64_t j = (int64_t)idx[i];
      uint64_t k = keys[i];
      if (i == range_lo[t] || k != prev) {
        g++;
        out_vid[g] = (int32_t)(k >> 32);
        out_cb[g] = (int32_t)(k & 0xffffffffu);
        out_snp[g] = snp[j];
        out_p[g] = p[j];
        out_count[g] = 1;
        prev = k;
      } else {
        out_p[g] *= p[j];  // float32 product in stable member order
        out_count[g]++;
      }
    }
  });
  return groups_at[n_threads];
}

// Device-order collapse for the SoA packing path: groups calls by
// (lut[vid], cb) — lut is the SNP-sorted variant renumbering
// (ops/packing.py VariantReindex.inverse) — and emits per-group
// (device_vid, cb, f32 product of p in stable member order, count),
// rows sorted by (device_vid, cb). Because the output is sorted by the
// DEVICE variant id, the M-step layout consumes it with no further sort,
// and the E-step layout needs exactly one key sort by cb. The p values
// ride through the radix passes as payload (no index array, no random
// emit gather): pure streaming passes.
int64_t demux_collapse_calls_keyed(const int32_t* vid, const int32_t* cb,
                                   const float* p, int64_t n,
                                   const int32_t* lut, int32_t cb_bits,
                                   int32_t* out_vid, int32_t* out_cb,
                                   float* out_p, int64_t* out_count) {
  if (n <= 0) return 0;
  std::lock_guard<std::mutex> lock(g_arena_mu);
  g_arena.ensure((size_t)n * 32 + 256);
  uint64_t* cur_keys = g_arena.take<uint64_t>(n);
  uint64_t* nxt_keys = g_arena.take<uint64_t>(n);
  uint64_t* cur_pay = g_arena.take<uint64_t>(n);
  uint64_t* nxt_pay = g_arena.take<uint64_t>(n);
  {
    const int n_threads = pick_threads(n);
    const int64_t block = (n + n_threads - 1) / n_threads;
    run_threaded(n_threads, [&](int t) {
      const int64_t lo = t * block, hi = std::min<int64_t>(n, lo + block);
      for (int64_t i = lo; i < hi; i++) {
        cur_keys[i] = ((uint64_t)(uint32_t)lut[vid[i]] << cb_bits) | (uint32_t)cb[i];
        uint32_t pbits;
        std::memcpy(&pbits, &p[i], 4);
        cur_pay[i] = pbits;
      }
    });
  }
  RadixBufs sorted = radix_pairs(cur_keys, cur_pay, nxt_keys, nxt_pay, n);
  const uint64_t* keys = sorted.keys;
  const uint64_t* pay = sorted.payload;

  const int n_threads = pick_threads(n);
  std::vector<int64_t> range_lo(n_threads + 1);
  range_lo[0] = 0;
  range_lo[n_threads] = n;
  const int64_t block = (n + n_threads - 1) / n_threads;
  for (int t = 1; t < n_threads; t++) {
    int64_t i = std::min<int64_t>(n, t * block);
    while (i < n && i > 0 && keys[i] == keys[i - 1]) i++;
    range_lo[t] = std::max(i, range_lo[t - 1]);
  }
  std::vector<int64_t> groups_at(n_threads + 1, 0);
  run_threaded(n_threads, [&](int t) {
    int64_t g = 0;
    for (int64_t i = range_lo[t]; i < range_lo[t + 1]; i++)
      if (i == range_lo[t] || keys[i] != keys[i - 1]) g++;
    groups_at[t + 1] = g;
  });
  for (int t = 0; t < n_threads; t++) groups_at[t + 1] += groups_at[t];
  const uint64_t cb_mask = ((uint64_t)1 << cb_bits) - 1;
  run_threaded(n_threads, [&](int t) {
    int64_t g = groups_at[t] - 1;
    uint64_t prev = 0;
    for (int64_t i = range_lo[t]; i < range_lo[t + 1]; i++) {
      uint64_t k = keys[i];
      uint32_t pbits = (uint32_t)pay[i];
      float pv;
      std::memcpy(&pv, &pbits, 4);
      if (i == range_lo[t] || k != prev) {
        g++;
        out_vid[g] = (int32_t)(k >> cb_bits);
        out_cb[g] = (int32_t)(k & cb_mask);
        out_p[g] = pv;
        out_count[g] = 1;
        prev = k;
      } else {
        out_p[g] *= pv;  // float32 product in stable member order
        out_count[g]++;
      }
    }
  });
  return groups_at[n_threads];
}

// Stable sort of the (cb, vid, q) call columns by cb — the E-step layout's
// barcode-major order — carrying (vid, q) through the radix passes as one
// u64 payload. Replaces argsort + 3-column gather with streaming passes.
void demux_sort_calls_by_cb(const int32_t* cb, const int32_t* vid,
                            const float* q, int64_t n,
                            int32_t* out_cb, int32_t* out_vid, float* out_q) {
  if (n <= 0) return;
  std::lock_guard<std::mutex> lock(g_arena_mu);
  g_arena.ensure((size_t)n * 32 + 256);
  uint64_t* cur_keys = g_arena.take<uint64_t>(n);
  uint64_t* nxt_keys = g_arena.take<uint64_t>(n);
  uint64_t* cur_pay = g_arena.take<uint64_t>(n);
  uint64_t* nxt_pay = g_arena.take<uint64_t>(n);
  {
    const int n_threads = pick_threads(n);
    const int64_t block = (n + n_threads - 1) / n_threads;
    run_threaded(n_threads, [&](int t) {
      const int64_t lo = t * block, hi = std::min<int64_t>(n, lo + block);
      for (int64_t i = lo; i < hi; i++) {
        cur_keys[i] = (uint32_t)cb[i];
        uint32_t qbits;
        std::memcpy(&qbits, &q[i], 4);
        cur_pay[i] = ((uint64_t)(uint32_t)vid[i] << 32) | qbits;
      }
    });
  }
  RadixBufs sorted = radix_pairs(cur_keys, cur_pay, nxt_keys, nxt_pay, n);
  const int n_threads = pick_threads(n);
  const int64_t block = (n + n_threads - 1) / n_threads;
  run_threaded(n_threads, [&](int t) {
    const int64_t lo = t * block, hi = std::min<int64_t>(n, lo + block);
    for (int64_t i = lo; i < hi; i++) {
      out_cb[i] = (int32_t)sorted.keys[i];
      uint64_t pl = sorted.payload[i];
      out_vid[i] = (int32_t)(pl >> 32);
      uint32_t qbits = (uint32_t)pl;
      std::memcpy(&out_q[i], &qbits, 4);
    }
  });
}

// Per-key group sums broadcast back to rows: out[i] = sum of w over all
// rows whose key equals keys[i]. One radix argsort + two sweeps — replaces
// the packing layer's second grouping (argsort + reduceat + cumsum-scatter
// chain) that fills the reference-parity barcode_snp_count column.
void demux_group_sum_broadcast(const int64_t* keys, const double* w,
                               int64_t n, double* out) {
  if (n <= 0) return;
  std::lock_guard<std::mutex> lock(g_arena_mu);
  g_arena.ensure((size_t)n * 32 + 256);
  uint64_t* cur_keys = g_arena.take<uint64_t>(n);
  uint64_t* nxt_keys = g_arena.take<uint64_t>(n);
  uint64_t* cur_idx = g_arena.take<uint64_t>(n);
  uint64_t* nxt_idx = g_arena.take<uint64_t>(n);
  for (int64_t i = 0; i < n; i++) {
    cur_keys[i] = (uint64_t)keys[i];
    cur_idx[i] = (uint64_t)i;
  }
  RadixBufs sorted = radix_pairs(cur_keys, cur_idx, nxt_keys, nxt_idx, n);
  const uint64_t* skeys = sorted.keys;
  const uint64_t* order = sorted.payload;
  int64_t run = 0;
  while (run < n) {
    int64_t end = run;
    const uint64_t k = skeys[run];
    double sum = 0.0;
    while (end < n && skeys[end] == k) sum += w[order[end++]];
    for (int64_t i = run; i < end; i++) out[order[i]] = sum;
    run = end;
  }
}

// Fused slot scatter for the tiled kernel layout
// (ops/tiling.py tile_barcode_calls): one pass over barcode-sorted calls
// computing each call's chunk/lane slot and writing vid/q/seg_group.
// b_offset[b] = slot offset of barcode b within its tile's call stream,
// chunk_start[t] = first chunk of tile t; outputs are pre-filled with the
// padding values (vid 0, q 1, seg 0) by the caller. Threaded over ranges
// split at barcode boundaries: slots of distinct barcodes are disjoint, so
// threads never write the same cell.
void demux_tile_scatter(const int32_t* cb, const int32_t* vid, const float* q,
                        int64_t n, const int64_t* b_offset,
                        const int64_t* chunk_start, int32_t tb, int32_t tc,
                        int32_t* out_vid, float* out_q, int32_t* out_seg) {
  if (n <= 0) return;
  const int32_t G = tc >= 128 ? tc / 128 : 1;
  const int32_t GPC = tc / G;
  const int n_threads = pick_threads(n);
  std::vector<int64_t> range_lo(n_threads + 1);
  range_lo[0] = 0;
  range_lo[n_threads] = n;
  const int64_t block = (n + n_threads - 1) / n_threads;
  for (int t = 1; t < n_threads; t++) {
    int64_t i = std::min<int64_t>(n, t * block);
    while (i < n && i > 0 && cb[i] == cb[i - 1]) i++;  // barcode boundary
    range_lo[t] = std::max(i, range_lo[t - 1]);
  }
  auto scatter_fn = [&](int t) {
    int64_t run_start = 0;
    int32_t prev_b = -1;
    for (int64_t i = range_lo[t]; i < range_lo[t + 1]; i++) {
      int32_t b = cb[i];
      if (b != prev_b) {
        run_start = i;
        prev_b = b;
      }
      int64_t s = b_offset[b] + (i - run_start);
      int64_t tile = b / tb;
      int64_t c = chunk_start[tile] + s / tc;
      int32_t iin = (int32_t)(s % tc);
      int32_t lane = (iin % G) * GPC + iin / G;
      out_vid[c * tc + lane] = vid[i];
      out_q[c * tc + lane] = q[i];
      out_seg[c * GPC + iin / G] = b - (int32_t)(tile * tb);
    }
  };
  run_threaded(n_threads, scatter_fn);
}

// Per-(band, barcode) call counts for the banded tiled layout
// (ops/tiling.py tile_barcode_calls_banded): out[band * nb + b] = number of
// calls of barcode b whose variant falls in band band_lut[vid]. One
// threaded pass — replaces the numpy searchsorted + per-band boolean
// selections. Threads own whole barcodes, so every (band, barcode) cell
// has exactly one writer. The caller zero-fills out.
void demux_band_counts(const int32_t* cb, const int32_t* vid, int64_t n,
                       const int32_t* band_lut, int64_t nb, int32_t n_bands,
                       int64_t* out) {
  if (n <= 0) return;
  const int n_threads = pick_threads(n);
  std::vector<int64_t> range_lo(n_threads + 1);
  range_lo[0] = 0;
  range_lo[n_threads] = n;
  const int64_t block = (n + n_threads - 1) / n_threads;
  for (int t = 1; t < n_threads; t++) {
    int64_t i = std::min<int64_t>(n, t * block);
    while (i < n && i > 0 && cb[i] == cb[i - 1]) i++;
    range_lo[t] = std::max(i, range_lo[t - 1]);
  }
  auto count_fn = [&](int t) {
    for (int64_t i = range_lo[t]; i < range_lo[t + 1]; i++)
      out[(int64_t)band_lut[vid[i]] * nb + cb[i]]++;
  };
  run_threaded(n_threads, count_fn);
}

// Fused banded slot scatter: the whole band-major tiled layout
// (ops/tiling.py tile_barcode_calls_banded) in ONE threaded pass over the
// barcode-sorted calls — replacing the per-band numpy pipeline (boolean
// select x3, per-band scatter, final concatenate) that dominated product-
// scale layout builds. Per call: band k = band_lut[vid], slot s =
// b_offset[k*nb + b] + rank-within-(band, barcode), chunk c =
// chunk_start[k*n_tiles + tile] + s/tc (chunk_start is GLOBAL, band-major),
// group lane layout as in demux_tile_scatter. out_vid receives BAND-LOCAL
// variant ids (vid - band_base[k]). Call order within a (band, barcode)
// group is preserved (ranks increase in input order), matching the
// stability of the numpy boolean-mask path bit for bit.
void demux_tile_scatter_banded(
    const int32_t* cb, const int32_t* vid, const float* q, int64_t n,
    const int32_t* band_lut, const int64_t* band_base, int32_t n_bands,
    const int64_t* b_offset, const int64_t* chunk_start, int64_t nb,
    int32_t n_tiles, int32_t tb, int32_t tc,
    int32_t* out_vid, float* out_q, int32_t* out_seg) {
  if (n <= 0) return;
  const int32_t G = tc >= 128 ? tc / 128 : 1;
  const int32_t GPC = tc / G;
  const int n_threads = pick_threads(n);
  std::vector<int64_t> range_lo(n_threads + 1);
  range_lo[0] = 0;
  range_lo[n_threads] = n;
  const int64_t block = (n + n_threads - 1) / n_threads;
  for (int t = 1; t < n_threads; t++) {
    int64_t i = std::min<int64_t>(n, t * block);
    while (i < n && i > 0 && cb[i] == cb[i - 1]) i++;
    range_lo[t] = std::max(i, range_lo[t - 1]);
  }
  auto scatter_fn = [&](int t) {
    std::vector<int64_t> rank(n_bands, 0);
    int32_t prev_b = -1;
    for (int64_t i = range_lo[t]; i < range_lo[t + 1]; i++) {
      int32_t b = cb[i];
      if (b != prev_b) {
        std::fill(rank.begin(), rank.end(), 0);
        prev_b = b;
      }
      int32_t k = band_lut[vid[i]];
      int64_t s = b_offset[(int64_t)k * nb + b] + rank[k]++;
      int64_t tile = b / tb;
      int64_t c = chunk_start[(int64_t)k * n_tiles + tile] + s / tc;
      int32_t iin = (int32_t)(s % tc);
      int32_t lane = (iin % G) * GPC + iin / G;
      out_vid[c * tc + lane] = vid[i] - (int32_t)band_base[k];
      out_q[c * tc + lane] = q[i];
      out_seg[c * GPC + iin / G] = b - (int32_t)(tile * tb);
    }
  };
  run_threaded(n_threads, scatter_fn);
}

// Threaded permutation gather of the three call columns by a sort order —
// the numpy fancy-index gathers (cb[order], vid[order], q[order]) cost
// ~0.4 s EACH at 22M calls; one fused threaded pass does all three.
void demux_gather3(const int64_t* order, int64_t n, const int32_t* a,
                   const int32_t* b, const float* c, int32_t* out_a,
                   int32_t* out_b, float* out_c) {
  if (n <= 0) return;
  const int n_threads = pick_threads(n);
  const int64_t block = (n + n_threads - 1) / n_threads;
  auto gather_fn = [&](int t) {
    const int64_t lo = t * block, hi = std::min<int64_t>(n, lo + block);
    for (int64_t i = lo; i < hi; i++) {
      const int64_t j = order[i];
      out_a[i] = a[j];
      out_b[i] = b[j];
      out_c[i] = c[j];
    }
  };
  run_threaded(n_threads, gather_fn);
}

}  // extern "C"
