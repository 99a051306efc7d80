// The aggregate-on-SNPs E-step with the row softmax fused, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves this op to XLA
// (demuxalot_tpu/ops/likelihood.py:258 snp_aggregated_logits; reference
// demuxalot/demux.py:193-244). It exists because the plain torch chain was the
// aggregate path's critical path on the H100 (8.1 ms of a 10.8 ms EM iteration
// at 32 columns, 83.8 ms and a 19.5 GB peak for predict at 528; PERF.md). For
// barcode b and column g, with a group being the molecule calls of one
// (barcode, SNP):
//
//   x[grp, g] = (sum_{calls c of grp} log(p[c, g] + q_c)) / max(n_grp, 1)^compensation
//   p[c, g]   = 0.5 * (G[vid_c, i_g] + G[vid_c, j_g])           (i_g == j_g for a singlet)
//   y         = log_softmax(x[grp, :])
//   z         = log_softmax(logaddexp(y, log(escape)))           escape = p_bad_snp / n_pg
//   logits[b] = sum_{groups of b} z[grp, :]                      (+ prior[b]; probs = softmax, when given)
//
// No doublet penalty is added (the reference computes but never adds them on
// this path); a barcode with no group gets a row of zeros (+ prior).
//
// The algebra it runs: sum_k e^{y_k} = 1, so the second log-softmax's
// normaliser is log(1 + n_pg * escape) (log_norm, from the host), and
//   z_g = log(e^{x_g - m} / S + escape) - log_norm,   S = sum_k e^{x_k - m},
// with the first log-softmax's own exponentials. A group of one call c (nine
// groups in ten in a pool of 1.2 molecules a group) has scale 1 and
// e^{x_g - m} / S = t_g / T exactly, t_g = p[c, g] + q_c, T = sum_k t_k, so it
// is closed in the probability domain:
//   z_g = log(t_g * (1 / T) + escape) - log_norm,
// with no log of its term, no max and no exp; t_g lies in [q, 1 + q], so T
// neither overflows nor loses the row. A group of two calls or more takes the
// log domain: one log per (call, column), then one exp and one log per
// (group, column). The call terms of such a group are not multiplied before a
// log as the main E-step's are: p + q has no floor here (p is 0 in an
// unclipped table, q goes down to 1e-7), so a product of 8 could underflow. x
// is kept in log2 units (lg2 of each call term, ex2 of x - m) and scaled by
// ln 2 once, in z.
//
// What bounds it on the H100: the MUFU unit, (calls in groups of two or more
// + 2 x such groups + groups of one) x columns operations
// (utils/profiling.py: AggregateRoofline counts (calls + 2 x groups) x
// columns, the log domain for every group); its bytes (the calls' ids and q,
// the pointers, G, the rows written) take a fraction of that time. What held
// the first design (one warp a group, one column a lane at narrow rows) was
// not the MUFU unit but each group's chain of dependent steps: the group's
// bounds, q and two 5-step shuffle reductions, all for 3 MUFU operations a
// lane. With teams, groups of 8 calls take nearly as long as groups of one
// at 32 columns: what is left at narrow rows rides mostly on each call (its
// G row, n_donors floats gathered from L2 whatever the width, and its
// terms), not on a group's reductions (PERF.md). The design, by width (the
// host's plan, ops/aggregate_kernel.py: aggregate_plan, picks the
// instantiation):
// - Every warp walks its barcode's calls in tiles of 32, in call order: the
//   next tile's G rows are gathered into a double-buffered ring in shared
//   memory with cp.async while this tile is computed (as in likelihood.cu's
//   main path), the ids and q of the tile after that already in registers. A
//   call term is one FADD and one FFMA, 0.5 * (G_i + G_j) + q: the bits of the
//   plain path's f32 product with a 0 / 0.5 / 1 mixing matrix (no tensor
//   cores: TF32 would shift the posteriors), then one lg2 in a group of two
//   calls or more. Columns live in registers with their donor pairs (both
//   byte offsets into a G row in one register; a team's lanes, with room,
//   keep two indices), read once a warp. A group's call count (from group_ptr) picks its domain,
//   warp-uniform (block-uniform on the split row; a round's, below).
// - Narrow rows (kTeam < 32, up to 256 columns; the aggregate EM's width): a
//   team of kTeam lanes works one group, so a warp has 32 / kTeam groups in
//   flight; lane l of a team holds columns k * kTeam + l, k < kCols. A warp
//   reads the pointers of 32 groups at once (one group a lane, with its
//   1 / n^compensation); in a round, team t takes the window's group r + t,
//   its bounds and scale by one shuffle each that serves every team. The
//   round's calls are contiguous: the warp steps through the part of each
//   ring tile that they cover, every team adding the terms of its own calls
//   there. The round's domains are warp-uniform: with no group of one the
//   log domain alone (a pool of longer groups runs the teams' log path
//   unchanged); with only groups of one the probability domain alone, no
//   lg2 of a term, no max and no exp; with both, every call's lg2 is taken
//   (the log-domain teams set the warp's pace) and a team of one keeps its
//   term. A group's max takes
//   log2(kTeam) xor shuffles inside the team, one instruction for every
//   team; its sum (S or T) the first design's order (below), its
//   reciprocal one correctly rounded (as 1.f / S) that serves every team.
//   The teams then write the round's z rows to the warp's shared memory
//   and the barcode's running row, held as in the first design (lane l:
//   columns j * 32 + l), adds them in group order. The ring's rows and the
//   teams' rows are padded so that teams reading or writing the same
//   column of different rows hit different banks.
// - Up to 544 columns (kTeam = 32): one warp a group, kCols a lane, column
//   k * 32 + lane: the first design, unchanged (its bits and time).
// - Wide rows (kTeam = 0, past 544 columns): the barcode's columns split over
//   the warps of a block, kCols a lane each (column w * 32 * kCols + k * 32 +
//   lane), the block's warps sharing one ring; a group's max and sum are the
//   warps' own, combined in warp order through shared memory at a block
//   barrier each (a group of one: its sum alone, one barrier). The running
//   row stays in registers until the barcode ends.
// - Past 16 such warps (over 8,704 columns, 132 donors with doublets) the
//   group's row sits in the warp's shared memory and the barcode's running row
//   in its own logits row (kTeam = 32, kCols = 0), one warp a barcode.
// Logits and probs are written once a barcode. Nothing of size [groups,
// columns] or [calls, columns] exists in device memory. The indices are
// checked once per dataset (demux_aggregate_check, when the operands are
// built), so a launch checks nothing; what a launch asks the card (its SMs,
// the shared-memory attribute, the occupancy) is asked once and kept.
//
// Sum order, fixed by the layout and the instantiation, never by the grid or
// by timing (no atomics; two runs give the same bits):
// - x: a group's call terms in call order, one column at a time.
// - S (T for a group of one, 0 past the row): lane l of the warp sums its
//   columns K * 32 + l in K order, then xor butterflies with offsets 16, ...,
//   1. A team lane stands for 32 / kTeam of those lanes: it adds their
//   registers in that order, and the offsets of kTeam and up between its
//   registers before the team's shuffles. At kTeam = 0, each warp's sum so,
//   then the warps' sums in warp order.
// - logits: every group of the barcode in group order, from zero, lane l
//   holding columns j * 32 + l (kTeam = 0: the warp's own columns).
// - probs: a lane's columns in j order, then the butterflies (kTeam = 0: the
//   warps in warp order).
// So every instantiation up to 544 columns gives the same bits, the first
// design's; the split row past 544 its own.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "checks.cuh"
#include "common.cuh"
#include "launch.cuh"

namespace {

using demux::kFullMask;
using demux::kWarpSize;

constexpr int kTileCalls = 32;           // calls per ring slot
constexpr int kWindow = kWarpSize - 1;   // groups per window of 32 group pointers (kTeam = 32, 0)
constexpr int kWarpsPerBlock = 4;
constexpr int kMaxRegisterCols = 17;     // columns a lane in registers: 544 a warp
constexpr int kMaxSplitWarps = 16;       // warps a block on one barcode's columns: 128 registers a thread
constexpr float kLn2 = 0.693147180559945309f;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// log2 of a call term on the MUFU unit; subnormal arguments too (p + q has no floor)
__device__ __forceinline__ float lg2(float x) {
    float y;
    asm("lg2.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// log2 of an argument >= escape, a normal float
__device__ __forceinline__ float lg2_normal(float x) {
    float y;
    asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// 2^x on the MUFU unit, x <= 0; results below 2^-126 flush to 0 (they add
// nothing beside escape)
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// butterflies over aligned teams of kLanes lanes: every lane of a team ends with the same bits (a + b == b + a)
template <int kLanes>
__device__ __forceinline__ float team_max(float v) {
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
    return v;
}

template <int kLanes>
__device__ __forceinline__ float team_sum(float v) {
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
    return v;
}

__device__ __forceinline__ float warp_max(float v) { return team_max<kWarpSize>(v); }
__device__ __forceinline__ float warp_sum(float v) { return team_sum<kWarpSize>(v); }

// The calls of one barcode, [start of its first tile, end), asked for in
// order, in tiles of 32: the current tile's G rows in one slot of the ring,
// the next tile's in flight into the other, the ids and q of the one after
// that in registers. kChunk: floats per cp.async (4 when G's rows are 16-byte
// aligned). kBlock: the block's warps share the ring (each holding the same
// ids and q), else it is the warp's own. kRolled: the gather's loop is not
// unrolled (the group walk's: unrolled, its temporaries crowd the walk's
// registers, and ptxas spilled at 128; the teams' walk, with room, unrolls it).
template <int kChunk, bool kBlock = false, bool kRolled = false>
struct CallTiles {
    const float* G;
    const int32_t* vid;
    const float* q;
    float* ring;  // [2][kTileCalls][stride]
    int n_donors, stride, lane;
    int64_t start = 0, end = 0;  // the current tile's first call, the barcode's end
    int cur = 0;
    float q_cur = 1.f, q_next = 1.f, q_ahead = 1.f;
    int v_ahead = 0;

    __device__ CallTiles(const float* G_, const int32_t* vid_, const float* q_, float* ring_, int n_donors_,
                         int stride_, int lane_)
        : G(G_), vid(vid_), q(q_), ring(ring_), n_donors(n_donors_), stride(stride_), lane(lane_) {}

    __device__ void sync() const {
        if constexpr (kBlock) {
            __syncthreads();
        } else {
            __syncwarp();
        }
    }

    // call t + lane's id and q (0 and 1 past the end)
    __device__ void load(int64_t t, int& v, float& qq) const {
        const int64_t c = t + lane;
        v = c < end ? vid[c] : 0;
        qq = c < end ? q[c] : 1.f;
    }

    // the G rows of calls [t, min(t + 32, end)) into buf, one commit group
    __device__ void gather(int64_t t, int v, float* buf) const {
        const int64_t left = end - t;
        const int n = left <= 0 ? 0 : (left < kTileCalls ? (int)left : kTileCalls);
        const int row_chunks = n_donors / kChunk;
        const int total = n * row_chunks;
        const int first = kBlock ? (int)threadIdx.x : lane;
        const int step = kBlock ? (int)blockDim.x : kWarpSize;
        if constexpr (kRolled) {
#pragma unroll 1
            for (int i0 = 0; i0 < total; i0 += step) copy(buf, v, i0 + first, total, row_chunks);
        } else {
            for (int i0 = 0; i0 < total; i0 += step) copy(buf, v, i0 + first, total, row_chunks);
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    }

    // chunk i of the tile's rows (row i / row_chunks, the lanes' ids in v), when i < total
    __device__ __forceinline__ void copy(float* buf, int v, int i, int total, int row_chunks) const {
        const int r = i / row_chunks;
        const int vr = __shfl_sync(kFullMask, v, r & (kWarpSize - 1));
        if (i < total) {
            const int k = (i - r * row_chunks) * kChunk;
            demux::cp_async<4 * kChunk>(buf + r * stride + k, G + (int64_t)vr * n_donors + k);
        }
    }

    __device__ void begin(int64_t lo, int64_t hi) {
        start = lo;
        end = hi;
        cur = 0;
        int v0, v1;
        load(lo, v0, q_cur);
        load(lo + kTileCalls, v1, q_next);
        load(lo + 2 * kTileCalls, v_ahead, q_ahead);
        sync();  // every thread is done with the ring
        gather(lo, v0, ring);
        gather(lo + kTileCalls, v1, ring + kTileCalls * stride);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        sync();  // the first tile landed
    }

    __device__ void advance() {
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        sync();  // the next tile landed; every thread is done with this one
        start += kTileCalls;
        cur ^= 1;
        q_cur = q_next;
        gather(start + kTileCalls, v_ahead, ring + (cur ^ 1) * kTileCalls * stride);
        q_next = q_ahead;
        load(start + 2 * kTileCalls, v_ahead, q_ahead);
    }

    // row r of the current tile
    __device__ const float* slot(int r) const { return ring + (cur * kTileCalls + r) * stride; }

    // call c's G row in shared memory and its q; c is the call after the last one asked for
    __device__ const float* row(int64_t c, float& qc) {
        if (c >= start + kTileCalls) advance();
        const int r = (int)(c - start);
        qc = __shfl_sync(kFullMask, q_cur, r);
        return slot(r);
    }
};

// column g's donor pair as byte offsets into a G row, i in the low 16 bits and j in the high (a ring row, in shared
// memory, holds under 1,000 donors), 0 past the row
__device__ __forceinline__ int pair_bytes(const int32_t* pairs, int n_pg, int g) {
    return g < n_pg ? 4 * pairs[g] | 4 * pairs[n_pg + g] << 16 : 0;
}

// one call's term for a column: ½(row[i] + row[j]) + q
__device__ __forceinline__ float call_term(const float* row, int pair, float qc) {
    const char* r = reinterpret_cast<const char*>(row);
    const float gi = *reinterpret_cast<const float*>(r + (pair & 0xffff));
    const float gj = *reinterpret_cast<const float*>(r + ((unsigned)pair >> 16));
    return fmaf(gi + gj, 0.5f, qc);
}

// one call's terms, added to a lane's columns: x[k] += log2(½(row[i_k] + row[j_k]) + q)
template <int kCols>
__device__ __forceinline__ void add_terms(float (&x)[kCols], const int (&pair)[kCols], const float* row, float qc) {
#pragma unroll
    for (int k = 0; k < kCols; ++k) x[k] += lg2(call_term(row, pair[k], qc));
}

// the terms of a group's one call: x[k] = ½(row[i_k] + row[j_k]) + q, past the row too (its offsets are 0)
template <int kCols>
__device__ __forceinline__ void add_single(float (&x)[kCols], const int (&pair)[kCols], const float* row, float qc) {
#pragma unroll
    for (int k = 0; k < kCols; ++k) x[k] = call_term(row, pair[k], qc);
}

// The barcode's row in the first design's layout, lane l holding columns k * 32 + l (+ prior) → logits and, when
// probs is given, its softmax; every pointer is at the barcode's row.
template <int kCols>
__device__ __forceinline__ void finish_row(float (&acc)[kCols], int lane, int n_pg, const float* prior, float* logits,
                                           float* probs) {
    float m = neg_inf();
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
        const int g = k * kWarpSize + lane;
        if (g >= n_pg) continue;
        if (prior != nullptr) acc[k] += prior[g];
        logits[g] = acc[k];
        m = fmaxf(m, acc[k]);
    }
    if (probs == nullptr) return;
    m = warp_max(m);
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
        acc[k] = k * kWarpSize + lane < n_pg ? expf(acc[k] - m) : 0.f;
        s += acc[k];
    }
    const float inv = 1.f / warp_sum(s);
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
        if (k * kWarpSize + lane < n_pg) probs[k * kWarpSize + lane] = acc[k] * inv;
    }
}

// kTeam = 32: up to 32 * kCols columns in registers, one warp a group: lane l holds columns k * 32 + l.
template <int kCols>
struct RegisterColumns {
    float x[kCols], acc[kCols];
    int pair[kCols];  // the columns' donor pairs (pair_bytes)
    int lane, n_pg;
    bool one = false;  // the group holds one call: x holds its terms, in the probability domain

    __device__ RegisterColumns(const int32_t* pairs, int n_pg_, int lane_, float*) : lane(lane_), n_pg(n_pg_) {
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
            pair[k] = pair_bytes(pairs, n_pg, k * kWarpSize + lane);
        }
    }

    // as k * 32 + lane < n_pg, against the columns left past the lane, so that ptxas keeps no mask of the valid
    // registers (which it spilled at 128 registers)
    __device__ bool valid(int k) const { return k * kWarpSize < n_pg - lane; }

    __device__ void start_barcode(float*) {
#pragma unroll
        for (int k = 0; k < kCols; ++k) acc[k] = 0.f;
    }

    __device__ void start_group(bool one_call) {
        one = one_call;
        if (one) return;
#pragma unroll
        for (int k = 0; k < kCols; ++k) x[k] = 0.f;
    }

    __device__ void add_call(const float* row, float qc) {
        if (one) {
            add_single(x, pair, row, qc);
        } else {
            add_terms(x, pair, row, qc);
        }
    }

    // e (a group of one's terms t, 0 past the row; else 2^(x · 1 / n^compensation − max), x in log2 units) → z,
    // added to the barcode's row
    __device__ void close_group(float scale, float escape, float log_norm) {
        if (one) {
#pragma unroll
            for (int k = 0; k < kCols; ++k) x[k] = valid(k) ? x[k] : 0.f;
        } else {
            float m = neg_inf();
#pragma unroll
            for (int k = 0; k < kCols; ++k) {
                x[k] = valid(k) ? x[k] * scale : neg_inf();
                m = fmaxf(m, x[k]);
            }
            m = warp_max(m);
#pragma unroll
            for (int k = 0; k < kCols; ++k) x[k] = ex2(x[k] - m);
        }
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < kCols; ++k) s += x[k];
        const float inv = 1.f / warp_sum(s);  // 1 / S, or 1 / T for a group of one
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
            acc[k] += fmaf(lg2_normal(fmaf(x[k], inv, escape)), kLn2, -log_norm);
        }
    }

    // the row (+ prior) → logits and, when probs is given, its softmax; every pointer is at the barcode's row
    __device__ void finish(const float* prior, float* logits, float* probs) {
        finish_row(acc, lane, n_pg, prior, logits, probs);
    }
};

// floats a row of the round's group rows (TeamColumns::rows): at least kTeam * kCols, kTeam mod 32, so that the
// 32 lanes storing one register of their team's row hit 32 banks
__host__ __device__ constexpr int team_row(int team, int cols) {
    int row = team * cols;
    while (row % kWarpSize != team % kWarpSize) ++row;
    return row;
}

// a round's domains (TeamColumns, team_walk): every team in the log domain, every active team's group of one call,
// or both kinds, each team its own
enum Domains { kLogDomain, kProbDomain, kMixedDomains };

// kTeam < 32: a team of kTeam lanes a group, 32 / kTeam teams a warp; lane l of team t holds columns k * kTeam + l
// of its group. Each round the teams' rows go through the warp's shared memory (rows: [32 / kTeam][kRow]) to the
// barcode's running row, which sits in the first design's layout (lane l: columns j * 32 + l, j < kOwn) and takes
// them in group order. A group's S (T for a group of one) is taken in the first design's order too (lane l of the
// warp: its columns K * 32 + l in K order, then xor butterflies 16, ..., 1; the offsets of kTeam and up between a
// lane's registers), so every width gives the first design's bits. The round's domains are warp-uniform (kD):
// a round with no group of one runs the log domain alone, one whose active teams all hold groups of one the
// probability domain alone; a round of both kinds takes each call's lg2 and keeps it only in a log-domain team.
template <int kTeam, int kCols>
struct TeamColumns {
    static constexpr int kTeams = kWarpSize / kTeam;
    static constexpr int kLo = kTeams < kCols ? kTeams : kCols;  // the first design's lanes a lane of a team stands for
    static constexpr int kOwn = (kTeam * kCols + kWarpSize - 1) / kWarpSize;
    static constexpr int kRow = team_row(kTeam, kCols);
    float x[kCols], acc[kOwn];
    int oi[kCols], oj[kCols];  // the columns' donor pairs as indices into a G row (0 past the row)
    int lane, sub, team, n_pg;
    float* rows;

    __device__ TeamColumns(const int32_t* pairs, int n_pg_, int lane_, float* rows_)
        : lane(lane_), sub(lane_ % kTeam), team(lane_ / kTeam), n_pg(n_pg_), rows(rows_) {
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
            const int g = k * kTeam + sub;
            oi[k] = g < n_pg ? pairs[g] : 0;
            oj[k] = g < n_pg ? pairs[n_pg + g] : 0;
        }
    }

    __device__ bool valid(int k) const { return k * kTeam + sub < n_pg; }

    __device__ void start_barcode() {
#pragma unroll
        for (int j = 0; j < kOwn; ++j) acc[j] = 0.f;
    }

    __device__ void start_group() {
#pragma unroll
        for (int k = 0; k < kCols; ++k) x[k] = 0.f;
    }

    // one call's terms t: x += lg2(t) in the log domain, x = t (from 0) for a group of one; kMixedDomains: one
    // says which
    template <int kD>
    __device__ void add_call(const float* row, float qc, bool one) {
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
            const float t = fmaf(row[oi[k]] + row[oj[k]], 0.5f, qc);
            if constexpr (kD == kLogDomain) {
                x[k] += lg2(t);
            } else if constexpr (kD == kProbDomain) {
                x[k] = t;
            } else {
                x[k] += one ? t : lg2(t);
            }
        }
    }

    // each team's e (a log-domain group's 2^(x · 1 / n^compensation − max), x in log2 units; a group of one's terms)
    // → z; the rows of the round's first n_active teams (its groups, in group order) added to the barcode's row
    template <int kD>
    __device__ void close_round(float scale, float escape, float log_norm, int n_active, bool one) {
        if constexpr (kD == kProbDomain) {
#pragma unroll
            for (int k = 0; k < kCols; ++k) x[k] = valid(k) ? x[k] : 0.f;
        } else {
            float m = neg_inf();
#pragma unroll
            for (int k = 0; k < kCols; ++k) {
                if (kD == kLogDomain || !one) x[k] = valid(k) ? x[k] * scale : neg_inf();
                m = fmaxf(m, x[k]);
            }
            m = team_max<kTeam>(m);
#pragma unroll
            for (int k = 0; k < kCols; ++k) {
                x[k] = kD == kLogDomain || !one ? ex2(x[k] - m) : (valid(k) ? x[k] : 0.f);
            }
        }
        // register k holds the first design's lane (k % kTeams) * kTeam + sub, its column k / kTeams
        float p[kLo];
#pragma unroll
        for (int lo = 0; lo < kLo; ++lo) {
            p[lo] = x[lo];
#pragma unroll
            for (int k = lo + kTeams; k < kCols; k += kTeams) p[lo] += x[k];
        }
#pragma unroll
        for (int h = kTeams / 2; h > 0; h >>= 1) {
#pragma unroll
            for (int lo = 0; lo < h; ++lo) {
                if (lo + h < kLo) p[lo] += p[lo + h];
            }
        }
        const float inv = __frcp_rn(team_sum<kTeam>(p[0]));  // 1 / S (or T) correctly rounded, as 1.f / S
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
            rows[team * kRow + k * kTeam + sub] = fmaf(lg2_normal(fmaf(x[k], inv, escape)), kLn2, -log_norm);
        }
        __syncwarp();
        for (int t = 0; t < n_active; ++t) {
#pragma unroll
            for (int j = 0; j < kOwn; ++j) acc[j] += rows[t * kRow + j * kWarpSize + lane];
        }
        __syncwarp();  // every lane has read the rows before the next round writes them
    }

    __device__ void finish(const float* prior, float* logits, float* probs) {
        finish_row(acc, lane, n_pg, prior, logits, probs);
    }
};

// kTeam = 0: the barcode's columns split over the block's warps, kCols a lane: warp w's lane l holds columns
// w * 32 * kCols + k * 32 + l. A group's max and sum are each warp's, combined in warp order through shared
// memory (red: the warps' maxima, then two slots of their sums) at a block barrier.
template <int kCols>
struct SplitColumns {
    float x[kCols], acc[kCols];
    int pair[kCols];
    int lane, warp, first, n_pg;
    int parity = 0;    // the sums' slot for the next block_sum
    bool one = false;  // the group holds one call: x holds its terms, in the probability domain
    float* red;        // [3][kMaxSplitWarps]

    __device__ SplitColumns(const int32_t* pairs, int n_pg_, int lane_, float* red_)
        : lane(lane_), warp((int)threadIdx.x / kWarpSize), first(warp * kWarpSize * kCols), n_pg(n_pg_), red(red_) {
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
            pair[k] = pair_bytes(pairs, n_pg, first + k * kWarpSize + lane);
        }
    }

    __device__ bool valid(int k) const { return first + k * kWarpSize + lane < n_pg; }

    // The block's max and sum of one value a thread, every thread calling them in the same order. A max is
    // followed by a sum (a log-domain group, the softmax), sums may follow each other (groups of one). A warp
    // writes a max only after the barrier of the sum that followed the last max, which every warp reaches after
    // reading that max, so one slot suffices. The sums alternate between two slots: a warp writes a slot only
    // after the barrier of the sum between, which every warp reaches after reading that slot.
    __device__ float block_max(float v) {
        v = warp_max(v);
        if (lane == 0) red[warp] = v;
        __syncthreads();
        float m = red[0];
        for (int w = 1; w < (int)(blockDim.x / kWarpSize); ++w) m = fmaxf(m, red[w]);
        return m;
    }

    __device__ float block_sum(float v) {
        v = warp_sum(v);
        float* sums = red + (1 + parity) * kMaxSplitWarps;
        parity ^= 1;
        if (lane == 0) sums[warp] = v;
        __syncthreads();
        float s = sums[0];
        for (int w = 1; w < (int)(blockDim.x / kWarpSize); ++w) s += sums[w];
        return s;
    }

    __device__ void start_barcode(float*) {
#pragma unroll
        for (int k = 0; k < kCols; ++k) acc[k] = 0.f;
    }

    __device__ void start_group(bool one_call) {
        one = one_call;
        if (one) return;
#pragma unroll
        for (int k = 0; k < kCols; ++k) x[k] = 0.f;
    }

    __device__ void add_call(const float* row, float qc) {
        if (one) {
            add_single(x, pair, row, qc);
        } else {
            add_terms(x, pair, row, qc);
        }
    }

    // as RegisterColumns::close_group, the max and the sum across the block's warps: a group of one takes the
    // sum's barrier alone
    __device__ void close_group(float scale, float escape, float log_norm) {
        if (one) {
#pragma unroll
            for (int k = 0; k < kCols; ++k) x[k] = valid(k) ? x[k] : 0.f;
        } else {
            float m = neg_inf();
#pragma unroll
            for (int k = 0; k < kCols; ++k) {
                x[k] = valid(k) ? x[k] * scale : neg_inf();
                m = fmaxf(m, x[k]);
            }
            m = block_max(m);
#pragma unroll
            for (int k = 0; k < kCols; ++k) x[k] = ex2(x[k] - m);
        }
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < kCols; ++k) s += x[k];
        const float inv = 1.f / block_sum(s);
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
            acc[k] += fmaf(lg2_normal(fmaf(x[k], inv, escape)), kLn2, -log_norm);
        }
    }

    __device__ void finish(const float* prior, float* logits, float* probs) {
        float m = neg_inf();
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
            if (!valid(k)) continue;
            const int g = first + k * kWarpSize + lane;
            if (prior != nullptr) acc[k] += prior[g];
            logits[g] = acc[k];
            m = fmaxf(m, acc[k]);
        }
        if (probs == nullptr) return;
        m = block_max(m);
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
            acc[k] = valid(k) ? expf(acc[k] - m) : 0.f;
            s += acc[k];
        }
        const float inv = 1.f / block_sum(s);
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
            if (valid(k)) probs[first + k * kWarpSize + lane] = acc[k] * inv;
        }
    }
};

// Any number of columns: the group's row in the warp's shared memory (x, n_pg
// floats), the barcode's running row in its logits row. Column g is always
// lane g % 32's, so no lane reads another's entries.
struct SharedColumns {
    const int32_t* pairs;
    int n_pg, lane;
    bool one = false;  // the group holds one call: x holds its terms, in the probability domain
    float* x;
    float* out = nullptr;

    __device__ SharedColumns(const int32_t* pairs_, int n_pg_, int lane_, float* x_)
        : pairs(pairs_), n_pg(n_pg_), lane(lane_), x(x_) {}

    __device__ void start_barcode(float* logits_row) {
        out = logits_row;
        for (int g = lane; g < n_pg; g += kWarpSize) out[g] = 0.f;
    }

    __device__ void start_group(bool one_call) {
        one = one_call;
        if (one) return;
        for (int g = lane; g < n_pg; g += kWarpSize) x[g] = 0.f;
    }

    __device__ void add_call(const float* row, float qc) {
        if (one) {
            for (int g = lane; g < n_pg; g += kWarpSize) x[g] = fmaf(row[pairs[g]] + row[pairs[n_pg + g]], 0.5f, qc);
        } else {
            for (int g = lane; g < n_pg; g += kWarpSize) {
                x[g] += lg2(fmaf(row[pairs[g]] + row[pairs[n_pg + g]], 0.5f, qc));
            }
        }
    }

    // as RegisterColumns::close_group, over the shared row
    __device__ void close_group(float scale, float escape, float log_norm) {
        if (!one) {
            float m = neg_inf();
            for (int g = lane; g < n_pg; g += kWarpSize) {
                x[g] *= scale;
                m = fmaxf(m, x[g]);
            }
            m = warp_max(m);
            for (int g = lane; g < n_pg; g += kWarpSize) x[g] = ex2(x[g] - m);
        }
        float s = 0.f;
        for (int g = lane; g < n_pg; g += kWarpSize) s += x[g];
        const float inv = 1.f / warp_sum(s);
        for (int g = lane; g < n_pg; g += kWarpSize) {
            out[g] += fmaf(lg2_normal(fmaf(x[g], inv, escape)), kLn2, -log_norm);
        }
    }

    __device__ void finish(const float* prior, float* logits, float* probs) {
        float m = neg_inf();
        for (int g = lane; g < n_pg; g += kWarpSize) {
            if (prior != nullptr) logits[g] += prior[g];
            m = fmaxf(m, logits[g]);
        }
        if (probs == nullptr) return;
        m = warp_max(m);
        float s = 0.f;
        for (int g = lane; g < n_pg; g += kWarpSize) {
            x[g] = expf(logits[g] - m);
            s += x[g];
        }
        const float inv = 1.f / warp_sum(s);
        for (int g = lane; g < n_pg; g += kWarpSize) probs[g] = x[g] * inv;
    }
};

template <int kTeam, int kCols>
struct ColumnsOf {
    using type = RegisterColumns<kCols>;
};
template <>
struct ColumnsOf<32, 0> {
    using type = SharedColumns;
};
template <int kCols>
struct ColumnsOf<0, kCols> {
    using type = SplitColumns<kCols>;
};

struct Args {
    const float* genotype_prob;  // [n_variants, n_donors]
    int n_donors, stride;        // stride: the ring's floats a row (n_donors rounded up to 4, padded: ring_stride)
    const int32_t* vid;          // [n_calls], sorted by group
    const float* q;              // [n_calls]
    const int64_t* group_ptr;    // [n_groups + 1] first call of every group
    const int64_t* barcode_ptr;  // [n_barcodes + 1] first group of every barcode
    int64_t n_barcodes;
    const int32_t* pairs;        // [2, n_pg] every column's donor pair
    int n_pg, x_floats;          // x_floats: the shared row's floats (kTeam = 32, kCols = 0), else 0
    float compensation, escape, log_norm;
    const float* prior;          // [n_barcodes, n_pg] or null
    float* logits;               // [n_barcodes, n_pg]
    float* probs;                // [n_barcodes, n_pg] or null
};

// One ring tile's part of a team_walk round in domains kD: each team's calls there, mine of them from the tile's
// row row0, one step a call for the warp (steps: the most a team has).
template <int kD, int kTeam, int kCols, int kChunk>
__device__ __forceinline__ void team_steps(TeamColumns<kTeam, kCols>& cols, const CallTiles<kChunk>& tiles, int row0,
                                           int mine, int steps, bool one) {
    for (int s = 0; s < steps; ++s) {
        const int r = row0 + s;
        const float qc = __shfl_sync(kFullMask, tiles.q_cur, r & (kWarpSize - 1));
        if (s < mine) cols.template add_call<kD>(tiles.slot(r), qc, one);
    }
}

// kTeam < 32: teams of kTeam lanes, one warp a barcode (warps persistent over a static stride of barcodes).
template <int kTeam, int kCols, int kChunk>
__device__ __forceinline__ void team_walk(const Args& a, float* ring, float* rows, int lane, int warp) {
    constexpr int kTeams = kWarpSize / kTeam;
    TeamColumns<kTeam, kCols> cols(a.pairs, a.n_pg, lane, rows);
    CallTiles<kChunk> tiles(a.genotype_prob, a.vid, a.q, ring, a.n_donors, a.stride, lane);
    const int64_t n_warps = (int64_t)gridDim.x * (blockDim.x / kWarpSize);

    for (int64_t b = (int64_t)blockIdx.x * (blockDim.x / kWarpSize) + warp; b < a.n_barcodes; b += n_warps) {
        const int64_t at = b * (int64_t)a.n_pg;
        const int64_t g_lo = a.barcode_ptr[b];
        const int64_t g_hi = a.barcode_ptr[b + 1];
        cols.start_barcode();
        if (g_lo < g_hi) {
            const int64_t base = a.group_ptr[g_lo];  // the barcode's first call; calls below as offsets from it
            tiles.begin(base, a.group_ptr[g_hi]);
            for (int64_t w0 = g_lo; w0 < g_hi; w0 += kWarpSize) {
                const int nw = (int)(g_hi - w0 < kWarpSize ? g_hi - w0 : kWarpSize);
                // lane j < nw: group w0 + j's first call, its calls and its 1 / max(n, 1)^compensation
                const int first = (int)(a.group_ptr[w0 + (lane < nw ? lane : nw)] - base);
                const int count = (int)(a.group_ptr[w0 + (lane < nw ? lane + 1 : nw)] - base) - first;
                const float scale = 1.f / powf(fmaxf((float)count, 1.f), a.compensation);
                // the window's groups of one call, and its others (an empty group too: the log domain's row)
                const unsigned ones = __ballot_sync(kFullMask, lane < nw && count == 1);
                const unsigned others = __ballot_sync(kFullMask, lane < nw && count != 1);
                for (int r0 = 0; r0 < nw; r0 += kTeams) {  // a round: group r0 + t for team t (none past nw)
                    const int j = r0 + lane / kTeam;
                    const int lo = __shfl_sync(kFullMask, first, j);
                    const int hi = lo + __shfl_sync(kFullMask, count, j);
                    const float sc = __shfl_sync(kFullMask, scale, j);
                    const int last = (r0 + kTeams < nw ? r0 + kTeams : nw) - 1;
                    const int c0 = __shfl_sync(kFullMask, first, r0);
                    const int c1 = __shfl_sync(kFullMask, first + count, last);
                    const int n_active = nw - r0 < kTeams ? nw - r0 : kTeams;
                    const unsigned round = (n_active == kWarpSize ? ~0u : (1u << n_active) - 1) << r0;
                    const int domains = (ones & round) == 0     ? kLogDomain
                                        : (others & round) == 0 ? kProbDomain
                                                                : kMixedDomains;
                    const bool one = hi - lo == 1;
                    cols.start_group();
                    // the round's calls [c0, c1), contiguous, through the ring's tiles in order; the domains picked
                    // once a tile, so that the walk and the tiles' gather stay one copy, and the log domain's code
                    // laid out on the fall-through path, as the walk had it with no other domain (a pool of longer
                    // groups: 2.2-2.5% slower without that layout, on the H100)
                    for (int c = c0; c < c1;) {
                        if (base + c >= tiles.start + kTileCalls) tiles.advance();
                        const int tile = (int)(tiles.start - base);
                        const int end = tile + kTileCalls < c1 ? tile + kTileCalls : c1;
                        const int from = lo > c ? lo : c;
                        const int mine = (hi < end ? hi : end) - from;  // this team's calls in [c, end)
                        const int steps = __reduce_max_sync(kFullMask, mine > 0 ? mine : 0);
                        if (__builtin_expect(domains == kLogDomain, 1)) {
                            team_steps<kLogDomain>(cols, tiles, from - tile, mine, steps, one);
                        } else if (domains == kProbDomain) {
                            team_steps<kProbDomain>(cols, tiles, from - tile, mine, steps, one);
                        } else {
                            team_steps<kMixedDomains>(cols, tiles, from - tile, mine, steps, one);
                        }
                        c = end;
                    }
                    if (__builtin_expect(domains == kLogDomain, 1)) {
                        cols.template close_round<kLogDomain>(sc, a.escape, a.log_norm, n_active, one);
                    } else if (domains == kProbDomain) {
                        cols.template close_round<kProbDomain>(sc, a.escape, a.log_norm, n_active, one);
                    } else {
                        cols.template close_round<kMixedDomains>(sc, a.escape, a.log_norm, n_active, one);
                    }
                }
            }
        }
        cols.finish(a.prior != nullptr ? a.prior + at : nullptr, a.logits + at,
                    a.probs != nullptr ? a.probs + at : nullptr);
    }
}

// kTeam = 32 (one warp a barcode, persistent over a static stride of barcodes) and kTeam = 0 (one block a
// barcode): every group in turn, its pointers a window of 31 at a time, one per lane, with each group's
// 1 / n^compensation.
template <int kTeam, int kCols, int kChunk>
__device__ __forceinline__ void group_walk(const Args& a, float* ring, float* extra, int lane, int warp) {
    constexpr bool kBlock = kTeam == 0;
    typename ColumnsOf<kTeam, kCols>::type cols(a.pairs, a.n_pg, lane, extra);
    CallTiles<kChunk, kBlock, true> tiles(a.genotype_prob, a.vid, a.q, ring, a.n_donors, a.stride, lane);
    const int64_t first_b = kBlock ? (int64_t)blockIdx.x : (int64_t)blockIdx.x * (blockDim.x / kWarpSize) + warp;
    const int64_t n_b = kBlock ? (int64_t)gridDim.x : (int64_t)gridDim.x * (blockDim.x / kWarpSize);

    for (int64_t b = first_b; b < a.n_barcodes; b += n_b) {
        const int64_t at = b * (int64_t)a.n_pg;
        const int64_t g_lo = a.barcode_ptr[b];
        const int64_t g_hi = a.barcode_ptr[b + 1];
        cols.start_barcode(a.logits + at);
        if (g_lo < g_hi) {
            const int64_t base = a.group_ptr[g_lo];  // the barcode's first call; calls below as offsets from it
            tiles.begin(base, a.group_ptr[g_hi]);
            for (int64_t w0 = g_lo; w0 < g_hi; w0 += kWindow) {
                const int nw = (int)(g_hi - w0 < kWindow ? g_hi - w0 : kWindow);
                // lane j <= nw: group w0 + j's first call; lane j < nw: its 1 / max(n, 1)^compensation
                const int gp = (int)(a.group_ptr[w0 + (lane < nw ? lane : nw)] - base);
                const int gp_next = __shfl_down_sync(kFullMask, gp, 1);
                const float n = lane < nw ? (float)(gp_next - gp) : 1.f;
                const float scale = 1.f / powf(fmaxf(n, 1.f), a.compensation);
                for (int j = 0; j < nw; ++j) {
                    const int lo = __shfl_sync(kFullMask, gp, j);
                    const int hi = __shfl_sync(kFullMask, gp, j + 1);
                    cols.start_group(hi - lo == 1);  // a group of one call: the probability domain
                    for (int c = lo; c < hi; ++c) {
                        float qc;
                        const float* row = tiles.row(base + c, qc);
                        cols.add_call(row, qc);
                    }
                    cols.close_group(__shfl_sync(kFullMask, scale, j), a.escape, a.log_norm);
                }
            }
        }
        cols.finish(a.prior != nullptr ? a.prior + at : nullptr, a.logits + at,
                    a.probs != nullptr ? a.probs + at : nullptr);
    }
}

// kTeam: lanes a group (1-16: teams; 32: a warp; 0: the block's warps split the columns); kCols: columns a lane
// in registers (0 at kTeam = 32: the shared-memory row); kChunk: floats per cp.async. Shared memory: kTeam > 0,
// per warp its ring (2 x 32 calls x stride floats), then x_floats for the group's row; kTeam = 0, the block's
// ring (2 x 32 x stride), then the warps' maxima and two slots of their sums. Registers: at most 128 a thread (4
// blocks of 4 warps an SM), 168 for teams of 16 columns a lane, which spill at 128.
template <int kTeam, int kCols, int kChunk>
__global__ void __launch_bounds__(kTeam == 0 ? kMaxSplitWarps * kWarpSize : kWarpsPerBlock * kWarpSize,
                                  kTeam == 0 ? 1 : kTeam < kWarpSize && kCols >= 16 ? 3 : 4)
aggregate_kernel(
    const float* __restrict__ genotype_prob, int n_donors, int stride, const int32_t* __restrict__ vid,
    const float* __restrict__ q, const int64_t* __restrict__ group_ptr, const int64_t* __restrict__ barcode_ptr,
    int64_t n_barcodes, const int32_t* __restrict__ pairs, int n_pg, int x_floats, float compensation, float escape,
    float log_norm, const float* __restrict__ prior, float* __restrict__ logits, float* __restrict__ probs)
{
    extern __shared__ __align__(16) float smem[];
    const Args a{genotype_prob, n_donors, stride, vid, q, group_ptr, barcode_ptr, n_barcodes, pairs, n_pg, x_floats,
                 compensation, escape, log_norm, prior, logits, probs};
    const int lane = threadIdx.x & (kWarpSize - 1);
    const int warp = threadIdx.x / kWarpSize;
    const int tile_floats = kTileCalls * a.stride;
    if constexpr (kTeam == 0) {
        group_walk<kTeam, kCols, kChunk>(a, smem, smem + 2 * tile_floats, lane, warp);
    } else {
        float* ring = smem + (size_t)warp * (2 * tile_floats + a.x_floats);
        if constexpr (kTeam < kWarpSize) {
            team_walk<kTeam, kCols, kChunk>(a, ring, ring + 2 * tile_floats, lane, warp);
        } else {
            group_walk<kTeam, kCols, kChunk>(a, ring, ring + 2 * tile_floats, lane, warp);
        }
    }
}

}  // namespace

namespace {

using Kernel = decltype(&aggregate_kernel<32, kMaxRegisterCols, 4>);

// the instantiations the host's plan may name (ops/aggregate_kernel.py: TEAM_COLUMNS), null for any other
template <int kChunk>
Kernel pick(int team, int cols) {
#define DEMUX_AGGREGATE(T, C) \
    if (team == T && cols == C) return aggregate_kernel<T, C, kChunk>;
    DEMUX_AGGREGATE(1, 4)
    DEMUX_AGGREGATE(2, 4)
    DEMUX_AGGREGATE(4, 4)
    DEMUX_AGGREGATE(4, 8)
    DEMUX_AGGREGATE(8, 8)
    DEMUX_AGGREGATE(16, 8)
    DEMUX_AGGREGATE(16, 16)
    DEMUX_AGGREGATE(32, kMaxRegisterCols)
    DEMUX_AGGREGATE(32, 0)
    DEMUX_AGGREGATE(0, 9)
    DEMUX_AGGREGATE(0, kMaxRegisterCols)
#undef DEMUX_AGGREGATE
    return nullptr;
}

// the ring's floats a row: n_donors rounded up to 4; for teams of 4, 8 or 16 lanes padded to kTeam mod 32 (else 4
// mod 32), so that the teams of a round, reading the same column of consecutive rows, hit different banks
int ring_stride(int n_donors, int team) {
    int stride = 4 * ((n_donors + 3) / 4);
    if (team > 0 && team < kWarpSize) {
        const int want = team >= 4 ? team : 4;
        while (stride % kWarpSize != want) stride += 4;
    }
    return stride;
}

}  // namespace

// The operands' indices, checked once when they are built (ops/aggregate_kernel.py: aggregate_operands):
// group_ptr a CSR of n_groups over the n_calls calls, barcode_ptr a CSR of n_barcodes over the groups, every vid in
// [0, n_variants) and every donor of the pair table [2, n_pg] in [0, n_donors). checks.cu's kernels trap on a bad one.
extern "C" int demux_aggregate_check(const int64_t* group_ptr, int64_t n_groups, int64_t n_calls, const int32_t* vid,
                                     int64_t n_variants, const int64_t* barcode_ptr, int64_t n_barcodes,
                                     const int32_t* pairs, int n_pg, int n_donors, int device, void* stream) {
    if (n_groups < 0 || n_calls < 0 || n_barcodes < 0 || n_pg <= 0 || n_donors <= 0) return (int)cudaErrorInvalidValue;
    const demux::DeviceGuard guard(device);
    if (guard.status() != 0) return guard.status();
    cudaStream_t s = (cudaStream_t)stream;
    int status;
    if ((status = demux_check_csr(group_ptr, n_groups, n_calls, s)) != 0) return status;
    if ((status = demux_check_csr(barcode_ptr, n_barcodes, n_groups, s)) != 0) return status;
    if ((status = demux_check_index(vid, n_calls, n_variants, s)) != 0) return status;
    return demux_check_index(pairs, 2 * (int64_t)n_pg, n_donors, s);
}

// logits [n_barcodes, n_pg] (+ prior_logits where given) and, where probs is given, their row softmax, in one
// launch of the instantiation (team, cols) that the host's plan picked for n_pg; operands checked by
// demux_aggregate_check. escape = p_bad_snp / n_pg, log_norm = log(1 + n_pg escape).
extern "C" int demux_aggregated_logits(
    const float* genotype_prob, int n_donors, const int32_t* vid, const float* q,
    const int64_t* group_ptr, const int64_t* barcode_ptr, int64_t n_barcodes,
    const int32_t* pairs, int n_pg, int team, int cols, float compensation, float escape, float log_norm,
    const float* prior_logits, float* logits, float* probs, int device, void* stream)
{
    if (n_barcodes <= 0 || n_pg <= 0 || n_donors <= 0) return (int)cudaErrorInvalidValue;
    const bool rows16 = n_donors % 4 == 0 && demux::aligned16(genotype_prob);
    const Kernel kernel = rows16 ? pick<4>(team, cols) : pick<1>(team, cols);
    const int per_warp = team == 0 ? 0 : (team == kWarpSize ? kWarpSize : team) * cols;  // columns a warp (team)
    const int split = team == 0 ? (n_pg + kWarpSize * cols - 1) / (kWarpSize * cols) : 0;  // warps a barcode
    if (kernel == nullptr || (team == 0 ? split > kMaxSplitWarps : cols > 0 && per_warp < n_pg))
        return (int)cudaErrorInvalidValue;
    const demux::DeviceGuard guard(device);
    if (guard.status() != 0) return guard.status();
    demux::Card card;
    int status;
    if ((status = demux::card_of(device, card)) != 0) return status;
    const int stride = ring_stride(n_donors, team);
    const size_t ring_bytes = (size_t)2 * kTileCalls * stride * sizeof(float);
    int warps, x_floats = 0;
    size_t shared;
    if (team == 0) {
        warps = split;
        shared = ring_bytes + 3 * kMaxSplitWarps * sizeof(float);
        if (shared > (size_t)card.optin) return (int)cudaErrorInvalidValue;
    } else {
        const int row_floats = team < kWarpSize ? kWarpSize / team * team_row(team, cols) : cols == 0 ? n_pg : 0;
        x_floats = 4 * ((row_floats + 3) / 4);  // the group's row (kCols = 0) or the teams' rows (kTeam < 32)
        const size_t warp_bytes = ring_bytes + x_floats * sizeof(float);
        const size_t fit = (size_t)card.optin / warp_bytes;  // a warp's ring (and row) must fit in shared memory
        if (fit < 1) return (int)cudaErrorInvalidValue;
        warps = (int)(fit < (size_t)kWarpsPerBlock ? fit : kWarpsPerBlock);
        shared = warps * warp_bytes;
    }
    int per_sm = 0;
    if ((status = demux::blocks_per_sm(card, reinterpret_cast<const void*>(kernel), warps * kWarpSize, shared,
                                       per_sm)) != 0)
        return status;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const int64_t per_block = team == 0 ? 1 : warps;  // barcodes a block at once
    const int64_t wanted = (n_barcodes + per_block - 1) / per_block;
    const int64_t resident = (int64_t)per_sm * card.n_sms;
    const unsigned int grid = (unsigned int)(wanted < resident ? wanted : resident);
    kernel<<<grid, warps * kWarpSize, shared, (cudaStream_t)stream>>>(
        genotype_prob, n_donors, stride, vid, q, group_ptr, barcode_ptr, n_barcodes, pairs, n_pg, x_floats,
        compensation, escape, log_norm, prior_logits, logits, probs);
    return (int)cudaGetLastError();
}
