// E-step likelihood kernel with the row softmax fused, for Hopper (sm_90a).
//
// Replaces demuxalot_tpu/ops/pallas_likelihood.py:_likelihood_kernel (:180)
// with its softmax_out epilogue (:317-329), and the gather and fold XLA ran
// around it (tiled_logits_impl). For every barcode b and pseudogenotype g:
//
//   logits[b, g] = pen[g] + sum_{calls c of b} log(U'[c, i_g] + U'[c, j_g])   (+ prior[b, g])
//   U'[c, d]     = 0.5 * (G[vid_c, d] * (1 - q_c) + max(q_c, 1e-4))
//   probs[b, :]  = softmax(logits[b, :])                                       (when probs is given)
//
// (i_g, j_g) is column g's donor pair, i == j for a singlet (U' + U' = U).
// Halving before the add is exact for normal floats, so a column carries the
// bits of 0.5 * (U_i + U_j). Calls arrive in CSR form sorted by barcode.
//
// What bounds it on the H100: instruction issue and shared-memory loads, at
// the 4 warps per scheduler that 128 registers a thread allow (capping the
// registers lower spills, and fewer warps hide less latency; PERF.md). A
// doublet column needs no matrix product (it is an f32 add), so there is
// nothing for the tensor cores; at the bench shape (32 donors, 528 columns)
// the work is 2.2 G (call, column) terms of an add, a multiply and an eighth
// of a log. The design spends as few instructions and loads per term as it
// can:
// - Register-tiled donor pairs. A lane owns a 4 x 4 tile of the pair
//   triangle (donor blocks p <= q) and a 2 x 2 tile (blocks of 2 donors).
//   Per call it reads U'[c, 4p..4p+3], U'[c, 4q..4q+3] (two 16-byte shared
//   loads) and two 8-byte pairs, then updates 20 running products at one
//   FADD and one FMUL each. The host's schedule (ops/likelihood_kernel.py:
//   estep_schedule) maps slots to columns: at 32 donors one warp covers all
//   528 columns in one pass, 20 slots per lane for a mean of 16.5 useful
//   columns. More donors walk the calls again, one pass per 32 lanes of
//   tiles. Unused slots have column -1.
// - The log fold, unrolled: each column multiplies its barcode's arguments
//   in call order and takes one log per 8 calls. Real arguments are >= 1e-4,
//   so a product of 8 is >= 1e-32 and stays a normal float. A ragged last
//   group is padded with rows of U' = 0.5 (argument exactly 1), so the loop
//   has no counter and no branch, and padding calls (q = 1, argument 1)
//   change no bit when they follow a barcode's real calls.
// - One warp per barcode, warps persistent over a static stride of
//   barcodes, only warp-level synchronisation. Each warp gathers its calls'
//   G rows (128 bytes at 32 donors) into its own double-buffered ring of
//   32-call tiles with cp.async, so the next tile arrives while this one is
//   folded to U' and computed; the fold keeps four rounds of rows in flight.
//   Hopper's TMA has no row gather, and a call's vid/q run is a few hundred
//   bytes, so cp.async is the copy.
// - The softmax epilogue: the warp stages its barcode's row of logits in
//   shared memory, adds the optional prior, takes the row max and the sum of
//   exponentials by warp shuffles, and writes logits and probs as coalesced
//   16-byte stores (4-byte ones when the row width is not a multiple of 4).
// No integer division runs in a loop. One column's calls are never split
// across threads and nothing is summed with atomics, so two runs give the
// same bits and a barcode's logits do not depend on what else is launched.
// The log is log2 on the MUFU unit (lg2.approx; logf took 1.4x as long at the
// bench shape on an H100, PERF.md), each column's sum scaled by ln 2 once.
// The indices were checked when the operands were built (demux_estep_check,
// checks.cu), so the kernel carries no trap and a launch checks nothing.
//
// The banded E-step (demux_estep_logits_banded) is the same kernel with
// kBanded set. It replaces benchmarks/inkernel_gather_kernels.py:
// _likelihood_kernel_ig (:78), the TPU's in-kernel-gather E-step: the
// variants are cut into K bands (edges[k], edges[k+1]), each call carries a
// band-local variant id, and the calls lie band-major, a barcode CSR per
// band (band_ptr [K, n_barcodes + 1]). Its logits are summed in band order,
// then in call order, and each band's calls of a barcode (a segment) end in
// a log: a call's log argument never multiplies with another band's, so
// padding calls (q = 1) at the end of a segment change no bit. The TPU kept
// one band of G in VMEM beside a super-tile of output rows; here a block's
// 227 KB could not hold a band beside more than a few dozen barcodes' 528
// running sums, so the band stays in L2 (as G does on the main path) and
// the sums stay in registers. The design keeps the main path's ring whole:
// - One stream of slots per barcode. Its K segments lie end to end, each
//   from a multiple of 8 slots and padded to the next with pad slots (U' =
//   0.5, an argument of exactly 1); an empty segment takes no slot. The
//   32-slot tiles of the ring run over this stream as the main path's run
//   over one CSR range, so tile t + 1's calls and rows are in flight while
//   tile t is folded and computed, across band boundaries too. The groups
//   of 8, their products, their logs and the order of the sums are the
//   per-segment walk's, so the logits keep its bits.
// - Finding a slot's call. A window of up to 32 of the barcode's segments
//   sits in the warp's shared memory (lane k reads band k's bounds, a warp
//   scan of the padded lengths gives each segment's first slot); each lane
//   finds its slot's segment by a binary search over the window's first
//   slots, adds band_edges[segment] to the band-local id, and marks a pad
//   slot with q = -1 (real q lie in [0, 1]). The window moves on as the
//   slots pass its end, so K may exceed 32.
// What bounds it is the main path's bound, plus the pad slots (1.6 slots a
// call at 12 bands and 64 calls a barcode; PERF.md). Only the
// logits are written (no prior, no softmax). It runs at the main path's 4
// blocks per SM and 128 registers. The band CSR, the band-local ids and the
// schedule are bounds-checked once, when the operands are built
// (demux_banded_check, checks.cu), so a launch checks nothing.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "launch.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kTileCalls = 32;        // calls per ring slot
constexpr int kLogFold = 8;           // arguments multiplied per log
constexpr int kFoldRounds = 4;        // rounds of the U' fold in flight
constexpr int kQuadSlots = 16;        // 4 x 4 donors
constexpr int kSlots = kQuadSlots + 4;  // + 2 x 2 donors
constexpr int kEntry = 4 + kSlots;    // per (pass, lane): quad p, q, duo r, s, then one column per slot
constexpr int kMaxWarpsPerBlock = 4;
constexpr int kWindowFloats = kWarp * 5;  // kBanded: 32 segments of (first call i64, calls, first slot, edge)
constexpr float kLn2 = 0.693147180559945309f;

using demux::cp_async;

// log2 on the MUFU unit (the argument is a normal float, so no denormal
// handling), the sum scaled by ln 2 once at the end
__device__ __forceinline__ float log_of(float x) {
    float y;
    asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// A row-major [rows, per_row] walk spread over the warp: `step` rows per
// round, this lane's row within the round and its first item in the row.
struct Walk {
    int step, sub, first;
    bool active;
    __device__ Walk(int per_row, int lane) {
        if (per_row <= kWarp) {
            step = kWarp / per_row;
            sub = lane / per_row;
            first = lane - sub * per_row;
        } else {
            step = 1;
            sub = 0;
            first = lane;
        }
        active = sub < step;
    }
};

template <int W>
struct Vec {
    float v[W];
};

template <int W>
__device__ __forceinline__ Vec<W> load(const float* p) {
    Vec<W> r;
    if constexpr (W == 4) {
        const float4 t = *reinterpret_cast<const float4*>(p);
        r.v[0] = t.x; r.v[1] = t.y; r.v[2] = t.z; r.v[3] = t.w;
    } else {
        r.v[0] = *p;
    }
    return r;
}

template <int W>
__device__ __forceinline__ void store(float* p, const Vec<W>& r) {
    if constexpr (W == 4) {
        *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
    } else {
        *p = r.v[0];
    }
}

// The barcode's staged row → logits (+ prior) and, when probs is given, the
// row softmax. W floats per lane and store; every pointer is at the row.
template <int W>
__device__ void epilogue(float* row, int n_pg, const float* prior, float* logits, float* probs, int lane) {
    float m = __int_as_float(0xff800000);  // -inf
    for (int k = W * lane; k < n_pg; k += W * kWarp) {
        Vec<W> l = load<W>(row + k);
        if (prior != nullptr) {
            const Vec<W> p = load<W>(prior + k);
#pragma unroll
            for (int i = 0; i < W; ++i) l.v[i] += p.v[i];
        }
        store<W>(logits + k, l);
        store<W>(row + k, l);
#pragma unroll
        for (int i = 0; i < W; ++i) m = fmaxf(m, l.v[i]);
    }
    if (probs == nullptr) return;
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    float s = 0.f;
    for (int k = W * lane; k < n_pg; k += W * kWarp) {
        Vec<W> e = load<W>(row + k);
#pragma unroll
        for (int i = 0; i < W; ++i) {
            e.v[i] = expf(e.v[i] - m);
            s += e.v[i];
        }
        store<W>(row + k, e);
    }
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    // one division per row: a division per column takes its slow path for
    // every subnormal exponential, which most columns of a confident row are
    const float inv = 1.f / s;
    for (int k = W * lane; k < n_pg; k += W * kWarp) {
        Vec<W> e = load<W>(row + k);
#pragma unroll
        for (int i = 0; i < W; ++i) e.v[i] *= inv;
        store<W>(probs + k, e);
    }
}

// kChunk: floats per cp.async of a G row (4 when rows are 16-byte aligned).
// kBanded: row_ptr is the band-major [n_bands, n_barcodes + 1] CSR, vid is
// band-local and band k's rows start at G[band_edges[k]].
template <int kChunk, bool kBanded>
__global__ void __launch_bounds__(kMaxWarpsPerBlock * kWarp, 4) estep_kernel(
    const float* __restrict__ genotype_prob,  // [n_variants, n_donors]
    int n_donors, int stride,                 // stride: n_donors rounded up to 4
    const int64_t* __restrict__ band_edges,   // [n_bands + 1] (kBanded)
    int n_bands,                              // 1 unless kBanded
    const int64_t* __restrict__ row_ptr,      // [n_barcodes + 1], or [n_bands, n_barcodes + 1]
    const int32_t* __restrict__ vid,          // [n_calls], barcode-sorted (band-major if kBanded)
    const float* __restrict__ q,              // [n_calls]
    int64_t n_barcodes,
    const float* __restrict__ penalties,      // [n_pg]
    const int32_t* __restrict__ schedule,     // [n_passes, kWarp, kEntry]
    int n_passes, int n_pg, int row_floats,   // row_floats: n_pg rounded up to 4
    const float* __restrict__ prior,          // [n_barcodes, n_pg] or null
    float* __restrict__ logits,               // [n_barcodes, n_pg]
    float* __restrict__ probs,                // [n_barcodes, n_pg] or null
    bool vec_rows)                            // the rows take 16-byte stores
{
    extern __shared__ __align__(16) float smem[];
    const int lane = threadIdx.x & (kWarp - 1);
    const int warp = threadIdx.x / kWarp;
    const int tile_floats = kTileCalls * stride;
    float* ring = smem + (size_t)warp * (2 * tile_floats + row_floats + (kBanded ? kWindowFloats : 0));
    float* row = ring + 2 * tile_floats;  // the barcode's staged logits
    const int row_chunks = n_donors / kChunk;
    const int row_quads = stride / 4;
    const Walk copy(row_chunks, lane);
    const Walk fold(row_quads, lane);
    const int64_t n_warps = (int64_t)gridDim.x * (blockDim.x / kWarp);

    // kBanded: the window, after the row: segment k0 + k of the barcode's stream in entry k, its first call,
    // its calls, its first slot and its band's first row of G; win_end is the slot after its last segment
    int64_t* win_lo = reinterpret_cast<int64_t*>(row + row_floats);
    int* win_n = reinterpret_cast<int*>(win_lo + kWarp);
    int* win_start = win_n + kWarp;
    int* win_edge = win_start + kWarp;
    int win_k0 = 0, win_end = 0;
    // bands k0 .. k0 + 31 of barcode b into the window, their first slots from `base`; returns the slot after
    // the window's last segment
    auto open_window = [&](int64_t b, int k0, int base) {
        const int k = k0 + lane;
        int64_t first = 0;
        int n = 0, edge = 0;
        if (k < n_bands) {
            const int64_t* ptr = row_ptr + (int64_t)k * (n_barcodes + 1) + b;
            first = ptr[0];
            n = (int)(ptr[1] - first);
            edge = (int)band_edges[k];
        }
        const int len = (n + kLogFold - 1) & ~(kLogFold - 1);  // whole log groups
        int end = len;  // the inclusive scan of the padded lengths
#pragma unroll
        for (int o = 1; o < kWarp; o <<= 1) {
            const int x = __shfl_up_sync(kFull, end, o);
            if (lane >= o) end += x;
        }
        __syncwarp();  // every lane is done with the last window
        win_lo[lane] = first;
        win_n[lane] = n;
        win_start[lane] = base + end - len;
        win_edge[lane] = edge;
        __syncwarp();
        return base + __shfl_sync(kFull, end, kWarp - 1);
    };

    // one tile's calls into lane registers: lanes [0, n) from call (main path) or slot (kBanded) t; a pad
    // slot has v = -1 and q = -1 (real q lie in [0, 1])
    auto load_calls = [&](int64_t b, int64_t t, int n, int& v, float& qq) {
        if constexpr (!kBanded) {
            v = lane < n ? vid[t + lane] : 0;
            qq = lane < n ? q[t + lane] : 1.f;
        } else {
            const int s = (int)t + lane;
            v = -1;
            qq = -1.f;
            bool pending = lane < n;
            for (;;) {
                int j = 0;  // the window's last segment that starts at or before slot s
#pragma unroll
                for (int step = kWarp / 2; step > 0; step >>= 1) {
                    if (win_start[j + step] <= s) j += step;
                }
                if (pending && s < win_end) {
                    const int at = s - win_start[j];
                    if (at < win_n[j]) {
                        const int64_t c = win_lo[j] + at;
                        v = vid[c] + win_edge[j];  // band-local id made global
                        qq = q[c];
                    }
                    pending = false;
                }
                if (!__any_sync(kFull, pending) || win_k0 + kWarp >= n_bands) break;
                win_k0 += kWarp;  // the tile runs past the window: the next 32 bands
                win_end = open_window(b, win_k0, win_end);
            }
        }
    };
    // the G rows of a tile's calls into `buf` (pad slots copy nothing)
    auto gather = [&](int n, int v, float* buf) {
        for (int r0 = 0; r0 < n; r0 += copy.step) {
            const int r = r0 + copy.sub;
            const int vr = __shfl_sync(kFull, v, r & (kWarp - 1));
            if (copy.active && r < n && (!kBanded || vr >= 0)) {
                const float* src = genotype_prob + (int64_t)vr * n_donors;
                float* dst = buf + r * stride;
                for (int k = copy.first; k < row_chunks; k += kWarp) {
                    cp_async<4 * kChunk>(dst + k * kChunk, src + k * kChunk);
                }
            }
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    };

    for (int64_t b = (int64_t)blockIdx.x * (blockDim.x / kWarp) + warp; b < n_barcodes; b += n_warps) {
        // the main path's calls [lo, hi); the banded stream's slots [0, hi)
        int64_t lo, hi;
        if constexpr (kBanded) {
            lo = 0;
            win_k0 = 0;
            hi = win_end = open_window(b, 0, 0);
            for (int k0 = kWarp; k0 < n_bands; k0 += kWarp) {  // past 32 bands, the stream's length first
                win_k0 = k0;
                hi = win_end = open_window(b, k0, win_end);
            }
        } else {
            lo = row_ptr[b];
            hi = row_ptr[b + 1];
        }
        for (int pass = 0; pass < n_passes; ++pass) {
            const int32_t* entry = schedule + ((int64_t)pass * kWarp + lane) * kEntry;
            const int off_a = 4 * entry[0], off_b = 4 * entry[1];
            const int off_c = 2 * entry[2], off_d = 2 * entry[3];
            float prod[kSlots], sum[kSlots];
#pragma unroll
            for (int s = 0; s < kSlots; ++s) {
                prod[s] = 1.f;
                sum[s] = 0.f;
            }
            if constexpr (kBanded) {
                if (win_k0 != 0) {  // the stream from its first window again
                    win_k0 = 0;
                    win_end = open_window(b, 0, 0);
                }
            }
            __syncwarp();  // every lane is done with the ring and the row
            int v_cur = 0;
            float q_cur = 1.f;
            int cur = 0;
            if (lo < hi) {
                const int n0 = (int)(hi - lo < kTileCalls ? hi - lo : kTileCalls);
                load_calls(b, lo, n0, v_cur, q_cur);
                gather(n0, v_cur, ring);
            }
            for (int64_t t0 = lo; t0 < hi; t0 += kTileCalls) {
                const int nt = (int)(hi - t0 < kTileCalls ? hi - t0 : kTileCalls);
                float* buf = ring + cur * tile_floats;
                asm volatile("cp.async.wait_all;\n" ::: "memory");
                __syncwarp();  // this tile's rows landed; the other slot is free
                float q_next = 1.f;
                const int64_t t1 = t0 + kTileCalls;
                if (t1 < hi) {
                    const int n1 = (int)(hi - t1 < kTileCalls ? hi - t1 : kTileCalls);
                    int v_next;
                    load_calls(b, t1, n1, v_next, q_next);
                    gather(n1, v_next, ring + (cur ^ 1) * tile_floats);
                }
                // fold G rows into U' in place; rows [nt, rows), pad slots and
                // donors past n_donors become 0.5, an argument of exactly 1
                // (a banded tile is whole log groups: rows == nt)
                const int rows = (nt + kLogFold - 1) & ~(kLogFold - 1);
                // kFoldRounds rounds at a time, all loads before all stores, so
                // their shared-memory latencies overlap
                for (int r0 = 0; r0 < rows; r0 += kFoldRounds * fold.step) {
                    int r[kFoldRounds];
                    float w[kFoldRounds], floor_q[kFoldRounds];
                    bool pad[kFoldRounds];
#pragma unroll
                    for (int u = 0; u < kFoldRounds; ++u) {
                        r[u] = r0 + u * fold.step + fold.sub;
                        const float qr = __shfl_sync(kFull, q_cur, r[u] & (kWarp - 1));
                        w[u] = 1.f - qr;
                        floor_q[u] = fmaxf(qr, 1e-4f);
                        pad[u] = qr < 0.f;
                    }
                    for (int k = fold.first; k < row_quads; k += kWarp) {
                        float4 g[kFoldRounds];
#pragma unroll
                        for (int u = 0; u < kFoldRounds; ++u) {
                            if (fold.active && r[u] < rows) g[u] = reinterpret_cast<const float4*>(buf + r[u] * stride)[k];
                        }
                        const int d = 4 * k;
#pragma unroll
                        for (int u = 0; u < kFoldRounds; ++u) {
                            if (!fold.active || r[u] >= rows) continue;
                            // with kChunk 4, n_donors is a multiple of 4
                            const bool real = kBanded ? !pad[u] : r[u] < nt;
                            float4 v = g[u];
                            v.x = real && (kChunk == 4 || d < n_donors) ? 0.5f * (v.x * w[u] + floor_q[u]) : 0.5f;
                            v.y = real && (kChunk == 4 || d + 1 < n_donors) ? 0.5f * (v.y * w[u] + floor_q[u]) : 0.5f;
                            v.z = real && (kChunk == 4 || d + 2 < n_donors) ? 0.5f * (v.z * w[u] + floor_q[u]) : 0.5f;
                            v.w = real && (kChunk == 4 || d + 3 < n_donors) ? 0.5f * (v.w * w[u] + floor_q[u]) : 0.5f;
                            reinterpret_cast<float4*>(buf + r[u] * stride)[k] = v;
                        }
                    }
                }
                __syncwarp();
                for (int r = 0; r < rows; r += kLogFold) {
#pragma unroll
                    for (int c = 0; c < kLogFold; ++c) {
                        const float* u = buf + (r + c) * stride;
                        const float4 a = *reinterpret_cast<const float4*>(u + off_a);
                        const float4 e = *reinterpret_cast<const float4*>(u + off_b);
                        const float2 x = *reinterpret_cast<const float2*>(u + off_c);
                        const float2 y = *reinterpret_cast<const float2*>(u + off_d);
                        const float av[4] = {a.x, a.y, a.z, a.w};
                        const float ev[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
                        for (int i = 0; i < 4; ++i) {
#pragma unroll
                            for (int j = 0; j < 4; ++j) prod[4 * i + j] *= av[i] + ev[j];
                        }
                        prod[kQuadSlots + 0] *= x.x + y.x;
                        prod[kQuadSlots + 1] *= x.x + y.y;
                        prod[kQuadSlots + 2] *= x.y + y.x;
                        prod[kQuadSlots + 3] *= x.y + y.y;
                    }
#pragma unroll
                    for (int s = 0; s < kSlots; ++s) {
                        sum[s] += log_of(prod[s]);
                        prod[s] = 1.f;
                    }
                }
                q_cur = q_next;
                cur ^= 1;
            }
            // every group ended in a log, so prod is 1 and pen + (sum + log 1) is pen + sum
#pragma unroll
            for (int s = 0; s < kSlots; ++s) {
                const int g = entry[4 + s];
                if (g >= 0) row[g] = penalties[g] + sum[s] * kLn2;
            }
        }
        __syncwarp();
        const int64_t at = b * (int64_t)n_pg;
        const float* prior_row = prior != nullptr ? prior + at : nullptr;
        float* probs_row = probs != nullptr ? probs + at : nullptr;
        if (vec_rows) {
            epilogue<4>(row, n_pg, prior_row, logits + at, probs_row, lane);
        } else {
            epilogue<1>(row, n_pg, prior_row, logits + at, probs_row, lane);
        }
    }
}

// Sizes and launches estep_kernel<., kBanded> on the current device; the operands were checked when they were built.
template <bool kBanded>
int launch_estep(int device, const float* genotype_prob, int n_donors, const int64_t* band_edges, int n_bands,
                 const int64_t* row_ptr, const int32_t* vid, const float* q, int64_t n_barcodes,
                 const float* penalties, const int32_t* schedule, int n_passes, int n_pg,
                 const float* prior_logits, float* logits, float* probs, cudaStream_t s)
{
    const int stride = 4 * ((n_donors + 3) / 4);
    const int row_floats = (n_pg + 3) & ~3;
    const size_t warp_floats = (size_t)2 * kTileCalls * stride + row_floats + (kBanded ? kWindowFloats : 0);
    const size_t warp_bytes = warp_floats * sizeof(float);
    demux::Card card;
    int status;
    if ((status = demux::card_of(device, card)) != 0) return status;
    const size_t fit = (size_t)card.optin / warp_bytes;  // the ring and the row must fit in shared memory
    if (fit < 1) return (int)cudaErrorInvalidValue;
    const int warps = (int)(fit < (size_t)kMaxWarpsPerBlock ? fit : kMaxWarpsPerBlock);
    const size_t shared = warps * warp_bytes;

    const bool rows16 = n_donors % 4 == 0 && demux::aligned16(genotype_prob);
    const auto kernel = rows16 ? estep_kernel<4, kBanded> : estep_kernel<1, kBanded>;
    int per_sm = 0;
    if ((status = demux::blocks_per_sm(card, reinterpret_cast<const void*>(kernel), warps * kWarp, shared,
                                       per_sm)) != 0)
        return status;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const int64_t wanted = (n_barcodes + warps - 1) / warps;
    const int64_t resident = (int64_t)per_sm * card.n_sms;
    const unsigned int grid = (unsigned int)(wanted < resident ? wanted : resident);
    const bool vec_rows = n_pg % 4 == 0 && demux::aligned16(prior_logits) && demux::aligned16(logits) &&
                          demux::aligned16(probs);
    kernel<<<grid, warps * kWarp, shared, s>>>(
        genotype_prob, n_donors, stride, band_edges, n_bands, row_ptr, vid, q, n_barcodes, penalties, schedule,
        n_passes, n_pg, row_floats, prior_logits, logits, probs, vec_rows);
    return (int)cudaGetLastError();
}

}  // namespace

// prior_logits and probs may be null; the operands (row_ptr, vid, schedule) were checked by demux_estep_check when
// they were built
extern "C" int demux_estep_logits(
    const float* genotype_prob, int n_donors, const int64_t* row_ptr, const int32_t* vid, const float* q,
    int64_t n_barcodes, const float* penalties, const int32_t* schedule, int n_passes, int n_pg,
    const float* prior_logits, float* logits, float* probs, int device, void* stream)
{
    if (n_barcodes <= 0 || n_pg <= 0 || n_donors <= 0 || n_passes <= 0) return (int)cudaErrorInvalidValue;
    const demux::DeviceGuard guard(device);
    if (guard.status() != 0) return guard.status();
    return launch_estep<false>(device, genotype_prob, n_donors, nullptr, 1, row_ptr, vid, q, n_barcodes, penalties,
                               schedule, n_passes, n_pg, prior_logits, logits, probs, (cudaStream_t)stream);
}

// The banded E-step: band_edges [n_bands + 1] cut the variants, band_ptr
// [n_bands, n_barcodes + 1] is each band's barcode CSR over the band-major
// calls, vid is band-local; all three and the schedule were checked by
// demux_banded_check when the operands were built. Logits only.
extern "C" int demux_estep_logits_banded(
    const float* genotype_prob, int64_t n_variants, int n_donors,
    const int64_t* band_edges, int n_bands, const int64_t* band_ptr,
    const int32_t* vid, const float* q, int64_t n_barcodes,
    const float* penalties, const int32_t* schedule, int n_passes, int n_pg,
    float* logits, int device, void* stream)
{
    // global variant ids are ints inside the kernel
    if (n_barcodes <= 0 || n_pg <= 0 || n_donors <= 0 || n_passes <= 0 || n_bands <= 0 || n_variants > INT32_MAX)
        return (int)cudaErrorInvalidValue;
    const demux::DeviceGuard guard(device);
    if (guard.status() != 0) return guard.status();
    return launch_estep<true>(device, genotype_prob, n_donors, band_edges, n_bands, band_ptr, vid, q, n_barcodes,
                              penalties, schedule, n_passes, n_pg, nullptr, logits, nullptr, (cudaStream_t)stream);
}
