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
//   logits[b] = sum_{groups of b, in group order} z[grp, :]      (+ prior[b]; probs = softmax, when given)
//
// No doublet penalty is added (the reference computes but never adds them on
// this path); a barcode with no group gets a row of zeros (+ prior).
//
// The algebra it runs: sum_k e^{y_k} = 1, so the second log-softmax's
// normaliser is log(1 + n_pg * escape) (log_norm, from the host), and
//   z_g = log(e^{x_g - m} / S + escape) - log_norm,   S = sum_k e^{x_k - m},
// with the first log-softmax's own exponentials. Per (group, column) that is
// one exp and one log on the MUFU unit, per (call, column) one log. The call
// terms are not multiplied before a log as the main E-step's are: p + q has
// no floor here (p is 0 in an unclipped table, q goes down to 1e-7), so a
// product of 8 could underflow. x is kept in log2 units (lg2 of each call
// term, ex2 of x - m) and scaled by ln 2 once, in z.
//
// What bounds it on the H100: the MUFU unit, (calls + 2 groups) x columns
// operations (utils/profiling.py: AggregateRoofline); its bytes (the calls'
// ids and q, the pointers, G, the rows written) take a fraction of that time.
// The design:
// - One warp per barcode, warps persistent over a static stride of barcodes.
//   A warp walks its barcode's groups in order (their pointers a window of 31
//   at a time, one per lane, with each group's 1 / n^compensation) and its
//   calls in tiles of 32: the next tile's G rows are gathered into the warp's
//   double-buffered ring with cp.async while this tile is computed (as in
//   likelihood.cu's main path), and the ids and q of the tile after that are
//   already in registers.
// - Up to 544 columns, the columns live in registers: kCols a lane, column
//   k * 32 + lane, each with its donor pair's offsets. A call term is one FADD
//   and one FFMA, 0.5 * (G_i + G_j) + q: the bits of the plain path's f32
//   product with a 0 / 0.5 / 1 mixing matrix (no tensor cores: TF32 would shift
//   the posteriors), then one lg2. A group's max and sum are warp shuffles; the
//   barcode's row is summed in registers in group order.
// - Past 544 columns (kCols = 0: 33 donors or more with doublets), the group's
//   row sits in the warp's shared memory and the barcode's running row in its
//   own logits row, each column always the same lane's; columns in strides of
//   32 lanes.
// Nothing of size [groups, columns] or [calls, columns] exists in device
// memory. No atomics and no cross-warp sums: two runs give the same bits. The
// indices are checked once per dataset (demux_aggregate_check, when the
// operands are built), so a launch checks nothing.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

int demux_check_index(const int32_t* idx, int64_t n, int64_t limit, cudaStream_t stream);
int demux_check_csr(const int64_t* row_ptr, int64_t n_rows, int64_t n_entries, cudaStream_t stream);

namespace {

using demux::kFullMask;
using demux::kWarpSize;

constexpr int kTileCalls = 32;           // calls per ring slot
constexpr int kWindow = kWarpSize - 1;   // groups per window of 32 group pointers
constexpr int kWarpsPerBlock = 4;
constexpr int kMaxRegisterCols = 17;     // columns a lane in registers: 544 a warp
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

// butterflies: every lane ends with the same bits (a + b == b + a)
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = kWarpSize / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = kWarpSize / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
    return v;
}

// The calls of one barcode, [start of its first tile, end), asked for in
// order, in tiles of 32: the current tile's G rows in one slot of the warp's
// ring, the next tile's in flight into the other, the ids and q of the one
// after that in registers. kChunk: floats per cp.async (4 when G's rows are
// 16-byte aligned).
template <int kChunk>
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
        for (int i0 = 0; i0 < total; i0 += kWarpSize) {
            const int i = i0 + lane;
            const int r = i / row_chunks;
            const int vr = __shfl_sync(kFullMask, v, r & (kWarpSize - 1));
            if (i < total) {
                const int k = (i - r * row_chunks) * kChunk;
                demux::cp_async<4 * kChunk>(buf + r * stride + k, G + (int64_t)vr * n_donors + k);
            }
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    }

    __device__ void begin(int64_t lo, int64_t hi) {
        start = lo;
        end = hi;
        cur = 0;
        int v0, v1;
        load(lo, v0, q_cur);
        load(lo + kTileCalls, v1, q_next);
        load(lo + 2 * kTileCalls, v_ahead, q_ahead);
        __syncwarp();  // every lane is done with the ring
        gather(lo, v0, ring);
        gather(lo + kTileCalls, v1, ring + kTileCalls * stride);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        __syncwarp();  // the first tile landed
    }

    __device__ void advance() {
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncwarp();  // the next tile landed; every lane is done with this one
        start += kTileCalls;
        cur ^= 1;
        q_cur = q_next;
        gather(start + kTileCalls, v_ahead, ring + (cur ^ 1) * kTileCalls * stride);
        q_next = q_ahead;
        load(start + 2 * kTileCalls, v_ahead, q_ahead);
    }

    // call c's G row in shared memory and its q; c is the call after the last one asked for
    __device__ const float* row(int64_t c, float& qc) {
        if (c >= start + kTileCalls) advance();
        const int r = (int)(c - start);
        qc = __shfl_sync(kFullMask, q_cur, r);
        return ring + (cur * kTileCalls + r) * stride;
    }
};

// Up to 32 * kCols columns in registers: lane l holds columns k * 32 + l.
template <int kCols>
struct RegisterColumns {
    float x[kCols], acc[kCols];
    int oi[kCols], oj[kCols];  // the columns' donor pairs: offsets into a G row
    int lane, n_pg;

    __device__ RegisterColumns(const int32_t* pairs, int n_pg_, int lane_, float*) : lane(lane_), n_pg(n_pg_) {
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
            const int g = k * kWarpSize + lane;
            oi[k] = g < n_pg ? pairs[g] : 0;
            oj[k] = g < n_pg ? pairs[n_pg + g] : 0;
        }
    }

    __device__ bool valid(int k) const { return k * kWarpSize + lane < n_pg; }

    __device__ void start_barcode(float*) {
#pragma unroll
        for (int k = 0; k < kCols; ++k) acc[k] = 0.f;
    }

    __device__ void start_group() {
#pragma unroll
        for (int k = 0; k < kCols; ++k) x[k] = 0.f;
    }

    __device__ void add_call(const float* row, float qc) {
#pragma unroll
        for (int k = 0; k < kCols; ++k) x[k] += lg2(fmaf(row[oi[k]] + row[oj[k]], 0.5f, qc));
    }

    // x (log2 units) times 1 / n^compensation → z, added to the barcode's row
    __device__ void close_group(float scale, float escape, float log_norm) {
        float m = neg_inf();
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
            x[k] = valid(k) ? x[k] * scale : neg_inf();
            m = fmaxf(m, x[k]);
        }
        m = warp_max(m);
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
            x[k] = ex2(x[k] - m);
            s += x[k];
        }
        const float inv = 1.f / warp_sum(s);
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
            acc[k] += fmaf(lg2_normal(fmaf(x[k], inv, escape)), kLn2, -log_norm);
        }
    }

    // the row (+ prior) → logits and, when probs is given, its softmax; every pointer is at the barcode's row
    __device__ void finish(const float* prior, float* logits, float* probs) {
        float m = neg_inf();
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
            if (!valid(k)) continue;
            const int g = k * kWarpSize + lane;
            if (prior != nullptr) acc[k] += prior[g];
            logits[g] = acc[k];
            m = fmaxf(m, acc[k]);
        }
        if (probs == nullptr) return;
        m = warp_max(m);
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
            acc[k] = valid(k) ? expf(acc[k] - m) : 0.f;
            s += acc[k];
        }
        const float inv = 1.f / warp_sum(s);
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
            if (valid(k)) probs[k * kWarpSize + lane] = acc[k] * inv;
        }
    }
};

// Any number of columns: the group's row in the warp's shared memory (x, n_pg
// floats), the barcode's running row in its logits row. Column g is always
// lane g % 32's, so no lane reads another's entries.
struct SharedColumns {
    const int32_t* pairs;
    int n_pg, lane;
    float* x;
    float* out = nullptr;

    __device__ SharedColumns(const int32_t* pairs_, int n_pg_, int lane_, float* x_)
        : pairs(pairs_), n_pg(n_pg_), lane(lane_), x(x_) {}

    __device__ void start_barcode(float* logits_row) {
        out = logits_row;
        for (int g = lane; g < n_pg; g += kWarpSize) out[g] = 0.f;
    }

    __device__ void start_group() {
        for (int g = lane; g < n_pg; g += kWarpSize) x[g] = 0.f;
    }

    __device__ void add_call(const float* row, float qc) {
        for (int g = lane; g < n_pg; g += kWarpSize) {
            x[g] += lg2(fmaf(row[pairs[g]] + row[pairs[n_pg + g]], 0.5f, qc));
        }
    }

    __device__ void close_group(float scale, float escape, float log_norm) {
        float m = neg_inf();
        for (int g = lane; g < n_pg; g += kWarpSize) {
            x[g] *= scale;
            m = fmaxf(m, x[g]);
        }
        m = warp_max(m);
        float s = 0.f;
        for (int g = lane; g < n_pg; g += kWarpSize) {
            x[g] = ex2(x[g] - m);
            s += x[g];
        }
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

template <int kCols>
struct ColumnsOf {
    using type = RegisterColumns<kCols>;
};
template <>
struct ColumnsOf<0> {
    using type = SharedColumns;
};

// kCols: columns a lane in registers (1, 2, 4, 8 or 17), 0 for the shared-memory row; kChunk: floats per cp.async.
// Shared memory per warp: its ring (2 x 32 calls x stride floats), then (kCols = 0) x_floats for the group's row.
template <int kCols, int kChunk>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarpSize, 4) aggregate_kernel(
    const float* __restrict__ genotype_prob,  // [n_variants, n_donors]
    int n_donors, int stride,                 // stride: n_donors rounded up to 4
    const int32_t* __restrict__ vid,          // [n_calls], sorted by group
    const float* __restrict__ q,              // [n_calls]
    const int64_t* __restrict__ group_ptr,    // [n_groups + 1] first call of every group
    const int64_t* __restrict__ barcode_ptr,  // [n_barcodes + 1] first group of every barcode
    int64_t n_barcodes,
    const int32_t* __restrict__ pairs,        // [2, n_pg] every column's donor pair
    int n_pg, int x_floats,                   // x_floats: the shared row's floats (kCols = 0), else 0
    float compensation, float escape, float log_norm,
    const float* __restrict__ prior,          // [n_barcodes, n_pg] or null
    float* __restrict__ logits,               // [n_barcodes, n_pg]
    float* __restrict__ probs)                // [n_barcodes, n_pg] or null
{
    extern __shared__ __align__(16) float smem[];
    const int lane = threadIdx.x & (kWarpSize - 1);
    const int warp = threadIdx.x / kWarpSize;
    const int tile_floats = kTileCalls * stride;
    float* ring = smem + (size_t)warp * (2 * tile_floats + x_floats);
    typename ColumnsOf<kCols>::type cols(pairs, n_pg, lane, ring + 2 * tile_floats);
    CallTiles<kChunk> tiles(genotype_prob, vid, q, ring, n_donors, stride, lane);
    const int64_t n_warps = (int64_t)gridDim.x * (blockDim.x / kWarpSize);

    for (int64_t b = (int64_t)blockIdx.x * (blockDim.x / kWarpSize) + warp; b < n_barcodes; b += n_warps) {
        const int64_t at = b * (int64_t)n_pg;
        const int64_t g_lo = barcode_ptr[b];
        const int64_t g_hi = barcode_ptr[b + 1];
        cols.start_barcode(logits + at);
        if (g_lo < g_hi) {
            tiles.begin(group_ptr[g_lo], group_ptr[g_hi]);
            for (int64_t w0 = g_lo; w0 < g_hi; w0 += kWindow) {
                const int nw = (int)(g_hi - w0 < kWindow ? g_hi - w0 : kWindow);
                // lane j <= nw: group w0 + j's first call; lane j < nw: its 1 / max(n, 1)^compensation
                const int64_t gp = group_ptr[w0 + (lane < nw ? lane : nw)];
                const int64_t gp_next = __shfl_down_sync(kFullMask, gp, 1);
                const float n = lane < nw ? (float)(gp_next - gp) : 1.f;
                const float scale = 1.f / powf(fmaxf(n, 1.f), compensation);
                for (int j = 0; j < nw; ++j) {
                    const int64_t lo = __shfl_sync(kFullMask, gp, j);
                    const int64_t hi = __shfl_sync(kFullMask, gp, j + 1);
                    cols.start_group();
                    for (int64_t c = lo; c < hi; ++c) {
                        float qc;
                        const float* row = tiles.row(c, qc);
                        cols.add_call(row, qc);
                    }
                    cols.close_group(__shfl_sync(kFullMask, scale, j), escape, log_norm);
                }
            }
        }
        cols.finish(prior != nullptr ? prior + at : nullptr, logits + at, probs != nullptr ? probs + at : nullptr);
    }
}

using Kernel = decltype(&aggregate_kernel<1, 4>);

// columns a lane in registers for n_pg columns: 1, 2, 4, 8, 17, or 0 (the shared-memory row)
int register_cols(int n_pg) {
    const int per_lane = (n_pg + kWarpSize - 1) / kWarpSize;
    const int options[] = {1, 2, 4, 8, kMaxRegisterCols};
    for (int cols : options) {
        if (per_lane <= cols) return cols;
    }
    return 0;
}

template <int kChunk>
Kernel pick(int cols) {
    switch (cols) {
        case 1: return aggregate_kernel<1, kChunk>;
        case 2: return aggregate_kernel<2, kChunk>;
        case 4: return aggregate_kernel<4, kChunk>;
        case 8: return aggregate_kernel<8, kChunk>;
        case kMaxRegisterCols: return aggregate_kernel<kMaxRegisterCols, kChunk>;
        default: return aggregate_kernel<0, kChunk>;
    }
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
// launch; operands checked by demux_aggregate_check. escape = p_bad_snp / n_pg, log_norm = log(1 + n_pg escape).
extern "C" int demux_aggregated_logits(
    const float* genotype_prob, int n_donors, const int32_t* vid, const float* q,
    const int64_t* group_ptr, const int64_t* barcode_ptr, int64_t n_barcodes,
    const int32_t* pairs, int n_pg, float compensation, float escape, float log_norm,
    const float* prior_logits, float* logits, float* probs, int device, void* stream)
{
    if (n_barcodes <= 0 || n_pg <= 0 || n_donors <= 0) return (int)cudaErrorInvalidValue;
    const demux::DeviceGuard guard(device);
    if (guard.status() != 0) return guard.status();
    const int cols = register_cols(n_pg);
    const int stride = 4 * ((n_donors + 3) / 4);
    const int x_floats = cols == 0 ? 4 * ((n_pg + 3) / 4) : 0;
    const size_t warp_bytes = ((size_t)2 * kTileCalls * stride + x_floats) * sizeof(float);
    int optin, n_sms, status;
    if ((status = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) != 0) return status;
    if ((status = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, device)) != 0) return status;
    const size_t fit = (size_t)optin / warp_bytes;  // a warp's ring (and row) must fit in shared memory
    if (fit < 1) return (int)cudaErrorInvalidValue;
    const int warps = (int)(fit < (size_t)kWarpsPerBlock ? fit : kWarpsPerBlock);
    const size_t shared = warps * warp_bytes;
    const bool rows16 = n_donors % 4 == 0 && demux::aligned16(genotype_prob);
    const Kernel kernel = rows16 ? pick<4>(cols) : pick<1>(cols);
    if ((status = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared)) != 0)
        return status;
    int per_sm = 0;
    if ((status = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, warps * kWarpSize, shared)) != 0)
        return status;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const int64_t wanted = (n_barcodes + warps - 1) / warps;
    const int64_t resident = (int64_t)per_sm * n_sms;
    const unsigned int grid = (unsigned int)(wanted < resident ? wanted : resident);
    kernel<<<grid, warps * kWarpSize, shared, (cudaStream_t)stream>>>(
        genotype_prob, n_donors, stride, vid, q, group_ptr, barcode_ptr, n_barcodes, pairs, n_pg, x_floats,
        compensation, escape, log_norm, prior_logits, logits, probs);
    return (int)cudaGetLastError();
}
