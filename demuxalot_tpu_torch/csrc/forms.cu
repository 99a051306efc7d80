// In-kernel gather forms for Hopper (sm_90a).
//
// Replace benchmarks/exp_gather_forms.py's TPU kernels:
// - the run_form kernels (:38) with main's lambdas for forms C, D, D2
//   (take_along_axis(axis=0) with 2-D indices, :88-125) and E, E2 (the lane
//   gather, take_along_axis(axis=1), :127-155). take_along_axis computes
//     axis 0: out[i, j] = table[idx[i, j], j]
//     axis 1: out[i, j] = table[i, idx[i, j]]
//   bit for bit. Forms A and B, jnp.take(axis=0) with 1-D indices, are
//   gather.cu's gather_rows. What bounds it: the bytes, each index read
//   once, each touched table element once, each output written once (12.6
//   MB at D2's [8192, 128], >= 3.3 us at 3.35 TB/s); at the forms' sizes a
//   launch (a few us) is as long, so the design is one launch per call and
//   as few instructions per byte as the card allows:
//   - the bound test is inside the gather: the kernel reads every index
//     anyway, tests it with one unsigned compare and traps on one out of
//     range. Measured once against checks.cu's kernel launched first
//     (NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py at c42f1ef, 100 calls
//     in a CUDA graph, in turns): 0.00292 ms a call at D2 against 0.00516
//     apart (C-E2: 0.0016-0.0019 against 0.0029-0.0033), so only the fused
//     test is built;
//   - a 2-D grid, output rows by blockIdx.y, column quads by thread: no
//     division per element; 32-bit offsets where the table and the output
//     hold fewer than 2^31 elements, 64-bit ones otherwise;
//   - each thread loads 4 indices with one 16-byte load and stores 4
//     outputs with one 16-byte store, with a scalar path for widths that
//     are no multiple of 4 or indices and outputs off a 16-byte boundary;
//     the table reads on axis 0 stay scalar (a 16-byte table load where a
//     thread's 4 indices are equal, as in C, D and D2, is not tried);
//   - on axis 1 each block stages its rows of the table in shared memory
//     (16-byte loads where the rows are 16-byte aligned; as many rows as 48
//     KB holds, at least one, opting in past 48 KB up to the card's limit)
//     and the lanes gather from there; a row past a block's shared memory
//     (over 227 KB, 58,000 floats) is read through L1/L2 instead.
//   The entry takes the device index and makes that device current only
//   where it is not (common.cuh's DeviceGuard), so the wrapper needs no
//   Python device guard and no stream object (ops/_cuda.py's Entry keeps
//   the ctypes function). Measured (NVIDIA H100 80GB HBM3, 700.00 W,
//   chip_smoke.py phase 11d, each number the mean of two samples in turns
//   with torch.gather's): at D2, 100 calls in a CUDA graph, each on its own
//   copy of the inputs (113 MB of copies, past the 50 MB L2), take 0.00563
//   ms a call against torch.gather's 0.01093, 58% of the 3.3 us HBM bound
//   (C-E2: 0.0022-0.0030 against 0.0078-0.0086). Eagerly the host sets the
//   time: 0.0170 ms against torch.gather's 0.0117, the wrapper issuing a
//   call in 20.7 us against 10.8, of which the launch through Entry takes
//   9.8 (2.5 of it before the C entry's device guard and launch) and the
//   output's allocation through PyTorch's Python API 3.0.
// - ig_kernel (:183-210), the in-kernel gather bench over a table held in
//   on-chip memory (the TPU's VMEM holds the [8192, 32] f32 table, 1 MiB):
//     total = sum_i sum_w table[idx[i], w], steps of `step` indices
//   One block's 227 KB of shared memory cannot hold 1 MiB, but a thread-block
//   cluster's can: cluster_gather_sum_kernel runs clusters of 8 CTAs (the
//   portable size), CTA r holding rows [r * R / 8, (r + 1) * R / 8) (128 KB),
//   loaded once per launch by one bulk copy. What bounds it: the indices (4 B
//   each, 16.8 MB at the harness's 4,194,304) and the table once (1 MiB),
//   >= 5.32 us. An earlier design read each index's row from its owner CTA
//   through the SM-to-SM network (7/8 of the rows, 470 of 537 MB, at 2.3-2.6
//   TB/s: 0.2037 ms). Here no row leaves its SM; the indices travel instead:
//   - owner computes: every CTA sees every index of its cluster and sums
//     only the rows of its own slice: each lane tests its 8 consecutive
//     indices of a chunk, a warp scan of the lanes' hit counts places the
//     row offsets in a queue in index order, and the queued rows are read
//     warp-wide from shared memory, a row across neighbouring lanes in
//     16-byte reads (8 lanes a row at W = 32, 4 rows in flight a lane);
//   - the indices come by TMA: each cluster walks a contiguous span of steps,
//     its index stream cut into stages of kRingStage indices (24 KB) on a
//     grid fixed by the index tensor's own 16-byte alignment, into a ring of
//     2-8 stages in every CTA's shared memory (3 beside the harness's 128 KB
//     slice). Each CTA's producer warp issues 1/8 of each
//     stage as a bulk copy multicast to all 8 CTAs, so each index is read from
//     L2 once per cluster. A stage's "full" barrier in each CTA completes when
//     all 8 producers have arrived (each expecting its own piece's bytes) and
//     the bytes have landed. Each consumer warp releases a stage on its CTA's
//     "local empty" barrier as soon as its indices are in registers; a relay
//     warp in each CTA turns each completed local release into one arrival on
//     the "cluster empty" barrier of each of the 8 CTAs, and a producer
//     refills a stage only when all 8 CTAs have released it (a release that
//     counted only the CTA's own warps would let a peer's multicast overwrite
//     a stage still being read; a release made by the producer between its
//     waits chained every refill behind the one before it, and one made by
//     the consumer warps themselves put a cluster-scope release on their
//     path). An unaligned head and a tail of the index tensor (fewer than 4
//     indices each) are read by plain loads;
//   - the index test is fused: CTA 0 of each cluster tests every index with
//     one unsigned compare and traps past the table, so there is no checks.cu
//     launch.
//   Warp w of 24 takes chunk w (256 indices) of each stage, so a chunk is
//   fixed by an index's position and the tensor's alignment, not by the
//   cluster that reads it. Each CTA's sum of a step is, in warp order, each
//   warp's sum of its chunks of the step in chunk order (the lanes' sums of
//   their rows, then a shuffle tree): a warp whose chunk holds all of a step
//   writes partial[step * 8 + r] itself; for a step over several chunks each
//   warp leaves its sum in scratch behind the partials and the CTA adds them
//   at the end of its span. reduce.cu's demux_sum_in_order then adds the
//   partials in a fixed order. No atomics, so two runs give the same bits,
//   whatever the number of clusters the card places (an index tensor off a
//   16-byte boundary has its own chunk grid, so its own bits). Where a table
//   and the smallest ring do not fit, or cudaOccupancyMaxActiveClusters says
//   the card cannot place one cluster, demux_cluster_gather_plan returns an
//   error and the wrapper raises: it never falls back to the L2 gather.
//   What builds of the alternatives taught (timed with clock64 stamps,
//   kept out of the repository, so no numbers here): the pipeline does not
//   hold it: the ring's depth moves nothing and a stage lands long before a
//   warp asks for it; releases relayed by the producer between its waits, or made with a
//   cluster-scope release on every consumer warp's path, or by a CTA's last
//   warp, each cost more than the relay warp; 8 consecutive indices a lane
//   with a warp scan beat a ballot per 32, and 24 consumer warps beat 16.
//   What is left is the walk's instructions a chunk. chip_smoke.py phase 11
//   times it.
#include <cooperative_groups.h>

#include "bulk.cuh"
#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

// the cluster gather-sum; experiments/gather_forms.py's cluster_plan mirrors these and its shared memory
constexpr int kClusterSize = 8;  // CTAs per cluster, the portable size
constexpr int kConsumerWarps = 24;  // each takes one chunk of every stage
constexpr int kConsumerThreads = kConsumerWarps * demux::kWarpSize;
constexpr int kProducerWarp = kConsumerWarps, kRelayWarp = kConsumerWarps + 1;
constexpr int kClusterThreads = kConsumerThreads + 2 * demux::kWarpSize;  // and the producer and relay warps
constexpr int kPerLane = 8;  // indices a lane reads from a stage, consecutive
constexpr int kChunk = kPerLane * demux::kWarpSize;  // indices a warp reads from a stage
constexpr int kRingStage = kConsumerWarps * kChunk;  // indices a stage holds
constexpr int kRingStageBytes = kRingStage * 4;
constexpr int kMinStages = 2, kMaxStages = 8;
constexpr int kReads = 4;  // queued rows a lane reads at a time
// beside the ring and the slice: the barriers (full, local empty and cluster empty per stage, the slice's), each
// consumer warp's queue of a chunk's 16-bit row offsets, and up to 12 bytes that put the slice at its table offset
// modulo 16
constexpr int kBarrierBytes = 256;
constexpr int kQueueBytes = kConsumerWarps * kChunk * 2;
constexpr int kSlicePad = 16;
constexpr int kFixedBytes = kBarrierBytes + kQueueBytes + kSlicePad;
constexpr int kConsumerBarrier = 1;  // the named barrier of the consumer warps
constexpr int kErrorTooLarge = -1;  // the table and the smallest ring do not fit a CTA's shared memory
constexpr int kErrorNoCluster = -2;  // the card cannot place one cluster
static_assert((3 * kMaxStages + 1) * 8 <= kBarrierBytes, "the barriers fit their bytes");
// positions of indices and stages fit 32 bits below this many indices
constexpr int32_t kMaxIndices = 0x7fffffff - 2 * kConsumerWarps * kPerLane * demux::kWarpSize;
static_assert(kBarrierBytes % 128 == 0 && kRingStageBytes % 128 == 0 && kQueueBytes % 16 == 0, "aligned regions");

constexpr int kStageBytes = 48 * 1024;  // staged table rows a block takes without opting in to more

// take_along_axis on a 2-D grid: thread (x, y) of a block owns output columns [4 j, 4 j + 4) of rows
// blockIdx.y * blockDim.y + y, + gridDim.y * blockDim.y, ...; nothing divides per element.
// Off: uint32_t when the table and the output hold fewer than 2^31 elements, else int64_t.
// kVec: cols_out % 4 == 0 and idx, out on 16-byte boundaries: one 16-byte index load and one 16-byte store per
// thread and row; else 4 scalar loads and stores, the row's tail masked.
// Each index is tested against `limit` (one unsigned compare: a negative index wraps past it) and an index out of
// range traps.
template <bool kVec>
__device__ __forceinline__ void load_indices(const int32_t* __restrict__ p, int valid, int32_t (&k)[4]) {
    if constexpr (kVec) {
        const int4 v = *reinterpret_cast<const int4*>(p);
        k[0] = v.x;
        k[1] = v.y;
        k[2] = v.z;
        k[3] = v.w;
    } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) k[u] = u < valid ? p[u] : 0;
    }
}

template <bool kVec>
__device__ __forceinline__ void store_outputs(float* __restrict__ p, int valid, const float (&v)[4]) {
    if constexpr (kVec) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            if (u < valid) p[u] = v[u];
        }
    }
}

__device__ __forceinline__ void check_index(int32_t k, uint32_t limit) {
    if ((uint32_t)k >= limit) __trap();
}

// axis 0: out[i, j] = table[idx[i, j], j]; the table reads are scalar (4 rows per thread, anywhere in the table)
template <typename Off, bool kVec>
__global__ void __launch_bounds__(kThreads) take_axis0_kernel(const float* __restrict__ table, Off ld,
                                                              const int32_t* __restrict__ idx, Off rows_out,
                                                              int cols_out, uint32_t limit, float* __restrict__ out) {
    const int64_t j64 = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
    if (j64 >= cols_out) return;
    const int j = (int)j64;
    const int valid = cols_out - j;
    for (Off i = (Off)blockIdx.y * blockDim.y + threadIdx.y; i < rows_out; i += (Off)gridDim.y * blockDim.y) {
        const Off base = i * (Off)cols_out + (Off)j;
        int32_t k[4];
        load_indices<kVec>(idx + base, valid, k);
        float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            if (kVec || u < valid) {
                check_index(k[u], limit);
                v[u] = table[(Off)(uint32_t)k[u] * ld + (Off)(j + u)];
            }
        }
        store_outputs<kVec>(out + base, valid, v);
    }
}

// axis 1: out[i, j] = table[i, idx[i, j]]. kStaged: each row y of the block stages table row i in shared memory
// (a stride of `stage` floats, 16-byte loads where the rows are 16-byte aligned) and its lanes gather from there;
// without it (a row past a block's shared memory) they read the table through L1/L2. The loop over row groups
// is uniform across the block, so every thread reaches both barriers.
template <typename Off, bool kVec, bool kStaged>
__global__ void __launch_bounds__(kThreads) take_axis1_kernel(const float* __restrict__ table, Off ld, int n_cols,
                                                              int stage, bool stage_vec, const int32_t* __restrict__ idx,
                                                              Off rows, int cols_out, uint32_t limit,
                                                              float* __restrict__ out) {
    extern __shared__ float4 stage4[];
    float* row = reinterpret_cast<float*>(stage4) + (size_t)threadIdx.y * stage;
    const int64_t j64 = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
    const int j = j64 < cols_out ? (int)j64 : cols_out;
    const int valid = cols_out - j;
    for (Off i0 = (Off)blockIdx.y * blockDim.y; i0 < rows; i0 += (Off)gridDim.y * blockDim.y) {
        const Off i = i0 + threadIdx.y;
        const float* src = table + i * ld;
        if constexpr (kStaged) {
            if (i < rows) {
                if (stage_vec) {
                    for (int c = threadIdx.x; c < n_cols / 4; c += blockDim.x) {
                        reinterpret_cast<float4*>(row)[c] = reinterpret_cast<const float4*>(src)[c];
                    }
                    for (int c = n_cols / 4 * 4 + threadIdx.x; c < n_cols; c += blockDim.x) row[c] = src[c];
                } else {
                    for (int c = threadIdx.x; c < n_cols; c += blockDim.x) row[c] = src[c];
                }
            }
            __syncthreads();
        }
        if (i < rows && valid > 0) {
            const Off base = i * (Off)cols_out + (Off)j;
            int32_t k[4];
            load_indices<kVec>(idx + base, valid, k);
            float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                if (kVec || u < valid) {
                    check_index(k[u], limit);
                    v[u] = kStaged ? row[k[u]] : src[(uint32_t)k[u]];
                }
            }
            store_outputs<kVec>(out + base, valid, v);
        }
        if constexpr (kStaged) __syncthreads();  // the row is read before the next group overwrites it
    }
}

// the block and grid of a take_along_axis launch: x over the output columns' quads (a power of two, at most
// kThreads), y over rows, at most max_rows of them per block
struct TakeShape {
    dim3 block, grid;
};

TakeShape take_shape(int64_t rows, int64_t cols_out, int max_rows) {
    const int64_t quads = (cols_out + 3) / 4;
    int tx = 1;
    while (tx < quads && tx < kThreads) tx *= 2;
    int ty = kThreads / tx;
    if (ty > max_rows) ty = max_rows;
    const int64_t groups = (rows + ty - 1) / ty;
    TakeShape shape;
    shape.block = dim3((unsigned int)tx, (unsigned int)ty);
    shape.grid = dim3((unsigned int)((quads + tx - 1) / tx), (unsigned int)(groups < 65535 ? groups : 65535));
    return shape;
}

// one take_along_axis launch, its arguments checked by the entry
struct Take {
    const float* table;
    int64_t n_rows, n_cols;
    const int32_t* idx;
    int64_t rows_out, cols_out;
    int axis;
    uint32_t limit;
    float* out;
    int device;
    cudaStream_t stream;
};

template <typename Off, bool kVec>
int launch_take(const Take& a) {
    if (a.axis == 0) {
        const TakeShape shape = take_shape(a.rows_out, a.cols_out, kThreads);
        take_axis0_kernel<Off, kVec><<<shape.grid, shape.block, 0, a.stream>>>(
            a.table, (Off)a.n_cols, a.idx, (Off)a.rows_out, (int)a.cols_out, a.limit, a.out);
        return (int)cudaGetLastError();
    }
    // a block stages as many rows as kStageBytes holds (at least one, opting in past 48 KB up to the card's
    // limit); a row past that is read through L1/L2
    const int stage = (int)((a.n_cols + 3) / 4 * 4);
    const size_t row_bytes = (size_t)stage * sizeof(float);
    int max_smem = kStageBytes, status;
    if (row_bytes > (size_t)kStageBytes &&
        (status = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, a.device)) != 0)
        return status;
    const bool staged = row_bytes <= (size_t)max_smem;
    const int max_rows = staged && row_bytes <= (size_t)kStageBytes ? (int)(kStageBytes / row_bytes) : 1;
    const TakeShape shape = take_shape(a.rows_out, a.cols_out, max_rows);
    const bool stage_vec = a.n_cols % 4 == 0 && demux::aligned16(a.table);
    if (staged) {
        const size_t shared = (size_t)shape.block.y * row_bytes;
        auto kernel = take_axis1_kernel<Off, kVec, true>;
        if (shared > (size_t)kStageBytes &&
            (status = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared)) != 0)
            return status;
        kernel<<<shape.grid, shape.block, shared, a.stream>>>(a.table, (Off)a.n_cols, (int)a.n_cols, stage, stage_vec,
                                                              a.idx, (Off)a.rows_out, (int)a.cols_out, a.limit, a.out);
    } else {
        take_axis1_kernel<Off, kVec, false><<<shape.grid, shape.block, 0, a.stream>>>(
            a.table, (Off)a.n_cols, (int)a.n_cols, stage, stage_vec, a.idx, (Off)a.rows_out, (int)a.cols_out, a.limit,
            a.out);
    }
    return (int)cudaGetLastError();
}

using TakeLaunch = int (*)(const Take&);

template <typename Off>
TakeLaunch pick_take(bool vec) {
    return vec ? launch_take<Off, true> : launch_take<Off, false>;
}

// one cluster gather-sum launch, its arguments checked by the entry (n below kMaxIndices, so every position fits 32
// bits; step at most n)
struct ClusterSum {
    const float* table;
    int32_t n_rows;
    int width;
    int rows_per_cta;
    const int32_t* idx;
    int32_t n, step, n_steps;
    int stages;
    float* partial;  // [n_steps * 8]
    float* warp_sums;  // [chunks][8][kConsumerWarps]: a warp's sum of a step over several chunks, at its first chunk
};

// kQ: floats per row read (4: W % 4 == 0 and the table 16-byte aligned, else 1). Index i sits at position
// p = i + ph, ph the tensor's offset in ints from a 16-byte boundary; stage g holds p in [kRingStage g,
// kRingStage (g + 1)), chunk c = kConsumerWarps g + w of it p in [256 c, 256 c + 256), read by consumer warp w,
// lane l of it p in [256 c + 8 l, 256 c + 8 l + 8).
template <int kQ>
__global__ void __launch_bounds__(kClusterThreads, 1) cluster_gather_sum_kernel(const ClusterSum a) {
    extern __shared__ __align__(128) unsigned char smem[];
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    uint64_t* local_empty = full + kMaxStages;
    uint64_t* cluster_empty = local_empty + kMaxStages;
    uint64_t* slice_bar = cluster_empty + kMaxStages;
    int32_t* ring = reinterpret_cast<int32_t*>(smem + kBarrierBytes);
    uint16_t* queues = reinterpret_cast<uint16_t*>(smem + kBarrierBytes + (size_t)a.stages * kRingStageBytes);
    cg::cluster_group cluster = cg::this_cluster();
    const uint32_t rank = cluster.block_rank();
    const int warp = threadIdx.x / demux::kWarpSize, lane = threadIdx.x % demux::kWarpSize;

    // this CTA's rows, at the same offset modulo 16 bytes in shared memory as in the table: the 16-byte-aligned
    // body is one bulk copy, the few floats before and after it plain loads
    const int32_t row_lo = (int32_t)rank * a.rows_per_cta;
    const int32_t row_end = a.n_rows - row_lo < a.rows_per_cta ? a.n_rows : row_lo + a.rows_per_cta;
    const uint32_t slice_rows = row_end > row_lo ? (uint32_t)(row_end - row_lo) : 0u;
    const float* src = a.table + (int64_t)row_lo * a.width;
    float* slice = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(queues) + kQueueBytes +
                                            (reinterpret_cast<uintptr_t>(src) & 15));
    const int count = (int)slice_rows * a.width;
    int body_lo = (int)((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15) / 4;
    body_lo = body_lo < count ? body_lo : count;
    const int body_hi = body_lo + (count - body_lo) / 4 * 4;

    // the index stream: a plain head below d and tail from e_end, the aligned body between them by bulk copies
    const int ph = (int)((reinterpret_cast<uintptr_t>(a.idx) >> 2) & 3);
    const int d = (4 - ph) % 4 < a.n ? (4 - ph) % 4 : a.n;
    const int e_end = d + (a.n - d) / 4 * 4;
    // this cluster's steps [s_lo, s_hi), indices [ia, ib), stages g_a, ..., g_a + n_stages - 1
    const int64_t n_clusters = gridDim.x / kClusterSize, cid = blockIdx.x / kClusterSize;
    const int s_lo = (int)(cid * a.n_steps / n_clusters), s_hi = (int)((cid + 1) * a.n_steps / n_clusters);
    const int ia = s_lo * a.step;  // below n: s_lo < n_steps
    const int ib = (int)((int64_t)s_hi * a.step < a.n ? (int64_t)s_hi * a.step : a.n);
    const int g_a = (ia + ph) / kRingStage, n_stages = (ib - 1 + ph) / kRingStage - g_a + 1;

    if (threadIdx.x == kConsumerThreads) {
        for (int j = 0; j < a.stages; ++j) {
            demux::mbar_init(&full[j], kClusterSize);  // each CTA's producer, with its piece's bytes
            demux::mbar_init(&local_empty[j], kConsumerWarps);  // this CTA's consumer warps
            demux::mbar_init(&cluster_empty[j], kClusterSize);  // each CTA's relay
        }
        demux::mbar_init(slice_bar, 1);
        demux::mbar_init_fence();
    }
    for (int e = threadIdx.x; e < body_lo + count - body_hi; e += blockDim.x) {
        const int f = e < body_lo ? e : body_hi + (e - body_lo);
        slice[f] = src[f];
    }
    cluster.sync();  // every CTA's barriers are initialised before any multicast or remote arrival

    if (warp == kRelayWarp) {  // this CTA's consumers are done with a stage that will be refilled: tell all 8
        for (int j = 0, slot = 0, round = 0; j < n_stages - a.stages; ++j) {
            demux::mbar_wait(&local_empty[slot], round & 1);
            if (lane < kClusterSize) demux::mbar_arrive_cluster(&cluster_empty[slot], lane);
            if (++slot == a.stages) {
                slot = 0;
                ++round;
            }
        }
    } else if (warp == kProducerWarp) {
        if (lane == 0) {
            const uint32_t bytes = (uint32_t)(body_hi - body_lo) * 4;
            demux::mbar_arrive_expect_tx(slice_bar, bytes);
            if (bytes > 0) demux::bulk_load(slice + body_lo, src + body_lo, bytes, slice_bar);
        }
        for (int j = 0, slot = 0, round = 0; j < n_stages; ++j) {
            if (round > 0) demux::mbar_wait<true>(&cluster_empty[slot], (round - 1) & 1);  // all 8 done
            // the stage's bulk-copied indices [lo, hi), this CTA's eighth of them (16-byte pieces) to all 8
            const int first = (g_a + j) * kRingStage - ph;  // the index at the stage's position 0
            const int lo = first > d ? first : d;
            int hi = first + kRingStage < e_end ? first + kRingStage : e_end;
            hi = hi > lo ? hi : lo;
            const int part = ((hi - lo + kClusterSize - 1) / kClusterSize + 3) / 4 * 4;
            const int p_lo = lo + (int)rank * part < hi ? lo + (int)rank * part : hi;
            const int p_hi = p_lo + part < hi ? p_lo + part : hi;
            const uint32_t bytes = (uint32_t)(p_hi - p_lo) * 4;
            if (lane < kClusterSize) demux::mbar_arrive_expect_tx_cluster(&full[slot], lane, bytes);
            if (lane == 0 && bytes > 0) {
                demux::bulk_load_multicast(ring + slot * kRingStage + (p_lo - first), a.idx + p_lo, bytes,
                                           &full[slot], (uint16_t)((1u << kClusterSize) - 1u));
            }
            if (++slot == a.stages) {
                slot = 0;
                ++round;
            }
        }
    } else {  // a consumer
        uint16_t* queue = queues + warp * kChunk;
        const bool tests = rank == 0;
        // queued rows across neighbouring lanes: lanes_per_row lanes of kQ floats each, rows_at_once rows a read
        const int row_loads = a.width / kQ;
        const int lanes_per_row = row_loads < demux::kWarpSize ? row_loads : demux::kWarpSize;
        const int rows_at_once = demux::kWarpSize / lanes_per_row;
        const int sub = lane / lanes_per_row, col = lane - sub * lanes_per_row;
        const bool reads = sub < rows_at_once;
        bool slice_in = false;  // the slice's bulk copy has landed (waited for before the first row read)
        demux::RowSums<kQ> acc;
        int s = s_lo;  // a step of this warp's chunks, and the index where the one after it begins
        int64_t s_next = (int64_t)(s_lo + 1) * a.step;
        for (int j = 0, slot = 0, round = 0; j < n_stages; ++j) {
            const int c = (g_a + j) * kConsumerWarps + warp;  // this warp's chunk
            const int base = c * kChunk - ph;  // the index at the chunk's position 0
            const int lo = base > ia ? base : ia, hi = base + kChunk < ib ? base + kChunk : ib;
            demux::mbar_wait(&full[slot], round & 1);
            // the chunk's indices, lane l's 8 at positions 8 l, ..., 8 l + 7 in two 16-byte loads (positions
            // outside [lo, hi) are masked below), then the stage released to the relay
            const int4* chunk = reinterpret_cast<const int4*>(ring + slot * kRingStage + warp * kChunk) + 2 * lane;
            const int4 k0 = chunk[0], k1 = chunk[1];
            int32_t k[kPerLane] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
            __syncwarp();
            if (lane == 0) demux::mbar_arrive(&local_empty[slot]);
            if (++slot == a.stages) {
                slot = 0;
                ++round;
            }
            if (lo >= hi) continue;
            // position 8 lane + u of the chunk is in [lo, hi) when it is less than span past lo - base
            const uint32_t from = (uint32_t)(lo - base - kPerLane * lane), span = (uint32_t)(hi - lo);
            if (base < d || base + kChunk > e_end) {  // the tensor's unaligned head or tail: plain loads
#pragma unroll
                for (int u = 0; u < kPerLane; ++u) {
                    const int i = base + kPerLane * lane + u;
                    if ((uint32_t)u - from < span && (i < d || i >= e_end)) k[u] = a.idx[i];
                }
            }
            if (tests) {  // the bound test (CTA 0)
#pragma unroll
                for (int u = 0; u < kPerLane; ++u) {
                    if ((uint32_t)u - from < span) check_index(k[u], (uint32_t)a.n_rows);
                }
            }
            // the lane's hits: its indices in [lo, hi) whose rows this CTA holds, bit u for position 8 lane + u
            unsigned hits = 0;
            if (span == kChunk) {  // the whole chunk is this cluster's, as all but a span's first and last are
#pragma unroll
                for (int u = 0; u < kPerLane; ++u) {
                    hits |= (unsigned)((uint32_t)k[u] - (uint32_t)row_lo < slice_rows) << u;
                }
            } else {
#pragma unroll
                for (int u = 0; u < kPerLane; ++u) {
                    const bool hit = (uint32_t)u - from < span && (uint32_t)k[u] - (uint32_t)row_lo < slice_rows;
                    hits |= (unsigned)hit << u;
                }
            }
            // the hits in this CTA's slice queued in index order: each lane's after those of the lanes before it
            // (a warp scan of the lanes' counts)
            const int mine = __popc(hits);
            int upto = mine;
#pragma unroll
            for (int o = 1; o < demux::kWarpSize; o <<= 1) {
                const int v = __shfl_up_sync(demux::kFullMask, upto, o);
                if (lane >= o) upto += v;
            }
            const int first_hit = upto - mine, n_hits = __shfl_sync(demux::kFullMask, upto, demux::kWarpSize - 1);
            int at = first_hit;
#pragma unroll
            for (int u = 0; u < kPerLane; ++u) {
                if ((hits >> u) & 1u) queue[at] = (uint16_t)((k[u] - row_lo) * a.width);
                at += (hits >> u) & 1u;
            }
            __syncwarp();
            // the step of the chunk's first index: steps of a stage or more move it by a few from this warp's
            // chunk before, shorter ones by a division
            if (a.step >= kRingStage) {
                while (s_next <= lo) {
                    ++s;
                    s_next += a.step;
                }
            } else {
                s = (int)((uint32_t)lo / (uint32_t)a.step);
                s_next = (int64_t)(s + 1) * a.step;
            }
            if (!slice_in) {
                demux::mbar_wait(slice_bar, 0);
                slice_in = true;
            }
            // the chunk's steps in order: each step's queued rows, then this warp's sum of the step where this
            // is its last chunk of it
            int qa = 0;
            for (;;) {
                const int s_start = s * a.step;
                const int s_end = s_start + (a.n - s_start < a.step ? a.n - s_start : a.step);
                const int seg_hi = s_end < hi ? s_end : hi;
                int qb = n_hits;
                if (seg_hi != hi) {  // the hits before position t = seg_hi - base: lane t / 8's first and its own
                    const int t = seg_hi - base;
                    const int below_t = first_hit + __popc(hits & ((1u << (t % kPerLane)) - 1u));
                    qb = __shfl_sync(demux::kFullMask, below_t, t / kPerLane);
                }
                for (int q0 = qa + sub; q0 < qb; q0 += kReads * rows_at_once) {
                    int offset[kReads];
                    bool has[kReads];
#pragma unroll
                    for (int r = 0; r < kReads; ++r) {  // the row offsets first, then the rows
                        has[r] = q0 + r * rows_at_once < qb;
                        offset[r] = queue[has[r] ? q0 + r * rows_at_once : q0];
                    }
                    if (reads) {
                        for (int e = col * kQ; e < a.width; e += lanes_per_row * kQ) {
#pragma unroll
                            for (int r = 0; r < kReads; ++r) {
                                if (has[r]) acc.add(slice + offset[r] + e);
                            }
                        }
                    }
                }
                // no later chunk of this warp holds step s: the warp's sum of it
                if (s_end + ph <= (c + kConsumerWarps) * kChunk) {
                    float sum = acc.take();
#pragma unroll
                    for (int o = demux::kWarpSize / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(demux::kFullMask, sum, o);
                    const int c1 = (s_start + ph) / kChunk, c2 = (s_end - 1 + ph) / kChunk;
                    if (lane == 0) {
                        if (c1 == c2) {  // the step's only chunk: its partial, the warp-order sum of one term
                            a.partial[(int64_t)s * kClusterSize + rank] = 0.f + sum;
                        } else {
                            a.warp_sums[((int64_t)c1 * kClusterSize + rank) * kConsumerWarps + warp] = sum;
                        }
                    }
                }
                if (seg_hi == hi) break;
                ++s;
                s_next += a.step;
                qa = qb;
            }
            __syncwarp();  // the queue is read before the next chunk's hits overwrite it
        }
        // the steps over several chunks: their warps' sums in warp order (a warp with no chunk in the step adds 0)
        asm volatile("bar.sync %0, %1;\n" ::"n"(kConsumerBarrier), "n"(kConsumerThreads) : "memory");
        for (int s = s_lo + (int)threadIdx.x; s < s_hi; s += kConsumerThreads) {
            const int s_start = s * a.step;
            const int s_end = s_start + (a.n - s_start < a.step ? a.n - s_start : a.step);
            const int c1 = (s_start + ph) / kChunk, span = (s_end - 1 + ph) / kChunk - c1;
            if (span == 0) continue;
            const int w1 = c1 % kConsumerWarps;
            const float* sums = a.warp_sums + ((int64_t)c1 * kClusterSize + rank) * kConsumerWarps;
            float total = 0.f;
            for (int w = 0; w < kConsumerWarps; ++w) {
                if (span >= kConsumerWarps - 1 || (w - w1 + kConsumerWarps) % kConsumerWarps <= span) total += sums[w];
            }
            a.partial[(int64_t)s * kClusterSize + rank] = total;
        }
    }
    cluster.sync();  // no CTA leaves while a peer may still multicast into it or arrive on its barriers
}

// stages of the index ring that fit beside a slice of rows_per_cta rows of `width` floats (kMaxStages at most)
int64_t ring_stages(int64_t rows_per_cta, int width, int optin) {
    const int64_t slice_bytes = rows_per_cta * width * 4;
    const int64_t spare = optin - kFixedBytes - slice_bytes;
    const int64_t stages = spare > 0 ? spare / kRingStageBytes : 0;
    return stages < kMaxStages ? stages : kMaxStages;
}

size_t cluster_shared(int64_t rows_per_cta, int width, int stages) {
    return (size_t)kFixedBytes + (size_t)stages * kRingStageBytes + (size_t)rows_per_cta * width * 4;
}

using ClusterKernel = void (*)(ClusterSum);

ClusterKernel pick_cluster(bool row_vec) {
    return row_vec ? &cluster_gather_sum_kernel<4> : &cluster_gather_sum_kernel<1>;
}

// a launch of `clusters` clusters of 8 CTAs, or (grid 0) a configuration for the occupancy queries
cudaLaunchConfig_t cluster_config(size_t shared, int64_t clusters, cudaStream_t s, cudaLaunchAttribute* attribute) {
    attribute->id = cudaLaunchAttributeClusterDimension;
    attribute->val.clusterDim.x = kClusterSize;
    attribute->val.clusterDim.y = 1;
    attribute->val.clusterDim.z = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3((unsigned int)(clusters * kClusterSize));
    config.blockDim = dim3(kClusterThreads);
    config.dynamicSmemBytes = shared;
    config.stream = s;
    config.attrs = attribute;
    config.numAttrs = 1;
    return config;
}

}  // namespace

extern "C" int demux_take_along_axis(const float* table, int64_t n_rows, int64_t n_cols, const int32_t* idx,
                                     int64_t rows_out, int64_t cols_out, int axis, float* out, int device,
                                     void* stream) {
    if (n_rows <= 0 || n_cols <= 0 || rows_out < 0 || cols_out <= 0 || cols_out > 0x7fffffff ||
        (axis != 0 && axis != 1) || (axis == 0 ? cols_out != n_cols : rows_out != n_rows || n_cols > 0x7fffffff))
        return (int)cudaErrorInvalidValue;
    const int64_t n = rows_out * cols_out;
    if (n == 0) return 0;
    const demux::DeviceGuard guard(device);
    if (guard.status() != 0) return guard.status();
    cudaStream_t s = (cudaStream_t)stream;
    const int64_t limit = axis == 0 ? n_rows : n_cols;  // an int32 index is below 2^31 whatever the limit
    const uint32_t limit32 = (uint32_t)(limit < 0x80000000LL ? limit : 0x80000000LL);
    const bool wide = n_rows * n_cols > 0x7fffffff || n > 0x7fffffff;
    const bool vec = cols_out % 4 == 0 && demux::aligned16(idx) && demux::aligned16(out);
    const Take take{table, n_rows, n_cols, idx, rows_out, cols_out, axis, limit32, out, device, s};
    return (wide ? pick_take<int64_t>(vec) : pick_take<uint32_t>(vec))(take);
}

// out[0]: ring stages, out[1]: shared memory per CTA, out[2]: clusters of 8 CTAs the card can place at once,
// out[3]: CTAs per SM, for a table [n_rows, width] on card `device`. kErrorTooLarge where the slice and the
// smallest ring do not fit a CTA's shared memory, kErrorNoCluster where the card cannot place one cluster.
extern "C" int demux_cluster_gather_plan(int64_t n_rows, int width, int32_t* out, int device) {
    if (n_rows <= 0 || width <= 0 || n_rows > 0x7fffffff) return (int)cudaErrorInvalidValue;
    const demux::DeviceGuard guard(device);
    if (guard.status() != 0) return guard.status();
    int status, optin;
    if ((status = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) != 0) return status;
    const int64_t rows_per_cta = (n_rows + kClusterSize - 1) / kClusterSize;
    const int64_t stages = ring_stages(rows_per_cta, width, optin);
    if (stages < kMinStages) return kErrorTooLarge;
    const size_t shared = cluster_shared(rows_per_cta, width, (int)stages);
    const ClusterKernel kernel = pick_cluster(width % 4 == 0);
    if ((status = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared)) != 0)
        return status;
    cudaLaunchAttribute attribute[1];
    const cudaLaunchConfig_t config = cluster_config(shared, 1, nullptr, attribute);
    int clusters = 0, per_sm = 0;
    if ((status = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config)) != 0 ||
        (status = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kClusterThreads, shared)) != 0) {
        cudaGetLastError();  // a refused configuration is reported here, not left for the next launch
        return status;
    }
    out[0] = (int32_t)stages;
    out[1] = (int32_t)shared;
    out[2] = clusters;
    out[3] = per_sm;
    return clusters < 1 ? kErrorNoCluster : 0;
}

// stages, clusters: from demux_cluster_gather_plan. partial: scratch of at least ceil(n / step) * 8 +
// ((n + 2) / 256 + 1) * 128 floats (the partials, then the warps' sums of steps over several chunks); total: one
// float.
extern "C" int demux_cluster_gather_sum(const float* table, int64_t n_rows, int width, const int32_t* idx, int64_t n,
                                        int64_t step, int stages, int clusters, float* partial, float* total,
                                        int device, void* stream) {
    if (n_rows <= 0 || width <= 0 || n <= 0 || step <= 0 || n_rows > 0x7fffffff || n > kMaxIndices ||
        stages < kMinStages || stages > kMaxStages || clusters < 1)
        return (int)cudaErrorInvalidValue;
    const demux::DeviceGuard guard(device);
    if (guard.status() != 0) return guard.status();
    cudaStream_t s = (cudaStream_t)stream;
    int status, optin;
    if ((status = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) != 0) return status;
    const int64_t rows_per_cta = (n_rows + kClusterSize - 1) / kClusterSize;
    if (ring_stages(rows_per_cta, width, optin) < stages) return kErrorTooLarge;
    const size_t shared = cluster_shared(rows_per_cta, width, stages);
    const ClusterKernel kernel = pick_cluster(width % 4 == 0 && demux::aligned16(table));
    if ((status = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared)) != 0)
        return status;
    const int64_t n_steps = (n + step - 1) / step;
    cudaLaunchAttribute attribute[1];
    const cudaLaunchConfig_t config = cluster_config(shared, n_steps < clusters ? n_steps : clusters, s, attribute);
    const ClusterSum args{table, (int32_t)n_rows, width, (int)rows_per_cta, idx, (int32_t)n,
                          (int32_t)(step < n ? step : n), (int32_t)n_steps, stages, partial,
                          partial + n_steps * kClusterSize};
    if ((status = cudaLaunchKernelEx(&config, kernel, args)) != 0) return status;
    if ((status = (int)cudaGetLastError()) != 0) return status;
    return demux_sum_in_order(partial, n_steps * kClusterSize, total, s);
}
