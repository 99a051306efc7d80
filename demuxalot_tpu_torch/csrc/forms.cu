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
//   cluster's distributed shared memory can: cluster_gather_sum_kernel runs
//   clusters of 8 CTAs (the portable size), CTA r holding rows
//   [r * R / 8, (r + 1) * R / 8) (128 KB), loaded once per launch; after
//   cluster.sync() each index's row is read from its owner CTA's shared
//   memory through cluster.map_shared_rank. Where a table does not fit the
//   8 CTAs' shared memory, or cudaOccupancyMaxActiveClusters says the card
//   cannot place one such cluster, it returns an error and the wrapper
//   raises: it never falls back to the L2 gather. What bounds it: the
//   indices (4 B each, 16.8 MB at the harness's 4,194,304) and the table
//   once (1 MiB), >= 5.32 us; the gathered rows come from distributed
//   shared memory, not HBM. Each cluster walks steps cluster_id,
//   cluster_id + n_clusters, ...; within a step CTA r sums a contiguous 1/8
//   of its indices in a fixed order (common.cuh's block_sum) and writes
//   partial[step * 8 + r]. Each element is an index load, then a remote row
//   load that depends on it, so each thread loads kUnroll indices, then
//   their rows, then adds them in element order (0.2380 ms at the harness's
//   shape against 0.2547 one at a time, NVIDIA H100 80GB HBM3, 700 W: 2.3
//   TB/s of rows, 7/8 of them from other SMs). reduce.cu's
//   demux_sum_in_order then adds the partials in a fixed order.
//   No atomics, so two runs give the same bits.
//   Its indices are bounds-checked by checks.cu's kernel before each launch.
#include <cooperative_groups.h>

#include "common.cuh"

int demux_check_index(const int32_t* idx, int64_t n, int64_t limit, cudaStream_t stream);

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kClusterThreads = 512;
constexpr int kClusterSize = 8;  // CTAs per cluster, the portable size
constexpr int kUnroll = 4;  // gathered elements per thread in flight
constexpr int kErrorTooLarge = -1;  // the table does not fit the cluster's shared memory
constexpr int kErrorNoCluster = -2;  // the card cannot place one cluster

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

// kW: floats per load (4 or 1)
template <int kW>
__global__ void __launch_bounds__(kClusterThreads) cluster_gather_sum_kernel(
    const float* __restrict__ table, int64_t n_rows, int width, int rows_per_cta, const int32_t* __restrict__ idx,
    int64_t n, int64_t step, int64_t n_steps, float* __restrict__ partial) {
    extern __shared__ float4 smem4[];
    float* slice = reinterpret_cast<float*>(smem4);
    __shared__ float warp_sums[kClusterThreads / demux::kWarpSize];
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int width_v = width / kW;

    // this CTA's rows of the table, once
    const int64_t r0 = (int64_t)rank * rows_per_cta;
    const int64_t r1 = r0 + rows_per_cta < n_rows ? r0 + rows_per_cta : n_rows;
    const int64_t count_v = r1 > r0 ? (r1 - r0) * width_v : 0;
    for (int64_t e = threadIdx.x; e < count_v; e += blockDim.x) {
        if constexpr (kW == 4) {
            smem4[e] = reinterpret_cast<const float4*>(table + r0 * width)[e];
        } else {
            slice[e] = table[r0 * width + e];
        }
    }
    cluster.sync();  // every slice is in place before any CTA reads another's

    const int64_t n_clusters = gridDim.x / kClusterSize;
    for (int64_t s = blockIdx.x / kClusterSize; s < n_steps; s += n_clusters) {
        const int64_t lo = s * step;
        const int64_t hi = lo + step < n ? lo + step : n;
        const int64_t part = (hi - lo + kClusterSize - 1) / kClusterSize;
        const int64_t a = lo + rank * part < hi ? lo + rank * part : hi;
        const int64_t b = a + part < hi ? a + part : hi;
        const int total = (int)(b - a) * width_v;  // the launcher keeps step * width below 2^31
        float acc = 0.f;
        // kUnroll elements per thread in flight: their indices first, then their rows, then the adds in
        // element order (the order of a one-at-a-time loop), so the index -> row chains overlap
        for (int e0 = threadIdx.x; e0 < total; e0 += kUnroll * kClusterThreads) {
            const float* src[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const int e = e0 + u * kClusterThreads;
                const int i = e / width_v;
                const int row = e < total ? idx[a + i] : 0;
                const int owner = row / rows_per_cta;
                src[u] = cluster.map_shared_rank(slice, owner) + (row - owner * rows_per_cta) * width +
                         (e - i * width_v) * kW;
            }
            float v[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                v[u] = e0 + u * kClusterThreads < total ? demux::load_sum<kW>(src[u]) : 0.f;
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                if (e0 + u * kClusterThreads < total) acc += v[u];
            }
        }
        const float sum = demux::block_sum(acc, warp_sums);
        if (threadIdx.x == 0) partial[s * kClusterSize + rank] = sum;
        __syncthreads();  // warp_sums is read before the next step writes it
    }
    cluster.sync();  // no CTA leaves while another may still read its slice
}

// launches kernel in clusters of kClusterSize CTAs over the steps; kErrorNoCluster when the card cannot place one
template <typename Kernel>
int launch_clusters(Kernel kernel, size_t shared, const float* table, int64_t n_rows, int width, int rows_per_cta,
                    const int32_t* idx, int64_t n, int64_t step, int64_t n_steps, float* partial, cudaStream_t s) {
    int status;
    if ((status = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared)) != 0)
        return status;
    cudaLaunchAttribute attribute[1];
    attribute[0].id = cudaLaunchAttributeClusterDimension;
    attribute[0].val.clusterDim.x = kClusterSize;
    attribute[0].val.clusterDim.y = 1;
    attribute[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t config = {};
    config.blockDim = dim3(kClusterThreads);
    config.dynamicSmemBytes = shared;
    config.stream = s;
    config.attrs = attribute;
    config.numAttrs = 1;
    config.gridDim = dim3(kClusterSize);
    int clusters = 0;
    if ((status = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config)) != 0) {
        cudaGetLastError();  // a refused configuration is reported here, not left for the next launch
        return status;
    }
    if (clusters < 1) return kErrorNoCluster;
    const int64_t grid = n_steps < clusters ? n_steps : clusters;
    config.gridDim = dim3((unsigned int)(grid * kClusterSize));
    if ((status = cudaLaunchKernelEx(&config, kernel, table, n_rows, width, rows_per_cta, idx, n, step, n_steps,
                                     partial)) != 0)
        return status;
    return (int)cudaGetLastError();
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

// partial: scratch of at least ceil(n / step) * 8 floats; total: one float
extern "C" int demux_cluster_gather_sum(const float* table, int64_t n_rows, int width, const int32_t* idx, int64_t n,
                                        int64_t step, float* partial, float* total, void* stream) {
    if (n_rows <= 0 || width <= 0 || n <= 0 || step <= 0) return (int)cudaErrorInvalidValue;
    const int64_t n_steps = (n + step - 1) / step;
    if (step * width > 0x7fffffff || n_rows > 0x7fffffff) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    int status, device, optin;
    if ((status = cudaGetDevice(&device)) != 0) return status;
    if ((status = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) != 0) return status;
    const size_t limit = (size_t)optin - kClusterThreads / demux::kWarpSize * sizeof(float);  // less the warp sums
    const int64_t rows_per_cta = (n_rows + kClusterSize - 1) / kClusterSize;
    const size_t shared = (size_t)rows_per_cta * width * sizeof(float);
    if (shared > limit) return kErrorTooLarge;
    if ((status = demux_check_index(idx, n, n_rows, s)) != 0) return status;
    const bool vec = width % 4 == 0 && demux::aligned16(table);
    auto kernel = vec ? cluster_gather_sum_kernel<4> : cluster_gather_sum_kernel<1>;
    if ((status = launch_clusters(kernel, shared, table, n_rows, width, (int)rows_per_cta, idx, n, step, n_steps,
                                  partial, s)) != 0)
        return status;
    return demux_sum_in_order(partial, n_steps * kClusterSize, total, s);
}
