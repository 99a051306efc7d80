// In-kernel gather forms for Hopper (sm_90a).
//
// Replace benchmarks/exp_gather_forms.py's TPU kernels:
// - the run_form kernels (:38) with main's lambdas for forms C, D, D2
//   (take_along_axis(axis=0) with 2-D indices, :88-125) and E, E2 (the lane
//   gather, take_along_axis(axis=1), :127-155). take_along_axis_kernel
//   computes
//     axis 0: out[i, j] = table[idx[i, j], j]
//     axis 1: out[i, j] = table[i, idx[i, j]]
//   bit for bit, one thread per output element: the index read coalesced,
//   the element read from wherever it lies (L1/L2 for these tables, 0.5-4 MB).
//   Forms A and B, jnp.take(axis=0) with 1-D indices, are gather.cu's
//   gather_rows. What bounds it: the bytes, each index read once, each
//   touched table element once, each output written once (12.6 MB at D2's
//   [8192, 128], >= 3.8 us); at these sizes the launch dominates.
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
// The indices are bounds-checked by checks.cu's kernel before each launch.
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

template <int kAxis>
__global__ void take_along_axis_kernel(const float* __restrict__ table, int64_t ld, const int32_t* __restrict__ idx,
                                       int64_t n, int cols, float* __restrict__ out) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n; e += stride) {
        const int64_t i = e / cols;
        const int64_t j = e - i * cols;
        const int64_t k = idx[e];
        out[e] = kAxis == 0 ? table[k * ld + j] : table[i * ld + k];
    }
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
                                     int64_t rows_out, int64_t cols_out, int axis, float* out, void* stream) {
    if (n_rows <= 0 || n_cols <= 0 || rows_out < 0 || cols_out <= 0 || cols_out > 0x7fffffff ||
        (axis != 0 && axis != 1))
        return (int)cudaErrorInvalidValue;
    const int64_t n = rows_out * cols_out;
    if (n == 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    int status;
    if ((status = demux_check_index(idx, n, axis == 0 ? n_rows : n_cols, s)) != 0) return status;
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    const unsigned int grid = (unsigned int)(blocks < 4096 ? blocks : 4096);
    if (axis == 0) {
        take_along_axis_kernel<0><<<grid, kThreads, 0, s>>>(table, n_cols, idx, n, (int)cols_out, out);
    } else {
        take_along_axis_kernel<1><<<grid, kThreads, 0, s>>>(table, n_cols, idx, n, (int)cols_out, out);
    }
    return (int)cudaGetLastError();
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
