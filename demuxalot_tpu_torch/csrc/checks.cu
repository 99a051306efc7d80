// Bounds checks of the kernels' index inputs, for Hopper (sm_90a).
//
// Entry points run these small kernels on the same stream just before their
// main kernel, so an out-of-range index or a malformed CSR traps before
// anything reads through it; the M-step's operands, the split, group and
// folded E-steps' and the banded E-step's and M-step's are checked once
// instead, when they are built. They are separate
// kernels because a __trap inside the hot kernels cost the E-step 3-11% of
// its time on the H100 wherever it sat (the branch keeps the compiler from
// batching the loads around it); here they cost one read of each index
// array, which stays in L2 for the main kernel.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1024;

// every idx[i] lies in [0, limit)
__global__ void check_index_kernel(const int32_t* __restrict__ idx, int64_t n, int64_t limit) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        const int64_t v = idx[i];
        if (v < 0 || v >= limit) __trap();
    }
}

// row_ptr[0] >= 0, row_ptr is non-decreasing, row_ptr[n_rows] <= n_entries
__global__ void check_csr_kernel(const int64_t* __restrict__ row_ptr, int64_t n_rows, int64_t n_entries) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_rows; i += stride) {
        const int64_t lo = row_ptr[i];
        const int64_t hi = row_ptr[i + 1];
        if (lo < 0 || hi < lo || hi > n_entries) __trap();
    }
}

// band-local ids: the calls of band k = blockIdx.y, [band_ptr[k][0],
// band_ptr[k][n_rows]) of a band-major [n_bands, n_rows + 1] CSR, lie in
// [0, min(edges[k + 1] - edges[k], cap))
__global__ void check_banded_index_kernel(const int32_t* __restrict__ idx, const int64_t* __restrict__ band_ptr,
                                          const int64_t* __restrict__ edges, int64_t n_rows, int64_t cap) {
    const int64_t k = blockIdx.y;
    const int64_t lo = band_ptr[k * (n_rows + 1)];
    const int64_t hi = band_ptr[k * (n_rows + 1) + n_rows];
    const int64_t height = edges[k + 1] - edges[k];
    const int64_t limit = height < cap ? height : cap;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = lo + (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < hi; i += stride) {
        const int64_t v = idx[i];
        if (v < 0 || v >= limit) __trap();
    }
}

// the E-step schedule, entries of `entry` ints: donor blocks of 4 (quad p,
// q) in [0, n_blocks), donor blocks of 2 (duo r, s) in [0, 2 n_blocks), then
// one output column per slot in [-1, n_pg) (-1: unused)
__global__ void check_schedule_kernel(const int32_t* __restrict__ schedule, int64_t n, int entry, int n_blocks,
                                      int n_pg) {
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        const int64_t field = i % entry;
        const int64_t v = schedule[i];
        const int64_t lo = field < 4 ? 0 : -1;
        const int64_t hi = field < 2 ? n_blocks : field < 4 ? 2 * (int64_t)n_blocks : n_pg;
        if (v < lo || v >= hi) __trap();
    }
}

unsigned int blocks_for(int64_t n) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    return (unsigned int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

// Host launchers used by likelihood.cu, mstep.cu and gather.cu, and by demux_variant_check and
// demux_banded_check below; each returns cudaGetLastError().
int demux_check_index(const int32_t* idx, int64_t n, int64_t limit, cudaStream_t stream) {
    if (n > 0) check_index_kernel<<<blocks_for(n), kThreads, 0, stream>>>(idx, n, limit);
    return (int)cudaGetLastError();
}

int demux_check_schedule(const int32_t* schedule, int64_t n_entries, int entry, int n_blocks, int n_pg,
                         cudaStream_t stream) {
    if (n_entries > 0) {
        check_schedule_kernel<<<blocks_for(n_entries), kThreads, 0, stream>>>(schedule, n_entries, entry, n_blocks,
                                                                               n_pg);
    }
    return (int)cudaGetLastError();
}

int demux_check_csr(const int64_t* row_ptr, int64_t n_rows, int64_t n_entries, cudaStream_t stream) {
    if (n_rows > 0) check_csr_kernel<<<blocks_for(n_rows), kThreads, 0, stream>>>(row_ptr, n_rows, n_entries);
    return (int)cudaGetLastError();
}

// run after demux_check_csr of edges and of the flattened band_ptr
int demux_check_banded_index(const int32_t* idx, const int64_t* band_ptr, const int64_t* edges, int n_bands,
                             int64_t n_rows, int64_t cap, int64_t n_entries, cudaStream_t stream) {
    if (n_entries > 0 && n_bands > 0) {
        const unsigned int per_band = (blocks_for(n_entries) + n_bands - 1) / n_bands;
        const dim3 grid(per_band, (unsigned int)n_bands);
        check_banded_index_kernel<<<grid, kThreads, 0, stream>>>(idx, band_ptr, edges, n_rows, cap);
    }
    return (int)cudaGetLastError();
}

// The split and group E-steps' operands, checked once when they are built (experiments/folded_estep.py:
// variant_operands, group_estep.py:group_layout): row_ptr a CSR over n_calls, every pair in [0, n_donors),
// and the group kernel's tile schedule (null for split) as demux_check_schedule takes it.
extern "C" int demux_variant_check(const int64_t* row_ptr, int64_t n_barcodes, int64_t n_calls, const int32_t* pairs,
                                   int n_pg, int n_donors, const int32_t* schedule, int n_passes, int entry,
                                   int device, void* stream) {
    if (n_barcodes < 0 || n_pg <= 0 || n_donors <= 0 || n_passes < 0 || entry <= 4) return (int)cudaErrorInvalidValue;
    const demux::DeviceGuard guard(device);
    if (guard.status() != 0) return guard.status();
    cudaStream_t s = (cudaStream_t)stream;
    int status;
    if ((status = demux_check_csr(row_ptr, n_barcodes, n_calls, s)) != 0) return status;
    if ((status = demux_check_index(pairs, 2 * (int64_t)n_pg, n_donors, s)) != 0) return status;
    if (schedule == nullptr) return 0;
    return demux_check_schedule(schedule, (int64_t)n_passes * demux::kWarpSize * entry, entry, (n_donors + 3) / 4,
                                n_pg, s);
}

// The banded E-step's and M-step's operands, checked once when they are built (experiments/inkernel_gather.py:
// banded_estep_operands, banded_mstep_operands): band_edges non-decreasing in [0, n_rows] (the rows of the table
// the band-local ids index: G's variants or the posterior's barcodes), the band-major band_ptr [n_bands,
// n_groups + 1] non-decreasing in [0, n_calls], every band-local idx in [0, its band's height), and the E-step's
// tile schedule (null for the M-step) as demux_check_schedule takes it.
extern "C" int demux_banded_check(const int64_t* band_edges, int n_bands, int64_t n_rows, const int64_t* band_ptr,
                                  int64_t n_groups, int64_t n_calls, const int32_t* idx, const int32_t* schedule,
                                  int n_passes, int entry, int n_donors, int n_pg, int device, void* stream) {
    if (n_bands <= 0 || n_groups < 0 || n_calls < 0 || n_passes < 0 || entry <= 4) return (int)cudaErrorInvalidValue;
    const demux::DeviceGuard guard(device);
    if (guard.status() != 0) return guard.status();
    cudaStream_t s = (cudaStream_t)stream;
    int status;
    if ((status = demux_check_csr(band_edges, n_bands, n_rows, s)) != 0) return status;
    if ((status = demux_check_csr(band_ptr, (int64_t)n_bands * (n_groups + 1) - 1, n_calls, s)) != 0) return status;
    if ((status = demux_check_banded_index(idx, band_ptr, band_edges, n_bands, n_groups, INT64_MAX, n_calls, s)) != 0)
        return status;
    if (schedule == nullptr) return 0;
    return demux_check_schedule(schedule, (int64_t)n_passes * demux::kWarpSize * entry, entry, (n_donors + 3) / 4,
                                n_pg, s);
}
