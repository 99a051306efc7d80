// Bounds checks of the kernels' index inputs, for Hopper (sm_90a).
//
// The E-step and M-step entry points run these small kernels on the same
// stream just before their main kernel, so an out-of-range index or a
// malformed CSR traps before anything reads through it. They are separate
// kernels because a __trap inside the hot kernels cost the E-step 3-11% of
// its time on the H100 wherever it sat (the branch keeps the compiler from
// batching the loads around it); here they cost one read of each index
// array, which stays in L2 for the main kernel.
#include <cuda_runtime.h>
#include <stdint.h>

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

// Host launchers used by likelihood.cu and mstep.cu; each returns cudaGetLastError().
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
