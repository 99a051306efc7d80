// The in-order sum of per-step partials, shared by the gather-sum
// (gather.cu), the streams (stream.cu) and the cluster gather-sum (forms.cu).
// One block: each thread adds a contiguous run of partials in order, then the
// block sums the threads' runs in a fixed order. No atomics, so two runs give
// the same bits.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads) sum_in_order_kernel(const float* __restrict__ partial, int64_t n,
                                                                float* __restrict__ total) {
    __shared__ float warp_sums[kThreads / demux::kWarpSize];
    const int64_t run = (n + kThreads - 1) / kThreads;
    const int64_t lo = run * threadIdx.x;
    const int64_t hi = lo + run < n ? lo + run : n;
    float acc = 0.f;
    for (int64_t i = lo; i < hi; ++i) acc += partial[i];
    const float s = demux::block_sum(acc, warp_sums);
    if (threadIdx.x == 0) *total = s;
}

}  // namespace

int demux_sum_in_order(const float* partial, int64_t n, float* total, cudaStream_t stream) {
    sum_in_order_kernel<<<1, kThreads, 0, stream>>>(partial, n, total);
    return (int)cudaGetLastError();
}
