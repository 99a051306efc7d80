// The tiny kernel for Hopper (sm_90a).
//
// Replaces benchmarks/exp_gather_operand.py's tiny_kernel (:108, in phase3),
// o = x * 2 on f32 [8, 128], which the TPU harness puts in the same program
// as an XLA gather and the E-step to see whether a kernel beside the gather
// slows it. What bounds it on the H100: the bytes, 4 KB read and 4 KB
// written (>= 2.4 ns at 3.35 TB/s); a launch takes microseconds, so the
// launch is the time. The design is the plainest: one thread per element,
// one block of 256 threads per 256 elements.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void tiny_kernel(const float* __restrict__ x, int64_t n, float* __restrict__ out) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) out[i] = x[i] * 2.0f;
}

}  // namespace

extern "C" int demux_tiny(const float* x, int64_t n, float* out, void* stream) {
    if (n < 0 || (n + kThreads - 1) / kThreads > 0x7fffffff) return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    tiny_kernel<<<(unsigned int)((n + kThreads - 1) / kThreads), kThreads, 0, (cudaStream_t)stream>>>(x, n, out);
    return (int)cudaGetLastError();
}
