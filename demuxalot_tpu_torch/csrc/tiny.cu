// The tiny kernel for Hopper (sm_90a).
//
// Replaces benchmarks/exp_gather_operand.py's tiny_kernel (:108, in phase3),
// o = x * 2 on f32 [8, 128], which the TPU harness puts in the same program
// as an XLA gather and the E-step to see whether a kernel beside the gather
// slows it. What bounds it on the H100: the bytes, 4 KB read and 4 KB
// written (>= 2.4 ns at 3.35 TB/s); a launch takes microseconds, so the
// launch is the time, and on the host the path to it. The design: [8, 128]
// is one block of 256 threads, each with one 16-byte load and one 16-byte
// store (any size takes ceil(n / 1024) such blocks, the n % 4 tail on the
// first threads); x or out off a 16-byte boundary takes the scalar kernel,
// one float per thread. The entry takes the device index and makes that
// device current only where it is not (common.cuh's DeviceGuard), so the
// wrapper needs no Python device guard and no stream object (ops/_cuda.py's
// Entry keeps the ctypes function). Measured (NVIDIA H100 80GB HBM3, 700.00
// W, chip_smoke.py phase 11d, in turns with torch.mul(x, 2.0)): 100 calls
// in a CUDA graph take 0.00122 ms a call against torch.mul's 0.00120 (the
// launch floor); eagerly 0.0159 ms against 0.0137, the host issuing a call
// in 12.5 us against torch.mul's 10.5.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kVec>
__global__ void __launch_bounds__(kThreads) tiny_kernel(const float* __restrict__ x, int64_t n,
                                                        float* __restrict__ out) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if constexpr (kVec) {
        const int64_t quads = n / 4;
        if (t < quads) {
            float4 v = reinterpret_cast<const float4*>(x)[t];
            v.x *= 2.0f;
            v.y *= 2.0f;
            v.z *= 2.0f;
            v.w *= 2.0f;
            reinterpret_cast<float4*>(out)[t] = v;
        }
        if (t < n % 4) out[quads * 4 + t] = x[quads * 4 + t] * 2.0f;
    } else {
        if (t < n) out[t] = x[t] * 2.0f;
    }
}

}  // namespace

extern "C" int demux_tiny(const float* x, int64_t n, float* out, int device, void* stream) {
    if (n < 0 || (n + kThreads - 1) / kThreads > 0x7fffffff) return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    const demux::DeviceGuard guard(device);
    if (guard.status() != 0) return guard.status();
    cudaStream_t s = (cudaStream_t)stream;
    if (demux::aligned16(x) && demux::aligned16(out)) {
        const int64_t threads = n / 4 > 0 ? n / 4 : 1;
        tiny_kernel<true><<<(unsigned int)((threads + kThreads - 1) / kThreads), kThreads, 0, s>>>(x, n, out);
    } else {
        tiny_kernel<false><<<(unsigned int)((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(x, n, out);
    }
    return (int)cudaGetLastError();
}
