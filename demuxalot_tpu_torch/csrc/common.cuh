// Helpers shared by the kernel sources: alignment, vector loads, the
// fixed-order block sum, and the in-order sum of per-step partials
// (reduce.cu). Every helper sums in one fixed order, so two runs of a
// kernel that uses them give the same bits.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace demux {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpSize = 32;

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Makes `device` current for the guard's lifetime where it is not already, and restores the caller's device
// after: cudaGetDevice reads a thread-local, so a launch on the current device pays no device exchange.
// status() is the first failing call's cudaError_t, 0 when the device is current.
class DeviceGuard {
  public:
    explicit DeviceGuard(int device) {
        int current = 0;
        status_ = (int)cudaGetDevice(&current);
        if (status_ == 0 && current != device) {
            status_ = (int)cudaSetDevice(device);
            if (status_ == 0) saved_ = current;
        }
    }
    ~DeviceGuard() {
        if (saved_ >= 0) cudaSetDevice(saved_);
    }
    DeviceGuard(const DeviceGuard&) = delete;
    DeviceGuard& operator=(const DeviceGuard&) = delete;
    int status() const { return status_; }

  private:
    int saved_ = -1;
    int status_ = 0;
};

// the sum of kW floats at p (kW = 4: one 16-byte load; kW = 1: one float)
template <int kW>
__device__ __forceinline__ float load_sum(const float* p) {
    if constexpr (kW == 4) {
        const float4 v = *reinterpret_cast<const float4*>(p);
        return (v.x + v.y) + (v.z + v.w);
    } else {
        return *p;
    }
}

// block-wide sum in a fixed order (a shuffle tree in each warp, then the
// warps in order); thread 0 holds the result. warp_sums holds blockDim.x / 32
// floats; every thread of the block calls it.
__device__ __forceinline__ float block_sum(float acc, float* warp_sums) {
#pragma unroll
    for (int o = kWarpSize / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(kFullMask, acc, o);
    if (threadIdx.x % kWarpSize == 0) warp_sums[threadIdx.x / kWarpSize] = acc;
    __syncthreads();
    float s = 0.f;
    if (threadIdx.x == 0) {
        for (int w = 0; w < (int)(blockDim.x / kWarpSize); ++w) s += warp_sums[w];
    }
    return s;
}

}  // namespace demux

// *total = partial[0] + ... + partial[n - 1] in a fixed order, on one block (reduce.cu)
int demux_sum_in_order(const float* partial, int64_t n, float* total, cudaStream_t stream);
