// Row gather and gather-sum kernels for Hopper (sm_90a).
//
// Replace benchmarks/exp_kernel_gather.py's two TPU kernels:
// - _take_kernel (:39), the canary of an in-kernel row gather:
//     out[i, :] = table[idx[i], :]
//   gather_rows_kernel copies the rows bit for bit.
// - _bench_kernel (:63), the gather-rate bench, which sums the gathered rows
//   one step of `step` indices after another:
//     total = sum_i sum_w table[idx[i], w]
//   gather_sum_kernel takes one block per step and sums the step's rows in a
//   fixed order (each thread its own strided elements, then common.cuh's
//   block_sum); reduce.cu's demux_sum_in_order then adds the per-step
//   partials in a fixed order. No atomics, so two runs give the same bits.
//
// What bounds them on the H100: moving the gathered rows, N x W x 4 bytes
// read (and, for the canary, written); the table itself is read from L2
// when it fits the 50 MB cache and from HBM when it does not, so the rate
// per row is the measurement (chip_smoke.py phase 9). The design gives each
// thread 16-byte loads with neighbouring lanes on neighbouring words of a
// row (4-byte ones when rows are not 16-byte aligned), and keeps many rows
// in flight per SM. The indices are bounds-checked by checks.cu's kernel
// before the launch.
#include <type_traits>

#include "common.cuh"

int demux_check_index(const int32_t* idx, int64_t n, int64_t limit, cudaStream_t stream);

namespace {

constexpr int kThreads = 256;
constexpr int kSumThreads = 1024;

// kW: floats per load (4 or 1); width_v: the row's loads; I: the element
// index type (32 bits when n * width_v fits, so the division is cheap)
template <int kW, typename I>
__global__ void gather_rows_kernel(const float* __restrict__ table, const int32_t* __restrict__ idx, I n,
                                   I width_v, float* __restrict__ out) {
    using V = typename std::conditional<kW == 4, float4, float>::type;
    const V* src = reinterpret_cast<const V*>(table);
    V* dst = reinterpret_cast<V*>(out);
    const I total = n * width_v;
    const I stride = (I)gridDim.x * blockDim.x;
    for (I e = (I)blockIdx.x * blockDim.x + threadIdx.x; e < total; e += stride) {
        const I i = e / width_v;
        const I w = e - i * width_v;
        dst[e] = src[(int64_t)idx[i] * width_v + w];
    }
}

// block s sums the rows of indices [s * step, min((s + 1) * step, n)) into partial[s]
template <int kW>
__global__ void __launch_bounds__(kSumThreads) gather_sum_kernel(const float* __restrict__ table,
                                                                 const int32_t* __restrict__ idx, int64_t n,
                                                                 int64_t step, int width,
                                                                 float* __restrict__ partial) {
    __shared__ float warp_sums[kSumThreads / demux::kWarpSize];
    const int64_t lo = blockIdx.x * step;
    const int64_t hi = lo + step < n ? lo + step : n;
    const int width_v = width / kW;
    const int total = (int)(hi - lo) * width_v;  // the launcher keeps step * width below 2^31
    float acc = 0.f;
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
        const int i = e / width_v;
        const int w = e - i * width_v;
        acc += demux::load_sum<kW>(table + (int64_t)idx[lo + i] * width + w * kW);
    }
    const float s = demux::block_sum(acc, warp_sums);
    if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

unsigned int grid_for(int64_t n) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    const int64_t cap = 4096;  // ~31 blocks of 256 threads per SM of 132; the grid strides past that
    return (unsigned int)(blocks < cap ? blocks : cap);
}

template <int kW>
void launch_rows(const float* table, const int32_t* idx, int64_t n, int width, float* out, cudaStream_t s) {
    const int64_t width_v = width / kW;
    if (n * width_v < 0x7fffffff) {
        gather_rows_kernel<kW, uint32_t><<<grid_for(n * width_v), kThreads, 0, s>>>(
            table, idx, (uint32_t)n, (uint32_t)width_v, out);
    } else {
        gather_rows_kernel<kW, int64_t><<<grid_for(n * width_v), kThreads, 0, s>>>(table, idx, n, width_v, out);
    }
}

}  // namespace

extern "C" int demux_gather_rows(const float* table, int64_t n_rows, int width, const int32_t* idx, int64_t n,
                                 float* out, void* stream) {
    if (n_rows <= 0 || width <= 0 || n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    int status;
    if ((status = demux_check_index(idx, n, n_rows, s)) != 0) return status;
    if (width % 4 == 0 && demux::aligned16(table) && demux::aligned16(out)) {
        launch_rows<4>(table, idx, n, width, out, s);
    } else {
        launch_rows<1>(table, idx, n, width, out, s);
    }
    return (int)cudaGetLastError();
}

// partial: scratch of ceil(n / step) floats; total: one float
extern "C" int demux_gather_sum(const float* table, int64_t n_rows, int width, const int32_t* idx, int64_t n,
                                int64_t step, float* partial, float* total, void* stream) {
    if (n_rows <= 0 || width <= 0 || n <= 0 || step <= 0) return (int)cudaErrorInvalidValue;
    const int64_t n_steps = (n + step - 1) / step;
    if (n_steps > 0x7fffffff || step * width > 0x7fffffff) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    int status;
    if ((status = demux_check_index(idx, n, n_rows, s)) != 0) return status;
    if (width % 4 == 0 && demux::aligned16(table)) {
        gather_sum_kernel<4><<<(unsigned int)n_steps, kSumThreads, 0, s>>>(table, idx, n, step, width, partial);
    } else {
        gather_sum_kernel<1><<<(unsigned int)n_steps, kSumThreads, 0, s>>>(table, idx, n, step, width, partial);
    }
    if ((status = (int)cudaGetLastError()) != 0) return status;
    return demux_sum_in_order(partial, n_steps, total, s);
}
