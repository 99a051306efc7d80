// Banded M-step addition kernel for Hopper (sm_90a).
//
// Replaces benchmarks/inkernel_gather_kernels.py:_mstep_kernel_ig (:252),
// the TPU's in-kernel posterior-gather M-step. The barcodes are cut into K
// bands (edges[k], edges[k + 1]); the power table posterior[:, :D]^p is
// stacked band by band into [K * band_rows, D] (band_rows: the tallest band
// rounded up to 4, padding rows 0; ops: experiments/inkernel_gather.py:
// banded_table), each call carries a band-local barcode and q2 = (1 - q)^p
// (exactly 0 for q >= 1), and the calls lie band-major, a variant CSR per
// band (band_ptr [K, n_variants + 1]). For every variant v and donor d:
//
//   addition[v, d] = sum_k sum_{calls c of v in band k} table[k * band_rows + cb_c, d] * q2_c,
//
// summed in band order, then in call order.
//
// What bounds it on the H100: the mainline M-step (mstep.cu) reads one
// random posterior row per call from L2. Here the TPU's idea carries over,
// because a variant's running sums are only D floats: a block keeps one band
// of the table in shared memory (at most the card's 227 KB opt-in, less the
// sums) and its variants' sums beside it. Each block owns a contiguous chunk
// of at most 1,024 variants (32 per warp, a warp's variants contiguous) and
// walks the bands in order: it stages band k with cp.async (16-byte copies
// where the table allows), while each warp loads its variants' band-k row
// pointers in one coalesced read; then each warp walks its variants' calls
// of band k in tiles of 32 (cb and q2 coalesced into lanes, broadcast by
// shuffles) and adds table rows from shared memory into its sums in shared
// memory, lanes over donors. So every call's row read is a shared-memory
// read, and the price is that every block stages the whole table once per
// chunk of variants (K bands x band_rows x D x 4 bytes from L2), plus the
// K x (V + 1) row pointers. No atomics: one warp owns a variant's sums, so
// two runs give the same bits. The index inputs are bounds-checked by
// checks.cu's kernels before the launch.
#include "common.cuh"

int demux_check_csr(const int64_t* row_ptr, int64_t n_rows, int64_t n_entries, cudaStream_t stream);
int demux_check_banded_index(const int32_t* idx, const int64_t* band_ptr, const int64_t* edges, int n_bands,
                             int64_t n_rows, int64_t cap, int64_t n_entries, cudaStream_t stream);

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kWarps = 32;  // warps per block
constexpr int kMaxChunkVariants = kWarp * kWarps;

template <bool kVec>
__device__ __forceinline__ void stage(float* dst, const float* src, int64_t n_floats) {
    if constexpr (kVec) {
        for (int64_t i = 4 * (int64_t)threadIdx.x; i < n_floats; i += 4 * (int64_t)blockDim.x) {
            const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst + i));
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src + i) : "memory");
        }
    } else {
        for (int64_t i = threadIdx.x; i < n_floats; i += blockDim.x) {
            const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst + i));
            asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src + i) : "memory");
        }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// kVec: the table and its bands are 16-byte aligned (band_rows * D % 4 == 0)
template <bool kVec>
__global__ void __launch_bounds__(kWarp * kWarps, 1) mstep_banded_kernel(
    const float* __restrict__ table,       // [n_bands * band_rows, n_donors]
    int n_bands, int band_rows, int n_donors,
    const int64_t* __restrict__ band_ptr,  // [n_bands, n_variants + 1]
    const int32_t* __restrict__ cb,        // [n_calls], band-major, band-local
    const float* __restrict__ q2,          // [n_calls]
    int64_t n_variants, int chunk_variants,
    float* __restrict__ addition)          // [n_variants, n_donors]
{
    extern __shared__ __align__(16) float smem[];
    float* band = smem;                                    // band_rows * n_donors
    float* sums = smem + (int64_t)band_rows * n_donors;    // chunk_variants * n_donors
    const int lane = threadIdx.x % kWarp;
    const int warp = threadIdx.x / kWarp;
    const int per_warp = (chunk_variants + kWarps - 1) / kWarps;  // <= 32
    const int64_t band_floats = (int64_t)band_rows * n_donors;
    const int64_t n_chunks = (n_variants + chunk_variants - 1) / chunk_variants;

    for (int64_t chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
        const int64_t v0 = chunk * chunk_variants;
        const int nv = (int)(n_variants - v0 < chunk_variants ? n_variants - v0 : chunk_variants);
        for (int i = threadIdx.x; i < nv * n_donors; i += blockDim.x) sums[i] = 0.f;
        // this warp's variants: [first, first + count) of the chunk
        const int first = warp * per_warp;
        const int count = first < nv ? (nv - first < per_warp ? nv - first : per_warp) : 0;
        for (int k = 0; k < n_bands; ++k) {
            __syncthreads();  // every warp is done with band k - 1 (and the zeroed sums are visible)
            stage<kVec>(band, table + k * band_floats, band_floats);
            // the row pointers while the band lands: lane j holds the start of variant j, all lanes its end
            const int64_t* ptr = band_ptr + k * (n_variants + 1) + v0 + first;
            const int64_t start = lane < count ? ptr[lane] : 0;
            const int64_t end = count > 0 ? ptr[count] : 0;
            asm volatile("cp.async.wait_all;\n" ::: "memory");
            __syncthreads();  // band k is in shared memory
            if (count == 0) continue;
            const int64_t lo = __shfl_sync(kFull, start, 0);
            int j = 0;  // the variant of the call at hand
            int64_t j_end = count > 1 ? __shfl_sync(kFull, start, 1) : end;
            for (int64_t t = lo; t < end; t += kWarp) {
                const int n = (int)(end - t < kWarp ? end - t : kWarp);
                const int my_cb = lane < n ? cb[t + lane] : 0;
                const float my_q2 = lane < n ? q2[t + lane] : 0.f;
                for (int i = 0; i < n; ++i) {
                    const int row = __shfl_sync(kFull, my_cb, i);
                    const float w = __shfl_sync(kFull, my_q2, i);
                    while (t + i >= j_end) {  // warp-uniform: the calls are variant-sorted
                        ++j;
                        const int64_t next = __shfl_sync(kFull, start, (j + 1) & (kWarp - 1));
                        j_end = j + 1 < count ? next : end;
                    }
                    float* acc = sums + (int64_t)(first + j) * n_donors;
                    const float* src = band + (int64_t)row * n_donors;
                    for (int d = lane; d < n_donors; d += kWarp) acc[d] += src[d] * w;
                }
            }
        }
        __syncthreads();  // every warp's sums are final
        float* out = addition + v0 * n_donors;
        for (int i = threadIdx.x; i < nv * n_donors; i += blockDim.x) out[i] = sums[i];
        __syncthreads();  // the sums are read before the next chunk zeroes them
    }
}

int shared_optin(int* optin, int* n_sms) {
    int device, status;
    if ((status = cudaGetDevice(&device)) != 0) return status;
    if ((status = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) != 0) return status;
    return cudaDeviceGetAttribute(n_sms, cudaDevAttrMultiProcessorCount, device);
}

}  // namespace

extern "C" int demux_mstep_addition_banded(
    const float* table, int n_bands, int band_rows, int n_donors,
    const int64_t* band_edges, int64_t n_barcodes,
    const int64_t* band_ptr, int64_t n_calls, const int32_t* cb, const float* q2, int64_t n_variants,
    float* addition, void* stream)
{
    if (n_variants <= 0 || n_donors <= 0 || n_bands <= 0 || band_rows <= 0) return (int)cudaErrorInvalidValue;
    int optin, n_sms, status;
    if ((status = shared_optin(&optin, &n_sms)) != 0) return status;
    const int64_t band_bytes = (int64_t)band_rows * n_donors * sizeof(float);
    const int64_t row_bytes = (int64_t)n_donors * sizeof(float);
    // one chunk per SM where the sums fit beside the band, else as many variants as fit
    int64_t chunk = (n_variants + n_sms - 1) / n_sms;
    if (chunk > kMaxChunkVariants) chunk = kMaxChunkVariants;
    if (band_bytes + chunk * row_bytes > optin) chunk = (optin - band_bytes) / row_bytes;
    // a band does not fit in shared memory: the one refusal that returns this code
    // past the argument checks above (the wrapper raises it as a ValueError)
    if (chunk < 1) return (int)cudaErrorInvalidValue;
    const size_t shared = (size_t)(band_bytes + chunk * row_bytes);
    const int64_t n_chunks = (n_variants + chunk - 1) / chunk;

    cudaStream_t s = (cudaStream_t)stream;
    if ((status = demux_check_csr(band_edges, n_bands, n_barcodes, s)) != 0) return status;
    if ((status = demux_check_csr(band_ptr, (int64_t)n_bands * (n_variants + 1) - 1, n_calls, s)) != 0) return status;
    if ((status = demux_check_banded_index(cb, band_ptr, band_edges, n_bands, n_variants, band_rows, n_calls, s)) != 0)
        return status;

    const bool vec = demux::aligned16(table) && band_rows % 4 == 0;
    using Kernel = decltype(&mstep_banded_kernel<true>);
    const Kernel kernel = vec ? mstep_banded_kernel<true> : mstep_banded_kernel<false>;
    if ((status = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared)) != 0)
        return status;
    const int64_t grid = n_chunks < n_sms ? n_chunks : n_sms;
    kernel<<<(unsigned int)grid, kWarp * kWarps, shared, s>>>(table, n_bands, band_rows, n_donors, band_ptr, cb, q2,
                                                              n_variants, (int)chunk, addition);
    return (int)cudaGetLastError();
}
