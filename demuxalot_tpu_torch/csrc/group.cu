// Group-G E-step kernel for Hopper (sm_90a).
//
// Replaces benchmarks/exp_group.py:_group_kernel (:123, via group_logits
// :188), the TPU's E-step that pads each barcode's calls to a multiple of G
// and sums the logs of each group of G calls before its one-hot scatter,
// so the scatter contracts 128 group columns instead of TC calls. Here the
// calls come in the group layout of experiments/group_estep.py:group_layout
// (barcode CSR, each barcode's calls padded with q = 1 slots to a multiple
// of G; group h of a barcode is its calls [h * G, (h + 1) * G)), folded to U
// (call-major f32 [n_calls, n_donors]; a padding slot has U = 1). For every
// barcode b and column g:
//
//   args[c, g]   = sum_k 0.5 * (word_k(U)[c, i_g] + word_k(U)[c, j_g])     k < n_words, in word order
//   gsum[h, g]   = sum_{calls c of group h, in order} log(max(args[c, g], 1e-30))
//   logits[b, g] = pen[g] + sum_{groups h of b, in order} words(gsum[h, g])  kept to n_words bf16 words
//
// n_words 0 is full f32 (the TPU's HIGHEST dots); word_k as split.cu makes
// them (round to nearest even). use_log off sums the arguments (nolog).
//
// What bounds it on the H100: one log per (call, column) of the padded
// calls, as the TPU kernel takes it (on the MUFU unit, but through logf at
// one word: see log_of), and the instructions around it:
// n_words loads and adds per donor of the pair. Grouping saves nothing here,
// since the scatter is a lane's running sum rather than a matrix product; the
// padding slots (about G / 2 per barcode) add their terms. The design: one
// warp per barcode; the warp stages the words of a 32-call tile of U (whole
// groups, G divides 32) in shared memory; lane l walks columns l, l + 32,
// ... over the tile's groups, its running sums kept in a staged row of the
// barcode's logits in shared memory. Each column's sum is one lane's, in
// group and call order, with no atomics: two runs give the same bits. row_ptr
// and the pairs are bounds-checked by checks.cu's kernels before the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

int demux_check_index(const int32_t* idx, int64_t n, int64_t limit, cudaStream_t stream);
int demux_check_csr(const int64_t* row_ptr, int64_t n_rows, int64_t n_entries, cudaStream_t stream);

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 4;       // warps (barcodes) per block
constexpr int kTileCalls = 32;  // calls staged at a time; G divides it
constexpr int kMaxWords = 2;

constexpr float kLn2 = 0.693147180559945309f;

__device__ __forceinline__ float lg2_approx(float x) {
    float y;
    asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ float bf16_round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// a call's log: logf where the group sum is kept to one bf16 word (its bits are torch.log's, and the
// MUFU log's last-bit differences would move the word by 2^-8 where they cross a rounding boundary),
// the MUFU log2 scaled by ln 2 otherwise
template <int kWords>
__device__ __forceinline__ float log_of(float x) {
    if constexpr (kWords == 1) {
        return logf(x);
    } else {
        return lg2_approx(x) * kLn2;
    }
}

// x kept to kWords bf16 words: the words' sum in word order
template <int kWords>
__device__ __forceinline__ float round_words(float x) {
    if constexpr (kWords == 0) {
        return x;
    } else {
        float total = bf16_round(x);
        float rem = x - total;
#pragma unroll
        for (int k = 1; k < kWords; ++k) {
            const float word = bf16_round(rem);
            total += word;
            rem -= word;
        }
        return total;
    }
}

__host__ __device__ constexpr int planes(int words) { return words > 0 ? words : 1; }

template <int kWords, bool kLog>
__global__ void __launch_bounds__(kWarps * kWarp) group_kernel(
    const float* __restrict__ u,          // [n_calls, n_donors], the group layout's calls
    int n_donors,
    const int64_t* __restrict__ row_ptr,  // [n_barcodes + 1], counts multiples of group
    int64_t n_barcodes, int group,
    const int32_t* __restrict__ pairs,    // [2, n_pg]
    const float* __restrict__ penalties,  // [n_pg]
    int n_pg, int row_floats,             // row_floats: n_pg rounded up to 4
    float* __restrict__ logits)           // [n_barcodes, n_pg]
{
    extern __shared__ __align__(16) float smem[];
    const int lane = threadIdx.x % kWarp;
    const int warp = threadIdx.x / kWarp;
    const int64_t b = (int64_t)blockIdx.x * kWarps + warp;
    if (b >= n_barcodes) return;  // the whole warp; nothing below synchronises the block
    const int plane = kTileCalls * n_donors;
    float* row = smem + (size_t)warp * (row_floats + planes(kWords) * plane);
    float* words = row + row_floats;  // [planes][kTileCalls][n_donors]
    for (int g = lane; g < n_pg; g += kWarp) row[g] = 0.f;
    const int64_t lo = row_ptr[b], hi = row_ptr[b + 1];
    for (int64_t t0 = lo; t0 < hi; t0 += kTileCalls) {
        const int nt = (int)(hi - t0 < kTileCalls ? hi - t0 : kTileCalls);
        const float* src = u + t0 * n_donors;
        __syncwarp();  // every lane is done with the last tile
        for (int e = lane; e < nt * n_donors; e += kWarp) {
            float x = src[e];
            if constexpr (kWords == 0) {
                words[e] = x;
            } else {
#pragma unroll
                for (int k = 0; k < kWords; ++k) {
                    const float word = bf16_round(x);
                    words[k * plane + e] = word;
                    x -= word;
                }
            }
        }
        __syncwarp();
        for (int g = lane; g < n_pg; g += kWarp) {
            const int i = pairs[g], j = pairs[n_pg + g];
            float sum = row[g];
            for (int c0 = 0; c0 < nt; c0 += group) {
                const int c1 = c0 + group < nt ? c0 + group : nt;  // a whole group in a valid layout
                float gsum = 0.f;
                for (int c = c0; c < c1; ++c) {
                    const float* w = words + c * n_donors;
                    float a = 0.5f * (w[i] + w[j]);
#pragma unroll
                    for (int k = 1; k < kWords; ++k) a += 0.5f * (w[k * plane + i] + w[k * plane + j]);
                    gsum += kLog ? log_of<kWords>(fmaxf(a, 1e-30f)) : a;
                }
                sum += round_words<kWords>(gsum);
            }
            row[g] = sum;
        }
    }
    float* out = logits + b * n_pg;
    for (int g = lane; g < n_pg; g += kWarp) out[g] = penalties[g] + row[g];
}

using Kernel = decltype(&group_kernel<0, true>);

template <bool kLog>
Kernel pick(int n_words) {
    return n_words == 0 ? &group_kernel<0, kLog> : n_words == 1 ? &group_kernel<1, kLog> : &group_kernel<2, kLog>;
}

}  // namespace

// u: the folded calls of the group layout [n_calls, n_donors]; group divides 32;
// n_words in 0..2 (0: full f32)
extern "C" int demux_group_logits(const float* u, int64_t n_calls, int n_donors, const int64_t* row_ptr,
                                  int64_t n_barcodes, int group, const int32_t* pairs, const float* penalties,
                                  int n_pg, float* logits, int n_words, int use_log, void* stream) {
    if (n_barcodes <= 0 || n_pg <= 0 || n_donors <= 0 || group < 1 || kTileCalls % group != 0 || n_words < 0 ||
        n_words > kMaxWords)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    int status;
    if ((status = demux_check_csr(row_ptr, n_barcodes, n_calls, s)) != 0) return status;
    if ((status = demux_check_index(pairs, 2 * (int64_t)n_pg, n_donors, s)) != 0) return status;
    const int row_floats = (n_pg + 3) & ~3;
    const size_t shared =
        (size_t)kWarps * (row_floats + (size_t)planes(n_words) * kTileCalls * n_donors) * sizeof(float);
    int device, optin;
    if ((status = cudaGetDevice(&device)) != 0) return status;
    if ((status = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) != 0) return status;
    if (shared > (size_t)optin) return (int)cudaErrorInvalidValue;
    const Kernel kernel = use_log ? pick<true>(n_words) : pick<false>(n_words);
    if ((status = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared)) != 0)
        return status;
    const unsigned int grid = (unsigned int)((n_barcodes + kWarps - 1) / kWarps);
    kernel<<<grid, kWarps * kWarp, shared, s>>>(u, n_donors, row_ptr, n_barcodes, group, pairs, penalties, n_pg,
                                                 row_floats, logits);
    return (int)cudaGetLastError();
}
