// Folded E-step kernel for Hopper (sm_90a).
//
// Replaces benchmarks/exp_estep.py:_folded_kernel (:40, via folded_logits
// :132), the TPU's E-step over calls folded before the doublet expansion.
// The fold U[c, d] = G[vid_c, d] * (1 - q_c) + max(q_c, 1e-4) runs as torch
// ops before the launch (experiments/folded_estep.py:fold_calls), so this
// kernel reads U, call-major f32 [n_calls, n_donors] in barcode CSR form,
// and for every barcode b and column g computes
//
//   logits[b, g] = pen[g] + sum_{calls c of b} log(0.5 * (U[c, i_g] + U[c, j_g]))
//
// (i_g, j_g) is column g's donor pair, i == j for a singlet, so the argument
// is the mixing column's sum 1/2 U_i + 1/2 U_j bit for bit (halving is
// exact). A padding call (q = 1) has U = 1, an argument of 1 and a log of 0.
// With use_log off it sums the arguments (the TPU file's nolog ablation).
//
// What bounds it on the H100: one log per (call, column), as the TPU kernel
// takes it, on the MUFU unit (lg2.approx, 16 results per clock per SM), and
// the instructions of the two shared-memory loads and three arithmetic steps
// around each log: 2.2 G terms at the JAX harness's shape (4,194,304 calls x
// 528 columns) is >= 0.53 ms of MUFU alone, where the mainline E-step
// (likelihood.cu) multiplies 8 arguments per log. Reading U (537 MB at that
// shape) is >= 0.16 ms of HBM and overlaps the logs. The design:
// - One warp per barcode. The warp copies a tile of 32 calls' U rows
//   (contiguous in U) into its shared memory with coalesced loads, then each
//   lane walks its columns (g = lane, lane + 32, ...) over the tile's calls
//   in call order, its running sums kept in a staged row of the barcode's
//   logits in shared memory, so U is read once whatever the column count.
// - log2 on the MUFU unit, the sum scaled by ln 2 once at the end.
// Each column's sum is one lane's, in call order, with no atomics: two runs
// give the same bits. row_ptr and the pairs are bounds-checked by checks.cu's
// kernels before the launch.
#include <cuda_runtime.h>
#include <stdint.h>

int demux_check_index(const int32_t* idx, int64_t n, int64_t limit, cudaStream_t stream);
int demux_check_csr(const int64_t* row_ptr, int64_t n_rows, int64_t n_entries, cudaStream_t stream);

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 4;       // warps (barcodes) per block
constexpr int kTileCalls = 32;  // calls of U staged at a time
constexpr float kLn2 = 0.693147180559945309f;

__device__ __forceinline__ float lg2_approx(float x) {
    float y;
    asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

template <bool kLog>
__global__ void __launch_bounds__(kWarps * kWarp) folded_kernel(
    const float* __restrict__ u,          // [n_calls, n_donors]
    int n_donors,
    const int64_t* __restrict__ row_ptr,  // [n_barcodes + 1]
    int64_t n_barcodes,
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
    float* row = smem + (size_t)warp * (row_floats + kTileCalls * n_donors);
    float* tile = row + row_floats;
    for (int g = lane; g < n_pg; g += kWarp) row[g] = 0.f;
    const int64_t lo = row_ptr[b], hi = row_ptr[b + 1];
    for (int64_t t0 = lo; t0 < hi; t0 += kTileCalls) {
        const int nt = (int)(hi - t0 < kTileCalls ? hi - t0 : kTileCalls);
        const float* src = u + t0 * n_donors;
        __syncwarp();  // every lane is done with the last tile
        for (int e = lane; e < nt * n_donors; e += kWarp) tile[e] = src[e];
        __syncwarp();
        for (int g = lane; g < n_pg; g += kWarp) {
            const float* ui = tile + pairs[g];
            const float* uj = tile + pairs[n_pg + g];
            float sum = row[g];
            for (int c = 0; c < nt; ++c) {
                const float a = 0.5f * (ui[c * n_donors] + uj[c * n_donors]);
                sum += kLog ? lg2_approx(a) : a;
            }
            row[g] = sum;
        }
    }
    float* out = logits + b * n_pg;
    for (int g = lane; g < n_pg; g += kWarp) out[g] = penalties[g] + (kLog ? row[g] * kLn2 : row[g]);
}

}  // namespace

// u: the folded calls [n_calls, n_donors]; pairs [2, n_pg] each column's donors
extern "C" int demux_folded_logits(const float* u, int64_t n_calls, int n_donors, const int64_t* row_ptr,
                                   int64_t n_barcodes, const int32_t* pairs, const float* penalties, int n_pg,
                                   float* logits, int use_log, void* stream) {
    if (n_barcodes <= 0 || n_pg <= 0 || n_donors <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    int status;
    if ((status = demux_check_csr(row_ptr, n_barcodes, n_calls, s)) != 0) return status;
    if ((status = demux_check_index(pairs, 2 * (int64_t)n_pg, n_donors, s)) != 0) return status;
    const int row_floats = (n_pg + 3) & ~3;
    const size_t shared = (size_t)kWarps * (row_floats + kTileCalls * n_donors) * sizeof(float);
    int device, optin;
    if ((status = cudaGetDevice(&device)) != 0) return status;
    if ((status = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) != 0) return status;
    if (shared > (size_t)optin) return (int)cudaErrorInvalidValue;
    const auto kernel = use_log ? &folded_kernel<true> : &folded_kernel<false>;
    if ((status = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared)) != 0)
        return status;
    const unsigned int grid = (unsigned int)((n_barcodes + kWarps - 1) / kWarps);
    kernel<<<grid, kWarps * kWarp, shared, s>>>(u, n_donors, row_ptr, n_barcodes, pairs, penalties, n_pg,
                                                 row_floats, logits);
    return (int)cudaGetLastError();
}
