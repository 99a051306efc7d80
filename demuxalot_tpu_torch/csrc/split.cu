// Split-word E-step kernel for Hopper (sm_90a): the doublet expansion on the tensor cores.
//
// Replaces the kernel of benchmarks/exp_split.py:make_kernel (:62, via
// run_variant :115), the TPU's E-step that recovers about f32 accuracy from
// bf16 matrix passes. On the folded calls U (call-major f32 [n_calls,
// n_donors], barcode CSR; experiments/folded_estep.py:fold_calls), for
// every barcode b and column g:
//
//   args[c, g]   = sum_k sum_d mix[d, g] * word_k(U)[c, d]        k < exp_words, in word order
//   logits[b, g] = pen[g] + sum_{calls c of b} words(log(args[c, g]))   log kept to sc_words bf16 words
//
// word_k: rem = U; word = bf16_rn(rem); rem -= word (round to nearest even,
// as astype(bfloat16) rounds). mix[d, g] is 1/2 at each of column g's two
// donors (1 for a singlet), exact in bf16. exp_words 0 expands in full f32
// on CUDA cores; sc_words 0 sums the logs in full f32.
//
// What bounds it on the H100: as folded.cu, one log per (call, column) and
// the instructions around it (2.2 G terms at the JAX harness's shape), now with the
// word split, the MMA fragments and a staging round trip per term. The
// expansion is dense: an m16n8k16 step spends 4,096 FLOP on 128 terms of
// which each has two nonzero products, so at the harness's shape with 2
// words (1,088 mma.sync per 64-call barcode) it is 2.9e11 bf16 FLOP, at
// least 0.29 ms at the 989 TFLOP/s dense peak, beside the logs' 0.53 ms;
// the two units run side by side. The design:
// - One warp per barcode, 16 calls at a time: their U rows are staged in
//   shared memory, split into exp_words bf16 word tiles (rows padded by 8
//   so the fragment loads hit distinct banks).
// - The expansion with mma.sync.m16n8k16 bf16 -> f32: A = a word tile (16
//   calls x 16 donors), B = the mixing column block (16 donors x 8
//   columns), built in registers from each column's donor pair, so no
//   mixing matrix is stored. Word by word, one f32 accumulator over the
//   donor steps, added to the arguments in word order, as the TPU kernel
//   adds its dot_split parts (a live accumulator per word spilled at 3 words). 32 columns (4 MMAs per word and donor step)
//   go to a 16 x 32 staging tile.
// - The scatter on CUDA cores: lane l owns column col0 + l, takes one log
//   per staged call, rounds it to sc_words words and adds it to the
//   barcode's running sum (a staged row in shared memory) in call order.
//   The TPU's one-hot product sums the same terms in another order. Logs are
//   lg2.approx (scaled by ln 2) except at sc_words 1, where logf keeps the
//   one rounded word equal to the plain version's (see term()).
// Each column's sum is one lane's, in call order, with no atomics: two runs
// give the same bits. row_ptr and the pairs are bounds-checked by checks.cu's
// kernels before the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

int demux_check_index(const int32_t* idx, int64_t n, int64_t limit, cudaStream_t stream);
int demux_check_csr(const int64_t* row_ptr, int64_t n_rows, int64_t n_entries, cudaStream_t stream);

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 4;          // warps (barcodes) per block
constexpr int kM = 16;             // calls per MMA tile
constexpr int kN = 8;              // columns per MMA
constexpr int kK = 16;             // donors per MMA step
constexpr int kChunk = kWarp;      // columns per staging tile: one per lane in the scatter
constexpr int kStage = kChunk + 1; // staging row stride in floats
constexpr int kWordPad = 8;        // bf16 padding of a word tile's rows
constexpr int kMaxExpWords = 3;
constexpr int kMaxScWords = 2;
constexpr float kLn2 = 0.693147180559945309f;

__device__ __forceinline__ float lg2_approx(float x) {
    float y;
    asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ float bf16_round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

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

// one call's term of a column's sum: log2 (scaled later) or the word-rounded natural log. One word
// takes logf, whose bits are torch.log's: the MUFU log differs in the last bits, and where that moves
// a value across a bf16 rounding boundary the word moves by 2^-8 of the log. Two words (16 bits) take
// the MUFU log: a crossing there moves the term by 2^-16 of it.
template <int kScWords>
__device__ __forceinline__ float term(float a) {
    if constexpr (kScWords == 0) {
        return lg2_approx(a);
    } else if constexpr (kScWords == 1) {
        return round_words<1>(logf(a));
    } else {
        return round_words<kScWords>(lg2_approx(a) * kLn2);
    }
}

__device__ __forceinline__ float mix_at(int d, int i, int j) { return (d == i ? 0.5f : 0.f) + (d == j ? 0.5f : 0.f); }

// two bf16 in one register, the lower k index in the lower half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// D = A (16 x 16, row) * B (16 x 8, col) + D, bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Per warp, in floats: the staged row of logits, the f32 U tile, the staging
// tile and the word tiles (bf16 [kExpWords][kM][d_pad + kWordPad]).
struct Layout {
    int row, tile, stage, words;
    __host__ __device__ Layout(int n_pg, int n_donors, int d_pad, int exp_words)
        : row((n_pg + 3) & ~3),
          tile((kM * n_donors + 3) & ~3),
          stage((kM * kStage + 3) & ~3),
          words(((exp_words * kM * (d_pad + kWordPad) + 1) / 2 + 3) & ~3) {}
    __host__ __device__ int total() const { return row + tile + stage + words; }
};

template <int kExpWords, int kScWords>
__global__ void __launch_bounds__(kWarps * kWarp) split_kernel(
    const float* __restrict__ u,          // [n_calls, n_donors]
    int n_donors, int d_pad,              // d_pad: n_donors rounded up to kK
    const int64_t* __restrict__ row_ptr,  // [n_barcodes + 1]
    int64_t n_barcodes,
    const int32_t* __restrict__ pairs,    // [2, n_pg]
    const float* __restrict__ penalties,  // [n_pg]
    int n_pg,
    float* __restrict__ logits)           // [n_barcodes, n_pg]
{
    extern __shared__ __align__(16) float smem[];
    const int lane = threadIdx.x % kWarp;
    const int warp = threadIdx.x / kWarp;
    const int64_t b = (int64_t)blockIdx.x * kWarps + warp;
    if (b >= n_barcodes) return;  // the whole warp; nothing below synchronises the block
    const Layout layout(n_pg, n_donors, d_pad, kExpWords);
    float* row = smem + (size_t)warp * layout.total();
    float* tile = row + layout.row;
    float* stage = tile + layout.tile;
    __nv_bfloat16* words = reinterpret_cast<__nv_bfloat16*>(stage + layout.stage);
    const int w_stride = d_pad + kWordPad;
    const int group = lane >> 2, tig = lane & 3;  // the MMA fragments' row and column within a quad

    for (int g = lane; g < n_pg; g += kWarp) row[g] = 0.f;
    const int64_t lo = row_ptr[b], hi = row_ptr[b + 1];
    for (int64_t t0 = lo; t0 < hi; t0 += kM) {
        const int nt = (int)(hi - t0 < kM ? hi - t0 : kM);
        const float* src = u + t0 * n_donors;
        __syncwarp();  // every lane is done with the last tile
        for (int e = lane; e < nt * n_donors; e += kWarp) tile[e] = src[e];
        __syncwarp();
        if constexpr (kExpWords > 0) {
            // U's words; rows past nt and donors past n_donors are 0 (their arguments are never summed)
            for (int e = lane; e < kM * d_pad; e += kWarp) {
                const int r = e / d_pad, d = e - r * d_pad;
                float x = r < nt && d < n_donors ? tile[r * n_donors + d] : 0.f;
#pragma unroll
                for (int k = 0; k < kExpWords; ++k) {
                    const __nv_bfloat16 word = __float2bfloat16_rn(x);
                    words[(k * kM + r) * w_stride + d] = word;
                    x -= __bfloat162float(word);
                }
            }
            __syncwarp();
        }
        for (int col0 = 0; col0 < n_pg; col0 += kChunk) {
            const int g = col0 + lane;
            if constexpr (kExpWords > 0) {
#pragma unroll
                for (int s = 0; s < kChunk / kN; ++s) {
                    const int n = col0 + s * kN + group;  // this lane's column of the B fragment
                    const int pi = n < n_pg ? pairs[n] : -1;
                    const int pj = n < n_pg ? pairs[n_pg + n] : -1;
                    // word by word, the B fragment rebuilt for each
                    float args[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
                    for (int k = 0; k < kExpWords; ++k) {
                        const __nv_bfloat16* w = words + (size_t)k * kM * w_stride;
                        float acc[4] = {0.f, 0.f, 0.f, 0.f};
                        for (int kk = 0; kk < d_pad; kk += kK) {
                            const int d0 = kk + 2 * tig;
                            const uint32_t bf[2] = {pack_bf16(mix_at(d0, pi, pj), mix_at(d0 + 1, pi, pj)),
                                                    pack_bf16(mix_at(d0 + 8, pi, pj), mix_at(d0 + 9, pi, pj))};
                            const uint32_t af[4] = {load_pair(w + group * w_stride + d0),
                                                    load_pair(w + (group + 8) * w_stride + d0),
                                                    load_pair(w + group * w_stride + d0 + 8),
                                                    load_pair(w + (group + 8) * w_stride + d0 + 8)};
                            mma_bf16(acc, af, bf);
                        }
#pragma unroll
                        for (int i = 0; i < 4; ++i) args[i] = k == 0 ? acc[i] : args[i] + acc[i];
                    }
                    float* st = stage + s * kN + 2 * tig;
                    st[group * kStage] = args[0];
                    st[group * kStage + 1] = args[1];
                    st[(group + 8) * kStage] = args[2];
                    st[(group + 8) * kStage + 1] = args[3];
                }
                __syncwarp();
                if (g < n_pg) {
                    float sum = row[g];
                    for (int c = 0; c < nt; ++c) sum += term<kScWords>(stage[c * kStage + lane]);
                    row[g] = sum;
                }
                __syncwarp();  // the next chunk rewrites the staging tile
            } else {
                if (g < n_pg) {
                    const float* ui = tile + pairs[g];
                    const float* uj = tile + pairs[n_pg + g];
                    float sum = row[g];
                    for (int c = 0; c < nt; ++c) sum += term<kScWords>(0.5f * (ui[c * n_donors] + uj[c * n_donors]));
                    row[g] = sum;
                }
            }
        }
    }
    float* out = logits + b * n_pg;
    for (int g = lane; g < n_pg; g += kWarp) out[g] = penalties[g] + (kScWords == 0 ? row[g] * kLn2 : row[g]);
}

using Kernel = decltype(&split_kernel<0, 0>);

template <int kExpWords>
Kernel pick(int sc_words) {
    return sc_words == 0 ? &split_kernel<kExpWords, 0>
         : sc_words == 1 ? &split_kernel<kExpWords, 1> : &split_kernel<kExpWords, 2>;
}

}  // namespace

// u: the folded calls [n_calls, n_donors]; pairs [2, n_pg] each column's donors;
// exp_words in 0..3, sc_words in 0..2 (0: full f32)
extern "C" int demux_split_logits(const float* u, int64_t n_calls, int n_donors, const int64_t* row_ptr,
                                  int64_t n_barcodes, const int32_t* pairs, const float* penalties, int n_pg,
                                  float* logits, int exp_words, int sc_words, void* stream) {
    if (n_barcodes <= 0 || n_pg <= 0 || n_donors <= 0 || exp_words < 0 || exp_words > kMaxExpWords ||
        sc_words < 0 || sc_words > kMaxScWords)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    int status;
    if ((status = demux_check_csr(row_ptr, n_barcodes, n_calls, s)) != 0) return status;
    if ((status = demux_check_index(pairs, 2 * (int64_t)n_pg, n_donors, s)) != 0) return status;
    const int d_pad = (n_donors + kK - 1) / kK * kK;
    const size_t shared = (size_t)kWarps * Layout(n_pg, n_donors, d_pad, exp_words).total() * sizeof(float);
    int device, optin;
    if ((status = cudaGetDevice(&device)) != 0) return status;
    if ((status = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) != 0) return status;
    if (shared > (size_t)optin) return (int)cudaErrorInvalidValue;
    const Kernel kernel = exp_words == 0 ? pick<0>(sc_words) : exp_words == 1 ? pick<1>(sc_words)
                        : exp_words == 2 ? pick<2>(sc_words) : pick<3>(sc_words);
    if ((status = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared)) != 0)
        return status;
    const unsigned int grid = (unsigned int)((n_barcodes + kWarps - 1) / kWarps);
    kernel<<<grid, kWarps * kWarp, shared, s>>>(u, n_donors, d_pad, row_ptr, n_barcodes, pairs, penalties, n_pg,
                                                 logits);
    return (int)cudaGetLastError();
}
