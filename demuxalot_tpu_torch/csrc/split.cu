// Split-word E-step kernel for Hopper (sm_90a): the doublet expansion on warpgroup MMA (wgmma).
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
// What bounds it on the H100: one log per (call, column) on the MUFU unit,
// 16 a clock per SM (2.2 G at the JAX harness's shape: 0.53 ms), and the
// instructions around each (the word rounding: one packed bf16 conversion
// per two terms and word; the adds). The expansion is dense: with 2 words
// 2 x 576 x 32 x 2 FLOP per call, 3.1e11 at the harness's shape, 0.31 ms at
// the 989 TFLOP/s dense bf16 peak, run on the tensor cores beside the logs.
// U's bytes (537 MB there) take 0.16 ms of HBM. The design (exp_words >= 1):
// - Columns on the MMA's M, calls on its N: D[g, c] = MixT[g, :] . word_k(U)[c, :],
//   wgmma.m64n64k16 bf16 -> f32, both operands K-major (donors) in shared
//   memory, read through descriptors in the no-swizzle core-matrix layout (8
//   rows x 16 bytes per core matrix; K-neighbours 128 bytes apart, 8-row
//   groups d_pad x 16 bytes apart). A = MixT, bf16 [64 x tiles, d_pad], is
//   built once per CTA from the column pairs. A CTA owns a range of 64-column
//   tiles (the grid's y) in half an SM's shared memory: every column at 32
//   donors (576 x 32 x 2 B = 36 KB); at 64 donors (2,112 x 64 x 2 B would be
//   270 KB) a third of them in a whole SM's.
// - A CTA is two warpgroups sharing A, each persistent over its own stride of
//   barcodes, two CTAs an SM where they fit. B is a tile of 64 calls of one barcode:
//   cp.async brings its f32 rows into the warpgroup's double buffer (the
//   next tile's rows arrive while this one is computed), then the warpgroup
//   splits it into exp_words bf16 word tiles. Calls past the barcode's end
//   take U = 1, whose argument is exactly 1 and whose log is 0.
// - One accumulator per word, added in word order on CUDA cores. A word's
//   product has at most two nonzero terms, bf16 values times 1/2 or 1, so
//   each word's accumulator is the f32 sum whatever order the tensor core
//   takes; one accumulator over all words would round inside the tensor core
//   and move one-word-rounded logs across bf16 boundaries. Two accumulators
//   are live at most (a third word waits for the second's sum). A
//   warpgroup waits for its products; the CTA's other warpgroup and the
//   SM's other CTA take their logs meanwhile.
// - The logs in the accumulators' own registers: a thread holds 2 columns x
//   16 calls of each 64 x 64 product, takes their terms and adds them in call
//   order to its two running sums (in shared memory, one pair per thread and
//   column tile). At the barcode's end each quad's four partial sums are
//   added in a fixed shuffle order, the penalty added and each logit written
//   once. No atomics: two runs give the same bits. Groups of 8 calls wholly
//   past the barcode's end are skipped, as are warps whose 16 columns are
//   all padding.
// exp_words 0 runs split_f32_kernel: one warp per barcode, each lane a
// column, the calls' f32 U rows staged in shared memory. Logs are
// lg2.approx (scaled by ln 2) except at sc_words 1, where logf keeps the one
// rounded word equal to the plain version's (see term()). row_ptr and the
// pairs are bounds-checked once, when the operands are built
// (demux_variant_check, checks.cu).
#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kGroupThreads = 128;     // a warpgroup
constexpr int kGroups = 2;             // warpgroups per CTA, each on its own barcodes, sharing A
constexpr int kThreads = kGroups * kGroupThreads;
constexpr int kM = 64;                 // columns per column tile (the MMA's M)
constexpr int kN = 64;                 // calls per call tile (the MMA's N)
constexpr int kK = 16;                 // donors per MMA step
constexpr int kAcc = kM * kN / kGroupThreads;  // accumulator floats per thread: 32
constexpr int kCtasPerSm = 2;          // the shared-memory budget of a CTA is half the SM's
constexpr int kF32Warps = 4;           // split_f32_kernel: warps (barcodes) per block
constexpr int kF32Tile = 16;           // split_f32_kernel: calls staged at a time
constexpr int kMaxExpWords = 3;
constexpr int kMaxScWords = 2;
constexpr float kLn2 = 0.693147180559945309f;

__device__ __forceinline__ float lg2_approx(float x) {
    float y;
    asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// x and y kept to kWords bf16 words each (the words' sum in word order), one packed conversion per word
template <int kWords>
__device__ __forceinline__ void round_words2(float& x, float& y) {
    if constexpr (kWords > 0) {
        float tx = 0.f, ty = 0.f, rx = x, ry = y;
#pragma unroll
        for (int k = 0; k < kWords; ++k) {
            const __nv_bfloat162 w = __floats2bfloat162_rn(rx, ry);  // .x the low half
            const uint32_t bits = *reinterpret_cast<const uint32_t*>(&w);
            const float wx = __uint_as_float(bits << 16), wy = __uint_as_float(bits & 0xffff0000u);
            tx = k == 0 ? wx : tx + wx;
            ty = k == 0 ? wy : ty + wy;
            rx -= wx;
            ry -= wy;
        }
        x = tx;
        y = ty;
    }
}

// x kept to kWords bf16 words, one conversion per word
template <int kWords>
__device__ __forceinline__ float round_words(float x) {
    if constexpr (kWords == 0) {
        return x;
    } else {
        float total = 0.f, rem = x;
#pragma unroll
        for (int k = 0; k < kWords; ++k) {
            const float word = __bfloat162float(__float2bfloat16_rn(rem));
            total = k == 0 ? word : total + word;
            rem -= word;
        }
        return total;
    }
}

// a call's log, before the rounding: log2 (scaled later) or the natural log. One word takes logf, whose
// bits are torch.log's: the MUFU log differs in the last bits, and where that moves a value across a bf16
// rounding boundary the word moves by 2^-8 of the log. Two words (16 bits) take the MUFU log: a crossing
// there moves the term by 2^-16 of it.
template <int kScWords>
__device__ __forceinline__ float log_of(float a) {
    if constexpr (kScWords == 0) {
        return lg2_approx(a);
    } else if constexpr (kScWords == 1) {
        return logf(a);
    } else {
        return lg2_approx(a) * kLn2;
    }
}

// one call's term of a column's sum: its log kept to kScWords words
template <int kScWords>
__device__ __forceinline__ float term(float a) {
    return round_words<kScWords>(log_of<kScWords>(a));
}

// two calls' terms, their roundings packed two to a conversion
template <int kScWords>
__device__ __forceinline__ void terms2(float& a, float& b) {
    a = log_of<kScWords>(a);
    b = log_of<kScWords>(b);
    round_words2<kScWords>(a, b);
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    if constexpr (kBytes == 16) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
    } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
    }
}

// A wgmma shared-memory descriptor, no swizzle: the start address, the byte offset between core matrices
// adjacent in K (lbo) and between 8-row groups (sbo), each in 16-byte units
__device__ __forceinline__ uint64_t descriptor(const void* smem, uint32_t lbo, uint32_t sbo) {
    const uint32_t at = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    return (uint64_t)((at & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
           ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// the compiler must not move reads or writes of an accumulator across the wgmma issue and wait
__device__ __forceinline__ void fence_operands(float (&d)[kAcc]) {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// D (64 x 64, f32) = A (64 x 16, K-major) . B (16 x 64, K-major)^T + (scale_d ? D : 0), bf16 inputs
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[kAcc], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
}

// the byte offset of element (r, k) of a K-major tile in the no-swizzle core-matrix layout
__device__ __forceinline__ int core_offset(int r, int k, int sbo) {
    return (r >> 3) * sbo + (k >> 3) * 128 + (r & 7) * 16 + (k & 7) * 2;
}

// Shared memory of split_kernel, in bytes: A and the penalties of the CTA's columns, then each warpgroup's
// word tiles, f32 double buffer and running sums
struct Layout {
    int a, pen, words, stage, sums, group, total;
    __host__ __device__ Layout(int tiles, int d_pad, int stride, int exp_words)
        : a(tiles * kM * d_pad * 2),
          pen(tiles * kM * 4),
          words(exp_words * kN * d_pad * 2),
          stage(2 * kN * stride * 4),
          sums(tiles * kGroupThreads * 8),
          group(words + stage + sums),
          total(a + pen + kGroups * group) {}
};

__device__ __forceinline__ void group_barrier(int id) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kGroupThreads) : "memory");
}

// one word's product of a column tile: d = A . word^T over the donors, kSteps MMA steps a block of the
// donor axis (kSteps 4 walks `blocks` such blocks; 1 and 2 take one)
template <int kSteps>
__device__ __forceinline__ void chain(float (&d)[kAcc], const unsigned char* a, const unsigned char* w, int sbo,
                                      int blocks) {
    if constexpr (kSteps < 4) {
#pragma unroll
        for (int s = 0; s < kSteps; ++s)
            wgmma_m64n64k16(d, descriptor(a + 256 * s, 128, sbo), descriptor(w + 256 * s, 128, sbo), s > 0);
    } else {
        for (int block = 0; block < blocks; ++block) {
#pragma unroll
            for (int s = 0; s < kSteps; ++s) {
                const int k = block * kSteps + s;
                wgmma_m64n64k16(d, descriptor(a + 256 * k, 128, sbo), descriptor(w + 256 * k, 128, sbo), k > 0);
            }
        }
    }
}

// one CTA: column tiles [blockIdx.y * tiles, ...); warpgroup w of the CTA takes barcodes
// kGroups * blockIdx.x + w, then every kGroups * gridDim.x-th. d_pad = 16 kSteps (kSteps 1, 2) or a multiple
// of 64 (kSteps 4); vec: U's rows take 16-byte copies (n_donors % 4 == 0, U 16-byte aligned)
// logf (sc_words 1) takes more registers than two CTAs an SM leave: such kernels run one CTA an SM
template <int kExpWords, int kScWords, int kSteps>
__global__ void __launch_bounds__(kThreads, kScWords == 1 ? 1 : kCtasPerSm) split_kernel(
    const float* __restrict__ u,          // [n_calls, n_donors]
    int n_donors, int d_pad, int stride,  // stride: a staged row's floats
    bool vec,
    const int64_t* __restrict__ row_ptr,  // [n_barcodes + 1]
    int64_t n_barcodes,
    const int32_t* __restrict__ pairs,    // [2, n_pg]
    const float* __restrict__ penalties,  // [n_pg]
    int n_pg, int tiles,                  // tiles: column tiles per CTA
    float* __restrict__ logits)           // [n_barcodes, n_pg]
{
    extern __shared__ __align__(128) unsigned char smem[];
    const int group = threadIdx.x / kGroupThreads, tid = threadIdx.x % kGroupThreads;
    const int warp = tid / kWarp, lane = tid % kWarp;
    const int tile0 = blockIdx.y * tiles;
    const int n_tiles = min(tiles, (n_pg + kM - 1) / kM - tile0);
    const Layout layout(tiles, d_pad, stride, kExpWords);
    unsigned char* a_tiles = smem;
    float* pen = reinterpret_cast<float*>(a_tiles + layout.a);
    unsigned char* words = a_tiles + layout.a + layout.pen + group * layout.group;
    float* stage = reinterpret_cast<float*>(words + layout.words);
    float2* sums = reinterpret_cast<float2*>(stage + 2 * kN * stride);
    const int sbo = d_pad * 16;    // bytes between 8-row groups of A and of a word tile
    const int chunks = d_pad / 8;  // 16-byte chunks of a row
    const int blocks = d_pad / (16 * kSteps);
    const int a_bytes = kM * d_pad * 2, w_bytes = kN * d_pad * 2;  // a column tile of A, a word tile

    // A = MixT over this CTA's column tiles and their penalties, once, by both warpgroups
    for (int r = threadIdx.x; r < n_tiles * kM; r += kThreads)
        pen[r] = tile0 * kM + r < n_pg ? penalties[tile0 * kM + r] : 0.f;
    for (int e = threadIdx.x; e < n_tiles * kM * chunks; e += kThreads) {
        const int r = (e & 7) + (e >> 3) / chunks * 8, c = (e >> 3) % chunks;  // row-fastest: 128-byte stores
        const int g = tile0 * kM + r;
        const int i = g < n_pg ? pairs[g] : -1, j = g < n_pg ? pairs[n_pg + g] : -1;
        uint32_t packed[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
            const int d = 8 * c + 2 * h;
            const float lo = (d == i ? 0.5f : 0.f) + (d == j ? 0.5f : 0.f);
            const float hi = (d + 1 == i ? 0.5f : 0.f) + (d + 1 == j ? 0.5f : 0.f);
            const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
            packed[h] = *reinterpret_cast<const uint32_t*>(&v);
        }
        *reinterpret_cast<uint4*>(a_tiles + core_offset(r, 8 * c, sbo)) =
            make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }

    // the f32 rows of calls [t0, t0 + n) into stage slot `slot`, by this warpgroup
    auto copy_tile = [&](int64_t t0, int n, int slot) {
        float* dst = stage + slot * kN * stride;
        const float* src = u + t0 * n_donors;
        if (vec) {
            const int per_row = n_donors / 4;
            for (int e = tid; e < n * per_row; e += kGroupThreads) {
                const int r = e / per_row, c = e - r * per_row;
                cp_async<16>(dst + r * stride + 4 * c, src + (int64_t)r * n_donors + 4 * c);
            }
        } else {
            for (int e = tid; e < n * n_donors; e += kGroupThreads) {
                const int r = e / n_donors, c = e - r * n_donors;
                cp_async<4>(dst + r * stride + c, src + e);
            }
        }
    };
    auto commit = [] { asm volatile("cp.async.commit_group;\n" ::: "memory"); };

    float args[kAcc], acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) args[i] = acc[i] = 0.f;
    // a column tile's terms, added in call order to this thread's two running sums; kFull: all kN calls
    // (calls past the barcode's end have argument 1, term 0), else only the groups of 8 before nt
    auto add_terms = [&](auto full, int nt, float2& s) {
#pragma unroll
        for (int j = 0; j < kN / 8; ++j) {
            if (!decltype(full)::value && 8 * j >= nt) break;
            float x0 = args[4 * j], x1 = args[4 * j + 1], y0 = args[4 * j + 2], y1 = args[4 * j + 3];
            terms2<kScWords>(x0, x1);
            terms2<kScWords>(y0, y1);
            s.x += x0;
            s.x += x1;
            s.y += y0;
            s.y += y1;
        }
    };

    // this thread's accumulators: rows row0 and row0 + 8 of a column tile, calls 8 j + 2 (lane % 4) + {0, 1}
    const int row0 = 16 * warp + lane / 4;
    int64_t pending = -1;  // the call tile whose copy is in flight in slot `cur`
    int cur = 0;
    const int64_t first = (int64_t)blockIdx.x * kGroups + group, step = (int64_t)gridDim.x * kGroups;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // A, for the tensor cores
    __syncthreads();

    // each barcode's call range, the next one's loaded a barcode ahead
    int64_t lo = first < n_barcodes ? row_ptr[first] : 0;
    int64_t hi = first < n_barcodes ? row_ptr[first + 1] : 0;
    for (int64_t b = first; b < n_barcodes; b += step) {
        const bool more = b + step < n_barcodes;
        const int64_t next_lo = more ? row_ptr[b + step] : 0, next_hi = more ? row_ptr[b + step + 1] : 0;
        for (int t = 0; t < n_tiles; ++t) sums[t * kGroupThreads + tid] = make_float2(0.f, 0.f);
        for (int64_t t0 = lo; t0 < hi; t0 += kN) {
            const int nt = (int)(hi - t0 < kN ? hi - t0 : kN);
            if (pending != t0) {
                copy_tile(t0, nt, cur);
                commit();
            }
            // the next call tile, of this barcode or the next one of this warpgroup
            const bool same = t0 + kN < hi;
            const int64_t next = same ? t0 + kN : next_lo < next_hi ? next_lo : -1;
            const int64_t end = same ? hi : next_hi;
            if (next >= 0) copy_tile(next, (int)(end - next < kN ? end - next : kN), cur ^ 1);
            commit();
            pending = next;
            asm volatile("cp.async.wait_group 1;\n" ::: "memory");
            group_barrier(1 + group);  // this tile's rows landed; every warp is done with the word tiles

            // the word tiles; calls past nt take U = 1 (argument 1, log 0), padding donors 0
            const float* rows = stage + cur * kN * stride;
            for (int e = tid; e < kN * chunks; e += kGroupThreads) {
                const int r = (e & 7) + (e >> 3) / chunks * 8, c = (e >> 3) % chunks;
                float x[8];
                if (vec) {  // a 16-byte piece is all donors or all padding
#pragma unroll
                    for (int h = 0; h < 8; h += 4) {
                        const int d = 8 * c + h;
                        const float4 v = d >= n_donors ? make_float4(0.f, 0.f, 0.f, 0.f)
                                       : r < nt ? *reinterpret_cast<const float4*>(rows + r * stride + d)
                                                : make_float4(1.f, 1.f, 1.f, 1.f);
                        x[h] = v.x;
                        x[h + 1] = v.y;
                        x[h + 2] = v.z;
                        x[h + 3] = v.w;
                    }
                } else {
#pragma unroll
                    for (int h = 0; h < 8; ++h) {
                        const int d = 8 * c + h;
                        x[h] = d >= n_donors ? 0.f : r < nt ? rows[r * stride + d] : 1.f;
                    }
                }
#pragma unroll
                for (int k = 0; k < kExpWords; ++k) {
                    uint32_t packed[4];
#pragma unroll
                    for (int h = 0; h < 4; ++h) {
                        const __nv_bfloat162 w = __floats2bfloat162_rn(x[2 * h], x[2 * h + 1]);
                        packed[h] = *reinterpret_cast<const uint32_t*>(&w);
                        x[2 * h] -= __low2float(w);
                        x[2 * h + 1] -= __high2float(w);
                    }
                    *reinterpret_cast<uint4*>(words + k * w_bytes + core_offset(r, 8 * c, sbo)) =
                        make_uint4(packed[0], packed[1], packed[2], packed[3]);
                }
            }
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the word tiles, for the tensor cores
            group_barrier(1 + group);

            for (int t = 0; t < n_tiles; ++t) {
                const unsigned char* a_tile = a_tiles + t * a_bytes;
                fence_operands(args);
                fence_operands(acc);
                wgmma_fence();
                chain<kSteps>(args, a_tile, words, sbo, blocks);
                if constexpr (kExpWords >= 2) chain<kSteps>(acc, a_tile, words + w_bytes, sbo, blocks);
                wgmma_commit();
                wgmma_wait_all();
                fence_operands(args);
                fence_operands(acc);
                if constexpr (kExpWords >= 2) {
#pragma unroll
                    for (int i = 0; i < kAcc; ++i) args[i] += acc[i];  // word order
                }
                if constexpr (kExpWords >= 3) {
                    fence_operands(acc);
                    wgmma_fence();
                    chain<kSteps>(acc, a_tile, words + 2 * w_bytes, sbo, blocks);
                    wgmma_commit();
                    wgmma_wait_all();
                    fence_operands(acc);
#pragma unroll
                    for (int i = 0; i < kAcc; ++i) args[i] += acc[i];
                }
                if ((tile0 + t) * kM + 16 * warp >= n_pg) continue;  // the warp's 16 columns are padding
                float2 s = sums[t * kGroupThreads + tid];
                if (nt == kN) {
                    add_terms(std::true_type{}, nt, s);
                } else {
                    add_terms(std::false_type{}, nt, s);
                }
                sums[t * kGroupThreads + tid] = s;
            }
            cur ^= 1;
        }
        // the quads' partial sums, in a fixed order, and the logits
        for (int t = 0; t < n_tiles; ++t) {
            float2 s = sums[t * kGroupThreads + tid];
            s.x += __shfl_xor_sync(demux::kFullMask, s.x, 1);
            s.y += __shfl_xor_sync(demux::kFullMask, s.y, 1);
            s.x += __shfl_xor_sync(demux::kFullMask, s.x, 2);
            s.y += __shfl_xor_sync(demux::kFullMask, s.y, 2);
            const int quad = lane & 3;
            if (quad < 2) {
                const int g = (tile0 + t) * kM + row0 + 8 * quad;
                const float sum = quad == 0 ? s.x : s.y;
                if (g < n_pg) logits[b * n_pg + g] = pen[g - tile0 * kM] + (kScWords == 0 ? sum * kLn2 : sum);
            }
        }
        lo = next_lo;
        hi = next_hi;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// exp_words 0: the f32 expansion on CUDA cores. One warp per barcode, lane l owns columns l, l + 32, ...;
// the calls' U rows staged 16 at a time; each column's terms summed in call order in a staged row.
template <int kScWords>
__global__ void __launch_bounds__(kF32Warps * kWarp) split_f32_kernel(
    const float* __restrict__ u, int n_donors, const int64_t* __restrict__ row_ptr, int64_t n_barcodes,
    const int32_t* __restrict__ pairs, const float* __restrict__ penalties, int n_pg, int row_floats,
    float* __restrict__ logits)
{
    extern __shared__ __align__(16) float f32_smem[];
    const int lane = threadIdx.x % kWarp;
    const int warp = threadIdx.x / kWarp;
    const int64_t b = (int64_t)blockIdx.x * kF32Warps + warp;
    if (b >= n_barcodes) return;  // the whole warp; nothing below synchronises the block
    float* row = f32_smem + (size_t)warp * (row_floats + kF32Tile * n_donors);
    float* tile = row + row_floats;
    for (int g = lane; g < n_pg; g += kWarp) row[g] = 0.f;
    const int64_t lo = row_ptr[b], hi = row_ptr[b + 1];
    for (int64_t t0 = lo; t0 < hi; t0 += kF32Tile) {
        const int nt = (int)(hi - t0 < kF32Tile ? hi - t0 : kF32Tile);
        const float* src = u + t0 * n_donors;
        __syncwarp();  // every lane is done with the last tile
        for (int e = lane; e < nt * n_donors; e += kWarp) tile[e] = src[e];
        __syncwarp();
        for (int g = lane; g < n_pg; g += kWarp) {
            const float* ui = tile + pairs[g];
            const float* uj = tile + pairs[n_pg + g];
            float sum = row[g];
            for (int c = 0; c < nt; ++c) sum += term<kScWords>(0.5f * (ui[c * n_donors] + uj[c * n_donors]));
            row[g] = sum;
        }
    }
    float* out = logits + b * n_pg;
    for (int g = lane; g < n_pg; g += kWarp) out[g] = penalties[g] + (kScWords == 0 ? row[g] * kLn2 : row[g]);
}

using Kernel = decltype(&split_kernel<1, 0, 1>);

template <int kExpWords, int kSteps>
Kernel pick_sc(int sc_words) {
    return sc_words == 0 ? &split_kernel<kExpWords, 0, kSteps>
         : sc_words == 1 ? &split_kernel<kExpWords, 1, kSteps> : &split_kernel<kExpWords, 2, kSteps>;
}

template <int kSteps>
Kernel pick(int exp_words, int sc_words) {
    return exp_words == 1 ? pick_sc<1, kSteps>(sc_words) : exp_words == 2 ? pick_sc<2, kSteps>(sc_words)
                                                                          : pick_sc<3, kSteps>(sc_words);
}

int launch_f32(const float* u, int n_donors, const int64_t* row_ptr, int64_t n_barcodes, const int32_t* pairs,
               const float* penalties, int n_pg, float* logits, int sc_words, cudaStream_t s, int optin) {
    using F32Kernel = decltype(&split_f32_kernel<0>);
    const int row_floats = (n_pg + 3) & ~3;
    const size_t shared = (size_t)kF32Warps * (row_floats + kF32Tile * n_donors) * sizeof(float);
    if (shared > (size_t)optin) return (int)cudaErrorInvalidValue;
    const F32Kernel kernel = sc_words == 0 ? &split_f32_kernel<0>
                           : sc_words == 1 ? &split_f32_kernel<1> : &split_f32_kernel<2>;
    int status;
    if ((status = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared)) != 0)
        return status;
    const unsigned int grid = (unsigned int)((n_barcodes + kF32Warps - 1) / kF32Warps);
    kernel<<<grid, kF32Warps * kWarp, shared, s>>>(u, n_donors, row_ptr, n_barcodes, pairs, penalties, n_pg,
                                                    row_floats, logits);
    return (int)cudaGetLastError();
}

}  // namespace

// u: the folded calls [n_calls, n_donors]; pairs [2, n_pg] each column's donors; exp_words in 0..3,
// sc_words in 0..2 (0: full f32). row_ptr and pairs as demux_variant_check passed them.
extern "C" int demux_split_logits(const float* u, int64_t n_calls, int n_donors, const int64_t* row_ptr,
                                  int64_t n_barcodes, const int32_t* pairs, const float* penalties, int n_pg,
                                  float* logits, int exp_words, int sc_words, int device, void* stream) {
    if (n_barcodes <= 0 || n_pg <= 0 || n_donors <= 0 || n_calls < 0 || exp_words < 0 ||
        exp_words > kMaxExpWords || sc_words < 0 || sc_words > kMaxScWords)
        return (int)cudaErrorInvalidValue;
    const demux::DeviceGuard guard(device);
    if (guard.status() != 0) return guard.status();
    cudaStream_t s = (cudaStream_t)stream;
    int optin, smem_per_sm, reserved, n_sms, status;
    if ((status = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) != 0) return status;
    if (exp_words == 0)
        return launch_f32(u, n_donors, row_ptr, n_barcodes, pairs, penalties, n_pg, logits, sc_words, s, optin);
    if ((status = cudaDeviceGetAttribute(&smem_per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device)) != 0)
        return status;
    if ((status = cudaDeviceGetAttribute(&reserved, cudaDevAttrReservedSharedMemoryPerBlock, device)) != 0)
        return status;
    if ((status = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, device)) != 0) return status;
    const bool vec = n_donors % 4 == 0 && demux::aligned16(u);
    // the donor axis in MMA steps of 16: one or two steps, or blocks of four
    const int steps = (n_donors + kK - 1) / kK <= 2 ? (n_donors + kK - 1) / kK : 4;
    const int d_pad = steps < 4 ? steps * kK : (n_donors + 4 * kK - 1) / (4 * kK) * (4 * kK);
    const int total_tiles = (n_pg + kM - 1) / kM;
    // the column tiles a CTA holds, in balanced ranges (the grid's y): as many as half the SM's shared memory
    // takes, or a whole block's where that needs more than twice the ranges (64 donors: 33 ranges of one
    // tile against 3 of 11). Staged rows are padded so that 8 rows' 16-byte reads hit distinct banks (an
    // odd count of 16-byte pieces) unless the padding costs a column range.
    auto fits = [&](int budget, int stride) {
        const Layout fixed(0, d_pad, stride, exp_words), one(1, d_pad, stride, exp_words);
        return budget < fixed.total ? 0 : (budget - fixed.total) / (one.total - fixed.total);
    };
    auto ranges_of = [&](int fit) { return fit < 1 ? INT32_MAX : (total_tiles + fit - 1) / fit; };
    const int padded = vec && n_donors / 4 % 2 == 0 ? n_donors + 4 : n_donors;
    const int half = smem_per_sm / kCtasPerSm - reserved;
    const int budget = ranges_of(fits(half, n_donors)) > 2 * ranges_of(fits(optin, n_donors)) ? optin : half;
    const int stride = ranges_of(fits(budget, padded)) <= ranges_of(fits(budget, n_donors)) ? padded : n_donors;
    const int ranges = ranges_of(fits(budget, stride));
    if (ranges == INT32_MAX) return (int)cudaErrorInvalidValue;
    const int tiles = (total_tiles + ranges - 1) / ranges;
    const size_t shared = Layout(tiles, d_pad, stride, exp_words).total;
    if (shared > (size_t)optin) return (int)cudaErrorInvalidValue;
    const Kernel kernel = steps == 1 ? pick<1>(exp_words, sc_words) : steps == 2 ? pick<2>(exp_words, sc_words)
                                                                      : pick<4>(exp_words, sc_words);
    if ((status = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared)) != 0)
        return status;
    int per_sm = 0;
    if ((status = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, shared)) != 0)
        return status;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    // persistent CTAs: each range's barcodes over the CTAs that fit the card at once
    const int64_t resident = ((int64_t)per_sm * n_sms + ranges - 1) / ranges;
    const int64_t wanted = (n_barcodes + kGroups - 1) / kGroups;
    const dim3 grid((unsigned int)(wanted < resident ? wanted : resident), (unsigned int)ranges);
    kernel<<<grid, kThreads, shared, s>>>(u, n_donors, d_pad, stride, vec, row_ptr, n_barcodes, pairs, penalties,
                                          n_pg, tiles, logits);
    return (int)cudaGetLastError();
}
