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
//   args[c, g]   = 0.5 * (U_w[c, i_g] + U_w[c, j_g]),  U_w = sum_k word_k(U)  k < n_words, in word order
//   gsum[h, g]   = sum_{calls c of group h, in order} log(max(args[c, g], 1e-30))
//   logits[b, g] = pen[g] + sum_{groups h of b, in order} words(gsum[h, g])  kept to n_words bf16 words
//
// n_words 0 is full f32 (U_w = U, the TPU's HIGHEST dots); word_k as split.cu
// makes them (round to nearest even). The TPU adds the words' dots; the sum
// of the words first differs from it in the last bit of an argument at
// most. use_log off sums the arguments (nolog).
//
// What bounds it on the H100: as the mainline E-step (likelihood.cu),
// instruction issue and shared-memory loads per term; the logs are few (one
// per group). The design is the mainline's:
// - Register-tiled donor pairs. A lane owns the 4 x 4 and 2 x 2 tiles of
//   donor pairs of the host's schedule (ops/likelihood_kernel.py:
//   estep_schedule, its columns mapped to the operands' pairs by
//   group_estep.py:group_schedule), so per call it reads two
//   16-byte and two 8-byte pieces of the staged row and updates 20 columns
//   at an add and a multiply each.
//   One warp per barcode, warps persistent over a stride of barcodes, one
//   walk of the calls per schedule pass.
// - U's words staged once per tile of 32 calls (whole groups: G divides
//   32): cp.async brings the tile's f32 rows into a double-buffered ring
//   while the last tile is computed, then the warp rounds them in place to
//   0.5 * U_w, one plane whatever the word count.
// - At n_words 0 and 2 each group's sum is kept in registers as the product
//   of its arguments, one MUFU log2 per group (per 4 calls past G = 8),
//   scaled by ln 2, rounded to n_words words and added in group order. The
//   mainline's invariant makes this exact enough: U >= 1e-4 (fold_calls'
//   floor), so a product of 8 arguments stays a normal float and the clamp
//   at 1e-30 never acts. n_words 1 keeps one logf per term in call order, the
//   plain version's bits, because one rounded bf16 word moves by 2^-8 of the
//   log where a last-bit difference crosses a rounding boundary.
// - Each column's sum is one lane's, in group and call order, staged in the
//   warp's row of logits and written coalesced; no atomics, so two runs give
//   the same bits.
// row_ptr, the pairs and the schedule are bounds-checked once, when the
// operands are built (demux_variant_check, checks.cu).
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 4;       // warps (barcodes) per block
constexpr int kTileCalls = 32;  // calls staged at a time; G divides it
constexpr int kMaxWords = 2;
constexpr int kQuadSlots = 16;
constexpr int kSlots = kQuadSlots + 4;
constexpr int kEntry = 4 + kSlots;  // per (pass, lane): quad p, q, duo r, s, then one column per slot
constexpr int kMaxFold = 8;         // arguments multiplied per log, at most
constexpr float kLn2 = 0.693147180559945309f;

enum Mode { kProduct = 0, kTermLog = 1, kNoLog = 2 };

__device__ __forceinline__ float lg2_approx(float x) {
    float y;
    asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ float bf16_round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// x and y kept to kWords bf16 words each (the words' sum in word order), one packed conversion per word
// for both
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

// sum[s] += words(v[s]) for every slot, the roundings two slots to a conversion
template <int kWords>
__device__ __forceinline__ void add_rounded(float (&sum)[kSlots], float (&v)[kSlots]) {
#pragma unroll
    for (int s = 0; s < kSlots; s += 2) {
        round_words2<kWords>(v[s], v[s + 1]);
        sum[s] += v[s];
        sum[s + 1] += v[s + 1];
    }
}

template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    if constexpr (kBytes == 16) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
    } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
    }
}

// A row-major [rows, per_row] walk spread over the warp (likelihood.cu's): `step` rows per round, this
// lane's row within the round and its first item in the row.
struct Walk {
    int step, sub, first;
    bool active;
    __device__ Walk(int per_row, int lane) {
        if (per_row <= kWarp) {
            step = kWarp / per_row;
            sub = lane / per_row;
            first = lane - sub * per_row;
        } else {
            step = 1;
            sub = 0;
            first = lane;
        }
        active = sub < step;
    }
};

// one call's 20 arguments of this lane's tiles from its staged row u
__device__ __forceinline__ void arguments(const float* u, int off_a, int off_b, int off_c, int off_d,
                                          float (&a)[kSlots]) {
    const float4 x = *reinterpret_cast<const float4*>(u + off_a);
    const float4 y = *reinterpret_cast<const float4*>(u + off_b);
    const float2 v = *reinterpret_cast<const float2*>(u + off_c);
    const float2 w = *reinterpret_cast<const float2*>(u + off_d);
    const float xv[4] = {x.x, x.y, x.z, x.w};
    const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) a[4 * i + j] = xv[i] + yv[j];
    }
    a[kQuadSlots + 0] = v.x + w.x;
    a[kQuadSlots + 1] = v.x + w.y;
    a[kQuadSlots + 2] = v.y + w.x;
    a[kQuadSlots + 3] = v.y + w.y;
}

// kFold: calls multiplied per log (kProduct: G, or 4 when kChunked, i.e. G > 8 and a group sum of several
// logs, whose sums beside the products take more registers than 4 blocks an SM leave); kTermLog and kNoLog
// take kFold 1. kVec: U's rows take 16-byte copies.
template <int kWords, int kMode, int kFold, bool kChunked, bool kVec>
__global__ void __launch_bounds__(kWarps * kWarp, kChunked ? 3 : 4) group_kernel(
    const float* __restrict__ u,          // [n_calls, n_donors], the group layout's calls
    int n_donors, int stride,             // stride: n_donors rounded up to 4
    const int64_t* __restrict__ row_ptr,  // [n_barcodes + 1], counts multiples of group
    int64_t n_barcodes, int group,
    const int32_t* __restrict__ schedule, // [n_passes, kWarp, kEntry]
    int n_passes,
    const float* __restrict__ penalties,  // [n_pg]
    int n_pg, int row_floats,             // row_floats: n_pg rounded up to 4
    float* __restrict__ logits)           // [n_barcodes, n_pg]
{
    extern __shared__ __align__(16) float smem[];
    const int lane = threadIdx.x % kWarp;
    const int warp = threadIdx.x / kWarp;
    const int tile_floats = kTileCalls * stride;
    float* ring = smem + (size_t)warp * (2 * tile_floats + row_floats);  // 2 slots, then the row
    float* row = ring + 2 * tile_floats;
    const int64_t n_warps = (int64_t)gridDim.x * kWarps;

    // a tile's rows of U (16-byte or 4-byte pieces) and their float4s, each spread over the warp
    const int pieces = kVec ? n_donors / 4 : n_donors;
    const Walk copy_walk(pieces, lane), split_walk(stride / 4, lane);
    auto copy = [&](int64_t t0, int n, float* dst) {
        const float* src = u + t0 * n_donors;
        for (int r0 = 0; r0 < n; r0 += copy_walk.step) {
            const int r = r0 + copy_walk.sub;
            if (!copy_walk.active || r >= n) continue;
            for (int c = copy_walk.first; c < pieces; c += kWarp) {
                if constexpr (kVec) {
                    cp_async<16>(dst + r * stride + 4 * c, src + (int64_t)r * n_donors + 4 * c);
                } else {
                    cp_async<4>(dst + r * stride + c, src + (int64_t)r * n_donors + c);
                }
            }
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    };

    for (int64_t b = (int64_t)blockIdx.x * kWarps + warp; b < n_barcodes; b += n_warps) {
        const int64_t lo = row_ptr[b], hi = row_ptr[b + 1];
        for (int pass = 0; pass < n_passes; ++pass) {
            const int32_t* entry = schedule + ((int64_t)pass * kWarp + lane) * kEntry;
            const int off_a = 4 * entry[0], off_b = 4 * entry[1];
            const int off_c = 2 * entry[2], off_d = 2 * entry[3];
            float sum[kSlots];
#pragma unroll
            for (int s = 0; s < kSlots; ++s) sum[s] = 0.f;
            __syncwarp();  // every lane is done with the ring and the row
            int cur = 0;
            if (lo < hi) copy(lo, (int)(hi - lo < kTileCalls ? hi - lo : kTileCalls), ring);
            for (int64_t t0 = lo; t0 < hi; t0 += kTileCalls) {
                const int nt = (int)(hi - t0 < kTileCalls ? hi - t0 : kTileCalls);
                float* buf = ring + cur * tile_floats;
                asm volatile("cp.async.wait_all;\n" ::: "memory");
                __syncwarp();  // this tile's rows landed; the other slot is free
                if (t0 + kTileCalls < hi) {
                    const int64_t t1 = t0 + kTileCalls;
                    copy(t1, (int)(hi - t1 < kTileCalls ? hi - t1 : kTileCalls), ring + (cur ^ 1) * tile_floats);
                }
                // 0.5 * U_w in place; padding donors as U = 1 (argument 1)
                for (int r0 = 0; r0 < nt; r0 += split_walk.step) {
                    const int r = r0 + split_walk.sub;
                    if (!split_walk.active || r >= nt) continue;
                    for (int k4 = split_walk.first; k4 < stride / 4; k4 += kWarp) {
                        float4* at = reinterpret_cast<float4*>(buf + r * stride + 4 * k4);
                        const float4 v = *at;
                        float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                        for (int i = 0; i < 4; ++i) {
                            if (4 * k4 + i >= n_donors) x[i] = 1.f;
                            if constexpr (kWords > 0) {
                                float total = 0.f, rem = x[i];
#pragma unroll
                                for (int k = 0; k < kWords; ++k) {
                                    const float word = bf16_round(rem);
                                    total = k == 0 ? word : total + word;
                                    rem -= word;
                                }
                                x[i] = total;
                            }
                        }
                        *at = make_float4(0.5f * x[0], 0.5f * x[1], 0.5f * x[2], 0.5f * x[3]);
                    }
                }
                __syncwarp();

                if constexpr (kMode == kProduct) {
                    float gsum[kChunked ? kSlots : 1];
                    for (int c0 = 0; c0 < nt; c0 += kFold) {
                        float prod[kSlots];
#pragma unroll
                        for (int c = 0; c < kFold; ++c) {
                            float a[kSlots];
                            arguments(buf + (c0 + c) * stride, off_a, off_b, off_c, off_d, a);
#pragma unroll
                            for (int s = 0; s < kSlots; ++s) prod[s] = c == 0 ? a[s] : prod[s] * a[s];
                        }
                        if constexpr (kChunked) {  // G > 8: the group's log is the sum of its chunks' logs
                            const bool first = c0 % group == 0, last = (c0 + kFold) % group == 0;
#pragma unroll
                            for (int s = 0; s < kSlots; ++s) {
                                const float l = lg2_approx(prod[s]) * kLn2;
                                gsum[s] = first ? l : gsum[s] + l;
                            }
                            if (last) add_rounded<kWords>(sum, gsum);
                        } else if constexpr (kWords == 0) {  // full f32: log2 summed, scaled once at the end
#pragma unroll
                            for (int s = 0; s < kSlots; ++s) sum[s] += lg2_approx(prod[s]);
                        } else {
#pragma unroll
                            for (int s = 0; s < kSlots; ++s) prod[s] = lg2_approx(prod[s]) * kLn2;
                            add_rounded<kWords>(sum, prod);
                        }
                    }
                } else {
                    for (int c0 = 0; c0 < nt; c0 += group) {
                        float gsum[kSlots];
                        for (int c = 0; c < group; ++c) {
                            float a[kSlots];
                            arguments(buf + (c0 + c) * stride, off_a, off_b, off_c, off_d, a);
#pragma unroll
                            for (int s = 0; s < kSlots; ++s) {
                                const float v = kMode == kTermLog ? logf(fmaxf(a[s], 1e-30f)) : a[s];
                                gsum[s] = c == 0 ? v : gsum[s] + v;
                            }
                        }
                        add_rounded<kWords>(sum, gsum);
                    }
                }
                cur ^= 1;
            }
            constexpr bool kScaled = kMode == kProduct && kWords == 0 && !kChunked;
#pragma unroll
            for (int s = 0; s < kSlots; ++s) {
                const int g = entry[4 + s];
                if (g >= 0) row[g] = penalties[g] + (kScaled ? sum[s] * kLn2 : sum[s]);
            }
        }
        __syncwarp();
        float* out = logits + b * (int64_t)n_pg;
        for (int g = lane; g < n_pg; g += kWarp) out[g] = row[g];
    }
}

using Kernel = decltype(&group_kernel<0, kProduct, 1, false, true>);

template <bool kVec>
Kernel product_kernel(int n_words, int group) {
    // past 8 calls a group's log is the sum of its chunks' logs, in chunks of 4 (of 8, the chunk's 20
    // products beside the group's 20 sums spill)
    if (group > kMaxFold) return n_words == 0 ? &group_kernel<0, kProduct, 4, true, kVec>
                                              : &group_kernel<2, kProduct, 4, true, kVec>;
    if (n_words == 0) {
        return group == 1 ? &group_kernel<0, kProduct, 1, false, kVec> : group == 2 ? &group_kernel<0, kProduct, 2, false, kVec>
             : group == 4 ? &group_kernel<0, kProduct, 4, false, kVec> : &group_kernel<0, kProduct, 8, false, kVec>;
    }
    return group == 1 ? &group_kernel<2, kProduct, 1, false, kVec> : group == 2 ? &group_kernel<2, kProduct, 2, false, kVec>
         : group == 4 ? &group_kernel<2, kProduct, 4, false, kVec> : &group_kernel<2, kProduct, 8, false, kVec>;
}

template <bool kVec>
Kernel pick(int n_words, int use_log, int group) {
    if (!use_log) {
        return n_words == 0 ? &group_kernel<0, kNoLog, 1, false, kVec> : n_words == 1 ? &group_kernel<1, kNoLog, 1, false, kVec>
                                                                             : &group_kernel<2, kNoLog, 1, false, kVec>;
    }
    return n_words == 1 ? &group_kernel<1, kTermLog, 1, false, kVec> : product_kernel<kVec>(n_words, group);
}

}  // namespace

// u: the folded calls of the group layout [n_calls, n_donors]; group divides 32; schedule [n_passes, 32, 24]
// the tile schedule with the operands' columns; n_words in 0..2 (0: full f32). row_ptr and schedule as
// demux_variant_check passed them.
extern "C" int demux_group_logits(const float* u, int64_t n_calls, int n_donors, const int64_t* row_ptr,
                                  int64_t n_barcodes, int group, const int32_t* schedule, int n_passes,
                                  const float* penalties, int n_pg, float* logits, int n_words, int use_log,
                                  int device, void* stream) {
    if (n_barcodes <= 0 || n_pg <= 0 || n_donors <= 0 || n_calls < 0 || n_passes <= 0 || group < 1 ||
        kTileCalls % group != 0 || n_words < 0 || n_words > kMaxWords)
        return (int)cudaErrorInvalidValue;
    const demux::DeviceGuard guard(device);
    if (guard.status() != 0) return guard.status();
    cudaStream_t s = (cudaStream_t)stream;
    const int stride = 4 * ((n_donors + 3) / 4);
    const int row_floats = (n_pg + 3) & ~3;
    const size_t warp_bytes = ((size_t)2 * kTileCalls * stride + row_floats) * sizeof(float);
    int optin, n_sms, status;
    if ((status = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) != 0) return status;
    if ((status = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, device)) != 0) return status;
    const size_t shared = kWarps * warp_bytes;
    if (shared > (size_t)optin) return (int)cudaErrorInvalidValue;
    const bool vec = n_donors % 4 == 0 && demux::aligned16(u);
    const Kernel kernel = vec ? pick<true>(n_words, use_log, group) : pick<false>(n_words, use_log, group);
    if ((status = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared)) != 0)
        return status;
    int per_sm = 0;
    if ((status = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarps * kWarp, shared)) != 0)
        return status;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const int64_t wanted = (n_barcodes + kWarps - 1) / kWarps;
    const int64_t resident = (int64_t)per_sm * n_sms;
    const unsigned int grid = (unsigned int)(wanted < resident ? wanted : resident);
    kernel<<<grid, kWarps * kWarp, shared, s>>>(u, n_donors, stride, row_ptr, n_barcodes, group, schedule, n_passes,
                                                 penalties, n_pg, row_floats, logits);
    return (int)cudaGetLastError();
}
