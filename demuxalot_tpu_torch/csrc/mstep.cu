// M-step kernels for Hopper (sm_90a): the beta addition, and the same
// addition with the next EM iteration's genotype probabilities computed in
// its epilogue.
//
// Replaces demuxalot_tpu/ops/pallas_mstep.py:_mstep_kernel together with the
// posterior gather XLA ran before it (pallas_mstep.py, tiled_mstep_impl);
// mstep_update also replaces the genotype normalisation that followed it
// (demuxalot_tpu/ops/likelihood.py:probs_from_betas, windowed branch).
// For every variant v and donor d < n_donors
//
//   addition[v, d] = sum_{calls c of v, in (vid, cb) order} (post[cb_c, d] * (1 - q_c))^p
//
// over the singlet columns of the [n_barcodes, n_pg] posterior. A call with
// q >= 1 (padding) adds exactly 0 (for a finite posterior). Each (v, d) sum is one chain in
// call order, acc = acc + term, and every multiply and add is rounded on its
// own (__fmul_rn / __fadd_rn, never contracted into an FMA): a PyTorch loop
// that adds term by term in separate launches gives the same bits.
//
// What bounds it on the H100: one 4·D-byte posterior row slice per call
// (128 bytes at 32 donors: 537 MB of reads at the bench shape, out of 8 MB of
// distinct rows that stay in L2), so the L2's latency and rate, and the
// instructions issued per call, not HBM bytes (the HBM bound counts each row
// once). The first version walked the calls one by one, two dependent
// broadcast loads (q, cb) and then the row read. Here
// - lanes run over donors, so each row read is one coalesced segment;
// - a warp loads its calls' cb and q in tiles of 32 (lane l reads call
//   c0 + l, turns cb into the 32-bit row offset cb * n_pg and q into the
//   factor 1 - q, or 0 for q >= 1) and stages them in shared memory, where
//   one broadcast 16-byte load hands out two calls (handed out by shuffles,
//   with 64-bit row offsets, a call took about twice the instructions);
// - kDepth row reads (ld.global.nc) are issued back to back before the first
//   is added, so up to kDepth round trips overlap in each warp; a tile's
//   rest goes in groups of 4, 2 and 1: no per-call predicate or bounds test;
// - one warp owns a unit: one variant (mstep_addition) or one SNP run of at
//   most kMaxRun variants (mstep_update), summed variant by variant.
// More donors than lanes loop in blocks of 32 (idle lanes read a real column
// and store nothing). No atomics: each output is written once, so two runs
// give the same bits.
//
// The epilogue (mstep_update): the warp owns its SNP run's <= 6 variants.
// Each lane's prior column of the run is copied into shared memory with
// cp.async while the sums run, and each masked addition is kept there too
// (betas held in registers across the sum loop cost it half its occupancy,
// and a read after the loop a round trip); then the lane holds the run's
// betas in registers and writes
//   genotype_prob[v, d] = clip(betas[v, d] / max(denom, floor), lo, hi),
//   denom = b[v], then + b[v+1], + b[v-1], + b[v+2], + b[v-2], ... within the run,
// the order of probs_from_betas' windowed sum (ops/likelihood.py), with IEEE
// division (no fast math) and the bounds as f32 values rounded on the host,
// so the result is that function's bits on the kernel's own addition.
//
// Bounds checks: demux_mstep_check runs checks.cu's kernels over var_ptr and
// cb once, when the operands are built (ops/mstep_kernel.py:mstep_operands);
// the launches read indices that are already checked, and carry no trap.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

int demux_check_index(const int32_t* idx, int64_t n, int64_t limit, cudaStream_t stream);
int demux_check_csr(const int64_t* row_ptr, int64_t n_rows, int64_t n_entries, cudaStream_t stream);

namespace {

using demux::kFullMask;
using demux::kWarpSize;

constexpr int kWarpsPerBlock = 8;
constexpr int kTile = 32;   // calls per index tile: one per lane
constexpr int kMaxRun = 6;  // ops/packing.py:MAX_WINDOWED_RUN
enum PowerKind { kPowerAny = 0, kPowerOne = 1, kPowerTwo = 2, kPowerHalf = 3 };

struct Calls {
    const float* posterior;  // [n_barcodes, n_pg]
    int n_pg, n_donors;
    const int64_t* var_ptr;  // [n_variants + 1] variant CSR over the calls
    const int32_t* cb;       // [n_calls], (vid, cb)-sorted
    const float* q;          // [n_calls]
    const int64_t* snp_ptr;  // [n_units + 1] SNP runs over the variants (update), else null
    int64_t n_units;         // SNP runs (update) or variants
    float power;
    float* addition;         // [n_variants, n_donors]
};

struct Epilogue {
    const float* prior;    // [n_variants, n_donors] prior betas
    const float* mask;     // [n_variants] anchor mask (0 or 1), or null
    float floor, lo, hi;   // denominator floor and clip bounds
    float* genotype_prob;  // [n_variants, n_donors]
};

// A call's factor, computed once per call by the lane that loads it: 1 - q,
// or 0 for q >= 1 (padding). A zero factor makes the term +0 at p = 1, 2 and
// 0.5 for any finite posterior, so the sum takes no select; at any other p
// (powf(0, p) need not be 0) the term keeps one.
__device__ __forceinline__ float call_factor(float q) { return q >= 1.f ? 0.f : __fsub_rn(1.f, q); }

// (post * f)^p; torch's pow takes sqrt at p = 0.5
template <int kPower>
__device__ __forceinline__ float call_term(float post, float f, float power) {
    const float w = __fmul_rn(post, f);
    if constexpr (kPower == kPowerTwo) return __fmul_rn(w, w);
    else if constexpr (kPower == kPowerOne) return w;
    else if constexpr (kPower == kPowerHalf) return __fsqrt_rn(w);
    else return f == 0.f ? 0.f : powf(w, power);  // f == 0 exactly when q >= 1
}

// asynchronous 4-byte copy from global to shared memory (read dst after
// cp.async.wait_all)
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// torch.clamp: a NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }
__device__ __forceinline__ float clamp(float x, float lo, float hi) { return isnan(x) ? x : fminf(fmaxf(x, lo), hi); }

// A tile's calls as the warp reads them: (row offset cb * n_pg, factor bits),
// two calls per 16 bytes, so one broadcast shared-memory load hands out two
// calls (where shuffles took two instructions per call)
struct Stage {
    uint4 pair[kTile / 2];
    __device__ __forceinline__ void call(int k, uint32_t& offset, float& f) const {
        const uint4 p = pair[k / 2];
        offset = k % 2 ? p.z : p.x;
        f = __uint_as_float(k % 2 ? p.w : p.y);
    }
};

// kN calls of the staged tile from slot k0 (even when kN > 1): all kN row
// reads are issued before the first is added, and the sum stays in call order
template <int kPower, int kN>
__device__ __forceinline__ float add_calls(float acc, const float* column, const Stage& stage, int k0, float power) {
    float x[kN], f[kN];
    if constexpr (kN == 1) {
        uint32_t offset;
        stage.call(k0, offset, f[0]);
        x[0] = __ldg(column + offset);
    } else {
#pragma unroll
        for (int k = 0; k < kN; k += 2) {
            const uint4 p = stage.pair[(k0 + k) / 2];
            x[k] = __ldg(column + p.x);
            x[k + 1] = __ldg(column + p.z);
            f[k] = __uint_as_float(p.y);
            f[k + 1] = __uint_as_float(p.w);
        }
    }
#pragma unroll
    for (int k = 0; k < kN; ++k) acc = __fadd_rn(acc, call_term<kPower>(x[k], f[k], power));
    return acc;
}

// addition[v, lane's donor] of the calls [lo, hi), in order: tiles of kTile
// calls staged in shared memory, groups of kDepth row reads in flight, the
// tile's rest in groups of 4, 2 and 1
template <int kPower, int kDepth>
__device__ __forceinline__ float variant_sum(const Calls& a, const float* column, Stage& stage, int lane, int64_t lo,
                                             int64_t hi) {
    float acc = 0.f;
    for (int64_t c0 = lo; c0 < hi; c0 += kTile) {
        const int n = hi - c0 < kTile ? (int)(hi - c0) : kTile;
        uint32_t offset = 0;
        float f = 0.f;
        if (lane < n) {
            offset = (uint32_t)__ldg(a.cb + c0 + lane) * (uint32_t)a.n_pg;
            f = call_factor(__ldg(a.q + c0 + lane));
        }
        __syncwarp();  // the previous tile is read
        uint32_t* slot = reinterpret_cast<uint32_t*>(&stage.pair[lane / 2]) + 2 * (lane % 2);
        slot[0] = offset;
        slot[1] = __float_as_uint(f);
        __syncwarp();
        int k0 = 0;
        for (; k0 + kDepth <= n; k0 += kDepth) acc = add_calls<kPower, kDepth>(acc, column, stage, k0, a.power);
        if constexpr (kDepth > 4) {
            for (; k0 + 4 <= n; k0 += 4) acc = add_calls<kPower, 4>(acc, column, stage, k0, a.power);
        }
        if constexpr (kDepth > 2) {
            if (k0 + 2 <= n) {
                acc = add_calls<kPower, 2>(acc, column, stage, k0, a.power);
                k0 += 2;
            }
        }
        if constexpr (kDepth > 1) {
            if (k0 < n) acc = add_calls<kPower, 1>(acc, column, stage, k0, a.power);
        }
    }
    return acc;
}

// mstep_update: a warp's run, one column per lane: its prior betas, copied
// in while the sums run, and its masked additions
struct RunRows {
    float prior[kMaxRun][kWarpSize];
    float addition[kMaxRun][kWarpSize];
};

// one warp per unit: variant `unit` (addition only) or SNP run `unit` (kUpdate)
template <int kPower, int kDepth, bool kUpdate>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarpSize) mstep_kernel(Calls a, Epilogue ep) {
    static_assert(kTile % kDepth == 0 && (kDepth == 1 || kDepth % 2 == 0), "groups divide the tile, in pairs");
    const int64_t unit = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarpSize;
    if (unit >= a.n_units) return;  // a whole warp
    const int lane = threadIdx.x % kWarpSize;
    __shared__ Stage stages[kWarpsPerBlock];
    Stage& stage = stages[threadIdx.x / kWarpSize];
    __shared__ RunRows runs[kUpdate ? kWarpsPerBlock : 1];
    RunRows& run = runs[kUpdate ? threadIdx.x / kWarpSize : 0];
    int64_t v0 = unit;
    int n_var = 1;
    if constexpr (kUpdate) {
        v0 = __ldg(a.snp_ptr + unit);
        n_var = (int)(__ldg(a.snp_ptr + unit + 1) - v0);
    }
    // lane j <= n_var holds var_ptr[v0 + j]: the unit's call boundaries
    const int64_t my_ptr = lane <= n_var ? __ldg(a.var_ptr + v0 + lane) : 0;
    float my_mask = 1.f;  // lane j < n_var: variant v0 + j's anchor mask
    if constexpr (kUpdate) {
        if (ep.mask != nullptr && lane < n_var) my_mask = __ldg(ep.mask + v0 + lane);
    }

    for (int d0 = 0; d0 < a.n_donors; d0 += kWarpSize) {
        const int d = d0 + lane;
        const bool active = d < a.n_donors;
        const int dd = active ? d : a.n_donors - 1;  // idle lanes read a real column and store nothing
        const float* column = a.posterior + dd;
        if constexpr (kUpdate) {
            if (active) {
                for (int r = 0; r < n_var; ++r) cp_async4(&run.prior[r][lane], ep.prior + (v0 + r) * a.n_donors + d);
            }
            asm volatile("cp.async.commit_group;\n" ::: "memory");
        }
        for (int j = 0; j < n_var; ++j) {
            const int64_t lo = __shfl_sync(kFullMask, my_ptr, j);
            const int64_t hi = __shfl_sync(kFullMask, my_ptr, j + 1);
            float add = variant_sum<kPower, kDepth>(a, column, stage, lane, lo, hi);
            if constexpr (kUpdate) {
                add = __fmul_rn(add, __shfl_sync(kFullMask, my_mask, j));  // exact for 0/1
                run.addition[j][lane] = add;
            }
            if (active) a.addition[(v0 + j) * a.n_donors + d] = add;
        }
        if constexpr (kUpdate) {
            asm volatile("cp.async.wait_all;\n" ::: "memory");  // each lane reads only its own column
            float betas[kMaxRun];  // the run's prior + masked addition, in registers
#pragma unroll
            for (int r = 0; r < kMaxRun; ++r) betas[r] = r < n_var ? __fadd_rn(run.prior[r][lane], run.addition[r][lane]) : 0.f;
#pragma unroll
            for (int r = 0; r < kMaxRun; ++r) {
                if (r < n_var) {
                    float denom = betas[r];
#pragma unroll
                    for (int s = 1; s < kMaxRun; ++s) {
                        const int up = r + s < kMaxRun ? r + s : kMaxRun - 1;  // a constant after unrolling
                        const int down = r - s >= 0 ? r - s : 0;
                        if (r + s < n_var) denom = __fadd_rn(denom, betas[up]);
                        if (r - s >= 0) denom = __fadd_rn(denom, betas[down]);
                    }
                    const float p = clamp(__fdiv_rn(betas[r], clamp_min(denom, ep.floor)), ep.lo, ep.hi);
                    if (active) ep.genotype_prob[(v0 + r) * a.n_donors + d] = p;
                }
            }
        }
    }
}

template <int kPower, int kDepth, bool kUpdate>
void launch(const Calls& a, const Epilogue& ep, cudaStream_t stream) {
    const int64_t blocks = (a.n_units + kWarpsPerBlock - 1) / kWarpsPerBlock;
    mstep_kernel<kPower, kDepth, kUpdate><<<(unsigned int)blocks, kWarpsPerBlock * kWarpSize, 0, stream>>>(a, ep);
}

// p = 2 (the engine's power) at the asked depth; the other powers at a fixed
// one, chosen where ptxas spills nothing (powf and the IEEE sqrt are calls)
template <bool kUpdate>
int launch_power(int depth, const Calls& a, const Epilogue& ep, cudaStream_t stream) {
    if (a.n_units <= 0 || a.n_donors <= 0 || a.n_donors > a.n_pg) return (int)cudaErrorInvalidValue;
    if (a.power == 2.f) {
        switch (depth) {
            case 1: launch<kPowerTwo, 1, kUpdate>(a, ep, stream); break;
            case 2: launch<kPowerTwo, 2, kUpdate>(a, ep, stream); break;
            case 4: launch<kPowerTwo, 4, kUpdate>(a, ep, stream); break;
            case 8: launch<kPowerTwo, 8, kUpdate>(a, ep, stream); break;
            case 16: launch<kPowerTwo, 16, kUpdate>(a, ep, stream); break;
            default: return (int)cudaErrorInvalidValue;
        }
    } else if (a.power == 1.f) {
        launch<kPowerOne, 16, kUpdate>(a, ep, stream);
    } else if (a.power == 0.5f) {
        launch<kPowerHalf, 16, kUpdate>(a, ep, stream);
    } else {
        launch<kPowerAny, 1, kUpdate>(a, ep, stream);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// var_ptr is a CSR over the calls and every cb lies in [0, n_barcodes):
// traps otherwise. Run once per dataset, when the operands are built.
extern "C" int demux_mstep_check(const int64_t* var_ptr, int64_t n_variants, int64_t n_calls, const int32_t* cb,
                                 int64_t n_barcodes, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    int status;
    if ((status = demux_check_csr(var_ptr, n_variants, n_calls, s)) != 0) return status;
    return demux_check_index(cb, n_calls, n_barcodes, s);
}

extern "C" int demux_mstep_addition(const float* posterior, int n_pg, int n_donors, const int64_t* var_ptr,
                                    const int32_t* cb, const float* q, int64_t n_variants, float power, int depth,
                                    float* addition, void* stream) {
    const Calls a{posterior, n_pg, n_donors, var_ptr, cb, q, nullptr, n_variants, power, addition};
    return launch_power<false>(depth, a, Epilogue{}, (cudaStream_t)stream);
}

// snp_ptr: runs of 1..kMaxRun variants covering [0, n_variants) (checked on the host)
extern "C" int demux_mstep_update(const float* posterior, int n_pg, int n_donors, const int64_t* var_ptr,
                                  const int32_t* cb, const float* q, const int64_t* snp_ptr, int64_t n_runs,
                                  float power, const float* prior, const float* mask, float floor, float lo,
                                  float hi, int depth, float* addition, float* genotype_prob, void* stream) {
    const Calls a{posterior, n_pg, n_donors, var_ptr, cb, q, snp_ptr, n_runs, power, addition};
    const Epilogue ep{prior, mask, floor, lo, hi, genotype_prob};
    return launch_power<true>(depth, a, ep, (cudaStream_t)stream);
}
