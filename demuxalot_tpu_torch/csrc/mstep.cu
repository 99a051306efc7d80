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
// q >= 1 (padding) adds exactly 0 (for a finite posterior).
//
// The summation contract, with C = kChunkCalls:
// - a variant of at most C calls: each (v, d) sum is one chain in call
//   order from +0, acc = acc + term;
// - a variant of more than C calls: its calls are cut in call order into
//   chunks of C (the last holds the rest); each chunk's sum is one such
//   chain from +0, and the addition is the chain of the chunk sums in chunk
//   order from +0.
// Every multiply and add is rounded on its own (__fmul_rn / __fadd_rn, never
// contracted into an FMA), so a PyTorch loop that adds term by term, chunk by
// chunk, gives the same bits (tests/torch_problems.py:in_order_addition).
// An output depends only on the data and C: not on the launch, the SM count
// or which warp finishes first.
//
// What bounds it on the H100: one 4·D-byte posterior row slice per call
// (128 bytes at 32 donors: 537 MB of reads at the bench shape, out of 8 MB of
// distinct rows that stay in L2), so the L2's latency and rate, and the
// instructions issued per call, not HBM bytes (the HBM bound counts each row
// once). The first version walked the calls one by one, two dependent
// broadcast loads (q, cb) and then the row read. Here
// - lanes run over donors, so each row read is one coalesced segment;
// - a warp loads its calls' cb and q in tiles of 32 and stages them in
//   shared memory as (row offset cb * n_pg, factor) pairs, then issues
//   kDepth row reads back to back before the first is added
//   (mstep_tiles.cuh, shared with the banded M-step in banded.cu);
// - one warp owns a unit of the work plan (ops/mstep_kernel.py:mstep_plan,
//   built once per dataset): a whole SNP run (each variant a run without SNP
//   runs) where no variant of it has more than C calls, summed variant by
//   variant; else one chunk of one of its variants. A warp walks at most
//   max(C, the calls of a run of short variants) calls, so a pool's most
//   expressed SNP no longer holds the launch on one warp. Units come
//   heaviest first.
// A chunk's warp writes its sums to the chunk's slot of `partials`, fences,
// and takes a ticket of its run; the warp that takes the run's last ticket
// chains the run's slots in chunk order, writes the additions, runs the
// epilogue and puts the ticket back to 0 for the next launch (and a CUDA
// graph's replays). Launches that share a plan are ordered by their stream.
// More donors than lanes loop in blocks of 32 (idle lanes read a real column
// and store nothing). Each output is written once, by one warp.
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
#include "checks.cuh"
#include "mstep_tiles.cuh"

namespace {

constexpr int kMaxRun = 6;         // ops/packing.py:MAX_WINDOWED_RUN
constexpr int kChunkCalls = 1024;  // ops/mstep_kernel.py:CHUNK_CALLS

struct Calls {
    const float* posterior;  // [n_barcodes, n_pg]
    int n_pg, n_donors;
    const int64_t* var_ptr;  // [n_variants + 1] variant CSR over the calls
    const int32_t* cb;       // [n_calls], (vid, cb)-sorted
    const float* q;          // [n_calls]
    const int64_t* snp_ptr;  // [n_runs + 1] SNP runs over the variants, or null: each variant a run
    float power;
    float* addition;         // [n_variants, n_donors]
};

// The work plan (ops/mstep_kernel.py:mstep_plan), built once per dataset
struct Plan {
    const int32_t* units;   // [n_units], heaviest first: r >= 0 the whole run r, -1 - c chunk c
    int64_t n_units;
    const int32_t* chunks;  // [n_chunks, 3]: (variant, chunk of the variant, split run)
    const int32_t* split;   // [n_split, 3]: (run, first slot, chunks), a run's slots in variant and chunk order
    int32_t* tickets;       // [n_split], 0 between launches
    float* partials;        // [n_chunks, n_donors]: chunk c's sums in slot c
};

struct Epilogue {
    const float* prior;    // [n_variants, n_donors] prior betas
    const float* mask;     // [n_variants] anchor mask (0 or 1), or null
    float floor, lo, hi;   // denominator floor and clip bounds
    float* genotype_prob;  // [n_variants, n_donors]
};

// asynchronous 4-byte copy from global to shared memory (read dst after
// cp.async.wait_all)
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// torch.clamp: a NaN passes through
__device__ __forceinline__ float clamp_min(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }
__device__ __forceinline__ float clamp(float x, float lo, float hi) { return isnan(x) ? x : fminf(fmaxf(x, lo), hi); }

// the chunks of a variant of n calls: one for at most kChunkCalls (none left out, an empty variant too)
__device__ __forceinline__ int64_t chunks_of(int64_t n) {
    return n > kChunkCalls ? (n + kChunkCalls - 1) / kChunkCalls : 1;
}

// addition[v, lane's donor] of the calls [lo, hi), in order: tiles of kTile
// calls staged in shared memory, summed by add_tile
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
        stage_tile(stage, lane, offset, f);
        acc = add_tile<kPower, kDepth>(acc, column, stage, n, a.power);
    }
    return acc;
}

// mstep_update: a warp's run, one column per lane: its prior betas, copied
// in while the sums run, and its masked additions
struct RunRows {
    float prior[kMaxRun][kWarpSize];
    float addition[kMaxRun][kWarpSize];
};

// Run `index`'s additions (and, kUpdate, its genotype probabilities), one
// column per lane; variant_addition(j, lo, hi, column, dd) gives the addition
// of the run's variant j, whose calls are [lo, hi), at donor column dd. Runs
// are snp_ptr's where it is set, else single variants
template <bool kUpdate, class Addition>
__device__ __forceinline__ void write_run(const Calls& a, const Epilogue& ep, RunRows& run, int lane, int64_t index,
                                           Addition variant_addition) {
    int64_t v0 = index;
    int n_var = 1;
    if (a.snp_ptr != nullptr) {
        v0 = __ldg(a.snp_ptr + index);
        n_var = (int)(__ldg(a.snp_ptr + index + 1) - v0);
    }
    // lane j <= n_var holds var_ptr[v0 + j]: the run's call boundaries
    const int64_t my_ptr = lane <= n_var ? __ldg(a.var_ptr + v0 + lane) : 0;
    float my_mask = 1.f;  // lane j < n_var: variant v0 + j's anchor mask
    if constexpr (kUpdate) {
        if (ep.mask != nullptr && lane < n_var) my_mask = __ldg(ep.mask + v0 + lane);
    }

    for (int d0 = 0; d0 < a.n_donors; d0 += kWarpSize) {
        const int d = d0 + lane;
        const bool active = d < a.n_donors;
        const int dd = active ? d : a.n_donors - 1;  // idle lanes read a real column and store nothing
        if constexpr (kUpdate) {
            if (active) {
                for (int r = 0; r < n_var; ++r) cp_async4(&run.prior[r][lane], ep.prior + (v0 + r) * a.n_donors + d);
            }
            asm volatile("cp.async.commit_group;\n" ::: "memory");
        }
        for (int j = 0; j < n_var; ++j) {
            const int64_t lo = __shfl_sync(kFullMask, my_ptr, j);
            const int64_t hi = __shfl_sync(kFullMask, my_ptr, j + 1);
            float add = variant_addition(j, lo, hi, a.posterior + dd, dd);
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

// Blocks an SM that an instantiation's registers must allow; ptxas then works to a cap of 65,536 / (256 threads
// x blocks) registers: 64 for p = 1 and 2, at which no instantiation spills and the chunk walks keep their 16 row
// reads in flight (capped at 48 the chunked M-step took 1.3x the time); 128 for the powers that call powf or the
// IEEE sqrt
constexpr int min_blocks(int power) { return power == kPowerAny || power == kPowerHalf ? 2 : 4; }

// One warp per unit of the plan: units[i] >= 0 the whole run units[i], each variant one chain in call order; else
// chunk -1 - units[i] of a run's variant
template <int kPower, int kDepth, bool kUpdate>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarpSize, min_blocks(kPower))
    mstep_kernel(Calls a, Plan plan, Epilogue ep) {
    const int64_t i = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarpSize;
    if (i >= plan.n_units) return;  // a whole warp
    const int lane = threadIdx.x % kWarpSize;
    __shared__ Stage stages[kWarpsPerBlock];
    Stage& stage = stages[threadIdx.x / kWarpSize];
    __shared__ RunRows runs[kUpdate ? kWarpsPerBlock : 1];
    RunRows& run = runs[kUpdate ? threadIdx.x / kWarpSize : 0];
    int32_t unit = __ldg(plan.units + i);
    int first = -1;  // a split run's first slot; -1: a whole run

    if (unit < 0) {  // chunk c: calls [lo, hi) of its variant, one chain into slot c
        const int64_t c = -1 - (int64_t)unit;
        const int v = __ldg(plan.chunks + 3 * c), k = __ldg(plan.chunks + 3 * c + 1);
        const int s = __ldg(plan.chunks + 3 * c + 2);
        const int64_t end = __ldg(a.var_ptr + v + 1);
        const int64_t lo = __ldg(a.var_ptr + v) + (int64_t)k * kChunkCalls;
        const int64_t hi = lo + kChunkCalls < end ? lo + kChunkCalls : end;
        for (int d0 = 0; d0 < a.n_donors; d0 += kWarpSize) {
            const int d = d0 + lane;
            const bool active = d < a.n_donors;
            const float* column = a.posterior + (active ? d : a.n_donors - 1);
            const float acc = variant_sum<kPower, kDepth>(a, column, stage, lane, lo, hi);
            if (active) plan.partials[c * a.n_donors + d] = acc;
        }
        __threadfence();  // the slot before the ticket
        __syncwarp();
        int ticket = 0;
        if (lane == 0) ticket = atomicAdd(plan.tickets + s, 1);
        ticket = __shfl_sync(kFullMask, ticket, 0);
        if (ticket != __ldg(plan.split + 3 * s + 2) - 1) return;  // another warp of the run finishes it
        // the run's last chunk: every chunk of the run has taken its ticket and written its slot
        if (lane == 0) plan.tickets[s] = 0;  // for the next launch
        __threadfence();
        unit = __ldg(plan.split + 3 * s);
        first = __ldg(plan.split + 3 * s + 1);
    }

    int slot = first;
    const auto addition = [&](int j, int64_t from, int64_t to, const float* column, int dd) {
        if (first < 0) return variant_sum<kPower, kDepth>(a, column, stage, lane, from, to);
        if (j == 0) slot = first;  // each block of donors walks the run's slots again
        const int n = (int)chunks_of(to - from);
        const float* sums = plan.partials + (int64_t)slot * a.n_donors + dd;
        float acc = 0.f;
        for (int t = 0; t < n; ++t) acc = __fadd_rn(acc, __ldcg(sums + (int64_t)t * a.n_donors));
        slot += n;
        return acc;
    };
    write_run<kUpdate>(a, ep, run, lane, unit, addition);
}

template <int kPower, int kDepth, bool kUpdate>
void launch(const Calls& a, const Plan& plan, const Epilogue& ep, cudaStream_t stream) {
    const int64_t blocks = (plan.n_units + kWarpsPerBlock - 1) / kWarpsPerBlock;
    mstep_kernel<kPower, kDepth, kUpdate><<<(unsigned int)blocks, kWarpsPerBlock * kWarpSize, 0, stream>>>(a, plan, ep);
}

// Each power at a fixed depth: 16 for p = 2 (the engine's power; of depths 1 to 16 the fastest on an H100,
// PERF.md), for the others where ptxas spills nothing (powf and the IEEE sqrt are calls)
template <bool kUpdate>
int launch_power(const Calls& a, const Plan& plan, const Epilogue& ep, cudaStream_t stream) {
    if (plan.n_units <= 0 || plan.units == nullptr || a.n_donors <= 0 || a.n_donors > a.n_pg) {
        return (int)cudaErrorInvalidValue;
    }
    if (a.power == 2.f) {
        launch<kPowerTwo, 16, kUpdate>(a, plan, ep, stream);
    } else if (a.power == 1.f) {
        launch<kPowerOne, 16, kUpdate>(a, plan, ep, stream);
    } else if (a.power == 0.5f) {
        launch<kPowerHalf, 16, kUpdate>(a, plan, ep, stream);
    } else {
        launch<kPowerAny, 1, kUpdate>(a, plan, ep, stream);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// var_ptr is a CSR over the calls and every cb lies in [0, n_barcodes):
// traps otherwise. Run once per dataset, when the operands are built.
extern "C" int demux_mstep_check(const int64_t* var_ptr, int64_t n_variants, int64_t n_calls, const int32_t* cb,
                                 int64_t n_barcodes, int device, void* stream) {
    const demux::DeviceGuard guard(device);
    if (guard.status() != 0) return guard.status();
    cudaStream_t s = (cudaStream_t)stream;
    int status;
    if ((status = demux_check_csr(var_ptr, n_variants, n_calls, s)) != 0) return status;
    return demux_check_index(cb, n_calls, n_barcodes, s);
}

// snp_ptr: runs of variants covering [0, n_variants), or null (each variant a run); the plan's tables are over
// those runs (ops/mstep_kernel.py:mstep_plan)
extern "C" int demux_mstep_addition(const float* posterior, int n_pg, int n_donors, const int64_t* var_ptr,
                                    const int32_t* cb, const float* q, const int64_t* snp_ptr, const int32_t* units,
                                    int64_t n_units, const int32_t* chunks, const int32_t* split, int32_t* tickets,
                                    float* partials, float power, float* addition, int device, void* stream) {
    const Calls a{posterior, n_pg, n_donors, var_ptr, cb, q, snp_ptr, power, addition};
    const Plan plan{units, n_units, chunks, split, tickets, partials};
    const demux::DeviceGuard guard(device);
    if (guard.status() != 0) return guard.status();
    return launch_power<false>(a, plan, Epilogue{}, (cudaStream_t)stream);
}

// snp_ptr: runs of 1..kMaxRun variants covering [0, n_variants) (checked on the host); the plan as above
extern "C" int demux_mstep_update(const float* posterior, int n_pg, int n_donors, const int64_t* var_ptr,
                                  const int32_t* cb, const float* q, const int64_t* snp_ptr, const int32_t* units,
                                  int64_t n_units, const int32_t* chunks, const int32_t* split, int32_t* tickets,
                                  float* partials, float power, const float* prior, const float* mask, float floor,
                                  float lo, float hi, float* addition, float* genotype_prob, int device,
                                  void* stream) {
    if (snp_ptr == nullptr) return (int)cudaErrorInvalidValue;
    const Calls a{posterior, n_pg, n_donors, var_ptr, cb, q, snp_ptr, power, addition};
    const Plan plan{units, n_units, chunks, split, tickets, partials};
    const Epilogue ep{prior, mask, floor, lo, hi, genotype_prob};
    const demux::DeviceGuard guard(device);
    if (guard.status() != 0) return guard.status();
    return launch_power<true>(a, plan, ep, (cudaStream_t)stream);
}
