// Banded M-step addition kernel for Hopper (sm_90a).
//
// Replaces benchmarks/inkernel_gather_kernels.py:_mstep_kernel_ig (:252),
// the TPU's in-kernel posterior-gather M-step. The barcodes are cut into K
// bands (edges[k], edges[k + 1]), each call carries a band-local barcode,
// and the calls lie band-major, a variant CSR per band (band_ptr [K,
// n_variants + 1]). For every variant v and donor d < n_donors:
//
//   addition[v, d] = sum_k sum_{calls c of v in band k} (post[edges[k] + cb_c, d] * (1 - q_c))^p,
//
// summed in band order, then in call order; a call with q >= 1 adds exactly
// 0. (The plain version, experiments/inkernel_gather.py, multiplies a
// banded table of post^p by (1 - q)^p, as the TPU kernel did: the same
// function in other roundings.)
//
// What bounds it on the H100: the mainline M-step's bound (mstep.cu), one
// 4·D-byte posterior row read per call from L2, plus the band CSR, K x (V +
// 1) row pointers read once (86 MB at the JAX harness's 82 bands, past the
// L2). The TPU kept one band of post^p in VMEM; on the H100 the posterior
// rows a run touches (8.4 MB at the bench shape) stay in L2 whatever, so
// nothing is staged on chip and the design is the mainline M-step's:
// - One warp per variant, lanes over donors. The warp walks the variant's
//   K segments band_ptr[k, v] .. band_ptr[k, v + 1] in band order, reading
//   the pointers of 32 bands at a time (lane j band k0 + j; the next 32
//   bands' pointers in flight while these are walked). A window's calls are
//   its segments' end to end; each lane finds its call's segment by a warp
//   scan and a binary search over the segments' first calls, so an empty
//   segment costs nothing and a sparse one no loop of its own.
// - The calls go through mstep.cu's 32-call tiles (mstep_tiles.cuh): lane
//   l loads tile slot l's call as (row offset (edges[k] + cb) * n_pg,
//   factor 1 - q), a tile fills across segments with no restart per band,
//   and up to kDepth posterior row reads go back to back before the first
//   is added. The power is folded in registers (call_term).
// No atomics: one warp owns a variant's sums, so two runs give the same
// bits. The edges, the band CSR and the band-local barcodes were
// bounds-checked once, when the operands were built (demux_banded_check,
// checks.cu), so a launch checks nothing.
#include "mstep_tiles.cuh"

namespace {

struct Banded {
    const float* posterior;     // [n_barcodes, n_pg]
    int n_pg, n_donors;
    const int64_t* band_edges;  // [n_bands + 1] barcode bands
    int n_bands;
    const int64_t* band_ptr;    // [n_bands, n_variants + 1] variant CSR per band over the band-major calls
    const int32_t* cb;          // [n_calls] band-local barcode
    const float* q;             // [n_calls]
    int64_t n_variants;
    float power;
    float* addition;            // [n_variants, n_donors]
};

// lane j's segment of a window: band k's calls of v from call lo, n of them, and the band's first barcode
struct Segment {
    int64_t lo;
    int n, first;
};

__device__ __forceinline__ Segment segment_of(const Banded& a, int64_t v, int k) {
    Segment s{0, 0, 0};
    if (k < a.n_bands) {
        const int64_t* ptr = a.band_ptr + (int64_t)k * (a.n_variants + 1) + v;
        s.lo = __ldg(ptr);
        s.n = (int)(__ldg(ptr + 1) - s.lo);
        s.first = (int)__ldg(a.band_edges + k);
    }
    return s;
}

// addition[v, lane's donor]: v's segments in band order, 32 bands a window (the next window's pointers in
// flight while this one's calls are summed). A window's calls are its segments' end to end; a tile takes the
// next of them whatever their segment (each lane finds its call's segment by a binary search over the
// segments' first calls, an empty segment taking none), and a tile fills across segments and windows
template <int kPower, int kDepth>
__device__ __forceinline__ float banded_sum(const Banded& a, const float* column, Stage& stage, int lane,
                                            int64_t v) {
    float acc = 0.f;
    int fill = 0;  // calls in the tile at hand; lane l < fill holds slot l's call
    uint32_t offset = 0;
    float f = 0.f;
    Segment next = segment_of(a, v, lane);
    for (int k0 = 0; k0 < a.n_bands; k0 += kWarpSize) {
        const Segment seg = next;
        if (k0 + kWarpSize < a.n_bands) next = segment_of(a, v, k0 + kWarpSize + lane);
        int start = seg.n;  // the window's calls before segment lane: an exclusive scan
#pragma unroll
        for (int o = 1; o < kWarpSize; o <<= 1) {
            const int x = __shfl_up_sync(kFullMask, start, o);
            if (lane >= o) start += x;
        }
        const int total = __shfl_sync(kFullMask, start, kWarpSize - 1);
        start -= seg.n;
        for (int t = 0; t < total;) {
            const int m = total - t < kTile - fill ? total - t : kTile - fill;
            const int g = t + lane - fill;  // this lane's call of the window, if fill <= lane < fill + m
            int j = 0;                      // its segment: the last that starts at or before it
#pragma unroll
            for (int step = kWarpSize / 2; step > 0; step >>= 1) {
                if (__shfl_sync(kFullMask, start, j + step) <= g) j += step;
            }
            const int64_t at = __shfl_sync(kFullMask, seg.lo, j) + (g - __shfl_sync(kFullMask, start, j));
            const uint32_t first = (uint32_t)__shfl_sync(kFullMask, seg.first, j);
            if (lane >= fill && lane < fill + m) {
                offset = (first + (uint32_t)__ldg(a.cb + at)) * (uint32_t)a.n_pg;
                f = call_factor(__ldg(a.q + at));
            }
            fill += m;
            t += m;
            if (fill == kTile) {
                stage_tile(stage, lane, offset, f);
                acc = add_tile<kPower, kDepth>(acc, column, stage, kTile, a.power);
                fill = 0;
            }
        }
    }
    if (fill > 0) {  // the last tile; slots past fill are never read
        stage_tile(stage, lane, offset, f);
        acc = add_tile<kPower, kDepth>(acc, column, stage, fill, a.power);
    }
    return acc;
}

// one warp per variant
template <int kPower, int kDepth>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarpSize) mstep_banded_kernel(Banded a) {
    const int64_t v = (int64_t)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarpSize;
    if (v >= a.n_variants) return;  // a whole warp
    const int lane = threadIdx.x % kWarpSize;
    __shared__ Stage stages[kWarpsPerBlock];
    Stage& stage = stages[threadIdx.x / kWarpSize];
    for (int d0 = 0; d0 < a.n_donors; d0 += kWarpSize) {
        const int d = d0 + lane;
        const bool active = d < a.n_donors;
        const float* column = a.posterior + (active ? d : a.n_donors - 1);  // idle lanes read a real column
        const float acc = banded_sum<kPower, kDepth>(a, column, stage, lane, v);
        if (active) a.addition[v * a.n_donors + d] = acc;
    }
}

template <int kPower, int kDepth>
void launch(const Banded& a, cudaStream_t stream) {
    const int64_t blocks = (a.n_variants + kWarpsPerBlock - 1) / kWarpsPerBlock;
    mstep_banded_kernel<kPower, kDepth><<<(unsigned int)blocks, kWarpsPerBlock * kWarpSize, 0, stream>>>(a);
}

}  // namespace

// band_edges [n_bands + 1] cut the posterior's barcode rows, band_ptr [n_bands, n_variants + 1] is each band's
// variant CSR over the band-major calls, cb is band-local; all three were checked by demux_banded_check when
// the operands were built. p = 1, 2 and 0.5 at 16 row reads in flight (the mainline's default), any other p > 0
// at 1 (powf is a call), as mstep.cu picks them.
extern "C" int demux_mstep_addition_banded(const float* posterior, int n_pg, int n_donors, const int64_t* band_edges,
                                           int n_bands, const int64_t* band_ptr, const int32_t* cb, const float* q,
                                           int64_t n_variants, float power, float* addition, int device,
                                           void* stream) {
    if (n_variants <= 0 || n_donors <= 0 || n_donors > n_pg || n_bands <= 0) return (int)cudaErrorInvalidValue;
    const demux::DeviceGuard guard(device);
    if (guard.status() != 0) return guard.status();
    const Banded a{posterior, n_pg, n_donors, band_edges, n_bands, band_ptr, cb, q, n_variants, power, addition};
    cudaStream_t s = (cudaStream_t)stream;
    if (power == 2.f) {
        launch<kPowerTwo, 16>(a, s);
    } else if (power == 1.f) {
        launch<kPowerOne, 16>(a, s);
    } else if (power == 0.5f) {
        launch<kPowerHalf, 16>(a, s);
    } else {
        launch<kPowerAny, 1>(a, s);
    }
    return (int)cudaGetLastError();
}
