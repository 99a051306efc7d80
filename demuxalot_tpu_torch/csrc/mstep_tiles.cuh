// The M-step's call tiles, shared by the mainline M-step (mstep.cu) and the
// banded M-step (banded.cu).
//
// A warp sums the calls of one output row, lanes over donors, in tiles of
// 32 calls: lane l loads call l of the tile and turns its barcode row into
// the 32-bit row offset row * n_pg and its q into the factor 1 - q (0 for
// q >= 1, padding); stage_tile puts the pairs in the warp's shared memory,
// two calls per 16 bytes, so one broadcast load hands out two calls (handed
// out by shuffles, with 64-bit row offsets, a call took about twice the
// instructions); add_tile adds the terms (post[offset + d] * f)^p in call
// order, kDepth row reads (ld.global.nc) issued back to back before the
// first is added, so up to kDepth round trips overlap in each warp, and
// the tile's rest in groups of 4, 2 and 1: no per-call predicate or bounds
// test. Every multiply and add is rounded on its own (__fmul_rn /
// __fadd_rn, never contracted into an FMA), so a PyTorch loop that adds term
// by term gives the same bits, and a call with q >= 1 adds exactly 0 (for a
// finite posterior).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using demux::kFullMask;
using demux::kWarpSize;

constexpr int kWarpsPerBlock = 8;
constexpr int kTile = 32;  // calls per index tile: one per lane
enum PowerKind { kPowerAny = 0, kPowerOne = 1, kPowerTwo = 2, kPowerHalf = 3 };

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

// A tile's calls as the warp reads them: (row offset, factor bits), two
// calls per 16 bytes
struct Stage {
    uint4 pair[kTile / 2];
    __device__ __forceinline__ void call(int k, uint32_t& offset, float& f) const {
        const uint4 p = pair[k / 2];
        offset = k % 2 ? p.z : p.x;
        f = __uint_as_float(k % 2 ? p.w : p.y);
    }
};

// lane's call (offset, factor) into slot `lane` of the warp's stage
__device__ __forceinline__ void stage_tile(Stage& stage, int lane, uint32_t offset, float f) {
    __syncwarp();  // the previous tile is read
    uint32_t* slot = reinterpret_cast<uint32_t*>(&stage.pair[lane / 2]) + 2 * (lane % 2);
    slot[0] = offset;
    slot[1] = __float_as_uint(f);
    __syncwarp();
}

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

// acc + the terms of the staged tile's first n calls, in order: groups of
// kDepth row reads in flight, the rest in groups of 4, 2 and 1
template <int kPower, int kDepth>
__device__ __forceinline__ float add_tile(float acc, const float* column, const Stage& stage, int n, float power) {
    static_assert(kTile % kDepth == 0 && (kDepth == 1 || kDepth % 2 == 0), "groups divide the tile, in pairs");
    int k0 = 0;
    for (; k0 + kDepth <= n; k0 += kDepth) acc = add_calls<kPower, kDepth>(acc, column, stage, k0, power);
    if constexpr (kDepth > 4) {
        for (; k0 + 4 <= n; k0 += 4) acc = add_calls<kPower, 4>(acc, column, stage, k0, power);
    }
    if constexpr (kDepth > 2) {
        if (k0 + 2 <= n) {
            acc = add_calls<kPower, 2>(acc, column, stage, k0, power);
            k0 += 2;
        }
    }
    if constexpr (kDepth > 1) {
        if (k0 < n) acc = add_calls<kPower, 1>(acc, column, stage, k0, power);
    }
    return acc;
}

}  // namespace
