// Hopper's mbarriers and bulk copies (TMA without a tensor map), as inline PTX for sm_90a.
//
// A bulk copy moves a 16-byte-aligned run of a multiple of 16 bytes from global to shared memory and reports its
// bytes to an mbarrier in the destination CTA (complete_tx); with .multicast::cluster one copy lands at the same
// offset in every CTA of a mask of the cluster, and on each one's mbarrier at the same offset. A barrier's phase
// completes when its pending arrivals reach 0 and its transaction count returns to 0; a wait names the parity of
// the phase it waits for. Remote arrivals (mapa + shared::cluster) reach the barrier at the same offset in another
// CTA of the cluster, with cluster-scope release.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace demux {

__device__ __forceinline__ uint32_t shared_address(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(shared_address(bar)), "r"(count) : "memory");
}

// makes the barriers this thread initialised visible to the cluster and to the async proxy
__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// waits for the completion of the phase of parity `parity`; kCluster: acquire at cluster scope (the arrivals came
// from other CTAs), else at CTA scope
template <bool kCluster = false>
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t address = shared_address(bar);
    uint32_t done;
    do {
        if constexpr (kCluster) {
            asm volatile(
                "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
                " selp.u32 %0, 1, 0, p;\n}\n"
                : "=r"(done)
                : "r"(address), "r"(parity)
                : "memory");
        } else {
            asm volatile(
                "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
                : "=r"(done)
                : "r"(address), "r"(parity)
                : "memory");
        }
    } while (!done);
}

// one arrival on this CTA's barrier
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("{\n .reg .b64 state;\n mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(shared_address(bar))
                 : "memory");
}

// one arrival, and `bytes` more expected, on this CTA's barrier
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("{\n .reg .b64 state;\n mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::"r"(
                     shared_address(bar)),
                 "r"(bytes)
                 : "memory");
}

// one arrival on the barrier at bar's offset in CTA `rank` of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t rank) {
    asm volatile(
        "{\n .reg .b32 remote;\n mapa.shared::cluster.u32 remote, %0, %1;\n"
        " mbarrier.arrive.release.cluster.shared::cluster.b64 _, [remote];\n}\n" ::"r"(shared_address(bar)),
        "r"(rank)
        : "memory");
}

// one arrival, and `bytes` more expected, on the barrier at bar's offset in CTA `rank` of the cluster
__device__ __forceinline__ void mbar_arrive_expect_tx_cluster(uint64_t* bar, uint32_t rank, uint32_t bytes) {
    asm volatile(
        "{\n .reg .b32 remote;\n mapa.shared::cluster.u32 remote, %0, %1;\n"
        " mbarrier.arrive.expect_tx.release.cluster.shared::cluster.b64 _, [remote], %2;\n}\n" ::"r"(
            shared_address(bar)),
        "r"(rank), "r"(bytes)
        : "memory");
}

// a bulk copy of `bytes` from global src to this CTA's shared dst, reported to bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                     shared_address(dst)),
                 "l"(src), "r"(bytes), "r"(shared_address(bar))
                 : "memory");
}

// the same copy to dst's offset in every CTA of `mask`, reported to the barrier at bar's offset in each
__device__ __forceinline__ void bulk_load_multicast(void* dst, const void* src, uint32_t bytes, uint64_t* bar,
                                                    uint16_t mask) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster [%0], [%1], %2, [%3], "
        "%4;\n" ::"r"(shared_address(dst)),
        "l"(src), "r"(bytes), "r"(shared_address(bar)), "h"(mask)
        : "memory");
}

}  // namespace demux
