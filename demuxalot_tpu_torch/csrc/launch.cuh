// What a launch asks the card, asked once and cached for the library: per device its SMs and the shared memory a
// block may opt in to; per (device, kernel) the shared-memory attribute, raised to that opt-in once (the attribute
// is the kernel's, so a launch that set it to its own bytes would refuse a later, larger one); per (device, kernel,
// threads, shared bytes) the blocks the occupancy calculator places on an SM.
#pragma once

#include <cuda_runtime.h>

#include <mutex>
#include <vector>

namespace demux {

struct Card {
    int device, n_sms, optin;
};

struct LaunchPlan {
    int device;
    const void* kernel;
    int threads;  // 0: the kernel's shared-memory attribute is set
    size_t shared;
    int per_sm;
};

inline std::mutex plans_lock;
inline std::vector<Card> cards;
inline std::vector<LaunchPlan> plans;

inline int card_of(int device, Card& card) {
    std::lock_guard<std::mutex> hold(plans_lock);
    for (const Card& c : cards) {
        if (c.device == device) {
            card = c;
            return 0;
        }
    }
    int status;
    card.device = device;
    if ((status = cudaDeviceGetAttribute(&card.optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) != 0)
        return status;
    if ((status = cudaDeviceGetAttribute(&card.n_sms, cudaDevAttrMultiProcessorCount, device)) != 0) return status;
    cards.push_back(card);
    return 0;
}

inline int blocks_per_sm(const Card& card, const void* kernel, int threads, size_t shared, int& per_sm) {
    std::lock_guard<std::mutex> hold(plans_lock);
    bool attribute = false;
    for (const LaunchPlan& p : plans) {
        if (p.device != card.device || p.kernel != kernel) continue;
        if (p.threads == threads && p.shared == shared) {
            per_sm = p.per_sm;
            return 0;
        }
        attribute = attribute || p.threads == 0;
    }
    int status;
    if (!attribute) {
        if ((status = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, card.optin)) != 0)
            return status;
        plans.push_back(LaunchPlan{card.device, kernel, 0, 0, 0});
    }
    if ((status = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, shared)) != 0)
        return status;
    plans.push_back(LaunchPlan{card.device, kernel, threads, shared, per_sm});
    return 0;
}

}  // namespace demux
