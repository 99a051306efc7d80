// Row gather and gather-sum kernels for Hopper (sm_90a).
//
// Replace benchmarks/exp_kernel_gather.py's two TPU kernels:
// - _take_kernel (:39), the canary of an in-kernel row gather:
//     out[i, :] = table[idx[i], :]
//   gather_rows_kernel copies the rows bit for bit. What bounds it: moving
//   the gathered rows, N x W x 4 bytes read and written. Each thread takes
//   16-byte loads with neighbouring lanes on neighbouring words of a row
//   (4-byte ones when rows are not 16-byte aligned), many rows in flight per
//   SM. Its indices are bounds-checked by checks.cu's kernel before the
//   launch.
// - _bench_kernel (:63), the gather-rate bench, which sums the gathered rows
//   one step of `step` indices after another, the whole table held in the
//   TPU core's VMEM (:63-74, 99-101):
//     total = sum_i sum_w table[idx[i], w]
//   as per-step partials, then reduce.cu's demux_sum_in_order adds the
//   partials in a fixed order. No atomics in any sum, so two runs give the
//   same bits. Two paths, chosen by the host's plan
//   (experiments/kernel_gather.py:gather_plan) by a count of bytes:
//   * On chip (gather_sum_chip_kernel), when the table cut into S slices of
//     whole rows, each small enough for one block's shared memory, needs
//     fewer index passes than a row has floats (S < W: S x 4 bytes of
//     indices read per index against 4 x W bytes of row). Persistent blocks,
//     R per slice (S x R fill the SMs), each hold their slice in shared
//     memory, loaded once by cp.async. Block (s, r) walks the steps r,
//     r + R, ...: its 32 warps read the steps' indices in chunks of 256,
//     two 16-byte loads a lane, the next chunk asked for before this one is
//     read; the blocks of slice 0 test each index against the table (one
//     unsigned compare, a trap past it, as forms.cu's take_along_axis); each
//     block ballots those in its slice, queues their row offsets (16 bits
//     each) in index order and reads the queued rows warp-wide from shared
//     memory, two reads in flight a lane, a row across neighbouring lanes
//     (16 lanes of 16 bytes at W = 64), so the lanes of one row never meet
//     in a bank. Each (step, slice) pair writes one partial, partial[step *
//     S + s]: the sum over the block's warps, in warp order, of each warp's
//     sum of its chunks in chunk order. The table's row reads move from L2
//     to shared memory; L2 carries S passes over the indices and one slice
//     per block.
//   * Through L2 (gather_sum_kernel) otherwise: one block per step, each
//     thread its own strided elements of the step's rows, then common.cuh's
//     block_sum, partial[step]. The index test is fused there too.
//   What bounds both: each input once, the indices (4 bytes each) and the
//   rows they touch; the measurement is the rate per row (chip_smoke.py
//   phase 9d).
#include <type_traits>

#include "common.cuh"

int demux_check_index(const int32_t* idx, int64_t n, int64_t limit, cudaStream_t stream);

namespace {

constexpr int kThreads = 256;
constexpr int kSumThreads = 1024;
// the on-chip gather-sum; experiments/kernel_gather.py's plan mirrors these three and its shared memory
constexpr int kChipWarps = 32;  // warps per block, one block per SM (64 registers a thread)
constexpr int kChipThreads = kChipWarps * demux::kWarpSize;
constexpr int kBatch = 32;  // steps whose per-warp sums a block holds before it sums them
constexpr int kPerLane = 8;  // indices a lane reads at a time, in 16-byte pieces
constexpr int kChunk = kPerLane * demux::kWarpSize;  // indices a warp reads at a time
constexpr int kReads = 2;  // queued rows a lane reads at a time
// shared memory beside the slice: the batch's per-warp step sums, each warp's queue of a chunk's row offsets
constexpr int kChipExtraBytes = kBatch * kChipWarps * 4 + kChipWarps * kChunk * 2;

// kW: floats per load (4 or 1); width_v: the row's loads; I: the element
// index type (32 bits when n * width_v fits, so the division is cheap)
template <int kW, typename I>
__global__ void gather_rows_kernel(const float* __restrict__ table, const int32_t* __restrict__ idx, I n,
                                   I width_v, float* __restrict__ out) {
    using V = typename std::conditional<kW == 4, float4, float>::type;
    const V* src = reinterpret_cast<const V*>(table);
    V* dst = reinterpret_cast<V*>(out);
    const I total = n * width_v;
    const I stride = (I)gridDim.x * blockDim.x;
    for (I e = (I)blockIdx.x * blockDim.x + threadIdx.x; e < total; e += stride) {
        const I i = e / width_v;
        const I w = e - i * width_v;
        dst[e] = src[(int64_t)idx[i] * width_v + w];
    }
}

// an index past the table (or negative: it wraps past `limit`) traps
__device__ __forceinline__ void check_row(int32_t k, uint32_t limit) {
    if ((uint32_t)k >= limit) __trap();
}

// The L2 path: block s sums the rows of indices [s * step, min((s + 1) * step, n)) into partial[s].
template <int kW>
__global__ void __launch_bounds__(kSumThreads) gather_sum_kernel(const float* __restrict__ table, uint32_t limit,
                                                                 const int32_t* __restrict__ idx, int64_t n,
                                                                 int64_t step, int width,
                                                                 float* __restrict__ partial) {
    __shared__ float warp_sums[kSumThreads / demux::kWarpSize];
    const int64_t lo = blockIdx.x * step;
    const int64_t hi = lo + step < n ? lo + step : n;
    const int width_v = width / kW;
    const int total = (int)(hi - lo) * width_v;  // the launcher keeps step * width below 2^31
    float acc = 0.f;
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
        const int i = e / width_v;
        const int w = e - i * width_v;
        const int32_t k = idx[lo + i];
        check_row(k, limit);
        acc += demux::load_sum<kW>(table + (int64_t)k * width + w * kW);
    }
    const float s = demux::block_sum(acc, warp_sums);
    if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

// the kPerLane indices at p of which `valid` lie before the step's end (16-byte loads where all do and kVecIdx)
template <bool kVecIdx>
__device__ __forceinline__ void load_indices(const int32_t* __restrict__ p, int valid, int32_t (&k)[kPerLane]) {
    if (kVecIdx && valid == kPerLane) {
#pragma unroll
        for (int u = 0; u < kPerLane; u += 4) {
            const int4 v = *reinterpret_cast<const int4*>(p + u);
            k[u] = v.x;
            k[u + 1] = v.y;
            k[u + 2] = v.z;
            k[u + 3] = v.w;
        }
    } else {
#pragma unroll
        for (int u = 0; u < kPerLane; ++u) k[u] = u < valid ? p[u] : 0;
    }
}

// The on-chip path: block (s, r) = (blockIdx.x / replicas, blockIdx.x % replicas) holds rows
// [s * rows_per_slice, min((s + 1) * rows_per_slice, n_rows)) and writes partial[t * n_slices + s] for its
// steps t = r, r + replicas, ... kQ: floats per row read (4: W % 4 == 0 and the table 16-byte aligned, else 1);
// kVecIdx: 16-byte index loads (step % 4 == 0 and idx 16-byte aligned). The blocks of slice 0 test every index
// against the table; every other block reads each index only to ask whether it falls in its slice.
template <int kQ, bool kVecIdx>
__global__ void __launch_bounds__(kChipThreads, 1) gather_sum_chip_kernel(
    const float* __restrict__ table, int32_t n_rows, int width, const int32_t* __restrict__ idx, int64_t n,
    int64_t step, int64_t n_steps, int rows_per_slice, int n_slices, int replicas, float* __restrict__ partial) {
    extern __shared__ float4 smem4[];
    float* slice = reinterpret_cast<float*>(smem4);
    float* sums = slice + ((rows_per_slice * width + 3) & ~3);  // [kBatch][kChipWarps]
    const int lane = threadIdx.x % demux::kWarpSize, warp = threadIdx.x / demux::kWarpSize;
    // a row's offset in the slice fits 16 bits: a block's shared memory holds at most 58,112 floats
    uint16_t* queue = reinterpret_cast<uint16_t*>(sums + kBatch * kChipWarps) + warp * kChunk;
    const int s = blockIdx.x / replicas, r = blockIdx.x % replicas;
    const int32_t row_lo = s * rows_per_slice;
    const int32_t row_end = n_rows - row_lo < rows_per_slice ? n_rows : row_lo + rows_per_slice;
    const uint32_t slice_rows = (uint32_t)(row_end - row_lo);
    const bool tests = s == 0;
    const int64_t n_local = r < n_steps ? (n_steps - 1 - r) / replicas + 1 : 0;
    if (n_local == 0) return;  // the whole block

    {  // the slice, in cp.async pieces; waited for after the first indices are asked for
        const float* src = table + (int64_t)row_lo * width;
        const int count = (int)slice_rows * width;
        for (int e = threadIdx.x; e < count / kQ; e += kChipThreads) demux::cp_async<4 * kQ>(slice + kQ * e, src + kQ * e);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    // queued rows across neighbouring lanes: lanes_per_row lanes of kQ floats each, rows_at_once rows a read
    const int row_loads = width / kQ;
    const int lanes_per_row = row_loads < demux::kWarpSize ? row_loads : demux::kWarpSize;
    const int rows_at_once = demux::kWarpSize / lanes_per_row;
    const int sub = lane / lanes_per_row, col = lane - sub * lanes_per_row;
    const bool reads = sub < rows_at_once;
    const unsigned below = (1u << lane) - 1u;  // the lanes before this one
    const int chunks = (int)((step + kChunk - 1) / kChunk);  // per step; a short last step's extra chunks are empty

    for (int64_t j0 = 0; j0 < n_local; j0 += kBatch) {
        const int nb = (int)(n_local - j0 < kBatch ? n_local - j0 : kBatch);
        if (lane < nb) sums[lane * kChipWarps + warp] = 0.f;  // a step none of this warp's chunks fall in
        __syncwarp();
        // the batch's chunks (step j, chunk c) in order, warp w taking the w-th, (w + kChipWarps)-th, ...; the next
        // chunk's indices are asked for before this chunk's are read
        int j = 0, c = warp - kChipWarps;  // the last chunk asked for
        int lo_j = -1, next_valid = 0, next_j = 0;
        int64_t lo = 0, hi = 0;
        int32_t next[kPerLane];
        auto fetch = [&]() {  // the next chunk of this warp
            c += kChipWarps;
            while (j < nb && c >= chunks) {
                c -= chunks;
                ++j;
            }
            next_j = j;
            next_valid = 0;
            if (j < nb) {
                if (j != lo_j) {  // the indices of step j
                    lo = (r + (j0 + j) * replicas) * step;
                    hi = lo + step < n ? lo + step : n;
                    lo_j = j;
                }
                const int64_t base = lo + (int64_t)c * kChunk + kPerLane * lane;
                next_valid = base < hi ? (hi - base < kPerLane ? (int)(hi - base) : kPerLane) : 0;
                load_indices<kVecIdx>(idx + base, next_valid, next);
            }
        };
        fetch();
        if (j0 == 0) {  // the slice is in place before any warp reads it
            asm volatile("cp.async.wait_all;\n" ::: "memory");
            __syncthreads();
        }
        demux::RowSums<kQ> acc;
        while (next_j < nb) {
            int32_t k[kPerLane];
#pragma unroll
            for (int u = 0; u < kPerLane; ++u) k[u] = next[u];
            const int valid = next_valid, step_j = next_j;
            fetch();
            // this lane's indices: the bound test (slice 0), and the local rows of those in the slice
            bool hit[kPerLane];
            int before = 0, total = 0;
#pragma unroll
            for (int u = 0; u < kPerLane; ++u) {
                if (tests && u < valid) check_row(k[u], (uint32_t)n_rows);
                hit[u] = u < valid && (uint32_t)k[u] - (uint32_t)row_lo < slice_rows;
                const unsigned ballot = __ballot_sync(demux::kFullMask, hit[u]);
                before += __popc(ballot & below);
                total += __popc(ballot);
            }
            if (total > 0) {  // queue the hits in index order (lane, then u), then read kReads rows a lane at a time
#pragma unroll
                for (int u = 0; u < kPerLane; ++u) {
                    if (hit[u]) queue[before++] = (uint16_t)((k[u] - row_lo) * width);
                }
                __syncwarp();
                for (int q0 = sub; q0 < total; q0 += kReads * rows_at_once) {
                    const float* row[kReads];
                    bool has[kReads];
#pragma unroll
                    for (int i = 0; i < kReads; ++i) {
                        has[i] = q0 + i * rows_at_once < total;
                        row[i] = slice + queue[has[i] ? q0 + i * rows_at_once : q0];
                    }
                    if (reads) {
                        for (int e = col * kQ; e < width; e += lanes_per_row * kQ) {
#pragma unroll
                            for (int i = 0; i < kReads; ++i) {
                                if (has[i]) acc.add(row[i] + e);
                            }
                        }
                    }
                }
                __syncwarp();  // the queue is read before the next chunk's hits overwrite it
            }
            if (next_j != step_j) {  // this warp's last chunk of step step_j: the lanes' sums, a fixed order
                float lane_sum = acc.take();
#pragma unroll
                for (int o = demux::kWarpSize / 2; o > 0; o >>= 1)
                    lane_sum += __shfl_xor_sync(demux::kFullMask, lane_sum, o);
                if (lane == 0) sums[step_j * kChipWarps + warp] = lane_sum;
            }
        }
        __syncthreads();
        if (threadIdx.x < nb) {  // each step's partial: its warps' sums in warp order
            float total = 0.f;
            for (int w = 0; w < kChipWarps; ++w) total += sums[threadIdx.x * kChipWarps + w];
            partial[(r + (j0 + threadIdx.x) * replicas) * n_slices + s] = total;
        }
        __syncthreads();  // the sums are read before the next batch zeroes them
    }
}

unsigned int grid_for(int64_t n) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    const int64_t cap = 4096;  // ~31 blocks of 256 threads per SM of 132; the grid strides past that
    return (unsigned int)(blocks < cap ? blocks : cap);
}

template <int kW>
void launch_rows(const float* table, const int32_t* idx, int64_t n, int width, float* out, cudaStream_t s) {
    const int64_t width_v = width / kW;
    if (n * width_v < 0x7fffffff) {
        gather_rows_kernel<kW, uint32_t><<<grid_for(n * width_v), kThreads, 0, s>>>(
            table, idx, (uint32_t)n, (uint32_t)width_v, out);
    } else {
        gather_rows_kernel<kW, int64_t><<<grid_for(n * width_v), kThreads, 0, s>>>(table, idx, n, width_v, out);
    }
}

using ChipKernel = decltype(&gather_sum_chip_kernel<4, true>);

ChipKernel pick_chip(bool row_vec, bool idx_vec) {
    if (row_vec) return idx_vec ? &gather_sum_chip_kernel<4, true> : &gather_sum_chip_kernel<4, false>;
    return idx_vec ? &gather_sum_chip_kernel<1, true> : &gather_sum_chip_kernel<1, false>;
}

}  // namespace

extern "C" int demux_gather_rows(const float* table, int64_t n_rows, int width, const int32_t* idx, int64_t n,
                                 float* out, void* stream) {
    if (n_rows <= 0 || width <= 0 || n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    int status;
    if ((status = demux_check_index(idx, n, n_rows, s)) != 0) return status;
    if (width % 4 == 0 && demux::aligned16(table) && demux::aligned16(out)) {
        launch_rows<4>(table, idx, n, width, out, s);
    } else {
        launch_rows<1>(table, idx, n, width, out, s);
    }
    return (int)cudaGetLastError();
}

// out[0]: the shared memory one block may opt in to, out[1]: the SM count, of card `device` (the plan's inputs)
extern "C" int demux_card_limits(int32_t* out, int device) {
    int status;
    if ((status = cudaDeviceGetAttribute(&out[0], cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) != 0) return status;
    return (int)cudaDeviceGetAttribute(&out[1], cudaDevAttrMultiProcessorCount, device);
}

// rows_per_slice 0: the L2 path, partial of ceil(n / step) floats; else the on-chip path over n_slices slices
// of rows_per_slice rows (the last may be short) and replicas blocks each, partial of ceil(n / step) *
// n_slices floats. total: one float.
extern "C" int demux_gather_sum(const float* table, int64_t n_rows, int width, const int32_t* idx, int64_t n,
                                int64_t step, int rows_per_slice, int n_slices, int replicas, float* partial,
                                float* total, int device, void* stream) {
    if (n_rows <= 0 || width <= 0 || n <= 0 || step <= 0 || rows_per_slice < 0) return (int)cudaErrorInvalidValue;
    const int64_t n_steps = (n + step - 1) / step;
    if (n_steps > 0x7fffffff || step * width > 0x7fffffff) return (int)cudaErrorInvalidValue;
    const demux::DeviceGuard guard(device);
    if (guard.status() != 0) return guard.status();
    cudaStream_t s = (cudaStream_t)stream;
    int status;
    if (rows_per_slice == 0) {
        const uint32_t limit = (uint32_t)(n_rows < 0x80000000LL ? n_rows : 0x80000000LL);
        if (width % 4 == 0 && demux::aligned16(table)) {
            gather_sum_kernel<4><<<(unsigned int)n_steps, kSumThreads, 0, s>>>(table, limit, idx, n, step, width,
                                                                               partial);
        } else {
            gather_sum_kernel<1><<<(unsigned int)n_steps, kSumThreads, 0, s>>>(table, limit, idx, n, step, width,
                                                                               partial);
        }
        if ((status = (int)cudaGetLastError()) != 0) return status;
        return demux_sum_in_order(partial, n_steps, total, s);
    }
    const int64_t blocks = (int64_t)n_slices * replicas;
    if (n_rows > 0x7fffffff || n_slices < 1 || replicas < 1 || blocks > 0x7fffffff ||
        (int64_t)rows_per_slice * n_slices < n_rows || (int64_t)rows_per_slice * (n_slices - 1) >= n_rows)
        return (int)cudaErrorInvalidValue;
    const int64_t slice_floats = ((int64_t)rows_per_slice * width + 3) & ~3LL;
    if (slice_floats > 0x10000) return (int)cudaErrorInvalidValue;  // the queue's 16-bit row offsets
    const size_t shared = (size_t)slice_floats * sizeof(float) + kChipExtraBytes;
    int optin;
    if ((status = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) != 0) return status;
    if (shared > (size_t)optin) return (int)cudaErrorInvalidValue;
    const ChipKernel kernel = pick_chip(width % 4 == 0 && demux::aligned16(table),
                                        step % 4 == 0 && demux::aligned16(idx));
    if ((status = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared)) != 0)
        return status;
    kernel<<<(unsigned int)blocks, kChipThreads, shared, s>>>(table, (int32_t)n_rows, width, idx, n, step, n_steps,
                                                               rows_per_slice, n_slices, replicas, partial);
    if ((status = (int)cudaGetLastError()) != 0) return status;
    return demux_sum_in_order(partial, n_steps * n_slices, total, s);
}
