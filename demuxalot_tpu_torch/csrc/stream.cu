// Streaming kernels for Hopper (sm_90a).
//
// Replace benchmarks/exp_dma_pattern.py's two TPU kernels, microbenchmarks of
// double-buffered DMA streaming that sum only a corner of what they stream:
// - stream_cols' kernel (:32, factory :29) streams x f32 [D, N] as steps of
//   [D, width] column slices, D runs of width * 4 bytes strided by N * 4
//   (the M-step's donor-major pattern), and returns
//     sum_{s < N / width} sum x[:, s * width : s * width + 128]
// - stream_rows' kernel (:71, factory :68) streams x f32 [N, D] as steps of
//   [rows, D] contiguous row blocks and returns
//     sum_{s < N / rows} sum x[s * rows : s * rows + 8, :]
// Both leave the tail past the last whole step unread, as on the TPU. The TPU
// kernels hand each step to the DMA engine (pltpu.make_async_copy into a
// double buffer in VMEM, waited on by a semaphore, :33-53, :72-92); the
// harness exists to stream the same bytes in two patterns, so every byte of
// every whole step lands in shared memory here too, and only the corner is
// then read.
//
// What bounds it on the H100: the bytes streamed, steps * width * D * 4
// (570.4 MB at the TPU harness's shape, >= 0.1703 ms at 3.35 TB/s). Two
// routes of one entry, demux_stream_sum; the host's plan
// (experiments/dma_pattern.py:stream_plan) picks one before the launch:
//
// - The TMA route, Hopper's copy engine, for what a tensor map can address
//   (base on a 16-byte boundary, rows a multiple of 16 bytes, D <= 256, a box
//   of at most 256 floats a side dividing the step). A persistent grid, one
//   block per SM, each owning a contiguous range of boxes. A box is [D, box]
//   columns of a step (cols: D strided runs of box * 4 bytes, two 32 KB boxes
//   a step at width 512) or [box, D] rows (rows: one contiguous run with a
//   128-byte inner extent at D = 32; 1-D bulk runs in its place were no
//   faster). One producer thread keeps a ring of `stages` box buffers in
//   shared memory full: it waits on a stage's "empty" mbarrier, arms its
//   "full" one with the box's bytes and issues one cp.async.bulk.tensor.2d
//   load through the tensor map; the hardware generates every address. One
//   consumer warp a stage waits on its "full" barrier round after round, sums
//   the corner where the box holds some of it (a fixed order: each lane its
//   elements, then a shuffle tree) and arrives on "empty". No thread spends
//   an instruction on the copy and no barrier spans the block after set-up.
//   The tensor map is encoded on the host at each call (cuTensorMapEncodeTiled,
//   reached through the runtime's driver entry point, so the library needs no
//   -lcuda) and passed by value as a __grid_constant__ parameter: a side
//   stream or a CUDA graph's replay launches with the map it was given.
// - The cp.async route, for everything else (D = 7, N odd, a view off a
//   16-byte boundary): each step is cut into pieces of at most 8,192 floats
//   (32 KB) that keep the pattern's run length and stride, streamed by all 256
//   threads with 16-byte (or 4-byte, where runs or strides are unaligned)
//   cp.async copies through a ring of kStages pieces, kStages - 1 in flight,
//   two block barriers a piece.
//
// Both routes write one partial per corner-holding box or piece, in a fixed
// order, and reduce.cu's demux_sum_in_order adds the partials step by step in
// a fixed order. No atomics, so two runs give the same bits, whatever the
// grid.
#include <cuda.h>  // CUtensorMap and the encoder's enums; the encoder itself comes through the runtime

#include "bulk.cuh"  // the mbarrier helpers
#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// the cp.async route
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kPieceFloats = 8192;  // 32 KB
constexpr int kStages = 3;          // 96 KB of shared memory: two blocks per SM

struct Region {
    const float* base;
    int64_t ld;           // floats between a step's rows
    int64_t step_offset;  // floats between steps
    int64_t n_steps;
    int h, w;             // a step's rows and columns
    int ph, pw;           // a piece's rows and columns
    int nrc, ncc;         // row and column chunks of a step
    int ch, cw;           // the corner: rows [0, ch), columns [0, cw)
};

// copies piece p of the region into buf, [rows][pw] with rows of its own width
template <int kV>
__device__ __forceinline__ void issue_piece(const Region& r, int64_t p, float* buf) {
    const int per_step = r.nrc * r.ncc;
    const int64_t s = p / per_step;
    const int within = (int)(p - s * per_step);
    const int rc = within / r.ncc;
    const int cc = within - rc * r.ncc;
    const int r0 = rc * r.ph;
    const int c0 = cc * r.pw;
    const int rows = min(r.ph, r.h - r0);
    const int cols_v = min(r.pw, r.w - c0) / kV;
    const float* src = r.base + s * r.step_offset + (int64_t)r0 * r.ld + c0;
    for (int e = threadIdx.x; e < rows * cols_v; e += kThreads) {
        const int i = e / cols_v;
        const int j = (e - i * cols_v) * kV;
        demux::cp_async<kV * 4>(buf + i * r.pw + j, src + (int64_t)i * r.ld + j);
    }
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int kV>
__global__ void __launch_bounds__(kThreads) stream_kernel(Region r, float* __restrict__ partial) {
    extern __shared__ float4 smem4[];
    float* ring = reinterpret_cast<float*>(smem4);
    __shared__ float warp_sums[kThreads / demux::kWarpSize];
    const int per_step = r.nrc * r.ncc;
    const int64_t n_pieces = r.n_steps * per_step;
    const int64_t lo = n_pieces * blockIdx.x / gridDim.x;
    const int64_t n = n_pieces * (blockIdx.x + 1) / gridDim.x - lo;
#pragma unroll
    for (int k = 0; k < kStages - 1; ++k) {
        if (k < n) issue_piece<kV>(r, lo + k, ring + k * kPieceFloats);
        cp_commit();
    }
    for (int64_t k = 0; k < n; ++k) {
        const int64_t ahead = k + kStages - 1;
        if (ahead < n) issue_piece<kV>(r, lo + ahead, ring + (ahead % kStages) * kPieceFloats);
        cp_commit();
        cp_wait<kStages - 1>();  // this thread's copies of piece k have landed
        __syncthreads();         // and every other thread's
        const int64_t p = lo + k;
        const int64_t s = p / per_step;
        const int within = (int)(p - s * per_step);
        const int rc = within / r.ncc;
        if (within - rc * r.ncc == 0) {  // the piece holds the step's first columns
            const float* buf = ring + (k % kStages) * kPieceFloats;
            const int rows = max(0, min(r.ph, r.ch - rc * r.ph));
            float acc = 0.f;
            for (int e = threadIdx.x; e < rows * r.cw; e += kThreads) {
                const int i = e / r.cw;
                acc += buf[i * r.pw + (e - i * r.cw)];
            }
            const float sum = demux::block_sum(acc, warp_sums);
            if (threadIdx.x == 0) partial[s * r.nrc + rc] = sum;
        }
        __syncthreads();  // every thread is done with buffer k % kStages before it is refilled
    }
}

// ---------------------------------------------------------------------------
// the TMA route
// ---------------------------------------------------------------------------

constexpr int kBoxFloats = 8192;  // 32 KB, a ring stage
constexpr int kMaxBoxSide = 256;  // TMA's limit on a box dimension
constexpr int kMinStages = 2, kMaxStages = 8;
// warp 0 is the producer, warp 1 + j consumes stage j: a stage's rounds are waited on in order by one warp, so no
// waiter runs a phase ahead of its barrier (a parity wait cannot tell round r from round r + 2)
constexpr int kMaxTmaThreads = demux::kWarpSize * (1 + kMaxStages);
constexpr int kErrorDriverEntry = -1;  // cuTensorMapEncodeTiled could not be reached through the runtime
constexpr int kErrorTensorMap = -2;    // the driver refused to encode the tensor map

enum Route { kCpAsync = 0, kTma = 1 };

struct Boxes {
    int64_t n_boxes;     // n_steps * per_step
    int64_t step;        // a step's extent along the stepping axis (columns for cols, rows for rows)
    int per_step;        // boxes a step
    int box;             // a box's extent along the axis
    int rows, cols;      // a box's rows and columns in shared memory ([rows][cols], row-major)
    int corner;          // the corner's extent along the axis, from the step's start
    int corner_boxes;    // the first boxes of a step that hold some of the corner: one partial each
    int stages;
    int stage_floats;    // floats between stages (the box's bytes rounded up to 128)
    uint32_t box_bytes;
    bool along_cols;     // steps of columns (cols) or of rows (rows)
};

__device__ __forceinline__ void tma_load_2d(float* dst, const CUtensorMap* map, int x, int y, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], "
        "[%4];\n" ::"r"(demux::shared_address(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(demux::shared_address(bar))
        : "memory");
}

// the sum of the corner's part in one box ([rows][cols] floats at buf), in a fixed order: each lane its float4s,
// then a shuffle tree; every lane holds the result
__device__ __forceinline__ float corner_sum(const float* buf, const Boxes& b, int j, int lane) {
    const int ext = min(b.box, b.corner - j * b.box);  // the corner's extent in box j along the axis
    const int rows = b.along_cols ? b.rows : ext;
    const int cols4 = (b.along_cols ? ext : b.cols) / 4;  // the TMA route's plan keeps both multiples of 4
    float acc = 0.f;
    if (cols4 * 4 == b.cols) {  // whole box rows: one contiguous run
#pragma unroll 4
        for (int e = lane; e < rows * cols4; e += demux::kWarpSize) acc += demux::load_sum<4>(buf + 4 * e);
    } else {
#pragma unroll 4
        for (int i = 0; i < rows; ++i) {
            for (int q = lane; q < cols4; q += demux::kWarpSize) acc += demux::load_sum<4>(buf + i * b.cols + q * 4);
        }
    }
#pragma unroll
    for (int o = demux::kWarpSize / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(demux::kFullMask, acc, o);
    return acc;
}

__global__ void __launch_bounds__(kMaxTmaThreads, 1)
    stream_tma_kernel(const __grid_constant__ CUtensorMap map, const Boxes b, float* __restrict__ partial) {
    extern __shared__ unsigned char smem[];
    // a TMA destination lies on a 128-byte boundary: the ring starts at the first one, the barriers after it
    const uint32_t pad = (128u - demux::shared_address(smem) % 128u) % 128u;
    float* ring = reinterpret_cast<float*>(smem + pad);
    uint64_t* full = reinterpret_cast<uint64_t*>(ring + (size_t)b.stages * b.stage_floats);
    uint64_t* empty = full + b.stages;
    const int warp = threadIdx.x / demux::kWarpSize;
    const int lane = threadIdx.x % demux::kWarpSize;
    const int64_t lo = b.n_boxes * blockIdx.x / gridDim.x;
    const int64_t n = b.n_boxes * (blockIdx.x + 1) / gridDim.x - lo;
    if (threadIdx.x == 0) {
        for (int j = 0; j < b.stages; ++j) {
            demux::mbar_init(&full[j], 1);   // the producer's arrival, with the box's bytes
            demux::mbar_init(&empty[j], 1);  // the consumer warp's arrival
        }
        demux::mbar_init_fence();
    }
    __syncthreads();  // the only block barrier: the barriers are initialised
    if (warp == 0) {
        if (lane != 0) return;
        // the producer: box lo + k of the block's range goes to stage k % stages in round k / stages
        int64_t s = lo / b.per_step;
        int j = (int)(lo - s * b.per_step);
        for (int64_t k = 0; k < n; ++k) {
            const int slot = (int)(k % b.stages);
            const int64_t round = k / b.stages;
            if (round > 0) demux::mbar_wait(&empty[slot], (uint32_t)((round - 1) & 1));  // its last box is summed
            float* dst = ring + (size_t)slot * b.stage_floats;
            const int64_t along = s * b.step + (int64_t)j * b.box;
            demux::mbar_arrive_expect_tx(&full[slot], b.box_bytes);
            if (b.along_cols) {
                tma_load_2d(dst, &map, (int)along, 0, &full[slot]);
            } else {
                tma_load_2d(dst, &map, 0, (int)along, &full[slot]);
            }
            if (++j == b.per_step) {
                j = 0;
                ++s;
            }
        }
        return;
    }
    // the consumers: warp 1 + slot takes boxes slot, slot + stages, ... of the block's range
    const int slot = warp - 1;
    for (int64_t k = slot; k < n; k += b.stages) {
        demux::mbar_wait(&full[slot], (uint32_t)((k / b.stages) & 1));  // every byte of the box has landed
        const int64_t box = lo + k;
        const int64_t s = box / b.per_step;
        const int j = (int)(box - s * b.per_step);
        if (j < b.corner_boxes) {
            const float sum = corner_sum(ring + (size_t)slot * b.stage_floats, b, j, lane);
            if (lane == 0) partial[s * b.corner_boxes + j] = sum;
        }
        __syncwarp();
        if (lane == 0) demux::mbar_arrive(&empty[slot]);  // release: the warp's reads come before the refill
    }
}

// cuTensorMapEncodeTiled, reached once through the runtime's driver entry point (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
    static const EncodeTiled fn = [] {
        void* found = nullptr;
        cudaDriverEntryPointQueryResult query;
#if CUDART_VERSION >= 12050
        const cudaError_t status =
            cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &found, 12000, cudaEnableDefault, &query);
#else
        const cudaError_t status = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &found, cudaEnableDefault, &query);
#endif
        return status == cudaSuccess && query == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(found)
                                                                              : nullptr;
    }();
    return fn;
}

int launch_tma(const float* x, int64_t n_rows, int64_t n_cols, bool along_cols, int64_t step, int64_t n_steps,
               int corner, int box, int stages, float* partial, int64_t n_partial, float* total, int device,
               cudaStream_t s) {
    const int64_t cross = along_cols ? n_rows : n_cols;  // a box's extent across the stepping axis
    const int64_t along_end = n_steps * step;             // the tail past it stays unread
    if (!demux::aligned16(x) || n_cols % 4 != 0 || cross > kMaxBoxSide || box > kMaxBoxSide ||
        step % box != 0 || (along_cols && box % 4 != 0) || box * cross > kBoxFloats || stages < kMinStages ||
        stages > kMaxStages || along_end > 0x7fffffffLL || n_rows > 0xffffffffLL || n_cols > 0xffffffffLL)
        return (int)cudaErrorInvalidValue;
    Boxes b;
    b.step = step;
    b.per_step = (int)(step / box);
    b.n_boxes = n_steps * b.per_step;
    b.box = box;
    b.rows = along_cols ? (int)n_rows : box;
    b.cols = along_cols ? box : (int)n_cols;
    b.corner = corner;
    b.corner_boxes = (corner + box - 1) / box;
    b.stages = stages;
    b.box_bytes = (uint32_t)(box * cross * sizeof(float));
    b.stage_floats = (int)((b.box_bytes + 127) / 128 * 128 / sizeof(float));
    b.along_cols = along_cols;
    if (n_partial < n_steps * b.corner_boxes) return (int)cudaErrorInvalidValue;
    const EncodeTiled encode = encoder();
    if (encode == nullptr) return kErrorDriverEntry;
    CUtensorMap map;
    const cuuint64_t dims[2] = {(cuuint64_t)n_cols, (cuuint64_t)n_rows};  // innermost first
    const cuuint64_t strides[1] = {(cuuint64_t)n_cols * sizeof(float)};
    const cuuint32_t box_dims[2] = {(cuuint32_t)b.cols, (cuuint32_t)b.rows};
    const cuuint32_t unit[2] = {1, 1};
    if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(x), dims, strides, box_dims, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return kErrorTensorMap;
    const size_t shared = 128 + (size_t)stages * b.stage_floats * sizeof(float) + 2 * (size_t)stages * 8;
    int status, n_sms, per_sm;
    if ((status = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, device)) != 0) return status;
    if ((status = cudaFuncSetAttribute(stream_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)shared)) != 0)
        return status;
    const int threads = demux::kWarpSize * (1 + stages);
    if ((status = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stream_tma_kernel, threads, shared)) != 0)
        return status;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const int64_t full = (int64_t)n_sms * per_sm;
    stream_tma_kernel<<<(unsigned int)(b.n_boxes < full ? b.n_boxes : full), threads, shared, s>>>(map, b, partial);
    if ((status = (int)cudaGetLastError()) != 0) return status;
    return demux_sum_in_order(partial, n_steps * b.corner_boxes, total, s);
}

int launch_cp_async(const float* x, int64_t n_rows, int64_t n_cols, bool along_cols, int64_t step, int64_t n_steps,
                    int corner, float* partial, int64_t n_partial, float* total, int device, cudaStream_t s) {
    // a step is an [h, w] block of rows strided by ld, the steps step_offset floats apart, the corner its top-left
    // [ch, cw] (cols: h = D, w = width, ld = N, corner [D, 128]; rows: h = 1, w = rows * D, one contiguous run,
    // corner the first 8 rows)
    Region r;
    r.base = x;
    r.ld = along_cols ? n_cols : step * n_cols;
    r.step_offset = along_cols ? step : step * n_cols;
    r.n_steps = n_steps;
    const int64_t w = along_cols ? step : step * n_cols;
    if (w > 0x7fffffffLL || n_rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    r.h = along_cols ? (int)n_rows : 1;
    r.w = (int)w;
    r.ch = r.h;
    r.cw = along_cols ? corner : corner * (int)n_cols;
    r.pw = r.w < kPieceFloats ? r.w : kPieceFloats;
    r.ph = kPieceFloats / r.pw < r.h ? kPieceFloats / r.pw : r.h;
    r.nrc = (r.h + r.ph - 1) / r.ph;
    r.ncc = (r.w + r.pw - 1) / r.pw;
    // the corner lies in each row chunk's first piece
    if (r.cw > r.pw || n_partial < n_steps * r.nrc) return (int)cudaErrorInvalidValue;
    const bool vec = demux::aligned16(x) && r.ld % 4 == 0 && r.step_offset % 4 == 0 && r.w % 4 == 0 && r.pw % 4 == 0;
    const size_t shared = (size_t)kStages * kPieceFloats * sizeof(float);
    auto kernel = vec ? stream_kernel<4> : stream_kernel<1>;
    int status, n_sms, per_sm;
    if ((status = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, device)) != 0) return status;
    if ((status = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared)) != 0)
        return status;
    if ((status = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, shared)) != 0)
        return status;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const int64_t n_pieces = n_steps * (int64_t)r.nrc * r.ncc;
    const int64_t full = (int64_t)n_sms * per_sm;
    kernel<<<(unsigned int)(n_pieces < full ? n_pieces : full), kThreads, shared, s>>>(r, partial);
    if ((status = (int)cudaGetLastError()) != 0) return status;
    return demux_sum_in_order(partial, n_steps * r.nrc, total, s);
}

}  // namespace

// x [n_rows, n_cols] row-major; cols = 1: steps of `step` columns (x [D, N]), the corner the first `corner`
// columns of each; cols = 0: steps of `step` rows (x [N, D]), the corner the first `corner` rows. route: 0 the
// cp.async route (box and stages unread), 1 TMA boxes of `box` columns (cols) or rows (rows) through a tensor map
// and a ring of `stages` boxes (experiments/dma_pattern.py's stream_plan picks them). partial: scratch of
// n_partial floats, at least one per corner-holding box or piece of every step; total: one float.
extern "C" int demux_stream_sum(const float* x, int64_t n_rows, int64_t n_cols, int cols, int64_t step, int corner,
                                int route, int box, int stages, float* partial, int64_t n_partial, float* total,
                                int device, void* stream) {
    const int64_t along = cols ? n_cols : n_rows;
    if (n_rows <= 0 || n_cols <= 0 || step <= 0 || step > along || corner <= 0 || corner > step ||
        (route != kCpAsync && route != kTma) || (route == kTma && box <= 0))
        return (int)cudaErrorInvalidValue;
    const demux::DeviceGuard guard(device);
    if (guard.status() != 0) return guard.status();
    cudaStream_t s = (cudaStream_t)stream;
    const int64_t n_steps = along / step;
    if (route == kCpAsync)
        return launch_cp_async(x, n_rows, n_cols, cols != 0, step, n_steps, corner, partial, n_partial, total, device,
                               s);
    return launch_tma(x, n_rows, n_cols, cols != 0, step, n_steps, corner, box, stages, partial, n_partial, total,
                      device, s);
}
