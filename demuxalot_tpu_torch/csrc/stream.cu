// Streaming kernels for Hopper (sm_90a).
//
// Replace benchmarks/exp_dma_pattern.py's two TPU kernels, microbenchmarks of
// double-buffered DMA streaming that sum only a corner of what they stream:
// - stream_cols' kernel (:32, factory :29) streams x f32 [D, N] as steps of
//   [D, width] column slices, 32 runs of width * 4 bytes strided by N * 4
//   (the M-step's donor-major pattern), and returns
//     sum_{s < N / width} sum x[:, s * width : s * width + 128]
// - stream_rows' kernel (:71, factory :68) streams x f32 [N, D] as steps of
//   [rows, D] contiguous row blocks and returns
//     sum_{s < N / rows} sum x[s * rows : s * rows + 8, :]
// Both leave the tail past the last whole step unread, as on the TPU.
//
// One kernel serves both: a step is an [h, w] block of rows strided by ld,
// the steps step_offset floats apart, the corner its top-left [ch, cw]
// (cols: h = D, w = width, ld = N, corner [D, 128]; rows: h = 1, w = rows *
// D, one contiguous run, corner the first 8 rows).
//
// What bounds it on the H100: the bytes streamed, steps * width * D * 4
// (570.4 MB at the TPU harness's shape, >= 0.1703 ms at 3.35 TB/s). The TPU
// stages [2, D, width] in VMEM (8 MB at width 32768); a block here has at
// most 227 KB of shared memory, so nothing copies the TPU's tile. The design:
// - Each step is cut into pieces of at most 8,192 floats (32 KB): whole runs
//   of min(width, 8192) floats, as many rows of them as fit, so every piece
//   keeps the pattern's run length (2 KB runs at width 512, 32 KB at 8192
//   and up) and its stride. Pieces are numbered step by step, rows before
//   columns within a step, and each block of the grid owns a contiguous
//   range of them.
// - A block streams its pieces through a ring of kStages piece buffers in
//   shared memory with cp.async (16-byte copies where every run and stride is
//   16-byte aligned, 4-byte ones where not), kStages - 1 pieces in flight.
//   Every byte of a step lands in shared memory, so no load can be dropped
//   as unused; only the corner is then read and summed.
// - A piece holding corner rows writes one partial: the sum of its corner
//   rows, in a fixed order (each thread its strided elements, then
//   common.cuh's block_sum). reduce.cu's demux_sum_in_order then adds the
//   partials (step by step, row chunks within a step) in a fixed order.
//   No atomics, so two runs give the same bits, whatever the grid.
#include "common.cuh"

namespace {

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

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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
        if constexpr (kV == 4) {
            cp_async16(buf + i * r.pw + j, src + (int64_t)i * r.ld + j);
        } else {
            cp_async4(buf + i * r.pw + j, src + (int64_t)i * r.ld + j);
        }
    }
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

}  // namespace

// partial: scratch of at least n_steps * h floats; total: one float
extern "C" int demux_stream_sum(const float* x, int64_t ld, int64_t step_offset, int64_t n_steps, int h, int w,
                                int ch, int cw, float* partial, float* total, void* stream) {
    if (n_steps <= 0 || h <= 0 || w <= 0 || ch <= 0 || cw <= 0 || ch > h || cw > w) return (int)cudaErrorInvalidValue;
    Region r;
    r.base = x;
    r.ld = ld;
    r.step_offset = step_offset;
    r.n_steps = n_steps;
    r.h = h;
    r.w = w;
    r.pw = w < kPieceFloats ? w : kPieceFloats;
    r.ph = kPieceFloats / r.pw < h ? kPieceFloats / r.pw : h;
    r.nrc = (h + r.ph - 1) / r.ph;
    r.ncc = (w + r.pw - 1) / r.pw;
    r.ch = ch;
    r.cw = cw;
    if (cw > r.pw) return (int)cudaErrorInvalidValue;  // the corner lies in each row chunk's first piece
    cudaStream_t s = (cudaStream_t)stream;
    const bool vec = demux::aligned16(x) && ld % 4 == 0 && step_offset % 4 == 0 && w % 4 == 0 && r.pw % 4 == 0;
    const size_t shared = (size_t)kStages * kPieceFloats * sizeof(float);
    auto kernel = vec ? stream_kernel<4> : stream_kernel<1>;
    int status, device, n_sms, per_sm;
    if ((status = cudaGetDevice(&device)) != 0) return status;
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
