// Folded E-step kernel for Hopper (sm_90a).
//
// Replaces benchmarks/exp_estep.py:_folded_kernel (:40, via folded_logits
// :132), the TPU's E-step over calls folded before the doublet expansion.
// The fold U[c, d] = G[vid_c, d] * (1 - q_c) + max(q_c, 1e-4) runs as torch
// ops before the launch (experiments/folded_estep.py:fold_calls), so this
// kernel reads U, call-major f32 [n_calls, n_donors] in the mainline's
// barcode CSR, and for every barcode b and column g computes
//
//   logits[b, g] = pen[g] + sum_{calls c of b} log(0.5 * U[c, i_g] + 0.5 * U[c, j_g])
//
// (i_g, j_g) is column g's donor pair, i == j for a singlet (halving is
// exact). A padding call (q = 1) has U = 1, an argument of 1 and a log of 0.
// With use_log off it sums the arguments (the TPU file's nolog ablation).
//
// What bounds it on the H100: the function needs one log per 8 calls and
// column (U >= 1e-4, so a product of 8 arguments stays a normal float):
// 2.8e8 MUFU logs at the JAX harness's shape (4,194,304 calls x 528
// columns), >= 0.07 ms; reading U (537 MB) is >= 0.16 ms of HBM; the terms'
// adds and multiplies, 2.2 G of each, set the issue time, as in the
// mainline E-step. The design is the mainline's, shared with group.cu in
// estep_tiles.cuh: one warp per barcode, each lane the 4 x 4 and 2 x 2 tiles
// of donor pairs of a schedule entry (the operands' `schedule`,
// group_estep.py:group_schedule of their pairs, built and checked once by
// folded_estep.variant_operands), U staged through a cp.async ring of
// 32-call tiles as 0.5 * U, and one MUFU log2 of the product of 8 arguments
// in call order (kProduct, kFold 8). The barcodes are not padded to a
// multiple of 8: the slots past a barcode's last call, to the fold's end,
// are staged as U = 1 (kRagged), so its last product holds fewer real
// arguments and a factor of 1 for each slot past them. use_log off is the
// same walk summing each call's arguments (kNoLog). Each column's sum is
// one lane's, in call order, with no atomics: two runs give the same bits.
// row_ptr and the schedule were bounds-checked when the operands were
// built (demux_variant_check, checks.cu), so a launch checks nothing.
#include "estep_tiles.cuh"

// u: the folded calls [n_calls, n_donors]; schedule [n_passes, 32, 24] the tile schedule with the operands'
// columns, as demux_variant_check passed it with row_ptr
extern "C" int demux_folded_logits(const float* u, int64_t n_calls, int n_donors, const int64_t* row_ptr,
                                   int64_t n_barcodes, const int32_t* schedule, int n_passes, const float* penalties,
                                   int n_pg, float* logits, int use_log, int device, void* stream) {
    const bool vec = tiles_vec(u, n_donors);
    const TilesKernel kernel =
        use_log ? (vec ? &tiles_kernel<0, kProduct, kMaxFold, false, true, true>
                       : &tiles_kernel<0, kProduct, kMaxFold, false, false, true>)
                : (vec ? &tiles_kernel<0, kNoLog, 1, false, true, true> : &tiles_kernel<0, kNoLog, 1, false, false, true>);
    return launch_tiles(kernel, u, n_calls, n_donors, row_ptr, n_barcodes, use_log ? kMaxFold : 1, schedule, n_passes,
                        penalties, n_pg, logits, device, stream);
}
