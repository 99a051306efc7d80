// Group-G E-step kernel for Hopper (sm_90a).
//
// Replaces benchmarks/exp_group.py:_group_kernel (:123, via group_logits
// :188), the TPU's E-step that pads each barcode's calls to a multiple of G
// and sums the logs of each group of G calls before its one-hot scatter,
// so the scatter contracts 128 group columns instead of TC calls. Here the
// calls come in the group layout of experiments/group_estep.py:group_layout
// (barcode CSR, each barcode's calls padded with q = 1 slots to a multiple
// of G; group h of a barcode is its calls [h * G, (h + 1) * G)), folded to U
// (call-major f32 [n_calls, n_donors]; a padding slot has U = 1). For every
// barcode b and column g:
//
//   args[c, g]   = 0.5 * (U_w[c, i_g] + U_w[c, j_g]),  U_w = sum_k word_k(U)  k < n_words, in word order
//   gsum[h, g]   = sum_{calls c of group h, in order} log(max(args[c, g], 1e-30))
//   logits[b, g] = pen[g] + sum_{groups h of b, in order} words(gsum[h, g])  kept to n_words bf16 words
//
// n_words 0 is full f32 (U_w = U, the TPU's HIGHEST dots); word_k as split.cu
// makes them (round to nearest even). The TPU adds the words' dots; the sum
// of the words first differs from it in the last bit of an argument at
// most. use_log off sums the arguments (nolog).
//
// What bounds it on the H100: as the mainline E-step (likelihood.cu),
// instruction issue and shared-memory loads per term; the logs are few (one
// per group). The design is the mainline's register tiles, estep_tiles.cuh
// (shared with folded.cu), over the group layout: each tile of 32 calls
// holds whole groups (G divides 32), so no fold is ragged.
// - At n_words 0 and 2 each group's sum is kept in registers as the product
//   of its arguments, one MUFU log2 per group (per 4 calls past G = 8),
//   scaled by ln 2, rounded to n_words words and added in group order. The
//   mainline's invariant makes this exact enough: U >= 1e-4 (fold_calls'
//   floor), so a product of 8 arguments stays a normal float and the clamp
//   at 1e-30 never acts. n_words 1 keeps one logf per term in call order, the
//   plain version's bits, because one rounded bf16 word moves by 2^-8 of the
//   log where a last-bit difference crosses a rounding boundary.
// row_ptr, the pairs and the schedule are bounds-checked once, when the
// operands are built (demux_variant_check, checks.cu).
#include "estep_tiles.cuh"

namespace {

template <bool kVec>
TilesKernel product_kernel(int n_words, int group) {
    // past 8 calls a group's log is the sum of its chunks' logs, in chunks of 4 (of 8, the chunk's 20
    // products beside the group's 20 sums spill)
    if (group > kMaxFold) return n_words == 0 ? &tiles_kernel<0, kProduct, 4, true, kVec, false>
                                              : &tiles_kernel<2, kProduct, 4, true, kVec, false>;
    if (n_words == 0) {
        return group == 1 ? &tiles_kernel<0, kProduct, 1, false, kVec, false>
             : group == 2 ? &tiles_kernel<0, kProduct, 2, false, kVec, false>
             : group == 4 ? &tiles_kernel<0, kProduct, 4, false, kVec, false>
                          : &tiles_kernel<0, kProduct, 8, false, kVec, false>;
    }
    return group == 1 ? &tiles_kernel<2, kProduct, 1, false, kVec, false>
         : group == 2 ? &tiles_kernel<2, kProduct, 2, false, kVec, false>
         : group == 4 ? &tiles_kernel<2, kProduct, 4, false, kVec, false>
                      : &tiles_kernel<2, kProduct, 8, false, kVec, false>;
}

template <bool kVec>
TilesKernel pick(int n_words, int use_log, int group) {
    if (!use_log) {
        return n_words == 0 ? &tiles_kernel<0, kNoLog, 1, false, kVec, false>
             : n_words == 1 ? &tiles_kernel<1, kNoLog, 1, false, kVec, false>
                            : &tiles_kernel<2, kNoLog, 1, false, kVec, false>;
    }
    return n_words == 1 ? &tiles_kernel<1, kTermLog, 1, false, kVec, false> : product_kernel<kVec>(n_words, group);
}

}  // namespace

// u: the folded calls of the group layout [n_calls, n_donors]; group divides 32; schedule [n_passes, 32, 24]
// the tile schedule with the operands' columns; n_words in 0..2 (0: full f32). row_ptr and schedule as
// demux_variant_check passed them.
extern "C" int demux_group_logits(const float* u, int64_t n_calls, int n_donors, const int64_t* row_ptr,
                                  int64_t n_barcodes, int group, const int32_t* schedule, int n_passes,
                                  const float* penalties, int n_pg, float* logits, int n_words, int use_log,
                                  int device, void* stream) {
    if (n_words < 0 || n_words > kMaxWords || group < 1) return (int)cudaErrorInvalidValue;
    const TilesKernel kernel = tiles_vec(u, n_donors) ? pick<true>(n_words, use_log, group)
                                                      : pick<false>(n_words, use_log, group);
    return launch_tiles(kernel, u, n_calls, n_donors, row_ptr, n_barcodes, group, schedule, n_passes, penalties,
                        n_pg, logits, device, stream);
}
