// Phase cuts of the fused-substep kernel (B4, the speed profile's binned
// selection at bf16), the card's counterparts of scripts/kernel_variants.py's
// sel and sel+fetch.
//
// Replaces: scripts/kernel_variants.py, run_variant (:146), pallas_call
// (:182), bodies sel_kernel (:118, through _selection :93) and
// sel_fetch_kernel (:123, bound at :791-794 with off_h = D, off_w1 = D + de):
//   sel: r = x - xh, the packed substep distances and the minimum of each
//     of the A bins of G = K / A contiguous codewords: out = the packed
//     bin minima (NF, A);
//   sel+fetch: sel, then each bin winner's row of the script's table
//     [C | C·P_in | (C·P_in)·W1] (bf16, built by the wrapper as the
//     script's run_variant builds it), out = sum(row^2) a slot, unpacked.
// Against the production launch on one card, sel is B4's selection and
// sel+fetch - sel its fetch.
//
// What bounds it on the card: operations, the substep products (2·K·D a
// beam row) against x, xh, the substep codebook, the table and the (NF, A)
// output; the selection's compares are not counted.
//
// The design is the production kernel's (fused_tc.cuh), instantiated at
// each cut with if constexpr: the same walk over work items of R rows, the
// same substep tile and bin minimum, and for sel+fetch the production
// fetch's 16-byte loads (4 in flight a thread) into the tile buffers in
// shared memory, without its condition terms; no product and no weight
// stream.  fused_substep_scores.cu builds only the full cut.
#include "fused_tc.cuh"

// cut: a FusedCut value (1 sel, 2 sel+fetch); the arguments are those of
// qt_fused_substep_scores at bf16 (the plan's layout), table (K, Wt).
extern "C" int qt_fused_cuts(const float* x, const float* xh, const float* sub_t, const float* cn2,
                             const void* table, const void* w2, const void* concat_w2,
                             const float* concat_b, const void* ffn_up, const void* ffn_down,
                             const void* out_proj, float* out, int NF, int F_in, int D, int K,
                             int De, int Dh, int L, int A, int Wt, int Wc, int off_h, int off_w1,
                             int off_up, int tm, int rows, int blocks, int smem, int res, int cut,
                             void* stream) {
  using namespace qt;
  if (NF == 0) return 0;
  const FusedArgs a{x,   xh,    sub_t, cn2, table, w2, concat_w2, concat_b, ffn_up, ffn_down,
                    out_proj, out, NF, F_in, D,  K,  De,        Dh,       L,      A,
                    Wt,  Wc,    off_h, off_w1, off_up, res, rows};
  if (A <= 0 || K % A || (cut != static_cast<int>(FusedCut::kSel) &&
                          cut != static_cast<int>(FusedCut::kSelFetch)))
    return static_cast<int>(cudaErrorInvalidValue);
  const FusedLayout lay(a, tm);
  // sel+fetch's rows (tm, ld Wt) bf16 lie over the tile buffers
  const bool fits = cut == static_cast<int>(FusedCut::kSel) ||
                    (Wt % 16 == 0 && 2 * (size_t)tm * tc::ld_of(Wt) <= lay.ring - lay.cand);
  if ((size_t)smem < lay.total || !fits || rows < 1 || rows > kRows || (off_up > 0 && L < 1) ||
      (tm != 64 && tm != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using tc::launch_tc;
  if (cut == static_cast<int>(FusedCut::kSel))
    return static_cast<int>(
        tm == 128 ? launch_tc(fused_substep_tc_kernel<4, FusedCut::kSel>, blocks, smem, s, a)
                  : launch_tc(fused_substep_tc_kernel<2, FusedCut::kSel>, blocks, smem, s, a));
  return static_cast<int>(
      tm == 128 ? launch_tc(fused_substep_tc_kernel<4, FusedCut::kSelFetch>, blocks, smem, s, a)
                : launch_tc(fused_substep_tc_kernel<2, FusedCut::kSelFetch>, blocks, smem, s, a));
}
