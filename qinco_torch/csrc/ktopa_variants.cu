// Phase cuts of the selected-scores kernel (B2, in-kernel exact top-A at
// bf16), the card's counterparts of the modes of scripts/ktopa_breakdown.py.
//
// Replaces: scripts/ktopa_breakdown.py, run_variant (:305), pallas_call
// (:335), body ktopa_kernel (:104): B2's lean-fetch in-kernel top-A with a
// mode switch that cuts or reorders its phases.  Each mode here computes
// what the TPU mode computes, mapped onto this card's kernel by what it
// isolates (qinco_torch/ops/breakdown.py holds the plain versions):
//   full (and deferred, catfetch): the production kernel.  The TPU's
//     deferred and catfetch move where its one-hot fetch masks are built
//     and how many matrix products fetch; this kernel gathers by id after
//     a complete extraction, so both are the full kernel here;
//   noextract: slot a takes codeword a's packed substep value: the
//     min-and-remove (top_a_rows) is cut, fetch, MLP and distance stay;
//   mlponly: noextract with every slot's candidate its row's slot-0
//     codeword, loaded once a row: the per-slot fetch is cut;
//   nodist: mlponly with the epilogue |sum(out + cand)| + 1: the distance
//     epilogue's residual and squares are cut;
//   shell: nodist without the per-pair products, d = ||r - cand||^2 (the
//     TPU mode's function); the condition product, once a row, stays;
//   perslot: the full function with the pairs taken slot-major, one
//     slot's R rows a tile;
//   tournament: the full function, the exact top-A taken from the minima
//     of A bins of K / A codewords, re-scanning only the winner's bin.
// So on one card, full - noextract is the extraction, noextract - mlponly
// the fetch, mlponly - nodist the distance epilogue, nodist - shell the
// MLP, and shell what is left (residuals, substep tile, write-back).
//
// What bounds it on the card: operations, as the production kernel
// (selected_scores.cu: about 4.8 MFLOP a beam row at qinco2-S against
// 0.6 KB); the shell's function needs the substep products alone, and is
// bound by them and its bytes (x, xh, the packed output).
//
// The design is the production kernel's (selected_tc.cuh), instantiated
// at each cut with if constexpr, so the cuts time the production pipeline
// and not a copy of it; selected_scores.cu builds only the full cut.
#include "selected_tc.cuh"

namespace qt {

template <int MT>
cudaError_t launch_cut(int cut, int blocks, int smem, cudaStream_t s, const SelectedArgs& a) {
  switch (static_cast<SelCut>(cut)) {
    case SelCut::kFull:
      return tc::launch_tc(selected_scores_tc_kernel<MT, SelCut::kFull>, blocks, smem, s, a);
    case SelCut::kNoExtract:
      return tc::launch_tc(selected_scores_tc_kernel<MT, SelCut::kNoExtract>, blocks, smem, s, a);
    case SelCut::kMlpOnly:
      return tc::launch_tc(selected_scores_tc_kernel<MT, SelCut::kMlpOnly>, blocks, smem, s, a);
    case SelCut::kNoDist:
      return tc::launch_tc(selected_scores_tc_kernel<MT, SelCut::kNoDist>, blocks, smem, s, a);
    case SelCut::kShell:
      return tc::launch_tc(selected_scores_tc_kernel<MT, SelCut::kShell>, blocks, smem, s, a);
    case SelCut::kPerSlot:
      return tc::launch_tc(selected_scores_tc_kernel<MT, SelCut::kPerSlot>, blocks, smem, s, a);
    case SelCut::kTournament:
      return tc::launch_tc(selected_scores_tc_kernel<MT, SelCut::kTournament>, blocks, smem, s, a);
  }
  return cudaErrorInvalidValue;
}

}  // namespace qt

// cut: a SelCut value (0 full .. 6 tournament).  The in-kernel top-A
// route at bf16 only (no external vals).
extern "C" int qt_ktopa_variants(const float* x, const float* xh, const float* sub_t,
                                 const float* cn2, const void* table, const void* wfold,
                                 const void* w2, const float* concat_b, const void* ffn_up,
                                 const void* ffn_down, const void* out_proj, float* out, int NF,
                                 int F_in, int D, int K, int De, int Dh, int L, int A, int Wt,
                                 int tm, int rows, int blocks, int smem, int res, int cut,
                                 void* stream) {
  using namespace qt;
  if (NF == 0) return 0;
  const SelectedArgs a{x,      xh,       nullptr,  sub_t, cn2, table, wfold, w2, concat_b,
                       ffn_up, ffn_down, out_proj, out,   NF,  F_in,  D,     K,  De,
                       Dh,     L,        A,        Wt,    res, rows};
  const bool tournament = cut == static_cast<int>(SelCut::kTournament);
  if (cut < 0 || cut > static_cast<int>(SelCut::kTournament) || K > 256 || A < 1 || A > K ||
      (tournament && (K % A || A > 32 || K / A > 32)) || selected_stages(a) > tc::kMaxStages ||
      (size_t)smem < SelectedLayout(a, tm, true).total || rows < 1 || rows > kRows ||
      (tm != 64 && tm != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(tm == 128 ? launch_cut<4>(cut, blocks, smem, s, a)
                                    : launch_cut<2>(cut, blocks, smem, s, a));
}
