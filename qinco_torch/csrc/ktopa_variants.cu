// Phase cuts of the selected-scores kernel (B2, in-kernel exact top-A at
// bf16), the card's counterparts of the modes of scripts/ktopa_breakdown.py,
// and of scripts/kernel_variants.py's selcat (B2' with external vals).
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
// Also replaces: scripts/kernel_variants.py, main's "selcat" (:632),
// run_selcat (:683), pallas_call (:727), body selcat_kernel (:638): B2'
// with external packed vals (the exact top-A of the f32 substep
// distances, computed outside) and the folded table [C | C·P + (C·P)·W1]
// in bf16: cand = T[:D], h = rnd(T_h + rnd(xh)·W2 + b), the L blocks, out
// = h·P_out + cand, d = ||(x - out) - xh||^2, packed with the vals' ids
// (SelCut::kSelCat).  The TPU fetches all slots by one one-hot product
// over the concatenated masks; here, as in B2, by id.  Against production
// B2' under the script's spec (fast: the lean fetch) its rounding points
// differ: h_cand = rnd(C·P + rnd(C·P)·W1) read from the table, not
// rnd(C)·rnd(P·(I + W1)) in the kernel, and the distance is formed from x
// and xh, not from r = x - xh (ops/breakdown.py's selcat_plain).  It is
// bound as B2' is, by its operations.
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

template <int NW, int HP>
cudaError_t launch_cut(int cut, int blocks, int smem, int cluster, cudaStream_t s,
                       const SelectedArgs& a) {
  switch (static_cast<SelCut>(cut)) {
#define QT_CUT(C)                                                                       \
  case SelCut::C:                                                                       \
    return launch_selected(selected_scores_tc_kernel<NW, SelCut::C, false, HP>, blocks, \
                           smem, cluster, s, a);
    QT_CUT(kFull)
    QT_CUT(kNoExtract)
    QT_CUT(kMlpOnly)
    QT_CUT(kNoDist)
    QT_CUT(kShell)
    QT_CUT(kPerSlot)
    QT_CUT(kTournament)
    QT_CUT(kSelCat)
#undef QT_CUT
  }
  return cudaErrorInvalidValue;
}

}  // namespace qt

// cut: a SelCut value (0 full .. 7 selcat).  At bf16; the in-kernel top-A
// route (vals null) for every cut but selcat, which takes the external
// packed vals (NF, A), no wfold, and (R, D) f32 at the end of the shared
// memory.
extern "C" int qt_ktopa_variants(const float* x, const float* xh, const float* vals,
                                 const float* sub_t, const float* cn2, const void* table,
                                 const void* wfold, const void* w2, const float* concat_b,
                                 const void* ffn_up, const void* ffn_down, const void* out_proj,
                                 float* out, int NF, int F_in, int D, int K, int De, int Dh, int L,
                                 int A, int Wt, int tm, int rows, int blocks, int smem,
                                 int cluster, int res, int cut, void* stream) {
  using namespace qt;
  if (NF == 0) return 0;
  const bool selcat = cut == static_cast<int>(SelCut::kSelCat);
  const SelectedArgs a{x,      xh,       selcat ? vals : nullptr, sub_t, cn2, table, wfold, w2,
                       concat_b, ffn_up, ffn_down, out_proj, out, NF, F_in, D, K, De,
                       Dh,     L,        A,        Wt,    res, rows};
  const bool tournament = cut == static_cast<int>(SelCut::kTournament);
  const size_t extra = selcat ? tc::align16(4 * (size_t)rows * D) : 0;
  const int hp = hidden_passes(Dh);  // 128 pairs: the hidden's passes in registers
  if (cut < 0 || cut > static_cast<int>(SelCut::kSelCat) || K > 256 || A < 1 ||
      (!selcat && A > K) || (selcat && (vals == nullptr || wfold != nullptr)) ||
      (tournament && (K % A || A > 32 || K / A > 32)) || selected_stages(a) > tc::kMaxStages ||
      SelectedLayout(a, tm, !selcat).slots(smem, extra) < wg::kMinRing || rows < 1 ||
      rows > kRows || (tm != 64 && (tm != 128 || hp == 0)) ||
      (cluster != 1 && cluster != 2 && cluster != 4) || blocks < cluster || blocks % cluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(tm == 64  ? launch_cut<1, 0>(cut, blocks, smem, cluster, s, a)
                          : hp == 2 ? launch_cut<2, 2>(cut, blocks, smem, cluster, s, a)
                                    : launch_cut<2, 3>(cut, blocks, smem, cluster, s, a));
}
