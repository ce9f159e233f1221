// Candidate scores: externally chosen codeword ids, scored through the
// unfolded step MLP.
//
// Replaces: qinco_tpu/ops/pallas_kernels.py, candidate_scores_pallas
// (:1019), body _cand_scores_kernel (:147).  The route for K > 256 (no
// packed ids) and for QINCo-LR (a low-rank concat factor, which the
// folded tables cannot absorb).
//
// What it computes, for each (row, slot) pair p = row * A + a with id
// idx[p] (any K):
//   cand = codebook[id] in the compute dtype (the QINCo2 "+ cand" below
//          uses this rounded codeword too, as the JAX one-hot fetch does)
//   cand_abs = (MLP(cand | xh[row]) + cand) + xh[row]
//     through _mlp_chain (:56): in_proj, the concat layer (and its
//     low-rank factor), L FFN blocks, out_proj; inputs rounded to the
//     compute dtype, f32 accumulation
//   d = ||x[row] - cand_abs||^2, packed with id when K <= 256
//
// What bounds it on the card: operations.  At the qinco2-S widths a pair
// costs about 0.33 MFLOP (the concat layer is a quarter of it, which the
// selected and fused-substep kernels fold away) against about 1 KB of
// input per row.
//
// What the design does about it, in this first version: a block takes a
// run of 256 consecutive pairs and scores them TM at a time with the
// chain shared with the select-rebuild kernel (mlp_chain_tile), on the
// CUDA cores in f32; codewords and condition rows are plain indexed loads
// and only the (rows, A) distances are written.
#include "common.cuh"

namespace qt {

constexpr int kPairs = 256;  // (row, slot) pairs per block

struct CandidateArgs {
  const float* x;         // (NF, D) targets
  const float* xh;        // (NF, D) beam rows
  const int* idx;         // (NF, A) codeword ids
  const void* codebook;   // (K, D) in the compute dtype
  ChainWeights w;
  float* out;             // (NF, A) squared distances (packed when pack)
  int NF, A, K, pack, res;
};

template <int TM, bool BF>
__global__ void __launch_bounds__(kThreads, 1) candidate_scores_kernel(CandidateArgs g) {
  using WT = typename WeightT<BF>::T;
  extern __shared__ __align__(16) float smem[];
  const int D = g.w.D, De = g.w.De, A = g.A;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long n_all = (long long)g.NF * A;
  const long long pb = (long long)blockIdx.x * kPairs;
  const int n_pairs = (int)min((long long)kPairs, n_all - pb);

  float* cand_s = smem;             // (TM, D) rounded codewords, f32
  float* cond_s = cand_s + TM * D;  // (TM, D) beam rows
  float* h_s = cond_s + TM * D;     // (TM, De)
  float* lr_s = h_s + TM * De;      // (TM, Wc) with the low-rank factor
  float* cat_s = lr_s + (g.w.concat_w2 ? TM * g.w.Wc : 0);  // (TM, max(De + D, Dh, D))
  const WT* book = static_cast<const WT*>(g.codebook);

  for (int p0 = 0; p0 < n_pairs; p0 += TM) {
    for (int e = tid; e < TM * D; e += kThreads) {
      const int t = e / D, c = e - t * D;
      float cv = 0.f, hv = 0.f;
      if (p0 + t < n_pairs) {
        const long long p = pb + p0 + t;
        const int id = g.idx[p];
        if ((unsigned)id < (unsigned)g.K) cv = to_f32(book[(size_t)id * D + c]);
        hv = g.xh[(size_t)(p / A) * D + c];
      }
      cand_s[e] = cv;
      cond_s[e] = hv;
    }
    __syncthreads();
    // cat_s is free once the chain's FFN blocks are done: it takes x - cand_abs
    mlp_chain_tile<TM, BF>(g.w, cand_s, cond_s, h_s, lr_s, cat_s, g.res,
                           [&](int t, int c, float v) {
                             float xv = 0.f;
                             if (p0 + t < n_pairs) xv = g.x[(size_t)((pb + p0 + t) / A) * D + c];
                             cat_s[t * D + c] = xv - v;
                           });
    __syncthreads();
    for (int t = warp; t < TM && p0 + t < n_pairs; t += kWarps) {
      float s = 0.f;
      for (int c = lane; c < D; c += 32) s = fmaf(cat_s[t * D + c], cat_s[t * D + c], s);
      s = warp_sum(s);
      if (lane == 0) {
        const long long p = pb + p0 + t;
        g.out[p] = g.pack ? pack_id(s, g.idx[p]) : s;
      }
    }
    __syncthreads();
  }
}

}  // namespace qt

extern "C" int qt_candidate_scores(const float* x, const float* xh, const int* idx,
                                   const void* codebook, const void* in_proj, const void* concat_w,
                                   const void* concat_w2, const float* concat_b,
                                   const void* ffn_up, const void* ffn_down, const void* out_proj,
                                   float* out, int NF, int A, int D, int K, int De, int Dh, int L,
                                   int Wc, int pack, int tm, int smem, int bf16, int res,
                                   void* stream) {
  using namespace qt;
  if (NF == 0 || A == 0) return 0;
  const ChainWeights w{in_proj, concat_w, concat_w2, concat_b, ffn_up, ffn_down, out_proj,
                       D,       De,       Dh,        L,        Wc};
  const CandidateArgs a{x, xh, idx, codebook, w, out, NF, A, K, pack, res};
  const long long n_all = (long long)NF * A;
  const int blocks = (int)((n_all + kPairs - 1) / kPairs);
  return static_cast<int>(dispatch_tile(tm, bf16, [&](auto TM, auto BF) {
    return launch_kernel(candidate_scores_kernel<decltype(TM)::value, decltype(BF)::value>,
                         blocks, smem, static_cast<cudaStream_t>(stream), a);
  }));
}
