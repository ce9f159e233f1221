// Fused-substep scores: binned argmin selection, scored through the fused
// per-codeword table (the speed profile).
//
// Replaces: qinco_tpu/ops/pallas_kernels.py, fused_substep_scores_pallas
// (:483), body _fused_substep_kernel (:198), both of its forms (spec.perbin
// and the blocked form compute the same function).
//
// What it computes, per beam row (x broadcast over the F_in rows of its
// vector), with the K codewords split into A contiguous bins of G = K/A:
//   r      = x - xh
//   d_sub  = ||C_k||^2 - 2 rnd(C_k)·rnd(r), packed with k, for every k
//   slot a = the float minimum of bin a's G packed values (its id in the
//            low bits).  The slot IS the bin: slot order is bin order,
//            not an ascending rank.
//   per slot, from the winner's row T of the fused table (compute dtype):
//     cand = T[:D]
//     fold_up  [C | h_cand | up_cand]:
//       ccb = rnd(xh)·W2 + b,  up_cond = rnd(ccb)·U_0   (once per row)
//       h = rnd(T_h + ccb);  up = rnd(relu(T_up + up_cond))
//       h = rnd(h + rnd(up·D_0));  FFN blocks 1 .. L-1
//     folded W1 [C | h_cand]:  h = rnd(T_h + ccb);  FFN blocks 0 .. L-1
//     low rank [C | (C·P) | C·P·W1] (QINCo-LR):
//       lr = rnd(T_w1 + rnd(xh)·W2);  h = rnd(h0 + rnd(lr·W2_lr + b))
//       with h0 = T_cp (or cand without in_proj);  FFN blocks 0 .. L-1
//     out = h·P_out (f32) or h;  d = ||r - out - cand||^2, packed with id
// rnd() rounds to the compute dtype; every product accumulates in f32.
//
// What bounds it on the card: operations.  At qinco2-S with fold_up a
// beam row costs about 3.3 MFLOP (the slots' down-projection and second
// FFN block are 95% of it) against about 0.6 KB of input and output.
//
// What the design does about it, in this first version: the structure of
// the selected-scores kernel (a block owns 32 rows, everything between
// the stages stays in shared memory, the MLP runs on the CUDA cores in
// f32 over tiles of TM pairs), with the selection a one-pass bin minimum
// instead of A rounds of min-and-remove, and the fold_up table deleting
// the concat layer and the first up-projection from the per-slot work.
// The table itself (256 x 512 bf16 = 256 KB at qinco2-S, 448 KB at the
// qinco2-M widths) does not fit a block's shared memory: each pair's row
// is read from device memory, where the whole table stays L2-resident,
// one warp per pair in 4-wide loads.
#include "common.cuh"

namespace qt {

constexpr int kRows = 32;  // beam rows per block

struct FusedArgs {
  const float* x;          // (NF / F_in, D) per-vector targets
  const float* xh;         // (NF, D) beam rows
  const float* sub_t;      // (D, K) substep codebook, rounded, transposed
  const float* cn2;        // (K,) ||C_k||^2 of the f32 substep codebook
  const void* table;       // (K, Wt) fused per-codeword table
  const void* w2;          // (D, Wc) condition half of the concat weight
  const void* concat_w2;   // (Wc, De) low-rank factor, or null
  const float* concat_b;   // (De,)
  const void* ffn_up;      // (L, De, Dh)
  const void* ffn_down;    // (L, Dh, De)
  const void* out_proj;    // (De, D) or null
  float* out;              // (NF, A) packed distances
  int NF, F_in, D, K, De, Dh, L, A, Wt, Wc;
  int off_h, off_w1, off_up;  // table column offsets, as in the JAX wrapper
  int res;
};

template <int TM, bool BF>
__global__ void __launch_bounds__(kThreads, 1) fused_substep_kernel(FusedArgs g) {
  using WT = typename WeightT<BF>::T;
  extern __shared__ __align__(16) float smem[];
  constexpr int R = kRows;
  const int D = g.D, De = g.De, Dh = g.Dh, K = g.K, A = g.A, Wt = g.Wt, Wc = g.Wc;
  const int G = K / A;
  const bool fold_up = g.off_up > 0, low_rank = g.concat_w2 != nullptr;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * R;
  const int n_rows = min(R, g.NF - row0);

  float* r_s = smem;                                  // (R, D) residual target
  float* ccb_s = r_s + R * D;                         // (R, Wc) condition half
  float* upc_s = ccb_s + R * Wc;                      // (R, Dh) rnd(ccb)·U_0, fold_up
  float* val_s = upc_s + (fold_up ? R * Dh : 0);      // (R, A) packed bin minima
  float* u_s = val_s + R * A;                         // the phases' buffers, overlaid

  // ---- phase 0: r = x - xh, the condition half of the concat layer and,
  // with fold_up, its product with the first up-projection
  float* xh_s = u_s;  // (R, D)
  for (int e = tid; e < R * D; e += kThreads) {
    const int i = e / D, c = e - i * D;
    float xv = 0.f, hv = 0.f;
    if (i < n_rows) {
      const int row = row0 + i;
      hv = g.xh[(size_t)row * D + c];
      xv = g.x[(size_t)(row / g.F_in) * D + c];
    }
    xh_s[e] = hv;
    r_s[e] = xv - hv;
  }
  __syncthreads();
  mlp_stage<R, true, BF>(xh_s, D, static_cast<const WT*>(g.w2), D, Wc,
                         [&](int i, int c, float acc) {
                           ccb_s[i * Wc + c] = low_rank ? acc : acc + g.concat_b[c];
                         });
  __syncthreads();
  if (fold_up) {
    mlp_stage<R, true, BF>(ccb_s, Wc, static_cast<const WT*>(g.ffn_up), De, Dh,
                           [&](int i, int c, float acc) { upc_s[i * Dh + c] = acc; });
    __syncthreads();
  }

  // ---- phase 1: packed substep partial distances, a (K, R) tile
  float* rr_s = u_s;          // (R, D) r rounded to the compute dtype
  float* S_s = rr_s + R * D;  // (K, R + 1)
  for (int e = tid; e < R * D; e += kThreads) rr_s[e] = rnd<BF>(r_s[e]);
  __syncthreads();
  substep_tile<R>(rr_s, D, g.sub_t, g.cn2, K, S_s);
  __syncthreads();

  // ---- phase 2: binned argmin.  Slot a of row i is the float minimum of
  // bin a's packed values; packed values are pairwise distinct, so the
  // minimum is one codeword and its id rides the low bits.  Floats, not
  // int bits: partial distances can be negative.
  for (int e = tid; e < R * A; e += kThreads) {
    const int i = e % R, a = e / R;
    const float* col = S_s + (size_t)a * G * (R + 1) + i;
    float m = col[0];
    for (int j = 1; j < G; ++j) m = fminf(m, col[j * (R + 1)]);
    val_s[i * A + a] = m;
  }
  __syncthreads();

  // ---- phase 3: fetch the winners' table rows, MLP and distance for the
  // (row, slot) pairs, TM at a time; pair p = i * A + a is val_s[p].
  float* cand_s = u_s;            // (TM, D) fetched codewords
  float* h_s = cand_s + TM * D;   // (TM, De)
  float* big_s = h_s + TM * De;   // (TM, max(Dh, D, Wc)): up / lr, FFN hidden, out
  const WT* table = static_cast<const WT*>(g.table);
  const int n_pairs = R * A;
  for (int p0 = 0; p0 < n_pairs; p0 += TM) {
    // Fetch: warp w takes pairs w, w + 8, ...; lane l reads columns
    // 4l .. 4l+3 of each 128-column pass over the winner's table row.
    // Every slice starts and ends on a multiple of 4, so a group of four
    // columns lies in one slice (the codeword slice and the h slice
    // overlap in the low-rank layout without in_proj: off_h = 0).
    for (int t = warp; t < TM; t += kWarps) {
      const int p = min(p0 + t, n_pairs - 1), i = p / A;
      const WT* row = table + (size_t)unpack_id(val_s[p]) * Wt;
      for (int c0 = 4 * lane; c0 < Wt; c0 += 128) {
        float v[4];
        load4(row + c0, v);
        if (c0 < D)
#pragma unroll
          for (int j = 0; j < 4; ++j) cand_s[t * D + c0 + j] = v[j];
        if (c0 >= g.off_h && c0 < g.off_h + De) {
          const int c = c0 - g.off_h;
#pragma unroll
          for (int j = 0; j < 4; ++j)  // low rank: h0 is the C·P column (or the codeword)
            h_s[t * De + c + j] = low_rank ? v[j] : rnd<BF>(v[j] + ccb_s[i * Wc + c + j]);
        }
        if (fold_up && c0 >= g.off_up) {
          const int c = c0 - g.off_up;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            big_s[t * Dh + c + j] = rnd<BF>(fmaxf(v[j] + upc_s[i * Dh + c + j], 0.f));
        } else if (low_rank && c0 >= g.off_w1) {
          const int c = c0 - g.off_w1;
#pragma unroll
          for (int j = 0; j < 4; ++j) big_s[t * Wc + c + j] = rnd<BF>(v[j] + ccb_s[i * Wc + c + j]);
        }
      }
    }
    __syncthreads();
    int l0 = 0;
    if (fold_up) {  // the rest of FFN block 0: h = rnd(h + rnd(up·D_0))
      mlp_stage<TM, false, BF>(big_s, Dh, static_cast<const WT*>(g.ffn_down), Dh, De,
                               [&](int t, int c, float acc) {
                                 h_s[t * De + c] = rnd<BF>(h_s[t * De + c] + rnd<BF>(acc));
                               });
      __syncthreads();
      l0 = 1;
    } else if (low_rank) {  // h = rnd(h0 + rnd(lr·W2_lr + b))
      mlp_stage<TM, false, BF>(big_s, Wc, static_cast<const WT*>(g.concat_w2), Wc, De,
                               [&](int t, int c, float acc) {
                                 h_s[t * De + c] =
                                     rnd<BF>(h_s[t * De + c] + rnd<BF>(acc + g.concat_b[c]));
                               });
      __syncthreads();
    }
    ffn_blocks<TM, BF>(h_s, big_s, g.ffn_up, g.ffn_down, l0, g.L, De, Dh);
    score_pairs<TM, BF>(h_s, big_s, g.out_proj, cand_s, r_s, val_s, p0, n_pairs, A, n_rows, D,
                        De, g.res, g.out + (size_t)row0 * A);
    __syncthreads();
  }
}

}  // namespace qt

extern "C" int qt_fused_substep_scores(const float* x, const float* xh, const float* sub_t,
                                       const float* cn2, const void* table, const void* w2,
                                       const void* concat_w2, const float* concat_b,
                                       const void* ffn_up, const void* ffn_down,
                                       const void* out_proj, float* out, int NF, int F_in, int D,
                                       int K, int De, int Dh, int L, int A, int Wt, int Wc,
                                       int off_h, int off_w1, int off_up, int tm, int smem,
                                       int bf16, int res, void* stream) {
  using namespace qt;
  if (NF == 0) return 0;
  if (A <= 0 || K % A) return static_cast<int>(cudaErrorInvalidValue);
  const FusedArgs a{x,   xh,    sub_t, cn2, table, w2, concat_w2, concat_b, ffn_up, ffn_down,
                    out_proj, out, NF, F_in, D,  K,  De,        Dh,       L,      A,
                    Wt,  Wc,    off_h, off_w1, off_up, res};
  const int blocks = (NF + kRows - 1) / kRows;
  return static_cast<int>(dispatch_tile(tm, bf16, [&](auto TM, auto BF) {
    return launch_kernel(fused_substep_kernel<decltype(TM)::value, decltype(BF)::value>, blocks,
                         smem, static_cast<cudaStream_t>(stream), a);
  }));
}
