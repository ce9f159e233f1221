// Selected-scores kernel: exact top-A candidates, scored.
//
// Replaces: qinco_tpu/ops/pallas_kernels.py, selected_scores_pallas
// (:880), body _selected_scores_kernel (:625), both of its routes:
//   - in-kernel top-A (sub_codebook given, vals null): the substep
//     distances over K and an exact ascending top-A per row;
//   - external vals (vals given, B2'): the top-A was taken outside, and
//     the kernel reads each slot's id from the low bits of its packed
//     value.
//
// What it computes, per beam row (x broadcast over the F_in rows of its
// vector):
//   r      = x - xh
//   [in-kernel top-A]  d_sub = ||C_k||^2 - 2 rnd(C_k)·rnd(r) for every k;
//                      the A smallest packed d_sub, ascending
//   for each slot's id:  cand = table[id][:D] (compute dtype)
//     lean table (spec.fast):  h = rnd(cand·wfold + rnd(xh)·W2 + b)
//     folded table:            h = rnd(table[id][D:] + rnd(xh)·W2 + b)
//     L times: up = rnd(relu(h·U_l)); h = rnd(h + rnd(up·D_l))
//     out = h·P_out (f32) or h
//     d = ||r - out - cand||^2, packed with id  ->  out[row][slot]
// rnd() rounds to the compute dtype; every product accumulates in f32.
//
// What bounds it on the card: operations.  At qinco2-S a beam row costs
// about 4.8 MFLOP (the A slots' MLP is 98% of it) against about 0.6 KB
// of input and output, far above the H100's ~295 FLOP/byte bf16 ridge.
//
// What the design does about it, in this first version: a block owns 32
// rows and keeps everything between the stages in shared memory, so
// nothing but the packed (rows, A) result goes back to device memory.
// The substep tile (K x 32) and a warp-per-row min-and-remove give the
// exact top-A; the MLP runs on the CUDA cores in f32 over tiles of TM
// (row, slot) pairs, reading the step's weights (~0.35 MB at qinco2-S)
// from L2.  The tensor cores (mma / wgmma on the bf16 operands) are the
// next step: the CUDA cores' f32 rate is a small fraction of them.
#include "common.cuh"

namespace qt {

constexpr int kRows = 32;  // beam rows per block

struct SelectedArgs {
  const float* x;         // (NF / F_in, D) per-vector targets
  const float* xh;        // (NF, D) beam rows
  const float* vals;      // (NF, A) packed external top-A, or null
  const float* sub_t;     // (D, K) substep codebook, rounded, transposed
  const float* cn2;       // (K,) ||C_k||^2 of the f32 substep codebook
  const void* table;      // (K, Wt): lean C (Wt = D) or folded [C | h_cand]
  const void* wfold;      // (D, De) P·(I+W1) with the lean table, else null
  const void* w2;         // (D, De) condition half of the concat weight
  const float* concat_b;  // (De,)
  const void* ffn_up;     // (L, De, Dh)
  const void* ffn_down;   // (L, Dh, De)
  const void* out_proj;   // (De, D) or null
  float* out;             // (NF, A) packed distances
  int NF, F_in, D, K, De, Dh, L, A, Wt, res;
};

template <int TM, bool BF>
__global__ void __launch_bounds__(kThreads, 1) selected_scores_kernel(SelectedArgs g) {
  using WT = typename WeightT<BF>::T;
  extern __shared__ __align__(16) float smem[];
  constexpr int R = kRows;
  const int D = g.D, De = g.De, Dh = g.Dh, K = g.K, A = g.A, Wt = g.Wt;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * R;
  const int n_rows = min(R, g.NF - row0);

  float* r_s = smem;              // (R, D) residual target
  float* ccb_s = r_s + R * D;     // (R, De) rnd(xh)·W2 + b
  float* val_s = ccb_s + R * De;  // (R, A) packed top-A substep values
  float* u_s = val_s + R * A;     // the phases' buffers, overlaid

  // ---- phase 0: r = x - xh and the condition half of the concat layer
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
  mlp_stage<R, true, BF>(xh_s, D, static_cast<const WT*>(g.w2), D, De,
                         [&](int i, int c, float acc) { ccb_s[i * De + c] = acc + g.concat_b[c]; });
  __syncthreads();

  if (g.vals) {
    // ---- external top-A: the packed values carry the ids
    for (int e = tid; e < R * A; e += kThreads)
      val_s[e] = e / A < n_rows ? g.vals[(size_t)row0 * A + e] : 0.f;
    __syncthreads();
  } else {
    // ---- phase 1: packed substep partial distances, a (K, R) tile
    float* rr_s = u_s;          // (R, D) r rounded to the compute dtype
    float* S_s = rr_s + R * D;  // (K, R + 1)
    for (int e = tid; e < R * D; e += kThreads) rr_s[e] = rnd<BF>(r_s[e]);
    __syncthreads();
    substep_tile<R>(rr_s, D, g.sub_t, g.cn2, K, S_s);
    __syncthreads();

    // ---- phase 2: exact top-A per row, ascending.  A rounds of (warp
    // min, remove the winner).  The packed values of one row are
    // pairwise distinct (their ids differ), so each round removes exactly
    // one entry and the order is that of a stable sort of the packed
    // values.  They are compared as floats: partial distances can be
    // negative.
    for (int i = warp; i < R; i += kWarps) {
      float v[8];  // K <= 256 = 32 lanes x 8
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = lane + 32 * j;
        v[j] = k < K ? S_s[k * (R + 1) + i] : CUDART_INF_F;
      }
      for (int a = 0; a < A; ++a) {
        float m = v[0];
#pragma unroll
        for (int j = 1; j < 8; ++j) m = fminf(m, v[j]);
#pragma unroll
        for (int off = 16; off; off >>= 1) m = fminf(m, __shfl_xor_sync(kFull, m, off));
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (v[j] == m) v[j] = CUDART_INF_F;
        if (lane == 0) val_s[i * A + a] = m;
      }
    }
    __syncthreads();
  }

  // ---- phase 3: fetch, MLP and distance for the (row, slot) pairs,
  // TM at a time; pair p = i * A + a is val_s[p].
  float* cand_s = u_s;            // (TM, D) fetched codewords
  float* h_s = cand_s + TM * D;   // (TM, De)
  float* big_s = h_s + TM * De;   // (TM, max(Dh, D)): FFN hidden, then out
  const WT* table = static_cast<const WT*>(g.table);
  const int n_pairs = R * A;
  for (int p0 = 0; p0 < n_pairs; p0 += TM) {
    for (int e = tid; e < TM * D; e += kThreads) {
      const int t = e / D, c = e - t * D, p = p0 + t;
      cand_s[e] = p < n_pairs ? to_f32(table[(size_t)unpack_id(val_s[p]) * Wt + c]) : 0.f;
    }
    if (g.wfold) {
      __syncthreads();
      mlp_stage<TM, false, BF>(cand_s, D, static_cast<const WT*>(g.wfold), D, De,
                               [&](int t, int c, float acc) {
                                 const int i = min(p0 + t, n_pairs - 1) / A;
                                 h_s[t * De + c] = rnd<BF>(acc + ccb_s[i * De + c]);
                               });
    } else {
      for (int e = tid; e < TM * De; e += kThreads) {
        const int t = e / De, c = e - t * De, p = min(p0 + t, n_pairs - 1);
        h_s[e] = rnd<BF>(to_f32(table[(size_t)unpack_id(val_s[p]) * Wt + D + c]) +
                         ccb_s[(p / A) * De + c]);
      }
    }
    __syncthreads();
    ffn_blocks<TM, BF>(h_s, big_s, g.ffn_up, g.ffn_down, 0, g.L, De, Dh);
    score_pairs<TM, BF>(h_s, big_s, g.out_proj, cand_s, r_s, val_s, p0, n_pairs, A, n_rows, D,
                        De, g.res, g.out + (size_t)row0 * A);
    __syncthreads();
  }
}

}  // namespace qt

extern "C" int qt_selected_scores(const float* x, const float* xh, const float* vals,
                                  const float* sub_t, const float* cn2, const void* table,
                                  const void* wfold, const void* w2, const float* concat_b,
                                  const void* ffn_up, const void* ffn_down, const void* out_proj,
                                  float* out, int NF, int F_in, int D, int K, int De, int Dh,
                                  int L, int A, int Wt, int tm, int smem, int bf16, int res,
                                  void* stream) {
  using namespace qt;
  if (NF == 0) return 0;
  const SelectedArgs a{x,      xh,       vals,     sub_t, cn2, table, wfold, w2, concat_b,
                       ffn_up, ffn_down, out_proj, out,   NF,  F_in,  D,     K,  De,
                       Dh,     L,        A,        Wt,    res};
  const int blocks = (NF + kRows - 1) / kRows;
  return static_cast<int>(dispatch_tile(tm, bf16, [&](auto TM, auto BF) {
    return launch_kernel(selected_scores_kernel<decltype(TM)::value, decltype(BF)::value>, blocks,
                         smem, static_cast<cudaStream_t>(stream), a);
  }));
}
