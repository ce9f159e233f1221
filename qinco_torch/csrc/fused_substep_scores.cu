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
// What the design does about it.  bf16 (the speed profile):
// fused_substep_tc_kernel, persistent blocks over work items of R beam
// rows (the wrapper's fused_plan picks R so that a launch has enough items
// to fill the card), every MLP product on the tensor cores (tc.cuh): the
// condition product (and with fold_up its product with U_0) once per
// item, then tiles of TM (row, slot) pairs through the rest of the MLP,
// activations as bf16 in shared memory, weights streamed through a
// cp.async ring.  The substep tile is the selected-scores kernel's
// (step_tc.cuh: same f32 sums in the same order on the CUDA cores), then
// a one-pass bin minimum.  The fused table (256 x 512 bf16 = 256 KB at
// qinco2-S) stays in L2: each tile fetches its winners' rows straight into
// the tile buffers with 16-byte loads, 4 in flight a thread, applying the
// row's condition terms on the way.  The distance is summed in the last
// product's epilogue into fixed-owner partials; only the packed (rows, A)
// result is written.  f32: the first version, fused_substep_kernel, the
// structure of the f32 selected-scores kernel (a block owns 32 rows, the
// MLP on the CUDA cores in f32 over tiles of TM pairs), each pair's table
// row read one warp per pair in 4-wide loads.
#include "step_tc.cuh"

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
  int R;                   // beam rows per work item (tensor-core kernel)
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

// Shared-memory layout of the tensor-core kernel (byte offsets), the same
// arithmetic as fused_plan in qinco_torch/ops/kernels.py:
//   stage table | r (R, D) f32 | ccb (R, Wc) f32 | up_cond (R, Dh) f32 with
//   fold_up | bin minima (R, A) f32 | score partials (TM, 16) f32 | one
//   region, overlaid by phase: rnd(xh) (R16, D) and, with fold_up, rnd(ccb)
//   (R16, Wc) bf16;  then rnd(r) (R, D) f32 and the substep tile (K, R + 1)
//   f32;  then per tile cand (TM, D), h (TM, De) and one buffer that holds
//   h0 (TM, De, low rank with in_proj) and lr (TM, Wc, low rank), or up
//   (TM, Dh) with fold_up, later the FFN hidden (TM, Dh), all bf16 | the
//   weight ring.
struct FusedLayout {
  unsigned r, ccb, upc, val, part, u, cand, h, big, lr, ring, total;
  __host__ __device__ FusedLayout(const FusedArgs& g, int TM) {
    using tc::align16;
    using tc::ld_of;
    const size_t R = g.R, R16 = (g.R + 15) / 16 * 16, D = g.D, De = g.De, Wc = g.Wc;
    const bool fold_up = g.off_up > 0, low_rank = g.concat_w2 != nullptr;
    r = tc::kStageBytes;
    ccb = r + align16(4 * R * D);
    upc = ccb + align16(4 * R * Wc);
    val = upc + (fold_up ? align16(4 * R * g.Dh) : 0);
    part = val + align16(4 * R * g.A);
    u = part + 4 * (size_t)TM * kScoreSlots;
    const size_t phase0 = 2 * R16 * (ld_of(D) + (fold_up ? ld_of(Wc) : 0));
    const size_t substep = align16(4 * R * D) + 4 * (size_t)g.K * (R + 1);
    cand = u;
    h = cand + 2 * (size_t)TM * ld_of(D);
    big = h + 2 * (size_t)TM * ld_of(De);
    lr = big + (low_rank && g.off_h > 0 ? 2 * (size_t)TM * ld_of(De) : 0);
    const size_t h0_lr = lr + (low_rank ? 2 * (size_t)TM * ld_of(Wc) : 0) - big;
    const size_t hid = 2 * (size_t)TM * ld_of(g.Dh);
    const size_t tiles = big - u + (h0_lr > hid ? h0_lr : hid);
    size_t region = phase0 > substep ? phase0 : substep;
    region = region > tiles ? region : tiles;
    ring = u + align16(region);
    total = ring + tc::kRingBytes;
  }
};

// Products in the tensor-core kernel's weight stream: W2 [and U_0 with
// fold_up] once per item, then per tile: fold_up D_0 and blocks 1..L-1;
// low rank concat_w2 and blocks 0..L-1; folded W1 blocks 0..L-1;
// [out_proj].
__host__ __device__ inline int fused_head_stages(const FusedArgs& g) {
  return 1 + (g.off_up > 0 ? 1 : 0);
}
__host__ __device__ inline int fused_stages(const FusedArgs& g) {
  const int tail = g.off_up > 0 ? 1 + 2 * (g.L - 1) : (g.concat_w2 ? 1 : 0) + 2 * g.L;
  return fused_head_stages(g) + tail + (g.out_proj ? 1 : 0);
}

// Round v + add to bf16 (with relu when RELU), eight values at a time.
template <bool RELU>
__device__ __forceinline__ uint4 add_round8(uint4 v, const float* add) {
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = tc::unpack_bf2(w[j]);
    float a = f.x + add[2 * j], b = f.y + add[2 * j + 1];
    if (RELU) {
      a = fmaxf(a, 0.f);
      b = fmaxf(b, 0.f);
    }
    w[j] = tc::pack_bf2(a, b);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// bf16 route: every MLP product on the tensor cores.  A block walks the
// work items blockIdx.x, blockIdx.x + gridDim.x, ...: R beam rows each,
// their R·A (row, slot) pairs in tiles of TM = 32·MT; pair p = i * A + a.
template <int MT>
__global__ void __launch_bounds__(tc::kTcThreads, 1) fused_substep_tc_kernel(FusedArgs g) {
  using namespace tc;
  constexpr int TM = 32 * MT;
  extern __shared__ __align__(16) unsigned char sm[];
  const int D = g.D, De = g.De, Dh = g.Dh, K = g.K, A = g.A, Wt = g.Wt, Wc = g.Wc, L = g.L;
  const int R = g.R, G = K / A, tid = threadIdx.x;
  const bool fold_up = g.off_up > 0, low_rank = g.concat_w2 != nullptr, proj = g.out_proj != nullptr;
  const FusedLayout lay(g, TM);
  float* r_s = reinterpret_cast<float*>(sm + lay.r);      // (R, D) residual target
  float* ccb_s = reinterpret_cast<float*>(sm + lay.ccb);  // (R, Wc) rnd(xh)·W2 (+ b)
  float* upc_s = reinterpret_cast<float*>(sm + lay.upc);  // (R, Dh) rnd(ccb)·U_0, fold_up
  float* val_s = reinterpret_cast<float*>(sm + lay.val);  // (R, A) packed bin minima
  float* part_s = reinterpret_cast<float*>(sm + lay.part);  // (TM, 16) distance partials
  const int ldd = ld_of(D), ldh = ld_of(De), ldf = ld_of(Dh), ldr = ld_of(Wc);
  const int R16 = (R + 15) / 16 * 16;
  bf16* xh_b = reinterpret_cast<bf16*>(sm + lay.u);       // (R16, D) rnd(xh)
  bf16* ccb_b = xh_b + R16 * ldd;                         // (R16, Wc) rnd(ccb), fold_up
  float* rr_s = reinterpret_cast<float*>(sm + lay.u);     // (R, D) rnd(r)
  float* S_s = reinterpret_cast<float*>(sm + lay.u + align16(4 * (size_t)R * D));  // (K, R + 1)
  bf16* cand_b = reinterpret_cast<bf16*>(sm + lay.cand);  // (TM, D) fetched codewords
  bf16* h_b = reinterpret_cast<bf16*>(sm + lay.h);        // (TM, De)
  bf16* hid_b = reinterpret_cast<bf16*>(sm + lay.big);    // (TM, Dh) up, then the FFN hidden
  bf16* lr_b = reinterpret_cast<bf16*>(sm + lay.lr);      // (TM, Wc) low rank
  // h0 of the low-rank layout: the table's C·P slice with in_proj (in the
  // big buffer), else the codeword itself
  bf16* h0_b = g.off_h > 0 ? hid_b : cand_b;
  const int ld0 = g.off_h > 0 ? ldh : ldd;

  WStage* stages = reinterpret_cast<WStage*>(sm);
  if (tid == 0) {
    const bf16* up = static_cast<const bf16*>(g.ffn_up);
    const bf16* down = static_cast<const bf16*>(g.ffn_down);
    int n = 0;
    stages[n++] = {static_cast<const bf16*>(g.w2), D, Wc};
    if (fold_up) stages[n++] = {up, De, Dh};
    if (fold_up) stages[n++] = {down, Dh, De};
    if (low_rank) stages[n++] = {static_cast<const bf16*>(g.concat_w2), Wc, De};
    for (int l = fold_up ? 1 : 0; l < L; ++l) {
      stages[n++] = {up + (size_t)l * De * Dh, De, Dh};
      stages[n++] = {down + (size_t)l * Dh * De, Dh, De};
    }
    if (proj) stages[n++] = {static_cast<const bf16*>(g.out_proj), De, D};
  }
  __syncthreads();
  const int n_pairs = R * A, n_items = (g.NF + R - 1) / R;
  WeightRing ring;
  ring.init(reinterpret_cast<bf16*>(sm + lay.ring), stages, fused_head_stages(g), fused_stages(g),
            (n_pairs + TM - 1) / TM);
  const bf16* table = static_cast<const bf16*>(g.table);

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int row0 = item * R, n_rows = min(R, g.NF - row0), n_valid = n_rows * A;
    __syncthreads();  // the last item's readers of r, ccb, up_cond, vals and the region are done

    // ---- r = x - xh and rnd(xh); the condition half of the concat layer,
    // ccb = rnd(xh)·W2 (+ b unless low rank), and with fold_up its product
    // with the first up-projection, up_cond = rnd(ccb)·U_0
    load_residuals(g.x, g.xh, row0, n_rows, R, D, g.F_in, r_s, xh_b, ldd);
    mma_stage<MT>(ring, xh_b, ldd, D, Wc, R, [&](int t, int c, float v0, float v1) {
      if (!low_rank) {
        v0 += g.concat_b[c];
        v1 += g.concat_b[c + 1];
      }
      ccb_s[t * Wc + c] = v0;
      ccb_s[t * Wc + c + 1] = v1;
      if (fold_up) st_bf2(ccb_b + t * ldr + c, v0, v1);
    });
    if (fold_up)
      mma_stage<MT>(ring, ccb_b, ldr, De, Dh, R, [&](int t, int c, float v0, float v1) {
        upc_s[t * Dh + c] = v0;
        upc_s[t * Dh + c + 1] = v1;
      });
    __syncthreads();  // the head products' readers of the region are done

    // ---- packed substep partial distances (K, R), as in the selected-
    // scores kernel, then the binned argmin: slot a of row i is the float
    // minimum of bin a's packed values (pairwise distinct: the id rides the
    // low bits; floats, not int bits: partial distances can be negative)
    for (int e = tid; e < R * D; e += kTcThreads) rr_s[e] = rnd<true>(r_s[e]);
    __syncthreads();
    substep_rows(rr_s, R, D, g.sub_t, g.cn2, K, S_s);
    __syncthreads();
    for (int e = tid; e < R * A; e += kTcThreads) {
      const int i = e % R, a = e / R;
      const float* col = S_s + (size_t)a * G * (R + 1) + i;
      float m = col[0];
      for (int j = 1; j < G; ++j) m = fminf(m, col[j * (R + 1)]);
      val_s[i * A + a] = m;
    }

    // ---- the (row, slot) pairs, TM at a time
    for (int p0 = 0; p0 < n_pairs; p0 += TM) {
      const int rows = max(0, min(TM, n_valid - p0));
      __syncthreads();  // vals are in; the region's last readers are done
      // Fetch each winner's table row, 8 bf16 a thread, 4 loads in flight,
      // straight into the tile buffers, adding the row's condition terms on
      // the way.  Every slice starts on a multiple of 16 columns, so 8
      // columns lie in one slice.  (cp.async with every row of the tile in
      // flight at once measured no faster: PERF.md, section 6.)
      const int CH = Wt / 8;
      for (int e0 = tid; e0 < rows * CH; e0 += 4 * kTcThreads) {
        uint4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + u * kTcThreads, t = e / CH, j = e - t * CH;
          v[u] = make_uint4(0, 0, 0, 0);
          if (e < rows * CH)
            v[u] = *reinterpret_cast<const uint4*>(table + (size_t)unpack_id(val_s[p0 + t]) * Wt +
                                                   8 * j);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + u * kTcThreads, t = e / CH, c = 8 * (e - t * CH);
          if (e >= rows * CH) break;
          const int i = (p0 + t) / A;
          if (c < D) {  // the codeword (and h0 of the low-rank layout without in_proj)
            *reinterpret_cast<uint4*>(cand_b + t * ldd + c) = v[u];
          } else if (low_rank) {
            if (c < g.off_w1)  // h0 = C·P
              *reinterpret_cast<uint4*>(h0_b + t * ld0 + c - g.off_h) = v[u];
            else  // lr = rnd(T_w1 + rnd(xh)·W2)
              *reinterpret_cast<uint4*>(lr_b + t * ldr + c - g.off_w1) =
                  add_round8<false>(v[u], ccb_s + i * Wc + c - g.off_w1);
          } else if (c < g.off_h + De) {  // h = rnd(T_h + ccb)
            *reinterpret_cast<uint4*>(h_b + t * ldh + c - g.off_h) =
                add_round8<false>(v[u], ccb_s + i * Wc + c - g.off_h);
          } else {  // fold_up: up = rnd(relu(T_up + up_cond))
            *reinterpret_cast<uint4*>(hid_b + t * ldf + c - g.off_up) =
                add_round8<true>(v[u], upc_s + i * Dh + c - g.off_up);
          }
        }
      }
      for (int e = tid; e < TM * kScoreSlots; e += kTcThreads) part_s[e] = 0.f;

      // d = ||r - out - cand||^2: each (t, c, c + 1) of out adds its two
      // squares to its slot; out is the last product's output
      auto score = [&](int t, int c, float o0, float o1) {
        const float* r = r_s + ((p0 + t) / A) * D + c;
        float d0 = r[0] - o0, d1 = r[1] - o1;
        if (g.res) {
          const float2 cv = ld_bf2(cand_b + t * ldd + c);
          d0 -= cv.x;
          d1 -= cv.y;
        }
        add_score(part_s, t, d0, d1);
      };
      // out = h when there is no out_proj: the last bf16 product carries the score
      const int l0 = fold_up ? 1 : 0;
      auto h_out = [&](int t, int c, float o0, float o1) {
        if (!proj) score(t, c, o0, o1);
      };
      auto first_out = [&](int t, int c, float o0, float o1) {
        if (!proj && L == l0) score(t, c, o0, o1);
      };
      if (fold_up) {  // the rest of FFN block 0: h = rnd(h + rnd(up·D_0))
        mma_stage_bf16<MT>(
            ring, hid_b, ldf, Dh, De, rows, h_b, ldh, h_b, ldh,
            [](int, int, float v0, float v1) { return make_float2(rnd<true>(v0), rnd<true>(v1)); },
            first_out);
      } else if (low_rank) {  // h = rnd(h0 + rnd(lr·W2_lr + b))
        mma_stage_bf16<MT>(
            ring, lr_b, ldr, Wc, De, rows, h_b, ldh, h0_b, ld0,
            [&](int, int c, float v0, float v1) {
              return make_float2(rnd<true>(v0 + g.concat_b[c]), rnd<true>(v1 + g.concat_b[c + 1]));
            },
            first_out);
      }
      ffn_stages<MT>(ring, h_b, ldh, hid_b, ldf, L - l0, De, Dh, rows, h_out);
      if (proj) mma_stage<MT>(ring, h_b, ldh, De, D, rows, score);
      __syncthreads();
      if (!proj && L == 0 && !low_rank)  // out = h, no product to carry the sums
        for (int e = tid; e < rows; e += kTcThreads)
          for (int c = 0; c < D; c += 2) {
            const float2 o = ld_bf2(h_b + e * ldh + c);
            float* q = part_s + e * kScoreSlots;
            const float* r = r_s + ((p0 + e) / A) * D + c;
            float d0 = r[0] - o.x, d1 = r[1] - o.y;
            if (g.res) {
              const float2 cv = ld_bf2(cand_b + e * ldd + c);
              d0 -= cv.x;
              d1 -= cv.y;
            }
            *q = fmaf(d1, d1, fmaf(d0, d0, *q));
          }
      // ---- the slots' sums, packed with the slot's id
      for (int t = tid; t < rows; t += kTcThreads) {
        const int p = p0 + t;
        g.out[(size_t)row0 * A + p] = pack_id(sum_score(part_s, t), unpack_id(val_s[p]));
      }
    }
  }
  ring.drain();
}

}  // namespace qt

extern "C" int qt_fused_substep_scores(const float* x, const float* xh, const float* sub_t,
                                       const float* cn2, const void* table, const void* w2,
                                       const void* concat_w2, const float* concat_b,
                                       const void* ffn_up, const void* ffn_down,
                                       const void* out_proj, float* out, int NF, int F_in, int D,
                                       int K, int De, int Dh, int L, int A, int Wt, int Wc,
                                       int off_h, int off_w1, int off_up, int tm, int rows,
                                       int blocks, int smem, int bf16, int res, void* stream) {
  using namespace qt;
  if (NF == 0) return 0;
  if (A <= 0 || K % A) return static_cast<int>(cudaErrorInvalidValue);
  const FusedArgs a{x,   xh,    sub_t, cn2, table, w2, concat_w2, concat_b, ffn_up, ffn_down,
                    out_proj, out, NF, F_in, D,  K,  De,        Dh,       L,      A,
                    Wt,  Wc,    off_h, off_w1, off_up, res, rows};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (fused_stages(a) > tc::kMaxStages || (size_t)smem < FusedLayout(a, tm).total || rows < 1 ||
        rows > kRows || (off_up > 0 && L < 1) || (tm != 64 && tm != 128))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(tm == 128 ? tc::launch_tc(fused_substep_tc_kernel<4>, blocks, smem, s, a)
                                      : tc::launch_tc(fused_substep_tc_kernel<2>, blocks, smem, s, a));
  }
  const int grid = (NF + kRows - 1) / kRows;
  switch (tm) {
    case 64: return static_cast<int>(launch_kernel(fused_substep_kernel<64, false>, grid, smem, s, a));
    case 32: return static_cast<int>(launch_kernel(fused_substep_kernel<32, false>, grid, smem, s, a));
    case 16: return static_cast<int>(launch_kernel(fused_substep_kernel<16, false>, grid, smem, s, a));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
