// The tensor-core (bf16) route of the fused-substep kernel, a template on
// its phase cut (FusedCut).  fused_substep_scores.cu instantiates the full
// kernel, the production route; fused_cuts.cu the cuts of
// scripts/kernel_variants.py's sel and sel+fetch, which time its phases.
// See fused_substep_scores.cu for what the kernel computes and why it is
// built so.
#pragma once

#include "step_tc.cuh"

namespace qt {

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
  int R;                   // beam rows per work item
};

// Products in a kernel's weight stream: W2 [and U_0 with fold_up] once per
// item, then per tile: fold_up D_0 and blocks 1..L-1; low rank concat_w2
// and blocks 0..L-1; folded W1 blocks 0..L-1; [out_proj].
__host__ __device__ inline int fused_head_stages(const FusedArgs& g) {
  return 1 + (g.off_up > 0 ? 1 : 0);
}
__host__ __device__ inline int fused_stages(const FusedArgs& g) {
  const int tail = g.off_up > 0 ? 1 + 2 * (g.L - 1) : (g.concat_w2 ? 1 : 0) + 2 * g.L;
  return fused_head_stages(g) + tail + (g.out_proj ? 1 : 0);
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

// The phase cuts of the kernel: kFull is the production kernel; the others
// are the card's counterparts of scripts/kernel_variants.py's sel_kernel
// and sel_fetch_kernel, built in fused_cuts.cu to time B4's phases:
//   kSel       r, the substep tile and the binned argmin; out = the packed
//              bin minima (no product, no weight stream);
//   kSelFetch  kSel, then per tile each winner's full row of the (K, Wt)
//              table into shared memory (the production fetch's loads
//              without its condition terms); out = sum(row^2), unpacked.
enum class FusedCut : int { kFull, kSel, kSelFetch };

// bf16 route: every MLP product on the tensor cores.  A block walks the
// work items blockIdx.x, blockIdx.x + gridDim.x, ...: R beam rows each,
// their R·A (row, slot) pairs in tiles of TM = 32·MT; pair p = i * A + a.
template <int MT, FusedCut CUT>
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
  constexpr bool kMlp = CUT == FusedCut::kFull;  // the products and their weight stream
  WeightRing ring;
  if constexpr (kMlp)
    ring.init(reinterpret_cast<bf16*>(sm + lay.ring), stages, fused_head_stages(g),
              fused_stages(g), (n_pairs + TM - 1) / TM);
  const bf16* table = static_cast<const bf16*>(g.table);

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int row0 = item * R, n_rows = min(R, g.NF - row0), n_valid = n_rows * A;
    __syncthreads();  // the last item's readers of r, ccb, up_cond, vals and the region are done

    // ---- r = x - xh and rnd(xh); the condition half of the concat layer,
    // ccb = rnd(xh)·W2 (+ b unless low rank), and with fold_up its product
    // with the first up-projection, up_cond = rnd(ccb)·U_0
    load_residuals(g.x, g.xh, row0, n_rows, R, D, g.F_in, r_s, xh_b, ldd);
    if constexpr (kMlp) {
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
    }
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
      if constexpr (CUT == FusedCut::kSel)
        if (i < n_rows) g.out[(size_t)(row0 + i) * A + a] = m;
    }
    if constexpr (CUT == FusedCut::kSel) continue;

    // ---- the (row, slot) pairs, TM at a time
    for (int p0 = 0; p0 < n_pairs; p0 += TM) {
      const int rows = max(0, min(TM, n_valid - p0));
      __syncthreads();  // vals are in; the region's last readers are done
      if constexpr (CUT == FusedCut::kSelFetch) {
        // each winner's row into ext (TM, ld Wt) over the tile buffers, 8
        // bf16 a thread, 4 loads in flight; then sum(row^2), slot s of row
        // t summing columns 2s, 2s + 1 + 32j
        bf16* ext_b = cand_b;
        const int CH = Wt / 8, ldx = ld_of(Wt);
        for (int e0 = tid; e0 < rows * CH; e0 += 4 * kTcThreads) {
          uint4 v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int e = e0 + u * kTcThreads, t = e / CH, j = e - t * CH;
            v[u] = make_uint4(0, 0, 0, 0);
            if (e < rows * CH)
              v[u] = *reinterpret_cast<const uint4*>(
                  table + (size_t)unpack_id(val_s[p0 + t]) * Wt + 8 * j);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int e = e0 + u * kTcThreads, t = e / CH, j = e - t * CH;
            if (e < rows * CH) *reinterpret_cast<uint4*>(ext_b + t * ldx + 8 * j) = v[u];
          }
        }
        __syncthreads();
        for (int e = tid; e < rows * kScoreSlots; e += kTcThreads) {
          const int t = e / kScoreSlots, s = e - t * kScoreSlots;
          float q = 0.f;
          for (int c = 2 * s; c < Wt; c += 2 * kScoreSlots) {
            const float2 v = ld_bf2(ext_b + t * ldx + c);
            q = fmaf(v.y, v.y, fmaf(v.x, v.x, q));
          }
          part_s[e] = q;
        }
        __syncthreads();
        for (int t = tid; t < rows; t += kTcThreads)
          g.out[(size_t)row0 * A + p0 + t] = sum_score(part_s, t);
        continue;
      }
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
  if constexpr (kMlp) ring.drain();
}

}  // namespace qt
