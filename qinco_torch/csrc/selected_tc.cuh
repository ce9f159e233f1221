// The tensor-core (bf16) route of the selected-scores kernel, a template
// on its phase cut (SelCut).  selected_scores.cu instantiates the full
// kernel, the production route; ktopa_variants.cu the cuts of
// scripts/ktopa_breakdown.py's modes, which time its phases, and
// scripts/kernel_variants.py's selcat.  See
// selected_scores.cu for what the kernel computes and why it is built so.
// Its MLP products run on wgmma with the weight ring of wgmma.cuh.
#pragma once

#include <type_traits>

#include "step_tc.cuh"
#include "wgmma.cuh"

namespace qt {

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
  int R;                  // beam rows per work item
  int kc;                 // columns of D a pass holds: D, or fewer on the D-passed plan
};

// The exact top-A of a work item's rows, each warp taking its rows
// (warp, warp + 8, warp + 16, warp + 24 of R <= 32) side by side.
__device__ __forceinline__ void top_a_rows(const float* S_s, int R, int K, int A, float* val_s) {
  constexpr int G = kRows / tc::kTcWarps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float v[G][8];  // K <= 256 = 32 lanes x 8
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int i = warp + tc::kTcWarps * g;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = lane + 32 * j;
      v[g][j] = i < R && k < K ? S_s[k * (R + 1) + i] : CUDART_INF_F;
    }
  }
  for (int a = 0; a < A; ++a) {
    float m[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m[g] = v[g][0];
#pragma unroll
      for (int j = 1; j < 8; ++j) m[g] = fminf(m[g], v[g][j]);
    }
#pragma unroll
    for (int off = 16; off; off >>= 1)
#pragma unroll
      for (int g = 0; g < G; ++g) m[g] = fminf(m[g], __shfl_xor_sync(kFull, m[g], off));
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (v[g][j] == m[g]) v[g][j] = CUDART_INF_F;
      const int i = warp + tc::kTcWarps * g;
      if (lane == 0 && i < R) val_s[i * A + a] = m[g];
    }
  }
}

// The exact top-A as a two-level extraction (scripts/ktopa_breakdown.py's
// tournament): first the minima of the A bins of G = K / A contiguous
// codewords (a row and a bin a thread), then A rounds in which a row's warp
// takes the least bin minimum and re-scans only the winner's bin, its G
// values spread over the lanes.  A row's packed values are distinct (the id
// rides the low bits), so the result is top_a_rows' bit for bit.  The
// winners are overwritten with +inf in the substep tile.  A, G <= 32.
__device__ __forceinline__ void top_a_tournament(float* S_s, int R, int K, int A, float* val_s) {
  constexpr int NR = kRows / tc::kTcWarps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, G = K / A;
  for (int e = threadIdx.x; e < R * A; e += tc::kTcThreads) {
    const int i = e % R, b = e / R;
    const float* col = S_s + (size_t)b * G * (R + 1) + i;
    float m = col[0];
    for (int j = 1; j < G; ++j) m = fminf(m, col[j * (R + 1)]);
    val_s[i * A + b] = m;
  }
  f32::sync();  // the consumer warps
  float bm[NR];  // lane b < A: bin b's minimum of the warp's row g
#pragma unroll
  for (int g = 0; g < NR; ++g) {
    const int i = warp + tc::kTcWarps * g;
    bm[g] = i < R && lane < A ? val_s[i * A + lane] : CUDART_INF_F;
  }
  __syncwarp();
  for (int a = 0; a < A; ++a) {
    float m[NR], v[NR];
    int w[NR];  // the winner's bin
#pragma unroll
    for (int g = 0; g < NR; ++g) m[g] = bm[g];
#pragma unroll
    for (int off = 16; off; off >>= 1)
#pragma unroll
      for (int g = 0; g < NR; ++g) m[g] = fminf(m[g], __shfl_xor_sync(kFull, m[g], off));
#pragma unroll
    for (int g = 0; g < NR; ++g) {
      const int i = warp + tc::kTcWarps * g;
      w[g] = __ffs(__ballot_sync(kFull, bm[g] == m[g])) - 1;
      const bool mine = i < R && lane < G;
      float* e = S_s + (size_t)(w[g] * G + (mine ? lane : 0)) * (R + 1) + (i < R ? i : 0);
      v[g] = mine ? *e : CUDART_INF_F;
      if (mine && v[g] == m[g]) *e = v[g] = CUDART_INF_F;  // remove the winner
      if (lane == 0 && i < R) val_s[i * A + a] = m[g];
    }
#pragma unroll
    for (int off = 16; off; off >>= 1)
#pragma unroll
      for (int g = 0; g < NR; ++g) v[g] = fminf(v[g], __shfl_xor_sync(kFull, v[g], off));
#pragma unroll
    for (int g = 0; g < NR; ++g)
      if (lane == w[g]) bm[g] = v[g];  // the winner's bin's new minimum
  }
}

// Products in a kernel's weight stream.
__host__ __device__ inline int selected_stages(const SelectedArgs& g) {
  return 1 + (g.wfold ? 1 : 0) + 2 * g.L + (g.out_proj ? 1 : 0);
}

// The products of the weight stream, in order (s -> wg::Stage): the
// condition product W2, [wfold], (U_l, D_l) x L, [out_proj]; every weight
// in the slab layout (wg::blocked).
struct SelectedStages {
  const tc::bf16 *w2, *wfold, *up, *down, *proj;
  int D, De, Dh, L;
  __device__ wg::Stage operator()(int s) const {
    if (s == 0) return {w2, D, De};
    --s;
    if (wfold) {
      if (s == 0) return {wfold, D, De};
      --s;
    }
    if (s < 2 * L) {
      const int l = s >> 1;
      if (s & 1) return {down + (size_t)l * wg::blocked(Dh, De), Dh, De};
      return {up + (size_t)l * wg::blocked(De, Dh), De, Dh};
    }
    return {proj, De, D};
  }
};

// Shared-memory layout of the tensor-core kernel (byte offsets), the same
// arithmetic as _selected_mma_smem in qinco_torch/ops/kernels.py:
//   the ring's barriers | r (R, D) f32 | ccb (R, De) f32 | vals (R, A) f32 |
//   the two warpgroups' distance partials (2, 64) f32 | one region, overlaid by phase: rnd(xh) (64, D) bf16, the condition
//   product's A;  then rnd(r) (R, D) f32 and the substep tile (K, R + 1)
//   f32;  then per tile cand (TM, D), h (TM, De) and, at TM = 64, the FFN
//   hidden (TM, Dh) bf16 (at 128 the warpgroups hold it in registers) |
//   the ring's slots (128-byte aligned), as many as the
//   launch's shared memory holds, at most wg::kMaxRing.  The bf16 buffers
//   are in the core-matrix layout (wg::act_off).  On the D-passed plan
//   (`passed`) the region holds a chunk of kc columns of rnd(xh) (64, kc),
//   and per tile no cand: h (TM, De), then in one place the FFN hidden, a
//   chunk of cand (TM, kc) and one output pass's columns of cand (TM,
//   wg::kPass), as wide as the widest.
struct SelectedLayout {
  unsigned r, ccb, val, part, u, cand, h, big, ring;
  __host__ __device__ SelectedLayout(const SelectedArgs& g, int TM, bool topa, bool passed = false) {
    using tc::align16;
    const size_t R = g.R;
    r = wg::kBarBytes;
    ccb = r + align16(4 * R * g.D);
    val = ccb + align16(4 * R * g.De);
    part = val + align16(4 * R * g.A);
    u = part + 2 * 64 * 4;
    const size_t phase0 = 2 * 64 * (size_t)(passed ? g.kc : g.D);
    const size_t substep = topa ? align16(4 * R * g.D) + 4 * (size_t)g.K * (R + 1) : 0;
    cand = u;
    h = passed ? u : cand + 2 * (size_t)TM * g.D;
    big = h + 2 * (size_t)TM * g.De;
    // the FFN hidden (in registers at TM = 128); passed, also a chunk of cand or a pass's columns
    size_t wide = TM == 64 ? g.Dh : 0;
    if (passed) {
      wide = wide > (size_t)g.kc ? wide : g.kc;
      wide = wide > (size_t)wg::kPass ? wide : wg::kPass;
    }
    const size_t tiles = big + 2 * (size_t)TM * wide - u;
    size_t region = phase0 > substep ? phase0 : substep;
    region = region > tiles ? region : tiles;
    ring = (u + align16(region) + 127) / 128 * 128;
  }
  // The ring's slots in `bytes` of shared memory, `extra` of them kept at
  // the end.
  __host__ __device__ int slots(size_t bytes, size_t extra) const {
    const size_t n = bytes >= ring + extra ? (bytes - extra - ring) / wg::kSlabBytes : 0;
    return n < (size_t)wg::kMaxRing ? (int)n : wg::kMaxRing;
  }
};

// The FFN hidden's passes (HP of selected_scores_tc_kernel) that the
// 128-pair tile holds in registers: Dh of 2 or 3 whole passes of wg::kPass
// (the qinco2-S, -M and -L widths: 64 or 96 registers a thread); 0 where it
// cannot, and the plan takes 64-pair tiles (kernels._wg_tiles).
__host__ __device__ constexpr int hidden_passes(int Dh) {
  return Dh == 2 * wg::kPass || Dh == 3 * wg::kPass ? Dh / wg::kPass : 0;
}

// The phase cuts of the kernel's in-kernel top-A route: kFull is the
// production kernel; the others are the card's counterparts of the modes of
// scripts/ktopa_breakdown.py's ktopa_kernel, built in ktopa_variants.cu to
// time B2's phases (ops/breakdown.py says what each computes):
//   kNoExtract  slot a takes codeword a's packed value, no min-and-remove;
//   kMlpOnly    kNoExtract, and every slot's candidate is its row's slot-0
//               codeword, loaded once a row and stored to its A slots;
//   kNoDist     kMlpOnly with the epilogue |sum(out + cand)| + 1;
//   kShell      kNoDist without the per-pair products: ||r - cand||^2 (the
//               condition product, once a row, stays);
//   kPerSlot    the full function, pairs slot-major, one slot's rows a tile;
//   kTournament the full function, the top-A by top_a_tournament;
//   kSelCat     scripts/kernel_variants.py's selcat_kernel: the external-vals
//               route with the folded table (no wfold), the distance formed
//               as ((x - (out + cand)) - xh)^2 from x and xh in f32, which
//               it keeps (R, D) f32 at the end of the shared memory.
enum class SelCut : int {
  kFull, kNoExtract, kMlpOnly, kNoDist, kShell, kPerSlot, kTournament, kSelCat
};

// bf16 route: every MLP product on wgmma (wgmma.cuh).  A block has two
// consumer warpgroups (the 8 warps of every phase) and a producer
// warpgroup whose warps' first threads stream the weights.  A tile is TM
// = 64·NW (row, slot) pairs: under NW = 2 each consumer warpgroup runs the
// products for its own 64 rows on whole passes; under NW = 1 both run them
// for the 64 rows, each on one 64-column half of every pass, and their
// distance partials are added in a fixed order.  Under NW = 2 (Dh = HP
// passes of wg::kPass, hidden_passes) a warpgroup holds its 64 rows of the
// FFN hidden in registers, 32·HP a thread (the up product's epilogue packs
// its sums into them, wg::pack_frag), and the down product takes them as
// its A (wg::product_regs); the layout has no hidden, which leaves room
// for the 128-pair tile at the qinco2-M and -L widths.  Under NW = 1 the
// hidden is (64, Dh) in shared memory.  The blocks of a cluster
// (1, 2 or 4 of them, the launch's) share every weight slab; cluster c
// walks the work items c·C + rank, c·C + rank + C·clusters, ..., every
// block of it as many rounds as its first (a block past the last item
// streams the weights with no rows).  An item is R beam rows, their R·A
// pairs in tiles of TM (pair p = i * A + a); under kPerSlot slot-major,
// one slot's R rows a tile.  A cut other than kFull and kSelCat takes the
// in-kernel top-A route only; kSelCat the external vals only.
//
// PASSED (the D-passed plan; kFull, NW = 1, with out_proj): no buffer holds
// D whole.  The products D -> De (the condition product, the lean fetch's)
// read their A a chunk of kc columns at a time (wg::product_chunked),
// filled from device memory again for every pass over their output
// columns, and before each pass of out_proj the pairs' codewords of its
// columns come again from the table (L2) for the distance.
template <int NW, SelCut CUT, bool PASSED = false, int HP = 0>
__global__ void __launch_bounds__(wg::kBlock, 1) selected_scores_tc_kernel(SelectedArgs g) {
  using namespace tc;
  using wg::act_off;
  using wg::frag_col;
  using wg::frag_row;
  constexpr int TM = 64 * NW;
  // a product's columns a warpgroup takes of each pass, and their n8 blocks
  constexpr int N = NW == 2 ? wg::kPass : wg::kPass / 2;
  constexpr int kNJ = N / 8;
  constexpr bool kSlotMajor = CUT == SelCut::kPerSlot;
  constexpr bool kOneFetch =  // one codeword a row, stored to its A slots
      CUT == SelCut::kMlpOnly || CUT == SelCut::kNoDist || CUT == SelCut::kShell;
  constexpr bool kMlp = CUT != SelCut::kShell;  // the per-pair products
  static_assert(!PASSED || (NW == 1 && CUT == SelCut::kFull), "the D-passed plan is kFull's");
  static_assert((NW == 2) == (HP > 0) && !(PASSED && HP), "128 pairs hold the hidden in registers");
  extern __shared__ __align__(128) unsigned char sm[];
  const int D = g.D, De = g.De, Dh = g.Dh, K = g.K, A = g.A, Wt = g.Wt, R = g.R;
  const int tid = threadIdx.x;
  const bool topa = g.vals == nullptr, proj = g.out_proj != nullptr;
  const SelectedLayout lay(g, TM, topa, PASSED);
  const size_t extra = CUT == SelCut::kSelCat ? align16(4 * (size_t)R * D) : 0;
  const uint32_t dyn = wg::dynamic_smem_bytes(), base = smem_addr(sm);
  float* r_s = reinterpret_cast<float*>(sm + lay.r);      // (R, D) residual target
  float* ccb_s = reinterpret_cast<float*>(sm + lay.ccb);  // (R, De) rnd(xh)·W2 + b
  float* val_s = reinterpret_cast<float*>(sm + lay.val);  // (R, A) packed top-A values
  unsigned char* xh_b = sm + lay.u;                       // (64, D) rnd(xh)
  float* rr_s = reinterpret_cast<float*>(sm + lay.u);     // (R, D) rnd(r)
  float* S_s = reinterpret_cast<float*>(sm + lay.u + align16(4 * (size_t)R * D));  // (K, R + 1)
  unsigned char* cand_b = sm + lay.cand;  // (TM, D) fetched codewords
  unsigned char* h_b = sm + lay.h;        // (TM, De)
  unsigned char* hid_b = sm + lay.big;    // (TM, Dh) FFN hidden, NW = 1
  float* xh32_s = reinterpret_cast<float*>(sm + dyn - extra);  // (R, D) xh, kSelCat only

  const int n_pairs = R * A, n_items = (g.NF + R - 1) / R;
  const int n_tiles = kSlotMajor ? A : (n_pairs + TM - 1) / TM;
  const SelectedStages stages{static_cast<const bf16*>(g.w2), static_cast<const bf16*>(g.wfold),
                              static_cast<const bf16*>(g.ffn_up),
                              static_cast<const bf16*>(g.ffn_down),
                              static_cast<const bf16*>(g.out_proj), D, De, Dh, g.L};
  wg::Ring<SelectedStages> ring;
  ring.init(stages, base, base + lay.ring, lay.slots(dyn, extra), 1,
            kMlp ? selected_stages(g) : 1, kMlp ? n_tiles : 1, kWarps);
  const int C = ring.cluster, first = wg::cluster_id() * C, stride = wg::cluster_count() * C;
  const int rounds = first < n_items ? (n_items - first + stride - 1) / stride : 0;
  if (tid >= kThreads) {  // the producer warpgroup: lane 0 of each warp streams weights
    f32::producer_regs();
    if ((tid & 31) == 0) ring.produce_all(rounds, (tid - kThreads) >> 5);
    return;
  }
  f32::consumer_regs();
  const int wgi = tid >> 7, lane = tid & 31;  // the thread's consumer warpgroup
  // NW = 2: warpgroup wgi runs the products for tile rows 64·wgi .. on whole
  // passes; NW = 1: both run them for the tile's 64 rows, on column half
  // `col` of each pass, and meet at the consumer barrier between products
  const int T0 = NW == 2 ? 64 * wgi : 0, col = NW == 2 ? 0 : 64 * wgi;
  const auto product_sync = [&] {
    wg::fence_proxy_async();
    if (NW == 2)
      wg::wg_sync(wgi);
    else
      f32::sync();
  };
  const bf16* table = static_cast<const bf16*>(g.table);

  for (int round = 0; round < rounds; ++round) {
    const int item = first + ring.rank + round * stride, row0 = item * R;
    const int n_rows = item < n_items ? min(R, g.NF - row0) : 0, n_valid = n_rows * A;
    f32::sync();  // the last item's readers of r, vals and the region are done

    // ---- r = x - xh and rnd(xh), 4 columns a thread; rows past n_rows zero
    for (int e = tid; e < R * D / 4; e += kThreads) {
      const int i = e / (D / 4), c = 4 * (e - i * (D / 4));
      float4 xv = make_float4(0.f, 0.f, 0.f, 0.f), hv = xv;
      if (i < n_rows) {
        hv = *reinterpret_cast<const float4*>(g.xh + (size_t)(row0 + i) * D + c);
        xv = *reinterpret_cast<const float4*>(g.x + (size_t)((row0 + i) / g.F_in) * D + c);
      }
      if constexpr (!PASSED) {
        st_bf2(reinterpret_cast<bf16*>(xh_b + act_off(i, c, D)), hv.x, hv.y);
        st_bf2(reinterpret_cast<bf16*>(xh_b + act_off(i, c + 2, D)), hv.z, hv.w);
      }
      *reinterpret_cast<float4*>(r_s + i * D + c) =
          make_float4(xv.x - hv.x, xv.y - hv.y, xv.z - hv.z, xv.w - hv.w);
    }
    if constexpr (CUT == SelCut::kSelCat) {  // x in place of r, and xh, in f32
      f32::sync();
      for (int e = tid; e < R * D; e += kThreads) {
        const int i = e / D, c = e - i * D;
        const bool on = i < n_rows;
        r_s[e] = on ? g.x[(size_t)((row0 + i) / g.F_in) * D + c] : 0.f;
        xh32_s[e] = on ? g.xh[(size_t)(row0 + i) * D + c] : 0.f;
      }
    }
    wg::fence_proxy_async();
    f32::sync();
    // ---- the condition half of the concat layer: ccb = rnd(xh)·W2 + b, on
    // warpgroup 0 (its 64 rows hold the R <= 32 rows); every epilogue
    // below loads what it reads before it stores anything
    const auto ccb_out = [&](float(&d)[N / 2], int c0) {
      float2 b[kNJ];
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const int c = c0 + frag_col(j);
        b[j] = c < De ? *reinterpret_cast<const float2*>(g.concat_b + c) : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const int c = c0 + frag_col(j);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (c < De && frag_row(h) < R)
            *reinterpret_cast<float2*>(ccb_s + frag_row(h) * De + c) =
                make_float2(d[4 * j + 2 * h] + b[j].x, d[4 * j + 2 * h + 1] + b[j].y);
      }
    };
    if constexpr (PASSED) {  // rnd(xh) a chunk of kc columns at a time, rows past n_rows zero
      wg::product_chunked<N>(ring, base + lay.u, g.kc, D, De, col, true, ccb_out, [&](int, int c0) {
        const int n4 = g.kc / 4, w = min(g.kc, D - c0);
        for (int e = tid; e < R * n4; e += kThreads) {
          const int i = e / n4, c = 4 * (e - i * n4);
          float4 hv = make_float4(0.f, 0.f, 0.f, 0.f);
          if (i < n_rows && c < w)
            hv = *reinterpret_cast<const float4*>(g.xh + (size_t)(row0 + i) * D + c0 + c);
          st_bf2(reinterpret_cast<bf16*>(xh_b + act_off(i, c, g.kc)), hv.x, hv.y);
          st_bf2(reinterpret_cast<bf16*>(xh_b + act_off(i, c + 2, g.kc)), hv.z, hv.w);
        }
      });
    } else {
      wg::product<N>(ring, base + lay.u, D, D, De, col, NW == 1 || wgi == 0, ccb_out);
    }
    f32::sync();

    if (!topa) {
      // ---- external top-A: the packed values carry the ids
      for (int e = tid; e < R * A; e += kThreads)
        val_s[e] = e / A < n_rows ? g.vals[(size_t)row0 * A + e] : 0.f;
    } else {
      // ---- packed substep partial distances (K, R) and the exact top-A,
      // as in the f32 kernel (f32 on the CUDA cores, same order of sums)
      for (int e = tid; e < R * D; e += kThreads) rr_s[e] = rnd<true>(r_s[e]);
      f32::sync();
      substep_rows(rr_s, R, D, g.sub_t, g.cn2, K, S_s);
      f32::sync();
      if constexpr (CUT == SelCut::kFull || CUT == SelCut::kPerSlot) {
        top_a_rows(S_s, R, K, A, val_s);
      } else if constexpr (CUT == SelCut::kTournament) {
        top_a_tournament(S_s, R, K, A, val_s);
      } else {  // no extraction: slot a takes codeword a's packed value
        for (int e = tid; e < R * A; e += kThreads)
          val_s[e] = S_s[(e % A) * (R + 1) + e / A];
      }
    }

    // ---- the (row, slot) pairs, TM at a time (one slot's rows under
    // kPerSlot: p0 is then the slot); pair t of a tile is p = pair(t) of
    // the item's (R, A) values, of beam row row(t)
    const auto pair = [&](int t, int p0) { return kSlotMajor ? t * A + p0 : p0 + t; };
    const auto row = [&](int t, int p0) { return kSlotMajor ? t : (p0 + t) / A; };
    for (int tile = 0, p0 = 0; tile < n_tiles; ++tile, p0 += kSlotMajor ? 1 : TM) {
      const int rows = kSlotMajor ? n_rows : max(0, min(TM, n_valid - p0));
      f32::sync();  // vals are in; the region's last readers are done
      if constexpr (kOneFetch) {
        // one 16-byte load per beam row the tile touches and 8 columns, its
        // slot 0's codeword, stored to each of its slots in the tile
        const int i0 = p0 / A, nb = (p0 + TM - 1) / A - i0 + 1;
        for (int e = tid; e < nb * (D / 8); e += kThreads) {
          const int b = e / (D / 8), j = e - b * (D / 8), i = i0 + b;
          uint4 v = make_uint4(0, 0, 0, 0);
          if (i < n_rows)
            v = *reinterpret_cast<const uint4*>(table + (size_t)unpack_id(val_s[i * A]) * Wt +
                                                8 * j);
          for (int t = max(0, i * A - p0); t < min(TM, (i + 1) * A - p0); ++t)
            *reinterpret_cast<uint4*>(cand_b + act_off(t, 8 * j, D)) =
                t < rows ? v : make_uint4(0, 0, 0, 0);
        }
      } else if constexpr (!PASSED) {
        // fetch the codewords, 8 bf16 a thread, 4 loads in flight; a
        // warp's threads take 32 rows of one 8-column chunk, so each 8 of
        // them store to the 8 rows of one core matrix (no bank twice)
        for (int e0 = tid; e0 < TM * (D / 8); e0 += 4 * kThreads) {
          uint4 v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int e = e0 + u * kThreads, t = e % TM, j = e / TM;
            v[u] = make_uint4(0, 0, 0, 0);
            if (t < rows && j < D / 8)
              v[u] = *reinterpret_cast<const uint4*>(
                  table + (size_t)unpack_id(val_s[pair(t, p0)]) * Wt + 8 * j);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int e = e0 + u * kThreads, t = e % TM, j = e / TM;
            if (j < D / 8) *reinterpret_cast<uint4*>(cand_b + act_off(t, 8 * j, D)) = v[u];
          }
        }
      }
      if (kMlp && !g.wfold) {  // the folded table's h slice: h = rnd(table[id][D:] + ccb)
        // a warp's threads take 8 rows x 8 columns, one core matrix
        for (int e = tid; e < (rows + 7) / 8 * 8 * (De / 2); e += kThreads) {
          const int rest = e >> 5, kc = rest % (De / 8);
          const int t = (rest / (De / 8)) * 8 + ((e >> 2) & 7), c = 8 * kc + 2 * (e & 3);
          if (t >= rows) continue;
          const int p = pair(t, p0);
          const float2 hc = ld_bf2(table + (size_t)unpack_id(val_s[p]) * Wt + D + c);
          const float* cb = ccb_s + row(t, p0) * De + c;
          st_bf2(reinterpret_cast<bf16*>(h_b + act_off(t, c, De)), hc.x + cb[0], hc.y + cb[1]);
        }
      }
      wg::fence_proxy_async();
      f32::sync();  // cand and h are in

      // PASSED: the pairs' codewords, columns c0 .. c0 + n - 1 (past D: zeros),
      // into the hidden's place (TM, n); 8 bf16 a thread, 4 loads in flight
      const auto gather_cand = [&](int c0, int n) {
        const int n8 = n / 8, w8 = min(n, D - c0) / 8;
        for (int e0 = tid; e0 < TM * n8; e0 += 4 * kThreads) {
          uint4 v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int e = e0 + u * kThreads, t = e % TM, j = e / TM;
            v[u] = make_uint4(0, 0, 0, 0);
            if (t < rows && j < w8)
              v[u] = *reinterpret_cast<const uint4*>(
                  table + (size_t)unpack_id(val_s[pair(t, p0)]) * Wt + c0 + 8 * j);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int e = e0 + u * kThreads, t = e % TM, j = e / TM;
            if (j < n8) *reinterpret_cast<uint4*>(hid_b + act_off(t, 8 * j, n)) = v[u];
          }
        }
      };
      const auto cand2 = [&](int t, int c) {  // pair t's codeword, columns c, c + 1
        if constexpr (PASSED)  // the columns of out_proj's pass, staged in the hidden's place
          return ld_bf2(reinterpret_cast<const bf16*>(hid_b + act_off(t, c % wg::kPass, wg::kPass)));
        else
          return ld_bf2(reinterpret_cast<const bf16*>(cand_b + act_off(t, c, D)));
      };
      const auto write = [&](int t, float d) {  // row t's distance, packed with its id
        const int p = pair(t, p0);
        g.out[(size_t)row0 * A + p] =
            pack_id(CUT == SelCut::kNoDist ? fabsf(d) + 1.f : d, unpack_id(val_s[p]));
      };
      if constexpr (!kMlp) {
        // ||r - cand||^2, a thread a pair, columns in order
        for (int t = tid; t < rows; t += kThreads) {
          const float* r = r_s + row(t, p0) * D;
          float q = 0.f;
          for (int c = 0; c < D; c += 2) {
            const float2 cv = cand2(t, c);
            const float d0 = r[c] - cv.x, d1 = r[c + 1] - cv.y;
            q = fmaf(d1, d1, fmaf(d0, d0, q));
          }
          write(t, q);
        }
        continue;
      }
      // ---- the warpgroup's 64 pairs from T0 through the MLP
      const bool on = rows > T0;
      const uint32_t a_cand = base + lay.cand + 2 * T0 * D, a_h = base + lay.h + 2 * T0 * De,
                     a_hid = base + lay.big + 2 * T0 * Dh;
      bf16* h16 = reinterpret_cast<bf16*>(h_b);
      bf16* hid16 = reinterpret_cast<bf16*>(hid_b);
      // d = ||r - out - cand||^2, summed over the thread's columns for its
      // two rows (h = 0, 1) in the last product's epilogue, in column
      // order; out(j, h) is that product's output in n8 block j of nj (an
      // std::integral_constant) from column c0.  kNoDist sums out + cand
      // instead, no residual and no square.
      float dsum[2] = {0.f, 0.f};
      using AllJ = std::integral_constant<int, kNJ>;
      const auto score = [&](int c0, auto out, auto nj) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int T = T0 + frag_row(h);
          const float* r = r_s + row(min(T, rows - 1), p0) * D;
          const float* hr = xh32_s + row(min(T, rows - 1), p0) * D;
          float q = dsum[h];
#pragma unroll
          for (int j = 0; j < decltype(nj)::value; ++j) {
            const int c = c0 + frag_col(j);
            if (c < D) {
              float2 o = out(j, h);
              const float2 cv = g.res ? cand2(min(T, TM - 1), c) : make_float2(0.f, 0.f);
              if constexpr (CUT == SelCut::kSelCat) {  // (x - (out + cand)) - xh, in that order
                o.x += cv.x;
                o.y += cv.y;
                const float d0 = (r[c] - o.x) - hr[c], d1 = (r[c + 1] - o.y) - hr[c + 1];
                q = fmaf(d1, d1, fmaf(d0, d0, q));
              } else if constexpr (CUT == SelCut::kNoDist) {
                q += (o.x + cv.x) + (o.y + cv.y);
              } else {
                const float d0 = r[c] - o.x - cv.x, d1 = r[c + 1] - o.y - cv.y;
                q = fmaf(d1, d1, fmaf(d0, d0, q));
              }
            }
          }
          dsum[h] = q;
        }
      };
      if (g.wfold) {  // the lean fetch: h = rnd(cand·wfold + ccb)
        int crow[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) crow[h] = min(row(T0 + frag_row(h), p0), R - 1);
        const auto h_out = [&](float(&d)[N / 2], int c0) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float2 cb[kNJ / 2][2];
#pragma unroll
            for (int jj = 0; jj < kNJ / 2; ++jj)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int c = c0 + frag_col(half * kNJ / 2 + jj);
                cb[jj][h] = c < De ? *reinterpret_cast<const float2*>(ccb_s + crow[h] * De + c)
                                   : make_float2(0.f, 0.f);
              }
#pragma unroll
            for (int jj = 0; jj < kNJ / 2; ++jj) {
              const int j = half * kNJ / 2 + jj, c = c0 + frag_col(j);
#pragma unroll
              for (int h = 0; h < 2; ++h)
                if (c < De)
                  st_bf2(h16 + act_off(T0 + frag_row(h), c, De) / 2, d[4 * j + 2 * h] + cb[jj][h].x,
                         d[4 * j + 2 * h + 1] + cb[jj][h].y);
            }
          }
        };
        if constexpr (PASSED) {  // cand a chunk of kc columns at a time, in the hidden's place
          wg::product_chunked<N>(ring, base + lay.big, g.kc, D, De, col, on, h_out,
                                 [&](int, int c0) { gather_cand(c0, g.kc); });
        } else {
          wg::product<N>(ring, a_cand, D, D, De, col, on, h_out);
        }
        product_sync();
      }
      // FFN blocks: up = rnd(relu(h·U_l)); h = rnd(h + rnd(up·D_l)); the last
      // block's h carries the score when no out_proj follows.  up in the
      // warpgroup's registers (NW = 2) or in shared memory.
      uint32_t hid[HP > 0 ? 32 * HP : 1];
      for (int l = 0; l < g.L; ++l) {
        if constexpr (HP > 0) {
          wg::product_passes<HP>(ring, a_h, De, De, [&](float(&d)[wg::kPass / 2], int p) {
            wg::pack_frag(d, hid, 32 * p, [](float v) { return fmaxf(v, 0.f); });
          });
        } else {
          wg::product<N>(ring, a_h, De, De, Dh, col, on, [&](float(&d)[N / 2], int c0) {
#pragma unroll
            for (int j = 0; j < kNJ; ++j) {
              const int c = c0 + frag_col(j);
#pragma unroll
              for (int h = 0; h < 2; ++h)
                if (c < Dh)
                  st_bf2(hid16 + act_off(T0 + frag_row(h), c, Dh) / 2,
                         fmaxf(d[4 * j + 2 * h], 0.f), fmaxf(d[4 * j + 2 * h + 1], 0.f));
            }
          });
          product_sync();
        }
        const bool last = l == g.L - 1 && !proj;
        // J n8 blocks at a time, each round loading before it stores: half
        // the blocks a round beside a hidden of 96 registers (HP = 3), so
        // that ptxas spills nothing
        const auto down_out = [&](float(&d)[N / 2], int c0) {
          constexpr int J = HP > 2 ? kNJ / 2 : kNJ;
#pragma unroll
          for (int j0 = 0; j0 < kNJ; j0 += J) {
            uint32_t v[J][2];
#pragma unroll
            for (int j = 0; j < J; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int c = c0 + frag_col(j0 + j);
                v[j][h] = c < De ? *reinterpret_cast<const uint32_t*>(
                                       h16 + act_off(T0 + frag_row(h), c, De) / 2)
                                 : 0u;
              }
#pragma unroll
            for (int j = 0; j < J; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float2 o = unpack_bf2(v[j][h]);
                v[j][h] = pack_bf2(rnd<true>(d[4 * (j0 + j) + 2 * h]) + o.x,
                                   rnd<true>(d[4 * (j0 + j) + 2 * h + 1]) + o.y);
              }
#pragma unroll
            for (int j = 0; j < J; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int c = c0 + frag_col(j0 + j);
                if (c < De)
                  *reinterpret_cast<uint32_t*>(h16 + act_off(T0 + frag_row(h), c, De) / 2) =
                      v[j][h];
              }
            if (HP == 0 && last)
              score(c0 + 8 * j0, [&](int j, int h) { return unpack_bf2(v[j][h]); },
                    std::integral_constant<int, J>{});
          }
        };
        if constexpr (HP > 0)
          wg::product_regs<2 * HP>(ring, hid, De, on, down_out);
        else
          wg::product<N>(ring, a_hid, Dh, Dh, De, col, on, down_out);
        product_sync();
      }
      // HP > 0 and no out_proj: the last block's h, read back pass by pass,
      // carries the score (in the down product's epilogue it made ptxas
      // spill beside the hidden's registers)
      if (HP > 0 && on && !proj && g.L > 0)
        for (int c0 = 0; c0 < De; c0 += wg::kPass)
          score(c0, [&](int j, int h) {
            return ld_bf2(h16 + act_off(T0 + frag_row(h), c0 + frag_col(j), De) / 2);
          }, AllJ{});
      const auto proj_out = [&](float(&d)[N / 2], int c0) {
        score(c0, [&](int j, int h) { return make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]); },
              AllJ{});
      };
      if constexpr (PASSED) {  // before each pass, its columns of the pairs' codewords
        wg::product_chunked<N>(ring, a_h, De, De, D, col, on, proj_out,
                               [&](int c, int) { gather_cand(c, wg::kPass); });
      } else if (proj) {
        wg::product<N>(ring, a_h, De, De, D, col, on, proj_out);
      }
      if (!proj && g.L == 0) {  // out = h, no product left to carry the sums: a thread a pair
        for (int t = T0 + (tid & 127); t < min(rows, T0 + 64) && (NW == 2 || wgi == 0); t += 128) {
          const float* r = r_s + row(t, p0) * D;
          float q = 0.f;
          for (int c = 0; c < D; c += 2) {
            const float2 o = ld_bf2(h16 + act_off(t, c, De) / 2);
            float d0 = r[c] - o.x, d1 = r[c + 1] - o.y;
            if (g.res) {
              const float2 cv = cand2(t, c);
              d0 -= cv.x;
              d1 -= cv.y;
            }
            q = fmaf(d1, d1, fmaf(d0, d0, q));
          }
          write(t, q);
        }
        continue;
      }
      // ---- the rows' sums: the 4 lanes of a row (lane & 3), in a fixed
      // order; under NW = 1 the two warpgroups' column halves, added in order
      float* part_s = reinterpret_cast<float*>(sm + lay.part);  // (2, 64)
#pragma unroll
      for (int hs = 0; hs < 2; ++hs) {
        float s = dsum[hs];
        s += __shfl_xor_sync(kFull, s, 1);
        s += __shfl_xor_sync(kFull, s, 2);
        const int T = T0 + frag_row(hs);
        if (NW == 1 && (lane & 3) == 0) part_s[64 * wgi + T] = s;
        if (NW == 2 && (lane & 3) == 0 && T < rows) write(T, s);
      }
      if (NW == 1) {
        f32::sync();
        if (wgi == 0 && (lane & 3) == 0)
#pragma unroll
          for (int hs = 0; hs < 2; ++hs) {
            const int T = frag_row(hs);
            if (T < rows) write(T, part_s[T] + part_s[64 + T]);
          }
      }
    }
  }
}

// Launches a selected-scores kernel in clusters of `cluster` blocks with
// wg::kBlock threads each on `stream`, on at most as many clusters as the
// card holds at once (cudaOccupancyMaxActiveClusters, asked once per
// kernel, shared memory and cluster size).
template <typename Kernel>
cudaError_t launch_selected(Kernel kernel, int blocks, int smem, int cluster, cudaStream_t stream,
                            const SelectedArgs& args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(wg::kBlock, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  struct Fit {
    const void* kernel;
    int smem, cluster, clusters;
  };
  static Fit fits[32];
  static int n_fits = 0;
  int clusters = 0;
  for (int i = 0; i < n_fits; ++i)
    if (fits[i].kernel == (const void*)kernel && fits[i].smem == smem &&
        fits[i].cluster == cluster)
      clusters = fits[i].clusters;
  if (clusters == 0) {
    e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (e != cudaSuccess) return e;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    if (n_fits < 32) fits[n_fits++] = {(const void*)kernel, smem, cluster, clusters};
  }
  cfg.gridDim.x = blocks < clusters * cluster ? blocks : clusters * cluster;
  e = cudaLaunchKernelEx(&cfg, kernel, args);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace qt
