// The tensor-core (bf16) route of the selected-scores kernel, a template
// on its phase cut (SelCut).  selected_scores.cu instantiates the full
// kernel, the production route; ktopa_variants.cu the cuts of
// scripts/ktopa_breakdown.py's modes, which time its phases.  See
// selected_scores.cu for what the kernel computes and why it is built so.
#pragma once

#include "step_tc.cuh"

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
  __syncthreads();
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

// Shared-memory layout of the tensor-core kernel (byte offsets), the same
// arithmetic as selected_plan in qinco_torch/ops/kernels.py:
//   stage table | r (R, D) f32 | ccb (R, De) f32 | vals (R, A) f32 |
//   score partials (TM, 16) f32 | one region, overlaid by phase: rnd(xh)
//   (R16, D) bf16;  then rnd(r) (R, D) f32 and the substep tile (K, R + 1)
//   f32;  then per tile cand (TM, D), h (TM, De) and the FFN hidden
//   (TM, Dh) bf16 | the weight ring.
struct SelectedLayout {
  unsigned r, ccb, val, part, u, cand, h, big, ring, total;
  __host__ __device__ SelectedLayout(const SelectedArgs& g, int TM, bool topa) {
    using tc::align16;
    using tc::ld_of;
    const size_t R = g.R, R16 = (g.R + 15) / 16 * 16;
    r = tc::kStageBytes;
    ccb = r + align16(4 * R * g.D);
    val = ccb + align16(4 * R * g.De);
    part = val + align16(4 * R * g.A);
    u = part + 4 * (size_t)TM * kScoreSlots;
    const size_t phase0 = 2 * R16 * ld_of(g.D);
    const size_t substep = topa ? align16(4 * R * g.D) + 4 * (size_t)g.K * (R + 1) : 0;
    cand = u;
    h = cand + 2 * (size_t)TM * ld_of(g.D);
    big = h + 2 * (size_t)TM * ld_of(g.De);
    size_t region = phase0 > substep ? phase0 : substep;
    const size_t tiles = big + 2 * (size_t)TM * ld_of(g.Dh) - u;
    region = region > tiles ? region : tiles;
    ring = u + align16(region);
    total = ring + tc::kRingBytes;
  }
};

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
//   kTournament the full function, the top-A by top_a_tournament.
enum class SelCut : int { kFull, kNoExtract, kMlpOnly, kNoDist, kShell, kPerSlot, kTournament };

// bf16 route: every MLP product on the tensor cores.  A block walks the
// work items blockIdx.x, blockIdx.x + gridDim.x, ...: R beam rows each,
// their R·A pairs in tiles of TM = 32·MT (pair p = i * A + a); under
// kPerSlot slot-major, one slot's R rows a tile.  A cut other than kFull
// takes the in-kernel top-A route only.
template <int MT, SelCut CUT>
__global__ void __launch_bounds__(tc::kTcThreads, 1) selected_scores_tc_kernel(SelectedArgs g) {
  using namespace tc;
  constexpr int TM = 32 * MT;
  constexpr bool kSlotMajor = CUT == SelCut::kPerSlot;
  constexpr bool kOneFetch =  // one codeword a row, stored to its A slots
      CUT == SelCut::kMlpOnly || CUT == SelCut::kNoDist || CUT == SelCut::kShell;
  constexpr bool kMlp = CUT != SelCut::kShell;  // the per-pair products
  extern __shared__ __align__(16) unsigned char sm[];
  const int D = g.D, De = g.De, Dh = g.Dh, K = g.K, A = g.A, Wt = g.Wt, R = g.R;
  const int tid = threadIdx.x;
  const bool topa = g.vals == nullptr, proj = g.out_proj != nullptr;
  const SelectedLayout lay(g, TM, topa);
  float* r_s = reinterpret_cast<float*>(sm + lay.r);      // (R, D) residual target
  float* ccb_s = reinterpret_cast<float*>(sm + lay.ccb);  // (R, De) rnd(xh)·W2 + b
  float* val_s = reinterpret_cast<float*>(sm + lay.val);  // (R, A) packed top-A values
  float* part_s = reinterpret_cast<float*>(sm + lay.part);  // (TM, 16) distance partials
  bf16* xh_b = reinterpret_cast<bf16*>(sm + lay.u);       // (R16, D) rnd(xh)
  float* rr_s = reinterpret_cast<float*>(sm + lay.u);     // (R, D) rnd(r)
  float* S_s = reinterpret_cast<float*>(sm + lay.u + align16(4 * (size_t)R * D));  // (K, R + 1)
  bf16* cand_b = reinterpret_cast<bf16*>(sm + lay.cand);  // (TM, D) fetched codewords
  bf16* h_b = reinterpret_cast<bf16*>(sm + lay.h);        // (TM, De)
  bf16* hid_b = reinterpret_cast<bf16*>(sm + lay.big);    // (TM, Dh) FFN hidden
  const int ldd = ld_of(D), ldh = ld_of(De), ldf = ld_of(Dh);

  // The weight stream: the condition product once per item, then per tile
  // [wfold], (U_l, D_l) x L, [out_proj] (none under kShell).
  WStage* stages = reinterpret_cast<WStage*>(sm);
  if (tid == 0) {
    const bf16* up = static_cast<const bf16*>(g.ffn_up);
    const bf16* down = static_cast<const bf16*>(g.ffn_down);
    int n = 0;
    stages[n++] = {static_cast<const bf16*>(g.w2), D, De};
    if (g.wfold) stages[n++] = {static_cast<const bf16*>(g.wfold), D, De};
    for (int l = 0; l < g.L; ++l) {
      stages[n++] = {up + (size_t)l * De * Dh, De, Dh};
      stages[n++] = {down + (size_t)l * Dh * De, Dh, De};
    }
    if (proj) stages[n++] = {static_cast<const bf16*>(g.out_proj), De, D};
  }
  __syncthreads();
  const int n_pairs = R * A, n_items = (g.NF + R - 1) / R;
  const int n_tiles = kSlotMajor ? A : (n_pairs + TM - 1) / TM;
  WeightRing ring;
  ring.init(reinterpret_cast<bf16*>(sm + lay.ring), stages, 1, kMlp ? selected_stages(g) : 1,
            kMlp ? n_tiles : 1);
  const bf16* table = static_cast<const bf16*>(g.table);

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int row0 = item * R, n_rows = min(R, g.NF - row0), n_valid = n_rows * A;
    __syncthreads();  // the last item's readers of r, vals and the region are done

    // ---- r = x - xh and rnd(xh)
    load_residuals(g.x, g.xh, row0, n_rows, R, D, g.F_in, r_s, xh_b, ldd);
    // ---- the condition half of the concat layer: ccb = rnd(xh)·W2 + b
    mma_stage<MT>(ring, xh_b, ldd, D, De, R, [&](int t, int c, float v0, float v1) {
      ccb_s[t * De + c] = v0 + g.concat_b[c];
      ccb_s[t * De + c + 1] = v1 + g.concat_b[c + 1];
    });
    __syncthreads();

    if (!topa) {
      // ---- external top-A: the packed values carry the ids
      for (int e = tid; e < R * A; e += kTcThreads)
        val_s[e] = e / A < n_rows ? g.vals[(size_t)row0 * A + e] : 0.f;
    } else {
      // ---- packed substep partial distances (K, R) and the exact top-A,
      // as in the f32 kernel (f32 on the CUDA cores, same order of sums)
      for (int e = tid; e < R * D; e += kTcThreads) rr_s[e] = rnd<true>(r_s[e]);
      __syncthreads();
      substep_rows(rr_s, R, D, g.sub_t, g.cn2, K, S_s);
      __syncthreads();
      if constexpr (CUT == SelCut::kFull || CUT == SelCut::kPerSlot) {
        top_a_rows(S_s, R, K, A, val_s);
      } else if constexpr (CUT == SelCut::kTournament) {
        top_a_tournament(S_s, R, K, A, val_s);
      } else {  // no extraction: slot a takes codeword a's packed value
        for (int e = tid; e < R * A; e += kTcThreads)
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
      __syncthreads();  // vals are in; the region's last readers are done
      if constexpr (kOneFetch) {
        // one 16-byte load per beam row the tile touches and 8 columns, its
        // slot 0's codeword, stored to each of its slots in the tile
        const int i0 = p0 / A, nb = (p0 + TM - 1) / A - i0 + 1;
        for (int e = tid; e < nb * (D / 8); e += kTcThreads) {
          const int b = e / (D / 8), j = e - b * (D / 8), i = i0 + b;
          uint4 v = make_uint4(0, 0, 0, 0);
          if (i < n_rows)
            v = *reinterpret_cast<const uint4*>(table + (size_t)unpack_id(val_s[i * A]) * Wt +
                                                8 * j);
          for (int t = max(0, i * A - p0); t < min(TM, (i + 1) * A - p0); ++t)
            *reinterpret_cast<uint4*>(cand_b + t * ldd + 8 * j) =
                t < rows ? v : make_uint4(0, 0, 0, 0);
        }
      } else {
        // fetch the codewords, 8 bf16 a thread, 4 loads in flight
        for (int e0 = tid; e0 < TM * (D / 8); e0 += 4 * kTcThreads) {
          uint4 v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int e = e0 + u * kTcThreads, t = e / (D / 8), j = e - t * (D / 8);
            v[u] = make_uint4(0, 0, 0, 0);
            if (t < rows)
              v[u] = *reinterpret_cast<const uint4*>(
                  table + (size_t)unpack_id(val_s[pair(t, p0)]) * Wt + 8 * j);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int e = e0 + u * kTcThreads, t = e / (D / 8), j = e - t * (D / 8);
            if (t < TM) *reinterpret_cast<uint4*>(cand_b + t * ldd + 8 * j) = v[u];
          }
        }
      }
      for (int e = tid; e < TM * kScoreSlots; e += kTcThreads) part_s[e] = 0.f;
      if constexpr (kMlp) {
        if (g.wfold) {
          mma_stage_bf16<MT>(
              ring, cand_b, ldd, D, De, rows, h_b, ldh, nullptr, 0,
              [&](int t, int c, float v0, float v1) {
                const float* cb = ccb_s + min(row(t, p0), R - 1) * De + c;
                return make_float2(v0 + cb[0], v1 + cb[1]);
              },
              NoLast{});
        } else {
          for (int e = tid; e < rows * (De / 2); e += kTcThreads) {
            const int t = e / (De / 2), c = 2 * (e - t * (De / 2)), p = pair(t, p0);
            const float2 hc = ld_bf2(table + (size_t)unpack_id(val_s[p]) * Wt + D + c);
            const float* cb = ccb_s + row(t, p0) * De + c;
            st_bf2(h_b + t * ldh + c, hc.x + cb[0], hc.y + cb[1]);
          }
        }
      }
      // d = ||r - out - cand||^2: each (t, c, c + 1) of out adds its two
      // squares to its slot; out is the last product's output.  kNoDist
      // adds out + cand instead, no residual and no square.
      auto score = [&](int t, int c, float o0, float o1) {
        if constexpr (CUT == SelCut::kNoDist) {
          if (g.res) {
            const float2 cv = ld_bf2(cand_b + t * ldd + c);
            o0 += cv.x;
            o1 += cv.y;
          }
          part_s[t * kScoreSlots + 4 * ((threadIdx.x >> 5) & 3) + (threadIdx.x & 3)] += o0 + o1;
        } else {
          const float* r = r_s + row(t, p0) * D + c;
          float d0 = r[0] - o0, d1 = r[1] - o1;
          if (g.res) {
            const float2 cv = ld_bf2(cand_b + t * ldd + c);
            d0 -= cv.x;
            d1 -= cv.y;
          }
          add_score(part_s, t, d0, d1);
        }
      };
      if constexpr (!kMlp) {
        // ||r - cand||^2, slot s of row t summing columns 2s, 2s + 1 + 32j
        __syncthreads();  // cand and the zeroed partials are in
        for (int e = tid; e < rows * kScoreSlots; e += kTcThreads) {
          const int t = e / kScoreSlots, s = e - t * kScoreSlots;
          const float* r = r_s + row(t, p0) * D;
          float q = 0.f;
          for (int c = 2 * s; c < D; c += 2 * kScoreSlots) {
            const float2 cv = ld_bf2(cand_b + t * ldd + c);
            const float d0 = r[c] - cv.x, d1 = r[c + 1] - cv.y;
            q = fmaf(d1, d1, fmaf(d0, d0, q));
          }
          part_s[e] = q;
        }
      } else if (proj) {
        ffn_stages<MT>(ring, h_b, ldh, hid_b, ldf, g.L, De, Dh, rows, NoLast{});
        mma_stage<MT>(ring, h_b, ldh, De, D, rows, score);
      } else {
        ffn_stages<MT>(ring, h_b, ldh, hid_b, ldf, g.L, De, Dh, rows, score);
      }
      __syncthreads();
      if (kMlp && !proj && g.L == 0)  // out = h, no product left to carry the sums
        for (int e = tid; e < rows; e += kTcThreads)
          for (int c = 0; c < D; c += 2) {
            const float2 o = ld_bf2(h_b + e * ldh + c);
            float* q = part_s + e * kScoreSlots;
            const float* r = r_s + row(e, p0) * D + c;
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
        const int p = pair(t, p0);
        const float d = sum_score(part_s, t);
        g.out[(size_t)row0 * A + p] =
            pack_id(CUT == SelCut::kNoDist ? fabsf(d) + 1.f : d, unpack_id(val_s[p]));
      }
    }
  }
  ring.drain();
}

}  // namespace qt
