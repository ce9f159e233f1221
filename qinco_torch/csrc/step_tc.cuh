// Pieces shared by the scoring kernels (selected scores, fused-substep
// scores, candidate scores): the substep distance tile on the CUDA cores
// (both routes), and for the tensor-core routes loading a work item's beam
// rows and the fixed-owner partial sums of the distances that the last
// product's epilogue accumulates.
#pragma once

#include "tc.cuh"

namespace qt {

constexpr int kRows = 32;  // the most beam rows of a scoring kernel's work item (substep_rows)

// r = x - xh (f32, (R, D)) and rnd(xh) (bf16, row stride ldd) for the R
// beam rows from row0, of which n_rows are real (the others are zero); x
// holds one target per F_in beam rows.  4 columns a thread, 4 loads in
// flight.  D is a multiple of 4.
__device__ __forceinline__ void load_residuals(const float* x, const float* xh, int row0,
                                               int n_rows, int R, int D, int F_in, float* r_s,
                                               tc::bf16* xh_b, int ldd) {
  using tc::kTcThreads;
  for (int e0 = threadIdx.x; e0 < R * D / 4; e0 += 4 * kTcThreads) {
    float4 xv[4], hv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * kTcThreads, i = e / (D / 4), c = 4 * (e - i * (D / 4));
      xv[u] = hv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < R * D / 4 && i < n_rows) {
        const int row = row0 + i;
        hv[u] = *reinterpret_cast<const float4*>(xh + (size_t)row * D + c);
        xv[u] = *reinterpret_cast<const float4*>(x + (size_t)(row / F_in) * D + c);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * kTcThreads, i = e / (D / 4), c = 4 * (e - i * (D / 4));
      if (e >= R * D / 4) break;
      tc::st_bf2(xh_b + i * ldd + c, hv[u].x, hv[u].y);
      tc::st_bf2(xh_b + i * ldd + c + 2, hv[u].z, hv[u].w);
      *reinterpret_cast<float4*>(r_s + i * D + c) =
          make_float4(xv[u].x - hv[u].x, xv[u].y - hv[u].y, xv[u].z - hv[u].z, xv[u].w - hv[u].w);
    }
  }
}

// The packed substep partial distances of R rows, a (K, R) tile padded to
// R + 1 columns against bank conflicts:
//   S[k][i] = pack(||C_k||^2 - 2 rnd(C_k)·rr_i, k)
// with rr (R, D) the residual rows already rounded to the compute dtype,
// sub_t (D, K) the rounded substep codebook, cn2 (K,) its f32 norms; each
// sum over d in order.  Spread over the block's kThreads math threads: a
// thread takes two codewords and one of NG groups of RH rows, so each
// rounded residual it reads from shared memory (4 at a time) feeds two
// sums, and keeps 32 values of the substep codebook in flight.  D is a
// multiple of 16.
template <int RH, int NG>
__device__ __forceinline__ void substep_tile_tc(const float* rr_s, int R, int D,
                                                const float* sub_t, const float* cn2, int K,
                                                float* S_s) {
  const int KP = (K + 1) / 2;
  for (int job = threadIdx.x; job < NG * KP; job += tc::kTcThreads) {
    const int kp = job % KP, i0 = (job / KP) * RH, ka = 2 * kp, kb = min(2 * kp + 1, K - 1);
    if (i0 >= R) continue;
    float acc[2][RH];
#pragma unroll
    for (int i = 0; i < RH; ++i) acc[0][i] = acc[1][i] = 0.f;
    for (int d0 = 0; d0 < D; d0 += 16) {
      float ca[16], cb[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        ca[u] = __ldg(sub_t + (size_t)(d0 + u) * K + ka);
        cb[u] = __ldg(sub_t + (size_t)(d0 + u) * K + kb);
      }
#pragma unroll
      for (int i = 0; i < RH; ++i) {
        const float4* q = reinterpret_cast<const float4*>(rr_s + (i0 + i) * D + d0);
#pragma unroll
        for (int u4 = 0; u4 < 4; ++u4) {
          const float4 r = q[u4];
          const float rv[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[0][i] = fmaf(ca[4 * u4 + j], rv[j], acc[0][i]);
            acc[1][i] = fmaf(cb[4 * u4 + j], rv[j], acc[1][i]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RH; ++i) {
      if (i0 + i >= R) break;
      S_s[ka * (R + 1) + i0 + i] = pack_id(cn2[ka] - 2.f * acc[0][i], ka);
      if (kb > ka) S_s[kb * (R + 1) + i0 + i] = pack_id(cn2[kb] - 2.f * acc[1][i], kb);
    }
  }
}

// The packed substep partial distances (K, R + 1) of the R <= kRows rows of
// rr_s (the residuals rounded to the compute dtype), two row groups of R / 2.
__device__ __forceinline__ void substep_rows(const float* rr_s, int R, int D, const float* sub_t,
                                             const float* cn2, int K, float* S_s) {
  constexpr int NG = tc::kTcThreads / 128;  // row groups: 128 codeword pairs at K = 256
  switch (R) {
    case 32: substep_tile_tc<32 / NG, NG>(rr_s, R, D, sub_t, cn2, K, S_s); break;
    case 16: substep_tile_tc<16 / NG, NG>(rr_s, R, D, sub_t, cn2, K, S_s); break;
    case 8: substep_tile_tc<8 / NG, NG>(rr_s, R, D, sub_t, cn2, K, S_s); break;
    case 4: substep_tile_tc<(4 / NG > 0 ? 4 / NG : 1), NG>(rr_s, R, D, sub_t, cn2, K, S_s); break;
    case 2: substep_tile_tc<(2 / NG > 0 ? 2 / NG : 1), NG>(rr_s, R, D, sub_t, cn2, K, S_s); break;
    default: substep_tile_tc<1, NG>(rr_s, R, D, sub_t, cn2, K, S_s); break;
  }
}

// Partial sums of the distance of a tile: 16 slots a pair row, one for each
// (warp column, lane & 3) of the mma fragments, so each slot has one owner
// and the sums keep a fixed order.
constexpr int kScoreSlots = 16;

// Add d0^2 + d1^2 to row t's slot of the calling thread, from inside an
// mma_stage or mma_stage_bf16 epilogue.
__device__ __forceinline__ void add_score(float* part_s, int t, float d0, float d1) {
  float* q = part_s + t * kScoreSlots + 4 * ((threadIdx.x >> 5) & 3) + (threadIdx.x & 3);
  *q = fmaf(d1, d1, fmaf(d0, d0, *q));
}

// Row t's distance: its slots summed in order.
__device__ __forceinline__ float sum_score(const float* part_s, int t) {
  const float* q = part_s + t * kScoreSlots;
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kScoreSlots; ++j) s += q[j];
  return s;
}

}  // namespace qt
