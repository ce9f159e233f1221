// Shared device helpers of the beam-step kernels: the packed-id layout,
// rounding to the compute dtype, the row-block MLP stage (bf16 or f32
// weights in, f32 accumulation) on the CUDA cores, and the pieces of the
// step MLP that several kernels run: the substep distance tile, the FFN
// blocks, the scoring epilogue and the unfolded chain (_mlp_chain).
//
// Build without --use_fast_math and without -ftz=true: a packed value
// must never be flushed to zero, or its id is lost (see pack_id).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace qt {

// Threads per block.  At the qinco2-S widths each kernel's block takes
// most of an SM's shared memory, so one block runs per SM: the kernels
// declare __launch_bounds__(kThreads, 1), which lets ptxas use the
// registers that leaves.  Without the block count ptxas caps the 64-row
// tiles at 80 registers and spills.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Weights arrive in the compute dtype: bf16 under the parity profile.
template <bool BF> struct WeightT { using T = float; };
template <> struct WeightT<true> { using T = __nv_bfloat16; };

// Round to the compute dtype (round to nearest even) and hold as f32.
template <bool BF> __device__ __forceinline__ float rnd(float v) {
  if constexpr (BF) return __bfloat162float(__float2bfloat16_rn(v));
  else return v;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// _pack_ids_f32: push |d| < 1e-30 to +-1e-30 (a normal float, so the
// packed value is never subnormal), then put the id (< 256) in the low
// 8 bits of the f32 pattern.  A subnormal d counts as zero (+1e-30), as
// under the flush-to-zero arithmetic of the TPU and of XLA on the CPU.
__device__ __forceinline__ float pack_id(float d, int id) {
  const float tiny = 1e-30f;
  if (fabsf(d) < tiny) d = d <= -FLT_MIN ? -tiny : tiny;
  return __int_as_float((__float_as_int(d) & ~0xFF) | id);
}

__device__ __forceinline__ int unpack_id(float v) { return __float_as_int(v) & 0xFF; }

__device__ __forceinline__ void load4(const float* p, float w[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float w[4]) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  w[0] = lo.x; w[1] = lo.y; w[2] = hi.x; w[3] = hi.y;
}

// One MLP stage for a block of TM rows: acc(r, c) = sum_k A[r][k] * W[k][c]
// for every column c < Nout, with A in shared memory (row stride lda, f32,
// rounded to bf16 on read when ROUND_A) and W row-major (Kin, Nout) in
// global memory, read through L1/L2 (a step's weights stay in L2).  Each
// (r, c, acc) goes to epi.  Warp w owns rows w, w + 8, ...; lane l owns
// columns 4l .. 4l+3 of each 128-column pass.  A warp reads only its own
// rows of A, so epi may write any buffer that this warp does not read
// as A.  Kin, Nout, lda and W's offset are multiples of 4.
template <int TM, bool ROUND_A, bool BF, typename Epi>
__device__ __forceinline__ void mlp_stage(const float* A, int lda,
                                          const typename WeightT<BF>::T* W,
                                          int Kin, int Nout, Epi epi) {
  constexpr int RPW = TM / kWarps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c0 = 4 * lane; c0 < Nout; c0 += 128) {
    float acc[RPW][4];
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < Kin; k0 += 4) {
      float w[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) load4(W + (size_t)(k0 + kk) * Nout + c0, w[kk]);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float4 a4 = *reinterpret_cast<const float4*>(A + (warp + i * kWarps) * lda + k0);
        const float a[4] = {rnd<ROUND_A && BF>(a4.x), rnd<ROUND_A && BF>(a4.y),
                            rnd<ROUND_A && BF>(a4.z), rnd<ROUND_A && BF>(a4.w)};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[kk], w[kk][j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) epi(warp + i * kWarps, c0 + j, acc[i][j]);
  }
}

// Sum over the 32 lanes of a warp.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Packed substep partial distances of R rows, a (K, R) tile padded to
// R + 1 columns against bank conflicts:
//   S[k][i] = pack(||C_k||^2 - 2 rnd(C_k)·rr_i, k)
// with rr (R, D) the residual rows already rounded to the compute dtype,
// sub_t (D, K) the rounded substep codebook, cn2 (K,) its f32 norms.
template <int R>
__device__ __forceinline__ void substep_tile(const float* rr_s, int D, const float* sub_t,
                                             const float* cn2, int K, float* S_s) {
  for (int k = threadIdx.x; k < K; k += kThreads) {
    float acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float c = __ldg(sub_t + (size_t)d * K + k);
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] = fmaf(c, rr_s[i * D + d], acc[i]);
    }
    const float n2 = cn2[k];
#pragma unroll
    for (int i = 0; i < R; ++i) S_s[k * (R + 1) + i] = pack_id(n2 - 2.f * acc[i], k);
  }
}

// FFN blocks l0 .. L-1 on the TM rows of h (TM, De), in place:
//   up = rnd(relu(h·U_l)) into hid (TM, Dh);  h = rnd(h + rnd(up·D_l)).
// Enters and leaves with the block synchronised.
template <int TM, bool BF>
__device__ __forceinline__ void ffn_blocks(float* h_s, float* hid_s, const void* ffn_up,
                                           const void* ffn_down, int l0, int L, int De, int Dh) {
  using WT = typename WeightT<BF>::T;
  for (int l = l0; l < L; ++l) {
    const WT* up = static_cast<const WT*>(ffn_up) + (size_t)l * De * Dh;
    const WT* down = static_cast<const WT*>(ffn_down) + (size_t)l * Dh * De;
    mlp_stage<TM, false, BF>(h_s, De, up, De, Dh, [&](int t, int c, float acc) {
      hid_s[t * Dh + c] = rnd<BF>(fmaxf(acc, 0.f));
    });
    __syncthreads();
    mlp_stage<TM, false, BF>(hid_s, Dh, down, Dh, De, [&](int t, int c, float acc) {
      h_s[t * De + c] = rnd<BF>(h_s[t * De + c] + rnd<BF>(acc));
    });
    __syncthreads();
  }
}

// Scoring epilogue of the per-slot kernels for TM (row, slot) pairs
// p0 .. p0+TM-1 of a block (pair p = i * A + a):
//   out = h·P_out (f32) or h;  d = ||r_i - out - cand||^2 (cand only in
//   QINCo2 mode), packed with the slot's id (low bits of val_s[p]) into
//   out_rows[p] for the block's real rows (i < n_rows).
// o_s (TM, D) receives out when there is an out_proj.
template <int TM, bool BF>
__device__ __forceinline__ void score_pairs(const float* h_s, float* o_s, const void* out_proj,
                                            const float* cand_s, const float* r_s,
                                            const float* val_s, int p0, int n_pairs, int A,
                                            int n_rows, int D, int De, int res, float* out_rows) {
  using WT = typename WeightT<BF>::T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* os = h_s;
  int ldo = De;
  if (out_proj) {
    mlp_stage<TM, false, BF>(h_s, De, static_cast<const WT*>(out_proj), De, D,
                             [&](int t, int c, float acc) { o_s[t * D + c] = acc; });
    __syncthreads();
    os = o_s;
    ldo = D;
  }
  for (int t = warp; t < TM && p0 + t < n_pairs; t += kWarps) {
    const int p = p0 + t, i = p / A;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) {
      float diff = r_s[i * D + c] - os[t * ldo + c];
      if (res) diff -= cand_s[t * D + c];
      s = fmaf(diff, diff, s);
    }
    s = warp_sum(s);
    if (lane == 0 && i < n_rows) out_rows[p] = pack_id(s, unpack_id(val_s[p]));
  }
}

// Weights of the unfolded step MLP, in the compute dtype except the bias.
struct ChainWeights {
  const void* in_proj;    // (D, De) or null
  const void* concat_w;   // (De + D, Wc)
  const void* concat_w2;  // (Wc, De) QINCo-LR low-rank factor, or null
  const float* concat_b;  // (De,)
  const void* ffn_up;     // (L, De, Dh)
  const void* ffn_down;   // (L, Dh, De)
  const void* out_proj;   // (De, D) or null
  int D, De, Dh, L, Wc;   // Wc = the rank with concat_w2, else De
};

// The unfolded step MLP (_mlp_chain) for TM pairs, from f32 codewords
// cand_s (TM, D) and condition rows cond_s (TM, D) that the caller filled
// and synchronised:
//   h0 = rnd(cand)·P rounded (or rnd(cand));  c = rnd(cond)
//   cc = [h0 | c]·W  (then rnd(cc)·W2 with the low-rank factor)
//   h  = rnd(h0 + rnd(cc + b));  L FFN blocks;  out = h·P_out or h
//   emit(t, col, (out + cand) + cond)    (out + cond in QINCo1 mode)
// Scratch: h_s (TM, De), lr_s (TM, Wc) with the low-rank factor, and
// cat_s (TM, max(De + D, Dh, D)).  emit may write cat_s, not h_s.  The
// caller synchronises before it reuses any buffer.
template <int TM, bool BF, typename Emit>
__device__ __forceinline__ void mlp_chain_tile(const ChainWeights& w, const float* cand_s,
                                               const float* cond_s, float* h_s, float* lr_s,
                                               float* cat_s, int res, Emit emit) {
  using WT = typename WeightT<BF>::T;
  const int D = w.D, De = w.De, ldc = w.De + w.D;
  for (int e = threadIdx.x; e < TM * D; e += kThreads) {
    const int t = e / D, c = e - t * D;
    cat_s[t * ldc + De + c] = rnd<BF>(cond_s[e]);
    if (!w.in_proj) cat_s[t * ldc + c] = rnd<BF>(cand_s[e]);  // De == D
  }
  if (w.in_proj)
    mlp_stage<TM, true, BF>(cand_s, D, static_cast<const WT*>(w.in_proj), D, De,
                            [&](int t, int c, float acc) { cat_s[t * ldc + c] = rnd<BF>(acc); });
  __syncthreads();
  const WT* cw = static_cast<const WT*>(w.concat_w);
  if (w.concat_w2) {
    mlp_stage<TM, false, BF>(cat_s, ldc, cw, ldc, w.Wc,
                             [&](int t, int c, float acc) { lr_s[t * w.Wc + c] = rnd<BF>(acc); });
    __syncthreads();
    mlp_stage<TM, false, BF>(lr_s, w.Wc, static_cast<const WT*>(w.concat_w2), w.Wc, De,
                             [&](int t, int c, float acc) {
                               h_s[t * De + c] =
                                   rnd<BF>(cat_s[t * ldc + c] + rnd<BF>(acc + w.concat_b[c]));
                             });
  } else {
    mlp_stage<TM, false, BF>(cat_s, ldc, cw, ldc, De, [&](int t, int c, float acc) {
      h_s[t * De + c] = rnd<BF>(cat_s[t * ldc + c] + rnd<BF>(acc + w.concat_b[c]));
    });
  }
  __syncthreads();
  ffn_blocks<TM, BF>(h_s, cat_s, w.ffn_up, w.ffn_down, 0, w.L, De, w.Dh);
  auto fin = [&](int t, int c, float o) {
    if (res) o += cand_s[t * D + c];
    emit(t, c, o + cond_s[t * D + c]);
  };
  if (w.out_proj) {
    mlp_stage<TM, false, BF>(h_s, De, static_cast<const WT*>(w.out_proj), De, D, fin);
  } else {
    for (int e = threadIdx.x; e < TM * D; e += kThreads) fin(e / D, e % D, h_s[e]);
  }
}

// Sets the kernel's dynamic shared memory and launches it on `stream`.
template <typename Kernel, typename Args>
cudaError_t launch_kernel(Kernel kernel, int blocks, int smem, cudaStream_t stream,
                          const Args& args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<blocks, kThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace qt

extern "C" const char* qt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
