// Shared device helpers of the beam-step kernels: the packed-id layout,
// rounding to the compute dtype and the weights of the unfolded step MLP
// (_mlp_chain), which candidate scores and select-rebuild run.
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

// The math threads of a block: all of a tensor-core block (tc.cuh), the
// consumer warps of an f32 block (f32_tile.cuh).  Each kernel's block
// takes most of an SM's shared memory, so one block runs per SM.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Round to the compute dtype (round to nearest even) and hold as f32.
template <bool BF> __device__ __forceinline__ float rnd(float v) {
  if constexpr (BF) return __bfloat162float(__float2bfloat16_rn(v));
  else return v;
}

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

}  // namespace qt

extern "C" const char* qt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
