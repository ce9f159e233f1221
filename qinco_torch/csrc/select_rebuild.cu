// Beam selection + reconstruction rebuild.
//
// Replaces: qinco_tpu/ops/pallas_kernels.py, select_rebuild_pallas
// (:1211), body _select_rebuild_kernel (:1116).
//
// What it computes, per vector, over its C = F_in * A_eff packed
// distances (position f * A_eff + a):
//   F_out rounds of: m = min, p = the first position holding m (the
//   lax.top_k tie order), remove p;  code = low 8 bits of m,
//   parent = p / A_eff
//   then for each selected (code, parent), with f32 gathers:
//     xhat = MLP(codebook[code] | xh[parent]) + codebook[code] + xh[parent]
//   through the unfolded step MLP (_mlp_chain, :56): in_proj, the concat
//   layer (and its QINCo-LR low-rank factor), L FFN blocks, out_proj,
//   inputs rounded to the compute dtype, f32 accumulation.  Outputs are
//   vector-major and ascending.
//
// What bounds it on the card: at qinco2-S a vector moves about 35 KB
// (its 512 distances, its 32 beam rows and its 32 output rows) against
// about 10.5 MFLOP, so at the bf16 tensor-core peak the bytes and the
// operations take about as long; on the CUDA cores (f32, this version)
// the operations bound it.  The kernel does some 15x less work than the
// selected-scores kernel.
//
// What the design does about it, in this first version: a block owns 8
// vectors, one warp each for the selection (a lane scan plus a warp
// reduction on (value, position) per round), and runs the rebuild MLP on
// the CUDA cores over tiles of TM (vector, beam) pairs in shared memory
// (mlp_chain_tile, shared with the candidate-scores kernel).  The gathers
// are plain indexed loads; nothing but the outputs is written.
#include "common.cuh"

namespace qt {

constexpr int kVecs = 8;  // vectors per block, one selection warp each

struct RebuildArgs {
  const float* dists;     // (N, C) packed
  const float* xh;        // (N * F_in, D)
  const float* codebook;  // (K, D) f32
  ChainWeights w;
  float* xhat;            // (N, F_out, D)
  int* codes;             // (N, F_out)
  int* parents;           // (N, F_out)
  int N, C, A_eff, F_in, F_out, K, res;
};

template <int TM, bool BF>
__global__ void __launch_bounds__(kThreads, 1) select_rebuild_kernel(RebuildArgs g) {
  extern __shared__ __align__(16) float smem[];
  constexpr int V = kVecs;
  const int C = g.C, F_out = g.F_out, D = g.w.D, De = g.w.De;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int v0 = blockIdx.x * V;
  const int n_vecs = min(V, g.N - v0);

  float* d_s = smem;                                 // (V, C)
  int* code_s = reinterpret_cast<int*>(d_s + V * C);  // (V, F_out)
  int* par_s = code_s + V * F_out;                   // (V, F_out)
  float* cand_s = reinterpret_cast<float*>(par_s + V * F_out);  // (TM, D) f32 codewords
  float* cond_s = cand_s + TM * D;                   // (TM, D) f32 parent rows
  float* h_s = cond_s + TM * D;                      // (TM, De)
  float* lr_s = h_s + TM * De;                       // (TM, Wc) with the low-rank factor
  float* cat_s = lr_s + (g.w.concat_w2 ? TM * g.w.Wc : 0);  // (TM, max(De + D, Dh, D))

  for (int e = tid; e < V * C; e += kThreads)
    d_s[e] = e / C < n_vecs ? g.dists[(size_t)v0 * C + e] : 0.f;
  __syncthreads();

  // ---- exact top-F_out per vector: (value, position) minimum per round,
  // remove only that position, so equal packed values both survive and
  // come out in position order.
  for (int v = warp; v < V; v += kWarps) {
    float* row = d_s + v * C;
    for (int j = 0; j < F_out; ++j) {
      float bv = CUDART_INF_F;
      int bp = 0x7fffffff;
      for (int c = lane; c < C; c += 32) {
        const float x = row[c];
        if (x < bv || (x == bv && c < bp)) { bv = x; bp = c; }
      }
#pragma unroll
      for (int off = 16; off; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, off);
        const int op = __shfl_xor_sync(kFull, bp, off);
        if (ov < bv || (ov == bv && op < bp)) { bv = ov; bp = op; }
      }
      const bool ok = v < n_vecs && bp < C;
      const int code = ok ? unpack_id(bv) : 0, par = ok ? bp / g.A_eff : 0;
      __syncwarp();
      if (lane == 0) {
        if (ok) {
          row[bp] = CUDART_INF_F;
          g.codes[(size_t)(v0 + v) * F_out + j] = code;
          g.parents[(size_t)(v0 + v) * F_out + j] = par;
        }
        code_s[v * F_out + j] = code;
        par_s[v * F_out + j] = par;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // ---- rebuild the (vector, beam) pairs, TM at a time; pair p = v * F_out + j
  const int n_pairs = n_vecs * F_out;
  float* xo = g.xhat + (size_t)v0 * F_out * D;
  for (int p0 = 0; p0 < n_pairs; p0 += TM) {
    for (int e = tid; e < TM * D; e += kThreads) {
      const int t = e / D, c = e - t * D, p = p0 + t;
      float cv = 0.f, hv = 0.f;
      if (p < n_pairs) {
        const int code = code_s[p];
        if (code < g.K) cv = g.codebook[(size_t)code * D + c];
        hv = g.xh[((size_t)(v0 + p / F_out) * g.F_in + par_s[p]) * D + c];
      }
      cand_s[e] = cv;
      cond_s[e] = hv;
    }
    __syncthreads();
    mlp_chain_tile<TM, BF>(g.w, cand_s, cond_s, h_s, lr_s, cat_s, g.res,
                           [&](int t, int c, float v) {
                             if (p0 + t < n_pairs) xo[(size_t)(p0 + t) * D + c] = v;
                           });
    __syncthreads();
  }
}

}  // namespace qt

extern "C" int qt_select_rebuild(const float* dists, const float* xh, const float* codebook,
                                 const void* in_proj, const void* concat_w, const void* concat_w2,
                                 const float* concat_b, const void* ffn_up, const void* ffn_down,
                                 const void* out_proj, float* xhat, int* codes, int* parents,
                                 int N, int C, int A_eff, int F_in, int F_out, int D, int K,
                                 int De, int Dh, int L, int Wc, int tm, int smem, int bf16,
                                 int res, void* stream) {
  using namespace qt;
  if (N == 0) return 0;
  const ChainWeights w{in_proj, concat_w, concat_w2, concat_b, ffn_up, ffn_down, out_proj,
                       D,       De,       Dh,        L,        Wc};
  const RebuildArgs a{dists, xh, codebook, w, xhat, codes, parents, N, C, A_eff, F_in, F_out,
                      K,     res};
  const int blocks = (N + kVecs - 1) / kVecs;
  return static_cast<int>(dispatch_tile(tm, bf16, [&](auto TM, auto BF) {
    return launch_kernel(select_rebuild_kernel<decltype(TM)::value, decltype(BF)::value>, blocks,
                         smem, static_cast<cudaStream_t>(stream), a);
  }));
}
