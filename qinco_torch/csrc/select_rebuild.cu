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
// operations take about as long.
//
// What the design does about it.  Both routes select with one warp per
// vector (a lane scan plus a warp reduction on (value, position) per
// round); nothing but the outputs is written.  bf16:
// select_rebuild_tc_kernel, persistent blocks over work items of V vectors
// (the wrapper picks V so that a launch has enough items to fill the
// card), gathers by plain indexed loads, the rebuild MLP on the tensor
// cores (tc.cuh) over tiles of TM (vector, beam) pairs, activations as
// bf16 in shared memory, weights streamed through a cp.async ring; the
// f32 codeword and parent row of the final sum are read again from device
// memory (L2).  Where D is too wide for [h0 | rnd(cond)] and rnd(cand) of a
// 64-pair tile beside the ring (D = 768 at every preset), the wrapper's
// plan takes D in column passes: in_proj and the concat layer read the
// codewords and the parent rows a chunk of columns at a time, again for
// every pass over their output columns.
// f32: select_rebuild_f32_kernel, the same walk over work items with the
// rebuild MLP in IEEE f32 FFMA on the CUDA cores (f32_tile.cuh: TF32 would
// be a different result), activations f32 in shared memory, the weights
// (in the blocked layout) streamed by bulk copies from a producer warp.
// The selection runs one work item ahead on the producer warpgroup's other
// three warps, so the math warps never wait for it.  Per tile the f32
// codeword and parent row go into one [cand | cond] buffer, the concat
// layer's A, by bulk copies that complete on an mbarrier, and the final
// sum reads them again from L2 and writes xhat in float4 stores from the
// last product's epilogue.  A 64-pair tile (two vectors an item) at the
// qinco2-S widths, a 32-pair tile (one vector) at the qinco2-M and -L
// widths, where the De + D wide buffer of 64 rows does not fit beside the
// weight ring.
#include "f32_tile.cuh"

namespace qt {

struct RebuildArgs {
  const float* dists;     // (N, C) packed
  const float* xh;        // (N * F_in, D)
  const float* codebook;  // (K, D) f32
  ChainWeights w;
  float* xhat;            // (N, F_out, D)
  int* codes;             // (N, F_out)
  int* parents;           // (N, F_out)
  int N, C, A_eff, F_in, F_out, K, res;
  int V;                  // vectors per work item
  int kc;                 // columns of D a pass holds: D, or fewer on the D-passed plan
};

// Exact top-F_out of the V vectors from v0 (n_vecs of them real) in d_s,
// one warp a vector (the calling warp, number `warp` of n_warps that share
// the vectors): (value, position) minimum per round, remove only that
// position, so equal packed values both survive and come out in position
// order.  Writes the codes and parents to code_s / par_s and, for real
// vectors, to g.
__device__ __forceinline__ void select_beams(const RebuildArgs& g, float* d_s, int* code_s,
                                             int* par_s, int V, int v0, int n_vecs, int warp,
                                             int n_warps) {
  const int C = g.C, F_out = g.F_out;
  const int lane = threadIdx.x & 31;
  for (int v = warp; v < V; v += n_warps) {
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
}

// Shared-memory layout of the tensor-core kernel (byte offsets), the same
// arithmetic as rebuild_plan in qinco_torch/ops/kernels.py:
//   stage table | dists (V, C) f32 | codes, parents (V, F_out) int32 |
//   cat [h0 | rnd(cond)] (TM, De + D), later the FFN hidden (TM, Dh) |
//   rnd(cand) (TM, D) for in_proj, later h (TM, De) | the low-rank
//   product (TM, Wc) | the weight ring.  Activations in bf16.  On the
//   D-passed plan (`passed`) a chunk of kc columns takes D's place in cat
//   (of rnd(cond)) and in h (of rnd(cand)).
struct RebuildLayout {
  unsigned d, code, par, cat, h, lr, ring, total;
  __host__ __device__ RebuildLayout(const RebuildArgs& g, int TM, bool passed = false) {
    using tc::align16;
    using tc::ld_of;
    const size_t V = g.V, D = passed ? g.kc : g.w.D, De = g.w.De, Dh = g.w.Dh;
    const size_t cat_w = ld_of(De + D) > ld_of(Dh) ? ld_of(De + D) : ld_of(Dh);
    const size_t h_w = ld_of(De > D ? De : D);
    d = tc::kStageBytes;
    code = d + align16(4 * V * g.C);
    par = code + align16(4 * V * g.F_out);
    cat = par + align16(4 * V * g.F_out);
    h = cat + 2 * TM * cat_w;
    lr = h + 2 * TM * h_w;
    ring = lr + (g.w.concat_w2 ? 2 * TM * (size_t)ld_of(g.w.Wc) : 0);
    total = ring + tc::kRingBytes;
  }
};

// Products in the tensor-core kernel's weight stream.
__host__ __device__ inline int rebuild_stages(const ChainWeights& w) {
  return (w.in_proj ? 1 : 0) + 1 + (w.concat_w2 ? 1 : 0) + 2 * w.L + (w.out_proj ? 1 : 0);
}

// Shared-memory layout of the f32 kernel (byte offsets), the same
// arithmetic as rebuild_plan in qinco_torch/ops/kernels.py:
//   stage table | the mbarriers (48 bytes: the gather's, selected[2],
//   consumed[2]) | two buffers of dists (V, C), codes and parents (V,
//   F_out) int32 | cat
//   [h0 | cond] (TM, ld De + D), later the FFN hidden (TM, ld Dh) | cand
//   (TM, ld D) for in_proj, later h (TM, ld De) | the low-rank product
//   (TM, ld Wc) | the weight ring (f32::ring_bytes).  All f32; ld w = w + 4.
struct RebuildF32Layout {
  unsigned bar, d, code, par, cat, h, lr, ring, total;
  __host__ __device__ RebuildF32Layout(const RebuildArgs& g, int TM) {
    using f32::ld_of;
    using tc::align16;
    const size_t V = g.V, T = TM, D = g.w.D, De = g.w.De, Dh = g.w.Dh;
    const size_t cat_w = ld_of(De + D) > ld_of(Dh) ? ld_of(De + D) : ld_of(Dh);
    bar = f32::kStageBytes;
    d = bar + 48;
    code = d + 2 * align16(4 * V * g.C);
    par = code + 2 * align16(4 * V * g.F_out);
    cat = par + 2 * align16(4 * V * g.F_out);
    h = cat + 4 * T * cat_w;
    lr = h + 4 * T * ld_of(De > D ? De : D);
    ring = lr + (g.w.concat_w2 ? 4 * T * ld_of(g.w.Wc) : 0);
    total = ring + f32::ring_bytes(TM);
  }
};

// f32 route: the rebuild MLP in f32 FFMA on the CUDA cores (f32_tile.cuh).
// A block walks the work items blockIdx.x, blockIdx.x + gridDim.x, ...: V
// vectors each, their V·F_out pairs in tiles of TM; pair p = v * F_out + j.
// The selection runs one item ahead on the producer warpgroup's three
// other warps (kSelectors), into the other of two buffers: the consumers
// wait for an item's codes and parents on selected[b] and hand the buffer
// back on consumed[b] once they are done with it.
constexpr int kSelectors = 3;

template <int TM>
__global__ void __launch_bounds__(f32::kBlock, 1) select_rebuild_f32_kernel(RebuildArgs g) {
  using namespace f32;
  extern __shared__ __align__(16) unsigned char sm[];
  const ChainWeights& w = g.w;
  const int C = g.C, F_out = g.F_out, D = w.D, De = w.De, Dh = w.Dh, Wc = w.Wc, L = w.L;
  const int V = g.V, tid = threadIdx.x;
  const bool low_rank = w.concat_w2 != nullptr, proj = w.out_proj != nullptr;
  const RebuildF32Layout lay(g, TM);
  float* d_buf = reinterpret_cast<float*>(sm + lay.d);    // 2 x (V, C)
  int* code_buf = reinterpret_cast<int*>(sm + lay.code);  // 2 x (V, F_out)
  int* par_buf = reinterpret_cast<int*>(sm + lay.par);    // 2 x (V, F_out)
  const int d_stride = (lay.code - lay.d) / 8, s_stride = (lay.par - lay.code) / 8;  // ints
  float* cat_s = reinterpret_cast<float*>(sm + lay.cat);  // (TM, ldc) [h0 | cond], then (TM, ldf)
  float* h_s = reinterpret_cast<float*>(sm + lay.h);      // (TM, ldd) cand for in_proj, then h
  float* lr_s = reinterpret_cast<float*>(sm + lay.lr);    // (TM, ldr) low-rank product
  const int ldc = ld_of(De + D), ldh = ld_of(De > D ? De : D), ldf = ld_of(Dh), ldr = ld_of(Wc);
  const uint32_t gather = tc::smem_addr(sm + lay.bar);  // the rows' bulk copies
  const auto selected = [&](int b) { return gather + 8 + 8 * b; };
  const auto consumed = [&](int b) { return gather + 24 + 8 * b; };
  if (tid == 0) {
    mbar_init(gather, 1);
    for (int b = 0; b < 2; ++b) {
      mbar_init(selected(b), kSelectors);
      mbar_init(consumed(b), kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // The weight stream, once per tile, every weight in the blocked layout:
  // [in_proj], concat, [concat_w2], (U_l, D_l) x L, [out_proj].
  Stage* stages = reinterpret_cast<Stage*>(sm);
  if (tid == 0) {
    const float* up = static_cast<const float*>(w.ffn_up);
    const float* down = static_cast<const float*>(w.ffn_down);
    int n = 0;
    if (w.in_proj) stages[n++] = {static_cast<const float*>(w.in_proj), D, De, D * kPass};
    stages[n++] = {static_cast<const float*>(w.concat_w), De + D, Wc, (De + D) * kPass};
    if (low_rank) stages[n++] = {static_cast<const float*>(w.concat_w2), Wc, De, Wc * kPass};
    for (int l = 0; l < L; ++l) {
      stages[n++] = {up + l * blocked(De, Dh), De, Dh, De * kPass};
      stages[n++] = {down + l * blocked(Dh, De), Dh, De, Dh * kPass};
    }
    if (proj) stages[n++] = {static_cast<const float*>(w.out_proj), De, D, De * kPass};
  }
  __syncthreads();
  const int n_pairs = V * F_out, n_items = (g.N + V - 1) / V;
  Ring ring;
  ring.init(sm + lay.ring, stages, 0, rebuild_stages(w), (n_pairs + TM - 1) / TM, TM == 64);
  if (tid >= kThreads) {  // the producer warpgroup
    producer_regs();
    const int items = (n_items - blockIdx.x + gridDim.x - 1) / gridDim.x;
    const int sw = (tid - kThreads) >> 5;  // its first warp streams the weights
    if (sw == 0) {
      ring.produce_all(items);
      return;
    }
    // the selectors: item i into buffer i & 1, once the consumers are done
    // with the item two before; each warp loads and selects its vectors
    for (int i = 0; i < items; ++i) {
      const int b = i & 1, v0 = (blockIdx.x + i * gridDim.x) * V, n_vecs = min(V, g.N - v0);
      if (i >= 2) mbar_wait(consumed(b), ((i >> 1) - 1) & 1, 64);
      float* d_s = d_buf + b * d_stride;
      for (int v = sw - 1; v < V; v += kSelectors)
        for (int c = tid & 31; c < C; c += 32)
          d_s[v * C + c] = v < n_vecs ? g.dists[(size_t)(v0 + v) * C + c] : 0.f;
      __syncwarp();
      select_beams(g, d_s, code_buf + b * s_stride, par_buf + b * s_stride, V, v0, n_vecs, sw - 1,
                   kSelectors);
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(selected(b));
    }
    return;
  }
  consumer_regs();
  uint32_t gathers = 0;  // phases of the gather barrier so far

  for (int i = 0, item = blockIdx.x; item < n_items; ++i, item += gridDim.x) {
    const int v0 = item * V, n_vecs = min(V, g.N - v0), n_valid = n_vecs * F_out, b = i & 1;
    const int* code_s = code_buf + b * s_stride;
    const int* par_s = par_buf + b * s_stride;
    float* xo = g.xhat + (size_t)v0 * F_out * D;
    // xh row of pair p's parent
    auto row_of = [&](int p) { return (size_t)(v0 + p / F_out) * g.F_in + par_s[p]; };
    mbar_wait(selected(b), (i >> 1) & 1);  // the item's codes and parents are in

    for (int p0 = 0; p0 < n_pairs; p0 += TM) {
      const int rows = max(0, min(TM, n_valid - p0));
      fence_proxy_async();  // the tile buffers' last generic accesses come before the copies
      sync();  // codes and parents are in; the last tile's readers are done
      // the f32 codeword and parent row by bulk copies (warp 0 issues
      // them, everyone waits for the bytes): [cand | cond] into cat, or
      // cand into h for in_proj; a code outside [0, K) gives zeros
      float* cand_dst = w.in_proj ? h_s : cat_s;
      const int ld_cand = w.in_proj ? ldh : ldc;
      if (tid < 32) {
        if (tid == 0) {
          int n = 0;
          for (int t = 0; t < rows; ++t) n += code_s[p0 + t] < g.K ? 2 : 1;
          mbar_expect_tx(gather, 4u * D * n);
        }
        __syncwarp();
        for (int t = tid; t < rows; t += 32) {
          const int code = code_s[p0 + t];
          if (code < g.K)
            bulk_copy(tc::smem_addr(cand_dst + t * ld_cand), g.codebook + (size_t)code * D, 4 * D,
                      gather);
          else
            for (int c = 0; c < D; c += 4) st4(cand_dst + t * ld_cand + c, make_float4(0, 0, 0, 0));
          bulk_copy(tc::smem_addr(cat_s + t * ldc + De), g.xh + row_of(p0 + t) * D, 4 * D, gather);
        }
      }
      mbar_wait(gather, gathers++ & 1);

      // xhat = (out + cand) + cond, from the f32 codeword and parent row in
      // device memory (L2); float4 stores
      auto fin = [&](int t, int c, float4 o) {
        const int p = p0 + t, code = code_s[p];
        if (g.res && code < g.K) o = add4(o, ld4(g.codebook + (size_t)code * D + c));
        st4(xo + (size_t)p * D + c, add4(o, ld4(g.xh + row_of(p) * D + c)));
      };
      auto h_out = [&](int t, int c, float4 o) {
        if (!proj) fin(t, c, o);
      };
      // h = h0 + (concat + b), written to h; out = h when nothing follows
      auto concat_out = [&](int t, int c, float4 v) {
        const float4 o = add4(ld4(cat_s + t * ldc + c), add4(v, ld4(w.concat_b + c)));
        st4(h_s + t * ldh + c, o);
        if (!proj && L == 0) fin(t, c, o);
      };
      // h0 = cand·P into cat[:, :De]
      if (w.in_proj)
        stage<TM>(ring, h_s, ldh, D, De, rows,
                  [&](int t, int c, float4 v) { st4(cat_s + t * ldc + c, v); });
      if (low_rank) {  // lr = [h0 | cond]·W;  h = h0 + (lr·W2 + b)
        stage<TM>(ring, cat_s, ldc, De + D, Wc, rows,
                  [&](int t, int c, float4 v) { st4(lr_s + t * ldr + c, v); });
        stage<TM>(ring, lr_s, ldr, Wc, De, rows, concat_out);
      } else {  // h = h0 + ([h0 | cond]·W + b)
        stage<TM>(ring, cat_s, ldc, De + D, De, rows, concat_out);
      }
      ffn<TM>(ring, h_s, ldh, cat_s, ldf, L, De, Dh, rows, h_out);
      if (proj) stage<TM>(ring, h_s, ldh, De, D, rows, fin);
    }
    __syncwarp();  // the warp's reads of the item's codes and parents are done
    if ((tid & 31) == 0) mbar_arrive(consumed(b));
  }
}

// bf16 route: the rebuild MLP on the tensor cores.  A block walks the
// work items blockIdx.x, blockIdx.x + gridDim.x, ...: V vectors each,
// their V·F_out pairs in tiles of TM = 32·MT.  PASSED (the D-passed plan):
// in_proj reads rnd(cand), and the concat layer the rnd(cond) half of its
// A, a chunk of kc columns at a time (the maps of tc::mma_pass), filled
// from device memory again for every pass over their output columns; the
// concat layer's slabs then start on chunk edges (De a multiple of 32).
template <int MT, bool PASSED = false>
__global__ void __launch_bounds__(tc::kTcThreads, 1) select_rebuild_tc_kernel(RebuildArgs g) {
  using namespace tc;
  constexpr int TM = 32 * MT;
  extern __shared__ __align__(16) unsigned char sm[];
  const ChainWeights& w = g.w;
  const int C = g.C, F_out = g.F_out, D = w.D, De = w.De, Dh = w.Dh, Wc = w.Wc, V = g.V;
  const int tid = threadIdx.x;
  const RebuildLayout lay(g, TM, PASSED);
  float* d_s = reinterpret_cast<float*>(sm + lay.d);     // (V, C)
  int* code_s = reinterpret_cast<int*>(sm + lay.code);   // (V, F_out)
  int* par_s = reinterpret_cast<int*>(sm + lay.par);     // (V, F_out)
  bf16* cat_b = reinterpret_cast<bf16*>(sm + lay.cat);   // (TM, De + D), then (TM, Dh)
  bf16* h_b = reinterpret_cast<bf16*>(sm + lay.h);       // (TM, D) rnd(cand), then (TM, De)
  bf16* lr_b = reinterpret_cast<bf16*>(sm + lay.lr);     // (TM, Wc)
  const int Dw = PASSED ? g.kc : D;  // columns of D a buffer holds
  const int ldc = ld_of(De + Dw), ldd = ld_of(Dw), ldh = ld_of(De > Dw ? De : Dw);
  const int ldf = ld_of(Dh), ldr = ld_of(Wc);

  // The weight stream, once per tile: [in_proj], concat, [concat_w2],
  // (U_l, D_l) x L, [out_proj].
  WStage* stages = reinterpret_cast<WStage*>(sm);
  if (tid == 0) {
    const bf16* up = static_cast<const bf16*>(w.ffn_up);
    const bf16* down = static_cast<const bf16*>(w.ffn_down);
    int n = 0;
    if (w.in_proj) stages[n++] = {static_cast<const bf16*>(w.in_proj), D, De};
    stages[n++] = {static_cast<const bf16*>(w.concat_w), De + D, Wc};
    if (w.concat_w2) stages[n++] = {static_cast<const bf16*>(w.concat_w2), Wc, De};
    for (int l = 0; l < w.L; ++l) {
      stages[n++] = {up + (size_t)l * De * Dh, De, Dh};
      stages[n++] = {down + (size_t)l * Dh * De, Dh, De};
    }
    if (w.out_proj) stages[n++] = {static_cast<const bf16*>(w.out_proj), De, D};
  }
  __syncthreads();
  const int n_pairs = V * F_out, n_items = (g.N + V - 1) / V;
  WeightRing ring;
  ring.init(reinterpret_cast<bf16*>(sm + lay.ring), stages, 0, rebuild_stages(w),
            (n_pairs + TM - 1) / TM);

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int v0 = item * V, n_vecs = min(V, g.N - v0), n_valid = n_vecs * F_out;
    float* xo = g.xhat + (size_t)v0 * F_out * D;
    // xh row of pair p's parent
    auto row_of = [&](int p) { return ((size_t)(v0 + p / F_out) * g.F_in + par_s[p]); };
    __syncthreads();  // the last item's readers of codes and parents are done
    for (int e = tid; e < V * C; e += kTcThreads)
      d_s[e] = e / C < n_vecs ? g.dists[(size_t)v0 * C + e] : 0.f;
    __syncthreads();
    select_beams(g, d_s, code_s, par_s, V, v0, n_vecs, tid >> 5, kTcWarps);

    for (int p0 = 0; p0 < n_pairs; p0 += TM) {
      const int rows = max(0, min(TM, n_valid - p0));
      __syncthreads();  // codes and parents are in; the last tile's readers are done
      // rows t < rows of dst (row stride ld) take columns c0 .. c0 + n - 1
      // of the f32 rows src(t) (null: zeros), rounded; 4 columns a thread,
      // 4 loads in flight
      const auto load_rows = [&](bf16* dst, int ld, int c0, int n, auto src) {
        const int n4 = n / 4;
        for (int e0 = tid; e0 < rows * n4; e0 += 4 * kTcThreads) {
          float4 v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int e = e0 + u * kTcThreads, t = e / n4;
            const float* row = e < rows * n4 ? src(t) : nullptr;
            v[u] = row ? *reinterpret_cast<const float4*>(row + c0 + 4 * (e - t * n4))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int e = e0 + u * kTcThreads, t = e / n4, c = 4 * (e - t * n4);
            if (e >= rows * n4) break;
            st_bf2(dst + t * ld + c, v[u].x, v[u].y);
            st_bf2(dst + t * ld + c + 2, v[u].z, v[u].w);
          }
        }
      };
      const auto cand_row = [&](int t) -> const float* {
        const int code = code_s[p0 + t];
        return code < g.K ? g.codebook + (size_t)code * D : nullptr;
      };
      const auto cond_row = [&](int t) -> const float* { return g.xh + row_of(p0 + t) * D; };
      // in_proj's A: rnd(cand), in h; a chunk of kc columns at a time (PASSED)
      const auto cand_cols = [&](int k0) {
        if constexpr (PASSED) {
          const int kl = k0 % g.kc;
          if (kl == 0) {
            load_rows(h_b, ldd, k0, min(g.kc, D - k0), cand_row);
            __syncthreads();
          }
          return kl;
        } else {
          return k0;
        }
      };
      // the concat layer's A: h0 (or rnd(cand)) whole, then rnd(cond); a
      // chunk of kc columns of it at a time (PASSED)
      const auto cat_cols = [&](int k0) {
        if constexpr (PASSED) {
          if (k0 < De) return k0;
          const int kl = (k0 - De) % g.kc;
          if (kl == 0) {
            load_rows(cat_b + De, ldc, k0 - De, min(g.kc, D - (k0 - De)), cond_row);
            __syncthreads();
          }
          return De + kl;
        } else {
          return k0;
        }
      };
      if constexpr (PASSED) {
        if (!w.in_proj) load_rows(cat_b, ldc, 0, D, cand_row);  // h0 = rnd(cand), De = D
      } else {
        // the f32 codeword (rounded) and parent row (rounded into cat), 4
        // columns a thread, 4 pairs of loads in flight
        bf16* cand_dst = w.in_proj ? h_b : cat_b;
        const int ld_cand = w.in_proj ? ldd : ldc;
        for (int e0 = tid; e0 < rows * (D / 4); e0 += 4 * kTcThreads) {
          float4 cv[4], hv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int e = e0 + u * kTcThreads, t = e / (D / 4), c = 4 * (e - t * (D / 4));
            cv[u] = hv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (t < rows) {
              const int p = p0 + t, code = code_s[p];
              if (code < g.K) cv[u] = *reinterpret_cast<const float4*>(g.codebook + (size_t)code * D + c);
              hv[u] = *reinterpret_cast<const float4*>(g.xh + (row_of(p) * D + c));
            }
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int e = e0 + u * kTcThreads, t = e / (D / 4), c = 4 * (e - t * (D / 4));
            if (t >= rows) break;
            st_bf2(cat_b + t * ldc + De + c, hv[u].x, hv[u].y);
            st_bf2(cat_b + t * ldc + De + c + 2, hv[u].z, hv[u].w);
            st_bf2(cand_dst + t * ld_cand + c, cv[u].x, cv[u].y);
            st_bf2(cand_dst + t * ld_cand + c + 2, cv[u].z, cv[u].w);
          }
        }
      }
      const auto same = [](int, int, float v0, float v1) { return make_float2(v0, v1); };
      // h0 = rnd(rnd(cand)·P) into cat[:, :De]
      if (w.in_proj)
        mma_stage_bf16<MT>(ring, h_b, ldd, D, De, rows, cat_b, ldc, nullptr, 0, same, NoLast{},
                           cand_cols);
      // h = rnd(h0 + rnd([h0 | c]·W (·W2) + b))
      const auto bias = [&](int, int c, float v0, float v1) {
        return make_float2(rnd<true>(v0 + w.concat_b[c]), rnd<true>(v1 + w.concat_b[c + 1]));
      };
      if (w.concat_w2) {
        mma_stage_bf16<MT>(ring, cat_b, ldc, De + D, Wc, rows, lr_b, ldr, nullptr, 0, same,
                           NoLast{}, cat_cols);
        mma_stage_bf16<MT>(ring, lr_b, ldr, Wc, De, rows, h_b, ldh, cat_b, ldc, bias, NoLast{});
      } else {
        mma_stage_bf16<MT>(ring, cat_b, ldc, De + D, De, rows, h_b, ldh, cat_b, ldc, bias,
                           NoLast{}, cat_cols);
      }
      ffn_stages<MT>(ring, h_b, ldh, cat_b, ldf, w.L, De, Dh, rows, NoLast{});
      // xhat = (out + cand) + cond, from the f32 codeword and parent row
      auto fin = [&](int t, int c, float o0, float o1) {
        const int p = p0 + t, code = code_s[p];
        const float2 hv = *reinterpret_cast<const float2*>(g.xh + row_of(p) * D + c);
        if (g.res && code < g.K) {
          const float2 cv = *reinterpret_cast<const float2*>(g.codebook + (size_t)code * D + c);
          o0 += cv.x;
          o1 += cv.y;
        }
        *reinterpret_cast<float2*>(xo + (size_t)p * D + c) = make_float2(o0 + hv.x, o1 + hv.y);
      };
      if (w.out_proj) {
        mma_stage<MT>(ring, h_b, ldh, De, D, rows, fin);
      } else {
        __syncthreads();
        for (int e0 = tid; e0 < rows * (D / 4); e0 += 4 * kTcThreads) {
          float4 cv[4], hv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int e = e0 + u * kTcThreads, t = e / (D / 4), c = 4 * (e - t * (D / 4));
            cv[u] = hv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (t < rows) {
              const int p = p0 + t, code = code_s[p];
              if (g.res && code < g.K)
                cv[u] = *reinterpret_cast<const float4*>(g.codebook + (size_t)code * D + c);
              hv[u] = *reinterpret_cast<const float4*>(g.xh + row_of(p) * D + c);
            }
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int e = e0 + u * kTcThreads, t = e / (D / 4), c = 4 * (e - t * (D / 4));
            if (t >= rows) break;
            const float2 o01 = ld_bf2(h_b + t * ldh + c), o23 = ld_bf2(h_b + t * ldh + c + 2);
            // (out + cand) + cond; cand is 0 outside QINCo2 mode
            *reinterpret_cast<float4*>(xo + (size_t)(p0 + t) * D + c) =
                make_float4((o01.x + cv[u].x) + hv[u].x, (o01.y + cv[u].y) + hv[u].y,
                            (o23.x + cv[u].z) + hv[u].z, (o23.y + cv[u].w) + hv[u].w);
          }
        }
      }
    }
  }
  ring.drain();
}

}  // namespace qt

extern "C" int qt_select_rebuild(const float* dists, const float* xh, const float* codebook,
                                 const void* in_proj, const void* concat_w, const void* concat_w2,
                                 const float* concat_b, const void* ffn_up, const void* ffn_down,
                                 const void* out_proj, float* xhat, int* codes, int* parents,
                                 int N, int C, int A_eff, int F_in, int F_out, int D, int K,
                                 int De, int Dh, int L, int Wc, int tm, int vecs, int blocks,
                                 int smem, int kc, int bf16, int res, void* stream) {
  using namespace qt;
  if (N == 0) return 0;
  const ChainWeights w{in_proj, concat_w, concat_w2, concat_b, ffn_up, ffn_down, out_proj,
                       D,       De,       Dh,        L,        Wc};
  const RebuildArgs a{dists, xh, codebook, w, xhat, codes, parents, N, C, A_eff, F_in, F_out,
                      K,     res, vecs,     kc};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16 && kc < D) {
    // the D-passed plan: 64-pair tiles, chunks of whole 64-row slabs, the
    // concat layer's chunks on its 32-row slabs
    if (rebuild_stages(w) > tc::kMaxStages || tm != 64 || kc < 64 || kc % 64 || De % 32 ||
        (size_t)smem < RebuildLayout(a, tm, true).total || vecs < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(tc::launch_tc(select_rebuild_tc_kernel<2, true>, blocks, smem, s, a));
  }
  if (kc != D) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16) {
    if (rebuild_stages(w) > tc::kMaxStages || (size_t)smem < RebuildLayout(a, tm).total || vecs < 1 ||
        (tm != 64 && tm != 128))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(tm == 128 ? tc::launch_tc(select_rebuild_tc_kernel<4>, blocks, smem, s, a)
                                      : tc::launch_tc(select_rebuild_tc_kernel<2>, blocks, smem, s, a));
  }
  // f32: the plan's tile, vectors a work item and shared memory, or nothing
  if (rebuild_stages(w) > f32::kMaxStages || (size_t)smem < RebuildF32Layout(a, tm).total ||
      vecs < 1 || blocks < 1 || (tm != 64 && tm != 32) || (D | De | Dh | Wc) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(tm == 64
                              ? f32::launch(select_rebuild_f32_kernel<64>, blocks, smem, s, a)
                              : f32::launch(select_rebuild_f32_kernel<32>, blocks, smem, s, a));
}
