// Candidate scores: externally chosen codeword ids, scored through the
// unfolded step MLP.
//
// Replaces: qinco_tpu/ops/pallas_kernels.py, candidate_scores_pallas
// (:1019), body _cand_scores_kernel (:147).  The route for K > 256 (no
// packed ids) and for QINCo-LR (a low-rank concat factor, which the
// folded tables cannot absorb).
//
// What it computes, for each (row, slot) pair p = row * A + a with id
// idx[p] (any K):
//   cand = codebook[id] in the compute dtype (the QINCo2 "+ cand" below
//          uses this rounded codeword too, as the JAX one-hot fetch does)
//   cand_abs = (MLP(cand | xh[row]) + cand) + xh[row]
//     through _mlp_chain (:56): in_proj, the concat layer (and its
//     low-rank factor), L FFN blocks, out_proj; inputs rounded to the
//     compute dtype, f32 accumulation
//   d = ||x[row] - cand_abs||^2, packed with id when K <= 256
//
// What bounds it on the card: operations.  At the qinco2-S widths a pair
// costs about 0.33 MFLOP against about 1 KB of input per row.
//
// What the design does about it.  Both routes are persistent blocks, one
// an SM, over work items of R rows (the wrapper's candidate_plan picks R
// so that a launch has enough items to fill the card), with the step's
// weights streamed through a ring in shared memory.  The concat
// layer's condition half xh·W[De:], the same for a row's A ids, runs once
// per item (the ring's head stage) into f32 shared memory; each tile of TM
// pairs then fetches its codewords, runs in_proj, the codeword half of
// the concat layer plus that condition sum (splitting [h0 | cond]·W into
// h0·W[:De] + cond·W[De:] changes only the order of the f32 sums), the
// low-rank factor, the FFN blocks and out_proj, and sums the distance in
// the last product's epilogue into fixed-owner partials.  Only the (rows,
// A) distances are written.
//   bf16: candidate_scores_tc_kernel, every MLP product on the tensor
//   cores (tc.cuh), codewords fetched by cp.async from the (K, D) bf16
//   codebook (L2-resident at any K the port runs), activations bf16.
//   f32: candidate_scores_f32_kernel, every MLP product in IEEE f32 FFMA
//   on the CUDA cores (f32_tile.cuh: TF32 would be a different result),
//   activations f32 in shared memory, an 8 x 8 (256-column passes) or 8 x
//   4 register tile of sums a thread, the weights (in the blocked layout)
//   streamed by bulk copies from a producer warp; codewords fetched from
//   the f32 codebook.  As for
//   B2', the 32-pair tile of the qinco2-M and -L widths waits on the
//   weight stream from L2.
#include "f32_tile.cuh"

namespace qt {

struct CandidateArgs {
  const float* x;         // (NF, D) targets
  const float* xh;        // (NF, D) beam rows
  const int* idx;         // (NF, A) codeword ids
  const void* codebook;   // (K, D) in the compute dtype
  ChainWeights w;
  float* out;             // (NF, A) squared distances (packed when pack)
  int NF, A, K, pack, res;
  int R;                  // rows per work item
};

// Shared-memory layout of the f32 kernel (byte offsets), the same
// arithmetic as candidate_plan in qinco_torch/ops/kernels.py:
//   stage table | x (R, D) | cc (R, Wc) | ids (R, A) int32 | score partials
//   (TM, 32) | xh (R, ld D) | per tile cand (TM, ld D), h (TM, ld De) and
//   one buffer that holds h0 = cand·P (TM, ld De, with in_proj) and the
//   low-rank product (TM, ld Wc), later the FFN hidden (TM, ld Dh) | the
//   weight ring (f32::ring_bytes).  All f32; ld w = w + 4.  xh comes last
//   before the tiles: the condition product reads TM rows from it, of
//   which R are its own.
struct CandidateF32Layout {
  unsigned x, cc, ids, part, xh, cand, h, big, lr, ring, total;
  __host__ __device__ CandidateF32Layout(const CandidateArgs& g, int TM) {
    using f32::ld_of;
    using tc::align16;
    const size_t R = g.R, T = TM, D = g.w.D, De = g.w.De;
    x = f32::kStageBytes;
    cc = x + align16(4 * R * D);
    ids = cc + align16(4 * R * g.w.Wc);
    part = ids + align16(4 * R * g.A);
    xh = part + 4 * T * f32::kSlots;
    cand = xh + 4 * R * ld_of(D);
    h = cand + 4 * T * ld_of(D);
    big = h + 4 * T * ld_of(De);
    lr = big + (g.w.in_proj ? 4 * T * ld_of(De) : 0);
    const size_t h0_lr = lr + (g.w.concat_w2 ? 4 * T * ld_of(g.w.Wc) : 0) - big;
    const size_t hid = 4 * T * ld_of(g.w.Dh);
    ring = big + align16(h0_lr > hid ? h0_lr : hid);
    total = ring + f32::ring_bytes(TM);
  }
};

// Shared-memory layout of the tensor-core kernel (byte offsets), the same
// arithmetic as candidate_plan in qinco_torch/ops/kernels.py:
//   stage table | x (R, D) f32 | xh (R, D) f32 | cc (R, Wc) f32 | ids (R, A)
//   int32 | score partials (TM, 16) f32 | one region, overlaid by phase:
//   rnd(xh) (R16, D);  then per tile cand (TM, D), h (TM, De) and one
//   buffer that holds h0 = rnd(cand·P) (TM, De, with in_proj) and the
//   low-rank product (TM, Wc), later the FFN hidden (TM, Dh), all bf16 |
//   the weight ring.
struct CandidateLayout {
  unsigned x, xh, cc, ids, part, u, cand, h, big, lr, ring, total;
  __host__ __device__ CandidateLayout(const CandidateArgs& g, int TM) {
    using tc::align16;
    using tc::ld_of;
    const size_t R = g.R, R16 = (g.R + 15) / 16 * 16, D = g.w.D, De = g.w.De;
    x = tc::kStageBytes;
    xh = x + align16(4 * R * D);
    cc = xh + align16(4 * R * D);
    ids = cc + align16(4 * R * g.w.Wc);
    part = ids + align16(4 * R * g.A);
    u = part + 4 * (size_t)TM * kScoreSlots;
    cand = u;
    h = cand + 2 * (size_t)TM * ld_of(D);
    big = h + 2 * (size_t)TM * ld_of(De);
    lr = big + (g.w.in_proj ? 2 * (size_t)TM * ld_of(De) : 0);
    const size_t h0_lr = lr + (g.w.concat_w2 ? 2 * (size_t)TM * ld_of(g.w.Wc) : 0) - big;
    const size_t hid = 2 * (size_t)TM * ld_of(g.w.Dh);
    const size_t tiles = big - u + (h0_lr > hid ? h0_lr : hid);
    const size_t phase0 = 2 * R16 * ld_of(D);
    ring = u + align16(phase0 > tiles ? phase0 : tiles);
    total = ring + tc::kRingBytes;
  }
};

// Products in the tensor-core kernel's weight stream: the condition half
// once per item, then per tile [in_proj], the codeword half, [concat_w2],
// (U_l, D_l) x L, [out_proj].
__host__ __device__ inline int candidate_stages(const ChainWeights& w) {
  return 1 + (w.in_proj ? 1 : 0) + 1 + (w.concat_w2 ? 1 : 0) + 2 * w.L + (w.out_proj ? 1 : 0);
}

// f32 route: every MLP product in f32 FFMA on the CUDA cores (f32_tile.cuh).
// A block walks the work items blockIdx.x, blockIdx.x + gridDim.x, ...: R
// rows each, their R·A pairs in tiles of TM; pair p = i * A + a.
template <int TM>
__global__ void __launch_bounds__(f32::kBlock, 1)
    candidate_scores_f32_kernel(CandidateArgs g) {
  using namespace f32;
  extern __shared__ __align__(16) unsigned char sm[];
  const ChainWeights& w = g.w;
  const int D = w.D, De = w.De, Dh = w.Dh, Wc = w.Wc, L = w.L, A = g.A, R = g.R;
  const int tid = threadIdx.x;
  const bool low_rank = w.concat_w2 != nullptr, proj = w.out_proj != nullptr;
  const CandidateF32Layout lay(g, TM);
  float* x_s = reinterpret_cast<float*>(sm + lay.x);        // (R, D) targets
  float* cc_s = reinterpret_cast<float*>(sm + lay.cc);      // (R, Wc) xh·W[De:] (+ b)
  int* id_s = reinterpret_cast<int*>(sm + lay.ids);         // (R, A) the pairs' ids
  float* part_s = reinterpret_cast<float*>(sm + lay.part);  // (TM, kSlots) distance partials
  float* xh_s = reinterpret_cast<float*>(sm + lay.xh);      // (R, ldd) beam rows
  float* cand_s = reinterpret_cast<float*>(sm + lay.cand);  // (TM, ldd) fetched codewords
  float* h_s = reinterpret_cast<float*>(sm + lay.h);        // (TM, ldh)
  float* hid_s = reinterpret_cast<float*>(sm + lay.big);    // (TM, ldf) FFN hidden
  float* lr_s = reinterpret_cast<float*>(sm + lay.lr);      // (TM, ldr) low-rank product
  const int ldd = ld_of(D), ldh = ld_of(De), ldf = ld_of(Dh), ldr = ld_of(Wc);
  // h0: cand·P with in_proj (in the big buffer), else the codeword
  float* h0_s = w.in_proj ? hid_s : cand_s;
  const int ld0 = w.in_proj ? ldh : ldd;

  // The weight stream, every weight in the blocked layout: the condition
  // half (concat_w's rows De ..) once per item, then per tile [in_proj],
  // the codeword half, [concat_w2], (U_l, D_l) x L, [out_proj].
  Stage* stages = reinterpret_cast<Stage*>(sm);
  if (tid == 0) {
    const float* cw = static_cast<const float*>(w.concat_w);
    const float* up = static_cast<const float*>(w.ffn_up);
    const float* down = static_cast<const float*>(w.ffn_down);
    const int cstride = (De + D) * kPass;
    int n = 0;
    stages[n++] = {cw + (size_t)De * kPass, D, Wc, cstride};
    if (w.in_proj) stages[n++] = {static_cast<const float*>(w.in_proj), D, De, D * kPass};
    stages[n++] = {cw, De, Wc, cstride};
    if (low_rank) stages[n++] = {static_cast<const float*>(w.concat_w2), Wc, De, Wc * kPass};
    for (int l = 0; l < L; ++l) {
      stages[n++] = {up + l * blocked(De, Dh), De, Dh, De * kPass};
      stages[n++] = {down + l * blocked(Dh, De), Dh, De, Dh * kPass};
    }
    if (proj) stages[n++] = {static_cast<const float*>(w.out_proj), De, D, De * kPass};
  }
  __syncthreads();
  const int n_pairs = R * A, n_items = (g.NF + R - 1) / R;
  Ring ring;
  ring.init(sm + lay.ring, stages, 1, candidate_stages(w),
            (n_pairs + TM - 1) / TM, TM == 64);
  if (tid >= kThreads) {  // the producer warpgroup: its first warp streams the weights
    producer_regs();
    if (tid < kThreads + 32) ring.produce_all((n_items - blockIdx.x + gridDim.x - 1) / gridDim.x);
    return;
  }
  consumer_regs();
  const float* book = static_cast<const float*>(g.codebook);

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int row0 = item * R, n_rows = min(R, g.NF - row0), n_valid = n_rows * A;
    sync();  // the last item's readers of x, xh, cc, ids and the tiles are done

    // ---- x and xh, 4 columns a thread (rows past n_rows are zero); the ids
    const int D4 = D / 4;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    copy4(
        R * D4, [&](int e) { return e / D4 < n_rows ? ld4(g.x + (size_t)row0 * D + 4 * e) : zero; },
        [&](int e, float4 v) { st4(x_s + 4 * e, v); });
    copy4(
        R * D4,
        [&](int e) { return e / D4 < n_rows ? ld4(g.xh + (size_t)row0 * D + 4 * e) : zero; },
        [&](int e, float4 v) { st4(xh_s + (e / D4) * ldd + 4 * (e % D4), v); });
    for (int e = tid; e < n_pairs; e += kThreads)
      id_s[e] = e < n_valid ? g.idx[(size_t)row0 * A + e] : 0;
    // ---- the condition half of the concat layer, once per row: cc =
    // xh·W[De:], plus the bias unless a low-rank factor follows
    stage<TM>(ring, xh_s, ldd, D, Wc, R, [&](int t, int c, float4 v) {
      st4(cc_s + t * Wc + c, low_rank ? v : add4(v, ld4(w.concat_b + c)));
    });

    // ---- the (row, slot) pairs, TM at a time
    for (int p0 = 0; p0 < n_pairs; p0 += TM) {
      const int rows = max(0, min(TM, n_valid - p0));
      sync();  // cc and the ids are in; the tiles' last readers are done
      // an id outside [0, K) fetches zeros, as the one-hot product does
      copy4(
          rows * D4,
          [&](int e) {
            const int id = id_s[p0 + e / D4];
            return (unsigned)id < (unsigned)g.K ? ld4(book + (size_t)id * D + 4 * (e % D4)) : zero;
          },
          [&](int e, float4 v) { st4(cand_s + (e / D4) * ldd + 4 * (e % D4), v); });
      for (int e = tid; e < TM * kSlots; e += kThreads) part_s[e] = 0.f;

      // d = ||x - ((out + cand) + xh)||^2, JAX's order of the f32 adds
      auto score = [&](int t, int c, float4 o) {
        const int i = (p0 + t) / A;
        if (g.res) o = add4(o, ld4(cand_s + t * ldd + c));
        f32::add_score(part_s, t, sub4(ld4(x_s + i * D + c), add4(o, ld4(xh_s + i * ldd + c))));
      };
      // out = h when there is no out_proj: the last product carries the score
      auto h_out = [&](int t, int c, float4 o) {
        if (!proj) score(t, c, o);
      };
      auto cc_of = [&](int t, int c) { return ld4(cc_s + ((p0 + t) / A) * Wc + c); };
      // h = h0 + concat(...), the concat layer's output written to h
      auto concat_out = [&](int t, int c, float4 v) {
        const float4 o = add4(ld4(h0_s + t * ld0 + c), v);
        st4(h_s + t * ldh + c, o);
        if (!proj && L == 0) score(t, c, o);
      };

      if (w.in_proj)  // h0 = cand·P
        stage<TM>(ring, cand_s, ldd, D, De, rows,
                  [&](int t, int c, float4 v) { st4(h0_s + t * ld0 + c, v); });
      if (low_rank) {
        // lr = h0·W[:De] + cc;  h = h0 + (lr·W2 + b)
        stage<TM>(ring, h0_s, ld0, De, Wc, rows, [&](int t, int c, float4 v) {
          st4(lr_s + t * ldr + c, add4(v, cc_of(t, c)));
        });
        stage<TM>(ring, lr_s, ldr, Wc, De, rows, [&](int t, int c, float4 v) {
          concat_out(t, c, add4(v, ld4(w.concat_b + c)));
        });
      } else {
        // h = h0 + (h0·W[:De] + cc)
        stage<TM>(ring, h0_s, ld0, De, De, rows,
                  [&](int t, int c, float4 v) { concat_out(t, c, add4(v, cc_of(t, c))); });
      }
      ffn<TM>(ring, h_s, ldh, hid_s, ldf, L, De, Dh, rows, h_out);
      if (proj) stage<TM>(ring, h_s, ldh, De, D, rows, score);
      sync();
      // ---- the pairs' sums
      for (int t = tid; t < rows; t += kThreads) {
        const int p = p0 + t;
        const float s = f32::sum_score(part_s, t);
        g.out[(size_t)row0 * A + p] = g.pack ? pack_id(s, id_s[p]) : s;
      }
    }
  }
}

// bf16 route: every MLP product on the tensor cores.  A block walks the
// work items blockIdx.x, blockIdx.x + gridDim.x, ...: R rows each, their
// R·A pairs in tiles of TM = 32·MT; pair p = i * A + a.
template <int MT>
__global__ void __launch_bounds__(tc::kTcThreads, 1) candidate_scores_tc_kernel(CandidateArgs g) {
  using namespace tc;
  constexpr int TM = 32 * MT;
  extern __shared__ __align__(16) unsigned char sm[];
  const ChainWeights& w = g.w;
  const int D = w.D, De = w.De, Dh = w.Dh, Wc = w.Wc, L = w.L, A = g.A, R = g.R;
  const int tid = threadIdx.x;
  const bool low_rank = w.concat_w2 != nullptr, proj = w.out_proj != nullptr;
  const CandidateLayout lay(g, TM);
  float* x_s = reinterpret_cast<float*>(sm + lay.x);    // (R, D) targets
  float* xh_s = reinterpret_cast<float*>(sm + lay.xh);  // (R, D) beam rows
  float* cc_s = reinterpret_cast<float*>(sm + lay.cc);  // (R, Wc) rnd(xh)·W[De:] (+ b)
  int* id_s = reinterpret_cast<int*>(sm + lay.ids);     // (R, A) the pairs' ids
  float* part_s = reinterpret_cast<float*>(sm + lay.part);  // (TM, 16) distance partials
  bf16* xh_b = reinterpret_cast<bf16*>(sm + lay.u);       // (R16, D) rnd(xh)
  bf16* cand_b = reinterpret_cast<bf16*>(sm + lay.cand);  // (TM, D) fetched codewords
  bf16* h_b = reinterpret_cast<bf16*>(sm + lay.h);        // (TM, De)
  bf16* hid_b = reinterpret_cast<bf16*>(sm + lay.big);    // (TM, Dh) FFN hidden
  bf16* lr_b = reinterpret_cast<bf16*>(sm + lay.lr);      // (TM, Wc) low-rank product
  const int ldd = ld_of(D), ldh = ld_of(De), ldf = ld_of(Dh), ldr = ld_of(Wc);
  // h0: rnd(cand·P) with in_proj (in the big buffer), else the codeword
  bf16* h0_b = w.in_proj ? hid_b : cand_b;
  const int ld0 = w.in_proj ? ldh : ldd;

  WStage* stages = reinterpret_cast<WStage*>(sm);
  if (tid == 0) {
    const bf16* cw = static_cast<const bf16*>(w.concat_w);
    const bf16* up = static_cast<const bf16*>(w.ffn_up);
    const bf16* down = static_cast<const bf16*>(w.ffn_down);
    int n = 0;
    stages[n++] = {cw + (size_t)De * Wc, D, Wc};
    if (w.in_proj) stages[n++] = {static_cast<const bf16*>(w.in_proj), D, De};
    stages[n++] = {cw, De, Wc};
    if (low_rank) stages[n++] = {static_cast<const bf16*>(w.concat_w2), Wc, De};
    for (int l = 0; l < L; ++l) {
      stages[n++] = {up + (size_t)l * De * Dh, De, Dh};
      stages[n++] = {down + (size_t)l * Dh * De, Dh, De};
    }
    if (proj) stages[n++] = {static_cast<const bf16*>(w.out_proj), De, D};
  }
  __syncthreads();
  const int n_pairs = R * A, n_items = (g.NF + R - 1) / R;
  WeightRing ring;
  ring.init(reinterpret_cast<bf16*>(sm + lay.ring), stages, 1, candidate_stages(w),
            (n_pairs + TM - 1) / TM);
  const bf16* book = static_cast<const bf16*>(g.codebook);

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int row0 = item * R, n_rows = min(R, g.NF - row0), n_valid = n_rows * A;
    __syncthreads();  // the last item's readers of x, xh, cc, ids and the region are done

    // ---- x, xh (f32) and rnd(xh), 4 columns a thread, 4 loads in flight; the ids
    for (int e0 = tid; e0 < R * D / 4; e0 += 4 * kTcThreads) {
      float4 xv[4], hv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * kTcThreads, i = e / (D / 4), c = 4 * (e - i * (D / 4));
        xv[u] = hv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (e < R * D / 4 && i < n_rows) {
          hv[u] = *reinterpret_cast<const float4*>(g.xh + (size_t)(row0 + i) * D + c);
          xv[u] = *reinterpret_cast<const float4*>(g.x + (size_t)(row0 + i) * D + c);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * kTcThreads, i = e / (D / 4), c = 4 * (e - i * (D / 4));
        if (e >= R * D / 4) break;
        st_bf2(xh_b + i * ldd + c, hv[u].x, hv[u].y);
        st_bf2(xh_b + i * ldd + c + 2, hv[u].z, hv[u].w);
        *reinterpret_cast<float4*>(x_s + i * D + c) = xv[u];
        *reinterpret_cast<float4*>(xh_s + i * D + c) = hv[u];
      }
    }
    for (int e = tid; e < n_pairs; e += kTcThreads)
      id_s[e] = e < n_valid ? g.idx[(size_t)row0 * A + e] : 0;
    // ---- the condition half of the concat layer, once per row: cc =
    // rnd(xh)·W[De:], plus the bias unless a low-rank factor follows
    mma_stage<MT>(ring, xh_b, ldd, D, Wc, R, [&](int t, int c, float v0, float v1) {
      if (!low_rank) {
        v0 += w.concat_b[c];
        v1 += w.concat_b[c + 1];
      }
      cc_s[t * Wc + c] = v0;
      cc_s[t * Wc + c + 1] = v1;
    });

    // ---- the (row, slot) pairs, TM at a time
    for (int p0 = 0; p0 < n_pairs; p0 += TM) {
      const int rows = max(0, min(TM, n_valid - p0));
      __syncthreads();  // cc and the ids are in; the region's last readers are done
      // fetch the codewords with cp.async, all of the tile's in flight at
      // once; an id outside [0, K) fetches zeros, as the one-hot product does
      for (int e = tid; e < rows * (D / 8); e += kTcThreads) {
        const int t = e / (D / 8), c = 8 * (e - t * (D / 8)), id = id_s[p0 + t];
        bf16* dst = cand_b + t * ldd + c;
        if ((unsigned)id < (unsigned)g.K)
          cp_async16(smem_addr(dst), book + (size_t)id * D + c);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
      cp_async_commit();
      cp_async_wait<0>();  // the first product's ring acquire synchronises the block
      for (int e = tid; e < TM * kScoreSlots; e += kTcThreads) part_s[e] = 0.f;

      // d = ||x - ((out + cand) + xh)||^2, JAX's order of the f32 adds;
      // each (t, c, c + 1) of out adds its two squares to its slot
      auto score = [&](int t, int c, float o0, float o1) {
        const int i = (p0 + t) / A;
        if (g.res) {
          const float2 cv = ld_bf2(cand_b + t * ldd + c);
          o0 += cv.x;
          o1 += cv.y;
        }
        const float* xr = x_s + i * D + c;
        const float* hr = xh_s + i * D + c;
        add_score(part_s, t, xr[0] - (o0 + hr[0]), xr[1] - (o1 + hr[1]));
      };
      // out = h when there is no out_proj: the last bf16 product carries the score
      auto h_out = [&](int t, int c, float o0, float o1) {
        if (!proj) score(t, c, o0, o1);
      };
      auto concat_out = [&](int t, int c, float o0, float o1) {
        if (!proj && L == 0) score(t, c, o0, o1);
      };
      auto cc_of = [&](int t, int c) { return cc_s + min((p0 + t) / A, R - 1) * Wc + c; };
      const auto same = [](int, int, float v0, float v1) { return make_float2(v0, v1); };

      // h0 = rnd(rnd(cand)·P)
      if (w.in_proj)
        mma_stage_bf16<MT>(ring, cand_b, ldd, D, De, rows, h0_b, ld0, nullptr, 0, same, NoLast{});
      if (low_rank) {
        // lr = rnd(h0·W[:De] + cc);  h = rnd(h0 + rnd(lr·W2 + b))
        mma_stage_bf16<MT>(
            ring, h0_b, ld0, De, Wc, rows, lr_b, ldr, nullptr, 0,
            [&](int t, int c, float v0, float v1) {
              const float* q = cc_of(t, c);
              return make_float2(v0 + q[0], v1 + q[1]);
            },
            NoLast{});
        mma_stage_bf16<MT>(
            ring, lr_b, ldr, Wc, De, rows, h_b, ldh, h0_b, ld0,
            [&](int, int c, float v0, float v1) {
              return make_float2(rnd<true>(v0 + w.concat_b[c]), rnd<true>(v1 + w.concat_b[c + 1]));
            },
            concat_out);
      } else {
        // h = rnd(h0 + rnd(h0·W[:De] + cc))
        mma_stage_bf16<MT>(
            ring, h0_b, ld0, De, De, rows, h_b, ldh, h0_b, ld0,
            [&](int t, int c, float v0, float v1) {
              const float* q = cc_of(t, c);
              return make_float2(rnd<true>(v0 + q[0]), rnd<true>(v1 + q[1]));
            },
            concat_out);
      }
      ffn_stages<MT>(ring, h_b, ldh, hid_b, ldf, L, De, Dh, rows, h_out);
      if (proj) mma_stage<MT>(ring, h_b, ldh, De, D, rows, score);
      __syncthreads();
      // ---- the pairs' sums
      for (int t = tid; t < rows; t += kTcThreads) {
        const int p = p0 + t;
        const float s = sum_score(part_s, t);
        g.out[(size_t)row0 * A + p] = g.pack ? pack_id(s, id_s[p]) : s;
      }
    }
  }
  ring.drain();
}

}  // namespace qt

extern "C" int qt_candidate_scores(const float* x, const float* xh, const int* idx,
                                   const void* codebook, const void* in_proj, const void* concat_w,
                                   const void* concat_w2, const float* concat_b,
                                   const void* ffn_up, const void* ffn_down, const void* out_proj,
                                   float* out, int NF, int A, int D, int K, int De, int Dh, int L,
                                   int Wc, int pack, int tm, int rows, int blocks, int smem,
                                   int bf16, int res, void* stream) {
  using namespace qt;
  if (NF == 0 || A == 0) return 0;
  const ChainWeights w{in_proj, concat_w, concat_w2, concat_b, ffn_up, ffn_down, out_proj,
                       D,       De,       Dh,        L,        Wc};
  const CandidateArgs a{x, xh, idx, codebook, w, out, NF, A, K, pack, res, rows};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (candidate_stages(w) > tc::kMaxStages || (size_t)smem < CandidateLayout(a, tm).total ||
        rows < 1 || (tm != 64 && tm != 128))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(tm == 128 ? tc::launch_tc(candidate_scores_tc_kernel<4>, blocks, smem, s, a)
                                      : tc::launch_tc(candidate_scores_tc_kernel<2>, blocks, smem, s, a));
  }
  // f32: the plan's tile, rows a work item and shared memory, or nothing
  if (candidate_stages(w) > f32::kMaxStages || (size_t)smem < CandidateF32Layout(a, tm).total ||
      rows < 1 || blocks < 1 || (tm != 64 && tm != 32) || (D | De | Dh | Wc) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(tm == 64
                              ? f32::launch(candidate_scores_f32_kernel<64>, blocks, smem, s, a)
                              : f32::launch(candidate_scores_f32_kernel<32>, blocks, smem, s, a));
}
