// Selected-scores kernel: exact top-A candidates, scored.
//
// Replaces: qinco_tpu/ops/pallas_kernels.py, selected_scores_pallas
// (:880), body _selected_scores_kernel (:625), both of its routes:
//   - in-kernel top-A (sub_codebook given, vals null): the substep
//     distances over K and an exact ascending top-A per row;
//   - external vals (vals given, B2'): the top-A was taken outside, and
//     the kernel reads each slot's id from the low bits of its packed
//     value.
//
// What it computes, per beam row (x broadcast over the F_in rows of its
// vector):
//   r      = x - xh
//   [in-kernel top-A]  d_sub = ||C_k||^2 - 2 rnd(C_k)·rnd(r) for every k;
//                      the A smallest packed d_sub, ascending
//   for each slot's id:  cand = table[id][:D] (compute dtype)
//     lean table (spec.fast):  h = rnd(cand·wfold + rnd(xh)·W2 + b)
//     folded table:            h = rnd(table[id][D:] + rnd(xh)·W2 + b)
//     L times: up = rnd(relu(h·U_l)); h = rnd(h + rnd(up·D_l))
//     out = h·P_out (f32) or h
//     d = ||r - out - cand||^2, packed with id  ->  out[row][slot]
// rnd() rounds to the compute dtype; every product accumulates in f32.
//
// What bounds it on the card: operations.  At qinco2-S a beam row costs
// about 4.8 MFLOP (the A slots' MLP is 98% of it) against about 0.6 KB
// of input and output, far above the H100's ridge in bf16 (~295
// FLOP/byte) and in f32 on the CUDA cores (~20 FLOP/byte).
//
// What the design does about it.  Both routes are persistent blocks, one
// an SM, over work items of R beam rows (the wrapper's selected_plan picks
// R so that a launch has enough items to fill the card): per item r = x -
// xh, the condition product once, the top-A; then tiles of TM (row, slot)
// pairs through the lean fetch's product (or the folded table's h slice),
// the FFN blocks and out_proj, with the step's weights streamed through a
// ring in shared memory and the distance summed in the last
// product's epilogue into fixed-owner partials.  Nothing but the packed
// (rows, A) result goes back to device memory.  The substep tile (K x R)
// and a warp-per-row min-and-remove give the exact top-A on the CUDA cores
// in f32 on both routes, so the candidate set and its order are the same.
//   bf16 (the parity profile): selected_scores_tc_kernel (selected_tc.cuh,
//   its full cut), every MLP product on wgmma (wgmma.cuh), activations
//   and weights both in shared memory in the core-matrix layout, the
//   weights (in the slab layout of kernels.wg_blocked) streamed through a
//   ring of 4 to 16 slabs of 64 x 128 bf16 by bulk copies from four
//   producer threads, with full and empty mbarriers and no block barrier
//   per slab.  A tile is 128 pairs where Dh is 2 or 3 passes (qinco2-S,
//   -M, -L) and its cand and h fit in shared memory: each of the two
//   consumer warpgroups runs 64 rows on whole 128-column passes and holds
//   their FFN hidden in registers (the up product's sums, packed to bf16,
//   are the A of the down product), which frees the 96 KB a (128, 384)
//   hidden would take at qinco2-M and -L.  Else a tile is 64 pairs, the
//   hidden in shared memory: both warpgroups run the 64 rows, each on one
//   64-column half of every pass.  Where
//   every SM has a work item the blocks run in clusters of 2 that share
//   each slab by multicast, so a weight byte read from L2 feeds 2·TM
//   pairs: 256.  Measured on an H100 (PERF.md §6): a bulk copy holds its
//   thread about 650 cycles whatever its size, so 8 KB slabs from one
//   thread held the ring to 12.5 B a cycle an SM and 16 KB slabs from
//   four threads lift it past what the products take; at 64-pair tiles
//   clusters of 4 ran 12% slower than 2, the kernel not being bound by L2.
//   Where the rows are too wide for that (D = 768 at qinco2-M and -L: cand,
//   h and the hidden of 64 pairs with r and the ring take more than a
//   block's shared memory), the wrapper's plan takes D in column passes:
//   the products D -> De read their A a chunk of columns at a time,
//   filled again from L2 for every pass over their output columns, and
//   the distance reads the codewords again from the table (L2).
//   f32 (pallas=true's external vals; fast_encode=true pallas=true at f32
//   in-kernel): selected_scores_f32_kernel, every MLP product in IEEE f32
//   FFMA on the CUDA cores (f32_tile.cuh: TF32 would be a different
//   result), activations f32 in shared memory, an 8 x 8 (256-column
//   passes) or 8 x 4 register tile of sums a thread, the weights (in the
//   blocked layout) streamed by bulk copies from a producer warp, so the
//   8 math warps meet at no block barrier per weight slab.  Each tile
//   streams the step's weights from L2: a weight byte feeds 32 FLOP at 64
//   pairs a tile (qinco2-S), so the f32 peak would draw 2.1 TB/s of L2
//   across the card, and 16 FLOP at 32 pairs (qinco2-M and -L, where 64
//   rows of f32 activations do not fit), 4.2 TB/s: those widths wait on
//   the stream.
#include "f32_tile.cuh"
#include "selected_tc.cuh"

namespace qt {

// Shared-memory layout of the f32 kernel (byte offsets), the same
// arithmetic as selected_plan in qinco_torch/ops/kernels.py:
//   stage table | r (R, D) | ccb (R, De) | vals (R, A) | score partials
//   (TM, 32) | one region, overlaid by phase: xh (TM, ld D), the condition
//   product's A;  then the substep tile (K, R + 1);  then per tile cand
//   (TM, ld D), h (TM, ld De) and the FFN hidden (TM, ld Dh) | the weight
//   ring (f32::ring_bytes).  All f32; ld w = w + 4.
struct SelectedF32Layout {
  unsigned r, ccb, val, part, u, cand, h, big, ring, total;
  __host__ __device__ SelectedF32Layout(const SelectedArgs& g, int TM, bool topa) {
    using f32::ld_of;
    using tc::align16;
    const size_t R = g.R, T = TM;
    r = f32::kStageBytes;
    ccb = r + align16(4 * R * g.D);
    val = ccb + align16(4 * R * g.De);
    part = val + align16(4 * R * g.A);
    u = part + 4 * T * f32::kSlots;
    const size_t phase0 = 4 * T * ld_of(g.D);
    const size_t substep = topa ? 4 * (size_t)g.K * (R + 1) : 0;
    cand = u;
    h = cand + 4 * T * ld_of(g.D);
    big = h + 4 * T * ld_of(g.De);
    const size_t tiles = big + 4 * T * ld_of(g.Dh) - u;
    size_t region = phase0 > substep ? phase0 : substep;
    region = region > tiles ? region : tiles;
    ring = u + align16(region);
    total = ring + f32::ring_bytes(TM);
  }
};

// f32 route: every MLP product in f32 FFMA on the CUDA cores (f32_tile.cuh).
// A block walks the work items blockIdx.x, blockIdx.x + gridDim.x, ...: R
// beam rows each, their R·A pairs in tiles of TM; pair p = i * A + a.
template <int TM>
__global__ void __launch_bounds__(f32::kBlock, 1)
    selected_scores_f32_kernel(SelectedArgs g) {
  using namespace f32;
  extern __shared__ __align__(16) unsigned char sm[];
  const int D = g.D, De = g.De, Dh = g.Dh, K = g.K, A = g.A, Wt = g.Wt, R = g.R, L = g.L;
  const int tid = threadIdx.x;
  const bool topa = g.vals == nullptr, proj = g.out_proj != nullptr;
  const SelectedF32Layout lay(g, TM, topa);
  float* r_s = reinterpret_cast<float*>(sm + lay.r);        // (R, D) residual target
  float* ccb_s = reinterpret_cast<float*>(sm + lay.ccb);    // (R, De) xh·W2 + b
  float* val_s = reinterpret_cast<float*>(sm + lay.val);    // (R, A) packed top-A values
  float* part_s = reinterpret_cast<float*>(sm + lay.part);  // (TM, kSlots) distance partials
  float* xh_s = reinterpret_cast<float*>(sm + lay.u);       // (TM, ldd) beam rows
  float* S_s = reinterpret_cast<float*>(sm + lay.u);        // (K, R + 1) substep tile
  float* cand_s = reinterpret_cast<float*>(sm + lay.cand);  // (TM, ldd) fetched codewords
  float* h_s = reinterpret_cast<float*>(sm + lay.h);        // (TM, ldh)
  float* hid_s = reinterpret_cast<float*>(sm + lay.big);    // (TM, ldf) FFN hidden
  const int ldd = ld_of(D), ldh = ld_of(De), ldf = ld_of(Dh);
  const float* table = static_cast<const float*>(g.table);

  // The weight stream: the condition product once per item, then per tile
  // [wfold], (U_l, D_l) x L, [out_proj]; every weight in the blocked layout.
  Stage* stages = reinterpret_cast<Stage*>(sm);
  if (tid == 0) {
    const float* up = static_cast<const float*>(g.ffn_up);
    const float* down = static_cast<const float*>(g.ffn_down);
    int n = 0;
    stages[n++] = {static_cast<const float*>(g.w2), D, De, D * kPass};
    if (g.wfold) stages[n++] = {static_cast<const float*>(g.wfold), D, De, D * kPass};
    for (int l = 0; l < L; ++l) {
      stages[n++] = {up + l * blocked(De, Dh), De, Dh, De * kPass};
      stages[n++] = {down + l * blocked(Dh, De), Dh, De, Dh * kPass};
    }
    if (proj) stages[n++] = {static_cast<const float*>(g.out_proj), De, D, De * kPass};
  }
  __syncthreads();
  const int n_pairs = R * A, n_items = (g.NF + R - 1) / R;
  Ring ring;
  ring.init(sm + lay.ring, stages, 1, selected_stages(g),
            (n_pairs + TM - 1) / TM, TM == 64);
  if (tid >= kThreads) {  // the producer warpgroup: its first warp streams the weights
    producer_regs();
    if (tid < kThreads + 32) ring.produce_all((n_items - blockIdx.x + gridDim.x - 1) / gridDim.x);
    return;
  }
  consumer_regs();

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int row0 = item * R, n_rows = min(R, g.NF - row0), n_valid = n_rows * A;
    sync();  // the last item's readers of r, vals and the region are done

    // ---- xh, then r = x - xh (each thread subtracts its own xh), 4
    // columns a thread; rows past n_rows are zero
    const int D4 = D / 4;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    copy4(
        R * D4,
        [&](int e) { return e / D4 < n_rows ? ld4(g.xh + (size_t)row0 * D + 4 * e) : zero; },
        [&](int e, float4 v) { st4(xh_s + (e / D4) * ldd + 4 * (e % D4), v); });
    copy4(
        R * D4,
        [&](int e) {
          const int i = e / D4;
          return i < n_rows ? ld4(g.x + (size_t)((row0 + i) / g.F_in) * D + 4 * (e % D4)) : zero;
        },
        [&](int e, float4 v) {
          st4(r_s + 4 * e, sub4(v, ld4(xh_s + (e / D4) * ldd + 4 * (e % D4))));
        });
    // ---- the condition half of the concat layer: ccb = xh·W2 + b
    stage<TM>(ring, xh_s, ldd, D, De, R, [&](int t, int c, float4 v) {
      st4(ccb_s + t * De + c, add4(v, ld4(g.concat_b + c)));
    });
    sync();  // ccb is in; the region's readers of xh are done

    if (!topa) {
      // ---- external top-A: the packed values carry the ids
      for (int e = tid; e < R * A; e += kThreads)
        val_s[e] = e / A < n_rows ? g.vals[(size_t)row0 * A + e] : 0.f;
    } else {
      // ---- packed substep partial distances (K, R) and the exact top-A;
      // r is its own rounding to f32
      substep_rows(r_s, R, D, g.sub_t, g.cn2, K, S_s);
      sync();
      top_a_rows(S_s, R, K, A, val_s);
    }

    // ---- the (row, slot) pairs, TM at a time
    for (int p0 = 0; p0 < n_pairs; p0 += TM) {
      const int rows = max(0, min(TM, n_valid - p0));
      sync();  // vals are in; the region's last readers are done
      const auto row_of = [&](int t) { return table + (size_t)unpack_id(val_s[p0 + t]) * Wt; };
      copy4(
          rows * D4, [&](int e) { return ld4(row_of(e / D4) + 4 * (e % D4)); },
          [&](int e, float4 v) { st4(cand_s + (e / D4) * ldd + 4 * (e % D4), v); });
      if (!g.wfold) {  // the folded table's h slice: h = table[id][D:] + ccb
        const int De4 = De / 4;
        copy4(
            rows * De4, [&](int e) { return ld4(row_of(e / De4) + D + 4 * (e % De4)); },
            [&](int e, float4 v) {
              const int t = e / De4, c = 4 * (e % De4);
              st4(h_s + t * ldh + c, add4(v, ld4(ccb_s + ((p0 + t) / A) * De + c)));
            });
      }
      for (int e = tid; e < TM * kSlots; e += kThreads) part_s[e] = 0.f;
      if (g.wfold)  // the lean fetch: h = cand·wfold + ccb
        stage<TM>(ring, cand_s, ldd, D, De, rows, [&](int t, int c, float4 v) {
          st4(h_s + t * ldh + c, add4(v, ld4(ccb_s + ((p0 + t) / A) * De + c)));
        });
      // d = ||r - out - cand||^2: each (t, c .. c + 3) of out adds its
      // squares to the thread's slot; out is the last product's output
      auto score = [&](int t, int c, float4 o) {
        float4 d = sub4(ld4(r_s + ((p0 + t) / A) * D + c), o);
        if (g.res) d = sub4(d, ld4(cand_s + t * ldd + c));
        f32::add_score(part_s, t, d);
      };
      if (proj) {
        ffn<TM>(ring, h_s, ldh, hid_s, ldf, L, De, Dh, rows, NoLast{});
        stage<TM>(ring, h_s, ldh, De, D, rows, score);
      } else {
        ffn<TM>(ring, h_s, ldh, hid_s, ldf, L, De, Dh, rows, score);
      }
      sync();
      if (!proj && L == 0) {  // out = h, no product left to carry the sums
        for (int t = tid; t < rows; t += kThreads)
          for (int c = 0; c < D; c += 4) score(t, c, ld4(h_s + t * ldh + c));
        sync();
      }
      // ---- the slots' sums, packed with the slot's id
      for (int t = tid; t < rows; t += kThreads) {
        const int p = p0 + t;
        g.out[(size_t)row0 * A + p] = pack_id(f32::sum_score(part_s, t), unpack_id(val_s[p]));
      }
    }
  }
}

}  // namespace qt

extern "C" int qt_selected_scores(const float* x, const float* xh, const float* vals,
                                  const float* sub_t, const float* cn2, const void* table,
                                  const void* wfold, const void* w2, const float* concat_b,
                                  const void* ffn_up, const void* ffn_down, const void* out_proj,
                                  float* out, int NF, int F_in, int D, int K, int De, int Dh,
                                  int L, int A, int Wt, int tm, int rows, int blocks, int smem,
                                  int cluster, int kc, int bf16, int res, void* stream) {
  using namespace qt;
  if (NF == 0) return 0;
  const SelectedArgs a{x,      xh,       vals,     sub_t, cn2, table, wfold, w2, concat_b,
                       ffn_up, ffn_down, out_proj, out,   NF,  F_in,  D,     K,  De,
                       Dh,     L,        A,        Wt,    res, rows,  kc};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16 && kc < D) {
    // the D-passed plan: 64-pair tiles, chunks of whole slabs
    if (selected_stages(a) > tc::kMaxStages || tm != 64 || kc < wg::kSlabK ||
        kc % wg::kSlabK || !out_proj || rows < 1 || rows > kRows ||
        (cluster != 1 && cluster != 2 && cluster != 4) || blocks < cluster ||
        blocks % cluster || SelectedLayout(a, tm, vals == nullptr, true).slots(smem, 0) < wg::kMinRing)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_selected(selected_scores_tc_kernel<1, SelCut::kFull, true>,
                                            blocks, smem, cluster, s, a));
  }
  if (kc != D) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16) {
    // the plan's tile (128 pairs: the hidden's 2 or 3 passes in
    // registers), rows a work item, cluster and shared memory (at least
    // wg::kMinRing slots of the ring), or nothing
    const int hp = hidden_passes(Dh);
    if (selected_stages(a) > tc::kMaxStages || (tm != 64 && (tm != 128 || hp == 0)) ||
        rows < 1 || rows > kRows || (cluster != 1 && cluster != 2 && cluster != 4) ||
        blocks < cluster || blocks % cluster ||
        SelectedLayout(a, tm, vals == nullptr).slots(smem, 0) < wg::kMinRing)
      return static_cast<int>(cudaErrorInvalidValue);
    const auto kernel = tm == 64  ? selected_scores_tc_kernel<1, SelCut::kFull>
                        : hp == 2 ? selected_scores_tc_kernel<2, SelCut::kFull, false, 2>
                                  : selected_scores_tc_kernel<2, SelCut::kFull, false, 3>;
    return static_cast<int>(launch_selected(kernel, blocks, smem, cluster, s, a));
  }
  // f32: the plan's tile, rows a work item and shared memory, or nothing
  if (selected_stages(a) > f32::kMaxStages ||
      (size_t)smem < SelectedF32Layout(a, tm, vals == nullptr).total || rows < 1 ||
      rows > kRows || blocks < 1 || (tm != 64 && tm != 32) || (D | De | Dh | Wt) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(tm == 64
                              ? f32::launch(selected_scores_f32_kernel<64>, blocks, smem, s, a)
                              : f32::launch(selected_scores_f32_kernel<32>, blocks, smem, s, a));
}
