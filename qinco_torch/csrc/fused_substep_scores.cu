// Fused-substep scores: binned argmin selection, scored through the fused
// per-codeword table (the speed profile).
//
// Replaces: qinco_tpu/ops/pallas_kernels.py, fused_substep_scores_pallas
// (:483), body _fused_substep_kernel (:198), both of its forms (spec.perbin
// and the blocked form compute the same function).
//
// What it computes, per beam row (x broadcast over the F_in rows of its
// vector), with the K codewords split into A contiguous bins of G = K/A:
//   r      = x - xh
//   d_sub  = ||C_k||^2 - 2 rnd(C_k)·rnd(r), packed with k, for every k
//   slot a = the float minimum of bin a's G packed values (its id in the
//            low bits).  The slot IS the bin: slot order is bin order,
//            not an ascending rank.
//   per slot, from the winner's row T of the fused table (compute dtype):
//     cand = T[:D]
//     fold_up  [C | h_cand | up_cand]:
//       ccb = rnd(xh)·W2 + b,  up_cond = rnd(ccb)·U_0   (once per row)
//       h = rnd(T_h + ccb);  up = rnd(relu(T_up + up_cond))
//       h = rnd(h + rnd(up·D_0));  FFN blocks 1 .. L-1
//     folded W1 [C | h_cand]:  h = rnd(T_h + ccb);  FFN blocks 0 .. L-1
//     low rank [C | (C·P) | C·P·W1] (QINCo-LR):
//       lr = rnd(T_w1 + rnd(xh)·W2);  h = rnd(h0 + rnd(lr·W2_lr + b))
//       with h0 = T_cp (or cand without in_proj);  FFN blocks 0 .. L-1
//     out = h·P_out (f32) or h;  d = ||r - out - cand||^2, packed with id
// rnd() rounds to the compute dtype; every product accumulates in f32.
//
// What bounds it on the card: operations.  At qinco2-S with fold_up a
// beam row costs about 3.3 MFLOP (the slots' down-projection and second
// FFN block are 95% of it) against about 0.6 KB of input and output.
//
// What the design does about it.  bf16 (the speed profile):
// fused_substep_tc_kernel (fused_tc.cuh, its full cut), persistent blocks
// over work items of R beam rows (the wrapper's fused_plan picks R so that
// a launch has enough items to fill the card), every MLP product on the
// tensor cores (tc.cuh): the
// condition product (and with fold_up its product with U_0) once per
// item, then tiles of TM (row, slot) pairs through the rest of the MLP,
// activations as bf16 in shared memory, weights streamed through a
// cp.async ring.  The substep tile is the selected-scores kernel's
// (step_tc.cuh: same f32 sums in the same order on the CUDA cores), then
// a one-pass bin minimum.  The fused table (256 x 512 bf16 = 256 KB at
// qinco2-S) stays in L2: each tile fetches its winners' rows straight into
// the tile buffers with 16-byte loads, 4 in flight a thread, applying the
// row's condition terms on the way.  The distance is summed in the last
// product's epilogue into fixed-owner partials; only the packed (rows, A)
// result is written.
//   f32 (encode_profile=speed compute_dtype=float32, pallas=true
//   fused_substep=true): fused_substep_f32_kernel, the same walk over work
//   items with every MLP product in IEEE f32 FFMA on the CUDA cores
//   (f32_tile.cuh: TF32 would be a different result), activations f32 in
//   shared memory, the weights (in the blocked layout) streamed by bulk
//   copies from a producer warp.  f32 doubles every activation buffer; the
//   tile keeps no codeword buffer (the score reads the codeword from the
//   table in L2), so an item holds 32 rows at the qinco2-S widths beside a
//   64-pair tile and 16 at the qinco2-M and -L widths beside a 32-pair
//   tile.  The winners' table rows (256 x 512 f32 = 512 KB at qinco2-S,
//   in L2) come in by bulk copies, one a slice of a row, that complete on
//   an mbarrier; a pass over the tile then adds the rows' condition terms.
#include "f32_tile.cuh"
#include "fused_tc.cuh"

namespace qt {

// Shared-memory layout of the f32 kernel (byte offsets), the same
// arithmetic as fused_plan in qinco_torch/ops/kernels.py:
//   stage table | the fetch's mbarrier (16 bytes) | r (R, D) | ccb (R, Wc) |
//   up_cond (R, Dh) with fold_up |
//   bin minima (R, A) | score partials (TM, 32) | one region, overlaid by
//   phase: xh (TM, ld D) and, with fold_up, ccb (TM, ld Wc), the head
//   products' A;  then the substep tile (K, R + 1);  then per tile h (TM,
//   ld De) and one buffer that holds h0 (TM, ld De, low rank with in_proj)
//   and lr (TM, ld Wc, low rank), or up (TM, ld Dh) with fold_up, later the
//   FFN hidden (TM, ld Dh) | the weight ring (f32::ring_bytes).  All f32;
//   ld w = w + 4.  The codeword is read from the table in L2 where it is
//   used (the score, and h0 of the low-rank layout without in_proj).
struct FusedF32Layout {
  unsigned bar, r, ccb, upc, val, part, u, h, big, lr, ring, total;
  __host__ __device__ FusedF32Layout(const FusedArgs& g, int TM) {
    using f32::ld_of;
    using tc::align16;
    const size_t R = g.R, T = TM, D = g.D, De = g.De, Wc = g.Wc;
    const bool fold_up = g.off_up > 0, low_rank = g.concat_w2 != nullptr;
    bar = f32::kStageBytes;
    r = bar + 16;
    ccb = r + align16(4 * R * D);
    upc = ccb + align16(4 * R * Wc);
    val = upc + (fold_up ? align16(4 * R * g.Dh) : 0);
    part = val + align16(4 * R * g.A);
    u = part + 4 * T * f32::kSlots;
    const size_t phase0 = 4 * T * (ld_of(D) + (fold_up ? ld_of(Wc) : 0));
    const size_t substep = 4 * (size_t)g.K * (R + 1);
    h = u;
    big = h + 4 * T * ld_of(De);
    lr = big + (low_rank && g.off_h > 0 ? 4 * T * ld_of(De) : 0);
    const size_t h0_lr = lr + (low_rank ? 4 * T * ld_of(Wc) : 0) - big;
    const size_t hid = 4 * T * ld_of(g.Dh);
    const size_t tiles = big - u + (h0_lr > hid ? h0_lr : hid);
    size_t region = phase0 > substep ? phase0 : substep;
    region = region > tiles ? region : tiles;
    ring = u + align16(region);
    total = ring + f32::ring_bytes(TM);
  }
};

// f32 route: every MLP product in f32 FFMA on the CUDA cores (f32_tile.cuh).
// A block walks the work items blockIdx.x, blockIdx.x + gridDim.x, ...: R
// beam rows each, their R·A (row, slot) pairs in tiles of TM; pair p =
// i * A + a.
template <int TM>
__global__ void __launch_bounds__(f32::kBlock, 1) fused_substep_f32_kernel(FusedArgs g) {
  using namespace f32;
  extern __shared__ __align__(16) unsigned char sm[];
  const int D = g.D, De = g.De, Dh = g.Dh, K = g.K, A = g.A, Wt = g.Wt, Wc = g.Wc, L = g.L;
  const int R = g.R, G = K / A, tid = threadIdx.x;
  const bool fold_up = g.off_up > 0, low_rank = g.concat_w2 != nullptr, proj = g.out_proj != nullptr;
  const FusedF32Layout lay(g, TM);
  float* r_s = reinterpret_cast<float*>(sm + lay.r);        // (R, D) residual target
  float* ccb_s = reinterpret_cast<float*>(sm + lay.ccb);    // (R, Wc) xh·W2 (+ b)
  float* upc_s = reinterpret_cast<float*>(sm + lay.upc);    // (R, Dh) ccb·U_0, fold_up
  float* val_s = reinterpret_cast<float*>(sm + lay.val);    // (R, A) packed bin minima
  float* part_s = reinterpret_cast<float*>(sm + lay.part);  // (TM, kSlots) distance partials
  const int ldd = ld_of(D), ldh = ld_of(De), ldf = ld_of(Dh), ldr = ld_of(Wc);
  float* xh_s = reinterpret_cast<float*>(sm + lay.u);       // (TM, ldd) beam rows
  float* ccbA_s = xh_s + TM * ldd;                          // (TM, ldr) ccb, fold_up
  float* S_s = reinterpret_cast<float*>(sm + lay.u);        // (K, R + 1) substep tile
  float* h_s = reinterpret_cast<float*>(sm + lay.h);        // (TM, ldh)
  float* hid_s = reinterpret_cast<float*>(sm + lay.big);    // (TM, ldf) up, then the FFN hidden
  float* lr_s = reinterpret_cast<float*>(sm + lay.lr);      // (TM, ldr) low rank
  // h0 of the low-rank layout with in_proj: the table's C·P slice, in the
  // big buffer (without in_proj h0 is the codeword)
  float* h0_s = hid_s;
  const float* table = static_cast<const float*>(g.table);
  const uint32_t fetch = tc::smem_addr(sm + lay.bar);  // the table rows' bulk copies
  if (tid == 0) {
    mbar_init(fetch, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // The weight stream, every weight in the blocked layout: W2 [U_0] once
  // per item, then per tile [D_0 | concat_w2], (U_l, D_l) for the
  // remaining blocks, [out_proj].
  Stage* stages = reinterpret_cast<Stage*>(sm);
  if (tid == 0) {
    const float* up = static_cast<const float*>(g.ffn_up);
    const float* down = static_cast<const float*>(g.ffn_down);
    int n = 0;
    stages[n++] = {static_cast<const float*>(g.w2), D, Wc, D * kPass};
    if (fold_up) stages[n++] = {up, De, Dh, De * kPass};
    if (fold_up) stages[n++] = {down, Dh, De, Dh * kPass};
    if (low_rank) stages[n++] = {static_cast<const float*>(g.concat_w2), Wc, De, Wc * kPass};
    for (int l = fold_up ? 1 : 0; l < L; ++l) {
      stages[n++] = {up + l * blocked(De, Dh), De, Dh, De * kPass};
      stages[n++] = {down + l * blocked(Dh, De), Dh, De, Dh * kPass};
    }
    if (proj) stages[n++] = {static_cast<const float*>(g.out_proj), De, D, De * kPass};
  }
  __syncthreads();
  const int n_pairs = R * A, n_items = (g.NF + R - 1) / R;
  Ring ring;
  ring.init(sm + lay.ring, stages, fused_head_stages(g), fused_stages(g),
            (n_pairs + TM - 1) / TM, TM == 64);
  if (tid >= kThreads) {  // the producer warpgroup: its first warp streams the weights
    producer_regs();
    if (tid < kThreads + 32) ring.produce_all((n_items - blockIdx.x + gridDim.x - 1) / gridDim.x);
    return;
  }
  consumer_regs();
  uint32_t fetches = 0;  // phases of the fetch barrier so far

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int row0 = item * R, n_rows = min(R, g.NF - row0), n_valid = n_rows * A;
    sync();  // the last item's readers of r, ccb, up_cond, vals and the region are done

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
    // ---- the condition half of the concat layer, ccb = xh·W2 (+ b unless
    // low rank), and with fold_up its product with the first
    // up-projection, up_cond = ccb·U_0
    stage<TM>(ring, xh_s, ldd, D, Wc, R, [&](int t, int c, float4 v) {
      if (!low_rank) v = add4(v, ld4(g.concat_b + c));
      st4(ccb_s + t * Wc + c, v);
      if (fold_up) st4(ccbA_s + t * ldr + c, v);
    });
    if (fold_up)
      stage<TM>(ring, ccbA_s, ldr, De, Dh, R,
                [&](int t, int c, float4 v) { st4(upc_s + t * Dh + c, v); });
    sync();  // the head products' readers of the region are done

    // ---- packed substep partial distances (K, R), as in the selected-
    // scores kernel (r is its own rounding to f32), then the binned argmin:
    // slot a of row i is the float minimum of bin a's packed values
    // (pairwise distinct: the id rides the low bits; floats, not int bits:
    // partial distances can be negative)
    substep_rows(r_s, R, D, g.sub_t, g.cn2, K, S_s);
    sync();
    for (int e = tid; e < R * A; e += kThreads) {
      const int i = e % R, a = e / R;
      const float* col = S_s + (size_t)a * G * (R + 1) + i;
      float m = col[0];
      for (int j = 1; j < G; ++j) m = fminf(m, col[j * (R + 1)]);
      val_s[i * A + a] = m;
    }

    // ---- the (row, slot) pairs, TM at a time
    for (int p0 = 0; p0 < n_pairs; p0 += TM) {
      const int rows = max(0, min(TM, n_valid - p0));
      fence_proxy_async();  // the tile buffers' last generic accesses come before the copies
      sync();  // vals are in; the region's last readers are done
      // Fetch each winner's table row past the codeword by bulk copies, one
      // for each slice, straight into its tile buffer: h (or h0) and up (or
      // lr).  Warp 0 issues them; every consumer waits for the bytes on the
      // fetch barrier.
      if (tid < 32) {
        if (tid == 0) mbar_expect_tx(fetch, 4u * (Wt - D) * rows);
        __syncwarp();
        for (int t = tid; t < rows; t += 32) {
          const float* row = table + (size_t)unpack_id(val_s[p0 + t]) * Wt;
          if (low_rank) {
            if (g.off_h > 0) bulk_copy(tc::smem_addr(h0_s + t * ldh), row + g.off_h, 4 * De, fetch);
            bulk_copy(tc::smem_addr(lr_s + t * ldr), row + g.off_w1, 4 * Wc, fetch);
          } else {
            bulk_copy(tc::smem_addr(h_s + t * ldh), row + g.off_h, 4 * De, fetch);
            if (fold_up) bulk_copy(tc::smem_addr(hid_s + t * ldf), row + g.off_up, 4 * Dh, fetch);
          }
        }
      }
      mbar_wait(fetch, fetches++ & 1);
      // the rows' condition terms: h = T_h + ccb; with fold_up up = relu(T_up
      // + up_cond); with a low-rank factor lr = T_w1 + xh·W2
      if (low_rank) {
        const int Wc4 = Wc / 4;
        for (int e = tid; e < rows * Wc4; e += kThreads) {
          const int t = e / Wc4, c = 4 * (e - t * Wc4);
          st4(lr_s + t * ldr + c,
              add4(ld4(lr_s + t * ldr + c), ld4(ccb_s + ((p0 + t) / A) * Wc + c)));
        }
      } else {
        const int De4 = De / 4;
        for (int e = tid; e < rows * De4; e += kThreads) {
          const int t = e / De4, c = 4 * (e - t * De4);
          st4(h_s + t * ldh + c, add4(ld4(h_s + t * ldh + c), ld4(ccb_s + ((p0 + t) / A) * Wc + c)));
        }
        const int Dh4 = Dh / 4;
        if (fold_up)
          for (int e = tid; e < rows * Dh4; e += kThreads) {
            const int t = e / Dh4, c = 4 * (e - t * Dh4);
            st4(hid_s + t * ldf + c,
                relu4(add4(ld4(hid_s + t * ldf + c), ld4(upc_s + ((p0 + t) / A) * Dh + c))));
          }
      }
      for (int e = tid; e < TM * kSlots; e += kThreads) part_s[e] = 0.f;

      // d = ||r - out - cand||^2: each (t, c .. c + 3) of out adds its
      // squares to the thread's slot; out is the last product's output
      // pair t's table row (its first D columns: the codeword)
      auto row_of = [&](int t) { return table + (size_t)unpack_id(val_s[p0 + t]) * Wt; };
      auto score = [&](int t, int c, float4 o) {
        float4 d = sub4(ld4(r_s + ((p0 + t) / A) * D + c), o);
        if (g.res) d = sub4(d, ld4(row_of(t) + c));
        f32::add_score(part_s, t, d);
      };
      // out = h when there is no out_proj: the last product carries the score
      const int l0 = fold_up ? 1 : 0;
      auto h_out = [&](int t, int c, float4 o) {
        if (!proj) score(t, c, o);
      };
      if (fold_up) {  // the rest of FFN block 0: h = h + up·D_0
        stage<TM>(ring, hid_s, ldf, Dh, De, rows, [&](int t, int c, float4 v) {
          const float4 o = add4(ld4(h_s + t * ldh + c), v);
          st4(h_s + t * ldh + c, o);
          if (!proj && L == 1) score(t, c, o);
        });
      } else if (low_rank) {  // h = h0 + (lr·W2_lr + b)
        stage<TM>(ring, lr_s, ldr, Wc, De, rows, [&](int t, int c, float4 v) {
          const float4 h0 = g.off_h > 0 ? ld4(h0_s + t * ldh + c) : ld4(row_of(t) + c);
          const float4 o = add4(h0, add4(v, ld4(g.concat_b + c)));
          st4(h_s + t * ldh + c, o);
          if (!proj && L == 0) score(t, c, o);
        });
      }
      ffn<TM>(ring, h_s, ldh, hid_s, ldf, L - l0, De, Dh, rows, h_out);
      if (proj) stage<TM>(ring, h_s, ldh, De, D, rows, score);
      sync();
      if (!proj && L == 0 && !low_rank) {  // out = h, no product to carry the sums
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

extern "C" int qt_fused_substep_scores(const float* x, const float* xh, const float* sub_t,
                                       const float* cn2, const void* table, const void* w2,
                                       const void* concat_w2, const float* concat_b,
                                       const void* ffn_up, const void* ffn_down,
                                       const void* out_proj, float* out, int NF, int F_in, int D,
                                       int K, int De, int Dh, int L, int A, int Wt, int Wc,
                                       int off_h, int off_w1, int off_up, int tm, int rows,
                                       int blocks, int smem, int bf16, int res, void* stream) {
  using namespace qt;
  if (NF == 0) return 0;
  if (A <= 0 || K % A) return static_cast<int>(cudaErrorInvalidValue);
  const FusedArgs a{x,   xh,    sub_t, cn2, table, w2, concat_w2, concat_b, ffn_up, ffn_down,
                    out_proj, out, NF, F_in, D,  K,  De,        Dh,       L,      A,
                    Wt,  Wc,    off_h, off_w1, off_up, res, rows};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (fused_stages(a) > tc::kMaxStages || (size_t)smem < FusedLayout(a, tm).total || rows < 1 ||
        rows > kRows || (off_up > 0 && L < 1) || (tm != 64 && tm != 128))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        tm == 128 ? tc::launch_tc(fused_substep_tc_kernel<4, FusedCut::kFull>, blocks, smem, s, a)
                  : tc::launch_tc(fused_substep_tc_kernel<2, FusedCut::kFull>, blocks, smem, s, a));
  }
  // f32: the plan's tile, rows a work item and shared memory, or nothing
  if (fused_stages(a) > f32::kMaxStages || (size_t)smem < FusedF32Layout(a, tm).total ||
      rows < 1 || rows > kRows || blocks < 1 || (off_up > 0 && L < 1) ||
      (tm != 64 && tm != 32) || (D | De | Dh | Wt | Wc | off_h | off_w1 | off_up) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(tm == 64
                              ? f32::launch(fused_substep_f32_kernel<64>, blocks, smem, s, a)
                              : f32::launch(fused_substep_f32_kernel<32>, blocks, smem, s, a));
}
