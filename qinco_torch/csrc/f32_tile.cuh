// The float32 tile stage of the f32 routes of the selected-scores (B2')
// and candidate-scores (B5) kernels: out = A·W on the CUDA cores in IEEE
// f32 FFMA (no TF32: that would be a different result), for a tile of TM
// rows at a time.
//
//   - The step's weights stream through a ring of kRing slots of 16 KB
//     in shared memory, each filled by bulk copies (the TMA's
//     cp.async.bulk, from the weights in a blocked layout that makes
//     every slab contiguous) that complete on an mbarrier.  A producer
//     warp keeps up to kRing slabs ahead of the math, across stage, tile
//     and work-item boundaries (the weights are the same for every
//     tile), and refills a slot once all 8 math warps have released it;
//     the math warps never meet at a block barrier for a slab.  All warps
//     share the ring, so a weight crosses from L2 once per tile.
//   - Activations are f32 in shared memory, each row padded by 4 floats
//     (a stride of Kin + 4): the two rows that one load instruction of a
//     warp reads then fall in different banks.
//   - A block is alone on its SM: 8 math warps (kThreads, two
//     warpgroups) and a producer warpgroup, which hands its registers to
//     the math warps (setmaxnreg).  A stage computes out in passes of 256
//     columns where that many remain (64-row tiles: an 8 x 8 register
//     tile of sums a thread) and of 128 columns otherwise (8 x 4; at TM =
//     32 the warps split each slab's rows in two halves).  A lane's rows
//     are 2 apart and its columns 4 wide (two such groups 64 apart in a
//     wide pass), so each group of 4 k-steps reads 8 float4 of A (two
//     addresses a warp: broadcast) and 4 or 8 float4 of the slab (256
//     contiguous bytes a warp each) for 128 or 256 FFMA.
//   - Every sum runs in one fixed order, and the epilogue gets each
//     output once, so a launch gives the same bits on every run.
#pragma once

#include "step_tc.cuh"

namespace qt {
namespace f32 {

constexpr int kPass = 128;   // output columns of one pass (a slab's width)
constexpr int kSlabK = 32;   // weight rows of one slab
constexpr int kRing = 3;     // slabs in the ring; kRing - 1 are in flight
constexpr int kSlab = kSlabK * kPass;  // floats of a slab
// A wide pass: 256 columns, its slab kWideK rows (two kPass-wide halves,
// [half][kWideK][kPass]), taken at 64-row tiles where 256 columns remain
// (Ring::wide_pass).
constexpr int kWide = 2 * kPass;
constexpr int kWideK = kSlab / kWide;
constexpr int kMaxStages = 64;         // products that one stream can hold
constexpr int kSlots = 32;   // distance partials a tile row: one a column thread

// Row stride (floats) of an activation buffer of width w.
__host__ __device__ constexpr int ld_of(int w) { return w + 4; }

// One product of the MLP: W (kin, nout) f32 in device memory in the
// blocked layout (passes(nout), kin, kPass), columns past nout zero: the
// slab of pass p and rows k0 .. is the contiguous w + p·pstride + k0·kPass.
struct Stage {
  const float* w;
  int kin, nout, pstride;
};

// Passes of kPass columns over nout columns, and the floats of a (kin,
// nout) weight in the blocked layout.
__host__ __device__ constexpr int passes(int nout) { return (nout + kPass - 1) / kPass; }
__host__ __device__ constexpr size_t blocked(int kin, int nout) {
  return (size_t)passes(nout) * kin * kPass;
}

// Bytes of the stage table at the start of the dynamic shared memory, of
// the ring's barriers (full and empty, kRing each) and of its slabs.
constexpr size_t kStageBytes = kMaxStages * sizeof(Stage);
constexpr size_t kBarBytes = 64;
constexpr size_t kRingBytes = kBarBytes + (size_t)kRing * kSlab * sizeof(float);
static_assert(2 * kRing * 8 <= kBarBytes, "the ring's barriers");

// mbarrier and bulk-copy primitives (sm_90).  A wait that has not seen its
// phase after kSpin tries traps: a fault is reported, never a hang.
constexpr long long kSpin = 1ll << 26;

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity, int sleep_ns = 0) {
  for (long long i = 0; i < kSpin; ++i) {
    if (sleep_ns && i) __nanosleep(sleep_ns);
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
  }
  __trap();
}

// Copy `bytes` (a multiple of 16) from device memory to shared memory; the
// barrier `bar` counts them in.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Order this thread's earlier shared-memory accesses (the generic proxy's)
// before later bulk copies into the same bytes (the async proxy's): every
// thread that touched a buffer runs it before the barrier after which one
// thread refills the buffer by bulk copies.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A block: kThreads consumer threads (8 warps, two warpgroups) that run
// the products, and a producer warpgroup, whose first warp streams the
// weights.  The producers hand their registers to the consumers
// (setmaxnreg): kConsumerRegs x 256 + kProducerRegs x 128 <= 65,536.
constexpr int kBlock = kThreads + 128;
constexpr int kConsumerRegs = 232, kProducerRegs = 40;

__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
}

__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
}

// Barrier of the consumer warps alone (named barrier 1): the producer warp
// never waits on the consumers' phases.
__device__ __forceinline__ void sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// The weight stream of a block, as tc::WeightRing: stages [0, n_head) once
// per work item, then stages [n_head, n_all) once per tile, reps tiles per
// item, item after item, cut in slabs (pass by pass, k-slab by k-slab):
// kSlabK rows x kPass columns, or kWideK rows x kWide columns in a wide
// pass.  The producer warp copies each slab into its slot (one bulk copy
// a kPass-wide half, counted in by the slot's full barrier) once the 8
// consumer warps have released the slot's last slab (its empty barrier),
// so it runs up to kRing slabs ahead; the consumers acquire and release
// every slab in order and never meet at a block barrier for it.
struct Ring {
  uint32_t bar;      // shared-memory address of full[kRing], then empty[kRing]
  float* buf;        // the kRing slabs
  float* red;        // the split sums' exchange buffer, after the slabs (ring_bytes)
  const Stage* st;   // in shared memory
  int n_head, n_all, reps;
  int s, rep, c0, k0;  // the producer's cursor
  int issued, used;    // slabs produced (the producer's count) and consumed
  bool wide;           // wide passes where 256 columns remain (64-row tiles)

  __device__ uint32_t full(int slot) const { return bar + 8 * slot; }
  __device__ uint32_t empty(int slot) const { return bar + 8 * (kRing + slot); }

  // area: the ring's ring_bytes of shared memory, 16-byte aligned.  Called
  // by the whole block (kBlock threads) after the stage table is written.
  __device__ void init(void* area, const Stage* stages, int nh, int na, int r, bool w) {
    wide = w;
    bar = tc::smem_addr(area);
    buf = reinterpret_cast<float*>(static_cast<char*>(area) + kBarBytes);
    red = buf + kRing * kSlab;
    st = stages;
    n_head = nh;
    n_all = na;
    reps = r;
    s = rep = c0 = k0 = issued = used = 0;
    if (threadIdx.x == 0) {
      for (int i = 0; i < kRing; ++i) {
        mbar_init(full(i), 1);
        mbar_init(empty(i), kWarps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  // Whether the pass from column c0 of a product of nout columns is wide.
  __device__ bool wide_pass(int c0, int nout) const { return wide && nout - c0 >= kWide; }

  // Slabs of stages [s0, s1).
  __device__ int slabs(int s0, int s1) const {
    int n = 0;
    for (int i = s0; i < s1; ++i)
      for (int c0 = 0; c0 < st[i].nout;) {
        const bool w = wide_pass(c0, st[i].nout);
        n += (st[i].kin + (w ? kWideK : kSlabK) - 1) / (w ? kWideK : kSlabK);
        c0 += w ? kWide : kPass;
      }
    return n;
  }

  // The producer warp: every slab of the block's `items` work items, in
  // the order the consumers take them.
  __device__ void produce_all(int items) {
    const int n = items * (slabs(0, n_head) + reps * slabs(n_head, n_all));
    for (int i = 0; i < n; ++i) produce();
  }

  // Copy the cursor's slab into its slot (one bulk copy: the blocked
  // layout), once the slot's last slab has been released (rows past kin
  // are left as they are: no thread reads them); advance the cursor.
  __device__ void produce() {
    const Stage g = st[s];
    const int slot = issued % kRing, u = issued / kRing;
    const bool w = wide_pass(c0, g.nout);
    const int rows = min(w ? kWideK : kSlabK, g.kin - k0), halves = w ? 2 : 1;
    const uint32_t bytes = 4u * kPass * rows;  // a half
    if ((threadIdx.x & 31) == 0) {
      if (u > 0) mbar_wait(empty(slot), (u - 1) & 1, 64);  // off the consumers' issue slots
      mbar_expect_tx(full(slot), halves * bytes);
      for (int h = 0; h < halves; ++h)
        bulk_copy(tc::smem_addr(buf + slot * kSlab + h * kWideK * kPass),
                  g.w + (size_t)(c0 / kPass + h) * g.pstride + (size_t)k0 * kPass, bytes,
                  full(slot));
    }
    ++issued;
    if ((k0 += w ? kWideK : kSlabK) < g.kin) return;
    k0 = 0;
    if ((c0 += w ? kWide : kPass) < g.nout) return;
    c0 = 0;
    if (++s < n_all) return;
    s = n_head;
    if (n_all > n_head && ++rep < reps) return;  // no per-tile stage: the next item
    rep = 0;
    s = 0;
  }

  // A consumer: the next slab, once it has landed.
  __device__ const float* acquire() {
    const int slot = used % kRing;
    mbar_wait(full(slot), (used / kRing) & 1);
    return buf + slot * kSlab;
  }

  // A consumer: the calling warp is done with the slab it acquired last.
  __device__ void release() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty(used % kRing));
    ++used;
  }
};

// The calling thread's distance slot in a tile row (its column thread).
__device__ __forceinline__ int slot() {
  return ((threadIdx.x >> 5) & 1) * 16 + (threadIdx.x & 15);
}

// Add the squares of d to row t's slot of the calling thread, in a fixed
// order, from inside a stage's epilogue.
__device__ __forceinline__ void add_score(float* part_s, int t, float4 d) {
  float* q = part_s + t * kSlots + slot();
  float s = *q;
  s = fmaf(d.x, d.x, s);
  s = fmaf(d.y, d.y, s);
  s = fmaf(d.z, d.z, s);
  s = fmaf(d.w, d.w, s);
  *q = s;
}

// Row t's distance: its slots summed in order.
__device__ __forceinline__ float sum_score(const float* part_s, int t) {
  const float* q = part_s + t * kSlots;
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) s += q[j];
  return s;
}

// The operands of 4 k-steps of a thread's register tile: TR float4 of A
// (its rows, 4 columns each) and 4 x NC float4 of the slab (4 rows, its NC
// groups of 4 columns, 64 apart).
template <int TR, int NC>
struct Frag {
  float4 a[TR], w[4][NC];

  __device__ __forceinline__ void load(const float* A, int lda, const float* b, int kk) {
#pragma unroll
    for (int i = 0; i < TR; ++i) a[i] = *reinterpret_cast<const float4*>(A + i * 2 * lda + kk);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < NC; ++q)
        w[j][q] = *reinterpret_cast<const float4*>(b + (kk + j) * kPass + 64 * q);
  }

  __device__ __forceinline__ void ffma(float (&acc)[TR][4 * NC]) const {
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const float ak[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < NC; ++q) {
          acc[i][4 * q + 0] = fmaf(ak[j], w[j][q].x, acc[i][4 * q + 0]);
          acc[i][4 * q + 1] = fmaf(ak[j], w[j][q].y, acc[i][4 * q + 1]);
          acc[i][4 * q + 2] = fmaf(ak[j], w[j][q].z, acc[i][4 * q + 2]);
          acc[i][4 * q + 3] = fmaf(ak[j], w[j][q].w, acc[i][4 * q + 3]);
        }
    }
  }
};

// acc += A[rows, k .. k + kn)·slab[k .. k + kn) for the thread's TR rows
// (A: its first row at column k, row step 2·lda) and NC column groups (b:
// its first column in the slab's row k), kn a multiple of 4 and at most
// SPAN.  A full span runs with the next 4 k-steps' operands loaded while
// the current ones are multiplied.
template <int TR, int NC, int SPAN>
__device__ __forceinline__ void span_ffma(float (&acc)[TR][4 * NC], const float* A, int lda,
                                          const float* b, int kn) {
  if (kn == SPAN) {
    Frag<TR, NC> f[2];
    f[0].load(A, lda, b, 0);
#pragma unroll
    for (int g = 0; g < SPAN / 4; ++g) {
      if (g + 1 < SPAN / 4) f[(g + 1) & 1].load(A, lda, b, 4 * (g + 1));
      f[g & 1].ffma(acc);
    }
  } else {
    for (int kk = 0; kk < kn; kk += 4) {
      Frag<TR, NC> f;
      f.load(A, lda, b, kk);
      f.ffma(acc);
    }
  }
}

// Bytes of the ring for a TM-row tile: the slabs, and with TM < 64 the
// exchange buffer of the split sums (TM x kPass f32).
__host__ __device__ constexpr size_t ring_bytes(int TM) {
  return kRingBytes + (TM < 64 ? (size_t)4 * TM * kPass : 0);
}

// out = A·W for rows t < rows of A (f32, row stride lda, kin columns) and
// W the ring's next stage (kin, nout).  A is read for all TM rows, so its
// TM rows of lda floats lie inside the block's shared memory; the sums of
// rows past `rows` are dropped.  epi(t, c, v) receives the f32 sums of
// columns c .. c + 3 of row t (nout is a multiple of 4).  Called by the
// consumer threads.  The stage synchronises them first, so whatever they
// wrote before the call is visible to its reads, and every earlier
// stage's reads are done;
// epi may write any buffer but A and the ring, and read and write the
// elements it is given of any other buffer.
//
// TM = 64: the 8 warps form a 4 x 2 grid over the pass, each thread an 8 x
// 8 tile of a 256-column pass or an 8 x 4 tile of a 128-column one.  TM =
// 32 (128-column passes only): two groups of 4 warps (2 x 2) each cover
// the 32 x 128 pass over one half of every slab's rows (split k); at the
// end of a pass the second group hands its 8 x 4 sums to the first through
// the exchange buffer, and the first adds them to its own and runs the
// epilogue: sum = (first half's sum) + (second half's sum), in one order
// on every run.
template <int TM, typename Epi>
__device__ __forceinline__ void stage(Ring& ring, const float* A, int lda, int kin, int nout,
                                      int rows, Epi epi) {
  static_assert(TM == 64 || TM == 32, "the f32 stage takes 64- or 32-row tiles");
  constexpr int TR = 8, SPLIT = 64 / TM, GW = kWarps / SPLIT, SPAN = kSlabK / SPLIT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = warp / GW, gw = warp % GW;
  const int t0 = (gw >> 1) * (2 * TR) + (lane >> 4);  // rows t0 + 2i
  const int cw = (warp & 1) * 64 + (lane & 15) * 4;   // columns cw .. cw + 3 of a pass
  const int k_lo = grp * SPAN;                        // the group's rows of a slab
  const float* a = A + t0 * lda + k_lo;
  sync();  // what the consumers wrote before the stage (A among it) is in
  for (int c0 = 0; c0 < nout;) {
    if constexpr (TM == 64) {
      if (ring.wide_pass(c0, nout)) {  // 8 x 8 sums a thread: columns cw .. + 3, cw + 64 ..
        float acc[TR][8];
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
        const int half = warp & 1, cw2 = half * kPass + (lane & 15) * 4;
        for (int k0 = 0; k0 < kin; k0 += kWideK) {
          const float* b = ring.acquire() + half * kWideK * kPass + (lane & 15) * 4;
          span_ffma<TR, 2, kWideK>(acc, a + k0, lda, b, min(kWideK, kin - k0));
          ring.release();
        }
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const int t = t0 + 2 * i;
          if (t >= rows) continue;
          epi(t, c0 + cw2, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
          epi(t, c0 + cw2 + 64, make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
        }
        c0 += kWide;
        continue;
      }
    }
    const int c = c0 + cw;
    const bool on = c < nout;
    c0 += kPass;
    float acc[TR][4];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < kin; k0 += kSlabK) {
      const float* b = ring.acquire();
      const int kn = min(SPAN, kin - k0 - k_lo);
      if (on && kn > 0) span_ffma<TR, 1, SPAN>(acc, a + k0, lda, b + k_lo * kPass + cw, kn);
      ring.release();
    }
    if constexpr (SPLIT > 1) {
      const int tig = threadIdx.x % (GW * 32);  // the thread's place in its group
      if (grp == 1 && on)
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) ring.red[(i * 4 + j) * (GW * 32) + tig] = acc[i][j];
      sync();
      if (grp == 0 && on)
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += ring.red[(i * 4 + j) * (GW * 32) + tig];
      sync();  // the next pass's sums may overwrite the buffer
      if (grp == 1) continue;
    }
    if (!on) continue;
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int t = t0 + 2 * i;
      if (t < rows) epi(t, c, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    }
  }
}

// Sets the kernel's dynamic shared memory and launches it on `stream`, kBlock
// threads a block.
template <typename Kernel, typename Args>
cudaError_t launch(Kernel kernel, int blocks, int smem, cudaStream_t stream, const Args& args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<blocks, kBlock, smem, stream>>>(args);
  return cudaGetLastError();
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// st(e, ld(e)) for the float4s e < n, four loads in flight a thread.
template <typename Ld, typename St>
__device__ __forceinline__ void copy4(int n, Ld ld, St st) {
  for (int e0 = threadIdx.x; e0 < n; e0 += 4 * kThreads) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (e0 + u * kThreads < n) v[u] = ld(e0 + u * kThreads);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (e0 + u * kThreads < n) st(e0 + u * kThreads, v[u]);
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

__device__ __forceinline__ float4 relu4(float4 a) {
  return make_float4(fmaxf(a.x, 0.f), fmaxf(a.y, 0.f), fmaxf(a.z, 0.f), fmaxf(a.w, 0.f));
}

// FFN blocks 0 .. L-1 on rows t < rows of h (row stride ldh), in place:
//   hid = relu(h·U_l) (row stride ldf);  h = h + hid·D_l.
// last(t, c, v) also receives the last block's new h values.
template <int TM, typename Last>
__device__ __forceinline__ void ffn(Ring& ring, float* h, int ldh, float* hid, int ldf, int L,
                                    int De, int Dh, int rows, Last last) {
  for (int l = 0; l < L; ++l) {
    stage<TM>(ring, h, ldh, De, Dh, rows,
              [&](int t, int c, float4 v) { st4(hid + t * ldf + c, relu4(v)); });
    stage<TM>(ring, hid, ldf, Dh, De, rows, [&](int t, int c, float4 v) {
      const float4 o = add4(ld4(h + t * ldh + c), v);
      st4(h + t * ldh + c, o);
      if (l == L - 1) last(t, c, o);
    });
  }
}

struct NoLast {
  __device__ void operator()(int, int, float4) const {}
};

}  // namespace f32
}  // namespace qt
