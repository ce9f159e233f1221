// Hopper warpgroup products (wgmma) fed by a weight ring that a producer
// warp fills with bulk copies (the TMA's cp.async.bulk), multicast to the
// blocks of a thread-block cluster.  The bf16 route of the selected-scores
// kernel (selected_tc.cuh) runs its MLP on these pieces; tc.cuh keeps the
// mma.sync pieces of the other tensor-core kernels.
//
//   - A product out = A·W runs on a consumer warpgroup for 64 rows of A
//     (wgmma.mma_async, bf16 in, f32 sums in registers), in column passes
//     of kPass = 128 (the weight's padding columns are zero and their sums
//     are dropped): m64n128k16 over a whole pass, or m64n64k16 over one
//     half of it where two warpgroups share the 64 rows.  Two widths keep
//     the build short and the accumulator at 64 or 32 registers a thread;
//     a pass reads A again, which at m64n128k16 costs 2 KB of shared
//     memory against 4 KB of the slab for 64 cycles of the tensor cores.
//   - A product may also take A from registers (product_regs, whole
//     passes): the bf16 pairs of an earlier product's sums, which an
//     m64nNk16 accumulator holds in the layout of wgmma's A fragments
//     (pack_frag), so an activation that one product writes and the next
//     reads once never goes through shared memory.
//   - Both operands are read from shared memory in the no-swizzle K-major
//     layout of 8 x 8 core matrices (128 contiguous bytes each), so a
//     warp's 4-byte stores of an epilogue fall in one core matrix and no
//     bank is hit twice:
//       activations (rows x w): core (row / 8, col / 8) at ((row / 8)·(w / 8)
//         + col / 8)·128 bytes (act_off), the k-neighbour 128 bytes on, the
//         next 8 rows 16·w bytes on;
//       a weight slab (kSlabK = 64 rows of W x kPass columns, as W^T, 16 KB):
//         core (n / 8, k / 8) at ((n / 8)·8 + k / 8)·128 bytes, the
//         n-neighbour 1024 on; its first and second 64 columns are its
//         first and second 8 KB.
//     The wrapper lays each weight out so (kernels.wg_blocked): pass by
//     pass, slab by slab, each slab contiguous, the rows past kin zero.
//   - The ring: `slots` slabs (4 to kMaxRing) with a full and an empty
//     mbarrier each.  Producer threads (lane 0 of each warp of a
//     warpgroup that hands its registers to the consumers, setmaxnreg)
//     copy the slabs in the consumers' order, across products, tiles and
//     work items (the weights are the same for every tile), each slab into
//     the slot that every consumer warp of the cluster has released.  A
//     bulk copy holds its thread for a fixed time, about 650 cycles on an
//     H100 whether it moves 4 or 32 KB, so the slabs are large and taken in
//     turn by the kProducers threads; in a cluster of C blocks each slab is
//     copied whole by one block, in turn, and multicast to all C, so a
//     weight byte crosses from L2 once for the C blocks' tiles and each
//     block issues 1/C of the copies; each block's full barrier counts the
//     whole slab in.  The
//     consumers meet at no block barrier for a slab: a warp waits on the
//     full barrier and, once its warpgroup's products of that slab are done
//     (wgmma.wait_group, one slab behind the issue), arrives on the empty
//     barrier of every block of the cluster.
#pragma once

#include "f32_tile.cuh"

namespace qt {
namespace wg {

using tc::bf16;
using f32::mbar_init;
using f32::mbar_expect_tx;
using f32::mbar_wait;
using f32::bulk_copy;
using f32::fence_proxy_async;

constexpr int kSlabK = 64;  // weight rows (K) of a slab: four k16 steps
constexpr int kPass = 128;  // columns of a pass (wgmma N)
constexpr int kMinRing = 4;    // slabs in the ring, at least ...
constexpr int kMaxRing = 16;   // ... and at most
constexpr int kBarBytes = 2 * kMaxRing * 8;  // full[kMaxRing], empty[kMaxRing]
constexpr int kBlock = f32::kBlock;  // 8 consumer warps and a producer warpgroup
constexpr int kProducers = 4;        // producer threads: lane 0 of each producer warp

// Column passes over nout columns and the padded rows of a weight; the
// bf16 elements of a (kin, nout) weight in the slab layout; the bytes of a
// slab.
__host__ __device__ constexpr int pass_count(int nout) { return (nout + kPass - 1) / kPass; }
__host__ __device__ constexpr int k_pad(int kin) { return (kin + kSlabK - 1) / kSlabK * kSlabK; }
__host__ __device__ constexpr size_t blocked(int kin, int nout) {
  return (size_t)k_pad(kin) * pass_count(nout) * kPass;
}
constexpr int kSlabBytes = kSlabK * kPass * 2;

// Byte offset of element (row, col) of an activation buffer of width w (a
// multiple of 8) in the core-matrix layout.
__host__ __device__ __forceinline__ unsigned act_off(int row, int col, int w) {
  return (((row >> 3) * (w >> 3) + (col >> 3)) << 7) + ((row & 7) << 4) + ((col & 7) << 1);
}

// A shared-memory matrix descriptor, no swizzle: lbo the byte step between
// core matrices along K, sbo along M (or N).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void mma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of the accumulators across the
// asynchronous products.
template <int N> __device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N> __device__ __forceinline__ void fence_operands(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d (+)= A·B, m64n64k16, A and B from shared memory (descriptors).
__device__ __forceinline__ void mma_async(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d (+)= A·B, m64n128k16, A and B from shared memory (descriptors).
__device__ __forceinline__ void mma_async(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// d (+)= A·B, m64n128k16, A from registers (a0..a3: the thread's fragment
// of the 64 x 16 slice, bf16 pairs), B from shared memory (descriptor).
__device__ __forceinline__ void mma_async(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint64_t db, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(acc));
}

// ---- clusters
__device__ __forceinline__ int cluster_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ int cluster_size() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ int cluster_id() {
  int r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ int cluster_count() {
  int r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t dynamic_smem_bytes() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%dynamic_smem_size;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" :::
                   "memory");
}

// Where `on`, arrive on the barrier at shared-memory address bar in block
// cta of the cluster (no branch: the products around it stay in flight).
__device__ __forceinline__ void arrive_cluster(uint32_t bar, int cta, bool on) {
  asm volatile(
      "{\n .reg .b32 ra;\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
      " mapa.shared::cluster.u32 ra, %0, %1;\n"
      " @p mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(bar),
      "r"(cta), "r"((int)on)
      : "memory");
}

// Copy `bytes` from device memory to shared-memory address dst in every
// block of `mask` (the same offset in each), counted in by the barrier at
// the same offset in each.
__device__ __forceinline__ void bulk_copy_multicast(uint32_t dst, const void* src, uint32_t bytes,
                                                    uint32_t bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
      " [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

// Barrier of the 4 warps of consumer warpgroup g (named barriers 2 and 3;
// 1 is the 8 consumer warps', f32::sync).
__device__ __forceinline__ void wg_sync(int g) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + g) : "memory");
}

// One product of the MLP: W (kin, nout) in the slab layout.
struct Stage {
  const bf16* w;
  int kin, nout;
};

// The weight stream of a block, as f32::Ring: stages [0, n_head) once per
// work item, then [n_head, n_all) once per tile, reps tiles per item, item
// after item; each stage pass by pass, slab by slab.  Stages is a functor
// s -> Stage.  The consumers are the warps of the warpgroups that run
// products (`consumers` warps a block), in every block of the cluster.
template <class Stages>
struct Ring {
  Stages st;
  uint32_t bar, buf;  // shared-memory addresses of the barriers and the slots
  int slots, n_head, n_all, reps, cluster, rank;
  int s, rep, c0, k0, issued;  // the producer's cursor
  int acquired, released;      // a consumer's counts

  __device__ uint32_t full(int i) const { return bar + 8 * i; }
  __device__ uint32_t empty(int i) const { return bar + 8 * (kMaxRing + i); }

  // Called by every thread of the block; ends with the cluster's barrier,
  // after which every block's barriers are ready.
  __device__ void init(Stages stages, uint32_t bars, uint32_t slots_at, int n_slots, int nh,
                       int na, int r, int consumers) {
    st = stages;
    bar = bars;
    buf = slots_at;
    slots = n_slots;
    n_head = nh;
    n_all = na;
    reps = r;
    cluster = cluster_size();
    rank = cluster_rank();
    s = rep = c0 = k0 = issued = acquired = released = 0;
    if (threadIdx.x == 0) {
      for (int i = 0; i < slots; ++i) {
        mbar_init(full(i), 1);
        mbar_init(empty(i), consumers * cluster);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    cluster_sync();
  }

  // Slabs of stages [s0, s1).
  __device__ int slabs(int s0, int s1) const {
    int n = 0;
    for (int i = s0; i < s1; ++i) {
      const Stage g = st(i);
      n += pass_count(g.nout) * (k_pad(g.kin) / kSlabK);
    }
    return n;
  }

  // Producer thread p (of kProducers): slabs p, p + kProducers, ... of
  // `items` work items.  For each it waits until every consumer of the
  // cluster has released the slot's last slab, counts the slab's bytes in
  // on the slot's full barrier, and, if its block is the slab's issuer
  // ((i / kProducers) mod C), copies the whole slab to every block of the
  // cluster.  A bulk copy costs a thread a fixed time whatever its size,
  // so the copies are spread over the threads and the blocks.  Then it
  // waits until every consumer has released its last slab of each slot,
  // so that no block leaves while another may still arrive on its
  // barriers.
  __device__ void produce_all(int items, int p) {
    const int n = items * (slabs(0, n_head) + reps * slabs(n_head, n_all));
    for (int i = 0; i < n; ++i) {
      if (i % kProducers == p) produce();
      advance();
    }
    for (int i = max(0, n - slots); i < n; ++i)
      if (i % kProducers == p) mbar_wait(empty(i % slots), (i / slots) & 1);
  }

  // The cursor's slab (slab `issued`).
  __device__ void produce() {
    const Stage g = st(s);
    const int slot = issued % slots, u = issued / slots;
    if (u > 0) mbar_wait(empty(slot), (u - 1) & 1);
    mbar_expect_tx(full(slot), kSlabBytes);
    if ((issued / kProducers) % cluster != rank) return;
    const char* src = reinterpret_cast<const char*>(g.w) +
                      ((size_t)c0 * k_pad(g.kin) + (size_t)k0 * kPass) * 2;
    const uint32_t dst = buf + slot * kSlabBytes;
    if (cluster == 1)
      bulk_copy(dst, src, kSlabBytes, full(slot));
    else
      bulk_copy_multicast(dst, src, kSlabBytes, full(slot), (uint16_t)((1u << cluster) - 1));
  }

  __device__ void advance() {
    const Stage g = st(s);
    ++issued;
    if ((k0 += kSlabK) < g.kin) return;
    k0 = 0;
    if ((c0 += kPass) < g.nout) return;
    c0 = 0;
    if (++s < n_all) return;
    s = n_head;
    if (n_all > n_head && ++rep < reps) return;  // no per-tile stage: the next item
    rep = 0;
    s = 0;
  }

  // A consumer thread: the shared-memory address of the next slab, once it
  // has landed.
  __device__ uint32_t acquire() {
    const int slot = acquired % slots;
    mbar_wait(full(slot), (acquired / slots) & 1);
    ++acquired;
    return buf + slot * kSlabBytes;
  }

  // A consumer thread: its warp is done with the oldest slab it holds.
  __device__ void release() {
    __syncwarp();
    const int lane = threadIdx.x & 31;
    arrive_cluster(empty(released % slots), min(lane, cluster - 1), lane < cluster);
    ++released;
  }
};

// The calling thread's place in a pass's accumulator d[N / 2]: entries
// 4j + 2h and 4j + 2h + 1 hold row frag_row(h) of the warpgroup's 64 and
// columns frag_col(j), frag_col(j) + 1 of its N (j < N / 8, h < 2).
__device__ __forceinline__ int frag_row(int h) {
  return 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2) + 8 * h;
}
__device__ __forceinline__ int frag_col(int j) { return 8 * j + 2 * (threadIdx.x & 3); }

// out = A·W for the 64 rows of the calling consumer warpgroup: A at
// shared-memory address a (its first row; width a_w, the core-matrix
// layout), W the ring's next stage (kin, nout), of which the warpgroup
// computes columns col .. col + N - 1 of each pass of kPass (N = kPass:
// all; N = kPass / 2, col 0 or 64: one half, whose slab is the first or
// second 4 KB of the slot).  Where `on`, epi(d, c0) receives each pass's
// f32 sums d[N / 2] (columns c0 .. c0 + N - 1, laid out as frag_row and
// frag_col say; columns past nout are the zero padding's) once the pass
// has completed.  The products run whether or not `on` (a warpgroup with
// no rows computes on what its buffer holds): a branch around wgmma would
// make ptxas serialize them.  A slab's k16 steps past kin (the last slab
// of a kin that is no multiple of kSlabK) multiply the slab's first step's
// A by the slab's zero rows.  pass_sums computes one pass's sums into d;
// product runs it pass by pass.
template <int N, class Ring_>
__device__ __forceinline__ void pass_sums(Ring_& ring, float (&d)[N / 2], uint32_t a, int a_w,
                                          int kin, int col) {
  const uint32_t sbo = 16 * a_w, half = 2 * kSlabK * col;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  fence_operands(d);
  mma_fence();
  for (int k0 = 0; k0 < kin; k0 += kSlabK) {
    const uint32_t b = ring.acquire() + half;
    mma_async(d, desc(a + 16 * k0, 128, sbo), desc(b, 128, 16 * kSlabK), k0 > 0);
#pragma unroll
    for (int kk = 1; kk < kSlabK / 16; ++kk) {
      const int k = k0 + 16 * kk < kin ? k0 + 16 * kk : k0;
      mma_async(d, desc(a + 16 * k, 128, sbo), desc(b + 256 * kk, 128, 16 * kSlabK), 1);
    }
    mma_commit();
    if (k0 >= 2 * kSlabK) {  // two slabs' products stay in flight
      mma_wait<2>();
      ring.release();
    }
  }
  mma_wait<0>();
  ring.release();
  if (kin > kSlabK) ring.release();
  fence_operands(d);
}

template <int N, class Ring_, class Epi>
__device__ __forceinline__ void product(Ring_& ring, uint32_t a, int a_w, int kin, int nout,
                                        int col, bool on, Epi epi) {
  for (int p0 = 0; p0 < nout; p0 += kPass) {
    float d[N / 2];
    pass_sums<N>(ring, d, a, a_w, kin, col);
    if (on) epi(d, p0 + col);
  }
}

// product() on whole passes over exactly P passes (nout = P·kPass), the
// loop unrolled so that epi(d, p) may put pass p's sums in registers of
// its own (pack_frag); epi runs whether or not the warpgroup has rows.
template <int P, class Ring_, class Epi>
__device__ __forceinline__ void product_passes(Ring_& ring, uint32_t a, int a_w, int kin, Epi epi) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    float d[kPass / 2];
    pass_sums<kPass>(ring, d, a, a_w, kin, 0);
    epi(d, p);
  }
}

// A's fragments from a pass's sums d[64] (m64n128k16), each pair of
// columns f(d[2i]), f(d[2i + 1]) rounded to one bf16 pair at q[at + i]:
// q[at + 4kk .. at + 4kk + 3] is then the A fragment (wgmma, A from
// registers) of the pass's columns 16kk .. 16kk + 15, as the
// accumulator's n8 blocks 2kk and 2kk + 1 hold them (rows frag_row(0),
// frag_row(1); columns frag_col).
template <int M, class F>
__device__ __forceinline__ void pack_frag(const float (&d)[kPass / 2], uint32_t (&q)[M], int at,
                                          F f) {
#pragma unroll
  for (int i = 0; i < kPass / 4; ++i) q[at + i] = tc::pack_bf2(f(d[2 * i]), f(d[2 * i + 1]));
}

// out = A·W on whole passes (N = kPass) for the 64 rows of the calling
// consumer warpgroup, A from registers: a[16·S], the pack_frag fragments
// of A's 64·S columns (k16 step k at a[4k .. 4k + 3]), W the ring's next
// stage (64·S, nout), its S slabs a pass walked as product() walks them.
// Where `on`, epi(d, c0) receives each pass's sums as in product().  The
// slab loop is unrolled (the fragments' indices fixed at compile time),
// and each slab's products complete before the next slab is waited for:
// products left in flight across the unrolled waits made ptxas serialize
// every wgmma of the kernel (C7515; 12.2 against 10.2 ms a launch at
// qinco2-L on an H100); the other warpgroup's products fill the gap.
template <int S, class Ring_, class Epi>
__device__ __forceinline__ void product_regs(Ring_& ring, uint32_t (&a)[16 * S], int nout, bool on,
                                             Epi epi) {
  for (int p0 = 0; p0 < nout; p0 += kPass) {
    float d[kPass / 2];
#pragma unroll
    for (int i = 0; i < kPass / 2; ++i) d[i] = 0.f;
    fence_operands(d);
    fence_operands(a);
    mma_fence();
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const uint32_t b = ring.acquire();
#pragma unroll
      for (int kk = 0; kk < kSlabK / 16; ++kk) {
        const int k = 16 * s + 4 * kk;
        mma_async(d, a[k], a[k + 1], a[k + 2], a[k + 3], desc(b + 256 * kk, 128, 16 * kSlabK),
                  s > 0 || kk > 0);
      }
      mma_commit();
      mma_wait<0>();
      ring.release();
    }
    fence_operands(d);
    fence_operands(a);
    if (on) epi(d, p0);
  }
}

// product() with a fill before each chunk of K (the D-passed plans): A's
// columns come in chunks of kc (a multiple of kSlabK; kin itself for one
// chunk), fill(p0, c0) writing columns c0 .. c0 + kc - 1 of the tile's
// rows into the buffer at a (width kc, the core-matrix layout) for the
// pass over output columns p0 .. p0 + kPass - 1, or whatever else the
// pass's epilogue reads.  Each pass walks the chunks again.  Before a fill
// every product on the buffer has completed, its slabs are released and
// the 8 consumer warps meet; after it they meet again, the writes fenced
// for the products.  The sums are product()'s, in the same order.  One
// loop over K with the fill under a branch: the chunks as a loop of their
// own (or the passes and chunks as one loop) made ptxas serialize the
// wgmmas (C7520).  Called by every consumer thread, with the same
// arguments but `on`.
template <int N, class Ring_, class Epi, class Fill>
__device__ __forceinline__ void product_chunked(Ring_& ring, uint32_t a, int kc, int kin, int nout,
                                                int col, bool on, Epi epi, Fill fill) {
  const uint32_t sbo = 16 * kc, half = 2 * kSlabK * col;
  for (int p0 = 0; p0 < nout; p0 += kPass) {
    float d[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
    fence_operands(d);
    mma_fence();
    int held = 0;  // slabs whose products may still be in flight
    for (int k0 = 0; k0 < kin; k0 += kSlabK) {
      const int kl = k0 % kc;
      if (kl == 0) {
        mma_wait<0>();
        for (; held > 0; --held) ring.release();
        f32::sync();
        fill(p0, k0);
        fence_proxy_async();
        f32::sync();
        mma_fence();
      }
      const uint32_t b = ring.acquire() + half;
      mma_async(d, desc(a + 16 * kl, 128, sbo), desc(b, 128, 16 * kSlabK), k0 > 0);
#pragma unroll
      for (int kk = 1; kk < kSlabK / 16; ++kk) {
        const int k = k0 + 16 * kk < kin ? kl + 16 * kk : kl;
        mma_async(d, desc(a + 16 * k, 128, sbo), desc(b + 256 * kk, 128, 16 * kSlabK), 1);
      }
      mma_commit();
      if (++held > 2) {  // two slabs' products stay in flight
        mma_wait<2>();
        ring.release();
        --held;
      }
    }
    mma_wait<0>();
    for (; held > 0; --held) ring.release();
    fence_operands(d);
    if (on) epi(d, p0 + col);
  }
}

}  // namespace wg
}  // namespace qt
