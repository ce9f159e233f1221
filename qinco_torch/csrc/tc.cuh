// Tensor-core pieces of the bf16 routes of the selected-scores and
// select-rebuild kernels.
//
// Every MLP product runs as warp-level mma.sync.m16n8k16 (bf16 operands,
// f32 accumulation) on operands in shared memory, loaded with ldmatrix:
//   - activations live in shared memory as bf16 (they hold bf16 values at
//     every rounding point of the JAX code, so this is exact), in row-major
//     buffers whose row stride is padded by 16 bytes against bank conflicts;
//   - the step's weights stream through a ring of kRing slabs of
//     kSlabK x kPass bf16 in shared memory, filled by cp.async kRing - 1
//     slabs ahead of the warps that consume them, across stage, tile and
//     work-item boundaries (the weights are the same for every tile).
// A block has 8 warps (kTcThreads) and is alone on its SM: its shared
// memory sees to that.  A stage is out = A·W for up to 32·MT rows: the
// warps form a 2 x 4 grid, warp (wm, wn) owning rows wm·16·MT .. and
// columns wn·32 .. wn·32+31 of each 128-column pass over W.  Widths are
// multiples of 16.
#pragma once

#include "common.cuh"

namespace qt {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kPass = 128;       // output columns of one pass (a slab's width)
constexpr int kSlabK = 32;       // weight rows of one slab
constexpr int kRing = 3;         // slabs in the ring; kRing - 1 are in flight
constexpr int kLdw = kPass + 8;  // slab row stride (bf16): 272 bytes
constexpr int kSlab = kSlabK * kLdw;
constexpr int kTcThreads = 256;  // threads of a tensor-core block
constexpr int kTcWarps = kTcThreads / 32;

// Row stride (bf16 elements) of an activation buffer of width w, a multiple
// of 16: the stride is then an odd number of 16-byte chunks, so the 8 row
// addresses of an ldmatrix fall in 8 different bank groups.
__host__ __device__ constexpr int ld_of(int w) { return w + 8; }

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes from device memory to the shared-memory address dst.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A operand (16 x 16, row-major rows = m): lane l gives the address of row
// l % 16, columns (l / 16)·8 .. +7.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// B operand of two n8 tiles (16 x 16 of a row-major (k, n) slab): lane l
// gives the address of k row l % 16, columns (l / 16)·8 .. +7; r[0..1] are
// the first n8 tile's fragment, r[2..3] the second's.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Store four 8 x 8 bf16 matrices from the mma fragment layout (lane l holds
// row l / 4, columns 2 (l % 4) .. + 1 of each): lane l gives the address of
// row l % 16, columns (l / 16)·8 .. +7, as for ldmatrix_x4.
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, const uint32_t r[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf2(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// d += a·b over one m16n8k16 tile, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Round (a, b) to bf16 (to nearest even) and store them at p, p + 1.
__device__ __forceinline__ void st_bf2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float2 ld_bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// One product of the MLP: W row-major (kin, nout) in device memory.
struct WStage {
  const bf16* w;
  int kin, nout;
};

// The weight stream of a block: stages [0, n_head) once per work item, then
// stages [n_head, n_all) once per tile, reps tiles per item, item after
// item, cut in slabs of kSlabK rows x kPass columns (pass by pass, k-slab by
// k-slab).  Every thread holds the same cursor and copies its share of
// each slab (cp.async, 16 bytes at a time); all of them call init, acquire
// and drain together.
struct WeightRing {
  uint32_t buf;      // shared-memory address of the kRing slabs
  const WStage* st;  // in shared memory
  int n_head, n_all, reps;
  int s, rep, c0, k0;  // the loader's cursor
  int issued;          // slabs issued; the next to consume is issued - (kRing - 1)

  __device__ void init(bf16* b, const WStage* stages, int nh, int na, int r) {
    buf = smem_addr(b);
    st = stages;
    n_head = nh;
    n_all = na;
    reps = r;
    s = rep = c0 = k0 = issued = 0;
    for (int i = 0; i < kRing - 1; ++i) issue();
  }

  // Start the copy of the cursor's slab into the next ring slot (rows past
  // kin and columns past nout are left as they are: no warp reads them),
  // commit it as one cp.async group, advance the cursor.
  __device__ void issue() {
    const WStage g = st[s];
    const uint32_t dst = buf + (issued % kRing) * (kSlab * 2);
    const int rows = min(kSlabK, g.kin - k0), chunks = min(kPass, g.nout - c0) / 8;
    for (int e = threadIdx.x; e < kSlabK * (kPass / 8); e += kTcThreads) {
      const int r = e / (kPass / 8), j = e % (kPass / 8);
      if (r < rows && j < chunks)
        cp_async16(dst + (r * kLdw + 8 * j) * 2, g.w + (size_t)(k0 + r) * g.nout + c0 + 8 * j);
    }
    cp_async_commit();
    ++issued;
    if ((k0 += kSlabK) < g.kin) return;
    k0 = 0;
    if ((c0 += kPass) < g.nout) return;
    c0 = 0;
    if (++s < n_all) return;
    s = n_head;
    if (++rep < reps) return;
    rep = 0;
    s = 0;
  }

  // The shared-memory address of the next slab, once it has landed; the
  // block is synchronised, so the slot consumed before it is free and takes
  // the next copy.
  __device__ uint32_t acquire() {
    cp_async_wait<kRing - 2>();
    __syncthreads();
    const uint32_t b = buf + ((issued - (kRing - 1)) % kRing) * (kSlab * 2);
    issue();
    return b;
  }

  // Wait for the copies still in flight (the next items' slabs) before exit.
  __device__ void drain() { cp_async_wait<0>(); }
};

// d += A[:, k-slab]·B[:, warp's 32 columns] over the slab's kn rows (a
// multiple of 16) for the warp's first mt_on m16 tiles.  a: this lane's
// ldmatrix address in A for m16 tile 0 at the slab's first column, a16: the
// bytes of 16 rows of A; b: this lane's ldmatrix address in the slab for its
// first n16 half; hi: whether the second half holds columns < nout.
template <int MT>
__device__ __forceinline__ void slab_mma(float (&d)[MT][4][4], uint32_t a, int a16, uint32_t b,
                                         int kn, bool hi, int mt_on) {
#pragma unroll
  for (int kk = 0; kk < kSlabK; kk += 16) {
    if (kk >= kn) break;
    uint32_t bf[2][4];
    ldmatrix_x4_trans(bf[0], b + kk * kLdw * 2);
    if (hi) ldmatrix_x4_trans(bf[1], b + kk * kLdw * 2 + 32);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (mt >= mt_on) break;
      uint32_t af[4];
      ldmatrix_x4(af, a + mt * a16 + kk * 2);
      mma_bf16(d[mt][0], af, bf[0][0], bf[0][1]);
      mma_bf16(d[mt][1], af, bf[0][2], bf[0][3]);
      if (hi) {
        mma_bf16(d[mt][2], af, bf[1][0], bf[1][1]);
        mma_bf16(d[mt][3], af, bf[1][2], bf[1][3]);
      }
    }
  }
}

// Where a product's slab at K row k0 finds its A columns in the buffer:
// k0 itself, A held whole.  A map for an A that comes in chunks (the
// D-passed plans) fills the buffer on the first slab of each chunk, after
// the ring's block barrier (the last slab's reads are done), and meets the
// block again before it returns.
struct SameCols {
  __device__ int operator()(int k0) const { return k0; }
};

// The accumulation of one 128-column pass of out = A·W: the warp's
// (32·MT / 2) x 32 block of it in acc, for m16 tiles holding rows < rows;
// cols(k0) the A column of the slab at K row k0.
template <int MT, typename Cols>
__device__ __forceinline__ void mma_pass(WeightRing& ring, uint32_t a, int lda, int kin, bool on,
                                         bool hi, int mt_on, uint32_t b_lane,
                                         float (&acc)[MT][4][4], Cols cols) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  for (int k0 = 0; k0 < kin; k0 += kSlabK) {
    const uint32_t B = ring.acquire();
    const int k = cols(k0);
    if (on) slab_mma<MT>(acc, a + k * 2, 32 * lda, B + b_lane, min(kSlabK, kin - k0), hi, mt_on);
  }
}

// The warp's place in the 2 x 4 grid and its lane's ldmatrix addresses.
struct WarpTile {
  int lane, mw, nw, mt_on;
  uint32_t a, b_lane;
  template <int MT>
  __device__ WarpTile(const bf16* A, int lda, int rows, std::integral_constant<int, MT>) {
    lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    mw = (warp >> 2) * (16 * MT);
    nw = (warp & 3) * 32;
    mt_on = max(0, min(MT, (rows - mw + 15) / 16));  // m16 tiles with rows < rows
    a = smem_addr(A) + ((mw + (lane & 15)) * lda + (lane >> 4) * 8) * 2;
    b_lane = ((lane & 15) * kLdw + nw + (lane >> 4) * 8) * 2;
  }
};

// out = A·W for rows t < rows of A (bf16, row stride lda, kin columns,
// 32·MT rows at most) and W the ring's next stage (kin, nout).  epi(t, c,
// v0, v1) receives the f32 sums of columns c and c + 1 of row t.  The ring
// synchronises the block before each slab, so whatever the block wrote
// before the call is visible to the first slab's reads; epi may write any
// buffer but A and the ring.  cols maps K rows onto A's columns (SameCols).
template <int MT, typename Epi, typename Cols = SameCols>
__device__ __forceinline__ void mma_stage(WeightRing& ring, const bf16* A, int lda, int kin,
                                          int nout, int rows, Epi epi, Cols cols = Cols{}) {
  const WarpTile w(A, lda, rows, std::integral_constant<int, MT>{});
  for (int c0 = 0; c0 < nout; c0 += kPass) {
    const int wc = c0 + w.nw;
    const bool on = wc < nout, hi = wc + 16 < nout;  // the warp's two n16 halves
    float acc[MT][4][4];
    mma_pass<MT>(ring, w.a, lda, kin, on, hi, w.mt_on, w.b_lane, acc, cols);
    if (!on) continue;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = wc + nt * 8 + 2 * (w.lane & 3);
        if (c >= nout) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = w.mw + 16 * mt + (w.lane >> 2) + 8 * h;
          if (t < rows) epi(t, c, acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        }
      }
      // one m16 tile's epilogue at a time: the compiler would otherwise
      // hoist every load of the unrolled epilogue and run out of registers
      asm volatile("" ::: "memory");
    }
  }
}

// out = A·W as mma_stage, written to dst (bf16, row stride ldd) 16 x 16 at
// a time with stmatrix:  dst = rnd(res + op(t, c, v0, v1)) with res the
// same block of res (row stride ldr, read with ldmatrix; res may be dst),
// or dst = rnd(op(...)) without res.  op returns the f32 pair for columns c
// and c + 1 of row t; last(t, c, o0, o1) receives the stored values of
// rows t < rows.  Rows past rows are written too, from whatever A holds
// there: nothing reads them.  cols as mma_stage's.
template <int MT, typename Op, typename Last, typename Cols = SameCols>
__device__ __forceinline__ void mma_stage_bf16(WeightRing& ring, const bf16* A, int lda, int kin,
                                               int nout, int rows, bf16* dst, int ldd,
                                               const bf16* res, int ldr, Op op, Last last,
                                               Cols cols = Cols{}) {
  const WarpTile w(A, lda, rows, std::integral_constant<int, MT>{});
  const int r16 = (w.lane & 15), c8 = (w.lane >> 4) * 8;
  for (int c0 = 0; c0 < nout; c0 += kPass) {
    const int wc = c0 + w.nw;
    const bool on = wc < nout, hi = wc + 16 < nout;
    float acc[MT][4][4];
    mma_pass<MT>(ring, w.a, lda, kin, on, hi, w.mt_on, w.b_lane, acc, cols);
    if (!on) continue;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {  // the warp's n16 halves
        if (p == 1 && !hi) break;
        const int row = w.mw + 16 * mt, col = wc + 16 * p;
        uint32_t old[4], out[4];
        if (res) ldmatrix_x4(old, smem_addr(res + (row + r16) * ldr + col + c8));
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // matrix j: rows 8 (j & 1) .., columns 8 (j >> 1) ..
          const int nt = 2 * p + (j >> 1), h = j & 1;
          const int t = row + (w.lane >> 2) + 8 * h, c = wc + nt * 8 + 2 * (w.lane & 3);
          float2 v = op(t, c, acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
          if (res) {
            const float2 o = unpack_bf2(old[j]);
            v.x += o.x;
            v.y += o.y;
          }
          out[j] = pack_bf2(v.x, v.y);
          if (t < rows) {
            const float2 s = unpack_bf2(out[j]);
            last(t, c, s.x, s.y);
          }
        }
        stmatrix_x4(smem_addr(dst + (row + r16) * ldd + col + c8), out);
      }
      asm volatile("" ::: "memory");
    }
  }
}

// The no-op for mma_stage_bf16's last.
struct NoLast {
  __device__ void operator()(int, int, float, float) const {}
};

// FFN blocks 0 .. L-1 on rows t < rows of h (row stride ldh), in place:
//   up = rnd(relu(h·U_l)) into hid (row stride ldd);  h = rnd(h + rnd(up·D_l)).
// last(t, c, h0, h1) also receives the last block's new h values.
template <int MT, typename Last>
__device__ __forceinline__ void ffn_stages(WeightRing& ring, bf16* h, int ldh, bf16* hid, int ldd,
                                           int L, int De, int Dh, int rows, Last last) {
  const auto relu = [](int, int, float v0, float v1) {
    return make_float2(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
  };
  const auto round = [](int, int, float v0, float v1) {
    return make_float2(rnd<true>(v0), rnd<true>(v1));
  };
  for (int l = 0; l < L; ++l) {
    mma_stage_bf16<MT>(ring, h, ldh, De, Dh, rows, hid, ldd, nullptr, 0, relu, NoLast{});
    if (l < L - 1)
      mma_stage_bf16<MT>(ring, hid, ldd, Dh, De, rows, h, ldh, h, ldh, round, NoLast{});
    else
      mma_stage_bf16<MT>(ring, hid, ldd, Dh, De, rows, h, ldh, h, ldh, round, last);
  }
}

// Sets the kernel's dynamic shared memory and launches it on `stream` with
// kTcThreads threads a block.
template <typename Kernel, typename Args>
cudaError_t launch_tc(Kernel kernel, int blocks, int smem, cudaStream_t stream, const Args& args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<blocks, kTcThreads, smem, stream>>>(args);
  return cudaGetLastError();
}

// Bytes of the stage table at the start of the dynamic shared memory, and
// of the ring's slabs.
constexpr int kMaxStages = 64;  // products of the MLP that one stream can hold
constexpr size_t kStageBytes = kMaxStages * sizeof(WStage);
constexpr size_t kRingBytes = (size_t)kRing * kSlab * sizeof(bf16);

}  // namespace tc
}  // namespace qt
