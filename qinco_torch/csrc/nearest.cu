// The IVF step 0: each row's nearest row of an f32 book, the distance
// product and the first-minimum argmin in one pass.
//
// Replaces: no Pallas kernel.  The JAX package leaves chunked_argmin
// (qinco_tpu/ops/distances.py) to XLA: a product per book slice, then a
// row min.  On the card that route (cuBLAS SGEMM, two elementwise passes,
// a row min; ops/distances.py's plain loop) writes each slice's
// (N, 65,536) f32 distance tile to device memory and reads it back three
// times, about 1.5 GB of traffic a slice at the encode's N = 1024.  Here
// the distances never leave registers.
//
// What it computes, for x (N, D) and book (K, D), f32, row-major:
// d(n, k) = ‖c_k‖² − 2 x_n·c_k in IEEE f32 (FFMA on the CUDA cores: no
// TF32, no tensor cores; d is formed as fma(−2, x·c, ‖c‖²), which rounds
// once, as ‖c‖² − 2.0 * (x·c) does), and for each row the first minimum:
// the lowest k among equal smallest d, the plain loop's order.  Out: the
// best partial distance (N,) f32 and its index (N,) int64.
//
// What bounds it on the card: operations, 2·N·K·D FLOP (2.7e11 at the
// encode's N = 1024, K = 2^20, D = 128: 4.1 ms at 67 TFLOP/s); the book
// is read once from device memory (0.5 GB: 0.16 ms at 3.35 TB/s).
//
// What the design does about it.  A block owns a work item: a block of
// 128 rows of x and a contiguous range of 128-row book tiles (a split).
// Where D <= 128 the x block stays in shared memory for the whole item
// (transposed, 66 KB at D = 128) and only the book streams; wider x blocks
// (D = 768: 384 KB) stream beside it.  The streamed operands come through
// shared memory in slices 16 deep along D (any D that is a multiple of 4;
// a short last slice reads zeros), each slice loaded into registers while
// the slice before it is multiplied, then stored transposed, so each of
// the 256 threads accumulates an 8 x 8 register tile from four float4
// loads and 64 FFMA a step.  ‖c‖² is summed from the same slices (two
// threads a book row, a fixed order, so equal rows get equal norms and
// exact ties stay ties).  At a tile's end each
// thread folds its 64 distances into running (best, index) slots of its
// 8 rows in shared memory, its columns ascending, strict less; at the
// split's end the 16 threads of a row merge their slots by (d, index),
// and the split's partial per row is written.  Blocks take their row
// block fastest, so the row blocks of one split run side by side and read
// each book tile from device memory once, the rest from L2.  A second
// kernel merges the splits' partials by (d, index); with one split the
// partials are the outputs.  Nothing is atomic: the same inputs give the
// same bits.  The wrapper (ops/kernels.py nearest_plan) picks the splits
// so that the blocks fill the card's resident slots, two blocks an SM, in
// as few waves as the book allows: at N = 1024 only 8 row blocks exist,
// and K is split 33 ways (264 blocks, one wave); at k-means' 2048-row
// steps 16 row blocks and 33 splits (two waves).
#include "common.cuh"

namespace qt {
namespace nn {

constexpr int kBM = 128;       // rows of x a block
constexpr int kBN = 128;       // book rows a tile
constexpr int kBK = 16;        // depth of a slice along D
constexpr int kLd = kBM + 4;   // a transposed slice's padded row: the stores meet no bank twice
constexpr int kSlots = 16;     // running (best, index) slots a row: one a column thread
constexpr int kSlotLd = 18;    // padded: a warp's 4 row groups land on distinct banks
constexpr int kResidentD = 128;  // the widest D whose x block stays in shared memory
static_assert(kBM == kBN && kThreads == 2 * kBM, "two threads a row of a slice");

struct Args {
  const float* x;        // (N, D)
  const float* book;     // (K, D)
  float* part_d;         // (splits, N)
  long long* part_i;     // (splits, N)
  int N, K, D, tiles, splits;
};

// Shared memory of a block, floats: x (the whole padded D when resident,
// else two slices), two book slices, the norm partials, the slots.
template <bool XRES>
__host__ __device__ constexpr int x_floats(int D) {
  return (XRES ? (D + kBK - 1) / kBK * kBK : 2 * kBK) * kLd;
}
template <bool XRES>
__host__ __device__ constexpr int smem_floats(int D) {
  return x_floats<XRES>(D) + 2 * kBK * kLd + 2 * 2 * kBN + 2 * kBM * kSlotLd;
}

__device__ __forceinline__ float4 load4(const float* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const float4*>(p)) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// Store a float4 of row `row`, depths k..k+3, into a transposed slice.
__device__ __forceinline__ void store_t(float* s, int row, int k, float4 v) {
  s[k * kLd + row] = v.x;
  s[(k + 1) * kLd + row] = v.y;
  s[(k + 2) * kLd + row] = v.z;
  s[(k + 3) * kLd + row] = v.w;
}

// (d, i) before (bd, bi): the smaller distance, the lower index on a tie.
__device__ __forceinline__ bool before(float d, long long i, float bd, long long bi) {
  return d < bd || (d == bd && i < bi);
}

// XRES: the block's x rows stay in shared memory for the whole work item
// (D <= kResidentD) and only the book streams; otherwise both stream, a
// slice each.  A thread loads row t / 2 of a slice at depths
// (t % 2) * 4 + 8q: a warp's two depth groups then store to disjoint
// banks.
template <bool XRES>
__global__ void __launch_bounds__(kThreads, 2) nearest_kernel(const Args a) {
  constexpr int BK = kBK, Q = BK / 8;  // Q: float4 a thread and operand a slice
  static_assert(BK % 8 == 0, "slices of whole 8-deep loader rounds");
  extern __shared__ __align__(16) float sm[];
  float* const xs = sm;
  float* const bs = xs + x_floats<XRES>(a.D);
  float* const npart = bs + 2 * BK * kLd;  // [tile parity][half of each slice][column]
  float* const best_d = npart + 2 * 2 * kBN;
  int* const best_i = reinterpret_cast<int*>(best_d + kBM * kSlotLd);

  const int t = threadIdx.x, w = t >> 5, l = t & 31;
  // the 8 x 8 register tile: rows ty*4 + {0..3} and 64 + ty*4 + {0..3},
  // columns tx*4 + {0..3} and 64 + tx*4 + {0..3}; a warp holds 4 row
  // groups by 8 column groups, so each of its float4 loads is one wavefront
  const int ty = 4 * (w >> 1) + (l >> 3), tx = 8 * (w & 1) + (l & 7);
  const int lrow = t >> 1, lk = (t & 1) * 4;  // the loader's row and first depth of a slice
  const int nc = t & (kBN - 1), nh = t >> 7;   // the norm's book row and half slice

  const int rb = blockIdx.x, split = blockIdx.y;
  const int t0 = (int)((long long)split * a.tiles / a.splits);
  const int t1 = (int)((long long)(split + 1) * a.tiles / a.splits);
  const int xrow = rb * kBM + lrow;
  const bool xok = xrow < a.N;
  const float* const xp = a.x + (size_t)(xok ? xrow : 0) * a.D + lk;
  const int ns = (a.D + BK - 1) / BK;  // slices a tile

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
    best_d[m * kSlotLd + tx] = CUDART_INF_F;
    best_i[m * kSlotLd + tx] = 0;
  }
  if constexpr (XRES) {
    for (int k = 0; k < ns * BK; k += 8)
      store_t(xs, lrow, k + lk, load4(xp + k, xok && k + lk < a.D));
  }

  const int G = (t1 - t0) * ns;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float nrm = 0.f;

  float4 rx[Q], rbk[Q];
  auto load = [&](int tile, int ks) {
    const int brow = tile * kBN + lrow;
    const float* bp = a.book + (size_t)(brow < a.K ? brow : 0) * a.D + lk;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int k = ks * BK + 8 * q;
      const bool kok = k + lk < a.D;
      if constexpr (!XRES) rx[q] = load4(xp + k, xok && kok);
      rbk[q] = load4(bp + k, kok && brow < a.K);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if constexpr (!XRES) store_t(xs + buf * BK * kLd, lrow, 8 * q + lk, rx[q]);
      store_t(bs + buf * BK * kLd, lrow, 8 * q + lk, rbk[q]);
    }
  };

  int tile = t0, ks = 0;
  if (G > 0) {
    load(tile, ks);
    store(0);
  }
  __syncthreads();
  for (int g = 0; g < G; ++g) {
    const int buf = g & 1;
    int nks = ks + 1, ntile = tile;
    if (nks == ns) {
      nks = 0;
      ++ntile;
    }
    const bool more = g + 1 < G;
    if (more) load(ntile, nks);
    const float* const xk = XRES ? xs + ks * BK * kLd : xs + buf * BK * kLd;
    const float* const bk = bs + buf * BK * kLd;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(xk + k * kLd + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(xk + k * kLd + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bk + k * kLd + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(bk + k * kLd + 64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int k = 0; k < BK / 2; ++k) {
      const float v = bk[(nh * BK / 2 + k) * kLd + nc];
      nrm = fmaf(v, v, nrm);
    }
    if (more) store(buf ^ 1);
    const bool last = ks == ns - 1;
    float* const np = npart + (tile & 1) * 2 * kBN;
    if (last) {
      np[nh * kBN + nc] = nrm;
      nrm = 0.f;
    }
    __syncthreads();
    if (last) {
      // fold the tile into the running slots, columns ascending
      const float4 p0 = *reinterpret_cast<const float4*>(np + tx * 4);
      const float4 p1 = *reinterpret_cast<const float4*>(np + 64 + tx * 4);
      const float4 q0 = *reinterpret_cast<const float4*>(np + kBN + tx * 4);
      const float4 q1 = *reinterpret_cast<const float4*>(np + kBN + 64 + tx * 4);
      const float nv[8] = {p0.x + q0.x, p0.y + q0.y, p0.z + q0.z, p0.w + q0.w,
                           p1.x + q1.x, p1.y + q1.y, p1.z + q1.z, p1.w + q1.w};
      const int c0 = tile * kBN + tx * 4;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
        float bd = best_d[m * kSlotLd + tx];
        int bi = best_i[m * kSlotLd + tx];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = c0 + (j < 4 ? j : 60 + j);
          const float d = fmaf(-2.f, acc[i][j], nv[j]);
          if (c < a.K && d < bd) {
            bd = d;
            bi = c;
          }
          acc[i][j] = 0.f;
        }
        best_d[m * kSlotLd + tx] = bd;
        best_i[m * kSlotLd + tx] = bi;
      }
    }
    tile = ntile;
    ks = nks;
  }
  __syncthreads();
  if (t < kBM) {
    float bd = best_d[t * kSlotLd];
    long long bi = best_i[t * kSlotLd];
#pragma unroll
    for (int q = 1; q < kSlots; ++q) {
      const float d = best_d[t * kSlotLd + q];
      const long long i = best_i[t * kSlotLd + q];
      if (before(d, i, bd, bi)) {
        bd = d;
        bi = i;
      }
    }
    const int row = rb * kBM + t;
    if (row < a.N) {
      a.part_d[(size_t)split * a.N + row] = bd;
      a.part_i[(size_t)split * a.N + row] = bi;
    }
  }
}

template <bool XRES>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const int smem = smem_floats<XRES>(a.D) * (int)sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(nearest_kernel<XRES>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  nearest_kernel<XRES><<<dim3((a.N + kBM - 1) / kBM, a.splits), kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// Each row's best over the splits' partials, by (d, index).
__global__ void nearest_merge_kernel(const float* part_d, const long long* part_i, float* out_d,
                                     long long* out_i, int N, int splits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  float bd = part_d[row];
  long long bi = part_i[row];
  for (int s = 1; s < splits; ++s) {
    const float d = part_d[(size_t)s * N + row];
    const long long i = part_i[(size_t)s * N + row];
    if (before(d, i, bd, bi)) {
      bd = d;
      bi = i;
    }
  }
  out_d[row] = bd;
  out_i[row] = bi;
}

}  // namespace nn
}  // namespace qt

// x (N, D), book (K, D): f32, contiguous, 16-byte aligned, D a multiple of
// 4.  part_d, part_i (splits, N); with splits > 1 the merge writes out_d,
// out_i (N,), with one split the partials are the outputs.  The nearest
// kernel, then (splits > 1) the merge: two launches, or one.
extern "C" int qt_nearest(const float* x, const float* book, float* part_d, long long* part_i,
                          float* out_d, long long* out_i, int N, int K, int D, int splits,
                          void* stream) {
  using namespace qt;
  if (N == 0) return 0;
  const int tiles = (K + nn::kBN - 1) / nn::kBN;
  if (K < 1 || D < 4 || D % 4 || splits < 1 || splits > tiles || splits > 65535 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(book)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const nn::Args a{x, book, part_d, part_i, N, K, D, tiles, splits};
  const cudaError_t err = D <= nn::kResidentD ? nn::launch<true>(a, s) : nn::launch<false>(a, s);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  nn::nearest_merge_kernel<<<(N + 255) / 256, 256, 0, s>>>(part_d, part_i, out_d, out_i, N,
                                                            splits);
  return static_cast<int>(cudaGetLastError());
}
