// razor_matmul for NVIDIA Hopper (sm_90a): Razor double-sampled matmul.
//
// Replaces the Pallas kernel src/repro/kernels/razor_matmul.py::_kernel
// (and its _quant_rows, now quant_rows.cu).
//
//   main   = dequant(int8(a) @ int8(b)^T)       the near-threshold path
//   shadow = f32(a) @ f32(b)                    the delayed shadow register
//   per (block_m x block_n) partition cell:
//     rel   = ||main - shadow||_F / (||shadow||_F + 1e-12)
//     fired = rel > tol;  C = fired ? shadow : main      (Razor replay)
//   plus the flag map, the rel map and the fired-cell count.
//
// How it differs from the kernel it replaces:
//   * The Pallas program holds a whole (block, K) row panel, quantizes it
//     again in every tile and multiplies the integer values in f32 (exact
//     only while partial sums stay below 2^24; K * 127^2 passes that at
//     K = 1041).  Here the scales and int8 copies are taken once per operand
//     (quant_rows.cu), and the integer product is int32 on the tensor cores,
//     exact as the oracle's, so a main-path cell equals the plain version
//     bit for bit at any K below 133,000.
//   * A cell's decision needs the whole cell, and a cell (128 x 128 from
//     select_blocks) is larger than a launch tile.  So one call is, on one
//     stream: the two quantizations, a product pass that writes main and
//     shadow, a cell-sums pass and a cell-select pass.
//
// What bounds it on this card.  At a 256-row prefill chunk against a
// full-width weight: the tensor cores (2MNK bf16 + 2MNK int8) and the bytes
// of b, read once for the shadow and once more as its int8 copy.  What the
// design does:
//   * Both products on the tensor cores, fed through a ring of k-tiles by
//     TMA (tc_ring.cuh, shared with precision_island.cu): a block computes a
//     64 x 64 tile of C with one warpgroup of four MMA warps (bf16: the
//     whole tile by wgmma, m64n64k32 int8 into int32 and m64n64k16 bf16
//     into f32; f32: 32 x 32 a warp by mma.sync, m16n8k32 int8 and a
//     3xTF32 split on m16n8k8) and one producer warp.  A stage holds a, b
//     and their int8 copies; the MMA warps hand it back as soon as they are
//     done with it.  Operands the TMA cannot take (a ragged 96 x 100 x 80
//     product, a transposed view) are loaded by the producer's lanes into
//     the same swizzled layout.
//   * Blocks are ordered with the row tiles fastest, so the blocks that
//     share a column tile of b run together and read it from L2.
//   * The cell passes run over (cell, slice) grids: the sums pass reads
//     main and shadow once; the select pass reads only the plane the cell
//     keeps.  Loads are 16 bytes where the cell's rows allow it.
//
// Numerical contracts:
//   1. Main cells: the int32 sum is exact, then (float(acc) * sa) * sb, the
//      oracle's order: bit-equal to the plain version.
//   2. One summation order for the shadow: k-tiles of 64 in ascending order;
//      each tile's MMAs go into a fresh f32 fragment that is then added to
//      the register sum, which keeps the tensor core's own accumulation to
//      one tile (as systolic_mac.cu does; accumulated on the tensor cores
//      over K = 8192, the bf16 shadow reached the 1e-5 x max|C| limit).
//   3. The cell sums run in one fixed order (each thread ascending, a fixed
//      tree, the slices in order), so a repeated call gives the same bits,
//      flags and count.  No float atomics; the count is an integer
//      atomicAdd of one per fired cell.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_ring.cuh"

// the shared prologue (quant_rows.cu)
extern "C" int quant_rows_launch(const void* x, int R, int K, int Kp,
                                 long long s_r, long long s_k, float levels,
                                 int dtype, void* amax, void* q, void* scale,
                                 void* stream);

namespace {

using namespace tc_ring;

constexpr int CELL_THREADS = 256;
constexpr int MAX_SLICES = 64;  // slices of a cell in the cell passes

// A stage of the product's ring: a's and b's float tiles, then their int8
// copies' tiles
template <typename T>
struct Stage {
  using L = Tile<T>;
  static constexpr int BYTES = L::A_BYTES + L::B_BYTES + L::QA_BYTES +
                               L::QB_BYTES;
  static constexpr int SMEM_BYTES = STAGES * BYTES + 1024;   // + align
  static_assert(BYTES % 1024 == 0, "stages start on the swizzle's 1024");
};

// One k-tile of the bf16 path on the warpgroup, issued as one group: the
// shadow's four k16 steps into a fresh sum t, the main path's two k32 steps
// into iacc.  The caller waits for it.
template <bool KFAST>
__device__ __forceinline__ void issue_bf16(const unsigned char* As,
                                           const unsigned char* Bs,
                                           const unsigned char* Qa,
                                           const unsigned char* Qb,
                                           float (&t)[32], int (&iacc)[32]) {
  wgmma_fence();
  issue_bf16_tile<KFAST>(As, Bs, t);
  issue_s8_tile(Qa, Qb, iacc);
  wgmma_commit();
}

// One k-tile of the f32 path on a warp (mma.sync, 32 x 32): the shadow's
// 3xTF32 products into a fresh sum t, the int8 products into iacc.
template <bool KFAST>
__device__ __forceinline__ void stage_f32(const unsigned char* As,
                                          const unsigned char* Bs,
                                          const unsigned char* Qa,
                                          const unsigned char* Qb,
                                          float (&t)[32], int (&iacc)[32],
                                          int wr, int wc, int lane) {
  tf32_tile<KFAST>(As, Bs, t, wr, wc, lane);
  s8_tile(Qa, Qb, iacc, wr, wc, lane);
}

template <typename T, bool KFAST>
__global__ void __launch_bounds__(BLOCK, 2)
razor_product_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     const __grid_constant__ CUtensorMap map_qa,
                     const __grid_constant__ CUtensorMap map_qb,
                     const T* __restrict__ a, const T* __restrict__ b,
                     const float* __restrict__ scale_a,
                     const float* __restrict__ scale_b,
                     float* __restrict__ main_out,
                     float* __restrict__ shadow_out, Problem p) {
  using L = Tile<T>;
  using S = Stage<T>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  unsigned char* smem = align1024(smem_raw);

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const bool by_hand = !p.a_tma || !p.b_tma;

  if (tid == 0) ring_init(full, empty, by_hand);
  __syncthreads();

  if (tid >= THREADS) {
    // ---- the producer warp
    const int lane = tid - THREADS;
    const uint32_t tx_bytes = (p.a_tma ? L::A_BYTES : 0) +
                              (p.b_tma ? L::B_BYTES : 0) + L::QA_BYTES +
                              L::QB_BYTES;
    for (int i = 0; i < p.k_tiles; ++i) {
      ring_acquire(empty, i);
      unsigned char* As = smem + (i % STAGES) * S::BYTES;
      unsigned char* Bs = As + L::A_BYTES;
      unsigned char* Qa = Bs + L::B_BYTES;
      unsigned char* Qb = Qa + L::QA_BYTES;
      const uint32_t bar = smem_u32(full + i % STAGES);
      const int k0 = i * BK;
      stage_open(bar, tx_bytes, lane);
      // one box a lane: a's on lanes 0.., b's on lanes 2.., the int8 copies
      // on lanes 4 and 5
      tma_float_tiles<T, KFAST>(lane, As, Bs, &map_a, &map_b, bar, p, k0,
                                row0, col0);
      tma_int_tiles(lane, 4, Qa, Qb, &map_qa, &map_qb, bar, k0, row0, col0);
      if (!by_hand) continue;
      float_tiles_by_hand<T, KFAST>(lane, As, Bs, a, b, p, k0, row0, col0);
      stage_close_by_hand(bar);
    }
    return;
  }

  // ---- the MMA warps (one warpgroup)
  const int lane = tid & 31, warp = tid >> 5;
  float acc[32], t[32];             // the sum, and one k-tile's
  int iacc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    acc[e] = t[e] = 0.0f;
    iacc[e] = 0;
  }
  for (int i = 0; i < p.k_tiles; ++i) {
    ring_wait(full, i);
    const unsigned char* As = smem + (i % STAGES) * S::BYTES;
    const unsigned char* Bs = As + L::A_BYTES;
    const unsigned char* Qa = Bs + L::B_BYTES;
    const unsigned char* Qb = Qa + L::QA_BYTES;
    if constexpr (sizeof(T) == 2) {
      // (a second tile sum, to add one k-tile while the next one runs,
      // makes ptxas serialize the wgmmas: slower on the card)
      issue_bf16<KFAST>(As, Bs, Qa, Qb, t, iacc);
      wgmma_wait<0>();
      fence_regs(t);
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) t[e] = 0.0f;
      stage_f32<KFAST>(As, Bs, Qa, Qb, t, iacc, (warp & 1) * 32,
                       (warp >> 1) * 32, lane);
    }
    ring_release(empty, i, lane);
    // the k-tile's sum into the f32 register sum, in one fixed order
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] += t[e];
  }
  if constexpr (sizeof(T) == 2) fence_regs(iacc);

  // ---- epilogue: dequantize the main path, write both planes
  const bool pairs = (p.N % 2) == 0;
#pragma unroll
  for (int f = 0; f < 8; ++f)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + frag_row<T>(warp, lane, f) + 8 * h;
      const int col = col0 + frag_col<T>(warp, lane, f);
      if (row >= p.M || col >= p.N) continue;
      const float sa = scale_a[row];
      const int e = 4 * f + 2 * h;
      const long long at = (long long)row * p.N + col;
      const float m0 = dequant(iacc[e], sa, scale_b[col]);
      const float s0 = acc[e];
      if (col + 1 < p.N) {
        const float m1 = dequant(iacc[e + 1], sa, scale_b[col + 1]);
        const float s1 = acc[e + 1];
        if (pairs) {
          *reinterpret_cast<float2*>(main_out + at) = make_float2(m0, m1);
          *reinterpret_cast<float2*>(shadow_out + at) = make_float2(s0, s1);
          continue;
        }
        main_out[at + 1] = m1;
        shadow_out[at + 1] = s1;
      }
      main_out[at] = m0;
      shadow_out[at] = s0;
    }
}

// ---- the cell passes over (cell, slice): a slice is a contiguous range of
// the cell's elements in row-major order, taken V at a time (V = 4 where
// the cell's rows and C's rows are multiples of 4 floats)

struct Cells {
  int N, block_m, block_n, grid_n, slices;
};

template <int V>
__device__ __forceinline__ void slice_range(const Cells& c, long long* base,
                                            long long* lo, long long* hi) {
  const int cell = blockIdx.x, slice = blockIdx.y;
  const int ci = cell / c.grid_n, cj = cell % c.grid_n;
  *base = (long long)ci * c.block_m * c.N + (long long)cj * c.block_n;
  const long long units = (long long)c.block_m * c.block_n / V;
  *lo = units * slice / c.slices;
  *hi = units * (slice + 1) / c.slices;
}

template <int V>
__device__ __forceinline__ long long unit_at(const Cells& c, long long base,
                                             long long u) {
  const int per_row = c.block_n / V;
  return base + (u / per_row) * c.N + (u % per_row) * V;
}

template <int V>
__device__ __forceinline__ void load_units(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = w.x;
    v[1] = w.y;
    v[2] = w.z;
    v[3] = w.w;
  } else {
    v[0] = __ldg(p);
  }
}

// partial[cell, slice] = (sum (main - shadow)^2, sum shadow^2) over the
// slice: each thread ascending, then a fixed tree
template <int V>
__global__ void __launch_bounds__(CELL_THREADS)
razor_cell_sums_kernel(const float* __restrict__ main_in,
                       const float* __restrict__ shadow_in,
                       float* __restrict__ partial, Cells c) {
  __shared__ float red_d[CELL_THREADS];
  __shared__ float red_s[CELL_THREADS];
  const int tid = threadIdx.x;
  long long base, lo, hi;
  slice_range<V>(c, &base, &lo, &hi);
  float d2 = 0.0f, s2 = 0.0f;
#pragma unroll 2
  for (long long u = lo + tid; u < hi; u += CELL_THREADS) {
    const long long at = unit_at<V>(c, base, u);
    float m[V], s[V];
    load_units<V>(main_in + at, m);
    load_units<V>(shadow_in + at, s);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float d = m[i] - s[i];
      d2 = fmaf(d, d, d2);
      s2 = fmaf(s[i], s[i], s2);
    }
  }
  red_d[tid] = d2;
  red_s[tid] = s2;
  __syncthreads();
  for (int half = CELL_THREADS / 2; half > 0; half /= 2) {
    if (tid < half) {
      red_d[tid] += red_d[tid + half];
      red_s[tid] += red_s[tid + half];
    }
    __syncthreads();
  }
  if (tid == 0) {
    const long long at = 2LL * ((long long)blockIdx.x * c.slices + blockIdx.y);
    partial[at] = red_d[0];
    partial[at + 1] = red_s[0];
  }
}

// every slice block sums its cell's partials in slice order (the same bits
// in each), decides, and copies the plane the cell keeps; slice 0 writes the
// cell's rel and flag and counts it
template <int V>
__global__ void __launch_bounds__(CELL_THREADS)
razor_cell_select_kernel(const float* __restrict__ main_in,
                         const float* __restrict__ shadow_in,
                         const float* __restrict__ partial,
                         float* __restrict__ out, int* __restrict__ flags,
                         float* __restrict__ rel, int* __restrict__ count,
                         Cells c, float tol) {
  __shared__ int fired_s;
  const int tid = threadIdx.x;
  const int cell = blockIdx.x;
  if (tid == 0) {
    const float* pc = partial + 2LL * cell * c.slices;
    float d2 = 0.0f, s2 = 0.0f;
    for (int s = 0; s < c.slices; ++s) {
      d2 += pc[2 * s];
      s2 += pc[2 * s + 1];
    }
    const float r = __fdiv_rn(sqrtf(d2), sqrtf(s2) + 1e-12f);
    const int f = r > tol ? 1 : 0;
    if (blockIdx.y == 0) {
      rel[cell] = r;
      flags[cell] = f;
      if (f && count != nullptr) atomicAdd(count, 1);
    }
    fired_s = f;
  }
  __syncthreads();
  const float* src = fired_s ? shadow_in : main_in;
  long long base, lo, hi;
  slice_range<V>(c, &base, &lo, &hi);
#pragma unroll 2
  for (long long u = lo + tid; u < hi; u += CELL_THREADS) {
    const long long at = unit_at<V>(c, base, u);
    if constexpr (V == 4)
      *reinterpret_cast<float4*>(out + at) =
          __ldg(reinterpret_cast<const float4*>(src + at));
    else
      out[at] = __ldg(src + at);
  }
}

// the workspace, carved in this order, each piece WS_ALIGN-aligned
// (kernels/razor_matmul.py::LaunchPlan.workspace_bytes computes the same)
struct Workspace {
  int8_t *qa, *qb;
  float *sa, *sb;
  unsigned int *amax_a, *amax_b;
  float *main, *shadow, *partial;
};

long long carve(unsigned char* ws, int M, int N, int Kp, long long cells,
                int slices, Workspace* w) {
  long long off = 0;
  auto take = [&](long long bytes) {
    unsigned char* p = ws + off;
    off += (bytes + WS_ALIGN - 1) / WS_ALIGN * WS_ALIGN;
    return p;
  };
  w->qa = reinterpret_cast<int8_t*>(take((long long)M * Kp));
  w->qb = reinterpret_cast<int8_t*>(take((long long)N * Kp));
  w->sa = reinterpret_cast<float*>(take(4LL * M));
  w->sb = reinterpret_cast<float*>(take(4LL * N));
  w->amax_a = reinterpret_cast<unsigned int*>(take(4LL * M));
  w->amax_b = reinterpret_cast<unsigned int*>(take(4LL * N));
  w->main = reinterpret_cast<float*>(take(4LL * M * N));
  w->shadow = reinterpret_cast<float*>(take(4LL * M * N));
  w->partial = reinterpret_cast<float*>(take(8LL * cells * slices));
  return off;
}

template <typename T>
int launch_product(const void* a_, const void* b_, const Workspace& w,
                   int M, int N, int K, int Kp, long long sa_m,
                   long long sa_k, long long sb_k, long long sb_n,
                   cudaStream_t stream) {
  static bool attrs_set = false;
  if (!attrs_set) {
    const decltype(&razor_product_kernel<T, false>) kernels[] = {
        razor_product_kernel<T, false>, razor_product_kernel<T, true>};
    for (auto kernel : kernels) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          Stage<T>::SMEM_BYTES);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    attrs_set = true;
  }
  const T* a = static_cast<const T*>(a_);
  const T* b = static_cast<const T*>(b_);
  CUtensorMap map_a = {}, map_b = {}, map_qa = {}, map_qb = {};
  const Problem p =
      float_maps<T>(&map_a, &map_b, a, b, M, N, K, sa_m, sa_k, sb_k, sb_n);
  if (!int_map(&map_qa, w.qa, M, Kp) || !int_map(&map_qb, w.qb, N, Kp))
    return static_cast<int>(cudaErrorNotSupported);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  const int smem = Stage<T>::SMEM_BYTES;
  if (b_kfast(sb_k, sb_n))
    razor_product_kernel<T, true><<<grid, BLOCK, smem, stream>>>(
        map_a, map_b, map_qa, map_qb, a, b, w.sa, w.sb, w.main, w.shadow, p);
  else
    razor_product_kernel<T, false><<<grid, BLOCK, smem, stream>>>(
        map_a, map_b, map_qa, map_qb, a, b, w.sa, w.sb, w.main, w.shadow, p);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int launch_cells(const Workspace& w, float* c, int* flags, float* rel,
                 int* count, const Cells& cells, int grid_m, float tol,
                 cudaStream_t stream) {
  const dim3 grid(grid_m * cells.grid_n, cells.slices);
  razor_cell_sums_kernel<V><<<grid, CELL_THREADS, 0, stream>>>(
      w.main, w.shadow, w.partial, cells);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  razor_cell_select_kernel<V><<<grid, CELL_THREADS, 0, stream>>>(
      w.main, w.shadow, w.partial, c, flags, rel, count, cells, tol);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One razor_matmul call on `stream`: the quantizations of a and b^T
// (quant_rows_launch), the product pass, the two cell passes.  dtype: 0 =
// float32, 1 = bfloat16 (a and b share it).  Strides in elements.  ws is a
// 16-byte aligned scratch of ws_bytes >= the carve below (LaunchPlan.
// workspace_bytes); slices is LaunchPlan.slices.  count may be null (no
// fused reduction); else it is zeroed on the stream first.  Returns the
// first CUDA error (0 = launched).
extern "C" int razor_matmul_launch(
    const void* a, const void* b, void* ws, long long ws_bytes, void* c,
    void* flags, void* rel, void* count, int M, int N, int K, long long sa_m,
    long long sa_k, long long sb_k, long long sb_n, int block_m, int block_n,
    int slices, float tol, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || block_m <= 0 || block_n <= 0 ||
      M % block_m != 0 || N % block_n != 0 || (N + BN - 1) / BN > 65535 ||
      (long long)(M / block_m) * (N / block_n) > 0x7FFFFFFFLL ||
      slices < 1 || slices > MAX_SLICES || !aligned16(ws) ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int Kp = (K + K_PAD - 1) / K_PAD * K_PAD;
  const int grid_m = M / block_m, grid_n = N / block_n;
  Workspace w;
  if (carve(static_cast<unsigned char*>(ws), M, N, Kp,
            (long long)grid_m * grid_n, slices, &w) > ws_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* ct = static_cast<int*>(count);
  if (ct != nullptr) {
    const cudaError_t e = cudaMemsetAsync(ct, 0, sizeof(int), s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int err = quant_rows_launch(a, M, K, Kp, sa_m, sa_k, 127.0f, dtype,
                              w.amax_a, w.qa, w.sa, stream);
  if (err == 0)
    err = quant_rows_launch(b, N, K, Kp, sb_n, sb_k, 127.0f, dtype, w.amax_b,
                            w.qb, w.sb, stream);
  if (err == 0)
    err = dtype == 0
              ? launch_product<float>(a, b, w, M, N, K, Kp, sa_m, sa_k, sb_k,
                                      sb_n, s)
              : launch_product<__nv_bfloat16>(a, b, w, M, N, K, Kp, sa_m,
                                              sa_k, sb_k, sb_n, s);
  if (err != 0) return err;
  const Cells cells{N, block_m, block_n, grid_n, slices};
  float* cc = static_cast<float*>(c);
  int* fl = static_cast<int*>(flags);
  float* rl = static_cast<float*>(rel);
  if (block_n % 4 == 0 && N % 4 == 0 && aligned16(cc))
    return launch_cells<4>(w, cc, fl, rl, ct, cells, grid_m, tol, s);
  return launch_cells<1>(w, cc, fl, rl, ct, cells, grid_m, tol, s);
}
