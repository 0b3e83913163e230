// precision_island for NVIDIA Hopper (sm_90a): a matmul in which each
// (block_m x block_n) output cell computes at its own precision tier.
//
// Replaces the Pallas kernel src/repro/kernels/precision_island.py::_kernel
// (and its _quant_rows(x, levels), now quant_rows.cu).
//
//   tier 0: dequant(int4(a) @ int4(b)^T)    levels 7, stored as int8
//   tier 1: dequant(int8(a) @ int8(b)^T)    levels 127
//   other : f32(a) @ f32(b)                 (the oracle's "else" branch)
//
// One call is, on one stream:
//   1. a one-block pass that reduces the tier map to a word of the tiers
//      present (bit t: tier t, bit 2: any other value) and zeroes the row
//      maxima of both operands;
//   2. the quantization of a and of b^T (quant_rows.cu): each operand's row
//      maxima found once, then one pass that reads the operand once and
//      writes the int8 copies of both levels, or only those the word holds
//      (none where the map has no integer cell), with no host sync;
//   3. the product pass.
// The workspace is the caller's and outlives the call: the int8 copies'
// tensor maps depend on it alone, so they are encoded once a workspace
// (precision_island_int_maps), and a call encodes only the float maps of a
// and b.
//
// How it differs from the kernel it replaces:
//   * The Pallas body computes all three products for every tile and then
//     selects.  A tier is uniform over a partition cell, so here a block
//     reads the tiers of the cells its 64 x 64 tile covers, forms the set of
//     products its elements need (block-uniform, no divergence) and runs
//     each as its own walk over K through the ring of tc_ring.cuh (shared
//     with razor_matmul.cu): int4, then int8, then f32.  A stage holds only
//     its walk's operands (a's and b's float tiles, or one level's int8
//     tiles), and each walk's epilogue writes only the elements of its
//     tier.  Where cells are 64 x 64 or more and aligned to the tile, as on
//     the precision-island path, a block makes exactly one walk; an integer
//     block then streams 1 byte an element of b, not 2 (bf16) or 4 (f32).
//   * The integer products are int32 on the tensor cores, exact as the
//     oracle's, where the Pallas body multiplies the integer values in f32;
//     the int4 tier holds values in [-7, 7] in int8 and runs on the same
//     int8 MMAs.  b is read through its strides, never transposed in device
//     memory.
//
// What bounds it on this card.  At a 256-row chunk against a full-width
// weight: the bytes of b (read by the quantization's two passes and once
// more by the product, as its float tiles or an int8 copy), and at bf16
// the tensor cores hardly (2MNK over the tiers' rates).  The ring keeps
// STAGES - 1 k-tiles in flight a block; the blocks that share a column tile
// of b run together (row tiles fastest) and read it from L2.
//
// Numerical contracts (one order, fixed by K and the operands' type, never
// by M or by the map):
//   1. int4 and int8 cells: the int32 sum is exact, then (float(acc) * sa) *
//      sb in the oracle's order: bit-equal to the plain version at any K
//      below 133,000.
//   2. f32 cells: k-tiles of 64 in ascending order, each tile's MMAs (bf16
//      wgmma, or the 3xTF32 split for f32 operands) into a fresh f32
//      fragment that is then added to the register sum (razor_matmul.cu's
//      contract 2).
//   3. A repeated call gives the same bits; no float atomics.  Edges are
//      masked by TMA zero-fill or clamped addresses, never by a branch
//      around a load.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

#include "tc_ring.cuh"

// the shared prologue (quant_rows.cu)
extern "C" int quant_rows_tiers_launch(const void* x, int R, int K, int Kp,
                                       long long s_r, long long s_k,
                                       int dtype, void* amax, void* q8,
                                       void* scale8, void* q4, void* scale4,
                                       const void* word, void* stream);

namespace {

using namespace tc_ring;

constexpr int WALKS = 3;          // int4, int8, f32: walk w computes tier w
constexpr int WORD_THREADS = 256;
// the int8 copies' tensor maps a workspace holds: qa4, qb4, qa8, qb8
constexpr int INT_MAPS = 4;
static_assert(sizeof(CUtensorMap) == 128,
              "kernels/precision_island.py _MAPS_BYTES");

// A stage of the ring holds one walk's operands: a's and b's float tiles,
// or one level's int8 tiles (at offset 0, b's at QA_BYTES)
template <typename T>
struct Stage {
  using L = Tile<T>;
  static constexpr int BYTES = L::A_BYTES + L::B_BYTES;
  static constexpr int SMEM_BYTES = STAGES * BYTES + 1024;   // + align
  static_assert(L::QA_BYTES + L::QB_BYTES <= BYTES && BYTES % 1024 == 0,
                "an int8 stage fits a float stage; stages on the 1024");
};

// the tier map: (M / block_m, N / block_n) int32, contiguous
struct Tiers {
  const int* map;
  int block_m, block_n, grid_n;
};

// each level's row scales (quant_rows.cu)
struct Scales {
  const float *a8, *b8, *a4, *b4;
};

// the walk that computes tier t: 0 (int4), 1 (int8), anything else 2 (f32)
__device__ __forceinline__ int walk_of_tier(int t) {
  return t == 0 ? 0 : (t == 1 ? 1 : 2);
}
__device__ __forceinline__ int walk_at(const Tiers& tz, int row, int col) {
  return walk_of_tier(
      __ldg(tz.map + (long long)(row / tz.block_m) * tz.grid_n +
            col / tz.block_n));
}

// word = OR of 1 << walk over the map; amax_a, amax_b zeroed
__global__ void __launch_bounds__(WORD_THREADS)
tier_word_kernel(const int* __restrict__ map, long long cells,
                 unsigned int* __restrict__ word,
                 unsigned int* __restrict__ amax_a, int M,
                 unsigned int* __restrict__ amax_b, int N) {
  const int tid = threadIdx.x;
  unsigned int bits = 0u;
  for (long long x = tid; x < cells; x += WORD_THREADS)
    bits |= 1u << walk_of_tier(__ldg(map + x));
  for (int r = tid; r < M; r += WORD_THREADS) amax_a[r] = 0u;
  for (int r = tid; r < N; r += WORD_THREADS) amax_b[r] = 0u;
  const unsigned int w = (__syncthreads_or(bits & 1u) ? 1u : 0u) |
                         (__syncthreads_or(bits & 2u) ? 2u : 0u) |
                         (__syncthreads_or(bits & 4u) ? 4u : 0u);
  if (tid == 0) *word = w;
}

// The thread's 32 values v of walk w into C, where the element's cell is of
// that walk's tier (pairs of columns as one 8-byte store where both are)
template <typename T>
__device__ __forceinline__ void store_walk(float* __restrict__ c,
                                           const float (&v)[32],
                                           const Tiers& tz, const Problem& p,
                                           int row0, int col0, int warp,
                                           int lane, int w) {
  const bool pairs = (p.N % 2) == 0;
#pragma unroll
  for (int f = 0; f < 8; ++f)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + frag_row<T>(warp, lane, f) + 8 * h;
      const int col = col0 + frag_col<T>(warp, lane, f);
      if (row >= p.M || col >= p.N) continue;
      const int e = 4 * f + 2 * h;
      const long long at = (long long)row * p.N + col;
      const bool mine0 = walk_at(tz, row, col) == w;
      const bool mine1 = col + 1 < p.N && walk_at(tz, row, col + 1) == w;
      if (mine0 && mine1 && pairs) {
        *reinterpret_cast<float2*>(c + at) = make_float2(v[e], v[e + 1]);
        continue;
      }
      if (mine0) c[at] = v[e];
      if (mine1) c[at + 1] = v[e + 1];
    }
}

template <typename T, bool KFAST>
__global__ void __launch_bounds__(BLOCK, 2)
precision_island_kernel(const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_b,
                        const __grid_constant__ CUtensorMap map_qa4,
                        const __grid_constant__ CUtensorMap map_qb4,
                        const __grid_constant__ CUtensorMap map_qa8,
                        const __grid_constant__ CUtensorMap map_qb8,
                        const T* __restrict__ a, const T* __restrict__ b,
                        Scales sc, Tiers tz, float* __restrict__ c,
                        Problem p) {
  using L = Tile<T>;
  using S = Stage<T>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  unsigned char* smem = align1024(smem_raw);

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const bool by_hand = !p.a_tma || !p.b_tma;

  if (tid == 0) ring_init(full, empty, by_hand);
  // the walks of this block: the tiers of the cells its tile covers
  const int ci0 = row0 / tz.block_m, cj0 = col0 / tz.block_n;
  const int ci1 = (min(row0 + BM, p.M) - 1) / tz.block_m;
  const int cj1 = (min(col0 + BN, p.N) - 1) / tz.block_n;
  const int ncj = cj1 - cj0 + 1;
  unsigned int need = 0u;
  for (int x = tid; x < (ci1 - ci0 + 1) * ncj; x += BLOCK)
    need |= 1u << walk_of_tier(__ldg(
                tz.map + (long long)(ci0 + x / ncj) * tz.grid_n + cj0 +
                x % ncj));
  // block-uniform (and, as a barrier, after the ring's init)
  const unsigned int walks = (__syncthreads_or(need & 1u) ? 1u : 0u) |
                             (__syncthreads_or(need & 2u) ? 2u : 0u) |
                             (__syncthreads_or(need & 4u) ? 4u : 0u);

  if (tid >= THREADS) {
    // ---- the producer warp: every walk's k-tiles, in the walks' order
    const int lane = tid - THREADS;
    const uint32_t float_bytes =
        (p.a_tma ? L::A_BYTES : 0) + (p.b_tma ? L::B_BYTES : 0);
    int g = 0;
    for (int w = 0; w < WALKS; ++w) {
      if (!((walks >> w) & 1u)) continue;
      for (int i = 0; i < p.k_tiles; ++i, ++g) {
        ring_acquire(empty, g);
        unsigned char* st = smem + (g % STAGES) * S::BYTES;
        const uint32_t bar = smem_u32(full + g % STAGES);
        const int k0 = i * BK;
        if (w == 2) {
          stage_open(bar, float_bytes, lane);
          tma_float_tiles<T, KFAST>(lane, st, st + L::A_BYTES, &map_a,
                                    &map_b, bar, p, k0, row0, col0);
          if (by_hand)
            float_tiles_by_hand<T, KFAST>(lane, st, st + L::A_BYTES, a, b, p,
                                          k0, row0, col0);
        } else {
          stage_open(bar, L::QA_BYTES + L::QB_BYTES, lane);
          tma_int_tiles(lane, 0, st, st + L::QA_BYTES,
                        w == 1 ? &map_qa8 : &map_qa4,
                        w == 1 ? &map_qb8 : &map_qb4, bar, k0, row0, col0);
        }
        if (by_hand) stage_close_by_hand(bar);
      }
    }
    return;
  }

  // ---- the MMA warps (one warpgroup)
  const int lane = tid & 31, warp = tid >> 5;
  const int wr = (warp & 1) * 32, wc = (warp >> 1) * 32;   // f32: mma.sync
  int g = 0;
  for (int w = 0; w < WALKS; ++w) {
    if (!((walks >> w) & 1u)) continue;
    float v[32];
    if (w == 2) {
      // f32: a fresh sum a k-tile, added to the register sum in order
      float t[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) v[e] = t[e] = 0.0f;
      for (int i = 0; i < p.k_tiles; ++i, ++g) {
        ring_wait(full, g);
        const unsigned char* As = smem + (g % STAGES) * S::BYTES;
        const unsigned char* Bs = As + L::A_BYTES;
        if constexpr (sizeof(T) == 2) {
          wgmma_fence();
          issue_bf16_tile<KFAST>(As, Bs, t);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(t);
        } else {
#pragma unroll
          for (int e = 0; e < 32; ++e) t[e] = 0.0f;
          tf32_tile<KFAST>(As, Bs, t, wr, wc, lane);
        }
        ring_release(empty, g, lane);
#pragma unroll
        for (int e = 0; e < 32; ++e) v[e] += t[e];
      }
    } else {
      // int4 / int8: one exact int32 sum over K
      int iacc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) iacc[e] = 0;
      for (int i = 0; i < p.k_tiles; ++i, ++g) {
        ring_wait(full, g);
        const unsigned char* Qa = smem + (g % STAGES) * S::BYTES;
        const unsigned char* Qb = Qa + L::QA_BYTES;
        if constexpr (sizeof(T) == 2) {
          wgmma_fence();
          issue_s8_tile(Qa, Qb, iacc);
          wgmma_commit();
          wgmma_wait<0>();
        } else {
          s8_tile(Qa, Qb, iacc, wr, wc, lane);
        }
        ring_release(empty, g, lane);
      }
      if constexpr (sizeof(T) == 2) fence_regs(iacc);
      const float* sa = w == 1 ? sc.a8 : sc.a4;
      const float* sb = w == 1 ? sc.b8 : sc.b4;
#pragma unroll
      for (int f = 0; f < 8; ++f)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // scales from clamped rows and columns (those outside C are not
          // stored)
          const int row = min(row0 + frag_row<T>(warp, lane, f) + 8 * h,
                              p.M - 1);
          const int col = col0 + frag_col<T>(warp, lane, f);
          const int e = 4 * f + 2 * h;
          const float s_a = __ldg(sa + row);
          v[e] = dequant(iacc[e], s_a, __ldg(sb + min(col, p.N - 1)));
          v[e + 1] = dequant(iacc[e + 1], s_a,
                             __ldg(sb + min(col + 1, p.N - 1)));
        }
    }
    store_walk<T>(c, v, tz, p, row0, col0, warp, lane, w);
  }
}

// the workspace, carved in this order, each piece WS_ALIGN-aligned
// (kernels/precision_island.py::LaunchPlan.workspace_pieces lists the same)
struct Workspace {
  unsigned int* word;
  unsigned int *amax_a, *amax_b;
  int8_t *qa8, *qb8, *qa4, *qb4;
  float *sa8, *sb8, *sa4, *sb4;
};

long long carve(unsigned char* ws, int M, int N, int Kp, Workspace* w) {
  long long off = 0;
  auto take = [&](long long bytes) {
    unsigned char* p = ws + off;
    off += (bytes + WS_ALIGN - 1) / WS_ALIGN * WS_ALIGN;
    return p;
  };
  w->word = reinterpret_cast<unsigned int*>(take(4));
  w->amax_a = reinterpret_cast<unsigned int*>(take(4LL * M));
  w->amax_b = reinterpret_cast<unsigned int*>(take(4LL * N));
  w->qa8 = reinterpret_cast<int8_t*>(take((long long)M * Kp));
  w->qb8 = reinterpret_cast<int8_t*>(take((long long)N * Kp));
  w->qa4 = reinterpret_cast<int8_t*>(take((long long)M * Kp));
  w->qb4 = reinterpret_cast<int8_t*>(take((long long)N * Kp));
  w->sa8 = reinterpret_cast<float*>(take(4LL * M));
  w->sb8 = reinterpret_cast<float*>(take(4LL * N));
  w->sa4 = reinterpret_cast<float*>(take(4LL * M));
  w->sb4 = reinterpret_cast<float*>(take(4LL * N));
  return off;
}

// the int8 copies' maps of the workspace w, in INT_MAPS order; false where
// the TMA cannot take one
bool encode_int_maps(const Workspace& w, int M, int N, int Kp,
                     CUtensorMap (&q)[INT_MAPS]) {
  return int_map(&q[0], w.qa4, M, Kp) && int_map(&q[1], w.qb4, N, Kp) &&
         int_map(&q[2], w.qa8, M, Kp) && int_map(&q[3], w.qb8, N, Kp);
}

template <typename T>
int launch_product(const void* a_, const void* b_, const Workspace& w,
                   const CUtensorMap (&q)[INT_MAPS], const Tiers& tz,
                   float* c, int M, int N, int K, long long sa_m,
                   long long sa_k, long long sb_k, long long sb_n,
                   cudaStream_t stream) {
  static bool attrs_set = false;
  if (!attrs_set) {
    const decltype(&precision_island_kernel<T, false>) kernels[] = {
        precision_island_kernel<T, false>, precision_island_kernel<T, true>};
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
  CUtensorMap map_a = {}, map_b = {};
  const Problem p =
      float_maps<T>(&map_a, &map_b, a, b, M, N, K, sa_m, sa_k, sb_k, sb_n);
  const Scales sc{w.sa8, w.sb8, w.sa4, w.sb4};
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  const int smem = Stage<T>::SMEM_BYTES;
  if (b_kfast(sb_k, sb_n))
    precision_island_kernel<T, true><<<grid, BLOCK, smem, stream>>>(
        map_a, map_b, q[0], q[1], q[2], q[3], a, b, sc, tz, c, p);
  else
    precision_island_kernel<T, false><<<grid, BLOCK, smem, stream>>>(
        map_a, map_b, q[0], q[1], q[2], q[3], a, b, sc, tz, c, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The tensor maps of the int8 copies that the workspace ws (ws_bytes, 16-byte
// aligned) holds for an (M, K) @ (K, N) call, written to `maps`: host
// memory of INT_MAPS CUtensorMaps (qa4, qb4, qa8, qb8).  They depend on the
// workspace alone, so a caller that keeps its workspace encodes them once
// (kernels/precision_island.py keeps one a shape) and passes them to every
// precision_island_launch on it.  Returns 0, cudaErrorInvalidValue for a
// workspace too small, cudaErrorNotSupported where the TMA cannot take a
// copy.
extern "C" int precision_island_int_maps(void* ws, long long ws_bytes, int M,
                                         int N, int K, void* maps) {
  if (M <= 0 || N <= 0 || K <= 0 || !aligned16(ws) || maps == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Kp = (K + K_PAD - 1) / K_PAD * K_PAD;
  Workspace w;
  if (carve(static_cast<unsigned char*>(ws), M, N, Kp, &w) > ws_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap q[INT_MAPS];
  if (!encode_int_maps(w, M, N, Kp, q))
    return static_cast<int>(cudaErrorNotSupported);
  std::memcpy(maps, q, sizeof q);
  return 0;
}

// One precision_island call on `stream`: the tier word, the quantizations of
// a and b^T, the product pass.  dtype: 0 = float32, 1 = bfloat16 (a and b
// share it).  Strides in elements.  tiers: (M / block_m, N / block_n)
// int32, contiguous.  ws is a 16-byte aligned scratch of ws_bytes >= the
// carve above (LaunchPlan.workspace_bytes); int_maps are its int8 copies'
// maps from precision_island_int_maps at the same M, N, K.  Returns the
// first CUDA error (0 = launched).
extern "C" int precision_island_launch(
    const void* a, const void* b, const void* tiers, void* ws,
    long long ws_bytes, const void* int_maps, void* c, int M, int N, int K,
    long long sa_m, long long sa_k, long long sb_k, long long sb_n,
    int block_m, int block_n, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || block_m <= 0 || block_n <= 0 ||
      M % block_m != 0 || N % block_n != 0 || (N + BN - 1) / BN > 65535 ||
      (long long)(M / block_m) * (N / block_n) > 0x7FFFFFFFLL ||
      !aligned16(ws) || int_maps == nullptr || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int Kp = (K + K_PAD - 1) / K_PAD * K_PAD;
  Workspace w;
  if (carve(static_cast<unsigned char*>(ws), M, N, Kp, &w) > ws_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap q[INT_MAPS];                 // aligned copies of the caller's
  std::memcpy(q, int_maps, sizeof q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Tiers tz{static_cast<const int*>(tiers), block_m, block_n,
                 N / block_n};
  tier_word_kernel<<<1, WORD_THREADS, 0, s>>>(
      tz.map, (long long)(M / block_m) * tz.grid_n, w.word, w.amax_a, M,
      w.amax_b, N);
  int err = static_cast<int>(cudaGetLastError());
  if (err == 0)
    err = quant_rows_tiers_launch(a, M, K, Kp, sa_m, sa_k, dtype, w.amax_a,
                                  w.qa8, w.sa8, w.qa4, w.sa4, w.word, stream);
  if (err == 0)
    err = quant_rows_tiers_launch(b, N, K, Kp, sb_n, sb_k, dtype, w.amax_b,
                                  w.qb8, w.sb8, w.qb4, w.sb4, w.word, stream);
  if (err != 0) return err;
  float* cc = static_cast<float*>(c);
  return dtype == 0 ? launch_product<float>(a, b, w, q, tz, cc, M, N, K, sa_m,
                                            sa_k, sb_k, sb_n, s)
                    : launch_product<__nv_bfloat16>(a, b, w, q, tz, cc, M, N,
                                                    K, sa_m, sa_k, sb_k, sb_n,
                                                    s);
}
