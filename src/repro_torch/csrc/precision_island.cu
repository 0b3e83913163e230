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
// How it differs from the kernel it replaces:
//   * The Pallas body computes all three products for every tile and then
//     selects.  The tier is uniform over a partition cell, so here a block
//     computes only the products its outputs need: it reads the tiers of its
//     64 x 64 tile's elements first and runs the f32, int8 and int4 K loops
//     only where some element asks for them (block-uniform decisions, no
//     divergence).  Where cells are at least 64 x 64 and aligned to the
//     tile, as on the precision-island path, a block runs exactly one.
//   * The integer products are int32 (__dp4a), exact as the oracle's, where
//     the Pallas body multiplies the integer values in f32; an int4 or int8
//     cell equals the plain version bit for bit.
//   * The scales come from quant_rows.cu, once per operand and level; b is
//     read through its strides and never transposed in device memory.
//
// Bound on this card: at a 256-row chunk against a full-width weight, the
// arithmetic of the tiers the map asks for, issued on the CUDA cores (fmaf,
// dp4a), not the tensor cores, in this first version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_products.cuh"

namespace {

using namespace tile_products;

struct Quantized {
  const int8_t *qa8, *qb8, *qa4, *qb4;
  const float *sa8, *sb8, *sa4, *sb4;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
precision_island_kernel(const T* __restrict__ a, const T* __restrict__ b,
                        Quantized qz, const int* __restrict__ tiers,
                        float* __restrict__ c, Operands o, int block_m,
                        int block_n, int grid_n) {
  __shared__ FloatTiles fs;
  __shared__ IntTiles is8;
  __shared__ IntTiles is4;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;

  auto tier_at = [&](int row, int col) {
    return tiers[(long long)(row / block_m) * grid_n + col / block_n];
  };
  int need = 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + tx + j * TX;
      if (row < o.M && col < o.N) {
        const int t = tier_at(row, col);
        need |= t == 0 ? 1 : (t == 1 ? 2 : 4);
      }
    }
  }
  const bool need4 = __syncthreads_or(need & 1) != 0;
  const bool need8 = __syncthreads_or(need & 2) != 0;
  const bool needf = __syncthreads_or(need & 4) != 0;

  float acc[TM][TN];
  int acc8[TM][TN], acc4[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc[i][j] = 0.0f;
      acc8[i][j] = 0;
      acc4[i][j] = 0;
    }
  for (int k0 = 0; k0 < o.K; k0 += BK) {
    if (needf) load_float_tiles(fs, a, b, o, row0, col0, k0);
    if (need8) load_int_tiles(is8, qz.qa8, qz.qb8, o, row0, col0, k0);
    if (need4) load_int_tiles(is4, qz.qa4, qz.qb4, o, row0, col0, k0);
    __syncthreads();
    if (needf) mac_float(fs, acc);
    if (need8) mac_int(is8, acc8);
    if (need4) mac_int(is4, acc4);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + ty * TM + i;
    if (row >= o.M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + tx + j * TX;
      if (col >= o.N) continue;
      const int t = tier_at(row, col);
      float v;
      if (t == 0)
        v = dequant(acc4[i][j], qz.sa4[row], qz.sb4[col]);
      else if (t == 1)
        v = dequant(acc8[i][j], qz.sa8[row], qz.sb8[col]);
      else
        v = acc[i][j];
      c[(long long)row * o.N + col] = v;
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (a and b share it).  Strides in elements.
// qa8/qb8 (levels 127) and qa4/qb4 (levels 7) with their scales come from
// quant_rows_launch: (M, Kp) and (N, Kp) int8.  tiers: (M/block_m,
// N/block_n) int32, contiguous.  Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int precision_island_launch(
    const void* a, const void* b, const void* qa8, const void* scale_a8,
    const void* qb8, const void* scale_b8, const void* qa4,
    const void* scale_a4, const void* qb4, const void* scale_b4,
    const void* tiers, void* c, int M, int N, int K, int Kp, long long sa_m,
    long long sa_k, long long sb_k, long long sb_n, int block_m,
    int block_n, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || Kp < K || Kp % BK != 0 ||
      block_m <= 0 || block_n <= 0 || M % block_m != 0 || N % block_n != 0 ||
      (M + BM - 1) / BM > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Operands o{M, N, K, Kp, sa_m, sa_k, sb_k, sb_n};
  const Quantized qz{
      static_cast<const int8_t*>(qa8), static_cast<const int8_t*>(qb8),
      static_cast<const int8_t*>(qa4), static_cast<const int8_t*>(qb4),
      static_cast<const float*>(scale_a8), static_cast<const float*>(scale_b8),
      static_cast<const float*>(scale_a4), static_cast<const float*>(scale_b4)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const int* t = static_cast<const int*>(tiers);
  float* cc = static_cast<float*>(c);
  if (dtype == 0)
    precision_island_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), qz, t, cc,
        o, block_m, block_n, N / block_n);
  else
    precision_island_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), qz, t, cc, o, block_m, block_n,
        N / block_n);
  return static_cast<int>(cudaGetLastError());
}
