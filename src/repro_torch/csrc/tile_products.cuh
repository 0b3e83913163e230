// Block-tile products of precision_island.cu.
//
// One block of 256 threads computes a 64 x 64 tile of C, each thread a 4 x 4
// patch (rows ty*4 + i, columns tx + j*16, so that neighbouring threads read
// neighbouring shared-memory words and write neighbouring columns).  K is
// walked in tiles of 32, in ascending order, inside the block.
//
//   * float path: a and b read through their element strides (either axis of
//     b contiguous, coalesced both ways), converted to f32, summed with fmaf
//     in ascending k: the same order in every launch, so a result does not
//     depend on the grid.
//   * integer path: int8 operands quantized by quant_rows.cu, (rows, Kp)
//     contiguous in k with Kp a multiple of 32 and zero past K, read as
//     packed 32-bit words and summed exactly in int32 with __dp4a
//     (|sum| <= K * 127^2 < 2^31 for K < 133,000).
//
// Loads are unconditional, from addresses clamped into the matrix, and the
// lanes out of range are zeroed afterwards: a load under a branch is not
// moved past it, and a tile's loads then wait for one another.
//
// Not used: the tensor cores (wgmma / mma.sync).  This first version is
// bound by the FMA and IMAD issue rate at large M; see PERF.md.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tile_products {

constexpr int BM = 64, BN = 64, BK = 32, TM = 4, TN = 4;
constexpr int TX = BN / TN;           // 16 threads along columns
constexpr int TY = BM / TM;           // 16 threads along rows
constexpr int THREADS = TX * TY;      // 256
constexpr int KQ = BK / 4;            // packed int8x4 words per k tile row

struct FloatTiles {
  float As[BM][BK + 1];
  float Bs[BK][BN + 1];
};

struct IntTiles {
  int Aq[BM][KQ + 1];
  int Bq[BN][KQ + 1];
};

struct Operands {
  int M, N, K, Kp;
  long long sa_m, sa_k, sb_k, sb_n;   // element strides of a (M,K), b (K,N)
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ void load_float_tiles(FloatTiles& s, const T* a,
                                                 const T* b,
                                                 const Operands& o, int row0,
                                                 int col0, int k0) {
  constexpr int A_PER = BM * BK / THREADS;
  constexpr int B_PER = BK * BN / THREADS;
  const int tid = threadIdx.x;
  const bool a_k_fastest = (o.sa_k == 1);
  const bool b_k_fastest = (o.sb_k == 1 && o.sb_n != 1);
  float av[A_PER], bv[B_PER];
#pragma unroll
  for (int p = 0; p < A_PER; ++p) {
    const int idx = tid + p * THREADS;
    const int r = a_k_fastest ? idx / BK : idx % BM;
    const int kk = a_k_fastest ? idx % BK : idx / BM;
    const int row = row0 + r, k = k0 + kk;
    const float v = to_f32(a[(long long)min(row, o.M - 1) * o.sa_m +
                             (long long)min(k, o.K - 1) * o.sa_k]);
    av[p] = (row < o.M && k < o.K) ? v : 0.0f;
  }
#pragma unroll
  for (int p = 0; p < B_PER; ++p) {
    const int idx = tid + p * THREADS;
    const int kk = b_k_fastest ? idx % BK : idx / BN;
    const int nn = b_k_fastest ? idx / BK : idx % BN;
    const int k = k0 + kk, col = col0 + nn;
    const float v = to_f32(b[(long long)min(k, o.K - 1) * o.sb_k +
                             (long long)min(col, o.N - 1) * o.sb_n]);
    bv[p] = (k < o.K && col < o.N) ? v : 0.0f;
  }
#pragma unroll
  for (int p = 0; p < A_PER; ++p) {
    const int idx = tid + p * THREADS;
    const int r = a_k_fastest ? idx / BK : idx % BM;
    const int kk = a_k_fastest ? idx % BK : idx / BM;
    s.As[r][kk] = av[p];
  }
#pragma unroll
  for (int p = 0; p < B_PER; ++p) {
    const int idx = tid + p * THREADS;
    const int kk = b_k_fastest ? idx % BK : idx / BN;
    const int nn = b_k_fastest ? idx / BK : idx % BN;
    s.Bs[kk][nn] = bv[p];
  }
}

// qa: (M, Kp) int8, qb: (N, Kp) int8 (the rows of b^T)
__device__ __forceinline__ void load_int_tiles(IntTiles& s, const int8_t* qa,
                                               const int8_t* qb,
                                               const Operands& o, int row0,
                                               int col0, int k0) {
  constexpr int PER = BM * KQ / THREADS;   // BM == BN
  const int tid = threadIdx.x;
  int av[PER], bv[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int w = tid + p * THREADS;
    const int r = w / KQ, kq = w % KQ;
    av[p] = reinterpret_cast<const int*>(
        qa + (long long)min(row0 + r, o.M - 1) * o.Kp + k0)[kq];
    bv[p] = reinterpret_cast<const int*>(
        qb + (long long)min(col0 + r, o.N - 1) * o.Kp + k0)[kq];
  }
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int w = tid + p * THREADS;
    s.Aq[w / KQ][w % KQ] = av[p];
    s.Bq[w / KQ][w % KQ] = bv[p];
  }
}

__device__ __forceinline__ void mac_float(const FloatTiles& s,
                                          float (&acc)[TM][TN]) {
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll 8
  for (int kk = 0; kk < BK; ++kk) {
    float av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = s.As[ty * TM + i][kk];
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = s.Bs[kk][tx + j * TX];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ void mac_int(const IntTiles& s,
                                        int (&acc)[TM][TN]) {
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll
  for (int kq = 0; kq < KQ; ++kq) {
    int av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = s.Aq[ty * TM + i][kq];
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = s.Bq[tx + j * TX][kq];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
  }
}

// The oracle's dequantization, in its order: (float(acc) * sa) * sb.
__device__ __forceinline__ float dequant(int acc, float sa, float sb) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), sa), sb);
}

}  // namespace tile_products
