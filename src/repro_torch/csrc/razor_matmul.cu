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
//   * The Pallas program holds a whole (block, K) row panel and computes the
//     integer product in f32 (exact only while partial sums stay below 2^24;
//     K * 127^2 passes that at K = 1041).  Here the integer product is int32
//     (__dp4a), exact as the oracle's int32 product, so a main-path cell
//     equals the plain version bit for bit at any K the path serves.
//   * A cell's decision needs the whole cell, and a cell (128 x 128 from
//     select_blocks) is larger than a launch tile.  Two passes: a product
//     pass writes main and shadow (64 x 64 tiles, K looped inside the block,
//     tile_products.cuh); a cell pass (one block per cell) sums the squared
//     differences and the squared shadow in one fixed order, writes rel and
//     the flag, selects main or shadow, and adds to the count with an
//     integer atomicAdd.  No float atomics: the flag map is the same on
//     every run.
//   * The scales come from quant_rows.cu, once per operand; b is read
//     through its strides and never transposed in device memory.
//
// Bound on this card: at a 256-row prefill chunk against a full-width weight
// the arithmetic of two products (2MNK f32 + 2MNK int8) -- this first
// version issues both on the CUDA cores (fmaf, dp4a), not the tensor cores.
// The main and shadow planes (8 MNB bytes) are written and read once more.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_products.cuh"

namespace {

using namespace tile_products;

template <typename T>
__global__ void __launch_bounds__(THREADS)
razor_product_kernel(const T* __restrict__ a, const T* __restrict__ b,
                     const int8_t* __restrict__ qa,
                     const float* __restrict__ scale_a,
                     const int8_t* __restrict__ qb,
                     const float* __restrict__ scale_b,
                     float* __restrict__ main_out,
                     float* __restrict__ shadow_out, Operands o) {
  __shared__ FloatTiles fs;
  __shared__ IntTiles is;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  float acc[TM][TN];
  int iacc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc[i][j] = 0.0f;
      iacc[i][j] = 0;
    }
  for (int k0 = 0; k0 < o.K; k0 += BK) {
    load_float_tiles(fs, a, b, o, row0, col0, k0);
    load_int_tiles(is, qa, qb, o, row0, col0, k0);
    __syncthreads();
    mac_float(fs, acc);
    mac_int(is, iacc);
    __syncthreads();
  }
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + ty * TM + i;
    if (row >= o.M) continue;
    const float sa = scale_a[row];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + tx + j * TX;
      if (col >= o.N) continue;
      const long long at = (long long)row * o.N + col;
      main_out[at] = dequant(iacc[i][j], sa, scale_b[col]);
      shadow_out[at] = acc[i][j];
    }
  }
}

constexpr int CELL_THREADS = 256;

// One block per partition cell.  Each thread sums its elements in ascending
// order, then a fixed tree joins the 256 partial sums: the same order on
// every run.
__global__ void __launch_bounds__(CELL_THREADS)
razor_cell_kernel(const float* __restrict__ main_in,
                  const float* __restrict__ shadow_in, float* __restrict__ c,
                  int* __restrict__ flags, float* __restrict__ rel,
                  int* __restrict__ count, int N, int block_m, int block_n,
                  int grid_n, float tol) {
  __shared__ float red_d[CELL_THREADS];
  __shared__ float red_s[CELL_THREADS];
  __shared__ int fired_s;
  const int tid = threadIdx.x;
  const int cell = blockIdx.x;
  const int ci = cell / grid_n, cj = cell % grid_n;
  const long long base = (long long)ci * block_m * N + (long long)cj * block_n;
  const long long elems = (long long)block_m * block_n;
  float d2 = 0.0f, s2 = 0.0f;
  for (long long e = tid; e < elems; e += CELL_THREADS) {
    const long long at = base + (e / block_n) * N + e % block_n;
    const float s = shadow_in[at];
    const float d = main_in[at] - s;
    d2 = fmaf(d, d, d2);
    s2 = fmaf(s, s, s2);
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
    const float r = __fdiv_rn(sqrtf(red_d[0]), sqrtf(red_s[0]) + 1e-12f);
    const int f = r > tol ? 1 : 0;
    rel[cell] = r;
    flags[cell] = f;
    if (f && count != nullptr) atomicAdd(count, 1);
    fired_s = f;
  }
  __syncthreads();
  const bool fired = fired_s != 0;
  for (long long e = tid; e < elems; e += CELL_THREADS) {
    const long long at = base + (e / block_n) * N + e % block_n;
    c[at] = fired ? shadow_in[at] : main_in[at];
  }
}

template <typename T>
int launch(const void* a, const void* b, const int8_t* qa,
           const float* scale_a, const int8_t* qb, const float* scale_b,
           float* main_buf, float* shadow_buf, float* c, int* flags,
           float* rel, int* count, const Operands& o, int block_m,
           int block_n, float tol, cudaStream_t stream) {
  dim3 grid((o.N + BN - 1) / BN, (o.M + BM - 1) / BM);
  razor_product_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), qa, scale_a, qb,
      scale_b, main_buf, shadow_buf, o);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid_m = o.M / block_m, grid_n = o.N / block_n;
  razor_cell_kernel<<<grid_m * grid_n, CELL_THREADS, 0, stream>>>(
      main_buf, shadow_buf, c, flags, rel, count, o.N, block_m, block_n,
      grid_n, tol);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (a and b share it).  Strides in elements.
// qa (M, Kp), qb (N, Kp) and their scales come from quant_rows_launch at
// levels 127.  main_buf and shadow_buf are (M, N) f32 scratch.  count may be
// null (no fused reduction); otherwise the caller zeroes it.  Returns the
// first CUDA error of the two launches (0 = launched).
extern "C" int razor_matmul_launch(
    const void* a, const void* b, const void* qa, const void* scale_a,
    const void* qb, const void* scale_b, void* main_buf, void* shadow_buf,
    void* c, void* flags, void* rel, void* count, int M, int N, int K,
    int Kp, long long sa_m, long long sa_k, long long sb_k, long long sb_n,
    int block_m, int block_n, float tol, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || Kp < K || Kp % BK != 0 ||
      block_m <= 0 || block_n <= 0 || M % block_m != 0 || N % block_n != 0 ||
      (M + BM - 1) / BM > 65535 ||
      (long long)(M / block_m) * (N / block_n) > 0x7FFFFFFFLL ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Operands o{M, N, K, Kp, sa_m, sa_k, sb_k, sb_n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* qa8 = static_cast<const int8_t*>(qa);
  const int8_t* qb8 = static_cast<const int8_t*>(qb);
  const float* sa = static_cast<const float*>(scale_a);
  const float* sb = static_cast<const float*>(scale_b);
  float* mb = static_cast<float*>(main_buf);
  float* sh = static_cast<float*>(shadow_buf);
  float* cc = static_cast<float*>(c);
  int* fl = static_cast<int*>(flags);
  float* rl = static_cast<float*>(rel);
  int* ct = static_cast<int*>(count);
  if (dtype == 0)
    return launch<float>(a, b, qa8, sa, qb8, sb, mb, sh, cc, fl, rl, ct, o,
                         block_m, block_n, tol, s);
  return launch<__nv_bfloat16>(a, b, qa8, sa, qb8, sb, mb, sh, cc, fl, rl,
                               ct, o, block_m, block_n, tol, s);
}
