// quant_rows for NVIDIA Hopper (sm_90a): symmetric per-row quantization, the
// prologue shared by razor_matmul and precision_island.
//
// Replaces the per-tile _quant_rows of src/repro/kernels/razor_matmul.py and
// src/repro/kernels/precision_island.py.  There a Pallas block holds whole
// rows of K, so every tile quantizes its (block, K) operand rows again; the
// scales run over the whole of K and do not depend on the output cell, so
// here they are taken once per operand, before the product.
//
//   X[r, k] = x[r * s_r + k * s_k]                (r < R, k < K)
//   scale[r] = max(max_k |X[r, k]|, 1e-12) / levels
//   q[r, k]  = clamp(rint(X[r, k] / scale[r]), -levels, levels)   (int8)
//
// bit for bit as the oracle (kernels/ref.py quantize_sym_i8/_i4): the
// division is a true IEEE division (__fdiv_rn), rounding is half to even
// (rintf), and the maximum is exact in any order.  q is written (R, Kp),
// contiguous in k, with the columns K..Kp-1 zero, so the products read
// whole 32-byte k tiles without bounds checks.  b is quantized through its
// strides as the rows of b^T: nothing is transposed in device memory.
//
// Two passes over X, both spread over (R / 32) x (K / 256) blocks so that a
// short operand (the activations, 256 rows) still fills the card: the row
// maxima by an unsigned atomicMax on the bits of |x| (monotone for
// non-negative floats, exact and order-free), then the quantization.  Bound:
// the bytes of X, read twice, and of q.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TR = 32;                // rows of X per block
constexpr int TK = 32;                // k per tile
constexpr int TILES = 8;              // tiles per block along k
constexpr int THREADS = 256;
constexpr int PER = TR * TK / THREADS;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Slot p of thread tid in a TR x TK tile.  Neighbouring threads walk the
// axis of X that is contiguous in memory, so the loads are coalesced either
// way; a slot's (row, k) is the same in every tile.
__device__ __forceinline__ void slot(int tid, int p, bool k_fastest, int* r,
                                     int* kk) {
  const int idx = tid + p * THREADS;
  *r = k_fastest ? idx / TK : idx % TR;
  *kk = k_fastest ? idx % TK : idx / TR;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
row_amax_kernel(const T* __restrict__ x, int R, int K, long long s_r,
                long long s_k, unsigned int* __restrict__ amax) {
  __shared__ float red[TR][TK + 1];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * TR;
  const int kb = blockIdx.y * TK * TILES;
  const bool k_fastest = (s_k == 1 && s_r != 1);
  float vmax[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p) vmax[p] = 0.0f;
  for (int t = 0; t < TILES; ++t) {
    const int k0 = kb + t * TK;
    if (k0 >= K) break;
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      int r, kk;
      slot(tid, p, k_fastest, &r, &kk);
      const int row = row0 + r, k = k0 + kk;
      // unconditional load from a clamped address, zeroed after
      const float v = fabsf(to_f32(x[(long long)min(row, R - 1) * s_r +
                                     (long long)min(k, K - 1) * s_k]));
      vmax[p] = fmaxf(vmax[p], (row < R && k < K) ? v : 0.0f);
    }
  }
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    int r, kk;
    slot(tid, p, k_fastest, &r, &kk);
    red[r][kk] = vmax[p];
  }
  __syncthreads();
  if (tid < TR && row0 + tid < R) {
    float m = 0.0f;
    for (int kk = 0; kk < TK; ++kk) m = fmaxf(m, red[tid][kk]);
    atomicMax(&amax[row0 + tid], __float_as_uint(m));
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
quantize_kernel(const T* __restrict__ x, int R, int K, int Kp, long long s_r,
                long long s_k, float levels,
                const unsigned int* __restrict__ amax,
                int8_t* __restrict__ q, float* __restrict__ scale) {
  __shared__ float s_scale[TR];
  __shared__ int8_t qs[TR][TK + 4];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * TR;
  const int kb = blockIdx.y * TK * TILES;
  const bool k_fastest = (s_k == 1 && s_r != 1);
  if (tid < TR) {
    const int row = min(row0 + tid, R - 1);
    const float sc =
        __fdiv_rn(fmaxf(__uint_as_float(amax[row]), 1e-12f), levels);
    s_scale[tid] = sc;
    if (blockIdx.y == 0 && row0 + tid < R) scale[row0 + tid] = sc;
  }
  __syncthreads();
  for (int t = 0; t < TILES; ++t) {
    const int k0 = kb + t * TK;
    if (k0 >= Kp) break;
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      int r, kk;
      slot(tid, p, k_fastest, &r, &kk);
      const int row = row0 + r, k = k0 + kk;
      const float v = to_f32(x[(long long)min(row, R - 1) * s_r +
                               (long long)min(k, K - 1) * s_k]);
      float qv = rintf(__fdiv_rn(v, s_scale[r]));
      qv = fminf(fmaxf(qv, -levels), levels);
      qs[r][kk] = (k < K) ? static_cast<int8_t>(__float2int_rn(qv)) : 0;
    }
    __syncthreads();
    // written along k, whatever the layout of x
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int idx = tid + p * THREADS;
      const int r = idx / TK, kk = idx % TK;
      const int row = row0 + r, k = k0 + kk;
      if (row < R && k < Kp) q[(long long)row * Kp + k] = qs[r][kk];
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* x, int R, int K, int Kp, long long s_r, long long s_k,
           float levels, unsigned int* amax, int8_t* q, float* scale,
           cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(unsigned int) * R, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid_max((R + TR - 1) / TR, (K + TK * TILES - 1) / (TK * TILES));
  row_amax_kernel<T><<<grid_max, THREADS, 0, stream>>>(
      static_cast<const T*>(x), R, K, s_r, s_k, amax);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid_q((R + TR - 1) / TR, (Kp + TK * TILES - 1) / (TK * TILES));
  quantize_kernel<T><<<grid_q, THREADS, 0, stream>>>(
      static_cast<const T*>(x), R, K, Kp, s_r, s_k, levels, amax, q, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides in elements.  amax is scratch
// of R uint32; q is (R, Kp) int8 with Kp >= K a multiple of 32; scale (R,).
// Returns the first CUDA error of the three launches (0 = launched).
extern "C" int quant_rows_launch(const void* x, int R, int K, int Kp,
                                 long long s_r, long long s_k, float levels,
                                 int dtype, void* amax, void* q, void* scale,
                                 void* stream) {
  if (R <= 0 || K <= 0 || Kp < K || Kp % TK != 0 ||
      (Kp + TK * TILES - 1) / (TK * TILES) > 65535 ||
      !(levels >= 1.0f && levels <= 127.0f) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned int* am = static_cast<unsigned int*>(amax);
  int8_t* qq = static_cast<int8_t*>(q);
  float* sc = static_cast<float*>(scale);
  if (dtype == 0)
    return launch<float>(x, R, K, Kp, s_r, s_k, levels, am, qq, sc, s);
  return launch<__nv_bfloat16>(x, R, K, Kp, s_r, s_k, levels, am, qq, sc, s);
}
