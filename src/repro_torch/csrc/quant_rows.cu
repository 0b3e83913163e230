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
// quotient is the true IEEE division's (__fdiv_rn, or a multiplication by
// the reciprocal where the two cannot round to different integers; see
// quant), rounding is half to even (rintf), and the maximum is exact in any
// order.  q is written (R, Kp),
// contiguous in k, with the columns K..Kp-1 zero, so the products read
// whole k tiles without bounds checks.  b is quantized through its strides
// as the rows of b^T: nothing is transposed in device memory by the caller.
//
// What bounds it on this card: bytes.  Two passes, each reading X once: the
// row maxima (an unsigned atomicMax on the bits of |x|, monotone for
// non-negative floats, exact and order-free), then the quantization, which
// writes q.  precision_island takes both of its levels (127 and 7) in the
// same two passes: the row maxima once, one scale a level formed from the
// same exact maximum, and one quantization pass that reads X once and writes
// both int8 copies; a level the tier map lacks is not written, as a word of
// the tiers present (reduced on the device before) says, with no host sync.
// Both passes follow whichever axis of X is contiguous, with 16-byte loads
// where the base and the row stride allow them:
//   * k-fast (a, or b as a transposed view): a warp walks a row; the
//     quantization writes 8 int8 of a row a thread (one 8-byte store).
//   * r-fast (the columns of a row-major b): a thread holds 16 bytes of
//     neighbouring rows; the quantization transposes a (rows x 64 k) tile
//     through shared memory and writes q in 16-byte stores along k.
//   * any other strides: the k-fast kernels with one load an element.
// Loads at a ragged edge come from clamped addresses and are zeroed after.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_ring.cuh"

namespace {

// q's rows are padded to a multiple of K_PAD, the padding the products'
// int8 tiles read (one contract with them)
using tc_ring::K_PAD;
using tc_ring::aligned16;

constexpr int THREADS = 256;
constexpr int AMAX_ROWS = 8;          // k-fast row maxima: a warp a row
constexpr int AMAX_K = 512;           // k of a k-fast row-maxima block
constexpr int RF_LANES = 32;          // r-fast row maxima: 16-byte r-runs
constexpr int RF_KLANES = 8;          //   x 8 phases along k a block
constexpr int RF_AMAX_K = 64;         // k of an r-fast row-maxima block
constexpr int QG = 8;                 // int8 a thread, k-fast quantization
constexpr int QT_THREADS = 128;       // r-fast quantization tile:
constexpr int QT_K = 64;              //   (8 runs of 16 bytes) x 64 k

template <typename T>
struct Run {
  static constexpr int N = 16 / static_cast<int>(sizeof(T));   // 4 f32, 8 bf16
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Elements e0 .. e0 + Run::N - 1 of a line whose element e is line[e]
// (stride 1), zero from `len` on: one 16-byte load where `vec` says the line
// is 16-byte aligned and the run lies inside it, else one clamped load an
// element.
template <typename T>
__device__ __forceinline__ void load_run(const T* line, int e0, int len,
                                         bool vec, float (&v)[Run<T>::N]) {
  constexpr int V = Run<T>::N;
  if (vec && e0 + V <= len) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(line + e0));
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
    if constexpr (V == 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = __uint_as_float(u[i]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {       // bf16 pairs, low half first
        v[2 * i] = __uint_as_float(u[i] << 16);
        v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int e = e0 + i;
    const float x = to_f32(line[min(e, len - 1)]);
    v[i] = e < len ? x : 0.0f;
  }
}

// clamp(rint(v / sc), -levels, levels) with v / sc the true division,
// multiplying by inv = 1 / sc (rounded) where that cannot differ.  |v / sc|
// <= levels (to a rounding) <= 128, and y = v * inv lies within 3 * 2^-24 *
// 128 < 2^-15 of the rounded quotient, so both round to the same integer
// unless y lies within 2^-14 of a half-integer; there (a fraction of about
// 2^-13 of random values) the division decides.
__device__ __forceinline__ int quant(float v, float sc, float inv,
                                     float levels) {
  const float y = __fmul_rn(v, inv);
  float qv = rintf(y);
  if (fabsf(fabsf(__fsub_rn(y, qv)) - 0.5f) <= 0x1p-14f)
    qv = rintf(__fdiv_rn(v, sc));
  qv = fminf(fmaxf(qv, -levels), levels);
  return __float2int_rn(qv);
}

__device__ __forceinline__ float row_scale(const unsigned int* amax, int row,
                                           float levels) {
  return __fdiv_rn(fmaxf(__uint_as_float(amax[row]), 1e-12f), levels);
}

// ---- row maxima

// The levels one quantization pass writes: L = 1 (razor_matmul: every call)
// or L = 2 (precision_island: level l where the tier word has bit[l]).
template <int L>
struct Levels {
  int8_t* q[L];
  float* scale[L];
  float levels[L];
  unsigned int bit[L];
  const unsigned int* word;   // L = 2: the tiers present (bit t: tier t)
};

// whether a gated pass has any level to write: the word's bits `need`
template <bool GATED>
__device__ __forceinline__ bool gated_off(const unsigned int* word,
                                          unsigned int need) {
  return GATED && (__ldg(word) & need) == 0u;
}

// k-fast: warp w of block (x, y) takes row 8x + w, k in [512y, 512y + 512)
template <typename T, bool GATED>
__global__ void __launch_bounds__(THREADS)
amax_kfast_kernel(const T* __restrict__ x, int R, int K, long long s_r,
                  long long s_k, bool vec, unsigned int* __restrict__ amax,
                  const unsigned int* __restrict__ word, unsigned int need) {
  constexpr int V = Run<T>::N;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * AMAX_ROWS + (threadIdx.x >> 5);
  if (row >= R || gated_off<GATED>(word, need)) return;
  const int k_lo = blockIdx.y * AMAX_K;
  const int k_hi = min(K, k_lo + AMAX_K);
  const T* line = x + (long long)row * s_r;
  float m = 0.0f;
  if (s_k == 1) {
    // every load of the block's k range issued at once (zero past K)
#pragma unroll
    for (int j = 0; j < AMAX_K / (32 * V); ++j) {
      float v[V];
      load_run(line, k_lo + (j * 32 + lane) * V, K, vec, v);
#pragma unroll
      for (int i = 0; i < V; ++i) m = fmaxf(m, fabsf(v[i]));
    }
  } else {
#pragma unroll 4
    for (int k = k_lo + lane; k < k_hi; k += 32)
      m = fmaxf(m, fabsf(to_f32(line[(long long)k * s_k])));
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) atomicMax(&amax[row], __float_as_uint(m));
}

// r-fast (s_r == 1): thread (tx, ty) takes rows r0 + V tx .. + V - 1 and
// k = k_lo + ty, + 8, ... in [64y, 64y + 64)
template <typename T, bool GATED>
__global__ void __launch_bounds__(THREADS)
amax_rfast_kernel(const T* __restrict__ x, int R, int K, long long s_k,
                  bool vec, unsigned int* __restrict__ amax,
                  const unsigned int* __restrict__ word, unsigned int need) {
  constexpr int V = Run<T>::N;
  constexpr int SPAN = RF_LANES * V;
  __shared__ float red[RF_KLANES][SPAN + 1];
  if (gated_off<GATED>(word, need)) return;      // block-uniform
  const int tx = threadIdx.x % RF_LANES, ty = threadIdx.x / RF_LANES;
  const int r_base = blockIdx.x * SPAN;
  const int k_lo = blockIdx.y * RF_AMAX_K;
  float m[V];
#pragma unroll
  for (int i = 0; i < V; ++i) m[i] = 0.0f;
  // every load of the block's k range issued at once, from clamped rows
#pragma unroll
  for (int j = 0; j < RF_AMAX_K / RF_KLANES; ++j) {
    const int k = k_lo + ty + j * RF_KLANES;
    float v[V];
    load_run(x + (long long)min(k, K - 1) * s_k, r_base + tx * V, R, vec, v);
#pragma unroll
    for (int i = 0; i < V; ++i)
      m[i] = fmaxf(m[i], k < K ? fabsf(v[i]) : 0.0f);
  }
#pragma unroll
  for (int i = 0; i < V; ++i) red[ty][tx * V + i] = m[i];
  __syncthreads();
  for (int c = threadIdx.x; c < SPAN; c += THREADS) {
    float mm = red[0][c];
#pragma unroll
    for (int y = 1; y < RF_KLANES; ++y) mm = fmaxf(mm, red[y][c]);
    if (r_base + c < R) atomicMax(&amax[r_base + c], __float_as_uint(mm));
  }
}

// ---- quantization

// whether level l of a pass is written
template <int L>
__device__ __forceinline__ bool level_on(const Levels<L>& lv, int l) {
  return L == 1 || (__ldg(lv.word) & lv.bit[l]) != 0u;
}

// k-fast: thread g of the grid writes q[row, 8j .. 8j + 7] for g = row *
// (Kp / 8) + j at each level, and the row's scales with its first group
template <typename T, int L>
__global__ void __launch_bounds__(THREADS)
quantize_kfast_kernel(const T* __restrict__ x, int R, int K, int Kp,
                      long long s_r, long long s_k, bool vec, Levels<L> lv,
                      const unsigned int* __restrict__ amax) {
  constexpr int V = Run<T>::N;
  const int groups = Kp / QG;
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (g >= (long long)R * groups) return;
  bool on[L];
  bool any = false;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    on[l] = level_on(lv, l);
    any = any || on[l];
  }
  if (!any) return;
  const int row = static_cast<int>(g / groups);
  const int k0 = static_cast<int>(g % groups) * QG;
  float sc[L], inv[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    sc[l] = row_scale(amax, row, lv.levels[l]);
    inv[l] = __frcp_rn(sc[l]);
    if (on[l] && k0 == 0) lv.scale[l][row] = sc[l];
  }
  const T* line = x + (long long)row * s_r;
  float v[QG];
  if (s_k == 1) {
#pragma unroll
    for (int h = 0; h < QG / V; ++h) {
      float part[V];
      load_run(line, k0 + h * V, K, vec, part);
#pragma unroll
      for (int i = 0; i < V; ++i) v[h * V + i] = part[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < QG; ++i) {
      const int k = k0 + i;
      const float xv = to_f32(line[(long long)min(k, K - 1) * s_k]);
      v[i] = k < K ? xv : 0.0f;
    }
  }
#pragma unroll
  for (int l = 0; l < L; ++l) {
    if (!on[l]) continue;
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < QG; ++i) {
      const uint32_t qi = static_cast<uint32_t>(
          quant(v[i], sc[l], inv[l], lv.levels[l]));
      w[i / 4] |= (qi & 0xffu) << (8 * (i % 4));
    }
    *reinterpret_cast<uint2*>(lv.q[l] + (long long)row * Kp + k0) =
        make_uint2(w[0], w[1]);
  }
}

// r-fast (s_r == 1): a block quantizes rows r0 .. r0 + 8V - 1 at k in
// [64y, 64y + 64): thread (rv, kq) loads the 16-byte runs of rows r0 + V rv
// .. at k = 64y + 4kq .. + 3, packs each row's four int8 of each level into
// one word of that level's shared tile, and the tiles leave along k in
// 16-byte stores
template <typename T, int L>
__global__ void __launch_bounds__(QT_THREADS)
quantize_rfast_kernel(const T* __restrict__ x, int R, int K, int Kp,
                      long long s_k, bool vec, Levels<L> lv,
                      const unsigned int* __restrict__ amax) {
  constexpr int V = Run<T>::N;
  constexpr int TR = 8 * V;
  constexpr int WORDS = QT_K / 4;
  __shared__ uint32_t qs[L][TR][WORDS + 1];
  __shared__ float s_scale[L][TR], s_inv[L][TR];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * TR, k0 = blockIdx.y * QT_K;
  bool on[L];                                    // block-uniform
  bool any = false;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    on[l] = level_on(lv, l);
    any = any || on[l];
  }
  if (!any) return;
  if (tid < TR) {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const float sc = row_scale(amax, min(r0 + tid, R - 1), lv.levels[l]);
      s_scale[l][tid] = sc;
      s_inv[l][tid] = __frcp_rn(sc);
      if (on[l] && blockIdx.y == 0 && r0 + tid < R) lv.scale[l][r0 + tid] = sc;
    }
  }
  __syncthreads();
  const int rv = tid % 8, kq = tid / 8;
  float v[4][V];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = k0 + 4 * kq + j;
    load_run(x + (long long)min(k, K - 1) * s_k, r0 + rv * V, R, vec, v[j]);
    if (k >= K) {
#pragma unroll
      for (int i = 0; i < V; ++i) v[j][i] = 0.0f;
    }
  }
#pragma unroll
  for (int l = 0; l < L; ++l) {
    if (!on[l]) continue;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float sc = s_scale[l][rv * V + i], inv = s_inv[l][rv * V + i];
      uint32_t w = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w |= (static_cast<uint32_t>(quant(v[j][i], sc, inv, lv.levels[l])) &
              0xffu)
             << (8 * j);
      qs[l][rv * V + i][kq] = w;
    }
  }
  __syncthreads();
#pragma unroll
  for (int l = 0; l < L; ++l) {
    if (!on[l]) continue;
    for (int c = tid; c < TR * (QT_K / 16); c += QT_THREADS) {
      const int r = c / (QT_K / 16), ch = c % (QT_K / 16);
      const int row = r0 + r, k = k0 + ch * 16;
      if (row < R && k < Kp)
        *reinterpret_cast<uint4*>(lv.q[l] + (long long)row * Kp + k) =
            make_uint4(qs[l][r][4 * ch], qs[l][r][4 * ch + 1],
                       qs[l][r][4 * ch + 2], qs[l][r][4 * ch + 3]);
    }
  }
}

// The two passes over X (R, K) at the levels of lv.  L = 1 zeroes amax on
// the stream first; for L = 2 the caller has zeroed it, and both passes are
// gated by the tier word (any integer level present: bits 0 | 1).
template <typename T, int L>
int launch(const void* x_, int R, int K, int Kp, long long s_r, long long s_k,
           const Levels<L>& lv, unsigned int* amax, cudaStream_t stream) {
  constexpr int V = Run<T>::N;
  constexpr bool GATED = L > 1;
  const unsigned int need = GATED ? (lv.bit[0] | lv.bit[L - 1]) : 0u;
  const T* x = static_cast<const T*>(x_);
  const long long es = static_cast<long long>(sizeof(T));
  cudaError_t err = cudaSuccess;
  if (!GATED) {
    err = cudaMemsetAsync(amax, 0, sizeof(unsigned int) * R, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (s_r == 1 && s_k != 1) {
    const bool vec = aligned16(x) && (K == 1 || (s_k * es) % 16 == 0);
    const dim3 grid_max((R + RF_LANES * V - 1) / (RF_LANES * V),
                        (K + RF_AMAX_K - 1) / RF_AMAX_K);
    amax_rfast_kernel<T, GATED><<<grid_max, THREADS, 0, stream>>>(
        x, R, K, s_k, vec, amax, lv.word, need);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid_q((R + 8 * V - 1) / (8 * V), (Kp + QT_K - 1) / QT_K);
    quantize_rfast_kernel<T, L><<<grid_q, QT_THREADS, 0, stream>>>(
        x, R, K, Kp, s_k, vec, lv, amax);
    return static_cast<int>(cudaGetLastError());
  }
  const bool vec =
      s_k == 1 && aligned16(x) && (R == 1 || (s_r * es) % 16 == 0);
  const dim3 grid_max((R + AMAX_ROWS - 1) / AMAX_ROWS,
                      (K + AMAX_K - 1) / AMAX_K);
  amax_kfast_kernel<T, GATED><<<grid_max, THREADS, 0, stream>>>(
      x, R, K, s_r, s_k, vec, amax, lv.word, need);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long threads = (long long)R * (Kp / QG);
  quantize_kfast_kernel<T, L>
      <<<static_cast<unsigned int>((threads + THREADS - 1) / THREADS), THREADS,
         0, stream>>>(x, R, K, Kp, s_r, s_k, vec, lv, amax);
  return static_cast<int>(cudaGetLastError());
}

// the extents both entry points check
bool bad_extent(int R, int K, int Kp, const void* q, int dtype) {
  return R <= 0 || K <= 0 || Kp < K || Kp % K_PAD != 0 ||
         (K + RF_AMAX_K - 1) / RF_AMAX_K > 65535 ||
         (Kp + QT_K - 1) / QT_K > 65535 ||
         ((long long)R * (Kp / QG) + THREADS - 1) / THREADS > 0x7FFFFFFFLL ||
         (reinterpret_cast<uintptr_t>(q) & 15u) != 0 ||
         (dtype != 0 && dtype != 1);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides in elements.  amax is scratch
// of R uint32; q is (R, Kp) int8, 16-byte aligned, with Kp >= K a multiple
// of 32; scale (R,).  Returns the first CUDA error of the memset and the two
// launches (0 = launched).
extern "C" int quant_rows_launch(const void* x, int R, int K, int Kp,
                                 long long s_r, long long s_k, float levels,
                                 int dtype, void* amax, void* q, void* scale,
                                 void* stream) {
  if (bad_extent(R, K, Kp, q, dtype) || !(levels >= 1.0f && levels <= 127.0f))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned int* am = static_cast<unsigned int*>(amax);
  const Levels<1> lv{{static_cast<int8_t*>(q)},
                     {static_cast<float*>(scale)},
                     {levels},
                     {0u},
                     nullptr};
  if (dtype == 0) return launch<float, 1>(x, R, K, Kp, s_r, s_k, lv, am, s);
  return launch<__nv_bfloat16, 1>(x, R, K, Kp, s_r, s_k, lv, am, s);
}

// precision_island's prologue for one operand: both levels in one pass
// each.  q8/scale8 at levels 127 (written where the tier word has bit 1),
// q4/scale4 at levels 7 (bit 0); word: the tiers present, on the device;
// amax (R uint32) zeroed on the stream before.  Same layout and bits as
// quant_rows_launch at each level.
extern "C" int quant_rows_tiers_launch(const void* x, int R, int K, int Kp,
                                       long long s_r, long long s_k,
                                       int dtype, void* amax, void* q8,
                                       void* scale8, void* q4, void* scale4,
                                       const void* word, void* stream) {
  if (bad_extent(R, K, Kp, q8, dtype) ||
      (reinterpret_cast<uintptr_t>(q4) & 15u) != 0 || word == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned int* am = static_cast<unsigned int*>(amax);
  const Levels<2> lv{
      {static_cast<int8_t*>(q8), static_cast<int8_t*>(q4)},
      {static_cast<float*>(scale8), static_cast<float*>(scale4)},
      {127.0f, 7.0f},
      {2u, 1u},
      static_cast<const unsigned int*>(word)};
  if (dtype == 0) return launch<float, 2>(x, R, K, Kp, s_r, s_k, lv, am, s);
  return launch<__nv_bfloat16, 2>(x, R, K, Kp, s_r, s_k, lv, am, s);
}
