// abft_checksums for NVIDIA Hopper (sm_90a): the ABFT guard's float64
// checksums of one GEMM operand, in one read of it.
//
// Not a TPU kernel: the reference computes these in numpy
// (src/repro/resilience/guard.py, GuardedBackend._abft_verify and
// _freivalds_verify: b64.sum(1), |b64|.sum(1), a64.sum(0) @ b64,
// |a64|.sum(0) @ |b64| and b64 @ x).  Done with PyTorch ops on the card each
// of those would first build a float64 copy of the weight; here the weight is
// read once, in its own type, and every product is formed from that read.
//
// The kernel sees the operand as X (R, C), X[r, c] = x[r * ld + c * sc], with
// sc the smaller stride (a row-major b is X = b; a transposed view b = W^T is
// X = W), and computes, in float64,
//
//   Yr[r, j] = sum_c f_j(X[r, c]) * P[c, j]     (j < np)   "along C"
//   Yc[i, c] = sum_r Q[i, r] * g_i(X[r, c])     (i < nq)   "along R"
//
// where f_j / g_i is the identity, or |.| where bit j of pabs / bit i of qabs
// is set.  P is (C, np) and Q (nq, R), both row-major float64, np, nq <= 4.
//
// Two passes, no float atomics, so a repeated call gives the same bits:
//   1. strip pass, grid (column blocks, row blocks).  A block covers
//      SUB x 128 columns and `rows` rows: eight warps, each on its own rows,
//      a lane on 4 columns of a 128-column sub-tile, with those columns' P
//      rows in registers.  A warp loads 4 rows at once (16 loads a lane in
//      flight).  A row's products with P are summed over the lanes by a
//      fixed shuffle tree and added, sub-tile after sub-tile, into the row's
//      shared-memory sum (one writer); the products with Q are summed in
//      registers down a warp's rows and then over the warps in warp order.
//      Each block writes its partial sums.
//   2. reduce pass: each output is the sum of its partials in block order.
// A ragged edge is loaded from a clamped address and zeroed after.
//
// What bounds it on this card: bytes (the operand, read once; at phi4-mini's
// logits weight 1.23 GB against about 40 MB of partial sums).  The float64
// products (2 (np + nq) an element) run on the CUDA cores at 34 TFLOP/s, not
// far below the byte rate: kept to four columns a lane and 4 + 4 sums.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int COLS_PER_LANE = 4;
constexpr int TILE_C = 32 * COLS_PER_LANE;     // columns of one sub-tile
constexpr int MAX_SUB = 4;                     // sub-tiles a block
constexpr int MAX_ROWS = 512;                  // rows a block
constexpr int MAXV = 4;                        // np, nq at most
constexpr int UNROLL = 4;                      // rows a warp loads at once

// dtype codes as the wrapper passes them
constexpr int DT_F32 = 0, DT_BF16 = 1, DT_F64 = 2;

// The operand's element type as it is loaded (widened to double at use).
template <int DT> struct Elem;
template <> struct Elem<DT_F32> { using T = float; };
template <> struct Elem<DT_BF16> { using T = unsigned short; };
template <> struct Elem<DT_F64> { using T = double; };

template <int DT>
__device__ __forceinline__ double widen(typename Elem<DT>::T v) {
  if constexpr (DT == DT_BF16) {
    // a bf16 is the high half of an f32: exact
    return static_cast<double>(__uint_as_float(static_cast<uint32_t>(v) << 16));
  } else {
    return static_cast<double>(v);
  }
}

// One block: SUB x 128 columns x `rows` rows.  NP / NQ bound np / nq at
// compile time (2 or 4), which sets the registers a thread holds.
template <int DT, int NP, int NQ>
__global__ void __launch_bounds__(THREADS)
abft_strip_kernel(const void* __restrict__ xv_, int R, int C, long long ld,
                  long long sc, const double* __restrict__ P, int np,
                  unsigned pabs, const double* __restrict__ Q, int nq,
                  unsigned qabs, int sub, int rows,
                  double* __restrict__ part_rows,
                  double* __restrict__ part_cols) {
  using T = typename Elem<DT>::T;
  const T* __restrict__ x = static_cast<const T*>(xv_);
  __shared__ double row_s[MAX_ROWS][NP > 0 ? NP : 1];
  __shared__ double col_s[TILE_C][NQ > 0 ? NQ : 1];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int cb = blockIdx.x, rb = blockIdx.y;
  const int c_block = cb * sub * TILE_C;
  const int r_block = rb * rows;

  for (int t = threadIdx.x; t < rows; t += THREADS) {
#pragma unroll
    for (int j = 0; j < NP; ++j) row_s[t][j] = 0.0;
  }
  __syncthreads();

  for (int s = 0; s < sub; ++s) {
    const int c0 = c_block + s * TILE_C;
    // the lane's columns: their P rows (zero past C) and clamped offsets
    double p_reg[COLS_PER_LANE][NP > 0 ? NP : 1];
    long long c_off[COLS_PER_LANE];
    bool c_ok[COLS_PER_LANE];
#pragma unroll
    for (int q = 0; q < COLS_PER_LANE; ++q) {
      const int c = c0 + lane + 32 * q;
      c_ok[q] = c < C;
      const int cc = c_ok[q] ? c : C - 1;
      c_off[q] = static_cast<long long>(cc) * sc;
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const double v = j < np ? __ldg(P + static_cast<long long>(cc) * np + j)
                                : 0.0;
        p_reg[q][j] = c_ok[q] ? v : 0.0;
      }
    }
    double col_acc[COLS_PER_LANE][NQ > 0 ? NQ : 1];
#pragma unroll
    for (int q = 0; q < COLS_PER_LANE; ++q)
#pragma unroll
      for (int i = 0; i < NQ; ++i) col_acc[q][i] = 0.0;

    // UNROLL rows of the warp at a time: their loads issued together
    for (int lr0 = warp; lr0 < rows; lr0 += WARPS * UNROLL) {
      T raw[UNROLL][COLS_PER_LANE];
      bool r_ok[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int r = r_block + lr0 + u * WARPS;
        r_ok[u] = lr0 + u * WARPS < rows && r < R;
        const long long r_off =
            static_cast<long long>(r < R ? r : R - 1) * ld;
#pragma unroll
        for (int q = 0; q < COLS_PER_LANE; ++q) raw[u][q] = x[r_off + c_off[q]];
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int lr = lr0 + u * WARPS;
        const int r = r_block + lr;
        double xv[COLS_PER_LANE];
#pragma unroll
        for (int q = 0; q < COLS_PER_LANE; ++q)
          xv[q] = (r_ok[u] && c_ok[q]) ? widen<DT>(raw[u][q]) : 0.0;
        // products with P, over the lane's columns, then over the warp
        double rp[NP > 0 ? NP : 1];
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          const bool ab = (pabs >> j) & 1u;
          rp[j] = 0.0;
#pragma unroll
          for (int q = 0; q < COLS_PER_LANE; ++q)
            rp[j] = fma(ab ? fabs(xv[q]) : xv[q], p_reg[q][j], rp[j]);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            rp[j] += __shfl_xor_sync(0xffffffffu, rp[j], off);
        }
        if (lane == 0 && r_ok[u]) {
#pragma unroll
          for (int j = 0; j < NP; ++j)
            if (j < np) row_s[lr][j] += rp[j];
        }
        // products with Q, down the warp's rows
#pragma unroll
        for (int i = 0; i < NQ; ++i) {
          if (i < nq) {
            const double qv =
                r_ok[u] ? __ldg(Q + static_cast<long long>(i) * R + r) : 0.0;
            const bool ab = (qabs >> i) & 1u;
#pragma unroll
            for (int q = 0; q < COLS_PER_LANE; ++q)
              col_acc[q][i] = fma(qv, ab ? fabs(xv[q]) : xv[q], col_acc[q][i]);
          }
        }
      }
    }

    // the warps' column sums, added in warp order
    if (nq > 0) {
      for (int w = 0; w < WARPS; ++w) {
        if (warp == w) {
#pragma unroll
          for (int q = 0; q < COLS_PER_LANE; ++q)
#pragma unroll
            for (int i = 0; i < NQ; ++i) {
              if (i < nq) {
                double& d = col_s[lane + 32 * q][i];
                d = (w == 0 ? 0.0 : d) + col_acc[q][i];
              }
            }
        }
        __syncthreads();
      }
      for (int t = threadIdx.x; t < TILE_C * nq; t += THREADS) {
        const int i = t / TILE_C, lc = t % TILE_C;
        const int c = c0 + lc;
        if (c < C)
          part_cols[(static_cast<long long>(rb) * nq + i) * C + c] = col_s[lc][i];
      }
      __syncthreads();
    }
  }

  if (np > 0) {
    __syncthreads();
    for (int t = threadIdx.x; t < rows * np; t += THREADS) {
      const int lr = t / np, j = t % np;
      const int r = r_block + lr;
      if (r < R)
        part_rows[(static_cast<long long>(cb) * R + r) * np + j] = row_s[lr][j];
    }
  }
}

// Yr[r, j] = sum over column blocks, in order; Yc[i, c] = sum over row
// blocks, in order.  One thread an output.
__global__ void __launch_bounds__(THREADS)
abft_reduce_kernel(const double* __restrict__ part_rows,
                   const double* __restrict__ part_cols, int R, int C,
                   int np, int nq, int n_cb, int n_rb,
                   double* __restrict__ yr, double* __restrict__ yc) {
  const long long n_r = static_cast<long long>(R) * np;
  const long long n_c = static_cast<long long>(nq) * C;
  for (long long t = blockIdx.x * static_cast<long long>(THREADS) + threadIdx.x;
       t < n_r + n_c; t += static_cast<long long>(gridDim.x) * THREADS) {
    double acc = 0.0;
    if (t < n_r) {
      for (int b = 0; b < n_cb; ++b) acc += part_rows[b * n_r + t];
      yr[t] = acc;
    } else {
      const long long u = t - n_r;
      for (int b = 0; b < n_rb; ++b) acc += part_cols[b * n_c + u];
      yc[u] = acc;
    }
  }
}

}  // namespace

// One call: both passes on `stream`.  part_rows holds n_cb * R * np and
// part_cols n_rb * nq * C doubles, n_cb = ceil(C / (sub * 128)) and
// n_rb = ceil(R / rows).  Returns a cudaError_t (0 on success).
extern "C" int abft_checksums_launch(const void* x, int R, int C,
                                     long long ld, long long sc, int dtype,
                                     const void* P, int np, unsigned pabs,
                                     const void* Q, int nq, unsigned qabs,
                                     int sub, int rows, void* part_rows,
                                     void* part_cols, void* yr, void* yc,
                                     void* stream) {
  if (R <= 0 || C <= 0 || np < 0 || np > MAXV || nq < 0 || nq > MAXV ||
      np + nq == 0 || sub < 1 || sub > MAX_SUB || rows < WARPS ||
      rows > MAX_ROWS || rows % WARPS != 0 || dtype < DT_F32 ||
      dtype > DT_F64)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_cb = (C + sub * TILE_C - 1) / (sub * TILE_C);
  const int n_rb = (R + rows - 1) / rows;
  if (n_rb > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_cb, n_rb);
  const double* p = static_cast<const double*>(P);
  const double* q = static_cast<const double*>(Q);
  double* pr = static_cast<double*>(part_rows);
  double* pc = static_cast<double*>(part_cols);
  // registers for 2 + 2 vectors where that is enough (the abft checksums),
  // else for 4 + 4 (Freivalds' probes)
  const bool small = np <= 2 && nq <= 2;
#define ABFT_STRIP(DT, NP, NQ)                                              \
  abft_strip_kernel<DT, NP, NQ><<<grid, THREADS, 0, s>>>(                   \
      x, R, C, ld, sc, p, np, pabs, q, nq, qabs, sub, rows, pr, pc)
  switch (dtype) {
    case DT_F32:
      if (small) ABFT_STRIP(DT_F32, 2, 2); else ABFT_STRIP(DT_F32, 4, 4);
      break;
    case DT_BF16:
      if (small) ABFT_STRIP(DT_BF16, 2, 2); else ABFT_STRIP(DT_BF16, 4, 4);
      break;
    default:
      if (small) ABFT_STRIP(DT_F64, 2, 2); else ABFT_STRIP(DT_F64, 4, 4);
      break;
  }
#undef ABFT_STRIP
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long outs = static_cast<long long>(R) * np +
                         static_cast<long long>(nq) * C;
  long long blocks = (outs + THREADS - 1) / THREADS;
  if (blocks > 4 * 132 * 8) blocks = 4 * 132 * 8;
  abft_reduce_kernel<<<static_cast<int>(blocks), THREADS, 0, s>>>(
      pr, pc, R, C, np, nq, n_cb, n_rb, static_cast<double*>(yr),
      static_cast<double*>(yc));
  return static_cast<int>(cudaGetLastError());
}
