// systolic_mac for NVIDIA Hopper (sm_90a): voltage-island partitioned matmul
// with timing-fault corruption and Razor flags.
//
// Replaces the Pallas kernel src/repro/kernels/systolic_mac.py::_kernel.
//
//   C = a @ b, f32 accumulate over K.  The output is cut into a grid of
//   (block_m x block_n) partition cells; cell (i, j) carries a rail voltage
//   v_map[i, j] and a minimum safe voltage v_safe[i, j].  A cell with
//   v_map < v_safe fails timing: the low (23 - keep_bits) mantissa bits of
//   its f32 accumulators are masked off and its Razor flag is raised.
//
// How it differs from the kernel it replaces:
//   * There the K axis is a sequential grid dimension with the accumulator in
//     scratch memory and the fired count carried from cell to cell.  Here
//     blocks run in any order: the K loop is inside the block, accumulators
//     live in registers, and the count is an integer atomicAdd (exact).
//   * The partition cell is not the launch tile.  block_m / block_n are
//     arguments (1x1 cells occur on the serving path); the epilogue looks up
//     v_map[row / block_m, col / block_n] per element, and the thread that
//     owns a cell's top-left element writes that cell's flag.
//   * a and b are addressed through element strides, so a transposed view of
//     a weight (the tied unembedding) is read in place, never copied.
//   * Ragged M, N, K are masked here; nothing is padded by the caller.
//
// Every output element is one accumulator summed with fmaf over k = 0..K-1
// in that order, in every launch configuration: a row's result does not
// depend on how many other rows the call carries.
//
// Bound on this card: at serving shapes (M = 1..8) the bytes of b, K*N*2 for
// bf16; the skinny configuration streams b through shared memory with the
// next tile's loads started before the current tile's arithmetic.  At large M
// the kernel is bound by the f32 FMA rate: it does not use the tensor cores.
// What still keeps it far from the byte bound (measured, see PERF.md): a
// block has one K tile of 2-byte loads in flight per memory round trip, and
// N <= 3072 gives fewer blocks than the card has SMs.  Wider loads and a
// split of K across blocks are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One block computes a BM x BN tile of C.  Threads form a TY x TX grid
// (TX = BN / TN along columns, TY = BM / TM along rows); a thread owns rows
// ty*TM + i and columns tx + j*TX, so that neighbouring threads read
// neighbouring shared-memory words and write neighbouring columns of C.
template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
systolic_mac_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    const float* __restrict__ v_map,
                    const float* __restrict__ v_safe, float* __restrict__ c,
                    int* __restrict__ flags, int* __restrict__ count, int M,
                    int N, int K, long long sa_m, long long sa_k,
                    long long sb_k, long long sb_n, int block_m, int block_n,
                    int grid_n, unsigned int keep_mask) {
  constexpr int TX = BN / TN;
  constexpr int TY = BM / TM;
  constexpr int THREADS = TX * TY;
  constexpr int A_ELEMS = BM * BK;
  constexpr int B_ELEMS = BK * BN;
  constexpr int A_PER = (A_ELEMS + THREADS - 1) / THREADS;
  constexpr int B_PER = (B_ELEMS + THREADS - 1) / THREADS;

  // +1 column of padding: the transposed-b fill writes down a column
  __shared__ float As[BM][BK + 1];
  __shared__ float Bs[BK][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  // which axis of b is contiguous decides which axis neighbouring threads
  // walk when they fill the tile (coalesced either way)
  const bool b_k_fastest = (sb_k == 1 && sb_n != 1);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  float a_reg[A_PER];
  float b_reg[B_PER];

  // Loads are unconditional, from an address clamped into the matrix, and
  // the out-of-range lanes are zeroed afterwards: a load under a branch is
  // not moved past it, and a tile's loads would then wait for one another.
  auto fetch = [&](int k0) {
#pragma unroll
    for (int p = 0; p < A_PER; ++p) {
      const int idx = min(tid + p * THREADS, A_ELEMS - 1);
      const int row = row0 + idx / BK, k = k0 + idx % BK;
      const float v = to_f32(a[(long long)min(row, M - 1) * sa_m +
                               (long long)min(k, K - 1) * sa_k]);
      a_reg[p] = (row < M && k < K) ? v : 0.0f;
    }
#pragma unroll
    for (int p = 0; p < B_PER; ++p) {
      const int idx = min(tid + p * THREADS, B_ELEMS - 1);
      const int kk = b_k_fastest ? idx % BK : idx / BN;
      const int nn = b_k_fastest ? idx / BK : idx % BN;
      const int k = k0 + kk, col = col0 + nn;
      const float v = to_f32(b[(long long)min(k, K - 1) * sb_k +
                               (long long)min(col, N - 1) * sb_n]);
      b_reg[p] = (k < K && col < N) ? v : 0.0f;
    }
  };

  auto stash = [&]() {
#pragma unroll
    for (int p = 0; p < A_PER; ++p) {
      const int idx = tid + p * THREADS;
      if (idx < A_ELEMS) As[idx / BK][idx % BK] = a_reg[p];
    }
#pragma unroll
    for (int p = 0; p < B_PER; ++p) {
      const int idx = tid + p * THREADS;
      if (idx < B_ELEMS) {
        const int kk = b_k_fastest ? idx % BK : idx / BN;
        const int nn = b_k_fastest ? idx / BK : idx % BN;
        Bs[kk][nn] = b_reg[p];
      }
    }
  };

  if (K > 0) fetch(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    stash();
    __syncthreads();
    // next tile's global loads are in flight during this tile's arithmetic
    if (k0 + BK < K) fetch(k0 + BK);
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[ty * TM + i][kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: per-element rail lookup, bit-cast + mask, flags, fired count
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + ty * TM + i;
    if (row >= M) continue;
    const int cell_i = row / block_m;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + tx + j * TX;
      if (col >= N) continue;
      const int cell_j = col / block_n;
      const long long cell = (long long)cell_i * grid_n + cell_j;
      const bool fail = v_map[cell] < v_safe[cell];
      float v = acc[i][j];
      if (fail) v = __uint_as_float(__float_as_uint(v) & keep_mask);
      c[(long long)row * N + col] = v;
      if (row == cell_i * block_m && col == cell_j * block_n) {
        flags[cell] = fail ? 1 : 0;
        if (fail && count != nullptr) atomicAdd(count, 1);
      }
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
void launch(const void* a, const void* b, const float* v_map,
            const float* v_safe, float* c, int* flags, int* count, int M,
            int N, int K, long long sa_m, long long sa_k, long long sb_k,
            long long sb_n, int block_m, int block_n, unsigned int keep_mask,
            cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  dim3 block((BM / TM) * (BN / TN));
  systolic_mac_kernel<T, BM, BN, BK, TM, TN><<<grid, block, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), v_map, v_safe, c,
      flags, count, M, N, K, sa_m, sa_k, sb_k, sb_n, block_m, block_n,
      N / block_n, keep_mask);
}

template <typename T>
void dispatch(const void* a, const void* b, const float* v_map,
              const float* v_safe, float* c, int* flags, int* count, int M,
              int N, int K, long long sa_m, long long sa_k, long long sb_k,
              long long sb_n, int block_m, int block_n, unsigned int keep_mask,
              cudaStream_t stream) {
  if (M <= 8) {
    // skinny (decode / short prefill): 8 x 32 tile with a deep K tile, so
    // that a block keeps 4 KB of b in flight (measured best of K tiles 32,
    // 64 and 128 over a decode step's GEMMs)
    launch<T, 8, 32, 64, 2, 1>(a, b, v_map, v_safe, c, flags, count, M, N, K,
                               sa_m, sa_k, sb_k, sb_n, block_m, block_n,
                               keep_mask, stream);
  } else {
    launch<T, 64, 64, 32, 4, 4>(a, b, v_map, v_safe, c, flags, count, M, N, K,
                                sa_m, sa_k, sb_k, sb_n, block_m, block_n,
                                keep_mask, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (a and b share it).  Strides in elements.
// count may be null (no fused reduction); otherwise the caller zeroes it.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int systolic_mac_launch(const void* a, const void* b,
                                   const void* v_map, const void* v_safe,
                                   void* c, void* flags, void* count, int M,
                                   int N, int K, long long sa_m,
                                   long long sa_k, long long sb_k,
                                   long long sb_n, int block_m, int block_n,
                                   int keep_bits, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || block_m <= 0 || block_n <= 0 ||
      M % block_m != 0 || N % block_n != 0 || keep_bits < 0 ||
      keep_bits > 23 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int keep_mask = 0xFFFFFFFFu << (23 - keep_bits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    dispatch<float>(a, b, static_cast<const float*>(v_map),
                    static_cast<const float*>(v_safe), static_cast<float*>(c),
                    static_cast<int*>(flags), static_cast<int*>(count), M, N,
                    K, sa_m, sa_k, sb_k, sb_n, block_m, block_n, keep_mask, s);
  else
    dispatch<__nv_bfloat16>(
        a, b, static_cast<const float*>(v_map),
        static_cast<const float*>(v_safe), static_cast<float*>(c),
        static_cast<int*>(flags), static_cast<int*>(count), M, N, K, sa_m,
        sa_k, sb_k, sb_n, block_m, block_n, keep_mask, s);
  return static_cast<int>(cudaGetLastError());
}
