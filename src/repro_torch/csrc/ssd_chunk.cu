// ssd_chunk for NVIDIA Hopper (sm_90a): the chunked Mamba2 SSD recurrence
// (state-space duality form), one head's (n, p) state carried across chunks.
//
// Replaces the Pallas kernel src/repro/kernels/ssd_chunk.py::_kernel
// (wrappers ssd_chunk / _ssd_chunk_call).  Same chunk math, clamps and order
// of operations:
//
//   da      = dt * -exp(A_log_h);  cum = inclusive cumsum of da over the chunk
//   W[t,s]  = (C_t . B_s) * exp(clip(cum_t - cum_s, +-30)), kept where s <= t
//   y       = W (x * dt) + (C S) * exp(clip(cum, -30, 0)) + D_h * x
//   S'      = S * exp(clip(cum[last], -30, 0))
//             + (B * exp(clip(cum[last] - cum, +-30)))^T (x * dt)
//
// How it differs from the kernel it replaces:
//   * The Pallas wrapper repeats B and C once per head and tiles A_log and D
//     over the batch before the call.  Here one block owns one (b, h): it
//     reads B and C of its batch row (shared by all heads) and x and dt of its
//     head through their strides; nothing is copied first.
//   * The (n, p) state stays in shared memory (16 KB at n = p = 64) from the
//     block's first read of it to its last write, and is read whole before
//     any of it is written, so the final-state output may be the state tensor
//     itself.
//   * Any chunk length works: a chunk's rows are taken in tiles of 32 and the
//     (32 x 32) weight tile is formed one pair of row tiles at a time, with
//     the cumsum recomputed per tile in the same sequential order (one
//     thread, from the tile's dt staged in shared memory).
//   * f32 throughout, fmaf on the CUDA cores (no TF32, no tensor cores); da is
//     rounded before it is summed, as the cumsum of the plain version does.
//
// Bound on this card: at zamba2's shapes (h 80, p 64, n 64, chunk 64) the
// f32 operations, about 60 per byte of x, dt, B, C and y (the f32 peak
// binds past 20; the scores are taken once per head, as the Pallas kernel
// takes them).  This first version runs one block per (b, h), 160 blocks
// for a batch of two, on the CUDA cores.

#include <cuda_runtime.h>

namespace {

constexpr int DMAX = 64;        // largest head size p and state size n
constexpr int TILE = 32;        // rows of a tile inside a chunk
constexpr int THREADS = 256;
constexpr int LD = DMAX + 1;    // padded row of a shared tile
constexpr float EXP_CLAMP = 30.0f;

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__global__ void __launch_bounds__(THREADS)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A_log, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, const float* __restrict__ Dv,
                 const float* s0, float* __restrict__ y, float* s_out,
                 long long x_sb, long long x_ss, long long x_sh,
                 long long dt_sb, long long dt_ss, long long dt_sh,
                 long long B_sb, long long B_ss, long long C_sb,
                 long long C_ss, int H, int S, int P, int N, int ch) {
  __shared__ float Ss[DMAX][LD];     // the state (n, p)
  __shared__ float tC[TILE][LD];     // C of the t tile
  __shared__ float tB[TILE][LD];     // B of an s tile (times the tail)
  __shared__ float tx_[TILE][LD];    // x * dt of an s tile
  __shared__ float Wt[TILE][TILE + 1];
  __shared__ float cum_t[TILE], cum_s[TILE], dt_s[TILE];
  __shared__ float cum_end;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const float a = -expf(A_log[h]);
  const float Dh = Dv[h];
  auto X = [&](int t, int p) { return x[b * x_sb + t * x_ss + h * x_sh + p]; };
  auto DT = [&](int t) { return dt[b * dt_sb + t * dt_ss + h * dt_sh]; };
  auto Bv = [&](int t, int n) { return Bm[b * B_sb + t * B_ss + n]; };
  auto Cv = [&](int t, int n) { return Cm[b * C_sb + t * C_ss + n]; };

  // one tile's dt into dt_s, 32 threads at once (thread 0's walks below then
  // read them from shared memory)
  auto stage_dt = [&](int row0, int rows) {
    if (tid < TILE) dt_s[tid] = tid < rows ? DT(row0 + tid) : 0.f;
  };
  // thread 0: cum of the staged tile's rows from the running ``pre``
  auto walk = [&](float& pre, float* cum, int rows) {
    for (int i = 0; i < rows; ++i) {
      pre = __fadd_rn(pre, __fmul_rn(dt_s[i], a));
      cum[i] = pre;
    }
  };

  // the whole state, read before anything is written (s_out may be s0)
  const float* s0b = s0 + (long long)bh * N * P;
  for (int e = tid; e < N * P; e += THREADS) Ss[e / P][e % P] = s0b[e];

  const int ty = tid / 16, tx = tid % 16;     // y tile: rows ty, ty + 16
  const int tr = tid / 8, sc = tid % 8;       // weight tile: row tr, cols sc + 8j
  const int n_chunks = S / ch, n_tiles = (ch + TILE - 1) / TILE;

  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = c * ch;
    float tot = 0.f;                          // the sequential cumsum's total
    for (int ti = 0; ti < n_tiles; ++ti) {
      const int rows = min(TILE, ch - ti * TILE);
      stage_dt(c0 + ti * TILE, rows);
      __syncthreads();
      if (tid == 0) walk(tot, cum_s, rows);
      __syncthreads();
    }
    if (tid == 0) cum_end = tot;
    float pre_t = 0.f;                        // cum before the t tile (tid 0)
    __syncthreads();

    for (int ti = 0; ti < n_tiles; ++ti) {
      const int t0 = ti * TILE, nt = min(TILE, ch - t0);
      stage_dt(c0 + t0, nt);
      for (int e = tid; e < TILE * DMAX; e += THREADS) {
        const int i = e / DMAX, n = e % DMAX;
        tC[i][n] = (i < nt && n < N) ? Cv(c0 + t0 + i, n) : 0.f;
      }
      __syncthreads();
      if (tid == 0) walk(pre_t, cum_t, nt);
      __syncthreads();

      // inter-chunk: (C S) * exp(cum) with the state at the chunk's start
      float inter[2][4] = {}, acc[2][4] = {};
      for (int n = 0; n < N; ++n) {
        const float c0v = tC[ty][n], c1v = tC[ty + 16][n];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float sv = Ss[n][tx + 16 * j];
          inter[0][j] = fmaf(c0v, sv, inter[0][j]);
          inter[1][j] = fmaf(c1v, sv, inter[1][j]);
        }
      }

      float pre_s = 0.f;                      // cum before the s tile (tid 0)
      for (int sj = 0; sj <= ti; ++sj) {
        const int s0_ = sj * TILE, ns = min(TILE, ch - s0_);
        stage_dt(c0 + s0_, ns);
        __syncthreads();
        if (tid == 0) walk(pre_s, cum_s, ns);
        for (int e = tid; e < TILE * DMAX; e += THREADS) {
          const int i = e / DMAX, q = e % DMAX;
          const bool in = i < ns;
          tB[i][q] = (in && q < N) ? Bv(c0 + s0_ + i, q) : 0.f;
          tx_[i][q] = (in && q < P) ? X(c0 + s0_ + i, q) * DT(c0 + s0_ + i) : 0.f;
        }
        __syncthreads();
        {
          float sco[4] = {};
          for (int n = 0; n < N; ++n) {
            const float cv = tC[tr][n];
#pragma unroll
            for (int j = 0; j < 4; ++j) sco[j] = fmaf(cv, tB[sc + 8 * j][n], sco[j]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {          // inclusive: s <= t
            const int s = sc + 8 * j;
            const bool keep = s0_ + s <= t0 + tr && s < ns && tr < nt;
            Wt[tr][s] = keep ? sco[j] * expf(clip(cum_t[tr] - cum_s[s],
                                                  -EXP_CLAMP, EXP_CLAMP))
                             : 0.f;
          }
        }
        __syncthreads();
        for (int s = 0; s < TILE; ++s) {
          const float w0 = Wt[ty][s], w1 = Wt[ty + 16][s];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float xv = tx_[s][tx + 16 * j];
            acc[0][j] = fmaf(w0, xv, acc[0][j]);
            acc[1][j] = fmaf(w1, xv, acc[1][j]);
          }
        }
        __syncthreads();
      }

#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = ty + 16 * i;
        if (row >= nt) continue;
        const int t = c0 + t0 + row;
        const float ec = expf(clip(cum_t[row], -EXP_CLAMP, 0.f));
        float* yr = y + (((long long)b * S + t) * H + h) * P;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q = tx + 16 * j;
          if (q < P) yr[q] = (acc[i][j] + inter[i][j] * ec) + Dh * X(t, q);
        }
      }
      __syncthreads();
    }

    // state update: S' = S * exp(cum_end) + (B * tail)^T (x * dt)
    float upd[4][4] = {};
    float pre_s = 0.f;
    for (int sj = 0; sj < n_tiles; ++sj) {
      const int s0_ = sj * TILE, ns = min(TILE, ch - s0_);
      stage_dt(c0 + s0_, ns);
      __syncthreads();
      if (tid == 0) walk(pre_s, cum_s, ns);
      __syncthreads();
      for (int e = tid; e < TILE * DMAX; e += THREADS) {
        const int i = e / DMAX, q = e % DMAX;
        const bool in = i < ns;
        tB[i][q] = (in && q < N)
                       ? Bv(c0 + s0_ + i, q) *
                             expf(clip(cum_end - cum_s[i], -EXP_CLAMP, EXP_CLAMP))
                       : 0.f;
        tx_[i][q] = (in && q < P) ? X(c0 + s0_ + i, q) * DT(c0 + s0_ + i) : 0.f;
      }
      __syncthreads();
      for (int s = 0; s < TILE; ++s) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float bt = tB[s][ty * 4 + i];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            upd[i][j] = fmaf(bt, tx_[s][tx + 16 * j], upd[i][j]);
        }
      }
      __syncthreads();
    }
    const float dec = expf(clip(cum_end, -EXP_CLAMP, 0.f));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = ty * 4 + i;
      if (n >= N) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = tx + 16 * j;
        if (q < P) Ss[n][q] = Ss[n][q] * dec + upd[i][j];
      }
    }
    __syncthreads();
  }

  float* sob = s_out + (long long)bh * N * P;
  for (int e = tid; e < N * P; e += THREADS) sob[e] = Ss[e / P][e % P];
}

}  // namespace

// x: (B, S, H, P) with P contiguous; dt: (B, S, H); Bm, Cm: (B, S, N) with N
// contiguous; strides in elements.  A_log, D: (H,); s0 and s_out: (B, H, N,
// P); y: (B, S, H, P); all float32, the last four contiguous; s_out may be
// s0.  chunk divides S.  Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int ssd_chunk_launch(
    const void* x, const void* dt, const void* A_log, const void* Bm,
    const void* Cm, const void* D, const void* s0, void* y, void* s_out,
    long long x_sb, long long x_ss, long long x_sh, long long dt_sb,
    long long dt_ss, long long dt_sh, long long B_sb, long long B_ss,
    long long C_sb, long long C_ss, int B, int S, int H, int P, int N,
    int chunk, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P > DMAX || N <= 0 ||
      N > DMAX || chunk <= 0 || S % chunk != 0 ||
      (long long)B * H > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ssd_chunk_kernel<<<B * H, THREADS, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A_log), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(D),
      static_cast<const float*>(s0), static_cast<float*>(y),
      static_cast<float*>(s_out), x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh,
      B_sb, B_ss, C_sb, C_ss, H, S, P, N, chunk);
  return static_cast<int>(cudaGetLastError());
}
