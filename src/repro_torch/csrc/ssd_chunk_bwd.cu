// The gradient of ssd_chunk (ssd_chunk.cu) for NVIDIA Hopper (sm_90a): a
// kernel of the port, not a TPU kernel (the JAX package differentiates the
// SSD core of its jnp mamba2_forward, src/repro/models/ssm.py, with
// jax.grad).  Its plain version is kernels/ssd_chunk.py::
// ssd_chunk_backward_plain, which repeats these passes.
//
// The forward (per chunk and head; t, s rows of the chunk):
//   a = -exp(A_log), cum = cumsum(dt a) over the chunk, xdt = x dt,
//   decay = exp(clip(cum_t - cum_s, +-30)), W = (C B^T) decay for s <= t,
//   tail = exp(clip(cum_last - cum_s, +-30)), dec = exp(clip(cum_last, -30,
//   0)), ec = exp(clip(cum_t, -30, 0)),
//   y = W xdt + ec (C S_in) + D x,  S_out = dec S_in + (B tail)^T xdt.
// Given dy and the final state's gradient, the passes (one head a block):
//   * state pass (ssd_bwd_state_kernel), per (b * h, chunk): the chunk's
//     local state gradient (ec C)^T dy into a (b, h, chunk, n, p) scratch;
//   * carry pass (ssd_bwd_carry_kernel), per (b * h, slice of the n * p
//     state): from the last chunk, dS_out(c) = dS; dS = dec_c dS + (ec_c
//     C_c)^T dy_c, dS_out(c) over the local term, dS into dstate;
//   * row pass (ssd_bwd_row_kernel), per (b * h, chunk, 64-row tile): Q = dy
//     S_in^T, dC = ec Q and ec's gradient (C . Q) ec; over the s tiles up to
//     the row tile dW = dy xdt^T, dscores = dW decay (inclusive mask), dC +=
//     dscores B, and d/dcum_t of the decay (its row sums);
//   * column pass (ssd_bwd_col_kernel), per (b * h, chunk, 64-row tile as
//     the s rows): U = xdt dS_out^T, dB = tail U and tail's gradient (B . U)
//     tail, dxdt = tail (B dS_out); over the t tiles from the row tile on
//     dxdt += W^T dy, dB += dscores^T C, and d/dcum_s of the decay (column
//     sums); then dx = dxdt dt + D dy, the part sum_p x dxdt of ddt, the
//     tile's sums of tail's gradient and of dy x (dD);
//   * cumsum pass (ssd_bwd_dcum_kernel), per (b * h, chunk): ddec = sum
//     dS_out S_in (a block sum in one order), d/dcum of every row, its
//     reverse cumsum d(dt a); ddt += d(dt a) a, and the chunk's sum of
//     d(dt a) dt;
//   * reduce passes: dB and dC over the heads in head order
//     (ssd_bwd_reduce_bc_kernel), dA_log and dD over (batch row, chunk,
//     tile) in that order (ssd_bwd_reduce_h_kernel).
// Each exp(clip(z)) passes its gradient where lo <= z <= hi (torch.clamp's
// rule) and none where the clamp binds; the diagonal's decay has z = 0 and
// its two ends cancel, so it adds nothing to d/dcum.  Products run on the
// TF32 tensor cores with a 3xTF32 split (tf32_tiles.cuh), as the forward's
// do.  No float atomics: every sum has one order, so a repeated call gives
// the same bits.
//
// S_in and the cumsum are the forward's scratch, kept by the wrapper for the
// backward pass (the forward runs inside the layer's recomputation under
// torch.utils.checkpoint right before it).  A simple kernel: plain loads,
// one head a block, every 64 x 64 tile in shared memory at one row stride.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_tiles.cuh"

namespace {

using namespace tf32_tiles;

constexpr int DMAX = 64;          // largest p and n
constexpr int TILE = 64;          // rows of a chunk tile
constexpr int THREADS = 256;      // 8 warps (warp_tile: a warp's share)
constexpr int CARRY_ELEMS = 1024; // state elements of a carry block (4 a thread)
constexpr int LD = DMAX + 4;      // row stride of every shared tile
constexpr int TILE_FLOATS = TILE * LD;
constexpr float EXP_CLAMP = 30.0f;
constexpr int ROW_TILES = 6;      // shared tiles of the row pass
constexpr int COL_TILES = 7;      // shared tiles of the column pass
constexpr int BC_ROWS = THREADS / DMAX;   // rows of a dB / dC reduce block

template <class At>
__device__ __forceinline__ void load_tile(float* dst, At at, int rows,
                                          int cols) {
  for (int e = threadIdx.x; e < TILE * DMAX; e += THREADS) {
    const int i = e / DMAX, q = e % DMAX;
    dst[i * LD + q] = (i < rows && q < cols) ? at(i, q) : 0.f;
  }
}

template <class FA, class FB>
__device__ __forceinline__ void mm(float (&acc)[2][2][4], FA a, FB b,
                                   int k_end) {
  product_3xtf32(acc, splitting(a), splitting(b), warp_tile(), k_end, k_end);
}

__device__ __forceinline__ void zero(float (&acc)[2][2][4]) {
#pragma unroll
  for (int si = 0; si < 2; ++si)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[si][jj][r] = 0.f;
}

__device__ __forceinline__ void to_shared(const float (&acc)[2][2][4],
                                          float* dst) {
  for_each(warp_tile(), [&](int i, int j, int si, int jj, int r) {
    dst[i * LD + j] = acc[si][jj][r];
  });
}

__device__ __forceinline__ int round8(int n) { return (n + 7) & ~7; }

// out[row] = sum over q < n of f(row, q) for the TILE rows (ADD: added to
// out[row]), four threads a row in one order
template <bool ADD = false, class F>
__device__ __forceinline__ void row_sums(float* out, int n, F f) {
  const int row = threadIdx.x >> 2, part = threadIdx.x & 3;
  float d = 0.f;
  for (int q = part; q < n; q += 4) d = __fadd_rn(d, f(row, q));
  d = __fadd_rn(d, __shfl_xor_sync(0xffffffffu, d, 1));
  d = __fadd_rn(d, __shfl_xor_sync(0xffffffffu, d, 2));
  if (part == 0) out[row] = ADD ? __fadd_rn(out[row], d) : d;
}

__device__ __forceinline__ float cexp(float z, float lo, float hi,
                                      bool& pass) {
  pass = z >= lo && z <= hi;
  return expf(clip(z, lo, hi));
}

// Pass 1, grid (b * h, chunks): (ec C)^T dy into dS's slot
__global__ void __launch_bounds__(THREADS)
ssd_bwd_state_kernel(const float* __restrict__ C, const float* __restrict__ dy,
                     const float* __restrict__ cum, float* __restrict__ dS,
                     int H, int S, int P, int N, int ch) {
  __shared__ __align__(16) float Ce[TILE_FLOATS];   // ec C   [t][n]
  __shared__ __align__(16) float Dy[TILE_FLOATS];   // dy     [t][p]
  __shared__ float ec[TILE];
  const int nc = S / ch;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int c = blockIdx.y, c0 = c * ch;
  const int n_tiles = (ch + TILE - 1) / TILE;
  const long long row0 = (long long)b * S + c0;
  float acc[2][2][4];
  zero(acc);
  for (int rt = 0; rt < n_tiles; ++rt) {
    const int r0 = rt * TILE, rows = min(TILE, ch - r0);
    if (rt > 0) __syncthreads();
    if (threadIdx.x < TILE)
      ec[threadIdx.x] =
          threadIdx.x < rows
              ? expf(clip(cum[(row0 + r0 + threadIdx.x) * H + h], -EXP_CLAMP,
                          0.f))
              : 0.f;
    __syncthreads();
    load_tile(Ce, [&](int t, int n) {
      return __fmul_rn(C[(row0 + r0 + t) * N + n], ec[t]); }, rows, N);
    load_tile(Dy, [&](int t, int p) {
      return dy[((row0 + r0 + t) * H + h) * P + p]; }, rows, P);
    __syncthreads();
    mm(acc, [&](int n, int t) { return Ce[t * LD + n]; },
       [&](int t, int p) { return Dy[t * LD + p]; }, round8(rows));
  }
  float* out = dS + ((long long)bh * nc + c) * N * P;
  store_tile(acc, warp_tile(), N, P,
             [&](int n, int p) { return out + n * P + p; });
}

// Pass 2, grid (b * h, slices of n * p): the reverse carry
__global__ void __launch_bounds__(THREADS)
ssd_bwd_carry_kernel(const float* __restrict__ cum,
                     const float* __restrict__ dS_final,
                     float* __restrict__ dS, float* __restrict__ dstate,
                     int H, int S, int NP, int ch) {
  constexpr int PER = CARRY_ELEMS / THREADS;
  const int nc = S / ch;
  const long long bh = blockIdx.x, base = bh * NP;
  const int b = int(bh / H), h = int(bh % H);
  float* slots = dS + base * nc;
  const int e0 = blockIdx.y * CARRY_ELEMS + PER * threadIdx.x;
  float st[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k)
    st[k] = (dS_final != nullptr && e0 + k < NP) ? dS_final[base + e0 + k]
                                                 : 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const float dec = expf(clip(
        cum[((long long)b * S + (long long)c * ch + ch - 1) * H + h],
        -EXP_CLAMP, 0.f));
    float* slot = slots + (long long)c * NP;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = e0 + k;
      if (e >= NP) continue;
      const float g = slot[e];
      slot[e] = st[k];
      st[k] = __fadd_rn(__fmul_rn(st[k], dec), g);
    }
  }
#pragma unroll
  for (int k = 0; k < PER; ++k)
    if (e0 + k < NP) dstate[base + e0 + k] = st[k];
}

// Pass 3, grid (b * h, chunks, row tiles): this head's term of dC, and the
// row side of d/dcum
__global__ void __launch_bounds__(THREADS)
ssd_bwd_row_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ B, const float* __restrict__ C,
                   const float* __restrict__ dy, const float* __restrict__ cum,
                   const float* __restrict__ S_in, float* __restrict__ dC_part,
                   float* __restrict__ g_row, int H, int S, int P, int N,
                   int ch) {
  extern __shared__ __align__(16) float smem[];
  float* Ct = smem;                      // C of the t tile          [t][n]
  float* Dy = Ct + TILE_FLOATS;          // dy of the t tile         [t][p]
  float* Sa = Dy + TILE_FLOATS;          // S_in [n][p], then dscores [t][s]
  float* Bs = Sa + TILE_FLOATS;          // B of the s tile          [s][n]
  float* Xs = Bs + TILE_FLOATS;          // x dt of the s tile       [s][p]
  float* Zw = Xs + TILE_FLOATS;          // Q [t][n], then dz        [t][s]
  __shared__ float cum_t[TILE], cum_s[TILE], dect[TILE], dcr[TILE];
  const int tid = threadIdx.x;
  const int nc = S / ch;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int c = blockIdx.y, c0 = c * ch;
  const int ti = blockIdx.z, t0 = ti * TILE, nt = min(TILE, ch - t0);
  const long long row0 = (long long)b * S + c0;

  load_tile(Ct, [&](int t, int n) { return C[(row0 + t0 + t) * N + n]; },
            nt, N);
  load_tile(Dy, [&](int t, int p) {
    return dy[((row0 + t0 + t) * H + h) * P + p]; }, nt, P);
  const float* Sc = S_in + ((long long)bh * nc + c) * N * P;
  load_tile(Sa, [&](int n, int p) { return Sc[n * P + p]; }, N, P);
  if (tid < TILE) {
    cum_t[tid] = tid < nt ? cum[(row0 + t0 + tid) * H + h] : 0.f;
    dcr[tid] = 0.f;
  }
  __syncthreads();
  float dc[2][2][4];                     // Q = dy S_in^T, then dC
  zero(dc);
  mm(dc, [&](int t, int p) { return Dy[t * LD + p]; },
     [&](int p, int n) { return Sa[n * LD + p]; }, round8(P));
  to_shared(dc, Zw);
  __syncthreads();
  row_sums(dect, N, [&](int t, int n) {
    return __fmul_rn(Ct[t * LD + n], Zw[t * LD + n]); });
  for_each(warp_tile(), [&](int t, int n, int si, int jj, int i) {
    dc[si][jj][i] = __fmul_rn(dc[si][jj][i],
                              expf(clip(cum_t[t], -EXP_CLAMP, 0.f)));
  });
  for (int sj = 0; sj <= ti; ++sj) {
    const int s0 = sj * TILE, ns = min(TILE, ch - s0);
    __syncthreads();                     // Sa, Bs, Xs, Zw are free
    if (tid < TILE) cum_s[tid] = tid < ns ? cum[(row0 + s0 + tid) * H + h] : 0.f;
    load_tile(Bs, [&](int s, int n) { return B[(row0 + s0 + s) * N + n]; },
              ns, N);
    load_tile(Xs, [&](int s, int p) {
      const long long at = (row0 + s0 + s) * H + h;
      return __fmul_rn(x[at * P + p], dt[at]); }, ns, P);
    __syncthreads();
    {
      float sc[2][2][4], dw[2][2][4];
      zero(sc);
      zero(dw);
      mm(sc, [&](int t, int n) { return Ct[t * LD + n]; },
         [&](int n, int s) { return Bs[s * LD + n]; }, round8(N));
      mm(dw, [&](int t, int p) { return Dy[t * LD + p]; },
         [&](int p, int s) { return Xs[s * LD + p]; }, round8(P));
      for_each(warp_tile(), [&](int t, int s, int si, int jj, int i) {
        const bool keep = t < nt && s < ns && s0 + s <= t0 + t;
        bool pass;
        const float decay =
            cexp(__fsub_rn(cum_t[t], cum_s[s]), -EXP_CLAMP, EXP_CLAMP, pass);
        const float dsc = keep ? __fmul_rn(dw[si][jj][i], decay) : 0.f;
        Sa[t * LD + s] = dsc;
        Zw[t * LD + s] = keep && pass && s0 + s < t0 + t
                             ? __fmul_rn(dsc, sc[si][jj][i]) : 0.f;
      });
    }
    __syncthreads();
    row_sums<true>(dcr, TILE, [&](int t, int s) { return Zw[t * LD + s]; });
    mm(dc, [&](int t, int s) { return Sa[t * LD + s]; },
       [&](int s, int n) { return Bs[s * LD + n]; }, round8(ns));
  }
  __syncthreads();
  float* out = dC_part + ((row0 + t0) * H + h) * N;
  store_tile(dc, warp_tile(), nt, N,
             [&](int t, int n) { return out + (long long)t * H * N + n; });
  if (tid < nt) {
    bool pass;
    const float e = cexp(cum_t[tid], -EXP_CLAMP, 0.f, pass);
    g_row[(row0 + t0 + tid) * H + h] =
        __fadd_rn(dcr[tid], pass ? __fmul_rn(dect[tid], e) : 0.f);
  }
}

// Pass 4, grid (b * h, chunks, row tiles as the s rows): dx, this head's
// term of dB, the column side of d/dcum, ddt's x dxdt part, partials
__global__ void __launch_bounds__(THREADS)
ssd_bwd_col_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ B, const float* __restrict__ C,
                   const float* __restrict__ D, const float* __restrict__ dy,
                   const float* __restrict__ cum, const float* __restrict__ dS,
                   float* __restrict__ dx, float* __restrict__ ddt,
                   float* __restrict__ dB_part, float* __restrict__ h_col,
                   float* __restrict__ dL_part, float* __restrict__ dD_part,
                   int H, int S, int P, int N, int ch) {
  extern __shared__ __align__(16) float smem[];
  float* Bt = smem;                      // B of the s tile          [s][n]
  float* Xt = Bt + TILE_FLOATS;          // x dt of the s tile       [s][p]
  float* Sa = Xt + TILE_FLOATS;          // dS_out [n][p], then W [t][s]; dxdt
  float* Ct = Sa + TILE_FLOATS;          // C of a t tile            [t][n]
  float* Dy = Ct + TILE_FLOATS;          // dy of a t tile           [t][p]
  float* Dw = Dy + TILE_FLOATS;          // U [s][n], then dscores   [t][s]
  float* Zt = Dw + TILE_FLOATS;          // dz [t][s]; then dy x     [s][p]
  __shared__ float cum_s[TILE], cum_t[TILE], tail[TILE], dtl[TILE],
      dcc[TILE], red[TILE];
  __shared__ float cum_last;
  const int tid = threadIdx.x;
  const int nc = S / ch, n_tiles = (ch + TILE - 1) / TILE;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int c = blockIdx.y, c0 = c * ch;
  const int ti = blockIdx.z, s0 = ti * TILE, ns = min(TILE, ch - s0);
  const long long row0 = (long long)b * S + c0;

  load_tile(Bt, [&](int s, int n) { return B[(row0 + s0 + s) * N + n]; },
            ns, N);
  load_tile(Xt, [&](int s, int p) {
    const long long at = (row0 + s0 + s) * H + h;
    return __fmul_rn(x[at * P + p], dt[at]); }, ns, P);
  const float* dSo = dS + ((long long)bh * nc + c) * N * P;
  load_tile(Sa, [&](int n, int p) { return dSo[n * P + p]; }, N, P);
  if (tid == 0) cum_last = cum[(row0 + ch - 1) * H + h];
  if (tid < TILE) {
    cum_s[tid] = tid < ns ? cum[(row0 + s0 + tid) * H + h] : 0.f;
    dcc[tid] = 0.f;
  }
  __syncthreads();
  if (tid < TILE) tail[tid] = expf(clip(__fsub_rn(cum_last, cum_s[tid]),
                                        -EXP_CLAMP, EXP_CLAMP));
  float db[2][2][4], dxa[2][2][4];       // U, then dB; B dS_out, then dxdt
  zero(db);
  zero(dxa);
  mm(db, [&](int s, int p) { return Xt[s * LD + p]; },
     [&](int p, int n) { return Sa[n * LD + p]; }, round8(P));
  mm(dxa, [&](int s, int n) { return Bt[s * LD + n]; },
     [&](int n, int p) { return Sa[n * LD + p]; }, round8(N));
  to_shared(db, Dw);
  __syncthreads();
  row_sums(dtl, N, [&](int s, int n) {
    return __fmul_rn(Bt[s * LD + n], Dw[s * LD + n]); });
  for_each(warp_tile(), [&](int s, int j, int si, int jj, int i) {
    db[si][jj][i] = __fmul_rn(db[si][jj][i], tail[s]);
    dxa[si][jj][i] = __fmul_rn(dxa[si][jj][i], tail[s]);
  });
  for (int tj = ti; tj < n_tiles; ++tj) {
    const int t0 = tj * TILE, nt = min(TILE, ch - t0);
    __syncthreads();                     // Sa, Ct, Dy, Dw, Zt are free
    if (tid < TILE) cum_t[tid] = tid < nt ? cum[(row0 + t0 + tid) * H + h] : 0.f;
    load_tile(Ct, [&](int t, int n) { return C[(row0 + t0 + t) * N + n]; },
              nt, N);
    load_tile(Dy, [&](int t, int p) {
      return dy[((row0 + t0 + t) * H + h) * P + p]; }, nt, P);
    __syncthreads();
    {
      float sc[2][2][4], dw[2][2][4];
      zero(sc);
      zero(dw);
      mm(sc, [&](int t, int n) { return Ct[t * LD + n]; },
         [&](int n, int s) { return Bt[s * LD + n]; }, round8(N));
      mm(dw, [&](int t, int p) { return Dy[t * LD + p]; },
         [&](int p, int s) { return Xt[s * LD + p]; }, round8(P));
      for_each(warp_tile(), [&](int t, int s, int si, int jj, int i) {
        const bool keep = t < nt && s < ns && s0 + s <= t0 + t;
        bool pass;
        const float decay =
            cexp(__fsub_rn(cum_t[t], cum_s[s]), -EXP_CLAMP, EXP_CLAMP, pass);
        const float dsc = keep ? __fmul_rn(dw[si][jj][i], decay) : 0.f;
        Sa[t * LD + s] = keep ? __fmul_rn(sc[si][jj][i], decay) : 0.f;
        Dw[t * LD + s] = dsc;
        Zt[t * LD + s] = keep && pass && s0 + s < t0 + t
                             ? __fmul_rn(dsc, sc[si][jj][i]) : 0.f;
      });
    }
    __syncthreads();
    if (tid < TILE) {                    // column sums, rows in order
      float z = 0.f;
      for (int t = 0; t < nt; ++t) z = __fadd_rn(z, Zt[t * LD + tid]);
      dcc[tid] = __fadd_rn(dcc[tid], z);
    }
    mm(dxa, [&](int s, int t) { return Sa[t * LD + s]; },
       [&](int t, int p) { return Dy[t * LD + p]; }, round8(nt));
    mm(db, [&](int s, int t) { return Dw[t * LD + s]; },
       [&](int t, int n) { return Ct[t * LD + n]; }, round8(nt));
  }
  __syncthreads();
  float* dbo = dB_part + ((row0 + s0) * H + h) * N;
  store_tile(db, warp_tile(), ns, N,
             [&](int s, int n) { return dbo + (long long)s * H * N + n; });
  to_shared(dxa, Sa);
  __syncthreads();
  const float Dh = D[h];
  for (int e = tid; e < TILE * DMAX; e += THREADS) {
    const int s = e / DMAX, p = e % DMAX;
    float xd = 0.f, yx = 0.f;
    if (s < ns && p < P) {
      const long long at = (row0 + s0 + s) * H + h;
      const float xv = x[at * P + p], dyv = dy[at * P + p];
      const float d = Sa[s * LD + p];
      dx[at * P + p] = __fadd_rn(__fmul_rn(d, dt[at]), __fmul_rn(Dh, dyv));
      xd = __fmul_rn(xv, d);
      yx = __fmul_rn(dyv, xv);
    }
    Sa[s * LD + p] = xd;
    Zt[s * LD + p] = yx;
  }
  __syncthreads();
  row_sums(red, P,
           [&](int s, int p) { return Sa[s * LD + p]; });
  __syncthreads();
  if (tid < ns) {
    const long long at = (row0 + s0 + tid) * H + h;
    ddt[at] = red[tid];
    bool pass;
    const float tl = cexp(__fsub_rn(cum_last, cum_s[tid]), -EXP_CLAMP,
                          EXP_CLAMP, pass);
    const float zt = pass ? __fmul_rn(dtl[tid], tl) : 0.f;
    h_col[at] = __fsub_rn(-dcc[tid], zt);
    dtl[tid] = zt;
  }
  __syncthreads();
  row_sums(red, P, [&](int s, int p) { return Zt[s * LD + p]; });
  __syncthreads();
  if (tid == 0) {                        // the tile's sums, rows in order
    float zt = 0.f, yx = 0.f;
    for (int s = 0; s < ns; ++s) {
      zt = __fadd_rn(zt, dtl[s]);
      yx = __fadd_rn(yx, red[s]);
    }
    const long long slot = ((long long)bh * nc + c) * n_tiles + ti;
    dL_part[slot] = zt;
    dD_part[slot] = yx;
  }
}

// Pass 5, grid (b * h, chunks): ddec, d/dcum of every row and its reverse
// cumsum; ddt (which holds sum_p x dxdt) += d(dt a) a; the chunk's sum of
// d(dt a) dt
__global__ void __launch_bounds__(THREADS)
ssd_bwd_dcum_kernel(const float* __restrict__ dt,
                    const float* __restrict__ A_log,
                    const float* __restrict__ cum,
                    const float* __restrict__ S_in,
                    const float* __restrict__ dS,
                    const float* __restrict__ g_row,
                    const float* __restrict__ h_col,
                    const float* __restrict__ dL_part, float* __restrict__ ddt,
                    float* __restrict__ da_part, int H, int S, int NP,
                    int ch) {
  __shared__ float red[THREADS];
  const int tid = threadIdx.x;
  const int nc = S / ch, n_tiles = (ch + TILE - 1) / TILE;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int c = blockIdx.y;
  const long long slot = (long long)bh * nc + c;
  const long long row0 = (long long)b * S + (long long)c * ch;
  const float* si = S_in + slot * NP;
  const float* so = dS + slot * NP;
  float d = 0.f;
  for (int e = tid; e < NP; e += THREADS)
    d = __fadd_rn(d, __fmul_rn(so[e], si[e]));
  red[tid] = d;
  __syncthreads();
  for (int w = THREADS / 2; w > 0; w >>= 1) {   // a tree in one order
    if (tid < w) red[tid] = __fadd_rn(red[tid], red[tid + w]);
    __syncthreads();
  }
  if (tid != 0) return;
  const float L = cum[(row0 + ch - 1) * H + h];
  bool in_d;
  const float dec = cexp(L, -EXP_CLAMP, 0.f, in_d);
  float dL = in_d ? __fmul_rn(red[0], dec) : 0.f;
  for (int ti = 0; ti < n_tiles; ++ti)
    dL = __fadd_rn(dL, dL_part[slot * n_tiles + ti]);
  const float a = -expf(A_log[h]);
  float run = 0.f, da = 0.f;
  for (int t = ch - 1; t >= 0; --t) {
    const long long at = (row0 + t) * H + h;
    float dc = __fadd_rn(g_row[at], h_col[at]);
    if (t == ch - 1) dc = __fadd_rn(dc, dL);
    run = __fadd_rn(run, dc);
    ddt[at] = __fadd_rn(ddt[at], __fmul_rn(run, a));
    da = __fadd_rn(da, __fmul_rn(run, dt[at]));
  }
  da_part[slot] = da;
}

// Pass 6, grid (b * s / BC_ROWS): dB and dC, the heads' terms in head order
__global__ void __launch_bounds__(THREADS)
ssd_bwd_reduce_bc_kernel(const float* __restrict__ dB_part,
                         const float* __restrict__ dC_part,
                         float* __restrict__ dB, float* __restrict__ dC,
                         long long rows, int H, int N) {
  const long long row = (long long)blockIdx.x * BC_ROWS + threadIdx.x / DMAX;
  const int n = threadIdx.x % DMAX;
  if (row >= rows || n >= N) return;
  float sb = 0.f, scc = 0.f;
  for (int h = 0; h < H; ++h) {
    const long long at = (row * H + h) * N + n;
    sb = __fadd_rn(sb, dB_part[at]);
    scc = __fadd_rn(scc, dC_part[at]);
  }
  dB[row * N + n] = sb;
  dC[row * N + n] = scc;
}

// Pass 7, grid (h / 64), a thread a head: dA_log and dD, the partials in
// (batch row, chunk, tile) order
__global__ void __launch_bounds__(64)
ssd_bwd_reduce_h_kernel(const float* __restrict__ A_log,
                        const float* __restrict__ da_part,
                        const float* __restrict__ dD_part,
                        float* __restrict__ dA_log, float* __restrict__ dD,
                        int B, int H, int nc, int n_tiles) {
  const int h = blockIdx.x * 64 + threadIdx.x;
  if (h >= H) return;
  float da = 0.f, dd = 0.f;
  for (int b = 0; b < B; ++b) {
    const long long base = ((long long)b * H + h) * nc;
    for (int c = 0; c < nc; ++c) {
      da = __fadd_rn(da, da_part[base + c]);
      for (int ti = 0; ti < n_tiles; ++ti)
        dd = __fadd_rn(dd, dD_part[(base + c) * n_tiles + ti]);
    }
  }
  dA_log[h] = __fmul_rn(da, -expf(A_log[h]));
  dD[h] = dd;
}

inline long long round4(long long n) { return (n + 3) & ~3LL; }

}  // namespace

// The gradient of one ssd_chunk call.  x: (B, S, H, P), dt: (B, S, H), B_
// and C: (B, S, N), A_log and D: (H,), dy: (B, S, H, P), dS_final: (B, H,
// N, P) or null (zero), all float32 and contiguous.  S_in: (B, H, S / chunk,
// N, P) and cum: (B, S, H), the forward's scratch.  bws: float32 scratch of
// bws_floats elements (kernels/ssd_chunk.py::PassPlan.
// backward_workspace_floats: the state gradients, g_row and h_col (B, S,
// H), dB's and dC's head terms (B, S, H, N), two partials (B * H, S / chunk,
// row tiles), the chunks' sums (B * H, S / chunk), each rounded up to 4
// floats).  dx, ddt, dA_log, dB, dC, dD, dstate: the gradients, float32,
// contiguous.  Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int ssd_chunk_bwd_launch(
    const void* x, const void* dt, const void* A_log, const void* B_,
    const void* C, const void* D, const void* dy, const void* dS_final,
    const void* S_in, const void* cum, void* bws, long long bws_floats,
    void* dx, void* ddt, void* dA_log, void* dB, void* dC, void* dD,
    void* dstate, int B, int S, int H, int P, int N, int chunk,
    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || P > DMAX ||
      N > DMAX || chunk <= 0 || S % chunk != 0 ||
      (long long)B * H > 2147483647LL || bws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nc = S / chunk;
  const long long n_tiles = (chunk + TILE - 1) / TILE;
  const long long NP = (long long)N * P;
  const long long slices = (NP + CARRY_ELEMS - 1) / CARRY_ELEMS;
  const long long n_states = round4((long long)B * H * nc * NP);
  const long long n_bsh = round4((long long)B * S * H);
  const long long n_bshn = round4((long long)B * S * H * N);
  const long long n_part = round4((long long)B * H * nc * n_tiles);
  const long long n_chunks = round4((long long)B * H * nc);
  if (nc > 65535 || n_tiles > 65535 ||
      bws_floats < n_states + 2 * n_bsh + 2 * n_bshn + 2 * n_part + n_chunks)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A_log);
  const float* Bf = static_cast<const float*>(B_);
  const float* Cf = static_cast<const float*>(C);
  const float* Df = static_cast<const float*>(D);
  const float* dyf = static_cast<const float*>(dy);
  const float* Sf = static_cast<const float*>(S_in);
  const float* cf = static_cast<const float*>(cum);
  float* dS = static_cast<float*>(bws);
  float* g_row = dS + n_states;
  float* h_col = g_row + n_bsh;
  float* dB_part = h_col + n_bsh;
  float* dC_part = dB_part + n_bshn;
  float* dL_part = dC_part + n_bshn;
  float* dD_part = dL_part + n_part;
  float* da_part = dD_part + n_part;
  float* ddtf = static_cast<float*>(ddt);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int ROW_SMEM = ROW_TILES * TILE_FLOATS * 4;
  constexpr int COL_SMEM = COL_TILES * TILE_FLOATS * 4;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      ROW_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_col_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               COL_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned bh = unsigned(B * H);
  ssd_bwd_state_kernel<<<dim3(bh, unsigned(nc)), THREADS, 0, st>>>(
      Cf, dyf, cf, dS, H, S, P, N, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_carry_kernel<<<dim3(bh, unsigned(slices)), THREADS, 0, st>>>(
      cf, static_cast<const float*>(dS_final), dS,
      static_cast<float*>(dstate), H, S, int(NP), chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const dim3 tiles(bh, unsigned(nc), unsigned(n_tiles));
  ssd_bwd_row_kernel<<<tiles, THREADS, ROW_SMEM, st>>>(
      xf, dtf, Bf, Cf, dyf, cf, Sf, dC_part, g_row, H, S, P, N, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_col_kernel<<<tiles, THREADS, COL_SMEM, st>>>(
      xf, dtf, Bf, Cf, Df, dyf, cf, dS, static_cast<float*>(dx), ddtf,
      dB_part, h_col, dL_part, dD_part, H, S, P, N, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dcum_kernel<<<dim3(bh, unsigned(nc)), THREADS, 0, st>>>(
      dtf, Af, cf, Sf, dS, g_row, h_col, dL_part, ddtf, da_part, H, S,
      int(NP), chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long rows = (long long)B * S;
  ssd_bwd_reduce_bc_kernel<<<unsigned((rows + BC_ROWS - 1) / BC_ROWS),
                             THREADS, 0, st>>>(
      dB_part, dC_part, static_cast<float*>(dB), static_cast<float*>(dC),
      rows, H, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_reduce_h_kernel<<<unsigned((H + 63) / 64), 64, 0, st>>>(
      Af, da_part, dD_part, static_cast<float*>(dA_log),
      static_cast<float*>(dD), B, H, int(nc), int(n_tiles));
  return static_cast<int>(cudaGetLastError());
}
