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
// Given dy and the final state's gradient, the passes, launched in order on
// one stream by ssd_chunk_bwd_launch:
//   * state pass (ssd_bwd_state_kernel), per (b, chunk, group of heads): C
//     staged once a row tile, each head's dy by cp.async into the other of
//     two buffers while the last head's product runs; the chunk's local
//     state gradient (ec C)^T dy into a (b, h, chunk, n, p) scratch;
//   * carry pass (ssd_bwd_carry_kernel), per (b * h, slice of the n * p
//     state): from the last chunk, dS_out(c) = dS; dS = dec_c dS + (ec_c
//     C_c)^T dy_c, dS_out(c) over the local term, dS into dstate.  Each
//     thread issues the loads of CARRY_UNROLL chunks before it walks them;
//   * where a chunk is one tile (chunk <= TILE: the chunk of every shipped
//     SSM config), one fused pass (ssd_bwd_fused_kernel) per (b, chunk,
//     group of heads): B and C staged and the scores C B^T formed once for
//     the group, then per head, in head order, the row side (Q = dy S_in^T,
//     dC = ec Q + dscores B, the row sums of d/dcum), the column side (U =
//     xdt dS_out^T, dB = tail U + dscores^T C, dxdt = tail (B dS_out) + W^T
//     dy, dx = dxdt dt + D dy, ddt's x dxdt part, the column sums), ddec =
//     sum dS_out S_in, and d/dcum of every row and its reverse cumsum d(dt a)
//     in the block: ddt += d(dt a) a, the chunk's sums of d(dt a) dt and of
//     dy x.  dW = dy xdt^T, dscores = dW decay and W are formed once a head
//     (the first form took them once on each side).  A head's x, dy, cum and
//     dt are staged by cp.async while the last head runs, its S_in and
//     dS_out while this head's row and column products run.  Products that
//     share a k range walk it together (product2_3xtf32: Q with dW, U with
//     B dS_out, W^T dy with dscores^T C), so their mma chains interleave; the
//     causal ones skip the k steps the mask zeroes.  The block adds its
//     heads' dB and dC terms in head order in registers and writes one
//     partial a group;
//   * where a chunk spans tiles (the ragged 100 and 1000 rows, chunk 128),
//     the first form's row pass (ssd_bwd_row_kernel, dC over 64-row tiles),
//     column pass (ssd_bwd_col_kernel, dx and dB) and cumsum pass
//     (ssd_bwd_dcum_kernel), one head a block, kept as they were: a fused
//     form over tile pairs would hold every tile's dB and dxdt of a chunk at
//     once, and no shipped config runs such a chunk;
//   * one reduce pass (ssd_bwd_reduce_kernel): dB and dC over the partials in
//     slot order (the groups, or the heads where a chunk spans tiles), and
//     dA_log and dD over (batch row, chunk, tile) in that order.
// Four launches a call where a chunk is one tile, six where it spans tiles.
// Each exp(clip(z)) passes its gradient where lo <= z <= hi (torch.clamp's
// rule) and none where the clamp binds; the diagonal's decay has z = 0 and
// its two ends cancel, so it adds nothing to d/dcum.  Products run on the
// TF32 tensor cores with a 3xTF32 split (tf32_tiles.cuh), as the forward's
// do.  No float atomics: every sum has one order fixed by the launch's
// extents (heads in order within a group, then the groups in order; a
// row's sums and the reverse cumsum in fixed shuffle trees), so a repeated
// call gives the same bits.
//
// S_in and the cumsum are the forward's scratch, kept by the wrapper for the
// backward pass (the forward runs inside the layer's recomputation under
// torch.utils.checkpoint right before it).
//
// Budget of the fused pass: 11 padded 64 x 68 f32 tiles (B, C, the scores,
// W, dscores, S_in, dS_out, x and dy twice, 191,488 bytes), each head's cum
// and dt (1 KB) and 5.6 KB of row and column partials: one block an SM (8
// warps, the group's dB and dC and a head's four products in registers),
// which hides a head's loads behind the last head's products.  The state pass: C and two dy buffers at 64 x 72, 3
// blocks an SM.  What bounds the call on an H100 at zamba2's loss shape (b
// 2, s 2048, h 80, p 64, n 64, chunk 64): x, dt, B, C, dy and S_in read,
// dx, ddt, dB, dC written, 345 MB over 3.35 TB/s = 0.103 ms; the passes
// also write and read the state scratch (84 MB) and the groups' dB and dC
// partials (21 MB).

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_tiles.cuh"

namespace {

using namespace tf32_tiles;

constexpr int DMAX = 64;          // largest p and n
constexpr int TILE = 64;          // rows of a chunk tile
constexpr int THREADS = 256;      // 8 warps (warp_tile: a warp's share)
constexpr int MAX_HEADS = 8;      // heads of a block of the state and fused passes
constexpr int CARRY_ELEMS = 1024; // state elements of a carry block (4 a thread)
constexpr int CARRY_UNROLL = 8;   // chunks whose loads the carry pass issues at once
constexpr int LD = DMAX + 4;      // row stride of the tile passes' shared tiles
constexpr int LDB = DMAX + 8;     // row stride of the state pass's ([k][j] reads)
constexpr int TILE_FLOATS = TILE * LD;
constexpr float EXP_CLAMP = 30.0f;
constexpr int ROW_TILES = 6;      // shared tiles of the multi-tile row pass
constexpr int COL_TILES = 7;      // shared tiles of the multi-tile column pass
constexpr int FUSED_TILES = 11;   // shared tiles of the fused pass
constexpr int BC_ROWS = THREADS / DMAX;   // rows of a dB / dC reduce block
// bits of the launch's vec flags: tensors whose rows load 16 bytes a copy
constexpr int VEC_X = 1, VEC_BC = 2, VEC_S = 4;
// dynamic shared memory: the state pass's C and two dy buffers; the fused
// pass's tiles and each head's cum and dt (two each, by head parity)
constexpr int STATE_SMEM_BYTES = 3 * TILE * LDB * 4;
constexpr int FUSED_SMEM_BYTES = (FUSED_TILES * TILE_FLOATS + 4 * TILE) * 4;
constexpr int ROW_SMEM_BYTES = ROW_TILES * TILE_FLOATS * 4;
constexpr int COL_SMEM_BYTES = COL_TILES * TILE_FLOATS * 4;

template <class At>
__device__ __forceinline__ void load_tile(float* dst, At at, int rows,
                                          int cols) {
  for (int e = threadIdx.x; e < TILE * DMAX; e += THREADS) {
    const int i = e / DMAX, q = e % DMAX;
    dst[i * LD + q] = (i < rows && q < cols) ? at(i, q) : 0.f;
  }
}

// a (TILE x DMAX) tile by cp.async (tf32_tiles.cuh: stage_tile)
template <class At>
__device__ __forceinline__ void stage(float* dst, int ld, At at, int rows,
                                      int cols, bool vec) {
  stage_tile<TILE, DMAX, THREADS>(dst, ld, at, rows, cols, vec);
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

// Sums of a value over a warp tile's rows or columns, from the registers.
// Each thread's part of a row (v[si][half]: row w.m[si] + g + 8 half, its
// four columns added in for_each's order) is added over the quad (lanes t,
// a fixed tree) into red[warp >> 1][row]; the row's total is then the four
// column groups in order (row_total).  A column's part (v[jj][c]: column
// w.j0 + 8 jj + 2 t + c) is added over the lanes g into red[warp & 1][col];
// its total is the two row-strip pairs in order (col_total).  The totals
// are read after a __syncthreads.
__device__ __forceinline__ void put_row_parts(float (&v)[2][2], float* red) {
  const WarpTile w = warp_tile();
  const int lane = threadIdx.x & 31, g = lane >> 2;
  const int wc = (threadIdx.x >> 5) >> 1;
#pragma unroll
  for (int si = 0; si < 2; ++si)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float d = v[si][half];
      d = __fadd_rn(d, __shfl_xor_sync(0xffffffffu, d, 1));
      d = __fadd_rn(d, __shfl_xor_sync(0xffffffffu, d, 2));
      if ((lane & 3) == 0) red[wc * TILE + w.m[si] + g + 8 * half] = d;
    }
}

__device__ __forceinline__ float row_total(const float* red, int row) {
  return __fadd_rn(__fadd_rn(__fadd_rn(red[row], red[TILE + row]),
                             red[2 * TILE + row]), red[3 * TILE + row]);
}

__device__ __forceinline__ void put_col_parts(float (&v)[2][2], float* red) {
  const WarpTile w = warp_tile();
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int pr = (threadIdx.x >> 5) & 1;
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float d = v[jj][c];
      d = __fadd_rn(d, __shfl_xor_sync(0xffffffffu, d, 4));
      d = __fadd_rn(d, __shfl_xor_sync(0xffffffffu, d, 8));
      d = __fadd_rn(d, __shfl_xor_sync(0xffffffffu, d, 16));
      if (lane < 4) red[pr * TILE + w.j0 + 8 * jj + 2 * t + c] = d;
    }
}

__device__ __forceinline__ float col_total(const float* red, int col) {
  return __fadd_rn(red[col], red[TILE + col]);
}

// the sum of a warp's 32 lanes' values in a fixed tree; every lane gets it
__device__ __forceinline__ float warp_sum(float d) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    d = __fadd_rn(d, __shfl_xor_sync(0xffffffffu, d, off));
  return d;
}

// Pass 1, grid (b * chunks, head groups): (ec C)^T dy into dS's slot.  The
// steps (head, row tile) run in order; a step's dy tile is staged (into the
// other of two buffers) and its cum read while the last step's product
// runs, and C is staged once a row tile (once a block where the chunk is
// one tile).
__global__ void __launch_bounds__(THREADS, 3)
ssd_bwd_state_kernel(const float* __restrict__ C, const float* __restrict__ dy,
                     const float* __restrict__ cum, float* __restrict__ dS,
                     int H, int S, int P, int N, int ch, int G, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;                  // C of a row tile           [t][n]
  float* Ys = Cs + TILE * LDB;       // dy of a step, two buffers [t][p]
  __shared__ float ec[2][TILE];      // ec of a step's rows, by step parity
  const int tid = threadIdx.x;
  const int nc = S / ch;
  const int b = blockIdx.x / nc, c = blockIdx.x % nc, c0 = c * ch;
  const int h0 = blockIdx.y * G, heads = min(G, H - h0);
  const int n_tiles = (ch + TILE - 1) / TILE, steps = heads * n_tiles;
  const long long row0 = (long long)b * S + c0;
  const WarpTile w = warp_tile();

  auto stage_C = [&](int rt) {
    const int r0 = rt * TILE;
    stage(Cs, LDB, [&](int i, int q) { return C + (row0 + r0 + i) * N + q; },
          min(TILE, ch - r0), N, vec & VEC_BC);
  };
  auto issue_dy = [&](int k) {       // step k: head k / n_tiles, its row tile
    const int h = h0 + k / n_tiles, r0 = (k % n_tiles) * TILE;
    stage(Ys + (k & 1) * TILE * LDB, LDB, [&](int i, int q) {
      return dy + ((row0 + r0 + i) * H + h) * P + q; }, min(TILE, ch - r0), P,
      vec & VEC_X);
    cp_async_commit();
  };
  auto fetch_cum = [&](int k) {      // a thread < TILE: its row's cum
    const int h = h0 + k / n_tiles, r0 = (k % n_tiles) * TILE;
    return cum[(row0 + r0 + min(tid, min(TILE, ch - r0) - 1)) * H + h];
  };
  auto put_ec = [&](int k, float cv) {
    const int rows = min(TILE, ch - (k % n_tiles) * TILE);
    ec[k & 1][tid] = tid < rows ? expf(clip(cv, -EXP_CLAMP, 0.f)) : 0.f;
  };
  stage_C(0);                        // in step 0's group
  issue_dy(0);
  if (tid < TILE) put_ec(0, fetch_cum(0));
  int staged = 0;                    // row tile whose C sits in Cs
  float acc[2][2][4];
  for (int k = 0; k < steps; ++k) {
    const int h = h0 + k / n_tiles, rt = k % n_tiles;
    const int rows = min(TILE, ch - rt * TILE);
    if (rt == 0) zero(acc);
    __syncthreads();                 // the last step's readers are done
    if (staged != rt) {              // a chunk of more than one tile
      stage_C(rt);
      cp_async_commit();
      staged = rt;
    }
    const bool more = k + 1 < steps;
    float cv = 0.f;
    if (more) {
      issue_dy(k + 1);               // into the buffer step k - 1 read
      if (tid < TILE) cv = fetch_cum(k + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Y = Ys + (k & 1) * TILE * LDB;
    const float* e = ec[k & 1];
    product_3xtf32(
        acc, splitting([&](int n, int t) {
          return __fmul_rn(Cs[t * LDB + n], e[t]); }),
        splitting([&](int t, int p) { return Y[t * LDB + p]; }), w,
        round8(rows), round8(rows));
    if (more && tid < TILE) put_ec(k + 1, cv);   // step k - 1's buffer
    if (rt == n_tiles - 1) {
      float* out = dS + (((long long)b * H + h) * nc + c) * N * P;
      store_tile(acc, w, N, P, [&](int n, int p) { return out + n * P + p; });
    }
  }
}

// Pass 2, grid (b * h, slices of n * p): the reverse carry.  A thread takes
// 4 neighbouring elements (one float4 where VEC) and issues the loads of
// CARRY_UNROLL chunks (their slots and decays) before it walks them from the
// last; each slot is read and written by one thread, read first.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_carry_kernel(const float* __restrict__ cum,
                     const float* __restrict__ dS_final,
                     float* __restrict__ dS, float* __restrict__ dstate,
                     int H, int S, int NP, int ch) {
  constexpr int PER = CARRY_ELEMS / THREADS;
  static_assert(PER == 4, "a thread's elements are one float4");
  const int nc = S / ch;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const long long base = (long long)bh * NP;
  float* slots = dS + base * nc;
  const float* cum_end = cum + ((long long)b * S + ch - 1) * H + h;
  const int e0 = blockIdx.y * CARRY_ELEMS + PER * threadIdx.x;
  auto load = [&](const float* src, float (&v)[PER]) {
    if (VEC) {
      const float4 f = *reinterpret_cast<const float4*>(src + min(e0, NP - PER));
      v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
    } else {
#pragma unroll
      for (int k = 0; k < PER; ++k) v[k] = src[min(e0 + k, NP - 1)];
    }
  };
  auto store = [&](float* dst, const float (&v)[PER]) {
    if (VEC) {
      if (e0 < NP)
        *reinterpret_cast<float4*>(dst + e0) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < PER; ++k)
        if (e0 + k < NP) dst[e0 + k] = v[k];
    }
  };
  float st[PER] = {0.f, 0.f, 0.f, 0.f};
  if (dS_final != nullptr) load(dS_final + base, st);
  for (int c1 = nc - 1; c1 >= 0; c1 -= CARRY_UNROLL) {
    float d[CARRY_UNROLL][PER], ce[CARRY_UNROLL];
#pragma unroll
    for (int u = 0; u < CARRY_UNROLL; ++u) {     // every load first
      const long long cc = max(c1 - u, 0);
      ce[u] = cum_end[cc * ch * H];
      load(slots + cc * NP, d[u]);
    }
#pragma unroll
    for (int u = 0; u < CARRY_UNROLL; ++u) {
      if (c1 - u < 0) break;
      const float dec = expf(clip(ce[u], -EXP_CLAMP, 0.f));
      store(slots + (long long)(c1 - u) * NP, st);
#pragma unroll
      for (int k = 0; k < PER; ++k)
        st[k] = __fadd_rn(__fmul_rn(st[k], dec), d[u][k]);
    }
  }
  store(dstate + base, st);
}

// Pass 3 where a chunk is one tile, grid (b * chunks, head groups): dx,
// ddt, the group's terms of dB and dC, each head's partials of dA_log and
// dD.  The order of cp.async groups: (B, C, head 0's x / dy / cum / dt),
// (head 0's S_in, dS_out), then at head j: (head j + 1's x ...) on entry,
// (head j + 1's S_in, dS_out) once this head's first products are done.
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_fused_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A_log,
                     const float* __restrict__ Bm, const float* __restrict__ Cm,
                     const float* __restrict__ Dv, const float* __restrict__ dy,
                     const float* __restrict__ cum,
                     const float* __restrict__ S_in,
                     const float* __restrict__ dS, float* __restrict__ dx,
                     float* __restrict__ ddt, float* __restrict__ dB_part,
                     float* __restrict__ dC_part, float* __restrict__ dD_part,
                     float* __restrict__ da_part, int H, int S, int P, int N,
                     int ch, int G, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* Bs = smem;                      // B of the chunk           [s][n]
  float* Cs = Bs + TILE_FLOATS;          // C of the chunk           [t][n]
  float* Sc = Cs + TILE_FLOATS;          // the scores C B^T         [t][s]
  float* Ws = Sc + TILE_FLOATS;          // a head's W               [t][s]
  float* Ds = Ws + TILE_FLOATS;          // a head's dscores         [t][s]
  float* Si = Ds + TILE_FLOATS;          // a head's S_in            [n][p]
  float* So = Si + TILE_FLOATS;          // a head's dS_out          [n][p]
  float* Xb = So + TILE_FLOATS;          // x, by head parity        [s][p]
  float* Yb = Xb + 2 * TILE_FLOATS;      // dy, by head parity       [t][p]
  float* cum_b = Yb + 2 * TILE_FLOATS;   // cum, by head parity
  float* dt_b = cum_b + 2 * TILE;        // dt, by head parity
  // row and column partial sums (put_row_parts / put_col_parts): C . Q,
  // B . U, the row and the column sums of d/d(cum_t - cum_s), x . dxdt
  __shared__ float r_cq[4 * TILE], r_bu[4 * TILE], r_dz[4 * TILE],
      r_xd[4 * TILE], c_dz[2 * TILE];
  __shared__ float ecv[TILE], tlv[TILE], dd_row[TILE], yx_row[TILE];
  __shared__ bool e_in[TILE], t_in[TILE];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nc = S / ch;
  const int b = blockIdx.x / nc, c = blockIdx.x % nc, c0 = c * ch;
  const int grp = blockIdx.y, slots = gridDim.y;
  const int h0 = grp * G, heads = min(G, H - h0);
  const long long row0 = (long long)b * S + c0;
  const WarpTile w = warp_tile();
  const int kp = round8(P), kn = round8(N), kc = round8(ch);

  auto issue_xd = [&](int j) {           // head j's x, dy, cum and dt
    const int h = h0 + j;
    stage(Xb + (j & 1) * TILE_FLOATS, LD, [&](int i, int q) {
      return x + ((row0 + i) * H + h) * P + q; }, ch, P, vec & VEC_X);
    stage(Yb + (j & 1) * TILE_FLOATS, LD, [&](int i, int q) {
      return dy + ((row0 + i) * H + h) * P + q; }, ch, P, vec & VEC_X);
    if (tid < TILE) {
      const long long at = (row0 + min(tid, ch - 1)) * H + h;
      cp_async4(cum_b + (j & 1) * TILE + tid, cum + at, tid < ch);
      cp_async4(dt_b + (j & 1) * TILE + tid, dt + at, tid < ch);
    }
    cp_async_commit();
  };
  auto issue_ss = [&](int j) {           // head j's S_in and dS_out
    const long long at = (((long long)b * H + h0 + j) * nc + c) * N * P;
    stage(Si, LD, [&](int i, int q) { return S_in + at + i * P + q; }, N, P,
          vec & VEC_S);
    stage(So, LD, [&](int i, int q) { return dS + at + i * P + q; }, N, P,
          vec & VEC_S);
    cp_async_commit();
  };
  stage(Bs, LD, [&](int i, int q) { return Bm + (row0 + i) * N + q; }, ch, N,
        vec & VEC_BC);
  stage(Cs, LD, [&](int i, int q) { return Cm + (row0 + i) * N + q; }, ch, N,
        vec & VEC_BC);
  issue_xd(0);                           // B and C join head 0's group
  issue_ss(0);

  float dBg[2][2][4], dCg[2][2][4];      // the group's dB and dC terms
  for (int j = 0; j < heads; ++j) {
    const int h = h0 + j;
    const bool next = j + 1 < heads;
    if (next) {
      issue_xd(j + 1);                   // into the buffers head j - 1 read
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* X = Xb + (j & 1) * TILE_FLOATS;
    const float* Y = Yb + (j & 1) * TILE_FLOATS;
    const float* cm = cum_b + (j & 1) * TILE;
    const float* dtr = dt_b + (j & 1) * TILE;
    if (j == 0) {                        // the scores, once for the group
      float sc[2][2][4];
      zero(sc);
      mm(sc, [&](int t, int n) { return Cs[t * LD + n]; },
         [&](int n, int s) { return Bs[s * LD + n]; }, kn);
      to_shared(sc, Sc);                 // read after the next barrier
    }
    const float L = cm[ch - 1];
    if (tid < TILE) {                    // the rows' clamped factors
      bool pe = false, pt = false;
      ecv[tid] = tid < ch ? cexp(cm[tid], -EXP_CLAMP, 0.f, pe) : 0.f;
      tlv[tid] = tid < ch ? cexp(__fsub_rn(L, cm[tid]), -EXP_CLAMP,
                                 EXP_CLAMP, pt) : 0.f;
      e_in[tid] = pe;
      t_in[tid] = pt;
    }
    // Q = dy S_in^T, U = xdt dS_out^T, B dS_out, dW = dy xdt^T
    float dc[2][2][4], db[2][2][4], dxa[2][2][4], dw[2][2][4];
    zero(dc);
    zero(db);
    zero(dxa);
    zero(dw);
    const auto xdt = [&](int s, int p) {
      return __fmul_rn(X[s * LD + p], dtr[s]); };
    const auto dy_of = [&](int t, int p) { return Y[t * LD + p]; };
    product2_3xtf32(
        dc, splitting(dy_of),
        splitting([&](int p, int n) { return Si[n * LD + p]; }), kp, dw,
        splitting(dy_of), splitting([&](int p, int s) { return xdt(s, p); }),
        kp, w);
    product2_3xtf32(
        db, splitting(xdt),
        splitting([&](int p, int n) { return So[n * LD + p]; }), kp, dxa,
        splitting([&](int s, int n) { return Bs[s * LD + n]; }),
        splitting([&](int n, int p) { return So[n * LD + p]; }), kn, w);
    // ddec's rows (sum dS_out S_in) and the rows of dy x (dD)
    row_sums(dd_row, P, [&](int n, int p) {
      return __fmul_rn(So[n * LD + p], Si[n * LD + p]); });
    row_sums(yx_row, P, [&](int s, int p) {
      return __fmul_rn(Y[s * LD + p], X[s * LD + p]); });
    __syncthreads();                     // S_in, dS_out read; factors written
    if (next) issue_ss(j + 1);
    {                                    // C . Q and B . U, rows in order
      float vq[2][2] = {}, vu[2][2] = {};
      for_each(w, [&](int i, int n, int si, int jj, int r) {
        vq[si][r >> 1] = __fadd_rn(vq[si][r >> 1],
                                   __fmul_rn(Cs[i * LD + n], dc[si][jj][r]));
        vu[si][r >> 1] = __fadd_rn(vu[si][r >> 1],
                                   __fmul_rn(Bs[i * LD + n], db[si][jj][r]));
      });
      put_row_parts(vq, r_cq);
      put_row_parts(vu, r_bu);
    }
    for_each(w, [&](int i, int, int si, int jj, int r) {
      dc[si][jj][r] = __fmul_rn(dc[si][jj][r], ecv[i]);     // dC = ec Q
      db[si][jj][r] = __fmul_rn(db[si][jj][r], tlv[i]);     // dB = tail U
      dxa[si][jj][r] = __fmul_rn(dxa[si][jj][r], tlv[i]);   // tail B dS_out
    });
    {                                    // dscores, W, d/d(cum_t - cum_s)
      float vr[2][2] = {}, vc[2][2] = {};
      for_each(w, [&](int t, int s, int si, int jj, int r) {
        const bool keep = t < ch && s <= t;
        bool pass;
        const float decay =
            cexp(__fsub_rn(cm[t], cm[s]), -EXP_CLAMP, EXP_CLAMP, pass);
        const float sc = Sc[t * LD + s];
        const float dsc = keep ? __fmul_rn(dw[si][jj][r], decay) : 0.f;
        Ds[t * LD + s] = dsc;
        Ws[t * LD + s] = keep ? __fmul_rn(sc, decay) : 0.f;
        const float z = keep && pass && s < t ? __fmul_rn(dsc, sc) : 0.f;
        vr[si][r >> 1] = __fadd_rn(vr[si][r >> 1], z);
        vc[jj][r & 1] = __fadd_rn(vc[jj][r & 1], z);
      });
      put_row_parts(vr, r_dz);
      put_col_parts(vc, c_dz);
    }
    __syncthreads();                     // Ds, Ws written
    // dC += dscores B (s <= t), dxdt += W^T dy and dB += dscores^T C (t >= s)
    product_3xtf32(dc, splitting([&](int t, int s) { return Ds[t * LD + s]; }),
                   splitting([&](int s, int n) { return Bs[s * LD + n]; }), w,
                   min(kc, w.m[0] + 16), min(kc, w.m[1] + 16));
    product2_3xtf32_upper(
        dxa, splitting([&](int s, int t) { return Ws[t * LD + s]; }),
        splitting(dy_of), db,
        splitting([&](int s, int t) { return Ds[t * LD + s]; }),
        splitting([&](int t, int n) { return Cs[t * LD + n]; }), w, w.m[0],
        w.m[1], kc);
    {                                    // ddt's x dxdt part; dx
      float vx[2][2] = {};
      const float Dh = Dv[h];
      for_each(w, [&](int s, int p, int si, int jj, int r) {
        const float d = dxa[si][jj][r];
        vx[si][r >> 1] = __fadd_rn(vx[si][r >> 1], __fmul_rn(X[s * LD + p], d));
        dxa[si][jj][r] =
            __fadd_rn(__fmul_rn(d, dtr[s]), __fmul_rn(Dh, Y[s * LD + p]));
      });
      put_row_parts(vx, r_xd);
      float* out = dx + (row0 * H + h) * P;
      store_tile(dxa, w, ch, P, [&](int s, int p) {
        return out + (long long)s * H * P + p; });
    }
#pragma unroll
    for (int si = 0; si < 2; ++si)       // the group's terms, heads in order
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          dCg[si][jj][r] = j ? __fadd_rn(dCg[si][jj][r], dc[si][jj][r])
                             : dc[si][jj][r];
          dBg[si][jj][r] = j ? __fadd_rn(dBg[si][jj][r], db[si][jj][r])
                             : db[si][jj][r];
        }
    __syncthreads();                     // every partial written
    if (warp == 0) {
      // ddec and the chunk's sum of dy x, rows in a fixed tree
      const float ddec = warp_sum(__fadd_rn(dd_row[lane], dd_row[lane + 32]));
      const float yx = warp_sum(__fadd_rn(yx_row[lane], yx_row[lane + 32]));
      // lane l: rows 2l and 2l + 1
      float dcum[2], zt[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int t = 2 * lane + k;
        zt[k] = t < ch && t_in[t] ? __fmul_rn(row_total(r_bu, t), tlv[t]) : 0.f;
        const float ze =
            t < ch && e_in[t] ? __fmul_rn(row_total(r_cq, t), ecv[t]) : 0.f;
        const float g_row = __fadd_rn(row_total(r_dz, t), ze);
        const float h_col = __fsub_rn(-col_total(c_dz, t), zt[k]);
        dcum[k] = t < ch ? __fadd_rn(g_row, h_col) : 0.f;
      }
      bool in_d;
      const float dec = cexp(L, -EXP_CLAMP, 0.f, in_d);
      const float dL = __fadd_rn(in_d ? __fmul_rn(ddec, dec) : 0.f,
                                 warp_sum(__fadd_rn(zt[0], zt[1])));
#pragma unroll
      for (int k = 0; k < 2; ++k)
        if (2 * lane + k == ch - 1) dcum[k] = __fadd_rn(dcum[k], dL);
      // the reverse cumsum d(dt a): suffix sums over the lanes in a fixed tree
      float incl = __fadd_rn(dcum[0], dcum[1]);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_down_sync(0xffffffffu, incl, off);
        if (lane + off < 32) incl = __fadd_rn(incl, v);
      }
      float after = __shfl_down_sync(0xffffffffu, incl, 1);
      if (lane == 31) after = 0.f;
      const float run[2] = {__fadd_rn(__fadd_rn(dcum[0], dcum[1]), after),
                            __fadd_rn(dcum[1], after)};
      const float a = -expf(A_log[h]);
      float da = 0.f;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int t = 2 * lane + k;
        if (t < ch) {
          ddt[(row0 + t) * H + h] =
              __fadd_rn(row_total(r_xd, t), __fmul_rn(run[k], a));
          da = __fadd_rn(da, __fmul_rn(run[k], dtr[t]));
        }
      }
      da = warp_sum(da);
      if (lane == 0) {
        const long long slot = ((long long)b * H + h) * nc + c;
        da_part[slot] = da;
        dD_part[slot] = yx;
      }
    }
    __syncthreads();                     // this head's buffers are free
  }
  float* bo = dB_part + (row0 * slots + grp) * N;
  float* co = dC_part + (row0 * slots + grp) * N;
  store_tile(dBg, w, ch, N, [&](int s, int n) {
    return bo + (long long)s * slots * N + n; });
  store_tile(dCg, w, ch, N, [&](int t, int n) {
    return co + (long long)t * slots * N + n; });
}

// Pass 3 where a chunk spans tiles (the first form), grid (b * h, chunks,
// row tiles): this head's term of dC, and the row side of d/dcum
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

// Pass 4 where a chunk spans tiles, grid (b * h, chunks, row tiles as the s
// rows): dx, this head's term of dB, the column side of d/dcum, ddt's x
// dxdt part, partials
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

// Pass 4b where a chunk spans tiles, grid (b * h, chunks): ddec, d/dcum of
// every row and its reverse cumsum; ddt (which holds sum_p x dxdt) += d(dt
// a) a; the chunk's sum of d(dt a) dt
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

// Pass 5, grid (bc_blocks + h / THREADS): blocks below bc_blocks take dB
// and dC, a thread a (row, n), the partials in slot order; the rest take
// dA_log and dD, a thread a head, the partials in (batch row, chunk, tile)
// order
__global__ void __launch_bounds__(THREADS)
ssd_bwd_reduce_kernel(const float* __restrict__ dB_part,
                      const float* __restrict__ dC_part,
                      float* __restrict__ dB, float* __restrict__ dC,
                      long long rows, int slots, int N, int bc_blocks,
                      const float* __restrict__ A_log,
                      const float* __restrict__ da_part,
                      const float* __restrict__ dD_part,
                      float* __restrict__ dA_log, float* __restrict__ dD,
                      int B, int H, int nc, int n_tiles) {
  if ((int)blockIdx.x < bc_blocks) {
    const long long row = (long long)blockIdx.x * BC_ROWS + threadIdx.x / DMAX;
    const int n = threadIdx.x % DMAX;
    if (row >= rows || n >= N) return;
    float sb = 0.f, scc = 0.f;
    for (int k = 0; k < slots; ++k) {
      const long long at = (row * slots + k) * N + n;
      sb = __fadd_rn(sb, dB_part[at]);
      scc = __fadd_rn(scc, dC_part[at]);
    }
    dB[row * N + n] = sb;
    dC[row * N + n] = scc;
    return;
  }
  const int h = (blockIdx.x - bc_blocks) * THREADS + threadIdx.x;
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

// the tile passes' shared-memory limits, once a device in this process (a
// function's attribute stays set for the process; the bits record it)
cudaError_t set_shared_limits() {
  static unsigned long long done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(ssd_bwd_fused_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             FUSED_SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_state_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               STATE_SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_row_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ROW_SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_col_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               COL_SMEM_BYTES);
  if (err == cudaSuccess) done |= bit;
  return err;
}

}  // namespace

// The gradient of one ssd_chunk call.  x: (B, S, H, P), dt: (B, S, H), B_
// and C: (B, S, N), A_log and D: (H,), dy: (B, S, H, P), dS_final: (B, H,
// N, P) or null (zero), all float32 and contiguous.  S_in: (B, H, S / chunk,
// N, P) and cum: (B, S, H), the forward's scratch.  heads_per_block: the
// heads of a block of the state and fused passes, in [1, MAX_HEADS].  bws:
// float32 scratch of bws_floats elements (kernels/ssd_chunk.py::PassPlan.
// backward_workspace_floats: the state gradients, g_row and h_col (B, S,
// H), dB's and dC's partials (B, S, slots, N): slots the head groups where
// chunk <= TILE, else the heads; two partials (B * H, S / chunk, row
// tiles), the chunks' sums (B * H, S / chunk), each rounded up to 4
// floats).  dx, ddt, dA_log, dB, dC, dD, dstate: the gradients, float32,
// contiguous.  Returns cudaGetLastError() after the launches (0 =
// launched).
extern "C" int ssd_chunk_bwd_launch(
    const void* x, const void* dt, const void* A_log, const void* B_,
    const void* C, const void* D, const void* dy, const void* dS_final,
    const void* S_in, const void* cum, void* bws, long long bws_floats,
    void* dx, void* ddt, void* dA_log, void* dB, void* dC, void* dD,
    void* dstate, int B, int S, int H, int P, int N, int chunk,
    int heads_per_block, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || P > DMAX ||
      N > DMAX || chunk <= 0 || S % chunk != 0 ||
      (long long)B * H > 2147483647LL || heads_per_block < 1 ||
      heads_per_block > MAX_HEADS || bws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = heads_per_block;
  const bool fused = chunk <= TILE;
  const long long nc = S / chunk;
  const long long groups = (H + G - 1) / G;
  const long long n_tiles = (chunk + TILE - 1) / TILE;
  const long long NP = (long long)N * P;
  const long long slices = (NP + CARRY_ELEMS - 1) / CARRY_ELEMS;
  const long long slots = fused ? groups : H;
  const long long n_states = round4((long long)B * H * nc * NP);
  const long long n_bsh = round4((long long)B * S * H);
  const long long n_bc = round4((long long)B * S * slots * N);
  const long long n_part = round4((long long)B * H * nc * n_tiles);
  const long long n_chunks = round4((long long)B * H * nc);
  if (nc > 65535 || n_tiles > 65535 || groups > 65535 ||
      (long long)B * nc > 2147483647LL ||
      bws_floats < n_states + 2 * n_bsh + 2 * n_bc + 2 * n_part + n_chunks)
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
  const float* dSf = static_cast<const float*>(dS_final);
  float* dS = static_cast<float*>(bws);
  float* g_row = dS + n_states;
  float* h_col = g_row + n_bsh;
  float* dB_part = h_col + n_bsh;
  float* dC_part = dB_part + n_bc;
  float* dL_part = dC_part + n_bc;
  float* dD_part = dL_part + n_part;
  float* da_part = dD_part + n_part;
  float* ddtf = static_cast<float*>(ddt);
  float* dstf = static_cast<float*>(dstate);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = set_shared_limits();
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte copies where every row of a tensor starts 16-byte aligned
  auto al16 = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  const int vec = (al16(x) && al16(dy) && P % 4 == 0 ? VEC_X : 0) |
                  (al16(B_) && al16(C) && N % 4 == 0 ? VEC_BC : 0) |
                  (al16(S_in) && P % 4 == 0 ? VEC_S : 0);
  const unsigned bh = unsigned(B * H);
  const dim3 blocks(unsigned(B * nc), unsigned(groups));
  ssd_bwd_state_kernel<<<blocks, THREADS, STATE_SMEM_BYTES, st>>>(
      Cf, dyf, cf, dS, H, S, P, N, chunk, G, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const dim3 carry_grid(bh, unsigned(slices));
  if (NP % 4 == 0 && (dSf == nullptr || al16(dSf)) && al16(dstf))
    ssd_bwd_carry_kernel<true><<<carry_grid, THREADS, 0, st>>>(
        cf, dSf, dS, dstf, H, S, int(NP), chunk);
  else
    ssd_bwd_carry_kernel<false><<<carry_grid, THREADS, 0, st>>>(
        cf, dSf, dS, dstf, H, S, int(NP), chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (fused) {
    ssd_bwd_fused_kernel<<<blocks, THREADS, FUSED_SMEM_BYTES, st>>>(
        xf, dtf, Af, Bf, Cf, Df, dyf, cf, Sf, dS, static_cast<float*>(dx),
        ddtf, dB_part, dC_part, dD_part, da_part, H, S, P, N, chunk, G, vec);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  } else {
    const dim3 tiles(bh, unsigned(nc), unsigned(n_tiles));
    ssd_bwd_row_kernel<<<tiles, THREADS, ROW_SMEM_BYTES, st>>>(
        xf, dtf, Bf, Cf, dyf, cf, Sf, dC_part, g_row, H, S, P, N, chunk);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
    ssd_bwd_col_kernel<<<tiles, THREADS, COL_SMEM_BYTES, st>>>(
        xf, dtf, Bf, Cf, Df, dyf, cf, dS, static_cast<float*>(dx), ddtf,
        dB_part, h_col, dL_part, dD_part, H, S, P, N, chunk);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
    ssd_bwd_dcum_kernel<<<dim3(bh, unsigned(nc)), THREADS, 0, st>>>(
        dtf, Af, cf, Sf, dS, g_row, h_col, dL_part, ddtf, da_part, H, S,
        int(NP), chunk);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  const long long rows = (long long)B * S;
  const long long bc_blocks = (rows + BC_ROWS - 1) / BC_ROWS;
  ssd_bwd_reduce_kernel<<<unsigned(bc_blocks + (H + THREADS - 1) / THREADS),
                          THREADS, 0, st>>>(
      dB_part, dC_part, static_cast<float*>(dB), static_cast<float*>(dC),
      rows, int(slots), N, int(bc_blocks), Af, da_part, dD_part,
      static_cast<float*>(dA_log), static_cast<float*>(dD), B, H, int(nc),
      int(fused ? 1 : n_tiles));
  return static_cast<int>(cudaGetLastError());
}
