// The gradient of wkv6 (wkv6.cu) for NVIDIA Hopper (sm_90a): a kernel of
// the port, not a TPU kernel (the JAX package differentiates its jnp chunked
// form, src/repro/models/ssm.py::wkv6_chunked, with jax.grad).  Its plain
// version is kernels/wkv6.py::wkv6_backward_plain, which repeats these passes.
//
// The forward (per chunk; t, s rows of the chunk, p key and q value
// channels):
//   lw = cumsum(w) over the chunk, lw_prev = lw shifted one row, L = lw[last],
//   m = L / 2, er = exp(clip(lw_prev - m, +-60)), ek = exp(clip(m - lw, +-60)),
//   ers = exp(clip(lw_prev, -60, 0)), tail = exp(clip(L - lw, +-60)),
//   dec = exp(clip(L, -60, 0)), rr = r er, kk = k ek, rs = r ers, kt = k tail,
//   A = tril_-1(rr kk^T), y = A v + (sum_p r u k) v + rs S_in,
//   S_out = diag(dec) S_in + kt^T v.
// Given dy and the final state's gradient, the passes, launched in order on
// one stream:
//   * state pass (wkv6_bwd_state_kernel), one block per (b * h, chunk): r,
//     lw_prev and dy staged by cp.async, rs formed in place; the chunk's
//     local state gradient rs^T dy into a (b, h, chunk, p, p) scratch;
//   * carry pass (wkv6_bwd_carry_kernel), one block per (b * h, slice of the
//     p * p state): walks the chunks from the last, dS_out(c) = dS; dS =
//     diag(dec_c) dS + rs_c^T dy_c, writes dS_out(c) over the local term and
//     dS into dstate (dS_out of the last chunk: the final state's gradient,
//     or zero).  Each thread issues the loads of CARRY_UNROLL chunks (slots
//     and decays) before it walks them, as the forward's carry does;
//   * where a chunk is one tile (chunk <= TILE: rwkv6's chunk, and chunk 1),
//     one fused pass (wkv6_bwd_fused_kernel) per (b * h, chunk): r, k, v,
//     dy, lw, S_in and dS_out staged once by cp.async (r, k, v in their own
//     type: bf16 r/k/v staged as bf16, v read as bf16x2 pairs into dy1 v^T);
//     rr, kk and kt formed once; dA = tril_-1(dy v^T) and A formed once;
//     the row side (drs = dy S_in^T, drr = dA kk: dr and the gradient
//     reaching lw_prev), the column side (dkt = v dS_out^T, dv = kt dS_out
//     + A^T dy, dkk = dA^T rr: dk, dv and the gradient reaching lw), ddec =
//     sum_q dS_out S_in, d/dL from the decay, m and tail, d/dlw of every
//     row and its reverse cumsum over the chunk's rows in the block: dw
//     written once, and the chunk's partial of du.  The f32 products that
//     share a k range walk it together (product2_3xtf32: dA with A, drs with
//     dkt, A^T dy with dA^T rr), so their mma chains interleave; the causal
//     ones skip the k steps the mask zeroes.  The first form took dA on both
//     sides and sent d/dlw through device memory to a third pass;
//   * where a chunk spans tiles (ragged chunks, chunk 128), the first form's
//     row pass (wkv6_bwd_row_kernel), column pass (wkv6_bwd_col_kernel) and
//     lw pass (wkv6_bwd_dw_kernel), kept as they were: a fused form over
//     tile pairs would hold every tile's dk and dv of a chunk at once, and
//     no shipped config runs such a chunk;
//   * u pass (wkv6_bwd_du_kernel), one block per head: du, the partials
//     added in (batch row, chunk, tile) order.
// Four launches a call where a chunk is one tile, six where it spans tiles.
// Each exp(clip(z)) passes its gradient where lo <= z <= hi (torch.clamp's
// rule) and none where the clamp binds.  The products run on the TF32
// tensor cores with a 3xTF32 split (tf32_tiles.cuh), as the forward's do.
// No float atomics: every sum has one order fixed by the launch's extents
// (the column sums and the reverse cumsum in fixed shuffle trees), so a
// repeated call gives the same bits.
//
// S_in, lw and the decays are the forward's (wkv6_passes_launch keeps its
// workspace for the backward pass): the forward runs inside the layer's
// recomputation under torch.utils.checkpoint right before the backward pass,
// so keeping them costs the scratch of one layer, and the backward pass runs
// no cumsum and no forward carry of its own.
//
// Budget of the fused pass: 9 padded 64 x 68 f32 tiles (dy, lw, S_in,
// dS_out, rr, kk, kt, A, dA; the last four reused for the lw pass's terms)
// and r, k, v (f32 at 68 a row, 208,896 bytes in all; bf16 at 72 halves a
// row, 184,320): one block an SM.  A block owns one (b * h, chunk), so its
// loads overlap other SMs' products, not its own.  What bounds it on an
// H100 at rwkv6's loss shape (b 2, s 2048, h 32, p 64, chunk 64): r, k, v,
// w, dy and S_in read and dr, dk, dv, dw written once, 335.5 MB over 3.35
// TB/s = 0.100 ms (bf16 r/k/v/dr/dk/dv: 234.9 MB).
//
// The bf16 recurrence (wkv6_bwd_bf16_launch: r, k and v in bf16, the
// forward wkv6_bf16_passes_launch's) is jax.grad of the reference's
// wkv6_chunked(..., compute_dtype=bf16) rounding for rounding, as
// kernels/wkv6.py::wkv6_backward_plain(..., compute_dtype=bf16) repeats it.
// The state, fused, row and column passes are templates on r/k/v's type and
// widen them exactly where they read them.  The fused, row and column passes
// round where the reference rounds, each value from an f32 sum or product:
//   dy1 = bf16(dy) (the intra-chunk output's gradient; packing rounds it),
//   rr = bf16(r * bf16(er)), kk = bf16(k * bf16(ek)), A = bf16(rr kk^T),
//   dA = bf16(tril_-1(dy1 v^T)), drr = bf16(dA kk), dkk = bf16(dA^T rr),
//   A^T dy1 rounded once (each over every tile of the chunk before its
//   rounding), these five products on the bf16 tensor cores (mma.sync
//   m16n8k16, f32 accumulate);
//   dr = bf16(bf16(bf16(ers drs) + bf16(dy.v k u)) + bf16(bf16(er) drr)),
//   dk = bf16(bf16(bf16(tail dkt) + bf16(dy.v (r u))) + bf16(bf16(ek) dkk)),
//   dv = bf16(bf16(bf16(kt dS_out) + bf16((r u . k) dy)) + bf16(A^T dy1)),
//   each f32 term rounded, then added in bf16 in the order of the
//   reference's VJP (state + u, then the intra-chunk term);
//   the factors' gradients bf16(r drr) er and bf16(k dkk) ek (f32 after the
//   rounding) into d/dlw.
// The carried-state and state products stay 3xTF32 (dy and S_in, dS_out
// are f32); the carry, lw and u passes, dw, du and dstate stay f32.  dr, dk
// and dv are written in bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_tiles.cuh"

namespace {

using namespace tf32_tiles;

constexpr int PMAX = 64;          // largest head size
constexpr int TILE = 64;          // rows of a chunk tile
constexpr int THREADS = 256;      // 8 warps (warp_tile: a warp's share)
constexpr int CARRY_ELEMS = 1024; // state elements of a carry block (4 a thread)
constexpr int CARRY_UNROLL = 8;   // chunks whose loads the carry pass issues at once
constexpr int LD = PMAX + 4;      // row stride of the tile passes' f32 tiles
constexpr int LDB = PMAX + 8;     // row stride of the state pass's ([k][j] reads)
constexpr int TILE_FLOATS = TILE * LD;
constexpr float EXP_CLAMP = 60.0f;
constexpr int ROW_TILES = 7;      // shared tiles of the multi-tile row pass
constexpr int COL_TILES = 9;      // shared tiles of the multi-tile column pass
constexpr int FUSED_TILES = 9;    // f32 tiles of the fused pass (and r, k, v)
// bits of the launch's vec flags: tensors whose rows load 16 bytes a copy
constexpr int VEC_R = 1, VEC_K = 2, VEC_V = 4, VEC_DENSE = 8, VEC_S = 16;

// row stride of a tile of r, k or v in their own type (16-byte rows)
template <class T>
constexpr int LDT = IS_BF16<T> ? PMAX + 8 : PMAX + 4;
// dynamic shared memory of the fused and state passes
template <class T>
constexpr int FUSED_SMEM_BYTES =
    FUSED_TILES * TILE_FLOATS * 4 + 3 * TILE * LDT<T> * (int)sizeof(T);
template <class T>
constexpr int STATE_SMEM_BYTES =
    2 * TILE * LDB * 4 + TILE * LDT<T> * (int)sizeof(T);
constexpr int ROW_SMEM_BYTES = ROW_TILES * TILE_FLOATS * 4;
constexpr int COL_SMEM_BYTES = COL_TILES * TILE_FLOATS * 4;

// strides, in elements, of a (b, s, h, p) tensor whose p axis is contiguous
struct Seq {
  long long b, s, h;
};

// a (TILE x PMAX) tile, rows >= rows and columns >= cols zero
// (r, k and v in bf16 widened exactly)
template <class At>
__device__ __forceinline__ void load_tile(float* dst, At at, int rows,
                                          int cols) {
  for (int e = threadIdx.x; e < TILE * PMAX; e += THREADS) {
    const int i = e / PMAX, q = e % PMAX;
    dst[i * LD + q] = (i < rows && q < cols) ? widen(*at(i, q)) : 0.f;
  }
}

// a (TILE x PMAX) tile of T by cp.async (tf32_tiles.cuh: stage_tile_t)
template <class T, class At>
__device__ __forceinline__ void stage(T* dst, int ld, At at, int rows,
                                      int cols, bool vec) {
  stage_tile_t<TILE, PMAX, THREADS>(dst, ld, at, rows, cols, vec);
}

// acc = A (m, k) B (k, j) over k < k_end (a multiple of 8), 3xTF32
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

// acc = A (m, k) B (k, j) over k < k_end, 3xTF32 for f32 operands (k_end
// a multiple of 8) and on the bf16 tensor cores for bf16 ones (rounded up
// to 16: the tiles are zero past k_end)
template <bool BF, class FA, class FB>
__device__ __forceinline__ void mm_in(float (&acc)[2][2][4], FA a, FB b,
                                      int k_end) {
  if constexpr (BF)
    product_bf16(acc, a, b, warp_tile(), (k_end + 15) & ~15,
                 (k_end + 15) & ~15);
  else
    mm(acc, a, b, k_end);
}

// a warp's share of acc into a shared tile (bf16: rounded)
template <bool BF = false>
__device__ __forceinline__ void to_shared(const float (&acc)[2][2][4],
                                          float* dst) {
  for_each(warp_tile(), [&](int i, int j, int si, int jj, int r) {
    dst[i * LD + j] = BF ? round_bf16(acc[si][jj][r]) : acc[si][jj][r];
  });
}

__device__ __forceinline__ int round8(int n) { return (n + 7) & ~7; }

// a term of a bf16 gradient: x rounded to bf16 where BF
template <bool BF>
__device__ __forceinline__ float rnd(float x) {
  return BF ? round_bf16(x) : x;
}

// out[row] = sum over q < n of f(row, q), for the TILE rows, four threads a
// row in one order
template <class F>
__device__ __forceinline__ void row_sums(float* out, int n, F f) {
  const int row = threadIdx.x >> 2, part = threadIdx.x & 3;
  float d = 0.f;
  for (int q = part; q < n; q += 4) d = __fadd_rn(d, f(row, q));
  d = __fadd_rn(d, __shfl_xor_sync(0xffffffffu, d, 1));
  d = __fadd_rn(d, __shfl_xor_sync(0xffffffffu, d, 2));
  if (part == 0) out[row] = d;
}

// the clamped factor exp(clip(z, lo, hi)) and whether its gradient passes
__device__ __forceinline__ float cexp(float z, float lo, float hi,
                                      bool& pass) {
  pass = z >= lo && z <= hi;
  return expf(clip(z, lo, hi));
}

// A column's sum over a warp tile's rows, from the registers: each
// thread's part of a column (v[jj][c]: column w.j0 + 8 jj + 2 t + c, its
// four rows added in for_each's order) is added over the lanes g (a fixed
// tree) into red[warp & 1][col]; the total is the two row-strip pairs in
// order (col_total), read after a __syncthreads.
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

// out(row, col) <- the warp's share of acc as T, in pairs where ncols is
// even; rows >= nrows and cols >= ncols left out
template <class T, class Out>
__device__ __forceinline__ void store_t(const float (&acc)[2][2][4],
                                        int nrows, int ncols, Out out) {
  if constexpr (IS_BF16<T>) {
    const WarpTile w = warp_tile();
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int si = 0; si < 2; ++si)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = w.m[si] + g + 8 * half, col = w.j0 + 8 * jj + 2 * t;
          if (row >= nrows || col >= ncols) continue;
          T* dst = out(row, col);
          const float v0 = acc[si][jj][2 * half], v1 = acc[si][jj][2 * half + 1];
          if (ncols % 2 == 0) {
            *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v0, v1);
          } else {
            dst[0] = narrow<T>(v0);
            if (col + 1 < ncols) dst[1] = narrow<T>(v1);
          }
        }
  } else {
    store_tile(acc, warp_tile(), nrows, ncols, out);
  }
}

// Pass 1, grid (b * h, chunks): G_c = rs^T dy into dS's slot.  Per row tile:
// r, lw_prev (rows shifted one up) and dy staged, rs = r exp(clip(lw_prev,
// -60, 0)) formed in place of lw_prev, then the product.
template <class T>
__global__ void __launch_bounds__(THREADS, 3)
wkv6_bwd_state_kernel(const T* __restrict__ r, Seq sr,
                      const float* __restrict__ dy,
                      const float* __restrict__ lw, float* __restrict__ dS,
                      int H, int S, int P, int ch, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* Rs = smem;                                 // lw_prev, then rs [t][p]
  float* Ys = Rs + TILE * LDB;                      // dy               [t][q]
  T* Rt = reinterpret_cast<T*>(Ys + TILE * LDB);    // r                [t][p]
  const int nc = S / ch;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int c = blockIdx.y, c0 = c * ch;
  const int n_tiles = (ch + TILE - 1) / TILE;
  const T* rb = r + b * sr.b + h * sr.h;
  const long long ss = (long long)H * P;             // dense row stride
  const float* lwb = lw + (long long)b * S * ss + (long long)h * P;
  const float* dyb = dy + (long long)b * S * ss + (long long)h * P;
  float acc[2][2][4];
  zero(acc);
  for (int rt = 0; rt < n_tiles; ++rt) {
    const int r0 = rt * TILE, rows = min(TILE, ch - r0);
    if (rt > 0) __syncthreads();
    stage(Rt, LDT<T>, [&](int t, int p) { return rb + (c0 + r0 + t) * sr.s + p; },
          rows, P, vec & VEC_R);
    stage(Rs, LDB, [&](int t, int p) {
      return lwb + (long long)(c0 + max(r0 + t - 1, 0)) * ss + p; }, rows, P,
      vec & VEC_DENSE);
    stage(Ys, LDB, [&](int t, int q) {
      return dyb + (long long)(c0 + r0 + t) * ss + q; }, rows, P,
      vec & VEC_DENSE);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int e = threadIdx.x; e < TILE * PMAX; e += THREADS) {
      const int t = e / PMAX, p = e % PMAX;
      const float lp = r0 + t > 0 ? Rs[t * LDB + p] : 0.f;
      Rs[t * LDB + p] =
          __fmul_rn(widen(Rt[t * LDT<T> + p]), expf(clip(lp, -EXP_CLAMP, 0.f)));
    }
    __syncthreads();
    mm(acc, [&](int p, int t) { return Rs[t * LDB + p]; },
       [&](int t, int q) { return Ys[t * LDB + q]; }, round8(rows));
  }
  float* out = dS + ((long long)bh * nc + c) * P * P;
  store_tile(acc, warp_tile(), P, P,
             [&](int p, int q) { return out + p * P + q; });
}

// Pass 2, grid (b * h, slices of p * p): the reverse carry.  A thread takes
// 4 neighbouring elements (one float4 where VEC) and issues the loads of
// CARRY_UNROLL chunks before it walks them from the last; each slot is read
// and written by one thread, read first.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
wkv6_bwd_carry_kernel(const float* __restrict__ dec,
                      const float* __restrict__ dS_final,
                      float* __restrict__ dS, float* __restrict__ dstate,
                      int P, int nc) {
  constexpr int PER = CARRY_ELEMS / THREADS;
  static_assert(PER == 4, "a thread's elements are one float4");
  const int NP = P * P;
  const long long bh = blockIdx.x, base = bh * NP;
  float* slots = dS + base * nc;
  const float* decb = dec + bh * nc * P;
  const int e0 = blockIdx.y * CARRY_ELEMS + PER * threadIdx.x;
  int row[PER];                                    // key channel of each element
#pragma unroll
  for (int k = 0; k < PER; ++k) row[k] = min(e0 + k, NP - 1) / P;
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
    float d[CARRY_UNROLL][PER], f[CARRY_UNROLL][PER];
#pragma unroll
    for (int u = 0; u < CARRY_UNROLL; ++u) {     // every load first
      const long long cc = max(c1 - u, 0);
      load(slots + cc * NP, d[u]);
#pragma unroll
      for (int k = 0; k < PER; ++k) f[u][k] = decb[cc * P + row[k]];
    }
#pragma unroll
    for (int u = 0; u < CARRY_UNROLL; ++u) {
      if (c1 - u < 0) break;
      store(slots + (long long)(c1 - u) * NP, st);
#pragma unroll
      for (int k = 0; k < PER; ++k)
        st[k] = __fadd_rn(__fmul_rn(st[k], f[u][k]), d[u][k]);
    }
  }
  store(dstate + base, st);
}

// Pass 3 where a chunk is one tile, grid (b * h, chunks): dr, dk, dv, dw of
// the chunk's rows and its partial of du
template <class T>
__global__ void __launch_bounds__(THREADS, 1)
wkv6_bwd_fused_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, Seq sr, Seq sk, Seq sv,
                      const float* __restrict__ u,
                      const float* __restrict__ dy,
                      const float* __restrict__ lw,
                      const float* __restrict__ S_in,
                      const float* __restrict__ dS, T* __restrict__ dr,
                      T* __restrict__ dk, T* __restrict__ dv,
                      float* __restrict__ dw, float* __restrict__ du_part,
                      int H, int S, int P, int ch, int vec) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool BF = IS_BF16<T>;
  constexpr int LT = LDT<T>;
  float* Dy = smem;                      // dy                      [t][q]
  float* Lw = Dy + TILE_FLOATS;          // lw                      [t][p]
  float* Si = Lw + TILE_FLOATS;          // S_in [p][q], then drs   [t][p]
  float* So = Si + TILE_FLOATS;          // dS_out [p][q], then dkt [s][p]
  float* RR = So + TILE_FLOATS;          // rr [t][p]; then dw      [t][p]
  float* KK = RR + TILE_FLOATS;          // kk                      [s][p]
  float* KT = KK + TILE_FLOATS;          // kt                      [s][p]
  float* Am = KT + TILE_FLOATS;          // A [t][s]; then zr + zs  [t][p]
  float* dAm = Am + TILE_FLOATS;         // dA [t][s]; then -zk - zt [s][p]
  T* Rt = reinterpret_cast<T*>(dAm + TILE_FLOATS);   // r         [t][p]
  T* Kt = Rt + TILE * LT;                            // k         [s][p]
  T* Vt = Kt + TILE * LT;                            // v         [s][q]
  // column partial sums (put_col_parts) of zr, the u term, zk and zt
  __shared__ float c_zr[2 * TILE], c_ut[2 * TILE], c_zk[2 * TILE],
      c_zt[2 * TILE];
  __shared__ float u_s[PMAX], ddiag[TILE], diag[TILE], ddec[PMAX], dL[PMAX];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nc = S / ch;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int c = blockIdx.y, c0 = c * ch;
  const long long ss = (long long)H * P;
  const long long dense = (long long)b * S * ss + (long long)h * P;
  const long long slot = (long long)bh * nc + c;
  const WarpTile w = warp_tile();
  const int kp = round8(P), kc = round8(ch);

  stage(Rt, LT, [&](int i, int p) { return r + b * sr.b + h * sr.h +
                                           (c0 + i) * sr.s + p; },
        ch, P, vec & VEC_R);
  stage(Kt, LT, [&](int i, int p) { return k + b * sk.b + h * sk.h +
                                           (c0 + i) * sk.s + p; },
        ch, P, vec & VEC_K);
  stage(Vt, LT, [&](int i, int q) { return v + b * sv.b + h * sv.h +
                                           (c0 + i) * sv.s + q; },
        ch, P, vec & VEC_V);
  stage(Dy, LD, [&](int i, int q) {
    return dy + dense + (long long)(c0 + i) * ss + q; }, ch, P,
    vec & VEC_DENSE);
  stage(Lw, LD, [&](int i, int p) {
    return lw + dense + (long long)(c0 + i) * ss + p; }, ch, P,
    vec & VEC_DENSE);
  stage(Si, LD, [&](int i, int q) { return S_in + slot * P * P + i * P + q; },
        P, P, vec & VEC_S);
  stage(So, LD, [&](int i, int q) { return dS + slot * P * P + i * P + q; },
        P, P, vec & VEC_S);
  cp_async_commit();
  if (tid < PMAX) u_s[tid] = tid < P ? u[h * P + tid] : 0.f;
  cp_async_wait<0>();
  __syncthreads();
  const float* Lend = Lw + (ch - 1) * LD;          // lw of the last row: L
  for (int e = tid; e < TILE * PMAX; e += THREADS) {   // rr, kk, kt
    const int i = e / PMAX, p = e % PMAX;
    float rr = 0.f, kk = 0.f, kt = 0.f;
    if (i < ch && p < P) {
      const float l = Lw[i * LD + p], lp = i > 0 ? Lw[(i - 1) * LD + p] : 0.f;
      const float er = expf(clip(__fsub_rn(lp, 0.5f * Lend[p]), -EXP_CLAMP,
                                 EXP_CLAMP));
      const float ek = expf(clip(__fsub_rn(0.5f * Lend[p], l), -EXP_CLAMP,
                                 EXP_CLAMP));
      const float tail = expf(clip(__fsub_rn(Lend[p], l), -EXP_CLAMP,
                                   EXP_CLAMP));
      const float rv = widen(Rt[i * LT + p]), kv = widen(Kt[i * LT + p]);
      rr = BF ? round_bf16(__fmul_rn(rv, round_bf16(er))) : __fmul_rn(rv, er);
      kk = BF ? round_bf16(__fmul_rn(kv, round_bf16(ek))) : __fmul_rn(kv, ek);
      kt = __fmul_rn(kv, tail);
    }
    RR[i * LD + p] = rr;
    KK[i * LD + p] = kk;
    KT[i * LD + p] = kt;
  }
  // dy . v and r u . k of each row; ddec = sum_q dS_out S_in of each channel
  row_sums(ddiag, P, [&](int t, int q) {
    return __fmul_rn(Dy[t * LD + q], widen(Vt[t * LT + q])); });
  row_sums(diag, P, [&](int s, int p) {
    return __fmul_rn(__fmul_rn(widen(Rt[s * LT + p]), u_s[p]),
                     widen(Kt[s * LT + p])); });
  row_sums(ddec, P, [&](int p, int q) {
    return __fmul_rn(So[p * LD + q], Si[p * LD + q]); });
  __syncthreads();
  const auto dy_of = [&](int t, int q) { return Dy[t * LD + q]; };
  const auto v_of = [&](int s, int q) { return widen(Vt[s * LT + q]); };
  {                                      // dA = tril_-1(dy v^T) (bf16: dy1)
    float da[2][2][4], a[2][2][4];       // and A = tril_-1(rr kk^T)
    zero(da);
    zero(a);
    const auto rr_of = [&](int t, int p) { return RR[t * LD + p]; };
    const auto kk_of = [&](int p, int s) { return KK[s * LD + p]; };
    if constexpr (BF) {
      product_bf16x2(
          da, [&](int t, int q) {
            return pack_bf16(Dy[t * LD + q], Dy[t * LD + q + 1]); },
          [&](int q, int s) {
            return *reinterpret_cast<const uint32_t*>(Vt + s * LT + q); },
          w, (P + 15) & ~15, (P + 15) & ~15);
      mm_in<BF>(a, rr_of, kk_of, kp);
    } else {
      product2_3xtf32(da, splitting(dy_of),
                      splitting([&](int q, int s) { return v_of(s, q); }), kp,
                      a, splitting(rr_of), splitting(kk_of), kp, w);
    }
    for_each(w, [&](int t, int s, int si, int jj, int i) {
      const bool keep = t < ch && s < t;
      dAm[t * LD + s] = keep ? rnd<BF>(da[si][jj][i]) : 0.f;
      Am[t * LD + s] = keep ? rnd<BF>(a[si][jj][i]) : 0.f;
    });
  }
  // drs = dy S_in^T, dkt = v dS_out^T, dv = kt dS_out (+ A^T dy below)
  float drs[2][2][4], dkt[2][2][4], dva[2][2][4];
  zero(drs);
  zero(dkt);
  zero(dva);
  product2_3xtf32(drs, splitting(dy_of),
                  splitting([&](int q, int p) { return Si[p * LD + q]; }), kp,
                  dkt, splitting(v_of),
                  splitting([&](int q, int p) { return So[p * LD + q]; }), kp,
                  w);
  mm(dva, [&](int s, int p) { return KT[s * LD + p]; },
     [&](int p, int q) { return So[p * LD + q]; }, kp);
  __syncthreads();                       // S_in, dS_out read; A, dA written
  to_shared(drs, Si);
  to_shared(dkt, So);
  // drr = dA kk (s < t), A^T dy and dkk = dA^T rr (t > s); bf16: A^T dy1
  // in an accumulator of its own, rounded once
  float drr[2][2][4], dvi[2][2][4], dkk[2][2][4];
  zero(drr);
  zero(dvi);
  zero(dkk);
  if constexpr (BF) {
    const int k16 = (ch + 15) & ~15;
    product_bf16(drr, [&](int t, int s) { return dAm[t * LD + s]; },
                 [&](int s, int p) { return KK[s * LD + p]; }, w,
                 min(k16, w.m[0] + 16), min(k16, w.m[1] + 16));
    product_bf16(dvi, [&](int s, int t) { return Am[t * LD + s]; },
                 [&](int t, int q) { return Dy[t * LD + q]; }, w, k16, k16);
    product_bf16(dkk, [&](int s, int t) { return dAm[t * LD + s]; },
                 [&](int t, int p) { return RR[t * LD + p]; }, w, k16, k16);
  } else {
    product_3xtf32(drr, splitting([&](int t, int s) { return dAm[t * LD + s]; }),
                   splitting([&](int s, int p) { return KK[s * LD + p]; }), w,
                   min(kc, w.m[0] + 16), min(kc, w.m[1] + 16));
    product2_3xtf32_upper(
        dva, splitting([&](int s, int t) { return Am[t * LD + s]; }),
        splitting(dy_of), dkk,
        splitting([&](int s, int t) { return dAm[t * LD + s]; }),
        splitting([&](int t, int p) { return RR[t * LD + p]; }), w, w.m[0],
        w.m[1], kc);
  }
  __syncthreads();                       // A, dA, rr free; drs, dkt written
  float* Gt = Am;                        // zr + zs            [t][p]
  float* Et = dAm;                       // -zk - zt           [s][p]
  {                                      // dr, and d/dlw_prev
    float vr[2][2] = {}, vu[2][2] = {};
    for_each(w, [&](int t, int p, int si, int jj, int i) {
      float out = 0.f, g = 0.f, zr = 0.f, ut = 0.f;
      if (t < ch && p < P) {
        const float lp = t > 0 ? Lw[(t - 1) * LD + p] : 0.f;
        bool in_r, in_s;
        const float er = cexp(__fsub_rn(lp, 0.5f * Lend[p]), -EXP_CLAMP,
                              EXP_CLAMP, in_r);
        const float ers = cexp(lp, -EXP_CLAMP, 0.f, in_s);
        const float rv = widen(Rt[t * LT + p]), kv = widen(Kt[t * LT + p]);
        const float d_rr = rnd<BF>(drr[si][jj][i]), d_rs = Si[t * LD + p];
        if constexpr (BF) {
          out = round_bf16(__fadd_rn(
              round_bf16(__fadd_rn(
                  round_bf16(__fmul_rn(ers, d_rs)),
                  round_bf16(__fmul_rn(__fmul_rn(ddiag[t], kv), u_s[p])))),
              round_bf16(__fmul_rn(round_bf16(er), d_rr))));
        } else {
          const float dd = __fmul_rn(ddiag[t], u_s[p]);
          out = __fadd_rn(__fadd_rn(__fmul_rn(er, d_rr), __fmul_rn(ers, d_rs)),
                          __fmul_rn(dd, kv));
        }
        zr = in_r ? __fmul_rn(rnd<BF>(__fmul_rn(rv, d_rr)), er) : 0.f;
        const float zs = in_s ? __fmul_rn(__fmul_rn(rv, d_rs), ers) : 0.f;
        g = __fadd_rn(zr, zs);
        ut = __fmul_rn(__fmul_rn(ddiag[t], rv), kv);
      }
      drr[si][jj][i] = out;
      Gt[t * LD + p] = g;
      vr[jj][i & 1] = __fadd_rn(vr[jj][i & 1], zr);
      vu[jj][i & 1] = __fadd_rn(vu[jj][i & 1], ut);
    });
    put_col_parts(vr, c_zr);
    put_col_parts(vu, c_ut);
    store_t<T>(drr, ch, P, [&](int t, int p) {
      return dr + dense + (long long)(c0 + t) * ss + p; });
  }
  {                                      // dk, and d/dlw through ek and tail
    float vk[2][2] = {}, vt[2][2] = {};
    for_each(w, [&](int s, int p, int si, int jj, int i) {
      float out = 0.f, e = 0.f, zk = 0.f, zt = 0.f;
      if (s < ch && p < P) {
        const float l = Lw[s * LD + p];
        bool in_k, in_t;
        const float ek = cexp(__fsub_rn(0.5f * Lend[p], l), -EXP_CLAMP,
                              EXP_CLAMP, in_k);
        const float tail = cexp(__fsub_rn(Lend[p], l), -EXP_CLAMP, EXP_CLAMP,
                                in_t);
        const float kv = widen(Kt[s * LT + p]), rv = widen(Rt[s * LT + p]);
        const float d_kk = rnd<BF>(dkk[si][jj][i]), d_kt = So[s * LD + p];
        if constexpr (BF) {
          out = round_bf16(__fadd_rn(
              round_bf16(__fadd_rn(
                  round_bf16(__fmul_rn(d_kt, tail)),
                  round_bf16(__fmul_rn(ddiag[s], __fmul_rn(rv, u_s[p]))))),
              round_bf16(__fmul_rn(d_kk, round_bf16(ek)))));
        } else {
          out = __fadd_rn(
              __fadd_rn(__fmul_rn(ek, d_kk), __fmul_rn(tail, d_kt)),
              __fmul_rn(__fmul_rn(ddiag[s], u_s[p]), rv));
        }
        zk = in_k ? __fmul_rn(rnd<BF>(__fmul_rn(kv, d_kk)), ek) : 0.f;
        zt = in_t ? __fmul_rn(__fmul_rn(kv, d_kt), tail) : 0.f;
        e = __fsub_rn(-zk, zt);
      }
      dkk[si][jj][i] = out;
      Et[s * LD + p] = e;
      vk[jj][i & 1] = __fadd_rn(vk[jj][i & 1], zk);
      vt[jj][i & 1] = __fadd_rn(vt[jj][i & 1], zt);
    });
    put_col_parts(vk, c_zk);
    put_col_parts(vt, c_zt);
    store_t<T>(dkk, ch, P, [&](int s, int p) {
      return dk + dense + (long long)(c0 + s) * ss + p; });
  }
  // dv = kt dS_out + A^T dy (bf16: A^T dy1 rounded once) + (sum_p r u k) dy
  for_each(w, [&](int s, int q, int si, int jj, int i) {
    const float du_term = __fmul_rn(diag[s], Dy[s * LD + q]);
    dva[si][jj][i] =
        BF ? round_bf16(__fadd_rn(
                 round_bf16(__fadd_rn(round_bf16(dva[si][jj][i]),
                                      round_bf16(du_term))),
                 round_bf16(dvi[si][jj][i])))
           : __fadd_rn(dva[si][jj][i], du_term);
  });
  store_t<T>(dva, ch, P, [&](int s, int q) {
    return dv + dense + (long long)(c0 + s) * ss + q; });
  __syncthreads();                       // the terms and their sums written
  if (tid < P) {                         // d/dL; the chunk's partial of du
    const float mk = col_total(c_zk, tid), mr = col_total(c_zr, tid);
    const float lt = col_total(c_zt, tid);
    bool in_d;
    const float dec = cexp(Lend[tid], -EXP_CLAMP, 0.f, in_d);
    dL[tid] = __fadd_rn(
        __fadd_rn(in_d ? __fmul_rn(ddec[tid], dec) : 0.f,
                  __fmul_rn(0.5f, __fsub_rn(mk, mr))), lt);
    du_part[slot * P + tid] = col_total(c_ut, tid);
  }
  __syncthreads();
  // dw: the reverse cumsum of d/dlw over the rows, a warp a channel (lane l:
  // rows 2l and 2l + 1), suffix sums over the lanes in a fixed tree
  for (int p = warp; p < P; p += THREADS / 32) {
    float d[2];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int t = 2 * lane + kk;
      d[kk] = t < ch ? __fadd_rn(Et[t * LD + p], t == ch - 1
                                                     ? dL[p]
                                                     : Gt[(t + 1) * LD + p])
                     : 0.f;
    }
    float incl = __fadd_rn(d[0], d[1]);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float x = __shfl_down_sync(0xffffffffu, incl, off);
      if (lane + off < 32) incl = __fadd_rn(incl, x);
    }
    float after = __shfl_down_sync(0xffffffffu, incl, 1);
    if (lane == 31) after = 0.f;
    RR[(2 * lane) * LD + p] = __fadd_rn(__fadd_rn(d[0], d[1]), after);
    RR[(2 * lane + 1) * LD + p] = __fadd_rn(d[1], after);
  }
  __syncthreads();
  for (int e = tid; e < TILE * PMAX; e += THREADS) {   // dw, rows in turn
    const int t = e / PMAX, p = e % PMAX;
    if (t < ch && p < P) dw[dense + (long long)(c0 + t) * ss + p] = RR[t * LD + p];
  }
}

// Pass 3 where a chunk spans tiles (the first form), grid (b * h, chunks,
// row tiles): dr, d/dlw_prev, partials of d/dm and of du
template <class T>
__global__ void __launch_bounds__(THREADS)
wkv6_bwd_row_kernel(const T* __restrict__ r, const T* __restrict__ k,
                    const T* __restrict__ v, Seq sr, Seq sk, Seq sv,
                    const float* __restrict__ u, const float* __restrict__ dy,
                    const float* __restrict__ lw,
                    const float* __restrict__ S_in, T* __restrict__ dr,
                    float* __restrict__ g, float* __restrict__ dm_part,
                    float* __restrict__ du_part, int H, int S, int P,
                    int ch) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool BF = IS_BF16<T>;
  float* Dy = smem;                       // dy of the t tile   [t][q]
  float* Lt = Dy + TILE_FLOATS;           // lw of the t tile   [t][p]
  float* X1 = Lt + TILE_FLOATS;           // drs, then dz_r     [t][p]
  float* Sa = X1 + TILE_FLOATS;           // S_in [p][q], then dA [t][s]
  float* Ks = Sa + TILE_FLOATS;           // k, then kk, of the s tile; drr
  float* Vs = Ks + TILE_FLOATS;           // v of the s tile    [s][q]
  float* Ls = Vs + TILE_FLOATS;           // lw of the s tile; the u term
  __shared__ float lend[PMAX], lw0[PMAX], u_s[PMAX], ddiag[TILE];
  const int tid = threadIdx.x;
  const int nc = S / ch, n_tiles = (ch + TILE - 1) / TILE;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int c = blockIdx.y, c0 = c * ch;
  const int ti = blockIdx.z, t0 = ti * TILE, nt = min(TILE, ch - t0);
  const long long ss = (long long)H * P;
  const long long dense = (long long)b * S * ss + (long long)h * P;
  const T* rb = r + b * sr.b + h * sr.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const float* lwb = lw + dense;
  const float* dyb = dy + dense;

  load_tile(Dy, [&](int t, int q) {
    return dyb + (long long)(c0 + t0 + t) * ss + q; }, nt, P);
  load_tile(Lt, [&](int t, int p) {
    return lwb + (long long)(c0 + t0 + t) * ss + p; }, nt, P);
  const float* Sc = S_in + ((long long)bh * nc + c) * P * P;
  load_tile(Sa, [&](int p, int q) { return Sc + p * P + q; }, P, P);
  if (tid < PMAX) {
    const int p = min(tid, P - 1);
    lend[tid] = tid < P ? lwb[(long long)(c0 + ch - 1) * ss + p] : 0.f;
    lw0[tid] = tid < P && t0 > 0
                   ? lwb[(long long)(c0 + t0 - 1) * ss + p] : 0.f;
    u_s[tid] = tid < P ? u[h * P + p] : 0.f;
  }
  __syncthreads();
  {                                        // drs = dy S_in^T
    float acc[2][2][4];
    zero(acc);
    mm(acc, [&](int t, int q) { return Dy[t * LD + q]; },
       [&](int q, int p) { return Sa[p * LD + q]; }, round8(P));
    to_shared(acc, X1);
  }
  float drr[2][2][4];
  zero(drr);
  for (int sj = 0; sj <= ti; ++sj) {
    const int s0 = sj * TILE, ns = min(TILE, ch - s0);
    __syncthreads();                       // Sa, Ks, Vs, Ls are free
    load_tile(Ks, [&](int i, int p) { return kb + (c0 + s0 + i) * sk.s + p; },
              ns, P);
    load_tile(Vs, [&](int i, int q) { return vb + (c0 + s0 + i) * sv.s + q; },
              ns, P);
    load_tile(Ls, [&](int i, int p) {
      return lwb + (long long)(c0 + s0 + i) * ss + p; }, ns, P);
    __syncthreads();
    if (sj == ti)                          // dy . v of the tile's rows
      row_sums(ddiag, P, [&](int t, int q) {
        return __fmul_rn(Dy[t * LD + q], Vs[t * LD + q]); });
    for (int e = tid; e < TILE * PMAX; e += THREADS) {   // kk in place
      const int i = e / PMAX, p = e % PMAX;
      if (i < ns && p < P) {
        const float f = expf(clip(__fsub_rn(0.5f * lend[p], Ls[i * LD + p]),
                                  -EXP_CLAMP, EXP_CLAMP));
        const float x = Ks[i * LD + p];
        Ks[i * LD + p] =
            BF ? round_bf16(__fmul_rn(x, round_bf16(f))) : __fmul_rn(x, f);
      }
    }
    {                                      // dA = tril_-1(dy v^T) (bf16: dy1)
      float acc[2][2][4];
      zero(acc);
      mm_in<BF>(acc, [&](int t, int q) { return Dy[t * LD + q]; },
                [&](int q, int s) { return Vs[s * LD + q]; }, round8(P));
      for_each(warp_tile(), [&](int t, int s, int si, int jj, int i) {
        Sa[t * LD + s] = (t < nt && s < ns && s0 + s < t0 + t)
                             ? rnd<BF>(acc[si][jj][i]) : 0.f;
      });
    }
    __syncthreads();
    mm_in<BF>(drr, [&](int t, int s) { return Sa[t * LD + s]; },
              [&](int s, int p) { return Ks[s * LD + p]; }, round8(ns));
  }
  __syncthreads();
  to_shared<BF>(drr, Ks);
  __syncthreads();
  T* drb = dr + dense;
  float* gb = g + dense;
  for (int e = tid; e < TILE * PMAX; e += THREADS) {
    const int t = e / PMAX, p = e % PMAX;
    float zr = 0.f, ut = 0.f;
    if (t < nt && p < P) {
      const int row = c0 + t0 + t;
      const float lp = t > 0 ? Lt[(t - 1) * LD + p] : lw0[p];
      bool in_r, in_s;
      const float er =
          cexp(__fsub_rn(lp, 0.5f * lend[p]), -EXP_CLAMP, EXP_CLAMP, in_r);
      const float ers = cexp(lp, -EXP_CLAMP, 0.f, in_s);
      const float rv = widen(rb[row * sr.s + p]), kv = widen(kb[row * sk.s + p]);
      const float d_rr = Ks[t * LD + p], d_rs = X1[t * LD + p];
      float out;
      if constexpr (BF) {
        out = round_bf16(__fadd_rn(
            round_bf16(__fadd_rn(
                round_bf16(__fmul_rn(ers, d_rs)),
                round_bf16(__fmul_rn(__fmul_rn(ddiag[t], kv), u_s[p])))),
            round_bf16(__fmul_rn(round_bf16(er), d_rr))));
      } else {
        const float dd = __fmul_rn(ddiag[t], u_s[p]);
        out = __fadd_rn(__fadd_rn(__fmul_rn(er, d_rr), __fmul_rn(ers, d_rs)),
                        __fmul_rn(dd, kv));
      }
      drb[(long long)row * ss + p] = narrow<T>(out);
      zr = in_r ? __fmul_rn(rnd<BF>(__fmul_rn(rv, d_rr)), er) : 0.f;
      const float zs = in_s ? __fmul_rn(__fmul_rn(rv, d_rs), ers) : 0.f;
      gb[(long long)row * ss + p] = __fadd_rn(zr, zs);
      ut = __fmul_rn(__fmul_rn(ddiag[t], rv), kv);
    }
    X1[t * LD + p] = zr;
    Ls[t * LD + p] = ut;
  }
  __syncthreads();
  if (tid < P) {                           // the tile's sums, rows in order
    float zr = 0.f, ut = 0.f;
    for (int t = 0; t < nt; ++t) {
      zr = __fadd_rn(zr, X1[t * LD + tid]);
      ut = __fadd_rn(ut, Ls[t * LD + tid]);
    }
    const long long slot = (((long long)bh * nc + c) * n_tiles + ti) * P + tid;
    dm_part[slot] = zr;
    du_part[slot] = ut;
  }
}

// Pass 4 where a chunk spans tiles, grid (b * h, chunks, row tiles as the s
// rows): dv, dk, d/dlw through ek and tail (into dw), partials of d/dm and
// d/dL
template <class T>
__global__ void __launch_bounds__(THREADS)
wkv6_bwd_col_kernel(const T* __restrict__ r, const T* __restrict__ k,
                    const T* __restrict__ v, Seq sr, Seq sk, Seq sv,
                    const float* __restrict__ u, const float* __restrict__ dy,
                    const float* __restrict__ lw,
                    const float* __restrict__ dS, T* __restrict__ dk,
                    T* __restrict__ dv, float* __restrict__ dw,
                    float* __restrict__ dmk_part, float* __restrict__ dL_part,
                    int H, int S, int P, int ch) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool BF = IS_BF16<T>;
  float* Kk = smem;                       // k, then kk, of the s tile [s][p]
  float* Vt = Kk + TILE_FLOATS;           // v of the s tile          [s][q]
  float* Lt = Vt + TILE_FLOATS;           // lw of the s tile         [s][p]
  float* Sa = Lt + TILE_FLOATS;           // dS_out [p][q], then A [t][s]; dkk
  float* X2 = Sa + TILE_FLOATS;           // dkt, then dz_k           [s][p]
  float* Rr = X2 + TILE_FLOATS;           // kt [s][p], then rr of a t tile
  float* Dy = Rr + TILE_FLOATS;           // dy of the t tile         [t][q]
  float* Lw = Dy + TILE_FLOATS;           // lw of the t tile         [t][p]
  float* Sd = Lw + TILE_FLOATS;           // dA [t][s]; then dz_t     [s][p]
  __shared__ float lend[PMAX], lw0[PMAX], u_s[PMAX], ddiag[TILE], diag[TILE];
  const int tid = threadIdx.x;
  const int nc = S / ch, n_tiles = (ch + TILE - 1) / TILE;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int c = blockIdx.y, c0 = c * ch;
  const int ti = blockIdx.z, s0 = ti * TILE, ns = min(TILE, ch - s0);
  const long long ss = (long long)H * P;
  const long long dense = (long long)b * S * ss + (long long)h * P;
  const T* rb = r + b * sr.b + h * sr.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const float* lwb = lw + dense;
  const float* dyb = dy + dense;

  load_tile(Kk, [&](int i, int p) { return kb + (c0 + s0 + i) * sk.s + p; },
            ns, P);
  load_tile(Vt, [&](int i, int q) { return vb + (c0 + s0 + i) * sv.s + q; },
            ns, P);
  load_tile(Lt, [&](int i, int p) {
    return lwb + (long long)(c0 + s0 + i) * ss + p; }, ns, P);
  const float* dSo = dS + ((long long)bh * nc + c) * P * P;
  load_tile(Sa, [&](int p, int q) { return dSo + p * P + q; }, P, P);
  if (tid < PMAX) {
    const int p = min(tid, P - 1);
    lend[tid] = tid < P ? lwb[(long long)(c0 + ch - 1) * ss + p] : 0.f;
    u_s[tid] = tid < P ? u[h * P + p] : 0.f;
  }
  __syncthreads();
  for (int e = tid; e < TILE * PMAX; e += THREADS) {     // kt = k tail
    const int i = e / PMAX, p = e % PMAX;
    Rr[i * LD + p] =
        (i < ns && p < P)
            ? __fmul_rn(Kk[i * LD + p],
                        expf(clip(__fsub_rn(lend[p], Lt[i * LD + p]),
                                  -EXP_CLAMP, EXP_CLAMP)))
            : 0.f;
  }
  {                                        // dkt = v dS_out^T
    float acc[2][2][4];
    zero(acc);
    mm(acc, [&](int s, int q) { return Vt[s * LD + q]; },
       [&](int q, int p) { return Sa[p * LD + q]; }, round8(P));
    to_shared(acc, X2);
  }
  __syncthreads();
  // dv = kt dS_out + A^T dy (bf16: A^T dy1 in an accumulator of its own,
  // rounded once) + (sum_p r u k) dy
  float dva[2][2][4], dvi[2][2][4], dkk[2][2][4];
  zero(dva);
  zero(dvi);
  zero(dkk);
  mm(dva, [&](int s, int p) { return Rr[s * LD + p]; },
     [&](int p, int q) { return Sa[p * LD + q]; }, round8(P));
  for (int e = tid; e < TILE * PMAX; e += THREADS) {     // kk in place
    const int i = e / PMAX, p = e % PMAX;
    if (i < ns && p < P) {
      const float f = expf(clip(__fsub_rn(0.5f * lend[p], Lt[i * LD + p]),
                                -EXP_CLAMP, EXP_CLAMP));
      const float x = Kk[i * LD + p];
      Kk[i * LD + p] =
          BF ? round_bf16(__fmul_rn(x, round_bf16(f))) : __fmul_rn(x, f);
    }
  }
  for (int tj = ti; tj < n_tiles; ++tj) {
    const int t0 = tj * TILE, nt = min(TILE, ch - t0);
    __syncthreads();                       // Rr, Dy, Lw, Sa, Sd are free
    load_tile(Rr, [&](int t, int p) { return rb + (c0 + t0 + t) * sr.s + p; },
              nt, P);
    load_tile(Dy, [&](int t, int q) {
      return dyb + (long long)(c0 + t0 + t) * ss + q; }, nt, P);
    load_tile(Lw, [&](int t, int p) {
      return lwb + (long long)(c0 + t0 + t) * ss + p; }, nt, P);
    if (tid < PMAX)
      lw0[tid] = tid < P && t0 > 0
                     ? lwb[(long long)(c0 + t0 - 1) * ss + tid] : 0.f;
    __syncthreads();
    if (tj == ti) {                        // the s rows' dy . v and r u k
      row_sums(ddiag, P, [&](int s, int q) {
        return __fmul_rn(Dy[s * LD + q], Vt[s * LD + q]); });
      row_sums(diag, P, [&](int s, int p) {
        return s < ns ? __fmul_rn(__fmul_rn(Rr[s * LD + p], u_s[p]),
                                  widen(kb[(c0 + s0 + s) * sk.s + p]))
                      : 0.f; });
      __syncthreads();
    }
    for (int e = tid; e < TILE * PMAX; e += THREADS) {   // rr in place
      const int t = e / PMAX, p = e % PMAX;
      if (t < nt && p < P) {
        const float lp = t > 0 ? Lw[(t - 1) * LD + p] : lw0[p];
        const float f =
            expf(clip(__fsub_rn(lp, 0.5f * lend[p]), -EXP_CLAMP, EXP_CLAMP));
        const float x = Rr[t * LD + p];
        Rr[t * LD + p] =
            BF ? round_bf16(__fmul_rn(x, round_bf16(f))) : __fmul_rn(x, f);
      }
    }
    __syncthreads();
    {                                      // A and dA of (t tile, s tile)
      float a[2][2][4], da[2][2][4];
      zero(a);
      zero(da);
      mm_in<BF>(a, [&](int t, int p) { return Rr[t * LD + p]; },
                [&](int p, int s) { return Kk[s * LD + p]; }, round8(P));
      mm_in<BF>(da, [&](int t, int q) { return Dy[t * LD + q]; },
                [&](int q, int s) { return Vt[s * LD + q]; }, round8(P));
      for_each(warp_tile(), [&](int t, int s, int si, int jj, int i) {
        const bool keep = t < nt && s < ns && s0 + s < t0 + t;
        Sa[t * LD + s] = keep ? rnd<BF>(a[si][jj][i]) : 0.f;
        Sd[t * LD + s] = keep ? rnd<BF>(da[si][jj][i]) : 0.f;
      });
    }
    __syncthreads();
    if constexpr (BF)
      mm_in<BF>(dvi, [&](int s, int t) { return Sa[t * LD + s]; },
                [&](int t, int q) { return Dy[t * LD + q]; }, round8(nt));
    else
      mm(dva, [&](int s, int t) { return Sa[t * LD + s]; },
         [&](int t, int q) { return Dy[t * LD + q]; }, round8(nt));
    mm_in<BF>(dkk, [&](int s, int t) { return Sd[t * LD + s]; },
              [&](int t, int p) { return Rr[t * LD + p]; }, round8(nt));
  }
  __syncthreads();
  T* dvb = dv + dense;
  for_each(warp_tile(), [&](int s, int q, int si, int jj, int i) {
    if (s < ns && q < P) {
      const long long row = c0 + s0 + s;
      const float du_term = __fmul_rn(diag[s], dyb[row * ss + q]);
      dvb[row * ss + q] = narrow<T>(
          BF ? round_bf16(__fadd_rn(
                   round_bf16(__fadd_rn(round_bf16(dva[si][jj][i]),
                                        round_bf16(du_term))),
                   round_bf16(dvi[si][jj][i])))
             : __fadd_rn(dva[si][jj][i], du_term));
    }
  });
  to_shared<BF>(dkk, Sa);
  __syncthreads();
  T* dkb = dk + dense;
  float* dwb = dw + dense;
  for (int e = tid; e < TILE * PMAX; e += THREADS) {
    const int s = e / PMAX, p = e % PMAX;
    float zk = 0.f, zt = 0.f;
    if (s < ns && p < P) {
      const int row = c0 + s0 + s;
      const float l = Lt[s * LD + p];
      bool in_k, in_t;
      const float ek =
          cexp(__fsub_rn(0.5f * lend[p], l), -EXP_CLAMP, EXP_CLAMP, in_k);
      const float tail = cexp(__fsub_rn(lend[p], l), -EXP_CLAMP, EXP_CLAMP,
                              in_t);
      const float kv = widen(kb[row * sk.s + p]), rv = widen(rb[row * sr.s + p]);
      const float d_kk = Sa[s * LD + p], d_kt = X2[s * LD + p];
      float out;
      if constexpr (BF) {
        out = round_bf16(__fadd_rn(
            round_bf16(__fadd_rn(
                round_bf16(__fmul_rn(d_kt, tail)),
                round_bf16(__fmul_rn(ddiag[s], __fmul_rn(rv, u_s[p]))))),
            round_bf16(__fmul_rn(d_kk, round_bf16(ek)))));
      } else {
        out = __fadd_rn(
            __fadd_rn(__fmul_rn(ek, d_kk), __fmul_rn(tail, d_kt)),
            __fmul_rn(__fmul_rn(ddiag[s], u_s[p]), rv));
      }
      dkb[(long long)row * ss + p] = narrow<T>(out);
      zk = in_k ? __fmul_rn(rnd<BF>(__fmul_rn(kv, d_kk)), ek) : 0.f;
      zt = in_t ? __fmul_rn(__fmul_rn(kv, d_kt), tail) : 0.f;
      dwb[(long long)row * ss + p] = __fsub_rn(-zk, zt);
    }
    X2[s * LD + p] = zk;
    Sd[s * LD + p] = zt;
  }
  __syncthreads();
  if (tid < P) {                           // the tile's sums, rows in order
    float zk = 0.f, zt = 0.f;
    for (int s = 0; s < ns; ++s) {
      zk = __fadd_rn(zk, X2[s * LD + tid]);
      zt = __fadd_rn(zt, Sd[s * LD + tid]);
    }
    const long long slot = (((long long)bh * nc + c) * n_tiles + ti) * P + tid;
    dmk_part[slot] = zk;
    dL_part[slot] = zt;
  }
}

// Pass 4b where a chunk spans tiles, grid (b * h, chunks), a thread a key
// channel: d/dlw and its reverse cumsum over the chunk's rows into dw (which
// holds the column pass's part)
__global__ void __launch_bounds__(PMAX)
wkv6_bwd_dw_kernel(const float* __restrict__ lw, const float* __restrict__ S_in,
                   const float* __restrict__ dS, const float* __restrict__ g,
                   const float* __restrict__ dmr_part,
                   const float* __restrict__ dmk_part,
                   const float* __restrict__ dL_part, float* __restrict__ dw,
                   int H, int S, int P, int ch) {
  const int p = threadIdx.x;
  if (p >= P) return;
  const int nc = S / ch, n_tiles = (ch + TILE - 1) / TILE;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int c = blockIdx.y, c0 = c * ch;
  const long long ss = (long long)H * P;
  const long long dense = (long long)b * S * ss + (long long)h * P + p;
  const long long slot = (long long)bh * nc + c;
  const float* si = S_in + slot * P * P + (long long)p * P;
  const float* so = dS + slot * P * P + (long long)p * P;
  float ddec = 0.f;
  for (int q = 0; q < P; ++q) ddec = __fadd_rn(ddec, __fmul_rn(so[q], si[q]));
  float mk = 0.f, mr = 0.f, lt = 0.f;
  for (int ti = 0; ti < n_tiles; ++ti) {
    const long long part = (slot * n_tiles + ti) * P + p;
    mk = __fadd_rn(mk, dmk_part[part]);
    mr = __fadd_rn(mr, dmr_part[part]);
    lt = __fadd_rn(lt, dL_part[part]);
  }
  const float L = lw[dense + (long long)(c0 + ch - 1) * ss];
  bool in_d;
  const float dec = cexp(L, -EXP_CLAMP, 0.f, in_d);
  const float dL = __fadd_rn(
      __fadd_rn(in_d ? __fmul_rn(ddec, dec) : 0.f,
                __fmul_rn(0.5f, __fsub_rn(mk, mr))), lt);
  float run = 0.f;
  for (int t = ch - 1; t >= 0; --t) {
    const long long at = dense + (long long)(c0 + t) * ss;
    const float up = t == ch - 1 ? dL : g[at + ss];
    run = __fadd_rn(run, __fadd_rn(dw[at], up));
    dw[at] = run;
  }
}

// Pass 5, grid (h), a thread a channel: du, the partials in (batch row,
// chunk, tile) order
__global__ void __launch_bounds__(PMAX)
wkv6_bwd_du_kernel(const float* __restrict__ du_part, float* __restrict__ du,
                   int B, int H, int P, int nc, int n_tiles) {
  const int p = threadIdx.x, h = blockIdx.x;
  if (p >= P) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) {
    const long long base = ((long long)b * H + h) * nc * n_tiles;
    for (long long i = 0; i < (long long)nc * n_tiles; ++i)
      acc = __fadd_rn(acc, du_part[(base + i) * P + p]);
  }
  du[h * P + p] = acc;
}

inline long long round4(long long n) { return (n + 3) & ~3LL; }

// the tile passes' shared-memory limits, once a device in this process for
// each type (a function's attribute stays set for the process; the bits
// record it)
template <class T>
cudaError_t set_shared_limits() {
  static unsigned long long done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(wkv6_bwd_fused_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             FUSED_SMEM_BYTES<T>);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wkv6_bwd_state_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               STATE_SMEM_BYTES<T>);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wkv6_bwd_row_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ROW_SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wkv6_bwd_col_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               COL_SMEM_BYTES);
  if (err == cudaSuccess) done |= bit;
  return err;
}

// the launches of one call, r, k, v and dr, dk, dv of type T
// (wkv6_bwd_launch's contract)
template <class T>
int launch(const void* r, const void* k, const void* v, long long r_sb,
           long long r_ss, long long r_sh, long long k_sb, long long k_ss,
           long long k_sh, long long v_sb, long long v_ss, long long v_sh,
           const void* u, const void* dy, const void* dS_final,
           const void* fws, void* bws, long long bws_floats, void* dr,
           void* dk, void* dv, void* dw, void* du, void* dstate, int B, int S,
           int H, int P, int chunk, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P > PMAX || chunk <= 0 ||
      S % chunk != 0 || (long long)B * H > 2147483647LL || fws == nullptr ||
      bws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool fused = chunk <= TILE;
  const long long nc = S / chunk;
  const long long n_tiles = (chunk + TILE - 1) / TILE;
  const long long slices = ((long long)P * P + CARRY_ELEMS - 1) / CARRY_ELEMS;
  const long long n_states = round4((long long)B * H * nc * P * P);
  const long long n_lw = round4((long long)B * S * H * P);
  const long long n_part = round4((long long)B * H * nc * n_tiles * P);
  if (nc > 65535 || n_tiles > 65535 ||
      bws_floats < n_states + (fused ? n_part : n_lw + 4 * n_part))
    return static_cast<int>(cudaErrorInvalidValue);
  const Seq sr{r_sb, r_ss, r_sh}, sk{k_sb, k_ss, k_sh}, sv{v_sb, v_ss, v_sh};
  const T* rf = static_cast<const T*>(r);
  const T* kf = static_cast<const T*>(k);
  const T* vf = static_cast<const T*>(v);
  const float* uf = static_cast<const float*>(u);
  const float* dyf = static_cast<const float*>(dy);
  const float* dSf = static_cast<const float*>(dS_final);
  const float* S_in = static_cast<const float*>(fws);
  const float* lw = S_in + n_states;
  const float* dec = lw + n_lw;
  float* dS = static_cast<float*>(bws);
  float* g = dS + n_states;              // multi-tile: d/dlw_prev, 4 partials
  float* dmr = g + n_lw;
  float* dup = fused ? dS + n_states : dmr + n_part;   // du's partials
  float* dmk = dmr + 2 * n_part;
  float* dLp = dmk + n_part;
  float* dstf = static_cast<float*>(dstate);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = set_shared_limits<T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte copies where every row of a tensor starts 16-byte aligned
  constexpr int per16 = 16 / (int)sizeof(T);
  auto al16 = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  auto rows16 = [&](const void* ptr, long long sb, long long ss,
                    long long sh) {
    return al16(ptr) && sb % per16 == 0 && ss % per16 == 0 &&
           sh % per16 == 0 && P % per16 == 0;
  };
  const int vec = (rows16(r, r_sb, r_ss, r_sh) ? VEC_R : 0) |
                  (rows16(k, k_sb, k_ss, k_sh) ? VEC_K : 0) |
                  (rows16(v, v_sb, v_ss, v_sh) ? VEC_V : 0) |
                  (al16(dy) && al16(fws) && P % 4 == 0 ? VEC_DENSE : 0) |
                  (al16(fws) && P % 4 == 0 ? VEC_S : 0);
  const unsigned bh = unsigned(B * H);
  wkv6_bwd_state_kernel<T><<<dim3(bh, unsigned(nc)), THREADS,
                             STATE_SMEM_BYTES<T>, st>>>(
      rf, sr, dyf, lw, dS, H, S, P, chunk, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const dim3 carry_grid(bh, unsigned(slices));
  if ((P * P) % 4 == 0 && (dSf == nullptr || al16(dSf)) && al16(dstf))
    wkv6_bwd_carry_kernel<true><<<carry_grid, THREADS, 0, st>>>(
        dec, dSf, dS, dstf, P, int(nc));
  else
    wkv6_bwd_carry_kernel<false><<<carry_grid, THREADS, 0, st>>>(
        dec, dSf, dS, dstf, P, int(nc));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (fused) {
    wkv6_bwd_fused_kernel<T><<<dim3(bh, unsigned(nc)), THREADS,
                               FUSED_SMEM_BYTES<T>, st>>>(
        rf, kf, vf, sr, sk, sv, uf, dyf, lw, S_in, dS, static_cast<T*>(dr),
        static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(dw),
        dup, H, S, P, chunk, vec);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  } else {
    const dim3 tiles(bh, unsigned(nc), unsigned(n_tiles));
    wkv6_bwd_row_kernel<T><<<tiles, THREADS, ROW_SMEM_BYTES, st>>>(
        rf, kf, vf, sr, sk, sv, uf, dyf, lw, S_in, static_cast<T*>(dr), g,
        dmr, dup, H, S, P, chunk);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
    wkv6_bwd_col_kernel<T><<<tiles, THREADS, COL_SMEM_BYTES, st>>>(
        rf, kf, vf, sr, sk, sv, uf, dyf, lw, dS, static_cast<T*>(dk),
        static_cast<T*>(dv), static_cast<float*>(dw), dmk, dLp, H, S, P,
        chunk);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
    wkv6_bwd_dw_kernel<<<dim3(bh, unsigned(nc)), PMAX, 0, st>>>(
        lw, S_in, dS, g, dmr, dmk, dLp, static_cast<float*>(dw), H, S, P,
        chunk);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  wkv6_bwd_du_kernel<<<unsigned(H), PMAX, 0, st>>>(
      dup, static_cast<float*>(du), B, H, P, int(nc),
      int(fused ? 1 : n_tiles));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The gradient of one wkv6 call.  r, k, v: (B, S, H, P) float32 with the P
// axis contiguous, any other strides (in elements); u: (H, P); dy: (B, S,
// H, P) contiguous; dS_final: (B, H, P, P) contiguous, or null (zero).  fws:
// the forward's workspace (wkv6_passes_launch: the chunks' incoming states,
// lw, the decays).  bws: float32 scratch of bws_floats elements: the state
// gradients (B, H, S / chunk, P, P), then where chunk <= TILE du's partials
// (B * H, S / chunk, P), else d/dlw_prev (B, S, H, P) and four partials (B
// * H, S / chunk, row tiles, P), each rounded up to 4 floats.  dr, dk, dv,
// dw: (B, S, H, P), du: (H, P), dstate: (B, H, P, P), all float32 and
// contiguous.  Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int wkv6_bwd_launch(
    const void* r, const void* k, const void* v, long long r_sb,
    long long r_ss, long long r_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    const void* u, const void* dy, const void* dS_final, const void* fws,
    void* bws, long long bws_floats, void* dr, void* dk, void* dv, void* dw,
    void* du, void* dstate, int B, int S, int H, int P, int chunk,
    void* stream) {
  return launch<float>(r, k, v, r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb,
                       v_ss, v_sh, u, dy, dS_final, fws, bws, bws_floats, dr,
                       dk, dv, dw, du, dstate, B, S, H, P, chunk, stream);
}

// The gradient of one bf16 wkv6 call (the bf16 recurrence above): r, k and
// v in bf16 (the P axis contiguous, any other strides), fws the forward's
// workspace of wkv6_bf16_passes_launch, dr, dk and dv (B, S, H, P) bf16 and
// contiguous; u, dy, dS_final, bws, dw, du and dstate as wkv6_bwd_launch's.
extern "C" int wkv6_bwd_bf16_launch(
    const void* r, const void* k, const void* v, long long r_sb,
    long long r_ss, long long r_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    const void* u, const void* dy, const void* dS_final, const void* fws,
    void* bws, long long bws_floats, void* dr, void* dk, void* dv, void* dw,
    void* du, void* dstate, int B, int S, int H, int P, int chunk,
    void* stream) {
  return launch<__nv_bfloat16>(r, k, v, r_sb, r_ss, r_sh, k_sb, k_ss, k_sh,
                               v_sb, v_ss, v_sh, u, dy, dS_final, fws, bws,
                               bws_floats, dr, dk, dv, dw, du, dstate, B, S,
                               H, P, chunk, stream);
}
