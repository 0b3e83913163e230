// wkv6 for NVIDIA Hopper (sm_90a): the chunked RWKV6 ("Finch") WKV
// recurrence
//
//   y_t = r_t . (S_{t-1} + (u * k_t) v_t^T),   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// Replaces the Pallas kernel src/repro/kernels/wkv6.py::_kernel (wrappers
// wkv6 / _wkv6_call).  Same chunk math, clamps and order of operations:
//
//   lw      = inclusive cumsum of w_log over the chunk, per channel
//   lw_prev = lw shifted down one row (0 at the chunk's first row)
//   m       = 0.5 * lw[last]                  (centring, per channel)
//   A[t,s]  = sum_p r*exp(clip(lw_prev - m, +-60)) * k*exp(clip(m - lw, +-60)),
//             kept where s < t (strictly lower)
//   y       = A v + (sum_p r u k) v + (r * exp(clip(lw_prev, -60, 0))) S
//   S'      = S * exp(clip(lw[last], -60, 0)) + (k * exp(clip(lw[last] - lw, +-60)))^T v
//
// A chunk of more than one row is three kernels, launched in order on one
// stream by wkv6_launch from one workspace:
//   * state pass (wkv6_state_kernel), one block per (b * h, chunk): lw, by one
//     thread a channel walking the chunk's rows in order (the one summation
//     order, set by the chunk alone), written to a (b, s, h, p) scratch that
//     every later use reads; the chunk's local state term S_c = (k * tail)^T
//     v and its decay exp(clip(lw[last], -60, 0)), written to (b, h, chunk,
//     p, p) and (b, h, chunk, p) scratch.  Only the (p, p) state passes from
//     chunk to chunk, so every chunk runs at once.
//   * carry pass (wkv6_carry_kernel), one block per (b * h, slice of the p * p
//     state): walks the chunks in order, S_in[c] = S; S = S * dec_c + S_c,
//     writes S_in[c] over S_c's slot and the final state into s_out.  Each
//     element of s0 is read by the thread that later writes it, so s_out may
//     be s0.
//   * scan pass (wkv6_scan_kernel), one block per (b * h, chunk, 64-row tile
//     of the chunk): y = (r * exp(lw_prev)) S_in[c] + sum over the s tiles up
//     to the row tile of A v, + (sum_p r u k) v on the diagonal; y written
//     once.
// A chunk of one row (decode) is one kernel (wkv6_token_kernel), one block
// per (b * h, slice of 16 state columns): the block reads its slice of the
// state once, walks the tokens (y = r S + (sum_p r u k) v, S' = S * exp(clip(
// w, -60, 0)) + k v^T) and writes the slice once; it reads all of its slice
// before it writes any, so s_out may be s0.
//
// What the design does about what held the first version back (one block
// per (b, h) walking every chunk in order, the products on the CUDA cores,
// the cumsum redone per tile pair, a 32-row tile with one live row at s = 1):
//   * b * h * chunks blocks a pass (2048 at rwkv6's loss shape, not 64), and
//     a long chunk's row tiles spread over blocks of the scan pass, the
//     row tile with the most s tiles launched first;
//   * the cumsum once per chunk, in the state pass, read back from the
//     scratch by the scan pass;
//   * the four products on mma.sync m16n8k8 TF32 with a 3xTF32 split (hi =
//     rna(a), lo = rna(a - hi); lo.hi + hi.lo + hi.hi into an f32
//     accumulator; tf32_tiles.cuh, shared with ssd_chunk.cu), close to f32
//     accuracy; rr, the score product's A operand for every s tile, is
//     split once per block;
//   * tiles staged by cp.async (16 bytes a copy where every row is 16-byte
//     aligned), clamped address, zero-filled past the edge;
//   * at s = 1 a kernel of its own sized to the state's bytes: 256 threads a
//     block, one float4 of the state a thread, the sum over p by shuffles and
//     one exchange in shared memory.
// No float atomics: every sum has one order, so a repeated call gives the
// same bits, and a batch row's result does not depend on the other rows.
// Accurate expf, no fast math.
//
// bf16 operands (wkv6_bf16_launch; the JAX package's cfg.ssm_bf16=True, its
// wkv6_chunked(..., compute_dtype=bf16)): r, k and v are read as bf16 by
// every kernel (each kernel is a template on their type; w, u and the state
// stay f32) and widened on load, exactly.  The scan pass rounds where the
// reference rounds, each value from an f32 sum or product:
//   rr = bf16(r * bf16(exp(clip(lw_prev - m, +-60)))),
//   kk = bf16(k * bf16(exp(clip(m - lw, +-60)))),
//   A  = bf16(rr kk^T), on the bf16 tensor cores (mma.sync m16n8k16, f32
//        accumulate), kept where s < t,
//   y  = (bf16(A v) + (sum_p r u k) v) + (r * exp(clip(lw_prev, -60, 0))) S,
//        A v on the bf16 tensor cores into an accumulator of its own, over
//        every s tile of the chunk before it is rounded;
// the state pass's S_c, the carry and r_state S_in stay f32 (3xTF32: their
// operands are bf16-exact or f32).  At s = 1 A is all masked and the
// one-token kernel's f32 arithmetic is the reference's.
//
// Bound on this card (NVIDIA H100 SXM), rwkv6's loss shape (b 2, s 2048, h
// 32, p 64, chunk 64): r, k, v, w read once, y written once, u read once, the
// state read and written once, 169.9 MB over 3.35 TB/s = 0.0507 ms; the four
// products at TF32's 495 TFLOP/s times the split's three passes take 0.026
// ms.  Bytes bind.  The passes move more than that: the lw scratch (33.5 MB)
// is written once and read twice, the state scratch (33.5 MB) written,
// read, rewritten and read again.  At decode (s = 1) the state's bytes: 16 KB
// each way a head.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tf32_tiles.cuh"

namespace {

using namespace tf32_tiles;

constexpr int PMAX = 64;          // largest head size
constexpr int TILE = 64;          // rows of a chunk tile
constexpr int THREADS = 256;      // 8 warps (warp_tile: a warp's share)
constexpr int CARRY_ELEMS = 1024; // state elements of a carry block (4 a thread)
constexpr int CARRY_UNROLL = 8;   // chunks whose loads the carry pass issues at once
constexpr int ONE_COLS = 16;      // state columns of a one-token block (4 a thread)
constexpr int LDA = PMAX + 4;     // tile row read as [m][k] or [j][k]: banks 4g + t
constexpr int LDB = PMAX + 8;     // tile row read as [k][j] or [k][m]: banks 8t + g
constexpr float EXP_CLAMP = 60.0f;
// bits of the launch's vec flags: tensors whose rows load 16 bytes a copy
constexpr int VEC_R = 1, VEC_K = 2, VEC_V = 4, VEC_W = 8, VEC_SCRATCH = 16;
// dynamic shared memory: the state pass's w / lw, k and v tiles (LDB); the
// scan pass's rr (hi, lo), r_state or scores, k (LDA), S_in or v, lw (LDB)
constexpr int STATE_SMEM_BYTES = 3 * TILE * LDB * 4;
constexpr int SCAN_SMEM_BYTES = (4 * TILE * LDA + 2 * TILE * LDB) * 4;

// strides, in elements, of a (b, s, h, p) tensor whose p axis is contiguous
struct Seq {
  long long b, s, h;
};

// a (TILE x PMAX) tile into shared memory (tf32_tiles.cuh: stage_tile)
template <class At>
__device__ __forceinline__ void stage(float* dst, int ld, At at, int rows,
                                      int cols, bool vec) {
  stage_tile<TILE, PMAX, THREADS>(dst, ld, at, rows, cols, vec);
}

template <class T>
constexpr bool IS_BF16 = std::is_same<T, __nv_bfloat16>::value;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to the nearest bf16 (ties to even), as an f32
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// a (TILE x PMAX) tile of r, k or v into shared f32: by cp.async for f32
// operands; widened on load for bf16 ones (clamped address, zero past the
// edge, as stage_tile)
template <class T, class At>
__device__ __forceinline__ void stage_in(float* dst, int ld, At at, int rows,
                                         int cols, bool vec) {
  if constexpr (!IS_BF16<T>) {
    stage(dst, ld, at, rows, cols, vec);
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < TILE * PMAX; e += THREADS) {
      const int i = e / PMAX, q = e % PMAX;
      const float x = widen(*at(min(i, rows - 1), min(q, cols - 1)));
      dst[i * ld + q] = (i < rows && q < cols) ? x : 0.f;
    }
  }
}

// two f32 values (bf16-exact where they come from a rounding above) as one
// bf16x2 register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[strip][n8 tile] += A (m, k) B (k, j) on the bf16 tensor cores, both
// strips over k < k_both, the lower strip alone up to k_last (multiples of
// 16), as product_3xtf32; A and B read shared f32 holding bf16 values
template <class FA, class FB>
__device__ __forceinline__ void product_bf16(float (&acc)[2][2][4], FA A,
                                             FB B, const WarpTile& w,
                                             int k_both, int k_last) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
  for (int k0 = 0; k0 < k_last; k0 += 16) {
    uint32_t b[2][2];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int n = w.j0 + 8 * jj + g;
      b[jj][0] = pack_bf16(B(k0 + t2, n), B(k0 + t2 + 1, n));
      b[jj][1] = pack_bf16(B(k0 + t2 + 8, n), B(k0 + t2 + 9, n));
    }
#pragma unroll
    for (int si = 0; si < 2; ++si) {
      if (si == 0 && k0 >= k_both) continue;
      const int m = w.m[si];
      const uint32_t a[4] = {
          pack_bf16(A(m + g, k0 + t2), A(m + g, k0 + t2 + 1)),
          pack_bf16(A(m + g + 8, k0 + t2), A(m + g + 8, k0 + t2 + 1)),
          pack_bf16(A(m + g, k0 + t2 + 8), A(m + g, k0 + t2 + 9)),
          pack_bf16(A(m + g + 8, k0 + t2 + 8), A(m + g + 8, k0 + t2 + 9))};
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) mma_bf16(acc[si][jj], a, b[jj][0], b[jj][1]);
    }
  }
}

// Pass 1, grid (b * h, chunks): lw (b, s, h, p), S_c (b, h, chunk, p, p) and
// dec (b, h, chunk, p).  lw is written and, in a chunk of more than one
// tile, read back by this block (no restrict, no read-only path).
template <class T>
__global__ void __launch_bounds__(THREADS, 3)
wkv6_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ w, Seq sk, Seq sv, Seq sw,
                  float* lw, float* __restrict__ states,
                  float* __restrict__ dec, int H, int S, int P, int ch,
                  int vec) {
  extern __shared__ __align__(16) float smem[];
  float* Ws = smem;                  // w, then lw, of a row tile   [s][p]
  float* Ks = Ws + TILE * LDB;       // k, then k * tail            [s][p]
  float* Vs = Ks + TILE * LDB;       // v                           [s][q]
  __shared__ float lend[PMAX];       // lw at the chunk's last row
  const int tid = threadIdx.x;
  const int nc = S / ch;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int c = blockIdx.y, c0 = c * ch;
  const int n_tiles = (ch + TILE - 1) / TILE;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const float* wb = w + b * sw.b + h * sw.h;
  const long long lw_ss = (long long)H * P;          // lw's row stride
  float* lwb = lw + (long long)b * S * lw_ss + (long long)h * P;
  const WarpTile wt = warp_tile();

  auto stage_kv = [&](int r0, int rows) {
    stage_in<T>(Ks, LDB,
                [&](int i, int q) { return kb + (c0 + r0 + i) * sk.s + q; },
                rows, P, vec & VEC_K);
    stage_in<T>(Vs, LDB,
                [&](int i, int q) { return vb + (c0 + r0 + i) * sv.s + q; },
                rows, P, vec & VEC_V);
  };

  // 1. lw: one thread a channel, the chunk's rows in order
  float run = 0.f;
  for (int rt = 0; rt < n_tiles; ++rt) {
    const int r0 = rt * TILE, rows = min(TILE, ch - r0);
    if (rt > 0) __syncthreads();     // the last tile's walk is done
    stage(Ws, LDB, [&](int i, int q) { return wb + (c0 + r0 + i) * sw.s + q; },
          rows, P, vec & VEC_W);
    if (n_tiles == 1) stage_kv(0, rows);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (tid < P) {
      float* out = lwb + (long long)(c0 + r0) * lw_ss + tid;
      for (int i = 0; i < rows; ++i) {
        run = __fadd_rn(run, Ws[i * LDB + tid]);
        Ws[i * LDB + tid] = run;
        out[i * lw_ss] = run;
      }
    }
  }
  if (tid < P) lend[tid] = run;
  __syncthreads();

  // 2. S_c = (k * exp(clip(lw[last] - lw, +-60)))^T v over the row tiles
  float acc[2][2][4] = {};
  for (int rt = 0; rt < n_tiles; ++rt) {
    const int r0 = rt * TILE, rows = min(TILE, ch - r0);
    if (n_tiles > 1) {
      if (rt > 0) __syncthreads();   // the last product's readers are done
      stage_kv(r0, rows);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    for (int e = tid; e < TILE * PMAX; e += THREADS) {
      const int i = e / PMAX, p = e % PMAX;
      if (i < rows && p < P) {
        // lw of the tile: in Ws (one tile), else from the scratch
        const float l = n_tiles == 1
                            ? Ws[i * LDB + p]
                            : lwb[(long long)(c0 + r0 + i) * lw_ss + p];
        Ks[i * LDB + p] = __fmul_rn(
            Ks[i * LDB + p],
            expf(clip(__fsub_rn(lend[p], l), -EXP_CLAMP, EXP_CLAMP)));
      }
    }
    __syncthreads();
    const int k_end = (rows + 7) & ~7;
    product_3xtf32(
        acc, splitting([&](int m, int kk) { return Ks[kk * LDB + m]; }),
        splitting([&](int kk, int q) { return Vs[kk * LDB + q]; }), wt, k_end,
        k_end);
  }
  const long long slot = (long long)bh * nc + c;
  float* out = states + slot * P * P;
  store_tile(acc, wt, P, P, [&](int p, int q) { return out + p * P + q; });
  if (tid < P) dec[slot * P + tid] = expf(clip(lend[tid], -EXP_CLAMP, 0.f));
}

// Pass 2, grid (b * h, slices of p * p): S_in[c] over S_c, the final state
// into s_out.  s_out may be s0: each element is read and written by one
// thread, read first.  A thread takes 4 neighbouring elements, as one float4
// where VEC (p * p a multiple of 4, s0 and s_out 16-byte aligned).
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
wkv6_carry_kernel(const float* __restrict__ dec, const float* s0,
                  float* __restrict__ states, float* s_out, int P, int nc) {
  constexpr int PER = CARRY_ELEMS / THREADS;
  static_assert(PER == 4, "a thread's elements are one float4");
  const int NP = P * P;
  const long long bh = blockIdx.x, base = bh * NP;
  float* slots = states + base * nc;
  const float* decb = dec + bh * nc * P;
  const int e0 = blockIdx.y * CARRY_ELEMS + PER * threadIdx.x;
  int row[PER];                      // the state row (key channel) of each
#pragma unroll
  for (int k = 0; k < PER; ++k) row[k] = min(e0 + k, NP - 1) / P;
  auto load = [&](const float* src, float (&x)[PER]) {
    if (VEC) {
      const float4 f = *reinterpret_cast<const float4*>(src + min(e0, NP - PER));
      x[0] = f.x, x[1] = f.y, x[2] = f.z, x[3] = f.w;
    } else {
#pragma unroll
      for (int k = 0; k < PER; ++k) x[k] = src[min(e0 + k, NP - 1)];
    }
  };
  auto store = [&](float* dst, const float (&x)[PER]) {
    if (VEC) {
      if (e0 < NP)
        *reinterpret_cast<float4*>(dst + e0) = make_float4(x[0], x[1], x[2], x[3]);
    } else {
#pragma unroll
      for (int k = 0; k < PER; ++k)
        if (e0 + k < NP) dst[e0 + k] = x[k];
    }
  };
  float st[PER];
  load(s0 + base, st);
  for (int c1 = 0; c1 < nc; c1 += CARRY_UNROLL) {
    float d[CARRY_UNROLL][PER], f[CARRY_UNROLL][PER];
#pragma unroll
    for (int u = 0; u < CARRY_UNROLL; ++u) {     // every load first
      const long long cc = min(c1 + u, nc - 1);
      load(slots + cc * NP, d[u]);
#pragma unroll
      for (int k = 0; k < PER; ++k) f[u][k] = decb[cc * P + row[k]];
    }
#pragma unroll
    for (int u = 0; u < CARRY_UNROLL; ++u) {
      if (c1 + u >= nc) break;
      store(slots + (long long)(c1 + u) * NP, st);
#pragma unroll
      for (int k = 0; k < PER; ++k)
        st[k] = __fadd_rn(__fmul_rn(st[k], f[u][k]), d[u][k]);
    }
  }
  store(s_out + base, st);
}

// Pass 3, grid (b * h, chunks, row tiles of the chunk, the last first): y.
// The t tile's r, lw and k and the chunk's S_in are staged together; then
// per s tile up to the row tile its v (and, but for the first s tile of the
// first row tile, which the t tile already holds, its k and lw).
template <class T>
__global__ void __launch_bounds__(THREADS, 2)
wkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, Seq sr, Seq sk, Seq sv,
                 const float* __restrict__ u, const float* __restrict__ lw,
                 const float* __restrict__ S_in, float* __restrict__ y, int H,
                 int S, int P, int ch, int vec) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool BF = IS_BF16<T>;
  uint32_t* RrH = reinterpret_cast<uint32_t*>(smem);  // rr (hi)   [t][p]
  float* RrL = smem + TILE * LDA;    // r, then rr (lo; bf16: rr)    [t][p]
  float* As = RrL + TILE * LDA;      // r_state [t][p], then A       [t][s]
  float* Ks = As + TILE * LDA;       // k, then kk, of the s tile    [s][p]
  float* Vs = Ks + TILE * LDA;       // S_in [p][q], then v          [s][q]
  float* Ls = Vs + TILE * LDB;       // lw of the t tile, then s tile [s][p]
  __shared__ float lend[PMAX], lw0[PMAX], u_s[PMAX], diag[TILE];
  const int tid = threadIdx.x;
  const int nc = S / ch;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int c = blockIdx.y, c0 = c * ch;
  // the row tile with the most s tiles is launched first
  const int ti = gridDim.z - 1 - blockIdx.z, t0 = ti * TILE;
  const int nt = min(TILE, ch - t0);
  const WarpTile wt = warp_tile();
  const int kp = (P + 7) & ~7;
  const int kp16 = (P + 15) & ~15;   // the bf16 products' k-steps are 16
  const T* rb = r + b * sr.b + h * sr.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const long long lw_ss = (long long)H * P;
  const float* lwb = lw + (long long)b * S * lw_ss + (long long)h * P;
  const bool vec_s = vec & VEC_SCRATCH;

  auto stage_kl = [&](int s0, int ns) {
    stage_in<T>(Ks, LDA,
                [&](int i, int q) { return kb + (c0 + s0 + i) * sk.s + q; },
                ns, P, vec & VEC_K);
    stage(Ls, LDB, [&](int i, int q) { return lwb + (c0 + s0 + i) * lw_ss + q; },
          ns, P, vec_s);
  };
  auto issue_s = [&](int sj, bool kl) {  // the s tile's v, and k and lw if kl
    const int s0 = sj * TILE, ns = min(TILE, ch - s0);
    stage_in<T>(Vs, LDB,
                [&](int i, int q) { return vb + (c0 + s0 + i) * sv.s + q; },
                ns, P, vec & VEC_V);
    if (kl) stage_kl(s0, ns);
    cp_async_commit();
  };

  // the t tile's r, lw and k; S_in; lw before the tile and at the chunk's
  // last row; u
  stage_in<T>(RrL, LDA,
              [&](int i, int q) { return rb + (c0 + t0 + i) * sr.s + q; }, nt,
              P, vec & VEC_R);
  stage_kl(t0, nt);
  const float* Sc = S_in + ((long long)bh * nc + c) * P * P;
  stage(Vs, LDB, [&](int i, int q) { return Sc + i * P + q; }, P, P, vec_s);
  if (tid < PMAX) {
    const int p = min(tid, P - 1);
    cp_async4(lend + tid, lwb + (long long)(c0 + ch - 1) * lw_ss + p, tid < P);
    cp_async4(lw0 + tid, lwb + (long long)(c0 + max(t0 - 1, 0)) * lw_ss + p,
              tid < P && t0 > 0);
    cp_async4(u_s + tid, u + h * P + p, tid < P);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // sum_p r u k of the tile's rows, four threads a row, one order
  {
    const int row = tid >> 2, part = tid & 3;
    float d = 0.f;
    for (int p = part; p < P; p += 4)
      d = __fadd_rn(d, __fmul_rn(__fmul_rn(RrL[row * LDA + p], u_s[p]),
                                 Ks[row * LDA + p]));
    d = __fadd_rn(d, __shfl_xor_sync(0xffffffffu, d, 1));
    d = __fadd_rn(d, __shfl_xor_sync(0xffffffffu, d, 2));
    if (part == 0) diag[row] = d;
  }
  __syncthreads();
  // r_state = r * exp(clip(lw_prev, -60, 0)) into As; rr = r * exp(clip(
  // lw_prev - m, +-60)), split once, into RrH / RrL (bf16: rounded as the
  // reference rounds it, into RrL)
  for (int e = tid; e < TILE * PMAX; e += THREADS) {
    const int t = e / PMAX, p = e % PMAX;
    float rs = 0.f, rr = 0.f;
    if (t < nt && p < P) {
      const float x = RrL[t * LDA + p];
      const float lp = t > 0 ? Ls[(t - 1) * LDB + p] : lw0[p];
      rs = __fmul_rn(x, expf(clip(lp, -EXP_CLAMP, 0.f)));
      const float f =
          expf(clip(__fsub_rn(lp, 0.5f * lend[p]), -EXP_CLAMP, EXP_CLAMP));
      rr = BF ? round_bf16(__fmul_rn(x, round_bf16(f))) : __fmul_rn(x, f);
    }
    As[t * LDA + p] = rs;
    if constexpr (BF) {
      RrL[t * LDA + p] = rr;
    } else {
      uint32_t hi, lo;
      split(rr, hi, lo);
      RrH[t * LDA + p] = hi;
      RrL[t * LDA + p] = __uint_as_float(lo);
    }
  }
  __syncthreads();

  // inter-chunk: r_state S_in, where the intra-chunk sum starts (bf16: the
  // intra-chunk sum has an accumulator of its own, rounded once)
  float acc[2][2][4] = {};
  float acc_in[2][2][4] = {};
  product_3xtf32(acc, splitting([&](int m, int kk) { return As[m * LDA + kk]; }),
                 splitting([&](int kk, int q) { return Vs[kk * LDB + q]; }),
                 wt, kp, kp);
  __syncthreads();                   // As and Vs are free
  issue_s(0, ti > 0);                // row tile 0: Ks, Ls hold s tile 0
  const auto rr_split = [&](int m, int kk, uint32_t& hi, uint32_t& lo) {
    hi = RrH[m * LDA + kk];
    lo = __float_as_uint(RrL[m * LDA + kk]);
  };
  for (int sj = 0; sj <= ti; ++sj) {
    const int s0 = sj * TILE, ns = min(TILE, ch - s0);
    const bool on_diag = sj == ti;
    cp_async_wait<0>();
    __syncthreads();
    // kk = k * exp(clip(m - lw, +-60)) in place (bf16: rounded as rr)
    for (int e = tid; e < TILE * PMAX; e += THREADS) {
      const int i = e / PMAX, p = e % PMAX;
      if (i < ns && p < P) {
        const float f = expf(clip(__fsub_rn(0.5f * lend[p], Ls[i * LDB + p]),
                                  -EXP_CLAMP, EXP_CLAMP));
        const float x = Ks[i * LDA + p];
        Ks[i * LDA + p] =
            BF ? round_bf16(__fmul_rn(x, round_bf16(f))) : __fmul_rn(x, f);
      }
    }
    __syncthreads();
    {                                // A = rr kk^T, strictly lower (s < t)
      float sc[2][2][4] = {};
      const auto kk_t = [&](int kk, int q) { return Ks[q * LDA + kk]; };
      if constexpr (BF)
        product_bf16(sc, [&](int m, int kk) { return RrL[m * LDA + kk]; },
                     kk_t, wt, kp16, kp16);
      else
        product_3xtf32(sc, rr_split, splitting(kk_t), wt, kp, kp);
      for_each(wt, [&](int t, int q, int si, int jj, int i) {
        const float a = BF ? round_bf16(sc[si][jj][i]) : sc[si][jj][i];
        As[t * LDA + q] = (t < nt && q < ns && s0 + q < t0 + t) ? a : 0.f;
      });
    }
    __syncthreads();
    // acc += A v; on the diagonal tile a strip's rows need no s past its
    // last row
    const auto a_of = [&](int m, int kk) { return As[m * LDA + kk]; };
    const auto v_of = [&](int kk, int q) { return Vs[kk * LDB + q]; };
    if constexpr (BF) {
      const int k_all = (ns + 15) & ~15;
      product_bf16(acc_in, a_of, v_of, wt,
                   on_diag ? min(k_all, wt.m[0] + 16) : k_all,
                   on_diag ? min(k_all, wt.m[1] + 16) : k_all);
    } else {
      const int k_all = (ns + 7) & ~7;
      product_3xtf32(acc, splitting(a_of), splitting(v_of), wt,
                     on_diag ? min(k_all, wt.m[0] + 16) : k_all,
                     on_diag ? min(k_all, wt.m[1] + 16) : k_all);
    }
    if (on_diag) {                   // + (sum_p r u k) v; Vs holds v of the t tile
      for_each(wt, [&](int t, int q, int si, int jj, int i) {
        const float dv = __fmul_rn(diag[t], Vs[t * LDB + q]);
        acc[si][jj][i] =
            BF ? __fadd_rn(__fadd_rn(round_bf16(acc_in[si][jj][i]), dv),
                           acc[si][jj][i])
               : __fadd_rn(acc[si][jj][i], dv);
      });
      float* yb = y + (((long long)b * S + c0 + t0) * H + h) * P;
      store_tile(acc, wt, nt, P, [&](int t, int q) {
        return yb + (long long)t * H * P + q; });
    } else {
      __syncthreads();               // Ks, Vs, Ls and As are free
      issue_s(sj + 1, true);
    }
  }
}

// chunk == 1, grid (b * h, slices of ONE_COLS state columns): thread (p =
// tid / 4, c4 = tid % 4) holds S[p][q0 .. q0 + 3] in registers over the
// tokens.  y's sum over p: shuffles over a warp's 8 rows, then the 8 warps'
// partial sums in order, one thread a column.  VEC: the state rows load as
// float4 (p a multiple of 4, s0 and s_out 16-byte aligned).
template <bool VEC, class T>
__global__ void __launch_bounds__(THREADS)
wkv6_token_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ w,
                  Seq sr, Seq sk, Seq sv, Seq sw, const float* __restrict__ u,
                  const float* s0, float* __restrict__ y, float* s_out, int H,
                  int S, int P) {
  constexpr int WARPS = THREADS / 32;
  __shared__ float part[WARPS][ONE_COLS + 1];   // column sums, then diag
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int p = tid >> 2, pc = min(p, P - 1);
  const int q0 = blockIdx.y * ONE_COLS + 4 * (tid & 3);
  const bool live = p < P;
  const long long row = (long long)bh * P * P + (long long)pc * P;
  float st[4];
  if (VEC) {
    const float4 f = *reinterpret_cast<const float4*>(s0 + row + min(q0, P - 4));
    st[0] = f.x, st[1] = f.y, st[2] = f.z, st[3] = f.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) st[j] = s0[row + min(q0 + j, P - 1)];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (!live || q0 + j >= P) st[j] = 0.f;
  const float up = u[h * P + pc];

  for (int t = 0; t < S; ++t) {
    const T* rt = r + b * sr.b + t * sr.s + h * sr.h;
    const T* kt = k + b * sk.b + t * sk.s + h * sk.h;
    const T* vt = v + b * sv.b + t * sv.s + h * sv.h;
    const float* wt = w + b * sw.b + t * sw.s + h * sw.h;
    float rp = widen(rt[pc]), kp = widen(kt[pc]);
    const float wp = wt[pc];
    if (!live) rp = kp = 0.f;
    float vq[4], ys[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      vq[j] = q0 + j < P ? widen(vt[min(q0 + j, P - 1)]) : 0.f;
      ys[j] = __fmul_rn(rp, st[j]);
    }
    float dg = __fmul_rn(__fmul_rn(rp, up), kp);
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ys[j] = __fadd_rn(ys[j], __shfl_xor_sync(0xffffffffu, ys[j], off));
      dg = __fadd_rn(dg, __shfl_xor_sync(0xffffffffu, dg, off));
    }
    if (lane < 4) {
#pragma unroll
      for (int j = 0; j < 4; ++j) part[warp][4 * lane + j] = ys[j];
      if (lane == 0) part[warp][ONE_COLS] = dg;
    }
    __syncthreads();
    if (tid < ONE_COLS) {
      const int q = blockIdx.y * ONE_COLS + tid;
      float acc = 0.f, d = 0.f;
#pragma unroll
      for (int i = 0; i < WARPS; ++i) {
        acc = __fadd_rn(acc, part[i][tid]);
        d = __fadd_rn(d, part[i][ONE_COLS]);
      }
      if (q < P)
        y[(((long long)b * S + t) * H + h) * P + q] =
            __fadd_rn(acc, __fmul_rn(d, widen(vt[q])));
    }
    const float dec = expf(clip(wp, -EXP_CLAMP, 0.f));
#pragma unroll
    for (int j = 0; j < 4; ++j)
      st[j] = __fadd_rn(__fmul_rn(st[j], dec), __fmul_rn(kp, vq[j]));
    __syncthreads();                 // part is free for the next token
  }
  if (!live) return;
  if (VEC) {
    if (q0 < P)
      *reinterpret_cast<float4*>(s_out + row + q0) =
          make_float4(st[0], st[1], st[2], st[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (q0 + j < P) s_out[row + q0 + j] = st[j];
  }
}

inline long long round4(long long n) { return (n + 3) & ~3LL; }

// the launches of one call, r, k and v of type T (wkv6_launch's contract)
template <class T>
int launch(const void* r, const void* k, const void* v, const void* w,
           long long r_sb, long long r_ss, long long r_sh, long long k_sb,
           long long k_ss, long long k_sh, long long v_sb, long long v_ss,
           long long v_sh, long long w_sb, long long w_ss, long long w_sh,
           const void* u, const void* s0, void* y, void* s_out, void* ws,
           long long ws_floats, int B, int S, int H, int P, int chunk,
           void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P > PMAX || chunk <= 0 ||
      S % chunk != 0 || (long long)B * H > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Seq sr{r_sb, r_ss, r_sh}, sk{k_sb, k_ss, k_sh}, sv{v_sb, v_ss, v_sh},
      sw{w_sb, w_ss, w_sh};
  const T* rf = static_cast<const T*>(r);
  const T* kf = static_cast<const T*>(k);
  const T* vf = static_cast<const T*>(v);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* yf = static_cast<float*>(y);
  float* sof = static_cast<float*>(s_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto aligned16 = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  const bool state_vec = aligned16(s0) && aligned16(s_out);

  if (chunk == 1) {
    const dim3 grid(unsigned(B * H), unsigned((P + ONE_COLS - 1) / ONE_COLS));
    if (P % 4 == 0 && state_vec)
      wkv6_token_kernel<true><<<grid, THREADS, 0, st>>>(
          rf, kf, vf, wf, sr, sk, sv, sw, uf, s0f, yf, sof, H, S, P);
    else
      wkv6_token_kernel<false><<<grid, THREADS, 0, st>>>(
          rf, kf, vf, wf, sr, sk, sv, sw, uf, s0f, yf, sof, H, S, P);
    return static_cast<int>(cudaGetLastError());
  }

  const long long nc = S / chunk;
  const long long t_tiles = (chunk + TILE - 1) / TILE;
  const long long slices = ((long long)P * P + CARRY_ELEMS - 1) / CARRY_ELEMS;
  const long long n_states = round4((long long)B * H * nc * P * P);
  const long long n_lw = round4((long long)B * S * H * P);
  const long long n_dec = round4((long long)B * H * nc * P);
  if (nc > 65535 || t_tiles > 65535 || ws == nullptr || !aligned16(ws) ||
      ws_floats < n_states + n_lw + n_dec)
    return static_cast<int>(cudaErrorInvalidValue);
  float* states = static_cast<float*>(ws);
  float* lw = states + n_states;
  float* dec = lw + n_lw;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_state_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      STATE_SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wkv6_scan_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SCAN_SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte copies where every row of a tensor starts 16-byte aligned (r,
  // k and v in bf16 are widened on load, never copied)
  auto rows16 = [&](const void* ptr, const Seq& sq) {
    return aligned16(ptr) && sq.b % 4 == 0 && sq.s % 4 == 0 && sq.h % 4 == 0 &&
           P % 4 == 0 && (ptr == w || !IS_BF16<T>);
  };
  const int vec = (rows16(r, sr) ? VEC_R : 0) | (rows16(k, sk) ? VEC_K : 0) |
                  (rows16(v, sv) ? VEC_V : 0) | (rows16(w, sw) ? VEC_W : 0) |
                  (P % 4 == 0 ? VEC_SCRATCH : 0);
  const unsigned bh = unsigned(B * H);
  wkv6_state_kernel<<<dim3(bh, unsigned(nc)), THREADS, STATE_SMEM_BYTES, st>>>(
      kf, vf, wf, sk, sv, sw, lw, states, dec, H, S, P, chunk, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const dim3 carry_grid(bh, unsigned(slices));
  if ((P * P) % 4 == 0 && state_vec)
    wkv6_carry_kernel<true><<<carry_grid, THREADS, 0, st>>>(
        dec, s0f, states, sof, P, int(nc));
  else
    wkv6_carry_kernel<false><<<carry_grid, THREADS, 0, st>>>(
        dec, s0f, states, sof, P, int(nc));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  wkv6_scan_kernel<<<dim3(bh, unsigned(nc), unsigned(t_tiles)), THREADS,
                     SCAN_SMEM_BYTES, st>>>(
      rf, kf, vf, sr, sk, sv, uf, lw, states, yf, H, S, P, chunk, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v, w: (B, S, H, P) float32 with the P axis contiguous, any other
// strides (in elements).  u: (H, P), s0 and s_out: (B, H, P, P), y: (B, S,
// H, P), all float32 and contiguous; s_out may be s0.  chunk divides S.
// ws: float32 workspace of ws_floats elements, 16-byte aligned, for chunk >
// 1: the state scratch (B, H, S / chunk, P, P), then lw (B, S, H, P), then
// the chunks' decays (B, H, S / chunk, P), each rounded up to 4 floats (null
// and 0 for chunk 1).  Returns cudaGetLastError() after the launches (0 =
// launched).
extern "C" int wkv6_launch(
    const void* r, const void* k, const void* v, const void* w,
    long long r_sb, long long r_ss, long long r_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long w_sb, long long w_ss, long long w_sh,
    const void* u, const void* s0, void* y, void* s_out, void* ws,
    long long ws_floats, int B, int S, int H, int P, int chunk, void* stream) {
  return launch<float>(r, k, v, w, r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb,
                       v_ss, v_sh, w_sb, w_ss, w_sh, u, s0, y, s_out, ws,
                       ws_floats, B, S, H, P, chunk, stream);
}

// wkv6_launch with r, k and v in bf16 (the P axis contiguous, any other
// strides): the bf16 recurrence (the scan pass's roundings above); w, u,
// the state, y and the workspace as wkv6_launch's.
extern "C" int wkv6_bf16_launch(
    const void* r, const void* k, const void* v, const void* w,
    long long r_sb, long long r_ss, long long r_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long w_sb, long long w_ss, long long w_sh,
    const void* u, const void* s0, void* y, void* s_out, void* ws,
    long long ws_floats, int B, int S, int H, int P, int chunk, void* stream) {
  return launch<__nv_bfloat16>(r, k, v, w, r_sb, r_ss, r_sh, k_sb, k_ss, k_sh,
                               v_sb, v_ss, v_sh, w_sb, w_ss, w_sh, u, s0, y,
                               s_out, ws, ws_floats, B, S, H, P, chunk,
                               stream);
}
