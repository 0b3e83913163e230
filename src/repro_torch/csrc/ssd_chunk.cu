// ssd_chunk for NVIDIA Hopper (sm_90a): the chunked Mamba2 SSD recurrence
// (state-space duality form), the (n, p) state of every head carried across
// chunks.
//
// Replaces the Pallas kernel src/repro/kernels/ssd_chunk.py::_kernel
// (wrappers ssd_chunk / _ssd_chunk_call).  Same chunk math and clamps:
//
//   da      = dt * -exp(A_log_h);  cum = inclusive cumsum of da over the chunk
//   W[t,s]  = (C_t . B_s) * exp(clip(cum_t - cum_s, +-30)), kept where s <= t
//   y       = W (x * dt) + (C S) * exp(clip(cum, -30, 0)) + D_h * x
//   S'      = S * exp(clip(cum[last], -30, 0))
//             + (B * exp(clip(cum[last] - cum, +-30)))^T (x * dt)
//
// Three kernels, launched in order on one stream by ssd_chunk_launch:
//   * state pass (ssd_chunk_state_kernel), one block per (b, chunk, group of
//     heads): each head's cum (one thread a head walks the chunk in order, as
//     the plain version's cumsum does), written to a (b, s, h) scratch, and
//     the chunk's local state term dS_c = (B * tail)^T (x * dt), written to a
//     (b, h, chunk, n, p) scratch.  Only the (n, p) state passes from chunk to
//     chunk, so every chunk runs at once.
//   * carry pass (ssd_chunk_carry_kernel), one block per (b, h, slice of the
//     n * p state elements): walks the chunks in order, S_in[c] = S;
//     S = S * dec_c + dS_c, writes S_in[c] over dS_c's slot and the final
//     state into s_out.  Each element of s0 is read by the thread that later
//     writes it, so s_out may be s0.
//   * scan pass (ssd_chunk_scan_kernel), one block per (b, chunk, group of
//     heads, 64-row tile of the chunk): the scores C B^T once for all the
//     block's heads (B and C are shared by every head), then per head the
//     decay and the mask, y = ((C S_in[c]) exp(cum) + W (x dt)) + D x (the
//     products' sum starts from the inter-chunk term).
//
// What the design does about what held the first version back:
//   * too few blocks, chunks in order: the passes above give b * chunks *
//     head groups blocks (640 at zamba2's loss shape) instead of b * h (160);
//   * a serial cumsum repeated per tile pair: cum is taken once per head and
//     chunk, in the state pass, by one thread a head in parallel, and read
//     back from the scratch by the other passes;
//   * the scores once per head: once per block, shared by its heads;
//   * B and x * dt reloaded per tile pair: each tile is staged once (by
//     cp.async, clamped address, zero-filled past the edge) and read from
//     shared memory;
//   * no tensor cores: the four products run on mma.sync m16n8k8 TF32 with a
//     3xTF32 split (hi = rna(a), lo = rna(a - hi); lo.hi + hi.lo + hi.hi into
//     an f32 accumulator), close to f32 accuracy.  C, shared by every head's
//     C S_in and the scores, is split once per block; the causal product's
//     rows are dealt to the warps so that each does the same work.
//   No float atomics: every sum has one order, so a repeated call gives the
//   same bits.  Any chunk length: a chunk's rows are taken in tiles of 64,
//   cum stays relative to the chunk's start, and a block never reads another
//   chunk.  Accurate expf, no fast math.
//
// Bound on this card (NVIDIA H100 SXM), zamba2's loss shape (b 2, s 2048,
// h 80, p 64, n 64, chunk 64): x, dt, B, C, A_log and D read once, y written
// once, the state read and written once, 176.4 MB over 3.35 TB/s = 0.0527
// ms; the products (scores once per (b, chunk), three per head) at TF32's
// 495 TFLOP/s times the split's three passes take 0.049 ms.  Bytes bind.
// The passes move more than that (the dS / S_in scratch, 84 MB, is written,
// read, rewritten and read again): fusing the carry into the state pass is
// left for later.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_tiles.cuh"

namespace {

using namespace tf32_tiles;

constexpr int DMAX = 64;          // largest head size p and state size n
constexpr int TILE = 64;          // rows of a chunk tile
constexpr int THREADS = 256;      // 8 warps (warp_tile: a warp's share)
constexpr int MAX_HEADS = 8;      // heads of a block of the state and scan passes
constexpr int CARRY_ELEMS = 1024; // state elements of a carry block (4 a thread)
constexpr int CARRY_UNROLL = 8;   // chunks whose loads the carry pass issues at once
constexpr int LDA = DMAX + 4;     // tile row read as [m][k] or [j][k]: banks 4g + t
constexpr int LDB = DMAX + 8;     // tile row read as [k][j] or [k][m]: banks 8t + g
constexpr float EXP_CLAMP = 30.0f;
// bits of the launch's vec flags: tensors whose rows load 16 bytes a copy
constexpr int VEC_X = 1, VEC_B = 2, VEC_C = 4, VEC_S = 8;
// dynamic shared memory: the state pass's Bs and two x buffers (LDB); the
// scan pass's C (hi, lo), Sc, Ws (LDA), Xs, Ss (LDB), cum_t (two), cum_s,
// dt_s, ec
constexpr int STATE_SMEM_BYTES = 3 * TILE * LDB * 4;
constexpr int SCAN_SMEM_BYTES = (4 * TILE * LDA + 2 * TILE * LDB + 5 * TILE) * 4;

// a (TILE x DMAX) tile into shared memory (tf32_tiles.cuh: stage_tile)
template <class At>
__device__ __forceinline__ void stage(float* dst, int ld, At at, int rows,
                                      int cols, bool vec) {
  stage_tile<TILE, DMAX, THREADS>(dst, ld, at, rows, cols, vec);
}

// Pass 1, grid (b * chunks, head groups): cum (b, s, h) and dS (b, h, chunk,
// n, p).  cum is written and read back by this block (no restrict, no
// read-only path).  The steps (head, row tile) run in order; the x tile of
// the next step is loaded (into the other of two buffers) while this one's
// product runs.
__global__ void __launch_bounds__(THREADS, 3)
ssd_chunk_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A_log,
                       const float* __restrict__ Bm, float* cum,
                       float* __restrict__ dS, long long x_sb, long long x_ss,
                       long long x_sh, long long dt_sb, long long dt_ss,
                       long long dt_sh, long long B_sb, long long B_ss, int H,
                       int S, int P, int N, int ch, int G, int vec) {
  extern __shared__ __align__(16) float smem[];
  float* Bs = smem;                  // B of a row tile         [s][n]
  float* Xs = Bs + TILE * LDB;       // x of a step, two buffers [s][p]
  __shared__ float dts[TILE][MAX_HEADS];           // dt of a tile, per head
  __shared__ float tail[2][TILE], dt_row[2][TILE]; // by step parity
  __shared__ float run[MAX_HEADS];                 // running cum, per head

  const int tid = threadIdx.x;
  const int nc = S / ch;
  const int b = blockIdx.x / nc, c = blockIdx.x % nc, c0 = c * ch;
  const int h0 = blockIdx.y * G, heads = min(G, H - h0);
  const WarpTile w = warp_tile();
  const int n_tiles = (ch + TILE - 1) / TILE, steps = heads * n_tiles;
  const float* xb = x + b * x_sb;
  const float* dtb = dt + b * dt_sb;
  const float* Bb = Bm + b * B_sb;
  float* cumb = cum + (long long)b * S * H;

  auto stage_B = [&](int rt) {
    const int r0 = rt * TILE;
    stage(Bs, LDB, [&](int i, int q) { return Bb + (c0 + r0 + i) * B_ss + q; },
          min(TILE, ch - r0), N, vec & VEC_B);
  };
  auto issue_x = [&](int k) {        // step k: head k / n_tiles, its row tile
    const int h = h0 + k / n_tiles, r0 = (k % n_tiles) * TILE;
    stage(Xs + (k & 1) * TILE * LDB, LDB, [&](int i, int q) {
      return xb + (c0 + r0 + i) * x_ss + h * x_sh + q; }, min(TILE, ch - r0), P,
      vec & VEC_X);
    cp_async_commit();
  };
  stage_B(0);                        // in flight during the cumsum
  issue_x(0);

  // 1. cum of every head of the group, in the order of the plain cumsum
  if (tid < MAX_HEADS) run[tid] = 0.f;
  for (int r0 = 0; r0 < ch; r0 += TILE) {
    const int rows = min(TILE, ch - r0);
    for (int e = tid; e < TILE * MAX_HEADS; e += THREADS) {
      const int i = e / MAX_HEADS, j = e % MAX_HEADS;
      const float v = dtb[(c0 + r0 + min(i, rows - 1)) * dt_ss +
                          min(h0 + j, H - 1) * dt_sh];
      dts[i][j] = (i < rows && j < heads) ? v : 0.f;
    }
    __syncthreads();
    if (tid < heads) {
      const float a = -expf(A_log[h0 + tid]);
      float pre = run[tid];
      float* out = cumb + (long long)(c0 + r0) * H + h0 + tid;
      for (int i = 0; i < rows; ++i) {
        pre = __fadd_rn(pre, __fmul_rn(dts[i][tid], a));
        out[(long long)i * H] = pre;
      }
      run[tid] = pre;
    }
    __syncthreads();
  }

  // 2. per head: dS = (B * tail)^T (x * dt) over the chunk's row tiles.
  // Step k's tail and dt: read from device memory during step k - 1's
  // product (threads < TILE), kept by step parity.
  float cv = 0.f, dv = 0.f;
  auto fetch_rows = [&](int k) {
    const int h = h0 + k / n_tiles, r0 = (k % n_tiles) * TILE;
    const int i = c0 + r0 + min(tid, min(TILE, ch - r0) - 1);
    cv = cumb[(long long)i * H + h];
    dv = dtb[i * dt_ss + h * dt_sh];
  };
  auto put_rows = [&](int k) {
    const int rows = min(TILE, ch - (k % n_tiles) * TILE);
    tail[k & 1][tid] = tid < rows ? expf(clip(run[k / n_tiles] - cv,
                                              -EXP_CLAMP, EXP_CLAMP))
                                  : 0.f;
    dt_row[k & 1][tid] = tid < rows ? dv : 0.f;
  };
  if (tid < TILE) {
    fetch_rows(0);
    put_rows(0);
  }
  int staged = 0;                    // row tile whose B sits in Bs
  float acc[2][2][4];
  for (int k = 0; k < steps; ++k) {
    const int j = k / n_tiles, rt = k % n_tiles, r0 = rt * TILE;
    const int h = h0 + j, rows = min(TILE, ch - r0);
    if (rt == 0) {
#pragma unroll
      for (int q = 0; q < 16; ++q) acc[q / 8][(q / 4) % 2][q % 4] = 0.f;
    }
    __syncthreads();                 // the last step's readers are done
    if (staged != rt) {              // a chunk of more than one tile
      stage_B(rt);
      cp_async_commit();
      staged = rt;
    }
    const bool more = k + 1 < steps;
    if (more) {
      issue_x(k + 1);                // into the buffer step k - 1 read
      if (tid < TILE) fetch_rows(k + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* X = Xs + (k & 1) * TILE * LDB;
    const float* tl = tail[k & 1];
    const float* dr = dt_row[k & 1];
    const int k_end = (rows + 7) & ~7;
    product_3xtf32(
        acc, splitting([&](int m, int kk) {
          return __fmul_rn(Bs[kk * LDB + m], tl[kk]); }),
        splitting([&](int kk, int q) {
          return __fmul_rn(X[kk * LDB + q], dr[kk]); }),
        w, k_end, k_end);
    if (more && tid < TILE) put_rows(k + 1);   // step k - 1's buffers
    if (rt == n_tiles - 1) {
      float* out = dS + (((long long)b * H + h) * nc + c) * N * P;
      store_tile(acc, w, N, P, [&](int n, int q) { return out + n * P + q; });
    }
  }
}

// Pass 2, grid (b * h, slices of n * p): S_in[c] over dS_c, the final state
// into s_out.  s_out may be s0: each element is read and written by one
// thread, read first.  A thread takes 4 neighbouring elements, as one float4
// where VEC (n * p a multiple of 4, s0 and s_out 16-byte aligned).
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_carry_kernel(const float* __restrict__ cum, const float* s0,
                       float* __restrict__ dS, float* s_out, int H, int S,
                       int NP, int ch) {
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
  float st[PER];
  load(s0 + base, st);
  for (int c1 = 0; c1 < nc; c1 += CARRY_UNROLL) {
    float d[CARRY_UNROLL][PER], ce[CARRY_UNROLL];
#pragma unroll
    for (int u = 0; u < CARRY_UNROLL; ++u) {     // every load first
      const long long cc = min(c1 + u, nc - 1);
      ce[u] = cum_end[cc * ch * H];
      load(slots + cc * NP, d[u]);
    }
#pragma unroll
    for (int u = 0; u < CARRY_UNROLL; ++u) {
      if (c1 + u >= nc) break;
      const float dec = expf(clip(ce[u], -EXP_CLAMP, 0.f));
      store(slots + (long long)(c1 + u) * NP, st);
#pragma unroll
      for (int k = 0; k < PER; ++k)
        st[k] = __fadd_rn(__fmul_rn(st[k], dec), d[u][k]);
    }
  }
  store(s_out + base, st);
}

// Pass 3, grid (b * chunks, head groups, row tiles of the chunk): y.  A
// head's S_in is loaded while the last head's output is formed, and its
// first x tile while its C S_in product runs.
__global__ void __launch_bounds__(THREADS, 2)
ssd_chunk_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ Bm, const float* __restrict__ Cm,
                      const float* __restrict__ Dv, const float* __restrict__ cum,
                      const float* __restrict__ S_in, float* __restrict__ y,
                      long long x_sb, long long x_ss, long long x_sh,
                      long long dt_sb, long long dt_ss, long long dt_sh,
                      long long B_sb, long long B_ss, long long C_sb,
                      long long C_ss, int H, int S, int P, int N, int ch,
                      int G, int vec) {
  extern __shared__ __align__(16) float smem[];
  // C of the t tile [t][n], split once for every head: Cl holds the staged
  // C until it is split
  uint32_t* Ch = reinterpret_cast<uint32_t*>(smem);
  float* Cl = smem + TILE * LDA;
  float* Sc = Cl + TILE * LDA;       // C B^T of (t, s)       [t][s]
  float* Ws = Sc + TILE * LDA;       // a head's weights      [t][s]
  float* Bs = Ws;                    // B of the s tile [s][n], until the
                                     // scores are formed from it
  float* Xs = Ws + TILE * LDA;       // x of the s tile       [s][p]
  float* Ss = Xs + TILE * LDB;       // the head's S_in       [n][p]
  float* cum_t = Ss + TILE * LDB;    // cum of the t tile, by head parity
  float* cum_s = cum_t + 2 * TILE;   // cum and dt of the s tile
  float* dt_s = cum_s + TILE;
  float* ec = dt_s + TILE;           // exp(clip(cum, -30, 0)) of the t tile

  const int tid = threadIdx.x;
  const int nc = S / ch;
  const int b = blockIdx.x / nc, c = blockIdx.x % nc, c0 = c * ch;
  const int h0 = blockIdx.y * G, heads = min(G, H - h0);
  const int ti = blockIdx.z, t0 = ti * TILE, nt = min(TILE, ch - t0);
  const WarpTile w = warp_tile();
  const int kn = (N + 7) & ~7;
  const float* xb = x + b * x_sb;
  const float* dtb = dt + b * dt_sb;
  const float* cumb = cum + (long long)b * S * H;

  auto issue_state = [&](int j) {    // head j's S_in and cum of the t tile
    const int h = h0 + j;
    const float* Sh = S_in + (((long long)b * H + h) * nc + c) * N * P;
    stage(Ss, LDB, [&](int i, int q) { return Sh + i * P + q; }, N, P,
          vec & VEC_S);
    if (tid < TILE)
      cp_async4(cum_t + (j & 1) * TILE + tid,
                cumb + (long long)(c0 + t0 + min(tid, nt - 1)) * H + h,
                tid < nt);
    cp_async_commit();
  };
  auto issue_x = [&](int j, int sj) {  // head j's x, cum, dt of s tile sj
    const int h = h0 + j, s0 = sj * TILE, ns = min(TILE, ch - s0);
    stage(Xs, LDB, [&](int i, int q) {
      return xb + (c0 + s0 + i) * x_ss + h * x_sh + q; }, ns, P, vec & VEC_X);
    if (tid < TILE) {
      const int i = min(tid, ns - 1);
      cp_async4(cum_s + tid, cumb + (long long)(c0 + s0 + i) * H + h, tid < ns);
      cp_async4(dt_s + tid, dtb + (c0 + s0 + i) * dt_ss + h * dt_sh, tid < ns);
    }
    cp_async_commit();
  };

  stage(Cl, LDA, [&](int i, int q) {
    return Cm + b * C_sb + (c0 + t0 + i) * C_ss + q; }, nt, N, vec & VEC_C);
  const auto C_split = [&](int m, int k, uint32_t& hi, uint32_t& lo) {
    hi = Ch[m * LDA + k];
    lo = __float_as_uint(Cl[m * LDA + k]);
  };
  issue_state(0);                    // C joins head 0's group
  issue_x(0, 0);
  int staged = -1;                   // s tile whose scores sit in Sc
  for (int j = 0; j < heads; ++j) {
    const int h = h0 + j;
    const bool next = j + 1 < heads;
    const float* ct = cum_t + (j & 1) * TILE;
    float acc[2][2][4] = {};
    cp_async_wait<1>();              // S_in (its x tile may be in flight)
    __syncthreads();
    if (j == 0) {                    // C (in head 0's group), split once
      for (int e = tid; e < TILE * DMAX; e += THREADS) {
        const int i = (e / DMAX) * LDA + e % DMAX;
        uint32_t hi, lo;
        split(Cl[i], hi, lo);
        Ch[i] = hi;
        Cl[i] = __uint_as_float(lo);
      }
      __syncthreads();
    }
    if (tid < TILE) ec[tid] = expf(clip(ct[tid], -EXP_CLAMP, 0.f));
    // inter-chunk: (C S_in) exp(cum), where the intra-chunk sum starts
    product_3xtf32(
        acc, C_split,
        splitting([&](int k, int q) { return Ss[k * LDB + q]; }), w, kn, kn);
    __syncthreads();                 // Ss is free, ec is written
    if (next) issue_state(j + 1);
    for_each(w, [&](int r, int, int si, int jj, int i) {
      acc[si][jj][i] = __fmul_rn(acc[si][jj][i], ec[r]);
    });

    for (int sj = 0; sj <= ti; ++sj) {
      const int s0 = sj * TILE, ns = min(TILE, ch - s0);
      if (staged != sj) {            // the scores, once for all the heads
        stage(Bs, LDA, [&](int i, int q) {
          return Bm + b * B_sb + (c0 + s0 + i) * B_ss + q; }, ns, N,
              vec & VEC_B);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        float sc[2][2][4] = {};
        product_3xtf32(
            sc, C_split,
            splitting([&](int k, int q) { return Bs[q * LDA + k]; }), w, kn,
            kn);
        for_each(w, [&](int r, int q, int si, int jj, int i) {
          Sc[r * LDA + q] = sc[si][jj][i];
        });
        staged = sj;
      }
      if (sj == 0 && next)           // the next head's S_in may stay in flight
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();
      // W = scores * decay under the inclusive mask (s <= t), on the columns
      // the product reads: on the diagonal tile a strip's rows need no s
      // past its last row.  A thread takes columns q8, q8 + 8, ... of row r1
      // and of row 63 - r1, the same count for every thread.
      const int k_all = (ns + 7) & ~7;
      const bool diag = sj == ti;
      {
        const int lane = tid & 31, q8 = lane & 7;
        const int r1 = 4 * (tid >> 5) + (lane >> 3);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = half ? TILE - 1 - r1 : r1;
          const int q_end = diag ? min(k_all, 16 * (r / 16 + 1)) : k_all;
          const float cr = ct[r];
          for (int q = q8; q < q_end; q += 8) {
            float v = 0.f;
            if (r < nt && q < ns && s0 + q <= t0 + r)
              v = __fmul_rn(Sc[r * LDA + q],
                            expf(clip(cr - cum_s[q], -EXP_CLAMP, EXP_CLAMP)));
            Ws[r * LDA + q] = v;
          }
        }
      }
      __syncthreads();
      product_3xtf32(
          acc, splitting([&](int m, int k) { return Ws[m * LDA + k]; }),
          splitting([&](int k, int q) {
            return __fmul_rn(Xs[k * LDB + q], dt_s[k]); }),
          w, diag ? min(k_all, w.m[0] + 16) : k_all,
          diag ? min(k_all, w.m[1] + 16) : k_all);
      if (sj == ti) {
        // y = ((C S_in) exp(cum) + W xdt) + D x; Xs holds x of the t tile
        const float Dh = Dv[h];
        for_each(w, [&](int r, int q, int si, int jj, int i) {
          acc[si][jj][i] =
              __fadd_rn(acc[si][jj][i], __fmul_rn(Dh, Xs[r * LDB + q]));
        });
        float* yb = y + ((long long)b * S + c0 + t0) * H * P + (long long)h * P;
        store_tile(acc, w, nt, P, [&](int r, int q) {
          return yb + (long long)r * H * P + q; });
      }
      __syncthreads();               // Xs, cum_s, dt_s, Ws and Bs are free
      if (sj < ti)
        issue_x(j, sj + 1);
      else if (next)
        issue_x(j + 1, 0);
    }
  }
}

}  // namespace

// x: (B, S, H, P) with P contiguous; dt: (B, S, H); Bm, Cm: (B, S, N) with N
// contiguous; strides in elements.  A_log, D: (H,); s0 and s_out: (B, H, N,
// P); y: (B, S, H, P); states: (B, H, S / chunk, N, P) and cum: (B, S, H)
// scratch; all float32, the last six contiguous; s_out may be s0.  chunk
// divides S; heads_per_block in [1, MAX_HEADS].  Returns cudaGetLastError()
// after the launches (0 = launched).
extern "C" int ssd_chunk_launch(
    const void* x, const void* dt, const void* A_log, const void* Bm,
    const void* Cm, const void* D, const void* s0, void* y, void* s_out,
    void* states, void* cum, long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh, long long B_sb,
    long long B_ss, long long C_sb, long long C_ss, int B, int S, int H, int P,
    int N, int chunk, int heads_per_block, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P > DMAX || N <= 0 ||
      N > DMAX || chunk <= 0 || S % chunk != 0 || heads_per_block < 1 ||
      heads_per_block > MAX_HEADS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = heads_per_block;
  const long long nc = S / chunk;
  const long long groups = (H + G - 1) / G;
  const long long t_tiles = (chunk + TILE - 1) / TILE;
  const long long slices = ((long long)N * P + CARRY_ELEMS - 1) / CARRY_ELEMS;
  if ((long long)B * nc > 2147483647LL || (long long)B * H > 2147483647LL ||
      groups > 65535 || t_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      STATE_SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_chunk_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SCAN_SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte copies where every row of a tensor starts 16-byte aligned
  auto rows16 = [](const void* ptr, long long s0_, long long s1, long long s2,
                   int cols) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && s0_ % 4 == 0 &&
           s1 % 4 == 0 && s2 % 4 == 0 && cols % 4 == 0;
  };
  const int vec = (rows16(x, x_sb, x_ss, x_sh, P) ? VEC_X : 0) |
                  (rows16(Bm, B_sb, B_ss, 0, N) ? VEC_B : 0) |
                  (rows16(Cm, C_sb, C_ss, 0, N) ? VEC_C : 0) |
                  (rows16(states, 0, 0, 0, P) ? VEC_S : 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* Bf = static_cast<const float*>(Bm);
  float* cumf = static_cast<float*>(cum);
  float* sf = static_cast<float*>(states);
  ssd_chunk_state_kernel<<<dim3(unsigned(B * nc), unsigned(groups)),
                           THREADS, STATE_SMEM_BYTES, st>>>(
      xf, dtf, static_cast<const float*>(A_log), Bf, cumf, sf, x_sb, x_ss,
      x_sh, dt_sb, dt_ss, dt_sh, B_sb, B_ss, H, S, P, N, chunk, G, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const dim3 carry_grid(unsigned(B * H), unsigned(slices));
  if ((N * P) % 4 == 0 && reinterpret_cast<uintptr_t>(s0) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(s_out) % 16 == 0)
    ssd_chunk_carry_kernel<true><<<carry_grid, THREADS, 0, st>>>(
        cumf, static_cast<const float*>(s0), sf, static_cast<float*>(s_out), H,
        S, N * P, chunk);
  else
    ssd_chunk_carry_kernel<false><<<carry_grid, THREADS, 0, st>>>(
        cumf, static_cast<const float*>(s0), sf, static_cast<float*>(s_out), H,
        S, N * P, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_scan_kernel<<<dim3(unsigned(B * nc), unsigned(groups),
                               unsigned(t_tiles)),
                          THREADS, SCAN_SMEM_BYTES, st>>>(
      xf, dtf, Bf, static_cast<const float*>(Cm),
      static_cast<const float*>(D), cumf, sf, static_cast<float*>(y), x_sb,
      x_ss, x_sh, dt_sb, dt_ss, dt_sh, B_sb, B_ss, C_sb, C_ss, H, S, P, N,
      chunk, G, vec);
  return static_cast<int>(cudaGetLastError());
}
