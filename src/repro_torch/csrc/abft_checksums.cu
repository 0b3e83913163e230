// The ABFT guard's two kernels for NVIDIA Hopper (sm_90a): abft_checksums,
// the float64 checksums of one GEMM's operands in one read of its weight,
// and abft_verdict, the verification of the product against them.
//
// Not TPU kernels: the reference computes both in numpy
// (src/repro/resilience/guard.py, GuardedBackend._abft_verify and
// _freivalds_verify: a64 @ b64.sum(1), a64.sum(0) @ b64, their |.| forms,
// b64 @ x, out64.sum(1), out64.sum(0) and the comparisons).  Done with
// PyTorch ops on the card each would first build a float64 copy of the
// weight, and the guard's checks and verdict cost ~40 launches a GEMM; here
// a guarded GEMM costs two launches and one read of the verdict.
//
// abft_checksums sees the weight as X (R, C), X[r, c] = x[r * ld + c * sc],
// sc the smaller stride (a row-major b is X = b; a transposed view b = W^T
// is X = W), and computes, in float64,
//
//   Yr[r, j] = sum_c f_j(X[r, c]) * P[c, j]     (j < np)   "along C"
//   Yc[i, c] = sum_r Q[i, r] * g_i(X[r, c])     (i < nq)   "along R"
//
// f_j / g_i the identity, or |.| where bit j of pabs / bit i of qabs is set.
// In the general form P (C, np) and Q (nq, R) are float64 row-major, np, nq
// <= 4.  The abft mode (the guard's call) has two vectors a side, the second
// taking |.|: on one side a's column sums and |a|'s (on Q when X = b: mode
// ABFT_Q; on P when X = b^T: ABFT_P), formed by the blocks that read those
// rows or columns; on the other ones, whose sums (b 1 and |b| 1, the b-side)
// each block multiplies by a over its own rows or columns.  Its output is the
// guard's (2, M + N) pack: the a-side sums (y + 1) * tol in the second
// vector, and a times the b-side.
//
// One launch, grid (column blocks, row blocks).  A block is 8 warps on one
// strip of 32 lanes x 16 bytes (8 bf16, 4 f32, 2 f64 a lane a row); warp w
// walks rows w, w + 8, ... of the block's rows.
//   * Loads: 16 bytes a lane, kept in flight by cp.async into a ring of
//     STAGES slots a thread (scalar loads where the operand is not aligned
//     for them).  A load past R or C comes from a clamped address and is
//     zeroed after.
//   * Along C: a lane adds its products over its columns as a tree; every
//     U rows the warp stores them in shared memory and all 32 lanes add
//     them in a fixed order (trees of 8 lanes, then of the 4 sums).  No
//     shuffles.
//   * Along R: a thread's products go down its rows in registers and are
//     added over the warps in order once a block.
//   * Widening to float64: bf16 -> float (a shift) -> double (the
//     conversion, exact).  The conversion unit does not bind: building the
//     double from the bits with integer operations measured slower.
//   * Across blocks: partial sums in global memory and integer tickets
//     (atomicInc, which wraps back to 0 for the next call): the last block of
//     a row group adds its rows' partials in column-block order, the last of
//     a column group its columns' in row-block order, and (abft mode) the
//     call's last block the blocks' products with a in block order.  No float
//     atomics, so a repeated call gives the same bits; the order is fixed by
//     (R, C, dtype) (kernels/abft.py::launch_plan).
//
// abft_verdict reads the product (M, N) once: a block of 512 threads sums
// 4096 columns down all M rows (a batch of rows' loads in flight at once)
// and its rows' partial sums; one block judges alone, the blocks of a
// cluster (up to 8) meet in block 0's shared memory, more blocks in global
// memory through an integer ticket.  Its seven numbers land in device
// memory; the host reads them with one copy.  (Written straight to pinned
// host memory they need no copy, but hold each launch about 1 us longer.)
//
// What bounds them on this card: bytes (the weight, read once; at
// phi4-mini's logits weight 1.23 GB).  The float64 products (4 an element
// in the abft mode) run on the CUDA cores at 34 TFLOP/s, under the byte
// rate, and taking them out of the row loop moves it by under 10 %: the loop
// streams at about 10 GB/s a block (two blocks an SM), and a call adds
// about 10 us of its own (the ring's first fill, the sums across warps and
// blocks, the tickets).  abft_verdict's bytes are small: it is bound by its
// launch and its dependent round trips.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int STAGES = 6;                    // cp.async slots a thread
constexpr int CHUNK = 32;                    // rows between block syncs
constexpr int QROWS = 1024;                  // most rows a block
constexpr int MAXV = 4;                      // np, nq at most
constexpr int PAD = 33;                      // a 32-double row, padded
constexpr int SLOTS = 8;                     // a warp's staged row sums
constexpr int MA = 4;                        // rows of a kept in smem

// dtype codes as the wrapper passes them
constexpr int DT_F32 = 0, DT_BF16 = 1, DT_F64 = 2;
// where the abft mode's a-side vectors are
constexpr int SIDE_NONE = 0, SIDE_Q = 1, SIDE_P = 2;
// kernel variants: the general form, and the abft mode by a's side
constexpr int GENERIC = 0, ABFT_Q = 1, ABFT_P = 2;

template <int DT> struct Elem;
template <> struct Elem<DT_F32> { using T = float; static constexpr int VEC = 4; };
template <> struct Elem<DT_BF16> { using T = unsigned short; static constexpr int VEC = 8; };
template <> struct Elem<DT_F64> { using T = double; static constexpr int VEC = 2; };

struct Params {
  const void* x;
  int R, C;
  long long ld, sc;
  const double* P;
  int np;
  unsigned pabs;
  const double* Q;
  int nq;
  unsigned qabs;
  const void* a;
  int M;
  long long a_ld, a_sc;
  int a_dtype;
  double tol;
  double* out_r;
  long long or_r, or_j;
  unsigned aff_r;
  double* out_c;
  long long oc_i, oc_c;
  unsigned aff_c;
  double* out_m;
  long long om_j, om_m;
  int rows, n_cb, n_rb;
  double* part_r;
  double* part_c;
  double* part_m;
  unsigned* tickets;
};

// Shared memory of a variant: the ring, the warps' staged row sums, Q (the
// block's rows for ABFT_Q, a chunk's for GENERIC), and in the abft mode the
// block's b-side sums and a's elements on a's side (M <= MA).
template <int MODE>
struct Smem {
  static constexpr int NP = MODE == GENERIC ? MAXV : 2;
  static constexpr int NQ = MODE == GENERIC ? MAXV : 2;
  static constexpr int RING = STAGES * THREADS * 16;
  static constexpr int STAGE = WARPS * SLOTS * PAD * 8;
  static constexpr int QS = MODE == ABFT_Q ? QROWS * NQ * 8
                            : MODE == GENERIC ? CHUNK * NQ * 8 : 0;
  static constexpr int SAVE = MODE == GENERIC ? 0 : QROWS * 2 * 8;
  static constexpr int ACACHE = MODE == GENERIC ? 0 : MA * QROWS * 8;
  static constexpr int BYTES = RING + STAGE + QS + SAVE + ACACHE;
};

// A bf16 (bits in the low half) as a double: exact, by way of its float.
__device__ __forceinline__ double bf16_to_double(uint32_t h) {
  return static_cast<double>(__uint_as_float(h << 16));
}

// A release or acquire at the scope of the whole card, for the tickets.
__device__ __forceinline__ void fence_gpu() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

// The VEC elements of a 16-byte word, widened.
template <int DT>
__device__ __forceinline__ void widen16(const uint4& w, double* out) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
  if constexpr (DT == DT_BF16) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = bf16_to_double(u[i] & 0xffffu);
      out[2 * i + 1] = bf16_to_double(u[i] >> 16);
    }
  } else if constexpr (DT == DT_F32) {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = __uint_as_float(u[i]);
  } else {
    out[0] = __hiloint2double(static_cast<int>(u[1]), static_cast<int>(u[0]));
    out[1] = __hiloint2double(static_cast<int>(u[3]), static_cast<int>(u[2]));
  }
}

// One element, widened (the scalar path).
template <int DT>
__device__ __forceinline__ double widen1(typename Elem<DT>::T v) {
  if constexpr (DT == DT_BF16) {
    return bf16_to_double(static_cast<uint32_t>(v));
  } else {
    return v;
  }
}

// An element of a as a double.
__device__ __forceinline__ double as_double(unsigned short h) {
  return bf16_to_double(h);
}
__device__ __forceinline__ double as_double(float f) { return f; }
__device__ __forceinline__ double as_double(double d) { return d; }

// Column sums of a, sum_m a[m, k] and sum_m |a[m, k]| in m order, for N
// columns k at element offsets off[] (past the row: 0): two rows' loads in
// flight at once.  Rows m < MA of the elements also go to cache[m * QROWS +
// pos[i]] (when cache is given).
template <typename TA, int N>
__device__ __forceinline__ void a_colsums(const TA* __restrict__ a, int M,
                                          long long a_ld,
                                          const long long* off,
                                          const bool* ok, double* s,
                                          double* sa, double* cache,
                                          const int* pos) {
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = sa[i] = 0.0;
  int m = 0;
  for (; m + 2 <= M; m += 2) {
    double y[2][N];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < N; ++i)
        y[h][i] = ok[i] ? as_double(a[(m + h) * a_ld + off[i]]) : 0.0;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < N; ++i) {
        s[i] += y[h][i];
        sa[i] += fabs(y[h][i]);
        if (cache && m + h < MA) cache[(m + h) * QROWS + pos[i]] = y[h][i];
      }
  }
  if (m < M) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const double y = ok[i] ? as_double(a[m * a_ld + off[i]]) : 0.0;
      s[i] += y;
      sa[i] += fabs(y);
      if (cache && m < MA) cache[m * QROWS + pos[i]] = y;
    }
  }
}

// The same, a's type chosen at run time (once, outside the loops).
template <int N>
__device__ __forceinline__ void a_colsums_any(const void* a, int dt, int M,
                                              long long a_ld,
                                              const long long* off,
                                              const bool* ok, double* s,
                                              double* sa, double* cache,
                                              const int* pos) {
  if (dt == DT_BF16)
    a_colsums<unsigned short, N>(static_cast<const unsigned short*>(a), M,
                                 a_ld, off, ok, s, sa, cache, pos);
  else if (dt == DT_F32)
    a_colsums<float, N>(static_cast<const float*>(a), M, a_ld, off, ok, s,
                        sa, cache, pos);
  else
    a_colsums<double, N>(static_cast<const double*>(a), M, a_ld, off, ok, s,
                         sa, cache, pos);
}

// A lane's share of a row of a times the b-side sums kept in `save`:
// sum over t = lane, lane + 32, ... < n of (a[k0 + t] save[2t], |a[k0 + t]|
// save[2t + 1]), t in order.
template <typename TA>
__device__ __forceinline__ void a_dot(const TA* __restrict__ arow,
                                      long long a_sc, int k0, int n, int lane,
                                      const double* save, double& s0,
                                      double& s1) {
  s0 = s1 = 0.0;
#pragma unroll 4
  for (int t = lane; t < n; t += 32) {
    const double y = as_double(arow[(k0 + t) * a_sc]);
    s0 = fma(y, save[2 * t], s0);
    s1 = fma(fabs(y), save[2 * t + 1], s1);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ double affine(double y, unsigned aff, int j,
                                         double tol) {
  return ((aff >> j) & 1u) ? (y + 1.0) * tol : y;
}

// Yr[r, j]: into the output when one block spans C, else a partial.
__device__ __forceinline__ void put_row(const Params& p, int cb, int r, int j,
                                        double s) {
  if (p.n_cb == 1)
    p.out_r[r * p.or_r + j * p.or_j] = affine(s, p.aff_r, j, p.tol);
  else
    p.part_r[(static_cast<long long>(cb) * p.np + j) * p.R + r] = s;
}

// Yc[i, c]: the same along R.
__device__ __forceinline__ void put_col(const Params& p, int rb, int c, int i,
                                        double s) {
  if (p.n_rb == 1)
    p.out_c[i * p.oc_i + c * p.oc_c] = affine(s, p.aff_c, i, p.tol);
  else
    p.part_c[(static_cast<long long>(rb) * p.nq + i) * p.C + c] = s;
}

// Eight doubles added as a tree: ((v0 + v1) + (v2 + v3)) + ((v4 + v5) +
// (v6 + v7)).
__device__ __forceinline__ double tree8(const double* v) {
  return ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]));
}

// A warp's eight slots of 32 doubles (`st`, [SLOTS][PAD]), each added in a
// fixed order: lane 4 o + q adds lanes 8 q .. 8 q + 7 of slot o as a tree,
// then lane 4 o the four as (g0 + g1) + (g2 + g3).  Returns slot lane / 4's
// sum in lanes 4 o.
__device__ __forceinline__ double slot_sum(double* st, int lane) {
  const int o = lane >> 2, q = lane & 3;
  double v[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) v[l] = st[o * PAD + 8 * q + l];
  const double s = tree8(v);
  __syncwarp();
  st[o * PAD + q] = s;
  __syncwarp();
  double t = 0.0;
  if (q == 0)
    t = (st[o * PAD] + st[o * PAD + 1]) + (st[o * PAD + 2] + st[o * PAD + 3]);
  __syncwarp();
  return t;
}

// A lane's products over its VEC columns, added as a tree: pairs first
// (x_1 P_1 + x_0 P_0, one fma), then the pairs in halves.
template <int VEC>
__device__ __forceinline__ double lane_sum(const double* x, const double* pv,
                                           bool ones) {
  double q[VEC / 2];
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i)
    q[i] = ones ? x[2 * i] + x[2 * i + 1]
                : fma(x[2 * i + 1], pv[2 * i + 1], x[2 * i] * pv[2 * i]);
  if constexpr (VEC == 8) return (q[0] + q[1]) + (q[2] + q[3]);
  else if constexpr (VEC == 4) return q[0] + q[1];
  else return q[0];
}

// One launch.  A block is 8 warps on one strip of 32 lanes x VEC columns;
// warp w walks rows w, w + 8, ... of the block's `rows`.
template <int DT, int MODE, bool VL>
__global__ void __launch_bounds__(THREADS, MODE == GENERIC ? 1 : 2)
abft_checksums_kernel(const Params p) {
  using T = typename Elem<DT>::T;
  using S = Smem<MODE>;
  constexpr int VEC = Elem<DT>::VEC;
  constexpr int NP = S::NP, NQ = S::NQ;
  constexpr int U = SLOTS / NP;              // rows a warp stages at once
  constexpr bool ABFT = MODE != GENERIC;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* ring = reinterpret_cast<uint4*>(smem);
  double* stage = reinterpret_cast<double*>(smem + S::RING);
  double* qs = reinterpret_cast<double*>(smem + S::RING + S::STAGE);
  double* save = reinterpret_cast<double*>(smem + S::RING + S::STAGE + S::QS);
  double* acache = reinterpret_cast<double*>(smem + S::RING + S::STAGE +
                                             S::QS + S::SAVE);
  __shared__ int flag[3];

  const T* __restrict__ x = static_cast<const T*>(p.x);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cb = blockIdx.x, rb = blockIdx.y;
  const int width = 32 * VEC;
  const int c_blk = cb * width;
  const int c_lane = c_blk + lane * VEC;
  const int r0 = rb * p.rows;
  const int R = p.R, C = p.C;
  const int rows_in = min(p.rows, R - r0), cols_in = min(width, C - c_blk);

  auto pab = [&](int j) -> bool {
    return ABFT ? j == 1 : ((p.pabs >> j) & 1u) != 0u;
  };
  auto qab = [&](int i) -> bool {
    return ABFT ? i == 1 : ((p.qabs >> i) & 1u) != 0u;
  };

  // the lane's columns: in range?, clamped offsets
  bool c_ok[VEC];
  long long c_off[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    c_ok[v] = c_lane + v < C;
    c_off[v] = static_cast<long long>(c_ok[v] ? c_lane + v : C - 1) * p.sc;
  }
  // the 16-byte word of a row: the lane's columns (a lane past C reads the
  // last word of the row, zeroed after; C is a multiple of VEC there, so a
  // lane's columns are all in range or all past it)
  const long long c_vec = c_lane < C ? c_lane : C - VEC;
  const int nk = p.rows / WARPS;             // rows of this warp
  constexpr int kch = CHUNK / WARPS;         // of them in a chunk
  auto row_of = [&](int k) { return r0 + warp + WARPS * k; };
  auto src = [&](int k) {
    const int r = row_of(k);
    return x + static_cast<long long>(r < R ? r : R - 1) * p.ld + c_vec;
  };
  uint4* my_ring = ring + tid;
  if constexpr (VL) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      if (s < nk) cp_async16(my_ring + s * THREADS, src(s));
      cp_async_commit();
    }
  }

  // P: ones (ABFT_Q), a's column sums (ABFT_P) or the caller's
  double pr[VEC][NP];
  if constexpr (MODE == ABFT_P) {
    long long off[VEC];
    int pos[VEC];
    double s[VEC], sa[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      off[v] = (c_ok[v] ? c_lane + v : 0) * p.a_sc;
      pos[v] = lane * VEC + v;
    }
    // (every warp holds the same columns: warp 0 keeps a's elements)
    a_colsums_any<VEC>(p.a, p.a_dtype, p.M, p.a_ld, off, c_ok, s, sa,
                       warp == 0 ? acache : nullptr, pos);
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      pr[v][0] = s[v];
      pr[v][1] = sa[v];
    }
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const long long cc = c_ok[v] ? c_lane + v : C - 1;
#pragma unroll
      for (int j = 0; j < NP; ++j)
        pr[v][j] = MODE == ABFT_Q ? 1.0
                   : (c_ok[v] && j < p.np) ? __ldg(p.P + cc * p.np + j)
                                           : 0.0;
    }
  }
  // Q of the block's rows (ABFT_Q): a's column sums and |a|'s, once (a
  // thread's QROWS / THREADS rows at a time)
  if constexpr (MODE == ABFT_Q) {
    constexpr int NT = QROWS / THREADS;
    long long off[NT];
    int pos[NT];
    bool ok[NT];
    double s[NT], sa[NT];
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int t = tid + THREADS * i;
      ok[i] = t < rows_in;
      off[i] = (ok[i] ? r0 + t : 0) * p.a_sc;
      pos[i] = t;
    }
    a_colsums_any<NT>(p.a, p.a_dtype, p.M, p.a_ld, off, ok, s, sa, acache,
                      pos);
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int t = tid + THREADS * i;
      if (t < p.rows) {
        qs[2 * t] = s[i];
        qs[2 * t + 1] = sa[i];
      }
    }
    __syncthreads();
  }

  double cp[VEC][NQ];
#pragma unroll
  for (int v = 0; v < VEC; ++v)
#pragma unroll
    for (int i = 0; i < NQ; ++i) cp[v][i] = 0.0;

  double* my_stage = stage + warp * SLOTS * PAD;
  for (int k = 0; k < nk; ++k) {
    if (MODE == GENERIC && k % kch == 0) {
      // this chunk's Q, from the caller's
      __syncthreads();
      const int rc = r0 + k * WARPS;
      for (int t = tid; t < CHUNK; t += THREADS) {
#pragma unroll
        for (int i = 0; i < NQ; ++i)
          qs[t * NQ + i] = (i < p.nq && rc + t < R)
                               ? __ldg(p.Q + static_cast<long long>(i) * R +
                                       rc + t)
                               : 0.0;
      }
      __syncthreads();
    }
    const int r = row_of(k);
    const bool r_ok = r < R;
    double xv[VEC];                          // zero past R or C
    if constexpr (VL) {
      cp_async_wait<STAGES - 1>();
      uint4 w = my_ring[(k % STAGES) * THREADS];
      if (!(r_ok && c_ok[0])) w = make_uint4(0u, 0u, 0u, 0u);
      widen16<DT>(w, xv);
    } else {
      const long long r_off = static_cast<long long>(r_ok ? r : R - 1) * p.ld;
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        xv[v] = (r_ok && c_ok[v]) ? widen1<DT>(x[r_off + c_off[v]]) : 0.0;
    }
    double qv[NQ];
    if constexpr (MODE == ABFT_Q) {
      qv[0] = qs[2 * (r - r0)];
      qv[1] = qs[2 * (r - r0) + 1];
    } else if constexpr (MODE == GENERIC) {
#pragma unroll
      for (int i = 0; i < NQ; ++i) qv[i] = qs[(warp + WARPS * (k % kch)) * NQ + i];
    }
    // along C: the lane's products, a tree over its columns
    double xa[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) xa[v] = fabs(xv[v]);
    double rp[NP];
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      double pv[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) pv[v] = pr[v][j];
      rp[j] = lane_sum<VEC>(pab(j) ? xa : xv, pv, MODE == ABFT_Q);
    }
    // along R: down the thread's rows
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const double xi = qab(i) ? xa[v] : xv[v];
        if constexpr (MODE == ABFT_P)
          cp[v][i] += xi;
        else
          cp[v][i] = fma(qv[i], xi, cp[v][i]);
      }
    }
    if constexpr (VL) {
      // the slot just read takes row k + STAGES (after its words were used)
      if (k + STAGES < nk) cp_async16(my_ring + (k % STAGES) * THREADS,
                                      src(k + STAGES));
      cp_async_commit();
    }
    // the row's lane sums, added in a fixed order every U rows: ABFT_Q
    // keeps them (the b-side) in `save`, the others write Yr
    const int u = k % U;
#pragma unroll
    for (int j = 0; j < NP; ++j) my_stage[(u * NP + j) * PAD + lane] = rp[j];
    if (u == U - 1) {
      __syncwarp();
      const double s = slot_sum(my_stage, lane);
      if ((lane & 3) == 0) {
        const int o = lane >> 2, uu = o / NP, j = o % NP;
        const int lr = row_of(k - (U - 1) + uu) - r0;
        if (lr < rows_in && j < p.np) {
          if constexpr (MODE == ABFT_Q)
            save[2 * lr + j] = s;
          else
            put_row(p, cb, r0 + lr, j, s);
        }
      }
    }
  }
  if constexpr (VL) cp_async_wait<0>();      // (no copies are left)
  __syncthreads();                           // every warp is off the ring

  // along R: the warps' sums, added in order (the ring and the stage are
  // free now; the abft mode's two vectors in one round); ABFT_P keeps them
  // (the b-side) in `save`
  double* colbuf = reinterpret_cast<double*>(ring);
  constexpr int ROUND = ABFT ? 2 : 1;
  for (int i0 = 0; i0 < p.nq; i0 += ROUND) {
#pragma unroll
    for (int ii = 0; ii < NQ; ++ii) {
      if (ii >= i0 && ii < i0 + ROUND) {
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          colbuf[((ii - i0) * WARPS + warp) * width + lane * VEC + v] =
              cp[v][ii];
      }
    }
    __syncthreads();
    for (int t = tid; t < ROUND * cols_in; t += THREADS) {
      const int i = i0 + t / cols_in, c = t % cols_in;
      if (i < p.nq) {
        double s = 0.0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w)
          s += colbuf[((i - i0) * WARPS + w) * width + c];
        if constexpr (MODE == ABFT_P)
          save[2 * c + i] = s;
        else
          put_col(p, rb, c_blk + c, i, s);
      }
    }
    __syncthreads();
  }

  // abft mode: the block's b-side sums times a, over its rows (ABFT_Q) or
  // columns (ABFT_P): a warp an m, a lane every 32nd k, lanes in a fixed
  // order
  const int blk = rb * p.n_cb + cb;
  if constexpr (ABFT) {
    const int n_k = MODE == ABFT_Q ? rows_in : cols_in;
    const int k0 = MODE == ABFT_Q ? r0 : c_blk;
    double* st = stage + warp * SLOTS * PAD;
    for (int m = warp; m < p.M; m += WARPS) {
      double s0 = 0.0, s1 = 0.0;
      if (p.M <= MA) {
        // a's elements kept by the prologue
        for (int t = lane; t < n_k; t += 32) {
          const double y = acache[m * QROWS + t];
          s0 = fma(y, save[2 * t], s0);
          s1 = fma(fabs(y), save[2 * t + 1], s1);
        }
      } else if (p.a_dtype == DT_BF16)
        a_dot(static_cast<const unsigned short*>(p.a) + m * p.a_ld, p.a_sc,
              k0, n_k, lane, save, s0, s1);
      else if (p.a_dtype == DT_F32)
        a_dot(static_cast<const float*>(p.a) + m * p.a_ld, p.a_sc, k0, n_k,
              lane, save, s0, s1);
      else
        a_dot(static_cast<const double*>(p.a) + m * p.a_ld, p.a_sc, k0, n_k,
              lane, save, s0, s1);
      st[lane] = s0;
      st[PAD + lane] = s1;
      for (int o = 2; o < SLOTS; ++o) st[o * PAD + lane] = 0.0;
      __syncwarp();
      const double s = slot_sum(st, lane);
      if (lane < 8 && (lane & 3) == 0)
        p.part_m[(static_cast<long long>(blk) * p.M + m) * 2 + (lane >> 2)] = s;
      __syncwarp();
    }
  }

  // tickets: the last block of a row group, of a column group, of the call
  // (thread 0's fences order the block's writes before its tickets, and the
  // others' before what a last block reads)
  __syncthreads();
  if (tid == 0) {
    fence_gpu();
    flag[0] = MODE != ABFT_Q && p.n_cb > 1 && p.np > 0 &&
              atomicInc(p.tickets + rb, p.n_cb - 1) == unsigned(p.n_cb - 1);
    flag[1] = MODE != ABFT_P && p.n_rb > 1 && p.nq > 0 &&
              atomicInc(p.tickets + p.n_rb + cb, p.n_rb - 1) ==
                  unsigned(p.n_rb - 1);
    const unsigned n_blocks = unsigned(p.n_cb) * unsigned(p.n_rb);
    flag[2] = ABFT && atomicInc(p.tickets + p.n_rb + p.n_cb, n_blocks - 1) ==
                          n_blocks - 1;
    if (flag[0] || flag[1] || flag[2]) fence_gpu();
  }
  __syncthreads();
  if (!(flag[0] || flag[1] || flag[2])) return;
  if (flag[0]) {
    for (int t = tid; t < rows_in * p.np; t += THREADS) {
      const int j = t / rows_in, r = r0 + t % rows_in;
      double s = 0.0;
      for (int b = 0; b < p.n_cb; ++b)
        s += __ldcg(p.part_r + (static_cast<long long>(b) * p.np + j) * R + r);
      p.out_r[r * p.or_r + j * p.or_j] = affine(s, p.aff_r, j, p.tol);
    }
  }
  if (flag[1]) {
    for (int t = tid; t < cols_in * p.nq; t += THREADS) {
      const int i = t / cols_in, c = c_blk + t % cols_in;
      double s = 0.0;
      for (int b = 0; b < p.n_rb; ++b)
        s += __ldcg(p.part_c + (static_cast<long long>(b) * p.nq + i) * C + c);
      p.out_c[i * p.oc_i + c * p.oc_c] = affine(s, p.aff_c, i, p.tol);
    }
  }
  if (ABFT && flag[2]) {
    // the blocks' products, a lane every 32nd block, lanes in a fixed order
    const int n_blocks = p.n_cb * p.n_rb;
    double* st = stage + warp * SLOTS * PAD;
    for (int o = warp; o < 2 * p.M; o += WARPS) {
      const int m = o >> 1, j = o & 1;
      double s = 0.0;
      for (int g = lane; g < n_blocks; g += 32)
        s += __ldcg(p.part_m + (static_cast<long long>(g) * p.M + m) * 2 + j);
      st[lane] = s;
      for (int q = 1; q < SLOTS; ++q) st[q * PAD + lane] = 0.0;
      __syncwarp();
      const double t = slot_sum(st, lane);
      if (lane == 0) p.out_m[j * p.om_j + m * p.om_m] = j ? (t + 1.0) * p.tol : t;
      __syncwarp();
    }
  }
}

// ---- abft_verdict ----------------------------------------------------------

constexpr int V_THREADS = 512;               // threads a block
constexpr int V_WARPS = V_THREADS / 32;
constexpr int V_COLS = 8;                    // columns a thread
constexpr int V_BLOCK = V_THREADS * V_COLS;  // columns a block
constexpr int V_ROWS = 4;                    // rows loaded at once
constexpr int V_PART = 5;                    // a block's tally, column 0
constexpr int V_CLUSTER = 8;                 // most blocks of a cluster
constexpr int V_CROWS = 32;                  // most rows a cluster judges

// largest of two ratios, nan kept (torch.max propagates nan)
__device__ __forceinline__ double nanmax(double a, double b) {
  return (a != a || b > a || b != b) ? (a != a ? a : b) : a;
}

// A verdict over some rows or columns: the bad ones, the first of them and
// its residual, the largest ratio.  Combined in any order: a sum of
// integers, a minimum and a maximum are exact.
struct Tally {
  int n, first;
  double err, worst;
};

__device__ __forceinline__ Tally merge(Tally a, const Tally& b) {
  a.n += b.n;
  if (b.first < a.first) {
    a.first = b.first;
    a.err = b.err;
  }
  a.worst = nanmax(a.worst, b.worst);
  return a;
}

// A warp's 32 tallies as one, in every lane (the warp converged): integer
// reductions for the count and the first index, the first's residual from
// its lowest lane, and the largest ratio as the largest of its bits (ratios
// are >= 0: tol is positive; a tally's -1, none yet, counts as 0).
__device__ __forceinline__ Tally warp_tally(const Tally& t) {
  constexpr unsigned FULL = 0xffffffffu;
  const int first = __reduce_min_sync(FULL, t.first);
  const unsigned owner = __ballot_sync(FULL, t.first == first);
  const double err = __shfl_sync(FULL, t.err, __ffs(owner) - 1);
  const bool nan = __any_sync(FULL, t.worst != t.worst);
  const unsigned long long key =
      t.worst > 0.0
          ? static_cast<unsigned long long>(__double_as_longlong(t.worst))
          : 0ull;
  const unsigned hi = __reduce_max_sync(FULL, static_cast<unsigned>(key >> 32));
  const unsigned lo = __reduce_max_sync(
      FULL, static_cast<unsigned>(key >> 32) == hi ? static_cast<unsigned>(key)
                                                   : 0u);
  const double worst =
      nan ? __longlong_as_double(0x7ff8000000000000LL)
          : __longlong_as_double(static_cast<long long>(
                (static_cast<unsigned long long>(hi) << 32) | lo));
  return Tally{__reduce_add_sync(FULL, t.n), first, err, worst};
}

// One row or column: its residual against the reference, over its
// tolerance, into the tally.
__device__ __forceinline__ Tally judge(Tally t, int i, double sum,
                                      double ref, double tol, double& err) {
  err = sum - ref;
  const double ratio = fabs(err) / tol;
  if (ratio > 1.0 && i < t.first) {
    t.first = i;
    t.err = err;
  }
  t.n += ratio > 1.0;
  t.worst = nanmax(t.worst, ratio);
  return t;
}

// The cluster's barrier (every thread of every block) and a double of
// another block's shared memory.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ double cluster_load(const double* p, int rank) {
  uint32_t remote;
  double v;
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.f64 %0, [%1];\n" : "=d"(v) : "r"(remote));
  return v;
}

// One launch: a block sums V_BLOCK columns down all M rows (V_ROWS rows'
// loads in flight at once), thread t columns t, t + V_THREADS, ...; a row's
// sum over the block's columns is a thread's in column order, a fixed
// shuffle tree over the warp's lanes, then the warps in order.  A thread
// tallies its columns; each warp's tallies become one by warp reductions,
// then the warps' (warp_tally, twice).  One block judges its rows as it
// goes.  Blocks of a cluster (`clustered`: at
// most V_CLUSTER blocks, M <= V_CROWS) keep their row sums and tally in
// shared memory, and warp 0 of block 0 adds the row sums in block order and
// merges the tallies through the cluster's shared memory; else each block
// leaves them in `part` and warp 0 of the last block (integer ticket) does
// the same from there.
template <int DT>
__global__ void __launch_bounds__(V_THREADS)
abft_verdict_kernel(const void* __restrict__ out_, int M, int N, long long s0,
                    long long s1, const double* __restrict__ chk,
                    long long ldc, double* __restrict__ part,
                    unsigned* ticket, double* __restrict__ verdict,
                    int clustered) {
  using T = typename Elem<DT>::T;
  constexpr int VR = sizeof(T) == 8 ? V_ROWS / 2 : V_ROWS;
  const T* __restrict__ out = static_cast<const T*>(out_);
  __shared__ double rowp[V_WARPS][V_ROWS];
  __shared__ Tally wt[V_WARPS];              // the warps' column tallies
  __shared__ double crow[V_CROWS];           // the block's row sums
  __shared__ double clt[V_PART];             // its tally, column 0's residual
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int vb = blockIdx.x, c0 = vb * V_BLOCK;
  const bool alone = gridDim.x == 1;
  const long long stride = M + V_PART;
  double* my_part = part + vb * stride;

  bool c_ok[V_COLS];
  double ref[V_COLS], tol[V_COLS], cs[V_COLS];
#pragma unroll
  for (int v = 0; v < V_COLS; ++v) {
    const int c = c0 + tid + V_THREADS * v;
    c_ok[v] = c < N;
    const int cc = c_ok[v] ? c : N - 1;
    ref[v] = chk[M + cc];
    tol[v] = chk[ldc + M + cc];
    cs[v] = 0.0;
  }
  Tally rt{0, M, 0.0, -1.0};                 // warp 0's lanes
  double er0 = 0.0;
  for (int m0 = 0; m0 < M; m0 += VR) {
    const int nb = min(VR, M - m0);
    T raw[VR][V_COLS];
#pragma unroll
    for (int mm = 0; mm < VR; ++mm) {
      const T* row = out + static_cast<long long>(m0 + (mm < nb ? mm : 0)) * s0;
#pragma unroll
      for (int v = 0; v < V_COLS; ++v) {
        const int c = c0 + tid + V_THREADS * v;
        raw[mm][v] = row[static_cast<long long>(c < N ? c : N - 1) * s1];
      }
    }
    double rref = 0.0, rtol = 1.0;
    if (alone && warp == 0 && lane < nb) {
      rref = chk[m0 + lane];
      rtol = chk[ldc + m0 + lane];
    }
#pragma unroll
    for (int mm = 0; mm < VR; ++mm) {
      double s = 0.0;
#pragma unroll
      for (int v = 0; v < V_COLS; ++v) {
        const double y = c_ok[v] ? as_double(raw[mm][v]) : 0.0;
        if (mm < nb) cs[v] += y;
        s += y;
      }
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_down_sync(0xffffffffu, s, off);
      if (lane == 0) rowp[warp][mm] = s;
    }
    __syncthreads();
    if (warp == 0 && lane < nb) {
      double s = 0.0;
      for (int w = 0; w < V_WARPS; ++w) s += rowp[w][lane];
      if (alone) {
        double e;
        rt = judge(rt, m0 + lane, s, rref, rtol, e);
        if (m0 + lane == 0) er0 = e;
      } else if (clustered) {
        crow[m0 + lane] = s;
      } else {
        my_part[m0 + lane] = s;
      }
    }
    __syncthreads();
  }
  // the thread's columns.  A column is bad where |err| > tol (exactly
  // where |err| / tol > 1: tol is a positive normal double and the quotient
  // correctly rounded); the largest ratio is the quotient of the pair that
  // maximises it (rounding is monotonic), found by cross products, one
  // division a thread (nan where any quotient would be)
  Tally col{0, N, 0.0, -1.0};
  double ec0 = 0.0;                          // column 0's residual
  {
    double be = -1.0, bt = 1.0;
    bool nan = false;
#pragma unroll
    for (int v = 0; v < V_COLS; ++v) {
      if (c_ok[v]) {
        const int c = c0 + tid + V_THREADS * v;
        const double e = cs[v] - ref[v], ae = fabs(e), t = tol[v];
        const bool bad = ae > t;
        if (bad && c < col.first) {
          col.first = c;
          col.err = e;
        }
        col.n += bad;
        nan |= ae != ae || t != t || (isinf(ae) && isinf(t)) ||
               (ae == 0.0 && t == 0.0);
        if (ae * bt > be * t) {
          be = ae;
          bt = t;
        }
        if (c == 0) ec0 = e;
      }
    }
    if (nan)
      col.worst = __longlong_as_double(0x7ff8000000000000LL);
    else if (be >= 0.0)
      col.worst = be / bt;
  }
  // the block's: each warp's, then the warps' (every warp alike)
  col = warp_tally(col);
  if (lane == 0) wt[warp] = col;
  __syncthreads();
  col = warp_tally(lane < V_WARPS ? wt[lane] : Tally{0, N, 0.0, -1.0});
  if (!alone) {
    // the block's tally and column 0's residual (thread 0 of block 0), for
    // block 0 of the cluster or the last block
    double* dst = clustered ? clt : my_part + M;
    if (tid == 0) {
      dst[0] = col.n;
      dst[1] = col.first;
      dst[2] = col.err;
      dst[3] = col.worst;
      dst[4] = ec0;
    }
    bool go;
    if (clustered) {
      cluster_sync();                        // every block's sums are kept
      go = vb == 0 && warp == 0;
    } else {
      if (warp != 0) return;
      int last = 0;
      __syncwarp();                          // lane 0's writes, then
      if (lane == 0) {                       // its fence and ticket
        fence_gpu();
        last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
        if (last) fence_gpu();
      }
      go = __shfl_sync(0xffffffffu, last, 0);
      if (!go) return;
    }
    if (go) {
      // the rows: the blocks' sums in block order; the columns: the
      // blocks' tallies, a lane each (a cluster's loads all issued before
      // any is used, so that their round trips overlap)
      const int n = gridDim.x;
      auto at = [&](int b, int i) {
        return clustered ? cluster_load(clt + i, b)
                         : __ldcg(part + b * stride + M + i);
      };
      for (int m = lane; m < M; m += 32) {
        const double rref = chk[m], rtol = chk[ldc + m];
        double s = 0.0;
        if (clustered) {
          double y[V_CLUSTER];
#pragma unroll
          for (int b = 0; b < V_CLUSTER; ++b)
            if (b < n) y[b] = cluster_load(crow + m, b);
#pragma unroll
          for (int b = 0; b < V_CLUSTER; ++b)
            if (b < n) s += y[b];
        } else {
          for (int b = 0; b < n; ++b) s += __ldcg(part + b * stride + m);
        }
        double e;
        rt = judge(rt, m, s, rref, rtol, e);
        if (m == 0) er0 = e;
      }
      col = Tally{0, N, 0.0, -1.0};
      for (int b = lane; b < n; b += 32)
        col = merge(col, Tally{static_cast<int>(at(b, 0)),
                               static_cast<int>(at(b, 1)), at(b, 2),
                               at(b, 3)});
      col = warp_tally(col);
      if (lane == 0) ec0 = at(0, 4);
    }
    if (clustered) {
      cluster_sync();                        // block 0 has read them
      if (!go) return;
    }
  } else if (warp != 0) {
    return;
  }
  rt = warp_tally(rt);
  // the seven numbers, from lane 0 (thread 0 of the block that ends)
  if (lane == 0) {
    verdict[0] = rt.n;
    verdict[1] = col.n;
    verdict[2] = rt.n ? rt.first : 0;
    verdict[3] = col.n ? col.first : 0;
    verdict[4] = rt.n ? rt.err : er0;
    verdict[5] = col.n ? col.err : ec0;
    verdict[6] = nanmax(rt.worst, col.worst);
  }
}

template <int DT, int MODE, bool VL>
int launch_variant(const dim3& grid, cudaStream_t s, const Params& p) {
  auto kernel = abft_checksums_kernel<DT, MODE, VL>;
  constexpr int bytes = Smem<MODE>::BYTES;
  // above 48 KB a kernel must be allowed its dynamic shared memory (once)
  static bool allowed = false;
  if (!allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = true;
  }
  kernel<<<grid, THREADS, bytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int DT>
int launch_dtype(int mode, bool vl, const dim3& grid, cudaStream_t s,
                 const Params& p) {
  switch (mode) {
    case ABFT_Q:
      return vl ? launch_variant<DT, ABFT_Q, true>(grid, s, p)
                : launch_variant<DT, ABFT_Q, false>(grid, s, p);
    case ABFT_P:
      return vl ? launch_variant<DT, ABFT_P, true>(grid, s, p)
                : launch_variant<DT, ABFT_P, false>(grid, s, p);
    default:
      return vl ? launch_variant<DT, GENERIC, true>(grid, s, p)
                : launch_variant<DT, GENERIC, false>(grid, s, p);
  }
}

// What stays fixed across the calls of one configuration (shape, strides,
// types, vectors and scratch): built once by the wrapper (ctypes, the same
// layout), passed by address.
struct Args {
  long long ld, sc, a_ld, a_sc, or_r, or_j, oc_i, oc_c, om_j, om_m;
  double tol;
  void* part_r;
  void* part_c;
  void* tickets;
  int R, C, dtype, np, nq, M, a_dtype, a_side, rows;
  unsigned pabs, qabs, aff_r, aff_c;
};

}  // namespace

// abft_checksums: one launch on `stream`.  part_r holds n_cb * np * R and
// part_c n_rb * nq * C doubles (none where one block spans the axis), part_m
// (the abft mode) n_cb * n_rb * M * 2, tickets n_rb + n_cb + 1 unsigned,
// zero before the first call (each is back at zero after a call).  The abft
// mode (a_side SIDE_Q or SIDE_P) takes np = nq = 2, pabs = qabs = 0b10, its
// P / Q unread (a's sums on a's side, ones on the other).  Returns a
// cudaError_t (0 on success).
extern "C" int abft_checksums_launch(const void* args, const void* x,
                                     const void* P, const void* Q,
                                     const void* a, void* out_r, void* out_c,
                                     void* out_m, void* part_m,
                                     void* stream) {
  const Args& g = *static_cast<const Args*>(args);
  const int R = g.R, C = g.C, np = g.np, nq = g.nq, rows = g.rows;
  const int dtype = g.dtype, a_side = g.a_side;
  const bool abft = a_side == SIDE_Q || a_side == SIDE_P;
  if (R <= 0 || C <= 0 || np < 0 || np > MAXV || nq < 0 || nq > MAXV ||
      np + nq == 0 || rows < CHUNK || rows > QROWS || rows % CHUNK != 0 ||
      dtype < DT_F32 || dtype > DT_F64 || a_side < SIDE_NONE ||
      a_side > SIDE_P ||
      x == nullptr || g.tickets == nullptr ||
      (abft && (np != 2 || nq != 2 || g.pabs != 2u || g.qabs != 2u ||
                a == nullptr || g.M < 1 || out_m == nullptr ||
                part_m == nullptr)) ||
      (!abft && ((np > 0 && P == nullptr) || (nq > 0 && Q == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = dtype == DT_BF16 ? 8 : (dtype == DT_F32 ? 4 : 2);
  const int width = 32 * vec;
  const int n_cb = (C + width - 1) / width;
  const int n_rb = (R + rows - 1) / rows;
  // the sums each mode writes: along C (rows of X) unless a's sums lie on
  // Q, along R unless they lie on P; partials where blocks share an axis
  const bool rows_out = a_side != SIDE_Q && np > 0;
  const bool cols_out = a_side != SIDE_P && nq > 0;
  if (n_rb > 65535 || (rows_out && out_r == nullptr) ||
      (cols_out && out_c == nullptr) ||
      (rows_out && n_cb > 1 && g.part_r == nullptr) ||
      (cols_out && n_rb > 1 && g.part_c == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int elem = 16 / vec;
  const bool vl = g.sc == 1 && C % vec == 0 &&
                  (reinterpret_cast<uintptr_t>(x) & 15u) == 0 &&
                  (g.ld * elem) % 16 == 0;
  Params p{x, R, C, g.ld, g.sc, static_cast<const double*>(P), np, g.pabs,
           static_cast<const double*>(Q), nq, g.qabs, a, g.M, g.a_ld,
           g.a_sc, g.a_dtype, g.tol, static_cast<double*>(out_r), g.or_r,
           g.or_j, g.aff_r, static_cast<double*>(out_c), g.oc_i, g.oc_c,
           g.aff_c, static_cast<double*>(out_m), g.om_j, g.om_m, rows, n_cb,
           n_rb, static_cast<double*>(g.part_r),
           static_cast<double*>(g.part_c), static_cast<double*>(part_m),
           static_cast<unsigned*>(g.tickets)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_cb, n_rb);
  const int mode = a_side == SIDE_Q ? ABFT_Q : (a_side == SIDE_P ? ABFT_P
                                                                  : GENERIC);
  switch (dtype) {
    case DT_F32: return launch_dtype<DT_F32>(mode, vl, grid, s, p);
    case DT_BF16: return launch_dtype<DT_BF16>(mode, vl, grid, s, p);
    default: return launch_dtype<DT_F64>(mode, vl, grid, s, p);
  }
}

// abft_verdict: one launch on `stream` (a cluster of its blocks where they
// are 2 to 8 and M <= V_CROWS).  chk is (2, M + N) with rows ldc apart; part
// (else) holds ceil(N / V_BLOCK) * (M + V_PART) doubles; ticket one
// unsigned, zero before the first call (back at zero after a call); verdict
// gets the seven doubles.
extern "C" int abft_verdict_launch(const void* out, int M, int N,
                                   long long s0, long long s1, int dtype,
                                   const void* chk, long long ldc, void* part,
                                   void* ticket, void* verdict,
                                   void* stream) {
  const int blocks = N > 0 ? (N + V_BLOCK - 1) / V_BLOCK : 0;
  const int clustered = blocks > 1 && blocks <= V_CLUSTER && M <= V_CROWS;
  if (M <= 0 || N <= 0 || dtype < DT_F32 || dtype > DT_F64 ||
      out == nullptr || chk == nullptr || ticket == nullptr ||
      verdict == nullptr || (blocks > 1 && !clustered && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(V_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = clustered ? 1 : 0;
  const double* c = static_cast<const double*>(chk);
  double* pt = static_cast<double*>(part);
  unsigned* t = static_cast<unsigned*>(ticket);
  double* v = static_cast<double*>(verdict);
  cudaError_t e;
  switch (dtype) {
    case DT_F32:
      e = cudaLaunchKernelEx(&cfg, abft_verdict_kernel<DT_F32>, out, M, N, s0,
                             s1, c, ldc, pt, t, v, clustered);
      break;
    case DT_BF16:
      e = cudaLaunchKernelEx(&cfg, abft_verdict_kernel<DT_BF16>, out, M, N,
                             s0, s1, c, ldc, pt, t, v, clustered);
      break;
    default:
      e = cudaLaunchKernelEx(&cfg, abft_verdict_kernel<DT_F64>, out, M, N, s0,
                             s1, c, ldc, pt, t, v, clustered);
      break;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
