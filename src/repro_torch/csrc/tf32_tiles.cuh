// The pieces the recurrence kernels (ssd_chunk.cu, wkv6.cu) share: f32
// products on the TF32 tensor cores with a 3xTF32 split, 64 x 64 block tiles
// dealt to 8 warps, tiles staged by cp.async and stored in pairs.
//
// 3xTF32: an f32 operand is split as x = hi + lo, hi = rna(x), lo = rna(x -
// hi), both TF32 (10-bit mantissa), and a product takes lo.hi + hi.lo +
// hi.hi on mma.sync m16n8k8 into an f32 accumulator: close to f32 (a single
// TF32 pass keeps 2^-11 of a term).  The tensor cores add inside an mma
// without rounding to nearest, so a sum leans toward zero by about f32's last
// place, and no result repeats an f32 sum taken on the CUDA cores bit for
// bit.  Every function here but the bf16 pieces is used by both kernels'
// sources.
//
// The bf16 pieces (wkv6's bf16 recurrence, wkv6.cu and its gradient
// wkv6_bf16 in wkv6_bwd.cu): bf16 operands widened to f32 exactly, f32
// values rounded to bf16 (to nearest, ties to even), and products on the
// bf16 tensor cores (mma.sync m16n8k16, f32 accumulate) over the same warp
// tiles, their fragments given as bf16x2 pairs or, for a [k][j] tile, read
// by ldmatrix.trans.  A fragment holds the same values however it is
// loaded, and every mma chain keeps its order: the forms give the same
// bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tf32_tiles {

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// round a finite float to TF32 (10-bit mantissa) by cvt.rna's rule: to
// nearest, ties away from zero.  Adding half of the last kept bit to the
// magnitude and dropping the 13 low bits gives cvt.rna.tf32.f32's bits in two
// integer operations; the conversion instruction itself issues at a lower
// rate on this card (3xTF32 takes two per operand element).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo (+ a rest below 2^-22 |x|), both TF32; x - hi is exact
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's share of a 64 x 64 product: row strips m[0] = 16p and m[1] =
// 16(3 - p) (p = warp & 1), columns j0 .. j0 + 15 (j0 = 16 (warp >> 1)).
// Pairing the first strip with the last balances the causal product, whose
// strip r needs k < 16 (r + 1) only.
struct WarpTile {
  int m[2], j0;
};

__device__ __forceinline__ WarpTile warp_tile() {
  const int warp = threadIdx.x >> 5, p = warp & 1;
  return {{16 * p, 16 * (3 - p)}, 16 * (warp >> 1)};
}

// An operand read as (i, k) -> (hi, lo): f(i, k) split on the fly
template <class F>
struct Splitting {
  F f;
  __device__ __forceinline__ void operator()(int i, int k, uint32_t& hi,
                                             uint32_t& lo) const {
    split(f(i, k), hi, lo);
  }
};

template <class F>
__device__ __forceinline__ Splitting<F> splitting(F f) {
  return {f};
}

// One k-step (k0 .. k0 + 7) of acc[strip][n8 tile] += A (m, k) B (k, j)
// for the strips FIRST <= si < LAST, 3xTF32: lo.hi, hi.lo, then hi.hi.  A
// and B give each element's (hi, lo).
template <int FIRST, int LAST = 2, class SA, class SB>
__device__ __forceinline__ void k_step(float (&acc)[2][2][4], SA& A, SB& B,
                                       const WarpTile& w, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t bh[2][2], bl[2][2];
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    B(k0 + t, w.j0 + 8 * jj + g, bh[jj][0], bl[jj][0]);
    B(k0 + t + 4, w.j0 + 8 * jj + g, bh[jj][1], bl[jj][1]);
  }
#pragma unroll
  for (int si = FIRST; si < LAST; ++si) {
    const int m = w.m[si];
    uint32_t ah[4], al[4];
    A(m + g, k0 + t, ah[0], al[0]);
    A(m + g + 8, k0 + t, ah[1], al[1]);
    A(m + g, k0 + t + 4, ah[2], al[2]);
    A(m + g + 8, k0 + t + 4, ah[3], al[3]);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      mma_tf32(acc[si][jj], al, bh[jj][0], bh[jj][1]);
      mma_tf32(acc[si][jj], ah, bl[jj][0], bl[jj][1]);
      mma_tf32(acc[si][jj], ah, bh[jj][0], bh[jj][1]);
    }
  }
}

// acc[strip][n8 tile] (16 x 8 each) += A (m, k) B (k, j), both strips over
// k < k_both, the second (lower) strip alone over k_both <= k < k_last
// (multiples of 8; a causal product's lower strip reaches further).  A and
// B read shared memory (split on the fly, or split once before).
template <class SA, class SB>
__device__ __forceinline__ void product_3xtf32(float (&acc)[2][2][4], SA A,
                                               SB B, const WarpTile& w,
                                               int k_both, int k_last) {
  int k0 = 0;
  for (; k0 < k_both; k0 += 8) k_step<0>(acc, A, B, w, k0);
  for (; k0 < k_last; k0 += 8) k_step<1>(acc, A, B, w, k0);
}

// The transposed causal product: acc += A (m, k) B (k, j) where A (m, k) is
// zero for k < m (an upper-triangular A, as a lower-triangular tile read
// transposed): the first (upper) strip alone over k_first0 <= k < k_first1,
// both strips over k_first1 <= k < k_end (multiples of 8; k_first0 <=
// w.m[0], k_first1 <= w.m[1]).  Each element's sum runs over k in
// ascending order, as product_3xtf32's.
template <class SA, class SB>
__device__ __forceinline__ void product_3xtf32_upper(float (&acc)[2][2][4],
                                                     SA A, SB B,
                                                     const WarpTile& w,
                                                     int k_first0,
                                                     int k_first1,
                                                     int k_end) {
  int k0 = k_first0;
  for (; k0 < k_first1 && k0 < k_end; k0 += 8) k_step<0, 1>(acc, A, B, w, k0);
  for (; k0 < k_end; k0 += 8) k_step<0>(acc, A, B, w, k0);
}

// Two products in one walk over k: acc1 += A1 B1 over k < k_end1 and acc2
// += A2 B2 over k < k_end2 (multiples of 8, both strips), so that the two
// products' mma chains interleave.  Each element's sum runs over k in
// ascending order, as product_3xtf32's: the results are its bits.
template <class SA1, class SB1, class SA2, class SB2>
__device__ __forceinline__ void product2_3xtf32(float (&acc1)[2][2][4],
                                                SA1 A1, SB1 B1, int k_end1,
                                                float (&acc2)[2][2][4],
                                                SA2 A2, SB2 B2, int k_end2,
                                                const WarpTile& w) {
  const int k_both = min(k_end1, k_end2);
  int k0 = 0;
  for (; k0 < k_both; k0 += 8) {
    k_step<0>(acc1, A1, B1, w, k0);
    k_step<0>(acc2, A2, B2, w, k0);
  }
  for (int k = k0; k < k_end1; k += 8) k_step<0>(acc1, A1, B1, w, k);
  for (int k = k0; k < k_end2; k += 8) k_step<0>(acc2, A2, B2, w, k);
}

// product_3xtf32_upper of two products over the same k range at once
template <class SA1, class SB1, class SA2, class SB2>
__device__ __forceinline__ void product2_3xtf32_upper(
    float (&acc1)[2][2][4], SA1 A1, SB1 B1, float (&acc2)[2][2][4], SA2 A2,
    SB2 B2, const WarpTile& w, int k_first0, int k_first1, int k_end) {
  int k0 = k_first0;
  for (; k0 < k_first1 && k0 < k_end; k0 += 8) {
    k_step<0, 1>(acc1, A1, B1, w, k0);
    k_step<0, 1>(acc2, A2, B2, w, k0);
  }
  for (; k0 < k_end; k0 += 8) {
    k_step<0>(acc1, A1, B1, w, k0);
    k_step<0>(acc2, A2, B2, w, k0);
  }
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

// x as a T (for bf16: rounded, exact where x is a rounding above)
template <class T>
__device__ __forceinline__ T narrow(float x) {
  if constexpr (IS_BF16<T>)
    return __float2bfloat16_rn(x);
  else
    return x;
}

// two f32 values as one bf16x2 register, lo in the low half, each rounded
// to the nearest bf16 (exact where it comes from a rounding above)
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

// One k-step (k0 .. k0 + 15) of acc[strip][n8 tile] += A (m, k) B (k, j)
// on the bf16 tensor cores for the strips FIRST <= si < 2.  A gives bf16x2
// pairs, A(m, k) the elements (m, k) and (m, k + 1), the first in the low
// half (k even); b holds the k-step's B fragments, b[jj][h] the elements
// (k0 + 2t + 8h, n) and (k0 + 2t + 8h + 1, n) of column n = j0 + 8 jj + g.
template <int FIRST, class PA>
__device__ __forceinline__ void bf16_step(float (&acc)[2][2][4], PA& A,
                                          const uint32_t (&b)[2][2],
                                          const WarpTile& w, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int si = FIRST; si < 2; ++si) {
    const int m = w.m[si];
    const uint32_t a[4] = {A(m + g, k0 + t2), A(m + g + 8, k0 + t2),
                           A(m + g, k0 + t2 + 8), A(m + g + 8, k0 + t2 + 8)};
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) mma_bf16(acc[si][jj], a, b[jj][0], b[jj][1]);
  }
}

// B pairs of a k-step (bf16_step's b) from B(k, j), the elements (k, j)
// and (k + 1, j), the first in the low half (k even)
template <class PB>
__device__ __forceinline__ void pairs_b(uint32_t (&b)[2][2], PB& B,
                                        const WarpTile& w, int k0) {
  const int g = (threadIdx.x & 31) >> 2, t2 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    b[jj][0] = B(k0 + t2, w.j0 + 8 * jj + g);
    b[jj][1] = B(k0 + t2 + 8, w.j0 + 8 * jj + g);
  }
}

// acc[strip][n8 tile] += A (m, k) B (k, j) on the bf16 tensor cores, both
// strips over k < k_both, the lower strip alone up to k_last (multiples of
// 16), as product_3xtf32: bf16_step over k in ascending order, load_b(k0,
// b) filling each k-step's B fragments.
template <class PA, class LB>
__device__ __forceinline__ void product_bf16_frags(float (&acc)[2][2][4],
                                                   PA A, LB load_b,
                                                   const WarpTile& w,
                                                   int k_both, int k_last) {
  for (int k0 = 0; k0 < k_last; k0 += 16) {
    uint32_t b[2][2];
    load_b(k0, b);
    if (k0 < k_both)
      bf16_step<0>(acc, A, b, w, k0);
    else
      bf16_step<1>(acc, A, b, w, k0);
  }
}

// product_bf16_frags with B given as bf16x2 pairs too (pairs_b)
template <class PA, class PB>
__device__ __forceinline__ void product_bf16x2(float (&acc)[2][2][4], PA A,
                                               PB B, const WarpTile& w,
                                               int k_both, int k_last) {
  product_bf16_frags(
      acc, A, [&](int k0, uint32_t (&b)[2][2]) { pairs_b(b, B, w, k0); }, w,
      k_both, k_last);
}

// A k-step's B fragments (product_bf16_frags' load_b) from a row-major
// [k][j] bf16 tile in shared memory (row stride ld halves, rows 16-byte
// aligned), whose k-pairs are not contiguous: one ldmatrix.x4.trans reads
// the four 8 x 8 blocks (k0 | k0 + 8) x (j0 | j0 + 8), lanes 8i .. 8i + 7
// giving block i's row addresses, and transposes each on the way, so a
// thread holds (2t, g) and (2t + 1, g) of a block: its B fragment.
__device__ __forceinline__ void ldmatrix_trans_b(uint32_t (&b)[2][2],
                                                 const __nv_bfloat16* tile,
                                                 int ld, int k0, int j0) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* row =
      tile + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld + j0 +
      8 * (lane >> 4);
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(b[0][0]), "=r"(b[0][1]), "=r"(b[1][0]), "=r"(b[1][1])
      : "r"(a));
}

// Two products in one walk over k, both strips: acc16 += A16 B16 on the
// bf16 tensor cores (pairs as product_bf16x2's, k < k16, a multiple of 16)
// and acc += A B in 3xTF32 (as product_3xtf32's, k < k8, a multiple of 8),
// a bf16 k-step and then the TF32 k-steps over the same 16 k, so that the
// two products' mma chains interleave.  Each element's sum runs over k in
// ascending order, as in the two products alone: the results are their
// bits.
template <class PA16, class PB16, class SA, class SB>
__device__ __forceinline__ void product2_bf16x2_3xtf32(
    float (&acc16)[2][2][4], PA16 A16, PB16 B16, int k16,
    float (&acc)[2][2][4], SA A, SB B, int k8, const WarpTile& w) {
  for (int k0 = 0; k0 < max(k16, k8); k0 += 16) {
    if (k0 < k16) {
      uint32_t b[2][2];
      pairs_b(b, B16, w, k0);
      bf16_step<0>(acc16, A16, b, w, k0);
    }
    if (k0 < k8) k_step<0>(acc, A, B, w, k0);
    if (k0 + 8 < k8) k_step<0>(acc, A, B, w, k0 + 8);
  }
}

// product_bf16x2 with A and B read as f32 values (shared memory), each
// rounded to bf16 as it is packed
template <class FA, class FB>
__device__ __forceinline__ void product_bf16(float (&acc)[2][2][4], FA A,
                                             FB B, const WarpTile& w,
                                             int k_both, int k_last) {
  product_bf16x2(
      acc, [&](int m, int k) { return pack_bf16(A(m, k), A(m, k + 1)); },
      [&](int k, int n) { return pack_bf16(B(k, n), B(k + 1, n)); }, w,
      k_both, k_last);
}

// f(row, col, si, jj, r) for every element acc[si][jj][r] of a warp's share
template <class F>
__device__ __forceinline__ void for_each(const WarpTile& w, F f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int si = 0; si < 2; ++si)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        f(w.m[si] + g + 8 * (r >> 1), w.j0 + 8 * jj + 2 * t + (r & 1), si,
          jj, r);
}

// 4 or 16 bytes global -> shared without registers; zero-filled when
// !valid (the address is clamped by the caller and read not at all)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// a (ROWS x COLS) tile, row i and column q of which are at at(i, q), into
// dst (row stride ld), by a block of NT threads: rows >= rows and columns >=
// cols zero-filled.  vec: 16 bytes a copy (every row 16-byte aligned, cols a
// multiple of 4)
template <int ROWS, int COLS, int NT, class At>
__device__ __forceinline__ void stage_tile(float* dst, int ld, At at, int rows,
                                           int cols, bool vec) {
  if (vec) {
#pragma unroll
    for (int e = threadIdx.x; e < ROWS * COLS / 4; e += NT) {
      const int i = e / (COLS / 4), q = 4 * (e % (COLS / 4));
      cp_async16(dst + i * ld + q, at(min(i, rows - 1), min(q, cols - 4)),
                 i < rows && q < cols);
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < ROWS * COLS; e += NT) {
      const int i = e / COLS, q = e % COLS;
      cp_async4(dst + i * ld + q, at(min(i, rows - 1), min(q, cols - 1)),
                i < rows && q < cols);
    }
  }
}

// stage_tile for a tile of T (float or bf16): 16 bytes a copy where vec
// (every row 16-byte aligned, cols a multiple of 16 / sizeof(T)); else 4
// bytes a copy for float, and for bf16 plain loads and stores (cp.async has
// no 2-byte copy).  Rows >= rows and columns >= cols zero-filled.
template <int ROWS, int COLS, int NT, class T, class At>
__device__ __forceinline__ void stage_tile_t(T* dst, int ld, At at, int rows,
                                             int cols, bool vec) {
  if constexpr (std::is_same<T, float>::value) {
    stage_tile<ROWS, COLS, NT>(dst, ld, at, rows, cols, vec);
  } else {
    constexpr int PER = 16 / sizeof(T);
    if (vec) {
#pragma unroll
      for (int e = threadIdx.x; e < ROWS * COLS / PER; e += NT) {
        const int i = e / (COLS / PER), q = PER * (e % (COLS / PER));
        cp_async16(reinterpret_cast<float*>(dst + i * ld + q),
                   reinterpret_cast<const float*>(
                       at(min(i, rows - 1), min(q, cols - PER))),
                   i < rows && q < cols);
      }
    } else {
#pragma unroll 4
      for (int e = threadIdx.x; e < ROWS * COLS; e += NT) {
        const int i = e / COLS, q = e % COLS;
        const T v = *at(min(i, rows - 1), min(q, cols - 1));
        dst[i * ld + q] = (i < rows && q < cols) ? v : narrow<T>(0.f);
      }
    }
  }
}

// out(row, col) <- a warp's share, in pairs (two neighbouring columns, 8
// bytes) where ncols is even; rows >= nrows and cols >= ncols left out
template <class Out>
__device__ __forceinline__ void store_tile(const float (&acc)[2][2][4],
                                           const WarpTile& w, int nrows,
                                           int ncols, Out out) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int si = 0; si < 2; ++si)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = w.m[si] + g + 8 * half, col = w.j0 + 8 * jj + 2 * t;
        if (row >= nrows || col >= ncols) continue;
        float* dst = out(row, col);
        const float v0 = acc[si][jj][2 * half], v1 = acc[si][jj][2 * half + 1];
        if (ncols % 2 == 0) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          dst[0] = v0;
          if (col + 1 < ncols) dst[1] = v1;
        }
      }
}

}  // namespace tf32_tiles
