// razor_matmul for NVIDIA Hopper (sm_90a): Razor double-sampled matmul.
//
// Replaces the Pallas kernel src/repro/kernels/razor_matmul.py::_kernel
// (and its _quant_rows, now quant_rows.cu).
//
//   main   = dequant(int8(a) @ int8(b)^T)       the near-threshold path
//   shadow = f32(a) @ f32(b)                    the delayed shadow register
//   per (block_m x block_n) partition cell:
//     rel   = ||main - shadow||_F / (||shadow||_F + 1e-12)
//     fired = rel > tol;  C = fired ? shadow : main      (Razor replay)
//   plus the flag map, the rel map and the fired-cell count.
//
// How it differs from the kernel it replaces:
//   * The Pallas program holds a whole (block, K) row panel, quantizes it
//     again in every tile and multiplies the integer values in f32 (exact
//     only while partial sums stay below 2^24; K * 127^2 passes that at
//     K = 1041).  Here the scales and int8 copies are taken once per operand
//     (quant_rows.cu), and the integer product is int32 on the tensor cores,
//     exact as the oracle's, so a main-path cell equals the plain version
//     bit for bit at any K below 133,000.
//   * A cell's decision needs the whole cell, and a cell (128 x 128 from
//     select_blocks) is larger than a launch tile.  So one call is, on one
//     stream: the two quantizations, a product pass that writes main and
//     shadow, a cell-sums pass and a cell-select pass.
//
// What bounds it on this card.  At a 256-row prefill chunk against a
// full-width weight: the tensor cores (2MNK bf16 + 2MNK int8) and the bytes
// of b, read once for the shadow and once more as its int8 copy.  What the
// design does:
//   * Both products on the tensor cores.  bf16 operands: warpgroup MMAs
//     (wgmma) reading both operands from shared memory, m64n64k32 int8 into
//     int32 (exact: |sum| <= K * 127^2 < 2^31) and m64n64k16 bf16 into f32
//     (a bf16 product is exact in f32).  f32 operands: mma.sync, m16n8k32
//     int8 into int32 and a 3xTF32 split on m16n8k8: x = hi + lo, both
//     rounded to a 10-bit mantissa, each product lo.hi + hi.lo + hi.hi (a
//     single TF32 pass keeps 2^-11 of each term, too little for the
//     shadow's 1e-5 of max|C|).
//   * A block computes a 64 x 64 tile of C with one warpgroup of four MMA
//     warps (bf16: the whole tile by wgmma; f32: 32 x 32 a warp) and one
//     producer warp.  The producer streams a, b and their int8 copies
//     through a ring of STAGES k-tiles of 64 in shared memory by 2-D
//     tensor-map TMA (one box a lane, completion on an mbarrier); the MMA
//     warps hand a stage back on a second mbarrier as soon as they are done
//     with it, so STAGES - 1 tiles are in flight while one is multiplied
//     and no block-wide barrier sits in the loop.  Boxes are in the TMA's
//     128-byte swizzle (float tiles) and 64-byte swizzle (int8 tiles), the
//     layouts wgmma's descriptors and ldmatrix read without bank conflicts;
//     what lies outside the matrices arrives as zeros.  b's box runs along
//     whichever axis of b is contiguous (a transposed view is read in
//     place; wgmma takes the row-major weight's tile as N-major).
//   * Blocks are ordered with the row tiles fastest, so the blocks that
//     share a column tile of b run together and read it from L2.
//   * An operand the TMA cannot take (a base pointer or a row stride that
//     is not 16-byte aligned: the ragged 96 x 100 x 80 case, b as the view
//     of a (80, 100) tensor) is loaded by the producer warp's lanes into the
//     same swizzled layout: unconditional loads from an address clamped
//     into the matrix, zeroed after.
//   * The cell passes run over (cell, slice) grids: the sums pass reads
//     main and shadow once; the select pass reads only the plane the cell
//     keeps.  Loads are 16 bytes where the cell's rows allow it.
//
// Numerical contracts:
//   1. Main cells: the int32 sum is exact, then (float(acc) * sa) * sb, the
//      oracle's order: bit-equal to the plain version.
//   2. One summation order for the shadow: k-tiles of 64 in ascending order;
//      each tile's MMAs go into a fresh f32 fragment that is then added to
//      the register sum, which keeps the tensor core's own accumulation to
//      one tile (as systolic_mac.cu does; accumulated on the tensor cores
//      over K = 8192, the bf16 shadow reached the 1e-5 x max|C| limit).
//   3. The cell sums run in one fixed order (each thread ascending, a fixed
//      tree, the slices in order), so a repeated call gives the same bits,
//      flags and count.  No float atomics; the count is an integer
//      atomicAdd of one per fired cell.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// the shared prologue (quant_rows.cu)
extern "C" int quant_rows_launch(const void* x, int R, int K, int Kp,
                                 long long s_r, long long s_k, float levels,
                                 int dtype, void* amax, void* q, void* scale,
                                 void* stream);

namespace {

constexpr int BM = 64;          // rows of a block tile
constexpr int BN = 64;          // columns of a block tile
constexpr int BK = 64;          // k of a stage, both operand types
constexpr int THREADS = 128;    // four MMA warps: one warpgroup
constexpr int BLOCK = THREADS + 32;   // and one warp that issues the copies
constexpr int STAGES = 4;       // ring of k-tiles, STAGES - 1 in flight
constexpr int ROW = 128;        // bytes of a float tile row: one swizzle row
constexpr int QROW = BK;        // bytes of an int8 tile row
constexpr int K_PAD = 32;       // the int8 copies' row padding (quant_rows)
constexpr int CELL_THREADS = 256;
constexpr int MAX_SLICES = 64;  // slices of a cell in the cell passes
constexpr int WS_ALIGN = 256;   // alignment of the workspace's pieces

// Float tiles are boxes of 128-byte rows: a [BM][BK] as BK / W boxes of
// [BM][W]; b as BN / W boxes of [BK][W] (b's N contiguous) or BK / W boxes
// of [BN][W] (b's K contiguous, the transposed view); W = 128 / sizeof(T).
// The int8 copies are one box each, [BM][64] and [BN][64] bytes.
template <typename T>
struct Tile {
  static constexpr int ES = static_cast<int>(sizeof(T));
  static constexpr int W = ROW / ES;            // 64 bf16, 32 f32
  static constexpr int BOXES = BK / W;          // = BN / W: 1 bf16, 2 f32
  static constexpr int A_BOX = BM * ROW;
  static constexpr int B_BOX = BK * ROW;        // = BN * ROW
  static constexpr int A_BYTES = BOXES * A_BOX;
  static constexpr int B_BYTES = BOXES * B_BOX;
  static constexpr int QA_BYTES = BM * QROW;
  static constexpr int QB_BYTES = BN * QROW;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES + QA_BYTES + QB_BYTES;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;   // + align
  static_assert(BK == BN && BK % W == 0, "square k-tiles of whole boxes");
  static_assert(A_BOX % 1024 == 0 && STAGE_BYTES % 1024 == 0 &&
                    (A_BYTES + B_BYTES) % 1024 == 0 && QA_BYTES % 512 == 0,
                "swizzled boxes start on their swizzle's boundaries");
};

// byte offset of byte `b` of row `r` in a box of 128-byte rows in the
// 128-byte swizzle: the 16-byte chunk c of row r sits at c ^ (r % 8)
__device__ __forceinline__ uint32_t swz(int r, int b) {
  return r * ROW + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
}
// the same for a box of 64-byte rows in the 64-byte swizzle: chunk c of row
// r sits at c ^ ((r / 2) % 4)
__device__ __forceinline__ uint32_t swz64(int r, int b) {
  return r * QROW + ((((b >> 4) ^ (r >> 1)) & 3) << 4) + (b & 15);
}

template <typename T>
__device__ __forceinline__ uint32_t a_off(int r, int k) {
  using L = Tile<T>;
  return (k / L::W) * L::A_BOX + swz(r, (k % L::W) * L::ES);
}
// b's element (k, n) in its tile; KFAST: b's contiguous axis is K
template <typename T, bool KFAST>
__device__ __forceinline__ uint32_t b_off(int k, int n) {
  using L = Tile<T>;
  if (KFAST) return (k / L::W) * L::B_BOX + swz(n, (k % L::W) * L::ES);
  return (n / L::W) * L::B_BOX + swz(k, (n % L::W) * L::ES);
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __ushort_as_bfloat16(static_cast<unsigned short>(0));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier and tensor copies (the Tensor Memory Accelerator)
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}\n" ::"r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
// one box of a 2-D tensor map at element coordinates (c0 inner, c1 outer);
// what lies outside the tensor arrives as zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- tensor cores, warp-level (mma.sync): the f32 path
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x32, row) * b (32x8, col), int8 operands, exact int32 sum
__device__ __forceinline__ void mma_s8(int* d, const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a (16x8, row) * b (8x8, col), TF32 operands, f32 accumulate
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// round a finite float to TF32 (10-bit mantissa) by cvt.rna's rule: to
// nearest, ties away from zero, in two integer operations (ssd_chunk.cu)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo (+ a rest below 2^-22 |x|), both TF32; x - hi is exact
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// ---- tensor cores, warpgroup-level (wgmma): the bf16 path.  Operands are
// read from shared memory through 64-bit descriptors: start address,
// stride between 8-row groups (SBO), swizzle (1 = 128-byte, 2 = 64-byte).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t sbo,
                                              uint32_t swizzle) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(swizzle) << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator registers across the
// asynchronous wgmma (CUTLASS's warpgroup_fence_operand)
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(int (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (= or +=) a (64x16, K-major) * b (16x64; K-major, or N-major where
// TB = 1), bf16 operands, f32 accumulate; scale_d = 0 starts a fresh sum
template <int TB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}
// d += a (64x32, K-major) * b (32x64, K-major), int8 operands, exact int32
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// The oracle's dequantization, in its order: (float(acc) * sa) * sb.
__device__ __forceinline__ float dequant(int acc, float sa, float sb) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), sa), sb);
}

// A consumer thread's 32 sums of each plane, as 8 fragments of 4: element
// e of fragment f lies at row frag_row(f) + 8 (e / 2), column frag_col(f) +
// e % 2.  bf16 (one wgmma warpgroup, m64n64): warp w holds rows 16w + l / 4
// (+ 8) and fragment f columns 8f + 2 (l % 4).  f32 (mma.sync, a 32 x 32
// tile a warp): fragment f = 4 mi + nj at rows 32 (w % 2) + 16 mi + l / 4,
// columns 32 (w / 2) + 8 nj + 2 (l % 4).
template <typename T>
__device__ __forceinline__ int frag_row(int warp, int lane, int f) {
  if (sizeof(T) == 2) return 16 * warp + (lane >> 2);
  return 32 * (warp & 1) + 16 * (f >> 2) + (lane >> 2);
}
template <typename T>
__device__ __forceinline__ int frag_col(int warp, int lane, int f) {
  if (sizeof(T) == 2) return 8 * f + 2 * (lane & 3);
  return 32 * (warp >> 1) + 8 * (f & 3) + 2 * (lane & 3);
}

// One k-tile of the bf16 path on the warpgroup, issued as one group: the
// shadow's four k16 steps into a fresh sum t, the main path's two k32 steps
// into iacc.  The caller waits for it.
template <bool KFAST>
__device__ __forceinline__ void issue_bf16(const unsigned char* As,
                                           const unsigned char* Bs,
                                           const unsigned char* Qa,
                                           const unsigned char* Qb,
                                           float (&t)[32], int (&iacc)[32]) {
  // a, and b when K is its contiguous axis: 64 rows of 128 bytes, a k16
  // step 32 bytes along the row; b with N contiguous: 64 k-rows of 128
  // bytes (N-major), a k16 step 16 rows down.  Groups of 8 rows 1024 bytes
  // apart; the int8 tiles' 64-byte rows 512 apart.
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_bf16<KFAST ? 0 : 1>(
        t, smem_desc(As + 32 * kk, 1024, 1),
        smem_desc(Bs + (KFAST ? 32 * kk : 2048 * kk), 1024, 1), kk > 0);
#pragma unroll
  for (int kk = 0; kk < QROW / 32; ++kk)
    wgmma_s8(iacc, smem_desc(Qa + 32 * kk, 512, 2),
             smem_desc(Qb + 32 * kk, 512, 2));
  wgmma_commit();
}

// One k-tile of the f32 path on a warp (mma.sync, 32 x 32): the shadow's
// 3xTF32 products into a fresh sum t, the int8 products into iacc.
template <bool KFAST>
__device__ __forceinline__ void stage_f32(const unsigned char* As,
                                          const unsigned char* Bs,
                                          const unsigned char* Qa,
                                          const unsigned char* Qb,
                                          float (&t)[32], int (&iacc)[32],
                                          int wr, int wc, int lane) {
  const int q = lane >> 3, r8 = lane & 7, g = lane >> 2, tig = lane & 3;
#pragma unroll 2
  for (int kk = 0; kk < BK; kk += 8) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      uint32_t raw[4];
      ldsm_x4(raw, As + a_off<float>(wr + mi * 16 + r8 + (q & 1) * 8,
                                     kk + (q >> 1) * 4));
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split(__uint_as_float(raw[e]), ah[mi][e], al[mi][e]);
    }
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const int n = wc + nj * 8 + g;
      const float b0 = *reinterpret_cast<const float*>(
          Bs + b_off<float, KFAST>(kk + tig, n));
      const float b1 = *reinterpret_cast<const float*>(
          Bs + b_off<float, KFAST>(kk + tig + 4, n));
      uint32_t bh0, bl0, bh1, bl1;
      split(b0, bh0, bl0);
      split(b1, bh1, bl1);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        float* d = t + 4 * (4 * mi + nj);
        mma_tf32(d, al[mi], bh0, bh1);
        mma_tf32(d, ah[mi], bl0, bl1);
        mma_tf32(d, ah[mi], bh0, bh1);
      }
    }
  }
#pragma unroll
  for (int kk = 0; kk < QROW; kk += 32) {
    uint32_t a8[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldsm_x4(a8[mi], Qa + swz64(wr + mi * 16 + r8 + (q & 1) * 8,
                                 kk + (q >> 1) * 16));
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      uint32_t b8[4];
      ldsm_x4(b8, Qb + swz64(wc + jp * 16 + r8 + (q >> 1) * 8,
                             kk + (q & 1) * 16));
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_s8(iacc + 4 * (4 * mi + 2 * jp), a8[mi], b8[0], b8[1]);
        mma_s8(iacc + 4 * (4 * mi + 2 * jp + 1), a8[mi], b8[2], b8[3]);
      }
    }
  }
}

struct Problem {
  int M, N, K, k_tiles;
  long long sa_m, sa_k, sb_k, sb_n;
  int a_tma, b_tma;
};

template <typename T, bool KFAST>
__global__ void __launch_bounds__(BLOCK, 2)
razor_product_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     const __grid_constant__ CUtensorMap map_qa,
                     const __grid_constant__ CUtensorMap map_qb,
                     const T* __restrict__ a, const T* __restrict__ b,
                     const float* __restrict__ scale_a,
                     const float* __restrict__ scale_b,
                     float* __restrict__ main_out,
                     float* __restrict__ shadow_out, Problem p) {
  using L = Tile<T>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const bool by_hand = !p.a_tma || !p.b_tma;

  if (tid == 0) {
    // full: the copy issuer's arrival (with the bytes it expects) and,
    // where a float tile is loaded by hand, every producer lane's; empty:
    // one arrival per MMA warp
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(full + s), 1u + (by_hand ? 32u : 0u));
      mbar_init(smem_u32(empty + s), THREADS / 32);
    }
  }
  __syncthreads();

  if (tid >= THREADS) {
    // ---- the producer warp
    const int lane = tid - THREADS;
    const uint32_t tx_bytes = (p.a_tma ? L::A_BYTES : 0) +
                              (p.b_tma ? L::B_BYTES : 0) + L::QA_BYTES +
                              L::QB_BYTES;
    for (int i = 0; i < p.k_tiles; ++i) {
      const int s = i % STAGES;
      if (i >= STAGES) mbar_wait(smem_u32(empty + s), ((i / STAGES) + 1) & 1);
      unsigned char* As = smem + s * L::STAGE_BYTES;
      unsigned char* Bs = As + L::A_BYTES;
      unsigned char* Qa = Bs + L::B_BYTES;
      unsigned char* Qb = Qa + L::QA_BYTES;
      const uint32_t bar = smem_u32(full + s);
      const int k0 = i * BK;
      if (lane == 0) {
        fence_proxy_async();        // the stage's last reads came before
        mbar_arrive_expect_tx(bar, tx_bytes);
      }
      __syncwarp();
      // one box a lane: a's on lanes 0.., b's on lanes 2.., the int8 copies
      // on lanes 4 and 5
      if (p.a_tma && lane < L::BOXES)
        tma_load(smem_u32(As + lane * L::A_BOX), &map_a, bar,
                 k0 + lane * L::W, row0);
      if (p.b_tma && lane >= 2 && lane < 2 + L::BOXES) {
        const int j = lane - 2;
        if (KFAST)
          tma_load(smem_u32(Bs + j * L::B_BOX), &map_b, bar, k0 + j * L::W,
                   col0);
        else
          tma_load(smem_u32(Bs + j * L::B_BOX), &map_b, bar, col0 + j * L::W,
                   k0);
      }
      if (lane == 4) tma_load(smem_u32(Qa), &map_qa, bar, k0, row0);
      if (lane == 5) tma_load(smem_u32(Qb), &map_qb, bar, k0, col0);
      if (!by_hand) continue;
      if (!p.a_tma) {
#pragma unroll 8
        for (int e = 0; e < BM * BK / 32; ++e) {
          const int idx = lane + e * 32;
          const int r = idx / BK, kc = idx % BK;
          const int row = row0 + r, k = k0 + kc;
          const T v = a[(long long)min(row, p.M - 1) * p.sa_m +
                        (long long)min(k, p.K - 1) * p.sa_k];
          *reinterpret_cast<T*>(As + a_off<T>(r, kc)) =
              (row < p.M && k < p.K) ? v : zero_of<T>();
        }
      }
      if (!p.b_tma) {
#pragma unroll 8
        for (int e = 0; e < BK * BN / 32; ++e) {
          const int idx = lane + e * 32;
          // neighbouring lanes walk b's contiguous axis
          const int kr = KFAST ? idx % BK : idx / BN;
          const int nr = KFAST ? idx / BK : idx % BN;
          const int k = k0 + kr, n = col0 + nr;
          const T v = b[(long long)min(k, p.K - 1) * p.sb_k +
                        (long long)min(n, p.N - 1) * p.sb_n];
          *reinterpret_cast<T*>(Bs + b_off<T, KFAST>(kr, nr)) =
              (k < p.K && n < p.N) ? v : zero_of<T>();
        }
      }
      // the stores above, seen by the tensor cores' reads (async proxy)
      fence_proxy_async();
      mbar_arrive(bar);
    }
    return;
  }

  // ---- the MMA warps (one warpgroup)
  const int lane = tid & 31, warp = tid >> 5;
  float acc[32], t[32];             // the sum, and one k-tile's
  int iacc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    acc[e] = t[e] = 0.0f;
    iacc[e] = 0;
  }
  for (int i = 0; i < p.k_tiles; ++i) {
    const int s = i % STAGES;
    mbar_wait(smem_u32(full + s), (i / STAGES) & 1);
    const unsigned char* As = smem + s * L::STAGE_BYTES;
    const unsigned char* Bs = As + L::A_BYTES;
    const unsigned char* Qa = Bs + L::B_BYTES;
    const unsigned char* Qb = Qa + L::QA_BYTES;
    if constexpr (sizeof(T) == 2) {
      // (a second tile sum, to add one k-tile while the next one runs,
      // makes ptxas serialize the wgmmas: slower on the card)
      issue_bf16<KFAST>(As, Bs, Qa, Qb, t, iacc);
      wgmma_wait<0>();
      fence_regs(t);
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) t[e] = 0.0f;
      stage_f32<KFAST>(As, Bs, Qa, Qb, t, iacc, (warp & 1) * 32,
                       (warp >> 1) * 32, lane);
    }
    __syncwarp();                   // the warp's reads of the stage are done
    if (lane == 0) mbar_arrive(smem_u32(empty + s));
    // the k-tile's sum into the f32 register sum, in one fixed order
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] += t[e];
  }
  if constexpr (sizeof(T) == 2) fence_regs(iacc);

  // ---- epilogue: dequantize the main path, write both planes
  const bool pairs = (p.N % 2) == 0;
#pragma unroll
  for (int f = 0; f < 8; ++f)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + frag_row<T>(warp, lane, f) + 8 * h;
      const int col = col0 + frag_col<T>(warp, lane, f);
      if (row >= p.M || col >= p.N) continue;
      const float sa = scale_a[row];
      const int e = 4 * f + 2 * h;
      const long long at = (long long)row * p.N + col;
      const float m0 = dequant(iacc[e], sa, scale_b[col]);
      const float s0 = acc[e];
      if (col + 1 < p.N) {
        const float m1 = dequant(iacc[e + 1], sa, scale_b[col + 1]);
        const float s1 = acc[e + 1];
        if (pairs) {
          *reinterpret_cast<float2*>(main_out + at) = make_float2(m0, m1);
          *reinterpret_cast<float2*>(shadow_out + at) = make_float2(s0, s1);
          continue;
        }
        main_out[at + 1] = m1;
        shadow_out[at + 1] = s1;
      }
      main_out[at] = m0;
      shadow_out[at] = s0;
    }
}

// ---- the cell passes over (cell, slice): a slice is a contiguous range of
// the cell's elements in row-major order, taken V at a time (V = 4 where
// the cell's rows and C's rows are multiples of 4 floats)

struct Cells {
  int N, block_m, block_n, grid_n, slices;
};

template <int V>
__device__ __forceinline__ void slice_range(const Cells& c, long long* base,
                                            long long* lo, long long* hi) {
  const int cell = blockIdx.x, slice = blockIdx.y;
  const int ci = cell / c.grid_n, cj = cell % c.grid_n;
  *base = (long long)ci * c.block_m * c.N + (long long)cj * c.block_n;
  const long long units = (long long)c.block_m * c.block_n / V;
  *lo = units * slice / c.slices;
  *hi = units * (slice + 1) / c.slices;
}

template <int V>
__device__ __forceinline__ long long unit_at(const Cells& c, long long base,
                                             long long u) {
  const int per_row = c.block_n / V;
  return base + (u / per_row) * c.N + (u % per_row) * V;
}

template <int V>
__device__ __forceinline__ void load_units(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = w.x;
    v[1] = w.y;
    v[2] = w.z;
    v[3] = w.w;
  } else {
    v[0] = __ldg(p);
  }
}

// partial[cell, slice] = (sum (main - shadow)^2, sum shadow^2) over the
// slice: each thread ascending, then a fixed tree
template <int V>
__global__ void __launch_bounds__(CELL_THREADS)
razor_cell_sums_kernel(const float* __restrict__ main_in,
                       const float* __restrict__ shadow_in,
                       float* __restrict__ partial, Cells c) {
  __shared__ float red_d[CELL_THREADS];
  __shared__ float red_s[CELL_THREADS];
  const int tid = threadIdx.x;
  long long base, lo, hi;
  slice_range<V>(c, &base, &lo, &hi);
  float d2 = 0.0f, s2 = 0.0f;
#pragma unroll 2
  for (long long u = lo + tid; u < hi; u += CELL_THREADS) {
    const long long at = unit_at<V>(c, base, u);
    float m[V], s[V];
    load_units<V>(main_in + at, m);
    load_units<V>(shadow_in + at, s);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float d = m[i] - s[i];
      d2 = fmaf(d, d, d2);
      s2 = fmaf(s[i], s[i], s2);
    }
  }
  red_d[tid] = d2;
  red_s[tid] = s2;
  __syncthreads();
  for (int half = CELL_THREADS / 2; half > 0; half /= 2) {
    if (tid < half) {
      red_d[tid] += red_d[tid + half];
      red_s[tid] += red_s[tid + half];
    }
    __syncthreads();
  }
  if (tid == 0) {
    const long long at = 2LL * ((long long)blockIdx.x * c.slices + blockIdx.y);
    partial[at] = red_d[0];
    partial[at + 1] = red_s[0];
  }
}

// every slice block sums its cell's partials in slice order (the same bits
// in each), decides, and copies the plane the cell keeps; slice 0 writes the
// cell's rel and flag and counts it
template <int V>
__global__ void __launch_bounds__(CELL_THREADS)
razor_cell_select_kernel(const float* __restrict__ main_in,
                         const float* __restrict__ shadow_in,
                         const float* __restrict__ partial,
                         float* __restrict__ out, int* __restrict__ flags,
                         float* __restrict__ rel, int* __restrict__ count,
                         Cells c, float tol) {
  __shared__ int fired_s;
  const int tid = threadIdx.x;
  const int cell = blockIdx.x;
  if (tid == 0) {
    const float* pc = partial + 2LL * cell * c.slices;
    float d2 = 0.0f, s2 = 0.0f;
    for (int s = 0; s < c.slices; ++s) {
      d2 += pc[2 * s];
      s2 += pc[2 * s + 1];
    }
    const float r = __fdiv_rn(sqrtf(d2), sqrtf(s2) + 1e-12f);
    const int f = r > tol ? 1 : 0;
    if (blockIdx.y == 0) {
      rel[cell] = r;
      flags[cell] = f;
      if (f && count != nullptr) atomicAdd(count, 1);
    }
    fired_s = f;
  }
  __syncthreads();
  const float* src = fired_s ? shadow_in : main_in;
  long long base, lo, hi;
  slice_range<V>(c, &base, &lo, &hi);
#pragma unroll 2
  for (long long u = lo + tid; u < hi; u += CELL_THREADS) {
    const long long at = unit_at<V>(c, base, u);
    if constexpr (V == 4)
      *reinterpret_cast<float4*>(out + at) =
          __ldg(reinterpret_cast<const float4*>(src + at));
    else
      out[at] = __ldg(src + at);
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime (no link
// against libcuda); null where it is missing
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  static bool looked = false;
  if (!looked) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
    looked = true;
  }
  return fn;
}

// A 2-D map of a matrix whose inner axis is contiguous: (inner, outer)
// elements of `es` bytes, outer rows `stride` elements apart, boxes of
// (box_inner, box_outer) elements in the given swizzle.  False where the
// TMA cannot take it (unaligned base or stride, no encoder).
bool encode(CUtensorMap* map, const void* base, CUtensorMapDataType type,
            long long es, long long inner, long long outer, long long stride,
            int box_inner, int box_outer, CUtensorMapSwizzle swizzle) {
  if (outer == 1) stride = (inner + 16 / es - 1) / (16 / es) * (16 / es);
  if (!aligned16(base) || (stride * es) % 16 != 0) return false;
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride * es)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the workspace, carved in this order, each piece WS_ALIGN-aligned
// (kernels/razor_matmul.py::LaunchPlan.workspace_bytes computes the same)
struct Workspace {
  int8_t *qa, *qb;
  float *sa, *sb;
  unsigned int *amax_a, *amax_b;
  float *main, *shadow, *partial;
};

long long carve(unsigned char* ws, int M, int N, int Kp, long long cells,
                int slices, Workspace* w) {
  long long off = 0;
  auto take = [&](long long bytes) {
    unsigned char* p = ws + off;
    off += (bytes + WS_ALIGN - 1) / WS_ALIGN * WS_ALIGN;
    return p;
  };
  w->qa = reinterpret_cast<int8_t*>(take((long long)M * Kp));
  w->qb = reinterpret_cast<int8_t*>(take((long long)N * Kp));
  w->sa = reinterpret_cast<float*>(take(4LL * M));
  w->sb = reinterpret_cast<float*>(take(4LL * N));
  w->amax_a = reinterpret_cast<unsigned int*>(take(4LL * M));
  w->amax_b = reinterpret_cast<unsigned int*>(take(4LL * N));
  w->main = reinterpret_cast<float*>(take(4LL * M * N));
  w->shadow = reinterpret_cast<float*>(take(4LL * M * N));
  w->partial = reinterpret_cast<float*>(take(8LL * cells * slices));
  return off;
}

template <typename T>
int launch_product(const void* a_, const void* b_, const Workspace& w,
                   int M, int N, int K, int Kp, long long sa_m,
                   long long sa_k, long long sb_k, long long sb_n,
                   cudaStream_t stream) {
  using L = Tile<T>;
  static bool attrs_set = false;
  if (!attrs_set) {
    const decltype(&razor_product_kernel<T, false>) kernels[] = {
        razor_product_kernel<T, false>, razor_product_kernel<T, true>};
    for (auto kernel : kernels) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM_BYTES);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    attrs_set = true;
  }
  const T* a = static_cast<const T*>(a_);
  const T* b = static_cast<const T*>(b_);
  const CUtensorMapDataType type = sizeof(T) == 2
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const bool kfast = sb_k == 1 && sb_n != 1;
  CUtensorMap map_a = {}, map_b = {}, map_qa = {}, map_qb = {};
  Problem p{M, N, K, (K + BK - 1) / BK, sa_m, sa_k, sb_k, sb_n, 0, 0};
  p.a_tma = (sa_k == 1 || K == 1) &&
            encode(&map_a, a, type, L::ES, K, M, sa_m, L::W, BM,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  p.b_tma = kfast ? encode(&map_b, b, type, L::ES, K, N, sb_n, L::W, BN,
                           CU_TENSOR_MAP_SWIZZLE_128B)
                  : (sb_n == 1 || N == 1) &&
                        encode(&map_b, b, type, L::ES, N, K, sb_k, L::W, BK,
                               CU_TENSOR_MAP_SWIZZLE_128B);
  if (!encode(&map_qa, w.qa, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, Kp, M, Kp,
              QROW, BM, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !encode(&map_qb, w.qb, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, Kp, N, Kp,
              QROW, BN, CU_TENSOR_MAP_SWIZZLE_64B))
    return static_cast<int>(cudaErrorNotSupported);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  if (kfast)
    razor_product_kernel<T, true><<<grid, BLOCK, L::SMEM_BYTES, stream>>>(
        map_a, map_b, map_qa, map_qb, a, b, w.sa, w.sb, w.main, w.shadow, p);
  else
    razor_product_kernel<T, false><<<grid, BLOCK, L::SMEM_BYTES, stream>>>(
        map_a, map_b, map_qa, map_qb, a, b, w.sa, w.sb, w.main, w.shadow, p);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int launch_cells(const Workspace& w, float* c, int* flags, float* rel,
                 int* count, const Cells& cells, int grid_m, float tol,
                 cudaStream_t stream) {
  const dim3 grid(grid_m * cells.grid_n, cells.slices);
  razor_cell_sums_kernel<V><<<grid, CELL_THREADS, 0, stream>>>(
      w.main, w.shadow, w.partial, cells);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  razor_cell_select_kernel<V><<<grid, CELL_THREADS, 0, stream>>>(
      w.main, w.shadow, w.partial, c, flags, rel, count, cells, tol);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One razor_matmul call on `stream`: the quantizations of a and b^T
// (quant_rows_launch), the product pass, the two cell passes.  dtype: 0 =
// float32, 1 = bfloat16 (a and b share it).  Strides in elements.  ws is a
// 16-byte aligned scratch of ws_bytes >= the carve below (LaunchPlan.
// workspace_bytes); slices is LaunchPlan.slices.  count may be null (no
// fused reduction); else it is zeroed on the stream first.  Returns the
// first CUDA error (0 = launched).
extern "C" int razor_matmul_launch(
    const void* a, const void* b, void* ws, long long ws_bytes, void* c,
    void* flags, void* rel, void* count, int M, int N, int K, long long sa_m,
    long long sa_k, long long sb_k, long long sb_n, int block_m, int block_n,
    int slices, float tol, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || block_m <= 0 || block_n <= 0 ||
      M % block_m != 0 || N % block_n != 0 || (N + BN - 1) / BN > 65535 ||
      (long long)(M / block_m) * (N / block_n) > 0x7FFFFFFFLL ||
      slices < 1 || slices > MAX_SLICES || !aligned16(ws) ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int Kp = (K + K_PAD - 1) / K_PAD * K_PAD;
  const int grid_m = M / block_m, grid_n = N / block_n;
  Workspace w;
  if (carve(static_cast<unsigned char*>(ws), M, N, Kp,
            (long long)grid_m * grid_n, slices, &w) > ws_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* ct = static_cast<int*>(count);
  if (ct != nullptr) {
    const cudaError_t e = cudaMemsetAsync(ct, 0, sizeof(int), s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int err = quant_rows_launch(a, M, K, Kp, sa_m, sa_k, 127.0f, dtype,
                              w.amax_a, w.qa, w.sa, stream);
  if (err == 0)
    err = quant_rows_launch(b, N, K, Kp, sb_n, sb_k, 127.0f, dtype, w.amax_b,
                            w.qb, w.sb, stream);
  if (err == 0)
    err = dtype == 0
              ? launch_product<float>(a, b, w, M, N, K, Kp, sa_m, sa_k, sb_k,
                                      sb_n, s)
              : launch_product<__nv_bfloat16>(a, b, w, M, N, K, Kp, sa_m,
                                              sa_k, sb_k, sb_n, s);
  if (err != 0) return err;
  const Cells cells{N, block_m, block_n, grid_n, slices};
  float* cc = static_cast<float*>(c);
  int* fl = static_cast<int*>(flags);
  float* rl = static_cast<float*>(rel);
  if (block_n % 4 == 0 && N % 4 == 0 && aligned16(cc))
    return launch_cells<4>(w, cc, fl, rl, ct, cells, grid_m, tol, s);
  return launch_cells<1>(w, cc, fl, rl, ct, cells, grid_m, tol, s);
}
