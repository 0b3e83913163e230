// The tensor-core product machinery that razor_matmul.cu and
// precision_island.cu share: a 64 x 64 tile of C a block, computed by one
// warpgroup of four MMA warps and fed k-tiles of 64 by one producer warp
// through a ring of STAGES stages in shared memory on two mbarriers (full:
// the stage's bytes have arrived; empty: every MMA warp is done with it), so
// STAGES - 1 tiles are in flight while one is multiplied and no block-wide
// barrier sits in a k loop.
//
//   * Copies: 2-D tensor-map TMA (cp.async.bulk.tensor), one box a lane,
//     completion on the stage's full barrier.  Float tiles are boxes of
//     128-byte rows in the 128-byte swizzle, int8 tiles boxes of 64-byte
//     rows in the 64-byte swizzle: the layouts wgmma's descriptors and
//     ldmatrix read without bank conflicts.  What lies outside a matrix
//     arrives as zeros.  b's box runs along whichever axis of b is
//     contiguous (a transposed view is read in place; wgmma takes the
//     row-major weight's tile as N-major).  The maps are encoded on the host
//     by cuTensorMapEncodeTiled, found through the runtime (no link against
//     libcuda).
//   * An operand the TMA cannot take (a base pointer or a row stride that
//     is not 16-byte aligned: a ragged 96 x 100 x 80 product, b as the view
//     of a (80, 100) tensor) is loaded by the producer warp's lanes into the
//     same swizzled layout: unconditional loads from an address clamped into
//     the matrix, zeroed after.
//   * bf16 operands: warpgroup MMAs (wgmma) reading both operands from
//     shared memory, m64n64k16 bf16 into f32 (a bf16 product is exact in
//     f32) and m64n64k32 int8 into int32 (exact: |sum| <= K * 127^2 <
//     2^31).  f32 operands: mma.sync, a 32 x 32 tile a warp, m16n8k32 int8
//     into int32 and a 3xTF32 split on m16n8k8: x = hi + lo, both rounded to
//     a 10-bit mantissa, each product lo.hi + hi.lo + hi.hi (a single TF32
//     pass keeps 2^-11 of each term, too little for 1e-5 of max|C|).
//
// Each kernel keeps its own stage layout, k loops and epilogue; what is
// here is used by both.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc_ring {

constexpr int BM = 64;          // rows of a block tile
constexpr int BN = 64;          // columns of a block tile
constexpr int BK = 64;          // k of a stage, both operand types
constexpr int THREADS = 128;    // four MMA warps: one warpgroup
constexpr int BLOCK = THREADS + 32;   // and one warp that issues the copies
constexpr int STAGES = 4;       // ring of k-tiles, STAGES - 1 in flight
constexpr int ROW = 128;        // bytes of a float tile row: one swizzle row
constexpr int QROW = BK;        // bytes of an int8 tile row
constexpr int K_PAD = 32;       // the int8 copies' row padding (quant_rows)
constexpr int WS_ALIGN = 256;   // alignment of a workspace's pieces

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
  static_assert(BK == BN && BK % W == 0, "square k-tiles of whole boxes");
  static_assert(A_BOX % 1024 == 0 && (A_BYTES + B_BYTES) % 1024 == 0 &&
                    QA_BYTES % 512 == 0,
                "swizzled boxes start on their swizzle's boundaries");
};

// The operands of one product: a (M, K), b (K, N) by element strides, K
// walked in k_tiles tiles of BK; a_tma / b_tma: the float operand comes by
// TMA (else by the producer's lanes).
struct Problem {
  int M, N, K, k_tiles;
  long long sa_m, sa_k, sb_k, sb_n;
  int a_tma, b_tma;
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
// the ring's base: dynamic shared memory rounded up to the 1024 bytes the
// 128-byte swizzle's boxes start on
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
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

// ---- the ring: the g-th k-tile a block streams (over all its k loops) sits
// in stage g % STAGES, in that stage's (g / STAGES)-th use

// full: the copy issuer's arrival (with the bytes it expects) and, where a
// float tile is loaded by hand, every producer lane's; empty: one arrival
// per MMA warp
__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty,
                                          bool by_hand) {
  for (int s = 0; s < STAGES; ++s) {
    mbar_init(smem_u32(full + s), 1u + (by_hand ? 32u : 0u));
    mbar_init(smem_u32(empty + s), THREADS / 32);
  }
}
// the producer: wait until the MMA warps have handed back tile g's stage
__device__ __forceinline__ void ring_acquire(uint64_t* empty, int g) {
  if (g >= STAGES)
    mbar_wait(smem_u32(empty + g % STAGES), ((g / STAGES) + 1) & 1);
}
// the producer's lane 0 announces the bytes the stage's copies will bring
__device__ __forceinline__ void stage_open(uint32_t bar, uint32_t tx_bytes,
                                           int lane) {
  if (lane == 0) {
    fence_proxy_async();        // the stage's last reads came before
    mbar_arrive_expect_tx(bar, tx_bytes);
  }
  __syncwarp();
}
// after tiles loaded by hand: the stores, seen by the tensor cores' reads
// (async proxy), then every lane's arrival
__device__ __forceinline__ void stage_close_by_hand(uint32_t bar) {
  fence_proxy_async();
  mbar_arrive(bar);
}
// an MMA warp: wait for tile g, and hand its stage back
__device__ __forceinline__ void ring_wait(uint64_t* full, int g) {
  mbar_wait(smem_u32(full + g % STAGES), (g / STAGES) & 1);
}
__device__ __forceinline__ void ring_release(uint64_t* empty, int g,
                                             int lane) {
  __syncwarp();                 // the warp's reads of the stage are done
  if (lane == 0) mbar_arrive(smem_u32(empty + g % STAGES));
}

// ---- the producer's copies of one k-tile at k0 for the tile (row0, col0)

// float tiles by TMA: a's boxes on lanes 0.., b's on lanes 2..
template <typename T, bool KFAST>
__device__ __forceinline__ void tma_float_tiles(
    int lane, unsigned char* As, unsigned char* Bs, const CUtensorMap* map_a,
    const CUtensorMap* map_b, uint32_t bar, const Problem& p, int k0,
    int row0, int col0) {
  using L = Tile<T>;
  if (p.a_tma && lane < L::BOXES)
    tma_load(smem_u32(As + lane * L::A_BOX), map_a, bar, k0 + lane * L::W,
             row0);
  if (p.b_tma && lane >= 2 && lane < 2 + L::BOXES) {
    const int j = lane - 2;
    if (KFAST)
      tma_load(smem_u32(Bs + j * L::B_BOX), map_b, bar, k0 + j * L::W, col0);
    else
      tma_load(smem_u32(Bs + j * L::B_BOX), map_b, bar, col0 + j * L::W, k0);
  }
}
// the int8 copies' tiles by TMA, on lanes `lane0` and `lane0 + 1`
__device__ __forceinline__ void tma_int_tiles(
    int lane, int lane0, unsigned char* Qa, unsigned char* Qb,
    const CUtensorMap* map_qa, const CUtensorMap* map_qb, uint32_t bar,
    int k0, int row0, int col0) {
  if (lane == lane0) tma_load(smem_u32(Qa), map_qa, bar, k0, row0);
  if (lane == lane0 + 1) tma_load(smem_u32(Qb), map_qb, bar, k0, col0);
}
// the float tiles the TMA cannot take, by the warp's lanes
template <typename T, bool KFAST>
__device__ __forceinline__ void float_tiles_by_hand(
    int lane, unsigned char* As, unsigned char* Bs, const T* a, const T* b,
    const Problem& p, int k0, int row0, int col0) {
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
}

// ---- tensor cores, warp-level (mma.sync): the f32 operands' path
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

// ---- tensor cores, warpgroup-level (wgmma): the bf16 operands' path.
// Operands are read from shared memory through 64-bit descriptors: start
// address, stride between 8-row groups (SBO), swizzle (1 = 128-byte, 2 =
// 64-byte).
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

// ---- one k-tile's products.  bf16: issued on the warpgroup (the caller
// fences, commits and waits); f32: a 32 x 32 tile of warp (wr, wc) by
// mma.sync.

// the float tiles' four k16 steps into a fresh sum t.  a, and b when K is
// its contiguous axis: 64 rows of 128 bytes, a k16 step 32 bytes along the
// row; b with N contiguous: 64 k-rows of 128 bytes (N-major), a k16 step 16
// rows down.  Groups of 8 rows 1024 bytes apart.
template <bool KFAST>
__device__ __forceinline__ void issue_bf16_tile(const unsigned char* As,
                                                const unsigned char* Bs,
                                                float (&t)[32]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_bf16<KFAST ? 0 : 1>(
        t, smem_desc(As + 32 * kk, 1024, 1),
        smem_desc(Bs + (KFAST ? 32 * kk : 2048 * kk), 1024, 1), kk > 0);
}
// the int8 tiles' two k32 steps into iacc; 64-byte rows, groups 512 apart
__device__ __forceinline__ void issue_s8_tile(const unsigned char* Qa,
                                              const unsigned char* Qb,
                                              int (&iacc)[32]) {
#pragma unroll
  for (int kk = 0; kk < QROW / 32; ++kk)
    wgmma_s8(iacc, smem_desc(Qa + 32 * kk, 512, 2),
             smem_desc(Qb + 32 * kk, 512, 2));
}

// the float tiles' 3xTF32 products into t
template <bool KFAST>
__device__ __forceinline__ void tf32_tile(const unsigned char* As,
                                          const unsigned char* Bs,
                                          float (&t)[32], int wr, int wc,
                                          int lane) {
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
}
// the int8 tiles' products into iacc
__device__ __forceinline__ void s8_tile(const unsigned char* Qa,
                                        const unsigned char* Qb,
                                        int (&iacc)[32], int wr, int wc,
                                        int lane) {
  const int q = lane >> 3, r8 = lane & 7;
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

// The oracle's dequantization, in its order: (float(acc) * sa) * sb.
__device__ __forceinline__ float dequant(int acc, float sa, float sb) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), sa), sb);
}

// A consumer thread's 32 sums, as 8 fragments of 4: element e of fragment f
// lies at row frag_row(f) + 8 (e / 2), column frag_col(f) + e % 2.  bf16
// (one wgmma warpgroup, m64n64): warp w holds rows 16w + l / 4 (+ 8) and
// fragment f columns 8f + 2 (l % 4).  f32 (mma.sync, a 32 x 32 tile a
// warp): fragment f = 4 mi + nj at rows 32 (w % 2) + 16 mi + l / 4, columns
// 32 (w / 2) + 8 nj + 2 (l % 4).
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

// ---- host: tensor maps

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
inline EncodeTiled encoder() {
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
inline bool encode(CUtensorMap* map, const void* base,
                   CUtensorMapDataType type, long long es, long long inner,
                   long long outer, long long stride, int box_inner,
                   int box_outer, CUtensorMapSwizzle swizzle) {
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

// b's contiguous axis is K (b is the transposed view of an (N, K) tensor)
inline bool b_kfast(long long sb_k, long long sb_n) {
  return sb_k == 1 && sb_n != 1;
}

// The problem of an (M, K) @ (K, N) product and the float operands' maps,
// where the TMA can take them
template <typename T>
Problem float_maps(CUtensorMap* map_a, CUtensorMap* map_b, const T* a,
                   const T* b, int M, int N, int K, long long sa_m,
                   long long sa_k, long long sb_k, long long sb_n) {
  using L = Tile<T>;
  const CUtensorMapDataType type = sizeof(T) == 2
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  Problem p{M, N, K, (K + BK - 1) / BK, sa_m, sa_k, sb_k, sb_n, 0, 0};
  p.a_tma = (sa_k == 1 || K == 1) &&
            encode(map_a, a, type, L::ES, K, M, sa_m, L::W, BM,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  p.b_tma = b_kfast(sb_k, sb_n)
                ? encode(map_b, b, type, L::ES, K, N, sb_n, L::W, BN,
                         CU_TENSOR_MAP_SWIZZLE_128B)
                : (sb_n == 1 || N == 1) &&
                      encode(map_b, b, type, L::ES, N, K, sb_k, L::W, BK,
                             CU_TENSOR_MAP_SWIZZLE_128B);
  return p;
}

// the map of an int8 copy, (rows, Kp) contiguous, in boxes of (64, 64)
inline bool int_map(CUtensorMap* map, const int8_t* q, int rows, int Kp) {
  return encode(map, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, Kp, rows, Kp, QROW,
                BM, CU_TENSOR_MAP_SWIZZLE_64B);
}

}  // namespace tc_ring
