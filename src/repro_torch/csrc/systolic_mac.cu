// systolic_mac for NVIDIA Hopper (sm_90a): voltage-island partitioned matmul
// with timing-fault corruption and Razor flags.
//
// Replaces the Pallas kernel src/repro/kernels/systolic_mac.py::_kernel.
//
//   C = a @ b, f32 accumulate over K.  The output is cut into a grid of
//   (block_m x block_n) partition cells; cell (i, j) carries a rail voltage
//   v_map[i, j] and a minimum safe voltage v_safe[i, j].  A cell with
//   v_map < v_safe fails timing: the low (23 - keep_bits) mantissa bits of
//   its f32 result are masked off and its Razor flag is raised.
//
// How it differs from the kernel it replaces:
//   * There the K axis is a sequential grid dimension with the accumulator in
//     scratch memory and the fired count carried from cell to cell.  Here K
//     is cut into splits that run as the blocks of one thread-block cluster;
//     the splits' partial tiles are summed through the cluster's distributed
//     shared memory, and the count is an integer atomicAdd (exact).
//   * The partition cell is not the launch tile.  block_m / block_n are
//     arguments (1x1 cells occur on the serving path); the epilogue looks up
//     v_map[row / block_m, col / block_n] per element, and the thread that
//     owns a cell's top-left element writes that cell's flag.
//   * a and b are addressed through element strides, so a transposed view of
//     a weight (the tied unembedding) is read in place, never copied.
//   * Ragged M, N, K and unaligned operands are handled here; nothing is
//     padded or copied by the caller.
//
// What bounds it on this card.  Every served GEMM has M = 1..16 rows against
// a (K, N) weight: the bytes of b (K * N * 2 in bf16) bound it, about 1 us
// of memory latency has to be covered by some 3.4 MB in flight across the
// 132 SMs, and one block streams only a fraction of the card's rate, so a
// decode GEMM needs most SMs busy.  At large M (a prefill's thousands of
// rows, a train step's 512) it is the tensor cores (bf16) or the f32 FMA
// rate (f32).  Two forms of one kernel: the 16-row form below (every f32
// call, bf16 at small M), and the wide form for bf16 at large M (128-row
// tiles, see wide_tile), chosen before the launch by the wrapper
// (kernels/systolic_mac.py::launch_rows).  The 16-row form's design:
//   * Split-K across the blocks of a cluster (a power of two, at most 16),
//     chosen from K, N and the type alone (kernels/systolic_mac.py::
//     launch_plan): about one block per SM at N <= 8192, no split for the
//     logits.
//   * a and b stream through a ring of STAGES shared-memory tiles filled by
//     the Tensor Memory Accelerator: one 2-D tensor-map copy per 128-byte-row
//     box.  One producer warp issues the copies (one box a lane) as stages
//     come free; four MMA warps wait for a stage to be full and hand it back
//     (an mbarrier each way), so no block-wide barrier sits in the loop and
//     a tile's copies are in flight while the previous ones are multiplied.  The boxes run along b's
//     contiguous axis (N for a row-major weight, K for the transposed view),
//     in the 128-byte swizzle, so ldmatrix reads them without bank conflicts;
//     what lies outside the matrices (ragged M, N, K) arrives as zeros.
//   * bf16 runs on the tensor cores: mma.sync m16n8k16 (f32 accumulate) fed
//     by ldmatrix, one instruction at every M (rows padded to 16).  f32 stays
//     on the CUDA cores with fmaf, no TF32.
//   * Each split leaves its partial tile in its own shared memory; after a
//     cluster barrier every block sums a slice of the tile over all splits
//     (ld.shared::cluster) and applies the epilogue to it: no workspace in
//     device memory, no fence or semaphore.  The producer warp looks up the
//     slice's rails once its copies are issued, off the MMA warps' path.
//   * An operand the TMA cannot take (a base pointer or a row stride that is
//     not 16-byte aligned) is loaded by the threads into the same swizzled
//     layout: unconditional loads from an address clamped into the matrix,
//     zeroed after (a load under a branch is not moved past it).

// Numerical contracts:
//   1. One summation order per (K, N, dtype), never a function of M, so a
//      row's result does not depend on how many rows share the call (nor on
//      the form that runs it: both forms sum in this order).  The
//      splits come from K, N and dtype; split s sums k-tiles
//      [s * k_tiles / splits, (s + 1) * k_tiles / splits) in ascending order;
//      bf16 sums each 64-deep k-tile as four MMAs into a fresh fragment and
//      adds that into the f32 register sum (an MMA element depends only on
//      its own row and column); f32 is one fmaf chain in ascending k; the
//      splits' partials are added in split order 0, 1, ..., splits - 1.
//   2. Deterministic: no float atomics.  The mask, flag and count are applied
//      after the whole sum, by one writer per element.
//   3. Held to 1e-5 x max|C| against the plain f32 product (chip_smoke.py),
//      K = 10240 included: the per-tile f32 register sum keeps the tensor
//      core's own accumulation to 64 products at a time.
//   A row's rail bits and flags come from the cells it lies in, never from
//   the launch tile, so they hold at every M too.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 16;        // rows of a block: one m16 MMA fragment
constexpr int BN = 128;       // columns of a block: 4 warps x 32
constexpr int THREADS = 128;  // the four MMA warps
constexpr int BLOCK = THREADS + 32;   // and one warp that issues the copies
constexpr int STAGES = 4;     // ring of k-tiles, STAGES - 1 in flight
constexpr int MAX_SPLITS = 16;  // blocks of a cluster (non-portable size)
constexpr int RED_LD = BN + 4;  // row of a partial tile, in floats
constexpr int ROW = 128;        // bytes of a tile row: one swizzle row

// Every tile in shared memory is made of boxes of 128-byte rows in the TMA's
// 128-byte swizzle: the 16-byte chunk c of row r sits at chunk c ^ (r % 8),
// so the 8 rows an ldmatrix phase reads fall in 8 distinct bank groups.
template <typename T>
struct Tile {
  static constexpr int ES = static_cast<int>(sizeof(T));
  static constexpr int BK = ROW / ES;            // k-tile: 64 bf16, 32 f32
  static constexpr int W = ROW / ES;             // columns of a KN box
  static constexpr int A_BYTES = BM * ROW;       // a tile [BM][BK]
  static constexpr int B_BYTES = BN * ROW;       // b tile, either layout:
  // KN: BN / W boxes of [BK][W] (BK rows of 128 B each); NK: one [BN][BK]
  static constexpr int KN_BOX = BK * ROW;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + align
  static constexpr int A_SCALAR = BM * BK / 32;     // a lane's, by hand
  static constexpr int B_SCALAR = BK * BN / 32;
  static_assert(BK * ES == ROW && BN % W == 0, "tile rows");
  static_assert(STAGE_BYTES % 1024 == 0 && A_BYTES % 1024 == 0 &&
                    KN_BOX % 1024 == 0,
                "swizzled boxes start on 1024-byte boundaries");
  static_assert(BM * RED_LD * 4 <= STAGE_BYTES, "partial tile fits a stage");
};

// byte offset of byte `b` of row `r` in a box of swizzled 128-byte rows
__device__ __forceinline__ uint32_t swz(int r, int b) {
  return r * ROW + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
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

// ---- the cluster: barrier and distributed shared memory
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ float cluster_load(uint32_t addr, uint32_t rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(remote)
               : "memory");
  return v;
}

// a fired cell into the call's count (null: no count), the only atomic
__device__ __forceinline__ void count_fired(int* count) {
  if (count != nullptr) atomicAdd(count, 1);
}

// ---- tensor cores
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col), f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Which of a block's BM x BN sums a thread accumulates: element e of 16.
// bf16 follows the MMA accumulator layout (warp w holds columns w*32..+31 as
// four n8 fragments; lane l holds rows l/4 and l/4 + 8, columns 2*(l%4) and
// +1 of each); f32 gives thread t column t and all 16 rows.
template <typename T>
__device__ __forceinline__ int elem_row(int tid, int e) {
  if (sizeof(T) == 2) return ((tid & 31) >> 2) + ((e & 2) ? 8 : 0);
  return e;
}
template <typename T>
__device__ __forceinline__ int elem_col(int tid, int e) {
  if (sizeof(T) == 2)
    return (tid >> 5) * 32 + (e >> 2) * 8 + 2 * (tid & 3) + (e & 1);
  return tid;
}

// The 16-row form, one block a (16-row, 128-column, split) tile.
// KFAST: b's contiguous axis is K (the transposed view), else N
template <typename T, bool KFAST>
__device__ __forceinline__ void row16_tile(
    const CUtensorMap& map_a, const CUtensorMap& map_b,
    const T* __restrict__ a, const T* __restrict__ b,
    const float* __restrict__ v_map, const float* __restrict__ v_safe,
    float* __restrict__ c, int* __restrict__ flags, int* __restrict__ count,
    int N, int K, int row_base, int m_rows, long long sa_m, long long sa_k,
    long long sb_k, long long sb_n, int block_m, int block_n, int grid_n,
    unsigned int keep_mask, int splits, int k_tiles, int a_tma, int b_tma) {
  using L = Tile<T>;
  constexpr int BK = L::BK;
  constexpr int ES = L::ES;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ bool fails[BM * BN];              // the slice's rail verdicts
  // swizzled boxes need 1024-byte alignment (SMEM_BYTES has the slack)
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int tid = threadIdx.x;
  const bool producer = tid >= THREADS;
  const int split = blockIdx.y;                // = rank in the cluster
  const int col0 = blockIdx.x * BN;
  const int row0 = row_base + blockIdx.z * BM;   // first row, in C
  const int row_end = row_base + m_rows;
  const int rows_valid = min(BM, row_end - row0);
  const int cols_valid = min(BN, N - col0);
  const int t_lo = static_cast<int>((long long)split * k_tiles / splits);
  const int t_hi = static_cast<int>((long long)(split + 1) * k_tiles / splits);
  const int nt = t_hi - t_lo;
  const bool by_hand = !a_tma || !b_tma;

  if (tid == 0) {
    // a stage is full when the copy issuer has arrived (with the bytes it
    // expects) and, where some of the tile is loaded by hand, every lane of
    // the producer warp; it is empty again when every MMA warp is done
    const uint32_t arrivals = ((a_tma || b_tma) ? 1u : 0u) + (by_hand ? 32u : 0u);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(full + s), arrivals);
      mbar_init(smem_u32(empty + s), THREADS / 32);
    }
  }
  __syncthreads();

  // the producer warp fills a stage: lane 0 issues the TMA copies, and
  // every lane loads by hand what the TMA cannot take
  auto load_stage = [&](int stage, int kt, int lane) {
    unsigned char* As = smem + stage * L::STAGE_BYTES;
    unsigned char* Bs = As + L::A_BYTES;
    const uint32_t bar = smem_u32(full + stage);
    const int k0 = kt * BK;
    if (a_tma || b_tma) {
      if (lane == 0) {
        fence_proxy_async();        // the stage's last reads came before
        mbar_arrive_expect_tx(bar, (a_tma ? L::A_BYTES : 0) +
                                       (b_tma ? L::B_BYTES : 0));
      }
      __syncwarp();
      // one box a lane, issued together: lane 0 a's, lanes 1.. b's
      constexpr int B_BOXES = KFAST ? 1 : BN / L::W;
      if (a_tma && lane == 0) tma_load(smem_u32(As), &map_a, bar, k0, row0);
      if (b_tma && lane >= 1 && lane <= B_BOXES) {
        const int j = lane - 1;
        if (KFAST)
          tma_load(smem_u32(Bs), &map_b, bar, k0, col0);
        else
          tma_load(smem_u32(Bs + j * L::KN_BOX), &map_b, bar,
                   col0 + j * L::W, k0);
      }
    }
    if (!by_hand) return;
    if (!a_tma) {
#pragma unroll 8
      for (int p = 0; p < L::A_SCALAR; ++p) {
        const int idx = lane + p * 32;
        const int r = idx / BK, kc = idx % BK;
        const int row = row0 + r, k = k0 + kc;
        const T v = a[(long long)min(row, row_end - 1) * sa_m +
                      (long long)min(k, K - 1) * sa_k];
        *reinterpret_cast<T*>(As + swz(r, kc * ES)) =
            (row < row_end && k < K) ? v : zero_of<T>();
      }
    }
    if (!b_tma) {
#pragma unroll 8
      for (int p = 0; p < L::B_SCALAR; ++p) {
        const int idx = lane + p * 32;
        // neighbouring lanes walk b's contiguous axis
        const int kr = KFAST ? idx % BK : idx / BN;
        const int nr = KFAST ? idx / BK : idx % BN;
        const int k = k0 + kr, n = col0 + nr;
        const T v = b[(long long)min(k, K - 1) * sb_k +
                      (long long)min(n, N - 1) * sb_n];
        const uint32_t at =
            KFAST ? swz(nr, kr * ES)
                        : (nr / L::W) * L::KN_BOX + swz(kr, (nr % L::W) * ES);
        *reinterpret_cast<T*>(Bs + at) = (k < K && n < N) ? v : zero_of<T>();
      }
    }
    mbar_arrive(bar);               // release: the stores above are seen
  };

  float acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0.0f;

  const int lane = tid & 31, warp = tid >> 5;
  const int q = lane >> 3, r8 = lane & 7;

  auto compute_stage = [&](int stage) {
    const unsigned char* As = smem + stage * L::STAGE_BYTES;
    const unsigned char* Bs = As + L::A_BYTES;
    if constexpr (ES == 2) {
      float tacc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) tacc[j][x] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t af[4];
        ldsm_x4(af, As + swz(r8 + (q & 1) * 8, (kk + (q >> 1) * 8) * 2));
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          const int n0 = warp * 32 + jp * 16;
          uint32_t bf[4];
          if constexpr (KFAST) {
            ldsm_x4(bf, Bs + swz(n0 + r8 + (q >> 1) * 8,
                                 (kk + (q & 1) * 8) * 2));
          } else {
            const int n = n0 + (q >> 1) * 8;
            ldsm_x4_trans(bf, Bs + (n / L::W) * L::KN_BOX +
                                  swz(kk + r8 + (q & 1) * 8, (n % L::W) * 2));
          }
          mma_bf16(tacc[2 * jp], af, bf[0], bf[1]);
          mma_bf16(tacc[2 * jp + 1], af, bf[2], bf[3]);
        }
      }
      // the k-tile's sum into the f32 register sum, in one fixed order
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] += tacc[e >> 2][e & 3];
    } else {
      const unsigned char* Bcol =
          KFAST ? Bs : Bs + (tid / L::W) * L::KN_BOX;
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        const float bv = *reinterpret_cast<const float*>(
            Bcol + (KFAST ? swz(tid, kk * 4) : swz(kk, (tid % L::W) * 4)));
#pragma unroll
        for (int r = 0; r < 16; ++r)
          acc[r] = fmaf(*reinterpret_cast<const float*>(As + swz(r, kk * 4)),
                        bv, acc[r]);
      }
    }
  };

  // this block's slice of the tile for the epilogue
  const int n_valid = rows_valid * cols_valid;
  const int lo = static_cast<int>((long long)split * n_valid / splits);
  const int hi = static_cast<int>((long long)(split + 1) * n_valid / splits);

  // ---- the split's k-tiles through the ring: the producer warp refills a
  // stage as soon as the MMA warps are done with it
  if (producer) {
    const int lane = tid - THREADS;
    for (int i = 0; i < nt; ++i) {
      const int s = i % STAGES;
      if (i >= STAGES) mbar_wait(smem_u32(empty + s), ((i / STAGES) + 1) & 1);
      load_stage(s, t_lo + i, lane);
    }
    // with its copies issued, the warp looks up the slice's rails while the
    // MMA warps finish: whether each element's cell fails timing
    for (int idx = lo + lane; idx < hi; idx += 32) {
      const int row = row0 + idx / cols_valid, col = col0 + idx % cols_valid;
      const long long cell =
          (long long)(row / block_m) * grid_n + col / block_n;
      fails[idx - lo] = v_map[cell] < v_safe[cell];
    }
  } else {
    for (int i = 0; i < nt; ++i) {
      const int s = i % STAGES;
      mbar_wait(smem_u32(full + s), (i / STAGES) & 1);
      compute_stage(s);
      __syncwarp();                 // the warp's reads of the stage are done
      if ((tid & 31) == 0) mbar_arrive(smem_u32(empty + s));
    }
  }

  // ---- partial tile to shared memory; the splits summed in split order
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  if (!producer) {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      red[elem_row<T>(tid, e) * RED_LD + elem_col<T>(tid, e)] = acc[e];
  }
  if (splits > 1)
    cluster_sync();
  else
    __syncthreads();

  // ---- epilogue on the slice: rail bits, bit-cast + mask, flags, count
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int idx = lo + tid + j * THREADS;
    if (producer || idx >= hi) break;
    const int r = idx / cols_valid, cc = idx % cols_valid;
    float v;
    if (splits == 1) {
      v = red[r * RED_LD + cc];
    } else {
      const uint32_t addr = smem_u32(red + r * RED_LD + cc);
      float part[MAX_SPLITS];
#pragma unroll
      for (int s = 0; s < MAX_SPLITS; ++s)
        part[s] = s < splits ? cluster_load(addr, s) : 0.0f;
      v = part[0];
#pragma unroll
      for (int s = 1; s < MAX_SPLITS; ++s)
        if (s < splits) v += part[s];
    }
    const int row = row0 + r, col = col0 + cc;
    const int cell_i = row / block_m, cell_j = col / block_n;
    const bool fail = fails[idx - lo];
    if (fail) v = __uint_as_float(__float_as_uint(v) & keep_mask);
    c[(long long)row * N + col] = v;
    if (row == cell_i * block_m && col == cell_j * block_n) {
      flags[(long long)cell_i * grid_n + cell_j] = fail ? 1 : 0;
      if (fail) count_fired(count);
    }
  }
  // no block leaves while another may still read its partial tile
  if (splits > 1) cluster_sync();
}

// ---- the wide form: bf16 at large M (prefill, the train step)
//
// One block a 128 x 128 output tile, every split of the plan walked in turn
// by the block itself: one ring of 64-deep k-tiles filled by one producer
// warp (a's box of 128 rows, b's boxes as the 16-row form's), eight MMA
// warps of 32 rows x 64 columns.  Each weight tile is streamed M / 128 times
// instead of M / 16, and no cluster is needed: at these M the (row, column)
// tiles alone fill the card.  Every element is summed as the 16-row form
// sums it: per k-tile four mma.sync into a fresh fragment (at the same
// place in the m16n8k16 fragment: a warp's rows and columns start on
// multiples of 16 and 8), added into the split's f32 register sum; the
// splits' sums in split order, `total = S0; total += S1; ...`, the total
// in shared memory (nine warps leave a thread 168 registers: the split's
// sum, a k-tile's fragments and its fresh MMA sums fill them).
constexpr int WM = 128;                  // rows of a wide block
constexpr int W_THREADS = 256;           // eight MMA warps: 4 (rows) x 2
constexpr int W_BLOCK = W_THREADS + 32;  // and one warp that issues copies
constexpr int W_STAGES = 5;              // ring of k-tiles
constexpr int W_RED_LD = BN + 8;         // row of the finished tile, in
                                         // floats: float2 stores conflict-free
constexpr int W_A_BYTES = WM * ROW;      // a tile [WM][64]
constexpr int W_STAGE_BYTES = W_A_BYTES + BN * ROW;
constexpr int W_TOTAL_BYTES = WM * BN * 4;   // the splits' total, f32
constexpr int W_SMEM_BYTES =
    W_STAGES * W_STAGE_BYTES + W_TOTAL_BYTES + 1024;   // + align
static_assert(WM * W_RED_LD * 4 <= W_STAGES * W_STAGE_BYTES,
              "the finished tile fits over the ring");
static_assert(W_SMEM_BYTES <= 232448, "a block's shared memory");

template <bool KFAST>
__device__ __forceinline__ void wide_tile(
    const CUtensorMap& map_a, const CUtensorMap& map_b,
    const float* __restrict__ v_map, const float* __restrict__ v_safe,
    float* __restrict__ c, int* __restrict__ flags, int* __restrict__ count,
    int M, int N, int block_m, int block_n, int grid_n,
    unsigned int keep_mask, int splits, int k_tiles) {
  using L = Tile<__nv_bfloat16>;
  constexpr int BK = L::BK;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[W_STAGES], empty[W_STAGES];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * WM;    // row tiles run fastest: a wave of
  const int col0 = blockIdx.y * BN;    // blocks shares its weight tiles
  const int rows_valid = min(WM, M - row0);
  const int cols_valid = min(BN, N - col0);

  if (tid == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), W_THREADS / 32);
    }
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
  // the split's sum: [16-row piece][n8 fragment][fragment element]
  float acc[2][8][4];
  // the earlier splits' total: a thread's fragment (mi, nj) at [mi, nj][t]
  float4* total = reinterpret_cast<float4*>(smem + W_STAGES * W_STAGE_BYTES);
  if (tid >= W_THREADS) {
    // the producer warp: every k-tile of every split, in order
    constexpr int B_BOXES = KFAST ? 1 : BN / L::W;
    for (int i = 0; i < k_tiles; ++i) {
      const int s = i % W_STAGES;
      if (i >= W_STAGES)
        mbar_wait(smem_u32(empty + s), ((i / W_STAGES) + 1) & 1);
      unsigned char* As = smem + s * W_STAGE_BYTES;
      unsigned char* Bs = As + W_A_BYTES;
      const uint32_t bar = smem_u32(full + s);
      const int k0 = i * BK;
      if (lane == 0) {
        fence_proxy_async();        // the stage's last reads came before
        mbar_arrive_expect_tx(bar, W_STAGE_BYTES);
        tma_load(smem_u32(As), &map_a, bar, k0, row0);
      }
      __syncwarp();
      if (lane >= 1 && lane <= B_BOXES) {
        const int j = lane - 1;
        if (KFAST)
          tma_load(smem_u32(Bs), &map_b, bar, k0, col0);
        else
          tma_load(smem_u32(Bs + j * L::KN_BOX), &map_b, bar,
                   col0 + j * L::W, k0);
      }
    }
  } else {
    const int q = lane >> 3, r8 = lane & 7;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 8; ++nj)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[mi][nj][x] = 0.0f;
    int split = 0;
    int t_hi = static_cast<int>((long long)k_tiles / splits);
    for (int i = 0; i < k_tiles; ++i) {
      const int s = i % W_STAGES;
      mbar_wait(smem_u32(full + s), (i / W_STAGES) & 1);
      const unsigned char* As = smem + s * W_STAGE_BYTES;
      const unsigned char* Bs = As + W_A_BYTES;
      // a's fragments of the whole k-tile: [16-deep step][16-row piece]
      uint32_t af[4][2][4];
#pragma unroll
      for (int kq = 0; kq < 4; ++kq)
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldsm_x4(af[kq][mi], As + swz(wm + mi * 16 + r8 + (q & 1) * 8,
                                       (kq * 16 + (q >> 1) * 8) * 2));
      // two groups of four n8 pieces: eight independent MMA chains a warp
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        // the k-tile's four MMAs into a fresh fragment, in ascending k
        float tacc[2][4][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int x = 0; x < 4; ++x) tacc[mi][j][x] = 0.0f;
#pragma unroll
        for (int kq = 0; kq < 4; ++kq) {
          const int kk = kq * 16;
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {
            // b's fragments of two n8 pieces, as the 16-row form reads them
            const int n0 = wn + g * 32 + jp * 16;
            uint32_t bf[4];
            if constexpr (KFAST) {
              ldsm_x4(bf, Bs + swz(n0 + r8 + (q >> 1) * 8,
                                   (kk + (q & 1) * 8) * 2));
            } else {
              const int n = n0 + (q >> 1) * 8;
              ldsm_x4_trans(bf, Bs + (n / L::W) * L::KN_BOX +
                                    swz(kk + r8 + (q & 1) * 8,
                                        (n % L::W) * 2));
            }
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              mma_bf16(tacc[mi][2 * jp], af[kq][mi], bf[0], bf[1]);
              mma_bf16(tacc[mi][2 * jp + 1], af[kq][mi], bf[2], bf[3]);
            }
          }
        }
        // the k-tile's sum into the split's f32 register sum
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int x = 0; x < 4; ++x)
              acc[mi][g * 4 + j][x] += tacc[mi][j][x];
      }
      __syncwarp();                 // the warp's reads of the stage are done
      if (lane == 0) mbar_arrive(smem_u32(empty + s));
      if (i + 1 == t_hi && t_hi < k_tiles) {
        // a split ends that is not the last: total = S0, total += S1, ...
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int nj = 0; nj < 8; ++nj) {
            float4* t = total + (mi * 8 + nj) * W_THREADS + tid;
            float* f = acc[mi][nj];
            *t = split == 0 ? make_float4(f[0], f[1], f[2], f[3])
                            : make_float4(t->x + f[0], t->y + f[1],
                                          t->z + f[2], t->w + f[3]);
#pragma unroll
            for (int x = 0; x < 4; ++x) f[x] = 0.0f;
          }
        ++split;
        t_hi = static_cast<int>((long long)(split + 1) * k_tiles / splits);
      }
    }
  }

  // ---- the finished tile to shared memory, over the ring (all consumed):
  // the last split's sum, added to the total where there are splits
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  if (tid < W_THREADS) {
    if (splits > 1) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < 8; ++nj) {
          const float4 t = total[(mi * 8 + nj) * W_THREADS + tid];
          float* f = acc[mi][nj];
          f[0] = t.x + f[0];
          f[1] = t.y + f[1];
          f[2] = t.z + f[2];
          f[3] = t.w + f[3];
        }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 8; ++nj) {
        const int r = wm + mi * 16 + (lane >> 2);
        const int cc = wn + nj * 8 + 2 * (lane & 3);
        *reinterpret_cast<float2*>(red + r * W_RED_LD + cc) =
            make_float2(acc[mi][nj][0], acc[mi][nj][1]);
        *reinterpret_cast<float2*>(red + (r + 8) * W_RED_LD + cc) =
            make_float2(acc[mi][nj][2], acc[mi][nj][3]);
      }
  }
  __syncthreads();

  // ---- epilogue: a thread keeps one column and walks every other row,
  // looking the rails up again only where a row enters another cell
  const int cc = tid % BN;
  if (tid >= W_THREADS || cc >= cols_valid) return;
  const int col = col0 + cc;
  const int cell_j = col / block_n;
  const bool first_col = col == cell_j * block_n;
  long long edge = 0, cell = 0;     // the first row looks its cell up
  int cell_top = 0;
  bool fail = false;
  for (int r = tid / BN; r < rows_valid; r += W_THREADS / BN) {
    const int row = row0 + r;
    if (row >= edge) {
      const int cell_i = row / block_m;
      cell_top = cell_i * block_m;
      edge = (long long)cell_top + block_m;
      cell = (long long)cell_i * grid_n + cell_j;
      fail = v_map[cell] < v_safe[cell];
    }
    float v = red[r * W_RED_LD + cc];
    if (fail) v = __uint_as_float(__float_as_uint(v) & keep_mask);
    c[(long long)row * N + col] = v;
    if (first_col && row == cell_top) {
      flags[cell] = fail ? 1 : 0;
      if (fail) count_fired(count);
    }
  }
}

// One kernel name for both forms (the profiler reads B1's rows by it):
// ROWS = BM is the 16-row form, ROWS = WM the wide form (bf16 only).
template <typename T, bool KFAST, int ROWS>
__global__ void __launch_bounds__(ROWS == BM ? BLOCK : W_BLOCK)
systolic_mac_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b,
                    const T* __restrict__ a, const T* __restrict__ b,
                    const float* __restrict__ v_map,
                    const float* __restrict__ v_safe, float* __restrict__ c,
                    int* __restrict__ flags, int* __restrict__ count, int N,
                    int K, int row_base, int m_rows, long long sa_m,
                    long long sa_k, long long sb_k, long long sb_n,
                    int block_m, int block_n, int grid_n,
                    unsigned int keep_mask, int splits, int k_tiles,
                    int a_tma, int b_tma) {
  if constexpr (ROWS == BM) {
    row16_tile<T, KFAST>(map_a, map_b, a, b, v_map, v_safe, c, flags, count,
                         N, K, row_base, m_rows, sa_m, sa_k, sb_k, sb_n,
                         block_m, block_n, grid_n, keep_mask, splits,
                         k_tiles, a_tma, b_tma);
  } else {
    static_assert(ROWS == WM && sizeof(T) == 2, "the wide form is bf16");
    wide_tile<KFAST>(map_a, map_b, v_map, v_safe, c, flags, count, m_rows, N,
                     block_m, block_n, grid_n, keep_mask, splits, k_tiles);
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
// elements, outer rows `stride` elements apart, boxes of 128-byte rows in
// the 128-byte swizzle.  False where the TMA cannot take it (unaligned base
// or stride): the kernel then loads that operand by hand.
template <typename T>
bool encode(CUtensorMap* map, const T* base, long long inner, long long outer,
            long long stride, int box_inner, int box_outer) {
  const long long es = static_cast<long long>(sizeof(T));
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
  return fn(map,
            sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            2, const_cast<T*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The kernel's launch attributes (dynamic shared memory, cluster size), set
// once a device
template <typename T>
cudaError_t set_attributes() {
  static uint64_t done = 0;         // a bit a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (bit != 0 && (done & bit)) return cudaSuccess;
  using Kernel = decltype(&systolic_mac_kernel<T, false, BM>);
  const Kernel row16[] = {systolic_mac_kernel<T, false, BM>,
                          systolic_mac_kernel<T, true, BM>};
  for (auto kernel : row16) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Tile<T>::SMEM_BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  if constexpr (sizeof(T) == 2) {
    const Kernel wide[] = {systolic_mac_kernel<T, false, WM>,
                           systolic_mac_kernel<T, true, WM>};
    for (auto kernel : wide) {
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               W_SMEM_BYTES);
      if (e != cudaSuccess) return e;
    }
  }
  done |= bit;
  return cudaSuccess;
}

template <typename T>
int launch(const void* a_, const void* b_, const float* v_map,
           const float* v_safe, float* c, int* flags, int* count, int splits,
           int rows, int M, int N, int K, long long sa_m, long long sa_k,
           long long sb_k, long long sb_n, int block_m, int block_n,
           unsigned int keep_mask, cudaStream_t stream) {
  using L = Tile<T>;
  const cudaError_t set = set_attributes<T>();
  if (set != cudaSuccess) return static_cast<int>(set);
  const T* a = static_cast<const T*>(a_);
  const T* b = static_cast<const T*>(b_);
  const int k_tiles = (K + L::BK - 1) / L::BK;
  const int n_tiles = (N + BN - 1) / BN;
  if (splits < 1 || splits > MAX_SPLITS || (splits & (splits - 1)) != 0 ||
      splits > (k_tiles > 1 ? k_tiles : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = rows == WM;
  if (!wide && rows != BM) return static_cast<int>(cudaErrorInvalidValue);
  const int b_k_fastest = (sb_k == 1 && sb_n != 1) ? 1 : 0;
  CUtensorMap map_a = {}, map_b = {};
  const int a_tma = K > 0 && (sa_k == 1 || K == 1) &&
                    encode<T>(&map_a, a, K, M, sa_m, L::BK, wide ? WM : BM);
  const int b_tma =
      K > 0 &&
      (b_k_fastest
           ? encode<T>(&map_b, b, K, N, sb_n, L::BK, BN)
           : (sb_n == 1 || N == 1) && encode<T>(&map_b, b, N, K, sb_k, L::W,
                                                L::BK));
  if (wide) {
    // bf16 operands the TMA takes, in one launch: the wrapper's rule
    // (kernels/systolic_mac.py::launch_rows) sends every other call to the
    // 16-row form before it gets here
    if constexpr (sizeof(T) == 2) {
      if (!a_tma || !b_tma || n_tiles > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3((M + WM - 1) / WM, n_tiles, 1);
      cfg.blockDim = dim3(W_BLOCK);
      cfg.dynamicSmemBytes = W_SMEM_BYTES;
      cfg.stream = stream;
      const cudaError_t e = cudaLaunchKernelEx(
          &cfg,
          b_k_fastest ? systolic_mac_kernel<T, true, WM>
                      : systolic_mac_kernel<T, false, WM>,
          map_a, map_b, a, b, v_map, v_safe, c, flags, count, N, K, 0, M,
          sa_m, sa_k, sb_k, sb_n, block_m, block_n, N / block_n, keep_mask,
          splits, k_tiles, a_tma, b_tma);
      if (e != cudaSuccess) return static_cast<int>(e);
      return static_cast<int>(cudaGetLastError());
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  // CUDA's grid.z bounds the rows of one launch
  const long long max_rows = 65535LL * BM;
  for (long long r0 = 0; r0 < M; r0 += max_rows) {
    const int m_rows =
        static_cast<int>(M - r0 < max_rows ? M - r0 : max_rows);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n_tiles, splits, (m_rows + BM - 1) / BM);
    cfg.blockDim = dim3(BLOCK);
    cfg.dynamicSmemBytes = L::SMEM_BYTES;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = splits;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = splits > 1 ? 1 : 0;
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg,
        b_k_fastest ? systolic_mac_kernel<T, true, BM>
                    : systolic_mac_kernel<T, false, BM>,
        map_a, map_b, a, b, v_map, v_safe, c, flags, count, N, K,
        static_cast<int>(r0), m_rows, sa_m, sa_k, sb_k, sb_n, block_m, block_n,
        N / block_n, keep_mask, splits, k_tiles, a_tma, b_tma);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (a and b share it).  Strides in elements.
// count may be null (no fused reduction); zero_count = 1 zeroes it on the
// stream first, 0 adds this call's fired cells to what it holds.  splits is
// launch_plan's: a power of two, at most 16 and at most the k-tiles.  rows
// is the block's row tile (launch_rows): 16, or 128 for the wide form (bf16
// operands the TMA takes).  Returns the launch's error (0 = launched).
extern "C" int systolic_mac_launch(
    const void* a, const void* b, const void* v_map, const void* v_safe,
    void* c, void* flags, void* count, int zero_count, int splits, int rows,
    int M, int N, int K, long long sa_m, long long sa_k, long long sb_k,
    long long sb_n, int block_m, int block_n, int keep_bits, int dtype,
    void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || block_m <= 0 || block_n <= 0 ||
      M % block_m != 0 || N % block_n != 0 || keep_bits < 0 ||
      keep_bits > 23 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int keep_mask = 0xFFFFFFFFu << (23 - keep_bits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (count != nullptr && zero_count) {
    const cudaError_t e = cudaMemsetAsync(count, 0, sizeof(int), s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  auto* vm = static_cast<const float*>(v_map);
  auto* vs = static_cast<const float*>(v_safe);
  auto* cf = static_cast<float*>(c);
  auto* fl = static_cast<int*>(flags);
  auto* ct = static_cast<int*>(count);
  if (dtype == 0)
    return launch<float>(a, b, vm, vs, cf, fl, ct, splits, rows, M, N, K,
                         sa_m, sa_k, sb_k, sb_n, block_m, block_n, keep_mask,
                         s);
  return launch<__nv_bfloat16>(a, b, vm, vs, cf, fl, ct, splits, rows, M, N,
                               K, sa_m, sa_k, sb_k, sb_n, block_m, block_n,
                               keep_mask, s);
}
