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
// How it differs from the kernel it replaces:
//   * The Pallas grid walks (b*h, chunk) with the state in VMEM scratch
//     across sequential grid steps.  Here one block owns one (b, h) and walks
//     the chunks itself, with the (p, p) state in shared memory (16 KB at
//     p = 64) from its first read to its last write.  A block reads its whole
//     state before it writes any of it, so the final-state output may be the
//     state tensor itself (the port's decode updates it in place).
//   * r, k, v and w are read in their (b, s, h, p) layout through their
//     strides; nothing is moved or tiled in device memory first.
//   * Any chunk length works: the rows of a chunk are taken in tiles of 32,
//     the score tile (32 x 32) is formed one pair of row tiles at a time, and
//     the centring m and the clamps are those of the whole chunk.  The
//     cumsum is the sequential sum, recomputed per tile in the same order
//     (one thread per channel, from the tile's decays staged in shared
//     memory by all threads), so every tile sees the same lw values to the
//     bit.
//   * f32 throughout, fmaf on the CUDA cores (no TF32, no tensor cores).
//
// Bound on this card: in the loss path (p = 64, chunk 64) the f32
// operations, about 25 per byte of r, k, v, w and y (the f32 peak binds
// past 20); at decode (s = 1) the state's bytes, 2 MB each way per layer at
// four slots, far under one launch's cost.  This first version keeps one
// block per (b, h) (64 to 128 blocks on 132 SMs) and takes the four
// products on the CUDA cores: occupancy, not the bound, sets its time.

#include <cuda_runtime.h>

namespace {

constexpr int PMAX = 64;        // largest head size
constexpr int TILE = 32;        // rows of a tile inside a chunk
constexpr int THREADS = 256;
constexpr int LD = PMAX + 1;    // padded row of a shared tile
constexpr float EXP_CLAMP = 60.0f;

// strides, in elements, of a (b, s, h, p) tensor whose p axis is contiguous
struct Seq {
  long long b, s, h;
};

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__global__ void __launch_bounds__(THREADS)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            Seq sr, Seq sk, Seq sv, Seq sw, const float* __restrict__ u,
            const float* s0, float* __restrict__ y, float* s_out, int H,
            int S, int P, int ch) {
  __shared__ float Ss[PMAX][LD];     // the state (p, q)
  __shared__ float ta[TILE][LD];     // r tile: r * exp(lw_prev), then rr
  __shared__ float tk[TILE][LD];     // lw_prev of the t tile, then kk / k_tail
  __shared__ float tv[TILE][LD];     // v of an s tile
  __shared__ float At[TILE][TILE + 1];
  __shared__ float m_s[PMAX], end_s[PMAX], diag_s[TILE];

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const long long ob_r = b * sr.b + h * sr.h, ob_k = b * sk.b + h * sk.h;
  const long long ob_v = b * sv.b + h * sv.h, ob_w = b * sw.b + h * sw.h;
  auto R = [&](int t, int p) { return r[ob_r + t * sr.s + p]; };
  auto K = [&](int t, int p) { return k[ob_k + t * sk.s + p]; };
  auto V = [&](int t, int p) { return v[ob_v + t * sv.s + p]; };
  auto W = [&](int t, int p) { return w[ob_w + t * sw.s + p]; };

  // one tile of decays into tk, all threads at once (the walks below then
  // read them from shared memory); rows past the tile are zero
  auto stage_w = [&](int row0, int rows) {
    for (int e = tid; e < TILE * PMAX; e += THREADS) {
      const int i = e / PMAX, p = e % PMAX;
      tk[i][p] = (i < rows && p < P) ? W(row0 + i, p) : 0.f;
    }
  };

  // the whole state, read before anything is written (s_out may be s0)
  const float* s0b = s0 + (long long)bh * P * P;
  for (int e = tid; e < P * P; e += THREADS) Ss[e / P][e % P] = s0b[e];

  const int ty = tid / 16, tx = tid % 16;     // y tile: rows ty, ty + 16
  const int tr = tid / 8, sc = tid % 8;       // score tile: row tr, cols sc + 8j
  const int n_chunks = S / ch, n_tiles = (ch + TILE - 1) / TILE;

  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = c * ch;
    // chunk totals, in the order of the sequential cumsum
    float tot = 0.f;
    for (int ti = 0; ti < n_tiles; ++ti) {
      stage_w(c0 + ti * TILE, min(TILE, ch - ti * TILE));
      __syncthreads();
      if (tid < P) {
#pragma unroll
        for (int i = 0; i < TILE; ++i) tot += tk[i][tid];   // zero past the tile
      }
      __syncthreads();
    }
    if (tid < P) {
      end_s[tid] = tot;
      m_s[tid] = 0.5f * tot;
    }
    float pre_t = 0.f;                        // lw before the t tile (tid < P)
    __syncthreads();

    for (int ti = 0; ti < n_tiles; ++ti) {
      const int t0 = ti * TILE, nt = min(TILE, ch - t0);
      stage_w(c0 + t0, nt);
      __syncthreads();
      if (tid < P) {                          // in place: w -> lw_prev
#pragma unroll
        for (int i = 0; i < TILE; ++i) {
          const float w_i = tk[i][tid];
          tk[i][tid] = pre_t;
          pre_t += w_i;
        }
      }
      __syncthreads();
      for (int e = tid; e < TILE * PMAX; e += THREADS) {
        const int i = e / PMAX, p = e % PMAX;
        ta[i][p] = (i < nt && p < P)
                       ? R(c0 + t0 + i, p) * expf(clip(tk[i][p], -EXP_CLAMP, 0.f))
                       : 0.f;
      }
      __syncthreads();

      // inter-chunk: (r * exp(lw_prev)) S with the state at the chunk's start
      float inter[2][4] = {}, acc[2][4] = {};
      for (int p = 0; p < P; ++p) {
        const float a0 = ta[ty][p], a1 = ta[ty + 16][p];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float sv_ = Ss[p][tx + 16 * j];
          inter[0][j] = fmaf(a0, sv_, inter[0][j]);
          inter[1][j] = fmaf(a1, sv_, inter[1][j]);
        }
      }
      __syncthreads();
      for (int e = tid; e < TILE * PMAX; e += THREADS) {
        const int i = e / PMAX, p = e % PMAX;
        ta[i][p] = (i < nt && p < P)
                       ? R(c0 + t0 + i, p) *
                             expf(clip(tk[i][p] - m_s[p], -EXP_CLAMP, EXP_CLAMP))
                       : 0.f;
      }
      __syncthreads();

      float pre_s = 0.f;                      // lw before the s tile (tid < P)
      for (int sj = 0; sj <= ti; ++sj) {
        const int s0_ = sj * TILE, ns = min(TILE, ch - s0_);
        stage_w(c0 + s0_, ns);
        __syncthreads();
        if (tid < P) {                        // in place: w -> lw
#pragma unroll
          for (int i = 0; i < TILE; ++i) {
            pre_s += tk[i][tid];
            tk[i][tid] = pre_s;
          }
        }
        __syncthreads();
        for (int e = tid; e < TILE * PMAX; e += THREADS) {
          const int i = e / PMAX, p = e % PMAX;
          tk[i][p] = (i < ns && p < P)
                         ? K(c0 + s0_ + i, p) *
                               expf(clip(m_s[p] - tk[i][p], -EXP_CLAMP, EXP_CLAMP))
                         : 0.f;
        }
        for (int e = tid; e < TILE * PMAX; e += THREADS) {
          const int i = e / PMAX, q = e % PMAX;
          tv[i][q] = (i < ns && q < P) ? V(c0 + s0_ + i, q) : 0.f;
        }
        if (sj == ti) {                       // sum_p r u k, 8 threads a row
          const int row = tid / 8, part = tid % 8;
          float d = 0.f;
          if (row < nt)
            for (int p = part; p < P; p += 8)
              d += R(c0 + t0 + row, p) * u[h * P + p] * K(c0 + t0 + row, p);
          d += __shfl_xor_sync(0xffffffffu, d, 4);
          d += __shfl_xor_sync(0xffffffffu, d, 2);
          d += __shfl_xor_sync(0xffffffffu, d, 1);
          if (part == 0) diag_s[row] = d;
        }
        __syncthreads();
        {
          float a[4] = {};
          for (int p = 0; p < P; ++p) {
            const float x = ta[tr][p];
#pragma unroll
            for (int j = 0; j < 4; ++j) a[j] = fmaf(x, tk[sc + 8 * j][p], a[j]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j)    // strictly lower: s < t
            At[tr][sc + 8 * j] = (s0_ + sc + 8 * j < t0 + tr) ? a[j] : 0.f;
        }
        __syncthreads();
        for (int s = 0; s < TILE; ++s) {
          const float a0 = At[ty][s], a1 = At[ty + 16][s];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float vv = tv[s][tx + 16 * j];
            acc[0][j] = fmaf(a0, vv, acc[0][j]);
            acc[1][j] = fmaf(a1, vv, acc[1][j]);
          }
        }
        if (sj == ti) {                       // the u bonus on the diagonal
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] += diag_s[ty + 16 * i] * tv[ty + 16 * i][tx + 16 * j];
        }
        __syncthreads();
      }

#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = ty + 16 * i;
        if (row >= nt) continue;
        float* yr = y + (((long long)b * S + c0 + t0 + row) * H + h) * P;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q = tx + 16 * j;
          if (q < P) yr[q] = acc[i][j] + inter[i][j];
        }
      }
    }

    // state update: S' = S * exp(lw_end) + k_tail^T v
    float upd[4][4] = {};
    float pre_s = 0.f;
    for (int sj = 0; sj < n_tiles; ++sj) {
      const int s0_ = sj * TILE, ns = min(TILE, ch - s0_);
      stage_w(c0 + s0_, ns);
      __syncthreads();
      if (tid < P) {                          // in place: w -> lw
#pragma unroll
        for (int i = 0; i < TILE; ++i) {
          pre_s += tk[i][tid];
          tk[i][tid] = pre_s;
        }
      }
      __syncthreads();
      for (int e = tid; e < TILE * PMAX; e += THREADS) {
        const int i = e / PMAX, p = e % PMAX;
        tk[i][p] = (i < ns && p < P)
                       ? K(c0 + s0_ + i, p) *
                             expf(clip(end_s[p] - tk[i][p], -EXP_CLAMP, EXP_CLAMP))
                       : 0.f;
      }
      for (int e = tid; e < TILE * PMAX; e += THREADS) {
        const int i = e / PMAX, q = e % PMAX;
        tv[i][q] = (i < ns && q < P) ? V(c0 + s0_ + i, q) : 0.f;
      }
      __syncthreads();
      for (int s = 0; s < TILE; ++s) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float kt = tk[s][ty * 4 + i];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            upd[i][j] = fmaf(kt, tv[s][tx + 16 * j], upd[i][j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = ty * 4 + i;
      if (p >= P) continue;
      const float dec = expf(clip(end_s[p], -EXP_CLAMP, 0.f));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = tx + 16 * j;
        if (q < P) Ss[p][q] = Ss[p][q] * dec + upd[i][j];
      }
    }
    __syncthreads();
  }

  float* sob = s_out + (long long)bh * P * P;
  for (int e = tid; e < P * P; e += THREADS) sob[e] = Ss[e / P][e % P];
}

}  // namespace

// r, k, v, w: (B, S, H, P) float32 with the P axis contiguous, any other
// strides (in elements).  u: (H, P), s0 and s_out: (B, H, P, P), y:
// (B, S, H, P), all float32 and contiguous; s_out may be s0.  chunk divides
// S.  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int wkv6_launch(
    const void* r, const void* k, const void* v, const void* w,
    long long r_sb, long long r_ss, long long r_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long w_sb, long long w_ss, long long w_sh,
    const void* u, const void* s0, void* y, void* s_out, int B, int S, int H,
    int P, int chunk, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P > PMAX || chunk <= 0 ||
      S % chunk != 0 || (long long)B * H > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  wkv6_kernel<<<B * H, THREADS, 0, st>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      Seq{r_sb, r_ss, r_sh}, Seq{k_sb, k_ss, k_sh}, Seq{v_sb, v_ss, v_sh},
      Seq{w_sb, w_ss, w_sh}, static_cast<const float*>(u),
      static_cast<const float*>(s0), static_cast<float*>(y),
      static_cast<float*>(s_out), H, S, P, chunk);
  return static_cast<int>(cudaGetLastError());
}
