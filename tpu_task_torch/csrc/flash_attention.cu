// Flash attention for Hopper (sm_90a), hand-written CUDA C++: the forward
// and the two backward kernels of one library.
//
// Replaces the TPU kernels of tpu_task/ml/ops/attention.py:
//   flash_fwd_wgmma_kernel     <- _flash_fwd_kernel (:186, called by
//                                 flash_attention at :319): bf16, d 64, 128
//   flash_bwd_dq_wgmma_kernel  <- _flash_bwd_dq_kernel (:344, call :577)
//   flash_bwd_dkv_wgmma_kernel <- _flash_bwd_dkv_kernel (:394, call :597)
//   flash_fwd_kernel, flash_bwd_dq_kernel, flash_bwd_dkv_kernel
//                              <- the same three, for fp32 and for bf16 at
//                                 other head dims
//
//   q, do, o, dq   (b, sq, h, d)   fp32 or bf16, contiguous
//   k, v, dk, dv   (b, sk, h, d)   q's type
//   lse, delta     (b, h, sq)      fp32; delta = rowsum(dO * O), computed
//                                  outside, as the JAX package does
//
// Scores are (q . k) * scale, scale = 1 / sqrt(d), in fp32. Under causal
// masking query row i (global position q_offset + i) sees key j iff
// q_offset + i >= j; any static q_offset is taken, negative ones too. A row
// that sees no key follows the JAX kernels exactly: o = 0, lse = -1e30, and
// its weights are 0 in the backward. Keys past sk and queries past sq (the
// ragged edge of the last tile) are masked the same way, so any length is
// taken.
//
// The forward on the tensor cores (bf16 at d 64 and 128, the model's
// shapes). Bound at the flagship train shape (b 8, s 1024, h 8, d 128,
// causal): bytes. It reads q, k, v and writes o once (67.1 MB) and lse
// (0.3 MB), 67.4 MB in all, 20.1 us at 3.35 TB/s; its two products over
// the visible score entries are 17.2 GFLOP, 17.4 us at 989 TFLOP/s. So
// the kernel has to keep the tensor cores fed while it streams K and V,
// which is what its design is for:
//   - a CTA owns a 128-row q tile of one (batch, head), in three
//     warpgroups (384 threads): a producer, whose one elected thread issues
//     every copy with the Tensor Memory Accelerator (TMA), and two
//     consumers of 64 rows each. setmaxnreg moves registers from the
//     producer (40) to the consumers (232).
//   - Q is loaded once; K and V stream through a ring of 128-row stages in
//     shared memory (2 stages at d 128: Q 32 KB + 2 x (K 32 KB + V 32 KB);
//     3 at d 64), each with a full barrier for K, one for V, and one empty
//     barrier that the consumers release once their products have read it.
//   - S = Q.K^T on wgmma m64n128k16 with both operands in shared memory,
//     K-major under the 128-byte swizzle; O += P.V on wgmma m64n{d}k16 with
//     P in registers: the fp32 accumulators of S, packed into bf16 pairs,
//     are already the A fragments of the next wgmma (p is rounded to bf16
//     before P.V, as at attention.py:248). V is read MN-major through
//     wgmma's transpose bit, so it is never transposed in memory.
//   - the online softmax runs in fp32 registers in the exp2 domain: each
//     weight is exp2(s scale log2(e) - shift) in one FMA and one ex2, the
//     statistics kept on the raw scores; lse = m scale + log(l). Only the
//     kv tiles that cross the diagonal or the ragged edge apply the mask;
//     the loop stops at the last tile the q tile's last row sees
//     (key_end). flash_fwd_tiles in ml/ops/attention.py writes this
//     schedule out in Python, where the CPU tests check it.
//   - the grid is (q tiles, batch x head), started in groups of (batch,
//     head) pairs that fill about one wave of the SMs, so a group's K and
//     V stay in L2, with the longest causal rows first inside a group.
//   - the epilogue divides by l, stages o through the consumer's own rows
//     of Q's shared memory and writes rows < sq with 16-byte stores.
// What it leaves: one CTA fills an SM, so a CTA's cold loads of Q, K and
// V and its epilogue overlap no other CTA's math, and the two consumers
// run their products and softmax in step rather than in turns (measured
// in PERF.md; a persistent grid and ping-pong consumers are the next
// steps).
// The tensor maps are encoded on the host per call (cuTensorMapEncodeTiled
// as rank-4 maps over the real (b, s, h, d) layout: dims (d, h, s, b),
// strides in bytes, boxes of 64 columns x 64 or 128 rows; a 128-wide head
// dim is two boxes). A box past s is zero-filled by the hardware and never
// wraps into the next batch row. The library is not linked against
// libcuda: it gets cuTensorMapEncodeTiled through the runtime's
// cudaGetDriverEntryPoint(ByVersion), and an encoding that fails returns
// its CUresult (as kTensorMapError + CUresult) for the wrapper to raise on.
//
// The backward on the tensor cores (bf16 at d 64 and 128) takes the
// forward's structure: the same three warpgroups, with setmaxnreg giving
// the producer 24 registers and the consumers 240, every copy a TMA box
// under the 128-byte swizzle, and every product on wgmma. Bound at the
// flagship shape: operations. One product over the visible score entries
// is 8.59 GFLOP; dq runs three (S, dP, dQ: 25.8 GFLOP, 26.1 us at 989
// TFLOP/s) and dk/dv four (S, dP, dV, dK: 34.4 GFLOP, 34.8 us), against
// 25.2 and 30.2 us at 3.35 TB/s for their bytes (five and six (b, s, h, d)
// tensors and two (b, h, s) arrays, each read or written once).
//   - dq: a CTA per 128-row q tile. Q and dO are loaded once; K and V
//     stream through the forward's ring of 128-row stages and walk its
//     schedule (fwd_tiles: stop at key_end, mask only the tiles that cross
//     the diagonal or sk). Per stage, S = Q.K^T and dP = dO.V^T on
//     m64n128k16, P = exp2(S scale log2(e) - lse log2(e)), dS = P (dP -
//     delta), and dQ += dS.K on m64n{d}k16 with dS rounded to bf16 in
//     registers as its A fragments (attention.py:387) and K read MN-major
//     through the transpose bit. A consumer holds dQ, S and dP: 3 x 64
//     fp32 at d 128.
//   - dk/dv: a CTA per 128-row kv tile, keys on the M side. K and V are
//     loaded once; Q and dO stream through a ring of 64-row stages, each
//     with its 64 lse and delta values, which the producer's first warp
//     loads with plain loads (a ragged sq leaves them off the 16-byte
//     alignment a bulk copy needs). Per stage, S^T = K.Q^T and dP^T =
//     V.dO^T on m64n64k16; dV += P^T.dO and dK += dS^T.Q on m64n{d}k16
//     with P^T and dS^T rounded to bf16 as A (attention.py:436, :441) and
//     dO and Q read MN-major. A consumer holds dK, dV, S^T and dP^T: 64 +
//     64 + 32 + 32 fp32 at d 128, which fits only with the 64-row q stage.
//     The walk starts at the first q tile that reaches the diagonal; a
//     tile needs the mask only where it crosses the diagonal, sq or sk.
//     flash_bwd_tiles in ml/ops/attention.py writes both kernels'
//     schedules out for the CPU tests.
//   - both: CTAs start in the forward's groups of about one wave of
//     (batch, head) pairs, the longest walks first (the last q tiles of
//     dq, the first kv tiles of dk/dv). Rows past sq weigh exactly 0:
//     their lse and delta are 0 and a masked weight is selected away,
//     never multiplied by 0; a row whose lse is -1e30 uses 0, as JAX's
//     lse_safe. The epilogue stages bf16 rows through the consumer's own
//     rows of Q (dq) or of K and V (dk/dv) and writes rows < sq (sk) with
//     16-byte stores. Every output tile has exactly one owner: no atomics,
//     and the result is deterministic.
// What they leave: two kernels compute S and dP twice, 7 products against
// a fused backward's 5; a fused backward (dq by a TMA reduce-add, delta in
// the same pass), a persistent grid and ping-pong consumers are later
// steps.
//
// The fp32 kernels, and bf16 at other head dims, keep an older structure
// on the fp32 cores: a CTA of 256 threads owns one 64-row output tile and
// loops over the other operand's 64-row tiles itself (dq: kv tiles up to
// the last the tile's last row sees; dk/dv: q tiles from the first that
// reaches the diagonal), with tiles staged as fp32 rows padded to d + 1
// floats, each thread holding a 4 x 4 block of the 64 x 64 score tile and
// a 4 x 8 block of the (64, d) accumulator, and one warp per row for the
// online softmax. fp32 needs fp32 products: TF32 tensor cores would miss
// the 2e-5 pin.

#include <cuda.h>  // CUtensorMap and its enums; libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                 // rows of a q tile and a kv tile
constexpr int kMaxD = 128;
constexpr int kSide = 16;                 // the 16 x 16 thread grid
constexpr int kRows = kTile / kSide;      // 4 tile rows per thread
constexpr int kCols = kMaxD / kSide;      // up to 8 head-dim columns per thread
constexpr int kLdS = kTile + 1;           // padded stride of a score tile

struct Geometry {
  int sq, sk, heads, d, causal, q_offset;
  float scale;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ int64_t row_offset(int b, int row, int s_len,
                                              int heads, int h, int d) {
  return ((static_cast<int64_t>(b) * s_len + row) * heads + h) * d;
}

// kTile rows of a (b, s_len, heads, d) tensor from row0 on, head h, into
// fp32 shared memory rows of stride ld; rows past s_len are zero.
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ src,
                                          float* __restrict__ dst, int b,
                                          int h, int row0, int s_len,
                                          int heads, int d, int ld) {
  for (int e = threadIdx.x; e < kTile * d; e += kThreads) {
    const int r = e / d;
    const int j = e % d;
    const int row = row0 + r;
    dst[r * ld + j] =
        row < s_len ? to_float(src[row_offset(b, row, s_len, heads, h, d) + j])
                    : 0.0f;
  }
}

// s[i][jj] = sum_j a[ty + 16i][j] * b[tx + 16jj][j]: this thread's 4 x 4
// block of a 64 x 64 tile of a . b^T.
__device__ __forceinline__ void tile_nt(const float* __restrict__ a,
                                        const float* __restrict__ bm, int d,
                                        int ld, int ty, int tx,
                                        float (&s)[kRows][kRows]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int jj = 0; jj < kRows; ++jj) s[i][jj] = 0.0f;
#pragma unroll 4
  for (int j = 0; j < d; ++j) {
    float av[kRows], bv[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      av[i] = a[(ty + kSide * i) * ld + j];
      bv[i] = bm[(tx + kSide * i) * ld + j];
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int jj = 0; jj < kRows; ++jj) s[i][jj] += av[i] * bv[jj];
  }
}

// acc[i][jj] += sum_k P(ty + 16i, k) * m[k][tx + 16jj] over k < kTile,
// where P(r, k) is p[r * kLdS + k], or p[k * kLdS + r] when Transposed.
template <bool Transposed>
__device__ __forceinline__ void tile_acc(const float* __restrict__ p,
                                         const float* __restrict__ m, int ld,
                                         int d, int ty, int tx,
                                         float (&acc)[kRows][kCols]) {
#pragma unroll 2
  for (int k = 0; k < kTile; ++k) {
    float pv[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + kSide * i;
      pv[i] = Transposed ? p[k * kLdS + r] : p[r * kLdS + k];
    }
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) {
      const int c = tx + kSide * jj;
      const float mv = c < d ? m[k * ld + c] : 0.0f;
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i][jj] += pv[i] * mv;
    }
  }
}

// Whether query row `row` may see key `col`.
__device__ __forceinline__ bool visible(const Geometry& g, int row, int col) {
  return row < g.sq && col < g.sk && (!g.causal || g.q_offset + row >= col);
}

// One past the last key a q tile whose rows are [q0, q0 + rows) can see.
__device__ __forceinline__ int key_end(const Geometry& g, int q0,
                                       int rows = kTile) {
  if (!g.causal) return g.sk;
  const int last_row = min(q0 + rows, g.sq) - 1;
  return max(0, min(g.sk, g.q_offset + last_row + 1));
}

template <typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, int b, int h,
                                           int row0, int s_len, int heads,
                                           int d, int ty, int tx,
                                           const float (&acc)[kRows][kCols],
                                           const float (&mul)[kRows]) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = row0 + ty + kSide * i;
    if (row >= s_len) continue;
    const int64_t base = row_offset(b, row, s_len, heads, h, d);
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) {
      const int c = tx + kSide * jj;
      if (c < d) dst[base + c] = from_float<T>(acc[i][jj] * mul[i]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Geometry g) {
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int bh = blockIdx.y;
  const int b = bh / g.heads;
  const int h = bh % g.heads;
  const int d = g.d;
  const int ld = d + 1;
  const int tid = threadIdx.x;
  const int ty = tid / kSide;
  const int tx = tid % kSide;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float smem[];
  float* sq = smem;                 // (kTile, ld) this CTA's queries
  float* skv = sq + kTile * ld;     // (kTile, ld) K, then V, of a kv tile
  float* ss = skv + kTile * ld;     // (kTile, kLdS) scores, then weights
  float* sm = ss + kTile * kLdS;    // (kTile) running max
  float* sl = sm + kTile;           // (kTile) running sum
  float* scorr = sl + kTile;        // (kTile) this tile's rescale factor

  load_rows(q, sq, b, h, q0, g.sq, g.heads, d, ld);
  for (int r = tid; r < kTile; r += kThreads) {
    sm[r] = kNegInf;
    sl[r] = 0.0f;
  }
  float acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) acc[i][jj] = 0.0f;

  const int k_end = key_end(g, q0);
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the last tile's readers of skv and ss are done
    load_rows(k, skv, b, h, k0, g.sk, g.heads, d, ld);
    __syncthreads();
    float s[kRows][kRows];
    tile_nt(sq, skv, d, ld, ty, tx, s);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int jj = 0; jj < kRows; ++jj) {
        const int r = ty + kSide * i;
        const int c = tx + kSide * jj;
        ss[r * kLdS + c] =
            visible(g, q0 + r, k0 + c) ? s[i][jj] * g.scale : kNegInf;
      }
    __syncthreads();  // K is read: V may take its place
    load_rows(v, skv, b, h, k0, g.sk, g.heads, d, ld);
    for (int r = warp; r < kTile; r += kWarps) {
      float* pr = ss + r * kLdS;
      const float x0 = pr[lane];
      const float x1 = pr[lane + 32];
      const float m = sm[r];
      const float m_new = fmaxf(m, warp_max(fmaxf(x0, x1)));
      // A row with nothing visible yet keeps m at -1e30: shift by 0, so
      // its masked weights stay exactly 0.
      const float shift = m_new <= kNegInf / 2 ? 0.0f : m_new;
      const float p0 = x0 <= kNegInf / 2 ? 0.0f : expf(x0 - shift);
      const float p1 = x1 <= kNegInf / 2 ? 0.0f : expf(x1 - shift);
      pr[lane] = p0;
      pr[lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float corr = expf((m <= kNegInf / 2 ? kNegInf : m) - shift);
        sl[r] = sl[r] * corr + sum;
        sm[r] = m_new;
        scorr[r] = corr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float corr = scorr[ty + kSide * i];
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) acc[i][jj] *= corr;
    }
    tile_acc<false>(ss, skv, ld, d, ty, tx, acc);
  }
  __syncthreads();

  float inv_l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const float l = sl[ty + kSide * i];
    inv_l[i] = 1.0f / (l == 0.0f ? 1.0f : l);
  }
  store_rows(o, b, h, q0, g.sq, g.heads, d, ty, tx, acc, inv_l);
  for (int r = tid; r < kTile; r += kThreads) {
    const int row = q0 + r;
    if (row >= g.sq) continue;
    const float m = sm[r];
    const float l = sl[r];
    const float shift = m <= kNegInf / 2 ? 0.0f : m;
    lse[static_cast<int64_t>(bh) * g.sq + row] =
        l == 0.0f ? kNegInf : shift + logf(l);
  }
}

// The per-row statistics of kTile query rows from q0 on: lse with a fully
// masked row's -1e30 replaced by 0 (its weights are masked to 0 anyway),
// and delta.
__device__ __forceinline__ void load_stats(const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           float* slse, float* sdelta, int bh,
                                           int q0, int sq) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int row = q0 + r;
    float l = 0.0f, dl = 0.0f;
    if (row < sq) {
      l = lse[static_cast<int64_t>(bh) * sq + row];
      l = l <= kNegInf / 2 ? 0.0f : l;
      dl = delta[static_cast<int64_t>(bh) * sq + row];
    }
    slse[r] = l;
    sdelta[r] = dl;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    Geometry g) {
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int bh = blockIdx.y;
  const int b = bh / g.heads;
  const int h = bh % g.heads;
  const int d = g.d;
  const int ld = d + 1;
  const int ty = threadIdx.x / kSide;
  const int tx = threadIdx.x % kSide;

  extern __shared__ float smem[];
  float* sq = smem;                 // (kTile, ld) queries
  float* sdo = sq + kTile * ld;     // (kTile, ld) output gradients
  float* sk = sdo + kTile * ld;     // (kTile, ld) K of a kv tile
  float* sv = sk + kTile * ld;      // (kTile, ld) V of a kv tile
  float* sds = sv + kTile * ld;     // (kTile, kLdS) ds
  float* slse = sds + kTile * kLdS; // (kTile)
  float* sdelta = slse + kTile;     // (kTile)

  load_rows(q, sq, b, h, q0, g.sq, g.heads, d, ld);
  load_rows(dout, sdo, b, h, q0, g.sq, g.heads, d, ld);
  load_stats(lse, delta, slse, sdelta, bh, q0, g.sq);
  float acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) acc[i][jj] = 0.0f;

  const int k_end = key_end(g, q0);
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    load_rows(k, sk, b, h, k0, g.sk, g.heads, d, ld);
    load_rows(v, sv, b, h, k0, g.sk, g.heads, d, ld);
    __syncthreads();
    float s[kRows][kRows], dp[kRows][kRows];
    tile_nt(sq, sk, d, ld, ty, tx, s);
    tile_nt(sdo, sv, d, ld, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int jj = 0; jj < kRows; ++jj) {
        const int r = ty + kSide * i;
        const int c = tx + kSide * jj;
        const float p = visible(g, q0 + r, k0 + c)
                            ? expf(s[i][jj] * g.scale - slse[r])
                            : 0.0f;
        sds[r * kLdS + c] = p * (dp[i][jj] - sdelta[r]);
      }
    __syncthreads();
    tile_acc<false>(sds, sk, ld, d, ty, tx, acc);
  }
  const float scale[kRows] = {g.scale, g.scale, g.scale, g.scale};
  store_rows(dq, b, h, q0, g.sq, g.heads, d, ty, tx, acc, scale);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, Geometry g) {
  const int k0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const int b = bh / g.heads;
  const int h = bh % g.heads;
  const int d = g.d;
  const int ld = d + 1;
  const int ty = threadIdx.x / kSide;
  const int tx = threadIdx.x % kSide;

  extern __shared__ float smem[];
  float* sk = smem;                 // (kTile, ld) this CTA's keys
  float* sv = sk + kTile * ld;      // (kTile, ld) this CTA's values
  float* sq = sv + kTile * ld;      // (kTile, ld) queries of a q tile
  float* sdo = sq + kTile * ld;     // (kTile, ld) their output gradients
  float* sp = sdo + kTile * ld;     // (kTile, kLdS) p, q rows by k columns
  float* sds = sp + kTile * kLdS;   // (kTile, kLdS) ds, the same layout
  float* slse = sds + kTile * kLdS; // (kTile)
  float* sdelta = slse + kTile;     // (kTile)

  load_rows(k, sk, b, h, k0, g.sk, g.heads, d, ld);
  load_rows(v, sv, b, h, k0, g.sk, g.heads, d, ld);
  float dk_acc[kRows][kCols], dv_acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) dk_acc[i][jj] = dv_acc[i][jj] = 0.0f;

  // Causal: the first query row that sees key k0 is k0 - q_offset.
  int q_begin = 0;
  if (g.causal) q_begin = max(0, min(g.sq, k0 - g.q_offset)) / kTile * kTile;
  for (int q0 = q_begin; q0 < g.sq; q0 += kTile) {
    __syncthreads();
    load_rows(q, sq, b, h, q0, g.sq, g.heads, d, ld);
    load_rows(dout, sdo, b, h, q0, g.sq, g.heads, d, ld);
    load_stats(lse, delta, slse, sdelta, bh, q0, g.sq);
    __syncthreads();
    float s[kRows][kRows], dp[kRows][kRows];
    tile_nt(sq, sk, d, ld, ty, tx, s);   // rows: queries, columns: keys
    tile_nt(sdo, sv, d, ld, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int jj = 0; jj < kRows; ++jj) {
        const int r = ty + kSide * i;
        const int c = tx + kSide * jj;
        const float p = visible(g, q0 + r, k0 + c)
                            ? expf(s[i][jj] * g.scale - slse[r])
                            : 0.0f;
        sp[r * kLdS + c] = p;
        sds[r * kLdS + c] = p * (dp[i][jj] - sdelta[r]);
      }
    __syncthreads();
    tile_acc<true>(sp, sdo, ld, d, ty, tx, dv_acc);   // dv += p^T . dO
    tile_acc<true>(sds, sq, ld, d, ty, tx, dk_acc);   // dk += ds^T . q
  }
  const float one[kRows] = {1.0f, 1.0f, 1.0f, 1.0f};
  const float scale[kRows] = {g.scale, g.scale, g.scale, g.scale};
  store_rows(dk, b, h, k0, g.sk, g.heads, d, ty, tx, dk_acc, scale);
  store_rows(dv, b, h, k0, g.sk, g.heads, d, ty, tx, dv_acc, one);
}

// ---------------------------------------------------------------------------
// Shared by the wgmma kernels below.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// The forward on wgmma, fed by a TMA ring (bf16 at head dims 64 and 128).
//
// Warpgroup 0 is the producer: its thread 0 loads Q once and walks the kv
// tiles, waiting on each ring stage's empty barrier before it reloads the
// stage. Warpgroups 1 and 2 are the consumers, each owning 64 of the CTA's
// 128 q rows; every one of their threads waits on a stage's full barriers,
// runs its products, and arrives on the stage's empty barrier once the
// last product that read it has been waited on.
//
// Shared memory, from a 1024-byte boundary (the 128-byte swizzle's period):
// Q (128 rows), kStages x K, kStages x V, then the barriers. A 128-row
// tile is kD / 64 boxes of 128 rows x 128 bytes, each row's 16-byte chunks
// swizzled (chunk c of row r at c ^ (r % 8)), exactly as the TMA writes
// them and as wgmma's 128-byte-swizzle descriptors read them.
//
// Fragments (PTX ISA, wgmma m64nNk16): accumulator element 4j + e of
// thread t of a warpgroup holds row 16 (t / 32) + (t % 32) / 4 + 8 (e / 2),
// column 8j + 2 (t % 4) + e % 2; the A fragment of k-step kk in registers
// is {S(2kk)[0,1], S(2kk)[2,3], S(2kk+1)[0,1], S(2kk+1)[2,3]} as bf16 pairs.
// ---------------------------------------------------------------------------

constexpr int kFwdBlockQ = 128;   // q rows of a CTA, 64 per consumer
constexpr int kFwdBlockK = 128;   // kv rows of a ring stage
constexpr int kFwdThreads = 384;  // producer + 2 consumer warpgroups
constexpr int kBoxCols = 64;      // bf16 columns of a box: 128 bytes
constexpr int kBoxBytes = kFwdBlockK * kBoxCols * 2;  // 16 KB
// setmaxnreg's split: 128 x 40 + 256 x 232 = 64,512 of an SM's 65,536
// registers, so the two consumers hold S, O and P (about 160) unspilled.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
// Error codes of an encoding that failed: kTensorMapError + its CUresult.
constexpr int kTensorMapError = 20000;

template <int kD>
struct FwdLayout {
  static_assert(kD == 64 || kD == 128, "the wgmma forward takes d 64, 128");
  // A third stage fits at d 128 too (230 KB) but did not run faster: one
  // stage ahead already covers a tile's loads, which mostly hit L2.
  static constexpr int kStages = kD == 128 ? 2 : 3;
  static constexpr int kTileBytes = (kD / kBoxCols) * kBoxBytes;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTileBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  // q_full, k_full[kStages], v_full[kStages], empty[kStages]
  static constexpr int kSmem = kBar + (1 + 3 * kStages) * 8 + 1024;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Returns once the barrier's phase of the given parity has completed.
// Built with -DTT_DEBUG_HANG, a wait past 2^26 polls traps, so that a ring
// that can never fill fails its launch instead of hanging the card. The
// watchdog is for debugging a new ring only: a trap poisons the process's
// whole CUDA context, and a poll count is not a time, so a slow but
// legitimate wait (a debugger, a busy card) would end a training run. Its
// poll counters also make the backward kernels spill: time only a build
// without it.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
#ifdef TT_DEBUG_HANG
  for (uint32_t polls = 0;; ++polls) {
#else
  for (;;) {
#endif
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
#ifdef TT_DEBUG_HANG
    if (polls == (1u << 26)) __trap();
#endif
  }
}

// One box of a rank-4 map at coordinates (c0, c1, c2, c3) = (column, head,
// row, batch) into shared memory at dst; completes its bytes on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor under the 128-byte swizzle: start
// address, leading and stride byte offsets (each >> 4), layout type 1 in
// bits 62-63 (cute/arch/mma_sm90_desc.hpp's GmmaDescriptor).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Returns once at most N of this warpgroup's committed groups are pending
// (groups complete in the order they were committed).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Ties registers to this point, so that no read of an accumulator moves
// above the wait that completes it (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define TT_ACC4(i) "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), \
                   "+f"(d[(i) + 3])
#define TT_ACC16(i) TT_ACC4(i), TT_ACC4((i) + 4), TT_ACC4((i) + 8), \
                    TT_ACC4((i) + 12)
#define TT_REGS32                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                       \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                  \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                \
  "%24, %25, %26, %27, %28, %29, %30, %31}"
#define TT_REGS64                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                       \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                  \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                \
  "%24, %25, %26, %27, %28, %29, %30, %31, "                \
  "%32, %33, %34, %35, %36, %37, %38, %39, "                \
  "%40, %41, %42, %43, %44, %45, %46, %47, "                \
  "%48, %49, %50, %51, %52, %53, %54, %55, "                \
  "%56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 128, fp32) = A . B^T (+ d when accumulate): A and B K-major in
// shared memory (descriptors), bf16.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TT_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : TT_ACC16(0), TT_ACC16(16), TT_ACC16(32), TT_ACC16(48)
      : "l"(a), "l"(b), "r"(accumulate));
}

// The same at N = 64: d (64 x 64, fp32) = A . B^T (+ d when accumulate).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TT_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : TT_ACC16(0), TT_ACC16(16)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128, fp32) += A . B: A (64 x 16, bf16) in registers, B (16 x
// 128) MN-major in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TT_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : TT_ACC16(0), TT_ACC16(16), TT_ACC16(32), TT_ACC16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The same at N = 64 (d 64).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TT_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : TT_ACC16(0), TT_ACC16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef TT_ACC4
#undef TT_ACC16
#undef TT_REGS32
#undef TT_REGS64

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The CTA's place in the grid, in dispatch order: groups of
// `group` (batch, head) pairs start one after the other, and inside a group
// tile rank `rank` of every pair starts before rank + 1.
struct Dispatch {
  int rank, bh;
};

__device__ __forceinline__ Dispatch dispatch(int group) {
  const int linear = blockIdx.x + gridDim.x * blockIdx.y;
  const int first = linear / (group * gridDim.x) * group;
  const int size = min(group, static_cast<int>(gridDim.y) - first);
  const int within = linear - first * static_cast<int>(gridDim.x);
  return Dispatch{within / size, first + within % size};
}

// A consumer's epilogue, in two steps around its warpgroup's named
// barrier. First its fp32 accumulators, the thread's row r_local times
// mul[0] and row r_local + 8 times mul[1], as bf16 into its own 64 rows of
// a 128-row tile at `tile`, in the same swizzled layout as the TMA's;
template <int kD>
__device__ __forceinline__ void stage_rows(unsigned char* tile,
                                           const float (&acc)[kD / 2],
                                           const float (&mul)[2],
                                           int r_local, int lane) {
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r_local + 8 * i;
      const uint32_t at = (j / 8) * kBoxBytes + r * 128 +
                          ((j % 8) ^ (r % 8)) * 16 + (lane % 4) * 4;
      *reinterpret_cast<uint32_t*>(tile + at) = pack_bf16(
          acc[4 * j + 2 * i] * mul[i], acc[4 * j + 2 * i + 1] * mul[i]);
    }
}

// then those rows, for rows row0 + r below s_len, into dst (b, s_len,
// heads, kD) with 16-byte stores.
template <int kD>
__device__ __forceinline__ void store_staged(bf16* __restrict__ dst,
                                             const unsigned char* tile,
                                             int wg, int tw, int b, int h,
                                             int row0, int s_len, int heads) {
  constexpr int kChunks = kD / 8;  // 16-byte chunks of a row
  for (int c = tw; c < 64 * kChunks; c += 128) {
    const int r = wg * 64 + c / kChunks;
    const int chunk = c % kChunks;
    const int row = row0 + r;
    if (row >= s_len) continue;
    const uint32_t at = (chunk / 8) * kBoxBytes + r * 128 +
                        ((chunk % 8) ^ (r % 8)) * 16;
    *reinterpret_cast<uint4*>(dst + row_offset(b, row, s_len, heads, h, kD) +
                              chunk * 8) =
        *reinterpret_cast<const uint4*>(tile + at);
  }
}

// The kv tiles a 128-row q tile walks, [0, n), and how many of them lead
// without a mask: tile t needs none iff every key of it is below sk and
// seen by the tile's first row (so by all its rows).
struct FwdTiles {
  int n, unmasked;
};

__device__ __forceinline__ FwdTiles fwd_tiles(const Geometry& g, int q0) {
  const int end = key_end(g, q0, kFwdBlockQ);
  const int n = (end + kFwdBlockK - 1) / kFwdBlockK;
  const int reach = g.causal ? min(g.sk, g.q_offset + q0 + 1) : g.sk;
  return FwdTiles{n, min(n, max(0, reach) / kFwdBlockK)};
}

template <int kD>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       bf16* __restrict__ o, float* __restrict__ lse,
                       Geometry g, int group) {
  using L = FwdLayout<kD>;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char fwd_smem[];
  const uint32_t raw = smem_u32(fwd_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* base_ptr = fwd_smem + (base - raw);
  const uint32_t s_q = base + L::kQ;
  const uint32_t s_k = base + L::kK;
  const uint32_t s_v = base + L::kV;
  const uint32_t q_full = base + L::kBar;
  const uint32_t k_full = q_full + 8;                  // + 8 * stage
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t empty = v_full + 8 * kStages;

  // Dispatch order (CTAs start in blockIdx order): groups of `group`
  // (batch, head) pairs, about one wave of the card's SMs, start one after
  // the other, so their K and V stay in L2 while the group runs; inside a
  // group the q tiles with the longest causal rows start first.
  const Dispatch place = dispatch(group);
  const int q0 = (gridDim.x - 1 - place.rank) * kFwdBlockQ;
  const int bh = place.bh;
  const int b = bh / g.heads;
  const int h = bh % g.heads;
  const FwdTiles tiles = fwd_tiles(g, q0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // -- producer ------------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0 && tiles.n > 0) {
      mbar_expect_tx(q_full, L::kTileBytes);
#pragma unroll
      for (int x = 0; x < kD / kBoxCols; ++x)
        tma_load(s_q + x * kBoxBytes, &map_q, q_full, x * kBoxCols, h, q0, b);
      for (int t = 0; t < tiles.n; ++t) {
        const int stage = t % kStages;
        mbar_wait(empty + 8 * stage, ((t / kStages) & 1) ^ 1);
        const uint32_t kb = k_full + 8 * stage, vb = v_full + 8 * stage;
        mbar_expect_tx(kb, L::kTileBytes);
#pragma unroll
        for (int x = 0; x < kD / kBoxCols; ++x)
          tma_load(s_k + stage * L::kTileBytes + x * kBoxBytes, &map_k, kb,
                   x * kBoxCols, h, t * kFwdBlockK, b);
        mbar_expect_tx(vb, L::kTileBytes);
#pragma unroll
        for (int x = 0; x < kD / kBoxCols; ++x)
          tma_load(s_v + stage * L::kTileBytes + x * kBoxBytes, &map_v, vb,
                   x * kBoxCols, h, t * kFwdBlockK, b);
      }
    }
  } else {
    // -- consumers -----------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = threadIdx.x / 128 - 1;   // 0 or 1: rows 64 wg ..
    const int tw = threadIdx.x % 128;
    const int warp = tw / 32;
    const int lane = tw % 32;
    const int r_local = wg * 64 + warp * 16 + lane / 4;  // and r_local + 8
    const float scale_log2 = g.scale * 1.4426950408889634f;

    // One past the last key each of this thread's two rows sees (0 for a
    // row past sq); a masked tile keeps column c of row i iff c < lim[i].
    int lim[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + r_local + 8 * i;
      lim[i] = row >= g.sq ? 0
               : g.causal  ? max(0, min(g.sk, g.q_offset + row + 1))
                           : g.sk;
    }

    float acc[kD / 2];  // (64, kD) of this warpgroup: kD / 8 n-tiles x 4
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) acc[i] = 0.0f;
    float s[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY};  // running max of the raw scores
    float l[2] = {0.0f, 0.0f};  // this thread's share of each row's sum

    if (tiles.n > 0) mbar_wait(q_full, 0);
    for (int t = 0; t < tiles.n; ++t) {
      const int stage = t % kStages;
      const int parity = (t / kStages) & 1;
      const uint32_t sk_t = s_k + stage * L::kTileBytes;
      const uint32_t sv_t = s_v + stage * L::kTileBytes;

      // S = Q . K^T, k-step kk: 16 columns at byte 32 (kk % 4) of box kk / 4.
      mbar_wait(k_full + 8 * stage, parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        wgmma_ss_n128(s, wgmma_desc(s_q + wg * 64 * 128 + off, 16, 1024),
                      wgmma_desc(sk_t + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // The online softmax, its statistics on the raw scores: masked
      // entries are -inf, and each weight is exp2(s scale log2(e) - shift)
      // in one FMA, shift being the row's running max in the exp2 domain.
      if (t >= tiles.unmasked) {
        const int c0 = t * kFwdBlockK + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = c0 + 8 * j + (e & 1);
            if (col >= lim[e >> 1]) s[4 * j + e] = -INFINITY;
          }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
      float shift[2], corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        // A row with nothing visible yet keeps m = -inf: shift by 0, so
        // its weights stay exactly 0 and no inf - inf arises.
        shift[i] = mx[i] == -INFINITY ? 0.0f : mx[i] * scale_log2;
        corr[i] = exp2_approx(fmaf(m[i], scale_log2, -shift[i]));
        m[i] = mx[i];
        l[i] *= corr[i];
      }
      uint32_t pa[8][4];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = exp2_approx(fmaf(s[4 * j + e], scale_log2, -shift[e >> 1]));
          l[e >> 1] += p[e];
        }
        pa[j / 2][2 * (j % 2)] = pack_bf16(p[0], p[1]);
        pa[j / 2][2 * (j % 2) + 1] = pack_bf16(p[2], p[3]);
      }
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        acc[4 * j] *= corr[0];
        acc[4 * j + 1] *= corr[0];
        acc[4 * j + 2] *= corr[1];
        acc[4 * j + 3] *= corr[1];
      }

      // O += P . V, k-step kk: the 16 kv rows from 16 kk on, 2048 bytes a
      // step; the two 64-column boxes of d 128 lie kBoxBytes apart (LBO).
      mbar_wait(v_full + 8 * stage, parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint64_t desc = wgmma_desc(sv_t + kk * 2048, kBoxBytes, 1024);
        if constexpr (kD == 128)
          wgmma_rs_n128(acc, pa[kk], desc);
        else
          wgmma_rs_n64(acc, pa[kk], desc);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(empty + 8 * stage);
    }

    // Epilogue: o = acc / l through this warpgroup's own rows of Q's shared
    // memory (the same swizzled layout), then 16-byte stores of rows < sq.
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      inv[i] = 1.0f / (l[i] == 0.0f ? 1.0f : l[i]);
    }
    stage_rows<kD>(base_ptr + L::kQ, acc, inv, r_local, lane);
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    store_staged<kD>(o, base_ptr + L::kQ, wg, tw, b, h, q0, g.sq, g.heads);
    if (lane % 4 == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = q0 + r_local + 8 * i;
        if (row >= g.sq) continue;
        lse[static_cast<int64_t>(bh) * g.sq + row] =
            l[i] == 0.0f ? kNegInf : m[i] * g.scale + logf(l[i]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The backward on wgmma, fed by TMA rings (bf16 at head dims 64 and 128).
//
// Both kernels are the forward's three warpgroups: thread 0 of the
// producer starts every TMA copy, each consumer warpgroup owns 64 rows of
// the CTA's 128-row output tile, and a ring stage is released through its
// empty barrier once both consumers' last product that read it has been
// waited on. Shared memory starts at a 1024-byte boundary and every tile
// is a run of boxes of 64 columns (128 bytes) under the 128-byte swizzle,
// as in the forward; a 64-row box is 8 KB.
//
// dq (a CTA per 128-row q tile): Q, dO, then kStages x K and x V of 128
// rows, then the barriers qdo_full, k_full[], v_full[], empty[].
// dk/dv (a CTA per 128-row kv tile): K, V, then kStages x Q and x dO of 64
// rows, kStages x (lse[64], delta[64]) as fp32, then the barriers kv_full,
// full[], empty[]. A stage's full barrier counts the 32 threads of the
// producer's first warp, which store its lse and delta before they arrive;
// thread 0's arrival also expects the bytes of the stage's Q and dO boxes.
// ---------------------------------------------------------------------------

constexpr int kBwdBlockQ = 64;    // q rows of a dk/dv ring stage
constexpr int kBwdBlockK = 128;   // kv rows of a dk/dv CTA, 64 per consumer
constexpr int kQBoxBytes = kBwdBlockQ * kBoxCols * 2;  // 8 KB
// setmaxnreg's split: 128 x 24 + 256 x 240 = 64,512 registers; a consumer
// holds 192 fp32 accumulators (dQ, S and dP; or dK, dV, S^T and dP^T).
constexpr int kBwdProducerRegs = 24;
constexpr int kBwdConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;

template <int kD>
struct DqLayout {
  static_assert(kD == 64 || kD == 128, "the wgmma dq takes d 64, 128");
  static constexpr int kStages = kD == 128 ? 2 : 3;
  static constexpr int kTileBytes = (kD / kBoxCols) * kBoxBytes;  // 128 rows
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + kTileBytes;
  static constexpr int kK = kDo + kTileBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  // qdo_full, k_full[kStages], v_full[kStages], empty[kStages]
  static constexpr int kSmem = kBar + (1 + 3 * kStages) * 8 + 1024;
};

template <int kD>
struct DkvLayout {
  static_assert(kD == 64 || kD == 128, "the wgmma dk/dv takes d 64, 128");
  static constexpr int kStages = 3;
  static constexpr int kKvBytes = (kD / kBoxCols) * kBoxBytes;   // 128 rows
  static constexpr int kQBytes = (kD / kBoxCols) * kQBoxBytes;   // 64 rows
  static constexpr int kStatsBytes = 2 * kBwdBlockQ * 4;  // lse, delta
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKvBytes;
  static constexpr int kQ = kV + kKvBytes;
  static constexpr int kDo = kQ + kStages * kQBytes;
  static constexpr int kStats = kDo + kStages * kQBytes;
  static constexpr int kBar = kStats + kStages * kStatsBytes;
  // kv_full, full[kStages], empty[kStages]
  static constexpr int kSmem = kBar + (1 + 2 * kStages) * 8 + 1024;
};

// The 64-row q tiles a dk/dv CTA over keys [k0, k0 + 128) walks, [begin,
// end), and those that need no mask, [lo, hi): tile t is seen whole iff
// all its rows lie below sq, all the CTA's keys below sk, and its first
// row sees the CTA's last key. The walk starts at the tile of the first
// row that sees key k0 and is empty if no row does.
struct DkvTiles {
  int begin, end, lo, hi;
};

__device__ __forceinline__ DkvTiles dkv_tiles(const Geometry& g, int k0) {
  const int n_q = (g.sq + kBwdBlockQ - 1) / kBwdBlockQ;
  const int hi = k0 + kBwdBlockK <= g.sk ? g.sq / kBwdBlockQ : 0;
  if (!g.causal) return DkvTiles{0, n_q, 0, hi};
  const int first = max(0, k0 - g.q_offset);
  if (first >= g.sq) return DkvTiles{0, 0, 0, 0};
  const int last = k0 + kBwdBlockK - 1 - g.q_offset;
  const int lo = last <= 0 ? 0 : (last + kBwdBlockQ - 1) / kBwdBlockQ;
  return DkvTiles{first / kBwdBlockQ, n_q, lo, hi};
}

template <int kD>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_do,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dq, Geometry g, int group) {
  using L = DqLayout<kD>;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char dq_smem[];
  const uint32_t raw = smem_u32(dq_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* base_ptr = dq_smem + (base - raw);
  const uint32_t qdo_full = base + L::kBar;
  const uint32_t k_full = qdo_full + 8;                // + 8 * stage
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t empty = v_full + 8 * kStages;

  // The longest causal rows first: the last q tiles.
  const Dispatch place = dispatch(group);
  const int q0 = (gridDim.x - 1 - place.rank) * kFwdBlockQ;
  const int bh = place.bh;
  const int b = bh / g.heads;
  const int h = bh % g.heads;
  const FwdTiles tiles = fwd_tiles(g, q0);   // 128-row kv stages

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // -- producer ------------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kBwdProducerRegs));
    if (threadIdx.x == 0 && tiles.n > 0) {
      mbar_expect_tx(qdo_full, 2 * L::kTileBytes);
#pragma unroll
      for (int x = 0; x < kD / kBoxCols; ++x) {
        tma_load(base + L::kQ + x * kBoxBytes, &map_q, qdo_full,
                 x * kBoxCols, h, q0, b);
        tma_load(base + L::kDo + x * kBoxBytes, &map_do, qdo_full,
                 x * kBoxCols, h, q0, b);
      }
      for (int t = 0; t < tiles.n; ++t) {
        const int stage = t % kStages;
        mbar_wait(empty + 8 * stage, ((t / kStages) & 1) ^ 1);
        const uint32_t kb = k_full + 8 * stage, vb = v_full + 8 * stage;
        mbar_expect_tx(kb, L::kTileBytes);
#pragma unroll
        for (int x = 0; x < kD / kBoxCols; ++x)
          tma_load(base + L::kK + stage * L::kTileBytes + x * kBoxBytes,
                   &map_k, kb, x * kBoxCols, h, t * kFwdBlockK, b);
        mbar_expect_tx(vb, L::kTileBytes);
#pragma unroll
        for (int x = 0; x < kD / kBoxCols; ++x)
          tma_load(base + L::kV + stage * L::kTileBytes + x * kBoxBytes,
                   &map_v, vb, x * kBoxCols, h, t * kFwdBlockK, b);
      }
    }
  } else {
    // -- consumers -----------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kBwdConsumerRegs));
    const int wg = threadIdx.x / 128 - 1;   // 0 or 1: rows 64 wg ..
    const int tw = threadIdx.x % 128;
    const int warp = tw / 32;
    const int lane = tw % 32;
    const int r_local = wg * 64 + warp * 16 + lane / 4;  // and r_local + 8
    const float scale_log2 = g.scale * kLog2e;

    // Per row of this thread: one past the last key it sees (a masked tile
    // keeps column c iff c < lim), lse log2(e) and delta; a row past sq
    // keeps nothing and has lse = delta = 0, a row whose lse is -1e30 uses
    // 0 (its weights are masked to 0 anyway).
    int lim[2];
    float lse2[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + r_local + 8 * i;
      lim[i] = row >= g.sq ? 0
               : g.causal  ? max(0, min(g.sk, g.q_offset + row + 1))
                           : g.sk;
      lse2[i] = dl[i] = 0.0f;
      if (row < g.sq) {
        const float l = lse[static_cast<int64_t>(bh) * g.sq + row];
        lse2[i] = l <= kNegInf / 2 ? 0.0f : l * kLog2e;
        dl[i] = delta[static_cast<int64_t>(bh) * g.sq + row];
      }
    }

    const uint32_t s_q = base + L::kQ + wg * 64 * 128;   // this consumer's
    const uint32_t s_do = base + L::kDo + wg * 64 * 128; // rows of Q and dO
    float acc[kD / 2];  // dQ (64, kD) of this warpgroup
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) acc[i] = 0.0f;
    float s[64], dp[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = dp[i] = 0.0f;

    if (tiles.n > 0) mbar_wait(qdo_full, 0);
    for (int t = 0; t < tiles.n; ++t) {
      const int stage = t % kStages;
      const int parity = (t / kStages) & 1;
      const uint32_t sk_t = base + L::kK + stage * L::kTileBytes;
      const uint32_t sv_t = base + L::kV + stage * L::kTileBytes;

      // S = Q . K^T and dP = dO . V^T; k-step kk: 16 columns at byte
      // 32 (kk % 4) of box kk / 4.
      mbar_wait(k_full + 8 * stage, parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        wgmma_ss_n128(s, wgmma_desc(s_q + off, 16, 1024),
                      wgmma_desc(sk_t + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      mbar_wait(v_full + 8 * stage, parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        wgmma_ss_n128(dp, wgmma_desc(s_do + off, 16, 1024),
                      wgmma_desc(sv_t + off, 16, 1024), kk > 0);
      }
      wgmma_commit();

      // P = exp2(S scale log2(e) - lse log2(e)) while dP runs, the mask
      // only on tiles that cross the diagonal or sk.
      wgmma_wait<1>();
      fence_regs(s);
      const bool masked = t >= tiles.unmasked;
      const int c0 = t * kFwdBlockK + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              exp2_approx(fmaf(s[4 * j + e], scale_log2, -lse2[e >> 1]));
          s[4 * j + e] =
              masked && c0 + 8 * j + (e & 1) >= lim[e >> 1] ? 0.0f : p;
        }

      // dS = P (dP - delta), rounded to bf16 as the A fragments of
      // dQ += dS . K.
      wgmma_wait<0>();
      fence_regs(dp);
      uint32_t da[8][4];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[e] = s[4 * j + e] * (dp[4 * j + e] - dl[e >> 1]);
        da[j / 2][2 * (j % 2)] = pack_bf16(ds[0], ds[1]);
        da[j / 2][2 * (j % 2) + 1] = pack_bf16(ds[2], ds[3]);
      }

      // dQ += dS . K, k-step kk: the 16 kv rows from 16 kk on, K read
      // MN-major (its two 64-column boxes kBoxBytes apart at d 128).
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint64_t desc = wgmma_desc(sk_t + kk * 2048, kBoxBytes, 1024);
        if constexpr (kD == 128)
          wgmma_rs_n128(acc, da[kk], desc);
        else
          wgmma_rs_n64(acc, da[kk], desc);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(empty + 8 * stage);
    }

    // Epilogue: dq = acc scale through this warpgroup's own rows of Q.
    const float mul[2] = {g.scale, g.scale};
    stage_rows<kD>(base_ptr + L::kQ, acc, mul, r_local, lane);
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    store_staged<kD>(dq, base_ptr + L::kQ, wg, tw, b, h, q0, g.sq, g.heads);
  }
}

template <int kD>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const __grid_constant__ CUtensorMap map_do,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           Geometry g, int group) {
  using L = DkvLayout<kD>;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char dkv_smem[];
  const uint32_t raw = smem_u32(dkv_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* base_ptr = dkv_smem + (base - raw);
  const uint32_t kv_full = base + L::kBar;
  const uint32_t full = kv_full + 8;                   // + 8 * stage
  const uint32_t empty = full + 8 * kStages;

  // The longest causal walks first: the first kv tiles.
  const Dispatch place = dispatch(group);
  const int k0 = place.rank * kBwdBlockK;
  const int bh = place.bh;
  const int b = bh / g.heads;
  const int h = bh % g.heads;
  const DkvTiles tiles = dkv_tiles(g, k0);
  const int n = tiles.end - tiles.begin;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 32);        // the producer's first warp
      mbar_init(empty + 8 * s, 2 * 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // -- producer ------------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kBwdProducerRegs));
    const int lane = threadIdx.x;
    if (lane < 32 && n > 0) {
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * L::kKvBytes);
#pragma unroll
        for (int x = 0; x < kD / kBoxCols; ++x) {
          tma_load(base + L::kK + x * kBoxBytes, &map_k, kv_full,
                   x * kBoxCols, h, k0, b);
          tma_load(base + L::kV + x * kBoxBytes, &map_v, kv_full,
                   x * kBoxCols, h, k0, b);
        }
      }
      for (int i = 0; i < n; ++i) {
        const int stage = i % kStages;
        const int q0 = (tiles.begin + i) * kBwdBlockQ;
        mbar_wait(empty + 8 * stage, ((i / kStages) & 1) ^ 1);
        // lse log2(e) and delta of the stage's rows: 0 past sq, and lse 0
        // for a row that sees no key (-1e30).
        float* stats = reinterpret_cast<float*>(base_ptr + L::kStats +
                                                stage * L::kStatsBytes);
        for (int r = lane; r < kBwdBlockQ; r += 32) {
          const int row = q0 + r;
          float l = 0.0f, dl = 0.0f;
          if (row < g.sq) {
            const int64_t idx = static_cast<int64_t>(bh) * g.sq + row;
            l = lse[idx];
            l = l <= kNegInf / 2 ? 0.0f : l * kLog2e;
            dl = delta[idx];
          }
          stats[r] = l;
          stats[kBwdBlockQ + r] = dl;
        }
        const uint32_t bar = full + 8 * stage;
        if (lane == 0) {
          mbar_expect_tx(bar, 2 * L::kQBytes);
#pragma unroll
          for (int x = 0; x < kD / kBoxCols; ++x) {
            tma_load(base + L::kQ + stage * L::kQBytes + x * kQBoxBytes,
                     &map_q, bar, x * kBoxCols, h, q0, b);
            tma_load(base + L::kDo + stage * L::kQBytes + x * kQBoxBytes,
                     &map_do, bar, x * kBoxCols, h, q0, b);
          }
        } else {
          mbar_arrive(bar);
        }
      }
    }
  } else {
    // -- consumers -----------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kBwdConsumerRegs));
    const int wg = threadIdx.x / 128 - 1;   // 0 or 1: keys 64 wg ..
    const int tw = threadIdx.x % 128;
    const int warp = tw / 32;
    const int lane = tw % 32;
    const int r_local = wg * 64 + warp * 16 + lane / 4;  // and r_local + 8
    const float scale_log2 = g.scale * kLog2e;

    // Per key of this thread, the first query that sees it: a masked tile
    // keeps query q iff from <= q < sq (a key past sk keeps none).
    int from[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = k0 + r_local + 8 * i;
      from[i] = key >= g.sk ? g.sq
                : g.causal  ? min(g.sq, max(0, key - g.q_offset))
                            : 0;
    }

    const uint32_t s_k = base + L::kK + wg * 64 * 128;   // this consumer's
    const uint32_t s_v = base + L::kV + wg * 64 * 128;   // keys of K and V
    float dk_acc[kD / 2], dv_acc[kD / 2];  // (64, kD) of this warpgroup
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;
    float st[32], dpt[32];  // S^T, dP^T: keys by this stage's 64 queries
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.0f;

    if (n > 0) mbar_wait(kv_full, 0);
    for (int i = 0; i < n; ++i) {
      const int t = tiles.begin + i;
      const int stage = i % kStages;
      const uint32_t sq_t = base + L::kQ + stage * L::kQBytes;
      const uint32_t sdo_t = base + L::kDo + stage * L::kQBytes;
      const float* stats = reinterpret_cast<const float*>(
          base_ptr + L::kStats + stage * L::kStatsBytes);

      // S^T = K . Q^T and dP^T = V . dO^T, both operands K-major; k-step
      // kk: 16 columns at byte 32 (kk % 4) of box kk / 4.
      mbar_wait(full + 8 * stage, (i / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t kv_off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        const uint32_t q_off = (kk / 4) * kQBoxBytes + (kk % 4) * 32;
        wgmma_ss_n64(st, wgmma_desc(s_k + kv_off, 16, 1024),
                     wgmma_desc(sq_t + q_off, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t kv_off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        const uint32_t q_off = (kk / 4) * kQBoxBytes + (kk % 4) * 32;
        wgmma_ss_n64(dpt, wgmma_desc(s_v + kv_off, 16, 1024),
                     wgmma_desc(sdo_t + q_off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // P^T = exp2(S^T scale log2(e) - lse log2(e)), the mask only on
      // tiles that cross the diagonal, sq or sk; dS^T = P^T (dP^T - delta)
      // with P^T in fp32 (attention.py:441). Both rounded to bf16 as the A
      // fragments of the next products (attention.py:436).
      const bool masked = t < tiles.lo || t >= tiles.hi;
      const int c0 = t * kBwdBlockQ + 2 * (lane % 4);
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * (lane % 4);
        const float2 l2 = *reinterpret_cast<const float2*>(stats + col);
        const float2 d2 =
            *reinterpret_cast<const float2*>(stats + kBwdBlockQ + col);
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = exp2_approx(
              fmaf(st[4 * j + e], scale_log2, -((e & 1) ? l2.y : l2.x)));
          if (masked) {
            const int q = c0 + 8 * j + (e & 1);
            if (q < from[e >> 1] || q >= g.sq) p[e] = 0.0f;
          }
          ds[e] = p[e] * (dpt[4 * j + e] - ((e & 1) ? d2.y : d2.x));
        }
        pa[j / 2][2 * (j % 2)] = pack_bf16(p[0], p[1]);
        pa[j / 2][2 * (j % 2) + 1] = pack_bf16(p[2], p[3]);
        da[j / 2][2 * (j % 2)] = pack_bf16(ds[0], ds[1]);
        da[j / 2][2 * (j % 2) + 1] = pack_bf16(ds[2], ds[3]);
      }

      // dV += P^T . dO and dK += dS^T . Q, k-step kk: the stage's 16 q rows
      // from 16 kk on, dO and Q read MN-major (their two 64-column boxes
      // kQBoxBytes apart at d 128).
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBwdBlockQ / 16; ++kk) {
        const uint64_t bdo = wgmma_desc(sdo_t + kk * 2048, kQBoxBytes, 1024);
        const uint64_t bq = wgmma_desc(sq_t + kk * 2048, kQBoxBytes, 1024);
        if constexpr (kD == 128) {
          wgmma_rs_n128(dv_acc, pa[kk], bdo);
          wgmma_rs_n128(dk_acc, da[kk], bq);
        } else {
          wgmma_rs_n64(dv_acc, pa[kk], bdo);
          wgmma_rs_n64(dk_acc, da[kk], bq);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      mbar_arrive(empty + 8 * stage);
    }

    // Epilogue: dk = dk_acc scale and dv = dv_acc through this warpgroup's
    // own rows of K and V.
    const float scale[2] = {g.scale, g.scale}, one[2] = {1.0f, 1.0f};
    stage_rows<kD>(base_ptr + L::kK, dk_acc, scale, r_local, lane);
    stage_rows<kD>(base_ptr + L::kV, dv_acc, one, r_local, lane);
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    store_staged<kD>(dk, base_ptr + L::kK, wg, tw, b, h, k0, g.sk, g.heads);
    store_staged<kD>(dv, base_ptr + L::kV, wg, tw, b, h, k0, g.sk, g.heads);
  }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

// bf16 at head dim 64 or 128 runs on the tensor cores; everything else on
// the fp32 kernels above.
constexpr bool tensor_core_route(int dtype, int d) {
  return dtype == 1 && (d == 64 || d == 128);
}

constexpr int smem_bytes(int which, int dtype, int d) {
  if (tensor_core_route(dtype, d)) {
    if (which == kFwd)
      return d == 128 ? FwdLayout<128>::kSmem : FwdLayout<64>::kSmem;
    if (which == kDq)
      return d == 128 ? DqLayout<128>::kSmem : DqLayout<64>::kSmem;
    return d == 128 ? DkvLayout<128>::kSmem : DkvLayout<64>::kSmem;
  }
  const int ld = d + 1;
  int floats = 0;
  if (which == kFwd) floats = 2 * kTile * ld + kTile * kLdS + 3 * kTile;
  if (which == kDq) floats = 4 * kTile * ld + kTile * kLdS + 2 * kTile;
  if (which == kDkv) floats = 4 * kTile * ld + 2 * kTile * kLdS + 2 * kTile;
  return floats * static_cast<int>(sizeof(float));
}

// Every kernel fits one CTA's opt-in shared memory on Hopper (227 KB) at
// the largest head dim the entries take, so no launch can ask for more.
constexpr int kMaxSmemBytes = 232448;
static_assert(smem_bytes(kFwd, 0, kMaxD) <= kMaxSmemBytes &&
                  smem_bytes(kDq, 0, kMaxD) <= kMaxSmemBytes &&
                  smem_bytes(kDkv, 0, kMaxD) <= kMaxSmemBytes &&
                  smem_bytes(kFwd, 1, kMaxD) <= kMaxSmemBytes &&
                  smem_bytes(kDq, 1, kMaxD) <= kMaxSmemBytes &&
                  smem_bytes(kDkv, 1, kMaxD) <= kMaxSmemBytes,
              "a flash kernel needs more shared memory than a CTA may use");

constexpr int kMaxDevices = 64;

// Past 48 KB a kernel's dynamic shared memory must be allowed explicitly,
// per device and per kernel; it is raised once to the device's opt-in
// maximum (`done` is the caller's, one per kernel), so later launches make
// no attribute calls.
template <typename Kernel>
cudaError_t allow_max_smem(Kernel kernel, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  int max_optin = 0;
  err = cudaDeviceGetAttribute(&max_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             max_optin);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

// Launch `kernel` with each untyped argument cast to its parameter type;
// returns cudaGetLastError() after the launch.
template <typename... Params, typename... Args>
int start(void (*kernel)(Params...), bool (&done)[kMaxDevices], dim3 grid,
          int threads, int smem, cudaStream_t stream, Args... args) {
  const cudaError_t err = allow_max_smem(kernel, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, stream>>>(static_cast<Params>(args)...);
  return static_cast<int>(cudaGetLastError());
}

Geometry geometry(int sq, int sk, int heads, int d, int causal,
                  int q_offset) {
  return Geometry{sq, sk, heads, d, causal, q_offset,
                  1.0f / sqrtf(static_cast<float>(d))};
}

dim3 grid_of(int rows, int batch, int heads, int tile = kTile) {
  return dim3(static_cast<unsigned>((rows + tile - 1) / tile),
              static_cast<unsigned>(batch * heads));
}

// cuTensorMapEncodeTiled, through the runtime's entry-point query (the
// library is not linked against libcuda); its ABI is CUDA 12.0's.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

int encode_tiled(EncodeTiled* fn) {
  static EncodeTiled found = nullptr;
  if (found == nullptr) {
    void* entry = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &entry, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &entry, cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess) return static_cast<int>(err);
    if (status != cudaDriverEntryPointSuccess || entry == nullptr)
      return kTensorMapError + static_cast<int>(CUDA_ERROR_NOT_FOUND);
    found = reinterpret_cast<EncodeTiled>(entry);
  }
  *fn = found;
  return 0;
}

// A rank-4 map over a contiguous bf16 (batch, s_len, heads, d) tensor:
// dims (d, heads, s_len, batch), boxes of 64 columns x `rows` rows of one
// head, 128-byte swizzle, out-of-bounds boxes zero-filled.
int encode_rows(EncodeTiled fn, CUtensorMap* map, const void* ptr, int batch,
                int s_len, int heads, int d, int rows) {
  const cuuint64_t elem = sizeof(bf16);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s_len),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {d * elem, heads * d * elem,
                                 static_cast<cuuint64_t>(s_len) * heads * d *
                                     elem};
  const cuuint32_t box[4] = {kBoxCols, 1, static_cast<cuuint32_t>(rows),
                             1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, steps,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + static_cast<int>(r);
}

// (batch, head) pairs of one dispatch group of the wgmma forward: enough
// for about one wave of the card's SMs (one CTA an SM) over n_q_tiles q
// tiles each, at least 1.
int fwd_group(int n_q_tiles, int* group) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *group = sms / n_q_tiles > 1 ? sms / n_q_tiles : 1;
  return static_cast<int>(err);
}

// The wgmma forward: q, k, v's maps, then the launch. With sk == 0 no
// tile is walked, and k and v's maps are q's (an empty tensor has no
// address to encode).
template <int kD>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* o,
                     void* lse, int batch, const Geometry& g,
                     cudaStream_t stream) {
  const dim3 grid = grid_of(g.sq, batch, g.heads, kFwdBlockQ);
  int group = 1;
  int err = fwd_group(static_cast<int>(grid.x), &group);
  if (err) return err;
  EncodeTiled fn = nullptr;
  err = encode_tiled(&fn);
  if (err) return err;
  CUtensorMap maps[3];
  const void* kv[2] = {g.sk > 0 ? k : q, g.sk > 0 ? v : q};
  const int kv_len = g.sk > 0 ? g.sk : g.sq;
  err = encode_rows(fn, &maps[0], q, batch, g.sq, g.heads, kD, kFwdBlockQ);
  for (int i = 0; i < 2 && !err; ++i)
    err = encode_rows(fn, &maps[1 + i], kv[i], batch, kv_len, g.heads, kD,
                      kFwdBlockK);
  if (err) return err;
  static bool done[kMaxDevices] = {};
  return start(flash_fwd_wgmma_kernel<kD>, done, grid, kFwdThreads,
               FwdLayout<kD>::kSmem, stream, maps[0], maps[1], maps[2], o,
               lse, g, group);
}

// The maps of q, k, v and dO for a wgmma backward kernel: q and dO in
// boxes of q_rows rows, k and v of kv_rows. A tensor of length 0 is never
// loaded, and its map is the other's (an empty tensor has no address to
// encode).
int encode_bwd(CUtensorMap (&maps)[4], const void* q, const void* k,
               const void* v, const void* dout, int batch, const Geometry& g,
               int q_rows, int kv_rows) {
  EncodeTiled fn = nullptr;
  int err = encode_tiled(&fn);
  if (err) return err;
  const bool has_q = g.sq > 0, has_kv = g.sk > 0;
  const void* ptr[4] = {has_q ? q : k, has_kv ? k : q, has_kv ? v : q,
                        has_q ? dout : k};
  const int len[4] = {has_q ? g.sq : g.sk, has_kv ? g.sk : g.sq,
                      has_kv ? g.sk : g.sq, has_q ? g.sq : g.sk};
  const int rows[4] = {q_rows, kv_rows, kv_rows, q_rows};
  for (int i = 0; i < 4 && !err; ++i)
    err = encode_rows(fn, &maps[i], ptr[i], batch, len[i], g.heads, g.d,
                      rows[i]);
  return err;
}

template <int kD>
int launch_dq_wgmma(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dq, int batch, const Geometry& g,
                    cudaStream_t stream) {
  const dim3 grid = grid_of(g.sq, batch, g.heads, kFwdBlockQ);
  int group = 1;
  int err = fwd_group(static_cast<int>(grid.x), &group);
  if (err) return err;
  CUtensorMap maps[4];
  err = encode_bwd(maps, q, k, v, dout, batch, g, kFwdBlockQ, kFwdBlockK);
  if (err) return err;
  static bool done[kMaxDevices] = {};
  return start(flash_bwd_dq_wgmma_kernel<kD>, done, grid, kFwdThreads,
               DqLayout<kD>::kSmem, stream, maps[0], maps[1], maps[2],
               maps[3], lse, delta, dq, g, group);
}

template <int kD>
int launch_dkv_wgmma(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int batch, const Geometry& g,
                     cudaStream_t stream) {
  const dim3 grid = grid_of(g.sk, batch, g.heads, kBwdBlockK);
  int group = 1;
  int err = fwd_group(static_cast<int>(grid.x), &group);
  if (err) return err;
  CUtensorMap maps[4];
  err = encode_bwd(maps, q, k, v, dout, batch, g, kBwdBlockQ, kBwdBlockK);
  if (err) return err;
  static bool done[kMaxDevices] = {};
  return start(flash_bwd_dkv_wgmma_kernel<kD>, done, grid, kFwdThreads,
               DkvLayout<kD>::kSmem, stream, maps[0], maps[1], maps[2],
               maps[3], lse, delta, dk, dv, g, group);
}

// CTAs of a 384-thread wgmma kernel at `smem` bytes that fit one SM. A
// query: it raises the kernel's shared memory limit every time (kernels of
// one signature share the type Kernel, so a cache here would mix them up).
template <typename Kernel>
int ctas_per_sm(Kernel kernel, int smem, int* ctas) {
  bool done[kMaxDevices] = {};
  const cudaError_t err = allow_max_smem(kernel, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, kernel, kFwdThreads, smem));
}

bool bad_args(int dtype, int d) {
  return (dtype != 0 && dtype != 1) || d < 8 || d > kMaxD || d % 8 != 0;
}

}  // namespace

extern "C" {

// 1 if dtype and head dim d run on the tensor-core kernels, else 0.
int tt_flash_tensor_cores(int dtype, int d) {
  return tensor_core_route(dtype, d) ? 1 : 0;
}

// CTAs of a wgmma kernel (which: 0 = forward, 1 = dq, 2 = dk/dv; bf16 at
// head dim d, 64 or 128) that fit one SM, into *ctas; returns a CUDA
// error code (0 = answered).
int tt_flash_ctas_per_sm(int which, int d, void* ctas) {
  int* out = static_cast<int*>(ctas);
  if (!tensor_core_route(1, d) || which < kFwd || which > kDkv)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(which, 1, d);
  if (which == kFwd)
    return d == 128 ? ctas_per_sm(flash_fwd_wgmma_kernel<128>, smem, out)
                    : ctas_per_sm(flash_fwd_wgmma_kernel<64>, smem, out);
  if (which == kDq)
    return d == 128 ? ctas_per_sm(flash_bwd_dq_wgmma_kernel<128>, smem, out)
                    : ctas_per_sm(flash_bwd_dq_wgmma_kernel<64>, smem, out);
  return d == 128 ? ctas_per_sm(flash_bwd_dkv_wgmma_kernel<128>, smem, out)
                  : ctas_per_sm(flash_bwd_dkv_wgmma_kernel<64>, smem, out);
}

// Dynamic shared memory of a wgmma kernel (which as above) at head dim d
// (64 or 128), else 0.
int tt_flash_smem_bytes(int which, int d) {
  return tensor_core_route(1, d) && which >= kFwd && which <= kDkv
             ? smem_bytes(which, 1, d)
             : 0;
}

// dtype: 0 = fp32, 1 = bf16. Each entry returns cudaGetLastError() after
// its launch (0 = launched), or cudaErrorInvalidValue for a type or head
// dim it does not take; nothing is synchronised. The wgmma forward may
// also return kTensorMapError + the CUresult of a tensor map that failed
// to encode.
int tt_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                 void* o, void* lse, int batch, int sq, int sk, int heads,
                 int d, int causal, int q_offset, void* stream) {
  if (bad_args(dtype, d)) return static_cast<int>(cudaErrorInvalidValue);
  if (batch * heads == 0 || sq == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geometry g = geometry(sq, sk, heads, d, causal, q_offset);
  const dim3 grid = grid_of(sq, batch, heads);
  const int smem = smem_bytes(kFwd, dtype, d);
  if (dtype == 0) {
    static bool done[kMaxDevices] = {};
    return start(flash_fwd_kernel<float>, done, grid, kThreads, smem, s, q,
                 k, v, o, lse, g);
  }
  if (d == 128) return launch_fwd_wgmma<128>(q, k, v, o, lse, batch, g, s);
  if (d == 64) return launch_fwd_wgmma<64>(q, k, v, o, lse, batch, g, s);
  static bool done[kMaxDevices] = {};
  return start(flash_fwd_kernel<bf16>, done, grid, kThreads, smem, s, q, k,
               v, o, lse, g);
}

int tt_flash_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dq, int batch, int sq, int sk, int heads, int d,
                    int causal, int q_offset, void* stream) {
  if (bad_args(dtype, d)) return static_cast<int>(cudaErrorInvalidValue);
  if (batch * heads == 0 || sq == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geometry g = geometry(sq, sk, heads, d, causal, q_offset);
  const dim3 grid = grid_of(sq, batch, heads);
  const int smem = smem_bytes(kDq, dtype, d);
  if (dtype == 0) {
    static bool done[kMaxDevices] = {};
    return start(flash_bwd_dq_kernel<float>, done, grid, kThreads, smem, s,
                 q, k, v, dout, lse, delta, dq, g);
  }
  if (d == 128)
    return launch_dq_wgmma<128>(q, k, v, dout, lse, delta, dq, batch, g, s);
  if (d == 64)
    return launch_dq_wgmma<64>(q, k, v, dout, lse, delta, dq, batch, g, s);
  static bool done[kMaxDevices] = {};
  return start(flash_bwd_dq_kernel<bf16>, done, grid, kThreads, smem, s, q,
               k, v, dout, lse, delta, dq, g);
}

int tt_flash_bwd_dkv(int dtype, const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int batch, int sq, int sk,
                     int heads, int d, int causal, int q_offset,
                     void* stream) {
  if (bad_args(dtype, d)) return static_cast<int>(cudaErrorInvalidValue);
  if (batch * heads == 0 || sk == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geometry g = geometry(sq, sk, heads, d, causal, q_offset);
  const dim3 grid = grid_of(sk, batch, heads);
  const int smem = smem_bytes(kDkv, dtype, d);
  if (dtype == 0) {
    static bool done[kMaxDevices] = {};
    return start(flash_bwd_dkv_kernel<float>, done, grid, kThreads, smem, s,
                 q, k, v, dout, lse, delta, dk, dv, g);
  }
  if (d == 128)
    return launch_dkv_wgmma<128>(q, k, v, dout, lse, delta, dk, dv, batch, g,
                                 s);
  if (d == 64)
    return launch_dkv_wgmma<64>(q, k, v, dout, lse, delta, dk, dv, batch, g,
                                s);
  static bool done[kMaxDevices] = {};
  return start(flash_bwd_dkv_kernel<bf16>, done, grid, kThreads, smem, s, q,
               k, v, dout, lse, delta, dk, dv, g);
}

const char* tt_cuda_error_string(int code) {
  if (code >= kTensorMapError) {
    static thread_local char text[96];
    snprintf(text, sizeof(text),
             "cuTensorMapEncodeTiled failed with CUresult %d",
             code - kTensorMapError);
    return text;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
