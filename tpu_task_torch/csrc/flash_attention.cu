// Flash attention for Hopper (sm_90a), hand-written CUDA C++: the forward
// and the two backward kernels of one library.
//
// Replaces the TPU kernels of tpu_task/ml/ops/attention.py:
//   flash_fwd_kernel     <- _flash_fwd_kernel      (called by flash_attention)
//   flash_bwd_dq_kernel  <- _flash_bwd_dq_kernel   (_flash_bwd_with_stats)
//   flash_bwd_dkv_kernel <- _flash_bwd_dkv_kernel  (_flash_bwd_with_stats)
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
// Design. The TPU grid walks kv blocks in order and carries (m, l, acc) in
// VMEM from one grid step to the next; here blocks run in parallel and in
// no order, so a CTA owns one 64-row output tile and loops over the other
// operand's 64-row tiles itself:
//   - forward and dq: a CTA per (q tile, batch x head); the loop over kv
//     tiles stops at the last one the tile's last row can see. q tiles are
//     handed out last first, so the long causal rows start first.
//   - dk/dv: a CTA per (kv tile, batch x head); the loop over q tiles starts
//     at the first that reaches the diagonal. Every output tile has exactly
//     one owner, so there are no atomics and the result is deterministic.
// Two routes share that structure:
//   - bf16 at head dim 64 or 128 (the model's shapes): 4 warps, each owning
//     16 rows, with every product on the tensor cores (mma.sync m16n8k16,
//     bf16 operands, fp32 sums) from bf16 tiles in shared memory read with
//     ldmatrix. Scores, the online softmax and ds stay in registers in fp32;
//     p and ds are rounded to bf16 as A operands of the next product, as the
//     TPU kernels round them (attention.py:248, :387, :436, :441).
//   - fp32, and bf16 at other head dims: 256 threads on the fp32 cores, with
//     tiles staged as fp32 rows padded to d + 1 floats, each thread holding
//     a 4 x 4 block of the 64 x 64 score tile and a 4 x 8 block of the
//     (64, d) accumulator; one warp per row for the online softmax. fp32
//     needs fp32 products: TF32 tensor cores would miss the 2e-5 pin.
//
// Bound, at the flagship train shape (b 8, s 1024, h 8, d 128, bf16,
// causal): operations. The forward executes 2 products of 8.6 GFLOP each
// after the causal halving (17.2 GFLOP, 17 us at 989 TFLOP/s) against 67 MB
// of q, k, v and o (20 us at 3.35 TB/s); dq executes 3 products and dk/dv 4
// (26 and 35 us). What the tensor-core route leaves on the table: mma.sync
// is Hopper's older, synchronous tensor-core path (wgmma reaches the full
// rate); a tile's loads are plain loads that no math overlaps (cp.async or
// TMA double buffering would hide them); and dq and dk/dv each recompute
// the scores. Those are a later change's work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// One past the last key a q tile whose rows are [q0, q0 + kTile) can see.
__device__ __forceinline__ int key_end(const Geometry& g, int q0) {
  if (!g.causal) return g.sk;
  const int last_row = min(q0 + kTile, g.sq) - 1;
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
// bf16 on the tensor cores (head dims 64 and 128): warp-level mma.sync.
//
// A CTA of 4 warps owns the same 64-row output tile as above; each warp owns
// 16 of its rows. Tiles sit in shared memory as bf16 rows padded by 8
// elements (16 bytes), so the 8 rows an ldmatrix reads fall in distinct
// banks. Every product is mma.m16n8k16 with bf16 operands and fp32 sums:
// scores and dP as A . B^T with both operands from shared memory, and the
// weights (p, or ds in the backward) times V, K, Q or dO with the weights
// in registers, turned from the accumulator layout straight into A
// fragments and rounded to bf16 on the way, as the TPU kernels round p and
// ds to the input type before their products. The softmax statistics and
// every elementwise step stay fp32.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMmaThreads = 128;  // 4 warps x 16 tile rows
constexpr int kPadH = 8;          // bf16 row padding of a shared tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c += a . b for one m16n8k16 tile: a row-major, b column-major, fp32 c.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// kTile rows of head h from row0 on, as bf16 rows of stride kD + kPadH, in
// 16-byte vectors; rows past s_len are zero.
template <int kD>
__device__ __forceinline__ void load_tile_bf16(const bf16* __restrict__ src,
                                               bf16* __restrict__ dst, int b,
                                               int h, int row0, int s_len,
                                               int heads) {
  constexpr int kVecs = kD / 8;
  for (int e = threadIdx.x; e < kTile * kVecs; e += kMmaThreads) {
    const int r = e / kVecs;
    const int c = (e % kVecs) * 8;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < s_len)
      val = *reinterpret_cast<const uint4*>(
          src + row_offset(b, row, s_len, heads, h, kD) + c);
    *reinterpret_cast<uint4*>(dst + r * (kD + kPadH) + c) = val;
  }
}

// acc[j] += A . B^T for NT n-tiles of 8 over K (a multiple of 16). A: the
// warp's 16 rows at `a`, row-major [m][k]; B: NT * 8 rows at `b`, row-major
// [n][k]; both in shared memory with row stride ld.
template <int NT, int K>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4],
                                        const bf16* a, const bf16* b, int ld,
                                        int lane) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a + (lane % 16) * ld + kk * 16 + (lane / 16) * 8);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t bf[4];
      ldsm_x4(bf, b + (j * 8 + lane % 8 + (lane / 16) * 8) * ld + kk * 16 +
                      ((lane / 8) % 2) * 8);
      mma_bf16(acc[j], af, bf[0], bf[1]);
      mma_bf16(acc[j + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[j] += A . B for NT n-tiles of 8 over K = 16 KT. A: KT m16k16 fragments
// in registers; B: row-major [k][n] at `b` in shared memory, stride ld.
template <int NT, int KT>
__device__ __forceinline__ void mma_ab(float (&acc)[NT][4],
                                       const uint32_t (&a)[KT][4],
                                       const bf16* b, int ld, int lane) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t bf[4];
      ldsm_x4_t(bf, b + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * ld +
                        j * 8 + (lane / 16) * 8);
      mma_bf16(acc[j], a[kk], bf[0], bf[1]);
      mma_bf16(acc[j + 1], a[kk], bf[2], bf[3]);
    }
  }
}

// The accumulators of a 16 x 8NT tile as the A fragments of the next
// product (k = the tile's columns), rounded to bf16.
template <int NT>
__device__ __forceinline__ void acc_to_a(const float (&c)[NT][4],
                                         uint32_t (&a)[NT / 2][4]) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// Stores a warp's 16 x kD accumulators times mul[row half] as bf16 rows.
template <int kD>
__device__ __forceinline__ void store_acc_bf16(bf16* __restrict__ dst,
                                               int b, int h, int row0,
                                               int s_len, int heads, int lane,
                                               const float (&acc)[kD / 8][4],
                                               const float (&mul)[2]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + lane / 4 + half * 8;
    if (row >= s_len) continue;
    bf16* out = dst + row_offset(b, row, s_len, heads, h, kD);
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const int c = n * 8 + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(out + c) = __floats2bfloat162_rn(
          acc[n][2 * half] * mul[half], acc[n][2 * half + 1] * mul[half]);
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, Geometry g) {
  constexpr int kLd = kD + kPadH;
  constexpr int kNT = kTile / 8;  // n-tiles of a score row
  constexpr int kDT = kD / 8;     // n-tiles of an output row
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int bh = blockIdx.y;
  const int b = bh / g.heads;
  const int h = bh % g.heads;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16 + lane / 4;  // this thread's rows: r0, r0 + 8

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sk = sq + kTile * kLd;
  bf16* sv = sk + kTile * kLd;

  load_tile_bf16<kD>(q, sq, b, h, q0, g.sq, g.heads);
  float acc[kDT][4] = {};
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};  // this thread's share of each row's sum

  const int k_end = key_end(g, q0);
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    load_tile_bf16<kD>(k, sk, b, h, k0, g.sk, g.heads);
    load_tile_bf16<kD>(v, sv, b, h, k0, g.sk, g.heads);
    __syncthreads();
    float s[kNT][4] = {};
    mma_abt<kNT, kD>(s, sq + warp * 16 * kLd, sk, kLd, lane);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + r0 + (e / 2) * 8;
        const int col = k0 + j * 8 + 2 * (lane % 4) + e % 2;
        const float x = visible(g, row, col) ? s[j][e] * g.scale : kNegInf;
        s[j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float shift[2], corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      shift[i] = m_new <= kNegInf / 2 ? 0.0f : m_new;
      corr[i] = expf((m[i] <= kNegInf / 2 ? kNegInf : m[i]) - shift[i]);
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float p = x <= kNegInf / 2 ? 0.0f : expf(x - shift[e / 2]);
        s[j][e] = p;
        l[e / 2] += p;
      }
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    uint32_t pa[kNT / 2][4];
    acc_to_a<kNT>(s, pa);
    mma_ab<kDT, kNT / 2>(acc, pa, sv, kLd, lane);
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.0f / (l[i] == 0.0f ? 1.0f : l[i]);
  }
  store_acc_bf16<kD>(o, b, h, q0 + warp * 16, g.sq, g.heads, lane, acc, inv);
  if (lane % 4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + r0 + i * 8;
      if (row >= g.sq) continue;
      const float shift = m[i] <= kNegInf / 2 ? 0.0f : m[i];
      lse[static_cast<int64_t>(bh) * g.sq + row] =
          l[i] == 0.0f ? kNegInf : shift + logf(l[i]);
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dq, Geometry g) {
  constexpr int kLd = kD + kPadH;
  constexpr int kNT = kTile / 8;
  constexpr int kDT = kD / 8;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int bh = blockIdx.y;
  const int b = bh / g.heads;
  const int h = bh % g.heads;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16 + lane / 4;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdo = sq + kTile * kLd;
  bf16* sk = sdo + kTile * kLd;
  bf16* sv = sk + kTile * kLd;

  load_tile_bf16<kD>(q, sq, b, h, q0, g.sq, g.heads);
  load_tile_bf16<kD>(dout, sdo, b, h, q0, g.sq, g.heads);
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + i * 8;
    float l = 0.0f, dl = 0.0f;
    if (row < g.sq) {
      l = lse[static_cast<int64_t>(bh) * g.sq + row];
      l = l <= kNegInf / 2 ? 0.0f : l;
      dl = delta[static_cast<int64_t>(bh) * g.sq + row];
    }
    row_lse[i] = l;
    row_delta[i] = dl;
  }
  float acc[kDT][4] = {};

  const int k_end = key_end(g, q0);
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    load_tile_bf16<kD>(k, sk, b, h, k0, g.sk, g.heads);
    load_tile_bf16<kD>(v, sv, b, h, k0, g.sk, g.heads);
    __syncthreads();
    float s[kNT][4] = {};
    float dp[kNT][4] = {};
    mma_abt<kNT, kD>(s, sq + warp * 16 * kLd, sk, kLd, lane);
    mma_abt<kNT, kD>(dp, sdo + warp * 16 * kLd, sv, kLd, lane);
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + r0 + (e / 2) * 8;
        const int col = k0 + j * 8 + 2 * (lane % 4) + e % 2;
        const float p = visible(g, row, col)
                            ? expf(s[j][e] * g.scale - row_lse[e / 2])
                            : 0.0f;
        s[j][e] = p * (dp[j][e] - row_delta[e / 2]);  // ds
      }
    uint32_t da[kNT / 2][4];
    acc_to_a<kNT>(s, da);
    mma_ab<kDT, kNT / 2>(acc, da, sk, kLd, lane);  // dq += ds . K
  }
  const float scale[2] = {g.scale, g.scale};
  store_acc_bf16<kD>(dq, b, h, q0 + warp * 16, g.sq, g.heads, lane, acc,
                     scale);
}

template <int kD>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         Geometry g) {
  constexpr int kLd = kD + kPadH;
  constexpr int kNT = kTile / 8;
  constexpr int kDT = kD / 8;
  const int k0 = blockIdx.x * kTile;
  const int bh = blockIdx.y;
  const int b = bh / g.heads;
  const int h = bh % g.heads;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16 + lane / 4;  // this thread's keys: r0, r0 + 8

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);
  bf16* sv = sk + kTile * kLd;
  bf16* sq = sv + kTile * kLd;
  bf16* sdo = sq + kTile * kLd;
  float* slse = reinterpret_cast<float*>(sdo + kTile * kLd);
  float* sdelta = slse + kTile;

  load_tile_bf16<kD>(k, sk, b, h, k0, g.sk, g.heads);
  load_tile_bf16<kD>(v, sv, b, h, k0, g.sk, g.heads);
  float dk_acc[kDT][4] = {};
  float dv_acc[kDT][4] = {};

  int q_begin = 0;
  if (g.causal) q_begin = max(0, min(g.sq, k0 - g.q_offset)) / kTile * kTile;
  for (int q0 = q_begin; q0 < g.sq; q0 += kTile) {
    __syncthreads();
    load_tile_bf16<kD>(q, sq, b, h, q0, g.sq, g.heads);
    load_tile_bf16<kD>(dout, sdo, b, h, q0, g.sq, g.heads);
    load_stats(lse, delta, slse, sdelta, bh, q0, g.sq);
    __syncthreads();
    // Transposed scores: rows are this warp's keys, columns the queries.
    float st[kNT][4] = {};
    float dpt[kNT][4] = {};
    mma_abt<kNT, kD>(st, sk + warp * 16 * kLd, sq, kLd, lane);    // K . Q^T
    mma_abt<kNT, kD>(dpt, sv + warp * 16 * kLd, sdo, kLd, lane);  // V . dO^T
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + r0 + (e / 2) * 8;
        const int qc = j * 8 + 2 * (lane % 4) + e % 2;
        const float p = visible(g, q0 + qc, key)
                            ? expf(st[j][e] * g.scale - slse[qc])
                            : 0.0f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - sdelta[qc]);  // ds^T
      }
    uint32_t pa[kNT / 2][4];
    acc_to_a<kNT>(st, pa);
    mma_ab<kDT, kNT / 2>(dv_acc, pa, sdo, kLd, lane);  // dv += p^T . dO
    uint32_t da[kNT / 2][4];
    acc_to_a<kNT>(dpt, da);
    mma_ab<kDT, kNT / 2>(dk_acc, da, sq, kLd, lane);   // dk += ds^T . Q
  }
  const float one[2] = {1.0f, 1.0f};
  const float scale[2] = {g.scale, g.scale};
  store_acc_bf16<kD>(dk, b, h, k0 + warp * 16, g.sk, g.heads, lane, dk_acc,
                     scale);
  store_acc_bf16<kD>(dv, b, h, k0 + warp * 16, g.sk, g.heads, lane, dv_acc,
                     one);
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
    const int tile = kTile * (d + kPadH) * static_cast<int>(sizeof(bf16));
    if (which == kFwd) return 3 * tile;
    if (which == kDq) return 4 * tile;
    return 4 * tile + 2 * kTile * static_cast<int>(sizeof(float));
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

dim3 grid_of(int rows, int batch, int heads) {
  return dim3(static_cast<unsigned>((rows + kTile - 1) / kTile),
              static_cast<unsigned>(batch * heads));
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

// dtype: 0 = fp32, 1 = bf16. Each entry returns cudaGetLastError() after
// its launch (0 = launched), or cudaErrorInvalidValue for a type or head
// dim it does not take; nothing is synchronised.
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
  if (d == 128) {
    static bool done[kMaxDevices] = {};
    return start(flash_fwd_mma_kernel<128>, done, grid, kMmaThreads, smem, s,
                 q, k, v, o, lse, g);
  }
  if (d == 64) {
    static bool done[kMaxDevices] = {};
    return start(flash_fwd_mma_kernel<64>, done, grid, kMmaThreads, smem, s,
                 q, k, v, o, lse, g);
  }
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
  if (d == 128) {
    static bool done[kMaxDevices] = {};
    return start(flash_bwd_dq_mma_kernel<128>, done, grid, kMmaThreads, smem,
                 s, q, k, v, dout, lse, delta, dq, g);
  }
  if (d == 64) {
    static bool done[kMaxDevices] = {};
    return start(flash_bwd_dq_mma_kernel<64>, done, grid, kMmaThreads, smem,
                 s, q, k, v, dout, lse, delta, dq, g);
  }
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
  if (d == 128) {
    static bool done[kMaxDevices] = {};
    return start(flash_bwd_dkv_mma_kernel<128>, done, grid, kMmaThreads,
                 smem, s, q, k, v, dout, lse, delta, dk, dv, g);
  }
  if (d == 64) {
    static bool done[kMaxDevices] = {};
    return start(flash_bwd_dkv_mma_kernel<64>, done, grid, kMmaThreads, smem,
                 s, q, k, v, dout, lse, delta, dk, dv, g);
  }
  static bool done[kMaxDevices] = {};
  return start(flash_bwd_dkv_kernel<bf16>, done, grid, kThreads, smem, s, q,
               k, v, dout, lse, delta, dk, dv, g);
}

const char* tt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
