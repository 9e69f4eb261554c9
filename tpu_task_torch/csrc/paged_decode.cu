// Paged-decode attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel tpu_task/ml/ops/paged_attention.py
// :: _paged_decode_kernel (called through paged_decode_attention): block-
// table-aware grouped-query attention that reads keys and values straight
// from the physical KV pools, so the gathered (rows, L, kv, d) view the
// plain version builds never exists.
//
//   q         (rows, w, h, d)             fp32 or bf16
//   k/v pool  (n_blocks, bs, kv, d)       q's type, or int8 / fp8 e4m3 codes,
//             (n_blocks, bs, kv, d / 2)   or uint8 int4 pairs (paged_kv.cuh)
//   k/v scale (n_blocks, kv)       fp32   quantized pools only
//   tables    (rows, max_blocks)   int32  physical block of each logical one
//   positions (rows, w)            int32  absolute position of each query
//   out       (rows, w, h, d)             q's type
//
// Cache slot j is visible to a query at position p iff j <= p. Scores are
// (q . k) / sqrt(d) in fp32, times k_scale[table[b], kv head] for a
// quantized pool; a masked score is NEG_INF and its weight exactly 0.0; a
// block's p.v is multiplied by its v_scale before it enters the
// accumulator; a row with no visible slot outputs 0 (l == 0 divides by 1).
// Query head h belongs to kv head h / group (contiguous groups).
//
// Design: one CTA of 256 threads per (row, kv head). The CTA stages its
// query group in fp32 shared memory, then walks the row's LIVE blocks only,
// 0 .. min(max_pos / bs + 1, max_blocks), in a loop that takes the place of
// the TPU kernel's sequential grid axis. Each iteration takes a tile of
// about 64 tokens (64 / bs blocks): every thread issues all of its 16-byte
// loads of the pool's own bytes for the tile before it stores any, so the
// tile's loads are in flight together, converts them in registers (codes
// stay codes: no scale is applied here) and stores them as fp32 rows padded
// to d + 1 floats, so threads that walk different tokens hit different
// banks. Then one thread per (query row, token) takes the full dot product,
// one warp per query row updates the online softmax (m, l), and one thread
// per output element rescales and accumulates P.V in fp32, block by block
// with its v_scale when the pool is quantized.
//
// Bound: memory. The work that must move is every live token's K and V
// once per kv head (sum of live tokens x kv x d x 2 x bytes per element, a
// quarter of fp32's for int8/fp8 and an eighth for int4, plus the scales)
// plus q and out; the arithmetic is ~4 flops per loaded element per query
// of the group, far below the card's ratio. What this simple design leaves
// on the table: the grid is rows x kv_heads CTAs (2 at batch 1, on 132
// SMs), so one CTA's serial walk sets the time; a split of the KV walk
// across CTAs (flash-decoding) would fill the card. The next tile's loads
// are not overlapped with this tile's math either (paged_decode_pipelined.cu
// does that). Inside the CTA the tile's shared-memory traffic sets the pace
// (the fp32 staging stores, then two loads per multiply-add in the score
// and P.V loops); registers or the tensor cores would cut it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "paged_kv.cuh"

namespace {

using paged_kv::kNegInf;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileTokens = 64;  // tokens per iteration (rounded to blocks)
constexpr int kUnroll = 8;       // 16-byte loads in flight per thread

// Copy the K and V rows of kv head `kvh` for one tile (n_tok tokens of the
// physical blocks in `stab`) into fp32 shared memory rows of stride `ld`,
// converting the pool's storage type in registers. Rows of row_bytes<S>(d)
// bytes are contiguous in the pools, so consecutive threads read
// consecutive 16-byte vectors; each thread loads up to kUnroll vectors
// before it stores any. Rows that are not a whole number of vectors (the
// small head dims of the tiny and micro presets) are read unit by unit.
template <typename S>
__device__ __forceinline__ void load_tile(const uint8_t* __restrict__ k_pool,
                                          const uint8_t* __restrict__ v_pool,
                                          float* __restrict__ sk,
                                          float* __restrict__ sv,
                                          const int* __restrict__ stab,
                                          int n_tok, int bs, int kv_heads,
                                          int kvh, int d, int ld) {
  const int rb = paged_kv::row_bytes<S>(d);
  if (rb % 16 == 0) {
    constexpr int kVecVals = 4 * S::kWordVals;  // values per 16-byte vector
    const int vecs_per_row = rb / 16;
    const int n_vec = n_tok * vecs_per_row;  // per pool
    for (int first = 0; first < 2 * n_vec; first += kThreads * kUnroll) {
      uint4 regs[kUnroll];
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        int e = first + i * kThreads + threadIdx.x;
        if (e < 2 * n_vec) {
          const uint8_t* pool = e < n_vec ? k_pool : v_pool;
          e = e < n_vec ? e : e - n_vec;
          const int t = e / vecs_per_row;
          const int64_t phys = stab[t / bs];
          const int64_t off = ((phys * bs + t % bs) * kv_heads + kvh) * rb +
                              (e % vecs_per_row) * 16;
          regs[i] = *reinterpret_cast<const uint4*>(pool + off);
        }
      }
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        int e = first + i * kThreads + threadIdx.x;
        if (e < 2 * n_vec) {
          float* dst = e < n_vec ? sk : sv;
          e = e < n_vec ? e : e - n_vec;
          const int t = e / vecs_per_row;
          const int j = (e % vecs_per_row) * kVecVals;
          float vals[kVecVals];
          S::word(regs[i].x, vals);
          S::word(regs[i].y, vals + S::kWordVals);
          S::word(regs[i].z, vals + 2 * S::kWordVals);
          S::word(regs[i].w, vals + 3 * S::kWordVals);
#pragma unroll
          for (int x = 0; x < kVecVals; ++x) dst[t * ld + j + x] = vals[x];
        }
      }
    }
  } else {
    const int units = rb / S::kUnitBytes;  // per row
    for (int e = threadIdx.x; e < 2 * n_tok * units; e += kThreads) {
      const bool is_k = e < n_tok * units;
      const int f = is_k ? e : e - n_tok * units;
      const int t = f / units;
      const int u = f % units;
      const int64_t phys = stab[t / bs];
      const int64_t off = ((phys * bs + t % bs) * kv_heads + kvh) * rb +
                          u * S::kUnitBytes;
      float vals[S::kVals];
      S::unit((is_k ? k_pool : v_pool) + off, vals);
#pragma unroll
      for (int x = 0; x < S::kVals; ++x)
        (is_k ? sk : sv)[t * ld + u * S::kVals + x] = vals[x];
    }
  }
}

template <typename Q, typename S>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const Q* __restrict__ q,
                    const uint8_t* __restrict__ k_pool,
                    const uint8_t* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ tables,
                    const int* __restrict__ positions, Q* __restrict__ out,
                    int w, int n_heads, int kv_heads, int d, int bs,
                    int max_blocks, int tile_blocks) {
  const int kvh = blockIdx.x % kv_heads;
  const int row = blockIdx.x / kv_heads;
  const int group = n_heads / kv_heads;
  const int R = w * group;  // query rows of this CTA: (query, head) pairs
  const int tile = tile_blocks * bs;  // tokens per iteration
  const int ld = d + 1;               // padded shared-memory row stride
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float sqrt_d = sqrtf(static_cast<float>(d));

  extern __shared__ float smem[];
  float* sq = smem;              // (R, d) queries in fp32
  float* sk = sq + R * d;        // (tile, ld) K rows of this tile
  float* sv = sk + tile * ld;    // (tile, ld) V rows of this tile
  float* sacc = sv + tile * ld;  // (R, d) unnormalised output
  float* sp = sacc + R * d;      // (R, tile) scores, then weights
  float* sm = sp + R * tile;     // (R) running max
  float* sl = sm + R;            // (R) running sum
  float* scorr = sl + R;         // (R) this tile's rescale factor
  float* ssk = scorr + R;        // (tile_blocks) k scales of the tile
  float* ssv = ssk + tile_blocks;  // (tile_blocks) v scales of the tile
  int* spos = reinterpret_cast<int*>(ssv + tile_blocks);  // (w) positions
  int* stab = spos + w;          // (tile_blocks) physical blocks of the tile

  for (int e = tid; e < R * d; e += kThreads) {
    const int r = e / d;
    const int j = e % d;
    const int wi = r / group;
    const int g = r % group;
    const int64_t src =
        ((static_cast<int64_t>(row) * w + wi) * n_heads + kvh * group + g) *
            d + j;
    sq[e] = paged_kv::to_float(q[src]);
    sacc[e] = 0.0f;
  }
  for (int r = tid; r < R; r += kThreads) {
    sm[r] = kNegInf;
    sl[r] = 0.0f;
  }
  for (int wi = tid; wi < w; wi += kThreads) {
    spos[wi] = positions[static_cast<int64_t>(row) * w + wi];
  }
  __syncthreads();

  int max_pos = spos[0];
  for (int wi = 1; wi < w; ++wi) max_pos = max(max_pos, spos[wi]);
  const int n_live = max_pos < 0 ? 0 : min(max_pos / bs + 1, max_blocks);
  const int* table = tables + static_cast<int64_t>(row) * max_blocks;

  for (int b0 = 0; b0 < n_live; b0 += tile_blocks) {
    const int nb = min(tile_blocks, n_live - b0);
    const int n_tok = nb * bs;
    const int base = b0 * bs;  // position of the tile's first token
    for (int i = tid; i < nb; i += kThreads) {
      stab[i] = table[b0 + i];
      if constexpr (S::kQuant) {
        ssk[i] = k_scale[static_cast<int64_t>(stab[i]) * kv_heads + kvh];
        ssv[i] = v_scale[static_cast<int64_t>(stab[i]) * kv_heads + kvh];
      }
    }
    __syncthreads();
    load_tile<S>(k_pool, v_pool, sk, sv, stab, n_tok, bs, kv_heads, kvh, d,
                 ld);
    __syncthreads();

    // Scores: one thread per (query row, token); lanes walk tokens, so the
    // query row is a broadcast and the padded K rows fall in distinct banks.
    for (int pair = tid; pair < R * tile; pair += kThreads) {
      const int r = pair / tile;
      const int t = pair % tile;
      float s = kNegInf;
      if (t < n_tok && base + t <= spos[r / group]) {
        const float* qr = sq + r * d;
        const float* kt = sk + t * ld;
        float dot = 0.0f;
        for (int j = 0; j < d; ++j) dot += qr[j] * kt[j];
        s = dot / sqrt_d;
        if constexpr (S::kQuant) s *= ssk[t / bs];
      }
      sp[pair] = s;
    }
    __syncthreads();

    // Online softmax: one warp per query row.
    for (int r = warp; r < R; r += kWarps) {
      float* pr = sp + r * tile;
      const int pos = spos[r / group];
      float m_tile = kNegInf;
      for (int t = lane; t < tile; t += 32) m_tile = fmaxf(m_tile, pr[t]);
      m_tile = paged_kv::warp_max(m_tile);
      const float m = sm[r];
      const float m_new = fmaxf(m, m_tile);
      const float shift = m_new <= kNegInf / 2 ? 0.0f : m_new;
      float sum = 0.0f;
      for (int t = lane; t < tile; t += 32) {
        const float p =
            t < n_tok && base + t <= pos ? expf(pr[t] - shift) : 0.0f;
        pr[t] = p;
        sum += p;
      }
      sum = paged_kv::warp_sum(sum);
      if (lane == 0) {
        const float corr = expf((m <= kNegInf / 2 ? kNegInf : m) - shift);
        sl[r] = sl[r] * corr + sum;
        sm[r] = m_new;
        scorr[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P.V: one thread per output element. A quantized
    // block's p.v takes its v_scale before it enters the accumulator.
    for (int e = tid; e < R * d; e += kThreads) {
      const int r = e / d;
      const int j = e % d;
      const float* pr = sp + r * tile;
      float acc = sacc[e] * scorr[r];
      if constexpr (S::kQuant) {
        for (int blk = 0; blk < nb; ++blk) {
          float part = 0.0f;
          for (int t = blk * bs; t < (blk + 1) * bs; ++t)
            part += pr[t] * sv[t * ld + j];
          acc += part * ssv[blk];
        }
      } else {
        for (int t = 0; t < n_tok; ++t) acc += pr[t] * sv[t * ld + j];
      }
      sacc[e] = acc;
    }
    __syncthreads();
  }

  for (int e = tid; e < R * d; e += kThreads) {
    const int r = e / d;
    const int j = e % d;
    const int wi = r / group;
    const int g = r % group;
    const float l = sl[r];
    const int64_t dst =
        ((static_cast<int64_t>(row) * w + wi) * n_heads + kvh * group + g) *
            d + j;
    out[dst] = paged_kv::from_float<Q>(sacc[e] / (l == 0.0f ? 1.0f : l));
  }
}

int tile_blocks_for(int bs) { return bs >= kTileTokens ? 1 : kTileTokens / bs; }

struct Args {
  const void *q, *k_pool, *v_pool, *k_scale, *v_scale, *tables, *positions;
  void* out;
  int rows, w, n_heads, kv_heads, d, bs, max_blocks, smem_bytes;
  cudaStream_t stream;
};

template <typename Q, typename S>
int launch(const Args& a) {
  static bool done[paged_kv::kMaxDevices] = {};
  const cudaError_t err =
      paged_kv::allow_max_smem(paged_decode_kernel<Q, S>, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(a.rows) * a.kv_heads);
  paged_decode_kernel<Q, S><<<grid, kThreads, a.smem_bytes, a.stream>>>(
      static_cast<const Q*>(a.q), static_cast<const uint8_t*>(a.k_pool),
      static_cast<const uint8_t*>(a.v_pool),
      static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.positions), static_cast<Q*>(a.out), a.w,
      a.n_heads, a.kv_heads, a.d, a.bs, a.max_blocks, tile_blocks_for(a.bs));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one CTA needs, in bytes (the wrapper checks it against the
// card's limit before launching).
int tt_paged_decode_smem_bytes(int w, int n_heads, int kv_heads, int d,
                               int bs) {
  const int R = w * (n_heads / kv_heads);
  const int tile_blocks = tile_blocks_for(bs);
  const int tile = tile_blocks * bs;
  return static_cast<int>(sizeof(float)) *
             (2 * R * d + 2 * tile * (d + 1) + R * tile + 3 * R +
              2 * tile_blocks) +
         static_cast<int>(sizeof(int)) * (w + tile_blocks);
}

// q_type: 0 = fp32, 1 = bf16; kv_type: the pool's storage (paged_kv.cuh).
// k_scale/v_scale are read only for a quantized pool. d is the head dim of
// q and out. Returns cudaGetLastError() after the launch (0 = launched);
// nothing is synchronised.
int tt_paged_decode(int q_type, int kv_type, const void* q,
                    const void* k_pool, const void* v_pool,
                    const void* k_scale, const void* v_scale,
                    const void* tables, const void* positions, void* out,
                    int rows, int w, int n_heads, int kv_heads, int d,
                    int bs, int max_blocks, void* stream) {
  if (rows == 0) return 0;
  const Args a{q, k_pool, v_pool, k_scale, v_scale, tables, positions, out,
               rows, w, n_heads, kv_heads, d, bs, max_blocks,
               tt_paged_decode_smem_bytes(w, n_heads, kv_heads, d, bs),
               static_cast<cudaStream_t>(stream)};
  PAGED_KV_DISPATCH(q_type, kv_type, launch, a);
}

const char* tt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
