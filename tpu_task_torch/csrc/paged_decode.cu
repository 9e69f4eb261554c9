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
// Bound: memory. The work that must move is every live token's K and V
// once per kv head (sum of live tokens x kv x d x 2 x bytes per element, a
// quarter of fp32's for int8/fp8 and an eighth for int4, plus the scales)
// plus q and out; the arithmetic is ~4 flops per loaded element per query
// of the group, far below the card's ratio.
//
// Design (v3, split-KV). The grid is (row x kv head) x splits CTAs of 256
// threads. Split s of a row covers its table entries [s S, (s + 1) S), S a
// whole number of the CTA's tiles, and walks only the LIVE blocks in that
// range (the row's live depth, min(max_pos / bs + 1, max_blocks), is read
// on the device). The host picks the split count from shapes alone
// (split_plan in ml/ops/paged_attention.py): enough CTAs for one resident
// wave of the card's 132 SMs. Without the split, the grid was rows x
// kv_heads CTAs (32 at batch 16, 2 at batch 1) and one CTA's serial walk
// of a row's whole depth set the time, flat over batch, at ~4% of HBM.
// With one split the CTA writes out directly, as v2 did, and the call is
// one launch; with more, each CTA writes its partial softmax state (m, l,
// acc) to a scratch buffer and combine_splits_kernel (paged_kv.cuh), a
// second launch, merges them.
//
// Inside a CTA nothing changed from v2. It stages its query group in fp32
// shared memory and takes its range in tiles of about 64 tokens (64 / bs
// blocks): every thread issues all of its 16-byte loads of the pool's own
// bytes for the tile before it stores any, converts them in registers
// (codes stay codes: no scale is applied here) and stores them as fp32 rows
// padded to d + 1 floats, so threads that walk different tokens hit
// different banks. Then one thread per (query row, token) takes the full
// dot product, one warp per query row updates the online softmax (m, l),
// and one thread per output element rescales and accumulates P.V in fp32,
// block by block with its v_scale when the pool is quantized. These four
// phases are separated by barriers and nothing overlaps, about 8 us a tile
// on the H100: that loop is what is left. It still sets the pace wherever
// the grid is already full without a split (the serving engine's 144-row
// chunk step), and the shared-memory traffic inside it (the fp32 staging
// stores, two loads per multiply-add) is what registers, the tensor cores
// or a copy ring overlapped with the math would cut.

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
                    float* __restrict__ partials, int w, int n_heads,
                    int kv_heads, int d, int bs, int max_blocks,
                    int tile_blocks, int split_blocks) {
  const int kvh = blockIdx.x % kv_heads;
  const int row = blockIdx.x / kv_heads;
  const int split = blockIdx.y;  // this CTA's part of the row's walk
  const int splits = gridDim.y;
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
  // split_blocks is a whole number of tiles, so this range's tiles are the
  // unsplit walk's and each quantized block keeps its own v_scale below.
  const int b_lo = split * split_blocks;
  const int b_hi = min(b_lo + split_blocks, n_live);

  for (int b0 = b_lo; b0 < b_hi; b0 += tile_blocks) {
    const int nb = min(tile_blocks, b_hi - b0);
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

  if (splits == 1) {
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
    return;
  }
  // This split's state for each query row, written even when its range
  // held no live block (the empty state): the buffer is uninitialised.
  const int ldp = paged_kv::kPartialHead + d;
  for (int e = tid; e < R * ldp; e += kThreads) {
    const int r = e / ldp;
    const int j = e % ldp;
    const int64_t o =
        (static_cast<int64_t>(row) * w + r / group) * n_heads + kvh * group +
        r % group;
    partials[(o * splits + split) * ldp + j] =
        j == 0 ? sm[r]
        : j == 1 ? sl[r]
                 : sacc[r * d + j - paged_kv::kPartialHead];
  }
}

int tile_blocks_for(int bs) { return bs >= kTileTokens ? 1 : kTileTokens / bs; }

struct Args {
  const void *q, *k_pool, *v_pool, *k_scale, *v_scale, *tables, *positions;
  void *out, *partials;
  int rows, w, n_heads, kv_heads, d, bs, max_blocks, splits, split_blocks,
      smem_bytes;
  cudaStream_t stream;
};

// Raise the instantiation's shared-memory limit once per device.
template <typename Q, typename S>
cudaError_t prepare() {
  static bool done[paged_kv::kMaxDevices] = {};
  return paged_kv::allow_max_smem(paged_decode_kernel<Q, S>, done);
}

template <typename Q, typename S>
int launch(const Args& a) {
  const cudaError_t err = prepare<Q, S>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(a.rows) * a.kv_heads, a.splits);
  paged_decode_kernel<Q, S><<<grid, kThreads, a.smem_bytes, a.stream>>>(
      static_cast<const Q*>(a.q), static_cast<const uint8_t*>(a.k_pool),
      static_cast<const uint8_t*>(a.v_pool),
      static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.positions), static_cast<Q*>(a.out),
      static_cast<float*>(a.partials), a.w, a.n_heads, a.kv_heads, a.d, a.bs,
      a.max_blocks, tile_blocks_for(a.bs), a.split_blocks);
  return static_cast<int>(cudaGetLastError());
}

struct Occupancy {
  int smem_bytes;
  int* ctas;
};

template <typename Q, typename S>
int occupancy(const Occupancy& a) {
  cudaError_t err = prepare<Q, S>();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      a.ctas, paged_decode_kernel<Q, S>, kThreads, a.smem_bytes);
  return static_cast<int>(err);
}

template <typename Q>
int combine(const void* partials, void* out, int n_rows, int splits, int d,
            cudaStream_t stream) {
  return static_cast<int>(paged_kv::launch_combine<Q>(
      static_cast<const float*>(partials), static_cast<Q*>(out), n_rows,
      splits, d, stream));
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
// q and out. splits cuts each row's walk, split s taking table entries
// [s split_blocks, (s + 1) split_blocks): the host's plan (split_blocks in
// ml/ops/paged_attention.py), whole tiles that together cover the table.
// With 1 split the kernel writes out; with more it writes each split's
// state to partials, (rows, w, h, splits, 2 + d) fp32, and leaves out alone
// for tt_paged_decode_combine. Returns cudaGetLastError() after the launch
// (0 = launched); nothing is synchronised.
int tt_paged_decode(int q_type, int kv_type, const void* q,
                    const void* k_pool, const void* v_pool,
                    const void* k_scale, const void* v_scale,
                    const void* tables, const void* positions, void* out,
                    void* partials, int rows, int w, int n_heads,
                    int kv_heads, int d, int bs, int max_blocks, int splits,
                    int split_blocks, void* stream) {
  if (rows == 0) return 0;
  if (splits < 1 || splits > 65535 || (splits > 1 && partials == nullptr) ||
      split_blocks < 0 || split_blocks % tile_blocks_for(bs) != 0 ||
      static_cast<int64_t>(splits) * split_blocks < max_blocks)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_pool, v_pool, k_scale, v_scale, tables, positions, out,
               partials, rows, w, n_heads, kv_heads, d, bs, max_blocks,
               splits, split_blocks,
               tt_paged_decode_smem_bytes(w, n_heads, kv_heads, d, bs),
               static_cast<cudaStream_t>(stream)};
  PAGED_KV_DISPATCH(q_type, kv_type, launch, a);
}

// Merge the split states of n_rows = rows * w * h output rows into out (q's
// type, q_type as above). Returns cudaGetLastError() after the launch.
int tt_paged_decode_combine(int q_type, const void* partials, void* out,
                            int n_rows, int splits, int d, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_type == 0) return combine<float>(partials, out, n_rows, splits, d, s);
  if (q_type == 1)
    return combine<__nv_bfloat16>(partials, out, n_rows, splits, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// CTAs of the (q_type, kv_type) instantiation that fit one SM at once with
// smem_bytes of dynamic shared memory, into *ctas; returns the CUDA error.
int tt_paged_decode_ctas_per_sm(int q_type, int kv_type, int smem_bytes,
                                void* ctas) {
  const Occupancy a{smem_bytes, static_cast<int*>(ctas)};
  PAGED_KV_DISPATCH(q_type, kv_type, occupancy, a);
}

const char* tt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
