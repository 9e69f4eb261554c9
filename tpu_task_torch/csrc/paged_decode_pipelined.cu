// Pipelined paged-decode attention for Hopper (sm_90a), hand-written CUDA
// C++.
//
// Replaces the TPU kernel tpu_task/ml/ops/paged_attention.py
// :: _paged_decode_pipelined_kernel (called through
// paged_decode_pipelined_attention). It computes the same function as
// paged_decode.cu (the port of _paged_decode_kernel), with the same
// arguments, types and semantics (see there and paged_kv.cuh): scores are
// (q . k) / sqrt(d) in fp32 times the block's k_scale for a quantized pool,
// masked scores are NEG_INF with weight exactly 0, a block's p.v takes its
// v_scale before it enters the accumulator, and a row with no visible key
// outputs 0.
//
// What the TPU kernel is for: it leaves the pools in HBM and copies each
// block of the pool's OWN bytes (int8, fp8 or packed int4 for a quantized
// pool) into a double buffer by hand, issuing the next copy before it
// computes the current one, and it walks only the row's live depth. The
// Hopper design keeps exactly that: a two-deep ring in shared memory, filled
// with cp.async (16-byte copies where a row's bytes allow, 8- or 4-byte ones
// for the small rows of the tiny and micro presets), holds the pool's raw
// bytes; codes are converted in registers and no dequantized copy is stored.
//
// Bound: memory. A call must move every live token's K and V bytes once per
// kv head (a quarter of fp32's for int8/fp8, an eighth for int4), the live
// blocks' scales and table entries, q and out; the arithmetic is about 4
// flops per loaded element per query row of the group, far below the card's
// ratio of operations to bytes.
//
// Design (v2).
//
// - Split-KV. The grid is (row x kv head) x splits CTAs. Split s walks the
//   live blocks of table entries [s S, (s + 1) S), S = split_blocks a whole
//   number of 64-token stages, chosen on the host from shapes alone
//   (split_plan in ml/ops/paged_attention.py) so that one resident wave
//   fills the card's SMs. With one split the CTA writes the output itself;
//   with more, each CTA writes its online-softmax state (m, l, acc) in
//   paged_kv.cuh's layout, the empty state where its range holds nothing
//   live, and paged_kv::combine_splits_kernel, exported from this library as
//   tt_paged_decode_pipelined_combine, merges them in a second launch. v1
//   ran one CTA per (row, kv head): 32 CTAs at the flagship's 16 slots, each
//   walking its 16 stages in series, so the time was flat over batch.
//
// - The stage math on the tensor cores, for bf16 queries at d % 16 == 0,
//   d <= 128 and at most 16 query rows per CTA (R = w x group; the flagship
//   decode has 4). Four warps take the split's 16-token chunks in turn, each
//   with its own two-slot cp.async ring, its own online-softmax state and no
//   barrier but __syncwarp, and merge through shared memory at the end.
//   Each lane loads the block-table entry of one token of a chunk a step
//   before that chunk's copies are issued (the first two beside the
//   positions), so no copy waits on a table lookup: looked up at issue
//   time, four dependent lookups a step held a two-step split's walk at
//   17.5 us on the H100. Products are mma.sync.m16n8k16 with bf16 operands and fp32 sums
//   (wgmma needs 64-row tiles; a decode CTA has 4 query rows):
//     S = Q . K^T   M = the R query rows (padded to 16), N = the chunk's 16
//                   tokens, K = d. The Q fragments stay in registers for the
//                   whole walk; the K fragments are built in registers from
//                   the ring's raw bytes: int8, fp8 e4m3 and int4 codes are
//                   exact in bf16, as is a bf16 pool, so each product is
//                   exact and only the order of the fp32 sum changes.
//     O^T += V^T . P^T  M = d, N = the query rows (8 a tile), K = the chunk's
//                   tokens. P^T's fragments are S's accumulators, taken
//                   straight from registers; P (times the token's v_scale
//                   for a quantized pool) is carried as three bf16 terms in
//                   three products, each term the rounding of what the ones
//                   before it leave, so P keeps 24 bits (2^-27 relative).
//                   A pair (hi + lo, 2^-18) keeps the outputs inside their
//                   gate but not the split states: where one token carries
//                   a split's weight, acc's error is up to 2^-18 |v| of l,
//                   and at |v| near 5 it reached the states' 2e-5 gate on
//                   the H100. The third product is cheap: the tensor cores
//                   are far from bounding this kernel.
//   The head dims each lane reads are chosen so that a lane's fragment
//   values are adjacent in a row (4 of a K row for Q . K^T, 2 of a V row for
//   V^T . P^T) and the warp's reads fall in distinct banks (bf16 K reads
//   take two wavefronts). The accumulators and (m, l) stay in registers.
//
// - The scalar path, for fp32 queries, head dims that are not a multiple of
//   16 or above 128, and more than 16 query rows: v1's stage math in fp32 on
//   the CUDA cores, over the same split. A CTA of 256 threads takes its
//   range in 64-token stages through the same ring: one thread per (query
//   row, token) for the scores, one warp per query row for the online
//   softmax, one thread per output element for P.V, block by block.
//
// What is left on the table: TMA bulk copies with mbarriers in place of
// cp.async (one thread per chunk instead of every lane computing addresses),
// merging the splits in the last split's CTA (a counter per row and kv head)
// so the second launch goes, and fp32 queries on the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "paged_kv.cuh"

namespace {

using paged_kv::kNegInf;
using paged_kv::kPartialHead;
using bf16 = __nv_bfloat16;

constexpr int kStages = 2;         // ring depth
constexpr int kStageTokens = 64;   // tokens per stage (rounded to blocks)
constexpr int kScalarThreads = 256;
constexpr int kScalarWarps = kScalarThreads / 32;
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kChunk = 16;         // tokens of a warp step: a k-step of P.V
constexpr int kMaxMmaRows = 16;    // query rows of one m16 tile
constexpr int kMaxMmaD = 128;      // head dims kept in registers
constexpr int kMaxKSteps = kMaxMmaD / 16;
constexpr int kPTerms = 3;         // bf16 terms P is carried in for P.V

__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(gmem));
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
                 "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(gmem));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Bytes a cp.async moves for rows of rb bytes (rb % 4 == 0), and the
// shared-memory row stride: rows that are a whole number of 16-byte vectors
// are padded by 16 bytes, so lanes that read different tokens' rows at the
// same offset hit different banks.
__host__ __device__ inline int copy_bytes(int rb) {
  return rb % 16 == 0 ? 16 : rb % 8 == 0 ? 8 : 4;
}
__host__ __device__ inline int smem_row_bytes(int rb) {
  return rb % 16 == 0 ? rb + 16 : rb;
}

// What every instantiation of both kernels takes.
struct Params {
  const void* q;
  const uint8_t* k_pool;
  const uint8_t* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* tables;
  const int* positions;
  void* out;
  float* partials;  // (rows, w, h, splits, 2 + d) when splits > 1
  int w, n_heads, kv_heads, d, bs, max_blocks, stage_blocks, split_blocks;
};

// The live blocks [b_lo, b_hi) of this CTA's split: the row's live depth,
// min(max_pos / bs + 1, max_blocks), is read on the device.
struct Range {
  int b_lo, b_hi;
};

__device__ __forceinline__ Range split_range(const Params& p, int row) {
  const int* pos = p.positions + static_cast<int64_t>(row) * p.w;
  int max_pos = pos[0];
  for (int wi = 1; wi < p.w; ++wi) max_pos = max(max_pos, pos[wi]);
  const int n_live = max_pos < 0 ? 0 : min(max_pos / p.bs + 1, p.max_blocks);
  const int b_lo = blockIdx.y * p.split_blocks;
  return {b_lo, min(b_lo + p.split_blocks, n_live)};
}

// Flat (row, query, head) index of the CTA's query row r.
__device__ __forceinline__ int64_t head_row(const Params& p, int row, int kvh,
                                            int r) {
  const int group = p.n_heads / p.kv_heads;
  return (static_cast<int64_t>(row) * p.w + r / group) * p.n_heads +
         kvh * group + r % group;
}

// Element j of one query row's result: with one split the normalised output
// in Q (0 where l is 0: nothing visible); with more, the split's state
// (m, l, acc) in partials.
template <typename Q>
__device__ __forceinline__ void put_result(const Params& p, int64_t o, int j,
                                           float m, float l, float acc) {
  const int splits = gridDim.y;
  if (splits == 1) {
    static_cast<Q*>(p.out)[o * p.d + j] =
        paged_kv::from_float<Q>(acc / (l == 0.0f ? 1.0f : l));
    return;
  }
  float* st = p.partials + (o * splits + blockIdx.y) * (kPartialHead + p.d);
  if (j == 0) {
    st[0] = m;
    st[1] = l;
  }
  st[kPartialHead + j] = acc;
}

// -- the scalar path ---------------------------------------------------------

// q . k over d, k a raw row of storage S in shared memory.
template <typename S>
__device__ __forceinline__ float row_dot(const float* __restrict__ qr,
                                         const uint8_t* __restrict__ kr,
                                         int rb) {
  float dot = 0.0f;
  if (rb % 16 == 0) {
    for (int v = 0; v < rb / 16; ++v) {
      const uint4 raw = reinterpret_cast<const uint4*>(kr)[v];
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // one word at a time: few registers
        float vals[S::kWordVals];
        S::word(words[k], vals);
        const float* qv = qr + (4 * v + k) * S::kWordVals;
#pragma unroll
        for (int x = 0; x < S::kWordVals; ++x) dot += qv[x] * vals[x];
      }
    }
  } else {
    for (int v = 0; v < rb / 4; ++v) {
      float vals[S::kWordVals];
      S::word(reinterpret_cast<const uint32_t*>(kr)[v], vals);
      const float* qv = qr + v * S::kWordVals;
#pragma unroll
      for (int x = 0; x < S::kWordVals; ++x) dot += qv[x] * vals[x];
    }
  }
  return dot;
}

// What a scalar CTA's stage copies need to know.
struct Walk {
  const uint8_t* k_pool;
  const uint8_t* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* table;  // the row's block table
  uint8_t* ring;     // kStages x (K rows, V rows) x tile x lds bytes
  float* ssc;        // kStages x (k scales, v scales) x stage_blocks
  int b_lo, b_hi, stage_blocks, bs, kv_heads, kvh, rb, lds, tile;
};

// Issue stage st's copies (its blocks' K and V rows, and for a quantized
// pool their scales) into ring slot st % kStages, as one commit group.
template <typename S>
__device__ __forceinline__ void issue_stage(const Walk& w, int st) {
  const int b0 = w.b_lo + st * w.stage_blocks;
  const int nb = min(w.stage_blocks, w.b_hi - b0);
  uint8_t* dk = w.ring + (st % kStages) * 2 * w.tile * w.lds;
  uint8_t* dv = dk + w.tile * w.lds;
  const int cb = copy_bytes(w.rb);
  const int per_row = w.rb / cb;
  const int n = nb * w.bs * per_row;  // copies per pool
  for (int e = threadIdx.x; e < 2 * n; e += kScalarThreads) {
    const bool is_k = e < n;
    const int f = is_k ? e : e - n;
    const int t = f / per_row;
    const int c = (f % per_row) * cb;
    const int64_t phys = w.table[b0 + t / w.bs];
    const int64_t off =
        ((phys * w.bs + t % w.bs) * w.kv_heads + w.kvh) * w.rb + c;
    cp_async((is_k ? dk : dv) + t * w.lds + c,
             (is_k ? w.k_pool : w.v_pool) + off, cb);
  }
  if constexpr (S::kQuant) {  // the stage's scales ride the same group
    float* sc = w.ssc + (st % kStages) * 2 * w.stage_blocks;
    for (int i = threadIdx.x; i < nb; i += kScalarThreads) {
      const int64_t at =
          static_cast<int64_t>(w.table[b0 + i]) * w.kv_heads + w.kvh;
      cp_async(sc + i, w.k_scale + at, 4);
      cp_async(sc + w.stage_blocks + i, w.v_scale + at, 4);
    }
  }
  cp_async_commit();
}

template <typename Q, typename S>
__global__ void __launch_bounds__(kScalarThreads)
paged_decode_pipelined_kernel(const Params p) {
  const int kvh = blockIdx.x % p.kv_heads;
  const int row = blockIdx.x / p.kv_heads;
  const int d = p.d;
  const int group = p.n_heads / p.kv_heads;
  const int R = p.w * group;  // query rows of this CTA: (query, head) pairs
  const int stage_blocks = p.stage_blocks;
  const int tile = stage_blocks * p.bs;  // tokens per stage
  const int rb = paged_kv::row_bytes<S>(d);
  const int lds = smem_row_bytes(rb);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float sqrt_d = sqrtf(static_cast<float>(d));

  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem;  // kStages x (K rows, V rows) x tile x lds bytes
  float* sq = reinterpret_cast<float*>(ring + kStages * 2 * tile * lds);
  float* sacc = sq + R * d;      // (R, d) unnormalised output
  float* sp = sacc + R * d;      // (R, tile) scores, then weights
  float* sm = sp + R * tile;     // (R) running max
  float* sl = sm + R;            // (R) running sum
  float* scorr = sl + R;         // (R) this stage's rescale factor
  float* ssc = scorr + R;        // kStages x (k scales, v scales) per block
  int* spos = reinterpret_cast<int*>(ssc + kStages * 2 * stage_blocks);

  const Q* q = static_cast<const Q*>(p.q);
  for (int e = tid; e < R * d; e += kScalarThreads) {
    sq[e] = paged_kv::to_float(q[head_row(p, row, kvh, e / d) * d + e % d]);
    sacc[e] = 0.0f;
  }
  for (int r = tid; r < R; r += kScalarThreads) {
    sm[r] = kNegInf;
    sl[r] = 0.0f;
  }
  for (int wi = tid; wi < p.w; wi += kScalarThreads) {
    spos[wi] = p.positions[static_cast<int64_t>(row) * p.w + wi];
  }
  __syncthreads();

  const Range range = split_range(p, row);
  const int n_stages =
      max(0, (range.b_hi - range.b_lo + stage_blocks - 1) / stage_blocks);
  const Walk walk{p.k_pool, p.v_pool, p.k_scale, p.v_scale,
                  p.tables + static_cast<int64_t>(row) * p.max_blocks, ring,
                  ssc, range.b_lo, range.b_hi, stage_blocks, p.bs,
                  p.kv_heads, kvh, rb, lds, tile};
  if (n_stages > 0) issue_stage<S>(walk, 0);
  for (int st = 0; st < n_stages; ++st) {
    if (st + 1 < n_stages) {
      issue_stage<S>(walk, st + 1);  // its bytes travel during this stage
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int b0 = range.b_lo + st * stage_blocks;
    const int nb = min(stage_blocks, range.b_hi - b0);
    const int n_tok = nb * p.bs;
    const int base = b0 * p.bs;  // position of the stage's first token
    const uint8_t* sk = ring + (st % kStages) * 2 * tile * lds;
    const uint8_t* sv = sk + tile * lds;
    const float* sc = ssc + (st % kStages) * 2 * stage_blocks;

    // Scores: one thread per (query row, token).
    for (int pair = tid; pair < R * tile; pair += kScalarThreads) {
      const int r = pair / tile;
      const int t = pair % tile;
      float s = kNegInf;
      if (t < n_tok && base + t <= spos[r / group]) {
        s = row_dot<S>(sq + r * d, sk + t * lds, rb) / sqrt_d;
        if constexpr (S::kQuant) s *= sc[t / p.bs];
      }
      sp[pair] = s;
    }
    __syncthreads();

    // Online softmax: one warp per query row.
    for (int r = warp; r < R; r += kScalarWarps) {
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
        const float pt =
            t < n_tok && base + t <= pos ? expf(pr[t] - shift) : 0.0f;
        pr[t] = pt;
        sum += pt;
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

    // acc = acc * corr + P.V, block by block (a quantized block's p.v
    // takes its v_scale first): one thread per output element.
    for (int e = tid; e < R * d; e += kScalarThreads) {
      const int r = e / d;
      const int j = e % d;
      const float* pr = sp + r * tile;
      float acc = sacc[e] * scorr[r];
      for (int blk = 0; blk < nb; ++blk) {
        float part = 0.0f;
        for (int t = blk * p.bs; t < (blk + 1) * p.bs; ++t)
          part += pr[t] * S::at(sv + t * lds, j);
        if constexpr (S::kQuant) part *= sc[stage_blocks + blk];
        acc += part;
      }
      sacc[e] = acc;
    }
    // The next iteration's copies overwrite this stage's ring slot only
    // after every thread is done reading it.
    __syncthreads();
  }

  for (int e = tid; e < R * d; e += kScalarThreads) {
    const int r = e / d;
    put_result<Q>(p, head_row(p, row, kvh, r), e % d, sm[r], sl[r], sacc[e]);
  }
}

// -- the tensor-core path ----------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

template <typename S>
constexpr bool kIsBF16 = std::is_same<S, paged_kv::StoreBF16>::value;
template <typename S>
constexpr bool kIsI4 = std::is_same<S, paged_kv::StoreI4>::value;

// Values c .. c + 3 of a raw row of storage S in shared memory (c a multiple
// of 4) as two bf16 pairs, (c, c + 1) and (c + 2, c + 3). Codes are exact in
// bf16, and a bf16 pool's values are its own bits.
template <typename S>
__device__ __forceinline__ uint2 quad_bf16(const uint8_t* row, int c) {
  if constexpr (kIsBF16<S>) {
    return *reinterpret_cast<const uint2*>(row + 2 * c);
  } else {
    float v[8];
    if constexpr (kIsI4<S>)
      S::word(*reinterpret_cast<const uint16_t*>(row + c / 2), v);
    else
      S::word(*reinterpret_cast<const uint32_t*>(row + c), v);
    return make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  }
}

// Values c, c + 1 of a raw row (c even) as one bf16 pair.
template <typename S>
__device__ __forceinline__ uint32_t pair_bf16(const uint8_t* row, int c) {
  if constexpr (kIsBF16<S>) {
    return *reinterpret_cast<const uint32_t*>(row + 2 * c);
  } else {
    float v[8];
    if constexpr (kIsI4<S>)
      S::word(row[c / 2], v);
    else
      S::word(*reinterpret_cast<const uint16_t*>(row + c), v);
    return pack_bf16(v[0], v[1]);
  }
}

// One warp's step over 16 tokens: lane (g = lane / 4, t4 = lane % 4).
//
// S = Q . K^T: the A operand holds query rows g and g + 8; k-step kk gives
// lane t4 the head dims 16 kk + 4 t4 .. + 3 (their place in the k16 slots,
// 2 t4, 2 t4 + 1, 2 t4 + 8, 2 t4 + 9, is the same in A and B, so the dot
// products are unchanged). n-tile j's column g is token 8 j + g, so the
// accumulator s[j] holds rows g (s[j][0..1]) and g + 8 (s[j][2..3]) at
// tokens 8 j + 2 t4 and 8 j + 2 t4 + 1.
//
// O^T += V^T . P^T: m-tile mt's rows g and g + 8 are head dims 16 mt + 2 g
// and 16 mt + 2 g + 1; k-slot 2 t4 + e is token 2 t4 + e and slot 2 t4 + 8
// + e token 8 + 2 t4 + e, which are exactly the tokens of s[0] and s[1], so
// P^T's B fragment for query rows 8 nr .. 8 nr + 7 is s[0][2 nr ..] and
// s[1][2 nr ..] of the lane's own registers. acc[mt][nr][e] is head dim
// 16 mt + 2 g + e / 2 of query row 8 nr + 2 t4 + e % 2.
template <typename S, int NR>
__global__ void __launch_bounds__(kMmaThreads)
paged_decode_pipelined_mma_kernel(const Params p) {
  const int kvh = blockIdx.x % p.kv_heads;
  const int row = blockIdx.x / p.kv_heads;
  const int d = p.d;
  const int n_ks = d / 16;  // k-steps of Q . K^T, m-tiles of V^T . P^T
  const int group = p.n_heads / p.kv_heads;
  const int R = p.w * group;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int rb = paged_kv::row_bytes<S>(d);
  const int lds = smem_row_bytes(rb);
  const int bs = p.bs;
  const float inv_sqrt_d = __frsqrt_rn(static_cast<float>(d));

  extern __shared__ __align__(16) uint8_t smem[];
  // Per warp: kStages x (16 K rows, 16 V rows) x lds bytes, then kStages x
  // (16 k scales, 16 v scales). After the walk, the warps' states.
  const int ring_bytes = kStages * 2 * kChunk * lds;
  uint8_t* ring =
      smem + warp * (ring_bytes + kStages * 2 * kChunk * sizeof(float));
  float* ssc = reinterpret_cast<float*>(ring + ring_bytes);

  // The table entry of this lane's token (lane % 16) of the warp's step i
  // (chunk warp + kMmaWarps i of the split), loaded a step ahead of the
  // step's copies so that no copy waits on it; the first two are loaded
  // beside the positions, before the live depth is known (any entry of the
  // split's table range may be read).
  const int* table = p.tables + static_cast<int64_t>(row) * p.max_blocks;
  const int b_lo = blockIdx.y * p.split_blocks;
  const int b_end = min(b_lo + p.split_blocks, p.max_blocks);
  auto entry = [&](int i) {
    const int b =
        b_lo + ((warp + kMmaWarps * i) * kChunk + (lane & (kChunk - 1))) / bs;
    return b < b_end ? table[b] : 0;
  };
  const int entry0 = entry(0);
  int entry_next = entry(1);

  const Range range = split_range(p, row);
  const int n_tok = max(0, range.b_hi - range.b_lo) * bs;
  const int n_chunks = (n_tok + kChunk - 1) / kChunk;
  const int steps =
      n_chunks > warp ? (n_chunks - warp + kMmaWarps - 1) / kMmaWarps : 0;

  // Q's A fragments for the whole walk, and the positions of rows g, g + 8
  // (-1 for padding rows: they see nothing).
  const bf16* q = static_cast<const bf16*>(p.q);
  uint32_t qa[kMaxKSteps][4];
  int pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = g + 8 * h;
    pos[h] = r < R ? p.positions[static_cast<int64_t>(row) * p.w + r / group]
                   : -1;
    const bf16* qr = q + (r < R ? head_row(p, row, kvh, r) * d : 0);
#pragma unroll
    for (int kk = 0; kk < kMaxKSteps; ++kk) {
      uint2 v = make_uint2(0u, 0u);
      if (kk < n_ks && r < R)
        v = *reinterpret_cast<const uint2*>(qr + 16 * kk + 4 * t4);
      qa[kk][h] = v.x;
      qa[kk][2 + h] = v.y;
    }
  }

  // Copies of the warp's step i into ring slot i % kStages, as one commit
  // group, given its table entry e: lane (tr, tc) copies piece tc of tokens
  // tr, tr + per_pass, ... of both pools (the pool row of token t comes from
  // lane t), and lanes 0-15 / 16-31 the k / v scale of their own token.
  const int cb = copy_bytes(rb);
  const int pieces = rb / cb;  // at most 16 on this path
  const int per_pass = 32 / pieces;
  const int tr = lane / pieces;
  const int tc = (lane % pieces) * cb;
  auto issue = [&](int i, int e) {
    const int t0 = (warp + kMmaWarps * i) * kChunk;  // from the split's start
    const int nt = min(kChunk, n_tok - t0);
    const long long own =
        (static_cast<long long>(e) * bs + (t0 + (lane & (kChunk - 1))) % bs) *
            p.kv_heads + kvh;
    uint8_t* dk = ring + (i % kStages) * 2 * kChunk * lds;
    uint8_t* dv = dk + kChunk * lds;
#pragma unroll
    for (int pass = 0; pass < kChunk / 2; ++pass) {
      const int t = tr + pass * per_pass;
      if (pass * per_pass < kChunk) {  // the same in every lane
        const long long pool_row =
            __shfl_sync(0xffffffffu, own, t & (kChunk - 1));
        if (tr < per_pass && t < nt) {
          const int64_t off = pool_row * rb + tc;
          cp_async(dk + t * lds + tc, p.k_pool + off, cb);
          cp_async(dv + t * lds + tc, p.v_pool + off, cb);
        }
      }
    }
    if constexpr (S::kQuant) {
      if ((lane & (kChunk - 1)) < nt) {
        const int64_t at = static_cast<int64_t>(e) * p.kv_heads + kvh;
        cp_async(ssc + (i % kStages) * 2 * kChunk + lane,
                 (lane < kChunk ? p.k_scale : p.v_scale) + at, 4);
      }
    }
    cp_async_commit();
  };

  float m_run[2] = {kNegInf, kNegInf};  // rows g, g + 8 (same in each t4)
  float l_run[2] = {0.0f, 0.0f};
  float acc[kMaxKSteps][NR][4];
#pragma unroll
  for (int mt = 0; mt < kMaxKSteps; ++mt)
#pragma unroll
    for (int nr = 0; nr < NR; ++nr)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nr][e] = 0.0f;

  if (steps > 0) issue(0, entry0);
  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps) {
      issue(i + 1, entry_next);  // its bytes travel during this step
      entry_next = entry(i + 2);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();  // every lane's copies are in

    const int t0 = (warp + kMmaWarps * i) * kChunk;
    const int nt = min(kChunk, n_tok - t0);
    const int base = range.b_lo * bs + t0;  // position of the chunk's token 0
    const uint8_t* sk = ring + (i % kStages) * 2 * kChunk * lds;
    const uint8_t* sv = sk + kChunk * lds;
    const float* sc = ssc + (i % kStages) * 2 * kChunk;

    // S = Q . K^T. Rows past nt hold stale bytes; their scores are masked.
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
      const uint8_t* kr = sk + (8 * j + g) * lds;
#pragma unroll
      for (int kk = 0; kk < kMaxKSteps; ++kk) {
        if (kk < n_ks) {
          const uint2 b = quad_bf16<S>(kr, 16 * kk + 4 * t4);
          mma_bf16(s[j], qa[kk], b.x, b.y);
        }
      }
    }

    // Online softmax over the chunk for rows g + 8 h; the four lanes of a
    // row (t4) reduce with two shuffles. A quantized token's score takes
    // its k_scale, its weight its v_scale on the way into P.V (l keeps the
    // weight itself).
    float corr[2];
    float pv[2][4];  // the weights that enter P.V
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bool live[2][2];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = 8 * j + 2 * t4 + e;
          live[j][e] = t < nt && base + t <= pos[h];
          float x = s[j][2 * h + e] * inv_sqrt_d;
          if constexpr (S::kQuant) x *= sc[t];
          s[j][2 * h + e] = live[j][e] ? x : kNegInf;
          mx = fmaxf(mx, s[j][2 * h + e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_run[h];
      const float m_new = fmaxf(m_old, mx);
      const float shift = m_new <= kNegInf / 2 ? 0.0f : m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pt =
              live[j][e] ? expf(s[j][2 * h + e] - shift) : 0.0f;
          sum += pt;
          if constexpr (S::kQuant)
            pv[h][2 * j + e] =
                live[j][e] ? pt * sc[kChunk + 8 * j + 2 * t4 + e] : 0.0f;
          else
            pv[h][2 * j + e] = pt;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      corr[h] = expf((m_old <= kNegInf / 2 ? kNegInf : m_old) - shift);
      l_run[h] = l_run[h] * corr[h] + sum;
      m_run[h] = m_new;
    }

    // P^T's B fragments, P as three bf16 terms (each the rounding of what
    // the terms before it leave; the differences are exact in fp32): n-tile
    // nr is rows 8 nr + g, i.e. the lane's row half h = nr.
    uint32_t pb[kPTerms][NR][2];
#pragma unroll
    for (int nr = 0; nr < NR; ++nr)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float x0 = pv[nr][2 * j], x1 = pv[nr][2 * j + 1];
#pragma unroll
        for (int term = 0; term < kPTerms; ++term) {
          const __nv_bfloat162 b = __floats2bfloat162_rn(x0, x1);
          pb[term][nr][j] = *reinterpret_cast<const uint32_t*>(&b);
          x0 -= __low2float(b);
          x1 -= __high2float(b);
        }
      }

    // Rescale: the lane's accumulators are query rows 8 nr + 2 t4 + e, whose
    // factors live in lanes 8 t4 + 4 e (row half nr).
    float cr[NR][2];
#pragma unroll
    for (int nr = 0; nr < NR; ++nr)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        cr[nr][e] = __shfl_sync(0xffffffffu, corr[nr], 8 * t4 + 4 * e);

    // O^T += V^T . P^T. V rows past nt hold stale bytes (maybe NaN
    // patterns): they enter as 0, never as 0 x NaN.
#pragma unroll
    for (int mt = 0; mt < kMaxKSteps; ++mt) {
      if (mt < n_ks) {
        uint32_t pr[4];  // tokens 2 t4, 2 t4 + 1, 2 t4 + 8, 2 t4 + 9
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int t = 2 * t4 + (u & 1) + 8 * (u >> 1);
          pr[u] = t < nt ? pair_bf16<S>(sv + t * lds, 16 * mt + 2 * g) : 0u;
        }
        const uint32_t a[4] = {__byte_perm(pr[0], pr[1], 0x5410),
                               __byte_perm(pr[0], pr[1], 0x7632),
                               __byte_perm(pr[2], pr[3], 0x5410),
                               __byte_perm(pr[2], pr[3], 0x7632)};
#pragma unroll
        for (int nr = 0; nr < NR; ++nr) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nr][e] *= cr[nr][e & 1];
#pragma unroll
          for (int term = 0; term < kPTerms; ++term)
            mma_bf16(acc[mt][nr], a, pb[term][nr][0], pb[term][nr][1]);
        }
      }
    }
    __syncwarp();  // the slot is refilled two steps on
  }

  // Merge the four warps' states through shared memory (over the rings):
  // (warp, r) holds m, l, acc[0 .. d).
  __syncthreads();
  float* ms = reinterpret_cast<float*>(smem);
  const int ld = kPartialHead + d;
  if (t4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h;
      if (r < R) {
        ms[(warp * R + r) * ld] = m_run[h];
        ms[(warp * R + r) * ld + 1] = l_run[h];
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < kMaxKSteps; ++mt) {
    if (mt < n_ks) {
#pragma unroll
      for (int nr = 0; nr < NR; ++nr)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 8 * nr + 2 * t4 + (e & 1);
          if (r < R)
            ms[(warp * R + r) * ld + kPartialHead + 16 * mt + 2 * g +
               (e >> 1)] = acc[mt][nr][e];
        }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < R * d; e += kMmaThreads) {
    const int r = e / d;
    const int j = e % d;
    float M = kNegInf;
#pragma unroll
    for (int wp = 0; wp < kMmaWarps; ++wp) M = fmaxf(M, ms[(wp * R + r) * ld]);
    float L = 0.0f, A = 0.0f;
#pragma unroll
    for (int wp = 0; wp < kMmaWarps; ++wp) {
      const float* st = ms + (wp * R + r) * ld;
      const float wt = paged_kv::split_weight(st[0], M);
      L += st[1] * wt;
      A += st[kPartialHead + j] * wt;
    }
    put_result<bf16>(p, head_row(p, row, kvh, r), j, M, L, A);
  }
}

// -- host side ---------------------------------------------------------------

int stage_blocks_for(int bs) {
  return bs >= kStageTokens ? 1 : kStageTokens / bs;
}

// Whether (q type, geometry) takes the tensor-core path.
bool use_mma(int q_type, int w, int n_heads, int kv_heads, int d) {
  const int R = w * (n_heads / kv_heads);
  return q_type == 1 && d % 16 == 0 && d <= kMaxMmaD && R <= kMaxMmaRows;
}

int smem_bytes(int q_type, int kv_type, int w, int n_heads, int kv_heads,
               int d, int bs) {
  const int R = w * (n_heads / kv_heads);
  const int lds = smem_row_bytes(paged_kv::row_bytes_of(kv_type, d));
  if (use_mma(q_type, w, n_heads, kv_heads, d)) {
    const int per_warp =
        kStages * 2 * kChunk * (lds + static_cast<int>(sizeof(float)));
    const int merge =
        kMmaWarps * R * (kPartialHead + d) * static_cast<int>(sizeof(float));
    return std::max(kMmaWarps * per_warp, merge);
  }
  const int stage_blocks = stage_blocks_for(bs);
  const int tile = stage_blocks * bs;
  return kStages * 2 * tile * lds +
         static_cast<int>(sizeof(float)) *
             (2 * R * d + R * tile + 3 * R + kStages * 2 * stage_blocks) +
         static_cast<int>(sizeof(int)) * w;
}

using KernelFn = void (*)(Params);

// The kernel an instantiation launches at a geometry, its block size, and
// its per-device "shared-memory limit raised" flags.
struct Choice {
  KernelFn fn;
  int threads;
  bool* done;
};

template <typename Q, typename S>
Choice choose(bool mma, int nr) {
  if constexpr (std::is_same<Q, bf16>::value) {
    if (mma) {
      static bool done1[paged_kv::kMaxDevices] = {};
      static bool done2[paged_kv::kMaxDevices] = {};
      return nr == 1 ? Choice{paged_decode_pipelined_mma_kernel<S, 1>,
                              kMmaThreads, done1}
                     : Choice{paged_decode_pipelined_mma_kernel<S, 2>,
                              kMmaThreads, done2};
    }
  }
  static bool done[paged_kv::kMaxDevices] = {};
  return {paged_decode_pipelined_kernel<Q, S>, kScalarThreads, done};
}

struct Geometry {
  int q_type, w, n_heads, kv_heads, d, bs;
  bool mma() const { return use_mma(q_type, w, n_heads, kv_heads, d); }
  int nr() const { return (w * (n_heads / kv_heads) + 7) / 8; }
};

struct Launch {
  Geometry geo;
  Params params;
  int rows, splits, smem;
  cudaStream_t stream;
};

template <typename Q, typename S>
int launch(const Launch& a) {
  const Choice c = choose<Q, S>(a.geo.mma(), a.geo.nr());
  const cudaError_t err = paged_kv::allow_max_smem(c.fn, c.done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(a.rows) * a.geo.kv_heads, a.splits);
  Params params = a.params;
  void* args[] = {&params};
  const cudaError_t rc =
      cudaLaunchKernel(reinterpret_cast<const void*>(c.fn), grid,
                       dim3(c.threads), args, a.smem, a.stream);
  const cudaError_t last = cudaGetLastError();  // and clear it
  return static_cast<int>(rc != cudaSuccess ? rc : last);
}

struct Occupancy {
  Geometry geo;
  int smem;
  int* ctas;
};

template <typename Q, typename S>
int occupancy(const Occupancy& a) {
  const Choice c = choose<Q, S>(a.geo.mma(), a.geo.nr());
  cudaError_t err = paged_kv::allow_max_smem(c.fn, c.done);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(a.ctas, c.fn, c.threads,
                                                      a.smem);
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
int tt_paged_decode_pipelined_smem_bytes(int q_type, int kv_type, int w,
                                         int n_heads, int kv_heads, int d,
                                         int bs) {
  return smem_bytes(q_type, kv_type, w, n_heads, kv_heads, d, bs);
}

// 1 if (q_type, geometry) runs the stage math on the tensor cores, 0 if on
// the scalar path.
int tt_paged_decode_pipelined_uses_mma(int q_type, int w, int n_heads,
                                       int kv_heads, int d) {
  return use_mma(q_type, w, n_heads, kv_heads, d) ? 1 : 0;
}

// The arguments of tt_paged_decode (paged_decode.cu): split s takes table
// entries [s split_blocks, (s + 1) split_blocks), whole 64-token stages that
// together cover the table; with 1 split the kernel writes out, with more
// each split's state goes to partials, (rows, w, h, splits, 2 + d) fp32,
// for tt_paged_decode_pipelined_combine. A pool row must be a multiple of 4
// bytes (the smallest cp.async); the wrapper checks it. Returns
// cudaGetLastError() after the launch (0 = launched); nothing is
// synchronised.
int tt_paged_decode_pipelined(int q_type, int kv_type, const void* q,
                              const void* k_pool, const void* v_pool,
                              const void* k_scale, const void* v_scale,
                              const void* tables, const void* positions,
                              void* out, void* partials, int rows, int w,
                              int n_heads, int kv_heads, int d, int bs,
                              int max_blocks, int splits, int split_blocks,
                              void* stream) {
  if (rows == 0) return 0;
  if (paged_kv::row_bytes_of(kv_type, d) % 4 || splits < 1 ||
      splits > 65535 || (splits > 1 && partials == nullptr) ||
      split_blocks < 0 || split_blocks % stage_blocks_for(bs) != 0 ||
      static_cast<int64_t>(splits) * split_blocks < max_blocks)
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch a{
      {q_type, w, n_heads, kv_heads, d, bs},
      {q, static_cast<const uint8_t*>(k_pool),
       static_cast<const uint8_t*>(v_pool),
       static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
       static_cast<const int*>(tables), static_cast<const int*>(positions),
       out, static_cast<float*>(partials), w, n_heads, kv_heads, d, bs,
       max_blocks, stage_blocks_for(bs), split_blocks},
      rows, splits, smem_bytes(q_type, kv_type, w, n_heads, kv_heads, d, bs),
      static_cast<cudaStream_t>(stream)};
  PAGED_KV_DISPATCH(q_type, kv_type, launch, a);
}

// CTAs of the kernel that (q_type, kv_type, geometry) launches that fit one
// SM at once, into *ctas; returns the CUDA error.
int tt_paged_decode_pipelined_ctas_per_sm(int q_type, int kv_type, int w,
                                          int n_heads, int kv_heads, int d,
                                          int bs, void* ctas) {
  const Occupancy a{{q_type, w, n_heads, kv_heads, d, bs},
                    smem_bytes(q_type, kv_type, w, n_heads, kv_heads, d, bs),
                    static_cast<int*>(ctas)};
  PAGED_KV_DISPATCH(q_type, kv_type, occupancy, a);
}

// paged_kv::combine_splits_kernel for this library's split states: merge
// the states of n_rows = rows * w * h output rows into out (q's type).
// Returns cudaGetLastError() after the launch.
int tt_paged_decode_pipelined_combine(int q_type, const void* partials,
                                      void* out, int n_rows, int splits,
                                      int d, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_type == 0) return combine<float>(partials, out, n_rows, splits, d, s);
  if (q_type == 1)
    return combine<bf16>(partials, out, n_rows, splits, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* tt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
