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
// pool) into a double buffer by hand, issuing block b+1's copy before it
// computes block b, so the copy overlaps the block's two products, and it
// walks only the row's live depth. The Hopper design keeps exactly that:
//
// - One CTA of 256 threads per (row, kv head) walks the row's live blocks,
//   0 .. min(max_pos / bs + 1, max_blocks), in stages of about 64 tokens
//   (64 / bs blocks).
// - A ring of kStages = 2 shared-memory stages holds each stage's K and V
//   rows as the pool's raw storage bytes. It is filled with cp.async
//   (16-byte copies where a row's bytes allow, 8- or 4-byte ones for the
//   small rows of the tiny and micro presets, down to an int4 micro row of
//   4 bytes), one commit group per stage. Stage s + 1's copies are issued
//   before the CTA waits for stage s (cp.async.wait_group 1) and computes
//   it, so the next stage's bytes travel while this one is consumed.
// - Codes are converted to fp32 in registers as the products read them
//   from shared memory; no dequantized or widened copy is stored. Rows are
//   padded by 16 bytes in shared memory when they are a whole number of
//   16-byte vectors, so threads that read different tokens' rows at the
//   same offset hit different banks.
// - Scores: one thread per (query row, token), the dot product over d in
//   fp32; the online softmax: one warp per query row; P.V: one thread per
//   output element, block by block.
//
// Bound: memory, as paged_decode.cu: each live token's K and V bytes once
// per kv head, plus the scales, q and out. What is left on the table: one
// CTA per (row, kv head) is 32 CTAs at the flagship's 16 slots, so one
// CTA's serial walk still sets the time (split-KV would fill the card);
// TMA bulk copies, wgmma and warp specialisation are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "paged_kv.cuh"

namespace {

using paged_kv::kNegInf;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;          // shared-memory ring depth
constexpr int kStageTokens = 64;    // tokens per stage (rounded to blocks)

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
// shared-memory row stride.
__host__ __device__ inline int copy_bytes(int rb) {
  return rb % 16 == 0 ? 16 : rb % 8 == 0 ? 8 : 4;
}
__host__ __device__ inline int smem_row_bytes(int rb) {
  return rb % 16 == 0 ? rb + 16 : rb;
}

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

// What a CTA's stage copies need to know.
struct Walk {
  const uint8_t* k_pool;
  const uint8_t* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* table;  // the row's block table
  uint8_t* ring;     // kStages x (K rows, V rows) x tile x lds bytes
  float* ssc;        // kStages x (k scales, v scales) x stage_blocks
  int n_live, stage_blocks, bs, kv_heads, kvh, rb, lds, tile;
};

// Issue stage st's copies (its blocks' K and V rows, and for a quantized
// pool their scales) into ring slot st % kStages, as one commit group.
template <typename S>
__device__ __forceinline__ void issue_stage(const Walk& w, int st) {
  const int b0 = st * w.stage_blocks;
  const int nb = min(w.stage_blocks, w.n_live - b0);
  uint8_t* dk = w.ring + (st % kStages) * 2 * w.tile * w.lds;
  uint8_t* dv = dk + w.tile * w.lds;
  const int cb = copy_bytes(w.rb);
  const int per_row = w.rb / cb;
  const int n = nb * w.bs * per_row;  // copies per pool
  for (int e = threadIdx.x; e < 2 * n; e += kThreads) {
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
    for (int i = threadIdx.x; i < nb; i += kThreads) {
      const int64_t at =
          static_cast<int64_t>(w.table[b0 + i]) * w.kv_heads + w.kvh;
      cp_async(sc + i, w.k_scale + at, 4);
      cp_async(sc + w.stage_blocks + i, w.v_scale + at, 4);
    }
  }
  cp_async_commit();
}

template <typename Q, typename S>
__global__ void __launch_bounds__(kThreads)
paged_decode_pipelined_kernel(const Q* __restrict__ q,
                              const uint8_t* __restrict__ k_pool,
                              const uint8_t* __restrict__ v_pool,
                              const float* __restrict__ k_scale,
                              const float* __restrict__ v_scale,
                              const int* __restrict__ tables,
                              const int* __restrict__ positions,
                              Q* __restrict__ out, int w, int n_heads,
                              int kv_heads, int d, int bs, int max_blocks,
                              int stage_blocks) {
  const int kvh = blockIdx.x % kv_heads;
  const int row = blockIdx.x / kv_heads;
  const int group = n_heads / kv_heads;
  const int R = w * group;  // query rows of this CTA: (query, head) pairs
  const int tile = stage_blocks * bs;  // tokens per stage
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
  const int n_stages = (n_live + stage_blocks - 1) / stage_blocks;
  const int* table = tables + static_cast<int64_t>(row) * max_blocks;

  const Walk walk{k_pool, v_pool, k_scale, v_scale, table, ring, ssc,
                  n_live, stage_blocks, bs, kv_heads, kvh, rb, lds, tile};
  if (n_stages > 0) issue_stage<S>(walk, 0);
  for (int st = 0; st < n_stages; ++st) {
    if (st + 1 < n_stages) {
      issue_stage<S>(walk, st + 1);  // its bytes travel during this stage
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int b0 = st * stage_blocks;
    const int nb = min(stage_blocks, n_live - b0);
    const int n_tok = nb * bs;
    const int base = b0 * bs;  // position of the stage's first token
    const uint8_t* sk = ring + (st % kStages) * 2 * tile * lds;
    const uint8_t* sv = sk + tile * lds;
    const float* sc = ssc + (st % kStages) * 2 * stage_blocks;

    // Scores: one thread per (query row, token).
    for (int pair = tid; pair < R * tile; pair += kThreads) {
      const int r = pair / tile;
      const int t = pair % tile;
      float s = kNegInf;
      if (t < n_tok && base + t <= spos[r / group]) {
        s = row_dot<S>(sq + r * d, sk + t * lds, rb) / sqrt_d;
        if constexpr (S::kQuant) s *= sc[t / bs];
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

    // acc = acc * corr + P.V, block by block (a quantized block's p.v
    // takes its v_scale first): one thread per output element.
    for (int e = tid; e < R * d; e += kThreads) {
      const int r = e / d;
      const int j = e % d;
      const float* pr = sp + r * tile;
      float acc = sacc[e] * scorr[r];
      for (int blk = 0; blk < nb; ++blk) {
        float part = 0.0f;
        for (int t = blk * bs; t < (blk + 1) * bs; ++t)
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

int stage_blocks_for(int bs) {
  return bs >= kStageTokens ? 1 : kStageTokens / bs;
}

int smem_bytes(int kv_type, int w, int n_heads, int kv_heads, int d,
               int bs) {
  const int R = w * (n_heads / kv_heads);
  const int stage_blocks = stage_blocks_for(bs);
  const int tile = stage_blocks * bs;
  const int lds = smem_row_bytes(paged_kv::row_bytes_of(kv_type, d));
  return kStages * 2 * tile * lds +
         static_cast<int>(sizeof(float)) *
             (2 * R * d + R * tile + 3 * R + kStages * 2 * stage_blocks) +
         static_cast<int>(sizeof(int)) * w;
}

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
      paged_kv::allow_max_smem(paged_decode_pipelined_kernel<Q, S>, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(a.rows) * a.kv_heads);
  paged_decode_pipelined_kernel<Q, S>
      <<<grid, kThreads, a.smem_bytes, a.stream>>>(
          static_cast<const Q*>(a.q), static_cast<const uint8_t*>(a.k_pool),
          static_cast<const uint8_t*>(a.v_pool),
          static_cast<const float*>(a.k_scale),
          static_cast<const float*>(a.v_scale),
          static_cast<const int*>(a.tables),
          static_cast<const int*>(a.positions), static_cast<Q*>(a.out), a.w,
          a.n_heads, a.kv_heads, a.d, a.bs, a.max_blocks,
          stage_blocks_for(a.bs));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one CTA needs, in bytes (the wrapper checks it against the
// card's limit before launching).
int tt_paged_decode_pipelined_smem_bytes(int kv_type, int w, int n_heads,
                                         int kv_heads, int d, int bs) {
  return smem_bytes(kv_type, w, n_heads, kv_heads, d, bs);
}

// The arguments of tt_paged_decode (paged_decode.cu). A pool row must be a
// multiple of 4 bytes (the smallest cp.async); the wrapper checks it.
// Returns cudaGetLastError() after the launch (0 = launched); nothing is
// synchronised.
int tt_paged_decode_pipelined(int q_type, int kv_type, const void* q,
                              const void* k_pool, const void* v_pool,
                              const void* k_scale, const void* v_scale,
                              const void* tables, const void* positions,
                              void* out, int rows, int w, int n_heads,
                              int kv_heads, int d, int bs, int max_blocks,
                              void* stream) {
  if (rows == 0) return 0;
  if (paged_kv::row_bytes_of(kv_type, d) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k_pool, v_pool, k_scale, v_scale, tables, positions, out,
               rows, w, n_heads, kv_heads, d, bs, max_blocks,
               smem_bytes(kv_type, w, n_heads, kv_heads, d, bs),
               static_cast<cudaStream_t>(stream)};
  PAGED_KV_DISPATCH(q_type, kv_type, launch, a);
}

const char* tt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
