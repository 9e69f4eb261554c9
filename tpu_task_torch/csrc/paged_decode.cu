// Paged-decode attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel tpu_task/ml/ops/paged_attention.py
// :: _paged_decode_kernel (called through paged_decode_attention): block-
// table-aware grouped-query attention that reads keys and values straight
// from the physical KV pools, so the gathered (rows, L, kv, d) view the
// plain version builds never exists.
//
//   q         (rows, w, h, d)             fp32 or bf16
//   k/v pool  (n_blocks, bs, kv, d)       same type as q
//   tables    (rows, max_blocks)   int32  physical block of each logical one
//   positions (rows, w)            int32  absolute position of each query
//   out       (rows, w, h, d)             q's type
//
// Cache slot j is visible to a query at position p iff j <= p. Scores are
// (q . k) / sqrt(d) in fp32; a masked score is NEG_INF and its weight
// exactly 0.0; a row with no visible slot outputs 0 (l == 0 divides by 1).
// Query head h belongs to kv head h / group (contiguous groups).
//
// Design: one CTA of 256 threads per (row, kv head). The CTA stages its
// query group in fp32 shared memory, then walks the row's LIVE blocks only,
// 0 .. min(max_pos / bs + 1, max_blocks), in a loop that takes the place of
// the TPU kernel's sequential grid axis. Each iteration takes a tile of
// about 64 tokens (64 / bs blocks): every thread issues all of its 16-byte
// K and V loads for the tile before it stores any, so the tile's loads are
// in flight together, and stores them as fp32 rows padded to d + 1 floats,
// so threads that walk different tokens hit different banks. Then one
// thread per (query row, token) takes the full dot product, one warp per
// query row updates the online softmax (m, l), and one thread per output
// element rescales and accumulates P.V in fp32.
//
// Bound: memory. The work that must move is every live token's K and V
// once per kv head (sum of live tokens x kv x d x 2 x itemsize per layer)
// plus q and out; the arithmetic is ~4 flops per loaded element per query
// of the group, far below the card's ratio. What this simple design leaves
// on the table: the grid is rows x kv_heads CTAs (2 at batch 1, on 132
// SMs), so one CTA's serial walk sets the time; a split of the KV walk
// across CTAs (flash-decoding) would fill the card. The next tile's loads
// are not overlapped with this tile's math either (cp.async or TMA double
// buffering would). Inside the CTA the tile's shared-memory traffic sets
// the pace (the fp32 staging stores, then two loads per multiply-add in the
// score and P.V loops); registers or the tensor cores would cut it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileTokens = 64;  // tokens per iteration (rounded to blocks)
constexpr int kUnroll = 8;       // 16-byte loads in flight per thread

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

// Copy the K and V rows of kv head `kvh` for one tile (n_tok tokens of the
// physical blocks in `stab`) into fp32 shared memory rows of stride `ld`.
// Rows of d elements are contiguous in the pools, so consecutive threads
// read consecutive 16-byte vectors; each thread loads up to kUnroll vectors
// before it stores any.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ k_pool,
                                          const T* __restrict__ v_pool,
                                          float* __restrict__ sk,
                                          float* __restrict__ sv,
                                          const int* __restrict__ stab,
                                          int n_tok, int bs, int kv_heads,
                                          int kvh, int d, int ld) {
  constexpr int kVec = 16 / sizeof(T);
  if (d % kVec == 0) {
    const int vecs_per_row = d / kVec;
    const int n_vec = n_tok * vecs_per_row;  // per pool
    for (int first = 0; first < 2 * n_vec; first += kThreads * kUnroll) {
      uint4 regs[kUnroll];
#pragma unroll
      for (int i = 0; i < kUnroll; ++i) {
        int e = first + i * kThreads + threadIdx.x;
        if (e < 2 * n_vec) {
          const T* pool = e < n_vec ? k_pool : v_pool;
          e = e < n_vec ? e : e - n_vec;
          const int t = e / vecs_per_row;
          const int j = (e % vecs_per_row) * kVec;
          const int64_t phys = stab[t / bs];
          const int64_t off = ((phys * bs + t % bs) * kv_heads + kvh) * d + j;
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
          const int j = (e % vecs_per_row) * kVec;
          const T* vals = reinterpret_cast<const T*>(&regs[i]);
#pragma unroll
          for (int x = 0; x < kVec; ++x) dst[t * ld + j + x] = to_float(vals[x]);
        }
      }
    }
  } else {
    for (int e = threadIdx.x; e < 2 * n_tok * d; e += kThreads) {
      const bool is_k = e < n_tok * d;
      const int f = is_k ? e : e - n_tok * d;
      const int t = f / d;
      const int j = f % d;
      const int64_t phys = stab[t / bs];
      const int64_t off = ((phys * bs + t % bs) * kv_heads + kvh) * d + j;
      (is_k ? sk : sv)[t * ld + j] = to_float((is_k ? k_pool : v_pool)[off]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ tables,
                    const int* __restrict__ positions, T* __restrict__ out,
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
  int* spos = reinterpret_cast<int*>(scorr + R);  // (w) positions
  int* stab = spos + w;          // (tile_blocks) physical blocks of the tile

  for (int e = tid; e < R * d; e += kThreads) {
    const int r = e / d;
    const int j = e % d;
    const int wi = r / group;
    const int g = r % group;
    const int64_t src =
        ((static_cast<int64_t>(row) * w + wi) * n_heads + kvh * group + g) *
            d + j;
    sq[e] = to_float(q[src]);
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
    for (int i = tid; i < nb; i += kThreads) stab[i] = table[b0 + i];
    __syncthreads();
    load_tile(k_pool, v_pool, sk, sv, stab, n_tok, bs, kv_heads, kvh, d, ld);
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
      m_tile = warp_max(m_tile);
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
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf((m <= kNegInf / 2 ? kNegInf : m) - shift);
        sl[r] = sl[r] * corr + sum;
        sm[r] = m_new;
        scorr[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P.V: one thread per output element.
    for (int e = tid; e < R * d; e += kThreads) {
      const int r = e / d;
      const int j = e % d;
      const float* pr = sp + r * tile;
      float acc = sacc[e] * scorr[r];
      for (int t = 0; t < n_tok; ++t) acc += pr[t] * sv[t * ld + j];
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
    out[dst] = from_float<T>(sacc[e] / (l == 0.0f ? 1.0f : l));
  }
}

int tile_blocks_for(int bs) { return bs >= kTileTokens ? 1 : kTileTokens / bs; }

constexpr int kMaxDevices = 64;

// Past 48 KB a kernel's dynamic shared memory must be allowed explicitly,
// per device. It is raised once per device to the device's opt-in maximum,
// so later launches make no further attribute calls.
template <typename T>
cudaError_t allow_max_smem() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  int max_optin = 0;
  err = cudaDeviceGetAttribute(&max_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(paged_decode_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             max_optin);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* positions, void* out, int rows,
           int w, int n_heads, int kv_heads, int d, int bs, int max_blocks,
           int smem_bytes, cudaStream_t stream) {
  const cudaError_t err = allow_max_smem<T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(rows) * kv_heads);
  paged_decode_kernel<T><<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(positions), static_cast<T*>(out), w, n_heads,
      kv_heads, d, bs, max_blocks, tile_blocks_for(bs));
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
             (2 * R * d + 2 * tile * (d + 1) + R * tile + 3 * R) +
         static_cast<int>(sizeof(int)) * (w + tile_blocks);
}

// dtype: 0 = fp32, 1 = bf16. Returns cudaGetLastError() after the launch
// (0 = launched); nothing is synchronised.
int tt_paged_decode(int dtype, const void* q, const void* k_pool,
                    const void* v_pool, const void* tables,
                    const void* positions, void* out, int rows, int w,
                    int n_heads, int kv_heads, int d, int bs, int max_blocks,
                    void* stream) {
  if (rows == 0) return 0;
  const int smem = tt_paged_decode_smem_bytes(w, n_heads, kv_heads, d, bs);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, tables, positions, out, rows, w,
                         n_heads, kv_heads, d, bs, max_blocks, smem, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tables, positions, out,
                                 rows, w, n_heads, kv_heads, d, bs,
                                 max_blocks, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* tt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
