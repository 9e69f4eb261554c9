// Shared pieces of the two paged-decode kernels (paged_decode.cu and
// paged_decode_pipelined.cu): how each KV pool storage type is read and
// converted to fp32 in registers, the query/output types, warp reductions,
// the one-time opt-in to more than 48 KB of dynamic shared memory, and the
// combine kernel that merges the partial softmax states of a split KV walk.
//
// Pool storage types, by the code the Python wrapper passes (kv_type):
//   0 fp32, 1 bf16              model-dtype pools (values)
//   2 int8, 3 fp8 e4m3          quantized codes, one per byte
//   4 int4                      two codes per uint8 byte, even channel in the
//                               low nibble, sign-extended by (n ^ 8) - 8
// A quantized pool's values are code x scale, with one fp32 scale per
// (block, kv head); the kernels convert codes only, and apply the scales to
// a block's scores and to its p.v, as the TPU kernels do.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paged_kv {

constexpr float kNegInf = -1e30f;

// Each storage type reads in units of kUnitBytes bytes holding kVals values;
// `word` converts one aligned 32-bit word (kWordVals values) and `unit` one
// unit at any unit-aligned address.
struct StoreF32 {
  static constexpr int kUnitBytes = 4, kVals = 1, kWordVals = 1;
  static constexpr bool kQuant = false;
  __device__ static void word(uint32_t w, float* out) {
    out[0] = __uint_as_float(w);
  }
  __device__ static void unit(const uint8_t* p, float* out) {
    out[0] = *reinterpret_cast<const float*>(p);
  }
  __device__ static float at(const uint8_t* row, int j) {
    return reinterpret_cast<const float*>(row)[j];
  }
};

struct StoreBF16 {
  static constexpr int kUnitBytes = 2, kVals = 1, kWordVals = 2;
  static constexpr bool kQuant = false;
  __device__ static void word(uint32_t w, float* out) {
    out[0] = __uint_as_float(w << 16);
    out[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ static void unit(const uint8_t* p, float* out) {
    out[0] = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
  }
  __device__ static float at(const uint8_t* row, int j) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(row)[j]);
  }
};

struct StoreI8 {
  static constexpr int kUnitBytes = 1, kVals = 1, kWordVals = 4;
  static constexpr bool kQuant = true;
  __device__ static void word(uint32_t w, float* out) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      out[k] = static_cast<float>(static_cast<int8_t>(w >> (8 * k)));
  }
  __device__ static void unit(const uint8_t* p, float* out) {
    out[0] = static_cast<float>(static_cast<int8_t>(p[0]));
  }
  __device__ static float at(const uint8_t* row, int j) {
    return static_cast<float>(static_cast<int8_t>(row[j]));
  }
};

struct StoreFP8 {
  static constexpr int kUnitBytes = 1, kVals = 1, kWordVals = 4;
  static constexpr bool kQuant = true;
  __device__ static float cvt(uint32_t byte) {
    __nv_fp8_e4m3 v;
    v.__x = static_cast<__nv_fp8_storage_t>(byte & 0xffu);
    return static_cast<float>(v);
  }
  __device__ static void word(uint32_t w, float* out) {
#pragma unroll
    for (int k = 0; k < 4; ++k) out[k] = cvt(w >> (8 * k));
  }
  __device__ static void unit(const uint8_t* p, float* out) {
    out[0] = cvt(p[0]);
  }
  __device__ static float at(const uint8_t* row, int j) { return cvt(row[j]); }
};

struct StoreI4 {
  static constexpr int kUnitBytes = 1, kVals = 2, kWordVals = 8;
  static constexpr bool kQuant = true;
  __device__ static float nibble(uint32_t n) {
    return static_cast<float>(static_cast<int>((n & 15u) ^ 8u) - 8);
  }
  __device__ static void word(uint32_t w, float* out) {
#pragma unroll
    for (int k = 0; k < 8; ++k) out[k] = nibble(w >> (4 * k));
  }
  __device__ static void unit(const uint8_t* p, float* out) {
    out[0] = nibble(p[0]);
    out[1] = nibble(p[0] >> 4);
  }
  __device__ static float at(const uint8_t* row, int j) {
    return nibble(row[j >> 1] >> (4 * (j & 1)));
  }
};

// Bytes of one (token, kv head) row of d values in storage S.
template <typename S>
__host__ __device__ constexpr int row_bytes(int d) {
  return d / S::kVals * S::kUnitBytes;
}

__host__ __device__ inline int row_bytes_of(int kv_type, int d) {
  return kv_type == 0 ? 4 * d : kv_type == 1 ? 2 * d : kv_type == 4 ? d / 2
                                                                     : d;
}

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

constexpr int kMaxDevices = 64;

// Past 48 KB a kernel's dynamic shared memory must be allowed explicitly,
// per device. It is raised once per device and kernel to the device's
// opt-in maximum, so later launches make no further attribute calls.
template <typename Kernel>
cudaError_t allow_max_smem(Kernel kernel, bool* done) {
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

// -- split-KV partial states and their merge ---------------------------------
//
// A kernel that cuts one row's KV walk over `splits` CTAs has each CTA write,
// for every query row (query, head) it owns, its online-softmax state over
// its part of the walk: m (running max), l (running sum) and the
// unnormalised acc (d values), all fp32, kPartialHead + d floats. Layout
// (rows, w, h, splits, kPartialHead + d), so one output row's splits are
// contiguous. A split that saw no visible slot writes m = kNegInf, l = 0,
// acc = 0.
constexpr int kPartialHead = 2;  // m, l; then acc[0 .. d)

// Weight of a split's state under the merged max M. A state whose m is the
// mask value contributes nothing, so a row with no visible slot in any
// split merges to exactly 0 (not NaN, and not exp(0) = 1 when M is the mask
// value too).
__device__ __forceinline__ float split_weight(float m, float M) {
  return m <= kNegInf / 2 ? 0.0f : expf(m - M);
}

constexpr int kCombineWarps = 4;  // output rows per CTA, one warp each
constexpr int kCombineVals = 4;   // head-dim elements per lane per pass

// One warp per output row: M = max_s m_s, L = sum_s l_s e^(m_s - M),
// o = sum_s acc_s e^(m_s - M) / (L == 0 ? 1 : L), written in Q. Lanes walk
// splits for M and L (m and l share a sector, so L re-reads from L1), then
// head-dim elements for o: each split's acc row is read coalesced,
// kCombineVals independent loads a lane per split and eight splits
// unrolled, so the walk's loads are in flight together rather than one
// round trip after another.
template <typename Q>
__global__ void __launch_bounds__(32 * kCombineWarps)
combine_splits_kernel(const float* __restrict__ partials, Q* __restrict__ out,
                      int n_rows, int splits, int d) {
  const int lane = threadIdx.x & 31;
  const int64_t o = static_cast<int64_t>(blockIdx.x) * kCombineWarps +
                    (threadIdx.x >> 5);
  if (o >= n_rows) return;  // warp-uniform
  const int ld = kPartialHead + d;
  const float* p = partials + o * splits * ld;
  float M = kNegInf;
  for (int s = lane; s < splits; s += 32) M = fmaxf(M, p[s * ld]);
  M = warp_max(M);
  float L = 0.0f;
  for (int s = lane; s < splits; s += 32)
    L += p[s * ld + 1] * split_weight(p[s * ld], M);
  L = warp_sum(L);
  const float l_safe = L == 0.0f ? 1.0f : L;
  for (int j0 = lane; j0 < d; j0 += 32 * kCombineVals) {
    float acc[kCombineVals] = {};
#pragma unroll 8
    for (int s = 0; s < splits; ++s) {
      const float* ps = p + s * ld;
      const float weight = split_weight(ps[0], M);
#pragma unroll
      for (int k = 0; k < kCombineVals; ++k) {
        const int j = j0 + 32 * k;
        if (j < d) acc[k] += ps[kPartialHead + j] * weight;
      }
    }
#pragma unroll
    for (int k = 0; k < kCombineVals; ++k) {
      const int j = j0 + 32 * k;
      if (j < d) out[o * d + j] = from_float<Q>(acc[k] / l_safe);
    }
  }
}

// Merge n_rows output rows' split states into out; returns
// cudaGetLastError() after the launch.
template <typename Q>
cudaError_t launch_combine(const float* partials, Q* out, int n_rows,
                           int splits, int d, cudaStream_t stream) {
  if (n_rows == 0) return cudaSuccess;
  const unsigned grid = (n_rows + kCombineWarps - 1) / kCombineWarps;
  combine_splits_kernel<Q><<<grid, 32 * kCombineWarps, 0, stream>>>(
      partials, out, n_rows, splits, d);
  return cudaGetLastError();
}

}  // namespace paged_kv

// One (q type, kv type) pair of a launch: calls LAUNCH<Q, S>(...) for the
// pairs the kernels take (q fp32 or bf16; a model-dtype pool of q's own
// type, or any quantized pool) and returns cudaErrorInvalidValue for the
// rest.
#define PAGED_KV_DISPATCH(q_type, kv_type, LAUNCH, ...)                      \
  do {                                                                       \
    using namespace paged_kv;                                                \
    if (q_type == 0) {                                                       \
      switch (kv_type) {                                                     \
        case 0: return LAUNCH<float, StoreF32>(__VA_ARGS__);                 \
        case 2: return LAUNCH<float, StoreI8>(__VA_ARGS__);                  \
        case 3: return LAUNCH<float, StoreFP8>(__VA_ARGS__);                 \
        case 4: return LAUNCH<float, StoreI4>(__VA_ARGS__);                  \
      }                                                                      \
    } else if (q_type == 1) {                                                \
      switch (kv_type) {                                                     \
        case 1: return LAUNCH<__nv_bfloat16, StoreBF16>(__VA_ARGS__);        \
        case 2: return LAUNCH<__nv_bfloat16, StoreI8>(__VA_ARGS__);          \
        case 3: return LAUNCH<__nv_bfloat16, StoreFP8>(__VA_ARGS__);         \
        case 4: return LAUNCH<__nv_bfloat16, StoreI4>(__VA_ARGS__);          \
      }                                                                      \
    }                                                                        \
    return static_cast<int>(cudaErrorInvalidValue);                          \
  } while (0)
