// Shared pieces of the GATv2 edge-stage kernels (edge_stage_fwd.cu,
// edge_stage_bwd.cu): type conversions with the TPU kernels' rounding,
// warp reductions, and the dropout keep multiplier of the three modes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sgt {

constexpr float kNegInf = -1e30f;
constexpr int kWarpsPerBlock = 8;

// the modes of gatv2_edge_stage_pallas: no dropout, dropout hashed from a
// seed, dropout multipliers read from an (N, K, H) tensor
constexpr int kModeNoKeep = 0;
constexpr int kModePrng = 1;
constexpr int kModeKeep = 2;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// an f32 value rounded to the feature type, back in f32
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// the hashed-dropout parameters: the two seed words, the inclusive
// threshold on the low 31 bits and the multiplier of a kept slot
struct KeepHash {
  uint32_t s0, s1, thresh;
  float inv_keep;
};

// murmur3 fmix32 (postgather.py::_mix32): wrapping multiplies, logical
// shifts
__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85ebca6bu;
  x ^= x >> 13;
  x *= 0xc2b2ae35u;
  x ^= x >> 16;
  return x;
}

// postgather.py::_prng_keep at one (row, slot, head)
__device__ __forceinline__ float prng_keep(const KeepHash& hp, int row,
                                           int slot, int head, int k,
                                           int heads) {
  const uint32_t pos = (uint32_t)row * (uint32_t)(k * heads) +
                       (uint32_t)slot * (uint32_t)heads + (uint32_t)head;
  uint32_t x = fmix32(pos ^ hp.s0);
  x = fmix32(x ^ (hp.s1 + 0x9E3779B9u));
  return (x & 0x7FFFFFFFu) <= hp.thresh ? hp.inv_keep : 0.f;
}

// the keep multiplier of (row, slot, head) in mode MODE; slot_flat is
// row * k + slot
template <typename T, int MODE>
__device__ __forceinline__ float keep_value(const T* __restrict__ keep,
                                            const KeepHash& hp, int row,
                                            int slot, int head, int k,
                                            int heads, size_t slot_flat) {
  if (MODE == kModePrng) return prng_keep(hp, row, slot, head, k, heads);
  if (MODE == kModeKeep) return to_f32(keep[slot_flat * heads + head]);
  return 1.f;
}

}  // namespace sgt
