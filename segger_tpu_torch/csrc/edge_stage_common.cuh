// Shared pieces of the GATv2 edge-stage kernels (edge_stage_fwd.cu,
// edge_stage_bwd.cu, attn_fwd.cu): type conversions with the TPU kernels'
// rounding, warp reductions, the dropout keep multiplier of the three
// modes, and the row groups of the three kernels (chunks of a row, their
// arithmetic in the feature type, cp.async staging).
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

// the hash with mode 1's two seed words read from device memory, as the
// TPU kernels read theirs from a ref: a captured CUDA graph then replays
// with whatever words were written there before the replay
__device__ __forceinline__ KeepHash with_seed(KeepHash hp,
                                              const uint32_t* seed,
                                              int mode) {
  if (mode == kModePrng) {
    hp.s0 = seed[0];
    hp.s1 = seed[1];
  }
  return hp;
}

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

template <typename T>
__device__ __forceinline__ float keep_of(int mode, const T* keep,
                                         const KeepHash& hash, int row,
                                         int j, int h, int k, int heads,
                                         size_t slot_flat) {
  if (mode == kModePrng)
    return keep_value<T, kModePrng>(keep, hash, row, j, h, k, heads,
                                    slot_flat);
  if (mode == kModeKeep)
    return keep_value<T, kModeKeep>(keep, hash, row, j, h, k, heads,
                                    slot_flat);
  return 1.f;
}

// ---------------------------------------------------------------------
// Row groups: a block of kMaxThreads threads serves R = kMaxThreads / L
// rows, L lanes a row (a power of two <= 32), each lane holding NV chunks
// of CB = 4*W contiguous bytes; chunk v of lane l covers channels
// (v*L + l)*VEC.., so neighbouring lanes touch neighbouring bytes.
// ---------------------------------------------------------------------
constexpr int kMaxThreads = 128;

// the sum over the `width` lanes of a row group
__device__ __forceinline__ float group_sum(float v, int width) {
  for (int off = width >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off, width);
  return v;
}

// A chunk: W 32-bit words, each one f32 or one bf16x2 pair.
template <int W>
struct Chunk {
  uint32_t w[W];
};

template <int W>
__device__ __forceinline__ Chunk<W> load_vec(const void* p) {
  Chunk<W> c;
  if constexpr (W == 4) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    c.w[0] = u.x, c.w[1] = u.y, c.w[2] = u.z, c.w[3] = u.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    c.w[0] = u.x, c.w[1] = u.y;
  }
  return c;
}

template <int W>
__device__ __forceinline__ void store_vec(void* p, const Chunk<W>& c) {
  if constexpr (W == 4)
    *reinterpret_cast<uint4*>(p) = make_uint4(c.w[0], c.w[1], c.w[2], c.w[3]);
  else
    *reinterpret_cast<uint2*>(p) = make_uint2(c.w[0], c.w[1]);
}

template <typename T>
constexpr int kPerWord = 4 / (int)sizeof(T);  // channels in a word

template <typename T, int W>
__device__ __forceinline__ void unpack(const Chunk<W>& c, float* f) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if constexpr (sizeof(T) == 4) {
      f[i] = __uint_as_float(c.w[i]);
    } else {  // a bf16 is the high half of its f32
      f[2 * i] = __uint_as_float(c.w[i] << 16);
      f[2 * i + 1] = __uint_as_float(c.w[i] & 0xffff0000u);
    }
  }
}

// round to nearest even into the feature type
template <typename T, int W>
__device__ __forceinline__ Chunk<W> pack(const float* f) {
  Chunk<W> c;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if constexpr (sizeof(T) == 4) {
      c.w[i] = __float_as_uint(f[i]);
    } else {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      c.w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
  }
  return c;
}

// a * b and a + b rounded to T, word by word.  The product or sum of two
// bf16 values is exact in f32 (a sum whose exponents differ by more than
// 16 rounds to the larger either way), so one bf16x2 operation, which
// rounds the exact result once, equals round_T of the f32 result.
template <typename T, int W>
__device__ __forceinline__ Chunk<W> mul_t(const Chunk<W>& a,
                                          const Chunk<W>& b) {
  Chunk<W> c;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if constexpr (sizeof(T) == 4) {
      c.w[i] = __float_as_uint(
          __fmul_rn(__uint_as_float(a.w[i]), __uint_as_float(b.w[i])));
    } else {
      const __nv_bfloat162 r =
          __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a.w[i]),
                  *reinterpret_cast<const __nv_bfloat162*>(&b.w[i]));
      c.w[i] = *reinterpret_cast<const uint32_t*>(&r);
    }
  }
  return c;
}

template <typename T, int W>
__device__ __forceinline__ Chunk<W> add_t(const Chunk<W>& a,
                                          const Chunk<W>& b) {
  Chunk<W> c;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if constexpr (sizeof(T) == 4) {
      c.w[i] = __float_as_uint(
          __fadd_rn(__uint_as_float(a.w[i]), __uint_as_float(b.w[i])));
    } else {
      const __nv_bfloat162 r =
          __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&a.w[i]),
                  *reinterpret_cast<const __nv_bfloat162*>(&b.w[i]));
      c.w[i] = *reinterpret_cast<const uint32_t*>(&r);
    }
  }
  return c;
}

// s = p > 0 ? p : slope*p from p and sp = round_T(slope*p), word by word:
// the maximum of the two for slope <= 1 (use_max), else the minimum, one
// instruction for two bf16 channels.  That equals p > 0 ? p : slope*p for
// every p, up to the sign of a zero s when the slope is negative, and but
// for p = -inf with slope 0 (where the plain versions give NaN).
template <typename T, int W>
__device__ __forceinline__ Chunk<W> leaky_t(const Chunk<W>& p,
                                            const Chunk<W>& sp, bool use_max) {
  Chunk<W> c;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if constexpr (sizeof(T) == 4) {
      const float a = __uint_as_float(p.w[i]), b = __uint_as_float(sp.w[i]);
      c.w[i] = __float_as_uint(use_max ? fmaxf(a, b) : fminf(a, b));
    } else {
      const __nv_bfloat162 a =
          *reinterpret_cast<const __nv_bfloat162*>(&p.w[i]);
      const __nv_bfloat162 b =
          *reinterpret_cast<const __nv_bfloat162*>(&sp.w[i]);
      const __nv_bfloat162 r = use_max ? __hmax2(a, b) : __hmin2(a, b);
      c.w[i] = *reinterpret_cast<const uint32_t*>(&r);
    }
  }
  return c;
}

// one chunk of a row at channel c0 (c0 < hc): a vector load when vec,
// else element loads masked at hc
template <typename T, int W>
__device__ __forceinline__ void load_chunk(const T* __restrict__ row, int c0,
                                           int hc, bool vec, float* f) {
  constexpr int VEC = W * kPerWord<T>;
  if (vec) {
    unpack<T, W>(load_vec<W>(row + c0), f);
    return;
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    f[e] = c0 + e < hc ? to_f32(row[c0 + e]) : 0.f;
}

template <typename T, int W>
__device__ __forceinline__ void store_chunk(T* __restrict__ row, int c0,
                                            int hc, bool vec,
                                            const float* f) {
  constexpr int VEC = W * kPerWord<T>;
  if (vec) {
    store_vec<W>(row + c0, pack<T, W>(f));
    return;
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    if (c0 + e < hc) row[c0 + e] = from_f32<T>(f[e]);
}

// cp.async of one chunk (16 bytes bypass L1; 8 bytes through it)
template <int W>
__device__ __forceinline__ void cp_async_chunk(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if constexpr (W == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// The lane's chunks of the source rows of slots [j0, j0 + nc) of its row
// into its staging rows; masked slots (src_s < 0) are not copied (they are
// never read).
template <typename T, int W, int NV>
__device__ __forceinline__ void stage_slots(T* stage, const T* __restrict__ xl,
                                            const int* src_s, int j0, int nc,
                                            int hc, int hc_pad, int lanes,
                                            int lg, bool vec) {
  constexpr int VEC = W * kPerWord<T>;
  for (int jj = 0; jj < nc; ++jj) {
    const int src = src_s[j0 + jj];
    if (src < 0) continue;
    const T* g = xl + (size_t)src * hc;
    T* dst = stage + (size_t)jj * hc_pad;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c0 = (v * lanes + lg) * VEC;
      if (c0 >= hc) continue;
      if (vec) {
        cp_async_chunk<W>(dst + c0, g + c0);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          dst[c0 + e] = c0 + e < hc ? g[c0 + e] : from_f32<T>(0.f);
      }
    }
  }
  cp_async_wait_all();
}

}  // namespace sgt
