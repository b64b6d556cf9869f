// Candidate scoring for Hopper (sm_90a): masked max cosine and its slot.
//
// Replaces segger_tpu/ops/pallas/score.py::_score_kernel (score_max_pallas),
// the prediction assignment.  Per transcript row i:
//
//   cos_j = sum_f f32(tx[i, f]) * f32(bd[idx[i, j], f])   (gathered here)
//   z_j   = mask[i, j] ? cos_j : -1e30
//   max_i = max_j z_j;  slot_i = first j with z_j == max_i, or -1 when the
//   row has no valid slot (then max_i = -1e30)
//
// What bounds it on an H100: bytes.  A row reads its tx row and at most K
// candidate rows of F values against 2F flops each, far below the
// tensor-core ridge; the floor is those reads plus 8 bytes written per
// row over 3.35 TB/s.  The TPU kernel read a gathered (N, K, F) tensor
// that XLA had written to HBM; here the candidate rows are gathered
// through idx inside the kernel, and masked slots are not read at all.
//
// Design: one warp per transcript row, each lane holding F/32 contiguous
// channels of the tx row in registers; per valid slot the lanes read
// their channels of the candidate row and a warp-shuffle reduction gives
// the dot product, identical on every lane, so the running max and its
// slot stay uniform across the warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int VPL>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
score_max_kernel(const T* __restrict__ tx, const T* __restrict__ bd,
                 const int32_t* __restrict__ idx,
                 const uint8_t* __restrict__ mask, int n, int n_bd, int k,
                 int f, float* __restrict__ max_out,
                 int32_t* __restrict__ slot_out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // uniform across the warp
  const int c0 = lane * VPL;
  float t[VPL];
#pragma unroll
  for (int v = 0; v < VPL; ++v)
    t[v] = c0 + v < f ? to_f32(tx[(size_t)row * f + c0 + v]) : 0.f;

  float best = kNegInf;
  int best_slot = 0;
  bool any = false;
  for (int j = 0; j < k; ++j) {
    float z = kNegInf;
    if (mask[(size_t)row * k + j]) {
      any = true;
      const int src = min(max(idx[(size_t)row * k + j], 0), n_bd - 1);
      const T* g = bd + (size_t)src * f;
      float dot = 0.f;
#pragma unroll
      for (int v = 0; v < VPL; ++v)
        if (c0 + v < f) dot += t[v] * to_f32(g[c0 + v]);
      z = warp_sum(dot);
    }
    if (j == 0 || z > best) {  // strict: the first maximal slot wins
      best = z;
      best_slot = j;
    }
  }
  if (lane == 0) {
    max_out[row] = best;
    slot_out[row] = any ? best_slot : -1;
  }
}

template <typename T>
void launch(const void* tx, const void* bd, const void* idx, const void* mask,
            int n, int n_bd, int k, int f, void* max_out, void* slot_out,
            cudaStream_t stream) {
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const int vpl = (f + 31) / 32;
#define SGT_LAUNCH(V)                                                      \
  score_max_kernel<T, V><<<grid, block, 0, stream>>>(                      \
      (const T*)tx, (const T*)bd, (const int32_t*)idx,                     \
      (const uint8_t*)mask, n, n_bd, k, f, (float*)max_out,                \
      (int32_t*)slot_out)
  if (vpl <= 1) SGT_LAUNCH(1);
  else if (vpl <= 2) SGT_LAUNCH(2);
  else if (vpl <= 4) SGT_LAUNCH(4);
  else if (vpl <= 8) SGT_LAUNCH(8);
  else SGT_LAUNCH(16);
#undef SGT_LAUNCH
}

}  // namespace

// tx (n, f) and bd (n_bd, f) in the feature type (is_bf16: bfloat16, else
// float32); idx (n, k) int32; mask (n, k) bool (1 byte); max_out (n,)
// float32; slot_out (n,) int32.  The caller checks shapes and types and
// guarantees n > 0, n_bd > 0, k > 0, 0 < f <= 512.  Returns
// cudaGetLastError() after the launch.
extern "C" int sgt_score_max(const void* tx, const void* bd, const void* idx,
                             const void* mask, int n, int n_bd, int k, int f,
                             int is_bf16, void* max_out, void* slot_out,
                             void* stream) {
  if (is_bf16)
    launch<__nv_bfloat16>(tx, bd, idx, mask, n, n_bd, k, f, max_out, slot_out,
                          (cudaStream_t)stream);
  else
    launch<float>(tx, bd, idx, mask, n, n_bd, k, f, max_out, slot_out,
                  (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
