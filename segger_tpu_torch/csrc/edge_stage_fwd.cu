// GATv2 edge-stage forward for Hopper (sm_90a), in three modes.
//
// Replaces segger_tpu/ops/pallas/postgather.py::_fwd_kernel_nokeep (mode 0),
// _fwd_kernel_prng (mode 1, with _prng_keep, _mix32 and _prng_config) and
// _fwd_kernel (mode 2), with _alpha_c and _head_matrices: the TPU kernels
// behind gatv2_edge_stage_pallas.  Per destination row i:
//
//   g_j   = xl[idx[i, j]]                     gathered here, in the kernel
//   p     = g_j + xr[i]                       rounded to the feature type
//   s     = p > 0 ? p : slope * p             rounded to the feature type
//   e_jh  = sum_{c in head h} s_c * att_c     f32 accumulation
//   alpha = masked softmax_j(e_jh)            f32; 0 on masked slots
//   out_i = sum_j alpha_jh * keep_jh * g_j    f32 accumulation, stored in T
//
// alpha (N, K, H) f32 is written out before dropout, as the TPU kernels
// do.  keep is 1 (mode 0), read from an (N, K, H) tensor (mode 2), or
// hashed from the position and two seed words (mode 1):
//
//   pos  = row*K*H + slot*H + head            wrapping 32-bit arithmetic
//   x    = fmix32(fmix32(pos ^ s0) ^ (s1 + 0x9E3779B9))
//   keep = (x & 0x7FFFFFFF) <= thresh ? 1/(1-rate) : 0
//
// which is the TPU kernel's stream bit for bit: its position is global (the
// block offset is added), so the stream does not depend on the blocking,
// and the backward (edge_stage_bwd.cu) regenerates it from the same words.
//
// What bounds it on an H100: bytes.  Each valid slot reads one source row
// (H*C values) at random, a few hundred bytes, against a few flops per
// byte, so the kernel sits far below the tensor-core ridge; the floor is
// the rows it must read and the outputs it must write over 3.35 TB/s.
// The TPU kernel read a gathered (N*K, H*C) tensor that XLA had written
// to HBM first, because Mosaic could not gather rows; this kernel gathers
// through idx itself, so that tensor never exists, and it skips masked
// slots, so padding costs no row read.  In mode 1 no keep tensor exists
// either.
//
// Design: one warp per destination row, each lane holding HC/32
// contiguous channels.  Pass 1 forms each valid slot's per-head logits by
// a warp-shuffle reduction and stores them in the alpha row; the softmax
// then runs over the K slots with lanes striding the slots; pass 2
// gathers the valid rows again (the first read left them in L1/L2) and
// accumulates sum_j alpha * keep * g in registers.  Keeping the rows in
// shared memory or loading them by TMA is left to a later change.

#include "edge_stage_common.cuh"

namespace {

using namespace sgt;

// VPL: channels per lane, a power of two with 32 * VPL >= hc.
template <typename T, int VPL, int MODE>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
edge_stage_fwd_kernel(const T* __restrict__ xl, const T* __restrict__ xr,
                      const T* __restrict__ att,
                      const int32_t* __restrict__ idx,
                      const uint8_t* __restrict__ mask,
                      const T* __restrict__ keep, int n, int n_src, int k,
                      int heads, int hc, float slope, KeepHash hash,
                      T* __restrict__ out, float* __restrict__ alpha) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // uniform across the warp
  const int ch = hc / heads;
  const int c0 = lane * VPL;

  float xr_v[VPL], att_v[VPL];
  int head_v[VPL];
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const int c = c0 + v;
    const bool in = c < hc;
    xr_v[v] = in ? to_f32(xr[(size_t)row * hc + c]) : 0.f;
    att_v[v] = in ? to_f32(att[c]) : 0.f;
    head_v[v] = in ? c / ch : 0;
  }
  const int32_t* idx_row = idx + (size_t)row * k;
  const uint8_t* mask_row = mask + (size_t)row * k;
  float* alpha_row = alpha + (size_t)row * k * heads;

  // pass 1: per-slot, per-head logits into the alpha row
  for (int j = 0; j < k; ++j) {
    if (!mask_row[j]) {
      for (int h = lane; h < heads; h += 32)
        alpha_row[j * heads + h] = kNegInf;
      continue;
    }
    const int src = min(max(idx_row[j], 0), n_src - 1);  // clip, as jnp.take
    const T* g = xl + (size_t)src * hc;
    float prod[VPL];
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const int c = c0 + v;
      float s = 0.f;
      if (c < hc) {
        const float p = round_to<T>(to_f32(g[c]) + xr_v[v]);
        s = p > 0.f ? p : round_to<T>(slope * p);
      }
      prod[v] = s * att_v[v];
    }
    for (int h = 0; h < heads; ++h) {
      float part = 0.f;
#pragma unroll
      for (int v = 0; v < VPL; ++v)
        if (c0 + v < hc && head_v[v] == h) part += prod[v];
      part = warp_sum(part);
      if (lane == 0) alpha_row[j * heads + h] = part;
    }
  }
  __syncwarp();

  // masked softmax over the K slots, per head, exactly as the TPU kernel:
  // z = e - max; ez = valid ? exp(z) : 0; alpha = ez / max(sum ez, 1e-30)
  for (int h = 0; h < heads; ++h) {
    float m = kNegInf;
    for (int j = lane; j < k; j += 32) m = fmaxf(m, alpha_row[j * heads + h]);
    m = warp_max(m);
    float den = 0.f;
    for (int j = lane; j < k; j += 32)
      if (mask_row[j]) den += expf(alpha_row[j * heads + h] - m);
    den = fmaxf(warp_sum(den), 1e-30f);
    __syncwarp();
    for (int j = lane; j < k; j += 32) {
      const float e = alpha_row[j * heads + h];
      alpha_row[j * heads + h] = mask_row[j] ? expf(e - m) / den : 0.f;
    }
  }
  __syncwarp();

  // pass 2: out = sum_j alpha_j * keep_j * g_j over the valid slots
  float acc[VPL];
#pragma unroll
  for (int v = 0; v < VPL; ++v) acc[v] = 0.f;
  for (int j = 0; j < k; ++j) {
    if (!mask_row[j]) continue;
    const int src = min(max(idx_row[j], 0), n_src - 1);
    const T* g = xl + (size_t)src * hc;
    const size_t slot = (size_t)row * k + j;
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const int c = c0 + v;
      if (c < hc) {
        const int h = head_v[v];
        const float w = alpha_row[j * heads + h] *
                        keep_value<T, MODE>(keep, hash, row, j, h, k, heads,
                                            slot);
        acc[v] += w * to_f32(g[c]);
      }
    }
  }
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const int c = c0 + v;
    if (c < hc) out[(size_t)row * hc + c] = from_f32<T>(acc[v]);
  }
}

template <typename T, int MODE>
void launch(const void* xl, const void* xr, const void* att, const void* idx,
            const void* mask, const void* keep, int n, int n_src, int k,
            int heads, int hc, float slope, KeepHash hash, void* out,
            void* alpha, cudaStream_t stream) {
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const int vpl = (hc + 31) / 32;
#define SGT_LAUNCH(V)                                                       \
  edge_stage_fwd_kernel<T, V, MODE><<<grid, block, 0, stream>>>(            \
      (const T*)xl, (const T*)xr, (const T*)att, (const int32_t*)idx,       \
      (const uint8_t*)mask, (const T*)keep, n, n_src, k, heads, hc, slope,  \
      hash, (T*)out, (float*)alpha)
  if (vpl <= 1) SGT_LAUNCH(1);
  else if (vpl <= 2) SGT_LAUNCH(2);
  else if (vpl <= 4) SGT_LAUNCH(4);
  else if (vpl <= 8) SGT_LAUNCH(8);
  else SGT_LAUNCH(16);
#undef SGT_LAUNCH
}

template <typename T>
void launch_mode(int mode, const void* xl, const void* xr, const void* att,
                 const void* idx, const void* mask, const void* keep, int n,
                 int n_src, int k, int heads, int hc, float slope,
                 KeepHash hash, void* out, void* alpha, cudaStream_t stream) {
  if (mode == kModePrng)
    launch<T, kModePrng>(xl, xr, att, idx, mask, keep, n, n_src, k, heads, hc,
                         slope, hash, out, alpha, stream);
  else if (mode == kModeKeep)
    launch<T, kModeKeep>(xl, xr, att, idx, mask, keep, n, n_src, k, heads, hc,
                         slope, hash, out, alpha, stream);
  else
    launch<T, kModeNoKeep>(xl, xr, att, idx, mask, keep, n, n_src, k, heads,
                           hc, slope, hash, out, alpha, stream);
}

}  // namespace

// xl (n_src, hc), xr (n, hc), att (hc,) in the feature type (is_bf16:
// bfloat16, else float32); idx (n, k) int32; mask (n, k) bool (1 byte);
// keep (n, k, heads) feature type, read in mode 2 only; seed0/seed1 the
// two seed words, thresh and inv_keep the dropout threshold and
// multiplier, read in mode 1 only; out (n, hc) feature type; alpha (n, k,
// heads) float32.  mode: 0 no dropout, 1 hashed dropout, 2 keep tensor.
// The caller checks shapes and types and guarantees n > 0, 0 < hc <= 512,
// hc % heads == 0.  Returns cudaGetLastError() after the launch.
extern "C" int sgt_edge_stage_fwd(const void* xl, const void* xr,
                                  const void* att, const void* idx,
                                  const void* mask, const void* keep, int n,
                                  int n_src, int k, int heads, int hc,
                                  float slope, int is_bf16, int mode,
                                  uint32_t seed0, uint32_t seed1,
                                  uint32_t thresh, float inv_keep, void* out,
                                  void* alpha, void* stream) {
  const KeepHash hash{seed0, seed1, thresh, inv_keep};
  if (is_bf16)
    launch_mode<__nv_bfloat16>(mode, xl, xr, att, idx, mask, keep, n, n_src,
                               k, heads, hc, slope, hash, out, alpha,
                               (cudaStream_t)stream);
  else
    launch_mode<float>(mode, xl, xr, att, idx, mask, keep, n, n_src, k, heads,
                       hc, slope, hash, out, alpha, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
