// GATv2 edge-stage backward for Hopper (sm_90a), in three modes.
//
// Replaces segger_tpu/ops/pallas/postgather.py::_bwd_kernel_nokeep (mode
// 0), _bwd_kernel_prng (mode 1) and _bwd_kernel (mode 2), with _bwd_core:
// the backward of gatv2_edge_stage_pallas from the forward's stored
// pre-dropout alpha (N, K, H) f32.  Per destination row i, slot j, head h
// (G the cotangent of out, T the feature type):
//
//   t      = round_T(G * g_j)                     g_j = xl[idx[i, j]]
//   dA_jh  = sum_{c in h} t_c                     f32
//   inner  = sum_j alpha_jh * keep_jh * dA_jh     f32
//   de_jh  = alpha_jh * (keep_jh * dA_jh - inner) f32
//   p, s   = round_T(g + xr), leaky(p) in T       as the forward
//   dp     = de * att * (p > 0 ? 1 : slope)       f32
//   dg_j   = round_T(alpha * keep * G + dp)       0 on masked slots
//   dxr    = round_T(sum_j dp)
//   datt   = sum_rows sum_j de * s                per-block f32 partials
//   dkeep  = round_T(alpha * dA)                  mode 2 only
//
// keep is regenerated from the two seed words in mode 1 (the same hash as
// the forward, edge_stage_common.cuh) and read from the keep tensor in
// mode 2.  dxl, the transpose-space gather of dg, is left to the caller.
//
// What bounds it on an H100: bytes, as the forward: each valid slot reads
// one source row at random and writes one dg row.  The TPU kernel read the
// forward's padded gathered (N*K, H*C) residual; this kernel gathers the
// source rows through idx again, so that residual never exists, and reads
// only valid slots.
//
// Design: one warp per destination row, a grid-stride loop over rows, each
// lane holding HC/32 contiguous channels.  Pass 1 gathers the valid rows
// and writes dA to an (N, K, H) f32 scratch; the softmax VJP then runs
// over the K slots with lanes striding the slots and overwrites dA with
// de; pass 2 gathers the rows again and writes dg, and accumulates dxr and
// the lane's datt share in registers.  No row is staged in shared memory,
// so any K works.  The datt partials of a block's warps are summed in
// shared memory in a fixed order and written per block; the caller sums
// the blocks in a fixed order, so runs repeat bit for bit (no atomics).

#include "edge_stage_common.cuh"

namespace {

using namespace sgt;

constexpr int kMaxHC = 512;

template <typename T, int VPL, int MODE>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
edge_stage_bwd_kernel(const T* __restrict__ xl, const T* __restrict__ xr,
                      const T* __restrict__ att,
                      const int32_t* __restrict__ idx,
                      const uint8_t* __restrict__ mask,
                      const float* __restrict__ alpha,
                      const T* __restrict__ keep, const T* __restrict__ go,
                      int n, int n_src, int k, int heads, int hc,
                      float slope_t, float slope, KeepHash hash,
                      T* __restrict__ dg, T* __restrict__ dxr,
                      float* __restrict__ datt_part, T* __restrict__ dkeep,
                      float* __restrict__ de_buf) {
  __shared__ float red[kWarpsPerBlock][kMaxHC];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ch = hc / heads;
  const int c0 = lane * VPL;

  float att_v[VPL], datt_acc[VPL];
  int head_v[VPL];
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const int c = c0 + v;
    att_v[v] = c < hc ? to_f32(att[c]) : 0.f;
    head_v[v] = c < hc ? c / ch : 0;
    datt_acc[v] = 0.f;
  }

  for (int row = blockIdx.x * kWarpsPerBlock + warp; row < n;
       row += gridDim.x * kWarpsPerBlock) {  // uniform across the warp
    float go_v[VPL], xr_v[VPL];
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const int c = c0 + v;
      go_v[v] = c < hc ? to_f32(go[(size_t)row * hc + c]) : 0.f;
      xr_v[v] = c < hc ? to_f32(xr[(size_t)row * hc + c]) : 0.f;
    }
    const int32_t* idx_row = idx + (size_t)row * k;
    const uint8_t* mask_row = mask + (size_t)row * k;
    const float* alpha_row = alpha + (size_t)row * k * heads;
    float* de_row = de_buf + (size_t)row * k * heads;

    // pass 1: dA per valid slot and head into the scratch row
    for (int j = 0; j < k; ++j) {
      if (!mask_row[j]) continue;
      const int src = min(max(idx_row[j], 0), n_src - 1);
      const T* g = xl + (size_t)src * hc;
      float t[VPL];
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        const int c = c0 + v;
        t[v] = c < hc ? round_to<T>(go_v[v] * to_f32(g[c])) : 0.f;
      }
      for (int h = 0; h < heads; ++h) {
        float part = 0.f;
#pragma unroll
        for (int v = 0; v < VPL; ++v)
          if (c0 + v < hc && head_v[v] == h) part += t[v];
        part = warp_sum(part);
        if (lane == 0) de_row[j * heads + h] = part;
      }
    }
    __syncwarp();

    // softmax VJP per head: de = alpha * (keep * dA - sum alpha keep dA)
    for (int h = 0; h < heads; ++h) {
      float inner = 0.f;
      for (int j = lane; j < k; j += 32) {
        if (!mask_row[j]) continue;
        const float kp = keep_value<T, MODE>(keep, hash, row, j, h, k, heads,
                                             (size_t)row * k + j);
        // dalpha = dA * keep rounded on its own (never fused into the
        // next subtraction), as the plain version forms it: a single
        // valid slot then gives de = 0 exactly
        const float dak = __fmul_rn(de_row[j * heads + h], kp);
        inner += alpha_row[j * heads + h] * dak;
      }
      inner = warp_sum(inner);
      for (int j = lane; j < k; j += 32) {
        const size_t at = ((size_t)row * k + j) * heads + h;
        if (!mask_row[j]) {
          if (MODE == kModeKeep) dkeep[at] = from_f32<T>(0.f);
          continue;
        }
        const float a = alpha_row[j * heads + h];
        const float da = de_row[j * heads + h];
        const float kp = keep_value<T, MODE>(keep, hash, row, j, h, k, heads,
                                             (size_t)row * k + j);
        if (MODE == kModeKeep) dkeep[at] = from_f32<T>(a * da);
        de_row[j * heads + h] = a * (__fmul_rn(da, kp) - inner);
      }
    }
    __syncwarp();

    // pass 2: dg per slot, dxr and datt accumulated in registers
    float dxr_acc[VPL];
#pragma unroll
    for (int v = 0; v < VPL; ++v) dxr_acc[v] = 0.f;
    for (int j = 0; j < k; ++j) {
      T* dg_row = dg + ((size_t)row * k + j) * hc;
      if (!mask_row[j]) {
#pragma unroll
        for (int v = 0; v < VPL; ++v)
          if (c0 + v < hc) dg_row[c0 + v] = from_f32<T>(0.f);
        continue;
      }
      const int src = min(max(idx_row[j], 0), n_src - 1);
      const T* g = xl + (size_t)src * hc;
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        const int c = c0 + v;
        if (c >= hc) continue;
        const int h = head_v[v];
        const float p = round_to<T>(to_f32(g[c]) + xr_v[v]);
        const bool pos = p > 0.f;
        const float s = pos ? p : round_to<T>(slope_t * p);
        const float de = de_row[j * heads + h];
        datt_acc[v] += de * s;
        const float dp = de * att_v[v] * (pos ? 1.f : slope);
        dxr_acc[v] += dp;
        const float a_eff =
            alpha_row[j * heads + h] *
            keep_value<T, MODE>(keep, hash, row, j, h, k, heads,
                                (size_t)row * k + j);
        dg_row[c] = from_f32<T>(a_eff * go_v[v] + dp);
      }
    }
#pragma unroll
    for (int v = 0; v < VPL; ++v)
      if (c0 + v < hc)
        dxr[(size_t)row * hc + c0 + v] = from_f32<T>(dxr_acc[v]);
    __syncwarp();
  }

  // the block's datt partial: warps summed in a fixed order
#pragma unroll
  for (int v = 0; v < VPL; ++v)
    if (c0 + v < hc) red[warp][c0 + v] = datt_acc[v];
  __syncthreads();
  for (int c = threadIdx.x; c < hc; c += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < kWarpsPerBlock; ++w) s += red[w][c];
    datt_part[(size_t)blockIdx.x * hc + c] = s;
  }
}

template <typename T, int MODE>
void launch(const void* xl, const void* xr, const void* att, const void* idx,
            const void* mask, const void* alpha, const void* keep,
            const void* go, int n, int n_src, int k, int heads, int hc,
            float slope_t, float slope, KeepHash hash, void* dg, void* dxr,
            void* datt_part, void* dkeep, void* de_buf, int n_blocks,
            cudaStream_t stream) {
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid(n_blocks);
  const int vpl = (hc + 31) / 32;
#define SGT_LAUNCH(V)                                                        \
  edge_stage_bwd_kernel<T, V, MODE><<<grid, block, 0, stream>>>(             \
      (const T*)xl, (const T*)xr, (const T*)att, (const int32_t*)idx,        \
      (const uint8_t*)mask, (const float*)alpha, (const T*)keep,             \
      (const T*)go, n, n_src, k, heads, hc, slope_t, slope, hash, (T*)dg,    \
      (T*)dxr, (float*)datt_part, (T*)dkeep, (float*)de_buf)
  if (vpl <= 1) SGT_LAUNCH(1);
  else if (vpl <= 2) SGT_LAUNCH(2);
  else if (vpl <= 4) SGT_LAUNCH(4);
  else if (vpl <= 8) SGT_LAUNCH(8);
  else SGT_LAUNCH(16);
#undef SGT_LAUNCH
}

template <typename T>
void launch_mode(int mode, const void* xl, const void* xr, const void* att,
                 const void* idx, const void* mask, const void* alpha,
                 const void* keep, const void* go, int n, int n_src, int k,
                 int heads, int hc, float slope_t, float slope, KeepHash hash,
                 void* dg, void* dxr, void* datt_part, void* dkeep,
                 void* de_buf, int n_blocks, cudaStream_t stream) {
  if (mode == kModePrng)
    launch<T, kModePrng>(xl, xr, att, idx, mask, alpha, keep, go, n, n_src, k,
                         heads, hc, slope_t, slope, hash, dg, dxr, datt_part,
                         dkeep, de_buf, n_blocks, stream);
  else if (mode == kModeKeep)
    launch<T, kModeKeep>(xl, xr, att, idx, mask, alpha, keep, go, n, n_src, k,
                         heads, hc, slope_t, slope, hash, dg, dxr, datt_part,
                         dkeep, de_buf, n_blocks, stream);
  else
    launch<T, kModeNoKeep>(xl, xr, att, idx, mask, alpha, keep, go, n, n_src,
                           k, heads, hc, slope_t, slope, hash, dg, dxr,
                           datt_part, dkeep, de_buf, n_blocks, stream);
}

}  // namespace

// xl (n_src, hc), xr (n, hc), att (hc,), go (n, hc) in the feature type
// (is_bf16: bfloat16, else float32); idx (n, k) int32; mask (n, k) bool;
// alpha (n, k, heads) float32 from the forward; keep (n, k, heads) feature
// type (mode 2 only); seed words, thresh and inv_keep as the forward's
// (mode 1 only).  slope_t is the slope rounded to the feature type (for s),
// slope the float32 slope (for the leaky derivative).  Outputs: dg (n, k,
// hc) and dxr (n, hc) in the feature type, datt_part (n_blocks, hc) float32,
// dkeep (n, k, heads) feature type (mode 2 only); de_buf (n, k, heads)
// float32 scratch.  The caller checks shapes and types and guarantees
// n > 0, 0 < hc <= 512, hc % heads == 0, n_blocks >= 1.  Returns
// cudaGetLastError() after the launch.
extern "C" int sgt_edge_stage_bwd(
    const void* xl, const void* xr, const void* att, const void* idx,
    const void* mask, const void* alpha, const void* keep, const void* go,
    int n, int n_src, int k, int heads, int hc, float slope_t, float slope,
    int is_bf16, int mode, uint32_t seed0, uint32_t seed1, uint32_t thresh,
    float inv_keep, void* dg, void* dxr, void* datt_part, void* dkeep,
    void* de_buf, int n_blocks, void* stream) {
  const KeepHash hash{seed0, seed1, thresh, inv_keep};
  if (is_bf16)
    launch_mode<__nv_bfloat16>(mode, xl, xr, att, idx, mask, alpha, keep, go,
                               n, n_src, k, heads, hc, slope_t, slope, hash,
                               dg, dxr, datt_part, dkeep, de_buf, n_blocks,
                               (cudaStream_t)stream);
  else
    launch_mode<float>(mode, xl, xr, att, idx, mask, alpha, keep, go, n,
                       n_src, k, heads, hc, slope_t, slope, hash, dg, dxr,
                       datt_part, dkeep, de_buf, n_blocks,
                       (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
