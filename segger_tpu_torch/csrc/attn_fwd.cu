// Fused GATv2 edge attention + aggregation, forward only, for Hopper
// (sm_90a): one device routine, two entry points.
//
// sgt_gatv2_attention replaces segger_tpu/ops/pallas/gatv2_attn.py::_kernel
// (gatv2_attention); sgt_banded_edge_stage replaces
// segger_tpu/ops/pallas/banded.py::_kernel (banded_edge_stage), the same
// function over a banded table whose source of slot j of row i is
// lo[i / 256] + idx[i, j].  Per destination row i:
//
//   g_j   = xl[src(i, j)]                     gathered here, in the kernel
//   p     = g_j + xr[i]                       rounded to the feature type
//   s     = p > 0 ? p : slope * p             rounded to the feature type
//   e_jh  = sum_{c in head h} s_c * att_c     each product and the sum
//                                             rounded to the feature type
//   z     = e_jh - max_j e_jh;  ez = exp(z)   each rounded to the type
//   alpha = ez / max(sum_j ez, 1e-30)         sum and quotient rounded
//   out_i = sum_j alpha_jh * g_j + bias       f32 accumulation, stored in T
//
// These are the TPU kernels' roundings: they compute in the feature type
// throughout, unlike the edge stage of edge_stage_fwd.cu, which keeps f32
// softmax statistics.  In float32 every rounding is the identity.  The
// per-head sum runs in a fixed order (each lane's channels, then a warp
// butterfly), which the plain version (ops/gatv2_attn.py::head_logits)
// repeats, so both round to the same bf16 logit.  Rows with no valid slot
// give bias.
//
// What bounds it on an H100: bytes.  Each valid slot reads one source row
// at random (a few hundred bytes) against a few flops per byte, far below
// the ridge; the floor is the rows it must read plus idx, mask, xr and
// out over 3.35 TB/s.  The TPU kernels kept the source table (gatv2_attn)
// or a 4,096-row window of it (banded) in VMEM: 12.8 MB or 2 MiB at the
// real widths, both above the 227 KB of shared memory a block can have.
// So this kernel reads the rows through L2 (50 MB), which holds a 50k-row
// table or a band of strips whole, and skips masked slots.  It needs no
// N_src >= WINDOW padding, since it reads no window.
//
// Design, as edge_stage_fwd.cu: one warp per destination row, each lane
// holding VPL contiguous channels.  Pass 1 writes each valid slot's
// per-head logits to a per-row scratch (N, K, H) f32; the softmax runs
// over the K slots with lanes striding the slots and overwrites them with
// alpha; pass 2 gathers the valid rows again (L1/L2 hits) and accumulates
// sum_j alpha * g in registers.  Staging the band in shared memory by TMA
// is left to a later change.

#include "edge_stage_common.cuh"

namespace {

using namespace sgt;

constexpr int kBandBlock = 256;  // banded.py BLOCK
constexpr int kBandK = 16;       // banded.py K_BAND

// VPL: channels per lane, a power of two with 32 * VPL >= hc.  lo: nullptr
// for a global idx, else the window start of each kBandBlock-row block.
template <typename T, int VPL>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
attn_fwd_kernel(const T* __restrict__ xl, const T* __restrict__ xr,
                const T* __restrict__ att, const float* __restrict__ bias,
                const int32_t* __restrict__ lo,
                const int32_t* __restrict__ idx,
                const uint8_t* __restrict__ mask, int n, int n_src, int k,
                int heads, int hc, float slope, float* __restrict__ scratch,
                T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // uniform across the warp
  const int ch = hc / heads;
  const int c0 = lane * VPL;
  const int base = lo ? lo[row / kBandBlock] : 0;

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
  float* e_row = scratch + (size_t)row * k * heads;

  // pass 1: per-slot, per-head logits of the valid slots
  for (int j = 0; j < k; ++j) {
    if (!mask_row[j]) continue;
    const int src = min(max(base + idx_row[j], 0), n_src - 1);  // clip
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
      prod[v] = round_to<T>(s * att_v[v]);
    }
    for (int h = 0; h < heads; ++h) {
      float part = 0.f;
#pragma unroll
      for (int v = 0; v < VPL; ++v)
        if (c0 + v < hc && head_v[v] == h) part += prod[v];
      part = warp_sum(part);
      if (lane == 0) e_row[j * heads + h] = round_to<T>(part);
    }
  }
  __syncwarp();

  // masked softmax over the valid slots, per head; each lane rewrites
  // only the entries it read
  for (int h = 0; h < heads; ++h) {
    float m = kNegInf;
    for (int j = lane; j < k; j += 32)
      if (mask_row[j]) m = fmaxf(m, e_row[j * heads + h]);
    m = warp_max(m);
    float den = 0.f;
    for (int j = lane; j < k; j += 32)
      if (mask_row[j])
        den += round_to<T>(expf(round_to<T>(e_row[j * heads + h] - m)));
    den = fmaxf(round_to<T>(warp_sum(den)), 1e-30f);
    for (int j = lane; j < k; j += 32) {
      if (!mask_row[j]) continue;
      const float ez =
          round_to<T>(expf(round_to<T>(e_row[j * heads + h] - m)));
      e_row[j * heads + h] = round_to<T>(ez / den);
    }
  }
  __syncwarp();

  // pass 2: out = sum_j alpha_j * g_j + bias over the valid slots
  float acc[VPL];
#pragma unroll
  for (int v = 0; v < VPL; ++v) acc[v] = 0.f;
  for (int j = 0; j < k; ++j) {
    if (!mask_row[j]) continue;
    const int src = min(max(base + idx_row[j], 0), n_src - 1);
    const T* g = xl + (size_t)src * hc;
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const int c = c0 + v;
      if (c < hc) acc[v] += e_row[j * heads + head_v[v]] * to_f32(g[c]);
    }
  }
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const int c = c0 + v;
    if (c < hc) out[(size_t)row * hc + c] = from_f32<T>(acc[v] + bias[c]);
  }
}

template <typename T>
int launch(const void* xl, const void* xr, const void* att, const void* bias,
           const void* lo, const void* idx, const void* mask, int n,
           int n_src, int k, int heads, int hc, float slope, void* scratch,
           void* out, cudaStream_t stream) {
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const int vpl = (hc + 31) / 32;
#define SGT_LAUNCH(V)                                                        \
  attn_fwd_kernel<T, V><<<grid, block, 0, stream>>>(                         \
      (const T*)xl, (const T*)xr, (const T*)att, (const float*)bias,         \
      (const int32_t*)lo, (const int32_t*)idx, (const uint8_t*)mask, n,      \
      n_src, k, heads, hc, slope, (float*)scratch, (T*)out)
  if (vpl <= 1) SGT_LAUNCH(1);
  else if (vpl <= 2) SGT_LAUNCH(2);
  else if (vpl <= 4) SGT_LAUNCH(4);
  else if (vpl <= 8) SGT_LAUNCH(8);
  else SGT_LAUNCH(16);
#undef SGT_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// xl (n_src, hc), xr (n, hc), att (hc,) in the feature type (is_bf16:
// bfloat16, else float32); bias (hc,) float32; idx (n, k) int32; mask
// (n, k) bool (1 byte); scratch (n, k, heads) float32; out (n, hc) feature
// type.  The caller checks shapes and types and guarantees n > 0,
// 0 < hc <= 512, hc % heads == 0.  Returns cudaGetLastError() after the
// launch.
extern "C" int sgt_gatv2_attention(const void* xl, const void* xr,
                                   const void* att, const void* bias,
                                   const void* idx, const void* mask, int n,
                                   int n_src, int k, int heads, int hc,
                                   float slope, int is_bf16, void* scratch,
                                   void* out, void* stream) {
  if (is_bf16)
    return launch<__nv_bfloat16>(xl, xr, att, bias, nullptr, idx, mask, n,
                                 n_src, k, heads, hc, slope, scratch, out,
                                 (cudaStream_t)stream);
  return launch<float>(xl, xr, att, bias, nullptr, idx, mask, n, n_src, k,
                       heads, hc, slope, scratch, out, (cudaStream_t)stream);
}

// The banded table: xl (n_src, hc), xr (n_pad, hc), att (hc,), bias (hc,)
// float32; lo (n_pad / 256,) int32; idx_local and mask (n_pad, 16);
// scratch (n_pad, 16, heads) float32; out (n_pad, hc) float32.  The caller
// guarantees n_pad % 256 == 0 and n_pad > 0.
extern "C" int sgt_banded_edge_stage(const void* xl, const void* xr,
                                     const void* att, const void* bias,
                                     const void* lo, const void* idx_local,
                                     const void* mask, int n_pad, int n_src,
                                     int heads, int hc, float slope,
                                     void* scratch, void* out,
                                     void* stream) {
  return launch<float>(xl, xr, att, bias, lo, idx_local, mask, n_pad, n_src,
                       kBandK, heads, hc, slope, scratch, out,
                       (cudaStream_t)stream);
}
