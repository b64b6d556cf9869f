// GATv2 edge-stage backward for Hopper (sm_90a), in three modes.
//
// Replaces segger_tpu/ops/pallas/postgather.py::_bwd_kernel_nokeep (mode
// 0), _bwd_kernel_prng (mode 1) and _bwd_kernel (mode 2), with their
// shared body _bwd_core: the backward of gatv2_edge_stage_pallas from the
// forward's stored pre-dropout alpha (N, K, H) f32.  Per destination row
// i, slot j, head h (G the cotangent of out, T the feature type):
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
// keep is hashed from the two seed words in mode 1 (the forward's hash,
// edge_stage_common.cuh) and read from the keep tensor in mode 2, once per
// (slot, head) either way.  dxl, the transpose-space gather of dg, is
// left to the caller.
//
// What bounds it on an H100: bytes.  Each valid slot reads one source row
// at random, every slot writes one dg row; at N = 50,000, K = 12, HC = 128
// in bf16 the dg rows are about 72 % of the bytes the function must move.
// The TPU kernel read the forward's gathered (N*K, HC) residual; this one
// gathers the source rows through idx, so that residual never exists.
//
// Design (the launch configuration comes from
// ops/postgather.py::bwd_launch_config):
//
// - Row groups.  L lanes per destination row (a power of two <= 32), each
//   lane holding NV chunks of CB contiguous bytes of the row (CB = 16 for
//   rows of 512 bytes or more, else 8); chunk v of lane l covers channels
//   (v*L + l)*VEC.., so neighbouring lanes touch neighbouring bytes.
//   HC = 128 takes L = 32 in bf16 (8-byte chunks) and f32 (16-byte
//   chunks), so a lane's chain of work per slot is 4 channels long.  Rows,
//   G, xr, dg and dxr move as CB-byte vectors when every row starts on CB
//   bytes (vec_io); otherwise element by element, masked at HC, so any
//   HC % H == 0 works.
// - The fast path (vec_io, one chunk a lane, C = HC/H a multiple of VEC
//   and a power-of-two lanes per head LPH, a template parameter, which
//   the main path's C = 64 is) keeps each chunk inside one head: a
//   butterfly of width LPH with fixed offsets sums every head of a row at
//   once, de and alpha*keep are read once per chunk, and in bf16 t, p and
//   slope*p are bf16x2 operations, which round the exact f32 result once,
//   as round_T does.  The general path sums per head over the row and
//   finds each channel's head.
// - Staged gathers.  A row's idx and mask go to shared memory first (one
//   coalesced load).  Then a lane copies its chunks of every valid slot's
//   source row into shared memory with cp.async before it forms the first
//   dA, and only that lane reads them back, so the copies need no barrier:
//   all of a row's gathers are in flight at once, and the dg pass reads
//   the same staged rows, so a referenced row is read from device memory
//   once per launch.  A block of R = 128/L rows stages S slots of each
//   row: R*S*HC_pad*size bytes of dynamic shared memory, beside each row's
//   source index (K int32), alpha, dA/de and alpha*keep (K*H f32 each) and
//   the datt reduction buffer (R*HC_pad f32), all within 232,448 bytes.
//   At the main path's shapes (HC = 128, K <= 24, bf16 and f32) S = K:
//   4 rows x 24 slots x 256 B = 24 KB in bf16.  Where S < K (wide rows and
//   many slots, e.g. HC = 512 in f32 with K > 26) the slots go in chunks
//   of S and the dg pass stages each chunk again: then every referenced
//   row is gathered twice.
// - No scratch in device memory: alpha, dA, de and alpha*keep live in
//   shared memory.
// - Roundings as the plain version: round_T at t, p, s, dg and dxr; every
//   product that the plain version rounds before a sum is an __fmul_rn,
//   never contracted into an FMA (dalpha = dA * keep so that a single
//   valid slot gives de = 0 exactly, alpha * keep * G, dp, de * s).
// - Bit-repeatable: dxr sums a row's slots in slot order; datt is summed
//   per block in a fixed order over its rows and written as one partial
//   per block (the block count depends on N only), which the caller sums
//   in a fixed order.  No atomics.
//
// Control flow is uniform across a warp wherever lanes shuffle: every
// lane walks every slot of its row (rows past N hold no valid slot), and a
// slot that no row of the warp holds is skipped by a warp-uniform branch.

#include "edge_stage_common.cuh"

namespace {

using namespace sgt;

// W: 32-bit words a chunk (CB = 4*W bytes); NV: chunks a lane; LPH: the
// lanes of a head on the fast path (see the note at the top; implies
// NV == 1 and vec_io), 0 on the general path.
//
// At most 64 registers a thread, so that eight blocks (32 warps) share an
// SM: the kernel is issue- and latency-bound, and more warps in flight
// hide the gathers.
template <typename T, int W, int NV, int LPH>
__global__ void __launch_bounds__(kMaxThreads, 8)
edge_stage_bwd_kernel(const T* __restrict__ xl, const T* __restrict__ xr,
                      const T* __restrict__ att,
                      const int32_t* __restrict__ idx,
                      const uint8_t* __restrict__ mask,
                      const float* __restrict__ alpha,
                      const T* __restrict__ keep, const T* __restrict__ go,
                      int n, int n_src, int k, int heads, int hc, int lanes,
                      int rows, int slots, int vec_io, int mode,
                      float slope_t, float slope, KeepHash hash_arg,
                      const uint32_t* __restrict__ seed,
                      T* __restrict__ dg, T* __restrict__ dxr,
                      float* __restrict__ datt_part, T* __restrict__ dkeep) {
  const KeepHash hash = with_seed(hash_arg, seed, mode);
  constexpr int VEC = W * kPerWord<T>;
  constexpr int E = NV * VEC;  // channels a lane holds
  constexpr bool FAST = LPH > 0;
  extern __shared__ __align__(16) unsigned char smem[];
  const bool vec = FAST || vec_io != 0;
  const int grp = threadIdx.x / lanes;  // the block's row this lane serves
  const int lg = threadIdx.x % lanes;   // lane in the row group
  const int hc_pad = lanes * E;
  const int kh = k * heads;
  const int ch = hc / heads;
  T* stage = reinterpret_cast<T*>(smem) + (size_t)grp * slots * hc_pad;
  float* fbuf = reinterpret_cast<float*>(
      smem + (size_t)rows * slots * hc_pad * sizeof(T));
  float* al_s = fbuf + (size_t)grp * kh;               // alpha
  float* de_s = fbuf + (size_t)(rows + grp) * kh;      // dA, then de
  float* ae_s = fbuf + (size_t)(2 * rows + grp) * kh;  // alpha * keep
  float* red = fbuf + (size_t)3 * rows * kh;           // (rows, hc_pad)
  int* src_s = reinterpret_cast<int*>(red + (size_t)rows * hc_pad) +
               (size_t)grp * k;  // source row of each slot, -1 if masked

  // FAST: the lane's head, and whether it writes its head's dA
  const int my_head = lg / (FAST ? LPH : 1);
  const bool head_writer = FAST && lg % (FAST ? LPH : 1) == 0 &&
                           my_head < heads;
  float att_v[E], datt_acc[E];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c0 = (v * lanes + lg) * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      att_v[v * VEC + e] = c0 + e < hc ? to_f32(att[c0 + e]) : 0.f;
      datt_acc[v * VEC + e] = 0.f;
    }
  }
  Chunk<W> slope_w;  // slope_t in every channel of a chunk
  {
    float sv[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) sv[e] = slope_t;
    slope_w = pack<T, W>(sv);
  }

  for (int base = blockIdx.x * rows; base < n; base += gridDim.x * rows) {
    const int row = base + grp;
    const bool live = row < n;  // rows past N hold no valid slot
    const size_t srow = live ? (size_t)row : 0;
    const float* alpha_row = alpha + srow * kh;

    // alpha into shared memory, in flight with the first staged rows
    if (live)
      for (int i = lg; i < kh; i += lanes) cp_async4(al_s + i, alpha_row + i);
    // the row's source index per slot, -1 where masked
    for (int j = lg; j < k; j += lanes)
      src_s[j] = live && mask[srow * k + j]
                     ? min(max(idx[srow * k + j], 0), n_src - 1)
                     : -1;
    Chunk<W> go_w[NV], xr_w[NV];  // G and xr as stored
    float go_f[E];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c0 = (v * lanes + lg) * VEC;
      float fx[VEC];
      if (live && c0 < hc) {
        load_chunk<T, W>(go + srow * hc, c0, hc, vec, go_f + v * VEC);
        load_chunk<T, W>(xr + srow * hc, c0, hc, vec, fx);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) go_f[v * VEC + e] = fx[e] = 0.f;
      }
      go_w[v] = pack<T, W>(go_f + v * VEC);
      xr_w[v] = pack<T, W>(fx);
    }
    __syncwarp();

    // pass 1: stage the source rows, dA per slot and head.  A slot that no
    // row of the warp holds is skipped (the branch is warp-uniform).
    for (int j0 = 0; j0 < k; j0 += slots) {
      const int nc = min(slots, k - j0);
      stage_slots<T, W, NV>(stage, xl, src_s, j0, nc, hc, hc_pad, lanes, lg,
                            vec);
      const T* sj = stage;
      float* dj = de_s + j0 * heads;
#pragma unroll 2
      for (int jj = 0; jj < nc; ++jj, sj += hc_pad, dj += heads) {
        const bool valid = src_s[j0 + jj] >= 0;
        if (!(lanes == 32 ? valid : __any_sync(0xffffffffu, valid))) continue;
        float t[E];
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const int c0 = (v * lanes + lg) * VEC;
          Chunk<W> g = {};
          if (valid && c0 < hc) g = load_vec<W>(sj + c0);
          unpack<T, W>(mul_t<T, W>(go_w[v], g), t + v * VEC);
        }
        if constexpr (FAST) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) part += t[e];
#pragma unroll
          for (int off = LPH / 2; off > 0; off >>= 1)
            part += __shfl_xor_sync(0xffffffffu, part, off);
          if (head_writer) dj[my_head] = part;
        } else {
          for (int h = 0; h < heads; ++h) {
            float part = 0.f;
#pragma unroll
            for (int v = 0; v < NV; ++v) {
              const int c0 = (v * lanes + lg) * VEC;
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                if (c0 + e < hc && (c0 + e) / ch == h) part += t[v * VEC + e];
            }
            part = group_sum(part, lanes);
            if (lg == 0) dj[h] = part;
          }
        }
      }
    }
    __syncwarp();

    // softmax VJP per head: de = alpha * (keep * dA - sum alpha keep dA),
    // the keep multiplier formed once per (slot, head)
    for (int h = 0; h < heads; ++h) {
      float inner = 0.f;
      for (int j = lg; j < k; j += lanes) {
        const int at = j * heads + h;
        if (src_s[j] >= 0) {
          const float kp =
              keep_of<T>(mode, keep, hash, row, j, h, k, heads, srow * k + j);
          const float a = al_s[at];
          const float da = de_s[at];
          if (mode == kModeKeep) dkeep[srow * kh + at] = from_f32<T>(a * da);
          // dalpha = dA * keep rounded on its own (never fused into the
          // next subtraction), as the plain version forms it: a single
          // valid slot then gives de = 0 exactly
          const float dak = __fmul_rn(da, kp);
          de_s[at] = dak;
          ae_s[at] = __fmul_rn(a, kp);
          inner += __fmul_rn(a, dak);
        } else if (live && mode == kModeKeep) {
          dkeep[srow * kh + at] = from_f32<T>(0.f);
        }
      }
      inner = group_sum(inner, lanes);
      for (int j = lg; j < k; j += lanes)
        if (src_s[j] >= 0) {
          const int at = j * heads + h;
          de_s[at] = al_s[at] * (de_s[at] - inner);
        }
    }
    __syncwarp();

    // pass 2: dg per slot from the staged rows (staged again chunk by
    // chunk when S < K), dxr in slot order, datt in registers
    float dxr_acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) dxr_acc[e] = 0.f;
    for (int j0 = 0; j0 < k; j0 += slots) {
      const int nc = min(slots, k - j0);
      if (slots < k)
        stage_slots<T, W, NV>(stage, xl, src_s, j0, nc, hc, hc_pad, lanes,
                              lg, vec);
      if (!live) continue;
      const T* sj = stage;
      const float* dj = de_s + j0 * heads;
      const float* aj = ae_s + j0 * heads;
      T* gj = dg + (srow * k + j0) * hc;
#pragma unroll 2
      for (int jj = 0; jj < nc;
           ++jj, sj += hc_pad, dj += heads, aj += heads, gj += hc) {
        const bool valid = src_s[j0 + jj] >= 0;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const int c0 = (v * lanes + lg) * VEC;
          if (c0 >= hc) continue;
          float out[VEC];
          if (!valid) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) out[e] = 0.f;
          } else {
            const Chunk<W> pw = add_t<T, W>(load_vec<W>(sj + c0), xr_w[v]);
            float p[VEC], sn[VEC];
            unpack<T, W>(pw, p);
            unpack<T, W>(mul_t<T, W>(slope_w, pw), sn);
            float de_u = 0.f, ae_u = 0.f;
            if constexpr (FAST) {
              de_u = dj[my_head];
              ae_u = aj[my_head];
            }
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              const int i = v * VEC + e;
              float de = de_u, ae = ae_u;
              if constexpr (!FAST) {
                if (c0 + e >= hc) {
                  out[e] = 0.f;
                  continue;
                }
                de = dj[(c0 + e) / ch];
                ae = aj[(c0 + e) / ch];
              }
              const bool pos = p[e] > 0.f;
              const float s = pos ? p[e] : sn[e];
              datt_acc[i] += __fmul_rn(de, s);
              const float da = __fmul_rn(de, att_v[i]);
              const float dp = pos ? da : __fmul_rn(da, slope);
              dxr_acc[i] += dp;
              out[e] = __fmul_rn(ae, go_f[i]) + dp;
            }
          }
          store_chunk<T, W>(gj, c0, hc, vec, out);
        }
      }
    }
    if (live)
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int c0 = (v * lanes + lg) * VEC;
        if (c0 < hc)
          store_chunk<T, W>(dxr + srow * hc, c0, hc, vec, dxr_acc + v * VEC);
      }
    __syncwarp();
  }

  // the block's datt partial: its rows summed in a fixed order
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      red[(size_t)grp * hc_pad + (v * lanes + lg) * VEC + e] =
          datt_acc[v * VEC + e];
  __syncthreads();
  for (int c = threadIdx.x; c < hc; c += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += red[(size_t)r * hc_pad + c];
    datt_part[(size_t)blockIdx.x * hc + c] = s;
  }
}

struct Args {
  const void *xl, *xr, *att, *idx, *mask, *alpha, *keep, *go;
  int n, n_src, k, heads, hc, lanes, rows, slots, smem_bytes, n_blocks,
      vec_io, mode;
  float slope_t, slope;
  KeepHash hash;
  const void* seed;
  void *dg, *dxr, *datt_part, *dkeep;
  cudaStream_t stream;
};

template <typename T, int W, int NV, int LPH>
int launch(const Args& a) {
  auto kernel = edge_stage_bwd_kernel<T, W, NV, LPH>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.n_blocks, a.rows * a.lanes, a.smem_bytes, a.stream>>>(
      (const T*)a.xl, (const T*)a.xr, (const T*)a.att, (const int32_t*)a.idx,
      (const uint8_t*)a.mask, (const float*)a.alpha, (const T*)a.keep,
      (const T*)a.go, a.n, a.n_src, a.k, a.heads, a.hc, a.lanes, a.rows,
      a.slots, a.vec_io, a.mode, a.slope_t, a.slope, a.hash,
      (const uint32_t*)a.seed, (T*)a.dg,
      (T*)a.dxr, (float*)a.datt_part, (T*)a.dkeep);
  return (int)cudaGetLastError();
}

template <typename T, int W>
int launch_nv(const Args& a, int nv, int head_lanes) {
  if (head_lanes) {
    if (nv != 1) return (int)cudaErrorInvalidValue;
    switch (head_lanes) {
      case 1: return launch<T, W, 1, 1>(a);
      case 2: return launch<T, W, 1, 2>(a);
      case 4: return launch<T, W, 1, 4>(a);
      case 8: return launch<T, W, 1, 8>(a);
      case 16: return launch<T, W, 1, 16>(a);
      case 32: return launch<T, W, 1, 32>(a);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (nv == 1) return launch<T, W, 1, 0>(a);
  if (nv == 2) return launch<T, W, 2, 0>(a);
  if (nv == 4) return launch<T, W, 4, 0>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// xl (n_src, hc), xr (n, hc), att (hc,), go (n, hc) in the feature type
// (is_bf16: bfloat16, else float32); idx (n, k) int32; mask (n, k) bool;
// alpha (n, k, heads) float32 from the forward; keep (n, k, heads) feature
// type (mode 2 only); the seed words' device address, thresh and inv_keep
// as the forward's (mode 1 only).  slope_t is the slope rounded to the
// feature type (for s), slope the float32 slope (for the leaky
// derivative).  Outputs: dg (n, k,
// hc) and dxr (n, hc) in the feature type, datt_part (n_blocks, hc) float32,
// dkeep (n, k, heads) feature type (mode 2 only).  The launch
// configuration (lanes per row, chunk bytes 8 or 16, chunks per lane nv in
// {1, 2, 4}, rows per block, staged slots, dynamic shared bytes, blocks)
// is ops/postgather.py::bwd_launch_config's; head_lanes, the lanes of a
// head, selects the fast path (0: the general path); vec_io says
// that every row of xl, xr, go, dg and dxr starts on a chunk boundary and
// hc * size is a multiple of the chunk.  The caller checks shapes and
// types and guarantees n > 0, 0 < hc <= 512, hc % heads == 0.  Returns the
// CUDA error of the launch.
extern "C" int sgt_edge_stage_bwd(
    const void* xl, const void* xr, const void* att, const void* idx,
    const void* mask, const void* alpha, const void* keep, const void* go,
    int n, int n_src, int k, int heads, int hc, float slope_t, float slope,
    int is_bf16, int mode, const void* seed, uint32_t thresh,
    float inv_keep, void* dg, void* dxr, void* datt_part, void* dkeep,
    int lanes, int chunk_bytes, int nv, int rows, int slots, int smem_bytes,
    int n_blocks, int vec_io, int head_lanes, void* stream) {
  const Args a{xl, xr, att, idx, mask, alpha, keep, go, n, n_src, k, heads,
               hc, lanes, rows, slots, smem_bytes, n_blocks, vec_io, mode,
               slope_t, slope, KeepHash{0u, 0u, thresh, inv_keep}, seed, dg,
               dxr, datt_part, dkeep, (cudaStream_t)stream};
  const int size = is_bf16 ? 2 : 4;
  if (rows * lanes > kMaxThreads || (chunk_bytes != 8 && chunk_bytes != 16) ||
      chunk_bytes / size * lanes * nv < hc || (head_lanes && !vec_io))
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return chunk_bytes == 16 ? launch_nv<__nv_bfloat16, 4>(a, nv, head_lanes)
                             : launch_nv<__nv_bfloat16, 2>(a, nv, head_lanes);
  return chunk_bytes == 16 ? launch_nv<float, 4>(a, nv, head_lanes)
                           : launch_nv<float, 2>(a, nv, head_lanes);
}
