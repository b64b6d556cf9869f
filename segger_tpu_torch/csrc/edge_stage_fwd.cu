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
// the rows it must read, xr, idx and mask, and out and alpha written once,
// over 3.35 TB/s.  The TPU kernel read a gathered (N*K, H*C) tensor that
// XLA had written to HBM first, because Mosaic could not gather rows; this
// kernel gathers through idx itself, so that tensor never exists, and it
// skips masked slots, so padding costs no row read.  In mode 1 no keep
// tensor exists either.  At the main path's sizes the floor is a few
// microseconds, so what sets the time is each row's chain of dependent
// steps (idx, gathers, logits, softmax, sum) and the instructions a lane
// spends a slot.  The design keeps that chain short:
//
// - Row groups, as in edge_stage_bwd.cu (the launch configuration comes
//   from ops/postgather.py::fwd_launch_config): L lanes per destination
//   row, each holding NV chunks of CB bytes, in blocks of 128 threads.
//   At HC = 128 in bf16 a table of 2,048 rows or more whose 8-row blocks
//   stage every slot eight blocks an SM (K <= 12) takes 16-byte chunks,
//   16 lanes and two rows a warp, which halves the instructions a row's
//   slot costs; smaller tables and larger K keep 8-byte chunks, 32 lanes
//   and 4-row blocks, whose lane chain (4 channels a slot) is shorter.
//   Other shapes take 16-byte chunks for rows of 512 bytes or more, else
//   8.  Rows move as CB-byte vectors when every row starts on CB bytes
//   (vec_io); otherwise element by element, masked at HC.
// - Staged gathers of the valid slots.  The row's idx and mask are read
//   in one coalesced load, and a ballot over the row's lanes compacts its
//   valid slots: their source rows in order, and each slot's place among
//   them.  Then each lane copies its chunks of every valid slot's source
//   row into shared memory with cp.async before it forms the first logit,
//   and only that lane reads them back, so no barrier is needed: all of a
//   row's gathers are in flight at once, and the passes walk the valid
//   slots only.  The logit pass and the output pass both read the staged
//   chunks, so a referenced row is read from device memory once per
//   launch where the block stages every slot (S = K), which holds at the
//   main path's shapes (24 KB a block in bf16 at K = 24 or 12).  Where
//   S < K the slots go in chunks of S and the output pass stages each
//   chunk again.
// - Logits and alpha in shared memory (K*H f32 a row in compact order,
//   beside K*H f32 of alpha*keep and the K int32 source rows and compact
//   places).  On the fast path (one chunk a lane inside one head, a
//   power-of-two lanes a head LPH, a template parameter: 16 or 8 at C =
//   64 in bf16) a butterfly of width LPH gives every head's logit at
//   once; the general path sums per head over the row.  The row's lanes
//   then run the softmax there, per head, with the TPU kernel's formula:
//   z = e - max, ez = exp(z), alpha = ez / max(sum ez, 1e-30), where its
//   masked slots add exactly 0.  alpha goes to device memory once, as the
//   row's contiguous K*H f32 (0 on masked slots), coalesced.
// - The keep multiplier once per (slot, head), hashed (mode 1) or read
//   (mode 2) in the softmax step and stored as alpha*keep, rounded on its
//   own (__fmul_rn) as the plain version rounds alpha * keep before the sum.
// - Roundings as the plain version: p and slope*p are bf16x2 operations in
//   bf16 (each rounds the exact f32 result once, as round_T does), and s,
//   which is p or slope*p, is their maximum (slope <= 1) or minimum
//   (slope > 1), one instruction for two channels.  That equals p > 0 ? p
//   : slope*p for every p, up to the sign of a zero s when the slope is
//   negative, and but for p = -inf with slope 0 (the plain version gives
//   NaN).  Logits and out are summed in f32; out is stored in T.
// - Rows with no valid slot give alpha = 0 and out = 0.
//
// Control flow is uniform across a warp wherever lanes shuffle: every lane
// of a warp walks as many compacted slots as the warp's fullest row holds
// (rows past N hold none), and a lane past its own row's count forms a
// logit that it does not store.

#include "edge_stage_common.cuh"

namespace {

using namespace sgt;

// The softmax of one row's logits, held in compact order in lg_c (the
// c-th valid slot's H logits at c*H): z = e - max, ez = exp(z), alpha =
// ez / max(sum ez, 1e-30), as the TPU kernel, whose masked slots (z near
// -1e30) add exactly 0.  alpha goes to device memory as the row's whole
// K*H f32, 0 on masked slots; alpha * keep goes to ae_c in compact order.
// ALL: every head at once, for a power-of-two H <= L, where the entries a
// lane walks (stride L) share one head and a butterfly over the lanes that
// keep it reduces each head; else head h alone, reduced over all L lanes.
template <typename T, bool ALL>
__device__ __forceinline__ void softmax_row(
    float* lg_c, float* ae_c, const int* cpos, int h, int n_valid, int k,
    int heads, int lanes, int lg, int hshift, int mode, const T* keep,
    const KeepHash& hash, int row, size_t srow, bool live,
    float* __restrict__ alpha) {
  const int count = ALL ? n_valid * heads : n_valid;
  const int stop = ALL ? heads : 1;
  float m = kNegInf;
  for (int t = lg; t < count; t += lanes)
    m = fmaxf(m, lg_c[ALL ? t : t * heads + h]);
  for (int off = lanes >> 1; off >= stop; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off, lanes));
  float den = 0.f;
  for (int t = lg; t < count; t += lanes) {
    const int at = ALL ? t : t * heads + h;
    const float ez = expf(lg_c[at] - m);
    lg_c[at] = ez;
    den += ez;
  }
  for (int off = lanes >> 1; off >= stop; off >>= 1)
    den += __shfl_xor_sync(0xffffffffu, den, off, lanes);
  den = fmaxf(den, 1e-30f);
  __syncwarp();
  const int kh = k * heads;
  for (int t = lg; t < (ALL ? kh : k); t += lanes) {
    const int j = ALL ? t >> hshift : t;
    const int hh = ALL ? t & (heads - 1) : h;
    const int c = cpos[j];
    float a = 0.f;
    if (c >= 0) {
      a = lg_c[c * heads + hh] / den;
      ae_c[c * heads + hh] = __fmul_rn(
          a, keep_of<T>(mode, keep, hash, row, j, hh, k, heads, srow * k + j));
    }
    if (live) alpha[srow * kh + j * heads + hh] = a;
  }
}

// W: 32-bit words a chunk (CB = 4*W bytes); NV: chunks a lane; LPH: the
// lanes of a head on the fast path (implies NV == 1 and vec_io), 0 on the
// general path.  At most 64 registers a thread, so that eight blocks (32
// warps) share an SM and hide each other's gathers.
template <typename T, int W, int NV, int LPH>
__global__ void __launch_bounds__(kMaxThreads, 8)
edge_stage_fwd_kernel(const T* __restrict__ xl, const T* __restrict__ xr,
                      const T* __restrict__ att,
                      const int32_t* __restrict__ idx,
                      const uint8_t* __restrict__ mask,
                      const T* __restrict__ keep, int n, int n_src, int k,
                      int heads, int hc, int lanes, int rows, int slots,
                      int vec_io, int mode, float slope_t,
                      KeepHash hash_arg, const uint32_t* __restrict__ seed,
                      T* __restrict__ out, float* __restrict__ alpha) {
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
  // per row, in compact order (the c-th valid slot): logits then ez, and
  // alpha * keep (K*H f32 each); source rows (K int32); and each slot's
  // compact index (K int32)
  float* lg_c = fbuf + (size_t)grp * kh;
  float* ae_c = fbuf + (size_t)(rows + grp) * kh;
  int* src_c = reinterpret_cast<int*>(fbuf + (size_t)2 * rows * kh) +
               (size_t)grp * k;
  int* cpos = src_c + (size_t)rows * k;
  const int lane0 = (threadIdx.x & 31) & ~(lanes - 1);  // in its warp

  // FAST: the lane's head, and whether it writes its head's logit
  const int my_head = lg / (FAST ? LPH : 1);
  const bool head_writer = FAST && lg % (FAST ? LPH : 1) == 0 &&
                           my_head < heads;
  const bool use_max = slope_t <= 1.f;
  const bool heads_pow2 = (heads & (heads - 1)) == 0 && heads <= lanes;
  const int hshift = __ffs(heads) - 1;  // log2(heads) when heads_pow2
  float att_v[E];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c0 = (v * lanes + lg) * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      att_v[v * VEC + e] = c0 + e < hc ? to_f32(att[c0 + e]) : 0.f;
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

    // xr as stored, left in flight (on the vector path) while the row's
    // idx and mask arrive
    Chunk<W> xr_w[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int c0 = (v * lanes + lg) * VEC;
      xr_w[v] = Chunk<W>{};
      if (live && c0 < hc) {
        if (vec) {
          xr_w[v] = load_vec<W>(xr + srow * hc + c0);
        } else {
          float fx[VEC];
          load_chunk<T, W>(xr + srow * hc, c0, hc, false, fx);
          xr_w[v] = pack<T, W>(fx);
        }
      }
    }
    // the row's valid slots, compacted: src_c[c] the source row of the
    // c-th valid slot, cpos[j] the compact index of slot j (-1 if masked).
    // idx and mask are loaded together; a ballot over the row's lanes
    // places each valid slot
    int n_valid = 0;
    for (int j0 = 0; j0 < k; j0 += lanes) {
      const int j = j0 + lg;
      int src = -1;
      if (live && j < k) {
        const int i = idx[srow * k + j];
        src = mask[srow * k + j] ? min(max(i, 0), n_src - 1) : -1;
      }
      const unsigned b = __ballot_sync(0xffffffffu, src >= 0);
      const unsigned seg =
          lanes == 32 ? b : (b >> lane0) & ((1u << lanes) - 1u);
      const int c = n_valid + __popc(seg & ((1u << lg) - 1u));
      if (j < k) cpos[j] = src >= 0 ? c : -1;
      if (src >= 0) src_c[c] = src;
      n_valid += __popc(seg);
    }
    // the slots every row of the warp walks (the most any of them holds)
    const int n_walk =
        lanes == 32 ? n_valid : __reduce_max_sync(0xffffffffu, n_valid);
    __syncwarp();

    // pass 1: stage the valid slots' source rows, logits per slot and head
    for (int q0 = 0; q0 < n_walk; q0 += slots) {
      const int nc = min(slots, n_walk - q0);
      stage_slots<T, W, NV>(stage, xl, src_c, q0,
                            max(min(nc, n_valid - q0), 0), hc, hc_pad, lanes,
                            lg, vec);
      const T* sj = stage;
      float* ej = lg_c + q0 * heads;
#pragma unroll 2
      for (int qq = 0; qq < nc; ++qq, sj += hc_pad, ej += heads) {
        const bool valid = lanes == 32 || q0 + qq < n_valid;
        float s[E];
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const int c0 = (v * lanes + lg) * VEC;
          Chunk<W> g = {};
          if (valid && c0 < hc) g = load_vec<W>(sj + c0);
          const Chunk<W> pw = add_t<T, W>(g, xr_w[v]);
          unpack<T, W>(leaky_t<T, W>(pw, mul_t<T, W>(slope_w, pw), use_max),
                       s + v * VEC);
        }
        if constexpr (FAST) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) part += s[e] * att_v[e];
#pragma unroll
          for (int off = LPH / 2; off > 0; off >>= 1)
            part += __shfl_xor_sync(0xffffffffu, part, off);
          if (head_writer && valid) ej[my_head] = part;
        } else {
          for (int h = 0; h < heads; ++h) {
            float part = 0.f;
#pragma unroll
            for (int v = 0; v < NV; ++v) {
              const int c0 = (v * lanes + lg) * VEC;
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                if (c0 + e < hc && (c0 + e) / ch == h)
                  part += s[v * VEC + e] * att_v[v * VEC + e];
            }
            part = group_sum(part, lanes);
            if (lg == 0 && valid) ej[h] = part;
          }
        }
      }
    }
    __syncwarp();

    // softmax over the valid slots, alpha (0 on masked slots) written out
    // whole, and alpha * keep with the keep multiplier formed once per
    // (slot, head)
    if (heads_pow2) {
      softmax_row<T, true>(lg_c, ae_c, cpos, 0, n_valid, k, heads, lanes, lg,
                           hshift, mode, keep, hash, row, srow, live, alpha);
    } else {
      for (int h = 0; h < heads; ++h)
        softmax_row<T, false>(lg_c, ae_c, cpos, h, n_valid, k, heads, lanes,
                              lg, hshift, mode, keep, hash, row, srow, live,
                              alpha);
    }
    __syncwarp();

    // pass 2: out = sum_c alpha * keep * g_c over the valid slots, from the
    // staged rows (staged again chunk by chunk when S < the slots walked)
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
    for (int q0 = 0; q0 < n_walk; q0 += slots) {
      const int nc = min(slots, n_walk - q0);
      if (n_walk > slots)
        stage_slots<T, W, NV>(stage, xl, src_c, q0,
                              max(min(nc, n_valid - q0), 0), hc, hc_pad,
                              lanes, lg, vec);
      const T* sj = stage;
      const float* aj = ae_c + q0 * heads;
      const int n_mine = min(nc, n_valid - q0);
#pragma unroll 2
      for (int qq = 0; qq < n_mine; ++qq, sj += hc_pad, aj += heads) {
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const int c0 = (v * lanes + lg) * VEC;
          if (c0 >= hc) continue;
          float g[VEC];
          unpack<T, W>(load_vec<W>(sj + c0), g);
          const float w_u = FAST ? aj[my_head] : 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            if constexpr (FAST) {
              acc[v * VEC + e] += w_u * g[e];
            } else if (c0 + e < hc) {
              acc[v * VEC + e] += aj[(c0 + e) / ch] * g[e];
            }
          }
        }
      }
    }
    if (live)
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int c0 = (v * lanes + lg) * VEC;
        if (c0 < hc)
          store_chunk<T, W>(out + srow * hc, c0, hc, vec, acc + v * VEC);
      }
    __syncwarp();
  }
}

struct Args {
  const void *xl, *xr, *att, *idx, *mask, *keep;
  int n, n_src, k, heads, hc, lanes, rows, slots, smem_bytes, n_blocks,
      vec_io, mode;
  float slope_t;
  KeepHash hash;
  const void* seed;
  void *out, *alpha;
  cudaStream_t stream;
};

template <typename T, int W, int NV, int LPH>
int launch(const Args& a) {
  auto kernel = edge_stage_fwd_kernel<T, W, NV, LPH>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.n_blocks, a.rows * a.lanes, a.smem_bytes, a.stream>>>(
      (const T*)a.xl, (const T*)a.xr, (const T*)a.att, (const int32_t*)a.idx,
      (const uint8_t*)a.mask, (const T*)a.keep, a.n, a.n_src, a.k, a.heads,
      a.hc, a.lanes, a.rows, a.slots, a.vec_io, a.mode, a.slope_t, a.hash,
      (const uint32_t*)a.seed, (T*)a.out, (float*)a.alpha);
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

// xl (n_src, hc), xr (n, hc), att (hc,) in the feature type (is_bf16:
// bfloat16, else float32); idx (n, k) int32; mask (n, k) bool (1 byte);
// keep (n, k, heads) feature type, read in mode 2 only; seed the device
// address of the two uint32 seed words, thresh and inv_keep the dropout
// threshold and multiplier, read in mode 1 only; slope_t the negative
// slope rounded to the feature type.  Outputs: out (n, hc) feature type;
// alpha (n, k, heads) float32.  mode: 0 no dropout, 1 hashed dropout, 2
// keep tensor.
// The launch configuration (lanes per row, chunk bytes 8 or 16, chunks
// per lane nv in {1, 2, 4}, rows per block, staged slots, dynamic shared
// bytes, blocks) is ops/postgather.py::fwd_launch_config's; head_lanes,
// the lanes of a head, selects the fast path (0: the general path);
// vec_io says that every row of xl, xr and out starts on a chunk boundary
// and hc * size is a multiple of the chunk.  The caller checks shapes and
// types and guarantees n > 0, 0 < hc <= 512, hc % heads == 0.  Returns
// the CUDA error of the launch.
extern "C" int sgt_edge_stage_fwd(
    const void* xl, const void* xr, const void* att, const void* idx,
    const void* mask, const void* keep, int n, int n_src, int k, int heads,
    int hc, float slope_t, int is_bf16, int mode, const void* seed,
    uint32_t thresh, float inv_keep, void* out, void* alpha,
    int lanes, int chunk_bytes, int nv, int rows, int slots, int smem_bytes,
    int n_blocks, int vec_io, int head_lanes, void* stream) {
  const Args a{xl, xr, att, idx, mask, keep, n, n_src, k, heads, hc, lanes,
               rows, slots, smem_bytes, n_blocks, vec_io, mode, slope_t,
               KeepHash{0u, 0u, thresh, inv_keep}, seed, out, alpha,
               (cudaStream_t)stream};
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
