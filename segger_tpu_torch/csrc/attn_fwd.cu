// Fused GATv2 edge attention + aggregation, forward only, for Hopper
// (sm_90a): one kernel, two entry points.
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
//   e_jh  = sum_{c in head h} s_c * att_c     each product rounded to the
//                                             type, summed in f32 in a
//                                             fixed order, the sum rounded
//   z     = e_jh - max_j e_jh;  ez = exp(z)   each rounded to the type
//   alpha = ez / max(sum_j ez, 1e-30)         sum and quotient rounded
//   out_i = sum_j alpha_jh * g_j + bias       f32 accumulation, stored in T
//
// These are the TPU kernels' roundings: they compute in the feature type
// throughout, unlike edge_stage_fwd.cu, which keeps f32 softmax statistics.
// In float32 every rounding is the identity.  Rows with no valid slot give
// the bias exactly.
//
// The order of each head's sum, which the plain version
// (ops/gatv2_attn.py::head_logits) repeats so that both round to the same
// bf16 logit: channel c lies in chunk v = c / (L*VEC) of lane
// (c / VEC) % L (L lanes a row, VEC channels a chunk, from
// ops/gatv2_attn.py::attn_launch_config); each lane adds its channels of
// the head to 0 in f32, chunk by chunk and channel by channel, and a
// butterfly over the L lanes (offsets L/2, ..., 1; on the fast path over
// the head's own LPH lanes, which equals it, the other lanes holding 0)
// adds the lanes' partial sums.
//
// What bounds it on an H100: bytes.  Each valid slot reads one source row
// (H*C values) at random against a few flops per byte, far below the
// ridge; the floor is the rows the valid slots name, xr, idx, mask (and lo)
// read once and out written once, over 3.35 TB/s: 0.0965 ms on the
// 200,192-row slide table at HC = 128 in f32.  The TPU kernels held the
// source table (gatv2_attn) or a 4,096-row window of it (banded) in VMEM,
// 12.8 MB or 2 MiB at these widths, both above the 227 KB of shared memory
// a block can have; this kernel reads the rows through L2 (50 MB) and skips
// masked slots.  What sets the time at these sizes is each row's chain of
// dependent steps (idx, gathers, logits, softmax, sum) and how many rows an
// SM keeps in flight to cover it, so the design is that of
// edge_stage_fwd.cu, which keeps the chain short, with shared memory sized
// so that eight blocks share an SM:
//
// - Row groups: L lanes a destination row, each holding NV chunks of CB =
//   8 or 16 bytes, in blocks of 128 threads, over a grid-stride loop whose
//   block count N alone sets.  Consecutive blocks take consecutive rows, so
//   the rows in flight at once are neighbours, and on a strip-major table
//   (K7's, or K6's over the same table) their sources are neighbours too,
//   which L2 holds.  The layout follows HC, H and the type alone (16-byte
//   chunks for rows of 256 bytes or more), so that the plain version can
//   repeat the summation order without the table's size.  Rows move as
//   CB-byte vectors when every row starts on CB bytes (vec_io); otherwise
//   element by element, masked at HC.
// - Compacted, staged gathers.  The row's idx and mask come in one
//   coalesced load (K7 adds lo[row / 256] to each index before the clip),
//   a ballot over the row's lanes compacts its valid slots, and each lane
//   copies its chunks of every valid slot's source row into shared memory
//   by cp.async before it forms the first logit.  Only that lane reads them
//   back, so no barrier is needed: all of a row's gathers are in flight at
//   once, and both the logit pass and the output pass read the staged rows,
//   so a referenced row is read from device memory once a launch where its
//   valid slots fit the S staged.  S is as many slots as keep eight blocks
//   an SM (ops/gatv2_attn.py::attn_launch_config): every slot up to K = 12
//   at HC = 128, 12 or 13 at K = 16 and 24.  A row with more valid slots
//   takes them in chunks of S, and the output pass stages each chunk again.
//   Rows in flight outweigh the second read: on the slide table (about 5
//   valid slots of 16) staging all 16 left six blocks an SM and took 20 %
//   longer on an H100.  Loading the next row's idx, mask and xr during the
//   current row gained nothing there once eight blocks shared an SM, and
//   cost 3-7 % at K = 4 and 8, so each row loads its own.
// - Logits, then alpha, in shared memory: K*H f32 a row in compact order,
//   beside the K int32 source rows.  No (N, K, H) scratch exists in device
//   memory, and no alpha leaves the kernel.  On the fast path (one chunk a
//   lane inside one head, LPH = 2^m lanes a head, a template parameter) a
//   butterfly of width LPH gives every head's logit at once; the general
//   path sums per head over the row.  The row's lanes then run the
//   softmax in place, every head at once where H is a power of two.
// - Roundings: p, slope*p and s*att are bf16x2 operations in bf16 (the
//   product or sum of two bf16 values is exact in f32, so one bf16x2
//   operation rounds it as round_T does), s is the maximum or minimum of p
//   and slope*p (leaky_t), and z, exp(z), the sum and alpha are rounded
//   to the type by f32 operations; expf as the plain version's exp.
//
// Staging K7's window would not pay here: the widest block span on the
// slide is 2,029 rows, about 1 MB in f32, four times a block's shared
// memory, and a block needs only the few rows its valid slots name (about
// 5 a row on the slide), which L2 already serves to the neighbouring
// blocks that share them.
//
// Control flow is uniform across a warp wherever lanes shuffle: every lane
// of a warp walks as many compacted slots as the warp's fullest row holds
// (rows past N hold none), and a lane past its own row's count forms a
// logit that it does not store.

#include "edge_stage_common.cuh"

namespace {

using namespace sgt;

constexpr int kBandBlock = 256;  // banded.py BLOCK
constexpr int kBandK = 16;       // banded.py K_BAND

// The softmax of one row's logits in lg_c (the c-th valid slot's H logits
// at c*H), rounded to T as the TPU kernel: z = e - max, ez = exp(z), alpha
// = ez / max(sum ez, 1e-30); alpha overwrites the logits.  ALL: every head
// at once, for a power-of-two H <= L, where the entries a lane walks
// (stride L) share one head and a butterfly over the lanes that keep it
// reduces each head; else head h alone, reduced over all L lanes.  Each
// lane rewrites only the entries it reads.
template <typename T, bool ALL>
__device__ __forceinline__ void softmax_row(float* lg_c, int h, int n_valid,
                                            int heads, int lanes, int lg) {
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
    const float ez = round_to<T>(expf(round_to<T>(lg_c[at] - m)));
    lg_c[at] = ez;
    den += ez;
  }
  for (int off = lanes >> 1; off >= stop; off >>= 1)
    den += __shfl_xor_sync(0xffffffffu, den, off, lanes);
  den = fmaxf(round_to<T>(den), 1e-30f);
  for (int t = lg; t < count; t += lanes) {
    const int at = ALL ? t : t * heads + h;
    lg_c[at] = round_to<T>(lg_c[at] / den);
  }
}

// W: 32-bit words a chunk (CB = 4*W bytes); NV: chunks a lane; LPH: the
// lanes of a head on the fast path (implies NV == 1 and vec_io), 0 on the
// general path.  lo: nullptr for a global idx, else the window start of
// each kBandBlock-row block.  At most 64 registers a thread, so that eight
// blocks (32 warps) can share an SM and hide each other's gathers.
template <typename T, int W, int NV, int LPH>
__global__ void __launch_bounds__(kMaxThreads, 8)
attn_fwd_kernel(const T* __restrict__ xl, const T* __restrict__ xr,
                const T* __restrict__ att, const float* __restrict__ bias,
                const int32_t* __restrict__ lo,
                const int32_t* __restrict__ idx,
                const uint8_t* __restrict__ mask, int n, int n_src, int k,
                int heads, int hc, int lanes, int rows, int slots,
                int vec_io, float slope_t, T* __restrict__ out) {
  constexpr int VEC = W * kPerWord<T>;
  constexpr int E = NV * VEC;  // channels a lane holds
  constexpr bool FAST = LPH > 0;
  extern __shared__ __align__(16) unsigned char smem[];
  const bool vec = FAST || vec_io != 0;
  const int grp = threadIdx.x / lanes;  // the block's row this lane serves
  const int lg = threadIdx.x % lanes;   // lane in the row group
  const int hc_pad = lanes * E;
  const int ch = hc / heads;
  T* stage = reinterpret_cast<T*>(smem) + (size_t)grp * slots * hc_pad;
  float* fbuf = reinterpret_cast<float*>(
      smem + (size_t)rows * slots * hc_pad * sizeof(T));
  // per row: logits, then ez, then alpha, in compact order (K*H f32); the
  // source rows of the valid slots in order (K int32)
  float* lg_c = fbuf + (size_t)grp * k * heads;
  int* src_c = reinterpret_cast<int*>(fbuf + (size_t)rows * k * heads) +
               (size_t)grp * k;
  const int lane0 = (threadIdx.x & 31) & ~(lanes - 1);  // in its warp

  // FAST: the lane's head, and whether it writes its head's logit
  const int my_head = lg / (FAST ? LPH : 1);
  const bool head_writer = FAST && lg % (FAST ? LPH : 1) == 0 &&
                           my_head < heads;
  const bool use_max = slope_t <= 1.f;
  const bool heads_pow2 = (heads & (heads - 1)) == 0 && heads <= lanes;
  Chunk<W> att_w[NV];  // att as stored, 0 past HC
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c0 = (v * lanes + lg) * VEC;
    float fa[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) fa[e] = 0.f;
    if (c0 < hc) load_chunk<T, W>(att, c0, hc, false, fa);
    att_w[v] = pack<T, W>(fa);
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
    const int win = lo ? lo[srow / kBandBlock] : 0;

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
    // c-th valid slot.  idx and mask are loaded together; a ballot over
    // the row's lanes places each valid slot
    int n_valid = 0;
    for (int j0 = 0; j0 < k; j0 += lanes) {
      const int j = j0 + lg;
      int src = -1;
      if (live && j < k) {
        const int i = idx[srow * k + j];
        src = mask[srow * k + j] ? min(max(win + i, 0), n_src - 1) : -1;
      }
      const unsigned b = __ballot_sync(0xffffffffu, src >= 0);
      const unsigned seg =
          lanes == 32 ? b : (b >> lane0) & ((1u << lanes) - 1u);
      if (src >= 0) src_c[n_valid + __popc(seg & ((1u << lg) - 1u))] = src;
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
        float prod[E];  // s * att, rounded to T
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const int c0 = (v * lanes + lg) * VEC;
          Chunk<W> g = {};
          if (valid && c0 < hc) g = load_vec<W>(sj + c0);
          const Chunk<W> pw = add_t<T, W>(g, xr_w[v]);
          const Chunk<W> sw =
              leaky_t<T, W>(pw, mul_t<T, W>(slope_w, pw), use_max);
          unpack<T, W>(mul_t<T, W>(sw, att_w[v]), prod + v * VEC);
        }
        if constexpr (FAST) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) part += prod[e];
#pragma unroll
          for (int off = LPH / 2; off > 0; off >>= 1)
            part += __shfl_xor_sync(0xffffffffu, part, off);
          if (head_writer && valid) ej[my_head] = round_to<T>(part);
        } else {
          for (int h = 0; h < heads; ++h) {
            float part = 0.f;
#pragma unroll
            for (int v = 0; v < NV; ++v) {
              const int c0 = (v * lanes + lg) * VEC;
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                if (c0 + e < hc && (c0 + e) / ch == h)
                  part += prod[v * VEC + e];
            }
            part = group_sum(part, lanes);
            if (lg == 0 && valid) ej[h] = round_to<T>(part);
          }
        }
      }
    }
    __syncwarp();

    // softmax over the valid slots, in place
    if (heads_pow2) {
      softmax_row<T, true>(lg_c, 0, n_valid, heads, lanes, lg);
    } else {
      for (int h = 0; h < heads; ++h)
        softmax_row<T, false>(lg_c, h, n_valid, heads, lanes, lg);
    }
    __syncwarp();

    // pass 2: out = sum_c alpha * g_c + bias over the valid slots, from the
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
      const float* aj = lg_c + q0 * heads;
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
        if (c0 >= hc) continue;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[v * VEC + e] += c0 + e < hc ? bias[c0 + e] : 0.f;
        store_chunk<T, W>(out + srow * hc, c0, hc, vec, acc + v * VEC);
      }
    __syncwarp();
  }
}

struct Args {
  const void *xl, *xr, *att, *bias, *lo, *idx, *mask;
  int n, n_src, k, heads, hc, lanes, rows, slots, smem_bytes, n_blocks,
      vec_io;
  float slope_t;
  void* out;
  cudaStream_t stream;
};

template <typename T, int W, int NV, int LPH>
int launch(const Args& a) {
  auto kernel = attn_fwd_kernel<T, W, NV, LPH>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.n_blocks, a.rows * a.lanes, a.smem_bytes, a.stream>>>(
      (const T*)a.xl, (const T*)a.xr, (const T*)a.att, (const float*)a.bias,
      (const int32_t*)a.lo, (const int32_t*)a.idx, (const uint8_t*)a.mask,
      a.n, a.n_src, a.k, a.heads, a.hc, a.lanes, a.rows, a.slots, a.vec_io,
      a.slope_t, (T*)a.out);
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

int dispatch(const Args& a, int is_bf16, int chunk_bytes, int nv,
             int head_lanes) {
  const int size = is_bf16 ? 2 : 4;
  if (a.rows * a.lanes > kMaxThreads ||
      (chunk_bytes != 8 && chunk_bytes != 16) ||
      chunk_bytes / size * a.lanes * nv < a.hc || (head_lanes && !a.vec_io))
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return chunk_bytes == 16 ? launch_nv<__nv_bfloat16, 4>(a, nv, head_lanes)
                             : launch_nv<__nv_bfloat16, 2>(a, nv, head_lanes);
  return chunk_bytes == 16 ? launch_nv<float, 4>(a, nv, head_lanes)
                           : launch_nv<float, 2>(a, nv, head_lanes);
}

}  // namespace

// xl (n_src, hc), xr (n, hc), att (hc,) in the feature type (is_bf16:
// bfloat16, else float32); bias (hc,) float32; idx (n, k) int32; mask
// (n, k) bool (1 byte); slope_t the negative slope rounded to the feature
// type; out (n, hc) feature type.  The launch configuration (lanes per
// row, chunk bytes 8 or 16, chunks per lane nv in {1, 2, 4}, rows per
// block, staged slots, dynamic shared bytes, blocks) is
// ops/gatv2_attn.py::attn_launch_config's; head_lanes, the lanes of a
// head, selects the fast path (0: the general path); vec_io says that
// every row of xl, xr and out starts on a chunk boundary and hc * size is
// a multiple of the chunk.  The caller checks shapes and types and
// guarantees n > 0, 0 < hc <= 512, hc % heads == 0.  Returns the CUDA
// error of the launch.
extern "C" int sgt_gatv2_attention(
    const void* xl, const void* xr, const void* att, const void* bias,
    const void* idx, const void* mask, int n, int n_src, int k, int heads,
    int hc, float slope_t, int is_bf16, void* out, int lanes,
    int chunk_bytes, int nv, int rows, int slots, int smem_bytes,
    int n_blocks, int vec_io, int head_lanes, void* stream) {
  const Args a{xl, xr, att, bias, nullptr, idx, mask, n, n_src, k, heads,
               hc, lanes, rows, slots, smem_bytes, n_blocks, vec_io, slope_t,
               out, (cudaStream_t)stream};
  return dispatch(a, is_bf16, chunk_bytes, nv, head_lanes);
}

// The banded table, float32: xl (n_src, hc), xr (n_pad, hc), att (hc,),
// bias (hc,); lo (n_pad / 256,) int32; idx_local and mask (n_pad, 16);
// out (n_pad, hc).  The launch configuration as sgt_gatv2_attention's, at
// k = 16.  The caller guarantees n_pad % 256 == 0 and n_pad > 0.
extern "C" int sgt_banded_edge_stage(
    const void* xl, const void* xr, const void* att, const void* bias,
    const void* lo, const void* idx_local, const void* mask, int n_pad,
    int n_src, int heads, int hc, float slope, void* out, int lanes,
    int chunk_bytes, int nv, int rows, int slots, int smem_bytes,
    int n_blocks, int vec_io, int head_lanes, void* stream) {
  const Args a{xl, xr, att, bias, lo, idx_local, mask, n_pad, n_src, kBandK,
               heads, hc, lanes, rows, slots, smem_bytes, n_blocks, vec_io,
               slope, out, (cudaStream_t)stream};
  return dispatch(a, 0, chunk_bytes, nv, head_lanes);
}
