// Candidate scoring for Hopper (sm_90a): masked max dot product and its
// first slot.
//
// Replaces segger_tpu/ops/pallas/score.py::_score_kernel (score_max_pallas),
// the prediction assignment.  Per transcript row i:
//
//   cos_j = sum_f f32(tx[i, f]) * f32(bd[clip(idx[i, j]), f])  (gathered here)
//   z_j   = mask[i, j] ? cos_j : -1e30
//   max_i = max_j z_j;  slot_i = first j with z_j == max_i, or -1 when the
//   row has no valid slot (then max_i = -1e30)
//
// What bounds it on an H100: bytes.  A row reads its tx row and at most K
// candidate rows of F values against 2F flops each, far below the
// tensor-core ridge; the floor is those reads, idx and mask, plus 8 bytes
// written per row, over 3.35 TB/s.  The TPU kernel read a gathered
// (N, K, F) tensor that XLA had written to HBM; here the candidate rows
// are gathered through idx inside the kernel, and masked slots are not
// read at all.  At the main path's sizes (16,128 x 4 over 832 rows of 128
// bytes) that floor is under a microsecond, so what sets the time is each
// row's chain of dependent steps and how many rows are in flight.  The
// design keeps the chain to two round trips to memory (idx and mask, then
// every gather of the row at once) and packs several rows into a warp:
//
// - Row groups (the layout is ops/score.py::score_launch_config's): L
//   lanes per transcript row, each holding NV chunks of CB bytes (16 for
//   rows of 128 bytes or more, else 8; up to two chunks a lane), in blocks
//   of 128 threads.  At F = 64 in bf16 that is 4 lanes of two 16-byte
//   chunks, eight rows a warp: the fewer lanes a row, the fewer
//   instructions a row spends on its idx, ballot and butterflies.  Rows
//   move as CB-byte vectors when every row of tx and bd starts on CB bytes
//   (VEC_IO); otherwise element by element, masked at F, in the same
//   layout.
// - Slots in rounds of L: lane j of the group reads idx and mask of slot
//   j0 + j, a ballot over the group compacts the round's valid slots in
//   slot order, and a shuffle hands each lane the candidate row of each.
//   Every valid slot's chunks are then loaded, SB slots at once (a
//   compile-time slot batch of 32 chunk words a lane, 4 slots at F = 64
//   bf16), before any product is formed; the SB reductions run side by
//   side.  Masked slots are never read.  Up to 85 registers a thread (six
//   blocks an SM) hold a batch without spilling; a 64-register cap (eight
//   blocks) spilled it and took 3 % longer (H100 80GB HBM3, 700 W).
// - One summation order for every slot: each lane sums its channels in
//   chunk order with fmaf from 0, then a butterfly over the L lanes
//   (offsets L/2 .. 1) adds the lanes' sums.  The order follows F, dtype
//   and the layout only, so equal candidate rows give equal sums and the
//   strict comparison in slot order keeps the first maximal slot.  The
//   butterfly leaves the sum bit-equal on every lane of the group, so the
//   running max and slot stay uniform across it.
// - A valid slot below -1e30 loses to a masked slot's -1e30, as in the
//   TPU kernel: the row's first masked slot enters the max at the end.
//
// Control flow is uniform across a warp wherever lanes shuffle: every row
// of a warp walks the rounds of K, and in each round as many batches as
// the warp's fullest row needs (rows past N hold no valid slot).

#include "edge_stage_common.cuh"

namespace {

using namespace sgt;

constexpr int kBatchWords = 32;  // gathered chunk words a lane holds at once

// the slot batch of a lane holding NV chunks of W words (ops/score.py
// _slot_batch)
__host__ __device__ constexpr int slot_batch(int w, int nv) {
  return kBatchWords / (w * nv) < 1   ? 1
         : kBatchWords / (w * nv) > 8 ? 8
                                      : kBatchWords / (w * nv);
}

// one chunk of a row: the vector as stored, or its elements masked at f
template <typename T, int W, bool VEC_IO>
__device__ __forceinline__ Chunk<W> row_chunk(const T* __restrict__ row,
                                              int c0, int f) {
  if constexpr (VEC_IO) return load_vec<W>(row + c0);
  float e[W * kPerWord<T>];
  load_chunk<T, W>(row, c0, f, false, e);
  return pack<T, W>(e);  // exact: the values came from T
}

// W: 32-bit words a chunk (CB = 4*W bytes); NV: chunks a lane; VEC_IO:
// rows move as chunk vectors.
template <typename T, int W, int NV, bool VEC_IO>
__global__ void __launch_bounds__(kMaxThreads, 6)
score_max_kernel(const T* __restrict__ tx, const T* __restrict__ bd,
                 const int32_t* __restrict__ idx,
                 const uint8_t* __restrict__ mask, int n, int n_bd, int k,
                 int f, int lanes, float* __restrict__ max_out,
                 int32_t* __restrict__ slot_out) {
  constexpr int VEC = W * kPerWord<T>;
  constexpr int SB = slot_batch(W, NV);
  const int grp = threadIdx.x / lanes;  // the block's row this lane serves
  const int lg = threadIdx.x % lanes;   // lane in the row group
  const int row = blockIdx.x * (blockDim.x / lanes) + grp;
  const bool live = row < n;  // rows past N hold no valid slot
  const size_t srow = live ? (size_t)row : 0;
  const int lane0 = (threadIdx.x & 31) & ~(lanes - 1);  // in its warp
  const unsigned seg = lanes == 32 ? 0xffffffffu : (1u << lanes) - 1u;

  // the tx row, in flight while the first round's idx and mask arrive
  Chunk<W> tx_w[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c0 = (v * lanes + lg) * VEC;
    tx_w[v] = Chunk<W>{};
    if (live && c0 < f)
      tx_w[v] = row_chunk<T, W, VEC_IO>(tx + srow * f, c0, f);
  }
  float t[NV * VEC];
#pragma unroll
  for (int v = 0; v < NV; ++v) unpack<T, W>(tx_w[v], t + v * VEC);

  float best = kNegInf;
  int best_slot = -1;  // over valid slots, in slot order
  int first_masked = k;
  for (int j0 = 0; j0 < k; j0 += lanes) {
    const int j = j0 + lg;
    int src = 0;
    bool valid = false, masked = false;
    if (live && j < k) {
      src = min(max(idx[srow * k + j], 0), n_bd - 1);
      valid = mask[srow * k + j] != 0;
      masked = !valid;
    }
    unsigned bits = (__ballot_sync(0xffffffffu, valid) >> lane0) & seg;
    const unsigned mbits = (__ballot_sync(0xffffffffu, masked) >> lane0) & seg;
    if (mbits && first_masked == k) first_masked = j0 + __ffs(mbits) - 1;
    // the batches every row of the warp walks (its fullest row's)
    const int walk = __reduce_max_sync(0xffffffffu, __popc(bits));
    for (int q0 = 0; q0 < walk; q0 += SB) {
      // the batch's gathers, all issued before the first product
      Chunk<W> g[SB][NV];
      int slot[SB];
#pragma unroll
      for (int s = 0; s < SB; ++s) {
        slot[s] = -1;
#pragma unroll
        for (int v = 0; v < NV; ++v) g[s][v] = Chunk<W>{};
        if (q0 + s >= walk) continue;  // uniform across the warp
        const int jj = bits ? __ffs(bits) - 1 : -1;
        bits &= bits - 1u;
        const int r = __shfl_sync(0xffffffffu, src, jj < 0 ? 0 : jj, lanes);
        if (jj < 0) continue;
        slot[s] = j0 + jj;
        const T* gr = bd + (size_t)r * f;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const int c0 = (v * lanes + lg) * VEC;
          if (c0 < f) g[s][v] = row_chunk<T, W, VEC_IO>(gr, c0, f);
        }
      }
      // the lanes' sums, then the SB butterflies side by side
      float part[SB];
#pragma unroll
      for (int s = 0; s < SB; ++s) {
        part[s] = 0.f;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          float ge[VEC];
          unpack<T, W>(g[s][v], ge);
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            part[s] = fmaf(t[v * VEC + e], ge[e], part[s]);
        }
      }
      for (int off = lanes >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int s = 0; s < SB; ++s)
          if (q0 + s < walk)
            part[s] += __shfl_xor_sync(0xffffffffu, part[s], off, lanes);
      }
#pragma unroll
      for (int s = 0; s < SB; ++s)  // strict: the first maximal slot wins
        if (slot[s] >= 0 && (best_slot < 0 || part[s] > best)) {
          best = part[s];
          best_slot = slot[s];
        }
    }
  }
  // a masked slot counts as -1e30: it wins over valid slots below it, and
  // over an equal one that comes later
  if (best_slot >= 0 && first_masked < k &&
      (best < kNegInf || (best == kNegInf && first_masked < best_slot))) {
    best = kNegInf;
    best_slot = first_masked;
  }
  if (live && lg == 0) {
    max_out[row] = best;
    slot_out[row] = best_slot;
  }
}

struct Args {
  const void *tx, *bd, *idx, *mask;
  int n, n_bd, k, f, lanes, rows, n_blocks;
  void *max_out, *slot_out;
  cudaStream_t stream;
};

template <typename T, int W, int NV, bool VEC_IO>
int launch(const Args& a) {
  score_max_kernel<T, W, NV, VEC_IO>
      <<<a.n_blocks, a.rows * a.lanes, 0, a.stream>>>(
          (const T*)a.tx, (const T*)a.bd, (const int32_t*)a.idx,
          (const uint8_t*)a.mask, a.n, a.n_bd, a.k, a.f, a.lanes,
          (float*)a.max_out, (int32_t*)a.slot_out);
  return (int)cudaGetLastError();
}

template <typename T, int W>
int launch_nv(const Args& a, int nv, bool vec_io) {
  switch (nv) {
    case 1:
      return vec_io ? launch<T, W, 1, true>(a) : launch<T, W, 1, false>(a);
    case 2:
      return vec_io ? launch<T, W, 2, true>(a) : launch<T, W, 2, false>(a);
    case 4:  // f32 rows over 1,024 bytes only (score_launch_config)
      if constexpr (sizeof(T) == 4 && W == 4)
        return vec_io ? launch<T, W, 4, true>(a) : launch<T, W, 4, false>(a);
      [[fallthrough]];
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// tx (n, f) and bd (n_bd, f) in the feature type (is_bf16: bfloat16, else
// float32); idx (n, k) int32; mask (n, k) bool (1 byte); max_out (n,)
// float32; slot_out (n,) int32.  The layout (lanes a row, chunk bytes 8 or
// 16, chunks a lane nv in {1, 2, 4}, slot batch, rows a block, blocks) is
// ops/score.py::score_launch_config's; vec_io says that f * size is a
// multiple of the chunk and tx and bd start on a chunk boundary.  The
// caller checks shapes and types and guarantees n > 0, n_bd > 0, k > 0,
// 0 < f <= 512.  Returns the CUDA error of the launch.
extern "C" int sgt_score_max(const void* tx, const void* bd, const void* idx,
                             const void* mask, int n, int n_bd, int k, int f,
                             int is_bf16, void* max_out, void* slot_out,
                             int lanes, int chunk_bytes, int nv,
                             int slot_batch_, int rows, int n_blocks,
                             int vec_io, void* stream) {
  const int size = is_bf16 ? 2 : 4;
  const int w = chunk_bytes / 4;
  if (rows * lanes != kMaxThreads || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) || (chunk_bytes != 8 && chunk_bytes != 16) ||
      chunk_bytes / size * lanes * nv < f || slot_batch_ != slot_batch(w, nv))
    return (int)cudaErrorInvalidValue;
  const Args a{tx,    bd,   idx,      mask,    n,        n_bd,
               k,     f,    lanes,    rows,    n_blocks, max_out,
               slot_out, (cudaStream_t)stream};
  if (is_bf16)
    return w == 4 ? launch_nv<__nv_bfloat16, 4>(a, nv, vec_io)
                  : launch_nv<__nv_bfloat16, 2>(a, nv, vec_io);
  return w == 4 ? launch_nv<float, 4>(a, nv, vec_io)
                : launch_nv<float, 2>(a, nv, vec_io);
}
