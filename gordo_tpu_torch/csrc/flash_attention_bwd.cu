// Flash-attention backward for NVIDIA Hopper (sm_90a), plain C interface:
// two kernels, one for dq and one for dk/dv.
//
// Replaces the two Pallas TPU kernels that _flash_backward_bhsd launches
// in gordo_tpu/ops/flash_attention.py:
//
// - gordo_flash_attention_bwd_dq replaces _bwd_dq_kernel: for each query
//   row, p = exp(s * q.k - LSE) over the keys the mask keeps, and
//   dq = s * sum_k [p * (dO.v - delta)] k. It also computes
//   delta = rowsum(dO * O), which the JAX wrapper computes outside any
//   kernel, and writes it out for the dk/dv kernel.
// - gordo_flash_attention_bwd_dkv replaces _bwd_dkv_kernel: for each key
//   row, dv = sum_q p dO and dk = s * sum_q [p * (dO.v - delta)] q.
//
// s is sm_scale; it scales the scores, dq and dk, never dv. LSE and delta
// are (batch*heads, seq) float32 with row b*heads + h, the forward
// kernel's convention. The dk/dv kernel reads the delta the dq kernel
// wrote, so the two run in that order on one stream.
//
// What bounds them on this card. Each kernel reads its inputs once and
// writes its outputs once: dq reads q, k, v, O, dO and LSE and writes dq
// and delta; dk/dv reads q, k, v, dO, LSE and delta and writes dk and dv.
// That is six (batch, seq, heads, head_dim) tensors each, about 3.1 MB at
// the training step's (32, 64, 4, 16) in float32 (under 1 us at
// 3.35 TB/s) and 822 MB at the served scale (8192, 64, 4, 16): 0.25 ms.
// The work is 3 (dq: scores, dO.v, ds.k) and 4 (dk/dv: scores, dO.v,
// p.dO, ds.q) dot products of head_dim per kept (query, key) pair, 6.5
// and 8.7 GFLOP at the served scale: 0.10 and 0.13 ms at the 67 TFLOP/s
// fp32 rate. So both are bound by bytes, and at the training shape by
// their launch and one block's dependent load-then-compute latency. Both
// keep every intermediate (scores, probabilities, dS) out of device
// memory. Each output element has one owner and there are no atomics;
// where dq splits its keys across blocks, a second kernel sums the splits
// in a fixed order: both kernels are deterministic.
//
// dq at head_dim 16 and 32 (flash_bwd_dq_quad_kernel, the model's head
// sizes) replaces _bwd_dq_kernel (gordo_tpu/ops/flash_attention.py:176),
// bound by bytes as above (0.25 ms at the served scale, under 1 us at the
// training step), with the forward quad kernel's layout. Blocks of 4 warps
// own a run of query rows of one (batch, head). Each lane holds R query
// rows times D/S of their head dims in registers: q (prescaled by
// sm_scale * log2 e, so one exp2(score - LSE * log2 e) gives a pair's
// probability), dO and the dq partials, with each row's LSE and delta.
// delta = rowsum(dO * O) is summed before the key loop, and one lane of
// the row writes it. A quad of four lanes shares those rows: lane `quad`
// walks keys quad, quad + 4, ... of each staged 64-key tile, so a lane's
// serial chain is 16 keys, not 64. Per key a lane reads the value row (for
// dO.v) and then the key row (for the score and ds.k), so only one of
// them is live in registers. R = 1, S = 1 at head_dim 16 and R = 1, S = 2
// at 32: the fastest tilings ptxas fits with no spill (117 and 148
// registers in float32). Key and value tiles are staged in shared memory
// with 16-byte cp.async copies when every row start of q, k, v, O, dO and
// dq is 16-byte aligned (mode bit 2), else element by element in the same
// kernel; the q, dO and O rows go straight to registers, 16 bytes a load
// under the same bit. Causal blocks stop at their last row's key and each
// warp at its own last row's, so no warp walks keys the mask drops for
// all of its rows. The quad's partials are merged once by the fixed-order
// butterfly reduce-scatter, and each lane stores a quarter of a row's
// dims.
//
// dq at head_dim 64 and 128 in float32 and float64, and at 256 in every
// type (flash_bwd_dq_wide_kernel): bound by
// operations (3 dots of head_dim per kept pair: 52 GFLOP, 0.77 ms at the
// fp32 rate, for the causal (1, 8192, 4, 64)) and by each block's serial
// key walk at small grids. The forward wide kernel's layout on query rows:
// a row's dims are split over S lanes (4 at head_dim 64, 8 at 128 and 256)
// and each lane owns R query rows (DqWideTiling) with q (prescaled by
// sm_scale * log2 e, so one exp2(score - LSE * log2 e) gives a pair's
// probability), dO and the dq partials in registers; delta = rowsum(dO *
// O) is summed before the walk and written once per row. A quad of four
// lanes splits each key tile (lane `quad` takes keys quad, quad + 4, ...),
// and per key a lane reads the value row (dO.v) and then the key row
// (score and ds.k), so one of the two is live at a time; every element
// read from shared memory feeds R rows' multiply-adds. Key and value tiles
// pass through a two-stage ring in dynamic shared memory: with mode bit 2
// the 16-byte cp.async copies of tile t + 1 run under the math on tile t,
// otherwise the same ring is filled element by element. Causal stops are
// warp-uniform, and blocks run the row tiles last to first across all
// heads, so a causal launch starts with its longest key walks. Where the
// row tiles alone leave the card's SMs idle the key axis is split across
// blocks, as the forward's is (flash::key_splits): each split writes its
// unscaled float32 dq rows to a scratch the caller allocates, and
// flash_bwd_dq_merge_kernel sums them in split order and writes s * dq in
// T. The quad's partials are merged once by the fixed-order butterfly.
// ptxas fits every width with no spill (212, 212 and 222 registers in
// float32): one 8-warp block an SM at 64 and 128, two 4-warp blocks at
// 256. The tilings were chosen by timing on the card
// (scripts/flash_tiling_sweep.py, PERF.md): R = 4 rows at S = 8 ran 3-5%
// faster in float32 at head_dim 64 and 25% slower in bf16, and tilings
// capped at 128 registers spill.
//
// dk/dv at head_dim 16 and 32 (flash_bwd_dkv_quad_kernel, the model's
// head sizes): blocks of 4 warps own a run of key rows of one (batch,
// head). Each lane holds R key rows times D/S of their head dims (k, v
// and the dk and dv partials in registers; k prescaled so scores are in
// log2 units, one exp2 a pair), the S lanes of a row's dims summing each
// dot with one shuffle, and a quad of four lanes shares those keys: lane
// `quad` walks queries quad, quad + 4, ... of each staged 64-query tile,
// so a lane's serial chain is 16 queries, not 64. Every q and dO element
// read from shared memory feeds R keys' multiply-adds (R = 2, S = 2 at
// head_dim 16: half the shared-memory traffic per (query, key) pair of
// one whole key row per lane, for one shuffle per dot). q, dO and the
// (LSE, delta) pairs of a tile are staged in shared memory with 16-byte
// cp.async copies when every row start is 16-byte aligned (mode bit 2,
// decided by the caller), else element by element in the same kernel.
// Causal blocks start at their first key's query and each warp at its
// own first key's, so no warp walks queries the mask drops for all of
// its keys. The quad's partials are merged once at the end by a
// fixed-order butterfly reduce-scatter. Everything stays on the fp32
// CUDA cores: TF32 would break the 1e-4 float32 tolerance, and the
// served scale is bound by bytes.
//
// dk/dv at head_dim 64, 128 and 256 (flash_bwd_dkv_wide_kernel): bound by
// operations (4 dots of head_dim per kept pair: 69 GFLOP, 1.03 ms at the
// fp32 rate, for the causal (1, 8192, 4, 64)) and by each block's serial
// query walk at small grids. The quad layout of the head_dim 16/32 kernel
// with wider rows: a key row's dims are split over S = 4 (head_dim 64) or
// 8 (128) lanes, each lane owning R = 2 key rows (k, v and the dk, dv
// partials of 16 dims each), so every q and dO element read from shared
// memory feeds two keys' multiply-adds. q, dO, LSE and delta tiles (64
// queries at head_dim 64, 32 at 128) pass through a two-stage ring in
// dynamic shared memory: with mode bit 2 the 16-byte cp.async copies of
// tile t + 1 (4-byte ones for LSE and delta) are in flight while the block
// works on tile t; otherwise q and dO go element by element. Causal blocks
// start at their first key's query and each warp at its own, and blocks
// run the key tiles first to last across all heads, so the longest query
// walks start first. ptxas fits both widths with no spill (248 and 255
// registers in float32); the warps per block (4 at 64, 8 at 128) and the
// tiles were chosen by timing on the card (scripts/flash_tiling_sweep.py,
// PERF.md). At head_dim 256 a key row spans S = 8 lanes of 32 dims and
// a lane owns R = 1 key row (16-query tiles). The quad's partials are
// merged once by the fixed-order butterfly, and each dk/dv element has
// one owner: no atomics.
//
// dk/dv in bfloat16 and float16 at head_dim 64 and 128
// (flash_bwd_dkv_mma_kernel) go to the tensor cores: on the CUDA cores the
// long-context bf16 case took 2.84 ms against SDPA's whole backward of
// 0.30 (PERF.md), and its four products' bound at the 989 TFLOP/s bf16
// rate is 0.069 ms. A block of 4 warps owns 64 key rows, each warp 16.
// q, dO, LSE and delta tiles (64 queries at 64, 32 at 128) pass through a
// two-stage cp.async ring, rows padded by 16 bytes for ldmatrix. Per tile
// each warp computes Sᵀ = K Qᵀ and dPᵀ = V dOᵀ (mma.sync m16n8k16,
// float32 accumulators; see flash_mma.cuh), Pᵀ = exp2(Sᵀ sm_scale log2 e
// - LSE log2 e) from the saved LSE (ex2.approx) where the mask keeps the
// pair, dSᵀ = Pᵀ (dPᵀ - delta), then dV += Pᵀ dO and dK += dSᵀ Q with Pᵀ
// and dSᵀ in the registers that computed them as A operands (dO and Q by
// ldmatrix.trans). As in the forward, Pᵀ and dSᵀ are each split into two
// terms of the input type (head + tail) for those two products: rounded
// once, as SDPA and FlashAttention do, they moved bf16 dk or dv by a
// 1-ulp step of 0.031 at magnitudes of 4 and up, past the 2e-2 tolerance
// of the plain version (which keeps them in float32). dK and dV stay in
// float32 registers and are scaled and written once; each key row has
// one owner and there are no atomics, so two launches are bitwise equal.
// At head_dim 64 the warp's K and V fragments stay in registers for the
// whole walk (246 registers in bf16, 248 in float16, no spill); at 128 dK
// and dV take 128 registers a lane, so K and V are read from shared
// memory each tile and the query tile is halved (254 registers in bf16,
// 255 with a 16-byte spill in float16; a 16-query tile ran 19-23% slower,
// scripts/flash_tiling_sweep.py). The causal start and the key-tile order
// are the wide kernel's; a warp skips the tiles wholly before its first
// key. float32 and float64 keep the wide kernel.
//
// dq in bfloat16 and float16 at head_dim 64 and 128
// (flash_bwd_dq_mma_kernel) goes to the tensor cores too: on the CUDA
// cores the long-context bf16 case took 2.37 ms against SDPA's whole
// backward of 0.30 (PERF.md), and its three products' bound at the 989
// TFLOP/s bf16 rate is 0.052 ms. The dk/dv kernel's design on query rows:
// a block of 4 warps owns 64 query rows, each warp 16, staged once and
// loaded as A fragments that stay in registers for the whole walk.
// delta = rowsum(dO * O) is summed first in float32, two lanes a row, and
// written once per row. Key and value tiles (64 keys at head_dim 64; 32 at
// 128, where the dQ accumulators take 64 registers a lane) pass through a
// two-stage cp.async ring, rows padded by 16 bytes for ldmatrix. Per tile each warp computes S = Q Kᵀ and dP = dO Vᵀ (mma.sync
// m16n8k16, float32 accumulators), P = exp2(S sm_scale log2 e - LSE log2
// e) from the saved LSE (ex2.approx) where the mask keeps the pair, dS =
// P (dP - delta), then dQ += dS K with dS in the registers that computed
// it as the A operand (rounded once to the input type) and K by
// ldmatrix.trans. Carrying dS as a head and a tail term, as dk/dv carries
// Pᵀ and dSᵀ, cut the largest bf16 error from 0.0156 to 0.0039 (tolerance
// 2e-2) at 5-20% more time, and no case needed it (PERF.md). ptxas: 218
// registers at head_dim 64, 240 at 128, no spill. From the wide kernel it keeps the warp-uniform causal
// stop, the heavy-first block order and the key split for grids under one
// wave (unscaled float32 rows summed in split order by
// flash_bwd_dq_merge_kernel); no atomics, so two launches are bitwise
// equal.
//
// Any head_dim above 256 (flash_bwd_dq_rowwise_kernel and
// flash_bwd_dkv_rowwise_kernel, the width a run-time argument, no upper
// limit): one warp a row (a query row in dq, a key row in dk/dv), each
// pair's two dot products summed over the lanes striding over the width
// and then by warp shuffles, the other side's rows staged 16 at a time as
// float32. Up to flash::kMaxSharedRowDim (1024: the dk/dv block's 192
// bytes a lane of width fill 192 KB) the row's vectors and float32
// accumulators sit in shared memory. Above it the kernels stream: the
// partner rows are staged 256 columns at a time (32 KB a block whatever
// the width), first over every chunk for the dot products, then over
// every chunk again for the accumulation; the warp's own rows are read
// from their tensors and its accumulators live in a float32 scratch the
// caller allocates (batch * heads * seq rows of head_dim for dq, 2
// head_dim for dk/dv). Written to be right, not fast (5-6x SDPA at (2,
// 300, 2, 300), PERF.md).
//
// Rows past the sequence end store nothing; query rows past the end add
// nothing to dk/dv and keys past the end have probability 0. No head-dim
// padding to 128 lanes and no lane-broadcast statistics: those exist only
// for Mosaic's (8, 128) tiling.
//
// Inputs are float32, bfloat16, float16 or float64 (dtype 0 / 1 / 2 / 3),
// each element converted to float32 on load and every sum in float32, as
// the Pallas kernels do (a float64 tile is staged in shared memory as
// float32); head_dim is 16, 32, 64, 128, 256 or any multiple of 32 above
// 256; any sequence length; causal or full. Strides are in elements,
// (batch, seq, head) for each tensor in the order the entry point names;
// the head dim must be contiguous. `mode` is a bit set: 1 causal, 2 every
// row start of the six (batch, seq, heads, head_dim) tensors of the entry
// point 16-byte aligned (the rowwise kernels read element by element
// either way). The kernels allocate nothing (dq's split scratch and the
// streamed rowwise kernels' accumulators are the caller's) and run on the
// caller's stream. Each entry point returns the
// CUDA error code of its launch (0 on success) and writes the family of
// the kernel it launched (flash::kFamily*) to its last argument.

#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

// (batch, seq, head) element strides of one (batch, seq, heads, head_dim)
// tensor
struct Strides {
  int64_t b, s, h;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* out;
  const void* d_out;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  Strides q_st, k_st, v_st, o_st, do_st, dq_st, dk_st, dv_st;
  // dq's key splits: each split's unscaled float32 dq rows (the caller's
  // scratch, n_splits * batch * heads * seq * head_dim elements)
  float* ws;
  int n_splits;
  int batch_heads;
  int heads;
  int seq;
  int n_tiles;  // row tiles per (batch, head)
  float sm_scale;
  int causal;
  int vec;
};

using flash::from_float;
using flash::to_float;

template <typename T>
__device__ __forceinline__ const T* row_ptr(const void* base, const Strides& st, int b,
                                            int pos, int h, int d0) {
  return static_cast<const T*>(base) + b * st.b + static_cast<int64_t>(pos) * st.s +
         h * st.h + d0;
}

template <typename T>
__device__ __forceinline__ T* row_ptr(void* base, const Strides& st, int b, int pos,
                                      int h, int d0) {
  return static_cast<T*>(base) + b * st.b + static_cast<int64_t>(pos) * st.s +
         h * st.h + d0;
}

template <typename T, int D, int R, int S, int kMinBlocks>
__global__ void __launch_bounds__(flash::kQuadThreads, kMinBlocks)
    flash_bwd_dkv_quad_kernel(const Params p) {
  using E = flash::staged_t<T>;
  constexpr int kDims = D / S;  // head dims a lane holds
  constexpr int kWarpKeys = R * (32 / (flash::kQuad * S));
  constexpr int kKeys = flash::quad_rows<R, S>();
  constexpr int kPitch = D + 16 / sizeof(E);  // padded row: 16-byte aligned, no bank conflicts
  constexpr int kTile = flash::kPartnerTile;
  __shared__ __align__(16) E k_tile[kKeys * kPitch];
  __shared__ __align__(16) E v_tile[kKeys * kPitch];
  __shared__ __align__(16) E q_tile[kTile * kPitch];
  __shared__ __align__(16) E do_tile[kTile * kPitch];
  __shared__ float2 stat_tile[kTile];  // (LSE in log2 units, delta) of each query

  const int bh = blockIdx.x / p.n_tiles;
  const int kt = blockIdx.x - bh * p.n_tiles;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int part = lane % S;                         // which kDims of each row
  const int quad = (lane / S) & (flash::kQuad - 1);  // which queries of each tile
  const int key0 = warp * kWarpKeys + (lane / (flash::kQuad * S)) * R;  // lane's keys: key0 + r
  const int seq = p.seq;
  const int k0 = kt * kKeys;
  const bool vec = p.vec;
  const int64_t stat = static_cast<int64_t>(bh) * seq;

  flash::stage_rows<T, D, kPitch, kKeys, flash::kQuadThreads>(
      k_tile, row_ptr<T>(p.k, p.k_st, b, 0, h, 0), p.k_st.s, k0, seq, vec);
  flash::stage_rows<T, D, kPitch, kKeys, flash::kQuadThreads>(
      v_tile, row_ptr<T>(p.v, p.v_st, b, 0, h, 0), p.v_st.s, k0, seq, vec);
  const T* q_head = row_ptr<T>(p.q, p.q_st, b, 0, h, 0);
  const T* do_head = row_ptr<T>(p.d_out, p.do_st, b, 0, h, 0);
  // causal: queries before the block's first key see none of its keys, and
  // queries before the warp's first key none of the warp's (all lanes of a
  // warp walk the same queries)
  const int q_begin = p.causal ? k0 : 0;
  const int warp_q_first = p.causal ? k0 + warp * kWarpKeys : 0;

  const float k_scale = p.sm_scale * flash::kLog2e;  // scores in log2 units
  float kr[R][kDims];
  float vr[R][kDims];
  float dk[R][kDims];
  float dv[R][kDims];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int d = 0; d < kDims; ++d) {
      dk[r][d] = 0.f;
      dv[r][d] = 0.f;
    }
  }

  for (int q0 = q_begin; q0 < seq; q0 += kTile) {
    if (q0 > q_begin) __syncthreads();  // every warp is done with the previous tile
    flash::stage_rows<T, D, kPitch, kTile, flash::kQuadThreads>(q_tile, q_head, p.q_st.s, q0, seq, vec);
    flash::stage_rows<T, D, kPitch, kTile, flash::kQuadThreads>(do_tile, do_head, p.do_st.s, q0, seq,
                                                          vec);
    for (int i = threadIdx.x; i < kTile; i += flash::kQuadThreads) {
      const int qp = q0 + i;
      stat_tile[i] = qp < seq ? make_float2(p.lse[stat + qp] * flash::kLog2e, p.delta[stat + qp])
                              : make_float2(0.f, 0.f);
    }
    if (vec) flash::cp_async_wait_all();
    __syncthreads();
    if (q0 == q_begin) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int d = 0; d < kDims; d += 4) {
          const int at = (key0 + r) * kPitch + part * kDims + d;
          const float4 kv = flash::load4(k_tile + at);
          const float4 vv = flash::load4(v_tile + at);
          kr[r][d] = kv.x * k_scale;
          kr[r][d + 1] = kv.y * k_scale;
          kr[r][d + 2] = kv.z * k_scale;
          kr[r][d + 3] = kv.w * k_scale;
          vr[r][d] = vv.x;
          vr[r][d + 1] = vv.y;
          vr[r][d + 2] = vv.z;
          vr[r][d + 3] = vv.w;
        }
      }
    }
    // queries quad + 4t of the tile, t in [t_begin, t_end) (uniform across the warp)
    const int t_begin = max(0, warp_q_first - q0) / flash::kQuad;
    const int t_end = min(flash::kPerLane, (seq - q0 + flash::kQuad - 1) / flash::kQuad);
#pragma unroll 2
    for (int t = t_begin; t < t_end; ++t) {
      const int i = quad + t * flash::kQuad;
      const E* q_row = q_tile + i * kPitch + part * kDims;
      const E* do_row = do_tile + i * kPitch + part * kDims;
      float4 qv[kDims / 4];
      float4 ov[kDims / 4];
#pragma unroll
      for (int c = 0; c < kDims / 4; ++c) {
        qv[c] = flash::load4(q_row + 4 * c);
        ov[c] = flash::load4(do_row + 4 * c);
      }
      const float2 st = stat_tile[i];
      const int qp = q0 + i;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f);
        float4 dp4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int c = 0; c < kDims / 4; ++c) {
          s4.x = fmaf(qv[c].x, kr[r][4 * c], s4.x);
          s4.y = fmaf(qv[c].y, kr[r][4 * c + 1], s4.y);
          s4.z = fmaf(qv[c].z, kr[r][4 * c + 2], s4.z);
          s4.w = fmaf(qv[c].w, kr[r][4 * c + 3], s4.w);
          dp4.x = fmaf(ov[c].x, vr[r][4 * c], dp4.x);
          dp4.y = fmaf(ov[c].y, vr[r][4 * c + 1], dp4.y);
          dp4.z = fmaf(ov[c].z, vr[r][4 * c + 2], dp4.z);
          dp4.w = fmaf(ov[c].w, vr[r][4 * c + 3], dp4.w);
        }
        const float score = flash::dim_sum<S>((s4.x + s4.y) + (s4.z + s4.w));
        const float dp = flash::dim_sum<S>((dp4.x + dp4.y) + (dp4.z + dp4.w));
        const bool keep = qp < seq && (!p.causal || k0 + key0 + r <= qp);
        const float prob = keep ? exp2f(score - st.x) : 0.f;
        const float ds = prob * (dp - st.y);
#pragma unroll
        for (int c = 0; c < kDims / 4; ++c) {
          dv[r][4 * c] = fmaf(prob, ov[c].x, dv[r][4 * c]);
          dv[r][4 * c + 1] = fmaf(prob, ov[c].y, dv[r][4 * c + 1]);
          dv[r][4 * c + 2] = fmaf(prob, ov[c].z, dv[r][4 * c + 2]);
          dv[r][4 * c + 3] = fmaf(prob, ov[c].w, dv[r][4 * c + 3]);
          dk[r][4 * c] = fmaf(ds, qv[c].x, dk[r][4 * c]);
          dk[r][4 * c + 1] = fmaf(ds, qv[c].y, dk[r][4 * c + 1]);
          dk[r][4 * c + 2] = fmaf(ds, qv[c].z, dk[r][4 * c + 2]);
          dk[r][4 * c + 3] = fmaf(ds, qv[c].w, dk[r][4 * c + 3]);
        }
      }
    }
  }

  // merge the quad: a quarter of the lane's dims of each key row per lane
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float dk_out[kDims / 4];
    float dv_out[kDims / 4];
    flash::quad_reduce_scatter<kDims, S>(dk[r], dk_out, quad);
    flash::quad_reduce_scatter<kDims, S>(dv[r], dv_out, quad);
    const int kpos = k0 + key0 + r;
    if (kpos < seq) {
      const int d0 = part * kDims + quad * (kDims / 4);
      flash::store_row<T, kDims / 4>(row_ptr<T>(p.dk, p.dk_st, b, kpos, h, d0), dk_out,
                                     p.sm_scale, vec);
      flash::store_row<T, kDims / 4>(row_ptr<T>(p.dv, p.dv_st, b, kpos, h, d0), dv_out, 1.f,
                                     vec);
    }
  }
}

// The dk/dv quad layout at head_dim 64, 128 and 256, with more of the work in
// flight: kWarps warps a block, the lane's k and v rows loaded straight
// into registers, and q, dO, LSE and delta tiles of kTile queries staged
// through a two-stage ring in dynamic shared memory, so the copies of
// tile t + 1 run under the math on tile t.
template <typename T, int D, int R, int S, int kWarps, int kTile, int kMinBlocks>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
    flash_bwd_dkv_wide_kernel(const Params p) {
  using E = flash::staged_t<T>;
  constexpr int kThreads = kWarps * 32;
  constexpr int kDims = D / S;  // head dims a lane holds
  constexpr int kWarpKeys = R * (32 / (flash::kQuad * S));
  constexpr int kKeys = flash::quad_rows<R, S, kWarps>();
  constexpr int kPitch = D + 16 / sizeof(E);  // padded row: 16-byte aligned, no bank conflicts
  constexpr int kStage = kTile * kPitch;      // elements of one staged tile
  constexpr int kLaneQueries = kTile / flash::kQuad;  // queries a lane walks per tile
  extern __shared__ __align__(16) unsigned char smem[];
  E* q_ring = reinterpret_cast<E*>(smem);  // [2][kStage]
  E* do_ring = q_ring + 2 * kStage;        // [2][kStage]
  float* lse_ring = reinterpret_cast<float*>(do_ring + 2 * kStage);  // [2][kTile]
  float* delta_ring = lse_ring + 2 * kTile;                          // [2][kTile]

  // key tiles first to last across all heads: causal launches start with
  // their longest query walks
  const int kt = blockIdx.x / p.batch_heads;
  const int bh = blockIdx.x - kt * p.batch_heads;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int part = lane % S;                         // which kDims of each row
  const int quad = (lane / S) & (flash::kQuad - 1);  // which queries of each tile
  const int key0 = warp * kWarpKeys + (lane / (flash::kQuad * S)) * R;  // lane's keys: key0 + r
  const int seq = p.seq;
  const int k0 = kt * kKeys;
  const bool vec = p.vec;
  const int64_t stat = static_cast<int64_t>(bh) * seq;
  const T* q_head = row_ptr<T>(p.q, p.q_st, b, 0, h, 0);
  const T* do_head = row_ptr<T>(p.d_out, p.do_st, b, 0, h, 0);
  // causal: queries before the block's first key see none of its keys, and
  // queries before the warp's first key none of the warp's (all lanes of a
  // warp walk the same queries)
  const int q_begin = p.causal ? k0 : 0;
  const int warp_q_first = p.causal ? k0 + warp * kWarpKeys : 0;
  const int n_tiles = (seq - q_begin + kTile - 1) / kTile;

  // stage the query tile at q0 (past the sequence end: zeros) into ring stage `s`
  auto stage = [&](int q0, int s) {
    flash::stage_rows<T, D, kPitch, kTile, kThreads>(q_ring + s * kStage, q_head, p.q_st.s, q0,
                                                     seq, vec);
    flash::stage_rows<T, D, kPitch, kTile, kThreads>(do_ring + s * kStage, do_head, p.do_st.s,
                                                     q0, seq, vec);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const int qp = q0 + i;
      if (qp < seq) {
        flash::cp_async4(lse_ring + s * kTile + i, p.lse + stat + qp);
        flash::cp_async4(delta_ring + s * kTile + i, p.delta + stat + qp);
      } else {
        lse_ring[s * kTile + i] = 0.f;
        delta_ring[s * kTile + i] = 0.f;
      }
    }
    flash::cp_async_commit();
  };
  stage(q_begin, 0);

  // the lane's k (prescaled: scores in log2 units) and v rows; keys past
  // the sequence end compute on a clamped copy and store nothing
  const float k_scale = p.sm_scale * flash::kLog2e;
  float kr[R][kDims];
  float vr[R][kDims];
  float dk[R][kDims];
  float dv[R][kDims];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int kc = min(k0 + key0 + r, seq - 1);
    flash::load_row<T, kDims>(row_ptr<T>(p.k, p.k_st, b, kc, h, part * kDims), kr[r], vec);
    flash::load_row<T, kDims>(row_ptr<T>(p.v, p.v_st, b, kc, h, part * kDims), vr[r], vec);
#pragma unroll
    for (int d = 0; d < kDims; ++d) {
      kr[r][d] *= k_scale;
      dk[r][d] = 0.f;
      dv[r][d] = 0.f;
    }
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = q_begin + t * kTile;
    if (t + 1 < n_tiles) {
      stage(q0 + kTile, (t + 1) & 1);  // the next tile into the other stage
    } else {
      flash::cp_async_commit();
    }
    flash::cp_async_wait<1>();  // tile t has landed
    __syncthreads();
    const E* q_tile = q_ring + (t & 1) * kStage;
    const E* do_tile = do_ring + (t & 1) * kStage;
    const float* lse_tile = lse_ring + (t & 1) * kTile;
    const float* delta_tile = delta_ring + (t & 1) * kTile;
    // queries quad + 4u of the tile, u in [u_begin, u_end) (uniform across the warp)
    const int u_begin = max(0, warp_q_first - q0) / flash::kQuad;
    const int u_end = min(kLaneQueries, (seq - q0 + flash::kQuad - 1) / flash::kQuad);
#pragma unroll 2
    for (int u = u_begin; u < u_end; ++u) {
      const int i = quad + u * flash::kQuad;
      const E* q_row = q_tile + i * kPitch + part * kDims;
      const E* do_row = do_tile + i * kPitch + part * kDims;
      float4 qv[kDims / 4];
      float4 ov[kDims / 4];
#pragma unroll
      for (int c = 0; c < kDims / 4; ++c) {
        qv[c] = flash::load4(q_row + 4 * c);
        ov[c] = flash::load4(do_row + 4 * c);
      }
      const float lse2 = lse_tile[i] * flash::kLog2e;
      const float delta = delta_tile[i];
      const int qp = q0 + i;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f);
        float4 dp4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int c = 0; c < kDims / 4; ++c) {
          s4.x = fmaf(qv[c].x, kr[r][4 * c], s4.x);
          s4.y = fmaf(qv[c].y, kr[r][4 * c + 1], s4.y);
          s4.z = fmaf(qv[c].z, kr[r][4 * c + 2], s4.z);
          s4.w = fmaf(qv[c].w, kr[r][4 * c + 3], s4.w);
          dp4.x = fmaf(ov[c].x, vr[r][4 * c], dp4.x);
          dp4.y = fmaf(ov[c].y, vr[r][4 * c + 1], dp4.y);
          dp4.z = fmaf(ov[c].z, vr[r][4 * c + 2], dp4.z);
          dp4.w = fmaf(ov[c].w, vr[r][4 * c + 3], dp4.w);
        }
        const float score = flash::dim_sum<S>((s4.x + s4.y) + (s4.z + s4.w));
        const float dp = flash::dim_sum<S>((dp4.x + dp4.y) + (dp4.z + dp4.w));
        const bool keep = qp < seq && (!p.causal || k0 + key0 + r <= qp);
        const float prob = keep ? exp2f(score - lse2) : 0.f;
        const float ds = prob * (dp - delta);
#pragma unroll
        for (int c = 0; c < kDims / 4; ++c) {
          dv[r][4 * c] = fmaf(prob, ov[c].x, dv[r][4 * c]);
          dv[r][4 * c + 1] = fmaf(prob, ov[c].y, dv[r][4 * c + 1]);
          dv[r][4 * c + 2] = fmaf(prob, ov[c].z, dv[r][4 * c + 2]);
          dv[r][4 * c + 3] = fmaf(prob, ov[c].w, dv[r][4 * c + 3]);
          dk[r][4 * c] = fmaf(ds, qv[c].x, dk[r][4 * c]);
          dk[r][4 * c + 1] = fmaf(ds, qv[c].y, dk[r][4 * c + 1]);
          dk[r][4 * c + 2] = fmaf(ds, qv[c].z, dk[r][4 * c + 2]);
          dk[r][4 * c + 3] = fmaf(ds, qv[c].w, dk[r][4 * c + 3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // merge the quad: a quarter of the lane's dims of each key row per lane
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float dk_out[kDims / 4];
    float dv_out[kDims / 4];
    flash::quad_reduce_scatter<kDims, S>(dk[r], dk_out, quad);
    flash::quad_reduce_scatter<kDims, S>(dv[r], dv_out, quad);
    const int kpos = k0 + key0 + r;
    if (kpos < seq) {
      const int d0 = part * kDims + quad * (kDims / 4);
      flash::store_row<T, kDims / 4>(row_ptr<T>(p.dk, p.dk_st, b, kpos, h, d0), dk_out,
                                     p.sm_scale, vec);
      flash::store_row<T, kDims / 4>(row_ptr<T>(p.dv, p.dv_st, b, kpos, h, d0), dv_out, 1.f,
                                     vec);
    }
  }
}

template <typename T, int D, int R, int S, int kMinBlocks>
__global__ void __launch_bounds__(flash::kQuadThreads, kMinBlocks)
    flash_bwd_dq_quad_kernel(const Params p) {
  using E = flash::staged_t<T>;
  constexpr int kDims = D / S;  // head dims a lane holds
  constexpr int kWarpRows = R * (32 / (flash::kQuad * S));
  constexpr int kRows = flash::quad_rows<R, S>();
  constexpr int kPitch = D + 16 / sizeof(E);  // padded row: 16-byte aligned, no bank conflicts
  constexpr int kTile = flash::kPartnerTile;
  __shared__ __align__(16) E k_tile[kTile * kPitch];
  __shared__ __align__(16) E v_tile[kTile * kPitch];

  const int bh = blockIdx.x / p.n_tiles;
  const int qt = blockIdx.x - bh * p.n_tiles;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int part = lane % S;                         // which kDims of each row
  const int quad = (lane / S) & (flash::kQuad - 1);  // which keys of each tile
  const int q0 = qt * kRows;
  // the lane's rows: row0 + r
  const int row0 = q0 + warp * kWarpRows + (lane / (flash::kQuad * S)) * R;
  const int seq = p.seq;
  const bool vec = p.vec;
  const float q_scale = p.sm_scale * flash::kLog2e;  // scores in log2 units
  const int64_t stat = static_cast<int64_t>(bh) * seq;
  // keys the block needs, and keys the warp's rows need: all lanes of a
  // warp walk the same keys, so causal work above a warp's rows is skipped
  const int k_end = p.causal ? min(seq, q0 + kRows) : seq;
  const int warp_k_end = p.causal ? min(seq, q0 + warp * kWarpRows + kWarpRows) : seq;
  const T* k_head = row_ptr<T>(p.k, p.k_st, b, 0, h, 0);
  const T* v_head = row_ptr<T>(p.v, p.v_st, b, 0, h, 0);

  flash::stage_rows<T, D, kPitch, kTile, flash::kQuadThreads>(k_tile, k_head, p.k_st.s, 0, k_end,
                                                              vec);
  flash::stage_rows<T, D, kPitch, kTile, flash::kQuadThreads>(v_tile, v_head, p.v_st.s, 0, k_end,
                                                              vec);

  // q (prescaled), dO, the row's LSE in log2 units and delta = rowsum(dO * O);
  // rows past the sequence end compute on a clamped copy and store nothing
  float qr[R][kDims];
  float dor[R][kDims];
  float acc[R][kDims];
  float lse2[R];
  float delta[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qc = min(row0 + r, seq - 1);
    const int d0 = part * kDims;
    float orow[kDims];
    flash::load_row<T, kDims>(row_ptr<T>(p.q, p.q_st, b, qc, h, d0), qr[r], vec);
    flash::load_row<T, kDims>(row_ptr<T>(p.d_out, p.do_st, b, qc, h, d0), dor[r], vec);
    flash::load_row<T, kDims>(row_ptr<T>(p.out, p.o_st, b, qc, h, d0), orow, vec);
    float dot = 0.f;
#pragma unroll
    for (int d = 0; d < kDims; ++d) {
      dot = fmaf(dor[r][d], orow[d], dot);
      qr[r][d] *= q_scale;
      acc[r][d] = 0.f;
    }
    delta[r] = flash::dim_sum<S>(dot);
    lse2[r] = p.lse[stat + qc] * flash::kLog2e;
    if (quad == 0 && part == 0 && row0 + r < seq) p.delta[stat + row0 + r] = delta[r];
  }

  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    if (k0 > 0) {
      __syncthreads();  // every warp is done with the previous tile
      flash::stage_rows<T, D, kPitch, kTile, flash::kQuadThreads>(k_tile, k_head, p.k_st.s, k0,
                                                                  k_end, vec);
      flash::stage_rows<T, D, kPitch, kTile, flash::kQuadThreads>(v_tile, v_head, p.v_st.s, k0,
                                                                  k_end, vec);
    }
    if (vec) flash::cp_async_wait_all();
    __syncthreads();
    // keys quad + 4t of the tile, t < n (uniform across the warp)
    const int n = min(flash::kPerLane, (warp_k_end - k0 + flash::kQuad - 1) / flash::kQuad);
#pragma unroll 2
    for (int t = 0; t < n; ++t) {
      const int j = quad + t * flash::kQuad;
      const int kpos = k0 + j;
      // dO.v first and k after, so only one of the two rows is live at a time
      float dp[R];
      {
        const E* v_row = v_tile + j * kPitch + part * kDims;
        float4 vv[kDims / 4];
#pragma unroll
        for (int c = 0; c < kDims / 4; ++c) vv[c] = flash::load4(v_row + 4 * c);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float4 dp4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int c = 0; c < kDims / 4; ++c) {
            dp4.x = fmaf(dor[r][4 * c], vv[c].x, dp4.x);
            dp4.y = fmaf(dor[r][4 * c + 1], vv[c].y, dp4.y);
            dp4.z = fmaf(dor[r][4 * c + 2], vv[c].z, dp4.z);
            dp4.w = fmaf(dor[r][4 * c + 3], vv[c].w, dp4.w);
          }
          dp[r] = flash::dim_sum<S>((dp4.x + dp4.y) + (dp4.z + dp4.w));
        }
      }
      const E* k_row = k_tile + j * kPitch + part * kDims;
      float4 kv[kDims / 4];
#pragma unroll
      for (int c = 0; c < kDims / 4; ++c) kv[c] = flash::load4(k_row + 4 * c);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int c = 0; c < kDims / 4; ++c) {
          s4.x = fmaf(qr[r][4 * c], kv[c].x, s4.x);
          s4.y = fmaf(qr[r][4 * c + 1], kv[c].y, s4.y);
          s4.z = fmaf(qr[r][4 * c + 2], kv[c].z, s4.z);
          s4.w = fmaf(qr[r][4 * c + 3], kv[c].w, s4.w);
        }
        const float score = flash::dim_sum<S>((s4.x + s4.y) + (s4.z + s4.w));
        const bool keep = kpos < seq && (!p.causal || kpos <= row0 + r);
        const float ds = keep ? exp2f(score - lse2[r]) * (dp[r] - delta[r]) : 0.f;
#pragma unroll
        for (int c = 0; c < kDims / 4; ++c) {
          acc[r][4 * c] = fmaf(ds, kv[c].x, acc[r][4 * c]);
          acc[r][4 * c + 1] = fmaf(ds, kv[c].y, acc[r][4 * c + 1]);
          acc[r][4 * c + 2] = fmaf(ds, kv[c].z, acc[r][4 * c + 2]);
          acc[r][4 * c + 3] = fmaf(ds, kv[c].w, acc[r][4 * c + 3]);
        }
      }
    }
  }

  // merge the quad: a quarter of the lane's dims of each row per lane
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float dq_out[kDims / 4];
    flash::quad_reduce_scatter<kDims, S>(acc[r], dq_out, quad);
    if (row0 + r < seq) {
      const int d0 = part * kDims + quad * (kDims / 4);
      flash::store_row<T, kDims / 4>(row_ptr<T>(p.dq, p.dq_st, b, row0 + r, h, d0), dq_out,
                                     p.sm_scale, vec);
    }
  }
}

// dq at head_dim 64, 128 and 256: the quad layout on query rows with
// kWarps warps a block, the lane's q, dO and O rows loaded straight into
// registers, and key and value tiles of kTile rows staged through a
// two-stage ring in dynamic shared memory, so the copies of tile t + 1 run
// under the math on tile t. Split `split` of `n_splits` walks its run of
// the block's key tiles.
template <typename T, int D, int R, int S, int kWarps, int kTile, int kMinBlocks>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
    flash_bwd_dq_wide_kernel(const Params p) {
  using E = flash::staged_t<T>;
  constexpr int kThreads = kWarps * 32;
  constexpr int kDims = D / S;  // head dims a lane holds
  constexpr int kWarpRows = R * (32 / (flash::kQuad * S));
  constexpr int kRows = flash::quad_rows<R, S, kWarps>();
  constexpr int kPitch = D + 16 / sizeof(E);  // padded row: 16-byte aligned, no bank conflicts
  constexpr int kStage = kTile * kPitch;      // elements of one staged tile
  constexpr int kLaneKeys = kTile / flash::kQuad;  // keys a lane walks per tile
  extern __shared__ __align__(16) unsigned char smem[];
  E* k_ring = reinterpret_cast<E*>(smem);  // [2][kStage]
  E* v_ring = k_ring + 2 * kStage;         // [2][kStage]

  // block = (row tile, batch*head, key split), split fastest; the row
  // tiles run last to first across all heads, so causal launches start
  // with their longest key walks
  const int split = blockIdx.x % p.n_splits;
  const int tile = blockIdx.x / p.n_splits;
  const int bh = tile % p.batch_heads;
  const int qt = p.n_tiles - 1 - tile / p.batch_heads;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int part = lane % S;                         // which kDims of each row
  const int quad = (lane / S) & (flash::kQuad - 1);  // which keys of each tile
  const int q0 = qt * kRows;
  // the lane's rows: row0 + r
  const int row0 = q0 + warp * kWarpRows + (lane / (flash::kQuad * S)) * R;
  const int seq = p.seq;
  const bool vec = p.vec;
  const int64_t stat = static_cast<int64_t>(bh) * seq;
  const T* k_head = row_ptr<T>(p.k, p.k_st, b, 0, h, 0);
  const T* v_head = row_ptr<T>(p.v, p.v_st, b, 0, h, 0);
  // keys the block needs, and keys the warp's rows need: all lanes of a
  // warp walk the same keys, so causal work above a warp's rows is skipped
  const int k_end = p.causal ? min(seq, q0 + kRows) : seq;
  const int warp_k_end = p.causal ? min(seq, q0 + warp * kWarpRows + kWarpRows) : seq;
  // this split's run of the block's key tiles
  const int n_tiles = (k_end + kTile - 1) / kTile;
  const int split_tiles = (n_tiles + p.n_splits - 1) / p.n_splits;
  const int t_begin = min(n_tiles, split * split_tiles);
  const int t_end = min(n_tiles, t_begin + split_tiles);

  // stage the key tile at k0 into ring stage `s`
  auto stage = [&](int k0, int s) {
    flash::stage_rows<T, D, kPitch, kTile, kThreads>(k_ring + s * kStage, k_head, p.k_st.s, k0,
                                                     k_end, vec);
    flash::stage_rows<T, D, kPitch, kTile, kThreads>(v_ring + s * kStage, v_head, p.v_st.s, k0,
                                                     k_end, vec);
  };
  if (t_begin < t_end) stage(t_begin * kTile, t_begin & 1);
  flash::cp_async_commit();

  // q (prescaled), dO, the row's LSE in log2 units and delta = rowsum(dO * O);
  // rows past the sequence end compute on a clamped copy and store nothing
  const float q_scale = p.sm_scale * flash::kLog2e;
  float qr[R][kDims];
  float dor[R][kDims];
  float acc[R][kDims];
  float lse2[R];
  float delta[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qc = min(row0 + r, seq - 1);
    const int d0 = part * kDims;
    float orow[kDims];
    flash::load_row<T, kDims>(row_ptr<T>(p.q, p.q_st, b, qc, h, d0), qr[r], vec);
    flash::load_row<T, kDims>(row_ptr<T>(p.d_out, p.do_st, b, qc, h, d0), dor[r], vec);
    flash::load_row<T, kDims>(row_ptr<T>(p.out, p.o_st, b, qc, h, d0), orow, vec);
    float dot = 0.f;
#pragma unroll
    for (int d = 0; d < kDims; ++d) {
      dot = fmaf(dor[r][d], orow[d], dot);
      qr[r][d] *= q_scale;
      acc[r][d] = 0.f;
    }
    delta[r] = flash::dim_sum<S>(dot);
    lse2[r] = p.lse[stat + qc] * flash::kLog2e;
    if (split == 0 && quad == 0 && part == 0 && row0 + r < seq) {
      p.delta[stat + row0 + r] = delta[r];
    }
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kTile;
    if (t + 1 < t_end) stage(k0 + kTile, (t + 1) & 1);  // the next tile into the other stage
    flash::cp_async_commit();
    flash::cp_async_wait<1>();  // tile t has landed
    __syncthreads();
    const E* k_tile = k_ring + (t & 1) * kStage;
    const E* v_tile = v_ring + (t & 1) * kStage;
    // keys quad + 4i of the tile, i < n (uniform across the warp)
    const int n = min(kLaneKeys, (warp_k_end - k0 + flash::kQuad - 1) / flash::kQuad);
#pragma unroll 2
    for (int i = 0; i < n; ++i) {
      const int j = quad + i * flash::kQuad;
      const int kpos = k0 + j;
      // dO.v first and k after, so only one of the two rows is live at a time
      float dp[R];
      {
        const E* v_row = v_tile + j * kPitch + part * kDims;
        float4 vv[kDims / 4];
#pragma unroll
        for (int c = 0; c < kDims / 4; ++c) vv[c] = flash::load4(v_row + 4 * c);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float4 dp4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int c = 0; c < kDims / 4; ++c) {
            dp4.x = fmaf(dor[r][4 * c], vv[c].x, dp4.x);
            dp4.y = fmaf(dor[r][4 * c + 1], vv[c].y, dp4.y);
            dp4.z = fmaf(dor[r][4 * c + 2], vv[c].z, dp4.z);
            dp4.w = fmaf(dor[r][4 * c + 3], vv[c].w, dp4.w);
          }
          dp[r] = flash::dim_sum<S>((dp4.x + dp4.y) + (dp4.z + dp4.w));
        }
      }
      const E* k_row = k_tile + j * kPitch + part * kDims;
      float4 kv[kDims / 4];
#pragma unroll
      for (int c = 0; c < kDims / 4; ++c) kv[c] = flash::load4(k_row + 4 * c);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int c = 0; c < kDims / 4; ++c) {
          s4.x = fmaf(qr[r][4 * c], kv[c].x, s4.x);
          s4.y = fmaf(qr[r][4 * c + 1], kv[c].y, s4.y);
          s4.z = fmaf(qr[r][4 * c + 2], kv[c].z, s4.z);
          s4.w = fmaf(qr[r][4 * c + 3], kv[c].w, s4.w);
        }
        const float score = flash::dim_sum<S>((s4.x + s4.y) + (s4.z + s4.w));
        const bool keep = kpos < seq && (!p.causal || kpos <= row0 + r);
        const float ds = keep ? exp2f(score - lse2[r]) * (dp[r] - delta[r]) : 0.f;
#pragma unroll
        for (int c = 0; c < kDims / 4; ++c) {
          acc[r][4 * c] = fmaf(ds, kv[c].x, acc[r][4 * c]);
          acc[r][4 * c + 1] = fmaf(ds, kv[c].y, acc[r][4 * c + 1]);
          acc[r][4 * c + 2] = fmaf(ds, kv[c].z, acc[r][4 * c + 2]);
          acc[r][4 * c + 3] = fmaf(ds, kv[c].w, acc[r][4 * c + 3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // merge the quad: a quarter of the lane's dims of each row per lane; with
  // one split the row is done, else its partial row goes to the scratch
  // for flash_bwd_dq_merge_kernel
  const int64_t n_rows = static_cast<int64_t>(p.batch_heads) * seq;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float dq_out[kDims / 4];
    flash::quad_reduce_scatter<kDims, S>(acc[r], dq_out, quad);
    const int qpos = row0 + r;
    if (qpos >= seq) continue;
    const int d0 = part * kDims + quad * (kDims / 4);
    if (p.n_splits == 1) {
      flash::store_row<T, kDims / 4>(row_ptr<T>(p.dq, p.dq_st, b, qpos, h, d0), dq_out,
                                     p.sm_scale, vec);
    } else {
      flash::store_row<float, kDims / 4>(p.ws + (split * n_rows + stat + qpos) * D + d0, dq_out,
                                         1.f, true);
    }
  }
}

// Merge the key splits of the wide dq kernel: one warp per (batch*head,
// row) sums the splits' rows in split order and writes s * dq.
template <typename T, int D>
__global__ void __launch_bounds__(128) flash_bwd_dq_merge_kernel(const Params p) {
  constexpr int kLaneDims = D / 32;
  const int64_t n_rows = static_cast<int64_t>(p.batch_heads) * p.seq;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 4 + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int lane = threadIdx.x & 31;
  float acc[kLaneDims] = {};
  for (int s = 0; s < p.n_splits; ++s) {
    const float* part = p.ws + (s * n_rows + row) * D + lane * kLaneDims;
#pragma unroll
    for (int d = 0; d < kLaneDims; ++d) acc[d] += part[d];
  }
  const int bh = static_cast<int>(row / p.seq);
  const int qpos = static_cast<int>(row - static_cast<int64_t>(bh) * p.seq);
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  T* dq_row = row_ptr<T>(p.dq, p.dq_st, b, qpos, h, lane * kLaneDims);
#pragma unroll
  for (int d = 0; d < kLaneDims; ++d) dq_row[d] = from_float<T>(acc[d] * p.sm_scale);
}

// dk/dv in bfloat16 and float16 at head_dim 64 and 128 on the tensor
// cores: 4 warps of 16 key rows a block; q, dO, LSE and delta tiles of
// kTile queries through a two-stage cp.async ring; per tile Sᵀ = K Qᵀ and
// dPᵀ = V dOᵀ, then dV += Pᵀ dO and dK += dSᵀ Q, all by mma.sync.m16n8k16
// with float32 accumulators (see flash_mma.cuh); Pᵀ and dSᵀ rounded to T
// as A operands in place. kKeepKV: the warp's K and V fragments stay in
// registers for the whole walk, else they are read from shared memory for
// each tile (at head_dim 128 the registers go to dK and dV).
constexpr int kMmaWarps = 4;
constexpr int kMmaKeys = 16 * kMmaWarps;  // key rows a block owns

template <typename T, int D, int kTile, bool kKeepKV, int kMinBlocks>
__global__ void __launch_bounds__(kMmaWarps * 32, kMinBlocks)
    flash_bwd_dkv_mma_kernel(const Params p) {
  constexpr int kThreads = kMmaWarps * 32;
  constexpr int kPitch = D + 8;  // 16 bytes of padding a row: ldmatrix rows on distinct banks
  constexpr int kStage = kTile * kPitch;
  constexpr int kKChunks = D / 16;    // 16-wide steps over head_dim in Sᵀ and dPᵀ
  constexpr int kQTiles = kTile / 8;  // 8-query tiles of a staged tile
  constexpr int kDTiles = D / 8;      // 8-wide dK and dV tiles
  static_assert(kTile % 16 == 0 && D % 16 == 0, "whole 16 x 16 blocks");
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_tile = reinterpret_cast<T*>(smem);   // [kMmaKeys][kPitch]
  T* v_tile = k_tile + kMmaKeys * kPitch;   // [kMmaKeys][kPitch]
  T* q_ring = v_tile + kMmaKeys * kPitch;   // [2][kStage]
  T* do_ring = q_ring + 2 * kStage;         // [2][kStage]
  float* lse_ring = reinterpret_cast<float*>(do_ring + 2 * kStage);  // [2][kTile]
  float* delta_ring = lse_ring + 2 * kTile;                          // [2][kTile]

  // key tiles first to last across all heads: causal launches start with
  // their longest query walks
  const int kt = blockIdx.x / p.batch_heads;
  const int bh = blockIdx.x - kt * p.batch_heads;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // the lane's keys of the warp's 16: g and g + 8
  const int t4 = lane & 3;  // the lane's columns of each 8-wide tile: 2 t4, 2 t4 + 1
  const int seq = p.seq;
  const int k0 = kt * kMmaKeys;
  const int key_a = k0 + warp * 16 + g;
  const bool vec = p.vec;
  const int64_t stat = static_cast<int64_t>(bh) * seq;
  const T* q_head = row_ptr<T>(p.q, p.q_st, b, 0, h, 0);
  const T* do_head = row_ptr<T>(p.d_out, p.do_st, b, 0, h, 0);
  // causal: queries before the block's first key see none of its keys,
  // and a tile wholly before the warp's first key none of the warp's (a
  // warp-uniform skip)
  const int q_begin = p.causal ? k0 : 0;
  const int warp_q_first = p.causal ? k0 + warp * 16 : 0;
  const int n_tiles = (seq - q_begin + kTile - 1) / kTile;

  // stage the query tile at q0 (past the sequence end: zeros) into ring stage `s`
  auto stage = [&](int q0, int s) {
    flash::stage_rows<T, D, kPitch, kTile, kThreads>(q_ring + s * kStage, q_head, p.q_st.s, q0,
                                                     seq, vec);
    flash::stage_rows<T, D, kPitch, kTile, kThreads>(do_ring + s * kStage, do_head, p.do_st.s,
                                                     q0, seq, vec);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const int qp = q0 + i;
      if (qp < seq) {
        flash::cp_async4(lse_ring + s * kTile + i, p.lse + stat + qp);
        flash::cp_async4(delta_ring + s * kTile + i, p.delta + stat + qp);
      } else {
        lse_ring[s * kTile + i] = 0.f;
        delta_ring[s * kTile + i] = 0.f;
      }
    }
  };
  flash::stage_rows<T, D, kPitch, kMmaKeys, kThreads>(
      k_tile, row_ptr<T>(p.k, p.k_st, b, 0, h, 0), p.k_st.s, k0, seq, vec);
  flash::stage_rows<T, D, kPitch, kMmaKeys, kThreads>(
      v_tile, row_ptr<T>(p.v, p.v_st, b, 0, h, 0), p.v_st.s, k0, seq, vec);
  stage(q_begin, 0);
  flash::cp_async_commit();
  flash::cp_async_wait<0>();
  __syncthreads();
  uint32_t kf[kKeepKV ? kKChunks : 1][4];  // the warp's K and V rows as A fragments
  uint32_t vf[kKeepKV ? kKChunks : 1][4];
  if constexpr (kKeepKV) {
#pragma unroll
    for (int kc = 0; kc < kKChunks; ++kc) {
      flash::ldmatrix_x4(kf[kc], flash::a_rows(k_tile, kPitch, warp * 16, kc * 16, lane));
      flash::ldmatrix_x4(vf[kc], flash::a_rows(v_tile, kPitch, warp * 16, kc * 16, lane));
    }
  }

  const float scale_log2 = p.sm_scale * flash::kLog2e;  // scores in log2 units
  float dk[kDTiles][4];
  float dv[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = q_begin + t * kTile;
    if (t + 1 < n_tiles) stage(q0 + kTile, (t + 1) & 1);  // the next tile into the other stage
    flash::cp_async_commit();
    flash::cp_async_wait<1>();  // tile t has landed
    __syncthreads();
    const T* q_tile = q_ring + (t & 1) * kStage;
    const T* do_tile = do_ring + (t & 1) * kStage;
    const float* lse_tile = lse_ring + (t & 1) * kTile;
    const float* delta_tile = delta_ring + (t & 1) * kTile;
    if (q0 + kTile > warp_q_first) {
      // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ, 16 keys x kTile queries each
      float st[kQTiles][4];
      float dpt[kQTiles][4];
#pragma unroll
      for (int j = 0; j < kQTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
      }
#pragma unroll
      for (int kc = 0; kc < kKChunks; ++kc) {
        uint32_t ka[4];
        uint32_t va[4];
        if constexpr (kKeepKV) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ka[i] = kf[kc][i];
            va[i] = vf[kc][i];
          }
        } else {
          flash::ldmatrix_x4(ka, flash::a_rows(k_tile, kPitch, warp * 16, kc * 16, lane));
          flash::ldmatrix_x4(va, flash::a_rows(v_tile, kPitch, warp * 16, kc * 16, lane));
        }
#pragma unroll
        for (int np = 0; np < kQTiles / 2; ++np) {
          uint32_t qb[4];
          flash::ldmatrix_x4(qb, flash::b_rows(q_tile, kPitch, np * 16, kc * 16, lane));
          flash::mma_16816<T>(st[2 * np], ka, qb[0], qb[1]);
          flash::mma_16816<T>(st[2 * np + 1], ka, qb[2], qb[3]);
          uint32_t ob[4];
          flash::ldmatrix_x4(ob, flash::b_rows(do_tile, kPitch, np * 16, kc * 16, lane));
          flash::mma_16816<T>(dpt[2 * np], va, ob[0], ob[1]);
          flash::mma_16816<T>(dpt[2 * np + 1], va, ob[2], ob[3]);
        }
      }
      // Pᵀ = exp2(Sᵀ - LSE) where the mask keeps the pair, dSᵀ = Pᵀ (dPᵀ - delta)
#pragma unroll
      for (int j = 0; j < kQTiles; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qi = 8 * j + 2 * t4 + c;
          const int qpos = q0 + qi;
          const float lse2 = lse_tile[qi] * flash::kLog2e;
          const float delta = delta_tile[qi];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 2 * r + c;
            const bool keep = qpos < seq && (!p.causal || key_a + 8 * r <= qpos);
            const float pt = keep ? flash::exp2_approx(st[j][e] * scale_log2 - lse2) : 0.f;
            dpt[j][e] = pt * (dpt[j][e] - delta);
            st[j][e] = pt;
          }
        }
      }
      // dV += Pᵀ dO and dK += dSᵀ Q, Pᵀ and dSᵀ in place as A operands,
      // each split into two terms of T (head + tail)
#pragma unroll
      for (int kc = 0; kc < kTile / 16; ++kc) {
        uint32_t ph[4];
        uint32_t pt[4];
        uint32_t dh[4];
        uint32_t dt[4];
        flash::split_a<T>(ph, pt, st[2 * kc], st[2 * kc + 1]);
        flash::split_a<T>(dh, dt, dpt[2 * kc], dpt[2 * kc + 1]);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t ob[4];
          flash::ldmatrix_x4_trans(ob, flash::bt_rows(do_tile, kPitch, kc * 16, dp * 16, lane));
          flash::mma_16816<T>(dv[2 * dp], ph, ob[0], ob[1]);
          flash::mma_16816<T>(dv[2 * dp + 1], ph, ob[2], ob[3]);
          flash::mma_16816<T>(dv[2 * dp], pt, ob[0], ob[1]);
          flash::mma_16816<T>(dv[2 * dp + 1], pt, ob[2], ob[3]);
          uint32_t qb[4];
          flash::ldmatrix_x4_trans(qb, flash::bt_rows(q_tile, kPitch, kc * 16, dp * 16, lane));
          flash::mma_16816<T>(dk[2 * dp], dh, qb[0], qb[1]);
          flash::mma_16816<T>(dk[2 * dp + 1], dh, qb[2], qb[3]);
          flash::mma_16816<T>(dk[2 * dp], dt, qb[0], qb[1]);
          flash::mma_16816<T>(dk[2 * dp + 1], dt, qb[2], qb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // each lane stores two columns of each 8-wide tile of its two key rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = key_a + 8 * r;
    if (kpos >= seq) continue;
    T* dk_row = row_ptr<T>(p.dk, p.dk_st, b, kpos, h, 0);
    T* dv_row = row_ptr<T>(p.dv, p.dv_st, b, kpos, h, 0);
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      const int col = dt * 8 + 2 * t4;
      const float k0v = dk[dt][2 * r] * p.sm_scale;
      const float k1v = dk[dt][2 * r + 1] * p.sm_scale;
      if (vec) {
        *reinterpret_cast<uint32_t*>(dk_row + col) = flash::pack2<T>(k0v, k1v);
        *reinterpret_cast<uint32_t*>(dv_row + col) =
            flash::pack2<T>(dv[dt][2 * r], dv[dt][2 * r + 1]);
      } else {
        dk_row[col] = from_float<T>(k0v);
        dk_row[col + 1] = from_float<T>(k1v);
        dv_row[col] = from_float<T>(dv[dt][2 * r]);
        dv_row[col + 1] = from_float<T>(dv[dt][2 * r + 1]);
      }
    }
  }
}

// dq in bfloat16 and float16 at head_dim 64 and 128 on the tensor cores:
// 4 warps of 16 query rows a block, key and value tiles of kTile keys
// through a two-stage cp.async ring; per tile S = Q Kᵀ and dP = dO Vᵀ,
// then dQ += dS K, all by mma.sync.m16n8k16 with float32 accumulators
// (see flash_mma.cuh); the warp's Q and dO fragments stay in registers for
// the whole walk, and dS is the A operand in place, rounded once to T.
// Split `split` of `n_splits` walks its run of the block's key tiles, as
// in flash_bwd_dq_wide_kernel, whose partial rows its splits write.
constexpr int kMmaRows = 16 * kMmaWarps;  // query rows a dq block owns

template <typename T, int D, int kTile, int kMinBlocks>
__global__ void __launch_bounds__(kMmaWarps * 32, kMinBlocks)
    flash_bwd_dq_mma_kernel(const Params p) {
  constexpr int kThreads = kMmaWarps * 32;
  constexpr int kPitch = D + 8;  // 16 bytes of padding a row: ldmatrix rows on distinct banks
  constexpr int kStage = kTile * kPitch;
  constexpr int kKChunks = D / 16;    // 16-wide steps over head_dim in S and dP
  constexpr int kNTiles = kTile / 8;  // 8-key tiles of a staged tile
  constexpr int kDTiles = D / 8;      // 8-wide dQ tiles
  static_assert(kTile % 16 == 0 && D % 16 == 0, "whole 16 x 16 blocks");
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_tile = reinterpret_cast<T*>(smem);   // [kMmaRows][kPitch]
  T* do_tile = q_tile + kMmaRows * kPitch;  // [kMmaRows][kPitch]
  T* k_ring = do_tile + kMmaRows * kPitch;  // [2][kStage]
  T* v_ring = k_ring + 2 * kStage;          // [2][kStage]

  // block = (row tile, batch*head, key split), split fastest; row tiles
  // last to first across all heads (causal launches start with their
  // longest key walks)
  const int split = blockIdx.x % p.n_splits;
  const int tile = blockIdx.x / p.n_splits;
  const int bh = tile % p.batch_heads;
  const int qt = p.n_tiles - 1 - tile / p.batch_heads;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // the lane's rows of the warp's 16: g and g + 8
  const int t4 = lane & 3;  // the lane's columns of each 8-wide tile: 2 t4, 2 t4 + 1
  const int seq = p.seq;
  const int q0 = qt * kMmaRows;
  const int row_a = q0 + warp * 16 + g;
  const bool vec = p.vec;
  const int64_t stat = static_cast<int64_t>(bh) * seq;
  const T* k_head = row_ptr<T>(p.k, p.k_st, b, 0, h, 0);
  const T* v_head = row_ptr<T>(p.v, p.v_st, b, 0, h, 0);
  // keys the block needs, and keys the warp's rows need (a causal warp
  // skips the tiles past its last row, a warp-uniform branch)
  const int k_end = p.causal ? min(seq, q0 + kMmaRows) : seq;
  const int warp_k_end = p.causal ? min(seq, q0 + warp * 16 + 16) : seq;
  // this split's run of the block's key tiles
  const int n_tiles = (k_end + kTile - 1) / kTile;
  const int split_tiles = (n_tiles + p.n_splits - 1) / p.n_splits;
  const int t_begin = min(n_tiles, split * split_tiles);
  const int t_end = min(n_tiles, t_begin + split_tiles);

  auto stage = [&](int t) {
    flash::stage_rows<T, D, kPitch, kTile, kThreads>(k_ring + (t & 1) * kStage, k_head, p.k_st.s,
                                                     t * kTile, k_end, vec);
    flash::stage_rows<T, D, kPitch, kTile, kThreads>(v_ring + (t & 1) * kStage, v_head, p.v_st.s,
                                                     t * kTile, k_end, vec);
  };
  // the block's q and dO rows (past the sequence end: zeros)
  flash::stage_rows<T, D, kPitch, kMmaRows, kThreads>(
      q_tile, row_ptr<T>(p.q, p.q_st, b, 0, h, 0), p.q_st.s, q0, seq, vec);
  flash::stage_rows<T, D, kPitch, kMmaRows, kThreads>(
      do_tile, row_ptr<T>(p.d_out, p.do_st, b, 0, h, 0), p.do_st.s, q0, seq, vec);
  if (t_begin < t_end) stage(t_begin);
  flash::cp_async_commit();
  flash::cp_async_wait<0>();
  __syncthreads();

  // delta = rowsum(dO * O) in float32, two lanes a row (lane 2r + half
  // sums half the dims of the warp's row r), written once per row; then
  // each lane takes its rows g and g + 8, with their LSE in log2 units
  float delta[2];
  float lse2[2];
  {
    const int r = warp * 16 + (lane >> 1);
    const int half = lane & 1;
    const int qc = min(q0 + r, seq - 1);
    const T* o_row = row_ptr<T>(p.out, p.o_st, b, qc, h, half * (D / 2));
    const T* d_row = do_tile + r * kPitch + half * (D / 2);
    float dot = 0.f;
#pragma unroll
    for (int d = 0; d < D / 2; d += 8) {
      float ov[8];
      float dv[8];
      flash::load_row<T, 8>(o_row + d, ov, vec);
      flash::load_row<T, 8>(d_row + d, dv, true);
#pragma unroll
      for (int e = 0; e < 8; ++e) dot = fmaf(dv[e], ov[e], dot);
    }
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    if (split == 0 && half == 0 && q0 + r < seq) p.delta[stat + q0 + r] = dot;
    delta[0] = __shfl_sync(0xffffffffu, dot, 2 * g);
    delta[1] = __shfl_sync(0xffffffffu, dot, 2 * g + 16);
#pragma unroll
    for (int i = 0; i < 2; ++i) lse2[i] = p.lse[stat + min(row_a + 8 * i, seq - 1)] * flash::kLog2e;
  }
  uint32_t qa[kKChunks][4];  // the warp's Q and dO rows as A fragments, loaded once
  uint32_t da[kKChunks][4];
#pragma unroll
  for (int kc = 0; kc < kKChunks; ++kc) {
    flash::ldmatrix_x4(qa[kc], flash::a_rows(q_tile, kPitch, warp * 16, kc * 16, lane));
    flash::ldmatrix_x4(da[kc], flash::a_rows(do_tile, kPitch, warp * 16, kc * 16, lane));
  }

  const float scale_log2 = p.sm_scale * flash::kLog2e;  // scores in log2 units
  float dq[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kTile;
    if (t + 1 < t_end) stage(t + 1);  // the next tile into the other stage
    flash::cp_async_commit();
    flash::cp_async_wait<1>();  // tile t has landed
    __syncthreads();
    const T* k_tile = k_ring + (t & 1) * kStage;
    const T* v_tile = v_ring + (t & 1) * kStage;
    if (k0 < warp_k_end) {
      // S = Q Kᵀ and dP = dO Vᵀ, 16 rows x kTile keys each
      float st[kNTiles][4];
      float dp[kNTiles][4];
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dp[j][e] = 0.f;
      }
#pragma unroll
      for (int kc = 0; kc < kKChunks; ++kc) {
#pragma unroll
        for (int np = 0; np < kNTiles / 2; ++np) {
          uint32_t kb[4];
          flash::ldmatrix_x4(kb, flash::b_rows(k_tile, kPitch, np * 16, kc * 16, lane));
          flash::mma_16816<T>(st[2 * np], qa[kc], kb[0], kb[1]);
          flash::mma_16816<T>(st[2 * np + 1], qa[kc], kb[2], kb[3]);
          uint32_t vb[4];
          flash::ldmatrix_x4(vb, flash::b_rows(v_tile, kPitch, np * 16, kc * 16, lane));
          flash::mma_16816<T>(dp[2 * np], da[kc], vb[0], vb[1]);
          flash::mma_16816<T>(dp[2 * np + 1], da[kc], vb[2], vb[3]);
        }
      }
      // P = exp2(S - LSE) where the mask keeps the pair (every pair of a
      // tile the mask keeps whole for the warp's rows), dS = P (dP - delta)
      const bool whole = k0 + kTile <= seq && (!p.causal || k0 + kTile <= q0 + warp * 16 + 1);
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float pr = flash::exp2_approx(st[j][e] * scale_log2 - lse2[r]);
          if (!whole) {
            const int kpos = k0 + 8 * j + 2 * t4 + (e & 1);
            const bool keep = kpos < seq && (!p.causal || kpos <= row_a + 8 * r);
            pr = keep ? pr : 0.f;
          }
          st[j][e] = pr * (dp[j][e] - delta[r]);
        }
      }
      // dQ += dS K: dS in place as the A operand, K by ldmatrix.trans
#pragma unroll
      for (int kc = 0; kc < kTile / 16; ++kc) {
        uint32_t ds[4];
        flash::pack_a<T>(ds, st[2 * kc], st[2 * kc + 1]);
#pragma unroll
        for (int dpi = 0; dpi < D / 16; ++dpi) {
          uint32_t kb[4];
          flash::ldmatrix_x4_trans(kb, flash::bt_rows(k_tile, kPitch, kc * 16, dpi * 16, lane));
          flash::mma_16816<T>(dq[2 * dpi], ds, kb[0], kb[1]);
          flash::mma_16816<T>(dq[2 * dpi + 1], ds, kb[2], kb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // each lane stores two columns of each 8-wide tile of its two rows: with
  // one split s * dq in T, else the unscaled float32 row to the scratch
  // for flash_bwd_dq_merge_kernel
  const int64_t n_rows = static_cast<int64_t>(p.batch_heads) * seq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row_a + 8 * r;
    if (qpos >= seq) continue;
    if (p.n_splits == 1) {
      T* dq_row = row_ptr<T>(p.dq, p.dq_st, b, qpos, h, 0);
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt) {
        const int col = dt * 8 + 2 * t4;
        const float x0 = dq[dt][2 * r] * p.sm_scale;
        const float x1 = dq[dt][2 * r + 1] * p.sm_scale;
        if (vec) {
          *reinterpret_cast<uint32_t*>(dq_row + col) = flash::pack2<T>(x0, x1);
        } else {
          dq_row[col] = from_float<T>(x0);
          dq_row[col + 1] = from_float<T>(x1);
        }
      }
    } else {
      float* ws_row = p.ws + (split * n_rows + stat + qpos) * D;
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt) {
        *reinterpret_cast<float2*>(ws_row + dt * 8 + 2 * t4) =
            make_float2(dq[dt][2 * r], dq[dt][2 * r + 1]);
      }
    }
  }
}

// dq at any head_dim above 256 (the width is a run-time argument): one warp
// a query row; each pair's two dot products (score, dO.v) summed over the
// lanes striding over the width, then by warp shuffles; key and value rows
// staged kRowTile at a time as float32. delta = rowsum(dO * O) is summed
// first and written for the dk/dv kernel. Up to flash::kMaxSharedRowDim
// (!kStream) the warp's q (prescaled), dO and float32 dq accumulator sit
// in shared memory and each partner tile is staged whole. Streamed, any
// width: the partner rows are staged kRowChunk columns at a time, first
// over every chunk for the dot products and then, last chunk first (it is
// still staged), over every chunk for dq += ds k; q and dO are read from
// their tensors and the accumulator is the row's slot of the caller's
// float32 scratch (p.ws, batch * heads * seq rows of D). A lane walks the
// same dims in the same order either way.
template <typename T, bool kStream>
__global__ void __launch_bounds__(flash::kRowThreads) flash_bwd_dq_rowwise_kernel(const Params p,
                                                                                  int D) {
  extern __shared__ __align__(16) float row_smem[];
  const int C = kStream ? flash::kRowChunk : D;  // columns of a staged partner chunk
  float* k_tile = row_smem;                      // [kRowTile][C]
  float* v_tile = k_tile + flash::kRowTile * C;  // [kRowTile][C]
  const int bh = blockIdx.x % p.batch_heads;
  const int qt = p.n_tiles - 1 - blockIdx.x / p.batch_heads;  // last to first
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int seq = p.seq;
  const int q0 = qt * flash::kRowWarps;
  const int qpos = q0 + warp;
  const int qc = min(qpos, seq - 1);  // a row past the end: a clamped copy, nothing stored
  const int64_t stat = static_cast<int64_t>(bh) * seq;
  const int k_end = p.causal ? min(seq, q0 + flash::kRowWarps) : seq;
  const T* k_head = row_ptr<T>(p.k, p.k_st, b, 0, h, 0);
  const T* v_head = row_ptr<T>(p.v, p.v_st, b, 0, h, 0);

  const float scale_log2 = p.sm_scale * flash::kLog2e;
  const T* q_src = row_ptr<T>(p.q, p.q_st, b, qc, h, 0);
  const T* do_src = row_ptr<T>(p.d_out, p.do_st, b, qc, h, 0);
  const T* o_src = row_ptr<T>(p.out, p.o_st, b, qc, h, 0);
  float* q_row = v_tile + flash::kRowTile * C + warp * D;  // unused when streamed
  float* do_row = q_row + flash::kRowWarps * D;
  // the warp's accumulator; streamed, a row past the end has none and adds nothing
  float* acc = kStream ? p.ws + (stat + qc) * D : do_row + flash::kRowWarps * D;
  const bool adds = !kStream || qpos < seq;
  float dot = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float dov = to_float(do_src[d]);
    dot = fmaf(dov, to_float(o_src[d]), dot);
    if constexpr (!kStream) {
      q_row[d] = to_float(q_src[d]) * scale_log2;
      do_row[d] = dov;
    }
    if (adds) acc[d] = 0.f;
  }
  const float delta = flash::warp_sum(dot);
  const float lse2 = p.lse[stat + qc] * flash::kLog2e;
  if (lane == 0 && qpos < seq) p.delta[stat + qpos] = delta;

  for (int k0 = 0; k0 < k_end; k0 += flash::kRowTile) {
    float ds[flash::kRowTile];
    if constexpr (!kStream) {
      __syncthreads();  // every warp is done with the previous tile
      flash::stage_rows_float(k_tile, k_head, p.k_st.s, k0, k_end, D);
      flash::stage_rows_float(v_tile, v_head, p.v_st.s, k0, k_end, D);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < flash::kRowTile; ++j) {
        const float* k_row = k_tile + j * D;
        const float* v_row = v_tile + j * D;
        float s = 0.f;
        float dp = 0.f;
        for (int d = lane; d < D; d += 32) {
          s = fmaf(q_row[d], k_row[d], s);
          dp = fmaf(do_row[d], v_row[d], dp);
        }
        s = flash::warp_sum(s);
        dp = flash::warp_sum(dp);
        const int kpos = k0 + j;
        const bool keep = kpos < seq && (!p.causal || kpos <= qpos);
        ds[j] = keep ? exp2f(s - lse2) * (dp - delta) : 0.f;
      }
      for (int d = lane; d < D; d += 32) {
        float a = acc[d];
#pragma unroll
        for (int j = 0; j < flash::kRowTile; ++j) a = fmaf(ds[j], k_tile[j * D + d], a);
        acc[d] = a;
      }
    } else {
      // the dot products over every chunk (each lane's dims in the order of
      // one pass over the row), then dq += ds k over every chunk, last
      // chunk first: it is still staged
      float s[flash::kRowTile];
      float dp[flash::kRowTile];
#pragma unroll
      for (int j = 0; j < flash::kRowTile; ++j) s[j] = dp[j] = 0.f;
      int cw = C;
      for (int c0 = 0; c0 < D; c0 += C) {
        cw = min(C, D - c0);
        __syncthreads();  // every warp is done with the staged rows
        flash::stage_rows_float(k_tile, k_head + c0, p.k_st.s, k0, k_end, cw);
        flash::stage_rows_float(v_tile, v_head + c0, p.v_st.s, k0, k_end, cw);
        __syncthreads();
        for (int d = lane; d < cw; d += 32) {
          const float qv = to_float(q_src[c0 + d]) * scale_log2;
          const float dov = to_float(do_src[c0 + d]);
#pragma unroll
          for (int j = 0; j < flash::kRowTile; ++j) {
            s[j] = fmaf(qv, k_tile[j * cw + d], s[j]);
            dp[j] = fmaf(dov, v_tile[j * cw + d], dp[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < flash::kRowTile; ++j) {
        const float score = flash::warp_sum(s[j]);
        const float dpj = flash::warp_sum(dp[j]);
        const int kpos = k0 + j;
        const bool keep = kpos < seq && (!p.causal || kpos <= qpos);
        ds[j] = keep ? exp2f(score - lse2) * (dpj - delta) : 0.f;
      }
      for (int c0 = (D - 1) / C * C; c0 >= 0; c0 -= C) {
        if (c0 + C < D) {
          cw = C;
          __syncthreads();
          flash::stage_rows_float(k_tile, k_head + c0, p.k_st.s, k0, k_end, cw);
          __syncthreads();
        }
        if (!adds) continue;
        for (int d = lane; d < cw; d += 32) {
          float a = acc[c0 + d];
#pragma unroll
          for (int j = 0; j < flash::kRowTile; ++j) a = fmaf(ds[j], k_tile[j * cw + d], a);
          acc[c0 + d] = a;
        }
      }
    }
  }
  if (qpos >= seq) return;
  T* dq_row = row_ptr<T>(p.dq, p.dq_st, b, qpos, h, 0);
  for (int d = lane; d < D; d += 32) dq_row[d] = from_float<T>(acc[d] * p.sm_scale);
}

// dk/dv at any head_dim above 256: one warp a key row; q and dO rows (with
// LSE and delta) staged kRowTile at a time as float32. Up to
// flash::kMaxSharedRowDim (!kStream) the warp's k (prescaled), v and the
// float32 dk and dv accumulators sit in shared memory; streamed, the
// partner rows come kRowChunk columns at a time (the dot products over
// every chunk, then dk and dv over every chunk, last first), k and v are
// read from their tensors and dk, dv accumulate in the row's two slots of
// the caller's float32 scratch (p.ws, batch * heads * seq rows of 2 D).
template <typename T, bool kStream>
__global__ void __launch_bounds__(flash::kRowThreads) flash_bwd_dkv_rowwise_kernel(const Params p,
                                                                                   int D) {
  extern __shared__ __align__(16) float row_smem[];
  const int C = kStream ? flash::kRowChunk : D;  // columns of a staged partner chunk
  float* q_tile = row_smem;                       // [kRowTile][C]
  float* do_tile = q_tile + flash::kRowTile * C;  // [kRowTile][C]
  float* lse_tile = do_tile + flash::kRowTile * C;  // [kRowTile], log2 units
  float* delta_tile = lse_tile + flash::kRowTile;   // [kRowTile]
  const int kt = blockIdx.x / p.batch_heads;  // first to last: the longest walks first
  const int bh = blockIdx.x - kt * p.batch_heads;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int seq = p.seq;
  const int k0 = kt * flash::kRowWarps;
  const int kpos = k0 + warp;
  const int kc = min(kpos, seq - 1);  // a row past the end: a clamped copy, nothing stored
  const int64_t stat = static_cast<int64_t>(bh) * seq;
  const T* q_head = row_ptr<T>(p.q, p.q_st, b, 0, h, 0);
  const T* do_head = row_ptr<T>(p.d_out, p.do_st, b, 0, h, 0);

  const float scale_log2 = p.sm_scale * flash::kLog2e;
  const T* k_src = row_ptr<T>(p.k, p.k_st, b, kc, h, 0);
  const T* v_src = row_ptr<T>(p.v, p.v_st, b, kc, h, 0);
  float* k_row = delta_tile + flash::kRowTile + warp * D;  // unused when streamed
  float* v_row = k_row + flash::kRowWarps * D;
  // the warp's accumulators; streamed, a row past the end has none and adds nothing
  float* dk = kStream ? p.ws + (stat + kc) * 2 * D : v_row + flash::kRowWarps * D;
  float* dv = kStream ? dk + D : dk + flash::kRowWarps * D;
  const bool adds = !kStream || kpos < seq;
  for (int d = lane; d < D; d += 32) {
    if constexpr (!kStream) {
      k_row[d] = to_float(k_src[d]) * scale_log2;
      v_row[d] = to_float(v_src[d]);
    }
    if (adds) {
      dk[d] = 0.f;
      dv[d] = 0.f;
    }
  }
  for (int q0 = p.causal ? k0 : 0; q0 < seq; q0 += flash::kRowTile) {
    float pr[flash::kRowTile];
    float ds[flash::kRowTile];
    if constexpr (!kStream) {
      __syncthreads();  // every warp is done with the previous tile
      flash::stage_rows_float(q_tile, q_head, p.q_st.s, q0, seq, D);
      flash::stage_rows_float(do_tile, do_head, p.do_st.s, q0, seq, D);
      for (int i = threadIdx.x; i < flash::kRowTile; i += flash::kRowThreads) {
        const int qp = q0 + i;
        lse_tile[i] = qp < seq ? p.lse[stat + qp] * flash::kLog2e : 0.f;
        delta_tile[i] = qp < seq ? p.delta[stat + qp] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < flash::kRowTile; ++i) {
        const float* q_row = q_tile + i * D;
        const float* do_row = do_tile + i * D;
        float s = 0.f;
        float dp = 0.f;
        for (int d = lane; d < D; d += 32) {
          s = fmaf(q_row[d], k_row[d], s);
          dp = fmaf(do_row[d], v_row[d], dp);
        }
        s = flash::warp_sum(s);
        dp = flash::warp_sum(dp);
        const int qpos = q0 + i;
        const bool keep = qpos < seq && (!p.causal || kpos <= qpos);
        pr[i] = keep ? exp2f(s - lse_tile[i]) : 0.f;
        ds[i] = pr[i] * (dp - delta_tile[i]);
      }
      for (int d = lane; d < D; d += 32) {
        float a = dk[d];
        float c = dv[d];
#pragma unroll
        for (int i = 0; i < flash::kRowTile; ++i) {
          a = fmaf(ds[i], q_tile[i * D + d], a);
          c = fmaf(pr[i], do_tile[i * D + d], c);
        }
        dk[d] = a;
        dv[d] = c;
      }
    } else {
      // the dot products over every chunk, then dk += ds q and dv += p dO
      // over every chunk, last chunk first: it is still staged
      float s[flash::kRowTile];
      float dp[flash::kRowTile];
#pragma unroll
      for (int i = 0; i < flash::kRowTile; ++i) s[i] = dp[i] = 0.f;
      int cw = C;
      for (int c0 = 0; c0 < D; c0 += C) {
        cw = min(C, D - c0);
        __syncthreads();  // every warp is done with the staged rows
        flash::stage_rows_float(q_tile, q_head + c0, p.q_st.s, q0, seq, cw);
        flash::stage_rows_float(do_tile, do_head + c0, p.do_st.s, q0, seq, cw);
        if (c0 == 0) {
          for (int i = threadIdx.x; i < flash::kRowTile; i += flash::kRowThreads) {
            const int qp = q0 + i;
            lse_tile[i] = qp < seq ? p.lse[stat + qp] * flash::kLog2e : 0.f;
            delta_tile[i] = qp < seq ? p.delta[stat + qp] : 0.f;
          }
        }
        __syncthreads();
        for (int d = lane; d < cw; d += 32) {
          const float kv = to_float(k_src[c0 + d]) * scale_log2;
          const float vv = to_float(v_src[c0 + d]);
#pragma unroll
          for (int i = 0; i < flash::kRowTile; ++i) {
            s[i] = fmaf(q_tile[i * cw + d], kv, s[i]);
            dp[i] = fmaf(do_tile[i * cw + d], vv, dp[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < flash::kRowTile; ++i) {
        const float score = flash::warp_sum(s[i]);
        const float dpi = flash::warp_sum(dp[i]);
        const int qpos = q0 + i;
        const bool keep = qpos < seq && (!p.causal || kpos <= qpos);
        pr[i] = keep ? exp2f(score - lse_tile[i]) : 0.f;
        ds[i] = pr[i] * (dpi - delta_tile[i]);
      }
      for (int c0 = (D - 1) / C * C; c0 >= 0; c0 -= C) {
        if (c0 + C < D) {
          cw = C;
          __syncthreads();
          flash::stage_rows_float(q_tile, q_head + c0, p.q_st.s, q0, seq, cw);
          flash::stage_rows_float(do_tile, do_head + c0, p.do_st.s, q0, seq, cw);
          __syncthreads();
        }
        if (!adds) continue;
        for (int d = lane; d < cw; d += 32) {
          float a = dk[c0 + d];
          float c = dv[c0 + d];
#pragma unroll
          for (int i = 0; i < flash::kRowTile; ++i) {
            a = fmaf(ds[i], q_tile[i * cw + d], a);
            c = fmaf(pr[i], do_tile[i * cw + d], c);
          }
          dk[c0 + d] = a;
          dv[c0 + d] = c;
        }
      }
    }
  }
  if (kpos >= seq) return;
  T* dk_row = row_ptr<T>(p.dk, p.dk_st, b, kpos, h, 0);
  T* dv_row = row_ptr<T>(p.dv, p.dv_st, b, kpos, h, 0);
  for (int d = lane; d < D; d += 32) {
    dk_row[d] = from_float<T>(dk[d] * p.sm_scale);
    dv_row[d] = from_float<T>(dv[d]);
  }
}

// (query rows per lane, dim split, minimum blocks per SM) of the dq quad
// kernel: one row per lane is the fastest tiling ptxas fits without a spill
template <int D>
struct DqTiling;
template <>
struct DqTiling<16> {
  static constexpr int R = 1, S = 1, kMinBlocks = 4;
};
template <>
struct DqTiling<32> {
  static constexpr int R = 1, S = 2, kMinBlocks = 3;
};

// (keys per lane, dim split, minimum blocks per SM) of the dk/dv quad kernel
template <int D>
struct DkvTiling;
template <>
struct DkvTiling<16> {
  static constexpr int R = 2, S = 2, kMinBlocks = 4;
};
template <>
struct DkvTiling<32> {
  static constexpr int R = 2, S = 2, kMinBlocks = 2;
};

// (keys per lane, dim split, warps per block, queries per staged tile,
// minimum blocks per SM) of the dk/dv wide kernel
template <int D>
struct DkvWideTiling;
template <>
struct DkvWideTiling<64> {
  static constexpr int R = 2, S = 4, kWarps = 4, kTile = 64, kMinBlocks = 2;
};
template <>
struct DkvWideTiling<128> {
  static constexpr int R = 2, S = 8, kWarps = 8, kTile = 32, kMinBlocks = 1;
};
template <>
struct DkvWideTiling<256> {
  static constexpr int R = 1, S = 8, kWarps = 8, kTile = 16, kMinBlocks = 1;
};

// (query rows per lane, dim split, warps per block, keys per staged tile,
// minimum blocks per SM) of the dq wide kernel
template <int D>
struct DqWideTiling;
template <>
struct DqWideTiling<64> {
  static constexpr int R = 2, S = 4, kWarps = 8, kTile = 64, kMinBlocks = 1;
};
template <>
struct DqWideTiling<128> {
  static constexpr int R = 2, S = 8, kWarps = 8, kTile = 32, kMinBlocks = 1;
};
template <>
struct DqWideTiling<256> {
  static constexpr int R = 1, S = 8, kWarps = 4, kTile = 16, kMinBlocks = 2;
};

// dynamic shared memory of a wide dq block (key and value rings) and of a
// wide dk/dv block (q and dO rings, then LSE and delta), two stages each
template <typename T, int D>
constexpr int dq_smem() {
  using E = flash::staged_t<T>;
  return 4 * DqWideTiling<D>::kTile * (D + 16 / static_cast<int>(sizeof(E))) *
         static_cast<int>(sizeof(E));
}

template <typename T, int D>
constexpr int dkv_smem() {
  using E = flash::staged_t<T>;
  constexpr int kTile = DkvWideTiling<D>::kTile;
  return 4 * kTile * (D + 16 / static_cast<int>(sizeof(E))) * static_cast<int>(sizeof(E)) +
         4 * kTile * static_cast<int>(sizeof(float));
}

// bfloat16 and float16 dq and dk/dv at head_dim 64 and 128 take the
// tensor cores; float32 keeps the CUDA cores (TF32 would break its 1e-4
// tolerance), and float64 is summed in float32 there as in the Pallas
// kernel
template <typename T, int D>
constexpr bool kTensorCores =
    (std::is_same_v<T, __nv_bfloat16> || std::is_same_v<T, __half>) && (D == 64 || D == 128);

// (keys per staged tile, minimum blocks per SM) of the tensor-core dq
// kernel, from the sweep (scripts/flash_tiling_sweep.py, PERF.md): at
// head_dim 128 the dQ accumulators take 64 registers a lane, so the key
// tile is halved to keep Q and dO in registers (240 registers, no spill):
// 23-27% faster than 64-key tiles reading them from shared memory each
// tile on small grids, within 2% either way at (1, 4096, 4, 128)
template <int D>
struct DqMmaTiling;
template <>
struct DqMmaTiling<64> {
  static constexpr int kTile = 64, kMinBlocks = 2;
};
template <>
struct DqMmaTiling<128> {
  static constexpr int kTile = 32, kMinBlocks = 2;
};

// A dq kernel at head_dim 64 and up (it may split its keys): the kernel,
// its block's threads, dynamic shared memory, query rows and keys a staged
// tile, and the family it reports.
struct DqLaunch {
  void (*kernel)(Params);
  int threads, smem, rows, tile, family;
};

template <typename T, int D>
DqLaunch dq_launch() {
  if constexpr (kTensorCores<T, D>) {
    using Tile = DqMmaTiling<D>;
    // the block's q and dO rows, then the key and value rings
    return {flash_bwd_dq_mma_kernel<T, D, Tile::kTile, Tile::kMinBlocks>,
            kMmaWarps * 32, (2 * kMmaRows + 4 * Tile::kTile) * (D + 8) * static_cast<int>(sizeof(T)),
            kMmaRows, Tile::kTile, flash::kFamilyMma};
  } else {
    using Tile = DqWideTiling<D>;
    return {flash_bwd_dq_wide_kernel<T, D, Tile::R, Tile::S, Tile::kWarps, Tile::kTile,
                                     Tile::kMinBlocks>,
            Tile::kWarps * 32, dq_smem<T, D>(), flash::quad_rows<Tile::R, Tile::S, Tile::kWarps>(),
            Tile::kTile, flash::kFamilyWide};
  }
}

template <typename T, int D>
const flash::WideSetup& dq_setup() {
  static const DqLaunch k = dq_launch<T, D>();
  static const flash::WideSetup setup = flash::wide_setup(k.kernel, k.threads, k.smem);
  return setup;
}

template <typename T, int D>
int dq_splits(int64_t wave, int64_t batch_heads, int seq, bool causal) {
  const DqLaunch k = dq_launch<T, D>();
  return flash::key_splits(wave, batch_heads * ((seq + k.rows - 1) / k.rows),
                           (seq + k.tile - 1) / k.tile, causal);
}

// (queries per staged tile, K and V fragments kept in registers, minimum
// blocks per SM) of the tensor-core dk/dv kernel: at head_dim 128 the
// dK and dV accumulators take 128 registers a lane, so K and V are read
// from shared memory and the query tile is halved
template <int D>
struct DkvMmaTiling;
template <>
struct DkvMmaTiling<64> {
  static constexpr int kTile = 64, kMinBlocks = 2;
  static constexpr bool kKeepKV = true;
};
template <>
struct DkvMmaTiling<128> {
  static constexpr int kTile = 32, kMinBlocks = 2;
  static constexpr bool kKeepKV = false;
};

// dynamic shared memory of a tensor-core dk/dv block: its K and V rows,
// the q and dO rings, then LSE and delta, two stages each
template <typename T, int D>
constexpr int dkv_mma_smem() {
  constexpr int kTile = DkvMmaTiling<D>::kTile;
  return (2 * kMmaKeys + 4 * kTile) * (D + 8) * static_cast<int>(sizeof(T)) +
         4 * kTile * static_cast<int>(sizeof(float));
}

// dynamic shared memory of a rowwise block at head_dim D, all float32:
// dq's key and value tiles (kRowChunk columns streamed, else D) and, not
// streamed, its warps' q, dO and dq rows; dk/dv's q and dO tiles, LSE and
// delta and, not streamed, its warps' k, v, dk and dv rows
constexpr int dq_rowwise_smem(int D, bool stream) {
  return (2 * flash::kRowTile * (stream ? flash::kRowChunk : D) +
          (stream ? 0 : 3 * flash::kRowWarps * D)) *
         static_cast<int>(sizeof(float));
}
constexpr int dkv_rowwise_smem(int D, bool stream) {
  return (2 * flash::kRowTile * (stream ? flash::kRowChunk : D) + 2 * flash::kRowTile +
          (stream ? 0 : 4 * flash::kRowWarps * D)) *
         static_cast<int>(sizeof(float));
}

enum class Which { kDq, kDkv };

template <Which W, typename T, int D>
int launch(Params& p, int64_t batch_heads, cudaStream_t stream, int* launched) {
  if constexpr (D <= 32) {  // the model's head sizes
    constexpr int kRows = W == Which::kDq ? flash::quad_rows<DqTiling<D>::R, DqTiling<D>::S>()
                                          : flash::quad_rows<DkvTiling<D>::R, DkvTiling<D>::S>();
    p.n_tiles = (p.seq + kRows - 1) / kRows;
    const int64_t n_blocks = batch_heads * p.n_tiles;
    if (n_blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
    const unsigned grid = static_cast<unsigned>(n_blocks);
    if constexpr (W == Which::kDq) {
      using Tile = DqTiling<D>;
      flash_bwd_dq_quad_kernel<T, D, Tile::R, Tile::S, Tile::kMinBlocks>
          <<<grid, flash::kQuadThreads, 0, stream>>>(p);
    } else {
      using Tile = DkvTiling<D>;
      flash_bwd_dkv_quad_kernel<T, D, Tile::R, Tile::S, Tile::kMinBlocks>
          <<<grid, flash::kQuadThreads, 0, stream>>>(p);
    }
    *launched = flash::kFamilyQuad;
  } else if constexpr (W == Which::kDq) {
    const DqLaunch k = dq_launch<T, D>();
    const flash::WideSetup& setup = dq_setup<T, D>();
    if (setup.err != cudaSuccess) return static_cast<int>(setup.err);
    p.n_splits = dq_splits<T, D>(setup.wave, batch_heads, p.seq, p.causal);
    if (p.n_splits > 1 && p.ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    p.n_tiles = (p.seq + k.rows - 1) / k.rows;
    const int64_t n_blocks = batch_heads * p.n_tiles * p.n_splits;
    const int64_t n_rows = batch_heads * p.seq;
    if (n_blocks > INT_MAX || (n_rows + 3) / 4 > INT_MAX) {
      return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    k.kernel<<<static_cast<unsigned>(n_blocks), k.threads, k.smem, stream>>>(p);
    if (p.n_splits > 1) {
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      flash_bwd_dq_merge_kernel<T, D>
          <<<static_cast<unsigned>((n_rows + 3) / 4), 128, 0, stream>>>(p);
    }
    *launched = k.family;
  } else if constexpr (kTensorCores<T, D>) {
    using Tile = DkvMmaTiling<D>;
    p.n_tiles = (p.seq + kMmaKeys - 1) / kMmaKeys;
    const int64_t n_blocks = batch_heads * p.n_tiles;
    if (n_blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
    const auto kernel =
        flash_bwd_dkv_mma_kernel<T, D, Tile::kTile, Tile::kKeepKV, Tile::kMinBlocks>;
    constexpr int kSmem = dkv_mma_smem<T, D>();
    static const cudaError_t smem_ok = flash::allow_dynamic_smem(kernel, kSmem);
    if (smem_ok != cudaSuccess) return static_cast<int>(smem_ok);
    kernel<<<static_cast<unsigned>(n_blocks), kMmaWarps * 32, kSmem, stream>>>(p);
    *launched = flash::kFamilyMma;
  } else {
    using Tile = DkvWideTiling<D>;
    constexpr int kKeys = flash::quad_rows<Tile::R, Tile::S, Tile::kWarps>();
    p.n_tiles = (p.seq + kKeys - 1) / kKeys;
    const int64_t n_blocks = batch_heads * p.n_tiles;
    if (n_blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
    const auto kernel = flash_bwd_dkv_wide_kernel<T, D, Tile::R, Tile::S, Tile::kWarps,
                                                  Tile::kTile, Tile::kMinBlocks>;
    constexpr int kSmem = dkv_smem<T, D>();
    static const cudaError_t smem_ok = flash::allow_dynamic_smem(kernel, kSmem);
    if (smem_ok != cudaSuccess) return static_cast<int>(smem_ok);
    kernel<<<static_cast<unsigned>(n_blocks), Tile::kWarps * 32, kSmem, stream>>>(p);
    *launched = flash::kFamilyWide;
  }
  return static_cast<int>(cudaGetLastError());
}

// the rowwise kernels at any head_dim above 256: rows in shared memory up
// to flash::kMaxSharedRowDim, streamed above it (the caller's scratch)
template <Which W, typename T, bool kStream>
int launch_rowwise(Params& p, int64_t batch_heads, int head_dim, cudaStream_t stream,
                   int* launched) {
  if (kStream && p.ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  p.n_tiles = (p.seq + flash::kRowWarps - 1) / flash::kRowWarps;
  const int64_t n_blocks = batch_heads * p.n_tiles;
  if (n_blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const unsigned grid = static_cast<unsigned>(n_blocks);
  // the widest block each kernel takes: the shared rows at kMaxSharedRowDim, or the streamed chunks
  constexpr int kDmax = kStream ? flash::kRowChunk : flash::kMaxSharedRowDim;
  if constexpr (W == Which::kDq) {
    static const cudaError_t smem_ok = flash::allow_dynamic_smem(
        flash_bwd_dq_rowwise_kernel<T, kStream>, dq_rowwise_smem(kDmax, kStream));
    if (smem_ok != cudaSuccess) return static_cast<int>(smem_ok);
    flash_bwd_dq_rowwise_kernel<T, kStream>
        <<<grid, flash::kRowThreads, dq_rowwise_smem(head_dim, kStream), stream>>>(p, head_dim);
  } else {
    static const cudaError_t smem_ok = flash::allow_dynamic_smem(
        flash_bwd_dkv_rowwise_kernel<T, kStream>, dkv_rowwise_smem(kDmax, kStream));
    if (smem_ok != cudaSuccess) return static_cast<int>(smem_ok);
    flash_bwd_dkv_rowwise_kernel<T, kStream>
        <<<grid, flash::kRowThreads, dkv_rowwise_smem(head_dim, kStream), stream>>>(p, head_dim);
  }
  *launched = flash::kFamilyRowwise;
  return static_cast<int>(cudaGetLastError());
}

template <Which W, typename T>
int dispatch_head_dim(int head_dim, Params& p, int64_t batch_heads, cudaStream_t stream,
                      int* launched) {
  switch (head_dim) {
    case 16: return launch<W, T, 16>(p, batch_heads, stream, launched);
    case 32: return launch<W, T, 32>(p, batch_heads, stream, launched);
    case 64: return launch<W, T, 64>(p, batch_heads, stream, launched);
    case 128: return launch<W, T, 128>(p, batch_heads, stream, launched);
    case 256: return launch<W, T, 256>(p, batch_heads, stream, launched);
    default:
      if (head_dim <= 256 || head_dim % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
      if (head_dim <= flash::kMaxSharedRowDim) {
        return launch_rowwise<W, T, false>(p, batch_heads, head_dim, stream, launched);
      }
      return launch_rowwise<W, T, true>(p, batch_heads, head_dim, stream, launched);
  }
}

Strides strides_at(const long long* strides, int tensor) {
  return Strides{strides[3 * tensor], strides[3 * tensor + 1], strides[3 * tensor + 2]};
}

template <Which W>
int run(Params& p, int batch, int seq, int heads, int head_dim, int dtype, int mode,
        void* stream, int* launched) {
  if (batch <= 0 || seq <= 0 || heads <= 0) return static_cast<int>(cudaErrorInvalidValue);
  p.heads = heads;
  p.seq = seq;
  p.causal = (mode & flash::kModeCausal) != 0;
  p.vec = (mode & flash::kModeVec16) != 0;
  const int64_t batch_heads = static_cast<int64_t>(batch) * heads;
  if (batch_heads > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  p.batch_heads = static_cast<int>(batch_heads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_head_dim<W, float>(head_dim, p, batch_heads, s, launched);
    case 1: return dispatch_head_dim<W, __nv_bfloat16>(head_dim, p, batch_heads, s, launched);
    case 2: return dispatch_head_dim<W, __half>(head_dim, p, batch_heads, s, launched);
    case 3: return dispatch_head_dim<W, double>(head_dim, p, batch_heads, s, launched);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int D>
int dq_splits_of(int64_t batch_heads, int seq, bool causal) {
  const flash::WideSetup& setup = dq_setup<T, D>();
  if (setup.err != cudaSuccess) return -static_cast<int>(setup.err);
  return dq_splits<T, D>(setup.wave, batch_heads, seq, causal);
}

template <typename T>
int dq_splits_for(int head_dim, int64_t batch_heads, int seq, bool causal) {
  switch (head_dim) {
    case 64: return dq_splits_of<T, 64>(batch_heads, seq, causal);
    case 128: return dq_splits_of<T, 128>(batch_heads, seq, causal);
    case 256: return dq_splits_of<T, 256>(batch_heads, seq, causal);
    default: return 1;
  }
}

}  // namespace

// the key splits the dq launch of these shapes and mode takes: the float32
// scratch it needs is n_splits * batch * heads * seq * head_dim elements
// when n_splits > 1 (none otherwise); minus the CUDA error code when the
// card could not be queried or the dtype is unknown
extern "C" int gordo_flash_attention_bwd_dq_splits(int batch, int seq, int heads, int head_dim,
                                                   int dtype, int mode) {
  const int64_t batch_heads = static_cast<int64_t>(batch) * heads;
  if (batch <= 0 || seq <= 0 || heads <= 0) return 1;
  const bool causal = (mode & flash::kModeCausal) != 0;
  switch (dtype) {
    case 0: return dq_splits_for<float>(head_dim, batch_heads, seq, causal);
    case 1: return dq_splits_for<__nv_bfloat16>(head_dim, batch_heads, seq, causal);
    case 2: return dq_splits_for<__half>(head_dim, batch_heads, seq, causal);
    case 3: return dq_splits_for<double>(head_dim, batch_heads, seq, causal);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// dq and delta, replacing _bwd_dq_kernel (gordo_tpu/ops/flash_attention.py:176);
// q, k, v, out, d_out and lse in, dq and delta out.
// strides: (batch, seq, head) of q, k, v, out, d_out, dq, in that order;
// mode: bit 1 causal, bit 2 16-byte aligned rows of all six; workspace:
// the scratch gordo_flash_attention_bwd_dq_splits asks for, or above
// flash::kMaxSharedRowDim the float32 dq accumulators, batch * heads *
// seq * head_dim elements (null when neither is asked for); launched: set
// to the kernel family launched (flash::kFamily*)
extern "C" int gordo_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* out, const void* d_out,
    const void* lse, void* delta, void* dq, void* workspace,
    int batch, int seq, int heads, int head_dim, int dtype,
    const long long* strides, float sm_scale, int mode, void* stream, int* launched) {
  Params p = {};
  p.ws = static_cast<float*>(workspace);
  p.n_splits = 1;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.d_out = d_out;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = dq;
  p.q_st = strides_at(strides, 0);
  p.k_st = strides_at(strides, 1);
  p.v_st = strides_at(strides, 2);
  p.o_st = strides_at(strides, 3);
  p.do_st = strides_at(strides, 4);
  p.dq_st = strides_at(strides, 5);
  p.sm_scale = sm_scale;
  return run<Which::kDq>(p, batch, seq, heads, head_dim, dtype, mode, stream, launched);
}

// dk and dv, replacing _bwd_dkv_kernel (gordo_tpu/ops/flash_attention.py:213);
// q, k, v, d_out, lse and delta in, dk and dv out.
// strides: (batch, seq, head) of q, k, v, d_out, dk, dv, in that order;
// mode: bit 1 causal, bit 2 16-byte aligned rows of all six; workspace:
// above flash::kMaxSharedRowDim the float32 dk and dv accumulators, 2 *
// batch * heads * seq * head_dim elements (null at narrower widths);
// launched: set to the kernel family launched (flash::kFamily*)
extern "C" int gordo_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* d_out,
    const void* lse, const void* delta, void* dk, void* dv, void* workspace,
    int batch, int seq, int heads, int head_dim, int dtype,
    const long long* strides, float sm_scale, int mode, void* stream, int* launched) {
  Params p = {};
  p.ws = static_cast<float*>(workspace);
  p.q = q;
  p.k = k;
  p.v = v;
  p.d_out = d_out;
  p.lse = static_cast<const float*>(lse);
  p.delta = const_cast<float*>(static_cast<const float*>(delta));
  p.dk = dk;
  p.dv = dv;
  p.q_st = strides_at(strides, 0);
  p.k_st = strides_at(strides, 1);
  p.v_st = strides_at(strides, 2);
  p.do_st = strides_at(strides, 3);
  p.dk_st = strides_at(strides, 4);
  p.dv_st = strides_at(strides, 5);
  p.sm_scale = sm_scale;
  return run<Which::kDkv>(p, batch, seq, heads, head_dim, dtype, mode, stream, launched);
}
