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
// Any head_dim above 256 that is a multiple of 128 (the JAX wrapper's
// padding; no upper limit), the width a run-time argument: the tiled
// kernels. They replace _bwd_dq_kernel (gordo_tpu/ops/flash_attention.py:
// 176) and _bwd_dkv_kernel (:213) there, and took the place of one-warp-
// a-row kernels that read both operands of every multiply-add from shared
// memory and summed each pair's dots by warp shuffles (7x SDPA's whole
// backward in bf16 at (2, 300, 2, 300), PERF.md). They are bound by
// operations: (2, 300, 2, 300) causal at 384 is 0.33 GFLOP for dq and
// 0.44 for dk/dv, 4.9 and 6.5 us at the fp32 rate, against about 5.5 MB
// of tensors; in bf16 the 989 TFLOP/s rate leaves them bound by bytes at
// that size and by operations at (2, 2048, 4, 512) (0.052 and 0.069 ms).
// A block owns a tile of rows (query rows in dq, key rows in dk/dv) and
// one slice of its output columns, so a small launch still fills the card
// (the grid is row tiles x slices x batch*heads, row tiles of dq last to
// first and key tiles of dk/dv first to last, so causal launches start
// with their longest walks, and grids under one wave split the partner
// axis: dq's keys as the wide kernels split them, dk/dv's queries the same
// way; each split writes unscaled float32 rows to the caller's scratch and
// flash_bwd_dq_merge_rows_kernel / flash_bwd_dkv_merge_rows_kernel sum
// them in split order). Per partner tile, the two score products (S = Q Kᵀ
// and dP = dO Vᵀ, or Sᵀ and dPᵀ) are summed over the whole width in chunks
// that pass through a two-stage cp.async ring, P and dS are formed from
// the saved LSE and the delta, and the slice's accumulators take the
// tile's share from the slice's columns of the partner rows, staged while
// the scores are summed. Every slice recomputes the scores: (slices 2 D +
// D) of work per kept pair for dq against 3 D, (slices 2 D + 2 D) for
// dk/dv against 4 D, 2.3x and 2x at 384. Keeping a row tile's whole-width
// float32 accumulators in shared memory instead (score once) does not fit
// the widths above 640 at 32 or 64 rows a block, and the register slices
// bound every width at one design. dq sums delta = rowsum(dO * O) for its
// own rows from device memory (2 D reads a row) and one block a row, slice
// 0 of split 0, writes it.
// - float32 and float64 (flash_bwd_dq_tiled_kernel,
//   flash_bwd_dkv_tiled_kernel, family `tiled`) stay on the CUDA cores:
//   TF32 would break the 1e-4 tolerance, and float64 is staged as float32.
//   128 threads hold register tiles of 4 rows x 4 keys (dq: 32 query rows,
//   64-key tiles, 32-column chunks) or 4 keys x 2 queries (dk/dv: 32 key
//   rows, 32-query tiles, 64-column chunks) of both score products, and a
//   128-column slice of 4 rows x 8 columns a thread of each accumulator;
//   dS (and Pᵀ) go through shared memory for the slice's products. Each chunk's dot
//   products are summed apart and then added: one chain over the whole
//   width moved the flash-vs-dense gradient at head_dim 300 to 1.1e-4,
//   past its 1e-4 bound (dP - delta cancels when dO follows O), and the
//   chunked sum keeps it at 5.7e-5, as the warp-shuffle sums had it.
//   Rows that are not 16-byte aligned are staged by 4-byte cp.async copies
//   in float32 (element by element in float64).
// - bfloat16 and float16 (flash_bwd_dq_tiled_mma_kernel,
//   flash_bwd_dkv_tiled_mma_kernel, family `tiled_mma`) run all four
//   products on the tensor cores (mma.sync m16n8k16, float32
//   accumulators, fragments by ldmatrix from 64-column chunks padded by 16
//   bytes): a block is 4 warps of 16 rows (64 query rows or key rows), dq
//   walks 64-key tiles with a 128-column slice (dS rounded once to the
//   input type as the A operand of dQ += dS K), dk/dv 64-query tiles with
//   a 64-column slice (two accumulators: 128 columns spilled 0.8 KB), Pᵀ
//   and dSᵀ each carried as a head and a tail term of the input type for
//   dV += Pᵀ dO and dK += dSᵀ Q, as the width-64/128 kernel carries them.
// The tiles were chosen by timing on the card (scripts/flash_tiling_sweep.py,
// PERF.md) at (2, 300, 2, 300), the phase-7 model's (4, 256, 2, 300), 640,
// 1100, 2048 and (2, 2048, 4, 512). 64-column dk/dv chunks beat 32-column
// ones by 4-9% in float32 at every case; 32-key float32 dq tiles were 15-19%
// faster at 300 and 1100 but 13% slower at the phase-7 model's shape;
// 128-column tensor-core chunks at one block an SM were 7-20% faster on
// grids under one wave and 30-37% slower at (2, 2048, 4, 512), where two
// blocks an SM fill the card; 32-key or 32-query tensor-core tiles and
// 128-column tensor-core dk/dv slices (0.8 KB of spills) lost. ptxas
// (registers, spill stores): dq 255 (8 bytes) float32, 234 float64, 254
// bf16 and float16; dk/dv 254 float32, 246 float64, 254 (8 bytes) bf16,
// 255 float16; two blocks an SM. No atomics: two launches are bitwise
// equal.
//
// Rows past the sequence end store nothing; query rows past the end add
// nothing to dk/dv and keys past the end have probability 0. No head-dim
// padding to 128 lanes and no lane-broadcast statistics: those exist only
// for Mosaic's (8, 128) tiling.
//
// Inputs are float32, bfloat16, float16 or float64 (dtype 0 / 1 / 2 / 3),
// each element converted to float32 on load and every sum in float32, as
// the Pallas kernels do (a float64 tile is staged in shared memory as
// float32); head_dim is 16, 32, 64, 128, 256 or any multiple of 128 above
// 256; any sequence length; causal or full. Strides are in elements,
// (batch, seq, head) for each tensor in the order the entry point names;
// the head dim must be contiguous. `mode` is a bit set: 1 causal, 2 every
// row start of the six (batch, seq, heads, head_dim) tensors of the entry
// point 16-byte aligned. The kernels allocate nothing (the split scratch
// is the caller's) and run on the caller's stream. Each entry point returns the
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
  // partner splits: each split's unscaled float32 dq rows, or above 256
  // its dk and dv rows (the caller's scratch, n_splits * batch * heads *
  // seq * head_dim elements, twice that for dk/dv)
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

// Above head_dim 256 the width D is a run-time argument, a multiple of the
// kernels' column slice. Each block owns a tile of rows (query rows in dq,
// key rows in dk/dv) and one slice of their output columns, and walks the
// partner tiles; per partner tile it sums the two score products over the
// whole width, chunk by chunk through a two-stage ring, then adds the
// partner tile's share to the slice's accumulators. See the file's note.

// delta = rowsum(dO * O) of one query row over the whole width: each of the
// kLanes threads of a row group sums 4 columns of every 4 kLanes, then a
// fixed butterfly over the group gives every thread the row's sum
template <typename T, int kLanes>
__device__ __forceinline__ float row_delta(const T* o_row, const T* do_row, int D, int tx,
                                           bool vec) {
  float dot = 0.f;
  for (int d = 4 * tx; d < D; d += 4 * kLanes) {
    float o[4];
    float g[4];
    flash::load_row<T, 4>(o_row + d, o, vec);
    flash::load_row<T, 4>(do_row + d, g, vec);
#pragma unroll
    for (int e = 0; e < 4; ++e) dot = fmaf(g[e], o[e], dot);
  }
#pragma unroll
  for (int offset = 1; offset < kLanes; offset <<= 1) {
    dot += __shfl_xor_sync(0xffffffffu, dot, offset);
  }
  return dot;
}

// component j (0-3) of a float4
__device__ __forceinline__ float lane_of(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// acc[i][j] += the dot product of staged rows ty + kRowGroups i of `a` and
// tx + 16 j of `b` over one kChunk-column chunk (16 threads across a row
// group). The chunk's sum is taken apart and then added, so a
// dot product over the whole width is a sum of per-chunk sums: over a
// width of hundreds its rounding error stays near that of a pairwise sum
// (dP - delta cancels heavily when dO follows O).
template <int TM, int TN, int kRowGroups, int kChunk, int kPitch, typename E>
__device__ __forceinline__ void chunk_dots(const E* a, const E* b, int ty, int tx,
                                           float (&acc)[TM][TN]) {
  constexpr int kLanes = 16;
  float part[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) part[i][j] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < kChunk; d += 4) {
    float4 av[TM];
    float4 bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = flash::load4(a + (ty + kRowGroups * i) * kPitch + d);
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = flash::load4(b + (tx + kLanes * j) * kPitch + d);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        part[i][j] = fmaf(av[i].x, bv[j].x, part[i][j]);
        part[i][j] = fmaf(av[i].y, bv[j].y, part[i][j]);
        part[i][j] = fmaf(av[i].z, bv[j].z, part[i][j]);
        part[i][j] = fmaf(av[i].w, bv[j].w, part[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j];
  }
}

// dq above 256 on the CUDA cores (float32, and float64 staged as float32):
// a block owns kRows query rows and kSlice of their dQ columns. Per key tile
// of kKeys keys, S = Q Kᵀ and dP = dO Vᵀ are summed over the whole width in
// kChunk-column chunks of q, dO, k and v through a two-stage ring, each
// thread holding TM rows x TN keys of both (rows ty + kRowGroups i, keys tx
// + kLanes j), so a staged element feeds TN or TM multiply-adds; dS = P (dP
// - delta) goes through shared memory, and dQ += dS K runs on the slice's
// key columns, staged while the scores are summed. Block order (row tiles
// last to first) and key splits as in flash_bwd_dq_wide_kernel; the
// splits' partial rows go to flash_bwd_dq_merge_rows_kernel.
template <typename T, int kRows, int kKeys, int kChunk, int kSlice, int kWarps, int kMinBlocks>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
    flash_bwd_dq_tiled_kernel(const Params p, int D) {
  using E = flash::staged_t<T>;
  constexpr int kThreads = kWarps * 32;
  constexpr int kLanes = 16;                     // threads across a row's keys and columns
  constexpr int kRowGroups = kThreads / kLanes;  // threads down the row tile
  constexpr int TM = kRows / kRowGroups;         // query rows a thread holds
  constexpr int TN = kKeys / kLanes;             // keys a thread scores per tile
  constexpr int TC = kSlice / (4 * kLanes);      // dQ float4s a thread holds per row
  constexpr int kCPitch = kChunk + 16 / sizeof(E);  // padded rows: 16-byte aligned
  constexpr int kKPitch = kSlice + 16 / sizeof(E);
  constexpr int kSPitch = kKeys + 4;
  constexpr int kStage = 2 * (kRows + kKeys) * kCPitch;  // q, dO, k and v chunks
  static_assert(kRows % kRowGroups == 0 && kKeys % kLanes == 0 && kSlice % (4 * kLanes) == 0 &&
                    (kChunk * sizeof(E)) % 16 == 0 && kKeys % 4 == 0,
                "whole register tiles and 16-byte chunks");
  extern __shared__ __align__(16) unsigned char smem[];
  E* ring = reinterpret_cast<E*>(smem);  // [2][q | dO (kRows each) | k | v (kKeys each)][kCPitch]
  E* k_slice = ring + 2 * kStage;        // [kKeys][kKPitch]
  float* ds_tile = reinterpret_cast<float*>(k_slice + kKeys * kKPitch);  // [kRows][kSPitch]

  // block = (row tile, batch*head, slice, key split), split fastest, then
  // the slice; row tiles last to first across all heads
  const int n_slices = D / kSlice;
  const int split = blockIdx.x % p.n_splits;
  const int rest = blockIdx.x / p.n_splits;
  const int slice = rest % n_slices;
  const int tile = rest / n_slices;
  const int bh = tile % p.batch_heads;
  const int qt = p.n_tiles - 1 - tile / p.batch_heads;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int tx = threadIdx.x % kLanes;
  const int ty = threadIdx.x / kLanes;
  const int seq = p.seq;
  const int q0 = qt * kRows;
  const bool vec = p.vec;
  const int64_t stat = static_cast<int64_t>(bh) * seq;
  const T* q_head = row_ptr<T>(p.q, p.q_st, b, 0, h, 0);
  const T* do_head = row_ptr<T>(p.d_out, p.do_st, b, 0, h, 0);
  const T* k_head = row_ptr<T>(p.k, p.k_st, b, 0, h, 0);
  const T* v_head = row_ptr<T>(p.v, p.v_st, b, 0, h, 0);
  const int k_end = p.causal ? min(seq, q0 + kRows) : seq;
  // this split's run of the block's key tiles
  const int n_tiles = (k_end + kKeys - 1) / kKeys;
  const int split_tiles = (n_tiles + p.n_splits - 1) / p.n_splits;
  const int t_begin = min(n_tiles, split * split_tiles);
  const int t_end = min(n_tiles, t_begin + split_tiles);
  const int n_chunks = D / kChunk;

  // chunk c of the q and dO rows and of key tile t's k and v rows into ring stage s
  auto stage_chunk = [&](int t, int c, int s) {
    E* dst = ring + s * kStage;
    const int d0 = c * kChunk;
    flash::stage_rows<T, kChunk, kCPitch, kRows, kThreads, true>(dst, q_head + d0, p.q_st.s, q0, seq,
                                                           vec);
    flash::stage_rows<T, kChunk, kCPitch, kRows, kThreads, true>(dst + kRows * kCPitch, do_head + d0,
                                                           p.do_st.s, q0, seq, vec);
    flash::stage_rows<T, kChunk, kCPitch, kKeys, kThreads, true>(
        dst + 2 * kRows * kCPitch, k_head + d0, p.k_st.s, t * kKeys, k_end, vec);
    flash::stage_rows<T, kChunk, kCPitch, kKeys, kThreads, true>(
        dst + (2 * kRows + kKeys) * kCPitch, v_head + d0, p.v_st.s, t * kKeys, k_end, vec);
  };
  if (t_begin < t_end) stage_chunk(t_begin, 0, 0);
  flash::cp_async_commit();

  // delta and LSE (log2 units) of the thread's rows; a row past the end is
  // a clamped copy and stores nothing. One block a row writes delta.
  float delta[TM];
  float lse2[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty + kRowGroups * i;
    const int qc = min(q0 + r, seq - 1);
    delta[i] = row_delta<T, kLanes>(row_ptr<T>(p.out, p.o_st, b, qc, h, 0),
                                    row_ptr<T>(p.d_out, p.do_st, b, qc, h, 0), D, tx, vec);
    lse2[i] = p.lse[stat + qc] * flash::kLog2e;
    if (slice == 0 && split == 0 && tx == 0 && q0 + r < seq) p.delta[stat + q0 + r] = delta[i];
  }

  const float scale_log2 = p.sm_scale * flash::kLog2e;  // scores in log2 units
  float acc[TM][4 * TC];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int c = 0; c < 4 * TC; ++c) acc[i][c] = 0.f;
  }

  int it = 0;  // chunks walked: chunk `it` sits in ring stage it & 1
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kKeys;
    // the slice's key columns of this tile (every thread is past the last
    // tile's dS K: the __syncthreads that ends it)
    flash::stage_rows<T, kSlice, kKPitch, kKeys, kThreads, true>(k_slice, k_head + slice * kSlice,
                                                           p.k_st.s, k0, k_end, vec);
    flash::cp_async_commit();
    float s[TM][TN];
    float dp[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = dp[i][j] = 0.f;
    }
    for (int c = 0; c < n_chunks; ++c, ++it) {
      // this chunk has landed (at c = 0 the key slice may still be in flight)
      if (c == 0) {
        flash::cp_async_wait<1>();
      } else {
        flash::cp_async_wait<0>();
      }
      __syncthreads();  // ... for every thread, and every thread is done with the other stage
      if (c + 1 < n_chunks) {
        stage_chunk(t, c + 1, (it + 1) & 1);
      } else if (t + 1 < t_end) {
        stage_chunk(t + 1, 0, (it + 1) & 1);
      }
      flash::cp_async_commit();
      const E* q_c = ring + (it & 1) * kStage;
      const E* do_c = q_c + kRows * kCPitch;
      const E* k_c = do_c + kRows * kCPitch;
      const E* v_c = k_c + kKeys * kCPitch;
      chunk_dots<TM, TN, kRowGroups, kChunk, kCPitch>(q_c, k_c, ty, tx, s);
      chunk_dots<TM, TN, kRowGroups, kChunk, kCPitch>(do_c, v_c, ty, tx, dp);
    }

    // P = exp2(S - LSE) where the mask keeps the pair (every pair of a tile
    // the mask keeps whole), dS = P (dP - delta), to shared memory
    const bool whole = k0 + kKeys <= seq && (!p.causal || k0 + kKeys - 1 <= q0);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty + kRowGroups * i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int kpos = k0 + tx + kLanes * j;
        const bool keep = whole || (kpos < seq && (!p.causal || kpos <= q0 + r));
        const float pr = keep ? exp2f(s[i][j] * scale_log2 - lse2[i]) : 0.f;
        ds_tile[r * kSPitch + tx + kLanes * j] = pr * (dp[i][j] - delta[i]);
      }
    }
    flash::cp_async_wait<1>();  // the key slice has landed (the next tile's first chunk may not)
    __syncthreads();
    // dQ += dS K on the slice's columns: this thread's TM rows x 4 TC columns
#pragma unroll 2
    for (int j = 0; j < kKeys; j += 4) {
      float4 dsv[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        dsv[i] = *reinterpret_cast<const float4*>(ds_tile + (ty + kRowGroups * i) * kSPitch + j);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const E* k_row = k_slice + (j + jj) * kKPitch + 4 * tx;
#pragma unroll
        for (int c = 0; c < TC; ++c) {
          const float4 kv = flash::load4(k_row + 4 * kLanes * c);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float w = lane_of(dsv[i], jj);
            acc[i][4 * c] = fmaf(w, kv.x, acc[i][4 * c]);
            acc[i][4 * c + 1] = fmaf(w, kv.y, acc[i][4 * c + 1]);
            acc[i][4 * c + 2] = fmaf(w, kv.z, acc[i][4 * c + 2]);
            acc[i][4 * c + 3] = fmaf(w, kv.w, acc[i][4 * c + 3]);
          }
        }
      }
    }
    __syncthreads();  // every thread is done with dS and the key slice
  }

  // with one split s * dq in T, else the unscaled float32 row to the
  // scratch for flash_bwd_dq_merge_rows_kernel
  const int64_t n_rows = static_cast<int64_t>(p.batch_heads) * seq;
  const int col0 = slice * kSlice + 4 * tx;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qpos = q0 + ty + kRowGroups * i;
    if (qpos >= seq) continue;
    if (p.n_splits == 1) {
      T* dq_row = row_ptr<T>(p.dq, p.dq_st, b, qpos, h, col0);
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        flash::store4(dq_row + 4 * kLanes * c,
                      make_float4(acc[i][4 * c] * p.sm_scale, acc[i][4 * c + 1] * p.sm_scale,
                                  acc[i][4 * c + 2] * p.sm_scale, acc[i][4 * c + 3] * p.sm_scale),
                      vec);
      }
    } else {
      float* ws_row = p.ws + (split * n_rows + stat + qpos) * D + col0;
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        flash::store4(ws_row + 4 * kLanes * c,
                      make_float4(acc[i][4 * c], acc[i][4 * c + 1], acc[i][4 * c + 2],
                                  acc[i][4 * c + 3]),
                      true);
      }
    }
  }
}

// dk/dv above 256 on the CUDA cores (float32, and float64 staged as
// float32): a block owns kRows key rows and kSlice of their dK and dV
// columns. Per query tile of kQueries queries, Sᵀ = K Qᵀ and dPᵀ = V dOᵀ are
// summed over the whole width in kChunk-column chunks of k, v, q and dO
// through a two-stage ring, each thread holding TM keys x TN queries of
// both; Pᵀ and dSᵀ go through shared memory, and dV += Pᵀ dO and dK += dSᵀ Q
// run on the slice's columns of the query tile, staged (with its LSE and
// delta) while the scores are summed. Key tiles run first to last, causal
// blocks start at their first key's query, and grids under one wave split
// the query axis: each split writes its unscaled float32 dK and dV rows,
// and flash_bwd_dkv_merge_rows_kernel sums them in split order.
template <typename T, int kRows, int kQueries, int kChunk, int kSlice, int kWarps,
          int kMinBlocks>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
    flash_bwd_dkv_tiled_kernel(const Params p, int D) {
  using E = flash::staged_t<T>;
  constexpr int kThreads = kWarps * 32;
  constexpr int kLanes = 16;                     // threads across a row's queries and columns
  constexpr int kRowGroups = kThreads / kLanes;  // threads down the key tile
  constexpr int TM = kRows / kRowGroups;         // key rows a thread holds
  constexpr int TN = kQueries / kLanes;          // queries a thread scores per tile
  constexpr int TC = kSlice / (4 * kLanes);      // dK and dV float4s a thread holds per row
  constexpr int kCPitch = kChunk + 16 / sizeof(E);
  constexpr int kSPitch = kSlice + 16 / sizeof(E);
  constexpr int kPPitch = kQueries + 4;
  constexpr int kStage = 2 * (kRows + kQueries) * kCPitch;  // k, v, q and dO chunks
  static_assert(kRows % kRowGroups == 0 && kQueries % kLanes == 0 &&
                    kSlice % (4 * kLanes) == 0 && (kChunk * sizeof(E)) % 16 == 0 &&
                    kQueries % 4 == 0,
                "whole register tiles and 16-byte chunks");
  extern __shared__ __align__(16) unsigned char smem[];
  E* ring = reinterpret_cast<E*>(smem);  // [2][k | v (kRows each) | q | dO (kQueries each)][kCPitch]
  E* q_slice = ring + 2 * kStage;                 // [kQueries][kSPitch]
  E* do_slice = q_slice + kQueries * kSPitch;     // [kQueries][kSPitch]
  float* p_tile = reinterpret_cast<float*>(do_slice + kQueries * kSPitch);  // [kRows][kPPitch]
  float* ds_tile = p_tile + kRows * kPPitch;      // [kRows][kPPitch]
  float* lse_tile = ds_tile + kRows * kPPitch;    // [kQueries]
  float* delta_tile = lse_tile + kQueries;        // [kQueries]

  // block = (key tile, batch*head, slice, query split), split fastest,
  // then the slice; key tiles first to last across all heads
  const int n_slices = D / kSlice;
  const int split = blockIdx.x % p.n_splits;
  const int rest = blockIdx.x / p.n_splits;
  const int slice = rest % n_slices;
  const int tile = rest / n_slices;
  const int kt = tile / p.batch_heads;
  const int bh = tile - kt * p.batch_heads;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int tx = threadIdx.x % kLanes;
  const int ty = threadIdx.x / kLanes;
  const int seq = p.seq;
  const int k0 = kt * kRows;
  const bool vec = p.vec;
  const int64_t stat = static_cast<int64_t>(bh) * seq;
  const T* q_head = row_ptr<T>(p.q, p.q_st, b, 0, h, 0);
  const T* do_head = row_ptr<T>(p.d_out, p.do_st, b, 0, h, 0);
  const T* k_head = row_ptr<T>(p.k, p.k_st, b, 0, h, 0);
  const T* v_head = row_ptr<T>(p.v, p.v_st, b, 0, h, 0);
  // causal: queries before the block's first key see none of its keys
  const int q_begin = p.causal ? k0 : 0;
  // this split's run of the block's query tiles
  const int n_tiles = (seq - q_begin + kQueries - 1) / kQueries;
  const int split_tiles = (n_tiles + p.n_splits - 1) / p.n_splits;
  const int t_begin = min(n_tiles, split * split_tiles);
  const int t_end = min(n_tiles, t_begin + split_tiles);
  const int n_chunks = D / kChunk;

  // chunk c of the k and v rows and of query tile t's q and dO rows into ring stage s
  auto stage_chunk = [&](int t, int c, int s) {
    E* dst = ring + s * kStage;
    const int d0 = c * kChunk;
    const int q0 = q_begin + t * kQueries;
    flash::stage_rows<T, kChunk, kCPitch, kRows, kThreads, true>(dst, k_head + d0, p.k_st.s, k0, seq,
                                                           vec);
    flash::stage_rows<T, kChunk, kCPitch, kRows, kThreads, true>(dst + kRows * kCPitch, v_head + d0,
                                                           p.v_st.s, k0, seq, vec);
    flash::stage_rows<T, kChunk, kCPitch, kQueries, kThreads, true>(
        dst + 2 * kRows * kCPitch, q_head + d0, p.q_st.s, q0, seq, vec);
    flash::stage_rows<T, kChunk, kCPitch, kQueries, kThreads, true>(
        dst + (2 * kRows + kQueries) * kCPitch, do_head + d0, p.do_st.s, q0, seq, vec);
  };
  if (t_begin < t_end) stage_chunk(t_begin, 0, 0);
  flash::cp_async_commit();

  const float scale_log2 = p.sm_scale * flash::kLog2e;  // scores in log2 units
  float dk[TM][4 * TC];
  float dv[TM][4 * TC];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int c = 0; c < 4 * TC; ++c) dk[i][c] = dv[i][c] = 0.f;
  }

  int it = 0;  // chunks walked: chunk `it` sits in ring stage it & 1
  for (int t = t_begin; t < t_end; ++t) {
    const int q0 = q_begin + t * kQueries;
    // the slice's q and dO columns of this tile with its LSE and delta
    // (every thread is past the last tile's products: the __syncthreads
    // that ends it)
    flash::stage_rows<T, kSlice, kSPitch, kQueries, kThreads, true>(q_slice, q_head + slice * kSlice,
                                                              p.q_st.s, q0, seq, vec);
    flash::stage_rows<T, kSlice, kSPitch, kQueries, kThreads, true>(do_slice, do_head + slice * kSlice,
                                                              p.do_st.s, q0, seq, vec);
    for (int i = threadIdx.x; i < kQueries; i += kThreads) {
      const int qp = q0 + i;
      if (qp < seq) {
        flash::cp_async4(lse_tile + i, p.lse + stat + qp);
        flash::cp_async4(delta_tile + i, p.delta + stat + qp);
      } else {
        lse_tile[i] = 0.f;
        delta_tile[i] = 0.f;
      }
    }
    flash::cp_async_commit();
    float st[TM][TN];
    float dpt[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) st[i][j] = dpt[i][j] = 0.f;
    }
    for (int c = 0; c < n_chunks; ++c, ++it) {
      if (c == 0) {
        flash::cp_async_wait<1>();
      } else {
        flash::cp_async_wait<0>();
      }
      __syncthreads();
      if (c + 1 < n_chunks) {
        stage_chunk(t, c + 1, (it + 1) & 1);
      } else if (t + 1 < t_end) {
        stage_chunk(t + 1, 0, (it + 1) & 1);
      }
      flash::cp_async_commit();
      const E* k_c = ring + (it & 1) * kStage;
      const E* v_c = k_c + kRows * kCPitch;
      const E* q_c = v_c + kRows * kCPitch;
      const E* do_c = q_c + kQueries * kCPitch;
      chunk_dots<TM, TN, kRowGroups, kChunk, kCPitch>(k_c, q_c, ty, tx, st);
      chunk_dots<TM, TN, kRowGroups, kChunk, kCPitch>(v_c, do_c, ty, tx, dpt);
    }
    flash::cp_async_wait<1>();  // the slices, LSE and delta have landed
    __syncthreads();
    // Pᵀ = exp2(Sᵀ - LSE) where the mask keeps the pair, dSᵀ = Pᵀ (dPᵀ - delta)
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty + kRowGroups * i;
      const int kpos = k0 + r;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int qi = tx + kLanes * j;
        const int qpos = q0 + qi;
        const bool keep = qpos < seq && (!p.causal || kpos <= qpos);
        const float pt = keep ? exp2f(st[i][j] * scale_log2 - lse_tile[qi] * flash::kLog2e) : 0.f;
        p_tile[r * kPPitch + qi] = pt;
        ds_tile[r * kPPitch + qi] = pt * (dpt[i][j] - delta_tile[qi]);
      }
    }
    __syncthreads();
    // dV += Pᵀ dO, then dK += dSᵀ Q, on the slice's columns: this thread's
    // TM keys x 4 TC columns of each (two passes: half the live registers)
    auto accumulate = [&](const float* w_tile, const E* rows, float (&acc)[TM][4 * TC]) {
#pragma unroll 2
      for (int j = 0; j < kQueries; j += 4) {
        float4 wv[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          wv[i] = *reinterpret_cast<const float4*>(w_tile + (ty + kRowGroups * i) * kPPitch + j);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const E* row = rows + (j + jj) * kSPitch + 4 * tx;
#pragma unroll
          for (int c = 0; c < TC; ++c) {
            const float4 x = flash::load4(row + 4 * kLanes * c);
#pragma unroll
            for (int i = 0; i < TM; ++i) {
              const float w = lane_of(wv[i], jj);
              acc[i][4 * c] = fmaf(w, x.x, acc[i][4 * c]);
              acc[i][4 * c + 1] = fmaf(w, x.y, acc[i][4 * c + 1]);
              acc[i][4 * c + 2] = fmaf(w, x.z, acc[i][4 * c + 2]);
              acc[i][4 * c + 3] = fmaf(w, x.w, acc[i][4 * c + 3]);
            }
          }
        }
      }
    };
    accumulate(p_tile, do_slice, dv);
    accumulate(ds_tile, q_slice, dk);
    __syncthreads();  // every thread is done with Pᵀ, dSᵀ and the slices
  }

  // with one split s * dk and dv in T, else the unscaled float32 rows to
  // the scratch for flash_bwd_dkv_merge_rows_kernel
  const int64_t n_rows = static_cast<int64_t>(p.batch_heads) * seq;
  const int col0 = slice * kSlice + 4 * tx;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int kpos = k0 + ty + kRowGroups * i;
    if (kpos >= seq) continue;
    if (p.n_splits == 1) {
      T* dk_row = row_ptr<T>(p.dk, p.dk_st, b, kpos, h, col0);
      T* dv_row = row_ptr<T>(p.dv, p.dv_st, b, kpos, h, col0);
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        flash::store4(dk_row + 4 * kLanes * c,
                      make_float4(dk[i][4 * c] * p.sm_scale, dk[i][4 * c + 1] * p.sm_scale,
                                  dk[i][4 * c + 2] * p.sm_scale, dk[i][4 * c + 3] * p.sm_scale),
                      vec);
        flash::store4(dv_row + 4 * kLanes * c,
                      make_float4(dv[i][4 * c], dv[i][4 * c + 1], dv[i][4 * c + 2],
                                  dv[i][4 * c + 3]),
                      vec);
      }
    } else {
      float* ws_row = p.ws + (split * n_rows + stat + kpos) * 2 * D + col0;
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        flash::store4(ws_row + 4 * kLanes * c,
                      make_float4(dk[i][4 * c], dk[i][4 * c + 1], dk[i][4 * c + 2],
                                  dk[i][4 * c + 3]),
                      true);
        flash::store4(ws_row + D + 4 * kLanes * c,
                      make_float4(dv[i][4 * c], dv[i][4 * c + 1], dv[i][4 * c + 2],
                                  dv[i][4 * c + 3]),
                      true);
      }
    }
  }
}

// dq above 256 in bfloat16 and float16 on the tensor cores: 4 warps of 16
// query rows a block (kMmaRows) and kSlice of their dQ columns. Per key
// tile of kKeys keys, S = Q Kᵀ and dP = dO Vᵀ are summed over the whole
// width in 64-column chunks of q, dO, k and v through a two-stage cp.async
// ring (mma.sync m16n8k16, float32 accumulators, A fragments of each chunk's
// q and dO rows by ldmatrix); P and dS = P (dP - delta) are formed in the
// registers that summed them, and dQ += dS K runs on the slice's key
// columns (staged while the scores are summed) with dS as the A operand in
// place, rounded once to T, and K by ldmatrix.trans. delta = rowsum(dO * O)
// is summed from device memory, two lanes a row. Block order and key
// splits as in flash_bwd_dq_tiled_kernel.
template <typename T, int kKeys, int kChunk, int kSlice, int kMinBlocks>
__global__ void __launch_bounds__(kMmaWarps * 32, kMinBlocks)
    flash_bwd_dq_tiled_mma_kernel(const Params p, int D) {
  constexpr int kThreads = kMmaWarps * 32;
  constexpr int kRows = kMmaRows;
  constexpr int kCPitch = kChunk + 8;  // 16 bytes of padding a row: ldmatrix rows on distinct banks
  constexpr int kKPitch = kSlice + 8;
  constexpr int kStage = 2 * (kRows + kKeys) * kCPitch;  // q, dO, k and v chunks
  constexpr int kNTiles = kKeys / 8;   // 8-key tiles of a key tile
  constexpr int kDTiles = kSlice / 8;  // 8-wide dQ tiles of the slice
  static_assert(kKeys % 16 == 0 && kSlice % 16 == 0 && kChunk % 16 == 0, "whole 16 x 16 blocks");
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // [2][q | dO (kRows each) | k | v (kKeys each)][kCPitch]
  T* k_slice = ring + 2 * kStage;        // [kKeys][kKPitch]

  const int n_slices = D / kSlice;
  const int split = blockIdx.x % p.n_splits;
  const int rest = blockIdx.x / p.n_splits;
  const int slice = rest % n_slices;
  const int tile = rest / n_slices;
  const int bh = tile % p.batch_heads;
  const int qt = p.n_tiles - 1 - tile / p.batch_heads;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // the lane's rows of the warp's 16: g and g + 8
  const int t4 = lane & 3;  // the lane's columns of each 8-wide tile: 2 t4, 2 t4 + 1
  const int seq = p.seq;
  const int q0 = qt * kRows;
  const int row_a = q0 + warp * 16 + g;
  const bool vec = p.vec;
  const int64_t stat = static_cast<int64_t>(bh) * seq;
  const T* q_head = row_ptr<T>(p.q, p.q_st, b, 0, h, 0);
  const T* do_head = row_ptr<T>(p.d_out, p.do_st, b, 0, h, 0);
  const T* k_head = row_ptr<T>(p.k, p.k_st, b, 0, h, 0);
  const T* v_head = row_ptr<T>(p.v, p.v_st, b, 0, h, 0);
  // keys the block needs, and keys the warp's rows need (a causal warp
  // skips the tiles past its last row, a warp-uniform branch)
  const int k_end = p.causal ? min(seq, q0 + kRows) : seq;
  const int warp_k_end = p.causal ? min(seq, q0 + warp * 16 + 16) : seq;
  const int n_tiles = (k_end + kKeys - 1) / kKeys;
  const int split_tiles = (n_tiles + p.n_splits - 1) / p.n_splits;
  const int t_begin = min(n_tiles, split * split_tiles);
  const int t_end = min(n_tiles, t_begin + split_tiles);
  const int n_chunks = D / kChunk;

  auto stage_chunk = [&](int t, int c, int s) {
    T* dst = ring + s * kStage;
    const int d0 = c * kChunk;
    flash::stage_rows<T, kChunk, kCPitch, kRows, kThreads>(dst, q_head + d0, p.q_st.s, q0, seq,
                                                           vec);
    flash::stage_rows<T, kChunk, kCPitch, kRows, kThreads>(dst + kRows * kCPitch, do_head + d0,
                                                           p.do_st.s, q0, seq, vec);
    flash::stage_rows<T, kChunk, kCPitch, kKeys, kThreads>(
        dst + 2 * kRows * kCPitch, k_head + d0, p.k_st.s, t * kKeys, k_end, vec);
    flash::stage_rows<T, kChunk, kCPitch, kKeys, kThreads>(
        dst + (2 * kRows + kKeys) * kCPitch, v_head + d0, p.v_st.s, t * kKeys, k_end, vec);
  };
  if (t_begin < t_end) stage_chunk(t_begin, 0, 0);
  flash::cp_async_commit();

  // delta = rowsum(dO * O) in float32, two lanes a row (lane 2r + half sums
  // half the width of the warp's row r) from device memory, written by one
  // block a row; then each lane takes its rows g and g + 8, with their LSE
  // in log2 units
  float delta[2];
  float lse2[2];
  {
    const int r = warp * 16 + (lane >> 1);
    const int half = lane & 1;
    const int qc = min(q0 + r, seq - 1);
    const T* o_row = row_ptr<T>(p.out, p.o_st, b, qc, h, half * (D / 2));
    const T* d_row = row_ptr<T>(p.d_out, p.do_st, b, qc, h, half * (D / 2));
    float dot = 0.f;
    for (int d = 0; d < D / 2; d += 8) {
      float ov[8];
      float gv[8];
      flash::load_row<T, 8>(o_row + d, ov, vec);
      flash::load_row<T, 8>(d_row + d, gv, vec);
#pragma unroll
      for (int e = 0; e < 8; ++e) dot = fmaf(gv[e], ov[e], dot);
    }
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    if (slice == 0 && split == 0 && half == 0 && q0 + r < seq) p.delta[stat + q0 + r] = dot;
    delta[0] = __shfl_sync(0xffffffffu, dot, 2 * g);
    delta[1] = __shfl_sync(0xffffffffu, dot, 2 * g + 16);
#pragma unroll
    for (int i = 0; i < 2; ++i) lse2[i] = p.lse[stat + min(row_a + 8 * i, seq - 1)] * flash::kLog2e;
  }

  const float scale_log2 = p.sm_scale * flash::kLog2e;  // scores in log2 units
  float dq[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.f;

  int it = 0;  // chunks walked: chunk `it` sits in ring stage it & 1
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kKeys;
    flash::stage_rows<T, kSlice, kKPitch, kKeys, kThreads>(k_slice, k_head + slice * kSlice,
                                                           p.k_st.s, k0, k_end, vec);
    flash::cp_async_commit();
    const bool active = k0 < warp_k_end;
    // S = Q Kᵀ and dP = dO Vᵀ, 16 rows x kKeys keys each
    float st[kNTiles][4];
    float dp[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dp[j][e] = 0.f;
    }
    for (int c = 0; c < n_chunks; ++c, ++it) {
      if (c == 0) {
        flash::cp_async_wait<1>();
      } else {
        flash::cp_async_wait<0>();
      }
      __syncthreads();
      if (c + 1 < n_chunks) {
        stage_chunk(t, c + 1, (it + 1) & 1);
      } else if (t + 1 < t_end) {
        stage_chunk(t + 1, 0, (it + 1) & 1);
      }
      flash::cp_async_commit();
      if (!active) continue;
      const T* q_c = ring + (it & 1) * kStage;
      const T* do_c = q_c + kRows * kCPitch;
      const T* k_c = do_c + kRows * kCPitch;
      const T* v_c = k_c + kKeys * kCPitch;
#pragma unroll
      for (int kc = 0; kc < kChunk / 16; ++kc) {
        uint32_t qa[4];
        uint32_t da[4];
        flash::ldmatrix_x4(qa, flash::a_rows(q_c, kCPitch, warp * 16, kc * 16, lane));
        flash::ldmatrix_x4(da, flash::a_rows(do_c, kCPitch, warp * 16, kc * 16, lane));
#pragma unroll
        for (int np = 0; np < kNTiles / 2; ++np) {
          uint32_t kb[4];
          flash::ldmatrix_x4(kb, flash::b_rows(k_c, kCPitch, np * 16, kc * 16, lane));
          flash::mma_16816<T>(st[2 * np], qa, kb[0], kb[1]);
          flash::mma_16816<T>(st[2 * np + 1], qa, kb[2], kb[3]);
          uint32_t vb[4];
          flash::ldmatrix_x4(vb, flash::b_rows(v_c, kCPitch, np * 16, kc * 16, lane));
          flash::mma_16816<T>(dp[2 * np], da, vb[0], vb[1]);
          flash::mma_16816<T>(dp[2 * np + 1], da, vb[2], vb[3]);
        }
      }
    }
    flash::cp_async_wait<1>();  // the key slice has landed (the next tile's first chunk may not)
    __syncthreads();
    if (active) {
      // P = exp2(S - LSE) where the mask keeps the pair (every pair of a
      // tile the mask keeps whole for the warp's rows), dS = P (dP - delta)
      const bool whole = k0 + kKeys <= seq && (!p.causal || k0 + kKeys <= q0 + warp * 16 + 1);
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
      // dQ += dS K on the slice's columns: dS in place as the A operand, K
      // by ldmatrix.trans
#pragma unroll
      for (int kc = 0; kc < kKeys / 16; ++kc) {
        uint32_t ds[4];
        flash::pack_a<T>(ds, st[2 * kc], st[2 * kc + 1]);
#pragma unroll
        for (int dpi = 0; dpi < kSlice / 16; ++dpi) {
          uint32_t kb[4];
          flash::ldmatrix_x4_trans(kb, flash::bt_rows(k_slice, kKPitch, kc * 16, dpi * 16, lane));
          flash::mma_16816<T>(dq[2 * dpi], ds, kb[0], kb[1]);
          flash::mma_16816<T>(dq[2 * dpi + 1], ds, kb[2], kb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with the key slice
  }

  // each lane stores two columns of each 8-wide tile of its two rows: with
  // one split s * dq in T, else the unscaled float32 row to the scratch for
  // flash_bwd_dq_merge_rows_kernel
  const int64_t n_rows = static_cast<int64_t>(p.batch_heads) * seq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row_a + 8 * r;
    if (qpos >= seq) continue;
    if (p.n_splits == 1) {
      T* dq_row = row_ptr<T>(p.dq, p.dq_st, b, qpos, h, slice * kSlice);
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
      float* ws_row = p.ws + (split * n_rows + stat + qpos) * D + slice * kSlice;
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt) {
        *reinterpret_cast<float2*>(ws_row + dt * 8 + 2 * t4) =
            make_float2(dq[dt][2 * r], dq[dt][2 * r + 1]);
      }
    }
  }
}

// dk/dv above 256 in bfloat16 and float16 on the tensor cores: 4 warps of
// 16 key rows a block (kMmaKeys) and kSlice of their dK and dV columns. Per
// query tile of kQueries queries, Sᵀ = K Qᵀ and dPᵀ = V dOᵀ are summed over
// the whole width in 64-column chunks of k, v, q and dO through a two-stage
// cp.async ring; Pᵀ and dSᵀ are formed in the registers that summed them,
// and dV += Pᵀ dO and dK += dSᵀ Q run on the slice's q and dO columns
// (staged with the tile's LSE and delta while the scores are summed), Pᵀ
// and dSᵀ each split into a head and a tail term of T as A operands in
// place, dO and Q by ldmatrix.trans. Block order and query splits as in
// flash_bwd_dkv_tiled_kernel.
template <typename T, int kQueries, int kChunk, int kSlice, int kMinBlocks>
__global__ void __launch_bounds__(kMmaWarps * 32, kMinBlocks)
    flash_bwd_dkv_tiled_mma_kernel(const Params p, int D) {
  constexpr int kThreads = kMmaWarps * 32;
  constexpr int kRows = kMmaKeys;
  constexpr int kCPitch = kChunk + 8;
  constexpr int kSPitch = kSlice + 8;
  constexpr int kStage = 2 * (kRows + kQueries) * kCPitch;  // k, v, q and dO chunks
  constexpr int kQTiles = kQueries / 8;  // 8-query tiles of a query tile
  constexpr int kDTiles = kSlice / 8;    // 8-wide dK and dV tiles of the slice
  static_assert(kQueries % 16 == 0 && kSlice % 16 == 0 && kChunk % 16 == 0,
                "whole 16 x 16 blocks");
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);     // [2][k | v (kRows each) | q | dO (kQueries each)][kCPitch]
  T* q_slice = ring + 2 * kStage;           // [kQueries][kSPitch]
  T* do_slice = q_slice + kQueries * kSPitch;  // [kQueries][kSPitch]
  float* lse_tile = reinterpret_cast<float*>(do_slice + kQueries * kSPitch);  // [kQueries]
  float* delta_tile = lse_tile + kQueries;                                     // [kQueries]

  const int n_slices = D / kSlice;
  const int split = blockIdx.x % p.n_splits;
  const int rest = blockIdx.x / p.n_splits;
  const int slice = rest % n_slices;
  const int tile = rest / n_slices;
  const int kt = tile / p.batch_heads;
  const int bh = tile - kt * p.batch_heads;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // the lane's keys of the warp's 16: g and g + 8
  const int t4 = lane & 3;  // the lane's columns of each 8-wide tile: 2 t4, 2 t4 + 1
  const int seq = p.seq;
  const int k0 = kt * kRows;
  const int key_a = k0 + warp * 16 + g;
  const bool vec = p.vec;
  const int64_t stat = static_cast<int64_t>(bh) * seq;
  const T* q_head = row_ptr<T>(p.q, p.q_st, b, 0, h, 0);
  const T* do_head = row_ptr<T>(p.d_out, p.do_st, b, 0, h, 0);
  const T* k_head = row_ptr<T>(p.k, p.k_st, b, 0, h, 0);
  const T* v_head = row_ptr<T>(p.v, p.v_st, b, 0, h, 0);
  // causal: queries before the block's first key see none of its keys,
  // and a tile wholly before the warp's first key none of the warp's (a
  // warp-uniform skip)
  const int q_begin = p.causal ? k0 : 0;
  const int warp_q_first = p.causal ? k0 + warp * 16 : 0;
  const int n_tiles = (seq - q_begin + kQueries - 1) / kQueries;
  const int split_tiles = (n_tiles + p.n_splits - 1) / p.n_splits;
  const int t_begin = min(n_tiles, split * split_tiles);
  const int t_end = min(n_tiles, t_begin + split_tiles);
  const int n_chunks = D / kChunk;

  auto stage_chunk = [&](int t, int c, int s) {
    T* dst = ring + s * kStage;
    const int d0 = c * kChunk;
    const int q0 = q_begin + t * kQueries;
    flash::stage_rows<T, kChunk, kCPitch, kRows, kThreads>(dst, k_head + d0, p.k_st.s, k0, seq,
                                                           vec);
    flash::stage_rows<T, kChunk, kCPitch, kRows, kThreads>(dst + kRows * kCPitch, v_head + d0,
                                                           p.v_st.s, k0, seq, vec);
    flash::stage_rows<T, kChunk, kCPitch, kQueries, kThreads>(
        dst + 2 * kRows * kCPitch, q_head + d0, p.q_st.s, q0, seq, vec);
    flash::stage_rows<T, kChunk, kCPitch, kQueries, kThreads>(
        dst + (2 * kRows + kQueries) * kCPitch, do_head + d0, p.do_st.s, q0, seq, vec);
  };
  if (t_begin < t_end) stage_chunk(t_begin, 0, 0);
  flash::cp_async_commit();

  const float scale_log2 = p.sm_scale * flash::kLog2e;  // scores in log2 units
  float dk[kDTiles][4];
  float dv[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;
  }

  int it = 0;  // chunks walked: chunk `it` sits in ring stage it & 1
  for (int t = t_begin; t < t_end; ++t) {
    const int q0 = q_begin + t * kQueries;
    flash::stage_rows<T, kSlice, kSPitch, kQueries, kThreads>(q_slice, q_head + slice * kSlice,
                                                              p.q_st.s, q0, seq, vec);
    flash::stage_rows<T, kSlice, kSPitch, kQueries, kThreads>(do_slice, do_head + slice * kSlice,
                                                              p.do_st.s, q0, seq, vec);
    for (int i = threadIdx.x; i < kQueries; i += kThreads) {
      const int qp = q0 + i;
      if (qp < seq) {
        flash::cp_async4(lse_tile + i, p.lse + stat + qp);
        flash::cp_async4(delta_tile + i, p.delta + stat + qp);
      } else {
        lse_tile[i] = 0.f;
        delta_tile[i] = 0.f;
      }
    }
    flash::cp_async_commit();
    const bool active = q0 + kQueries > warp_q_first;
    // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ, 16 keys x kQueries queries each
    float st[kQTiles][4];
    float dpt[kQTiles][4];
#pragma unroll
    for (int j = 0; j < kQTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    }
    for (int c = 0; c < n_chunks; ++c, ++it) {
      if (c == 0) {
        flash::cp_async_wait<1>();
      } else {
        flash::cp_async_wait<0>();
      }
      __syncthreads();
      if (c + 1 < n_chunks) {
        stage_chunk(t, c + 1, (it + 1) & 1);
      } else if (t + 1 < t_end) {
        stage_chunk(t + 1, 0, (it + 1) & 1);
      }
      flash::cp_async_commit();
      if (!active) continue;
      const T* k_c = ring + (it & 1) * kStage;
      const T* v_c = k_c + kRows * kCPitch;
      const T* q_c = v_c + kRows * kCPitch;
      const T* do_c = q_c + kQueries * kCPitch;
#pragma unroll
      for (int kc = 0; kc < kChunk / 16; ++kc) {
        uint32_t ka[4];
        uint32_t va[4];
        flash::ldmatrix_x4(ka, flash::a_rows(k_c, kCPitch, warp * 16, kc * 16, lane));
        flash::ldmatrix_x4(va, flash::a_rows(v_c, kCPitch, warp * 16, kc * 16, lane));
#pragma unroll
        for (int np = 0; np < kQTiles / 2; ++np) {
          uint32_t qb[4];
          flash::ldmatrix_x4(qb, flash::b_rows(q_c, kCPitch, np * 16, kc * 16, lane));
          flash::mma_16816<T>(st[2 * np], ka, qb[0], qb[1]);
          flash::mma_16816<T>(st[2 * np + 1], ka, qb[2], qb[3]);
          uint32_t ob[4];
          flash::ldmatrix_x4(ob, flash::b_rows(do_c, kCPitch, np * 16, kc * 16, lane));
          flash::mma_16816<T>(dpt[2 * np], va, ob[0], ob[1]);
          flash::mma_16816<T>(dpt[2 * np + 1], va, ob[2], ob[3]);
        }
      }
    }
    flash::cp_async_wait<1>();  // the slices, LSE and delta have landed
    __syncthreads();
    if (active) {
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
      // dV += Pᵀ dO and dK += dSᵀ Q on the slice's columns, Pᵀ and dSᵀ in
      // place as A operands, each split into two terms of T (head + tail)
#pragma unroll
      for (int kc = 0; kc < kQueries / 16; ++kc) {
        uint32_t ph[4];
        uint32_t pl[4];
        uint32_t dh[4];
        uint32_t dl[4];
        flash::split_a<T>(ph, pl, st[2 * kc], st[2 * kc + 1]);
        flash::split_a<T>(dh, dl, dpt[2 * kc], dpt[2 * kc + 1]);
#pragma unroll
        for (int dpi = 0; dpi < kSlice / 16; ++dpi) {
          uint32_t ob[4];
          flash::ldmatrix_x4_trans(ob, flash::bt_rows(do_slice, kSPitch, kc * 16, dpi * 16, lane));
          flash::mma_16816<T>(dv[2 * dpi], ph, ob[0], ob[1]);
          flash::mma_16816<T>(dv[2 * dpi + 1], ph, ob[2], ob[3]);
          flash::mma_16816<T>(dv[2 * dpi], pl, ob[0], ob[1]);
          flash::mma_16816<T>(dv[2 * dpi + 1], pl, ob[2], ob[3]);
          uint32_t qb[4];
          flash::ldmatrix_x4_trans(qb, flash::bt_rows(q_slice, kSPitch, kc * 16, dpi * 16, lane));
          flash::mma_16816<T>(dk[2 * dpi], dh, qb[0], qb[1]);
          flash::mma_16816<T>(dk[2 * dpi + 1], dh, qb[2], qb[3]);
          flash::mma_16816<T>(dk[2 * dpi], dl, qb[0], qb[1]);
          flash::mma_16816<T>(dk[2 * dpi + 1], dl, qb[2], qb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with the slices
  }

  // each lane stores two columns of each 8-wide tile of its two key rows:
  // with one split s * dk and dv in T, else the unscaled float32 rows to
  // the scratch for flash_bwd_dkv_merge_rows_kernel
  const int64_t n_rows = static_cast<int64_t>(p.batch_heads) * seq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = key_a + 8 * r;
    if (kpos >= seq) continue;
    if (p.n_splits == 1) {
      T* dk_row = row_ptr<T>(p.dk, p.dk_st, b, kpos, h, slice * kSlice);
      T* dv_row = row_ptr<T>(p.dv, p.dv_st, b, kpos, h, slice * kSlice);
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
    } else {
      float* ws_row = p.ws + (split * n_rows + stat + kpos) * 2 * D + slice * kSlice;
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt) {
        *reinterpret_cast<float2*>(ws_row + dt * 8 + 2 * t4) =
            make_float2(dk[dt][2 * r], dk[dt][2 * r + 1]);
        *reinterpret_cast<float2*>(ws_row + D + dt * 8 + 2 * t4) =
            make_float2(dv[dt][2 * r], dv[dt][2 * r + 1]);
      }
    }
  }
}

// Merge the key splits of the dq kernels above 256 (the width D at run
// time): one warp a row sums the splits' rows in split order, the lanes
// striding over the width, and writes s * dq.
template <typename T>
__global__ void __launch_bounds__(128) flash_bwd_dq_merge_rows_kernel(const Params p, int D) {
  const int64_t n_rows = static_cast<int64_t>(p.batch_heads) * p.seq;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 4 + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int lane = threadIdx.x & 31;
  const int bh = static_cast<int>(row / p.seq);
  const int qpos = static_cast<int>(row - static_cast<int64_t>(bh) * p.seq);
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  T* dq_row = row_ptr<T>(p.dq, p.dq_st, b, qpos, h, 0);
  for (int d = lane; d < D; d += 32) {
    float acc = 0.f;
    for (int s = 0; s < p.n_splits; ++s) acc += p.ws[(s * n_rows + row) * D + d];
    dq_row[d] = from_float<T>(acc * p.sm_scale);
  }
}

// Merge the query splits of the dk/dv kernels above 256: one warp a key
// row sums the splits' dK and dV rows in split order and writes s * dk and
// dv.
template <typename T>
__global__ void __launch_bounds__(128) flash_bwd_dkv_merge_rows_kernel(const Params p, int D) {
  const int64_t n_rows = static_cast<int64_t>(p.batch_heads) * p.seq;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 4 + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int lane = threadIdx.x & 31;
  const int bh = static_cast<int>(row / p.seq);
  const int kpos = static_cast<int>(row - static_cast<int64_t>(bh) * p.seq);
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  T* dk_row = row_ptr<T>(p.dk, p.dk_st, b, kpos, h, 0);
  T* dv_row = row_ptr<T>(p.dv, p.dv_st, b, kpos, h, 0);
  for (int d = lane; d < D; d += 32) {
    float k_acc = 0.f;
    float v_acc = 0.f;
    for (int s = 0; s < p.n_splits; ++s) {
      const float* part = p.ws + (s * n_rows + row) * 2 * D;
      k_acc += part[d];
      v_acc += part[D + d];
    }
    dk_row[d] = from_float<T>(k_acc * p.sm_scale);
    dv_row[d] = from_float<T>(v_acc);
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

// bfloat16 and float16 dq and dk/dv at head_dim 64 and 128, and above 256,
// take the tensor cores; float32 keeps the CUDA cores (TF32 would break its
// 1e-4 tolerance), and float64 is summed in float32 there as in the Pallas
// kernel
template <typename T>
constexpr bool kSixteenBit = std::is_same_v<T, __nv_bfloat16> || std::is_same_v<T, __half>;
template <typename T, int D>
constexpr bool kTensorCores = kSixteenBit<T> && (D == 64 || D == 128);

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

// Tilings of the kernels above head_dim 256, chosen by timing on the card
// (scripts/flash_tiling_sweep.py, PERF.md). The CUDA-core dq kernel:
// (query rows, keys a tile, head dims a staged chunk, dQ columns a block,
// warps, minimum blocks per SM).
struct DqTiledTiling {
  static constexpr int kRows = 32, kKeys = 64, kChunk = 32, kSlice = 128, kWarps = 4, kMinBlocks = 2;
};
// The CUDA-core dk/dv kernel: (key rows, queries a tile, head dims a staged
// chunk, dK and dV columns a block, warps, minimum blocks per SM).
struct DkvTiledTiling {
  static constexpr int kRows = 32, kQueries = 32, kChunk = 64, kSlice = 128, kWarps = 4, kMinBlocks = 2;
};
// The tensor-core dq kernel: (keys a tile, head dims a staged chunk, dQ
// columns a block, minimum blocks per SM); 64 query rows a block.
struct DqTiledMmaTiling {
  static constexpr int kKeys = 64, kChunk = 64, kSlice = 128, kMinBlocks = 2;
};
// The tensor-core dk/dv kernel: (queries a tile, head dims a staged chunk,
// dK and dV columns a block, minimum blocks per SM); 64 key rows a block.
// Its two accumulators take 2 kSlice / 4 registers a lane.
struct DkvTiledMmaTiling {
  static constexpr int kQueries = 64, kChunk = 64, kSlice = 64, kMinBlocks = 2;
};

// A kernel above head_dim 256 (the width at run time): the kernel, its
// block's threads and dynamic shared memory, the rows a block owns, the
// partner rows of a tile, the output columns of a block, and the family it
// reports.
struct TiledLaunch {
  void (*kernel)(Params, int);
  int threads, smem, rows, tile, slice, family;
};

template <Which W, typename T>
TiledLaunch tiled_launch() {
  constexpr int kE = static_cast<int>(sizeof(flash::staged_t<T>));
  constexpr int kPad = 16 / kE;  // elements of a 16-byte row pad
  constexpr int kF = static_cast<int>(sizeof(float));
  if constexpr (W == Which::kDq && kSixteenBit<T>) {
    using Tile = DqTiledMmaTiling;
    // the ring of q, dO, k and v chunks, then the key slice
    return {flash_bwd_dq_tiled_mma_kernel<T, Tile::kKeys, Tile::kChunk, Tile::kSlice,
                                          Tile::kMinBlocks>,
            kMmaWarps * 32,
            (4 * (kMmaRows + Tile::kKeys) * (Tile::kChunk + kPad) +
             Tile::kKeys * (Tile::kSlice + kPad)) * kE,
            kMmaRows, Tile::kKeys, Tile::kSlice, flash::kFamilyTiledMma};
  } else if constexpr (W == Which::kDq) {
    using Tile = DqTiledTiling;
    // the ring, the key slice (staged type), then dS (float32)
    return {flash_bwd_dq_tiled_kernel<T, Tile::kRows, Tile::kKeys, Tile::kChunk, Tile::kSlice,
                                      Tile::kWarps, Tile::kMinBlocks>,
            Tile::kWarps * 32,
            (4 * (Tile::kRows + Tile::kKeys) * (Tile::kChunk + kPad) +
             Tile::kKeys * (Tile::kSlice + kPad)) * kE +
                Tile::kRows * (Tile::kKeys + 4) * kF,
            Tile::kRows, Tile::kKeys, Tile::kSlice, flash::kFamilyTiled};
  } else if constexpr (kSixteenBit<T>) {
    using Tile = DkvTiledMmaTiling;
    // the ring of k, v, q and dO chunks, the q and dO slices, LSE and delta
    return {flash_bwd_dkv_tiled_mma_kernel<T, Tile::kQueries, Tile::kChunk, Tile::kSlice,
                                           Tile::kMinBlocks>,
            kMmaWarps * 32,
            (4 * (kMmaKeys + Tile::kQueries) * (Tile::kChunk + kPad) +
             2 * Tile::kQueries * (Tile::kSlice + kPad)) * kE +
                2 * Tile::kQueries * kF,
            kMmaKeys, Tile::kQueries, Tile::kSlice, flash::kFamilyTiledMma};
  } else {
    using Tile = DkvTiledTiling;
    // the ring, the q and dO slices (staged type), Pᵀ and dSᵀ, LSE and delta
    return {flash_bwd_dkv_tiled_kernel<T, Tile::kRows, Tile::kQueries, Tile::kChunk,
                                       Tile::kSlice, Tile::kWarps, Tile::kMinBlocks>,
            Tile::kWarps * 32,
            (4 * (Tile::kRows + Tile::kQueries) * (Tile::kChunk + kPad) +
             2 * Tile::kQueries * (Tile::kSlice + kPad)) * kE +
                (2 * Tile::kRows * (Tile::kQueries + 4) + 2 * Tile::kQueries) * kF,
            Tile::kRows, Tile::kQueries, Tile::kSlice, flash::kFamilyTiled};
  }
}

template <Which W, typename T>
const flash::WideSetup& tiled_setup() {
  static const TiledLaunch k = tiled_launch<W, T>();
  static const flash::WideSetup setup = flash::wide_setup(k.kernel, k.threads, k.smem);
  return setup;
}

// the partner splits (dq's keys, dk/dv's queries) of a launch above 256,
// by the wide kernels' rule
template <Which W, typename T>
int tiled_splits(int64_t wave, int64_t batch_heads, int seq, int head_dim, bool causal) {
  const TiledLaunch k = tiled_launch<W, T>();
  const int64_t blocks = batch_heads * ((seq + k.rows - 1) / k.rows) * (head_dim / k.slice);
  return flash::key_splits(wave, blocks, (seq + k.tile - 1) / k.tile, causal);
}

template <Which W, typename T>
int tiled_splits_of(int64_t batch_heads, int seq, int head_dim, bool causal) {
  if (head_dim <= 256 || head_dim % 128 != 0) return 1;
  const flash::WideSetup& setup = tiled_setup<W, T>();
  if (setup.err != cudaSuccess) return -static_cast<int>(setup.err);
  return tiled_splits<W, T>(setup.wave, batch_heads, seq, head_dim, causal);
}

// dq or dk/dv at any head_dim above 256 that is a multiple of 128 (of every
// tiling's chunk and slice); with splits, the merge kernel after it (the
// caller's scratch)
template <Which W, typename T>
int launch_tiled(Params& p, int64_t batch_heads, int head_dim, cudaStream_t stream,
                 int* launched) {
  const TiledLaunch k = tiled_launch<W, T>();
  if (head_dim % k.slice != 0 || head_dim % 128 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const flash::WideSetup& setup = tiled_setup<W, T>();
  if (setup.err != cudaSuccess) return static_cast<int>(setup.err);
  p.n_splits = tiled_splits<W, T>(setup.wave, batch_heads, p.seq, head_dim, p.causal);
  if (p.n_splits > 1 && p.ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  p.n_tiles = (p.seq + k.rows - 1) / k.rows;
  const int64_t n_blocks =
      batch_heads * p.n_tiles * (head_dim / k.slice) * static_cast<int64_t>(p.n_splits);
  const int64_t n_rows = batch_heads * p.seq;
  if (n_blocks > INT_MAX || (n_rows + 3) / 4 > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  k.kernel<<<static_cast<unsigned>(n_blocks), k.threads, k.smem, stream>>>(p, head_dim);
  if (p.n_splits > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned grid = static_cast<unsigned>((n_rows + 3) / 4);
    if constexpr (W == Which::kDq) {
      flash_bwd_dq_merge_rows_kernel<T><<<grid, 128, 0, stream>>>(p, head_dim);
    } else {
      flash_bwd_dkv_merge_rows_kernel<T><<<grid, 128, 0, stream>>>(p, head_dim);
    }
  }
  *launched = k.family;
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
      if (head_dim <= 256) return static_cast<int>(cudaErrorInvalidValue);
      return launch_tiled<W, T>(p, batch_heads, head_dim, stream, launched);
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
    default: return tiled_splits_of<Which::kDq, T>(batch_heads, seq, head_dim, causal);
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

// the query splits the dk/dv launch of these shapes and mode takes (above
// head_dim 256 only): the float32 scratch it needs is n_splits * batch *
// heads * seq * 2 * head_dim elements when n_splits > 1 (none otherwise);
// minus the CUDA error code when the card could not be queried or the
// dtype is unknown
extern "C" int gordo_flash_attention_bwd_dkv_splits(int batch, int seq, int heads, int head_dim,
                                                    int dtype, int mode) {
  const int64_t batch_heads = static_cast<int64_t>(batch) * heads;
  if (batch <= 0 || seq <= 0 || heads <= 0) return 1;
  const bool causal = (mode & flash::kModeCausal) != 0;
  switch (dtype) {
    case 0: return tiled_splits_of<Which::kDkv, float>(batch_heads, seq, head_dim, causal);
    case 1: return tiled_splits_of<Which::kDkv, __nv_bfloat16>(batch_heads, seq, head_dim, causal);
    case 2: return tiled_splits_of<Which::kDkv, __half>(batch_heads, seq, head_dim, causal);
    case 3: return tiled_splits_of<Which::kDkv, double>(batch_heads, seq, head_dim, causal);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// dq and delta, replacing _bwd_dq_kernel (gordo_tpu/ops/flash_attention.py:176);
// q, k, v, out, d_out and lse in, dq and delta out.
// strides: (batch, seq, head) of q, k, v, out, d_out, dq, in that order;
// mode: bit 1 causal, bit 2 16-byte aligned rows of all six; workspace:
// the scratch gordo_flash_attention_bwd_dq_splits asks for (null when it
// asks for none); launched: set to the kernel family launched
// (flash::kFamily*)
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
// the scratch gordo_flash_attention_bwd_dkv_splits asks for (null when it
// asks for none); launched: set to the kernel family launched
// (flash::kFamily*)
extern "C" int gordo_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* d_out,
    const void* lse, const void* delta, void* dk, void* dv, void* workspace,
    int batch, int seq, int heads, int head_dim, int dtype,
    const long long* strides, float sm_scale, int mode, void* stream, int* launched) {
  Params p = {};
  p.ws = static_cast<float*>(workspace);
  p.n_splits = 1;
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
