// Flash-attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces gordo_tpu/ops/flash_attention.py::_attn_kernel, the Pallas TPU
// kernel launched by _flash_forward_bhsd: FlashAttention-2 online softmax
// over (batch, seq, heads, head_dim) inputs, emitting the output and the
// per-row log-sum-exp (LSE) of the scaled scores, with causal masking and
// keys past the sequence end masked to zero probability.
//
// What bounds it on this card. The kernel reads q, k, v once and writes
// out and the LSE. At the served shape (8192 windows x 64 steps x 4 heads
// x head_dim 16, fp32, causal) that is ~545 MB, 0.163 ms at 3.35 TB/s,
// against ~4.3 GFLOP of kept (query, key) work, 0.065 ms at the 67
// TFLOP/s fp32 rate: bound by bytes. At the training step's (32, 64, 4,
// 16) it moves 2.1 MB (0.6 us), so there the launch and the latency of
// one dependent load-then-compute pass per block are the limit.
//
// Design at head_dim 16 and 32 (flash_fwd_quad_kernel, the model's head
// sizes). Blocks of 4 warps own a run of query rows of one (batch, head).
// Each lane holds R query rows (times D/S of their head dims, the S lanes
// of a row's dims summing each dot with shuffles), and a quad of four
// lanes shares those rows: lane `quad` walks keys quad, quad + 4, ... of
// each 64-key tile, so a lane's serial chain is 16 keys, not 64. Every
// key or value element read from shared memory feeds R multiply-adds
// (R = 2, S = 1 at head_dim 16: half the shared-memory traffic per (row,
// key) pair of one row per lane; a 128-bit shared load delivers 512
// bytes a warp whatever it broadcasts). The quad shares one running max per row (a two-shuffle
// max per update); its partial sums and accumulators are merged once at
// the end in a fixed order (a butterfly reduce-scatter that leaves each
// lane a quarter of its dims to store), so a launch is deterministic.
// Causal tiles stop at each warp's last row, so no warp walks keys that
// the mask drops for all of its rows. q, k, v tiles are staged into
// shared memory with 16-byte cp.async copies when every row start is
// 16-byte aligned (the caller decides, mode bit 2), else element by
// element in the same kernel; output rows leave as 16-byte (fp32) or
// 8-byte (bf16) stores where a lane owns four dims. Several blocks per SM
// overlap one block's loads with another's math. Scores are kept in log2
// units (q is prescaled by sm_scale * log2 e) so each probability is one
// exp2. Everything stays on the fp32 CUDA cores: TF32 would break the
// 1e-4 float32 tolerance, and the served shape is bound by bytes anyway.
//
// At head_dim 64, 128 and 256 (flash_fwd_wide_kernel) the work per (row, key)
// pair is 4-8x larger and the grids are small (76 blocks at (2, 300, 2,
// 128)), so the kernel is bound by operations and by the latency of each
// block's serial key walk, not by bytes: the JAX package's long-context
// case (1, 8192, 4, 64), causal, is 34 GFLOP against 34 MB, 0.51 ms at the
// fp32 rate. It keeps the quad layout and adds what the wider rows need.
// A row's dims are split over S = 4 (head_dim 64) or 8 (128) lanes, so a
// lane holds 16 of them, and each lane owns R = 4 rows: every key or value
// element read from shared memory feeds four multiply-adds, and each
// (row, key) dot costs log2 S shuffles. Key and value tiles (64 keys at
// head_dim 64, 32 at 128) pass through a two-stage ring in dynamic shared
// memory: with mode bit 2 the 16-byte cp.async copies of tile t + 1 are in
// flight while the block works on tile t, and otherwise the same ring is
// filled element by element. q rows go from device memory straight to
// registers. R, S, the warps per block (8 at 64, 4 at 128) and the tile
// were chosen by timing tilings on the card (scripts/flash_tiling_sweep.py,
// PERF.md): ptxas fits both widths at 254 registers in float32 with no
// spill, one 8-warp or two 4-warp blocks per SM; R = 2 tilings (136-148
// registers, three blocks per SM) ran slower. Blocks run the row tiles
// last to first across all heads, so a causal launch starts with its
// longest key walks. Where the row tiles alone leave the card's SMs idle,
// the key axis is split across blocks (at most 8 splits, as many as keep
// one wave; a causal launch counts half its blocks): each split writes its
// rows unnormalised with their (max, sum) to a float32 scratch the caller
// allocates, and flash_fwd_merge_kernel sums the splits in split order, so
// a launch stays deterministic. Neither kernel pads head_dim to 128 lanes
// or broadcasts row statistics over lanes: those exist only for Mosaic's
// (8, 128) tiling; the wrapper pads a head_dim off 16/32/64/128/256 to the
// next of them. At head_dim 256 a row's dims span S = 8 lanes of 32 dims
// each (the quad's four lanes times S fill the warp), so a lane holds R =
// 2 rows and the block's ring holds 16-key tiles (66.5 KB in float32);
// ptxas fits it at 231 registers in float32 with no spill.
//
// bfloat16 and float16 at head_dim 64 and 128 (flash_fwd_mma_kernel) go
// to the tensor cores: on the CUDA cores the long-context bf16 case took
// 1.80 ms against SDPA's 0.12 (PERF.md), and its bound at the 989 TFLOP/s
// bf16 rate is 0.035 ms. The design is FlashAttention-2's. A block of 4
// warps owns 64 query rows, each warp 16; key and value tiles of 64 keys
// pass through a two-stage cp.async ring (rows padded by 16 bytes, so the
// eight rows of an ldmatrix fall on distinct banks). The warp's q rows
// are loaded once as mma A fragments; S = Q Kᵀ is mma.sync m16n8k16 with
// float32 accumulators (flash_mma.cuh), scaled by sm_scale * log2 e in
// float32 (scores in log2 units, one ex2.approx a probability) and masked
// where the mask drops a pair of the tile for the warp's rows (a
// warp-uniform test); the online softmax keeps each row's max and sum in
// float32 registers, reduced over the four lanes that hold the row. P stays in the
// registers it was computed in, which are the A operand of O += P V (the
// C layout of two neighbouring 8-column tiles is the A layout of their
// 16 columns), and V comes in by ldmatrix.trans. P is not rounded once to
// the input type, as SDPA and FlashAttention do: one rounding moved some
// bf16 results by a 1-ulp step of 0.031 at magnitudes of 4 and up, past
// the 2e-2 tolerance the plain version is held to (which keeps P in
// float32, as the Pallas kernel does). So P is split into two terms of
// the input type, head = round(P) and tail = round(P - head), and both
// go through the tensor cores against the same V fragments: P is then
// carried to about 16 bits (bf16) or 22 (float16) of mantissa, at the
// cost of a third more products. From the wide kernel it keeps the
// heavy-first block order, the warp-uniform causal stop (a warp skips the
// tiles past its last row), the masked diagonal tile and the key split
// with flash_fwd_merge_kernel for grids under one wave, writing the same
// partial rows. ptxas: 156 / 219 registers at 64 / 128 in bf16 (167 / 215
// in float16), no spill; two blocks an SM or more. 64-key tiles beat
// 32-key ones at head_dim 128 on long sequences (scripts/flash_tiling_sweep.py). float32 keeps the wide kernel
// (TF32 would break its 1e-4 tolerance), and float64 too.
//
// Any head_dim above 256 (flash_fwd_sliced_kernel, the width a run-time
// argument, as the JAX wrapper pads any head_dim to a multiple of 128; no
// upper limit) is bound by operations like the wide kernels: (2, 300, 2,
// 300) causal at 384 is 0.21 GFLOP, 3.2 us at the fp32 rate, against 4.8 MB.
// The grid is (row tiles, slices of the output's width, batch*heads): a
// block owns 32 query rows and 128 of their output columns, so a small
// launch such as (2, 300, 2, 300) still fills 120 blocks, and a key split
// through flash_fwd_merge_rows_kernel fills the rest of the wave. The
// scores are summed over the whole width in 64-column chunks of q and of
// a 64-key tile, staged through a two-stage cp.async ring (element by
// element without mode bit 2); each of the block's 128 threads holds a 4
// rows x 4 keys register tile of the scores (16 threads across a row's
// keys, 8 down the rows), so a staged element feeds 4 multiply-adds, not
// one as in a warp-per-row design. The online softmax runs in float32
// registers in exp2 units, each row's max and sum over its 16 threads by
// a fixed butterfly; P goes through shared memory and O += P V runs on the
// slice's 128 value columns, staged while the scores are summed, each
// thread holding 4 rows x 8 columns of O. Every slice recomputes the
// scores, (slices + 1) / 2 times the pair work of one pass: 2x at 384, 3x
// at 640, 8.5x at 2048. The sweep (scripts/flash_tiling_sweep.py, PERF.md)
// kept 128-column slices: 64-column ones (more recomputed scores, less
// work a block) ran 6-16% slower except at 2048, and a slice of 128
// divides every padded width. 64-column chunks at two blocks an SM (216
// registers, no spill) beat 32-column ones at three (168, a 28-byte
// spill) by 1-20%, with half the barriers. 16-row blocks won 5-12% at (2,
// 300, 2, 300) and 45% on the 32-block grid of (1, 64, 1, 2048), but lost
// 16% at the phase-7 model's (4, 256, 2, 300) and 33% at (1, 256, 2, 640).
// bfloat16 and float16
// are staged in their own type and summed in float32 on the CUDA cores;
// float64 is staged as float32. The old warp-per-row forward read both
// operands of every multiply-add from shared memory and reached 1% of its
// bound (PERF.md).
//
// Inputs are float32, bfloat16, float16 or float64 (dtype 0 / 1 / 2 / 3),
// each element converted to float32 on load and every sum in float32, as
// the Pallas kernel does; a float64 tile is staged in shared memory as
// float32. head_dim is 16, 32, 64, 128, 256 or any multiple of 128 above
// 256; any sequence length. Strides are in elements; the head dim must be
// contiguous. `mode` is a bit set: 1 causal, 2 every row start of q, k, v
// and out 16-byte aligned. The kernels allocate nothing and run on the
// caller's stream. The entry point returns the CUDA error code of the
// launch (0 on success) and writes the family of the kernel it launched
// (flash::kFamily*) to its last argument.

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
  // key splits (wide kernel): each split's unnormalised rows, then its
  // (max, sum) pairs, in float32 (the caller's scratch)
  float* ws;
  int n_splits;
  int batch_heads;
  int heads;
  int seq;
  int n_qtiles;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  float sm_scale;
  int causal;
  int vec;
};

// The quad layout at head_dim 64, 128 and 256, with more of the work in flight:
// kWarps warps a block, lane rows loaded straight into registers, and key
// and value tiles of kTile rows staged through a two-stage ring in dynamic
// shared memory, so the copies of tile t + 1 run under the math on tile t.
template <typename T, int D, int R, int S, int kWarps, int kTile, int kMinBlocks>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
    flash_fwd_wide_kernel(const Params p) {
  using E = flash::staged_t<T>;
  constexpr int kThreads = kWarps * 32;
  constexpr int kDims = D / S;                          // head dims a lane holds
  constexpr int kWarpRows = R * (32 / (flash::kQuad * S));
  constexpr int kRows = flash::quad_rows<R, S, kWarps>();
  constexpr int kPitch = D + 16 / sizeof(E);  // padded row: 16-byte aligned, no bank conflicts
  constexpr int kStage = kTile * kPitch;      // elements of one staged tile
  constexpr int kLaneKeys = kTile / flash::kQuad;  // keys a lane walks per tile
  constexpr int kUpdate = kLaneKeys < 16 / R ? kLaneKeys : 16 / R;  // keys per softmax update
  static_assert(kLaneKeys % kUpdate == 0, "a tile holds whole softmax updates");
  extern __shared__ __align__(16) unsigned char smem[];
  E* k_ring = reinterpret_cast<E*>(smem);  // [2][kStage]
  E* v_ring = k_ring + 2 * kStage;         // [2][kStage]

  // block = (row tile, batch*head, key split), split fastest; the row
  // tiles run last to first across all heads, so causal launches start
  // with their longest key walks
  const int split = blockIdx.x % p.n_splits;
  const int tile = blockIdx.x / p.n_splits;
  const int bh = tile % p.batch_heads;
  const int qt = p.n_qtiles - 1 - tile / p.batch_heads;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int part = lane % S;                         // which kDims of each row
  const int quad = (lane / S) & (flash::kQuad - 1);  // which keys of each tile
  const int row0 = warp * kWarpRows + (lane / (flash::kQuad * S)) * R;  // lane's rows: row0 + r
  const int seq = p.seq;
  const int q0 = qt * kRows;
  const bool vec = p.vec;

  const T* q_head = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k_head = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v_head = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  // keys the block needs, and keys the warp's rows need: all lanes of a
  // warp walk the same keys, so causal work above a warp's rows is skipped
  const int k_end = p.causal ? min(seq, q0 + kRows) : seq;
  const int warp_k_end = p.causal ? min(seq, q0 + warp * kWarpRows + kWarpRows) : seq;
  // this split's run of the block's key tiles
  const int n_tiles = (k_end + kTile - 1) / kTile;
  const int split_tiles = (n_tiles + p.n_splits - 1) / p.n_splits;
  const int t_begin = min(n_tiles, split * split_tiles);
  const int t_end = min(n_tiles, t_begin + split_tiles);

  if (t_begin < t_end) {
    E* k_first = k_ring + (t_begin & 1) * kStage;
    E* v_first = v_ring + (t_begin & 1) * kStage;
    flash::stage_rows<T, D, kPitch, kTile, kThreads>(k_first, k_head, p.k_ss, t_begin * kTile,
                                                     k_end, vec);
    flash::stage_rows<T, D, kPitch, kTile, kThreads>(v_first, v_head, p.v_ss, t_begin * kTile,
                                                     k_end, vec);
  }
  flash::cp_async_commit();

  // the lane's q rows (prescaled: scores in log2 units); rows past the
  // sequence end compute on a clamped copy and store nothing
  const float q_scale = p.sm_scale * flash::kLog2e;
  float qr[R][kDims];
  float acc[R][kDims];
  float m[R];
  float l[R];  // this lane's share of each row's sum
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qc = min(q0 + row0 + r, seq - 1);
    flash::load_row<T, kDims>(q_head + static_cast<int64_t>(qc) * p.q_ss + part * kDims, qr[r],
                              vec);
    m[r] = flash::kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int d = 0; d < kDims; ++d) {
      qr[r][d] *= q_scale;
      acc[r][d] = 0.f;
    }
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kTile;
    if (t + 1 < t_end) {  // the next tile into the other stage
      E* k_next = k_ring + ((t + 1) & 1) * kStage;
      E* v_next = v_ring + ((t + 1) & 1) * kStage;
      flash::stage_rows<T, D, kPitch, kTile, kThreads>(k_next, k_head, p.k_ss, k0 + kTile, k_end,
                                                       vec);
      flash::stage_rows<T, D, kPitch, kTile, kThreads>(v_next, v_head, p.v_ss, k0 + kTile, k_end,
                                                       vec);
    }
    flash::cp_async_commit();
    flash::cp_async_wait<1>();  // tile t has landed
    __syncthreads();
    const E* k_tile = k_ring + (t & 1) * kStage;
    const E* v_tile = v_ring + (t & 1) * kStage;
    // keys quad + 4i of the tile, i < n (uniform across the warp)
    const int n = min(kLaneKeys, (warp_k_end - k0 + flash::kQuad - 1) / flash::kQuad);
#pragma unroll
    for (int c0 = 0; c0 < kLaneKeys; c0 += kUpdate) {
      if (c0 >= n) break;
      float s[R][kUpdate];
      float chunk_max[R];
#pragma unroll
      for (int r = 0; r < R; ++r) chunk_max[r] = flash::kNegInf;
#pragma unroll
      for (int i = 0; i < kUpdate; ++i) {
#pragma unroll
        for (int r = 0; r < R; ++r) s[r][i] = flash::kNegInf;
        if (c0 + i < n) {
          const int j = quad + (c0 + i) * flash::kQuad;
          const E* k_row = k_tile + j * kPitch + part * kDims;
          float dot[R];
#pragma unroll
          for (int r = 0; r < R; ++r) dot[r] = 0.f;
#pragma unroll
          for (int d = 0; d < kDims; d += 4) {
            const float4 kv = flash::load4(k_row + d);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              dot[r] = fmaf(qr[r][d], kv.x, dot[r]);
              dot[r] = fmaf(qr[r][d + 1], kv.y, dot[r]);
              dot[r] = fmaf(qr[r][d + 2], kv.z, dot[r]);
              dot[r] = fmaf(qr[r][d + 3], kv.w, dot[r]);
            }
          }
          const int kpos = k0 + j;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float score = flash::dim_sum<S>(dot[r]);
            if (kpos < seq && (!p.causal || kpos <= q0 + row0 + r)) s[r][i] = score;
            chunk_max[r] = fmaxf(chunk_max[r], s[r][i]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float m_new = fmaxf(m[r], flash::quad_max<S>(chunk_max[r]));
        const float alpha = exp2f(m[r] - m_new);
        l[r] *= alpha;
#pragma unroll
        for (int d = 0; d < kDims; ++d) acc[r][d] *= alpha;
        m[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < kUpdate; ++i) {
        if (c0 + i < n) {
          const E* v_row = v_tile + (quad + (c0 + i) * flash::kQuad) * kPitch + part * kDims;
          float pr[R];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            pr[r] = s[r][i] == flash::kNegInf ? 0.f : exp2f(s[r][i] - m[r]);
            l[r] += pr[r];
          }
#pragma unroll
          for (int d = 0; d < kDims; d += 4) {
            const float4 vv = flash::load4(v_row + d);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              acc[r][d] = fmaf(pr[r], vv.x, acc[r][d]);
              acc[r][d + 1] = fmaf(pr[r], vv.y, acc[r][d + 1]);
              acc[r][d + 2] = fmaf(pr[r], vv.z, acc[r][d + 2]);
              acc[r][d + 3] = fmaf(pr[r], vv.w, acc[r][d + 3]);
            }
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // merge the quad: each row's sum, and a quarter of the lane's dims per
  // lane; with one split the row is done, else its partial row goes to
  // the scratch for flash_fwd_merge_kernel
  const int64_t n_rows = static_cast<int64_t>(p.batch_heads) * seq;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float l_row = flash::quad_sum<S>(l[r]);  // one split: >= 1, the row's largest term is exp2(0)
    float o[kDims / 4];
    flash::quad_reduce_scatter<kDims, S>(acc[r], o, quad);
    const int qpos = q0 + row0 + r;
    if (qpos >= seq) continue;
    const int d0 = part * kDims + quad * (kDims / 4);
    const int64_t row = static_cast<int64_t>(bh) * seq + qpos;
    if (p.n_splits == 1) {
      T* o_row = static_cast<T*>(p.out) + b * p.o_sb + static_cast<int64_t>(qpos) * p.o_ss +
                 h * p.o_sh + d0;
      flash::store_row<T, kDims / 4>(o_row, o, 1.f / l_row, vec);
      if (quad == 0 && part == 0) p.lse[row] = (m[r] + log2f(l_row)) * flash::kLn2;
    } else {
      const int64_t at = split * n_rows + row;
      flash::store_row<float, kDims / 4>(p.ws + at * D + d0, o, 1.f, true);
      if (quad == 0 && part == 0) {
        reinterpret_cast<float2*>(p.ws + p.n_splits * n_rows * D)[at] = make_float2(m[r], l_row);
      }
    }
  }
}

// Merge the key splits of the wide kernel: one warp per (batch*head, row)
// sums the splits' rows in split order, each weighted by exp2(its max -
// the row's max), and writes the output row and its LSE.
template <typename T, int D>
__global__ void __launch_bounds__(128) flash_fwd_merge_kernel(const Params p) {
  constexpr int kLaneDims = D / 32;
  const int64_t n_rows = static_cast<int64_t>(p.batch_heads) * p.seq;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 4 + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int lane = threadIdx.x & 31;
  const float2* stats = reinterpret_cast<const float2*>(p.ws + p.n_splits * n_rows * D);
  float m_row = flash::kNegInf;
  for (int s = 0; s < p.n_splits; ++s) m_row = fmaxf(m_row, stats[s * n_rows + row].x);
  float l_row = 0.f;
  float acc[kLaneDims] = {};
  for (int s = 0; s < p.n_splits; ++s) {
    const float2 st = stats[s * n_rows + row];
    const float w = exp2f(st.x - m_row);  // 0 for a split that saw no key of the row
    l_row = fmaf(w, st.y, l_row);
    const float* part = p.ws + (s * n_rows + row) * D + lane * kLaneDims;
#pragma unroll
    for (int d = 0; d < kLaneDims; ++d) acc[d] = fmaf(w, part[d], acc[d]);
  }
  const int bh = static_cast<int>(row / p.seq);
  const int qpos = static_cast<int>(row - static_cast<int64_t>(bh) * p.seq);
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  T* o_row = static_cast<T*>(p.out) + b * p.o_sb + static_cast<int64_t>(qpos) * p.o_ss +
             h * p.o_sh + lane * kLaneDims;
#pragma unroll
  for (int d = 0; d < kLaneDims; ++d) o_row[d] = flash::from_float<T>(acc[d] / l_row);
  if (lane == 0) p.lse[row] = (m_row + log2f(l_row)) * flash::kLn2;
}

// The bfloat16/float16 forward at head_dim 64 and 128 on the tensor cores:
// 4 warps of 16 query rows a block, key and value tiles of kTile keys
// through a two-stage cp.async ring, S = Q Kᵀ and O += P V by
// mma.sync.m16n8k16 with float32 accumulators (see flash_mma.cuh), the
// online softmax in float32 registers. Block order and key splits as in
// flash_fwd_wide_kernel, whose partial-row format the splits write.
constexpr int kMmaWarps = 4;
constexpr int kMmaRows = 16 * kMmaWarps;  // query rows a block owns

template <typename T, int D, int kTile, int kMinBlocks>
__global__ void __launch_bounds__(kMmaWarps * 32, kMinBlocks)
    flash_fwd_mma_kernel(const Params p) {
  constexpr int kThreads = kMmaWarps * 32;
  constexpr int kPitch = D + 8;  // 16 bytes of padding a row: ldmatrix rows on distinct banks
  constexpr int kStage = kTile * kPitch;
  constexpr int kKChunks = D / 16;    // 16-wide steps over head_dim in S = Q Kᵀ
  constexpr int kNTiles = kTile / 8;  // 8-key score tiles of a staged tile
  constexpr int kDTiles = D / 8;      // 8-wide output tiles
  static_assert(kTile % 16 == 0 && D % 16 == 0, "whole 16 x 16 blocks");
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_tile = reinterpret_cast<T*>(smem);  // [kMmaRows][kPitch]
  T* k_ring = q_tile + kMmaRows * kPitch;  // [2][kStage]
  T* v_ring = k_ring + 2 * kStage;         // [2][kStage]

  // block = (row tile, batch*head, key split), split fastest; row tiles
  // last to first across all heads (causal launches start with their
  // longest key walks)
  const int split = blockIdx.x % p.n_splits;
  const int tile = blockIdx.x / p.n_splits;
  const int bh = tile % p.batch_heads;
  const int qt = p.n_qtiles - 1 - tile / p.batch_heads;
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

  const T* q_head = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k_head = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v_head = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  // keys the block needs, and keys the warp's rows need (a causal warp
  // skips the tiles past its last row, a warp-uniform branch)
  const int k_end = p.causal ? min(seq, q0 + kMmaRows) : seq;
  const int warp_k_end = p.causal ? min(seq, q0 + warp * 16 + 16) : seq;
  const int n_tiles = (k_end + kTile - 1) / kTile;
  const int split_tiles = (n_tiles + p.n_splits - 1) / p.n_splits;
  const int t_begin = min(n_tiles, split * split_tiles);
  const int t_end = min(n_tiles, t_begin + split_tiles);

  auto stage = [&](int t) {
    flash::stage_rows<T, D, kPitch, kTile, kThreads>(k_ring + (t & 1) * kStage, k_head, p.k_ss,
                                                     t * kTile, k_end, vec);
    flash::stage_rows<T, D, kPitch, kTile, kThreads>(v_ring + (t & 1) * kStage, v_head, p.v_ss,
                                                     t * kTile, k_end, vec);
  };
  flash::stage_rows<T, D, kPitch, kMmaRows, kThreads>(q_tile, q_head, p.q_ss, q0, seq, vec);
  if (t_begin < t_end) stage(t_begin);
  flash::cp_async_commit();
  flash::cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[kKChunks][4];  // the warp's 16 q rows as A fragments, loaded once
#pragma unroll
  for (int kc = 0; kc < kKChunks; ++kc) {
    flash::ldmatrix_x4(qa[kc], flash::a_rows(q_tile, kPitch, warp * 16, kc * 16, lane));
  }

  const float scale_log2 = p.sm_scale * flash::kLog2e;  // scores in log2 units
  float o[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g and g + 8
  float l[2] = {0.f, 0.f};              // this lane's share of each row's sum

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kTile;
    if (t + 1 < t_end) stage(t + 1);  // the next tile into the other stage
    flash::cp_async_commit();
    flash::cp_async_wait<1>();  // tile t has landed
    __syncthreads();
    const T* k_tile = k_ring + (t & 1) * kStage;
    const T* v_tile = v_ring + (t & 1) * kStage;
    if (k0 < warp_k_end) {
      // S = Q Kᵀ, 16 rows x kTile keys
      float s[kNTiles][4];
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < kKChunks; ++kc) {
#pragma unroll
        for (int np = 0; np < kNTiles / 2; ++np) {
          uint32_t kb[4];
          flash::ldmatrix_x4(kb, flash::b_rows(k_tile, kPitch, np * 16, kc * 16, lane));
          flash::mma_16816<T>(s[2 * np], qa[kc], kb[0], kb[1]);
          flash::mma_16816<T>(s[2 * np + 1], qa[kc], kb[2], kb[3]);
        }
      }
      // scale, and mask unless the mask keeps the whole tile for the
      // warp's rows (a warp-uniform test); each row's tile max over the
      // four lanes that hold it
      const bool whole = k0 + kTile <= seq && (!p.causal || k0 + kTile <= q0 + warp * 16 + 1);
      float mx[2] = {-INFINITY, -INFINITY};
      if (whole) {
#pragma unroll
        for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] *= scale_log2;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + 8 * j + 2 * t4 + (e & 1);
            const bool keep = kpos < seq && (!p.causal || kpos <= row_a + (e >> 1) * 8);
            s[j][e] = keep ? s[j][e] * scale_log2 : -INFINITY;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
          }
        }
      }
      float base[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        base[r] = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet
        const float alpha = flash::exp2_approx(m[r] - base[r]);
        l[r] *= alpha;
#pragma unroll
        for (int dt = 0; dt < kDTiles; ++dt) {
          o[dt][2 * r] *= alpha;
          o[dt][2 * r + 1] *= alpha;
        }
        m[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = flash::exp2_approx(s[j][e] - base[e >> 1]);
          l[e >> 1] += s[j][e];
        }
      }
      // O += P V: P in place as the A operand, split into two terms of T
      // (head + tail), each multiplied by the same V fragments
#pragma unroll
      for (int kc = 0; kc < kTile / 16; ++kc) {
        uint32_t ph[4];
        uint32_t pt[4];
        flash::split_a<T>(ph, pt, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t vb[4];
          flash::ldmatrix_x4_trans(vb, flash::bt_rows(v_tile, kPitch, kc * 16, dp * 16, lane));
          flash::mma_16816<T>(o[2 * dp], ph, vb[0], vb[1]);
          flash::mma_16816<T>(o[2 * dp + 1], ph, vb[2], vb[3]);
          flash::mma_16816<T>(o[2 * dp], pt, vb[0], vb[1]);
          flash::mma_16816<T>(o[2 * dp + 1], pt, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // each row's sum over its four lanes; with one split the row is done,
  // else its unnormalised row and (max, sum) go to the scratch
  const int64_t n_rows = static_cast<int64_t>(p.batch_heads) * seq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qpos = row_a + 8 * r;
    if (qpos >= seq) continue;
    const int64_t row = static_cast<int64_t>(bh) * seq + qpos;
    if (p.n_splits == 1) {
      const float inv = 1.f / l[r];  // >= 1: the row's largest term is exp2(0)
      T* o_row = static_cast<T*>(p.out) + b * p.o_sb + static_cast<int64_t>(qpos) * p.o_ss +
                 h * p.o_sh;
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt) {
        const int col = dt * 8 + 2 * t4;
        const float x0 = o[dt][2 * r] * inv;
        const float x1 = o[dt][2 * r + 1] * inv;
        if (vec) {
          *reinterpret_cast<uint32_t*>(o_row + col) = flash::pack2<T>(x0, x1);
        } else {
          o_row[col] = flash::from_float<T>(x0);
          o_row[col + 1] = flash::from_float<T>(x1);
        }
      }
      if (t4 == 0) p.lse[row] = (m[r] + log2f(l[r])) * flash::kLn2;
    } else {
      const int64_t at = split * n_rows + row;
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt) {
        *reinterpret_cast<float2*>(p.ws + at * D + dt * 8 + 2 * t4) =
            make_float2(o[dt][2 * r], o[dt][2 * r + 1]);
      }
      if (t4 == 0) {
        reinterpret_cast<float2*>(p.ws + p.n_splits * n_rows * D)[at] = make_float2(m[r], l[r]);
      }
    }
  }
}

// The forward at any head_dim above 256 (the width D a run-time argument,
// a multiple of kSlice): a block owns kRows query rows of one (batch,
// head) and kSlice columns of their output, and walks its key tiles of
// kKeys keys. The scores are summed over the whole width: kChunk-wide
// chunks of the block's q rows and of the key tile pass through a
// two-stage ring, and each thread holds a register tile of TM rows x TN
// keys (rows ty + kRowGroups i, keys tx + 16 j), so a staged q element
// feeds TN multiply-adds and a key element TM. The online softmax runs in
// float32 registers in log2 units, each row's max and sum over the 16
// threads that share it; P passes through shared memory, and O += P V
// runs on the slice's columns of the value tile, staged while the scores
// are summed. Block order (row tiles last to first) and key splits as in
// flash_fwd_wide_kernel; the splits' partial rows go to
// flash_fwd_merge_rows_kernel.
template <typename T, int kRows, int kKeys, int kChunk, int kSlice, int kWarps, int kMinBlocks>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
    flash_fwd_sliced_kernel(const Params p, int D) {
  using E = flash::staged_t<T>;
  constexpr int kThreads = kWarps * 32;
  constexpr int kLanes = 16;                     // threads across a row's keys and columns
  constexpr int kRowGroups = kThreads / kLanes;  // threads down the row tile
  constexpr int TM = kRows / kRowGroups;         // query rows a thread holds
  constexpr int TN = kKeys / kLanes;             // keys a thread scores per tile
  constexpr int TC = kSlice / (4 * kLanes);      // output float4s a thread holds per row
  constexpr int kQPitch = kChunk + 16 / sizeof(E);  // padded rows: 16-byte aligned
  constexpr int kVPitch = kSlice + 16 / sizeof(E);
  constexpr int kPPitch = kKeys + 4;
  constexpr int kStage = (kRows + kKeys) * kQPitch;  // a q chunk and a key chunk
  static_assert(kRows % kRowGroups == 0 && kKeys % kLanes == 0 && kSlice % (4 * kLanes) == 0 &&
                    kChunk % 4 == 0 && (kChunk * sizeof(E)) % 16 == 0,
                "whole register tiles and 16-byte chunks");
  extern __shared__ __align__(16) unsigned char smem[];
  E* ring = reinterpret_cast<E*>(smem);  // [2][kRows + kKeys][kQPitch]
  E* v_tile = ring + 2 * kStage;         // [kKeys][kVPitch]
  float* p_tile = reinterpret_cast<float*>(v_tile + kKeys * kVPitch);  // [kRows][kPPitch]

  // block = (row tile, batch*head, slice, key split), split fastest, then
  // the slice; the row tiles run last to first across all heads, so causal
  // launches start with their longest key walks
  const int n_slices = D / kSlice;
  const int split = blockIdx.x % p.n_splits;
  const int rest = blockIdx.x / p.n_splits;
  const int slice = rest % n_slices;
  const int tile = rest / n_slices;
  const int bh = tile % p.batch_heads;
  const int qt = p.n_qtiles - 1 - tile / p.batch_heads;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int tx = threadIdx.x % kLanes;
  const int ty = threadIdx.x / kLanes;
  const int seq = p.seq;
  const int q0 = qt * kRows;
  const bool vec = p.vec;

  const T* q_head = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k_head = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v_head = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh + slice * kSlice;
  const int k_end = p.causal ? min(seq, q0 + kRows) : seq;
  // this split's run of the block's key tiles
  const int n_tiles = (k_end + kKeys - 1) / kKeys;
  const int split_tiles = (n_tiles + p.n_splits - 1) / p.n_splits;
  const int t_begin = min(n_tiles, split * split_tiles);
  const int t_end = min(n_tiles, t_begin + split_tiles);
  const int n_chunks = D / kChunk;

  // chunk c of the q rows and of key tile t into ring stage s
  auto stage_qk = [&](int t, int c, int s) {
    E* q_dst = ring + s * kStage;
    flash::stage_rows<T, kChunk, kQPitch, kRows, kThreads>(q_dst, q_head + c * kChunk, p.q_ss, q0,
                                                           seq, vec);
    flash::stage_rows<T, kChunk, kQPitch, kKeys, kThreads>(
        q_dst + kRows * kQPitch, k_head + c * kChunk, p.k_ss, t * kKeys, k_end, vec);
  };

  const float scale_log2 = p.sm_scale * flash::kLog2e;  // scores in log2 units
  float o[TM][4 * TC];
  float m[TM];
  float l[TM];  // this thread's share of each row's sum
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * TC; ++c) o[i][c] = 0.f;
  }

  if (t_begin < t_end) stage_qk(t_begin, 0, 0);
  flash::cp_async_commit();
  int it = 0;  // chunks walked: chunk `it` sits in ring stage it & 1
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kKeys;
    // the slice's value columns of this tile (every thread is past the
    // last tile's P V: the __syncthreads that ends it)
    flash::stage_rows<T, kSlice, kVPitch, kKeys, kThreads>(v_tile, v_head, p.v_ss, k0, k_end, vec);
    flash::cp_async_commit();
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
    }
    for (int c = 0; c < n_chunks; ++c, ++it) {
      // this chunk has landed (at c = 0 the value tile may still be in flight)
      if (c == 0) {
        flash::cp_async_wait<1>();
      } else {
        flash::cp_async_wait<0>();
      }
      __syncthreads();  // ... for every thread, and every thread is done with the other stage
      if (c + 1 < n_chunks) {
        stage_qk(t, c + 1, (it + 1) & 1);
      } else if (t + 1 < t_end) {
        stage_qk(t + 1, 0, (it + 1) & 1);
      }
      flash::cp_async_commit();
      const E* q_chunk = ring + (it & 1) * kStage;
      const E* k_chunk = q_chunk + kRows * kQPitch;
#pragma unroll
      for (int d = 0; d < kChunk; d += 4) {
        float4 qv[TM];
        float4 kv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) qv[i] = flash::load4(q_chunk + (ty + kRowGroups * i) * kQPitch + d);
#pragma unroll
        for (int j = 0; j < TN; ++j) kv[j] = flash::load4(k_chunk + (tx + kLanes * j) * kQPitch + d);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
          }
        }
      }
    }

    // scale and mask (unless the mask keeps the whole tile), then the
    // online softmax; P to shared memory
    const bool whole = k0 + kKeys <= seq && (!p.causal || k0 + kKeys - 1 <= q0);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qpos = q0 + ty + kRowGroups * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int kpos = k0 + tx + kLanes * j;
        const bool keep = whole || (kpos < seq && (!p.causal || kpos <= qpos));
        s[i][j] = keep ? s[i][j] * scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int offset = 1; offset < kLanes; offset <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, offset));
      }
      const float m_new = fmaxf(m[i], mx);
      const float base = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet
      const float alpha = exp2f(m[i] - base);
      l[i] *= alpha;
#pragma unroll
      for (int c = 0; c < 4 * TC; ++c) o[i][c] *= alpha;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float pr = exp2f(s[i][j] - base);
        l[i] += pr;
        p_tile[(ty + kRowGroups * i) * kPPitch + tx + kLanes * j] = pr;
      }
    }
    flash::cp_async_wait<1>();  // the value tile has landed (the next tile's first chunk may not)
    __syncthreads();
    // O += P V on the slice's columns: this thread's TM rows x 4 TC columns
#pragma unroll 2
    for (int j = 0; j < kKeys; j += 4) {
      float4 pv[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        pv[i] = *reinterpret_cast<const float4*>(p_tile + (ty + kRowGroups * i) * kPPitch + j);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const E* v_row = v_tile + (j + jj) * kVPitch + 4 * tx;
#pragma unroll
        for (int c = 0; c < TC; ++c) {
          const float4 vv = flash::load4(v_row + 4 * kLanes * c);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float pr = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y : jj == 2 ? pv[i].z : pv[i].w;
            o[i][4 * c] = fmaf(pr, vv.x, o[i][4 * c]);
            o[i][4 * c + 1] = fmaf(pr, vv.y, o[i][4 * c + 1]);
            o[i][4 * c + 2] = fmaf(pr, vv.z, o[i][4 * c + 2]);
            o[i][4 * c + 3] = fmaf(pr, vv.w, o[i][4 * c + 3]);
          }
        }
      }
    }
    __syncthreads();  // every thread is done with P and the value tile
  }

  // each row's sum over its 16 threads (a fixed butterfly); with one
  // split the rows are done, else the partial rows and (max, sum) go to
  // the scratch for flash_fwd_merge_rows_kernel
  const int64_t n_rows = static_cast<int64_t>(p.batch_heads) * seq;
  const int col0 = slice * kSlice + 4 * tx;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float l_row = l[i];
#pragma unroll
    for (int offset = 1; offset < kLanes; offset <<= 1) {
      l_row += __shfl_xor_sync(0xffffffffu, l_row, offset);
    }
    const int qpos = q0 + ty + kRowGroups * i;
    if (qpos >= seq) continue;
    const int64_t row = static_cast<int64_t>(bh) * seq + qpos;
    if (p.n_splits == 1) {
      const float inv = 1.f / l_row;  // >= 1: the row's largest term is exp2(0)
      T* o_row = static_cast<T*>(p.out) + b * p.o_sb + static_cast<int64_t>(qpos) * p.o_ss +
                 h * p.o_sh + col0;
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        flash::store4(o_row + 4 * kLanes * c,
                      make_float4(o[i][4 * c] * inv, o[i][4 * c + 1] * inv, o[i][4 * c + 2] * inv,
                                  o[i][4 * c + 3] * inv),
                      vec);
      }
      if (slice == 0 && tx == 0) p.lse[row] = (m[i] + log2f(l_row)) * flash::kLn2;
    } else {
      const int64_t at = split * n_rows + row;
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        flash::store4(p.ws + at * D + col0 + 4 * kLanes * c,
                      make_float4(o[i][4 * c], o[i][4 * c + 1], o[i][4 * c + 2], o[i][4 * c + 3]),
                      true);
      }
      if (slice == 0 && tx == 0) {
        reinterpret_cast<float2*>(p.ws + p.n_splits * n_rows * D)[at] = make_float2(m[i], l_row);
      }
    }
  }
}

// Merge the key splits of the sliced forward (the width D at run time):
// flash_fwd_merge_kernel's sums, one warp a row, the lanes striding over
// the width.
template <typename T>
__global__ void __launch_bounds__(128) flash_fwd_merge_rows_kernel(const Params p, int D) {
  const int64_t n_rows = static_cast<int64_t>(p.batch_heads) * p.seq;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 4 + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int lane = threadIdx.x & 31;
  const float2* stats = reinterpret_cast<const float2*>(p.ws + p.n_splits * n_rows * D);
  float m_row = flash::kNegInf;
  for (int s = 0; s < p.n_splits; ++s) m_row = fmaxf(m_row, stats[s * n_rows + row].x);
  float w[flash::kMaxSplits];
  float l_row = 0.f;
  for (int s = 0; s < p.n_splits; ++s) {
    const float2 st = stats[s * n_rows + row];
    w[s] = exp2f(st.x - m_row);  // 0 for a split that saw no key of the row
    l_row = fmaf(w[s], st.y, l_row);
  }
  const int bh = static_cast<int>(row / p.seq);
  const int qpos = static_cast<int>(row - static_cast<int64_t>(bh) * p.seq);
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  T* o_row = static_cast<T*>(p.out) + b * p.o_sb + static_cast<int64_t>(qpos) * p.o_ss + h * p.o_sh;
  for (int d = lane; d < D; d += 32) {
    float acc = 0.f;
    for (int s = 0; s < p.n_splits; ++s) acc = fmaf(w[s], p.ws[(s * n_rows + row) * D + d], acc);
    o_row[d] = flash::from_float<T>(acc / l_row);
  }
  if (lane == 0) p.lse[row] = (m_row + log2f(l_row)) * flash::kLn2;
}

template <typename T, int D, int R, int S, int kMinBlocks>
__global__ void __launch_bounds__(flash::kQuadThreads, kMinBlocks)
    flash_fwd_quad_kernel(const Params p) {
  using E = flash::staged_t<T>;
  constexpr int kDims = D / S;                          // head dims a lane holds
  constexpr int kWarpRows = R * (32 / (flash::kQuad * S));
  constexpr int kRows = flash::quad_rows<R, S>();
  constexpr int kPitch = D + 16 / sizeof(E);  // padded row: 16-byte aligned, no bank conflicts
  constexpr int kTile = flash::kPartnerTile;
  constexpr int kUpdate = flash::kPerLane / R;  // keys a lane scores per softmax update
  __shared__ __align__(16) E q_tile[kRows * kPitch];
  __shared__ __align__(16) E k_tile[kTile * kPitch];
  __shared__ __align__(16) E v_tile[kTile * kPitch];

  const int bh = blockIdx.x / p.n_qtiles;
  const int qt = blockIdx.x - bh * p.n_qtiles;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int part = lane % S;                         // which kDims of each row
  const int quad = (lane / S) & (flash::kQuad - 1);  // which keys of each tile
  const int row0 = warp * kWarpRows + (lane / (flash::kQuad * S)) * R;  // lane's rows: row0 + r
  const int seq = p.seq;
  const int q0 = qt * kRows;
  const bool vec = p.vec;

  const T* q_head = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k_head = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v_head = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  // keys the block needs, and keys the warp's rows need: all lanes of a
  // warp walk the same keys, so causal work above a warp's rows is skipped
  const int k_end = p.causal ? min(seq, q0 + kRows) : seq;
  const int warp_k_end = p.causal ? min(seq, q0 + warp * kWarpRows + kWarpRows) : seq;

  flash::stage_rows<T, D, kPitch, kRows, flash::kQuadThreads>(q_tile, q_head, p.q_ss, q0, seq, vec);
  const float q_scale = p.sm_scale * flash::kLog2e;  // scores in log2 units
  float qr[R][kDims];
  float acc[R][kDims];
  float m[R];
  float l[R];  // this lane's share of each row's sum
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = flash::kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int d = 0; d < kDims; ++d) acc[r][d] = 0.f;
  }

  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    if (k0 > 0) __syncthreads();  // every warp is done with the previous tile
    flash::stage_rows<T, D, kPitch, kTile, flash::kQuadThreads>(k_tile, k_head, p.k_ss, k0, k_end, vec);
    flash::stage_rows<T, D, kPitch, kTile, flash::kQuadThreads>(v_tile, v_head, p.v_ss, k0, k_end, vec);
    if (vec) flash::cp_async_wait_all();
    __syncthreads();
    if (k0 == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int d = 0; d < kDims; d += 4) {
          const float4 x = flash::load4(q_tile + (row0 + r) * kPitch + part * kDims + d);
          qr[r][d] = x.x * q_scale;
          qr[r][d + 1] = x.y * q_scale;
          qr[r][d + 2] = x.z * q_scale;
          qr[r][d + 3] = x.w * q_scale;
        }
      }
    }
    // keys quad + 4i of the tile, i < n (uniform across the warp)
    const int n = min(flash::kPerLane, (warp_k_end - k0 + flash::kQuad - 1) / flash::kQuad);
#pragma unroll
    for (int c0 = 0; c0 < flash::kPerLane; c0 += kUpdate) {
      if (c0 >= n) break;
      float s[R][kUpdate];
      float chunk_max[R];
#pragma unroll
      for (int r = 0; r < R; ++r) chunk_max[r] = flash::kNegInf;
#pragma unroll
      for (int i = 0; i < kUpdate; ++i) {
#pragma unroll
        for (int r = 0; r < R; ++r) s[r][i] = flash::kNegInf;
        if (c0 + i < n) {
          const int j = quad + (c0 + i) * flash::kQuad;
          const E* k_row = k_tile + j * kPitch + part * kDims;
          float dot[R];
#pragma unroll
          for (int r = 0; r < R; ++r) dot[r] = 0.f;
#pragma unroll
          for (int d = 0; d < kDims; d += 4) {
            const float4 kv = flash::load4(k_row + d);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              dot[r] = fmaf(qr[r][d], kv.x, dot[r]);
              dot[r] = fmaf(qr[r][d + 1], kv.y, dot[r]);
              dot[r] = fmaf(qr[r][d + 2], kv.z, dot[r]);
              dot[r] = fmaf(qr[r][d + 3], kv.w, dot[r]);
            }
          }
          const int kpos = k0 + j;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float score = flash::dim_sum<S>(dot[r]);
            if (kpos < seq && (!p.causal || kpos <= q0 + row0 + r)) s[r][i] = score;
            chunk_max[r] = fmaxf(chunk_max[r], s[r][i]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float m_new = fmaxf(m[r], flash::quad_max<S>(chunk_max[r]));
        const float alpha = exp2f(m[r] - m_new);
        l[r] *= alpha;
#pragma unroll
        for (int d = 0; d < kDims; ++d) acc[r][d] *= alpha;
        m[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < kUpdate; ++i) {
        if (c0 + i < n) {
          const E* v_row = v_tile + (quad + (c0 + i) * flash::kQuad) * kPitch + part * kDims;
          float pr[R];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            pr[r] = s[r][i] == flash::kNegInf ? 0.f : exp2f(s[r][i] - m[r]);
            l[r] += pr[r];
          }
#pragma unroll
          for (int d = 0; d < kDims; d += 4) {
            const float4 vv = flash::load4(v_row + d);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              acc[r][d] = fmaf(pr[r], vv.x, acc[r][d]);
              acc[r][d + 1] = fmaf(pr[r], vv.y, acc[r][d + 1]);
              acc[r][d + 2] = fmaf(pr[r], vv.z, acc[r][d + 2]);
              acc[r][d + 3] = fmaf(pr[r], vv.w, acc[r][d + 3]);
            }
          }
        }
      }
    }
  }

  // merge the quad: each row's sum, and a quarter of the lane's dims per lane
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float l_row = flash::quad_sum<S>(l[r]);  // >= 1: the row's largest term is exp2(0)
    float o[kDims / 4];
    flash::quad_reduce_scatter<kDims, S>(acc[r], o, quad);
    const int qpos = q0 + row0 + r;
    if (qpos < seq) {
      T* o_row = static_cast<T*>(p.out) + b * p.o_sb + static_cast<int64_t>(qpos) * p.o_ss +
                 h * p.o_sh + part * kDims + quad * (kDims / 4);
      flash::store_row<T, kDims / 4>(o_row, o, 1.f / l_row, vec);
      if (quad == 0 && part == 0) {
        p.lse[static_cast<int64_t>(bh) * seq + qpos] = (m[r] + log2f(l_row)) * flash::kLn2;
      }
    }
  }
}

// (rows per lane, dim split, minimum blocks per SM) of the quad kernel
template <int D>
struct FwdTiling;
template <>
struct FwdTiling<16> {
  static constexpr int R = 2, S = 1, kMinBlocks = 4;
};
template <>
struct FwdTiling<32> {
  static constexpr int R = 2, S = 2, kMinBlocks = 4;
};

// (rows per lane, dim split, warps per block, keys per staged tile,
// minimum blocks per SM) of the wide kernel
template <int D>
struct FwdWideTiling;
template <>
struct FwdWideTiling<64> {
  static constexpr int R = 4, S = 4, kWarps = 8, kTile = 64, kMinBlocks = 1;
};
template <>
struct FwdWideTiling<128> {
  static constexpr int R = 4, S = 8, kWarps = 4, kTile = 32, kMinBlocks = 2;
};
template <>
struct FwdWideTiling<256> {
  static constexpr int R = 2, S = 8, kWarps = 8, kTile = 16, kMinBlocks = 1;
};

// dynamic shared memory of a wide-kernel block: the key and value rings,
// two stages each
template <typename T, int D>
constexpr int wide_smem() {
  using E = flash::staged_t<T>;
  return 4 * FwdWideTiling<D>::kTile * (D + 16 / static_cast<int>(sizeof(E))) *
         static_cast<int>(sizeof(E));
}

// bfloat16 and float16 at head_dim 64 and 128 take the tensor cores;
// float32 keeps the CUDA cores (TF32 would break its 1e-4 tolerance), and
// float64 is summed in float32 there as in the Pallas kernel
template <typename T, int D>
constexpr bool kTensorCores =
    (std::is_same_v<T, __nv_bfloat16> || std::is_same_v<T, __half>) && (D == 64 || D == 128);

// (keys per staged tile, minimum blocks per SM) of the tensor-core forward
template <int D>
struct FwdMmaTiling;
template <>
struct FwdMmaTiling<64> {
  static constexpr int kTile = 64, kMinBlocks = 2;
};
template <>
struct FwdMmaTiling<128> {
  static constexpr int kTile = 64, kMinBlocks = 2;
};

// A kernel that may split its keys (head_dim 64 and up): the kernel, its
// block's threads, dynamic shared memory, query rows and keys a staged
// tile, and the family it reports.
struct SplitLaunch {
  void (*kernel)(Params);
  int threads, smem, rows, tile, family;
};

template <typename T, int D>
SplitLaunch split_launch() {
  if constexpr (kTensorCores<T, D>) {
    using Tile = FwdMmaTiling<D>;
    return {flash_fwd_mma_kernel<T, D, Tile::kTile, Tile::kMinBlocks>, kMmaWarps * 32,
            (kMmaRows + 4 * Tile::kTile) * (D + 8) * static_cast<int>(sizeof(T)), kMmaRows,
            Tile::kTile, flash::kFamilyMma};
  } else {
    using Tile = FwdWideTiling<D>;
    return {flash_fwd_wide_kernel<T, D, Tile::R, Tile::S, Tile::kWarps, Tile::kTile,
                                  Tile::kMinBlocks>,
            Tile::kWarps * 32, wide_smem<T, D>(),
            flash::quad_rows<Tile::R, Tile::S, Tile::kWarps>(), Tile::kTile,
            flash::kFamilyWide};
  }
}

template <typename T, int D>
const flash::WideSetup& split_setup() {
  static const SplitLaunch k = split_launch<T, D>();
  static const flash::WideSetup setup = flash::wide_setup(k.kernel, k.threads, k.smem);
  return setup;
}

template <typename T, int D>
int split_count(int64_t wave, int64_t batch_heads, int seq, bool causal) {
  const SplitLaunch k = split_launch<T, D>();
  return flash::key_splits(wave, batch_heads * ((seq + k.rows - 1) / k.rows),
                           (seq + k.tile - 1) / k.tile, causal);
}

template <typename T, int D>
int launch(Params& p, int64_t batch_heads, cudaStream_t stream, int* launched) {
  if constexpr (D <= 32) {
    using Tile = FwdTiling<D>;
    constexpr int kRows = flash::quad_rows<Tile::R, Tile::S>();
    p.n_qtiles = (p.seq + kRows - 1) / kRows;
    const int64_t n_blocks = batch_heads * p.n_qtiles;
    if (n_blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
    flash_fwd_quad_kernel<T, D, Tile::R, Tile::S, Tile::kMinBlocks>
        <<<static_cast<unsigned>(n_blocks), flash::kQuadThreads, 0, stream>>>(p);
    *launched = flash::kFamilyQuad;
  } else {
    const SplitLaunch k = split_launch<T, D>();
    const flash::WideSetup& setup = split_setup<T, D>();
    if (setup.err != cudaSuccess) return static_cast<int>(setup.err);
    p.n_splits = split_count<T, D>(setup.wave, batch_heads, p.seq, p.causal);
    if (p.n_splits > 1 && p.ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    p.n_qtiles = (p.seq + k.rows - 1) / k.rows;
    const int64_t n_blocks = batch_heads * p.n_qtiles * p.n_splits;
    const int64_t n_rows = batch_heads * p.seq;
    if (n_blocks > INT_MAX || (n_rows + 3) / 4 > INT_MAX) {
      return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    k.kernel<<<static_cast<unsigned>(n_blocks), k.threads, k.smem, stream>>>(p);
    if (p.n_splits > 1) {
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      flash_fwd_merge_kernel<T, D><<<static_cast<unsigned>((n_rows + 3) / 4), 128, 0, stream>>>(p);
    }
    *launched = k.family;
  }
  return static_cast<int>(cudaGetLastError());
}

// (query rows, keys a tile, head dims a staged chunk, output columns,
// warps, minimum blocks per SM) of the sliced forward
struct FwdSlicedTiling {
  static constexpr int kRows = 32, kKeys = 64, kChunk = 64, kSlice = 128, kWarps = 4, kMinBlocks = 2;
};

template <typename T>
auto sliced_kernel() {
  using Tile = FwdSlicedTiling;
  return flash_fwd_sliced_kernel<T, Tile::kRows, Tile::kKeys, Tile::kChunk, Tile::kSlice,
                                 Tile::kWarps, Tile::kMinBlocks>;
}

// dynamic shared memory of a sliced block: the q and key chunk ring, the
// value tile (staged type) and P (float32)
template <typename T>
constexpr int sliced_smem() {
  using Tile = FwdSlicedTiling;
  constexpr int kPad = 16 / static_cast<int>(sizeof(flash::staged_t<T>));
  return (2 * (Tile::kRows + Tile::kKeys) * (Tile::kChunk + kPad) +
          Tile::kKeys * (Tile::kSlice + kPad)) *
             static_cast<int>(sizeof(flash::staged_t<T>)) +
         Tile::kRows * (Tile::kKeys + 4) * static_cast<int>(sizeof(float));
}

template <typename T>
const flash::WideSetup& sliced_setup() {
  static const flash::WideSetup setup =
      flash::wide_setup(sliced_kernel<T>(), FwdSlicedTiling::kWarps * 32, sliced_smem<T>());
  return setup;
}

template <typename T>
int sliced_splits(int64_t wave, int64_t batch_heads, int seq, int head_dim, bool causal) {
  using Tile = FwdSlicedTiling;
  const int64_t blocks =
      batch_heads * ((seq + Tile::kRows - 1) / Tile::kRows) * (head_dim / Tile::kSlice);
  return flash::key_splits(wave, blocks, (seq + Tile::kKeys - 1) / Tile::kKeys, causal);
}

template <typename T>
int launch_sliced(Params& p, int64_t batch_heads, int head_dim, cudaStream_t stream,
                  int* launched) {
  using Tile = FwdSlicedTiling;
  if (head_dim % Tile::kSlice != 0) return static_cast<int>(cudaErrorInvalidValue);
  const flash::WideSetup& setup = sliced_setup<T>();
  if (setup.err != cudaSuccess) return static_cast<int>(setup.err);
  p.n_splits = sliced_splits<T>(setup.wave, batch_heads, p.seq, head_dim, p.causal);
  if (p.n_splits > 1 && p.ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  p.n_qtiles = (p.seq + Tile::kRows - 1) / Tile::kRows;
  const int64_t n_blocks =
      batch_heads * p.n_qtiles * (head_dim / Tile::kSlice) * static_cast<int64_t>(p.n_splits);
  const int64_t n_rows = batch_heads * p.seq;
  if (n_blocks > INT_MAX || (n_rows + 3) / 4 > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const auto kernel = sliced_kernel<T>();
  kernel<<<static_cast<unsigned>(n_blocks), Tile::kWarps * 32, sliced_smem<T>(), stream>>>(
      p, head_dim);
  if (p.n_splits > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fwd_merge_rows_kernel<T>
        <<<static_cast<unsigned>((n_rows + 3) / 4), 128, 0, stream>>>(p, head_dim);
  }
  *launched = flash::kFamilySliced;
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_head_dim(int head_dim, Params& p, int64_t batch_heads, cudaStream_t stream,
                      int* launched) {
  switch (head_dim) {
    case 16: return launch<T, 16>(p, batch_heads, stream, launched);
    case 32: return launch<T, 32>(p, batch_heads, stream, launched);
    case 64: return launch<T, 64>(p, batch_heads, stream, launched);
    case 128: return launch<T, 128>(p, batch_heads, stream, launched);
    case 256: return launch<T, 256>(p, batch_heads, stream, launched);
    default:
      if (head_dim > 256) return launch_sliced<T>(p, batch_heads, head_dim, stream, launched);
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int D>
int splits_of(int64_t batch_heads, int seq, bool causal) {
  const flash::WideSetup& setup = split_setup<T, D>();
  if (setup.err != cudaSuccess) return -static_cast<int>(setup.err);
  return split_count<T, D>(setup.wave, batch_heads, seq, causal);
}

template <typename T>
int splits_for(int head_dim, int64_t batch_heads, int seq, bool causal) {
  switch (head_dim) {
    case 64: return splits_of<T, 64>(batch_heads, seq, causal);
    case 128: return splits_of<T, 128>(batch_heads, seq, causal);
    case 256: return splits_of<T, 256>(batch_heads, seq, causal);
    default: {
      if (head_dim <= 256 || head_dim % FwdSlicedTiling::kSlice != 0) return 1;
      const flash::WideSetup& setup = sliced_setup<T>();
      if (setup.err != cudaSuccess) return -static_cast<int>(setup.err);
      return sliced_splits<T>(setup.wave, batch_heads, seq, head_dim, causal);
    }
  }
}

}  // namespace

// the key splits the launch of these shapes and mode takes: the float32
// scratch it needs is n_splits * batch * heads * seq * (head_dim + 2)
// elements when n_splits > 1 (none otherwise); minus the CUDA error code
// when the card could not be queried or the dtype is unknown
extern "C" int gordo_flash_attention_fwd_splits(int batch, int seq, int heads, int head_dim,
                                                int dtype, int mode) {
  const int64_t batch_heads = static_cast<int64_t>(batch) * heads;
  if (batch <= 0 || seq <= 0 || heads <= 0) return 1;
  const bool causal = (mode & flash::kModeCausal) != 0;
  switch (dtype) {
    case 0: return splits_for<float>(head_dim, batch_heads, seq, causal);
    case 1: return splits_for<__nv_bfloat16>(head_dim, batch_heads, seq, causal);
    case 2: return splits_for<__half>(head_dim, batch_heads, seq, causal);
    case 3: return splits_for<double>(head_dim, batch_heads, seq, causal);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// strides: (batch, seq, head) of q, k, v, out, in that order; mode: bit 1
// causal, bit 2 16-byte aligned rows; workspace: the scratch
// gordo_flash_attention_fwd_splits asks for (null when it asks for none);
// launched: set to the kernel family launched (flash::kFamily*)
extern "C" int gordo_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse, void* workspace,
    int batch, int seq, int heads, int head_dim, int dtype,
    const long long* strides, float sm_scale, int mode, void* stream, int* launched) {
  if (batch <= 0 || seq <= 0 || heads <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.ws = static_cast<float*>(workspace);
  p.n_splits = 1;
  p.heads = heads;
  p.seq = seq;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
  p.sm_scale = sm_scale;
  p.causal = (mode & flash::kModeCausal) != 0;
  p.vec = (mode & flash::kModeVec16) != 0;
  const int64_t batch_heads = static_cast<int64_t>(batch) * heads;
  if (batch_heads > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  p.batch_heads = static_cast<int>(batch_heads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_head_dim<float>(head_dim, p, batch_heads, s, launched);
    case 1: return dispatch_head_dim<__nv_bfloat16>(head_dim, p, batch_heads, s, launched);
    case 2: return dispatch_head_dim<__half>(head_dim, p, batch_heads, s, launched);
    case 3: return dispatch_head_dim<double>(head_dim, p, batch_heads, s, launched);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
