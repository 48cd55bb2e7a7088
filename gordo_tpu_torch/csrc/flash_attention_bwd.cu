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
// memory. Each output element has one owner, so there are no atomics and
// no cross-block sum: both kernels are deterministic.
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
// dq at head_dim 64 and 128 (flash_bwd_dq_kernel): one block owns 64 query
// rows of one (batch, head) and loops over key tiles; q, dO and the dq
// accumulator stay in registers with the row's LSE and delta; key/value
// tiles are staged in shared memory as fp32. A row is owned by
// head_dim/16 neighbouring threads, each holding 16 of its head dims;
// dot products are summed with warp shuffles. Causal blocks stop at the
// tile's last query row.
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
// dk/dv at head_dim 64 and 128 (flash_bwd_dkv_wide_kernel): bound by
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
// PERF.md). The quad's partials are merged once by the fixed-order
// butterfly, and each dk/dv element has one owner: no atomics.
//
// Rows past the sequence end store nothing; query rows past the end add
// nothing to dk/dv and keys past the end have probability 0. No head-dim
// padding to 128 lanes and no lane-broadcast statistics: those exist only
// for Mosaic's (8, 128) tiling.
//
// Inputs are float32 or bfloat16 (dtype 0 / 1) with fp32 accumulation;
// head_dim is 16, 32, 64 or 128; any sequence length; causal or full.
// Strides are in elements, (batch, seq, head) for each tensor in the
// order the entry point names; the head dim must be contiguous. `mode` is
// a bit set: 1 causal, 2 every row start of the six (batch, seq, heads,
// head_dim) tensors of the entry point 16-byte aligned (read by every
// kernel but the head_dim 64/128 dq kernel, which reads bit 1 only). The kernels
// allocate nothing and run on the caller's stream. Each entry point
// returns the CUDA error code of its launch (0 on success).

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_common.cuh"

namespace {

constexpr int kSlice = 16;      // head dims held by one thread
constexpr int kBlockRows = 64;  // rows a thread block owns (head_dim 64 and 128 kernels)

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

// sum over the kTpr neighbouring threads that own one row
template <int kTpr>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = kTpr / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kBlockRows*(D / kSlice))
    flash_bwd_dq_kernel(const Params p) {
  constexpr int kTpr = D / kSlice;            // threads per query row
  constexpr int kBlockK = D <= 32 ? 64 : 32;  // keys per shared tile
  constexpr int kThreads = kBlockRows * kTpr;

  __shared__ float k_tile[kBlockK][D];
  __shared__ float v_tile[kBlockK][D];

  const int bh = blockIdx.x / p.n_tiles;
  const int qt = blockIdx.x - bh * p.n_tiles;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int row = threadIdx.x / kTpr;
  const int d0 = (threadIdx.x - row * kTpr) * kSlice;
  const int seq = p.seq;
  const int qpos = qt * kBlockRows + row;
  const int qc = min(qpos, seq - 1);

  const T* q_row = row_ptr<T>(p.q, p.q_st, b, qc, h, d0);
  const T* o_row = row_ptr<T>(p.out, p.o_st, b, qc, h, d0);
  const T* do_row = row_ptr<T>(p.d_out, p.do_st, b, qc, h, d0);
  float qr[kSlice];
  float dor[kSlice];
  float acc[kSlice];
  float dot_o = 0.f;
#pragma unroll
  for (int i = 0; i < kSlice; ++i) {
    qr[i] = to_float(q_row[i]);
    dor[i] = to_float(do_row[i]);
    dot_o = fmaf(dor[i], to_float(o_row[i]), dot_o);
    acc[i] = 0.f;
  }
  const int64_t stat = static_cast<int64_t>(bh) * seq;
  const float delta = row_sum<kTpr>(dot_o);
  const float lse = p.lse[stat + qc];
  if (qpos < seq && d0 == 0) p.delta[stat + qpos] = delta;

  const int q_last = min(seq, (qt + 1) * kBlockRows) - 1;
  const int k_end = p.causal ? q_last + 1 : seq;  // keys this tile needs
  const T* k_head = row_ptr<T>(p.k, p.k_st, b, 0, h, 0);
  const T* v_head = row_ptr<T>(p.v, p.v_st, b, 0, h, 0);

  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = threadIdx.x; idx < kBlockK * D; idx += kThreads) {
      const int j = idx / D;
      const int d = idx - j * D;
      const int kpos = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kpos < seq) {
        kv = to_float(k_head[static_cast<int64_t>(kpos) * p.k_st.s + d]);
        vv = to_float(v_head[static_cast<int64_t>(kpos) * p.v_st.s + d]);
      }
      k_tile[j][d] = kv;
      v_tile[j][d] = vv;
    }
    __syncthreads();

    const int n = min(kBlockK, k_end - k0);  // uniform across the block
#pragma unroll 2
    for (int j = 0; j < n; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < kSlice; ++i) {
        s = fmaf(qr[i], k_tile[j][d0 + i], s);
        dp = fmaf(dor[i], v_tile[j][d0 + i], dp);
      }
      s = row_sum<kTpr>(s);
      dp = row_sum<kTpr>(dp);
      // keys past the sequence end lie past k_end: only the causal mask
      const bool keep = !p.causal || k0 + j <= qpos;
      const float prob = keep ? expf(s * p.sm_scale - lse) : 0.f;
      const float ds = prob * (dp - delta);
#pragma unroll
      for (int i = 0; i < kSlice; ++i) acc[i] = fmaf(ds, k_tile[j][d0 + i], acc[i]);
    }
  }

  if (qpos < seq) {
    T* dq_row = row_ptr<T>(p.dq, p.dq_st, b, qpos, h, d0);
#pragma unroll
    for (int i = 0; i < kSlice; ++i) dq_row[i] = from_float<T>(acc[i] * p.sm_scale);
  }
}

template <typename T, int D, int R, int S, int kMinBlocks>
__global__ void __launch_bounds__(flash::kQuadThreads, kMinBlocks)
    flash_bwd_dkv_quad_kernel(const Params p) {
  constexpr int kDims = D / S;  // head dims a lane holds
  constexpr int kWarpKeys = R * (32 / (flash::kQuad * S));
  constexpr int kKeys = flash::quad_rows<R, S>();
  constexpr int kPitch = D + 16 / sizeof(T);  // padded row: 16-byte aligned, no bank conflicts
  constexpr int kTile = flash::kPartnerTile;
  __shared__ __align__(16) T k_tile[kKeys * kPitch];
  __shared__ __align__(16) T v_tile[kKeys * kPitch];
  __shared__ __align__(16) T q_tile[kTile * kPitch];
  __shared__ __align__(16) T do_tile[kTile * kPitch];
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
      const T* q_row = q_tile + i * kPitch + part * kDims;
      const T* do_row = do_tile + i * kPitch + part * kDims;
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

// The dk/dv quad layout at head_dim 64 and 128, with more of the work in
// flight: kWarps warps a block, the lane's k and v rows loaded straight
// into registers, and q, dO, LSE and delta tiles of kTile queries staged
// through a two-stage ring in dynamic shared memory, so the copies of
// tile t + 1 run under the math on tile t.
template <typename T, int D, int R, int S, int kWarps, int kTile, int kMinBlocks>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
    flash_bwd_dkv_wide_kernel(const Params p) {
  constexpr int kThreads = kWarps * 32;
  constexpr int kDims = D / S;  // head dims a lane holds
  constexpr int kWarpKeys = R * (32 / (flash::kQuad * S));
  constexpr int kKeys = flash::quad_rows<R, S, kWarps>();
  constexpr int kPitch = D + 16 / sizeof(T);  // padded row: 16-byte aligned, no bank conflicts
  constexpr int kStage = kTile * kPitch;      // elements of one staged tile
  constexpr int kLaneQueries = kTile / flash::kQuad;  // queries a lane walks per tile
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_ring = reinterpret_cast<T*>(smem);  // [2][kStage]
  T* do_ring = q_ring + 2 * kStage;        // [2][kStage]
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
    const T* q_tile = q_ring + (t & 1) * kStage;
    const T* do_tile = do_ring + (t & 1) * kStage;
    const float* lse_tile = lse_ring + (t & 1) * kTile;
    const float* delta_tile = delta_ring + (t & 1) * kTile;
    // queries quad + 4u of the tile, u in [u_begin, u_end) (uniform across the warp)
    const int u_begin = max(0, warp_q_first - q0) / flash::kQuad;
    const int u_end = min(kLaneQueries, (seq - q0 + flash::kQuad - 1) / flash::kQuad);
#pragma unroll 2
    for (int u = u_begin; u < u_end; ++u) {
      const int i = quad + u * flash::kQuad;
      const T* q_row = q_tile + i * kPitch + part * kDims;
      const T* do_row = do_tile + i * kPitch + part * kDims;
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
  constexpr int kDims = D / S;  // head dims a lane holds
  constexpr int kWarpRows = R * (32 / (flash::kQuad * S));
  constexpr int kRows = flash::quad_rows<R, S>();
  constexpr int kPitch = D + 16 / sizeof(T);  // padded row: 16-byte aligned, no bank conflicts
  constexpr int kTile = flash::kPartnerTile;
  __shared__ __align__(16) T k_tile[kTile * kPitch];
  __shared__ __align__(16) T v_tile[kTile * kPitch];

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
        const T* v_row = v_tile + j * kPitch + part * kDims;
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
      const T* k_row = k_tile + j * kPitch + part * kDims;
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

enum class Which { kDq, kDkv };

template <Which W, typename T, int D>
int launch(Params& p, int64_t batch_heads, cudaStream_t stream) {
  constexpr bool kQuadKernel = D <= 32;  // the model's head sizes
  int rows = kBlockRows;
  if constexpr (kQuadKernel && W == Which::kDq) {
    rows = flash::quad_rows<DqTiling<D>::R, DqTiling<D>::S>();
  } else if constexpr (kQuadKernel) {
    rows = flash::quad_rows<DkvTiling<D>::R, DkvTiling<D>::S>();
  } else if constexpr (W == Which::kDkv) {
    using Tile = DkvWideTiling<D>;
    rows = flash::quad_rows<Tile::R, Tile::S, Tile::kWarps>();
  }
  p.n_tiles = (p.seq + rows - 1) / rows;
  const int64_t n_blocks = batch_heads * p.n_tiles;
  if (n_blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const unsigned grid = static_cast<unsigned>(n_blocks);
  constexpr int kThreads = kBlockRows * (D / kSlice);
  if constexpr (W == Which::kDq && kQuadKernel) {
    using Tile = DqTiling<D>;
    flash_bwd_dq_quad_kernel<T, D, Tile::R, Tile::S, Tile::kMinBlocks>
        <<<grid, flash::kQuadThreads, 0, stream>>>(p);
  } else if constexpr (W == Which::kDq) {
    flash_bwd_dq_kernel<T, D><<<grid, kThreads, 0, stream>>>(p);
  } else if constexpr (kQuadKernel) {
    using Tile = DkvTiling<D>;
    flash_bwd_dkv_quad_kernel<T, D, Tile::R, Tile::S, Tile::kMinBlocks>
        <<<grid, flash::kQuadThreads, 0, stream>>>(p);
  } else {
    using Tile = DkvWideTiling<D>;
    // q and dO tiles, then LSE and delta, each in two stages
    constexpr int kSmem = 4 * Tile::kTile * (D + 16 / static_cast<int>(sizeof(T))) * sizeof(T) +
                          4 * Tile::kTile * sizeof(float);
    const auto kernel = flash_bwd_dkv_wide_kernel<T, D, Tile::R, Tile::S, Tile::kWarps,
                                                  Tile::kTile, Tile::kMinBlocks>;
    static const cudaError_t smem_ok = flash::allow_dynamic_smem(kernel, kSmem);
    if (smem_ok != cudaSuccess) return static_cast<int>(smem_ok);
    kernel<<<grid, Tile::kWarps * 32, kSmem, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <Which W, typename T>
int dispatch_head_dim(int head_dim, Params& p, int64_t batch_heads, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<W, T, 16>(p, batch_heads, stream);
    case 32: return launch<W, T, 32>(p, batch_heads, stream);
    case 64: return launch<W, T, 64>(p, batch_heads, stream);
    case 128: return launch<W, T, 128>(p, batch_heads, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

Strides strides_at(const long long* strides, int tensor) {
  return Strides{strides[3 * tensor], strides[3 * tensor + 1], strides[3 * tensor + 2]};
}

template <Which W>
int run(Params& p, int batch, int seq, int heads, int head_dim, int dtype, int mode,
        void* stream) {
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
    case 0: return dispatch_head_dim<W, float>(head_dim, p, batch_heads, s);
    case 1: return dispatch_head_dim<W, __nv_bfloat16>(head_dim, p, batch_heads, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dq and delta, replacing _bwd_dq_kernel (gordo_tpu/ops/flash_attention.py:176);
// bound by bytes: q, k, v, out, d_out and lse in, dq and delta out.
// strides: (batch, seq, head) of q, k, v, out, d_out, dq, in that order;
// mode: bit 1 causal, bit 2 16-byte aligned rows of all six
extern "C" int gordo_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* out, const void* d_out,
    const void* lse, void* delta, void* dq,
    int batch, int seq, int heads, int head_dim, int dtype,
    const long long* strides, float sm_scale, int mode, void* stream) {
  Params p = {};
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
  return run<Which::kDq>(p, batch, seq, heads, head_dim, dtype, mode, stream);
}

// dk and dv, replacing _bwd_dkv_kernel (gordo_tpu/ops/flash_attention.py:213);
// bound by bytes: q, k, v, d_out, lse and delta in, dk and dv out.
// strides: (batch, seq, head) of q, k, v, d_out, dk, dv, in that order;
// mode: bit 1 causal, bit 2 16-byte aligned rows of all six
extern "C" int gordo_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* d_out,
    const void* lse, const void* delta, void* dk, void* dv,
    int batch, int seq, int heads, int head_dim, int dtype,
    const long long* strides, float sm_scale, int mode, void* stream) {
  Params p = {};
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
  return run<Which::kDkv>(p, batch, seq, heads, head_dim, dtype, mode, stream);
}
