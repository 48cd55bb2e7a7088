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
// At head_dim 64 and 128 the general kernel (flash_fwd_slice_kernel)
// runs: one block per (batch*head, 64-query tile), a row owned by D/16
// threads each holding 16 of its head dims, key/value tiles staged in
// shared memory as fp32, causal tiles stopping at the query tile's last
// row. Neither kernel pads head_dim to 128 lanes or broadcasts row
// statistics over lanes: those exist only for Mosaic's (8, 128) tiling.
//
// Inputs are float32 or bfloat16 (dtype 0 / 1) with fp32 accumulation;
// head_dim is 16, 32, 64 or 128; any sequence length. Strides are in
// elements; the head dim must be contiguous. `mode` is a bit set: 1
// causal, 2 every row start of q, k, v and out 16-byte aligned. The
// kernels allocate nothing and run on the caller's stream. The entry
// point returns the CUDA error code of the launch (0 on success).

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_common.cuh"

namespace {

constexpr int kSlice = 16;    // head dims held by one thread (general kernel)
constexpr int kBlockQ = 64;   // query rows per block (general kernel)
constexpr int kChunk = 16;    // keys per online-softmax update (general kernel)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;
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

using flash::from_float;
using flash::kNegInf;
using flash::to_float;

template <typename T, int D>
__global__ void __launch_bounds__(kBlockQ*(D / kSlice))
    flash_fwd_slice_kernel(const Params p) {
  constexpr int kTpr = D / kSlice;              // threads per query row
  constexpr int kBlockK = D <= 32 ? 64 : 32;    // keys per shared tile
  constexpr int kThreads = kBlockQ * kTpr;
  static_assert(kBlockK % kChunk == 0, "key tile must hold whole chunks");

  __shared__ float k_tile[kBlockK][D];
  __shared__ float v_tile[kBlockK][D];

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  T* out = static_cast<T*>(p.out);

  const int bh = blockIdx.x / p.n_qtiles;
  const int qt = blockIdx.x - bh * p.n_qtiles;
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int row = threadIdx.x / kTpr;
  const int d0 = (threadIdx.x - row * kTpr) * kSlice;
  const int qpos = qt * kBlockQ + row;
  const int seq = p.seq;

  // rows past the sequence end compute on a clamped copy (every thread
  // must take part in the shuffles) and store nothing
  const T* q_row = q + b * p.q_sb + static_cast<int64_t>(min(qpos, seq - 1)) * p.q_ss +
                   h * p.q_sh + d0;
  float qr[kSlice];
  float acc[kSlice];
#pragma unroll
  for (int i = 0; i < kSlice; ++i) {
    qr[i] = to_float(q_row[i]);
    acc[i] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  const int q_last = min(seq, (qt + 1) * kBlockQ) - 1;
  const int k_end = p.causal ? q_last + 1 : seq;  // keys this tile needs
  const T* k_head = k + b * p.k_sb + h * p.k_sh;
  const T* v_head = v + b * p.v_sb + h * p.v_sh;

  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = threadIdx.x; idx < kBlockK * D; idx += kThreads) {
      const int j = idx / D;
      const int d = idx - j * D;
      const int kpos = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kpos < seq) {
        kv = to_float(k_head[static_cast<int64_t>(kpos) * p.k_ss + d]);
        vv = to_float(v_head[static_cast<int64_t>(kpos) * p.v_ss + d]);
      }
      k_tile[j][d] = kv;
      v_tile[j][d] = vv;
    }
    __syncthreads();

#pragma unroll
    for (int c0 = 0; c0 < kBlockK; c0 += kChunk) {
      if (k0 + c0 >= k_end) break;  // uniform across the block
      float s[kChunk];
      float m_chunk = kNegInf;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < kSlice; ++i) dot = fmaf(qr[i], k_tile[c0 + j][d0 + i], dot);
#pragma unroll
        for (int off = kTpr / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        const int kpos = k0 + c0 + j;
        const bool valid = kpos < seq && (!p.causal || kpos <= qpos);
        s[j] = valid ? dot * p.sm_scale : kNegInf;
        m_chunk = fmaxf(m_chunk, s[j]);
      }
      const float m_new = fmaxf(m, m_chunk);
      const float alpha = expf(m - m_new);
#pragma unroll
      for (int i = 0; i < kSlice; ++i) acc[i] *= alpha;
      float p_sum = 0.f;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int kpos = k0 + c0 + j;
        const bool valid = kpos < seq && (!p.causal || kpos <= qpos);
        const float pj = valid ? expf(s[j] - m_new) : 0.f;
        p_sum += pj;
#pragma unroll
        for (int i = 0; i < kSlice; ++i) acc[i] = fmaf(pj, v_tile[c0 + j][d0 + i], acc[i]);
      }
      l = l * alpha + p_sum;
      m = m_new;
    }
  }

  if (qpos < seq) {
    const float l_safe = l == 0.f ? 1.f : l;
    T* o_row = out + b * p.o_sb + static_cast<int64_t>(qpos) * p.o_ss + h * p.o_sh + d0;
#pragma unroll
    for (int i = 0; i < kSlice; ++i) o_row[i] = from_float<T>(acc[i] / l_safe);
    if (d0 == 0) p.lse[static_cast<int64_t>(bh) * seq + qpos] = m + logf(l_safe);
  }
}

template <typename T, int D, int R, int S, int kMinBlocks>
__global__ void __launch_bounds__(flash::kQuadThreads, kMinBlocks)
    flash_fwd_quad_kernel(const Params p) {
  constexpr int kDims = D / S;                          // head dims a lane holds
  constexpr int kWarpRows = R * (32 / (flash::kQuad * S));
  constexpr int kRows = flash::quad_rows<R, S>();
  constexpr int kPitch = D + 16 / sizeof(T);  // padded row: 16-byte aligned, no bank conflicts
  constexpr int kTile = flash::kPartnerTile;
  constexpr int kUpdate = flash::kPerLane / R;  // keys a lane scores per softmax update
  __shared__ __align__(16) T q_tile[kRows * kPitch];
  __shared__ __align__(16) T k_tile[kTile * kPitch];
  __shared__ __align__(16) T v_tile[kTile * kPitch];

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
          const T* k_row = k_tile + j * kPitch + part * kDims;
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
          const T* v_row = v_tile + (quad + (c0 + i) * flash::kQuad) * kPitch + part * kDims;
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

template <typename T, int D>
int launch(Params& p, int64_t batch_heads, cudaStream_t stream) {
  if constexpr (D <= 32) {
    using Tile = FwdTiling<D>;
    constexpr int kRows = flash::quad_rows<Tile::R, Tile::S>();
    p.n_qtiles = (p.seq + kRows - 1) / kRows;
  } else {
    p.n_qtiles = (p.seq + kBlockQ - 1) / kBlockQ;
  }
  const int64_t n_blocks = batch_heads * p.n_qtiles;
  if (n_blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const unsigned grid = static_cast<unsigned>(n_blocks);
  if constexpr (D <= 32) {
    using Tile = FwdTiling<D>;
    flash_fwd_quad_kernel<T, D, Tile::R, Tile::S, Tile::kMinBlocks>
        <<<grid, flash::kQuadThreads, 0, stream>>>(p);
  } else {
    flash_fwd_slice_kernel<T, D><<<grid, kBlockQ * (D / kSlice), 0, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_head_dim(int head_dim, Params& p, int64_t batch_heads, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(p, batch_heads, stream);
    case 32: return launch<T, 32>(p, batch_heads, stream);
    case 64: return launch<T, 64>(p, batch_heads, stream);
    case 128: return launch<T, 128>(p, batch_heads, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides: (batch, seq, head) of q, k, v, out, in that order; mode: bit 1
// causal, bit 2 16-byte aligned rows
extern "C" int gordo_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int batch, int seq, int heads, int head_dim, int dtype,
    const long long* strides, float sm_scale, int mode, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = static_cast<float*>(lse);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_head_dim<float>(head_dim, p, batch_heads, s);
    case 1: return dispatch_head_dim<__nv_bfloat16>(head_dim, p, batch_heads, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
