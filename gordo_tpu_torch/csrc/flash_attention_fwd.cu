// Flash-attention forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces gordo_tpu/ops/flash_attention.py::_attn_kernel, the Pallas TPU
// kernel launched by _flash_forward_bhsd: FlashAttention-2 online softmax
// over (batch, seq, heads, head_dim) inputs, emitting the output and the
// per-row log-sum-exp (LSE) of the scaled scores, with causal masking and
// keys past the sequence end masked to zero probability.
//
// What bounds it on this card. At the served shape (8192 windows x 64
// steps x 4 heads x head_dim 16, fp32, causal) the kernel reads q, k, v
// once and writes out and the LSE: ~545 MB, 0.16 ms at 3.35 TB/s, against
// ~4.3 GFLOP of causal work, 0.06 ms at the 67 TFLOP/s fp32 rate. It is
// bound by bytes, so the design keeps every intermediate (scores,
// probabilities, running max/sum, the accumulator) out of device memory
// and reads each q row and each k/v tile from device memory once per
// query tile.
//
// Design (not a copy of the Pallas grid). On the TPU the k axis of the
// grid runs in order and carries VMEM scratch between steps; here one
// thread block owns a (batch*head, 64-row query tile) pair and loops over
// the key tiles itself, keeping the running max, running sum and the
// accumulator in registers. A query row is owned by D/16 neighbouring
// threads, each holding 16 of its head dims; partial dot products are
// summed with warp shuffles. Key/value tiles are staged in shared memory
// as fp32. Causal tiles stop at the query tile's last row. There is no
// head-dim padding to 128 lanes and no lane-broadcast statistics: those
// exist only for Mosaic's (8, 128) tiling. Tensor cores (wgmma) and TMA
// are left for a later change; this kernel runs on the fp32 CUDA cores.
//
// Inputs are float32 or bfloat16 (dtype 0 / 1) with fp32 accumulation;
// head_dim is 16, 32, 64 or 128; any sequence length. Strides are in
// elements; the head dim must be contiguous. The kernel allocates nothing
// and runs on the caller's stream. The entry point returns the CUDA error
// code of the launch (0 on success).

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kSlice = 16;    // head dims held by one thread
constexpr int kBlockQ = 64;   // query rows per thread block
constexpr int kChunk = 16;    // keys per online-softmax update
constexpr float kNegInf = -1e30f;

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
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(kBlockQ*(D / kSlice))
    flash_fwd_kernel(const Params p) {
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

template <typename T, int D>
int launch(const Params& p, int64_t n_blocks, cudaStream_t stream) {
  constexpr int kThreads = kBlockQ * (D / kSlice);
  flash_fwd_kernel<T, D><<<static_cast<unsigned>(n_blocks), kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_head_dim(int head_dim, const Params& p, int64_t n_blocks, cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(p, n_blocks, stream);
    case 32: return launch<T, 32>(p, n_blocks, stream);
    case 64: return launch<T, 64>(p, n_blocks, stream);
    case 128: return launch<T, 128>(p, n_blocks, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides: (batch, seq, head) of q, k, v, out, in that order
extern "C" int gordo_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int batch, int seq, int heads, int head_dim, int dtype,
    const long long* strides, float sm_scale, int causal, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.heads = heads;
  p.seq = seq;
  p.n_qtiles = (seq + kBlockQ - 1) / kBlockQ;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
  p.sm_scale = sm_scale;
  p.causal = causal;
  const int64_t n_blocks = static_cast<int64_t>(batch) * heads * p.n_qtiles;
  if (n_blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_head_dim<float>(head_dim, p, n_blocks, s);
    case 1: return dispatch_head_dim<__nv_bfloat16>(head_dim, p, n_blocks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
