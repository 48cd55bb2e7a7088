// Pieces shared by the flash-attention kernels of flash_attention_fwd.cu
// and flash_attention_bwd.cu (sm_90a): element conversion, 16-byte
// asynchronous staging of row tiles into shared memory with a scalar path
// for unaligned views, the fixed-order reductions over the four lanes
// ("quad") that share one row, the key-split rule of the wide kernels,
// and the kernel families an entry point reports.
//
// Element types are float32, bfloat16, float16 and float64, as the Pallas
// kernels take them: every element is converted to float32 on load and
// every sum is in float32 (the Pallas kernels' `.astype(jnp.float32)`);
// outputs are rounded once to the input's type. A float64 tile is
// converted to float32 as it is staged into shared memory (Staged<double>),
// so its ring takes a float32 tile's room.
//
// A quad kernel gives each owned row (a query row in the forward and dq,
// a key row in dk/dv) to four neighbouring lanes; lane `quad` of the four
// walks partner rows quad, quad + 4, quad + 8, ... of every staged
// partner tile, and the four partial results are merged with shuffles in
// one fixed order, so a launch is deterministic.

#pragma once

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace flash {

// bits of the entry points' `mode` argument
constexpr int kModeCausal = 1;  // drop pairs with key > query
constexpr int kModeVec16 = 2;   // every row start is 16-byte aligned: stage with cp.async

constexpr int kQuad = 4;          // lanes that share one row
constexpr int kPartnerTile = 64;  // partner rows staged at a time
constexpr int kPerLane = kPartnerTile / kQuad;
constexpr int kQuadWarps = 4;  // warps per quad-kernel block
constexpr int kQuadThreads = kQuadWarps * 32;

// The kernel family an entry point launched, written to its `launched`
// argument: the wrapper counts each family's launches apart.
constexpr int kFamilyQuad = 0;      // head_dim 16 and 32
constexpr int kFamilyWide = 1;      // 64, 128 and 256 on the CUDA cores
constexpr int kFamilyMma = 2;       // 64 and 128 in bfloat16 and float16, tensor cores
constexpr int kFamilyTiled = 3;     // dq and dk/dv above 256 on the CUDA cores
constexpr int kFamilySliced = 4;    // the forward at any head_dim above 256
constexpr int kFamilyTiledMma = 5;  // dq and dk/dv above 256 in bfloat16 and float16

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(double x) { return static_cast<float>(x); }

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
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ double from_float<double>(float x) {
  return static_cast<double>(x);
}

// the element type a tile of T is staged as in shared memory: T itself,
// or float32 for float64
template <typename T>
struct Staged {
  using type = T;
};
template <>
struct Staged<double> {
  using type = float;
};
template <typename T>
using staged_t = typename Staged<T>::type;

// four consecutive elements (shared or device memory) as floats, 16-byte
// aligned for float32 and float64, 8-byte for bfloat16 and float16
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(&raw.x));
  const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ float4 load4(const double* p) {
  const double2 lo = *reinterpret_cast<const double2*>(p);
  const double2 hi = *reinterpret_cast<const double2*>(p + 2);
  return make_float4(static_cast<float>(lo.x), static_cast<float>(lo.y),
                     static_cast<float>(hi.x), static_cast<float>(hi.y));
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ unsigned pack_half2(float lo, float hi) {
  const __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// store four floats to device memory as T: one 16-byte (float32), two
// 16-byte (float64) or one 8-byte (bfloat16, float16) store when `vec`,
// else element by element
__device__ __forceinline__ void store4(float* p, float4 v, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = v;
  } else {
    p[0] = v.x;
    p[1] = v.y;
    p[2] = v.z;
    p[3] = v.w;
  }
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v, bool vec) {
  if (vec) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
  } else {
    p[0] = __float2bfloat16(v.x);
    p[1] = __float2bfloat16(v.y);
    p[2] = __float2bfloat16(v.z);
    p[3] = __float2bfloat16(v.w);
  }
}
__device__ __forceinline__ void store4(__half* p, float4 v, bool vec) {
  if (vec) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_half2(v.x, v.y), pack_half2(v.z, v.w));
  } else {
    p[0] = __float2half_rn(v.x);
    p[1] = __float2half_rn(v.y);
    p[2] = __float2half_rn(v.z);
    p[3] = __float2half_rn(v.w);
  }
}
__device__ __forceinline__ void store4(double* p, float4 v, bool vec) {
  if (vec) {
    *reinterpret_cast<double2*>(p) = make_double2(v.x, v.y);
    *reinterpret_cast<double2*>(p + 2) = make_double2(v.z, v.w);
  } else {
    p[0] = v.x;
    p[1] = v.y;
    p[2] = v.z;
    p[3] = v.w;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

// wait for every cp.async this thread issued (a __syncthreads must follow)
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// one float32 (4 bytes) copied asynchronously
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem) : "memory");
}

// close the group of cp.async copies issued since the last commit
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight (a
// __syncthreads must follow before other threads read the copies)
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one element of T as its staged type E: itself, or converted
template <typename E, typename T>
__device__ __forceinline__ E staged(T x) {
  if constexpr (std::is_same_v<E, T>) {
    return x;
  } else {
    return from_float<E>(to_float(x));
  }
}

// Stage rows [row0, row0 + kRows) of one head of a (batch, seq, heads, D)
// tensor of T into `tile` (kRows x kPitch elements of E, staged_t<T>).
// Rows at or past `end` are zero-filled without reading device memory, so
// a lane may read any row of the tile. With `vec` and E = T, 16-byte
// cp.async copies (the caller waits); else one element per thread,
// converted to E, or with kAsync4 a float32 element by a 4-byte cp.async
// copy (the caller waits whether or not `vec`).
template <typename T, int D, int kPitch, int kRows, int kThreads, bool kAsync4 = false,
          typename E>
__device__ __forceinline__ void stage_rows(E* tile, const T* head, int64_t row_stride,
                                           int row0, int end, bool vec) {
  static_assert(std::is_same_v<E, staged_t<T>>, "a tile of T is staged as staged_t<T>");
  if constexpr (kAsync4 && std::is_same_v<E, float> && std::is_same_v<T, float>) {
    if (!vec) {
      for (int c = threadIdx.x; c < kRows * D; c += kThreads) {
        const int r = c / D;
        const int e = c - r * D;
        const int pos = row0 + r;
        if (pos < end) {
          cp_async4(tile + r * kPitch + e, head + static_cast<int64_t>(pos) * row_stride + e);
        } else {
          tile[r * kPitch + e] = 0.f;
        }
      }
      return;
    }
  }
  if constexpr (std::is_same_v<E, T>) {
    if (vec) {
      constexpr int kElems = 16 / sizeof(T);  // elements per 16-byte chunk
      constexpr int kChunks = D / kElems;     // chunks per row
      for (int c = threadIdx.x; c < kRows * kChunks; c += kThreads) {
        const int r = c / kChunks;
        const int e = (c - r * kChunks) * kElems;
        T* dst = tile + r * kPitch + e;
        const int pos = row0 + r;
        if (pos < end) {
          cp_async16(dst, head + static_cast<int64_t>(pos) * row_stride + e);
        } else {
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
      return;
    }
  }
  for (int c = threadIdx.x; c < kRows * D; c += kThreads) {
    const int r = c / D;
    const int e = c - r * D;
    const int pos = row0 + r;
    tile[r * kPitch + e] =
        pos < end ? staged<E>(head[static_cast<int64_t>(pos) * row_stride + e]) : from_float<E>(0.f);
  }
}

// The lanes of a warp are laid out as (row group, quad, dim part), the
// dim part fastest: a row's dims are split over S neighbouring lanes, and
// the four quad lanes that share a row group sit S lanes apart.

// rows a quad-kernel block owns: 4 warps (kWarps in the wide kernels) of
// 32 / (4 S) groups of R rows
template <int R, int S, int kWarps = kQuadWarps>
__host__ __device__ constexpr int quad_rows() {
  return kWarps * R * (32 / (kQuad * S));
}

// Let `kernel` take `bytes` of dynamic shared memory: a launch above 48 KB
// is refused without this. The launchers call it once per kernel.
template <typename Kernel>
inline cudaError_t allow_dynamic_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// What a wide kernel's launches need to know about the card, found once
// per kernel: the error of its set-up (dynamic shared memory, occupancy
// query) and the blocks the card holds at once.
struct WideSetup {
  cudaError_t err;
  int64_t wave;
};

template <typename Kernel>
WideSetup wide_setup(Kernel kernel, int threads, int smem_bytes) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = allow_dynamic_smem(kernel, smem_bytes);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem_bytes);
  }
  return WideSetup{err, static_cast<int64_t>(sms) * std::max(per_sm, 1)};
}

// Key splits of a wide-kernel launch of `blocks` row-tile blocks over
// `key_tiles` key tiles: as many as keep the split blocks within one wave
// of the card (every SM holding as many blocks as fit), at most 8 and at
// most half the key tiles. A causal launch counts half its blocks: its
// row tiles walk half the keys on average, and the longest ones, which
// split most usefully, run first.
constexpr int kMaxSplits = 8;

inline int key_splits(int64_t wave, int64_t blocks, int key_tiles, bool causal) {
  const int64_t fill = (causal ? 2 * wave : wave) / blocks;
  return static_cast<int>(
      std::max<int64_t>(1, std::min<int64_t>({fill, key_tiles / 2, kMaxSplits})));
}

// sum of a dot product's S partial sums (the S lanes holding parts of one row)
template <int S>
__device__ __forceinline__ float dim_sum(float x) {
  static_assert(S == 1 || S == 2 || S == 4 || S == 8, "a row's dims span 1, 2, 4 or 8 lanes");
  if constexpr (S >= 2) x += __shfl_xor_sync(0xffffffffu, x, 1);
  if constexpr (S >= 4) x += __shfl_xor_sync(0xffffffffu, x, 2);
  if constexpr (S >= 8) x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

template <int S>
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, S));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2 * S));
}

template <int S>
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, S);
  return x + __shfl_xor_sync(0xffffffffu, x, 2 * S);
}

// Sum x[0..N) over the four lanes of a quad; lane `quad` ends with the
// sums of elements [quad * N/4, (quad + 1) * N/4) in out. Two butterfly
// steps (N/2 + N/4 shuffles), each element summed once in a fixed order.
template <int N, int S>
__device__ __forceinline__ void quad_reduce_scatter(const float (&x)[N], float (&out)[N / 4],
                                                    int quad) {
  constexpr int kHalf = N / 2;
  constexpr int kQuarter = N / 4;
  float part[kHalf];
  const bool hi = quad & 2;
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const float send = hi ? x[j] : x[j + kHalf];
    const float keep = hi ? x[j + kHalf] : x[j];
    part[j] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * S);
  }
  const bool odd = quad & 1;
#pragma unroll
  for (int j = 0; j < kQuarter; ++j) {
    const float send = odd ? part[j] : part[j + kQuarter];
    const float keep = odd ? part[j + kQuarter] : part[j];
    out[j] = keep + __shfl_xor_sync(0xffffffffu, send, S);
  }
}

// load N consecutive elements of T (N a multiple of 4) from device memory
// as floats: 16-byte (float32) or 8-byte (bfloat16) loads when `vec`,
// else element by element
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* p, float (&v)[N], bool vec) {
  static_assert(N % 4 == 0, "rows are loaded four elements at a time");
#pragma unroll
  for (int d = 0; d < N; d += 4) {
    const float4 x = vec ? load4(p + d)
                         : make_float4(to_float(p[d]), to_float(p[d + 1]), to_float(p[d + 2]),
                                       to_float(p[d + 3]));
    v[d] = x.x;
    v[d + 1] = x.y;
    v[d + 2] = x.z;
    v[d + 3] = x.w;
  }
}

// store N consecutive values times `scale` to device memory as T: 16-byte
// (float32) or 8-byte (bfloat16) stores when `vec` and N is a multiple of
// 4, else element by element
template <typename T, int N>
__device__ __forceinline__ void store_row(T* p, const float (&v)[N], float scale, bool vec) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int d = 0; d < N; d += 4) {
      store4(p + d, make_float4(v[d] * scale, v[d + 1] * scale, v[d + 2] * scale,
                                v[d + 3] * scale), vec);
    }
  } else {
#pragma unroll
    for (int d = 0; d < N; ++d) p[d] = from_float<T>(v[d] * scale);
  }
}

}  // namespace flash
