// Tensor-core pieces of the bfloat16/float16 flash kernels (sm_90a):
// the warp-wide m16n8k16 product with float32 accumulators, ldmatrix
// fragment loads from shared memory, the packing of float32 values into
// 16-bit operand registers (one rounding, or a head and a tail term), and
// the special-function unit's exp2.
//
// Fragment layouts of mma.sync.aligned.m16n8k16 (PTX ISA), for lane
// `lane`, g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major): a[0] = A[g][2t..2t+1], a[1] = A[g+8][2t..],
//     a[2] = A[g][2t+8..], a[3] = A[g+8][2t+8..];
//   B (16 x 8, k x n):      b[0] = B[2t..2t+1][g], b[1] = B[2t+8..2t+9][g];
//   C (16 x 8, float32):    c[0..1] = C[g][2t..2t+1], c[2..3] = C[g+8][2t..].
// Two neighbouring C tiles (columns 0-7 and 8-15 of a 16 x 16 block) hold
// exactly an A fragment of that block, so a product's float32 result,
// rounded to 16 bits, is the A operand of the next product in place
// (split_a).
//
// ldmatrix.x4 loads four 8 x 8 matrices of 16-bit elements; lanes 8i to
// 8i + 7 give the row addresses of matrix i, and register i of lane `lane`
// receives row g, elements 2t and 2t + 1 of matrix i (with .trans: column
// g, elements 2t and 2t + 1, i.e. the transposed matrix). Row addresses
// must be 16-byte aligned.

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "flash_common.cuh"

namespace flash {

// c += a * b on the tensor cores: A 16 x 16 and B 16 x 8 in T (bfloat16 or
// float16), C 16 x 8 in float32
template <typename T>
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  static_assert(std::is_same_v<T, __nv_bfloat16> || std::is_same_v<T, __half>,
                "the tensor-core kernels take bfloat16 and float16");
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// 2^x by the special-function unit (ex2.approx: a few float32 ulps, far
// below the 16-bit operands' rounding; -inf gives 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 matrices; `row` is this lane's row address (see above)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_address(row)));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_address(row)));
}

// two floats rounded to T and packed, the lower index in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return pack_bf16x2(lo, hi);
  } else {
    return pack_half2(lo, hi);
  }
}

// two floats as a pair of T: `head` rounded, and what rounding left,
// rounded again, so head + tail carries about twice T's mantissa
template <typename T>
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& head, uint32_t& tail) {
  float2 back;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    back = __bfloat1622float2(h);
    head = *reinterpret_cast<const uint32_t*>(&h);
  } else {
    const __half2 h = __floats2half2_rn(x0, x1);
    back = __half22float2(h);
    head = *reinterpret_cast<const uint32_t*>(&h);
  }
  tail = pack2<T>(x0 - back.x, x1 - back.y);
}

// The A fragment of a 16 x 16 block held as two float32 C tiles (its
// columns 0-7 and 8-15, `c0` and `c1`) as two fragments of T, `head` and
// `tail`: the block is head + tail to about 16 bits (bfloat16) or 22
// (float16) of mantissa, so two products on the tensor cores keep what
// one rounding to T would lose.
template <typename T>
__device__ __forceinline__ void split_a(uint32_t (&head)[4], uint32_t (&tail)[4],
                                        const float (&c0)[4], const float (&c1)[4]) {
  split2<T>(c0[0], c0[1], head[0], tail[0]);
  split2<T>(c0[2], c0[3], head[1], tail[1]);
  split2<T>(c1[0], c1[1], head[2], tail[2]);
  split2<T>(c1[2], c1[3], head[3], tail[3]);
}

// The same A fragment rounded once to T: one product on the tensor cores
template <typename T>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack2<T>(c0[0], c0[1]);
  a[1] = pack2<T>(c0[2], c0[3]);
  a[2] = pack2<T>(c1[0], c1[1]);
  a[3] = pack2<T>(c1[2], c1[3]);
}

// Row address of this lane for an ldmatrix.x4 of a 16 x 16 A block at
// (row0, col0) of a tile with `pitch` elements a row: lanes 0-15 rows
// 0-15 at col0, lanes 16-31 rows 0-15 at col0 + 8.
template <typename E>
__device__ __forceinline__ const E* a_rows(const E* tile, int pitch, int row0, int col0,
                                           int lane) {
  return tile + (row0 + (lane & 15)) * pitch + col0 + (lane >> 4) * 8;
}

// Row address of this lane for an ldmatrix.x4 (no .trans) of the B
// fragments of two n-tiles, from a tile stored n-major (row n, column k:
// K rows for S = Q Kᵀ): registers 0, 1 are n-tile n0's b[0], b[1] and
// registers 2, 3 n-tile n0 + 8's, over k columns k0 to k0 + 15.
template <typename E>
__device__ __forceinline__ const E* b_rows(const E* tile, int pitch, int n0, int k0, int lane) {
  return tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * pitch + k0 + ((lane >> 3) & 1) * 8;
}

// Row address of this lane for an ldmatrix.x4.trans of the B fragments of
// two n-tiles, from a tile stored k-major (row k, column n: V rows for
// O = P V): registers 0, 1 are n-tile n0's b[0], b[1] and registers 2, 3
// n-tile n0 + 8's, over k rows k0 to k0 + 15.
template <typename E>
__device__ __forceinline__ const E* bt_rows(const E* tile, int pitch, int k0, int n0, int lane) {
  return tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * pitch + n0 + (lane >> 4) * 8;
}

}  // namespace flash
