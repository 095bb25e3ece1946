// bf16 tensor-core helpers shared by the attention kernels (sm_90a):
// mma.sync m16n8k16 with f32 accumulators, its fragment loads from padded
// shared memory, and the bf16 hi + lo split that lets an f32 operand
// (softmax probabilities, dS) keep ~2^-16 of its precision in a product.
//
// Fragment layout (PTX m16n8k16, lane = 4 * gid + tig): A holds rows gid
// and gid + 8, k columns 2 tig, 2 tig + 1 and + 8; B holds k rows 2 tig,
// 2 tig + 1 and + 8 of column gid; C holds rows gid and gid + 8, columns
// 2 tig and 2 tig + 1. So the C tiles of columns 16 j .. 16 j + 15 are the
// A fragment of k step j of a following product.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_bf16 {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) = hi + lo, each a bf16 pair
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// the A fragments (hi, lo) of k step j from f32 accumulator tiles c[2j],
// c[2j + 1]
__device__ __forceinline__ void split_a(const float (*c)[4], int j, uint32_t* hi,
                                        uint32_t* lo) {
  split2(c[2 * j][0], c[2 * j][1], hi[0], lo[0]);
  split2(c[2 * j][2], c[2 * j][3], hi[1], lo[1]);
  split2(c[2 * j + 1][0], c[2 * j + 1][1], hi[2], lo[2]);
  split2(c[2 * j + 1][2], c[2 * j + 1][3], hi[3], lo[3]);
}

// c[16x8] += a[16x16] b[16x8]; a row-major by (row, k), b by (n, k)
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the A fragment of rows 0..15, k columns kc..kc+15 of a row-major tile
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* tile, int ld, int gid, int tig,
                                       int kc) {
  const bf16* p = tile + gid * ld + kc + 2 * tig;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// c[16x8] += a b with b's column n0 + gid, k rows kc.. from a tile stored
// by (n, k)
__device__ __forceinline__ void mma_b(float* c, const uint32_t* a, const bf16* tile, int ld,
                                      int n0, int gid, int tig, int kc) {
  const bf16* p = tile + (n0 + gid) * ld + kc + 2 * tig;
  mma16816(c, a, ld32(p), ld32(p + 8));
}

}  // namespace mma_bf16
