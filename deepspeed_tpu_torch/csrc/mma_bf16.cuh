// bf16 helpers shared by the attention kernels on wgmma (sm_90a): bf16
// packing and the bf16 hi + lo split that lets an f32 operand (softmax
// probabilities, dS) keep ~2^-16 of its precision in a product.
//
// Fragment layout (PTX m16n8k16, lane = 4 * gid + tig; per warp also the
// layout of wgmma's f32 accumulator and of its register A operand, see
// sm90.cuh): A holds rows gid and gid + 8, k columns 2 tig, 2 tig + 1 and
// + 8; C holds rows gid and gid + 8, columns 2 tig and 2 tig + 1. So the C
// tiles of columns 16 j .. 16 j + 15 are the A fragment of k step j of a
// following product.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_bf16 {

typedef __nv_bfloat16 bf16;

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

}  // namespace mma_bf16
