// 16-bit helpers shared by the attention kernels on wgmma (sm_90a): packing
// two f32 values into a bf16 (or, T = __half, f16) pair, and the hi + lo
// split that lets an f32 operand (softmax probabilities, dS) keep ~2^-16
// (bf16) or ~2^-22 (f16) of its precision in a product. Every conversion
// rounds to nearest and does not saturate: an f32 value past f16's range
// becomes inf (a loss scaler must see the overflow), and an f16 lo half
// below 2^-14 is a subnormal, which the tensor cores keep.
//
// Fragment layout (PTX m16n8k16, lane = 4 * gid + tig; per warp also the
// layout of wgmma's f32 accumulator and of its register A operand, see
// sm90.cuh): A holds rows gid and gid + 8, k columns 2 tig, 2 tig + 1 and
// + 8; C holds rows gid and gid + 8, columns 2 tig and 2 tig + 1. So the C
// tiles of columns 16 j .. 16 j + 15 are the A fragment of k step j of a
// following product.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace mma_bf16 {

typedef __nv_bfloat16 bf16;

template <typename T>
struct Pair;

template <>
struct Pair<__nv_bfloat16> {
  typedef __nv_bfloat162 type;
  static __device__ __forceinline__ type make(float lo, float hi) {
    return __floats2bfloat162_rn(lo, hi);
  }
  static __device__ __forceinline__ float2 to_float2(type v) { return __bfloat1622float2(v); }
};

template <>
struct Pair<__half> {
  typedef __half2 type;
  static __device__ __forceinline__ type make(float lo, float hi) {
    return __floats2half2_rn(lo, hi);
  }
  static __device__ __forceinline__ float2 to_float2(type v) { return __half22float2(v); }
};

template <typename T = bf16>
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  typename Pair<T>::type v = Pair<T>::make(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the two values of a packed pair as f32
template <typename T = bf16>
__device__ __forceinline__ float2 unpack(uint32_t u) {
  return Pair<T>::to_float2(*reinterpret_cast<const typename Pair<T>::type*>(&u));
}

// (x0, x1) = hi + lo, each a 16-bit pair
template <typename T = bf16>
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  typename Pair<T>::type h = Pair<T>::make(x0, x1);
  const float2 hf = Pair<T>::to_float2(h);
  typename Pair<T>::type l = Pair<T>::make(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// the A fragments (hi, lo) of k step j from f32 accumulator tiles c[2j],
// c[2j + 1]
template <typename T = bf16>
__device__ __forceinline__ void split_a(const float (*c)[4], int j, uint32_t* hi,
                                        uint32_t* lo) {
  split2<T>(c[2 * j][0], c[2 * j][1], hi[0], lo[0]);
  split2<T>(c[2 * j][2], c[2 * j][3], hi[1], lo[1]);
  split2<T>(c[2 * j + 1][0], c[2 * j + 1][1], hi[2], lo[2]);
  split2<T>(c[2 * j + 1][2], c[2 * j + 1][3], hi[3], lo[3]);
}

}  // namespace mma_bf16
