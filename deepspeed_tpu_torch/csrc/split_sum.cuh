// The second passes of the block-sparse kernels' split walks (B5, B6,
// B7): where a work item's list was cut into pieces, each piece wrote f32
// partials of its output block to a workspace slot, and these kernels
// combine the pieces of each block in a fixed order (slot s0, s0 + 1, ...)
// and write the block once, in bf16: `sum_partials` adds gradients (B6,
// B7); `lse_merge` merges forward states (B5) by the log-sum-exp rule. No
// atomics: the outputs are the same bit for bit from launch to launch.
//
// Layouts: a workspace is [slots][B * N][rows][D] f32 (rows = the layout
// block), B5's (m, l) beside it [slots][B * N][rows] float2; an output is
// [B, S, N, D] bf16, B5's LSE [B, N, S] f32; sums[3 i .. 3 i + 2] =
// (output block, first slot, pieces).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace split_sum {

constexpr int kThreads = 256;
constexpr int kChunk = kThreads * 4;   // floats of a block a CUDA block adds

// grid (blocks to sum x rows * D / kChunk, B * N, tensors), kThreads
// threads, one float4 of one output row a thread (enough loads in flight:
// the pieces are read from L2 or device memory); tensor z sums ws[z] into
// out[z] (B7 sums dK and dV in one launch)
__global__ void __launch_bounds__(kThreads) sum_partials(
    const int* __restrict__ sums, const float* __restrict__ ws0, const float* __restrict__ ws1,
    __nv_bfloat16* __restrict__ out0, __nv_bfloat16* __restrict__ out1, int S, int N, int rows,
    int D) {
  const int chunks = rows * D / kChunk;
  const int* e = sums + 3 * (blockIdx.x / chunks);
  const int o = e[0];
  const int s0 = e[1];
  const int pieces = e[2];
  const int i = (blockIdx.x % chunks) * kChunk + threadIdx.x * 4;
  const int bh = blockIdx.y;
  const int h = bh % N;
  const int b = bh / N;
  const size_t piece = (size_t)gridDim.y * rows * D;
  const float* src = (blockIdx.z ? ws1 : ws0) + ((size_t)s0 * gridDim.y + bh) * rows * D + i;
  float4 a = *reinterpret_cast<const float4*>(src);
#pragma unroll 4
  for (int p = 1; p < pieces; ++p) {
    const float4 c = *reinterpret_cast<const float4*>(src + p * piece);
    a.x += c.x;
    a.y += c.y;
    a.z += c.z;
    a.w += c.w;
  }
  const int r = i / D;
  const int c = i - r * D;
  __nv_bfloat162 lo = __floats2bfloat162_rn(a.x, a.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(a.z, a.w);
  uint2 pk;
  pk.x = *reinterpret_cast<uint32_t*>(&lo);
  pk.y = *reinterpret_cast<uint32_t*>(&hi);
  __nv_bfloat16* out = blockIdx.z ? out1 : out0;
  *reinterpret_cast<uint2*>(out + (((size_t)b * S + (size_t)o * rows + r) * N + h) * D + c) = pk;
}

// rows * D must be a multiple of kChunk (the layout blocks are 64 or 128
// rows, D 64 or 128). Returns a cudaError_t value (0 = launched, or
// nothing to sum).
inline int launch(const int* sums, int n_sums, const float* ws0, const float* ws1, void* out0,
                  void* out1, int B, int S, int N, int rows, int D, cudaStream_t stream) {
  if (n_sums == 0) return 0;
  dim3 grid(n_sums * (rows * D / kChunk), B * N, ws1 != nullptr ? 2 : 1);
  sum_partials<<<grid, kThreads, 0, stream>>>(sums, ws0, ws1,
                                               static_cast<__nv_bfloat16*>(out0),
                                               static_cast<__nv_bfloat16*>(out1), S, N, rows, D);
  return static_cast<int>(cudaGetLastError());
}

// grid (blocks to merge x rows * D / kChunk, B * N), kThreads threads, one
// float4 of one output row a thread. Piece p of a row holds acc_p (O's
// numerator relative to its running max), m_p (that max, in log2 units)
// and l_p; with M = max_p m_p and f_p = 2^(m_p - M): O = sum_p f_p acc_p /
// sum_p f_p l_p, LSE = M ln 2 + log(sum_p f_p l_p).
__global__ void __launch_bounds__(kThreads) lse_merge(
    const int* __restrict__ sums, const float* __restrict__ ws, const float2* __restrict__ ws_ml,
    __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int S, int N, int rows, int D) {
  const int chunks = rows * D / kChunk;
  const int* e = sums + 3 * (blockIdx.x / chunks);
  const int o = e[0];
  const int s0 = e[1];
  const int pieces = e[2];
  const int i = (blockIdx.x % chunks) * kChunk + threadIdx.x * 4;
  const int r = i / D;
  const int c = i - r * D;
  const int bh = blockIdx.y;
  const int h = bh % N;
  const int b = bh / N;
  const size_t row = ((size_t)s0 * gridDim.y + bh) * rows + r;   // piece 0's row
  const size_t piece = (size_t)gridDim.y * rows;                  // rows a slot holds
  float M = ws_ml[row].x;
  for (int p = 1; p < pieces; ++p) M = fmaxf(M, ws_ml[row + p * piece].x);
  float L = 0.f;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int p = 0; p < pieces; ++p) {
    const float2 ml = ws_ml[row + p * piece];
    const float f = exp2f(ml.x - M);
    const float4 x = *reinterpret_cast<const float4*>(ws + (row + p * piece) * D + c);
    L += ml.y * f;
    a.x += x.x * f;
    a.y += x.y * f;
    a.z += x.z * f;
    a.w += x.w * f;
  }
  const float inv = L == 0.f ? 1.f : 1.f / L;
  __nv_bfloat162 lo = __floats2bfloat162_rn(a.x * inv, a.y * inv);
  __nv_bfloat162 hi = __floats2bfloat162_rn(a.z * inv, a.w * inv);
  uint2 pk;
  pk.x = *reinterpret_cast<uint32_t*>(&lo);
  pk.y = *reinterpret_cast<uint32_t*>(&hi);
  const int pos = o * rows + r;
  *reinterpret_cast<uint2*>(out + (((size_t)b * S + pos) * N + h) * D + c) = pk;
  if (c == 0)
    lse[((size_t)b * N + h) * S + pos] =
        M * 0.6931471805599453f + logf(L == 0.f ? 1.f : L);
}

// as `launch`: rows * D a multiple of kChunk. Returns a cudaError_t value
// (0 = launched, or nothing to merge).
inline int launch_lse_merge(const int* sums, int n_sums, const float* ws, const float2* ws_ml,
                            void* out, float* lse, int B, int S, int N, int rows, int D,
                            cudaStream_t stream) {
  if (n_sums == 0) return 0;
  dim3 grid(n_sums * (rows * D / kChunk), B * N);
  lse_merge<<<grid, kThreads, 0, stream>>>(sums, ws, ws_ml, static_cast<__nv_bfloat16*>(out),
                                           lse, S, N, rows, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace split_sum
