// Flash attention forward for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/flash_attention.py, `_fwd_kernel` (:126) and
// `_fwd_kernel_nomask` (:177), launched by `_fwd` (pallas_call at :220).
//
// Computes GQA attention with an online softmax: for batch b, query head
// h (kv head g = h / rep) and query position i,
//   O[b, i, h]  = sum_j p_ij V[b, j, g] / sum_j p_ij,   p_ij = exp(s_ij - m_i)
//   LSE[b, h, i] = m_i + log(sum_j p_ij)
// over the keys j visible to i (j <= i when causal, kv_mask[b, j] != 0 when
// a key mask is given), with s_ij = sm_scale * q_i . k_j in f32. The running
// max is floored at M_FLOOR, so a fully masked row outputs 0 with LSE
// M_FLOOR, exactly as the TPU kernel does. Layout [B, S, N, D] for Q, K, V
// and O (the models' own layout, no transposes); LSE is [B, N, S] f32.
//
// What bounds it on an H100: operations. A causal call does
// 4 * B * Nq * D * S(S+1)/2 flops against 989 TF/s in bf16, and reads only
// (Q + K + V + O) bytes, so from a few hundred positions on the bound is
// the tensor-core rate.
//
// What the design does about it: one block per (Q tile, kv head, batch)
// covers the whole query-head group (rep * BQ <= 64 rows), so every K/V
// tile is staged in shared memory once and used by all rep heads. K/V
// tiles above the causal diagonal are skipped entirely (their loads and
// math), which halves a causal call's work. The ragged edge (S not a
// multiple of the tile) is masked in the kernel. The softmax state (m, l,
// the O accumulator) stays in f32 registers; O is written once in the
// input dtype. This first version computes both products with f32 FMAs on
// the CUDA cores out of shared memory, so it runs far below the
// tensor-core bound; moving them to wgmma with TMA-fed tiles is the next
// step and changes nothing of this interface.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kMFloor = -1e20f;
constexpr int kThreads = 128;  // 16 row groups x 8 column groups
constexpr int kRows = 64;      // query rows per block (rep * BQ <= kRows)
constexpr int kBK = 32;        // keys per K/V tile
constexpr int kTM = kRows / 16;  // rows per thread
constexpr int kTN = kBK / 8;     // score columns per thread

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D>
constexpr int smem_floats() {
  return kRows * (D + 1) + kBK * (D + 1) + kBK * D + kRows * (kBK + 1);
}

// grid (ceil(S / BQ), Nkv, B), kThreads threads. Row rho of the block is
// query head g*rep + rho / BQ at position q0 + rho % BQ (rows stacked by
// head, as the TPU kernel stacks them). Thread (ty, tx) owns rows
// ty*kTM .. ty*kTM+kTM-1, score columns tx + 8*j, and O columns tx + 8*c.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ kv_mask, T* __restrict__ o, float* __restrict__ lse,
    int S, int N, int Nkv, int rep, int BQ, int causal, float sm_scale) {
  constexpr int kTD = D / 8;  // O columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                    // [kRows][D + 1]
  float* Ks = Qs + kRows * (D + 1);    // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);      // [kBK][D]
  float* Ps = Vs + kBK * D;            // [kRows][kBK + 1]

  const int q0 = blockIdx.x * BQ;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;
  const int rows = rep * BQ;

  // stage the query group, pre-scaled; rows past the group or the sequence
  // are zero (their results are never written)
  for (int e = tid; e < kRows * D; e += kThreads) {
    const int rho = e / D;
    const int d = e - rho * D;
    const int pos = q0 + rho % BQ;
    float val = 0.f;
    if (rho < rows && pos < S) {
      const int head = g * rep + rho / BQ;
      val = to_f(q[(((size_t)b * S + pos) * N + head) * D + d]) * sm_scale;
    }
    Qs[rho * (D + 1) + d] = val;
  }

  int qpos[kTM];
  float m[kTM], l[kTM], acc[kTM][kTD];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    qpos[i] = q0 + (ty * kTM + i) % BQ;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kTD; ++c) acc[i][c] = 0.f;
  }

  // causal: keys past the tile's last query position are invisible
  const int q_last = min(q0 + BQ, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int t = e / D;
      const int d = e - t * D;
      const int pos = k0 + t;
      float kk = 0.f, vv = 0.f;
      if (pos < S) {
        const size_t off = (((size_t)b * S + pos) * Nkv + g) * D + d;
        kk = to_f(k[off]);
        vv = to_f(v[off]);
      }
      Ks[t * (D + 1) + d] = kk;
      Vs[t * D + d] = vv;
    }
    __syncthreads();

    float sacc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) sacc[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[kTM], kv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) qv[i] = Qs[(ty * kTM + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < kTN; ++j) kv[j] = Ks[(tx + 8 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) sacc[i][j] += qv[i] * kv[j];
    }

    // mask: ragged edge, causal triangle, key-padding mask
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int kpos = k0 + tx + 8 * j;
      const bool key_ok = kpos < S && (kv_mask == nullptr || kv_mask[(size_t)b * S + kpos] != 0);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        if (!key_ok || (causal && kpos > qpos[i])) sacc[i][j] = kNegInf;
      }
    }

    // online softmax: a row's 8 column groups are 8 adjacent lanes
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      float mx = sacc[i][0];
#pragma unroll
      for (int j = 1; j < kTN; ++j) mx = fmaxf(mx, sacc[i][j]);
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(fmaxf(m[i], mx), kMFloor);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const float p = expf(sacc[i][j] - m_new);
        Ps[(ty * kTM + i) * (kBK + 1) + tx + 8 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kTD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int t = 0; t < kBK; ++t) {
      float pv[kTM], vv[kTD];
#pragma unroll
      for (int i = 0; i < kTM; ++i) pv[i] = Ps[(ty * kTM + i) * (kBK + 1) + t];
#pragma unroll
      for (int c = 0; c < kTD; ++c) vv[c] = Vs[t * D + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int c = 0; c < kTD; ++c) acc[i][c] += pv[i] * vv[c];
    }
    __syncthreads();  // Ks, Vs and Ps are rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int rho = ty * kTM + i;
    if (rho >= rows || qpos[i] >= S) continue;
    const int head = g * rep + rho / BQ;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    const float inv = 1.f / l_safe;
    T* orow = o + (((size_t)b * S + qpos[i]) * N + head) * D;
#pragma unroll
    for (int c = 0; c < kTD; ++c) orow[tx + 8 * c] = from_f<T>(acc[i][c] * inv);
    if (tx == 0) lse[((size_t)b * N + head) * S + qpos[i]] = m[i] + logf(l_safe);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const uint8_t* kv_mask, void* o,
           float* lse, int B, int S, int N, int Nkv, int causal, float sm_scale,
           cudaStream_t stream) {
  const int rep = N / Nkv;
  const int BQ = kRows / rep;
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + BQ - 1) / BQ, Nkv, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kv_mask,
      static_cast<T*>(o), lse, S, N, Nkv, rep, BQ, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. kv_mask: null or [B, S] uint8 (nonzero
// = key visible). Returns a cudaError_t value (0 = launched).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* kv_mask,
                         void* o, void* lse, int B, int S, int N, int Nkv, int D, int dtype,
                         int causal, float sm_scale, void* stream) {
  if (B < 1 || S < 1 || Nkv < 1 || N % Nkv != 0 || N / Nkv > kRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint8_t* mask = static_cast<const uint8_t*>(kv_mask);
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, mask, o, lse_f, B, S, N, Nkv, causal, sm_scale, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, mask, o, lse_f, B, S, N, Nkv, causal, sm_scale, st);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, mask, o, lse_f, B, S, N, Nkv, causal, sm_scale,
                                     st);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, mask, o, lse_f, B, S, N, Nkv, causal,
                                      sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
