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
// input dtype. In bf16 both products run on the tensor cores (mma.sync
// m16n8k16, f32 accumulators; 64-key tiles, 16 rows per warp; p enters the
// p V product as a bf16 hi + lo pair, so it keeps f32-like precision as on
// the TPU); in f32 they run as FMAs on the CUDA cores. Staging is synchronous
// and the fragments come from padded shared memory by plain loads: wgmma
// with TMA-fed, double-buffered tiles is the next step and changes nothing
// of this interface.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace mma_bf16;

constexpr float kNegInf = -1e30f;
constexpr float kMFloor = -1e20f;
constexpr int kThreads = 128;  // 16 row groups x 8 column groups
constexpr int kRows = 64;      // query rows per block (rep * BQ <= kRows)
constexpr int kBK = 32;        // keys per K/V tile
constexpr int kTM = kRows / 16;  // rows per thread
constexpr int kTN = kBK / 8;     // score columns per thread

template <int D>
constexpr int smem_floats() {
  return kRows * (D + 1) + kBK * (D + 1) + kBK * D + kRows * (kBK + 1);
}

// f32, on the CUDA cores (bf16 takes the tensor-core kernel below).
// grid (ceil(S / BQ), Nkv, B), kThreads threads. Row rho of the block is
// query head g*rep + rho / BQ at position q0 + rho % BQ (rows stacked by
// head, as the TPU kernel stacks them). Thread (ty, tx) owns rows
// ty*kTM .. ty*kTM+kTM-1, score columns tx + 8*j, and O columns tx + 8*c.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const uint8_t* __restrict__ kv_mask, float* __restrict__ o, float* __restrict__ lse,
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
      val = q[(((size_t)b * S + pos) * N + head) * D + d] * sm_scale;
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
        kk = k[off];
        vv = v[off];
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
    float* orow = o + (((size_t)b * S + qpos[i]) * N + head) * D;
#pragma unroll
    for (int c = 0; c < kTD; ++c) orow[tx + 8 * c] = acc[i][c] * inv;
    if (tx == 0) lse[((size_t)b * N + head) * S + qpos[i]] = m[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// bf16: both products on the tensor cores (mma.sync m16n8k16, f32
// accumulators). Warp w owns block rows 16w..16w+15; a K/V tile is 64 keys.
// p enters the p V product as a pair of bf16 values (hi + lo), keeping
// ~2^-16 of its f32 precision, as the TPU kernel's f32 dot.
// ---------------------------------------------------------------------------

constexpr int kMBK = 64;  // keys per K/V tile

template <int D>
constexpr size_t mma_smem_bytes() {
  // Q rows, K tile by key, V tile by column
  return (kRows * (D + 8) + kMBK * (D + 8) + D * (kMBK + 8)) * sizeof(bf16);
}

// grid (ceil(S / BQ), Nkv, B), kThreads threads; rows stacked by head as in
// the CUDA-core kernel. Thread (warp, gid = lane / 4, tig = lane % 4) holds
// rows 16 warp + gid and + 8 of every 16 x 8 accumulator tile; the 4
// threads of a quad share those rows.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const uint8_t* __restrict__ kv_mask, bf16* __restrict__ o, float* __restrict__ lse, int S,
    int N, int Nkv, int rep, int BQ, int causal, float sm_scale) {
  constexpr int LD = D + 8;     // padded rows: fragment loads hit 32 banks
  constexpr int LT = kMBK + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kRows][LD]
  bf16* Ks = Qs + kRows * LD;                    // [kMBK][LD]
  bf16* Vt = Ks + kMBK * LD;                     // [D][LT]

  const int q0 = blockIdx.x * BQ;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int rows = rep * BQ;

  for (int e = tid; e < kRows * (D / 8); e += kThreads) {
    const int rho = e / (D / 8);
    const int c = (e - rho * (D / 8)) * 8;
    const int pos = q0 + rho % BQ;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (rho < rows && pos < S) {
      const int head = g * rep + rho / BQ;
      val = *reinterpret_cast<const uint4*>(q + (((size_t)b * S + pos) * N + head) * D + c);
    }
    *reinterpret_cast<uint4*>(Qs + rho * LD + c) = val;
  }

  int qpos[2];
  bool rvalid[2];
  float m[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rho = warp * 16 + gid + 8 * i;
    qpos[i] = q0 + rho % BQ;
    rvalid[i] = rho < rows && qpos[i] < S;
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int q_last = min(q0 + BQ, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;
  for (int k0 = 0; k0 < kv_end; k0 += kMBK) {
    for (int e = tid; e < kMBK * (D / 8); e += kThreads) {
      const int t = e / (D / 8);
      const int c = (e - t * (D / 8)) * 8;
      const int pos = k0 + t;
      uint4 kk = make_uint4(0, 0, 0, 0), vv = kk;
      if (pos < S) {
        const size_t off = (((size_t)b * S + pos) * Nkv + g) * D + c;
        kk = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(Ks + t * LD + c) = kk;
      const bf16* v8 = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[(c + j) * LT + t] = v8[j];
    }
    __syncthreads();

    float sacc[kMBK / 8][4];
#pragma unroll
    for (int n = 0; n < kMBK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D; kc += 16) {
      uint32_t a[4];
      load_a(a, Qs + warp * 16 * LD, LD, gid, tig, kc);
#pragma unroll
      for (int n = 0; n < kMBK / 8; ++n) mma_b(sacc[n], a, Ks, LD, n * 8, gid, tig, kc);
    }

    // scale; mask the ragged edge, the causal triangle and the key mask
#pragma unroll
    for (int n = 0; n < kMBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + n * 8 + 2 * tig + (e & 1);
        const bool ok = kpos < S && !(causal && kpos > qpos[e >> 1]) &&
                        (kv_mask == nullptr || kv_mask[(size_t)b * S + kpos] != 0);
        sacc[n][e] = ok ? sacc[n][e] * sm_scale : kNegInf;
      }
    }

    // online softmax over each row's 64 scores, held by the 4 threads of a
    // quad; p replaces the scores
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < kMBK / 8; ++n) mx = fmaxf(mx, fmaxf(sacc[n][2 * i], sacc[n][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(fmaxf(m[i], mx), kMFloor);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kMBK / 8; ++n) {
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          sacc[n][e] = expf(sacc[n][e] - m_new);
          sum += sacc[n][e];
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * i] *= alpha;
        acc[n][2 * i + 1] *= alpha;
      }
    }

    // O += p V; the score tiles of keys 16j..16j+15 are the A fragment of
    // that k step
#pragma unroll
    for (int j = 0; j < kMBK / 16; ++j) {
      uint32_t hi[4], lo[4];
      split_a(sacc, j, hi, lo);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const bf16* vb = Vt + (n * 8 + gid) * LT + j * 16 + 2 * tig;
        const uint32_t b0 = ld32(vb), b1 = ld32(vb + 8);
        mma16816(acc[n], hi, b0, b1);
        mma16816(acc[n], lo, b0, b1);
      }
    }
    __syncthreads();  // Ks and Vt are rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!rvalid[i]) continue;
    const int head = g * rep + (warp * 16 + gid + 8 * i) / BQ;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    const float inv = 1.f / l_safe;
    bf16* orow = o + (((size_t)b * S + qpos[i]) * N + head) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * tig) =
          pack(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    if (tig == 0) lse[((size_t)b * N + head) * S + qpos[i]] = m[i] + logf(l_safe);
  }
}

// dtype 0: the f32 CUDA-core kernel; 1: the bf16 tensor-core kernel
template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, const uint8_t* kv_mask, void* o,
           float* lse, int B, int S, int N, int Nkv, int causal, float sm_scale,
           cudaStream_t stream) {
  const int rep = N / Nkv;
  const int BQ = kRows / rep;
  dim3 grid((S + BQ - 1) / BQ, Nkv, B);
  if (dtype == 1) {
    const size_t smem = mma_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_mma<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fwd_mma<D><<<grid, kThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        kv_mask, static_cast<bf16*>(o), lse, S, N, Nkv, rep, BQ, causal, sm_scale);
  } else {
    const size_t smem = smem_floats<D>() * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fwd_f32<D><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        kv_mask, static_cast<float*>(o), lse, S, N, Nkv, rep, BQ, causal, sm_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. kv_mask: null or [B, S] uint8 (nonzero
// = key visible). Returns a cudaError_t value (0 = launched).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* kv_mask,
                         void* o, void* lse, int B, int S, int N, int Nkv, int D, int dtype,
                         int causal, float sm_scale, void* stream) {
  if (B < 1 || S < 1 || Nkv < 1 || N % Nkv != 0 || N / Nkv > kRows ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint8_t* mask = static_cast<const uint8_t*>(kv_mask);
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(dtype, q, k, v, mask, o, lse_f, B, S, N, Nkv, causal, sm_scale, st);
  if (D == 128)
    return launch<128>(dtype, q, k, v, mask, o, lse_f, B, S, N, Nkv, causal, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
