// Block-sparse attention backward, dQ, for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/sparse_attention.py, `_sp_bwd_dq_kernel`
// (:294), launched by `_sp_bwd` (pallas_call at :491). Its partner for
// dK/dV is sparse_bwd_dkv.cu (B7); the two together are the TPU module's
// backward, with no atomics (deterministic gradients).
//
// Computes, for batch b, head h and query position i of query block qi,
// over the keys j of the listed key blocks idx[qi, 0 .. cnt[qi]) (j <= i
// when causal; entries past cnt are -1 and are never read):
//   p_ij  = exp(sm_scale * q_i . k_j - LSE_i)
//   dS_ij = p_ij * (dO_i . v_j - delta_i) * sm_scale
//   dQ_i  = sum_j dS_ij k_j
// with delta_i = dO_i . O_i from the caller ([B, N, S] f32, one plain pass
// before the kernels, as it was one XLA pass in JAX). A row with an empty
// list gets dQ = 0. Layout [B, S, N, D] for Q, K, V, dO and dQ (K/V
// repeated over the query-head group); LSE and delta [B, N, S] f32. dQ is
// written once, in the input dtype, from f32 accumulators.
//
// What bounds it on an H100: three products of 2 * D flops per visible
// (query, key) pair (Q K^T, dO V^T, dS K) against the unique bytes (Q, K,
// V, dO, dQ, LSE, delta once); at a BigBird layout with D = 64 the two are
// of the same order.
//
// What the design does about it: one block per (64-row query tile, head,
// batch) holds the tile's Q and dO rows, LSE and delta in shared memory
// and dQ in f32 registers, and walks only its row's list, staging each
// listed K/V block in 64-key (bf16) or 32-key (f32) tiles; tiles wholly
// above the causal diagonal are skipped. In bf16 the three products run on
// the tensor cores (mma.sync m16n8k16, f32 accumulators, 16 rows per warp;
// dS enters dS K as a bf16 hi + lo pair, keeping f32-like precision as the
// TPU kernel's f32 dots); in f32 they run as FMAs on the CUDA cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace mma_bf16;

constexpr int kThreads = 128;    // 16 row groups x 8 column groups
constexpr int kRows = 64;        // query rows per block (a tile of a query block)
constexpr int kBK = 32;          // keys per K/V tile
constexpr int kTM = kRows / 16;  // rows per thread
constexpr int kTN = kBK / 8;     // score columns per thread

template <int D>
constexpr int smem_floats() {
  // Q, dO rows; K, V tile; dS tile; LSE and delta per row
  return 2 * kRows * (D + 1) + 2 * kBK * (D + 1) + kRows * (kBK + 1) + 2 * kRows;
}

// f32, on the CUDA cores (bf16 takes the tensor-core kernel below).
// grid (N, B, S / kRows), kThreads threads. Thread (ty, tx) owns rows
// ty*kTM .. ty*kTM+kTM-1, score columns tx + 8*j and dQ columns tx + 8*c.
template <int D>
__global__ void __launch_bounds__(kThreads) sparse_bwd_dq_f32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ idx, const int* __restrict__ cnt,
    float* __restrict__ dq, int S, int N, int block, int ldi, int causal, float sm_scale) {
  constexpr int kTD = D / 8;  // dQ columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                     // [kRows][D + 1]
  float* dOs = Qs + kRows * (D + 1);    // [kRows][D + 1]
  float* Ks = dOs + kRows * (D + 1);    // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);       // [kBK][D + 1]
  float* dSs = Vs + kBK * (D + 1);      // [kRows][kBK + 1]
  float* lse_s = dSs + kRows * (kBK + 1);
  float* delta_s = lse_s + kRows;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = blockIdx.z * kRows;
  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;
  const int qi = q0 / block;
  const int n_list = cnt[qi];
  const int* list = idx + (size_t)qi * ldi;

  for (int e = tid; e < kRows * D; e += kThreads) {
    const int rho = e / D;
    const int d = e - rho * D;
    const size_t off = (((size_t)b * S + q0 + rho) * N + h) * D + d;
    Qs[rho * (D + 1) + d] = q[off];
    dOs[rho * (D + 1) + d] = dout[off];
  }
  for (int rho = tid; rho < kRows; rho += kThreads) {
    const size_t r = ((size_t)b * N + h) * S + q0 + rho;
    lse_s[rho] = lse[r];
    delta_s[rho] = delta[r];
  }
  __syncthreads();

  int qpos[kTM];
  float lse_r[kTM], delta_r[kTM], acc[kTM][kTD];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int rho = ty * kTM + i;
    qpos[i] = q0 + rho;
    lse_r[i] = lse_s[rho];
    delta_r[i] = delta_s[rho];
#pragma unroll
    for (int c = 0; c < kTD; ++c) acc[i][c] = 0.f;
  }

  const int q_last = q0 + kRows - 1;
  for (int t = 0; t < n_list; ++t) {
    const int j = list[t];
    for (int k0 = j * block; k0 < (j + 1) * block; k0 += kBK) {
      if (causal && k0 > q_last) break;  // the rest of the block is invisible
      for (int e = tid; e < kBK * D; e += kThreads) {
        const int r = e / D;
        const int d = e - r * D;
        const size_t off = (((size_t)b * S + k0 + r) * N + h) * D + d;
        Ks[r * (D + 1) + d] = k[off];
        Vs[r * (D + 1) + d] = v[off];
      }
      __syncthreads();

      // s = Q K^T and dP = dO V^T on this thread's rows x columns
      float sacc[kTM][kTN], pacc[kTM][kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int c = 0; c < kTN; ++c) sacc[i][c] = pacc[i][c] = 0.f;
      for (int d = 0; d < D; ++d) {
        float qv[kTM], gv[kTM], kv[kTN], vv[kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          qv[i] = Qs[(ty * kTM + i) * (D + 1) + d];
          gv[i] = dOs[(ty * kTM + i) * (D + 1) + d];
        }
#pragma unroll
        for (int c = 0; c < kTN; ++c) {
          kv[c] = Ks[(tx + 8 * c) * (D + 1) + d];
          vv[c] = Vs[(tx + 8 * c) * (D + 1) + d];
        }
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int c = 0; c < kTN; ++c) {
            sacc[i][c] += qv[i] * kv[c];
            pacc[i][c] += gv[i] * vv[c];
          }
      }

      // dS = p (dP - delta) sm_scale; keys past the row (causal) have p = 0
#pragma unroll
      for (int c = 0; c < kTN; ++c) {
        const int kpos = k0 + tx + 8 * c;
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          float p = 0.f;
          if (!(causal && kpos > qpos[i])) p = expf(sacc[i][c] * sm_scale - lse_r[i]);
          dSs[(ty * kTM + i) * (kBK + 1) + tx + 8 * c] = p * (pacc[i][c] - delta_r[i]) * sm_scale;
        }
      }
      __syncthreads();

      // dQ += dS K
      for (int r = 0; r < kBK; ++r) {
        float sv[kTM], kk[kTD];
#pragma unroll
        for (int i = 0; i < kTM; ++i) sv[i] = dSs[(ty * kTM + i) * (kBK + 1) + r];
#pragma unroll
        for (int c = 0; c < kTD; ++c) kk[c] = Ks[r * (D + 1) + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int c = 0; c < kTD; ++c) acc[i][c] += sv[i] * kk[c];
      }
      __syncthreads();  // Ks, Vs and dSs are rewritten by the next tile
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    float* row = dq + (((size_t)b * S + qpos[i]) * N + h) * D;
#pragma unroll
    for (int c = 0; c < kTD; ++c) row[tx + 8 * c] = acc[i][c];
  }
}

// ---------------------------------------------------------------------------
// bf16: the three products on the tensor cores (mma.sync m16n8k16, f32
// accumulators). Warp w owns tile rows 16w..16w+15; a K/V tile is 64 keys.
// ---------------------------------------------------------------------------

constexpr int kMBK = 64;  // keys per K/V tile

template <int D>
constexpr size_t mma_smem_bytes() {
  // Q, dO rows; K, V tile by key; K tile by column; LSE and delta
  return (2 * kRows * (D + 8) + 2 * kMBK * (D + 8) + D * (kMBK + 8)) * sizeof(bf16) +
         2 * kRows * sizeof(float);
}

// grid (N, B, S / kRows), kThreads threads. Thread (warp, gid = lane / 4,
// tig = lane % 4) holds rows 16 warp + gid and + 8 of every 16 x 8
// accumulator tile.
template <int D>
__global__ void __launch_bounds__(kThreads) sparse_bwd_dq_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ idx, const int* __restrict__ cnt, bf16* __restrict__ dq, int S, int N,
    int block, int ldi, int causal, float sm_scale) {
  constexpr int LD = D + 8;     // padded rows: fragment loads hit 32 banks
  constexpr int LT = kMBK + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kRows][LD]
  bf16* dOs = Qs + kRows * LD;                   // [kRows][LD]
  bf16* Ks = dOs + kRows * LD;                   // [kMBK][LD]
  bf16* Vs = Ks + kMBK * LD;                     // [kMBK][LD]
  bf16* Kt = Vs + kMBK * LD;                     // [D][LT]
  float* lse_s = reinterpret_cast<float*>(Kt + D * LT);
  float* delta_s = lse_s + kRows;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = blockIdx.z * kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int qi = q0 / block;
  const int n_list = cnt[qi];
  const int* list = idx + (size_t)qi * ldi;

  for (int e = tid; e < kRows * (D / 8); e += kThreads) {
    const int rho = e / (D / 8);
    const int c = (e - rho * (D / 8)) * 8;
    const size_t off = (((size_t)b * S + q0 + rho) * N + h) * D + c;
    *reinterpret_cast<uint4*>(Qs + rho * LD + c) = *reinterpret_cast<const uint4*>(q + off);
    *reinterpret_cast<uint4*>(dOs + rho * LD + c) = *reinterpret_cast<const uint4*>(dout + off);
  }
  for (int rho = tid; rho < kRows; rho += kThreads) {
    const size_t r = ((size_t)b * N + h) * S + q0 + rho;
    lse_s[rho] = lse[r];
    delta_s[rho] = delta[r];
  }
  __syncthreads();

  int qpos[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rho = warp * 16 + gid + 8 * i;
    qpos[i] = q0 + rho;
    lse_r[i] = lse_s[rho];
    delta_r[i] = delta_s[rho];
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int q_last = q0 + kRows - 1;
  for (int t = 0; t < n_list; ++t) {
    const int j = list[t];
    for (int k0 = j * block; k0 < (j + 1) * block; k0 += kMBK) {
      if (causal && k0 > q_last) break;  // the rest of the block is invisible
      // K, V tile by key (16-byte loads) and K by column
      for (int e = tid; e < kMBK * (D / 8); e += kThreads) {
        const int r = e / (D / 8);
        const int c = (e - r * (D / 8)) * 8;
        const size_t off = (((size_t)b * S + k0 + r) * N + h) * D + c;
        const uint4 kk = *reinterpret_cast<const uint4*>(k + off);
        *reinterpret_cast<uint4*>(Ks + r * LD + c) = kk;
        *reinterpret_cast<uint4*>(Vs + r * LD + c) = *reinterpret_cast<const uint4*>(v + off);
        const bf16* k8 = reinterpret_cast<const bf16*>(&kk);
#pragma unroll
        for (int x = 0; x < 8; ++x) Kt[(c + x) * LT + r] = k8[x];
      }
      __syncthreads();

      // S = Q K^T and dP = dO V^T on this warp's 16 rows x 64 keys
      float sacc[kMBK / 8][4], pacc[kMBK / 8][4];
#pragma unroll
      for (int n = 0; n < kMBK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[n][e] = pacc[n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D; kc += 16) {
        uint32_t qa[4], ga[4];
        load_a(qa, Qs + warp * 16 * LD, LD, gid, tig, kc);
        load_a(ga, dOs + warp * 16 * LD, LD, gid, tig, kc);
#pragma unroll
        for (int n = 0; n < kMBK / 8; ++n) {
          mma_b(sacc[n], qa, Ks, LD, n * 8, gid, tig, kc);
          mma_b(pacc[n], ga, Vs, LD, n * 8, gid, tig, kc);
        }
      }

      // dS = p (dP - delta) sm_scale in place of S; keys past the row
      // (causal) give 0
#pragma unroll
      for (int n = 0; n < kMBK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int kpos = k0 + n * 8 + 2 * tig + (e & 1);
          const float p =
              (causal && kpos > qpos[i]) ? 0.f : expf(sacc[n][e] * sm_scale - lse_r[i]);
          sacc[n][e] = p * (pacc[n][e] - delta_r[i]) * sm_scale;
        }
      }

      // dQ += dS K; the accumulator tiles of keys 16x..16x+15 are the A
      // fragment of that k step
#pragma unroll
      for (int x = 0; x < kMBK / 16; ++x) {
        uint32_t hi[4], lo[4];
        split_a(sacc, x, hi, lo);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const bf16* kb = Kt + (n * 8 + gid) * LT + x * 16 + 2 * tig;
          const uint32_t b0 = ld32(kb), b1 = ld32(kb + 8);
          mma16816(acc[n], hi, b0, b1);
          mma16816(acc[n], lo, b0, b1);
        }
      }
      __syncthreads();  // Ks, Vs and Kt are rewritten by the next tile
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    bf16* row = dq + (((size_t)b * S + qpos[i]) * N + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8 + 2 * tig) = pack(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

// dtype 0: the f32 CUDA-core kernel; 1: the bf16 tensor-core kernel
template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, const int* idx, const int* cnt, void* dq, int B,
           int S, int N, int block, int ldi, int causal, float sm_scale, cudaStream_t stream) {
  dim3 grid(N, B, S / kRows);
  if (dtype == 1) {
    const size_t smem = mma_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(sparse_bwd_dq_mma<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    sparse_bwd_dq_mma<D><<<grid, kThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lse, delta, idx, cnt, static_cast<bf16*>(dq), S, N,
        block, ldi, causal, sm_scale);
  } else {
    const size_t smem = smem_floats<D>() * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(sparse_bwd_dq_f32<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    sparse_bwd_dq_f32<D><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), lse, delta, idx, cnt, static_cast<float*>(dq), S, N,
        block, ldi, causal, sm_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse: [B, N, S] f32 from the forward;
// delta: [B, N, S] f32 = rowsum(dO * O). idx / cnt: the forward's
// adjacency ([S / block, ldi] and [S / block] int32). Returns a
// cudaError_t value (0 = launched).
extern "C" int sparse_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* idx,
                             const void* cnt, void* dq, int B, int S, int N, int D, int block,
                             int ldi, int dtype, int causal, float sm_scale, void* stream) {
  if (B < 1 || S < 1 || N < 1 || (block != 64 && block != 128) || S % block != 0 || ldi < 1 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  const int* idx_i = static_cast<const int*>(idx);
  const int* cnt_i = static_cast<const int*>(cnt);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(dtype, q, k, v, dout, lse_f, delta_f, idx_i, cnt_i, dq, B, S, N, block,
                      ldi, causal, sm_scale, st);
  if (D == 128)
    return launch<128>(dtype, q, k, v, dout, lse_f, delta_f, idx_i, cnt_i, dq, B, S, N, block,
                       ldi, causal, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
