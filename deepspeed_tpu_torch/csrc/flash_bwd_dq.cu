// Flash attention backward, dQ, for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/flash_attention.py, `_bwd_dq_kernel` (:257)
// and `_bwd_dq_kernel_nomask` (:368), launched by `_bwd` (pallas_call at
// :426). Its partner for dK/dV is flash_bwd_dkv.cu (B3); the two together
// are the TPU module's backward, with no atomics (deterministic gradients).
//
// Computes, for batch b, query head h (kv head g = h / rep) and query
// position i, over the keys j visible to i (j <= i when causal,
// kv_mask[b, j] != 0 when a key mask is given):
//   p_ij  = exp(sm_scale * q_i . k_j - LSE_i)
//   dS_ij = p_ij * (dO_i . v_j - delta_i) * sm_scale
//   dQ_i  = sum_j dS_ij k_j
// with delta_i = dO_i . O_i. An invisible key has p = 0, so a fully masked
// row (LSE = M_FLOOR from the forward) gets dQ = 0, as on the TPU. delta
// comes from the caller ([B, N, S] f32, one plain pass) or, when the
// caller passes none (fused backward), from O inside this kernel, once per
// block. Layout [B, S, N, D] for Q, O, dO and dQ, [B, S, Nkv, D] for K and
// V (the models' own layout, no transposes); LSE and delta [B, N, S] f32.
// dQ is written once, in the input dtype, from f32 accumulators.
//
// What bounds it on an H100: operations. Three products of 2*D flops per
// visible (query, key) pair (Q K^T, dO V^T, dS K) against 989 TF/s in
// bf16; it reads Q, dO, O, K, V once, so at llama-1b's training shape
// (B=8, S=2048, 32/8 heads, D=64) bytes take ~0.07 ms against ~0.21 ms
// of tensor-core time.
//
// What the design does about it: one block per (Q tile, kv head, batch)
// holds the whole query-head group's rows (rep * BQ <= 64) of Q and dO,
// with their LSE and delta, in shared memory, and loops over K/V tiles up
// to the causal diagonal (tiles above it are never loaded), so each K/V
// tile is staged once for all rep heads. dQ stays in f32 registers for
// the whole loop. The ragged edge (S not a multiple of a tile) and the key
// mask are masked in the kernel. In bf16 the three products run on the
// tensor cores (mma.sync m16n8k16, f32 accumulators, 64-key tiles, 16 rows
// per warp; dS enters dS K as a bf16 hi + lo pair, keeping f32-like
// precision as the TPU kernel's f32 dots); in f32 they run as FMAs on the
// CUDA cores. wgmma with TMA-fed tiles is the next step and changes
// nothing of this interface.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace mma_bf16;

constexpr int kThreads = 128;  // 16 row groups x 8 column groups
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;      // query rows per block (rep * BQ <= kRows)
constexpr int kBK = 32;        // keys per K/V tile
constexpr int kTM = kRows / 16;  // rows per thread
constexpr int kTN = kBK / 8;     // score columns per thread

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr int smem_floats() {
  // Q, dO rows; K, V tile; dS tile; LSE and delta per row
  return 2 * kRows * (D + 1) + 2 * kBK * (D + 1) + kRows * (kBK + 1) + 2 * kRows;
}

// f32, on the CUDA cores (bf16 takes the tensor-core kernel below).
// grid (ceil(S / BQ), Nkv, B), kThreads threads. Row rho of the block is
// query head g*rep + rho / BQ at position q0 + rho % BQ (rows stacked by
// head, as the TPU kernel stacks them). Thread (ty, tx) owns rows
// ty*kTM .. ty*kTM+kTM-1, score columns tx + 8*j and dQ columns tx + 8*c.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_f32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ o, const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const uint8_t* __restrict__ kv_mask,
    float* __restrict__ dq, int S, int N, int Nkv, int rep, int BQ, int causal, float sm_scale) {
  constexpr int kTD = D / 8;  // dQ columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                     // [kRows][D + 1]
  float* dOs = Qs + kRows * (D + 1);    // [kRows][D + 1]
  float* Ks = dOs + kRows * (D + 1);    // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);       // [kBK][D + 1]
  float* dSs = Vs + kBK * (D + 1);      // [kRows][kBK + 1]
  float* lse_s = dSs + kRows * (kBK + 1);
  float* delta_s = lse_s + kRows;

  const int q0 = blockIdx.x * BQ;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rows = rep * BQ;

  // stage the group's Q and dO rows, one warp per row (a row's D values
  // are contiguous); rows past the group or the sequence are zero. The
  // fused backward takes delta = dO . O here, while dO is at hand.
  for (int rho = warp; rho < kRows; rho += kWarps) {
    const int pos = q0 + rho % BQ;
    const bool valid = rho < rows && pos < S;
    const int head = g * rep + rho / BQ;
    const size_t off = (((size_t)b * S + pos) * N + head) * D;
    float dsum = 0.f;
    for (int d = lane; d < D; d += 32) {
      float qq = 0.f, gg = 0.f;
      if (valid) {
        qq = q[off + d];
        gg = dout[off + d];
        if (delta == nullptr) dsum += gg * o[off + d];
      }
      Qs[rho * (D + 1) + d] = qq;
      dOs[rho * (D + 1) + d] = gg;
    }
    dsum = warp_sum(dsum);
    if (lane == 0) {
      float l = 0.f, dl = 0.f;
      if (valid) {
        const size_t r = ((size_t)b * N + head) * S + pos;
        l = lse[r];
        dl = delta != nullptr ? delta[r] : dsum;
      }
      lse_s[rho] = l;
      delta_s[rho] = dl;
    }
  }
  __syncthreads();

  int qpos[kTM];
  bool rvalid[kTM];
  float lse_r[kTM], delta_r[kTM], acc[kTM][kTD];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int rho = ty * kTM + i;
    qpos[i] = q0 + rho % BQ;
    rvalid[i] = rho < rows && qpos[i] < S;
    lse_r[i] = lse_s[rho];
    delta_r[i] = delta_s[rho];
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
      Vs[t * (D + 1) + d] = vv;
    }
    __syncthreads();

    // s = Q K^T and dP = dO V^T on this thread's rows x columns
    float sacc[kTM][kTN], pacc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) sacc[i][j] = pacc[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[kTM], gv[kTM], kv[kTN], vv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        qv[i] = Qs[(ty * kTM + i) * (D + 1) + d];
        gv[i] = dOs[(ty * kTM + i) * (D + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        kv[j] = Ks[(tx + 8 * j) * (D + 1) + d];
        vv[j] = Vs[(tx + 8 * j) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          sacc[i][j] += qv[i] * kv[j];
          pacc[i][j] += gv[i] * vv[j];
        }
    }

    // dS = p (dP - delta) sm_scale; invisible keys (ragged edge, causal
    // triangle, key mask) and rows past the group have p = 0
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int kpos = k0 + tx + 8 * j;
      const bool key_ok = kpos < S && (kv_mask == nullptr || kv_mask[(size_t)b * S + kpos] != 0);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        float p = 0.f;
        if (key_ok && rvalid[i] && !(causal && kpos > qpos[i]))
          p = expf(sacc[i][j] * sm_scale - lse_r[i]);
        dSs[(ty * kTM + i) * (kBK + 1) + tx + 8 * j] = p * (pacc[i][j] - delta_r[i]) * sm_scale;
      }
    }
    __syncthreads();

    // dQ += dS K
    for (int t = 0; t < kBK; ++t) {
      float sv[kTM], kk[kTD];
#pragma unroll
      for (int i = 0; i < kTM; ++i) sv[i] = dSs[(ty * kTM + i) * (kBK + 1) + t];
#pragma unroll
      for (int c = 0; c < kTD; ++c) kk[c] = Ks[t * (D + 1) + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int c = 0; c < kTD; ++c) acc[i][c] += sv[i] * kk[c];
    }
    __syncthreads();  // Ks, Vs and dSs are rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    if (!rvalid[i]) continue;
    const int head = g * rep + (ty * kTM + i) / BQ;
    float* row = dq + (((size_t)b * S + qpos[i]) * N + head) * D;
#pragma unroll
    for (int c = 0; c < kTD; ++c) row[tx + 8 * c] = acc[i][c];
  }
}

// ---------------------------------------------------------------------------
// bf16: the three products on the tensor cores (mma.sync m16n8k16, f32
// accumulators). Warp w owns block rows 16w..16w+15; a K/V tile is 64 keys.
// dS enters the dS K product as a pair of bf16 values (hi + lo), so that
// product keeps ~2^-16 of dS's f32 precision, as the TPU kernel's f32 dot.
// ---------------------------------------------------------------------------

constexpr int kMBK = 64;  // keys per K/V tile

template <int D>
constexpr size_t mma_smem_bytes() {
  // Q, dO rows; K, V tile by key; K tile by column; LSE and delta
  return (2 * kRows * (D + 8) + 2 * kMBK * (D + 8) + D * (kMBK + 8)) * sizeof(bf16) +
         2 * kRows * sizeof(float);
}

// grid (ceil(S / BQ), Nkv, B), kThreads threads; rows stacked by head as in
// the SIMT kernel. Thread (warp, gid = lane / 4, tig = lane % 4) holds rows
// 16 warp + gid and + 8 of every 16 x 8 accumulator tile.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const uint8_t* __restrict__ kv_mask,
    bf16* __restrict__ dq, int S, int N, int Nkv, int rep, int BQ, int causal, float sm_scale) {
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

  const int q0 = blockIdx.x * BQ;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int rows = rep * BQ;

  for (int rho = warp; rho < kRows; rho += kWarps) {
    const int pos = q0 + rho % BQ;
    const bool valid = rho < rows && pos < S;
    const int head = g * rep + rho / BQ;
    const size_t off = (((size_t)b * S + pos) * N + head) * D;
    float dsum = 0.f;
    for (int d = lane; d < D; d += 32) {
      bf16 qq = __float2bfloat16(0.f), gg = qq;
      if (valid) {
        qq = q[off + d];
        gg = dout[off + d];
        if (delta == nullptr) dsum += __bfloat162float(gg) * __bfloat162float(o[off + d]);
      }
      Qs[rho * LD + d] = qq;
      dOs[rho * LD + d] = gg;
    }
    dsum = warp_sum(dsum);
    if (lane == 0) {
      float l = 0.f, dl = 0.f;
      if (valid) {
        const size_t r = ((size_t)b * N + head) * S + pos;
        l = lse[r];
        dl = delta != nullptr ? delta[r] : dsum;
      }
      lse_s[rho] = l;
      delta_s[rho] = dl;
    }
  }
  __syncthreads();

  int qpos[2];
  bool rvalid[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rho = warp * 16 + gid + 8 * i;
    qpos[i] = q0 + rho % BQ;
    rvalid[i] = rho < rows && qpos[i] < S;
    lse_r[i] = lse_s[rho];
    delta_r[i] = delta_s[rho];
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int q_last = min(q0 + BQ, S) - 1;
  const int kv_end = causal ? q_last + 1 : S;
  for (int k0 = 0; k0 < kv_end; k0 += kMBK) {
    // K, V tile by key (16-byte loads) and K by column
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
      *reinterpret_cast<uint4*>(Vs + t * LD + c) = vv;
      const bf16* kv8 = reinterpret_cast<const bf16*>(&kk);
#pragma unroll
      for (int j = 0; j < 8; ++j) Kt[(c + j) * LT + t] = kv8[j];
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

    // dS = p (dP - delta) sm_scale in place of S; invisible pairs give 0
#pragma unroll
    for (int n = 0; n < kMBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int kpos = k0 + n * 8 + 2 * tig + (e & 1);
        const bool ok = kpos < S && rvalid[i] && !(causal && kpos > qpos[i]) &&
                        (kv_mask == nullptr || kv_mask[(size_t)b * S + kpos] != 0);
        const float p = ok ? expf(sacc[n][e] * sm_scale - lse_r[i]) : 0.f;
        sacc[n][e] = p * (pacc[n][e] - delta_r[i]) * sm_scale;
      }
    }

    // dQ += dS K; the accumulator tiles of keys 16j..16j+15 are the A
    // fragment of that k step
#pragma unroll
    for (int j = 0; j < kMBK / 16; ++j) {
      uint32_t hi[4], lo[4];
      split_a(sacc, j, hi, lo);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const bf16* kb = Kt + (n * 8 + gid) * LT + j * 16 + 2 * tig;
        const uint32_t b0 = ld32(kb), b1 = ld32(kb + 8);
        mma16816(acc[n], hi, b0, b1);
        mma16816(acc[n], lo, b0, b1);
      }
    }
    __syncthreads();  // Ks, Vs and Kt are rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!rvalid[i]) continue;
    const int head = g * rep + (warp * 16 + gid + 8 * i) / BQ;
    bf16* row = dq + (((size_t)b * S + qpos[i]) * N + head) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8 + 2 * tig) = pack(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

// dtype 0: the f32 CUDA-core kernel; 1: the bf16 tensor-core kernel
template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, const float* delta, const uint8_t* kv_mask,
           void* dq, int B, int S, int N, int Nkv, int causal, float sm_scale,
           cudaStream_t stream) {
  const int rep = N / Nkv;
  const int BQ = kRows / rep;
  dim3 grid((S + BQ - 1) / BQ, Nkv, B);
  if (dtype == 1) {
    const size_t smem = mma_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_mma<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dq_mma<D><<<grid, kThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, delta, kv_mask,
        static_cast<bf16*>(dq), S, N, Nkv, rep, BQ, causal, sm_scale);
  } else {
    const size_t smem = smem_floats<D>() * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_f32<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_dq_f32<D><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(o), static_cast<const float*>(dout), lse, delta, kv_mask,
        static_cast<float*>(dq), S, N, Nkv, rep, BQ, causal, sm_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse: [B, N, S] f32 from the forward.
// delta: null (fused: computed here from o) or [B, N, S] f32. kv_mask: null
// or [B, S] uint8 (nonzero = key visible). Returns a cudaError_t value
// (0 = launched).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const void* lse, const void* delta,
                            const void* kv_mask, void* dq, int B, int S, int N, int Nkv, int D,
                            int dtype, int causal, float sm_scale, void* stream) {
  if (B < 1 || S < 1 || Nkv < 1 || N % Nkv != 0 || N / Nkv > kRows ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  const uint8_t* mask = static_cast<const uint8_t*>(kv_mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(dtype, q, k, v, o, dout, lse_f, delta_f, mask, dq, B, S, N, Nkv, causal,
                      sm_scale, st);
  if (D == 128)
    return launch<128>(dtype, q, k, v, o, dout, lse_f, delta_f, mask, dq, B, S, N, Nkv, causal,
                       sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
