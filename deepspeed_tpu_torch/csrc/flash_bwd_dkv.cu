// Flash attention backward, dK and dV, for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/flash_attention.py, `_bwd_dkv_kernel` (:312)
// and `_bwd_dkv_kernel_nomask` (:374), launched by `_bwd` (pallas_call at
// :452). Its partner for dQ is flash_bwd_dq.cu (B2); the two together are
// the TPU module's backward, with no atomics (deterministic gradients).
//
// Computes, for batch b, kv head g and key position j, over the query
// heads h of g's group (h / rep == g) and the query positions i that see
// j (i >= j when causal; none when kv_mask[b, j] == 0):
//   p_ij  = exp(sm_scale * q_i . k_j - LSE_i)
//   dS_ij = p_ij * (dO_i . v_j - delta_i) * sm_scale
//   dV_j  = sum_{h, i} p_ij dO_i,     dK_j = sum_{h, i} dS_ij q_i
// with delta_i = dO_i . O_i, from the caller ([B, N, S] f32, one plain
// pass) or, when the caller passes none (fused backward), recomputed from
// O at every query tile, as the TPU kernel recomputes it at every step.
// Layout [B, S, N, D] for Q, O and dO, [B, S, Nkv, D] for K, V, dK and dV
// (the models' own layout); LSE and delta [B, N, S] f32. dK and dV are
// written once, in the input dtype, from f32 accumulators.
//
// What bounds it on an H100: operations. Four products of 2*D flops per
// visible (query, key) pair (K Q^T, V dO^T, p^T dO, dS^T Q) against
// 989 TF/s in bf16; at llama-1b's training shape (B=8, S=2048, 32/8 heads,
// D=64) bytes take ~0.07 ms against ~0.28 ms of tensor-core time.
//
// What the design does about it: one block per (K tile, kv head, batch)
// keeps its K and V tile in shared memory and dK, dV in f32 registers, and
// loops over query tiles x the rep heads of the group, starting at the
// first tile that can see the block's first key (the clamp of the TPU
// kernel's `_q_index_map`, :380): tiles below the causal diagonal are
// never loaded. Each step stages one head's query rows (Q, dO, LSE,
// delta) once for all the block's keys. The ragged edge and the key mask
// are masked in the kernel. In bf16 the four products run on the tensor
// cores (mma.sync m16n8k16, f32 accumulators; 64 keys per block, 16 per
// warp; query steps of 64 rows at D=64 and 32 at D=128 so dK and dV stay
// in registers; p and dS enter their products as bf16 hi + lo pairs,
// keeping f32-like precision as the TPU kernel's f32 dots); in f32 they
// run as FMAs on the CUDA cores (32 keys, 64-row steps). wgmma with
// TMA-fed tiles is the next step and changes nothing of this interface.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace mma_bf16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 32;          // keys per block
constexpr int kBQ = 64;          // query rows (one head) per step
// score tile [kBK x kBQ]: thread (kg, rg) = (tid / 16, tid % 16) owns keys
// kg*4 .. kg*4+3 and query rows rg + 16*j
constexpr int kSK = 4;
constexpr int kSQ = kBQ / 16;
// dK/dV: thread (ty, tx) = (tid / 8, tid % 8) owns keys ty*2, ty*2+1 and
// columns tx + 8*c
constexpr int kTK = kBK / 16;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr int smem_floats() {
  // K, V tile; Q, dO rows; p^T and dS^T tiles; LSE and delta per row
  return 2 * kBK * (D + 1) + 2 * kBQ * (D + 1) + 2 * kBK * (kBQ + 1) + 2 * kBQ;
}

// f32, on the CUDA cores (bf16 takes the tensor-core kernel below).
// grid (ceil(S / kBK), Nkv, B), kThreads threads.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_f32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ o, const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const uint8_t* __restrict__ kv_mask,
    float* __restrict__ dk, float* __restrict__ dv, int S, int N, int Nkv, int rep, int causal,
    float sm_scale) {
  constexpr int kTD = D / 8;  // dK/dV columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;                     // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);       // [kBK][D + 1]
  float* Qs = Vs + kBK * (D + 1);       // [kBQ][D + 1]
  float* dOs = Qs + kBQ * (D + 1);      // [kBQ][D + 1]
  float* Pt = dOs + kBQ * (D + 1);      // [kBK][kBQ + 1]
  float* dSt = Pt + kBK * (kBQ + 1);    // [kBK][kBQ + 1]
  float* lse_s = dSt + kBK * (kBQ + 1);
  float* delta_s = lse_s + kBQ;

  const int k0 = blockIdx.x * kBK;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int kg = tid >> 4;
  const int rg = tid & 15;
  const int ty = tid >> 3;
  const int tx = tid & 7;

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

  // the score tile's keys: ragged edge and key mask
  int kpos[kSK];
  bool key_ok[kSK];
#pragma unroll
  for (int i = 0; i < kSK; ++i) {
    kpos[i] = k0 + kg * kSK + i;
    key_ok[i] = kpos[i] < S && (kv_mask == nullptr || kv_mask[(size_t)b * S + kpos[i]] != 0);
  }

  float dk_acc[kTK][kTD], dv_acc[kTK][kTD];
#pragma unroll
  for (int i = 0; i < kTK; ++i)
#pragma unroll
    for (int c = 0; c < kTD; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // causal: queries before the block's first key see none of its keys
  const int q_begin = causal ? (k0 / kBQ) * kBQ : 0;
  for (int q0 = q_begin; q0 < S; q0 += kBQ) {
    for (int r = 0; r < rep; ++r) {
      const int head = g * rep + r;
      __syncthreads();  // the previous step's Qs, dOs, Pt, dSt are consumed
      // stage this head's query rows, one warp per row; the fused backward
      // takes delta = dO . O here, while dO is at hand
      for (int rho = warp; rho < kBQ; rho += kWarps) {
        const int pos = q0 + rho;
        const bool valid = pos < S;
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
            const size_t ri = ((size_t)b * N + head) * S + pos;
            l = lse[ri];
            dl = delta != nullptr ? delta[ri] : dsum;
          }
          lse_s[rho] = l;
          delta_s[rho] = dl;
        }
      }
      __syncthreads();

      // s^T = K Q^T and dP^T = V dO^T on this thread's keys x rows
      float sacc[kSK][kSQ], pacc[kSK][kSQ];
#pragma unroll
      for (int i = 0; i < kSK; ++i)
#pragma unroll
        for (int j = 0; j < kSQ; ++j) sacc[i][j] = pacc[i][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        float kv[kSK], vv[kSK], qv[kSQ], gv[kSQ];
#pragma unroll
        for (int i = 0; i < kSK; ++i) {
          kv[i] = Ks[(kg * kSK + i) * (D + 1) + d];
          vv[i] = Vs[(kg * kSK + i) * (D + 1) + d];
        }
#pragma unroll
        for (int j = 0; j < kSQ; ++j) {
          qv[j] = Qs[(rg + 16 * j) * (D + 1) + d];
          gv[j] = dOs[(rg + 16 * j) * (D + 1) + d];
        }
#pragma unroll
        for (int i = 0; i < kSK; ++i)
#pragma unroll
          for (int j = 0; j < kSQ; ++j) {
            sacc[i][j] += kv[i] * qv[j];
            pacc[i][j] += vv[i] * gv[j];
          }
      }

      // p and dS = p (dP - delta) sm_scale; invisible pairs have p = 0
#pragma unroll
      for (int j = 0; j < kSQ; ++j) {
        const int row = rg + 16 * j;
        const int qp = q0 + row;
        const float l = lse_s[row];
        const float dl = delta_s[row];
#pragma unroll
        for (int i = 0; i < kSK; ++i) {
          float p = 0.f;
          if (key_ok[i] && qp < S && !(causal && kpos[i] > qp))
            p = expf(sacc[i][j] * sm_scale - l);
          Pt[(kg * kSK + i) * (kBQ + 1) + row] = p;
          dSt[(kg * kSK + i) * (kBQ + 1) + row] = p * (pacc[i][j] - dl) * sm_scale;
        }
      }
      __syncthreads();

      // dV += p^T dO, dK += dS^T Q
      for (int t = 0; t < kBQ; ++t) {
        float pv[kTK], sv[kTK], gg[kTD], qq[kTD];
#pragma unroll
        for (int i = 0; i < kTK; ++i) {
          pv[i] = Pt[(ty * kTK + i) * (kBQ + 1) + t];
          sv[i] = dSt[(ty * kTK + i) * (kBQ + 1) + t];
        }
#pragma unroll
        for (int c = 0; c < kTD; ++c) {
          gg[c] = dOs[t * (D + 1) + tx + 8 * c];
          qq[c] = Qs[t * (D + 1) + tx + 8 * c];
        }
#pragma unroll
        for (int i = 0; i < kTK; ++i)
#pragma unroll
          for (int c = 0; c < kTD; ++c) {
            dv_acc[i][c] += pv[i] * gg[c];
            dk_acc[i][c] += sv[i] * qq[c];
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kTK; ++i) {
    const int pos = k0 + ty * kTK + i;
    if (pos >= S) continue;
    const size_t off = (((size_t)b * S + pos) * Nkv + g) * D;
#pragma unroll
    for (int c = 0; c < kTD; ++c) {
      dk[off + tx + 8 * c] = dk_acc[i][c];
      dv[off + tx + 8 * c] = dv_acc[i][c];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the four products on the tensor cores (mma.sync m16n8k16, f32
// accumulators). A block holds 64 keys, 16 per warp; a query step is BQ
// rows of one head (64 at D=64, 32 at D=128, to keep dK and dV in
// registers). p and dS enter their products as a pair of bf16 values
// (hi + lo), keeping ~2^-16 of their f32 precision, as the TPU kernel's
// f32 dots.
// ---------------------------------------------------------------------------

constexpr int kMBK = 64;  // keys per block

template <int D>
__host__ __device__ constexpr int mma_bq() { return D == 64 ? 64 : 32; }

template <int D>
constexpr size_t mma_smem_bytes() {
  // K, V tile; Q, dO rows by row and by column; LSE and delta
  constexpr int BQ = mma_bq<D>();
  return (2 * kMBK * (D + 8) + 2 * BQ * (D + 8) + 2 * D * (BQ + 8)) * sizeof(bf16) +
         2 * BQ * sizeof(float);
}

// grid (ceil(S / 64), Nkv, B), kThreads threads. Thread (warp, gid = lane /
// 4, tig = lane % 4) holds keys 16 warp + gid and + 8 of every accumulator
// tile.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const uint8_t* __restrict__ kv_mask,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int N, int Nkv, int rep, int causal,
    float sm_scale) {
  constexpr int BQ = mma_bq<D>();
  constexpr int LD = D + 8;   // padded rows: fragment loads hit 32 banks
  constexpr int LT = BQ + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [kMBK][LD]
  bf16* Vs = Ks + kMBK * LD;                     // [kMBK][LD]
  bf16* Qs = Vs + kMBK * LD;                     // [BQ][LD]
  bf16* dOs = Qs + BQ * LD;                      // [BQ][LD]
  bf16* Qt = dOs + BQ * LD;                      // [D][LT]
  bf16* dOt = Qt + D * LT;                       // [D][LT]
  float* lse_s = reinterpret_cast<float*>(dOt + D * LT);
  float* delta_s = lse_s + BQ;

  const int k0 = blockIdx.x * kMBK;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;

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
  }

  int kpos[2];
  bool key_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    kpos[i] = k0 + warp * 16 + gid + 8 * i;
    key_ok[i] = kpos[i] < S && (kv_mask == nullptr || kv_mask[(size_t)b * S + kpos[i]] != 0);
  }
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  // causal: query tiles before the block's first key see none of its keys
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_begin; q0 < S; q0 += BQ) {
    for (int r = 0; r < rep; ++r) {
      const int head = g * rep + r;
      __syncthreads();  // the previous step's rows are consumed
      // stage this head's rows by row and by column, 16 bytes a load; the
      // D / 8 adjacent threads of a row sum its fused delta = dO . O
      for (int e = tid; e < BQ * (D / 8); e += kThreads) {
        const int rho = e / (D / 8);
        const int c = (e - rho * (D / 8)) * 8;
        const int pos = q0 + rho;
        const bool valid = pos < S;
        const size_t off = (((size_t)b * S + pos) * N + head) * D + c;
        uint4 qq = make_uint4(0, 0, 0, 0), gg = qq;
        float dsum = 0.f;
        if (valid) {
          qq = *reinterpret_cast<const uint4*>(q + off);
          gg = *reinterpret_cast<const uint4*>(dout + off);
          if (delta == nullptr) {
            const uint4 oo = *reinterpret_cast<const uint4*>(o + off);
            const bf16* g8 = reinterpret_cast<const bf16*>(&gg);
            const bf16* o8 = reinterpret_cast<const bf16*>(&oo);
#pragma unroll
            for (int j = 0; j < 8; ++j) dsum += __bfloat162float(g8[j]) * __bfloat162float(o8[j]);
          }
        }
#pragma unroll
        for (int sh = 1; sh < D / 8; sh <<= 1) dsum += __shfl_xor_sync(0xffffffffu, dsum, sh);
        *reinterpret_cast<uint4*>(Qs + rho * LD + c) = qq;
        *reinterpret_cast<uint4*>(dOs + rho * LD + c) = gg;
        const bf16* q8 = reinterpret_cast<const bf16*>(&qq);
        const bf16* g8 = reinterpret_cast<const bf16*>(&gg);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          Qt[(c + j) * LT + rho] = q8[j];
          dOt[(c + j) * LT + rho] = g8[j];
        }
        if (c == 0) {
          float l = 0.f, dl = 0.f;
          if (valid) {
            const size_t ri = ((size_t)b * N + head) * S + pos;
            l = lse[ri];
            dl = delta != nullptr ? delta[ri] : dsum;
          }
          lse_s[rho] = l;
          delta_s[rho] = dl;
        }
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T on this warp's 16 keys x BQ rows
      float st[BQ / 8][4], pt[BQ / 8][4];
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = pt[n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D; kc += 16) {
        uint32_t ka[4], va[4];
        load_a(ka, Ks + warp * 16 * LD, LD, gid, tig, kc);
        load_a(va, Vs + warp * 16 * LD, LD, gid, tig, kc);
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
          mma_b(st[n], ka, Qs, LD, n * 8, gid, tig, kc);
          mma_b(pt[n], va, dOs, LD, n * 8, gid, tig, kc);
        }
      }

      // p^T in place of S^T, dS^T in place of dP^T; invisible pairs give 0
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int row = n * 8 + 2 * tig + (e & 1);
          const int qp = q0 + row;
          const bool ok = key_ok[i] && qp < S && !(causal && kpos[i] > qp);
          const float p = ok ? expf(st[n][e] * sm_scale - lse_s[row]) : 0.f;
          st[n][e] = p;
          pt[n][e] = p * (pt[n][e] - delta_s[row]) * sm_scale;
        }
      }

      // dV += p^T dO and dK += dS^T Q over this step's rows (k = row)
#pragma unroll
      for (int j = 0; j < BQ / 16; ++j) {
        uint32_t ph[4], pl[4], sh[4], sl[4];
        split_a(st, j, ph, pl);
        split_a(pt, j, sh, sl);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const bf16* gb = dOt + (n * 8 + gid) * LT + j * 16 + 2 * tig;
          const bf16* qb = Qt + (n * 8 + gid) * LT + j * 16 + 2 * tig;
          const uint32_t g0 = ld32(gb), g1 = ld32(gb + 8);
          const uint32_t q0b = ld32(qb), q1b = ld32(qb + 8);
          mma16816(dv_acc[n], ph, g0, g1);
          mma16816(dv_acc[n], pl, g0, g1);
          mma16816(dk_acc[n], sh, q0b, q1b);
          mma16816(dk_acc[n], sl, q0b, q1b);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kpos[i] >= S) continue;
    const size_t off = (((size_t)b * S + kpos[i]) * Nkv + g) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + 2 * tig;
      *reinterpret_cast<uint32_t*>(dk + off + c) = pack(dk_acc[n][2 * i], dk_acc[n][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + c) = pack(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

// dtype 0: the f32 CUDA-core kernel; 1: the bf16 tensor-core kernel
template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, const float* delta, const uint8_t* kv_mask,
           void* dk, void* dv, int B, int S, int N, int Nkv, int causal, float sm_scale,
           cudaStream_t stream) {
  if (dtype == 1) {
    const size_t smem = mma_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_mma<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((S + kMBK - 1) / kMBK, Nkv, B);
    flash_bwd_dkv_mma<D><<<grid, kThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, delta, kv_mask,
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, N, Nkv, N / Nkv, causal, sm_scale);
  } else {
    const size_t smem = smem_floats<D>() * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_f32<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((S + kBK - 1) / kBK, Nkv, B);
    flash_bwd_dkv_f32<D><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(o), static_cast<const float*>(dout), lse, delta, kv_mask,
        static_cast<float*>(dk), static_cast<float*>(dv), S, N, Nkv, N / Nkv, causal, sm_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse: [B, N, S] f32 from the forward.
// delta: null (fused: computed here from o) or [B, N, S] f32. kv_mask: null
// or [B, S] uint8 (nonzero = key visible). Returns a cudaError_t value
// (0 = launched).
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const void* lse, const void* delta,
                             const void* kv_mask, void* dk, void* dv, int B, int S, int N,
                             int Nkv, int D, int dtype, int causal, float sm_scale,
                             void* stream) {
  if (B < 1 || S < 1 || Nkv < 1 || N % Nkv != 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  const uint8_t* mask = static_cast<const uint8_t*>(kv_mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(dtype, q, k, v, o, dout, lse_f, delta_f, mask, dk, dv, B, S, N, Nkv,
                      causal, sm_scale, st);
  if (D == 128)
    return launch<128>(dtype, q, k, v, o, dout, lse_f, delta_f, mask, dk, dv, B, S, N, Nkv,
                       causal, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
