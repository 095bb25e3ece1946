// Block-sparse attention backward, dK and dV, for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/sparse_attention.py, `_sp_bwd_dkv_kernel`
// (:357), launched by `_sp_bwd` (pallas_call at :507). Its partner for dQ
// is sparse_bwd_dq.cu (B6); the two together are the TPU module's
// backward, with no atomics (deterministic gradients).
//
// Computes, for batch b, head h and key position j of key block ki, over
// the query blocks that list ki: the TRANSPOSED adjacency cidx[ki, 0 ..
// ccnt[ki]) (entries past ccnt are -1 and are never read), and in them the
// query positions i that see j (i >= j when causal):
//   p_ij  = exp(sm_scale * q_i . k_j - LSE_i)
//   dS_ij = p_ij * (dO_i . v_j - delta_i) * sm_scale
//   dV_j  = sum_i p_ij dO_i,     dK_j = sum_i dS_ij q_i
// with delta_i = dO_i . O_i from the caller ([B, N, S] f32). Layout
// [B, S, N, D] for Q, K, V, dO, dK and dV (K/V repeated over the
// query-head group: the model sums dK/dV over the group through autograd
// of the repeat); LSE and delta [B, N, S] f32. dK and dV are written once,
// in the input dtype, from f32 accumulators.
//
// What bounds it on an H100: four products of 2 * D flops per visible
// (query, key) pair (K Q^T, V dO^T, p^T dO, dS^T Q) against the unique
// bytes (Q, K, V, dO, LSE, delta read once, dK, dV written once).
//
// What the design does about it: one block per (key tile, head, batch)
// keeps its K and V tile in shared memory and dK, dV in f32 registers, and
// walks the key block's column list, staging each listed query block's Q,
// dO, LSE and delta in row steps; steps wholly before the causal diagonal
// are skipped. The load is uneven by design of the layouts: a global
// column (BigBird's block 0) is listed by every query block, so its blocks
// walk S / block query blocks where the rest walk a few. The grid puts the key
// tile outermost, so the low key blocks, which a causal layout lists most,
// start first and the long ones do not trail the launch. In bf16 the four
// products run on the tensor cores (mma.sync m16n8k16, f32 accumulators;
// 64 keys per block, 16 per warp; row steps of 64 at D=64 and 32 at D=128
// so dK and dV stay in registers; p and dS enter their products as bf16
// hi + lo pairs, keeping f32-like precision as the TPU kernel's f32 dots);
// in f32 they run as FMAs on the CUDA cores (32 keys, 64-row steps).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace mma_bf16;

constexpr int kThreads = 128;
constexpr int kBK = 32;          // keys per block
constexpr int kBQ = 64;          // query rows per step
// score tile [kBK x kBQ]: thread (kg, rg) = (tid / 16, tid % 16) owns keys
// kg*4 .. kg*4+3 and query rows rg + 16*j
constexpr int kSK = 4;
constexpr int kSQ = kBQ / 16;
// dK/dV: thread (ty, tx) = (tid / 8, tid % 8) owns keys ty*2, ty*2+1 and
// columns tx + 8*c
constexpr int kTK = kBK / 16;

template <int D>
constexpr int smem_floats() {
  // K, V tile; Q, dO rows; p^T and dS^T tiles; LSE and delta per row
  return 2 * kBK * (D + 1) + 2 * kBQ * (D + 1) + 2 * kBK * (kBQ + 1) + 2 * kBQ;
}

// f32, on the CUDA cores (bf16 takes the tensor-core kernel below).
// grid (N, B, S / kBK), kThreads threads.
template <int D>
__global__ void __launch_bounds__(kThreads) sparse_bwd_dkv_f32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ cidx, const int* __restrict__ ccnt,
    float* __restrict__ dk, float* __restrict__ dv, int S, int N, int block, int ldc,
    int causal, float sm_scale) {
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

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kBK;
  const int tid = threadIdx.x;
  const int kg = tid >> 4;
  const int rg = tid & 15;
  const int ty = tid >> 3;
  const int tx = tid & 7;
  const int ki = k0 / block;
  const int n_list = ccnt[ki];
  const int* list = cidx + (size_t)ki * ldc;

  for (int e = tid; e < kBK * D; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    const size_t off = (((size_t)b * S + k0 + r) * N + h) * D + d;
    Ks[r * (D + 1) + d] = k[off];
    Vs[r * (D + 1) + d] = v[off];
  }

  int kpos[kSK];
#pragma unroll
  for (int i = 0; i < kSK; ++i) kpos[i] = k0 + kg * kSK + i;

  float dk_acc[kTK][kTD], dv_acc[kTK][kTD];
#pragma unroll
  for (int i = 0; i < kTK; ++i)
#pragma unroll
    for (int c = 0; c < kTD; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int t = 0; t < n_list; ++t) {
    const int qb = list[t];
    for (int q0 = qb * block; q0 < (qb + 1) * block; q0 += kBQ) {
      if (causal && q0 + kBQ - 1 < k0) continue;  // rows before every key
      __syncthreads();  // the previous step's Qs, dOs, Pt, dSt are consumed
      for (int e = tid; e < kBQ * D; e += kThreads) {
        const int rho = e / D;
        const int d = e - rho * D;
        const size_t off = (((size_t)b * S + q0 + rho) * N + h) * D + d;
        Qs[rho * (D + 1) + d] = q[off];
        dOs[rho * (D + 1) + d] = dout[off];
      }
      for (int rho = tid; rho < kBQ; rho += kThreads) {
        const size_t ri = ((size_t)b * N + h) * S + q0 + rho;
        lse_s[rho] = lse[ri];
        delta_s[rho] = delta[ri];
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

      // p and dS = p (dP - delta) sm_scale; rows before the key (causal)
      // have p = 0
#pragma unroll
      for (int j = 0; j < kSQ; ++j) {
        const int row = rg + 16 * j;
        const int qp = q0 + row;
        const float l = lse_s[row];
        const float dl = delta_s[row];
#pragma unroll
        for (int i = 0; i < kSK; ++i) {
          float p = 0.f;
          if (!(causal && kpos[i] > qp)) p = expf(sacc[i][j] * sm_scale - l);
          Pt[(kg * kSK + i) * (kBQ + 1) + row] = p;
          dSt[(kg * kSK + i) * (kBQ + 1) + row] = p * (pacc[i][j] - dl) * sm_scale;
        }
      }
      __syncthreads();

      // dV += p^T dO, dK += dS^T Q
      for (int r = 0; r < kBQ; ++r) {
        float pv[kTK], sv[kTK], gg[kTD], qq[kTD];
#pragma unroll
        for (int i = 0; i < kTK; ++i) {
          pv[i] = Pt[(ty * kTK + i) * (kBQ + 1) + r];
          sv[i] = dSt[(ty * kTK + i) * (kBQ + 1) + r];
        }
#pragma unroll
        for (int c = 0; c < kTD; ++c) {
          gg[c] = dOs[r * (D + 1) + tx + 8 * c];
          qq[c] = Qs[r * (D + 1) + tx + 8 * c];
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
    const size_t off = (((size_t)b * S + k0 + ty * kTK + i) * N + h) * D;
#pragma unroll
    for (int c = 0; c < kTD; ++c) {
      dk[off + tx + 8 * c] = dk_acc[i][c];
      dv[off + tx + 8 * c] = dv_acc[i][c];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: the four products on the tensor cores (mma.sync m16n8k16, f32
// accumulators). A block holds 64 keys, 16 per warp; a row step is BQ rows
// (64 at D=64, 32 at D=128, to keep dK and dV in registers).
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

// grid (N, B, S / 64), kThreads threads. Thread (warp, gid = lane / 4, tig
// = lane % 4) holds keys 16 warp + gid and + 8 of every accumulator tile.
template <int D>
__global__ void __launch_bounds__(kThreads) sparse_bwd_dkv_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ cidx, const int* __restrict__ ccnt, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int S, int N, int block, int ldc, int causal, float sm_scale) {
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

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kMBK;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int ki = k0 / block;
  const int n_list = ccnt[ki];
  const int* list = cidx + (size_t)ki * ldc;

  for (int e = tid; e < kMBK * (D / 8); e += kThreads) {
    const int r = e / (D / 8);
    const int c = (e - r * (D / 8)) * 8;
    const size_t off = (((size_t)b * S + k0 + r) * N + h) * D + c;
    *reinterpret_cast<uint4*>(Ks + r * LD + c) = *reinterpret_cast<const uint4*>(k + off);
    *reinterpret_cast<uint4*>(Vs + r * LD + c) = *reinterpret_cast<const uint4*>(v + off);
  }

  int kpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) kpos[i] = k0 + warp * 16 + gid + 8 * i;
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int t = 0; t < n_list; ++t) {
    const int qb = list[t];
    for (int q0 = qb * block; q0 < (qb + 1) * block; q0 += BQ) {
      if (causal && q0 + BQ - 1 < k0) continue;  // rows before every key
      __syncthreads();  // the previous step's rows are consumed
      // stage the step's rows by row and by column, 16 bytes a load
      for (int e = tid; e < BQ * (D / 8); e += kThreads) {
        const int rho = e / (D / 8);
        const int c = (e - rho * (D / 8)) * 8;
        const size_t off = (((size_t)b * S + q0 + rho) * N + h) * D + c;
        const uint4 qq = *reinterpret_cast<const uint4*>(q + off);
        const uint4 gg = *reinterpret_cast<const uint4*>(dout + off);
        *reinterpret_cast<uint4*>(Qs + rho * LD + c) = qq;
        *reinterpret_cast<uint4*>(dOs + rho * LD + c) = gg;
        const bf16* q8 = reinterpret_cast<const bf16*>(&qq);
        const bf16* g8 = reinterpret_cast<const bf16*>(&gg);
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          Qt[(c + x) * LT + rho] = q8[x];
          dOt[(c + x) * LT + rho] = g8[x];
        }
      }
      for (int rho = tid; rho < BQ; rho += kThreads) {
        const size_t ri = ((size_t)b * N + h) * S + q0 + rho;
        lse_s[rho] = lse[ri];
        delta_s[rho] = delta[ri];
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

      // p^T in place of S^T, dS^T in place of dP^T; rows before the key
      // (causal) give 0
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int row = n * 8 + 2 * tig + (e & 1);
          const float p = (causal && kpos[i] > q0 + row)
                              ? 0.f
                              : expf(st[n][e] * sm_scale - lse_s[row]);
          st[n][e] = p;
          pt[n][e] = p * (pt[n][e] - delta_s[row]) * sm_scale;
        }
      }

      // dV += p^T dO and dK += dS^T Q over this step's rows (k = row)
#pragma unroll
      for (int x = 0; x < BQ / 16; ++x) {
        uint32_t ph[4], pl[4], sh[4], sl[4];
        split_a(st, x, ph, pl);
        split_a(pt, x, sh, sl);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const bf16* gb = dOt + (n * 8 + gid) * LT + x * 16 + 2 * tig;
          const bf16* qb_ = Qt + (n * 8 + gid) * LT + x * 16 + 2 * tig;
          const uint32_t g0 = ld32(gb), g1 = ld32(gb + 8);
          const uint32_t q0b = ld32(qb_), q1b = ld32(qb_ + 8);
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
    const size_t off = (((size_t)b * S + kpos[i]) * N + h) * D;
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
int launch(int dtype, const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, const int* cidx, const int* ccnt, void* dk,
           void* dv, int B, int S, int N, int block, int ldc, int causal, float sm_scale,
           cudaStream_t stream) {
  if (dtype == 1) {
    const size_t smem = mma_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(sparse_bwd_dkv_mma<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(N, B, S / kMBK);
    sparse_bwd_dkv_mma<D><<<grid, kThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lse, delta, cidx, ccnt, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), S, N, block, ldc, causal, sm_scale);
  } else {
    const size_t smem = smem_floats<D>() * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(sparse_bwd_dkv_f32<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid(N, B, S / kBK);
    sparse_bwd_dkv_f32<D><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), lse, delta, cidx, ccnt, static_cast<float*>(dk),
        static_cast<float*>(dv), S, N, block, ldc, causal, sm_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse: [B, N, S] f32 from the forward;
// delta: [B, N, S] f32 = rowsum(dO * O). cidx / ccnt: the transposed
// adjacency ([S / block, ldc] query blocks listing each key block, -1 past
// ccnt; [S / block] int32). Returns a cudaError_t value (0 = launched).
extern "C" int sparse_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, const void* cidx,
                              const void* ccnt, void* dk, void* dv, int B, int S, int N, int D,
                              int block, int ldc, int dtype, int causal, float sm_scale,
                              void* stream) {
  if (B < 1 || S < 1 || N < 1 || (block != 64 && block != 128) || S % block != 0 || ldc < 1 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  const int* cidx_i = static_cast<const int*>(cidx);
  const int* ccnt_i = static_cast<const int*>(ccnt);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(dtype, q, k, v, dout, lse_f, delta_f, cidx_i, ccnt_i, dk, dv, B, S, N,
                      block, ldc, causal, sm_scale, st);
  if (D == 128)
    return launch<128>(dtype, q, k, v, dout, lse_f, delta_f, cidx_i, ccnt_i, dk, dv, B, S, N,
                       block, ldc, causal, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
