// Block-sparse attention forward for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/sparse_attention.py, `_sp_fwd_kernel` (:229),
// launched by `_sp_fwd` (pallas_call at :463).
//
// Computes attention restricted to a block layout: query block qi attends
// only to the key blocks idx[qi, 0 .. cnt[qi]) (the adjacency list built on
// the host from the layout; entries past cnt are -1 and are never read).
// For batch b, head h and query position i of block qi,
//   O[b, i, h]   = sum_j p_ij V[b, j, h] / sum_j p_ij,   p_ij = exp(s_ij - m_i)
//   LSE[b, h, i] = m_i + log(sum_j p_ij)
// over the keys j of the listed blocks (j <= i when causal: inside the
// diagonal block the mask is by absolute position), s_ij = sm_scale q_i . k_j
// in f32. The running max is floored at M_FLOOR, and a row with an empty
// list outputs 0 with LSE -1e30, exactly as the TPU kernel. Layout
// [B, S, N, D] for Q, K, V and O (K/V already repeated over the query-head
// group: one kv head per query head); LSE is [B, N, S] f32.
//
// What bounds it on an H100: at a BigBird layout (a few listed blocks per
// row) it does 4 * D flops per visible (query, key) pair and reads each Q,
// O row once but each K/V block once per query block that lists it, so
// for D = 64 bytes and operations are of the same order; the bound that
// chip_smoke reports counts unique bytes (Q, K, V, O, LSE once).
//
// What the design does about it: one block per (64-row query tile, head,
// batch) keeps its query rows in shared memory and the softmax state (m,
// l, the O accumulator) in f32 registers, and walks only its row's list,
// staging each listed key block in 64-key (bf16) or 32-key (f32) tiles;
// tiles wholly above the causal diagonal are skipped. Work is therefore
// proportional to the row's true degree, as the TPU kernel's manual DMA
// loop makes it. In bf16 both products run on the tensor cores (mma.sync
// m16n8k16, f32 accumulators, 16 rows per warp; p enters p V as a bf16 hi
// + lo pair, keeping f32-like precision as the TPU kernel's f32 dots); in
// f32 they run as FMAs on the CUDA cores. Staging is synchronous: cp.async
// double buffering (the counterpart of the TPU kernel's 2-slot DMA) is the
// next step and changes nothing of this interface.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace mma_bf16;

constexpr float kNegInf = -1e30f;
constexpr float kMFloor = -1e20f;
constexpr int kThreads = 128;    // 16 row groups x 8 column groups
constexpr int kRows = 64;        // query rows per block (a tile of a query block)
constexpr int kBK = 32;          // keys per K/V tile
constexpr int kTM = kRows / 16;  // rows per thread
constexpr int kTN = kBK / 8;     // score columns per thread

template <int D>
constexpr int smem_floats() {
  return kRows * (D + 1) + kBK * (D + 1) + kBK * D + kRows * (kBK + 1);
}

// f32, on the CUDA cores (bf16 takes the tensor-core kernel below).
// grid (N, B, S / kRows), kThreads threads. Thread (ty, tx) owns rows
// ty*kTM .. ty*kTM+kTM-1, score columns tx + 8*j, and O columns tx + 8*c.
template <int D>
__global__ void __launch_bounds__(kThreads) sparse_fwd_f32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ idx, const int* __restrict__ cnt, float* __restrict__ o,
    float* __restrict__ lse, int S, int N, int block, int ldi, int causal, float sm_scale) {
  constexpr int kTD = D / 8;  // O columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                    // [kRows][D + 1]
  float* Ks = Qs + kRows * (D + 1);    // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);      // [kBK][D]
  float* Ps = Vs + kBK * D;            // [kRows][kBK + 1]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = blockIdx.z * kRows;
  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;
  const int qi = q0 / block;
  const int n_list = cnt[qi];
  const int* list = idx + (size_t)qi * ldi;

  // stage the tile's query rows, pre-scaled (S is a multiple of the block,
  // the block of kRows: every row exists)
  for (int e = tid; e < kRows * D; e += kThreads) {
    const int rho = e / D;
    const int d = e - rho * D;
    Qs[rho * (D + 1) + d] = q[(((size_t)b * S + q0 + rho) * N + h) * D + d] * sm_scale;
  }

  int qpos[kTM];
  float m[kTM], l[kTM], acc[kTM][kTD];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    qpos[i] = q0 + ty * kTM + i;
    m[i] = kNegInf;
    l[i] = 0.f;
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
        Vs[r * D + d] = v[off];
      }
      __syncthreads();

      float sacc[kTM][kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int c = 0; c < kTN; ++c) sacc[i][c] = 0.f;
      for (int d = 0; d < D; ++d) {
        float qv[kTM], kv[kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i) qv[i] = Qs[(ty * kTM + i) * (D + 1) + d];
#pragma unroll
        for (int c = 0; c < kTN; ++c) kv[c] = Ks[(tx + 8 * c) * (D + 1) + d];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int c = 0; c < kTN; ++c) sacc[i][c] += qv[i] * kv[c];
      }

      if (causal) {
#pragma unroll
        for (int c = 0; c < kTN; ++c) {
          const int kpos = k0 + tx + 8 * c;
#pragma unroll
          for (int i = 0; i < kTM; ++i)
            if (kpos > qpos[i]) sacc[i][c] = kNegInf;
        }
      }

      // online softmax: a row's 8 column groups are 8 adjacent lanes
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        float mx = sacc[i][0];
#pragma unroll
        for (int c = 1; c < kTN; ++c) mx = fmaxf(mx, sacc[i][c]);
#pragma unroll
        for (int off = 1; off < 8; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(fmaxf(m[i], mx), kMFloor);
        const float alpha = expf(m[i] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < kTN; ++c) {
          const float p = expf(sacc[i][c] - m_new);
          Ps[(ty * kTM + i) * (kBK + 1) + tx + 8 * c] = p;
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

      for (int r = 0; r < kBK; ++r) {
        float pv[kTM], vv[kTD];
#pragma unroll
        for (int i = 0; i < kTM; ++i) pv[i] = Ps[(ty * kTM + i) * (kBK + 1) + r];
#pragma unroll
        for (int c = 0; c < kTD; ++c) vv[c] = Vs[r * D + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int c = 0; c < kTD; ++c) acc[i][c] += pv[i] * vv[c];
      }
      __syncthreads();  // Ks, Vs and Ps are rewritten by the next tile
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    const float inv = 1.f / l_safe;
    float* orow = o + (((size_t)b * S + qpos[i]) * N + h) * D;
#pragma unroll
    for (int c = 0; c < kTD; ++c) orow[tx + 8 * c] = acc[i][c] * inv;
    if (tx == 0) lse[((size_t)b * N + h) * S + qpos[i]] = m[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// bf16: both products on the tensor cores (mma.sync m16n8k16, f32
// accumulators). Warp w owns tile rows 16w..16w+15; a K/V tile is 64 keys.
// ---------------------------------------------------------------------------

constexpr int kMBK = 64;  // keys per K/V tile

template <int D>
constexpr size_t mma_smem_bytes() {
  // Q rows, K tile by key, V tile by column
  return (kRows * (D + 8) + kMBK * (D + 8) + D * (kMBK + 8)) * sizeof(bf16);
}

// grid (N, B, S / kRows), kThreads threads. Thread (warp, gid = lane / 4,
// tig = lane % 4) holds rows 16 warp + gid and + 8 of every 16 x 8
// accumulator tile; the 4 threads of a quad share those rows.
template <int D>
__global__ void __launch_bounds__(kThreads) sparse_fwd_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ idx, const int* __restrict__ cnt, bf16* __restrict__ o,
    float* __restrict__ lse, int S, int N, int block, int ldi, int causal, float sm_scale) {
  constexpr int LD = D + 8;     // padded rows: fragment loads hit 32 banks
  constexpr int LT = kMBK + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kRows][LD]
  bf16* Ks = Qs + kRows * LD;                    // [kMBK][LD]
  bf16* Vt = Ks + kMBK * LD;                     // [D][LT]

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
    *reinterpret_cast<uint4*>(Qs + rho * LD + c) =
        *reinterpret_cast<const uint4*>(q + (((size_t)b * S + q0 + rho) * N + h) * D + c);
  }

  int qpos[2];
  float m[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qpos[i] = q0 + warp * 16 + gid + 8 * i;
    m[i] = kNegInf;
    l[i] = 0.f;
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
      for (int e = tid; e < kMBK * (D / 8); e += kThreads) {
        const int r = e / (D / 8);
        const int c = (e - r * (D / 8)) * 8;
        const size_t off = (((size_t)b * S + k0 + r) * N + h) * D + c;
        *reinterpret_cast<uint4*>(Ks + r * LD + c) = *reinterpret_cast<const uint4*>(k + off);
        const uint4 vv = *reinterpret_cast<const uint4*>(v + off);
        const bf16* v8 = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
        for (int x = 0; x < 8; ++x) Vt[(c + x) * LT + r] = v8[x];
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

      // scale; mask by absolute position inside the diagonal block
#pragma unroll
      for (int n = 0; n < kMBK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + n * 8 + 2 * tig + (e & 1);
          sacc[n][e] = (causal && kpos > qpos[e >> 1]) ? kNegInf : sacc[n][e] * sm_scale;
        }
      }

      // online softmax over each row's 64 scores, held by the 4 threads of
      // a quad; p replaces the scores
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

      // O += p V; the score tiles of keys 16x..16x+15 are the A fragment of
      // that k step
#pragma unroll
      for (int x = 0; x < kMBK / 16; ++x) {
        uint32_t hi[4], lo[4];
        split_a(sacc, x, hi, lo);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const bf16* vb = Vt + (n * 8 + gid) * LT + x * 16 + 2 * tig;
          const uint32_t b0 = ld32(vb), b1 = ld32(vb + 8);
          mma16816(acc[n], hi, b0, b1);
          mma16816(acc[n], lo, b0, b1);
        }
      }
      __syncthreads();  // Ks and Vt are rewritten by the next tile
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    const float inv = 1.f / l_safe;
    bf16* orow = o + (((size_t)b * S + qpos[i]) * N + h) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * tig) =
          pack(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    if (tig == 0) lse[((size_t)b * N + h) * S + qpos[i]] = m[i] + logf(l_safe);
  }
}

// dtype 0: the f32 CUDA-core kernel; 1: the bf16 tensor-core kernel
template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, const int* idx, const int* cnt,
           void* o, float* lse, int B, int S, int N, int block, int ldi, int causal,
           float sm_scale, cudaStream_t stream) {
  dim3 grid(N, B, S / kRows);
  if (dtype == 1) {
    const size_t smem = mma_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(sparse_fwd_mma<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    sparse_fwd_mma<D><<<grid, kThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        idx, cnt, static_cast<bf16*>(o), lse, S, N, block, ldi, causal, sm_scale);
  } else {
    const size_t smem = smem_floats<D>() * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(sparse_fwd_f32<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    sparse_fwd_f32<D><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        idx, cnt, static_cast<float*>(o), lse, S, N, block, ldi, causal, sm_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. idx: [S / block, ldi] int32 listed key
// blocks of each query block (-1 past cnt); cnt: [S / block] int32. block
// is 64 or 128 and divides S. Returns a cudaError_t value (0 = launched).
extern "C" int sparse_fwd(const void* q, const void* k, const void* v, const void* idx,
                          const void* cnt, void* o, void* lse, int B, int S, int N, int D,
                          int block, int ldi, int dtype, int causal, float sm_scale,
                          void* stream) {
  if (B < 1 || S < 1 || N < 1 || (block != 64 && block != 128) || S % block != 0 || ldi < 1 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* idx_i = static_cast<const int*>(idx);
  const int* cnt_i = static_cast<const int*>(cnt);
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(dtype, q, k, v, idx_i, cnt_i, o, lse_f, B, S, N, block, ldi, causal,
                      sm_scale, st);
  if (D == 128)
    return launch<128>(dtype, q, k, v, idx_i, cnt_i, o, lse_f, B, S, N, block, ldi, causal,
                       sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
