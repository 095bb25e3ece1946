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
// of tensor-core time. dS enters dS K as a bf16 hi + lo pair (f32-like
// precision, as the TPU kernel's f32 dot), so the tensor cores do 4
// products, not 3.
//
// What the design does about it (bf16; helpers in sm90.cuh). One block
// per (query tile, kv head, batch) holds 128 query rows, the whole
// query-head group of BQ = 128 / rep positions (32 at rep 4), rows
// stacked by position then head (row = (pos - q0) * rep + head - g * rep,
// so one TMA box of (D, rep, BQ) loads them), with their Q and dO resident
// in shared memory: each K/V tile is staged once for 128 rows of products.
// 288 threads: two consumer warpgroups of 64 rows and one producer warp.
// The producer streams the K/V tiles up to the causal diagonal through a
// 3-stage ring (TMA, completion on an mbarrier; zeros past S), with the
// tile's 64 key-mask bytes and a "tile has a masked key" flag written by
// its lanes; each consumer warpgroup runs on wgmma (m64nNk16, f32
// accumulators):
//   S = Q K^T, dP = dO V^T   A = Q, dO (resident, K-major), B = the K, V
//                            tile [keys][D] (K-major);
//   dQ += dS K               A = dS from registers as bf16 hi + lo (the
//                            accumulators of step 1 are the A fragments),
//                            B = the same K tile read MN-major (the
//                            descriptor's transpose): no transposed copy,
// and frees the stage on a second mbarrier. dQ stays in f32 registers
// (32 a thread at D=64, 64 at D=128; 161-167 registers, no spills) and is
// written once. delta (fused) and LSE are read once per row. The causal
// mask applies only to tiles that reach past the tile's first position,
// the key mask only to tiles whose flag is set; rows past S carry LSE =
// +inf (p = 0). Grid (Nkv * B, query tiles) with the query tile slowest,
// last tile first: under the causal mask the longest walks start first.
//
// What bounds it now: the CUDA-core work of each tile (exp, dS, the hi/lo
// split: ~10 instructions per score) as much as the tensor cores: with
// the exp and dS cut out, a development build on the H100 ran in well
// under half the time. So the two consumer warpgroups take turns to issue
// their wgmma batches (sm90.cuh, pingpong_*): one computes while the
// other's products run (without the turns both waited on the tensor cores
// together, then computed together). The f32 path (only the f32
// cross-checks use it) runs as FMAs on the CUDA cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "sm90.cuh"

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
// bf16: wgmma on TMA-fed tiles (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int kStages = 3;
constexpr int kBlockRows = 128;           // two consumer warpgroups of 64 rows
constexpr int kKeys = 64;                 // keys per K/V tile
constexpr int kWgThreads = 288;           // 2 consumer warpgroups + producer warp
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Dq {
  static constexpr int P = D / 64;                  // 64-column panels
  static constexpr int kPanelQ = kBlockRows * 128;  // bytes of a Q/dO panel
  static constexpr int kPanelK = kKeys * 128;       // bytes of a K/V panel
  static constexpr int kQ = P * kPanelQ;            // the Q (or dO) rows
  static constexpr int kKV = P * kPanelK;           // one K (or V) tile
  static constexpr int kOffStage = 2 * kQ;
  static constexpr int kOffMask = kOffStage + kStages * 2 * kKV;  // [stage][64] bytes
  static constexpr int kOffFlag = kOffMask + kStages * kKeys;     // [stage] int
  static constexpr int kOffDelta = kOffFlag + kStages * 4;        // [128] f32
  static constexpr int kOffBar = (kOffDelta + kBlockRows * 4 + 7) & ~7;
  static constexpr int kBytes = kOffBar + (2 * kStages + 1) * 8 + 1024;  // + alignment
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = sm90::smem_u32(p);
  return p + (((a + 1023) & ~1023u) - a);
}

// grid (Nkv * B, ceil(S / BQ)), kWgThreads threads, BQ = 128 / rep
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1) flash_bwd_dq_wgmma(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
    const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const uint8_t* __restrict__ kv_mask, bf16* __restrict__ dq,
    int S, int N, int Nkv, int rep, int BQ, int causal, float sm_scale) {
  using C = Dq<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* Qs = sm;
  unsigned char* dOs = sm + C::kQ;
  uint8_t* mask_s = sm + C::kOffMask;
  int* flag_s = reinterpret_cast<int*>(sm + C::kOffFlag);
  float* delta_s = reinterpret_cast<float*>(sm + C::kOffDelta);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::kOffBar);
  uint64_t* empty = full + kStages;
  uint64_t* q_bar = empty + kStages;

  const int g = blockIdx.x % Nkv;
  const int b = blockIdx.x / Nkv;
  // causal: the last query tile walks the most keys; it starts first
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int rows = rep * BQ;
  // causal: keys past the tile's last position are invisible
  const int kv_end = causal ? min(q0 + BQ, S) : S;
  const int tiles = (kv_end + kKeys - 1) / kKeys;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 32);      // the producer's 32 lanes
      sm90::mbar_init(&empty[s], 256);    // both consumer warpgroups
    }
    sm90::mbar_init(q_bar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- producer warp: the Q and dO rows once, then the K/V tiles ----
    const int lane = tid & 31;
    if (lane == 0) {
      sm90::prefetch_map(&tm_k);
      sm90::prefetch_map(&tm_v);
      sm90::mbar_arrive_tx(q_bar, 2 * rows * 128 * C::P);
#pragma unroll
      for (int p = 0; p < C::P; ++p) {
        sm90::tma_load_4d(Qs + p * C::kPanelQ, &tm_q, q_bar, 64 * p, g * rep, q0, b);
        sm90::tma_load_4d(dOs + p * C::kPanelQ, &tm_do, q_bar, 64 * p, g * rep, q0, b);
      }
    }
    for (int t = 0; t < tiles; ++t) {
      const int s = t % kStages;
      const int k0 = t * kKeys;
      sm90::mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
      if (kv_mask != nullptr) {
        // the tile's key mask (keys past S count as masked) and its flag
        bool bad = false;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int kp = k0 + lane + 32 * i;
          const uint8_t m = kp < S && kv_mask[(size_t)b * S + kp] != 0;
          mask_s[s * kKeys + lane + 32 * i] = m;
          bad |= !m;
        }
        bad = __any_sync(0xffffffffu, bad);
        if (lane == 0) flag_s[s] = bad;
      }
      if (lane == 0) {
        unsigned char* st = sm + C::kOffStage + s * 2 * C::kKV;
        sm90::mbar_arrive_tx(&full[s], 2 * C::kKV);
#pragma unroll
        for (int p = 0; p < C::P; ++p) {
          sm90::tma_load_4d(st + p * C::kPanelK, &tm_k, &full[s], 64 * p, g, k0, b);
          sm90::tma_load_4d(st + C::kKV + p * C::kPanelK, &tm_v, &full[s], 64 * p, g, k0, b);
        }
      } else {
        sm90::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---- consumer warpgroups: wg owns block rows 64 wg .. 64 wg + 63 ----
  const int wg = tid >> 7;
  const int wtid = tid & 127;
  const int warp = wtid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const float c_scale = sm_scale * kLog2e;
  const float kInf = __int_as_float(0x7f800000);

  if (delta == nullptr) {
    // fused: delta = rowsum(dO * O), two threads a row, from global memory
    const int rho = 64 * wg + (wtid >> 1);
    const int half = wtid & 1;
    const int pos = q0 + rho / rep;
    float sum = 0.f;
    if (rho < rows && pos < S) {
      const size_t off = (((size_t)b * S + pos) * N + g * rep + rho % rep) * D + half * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
        const uint4 oo = *reinterpret_cast<const uint4*>(o + off + c);
        const uint4 gg = *reinterpret_cast<const uint4*>(dout + off + c);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&oo);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gg);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 a = __bfloat1622float2(o2[j]);
          const float2 d2 = __bfloat1622float2(g2[j]);
          sum += a.x * d2.x + a.y * d2.y;
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) delta_s[rho] = sum;
    sm90::named_sync(1 + wg, 128);
  }
  // this thread's accumulator rows: 16 warp + gid and + 8 of its warpgroup
  int qpos[2], head[2];
  bool rvalid[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rho = 64 * wg + 16 * warp + gid + 8 * i;
    qpos[i] = q0 + rho / rep;
    head[i] = g * rep + rho % rep;
    rvalid[i] = rho < rows && qpos[i] < S;
    const size_t r = ((size_t)b * N + head[i]) * S + qpos[i];
    lse_r[i] = rvalid[i] ? lse[r] * kLog2e : kInf;     // rows past S: p = 0
    delta_r[i] = !rvalid[i] ? 0.f : delta == nullptr ? delta_s[rho] : delta[r];
  }
  float acc[D / 2];   // m64nD accumulator of dQ
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  sm90::mbar_wait(q_bar, 0);
  sm90::pingpong_start(wg);
  const unsigned char* Qw = Qs + wg * 64 * 128;
  const unsigned char* dOw = dOs + wg * 64 * 128;

  for (int t = 0; t < tiles; ++t) {
    const int s = t % kStages;
    const int k0 = t * kKeys;
    const unsigned char* Ks = sm + C::kOffStage + s * 2 * C::kKV;
    const unsigned char* Vs = Ks + C::kKV;
    sm90::mbar_wait(&full[s], (t / kStages) & 1);

    // S = Q K^T, dP = dO V^T (k steps of 16 along D: 32 bytes a step inside
    // a 128-byte row, the next panel every 4 steps)
    float sacc[kKeys / 2], pacc[kKeys / 2];
    sm90::pingpong_take(wg);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int offq = (kk >> 2) * C::kPanelQ + (kk & 3) * 32;
      const int offk = (kk >> 2) * C::kPanelK + (kk & 3) * 32;
      sm90::wgmma_ss_n64(sacc, sm90::desc_sw128(Qw + offq, 16, 1024),
                         sm90::desc_sw128(Ks + offk, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int offq = (kk >> 2) * C::kPanelQ + (kk & 3) * 32;
      const int offk = (kk >> 2) * C::kPanelK + (kk & 3) * 32;
      sm90::wgmma_ss_n64(pacc, sm90::desc_sw128(dOw + offq, 16, 1024),
                         sm90::desc_sw128(Vs + offk, 16, 1024), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::pingpong_pass(wg);
    sm90::wgmma_wait<0>();
    sm90::fence_regs<kKeys / 2>(sacc);
    sm90::fence_regs<kKeys / 2>(pacc);

    // dS = p (dP - delta) sm_scale in place of S. Masks only where the tile
    // holds masked pairs: a flagged key, or (causal) a key past the tile's
    // first position
    const bool key_masked = kv_mask != nullptr && flag_s[s] != 0;
    const bool mask_tile = key_masked || (causal && k0 + kKeys - 1 > q0);
    const uint8_t* ms = mask_s + s * kKeys;
    if (mask_tile) {
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int col = n * 8 + 2 * tig + (e & 1);
          const bool ok = !(causal && k0 + col > qpos[i]) && (!key_masked || ms[col] != 0);
          const float p = ok ? sm90::exp2_approx(sacc[4 * n + e] * c_scale - lse_r[i]) : 0.f;
          sacc[4 * n + e] = p * (pacc[4 * n + e] - delta_r[i]) * sm_scale;
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float p = sm90::exp2_approx(sacc[4 * n + e] * c_scale - lse_r[i]);
          sacc[4 * n + e] = p * (pacc[4 * n + e] - delta_r[i]) * sm_scale;
        }
      }
    }

    // dQ += dS K: k steps of 16 keys (2048 bytes), N = D (the next 64
    // columns one panel on: LBO)
    uint32_t hi[kKeys / 16][4], lo[kKeys / 16][4];
#pragma unroll
    for (int j = 0; j < kKeys / 16; ++j)
      split_a(reinterpret_cast<const float(*)[4]>(sacc), j, hi[j], lo[j]);
    sm90::pingpong_take(wg);
    sm90::wgmma_fence();
#pragma unroll
    for (int j = 0; j < kKeys / 16; ++j) {
      const uint64_t db = sm90::desc_sw128(Ks + j * 2048, C::kPanelK, 1024);
      if constexpr (D == 64) {
        sm90::wgmma_rs_n64_t(acc, hi[j], db);
        sm90::wgmma_rs_n64_t(acc, lo[j], db);
      } else {
        sm90::wgmma_rs_n128_t(acc, hi[j], db);
        sm90::wgmma_rs_n128_t(acc, lo[j], db);
      }
    }
    sm90::wgmma_commit();
    sm90::pingpong_pass(wg);
    sm90::wgmma_wait<0>();
    sm90::fence_regs<D / 2>(acc);
#pragma unroll
    for (int j = 0; j < kKeys / 16; ++j) {
      sm90::fence_regs<4>(hi[j]);
      sm90::fence_regs<4>(lo[j]);
    }
    sm90::mbar_arrive(&empty[s]);   // this stage's tiles are read
  }
  sm90::pingpong_end(wg);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!rvalid[i]) continue;
    bf16* row = dq + (((size_t)b * S + qpos[i]) * N + head[i]) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8 + 2 * tig) = pack(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]);
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o, const void* dout,
                 const float* lse, const float* delta, const uint8_t* kv_mask, void* dq, int B,
                 int S, int N, int Nkv, int causal, float sm_scale, cudaStream_t stream) {
  const int rep = N / Nkv;
  const int BQ = kBlockRows / rep;
  CUtensorMap tq, tdo, tk, tv;
  int err = sm90_host::make_map(&tq, q, B, S, N, D, rep, BQ);
  if (!err) err = sm90_host::make_map(&tdo, dout, B, S, N, D, rep, BQ);
  if (!err) err = sm90_host::make_map(&tk, k, B, S, Nkv, D, 1, kKeys);
  if (!err) err = sm90_host::make_map(&tv, v, B, S, Nkv, D, 1, kKeys);
  if (err) return err;
  const int smem = Dq<D>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_wgmma<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(Nkv * B, (S + BQ - 1) / BQ);
  flash_bwd_dq_wgmma<D><<<grid, kWgThreads, smem, stream>>>(
      tq, tdo, tk, tv, static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, delta,
      kv_mask, static_cast<bf16*>(dq), S, N, Nkv, rep, BQ, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// dtype 0: the f32 CUDA-core kernel; 1: the bf16 wgmma kernel
template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, const float* delta, const uint8_t* kv_mask,
           void* dq, int B, int S, int N, int Nkv, int causal, float sm_scale,
           cudaStream_t stream) {
  if (dtype == 1)
    return launch_wgmma<D>(q, k, v, o, dout, lse, delta, kv_mask, dq, B, S, N, Nkv, causal,
                           sm_scale, stream);
  const int rep = N / Nkv;
  const int BQ = kRows / rep;
  dim3 grid((S + BQ - 1) / BQ, Nkv, B);
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_f32<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_f32<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(o), static_cast<const float*>(dout), lse, delta, kv_mask,
      static_cast<float*>(dq), S, N, Nkv, rep, BQ, causal, sm_scale);
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
