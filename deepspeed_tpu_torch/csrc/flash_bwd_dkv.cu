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
// D=64) bytes take ~0.07 ms against ~0.28 ms of tensor-core time. p and dS
// enter their products as bf16 hi + lo pairs (f32-like precision, as the
// TPU kernel's f32 dots), so the tensor cores do 6 products, not 4.
//
// What the design does about it (bf16; helpers in sm90.cuh). One block
// per (128 keys, kv head, batch), 384 threads in three warpgroups: a
// producer (one warp works; all four hand their registers to the others
// with setmaxnreg, 24 left) and two consumers of 64 keys each (240
// registers allowed, 168 used, no spills). The K and V tile stays in
// shared memory for the whole block, dK and dV in f32 registers (64
// registers a thread at D=64, 128 at D=128). The block loops over (query
// tile x the rep heads of the group), from the first tile that sees its
// first key (the clamp of the TPU kernel's `_q_index_map`, :380). Each
// step is one stage of a 3-stage ring in shared memory, filled by TMA from
// the producer warp (Q, dO, and O when delta is fused: [BQ][D], BQ = 64
// query rows at D=64 and 32 at D=128, zeros past S; LSE and delta by the
// producer's lanes) with completion on an mbarrier; both consumers read
// it, and it is refilled once both have arrived on a second mbarrier. Per
// step each consumer warpgroup runs on wgmma (m64nNk16, f32 accumulators):
//   S^T = K Q^T, dP^T = V dO^T   A = K, V (shared, K-major), B = Q, dO
//                                (the staged [BQ][D] tile is K-major);
//   dV += P^T dO, dK += dS^T Q   A = p, dS from registers as bf16 hi + lo
//                                (the accumulators of step 1 are the A
//                                fragments), B = the same staged dO, Q
//                                tile read MN-major (the descriptor's
//                                transpose): no transposed copy.
// The fused delta is summed from the staged O and dO while S^T and dP^T
// run. The causal mask and the key mask are applied only on tiles that
// hold masked pairs (the diagonal tiles; every tile of a block with a
// masked key); rows past S carry LSE = +inf (p = 0) instead of a mask.
// The two consumers take turns to issue their wgmma batches (sm90.cuh,
// pingpong_*), so one's exp and split run beside the other's products.
// Grid (key tiles, Nkv * B) with the key tile fastest: the blocks of one
// (batch, kv head) run together and share its Q, dO and O through L2
// (walking the 64 groups at once spilled the re-read stream to HBM), key
// tile 0, the longest causal walk, first.
//
// What bounds it now: not the tensor cores alone. In development builds
// on the H100 with one part cut out, each of the two product phases and
// the CUDA-core work (exp, dS, the hi/lo split, the fused delta, which
// both consumers sum for the same rows) took a sizeable share of the time,
// and the pipeline alone (TMA stages, barriers, no arithmetic) about a
// third: the per-step fixed cost of 64-row steps. The f32 path (only the
// f32 cross-checks use it) runs as FMAs on the CUDA cores (32 keys a
// block, 64-row steps).
//
// Float16 (the fp16 training and serving paths) takes the same kernel,
// instantiated on __half: f16 inputs, tensor maps and hi + lo pairs, f32
// accumulators and LSE, f16 outputs, at bf16's tensor-core rate. Every
// conversion rounds to nearest and none saturates, so a value past f16's
// range comes out inf (under a loss scale the engine must see it).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "sm90.cuh"

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
// bf16 and f16 (T): wgmma on TMA-fed tiles (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int kStages = 3;
constexpr int kKeys = 128;                // keys per block
constexpr int kWgKeys = 64;               // keys per consumer warpgroup (its M)
constexpr int kWgThreads = 384;           // producer warpgroup + 2 consumer warpgroups
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Dkv {
  static constexpr int P = D / 64;                  // 64-column panels
  static constexpr int BQ = D == 64 ? 64 : 32;      // query rows per step
  static constexpr int kPanelK = kKeys * 128;       // bytes of a K/V panel
  static constexpr int kPanelQ = BQ * 128;          // bytes of a Q/dO/O panel
  static constexpr int kKV = P * kPanelK;           // bytes of the K (or V) tile
  static constexpr int kTile = P * kPanelQ;         // bytes of a Q (dO, O) tile
  static constexpr int kOffStage = 2 * kKV;
  static constexpr int kStage = 3 * kTile;          // Q, dO, O
  // per stage: LSE, delta from the caller, and each consumer's fused delta
  static constexpr int kOffVec = kOffStage + kStages * kStage;
  static constexpr int kOffBar = kOffVec + kStages * 4 * BQ * 4;
  static constexpr int kBytes = kOffBar + (2 * kStages + 1) * 8 + 1024;  // + alignment
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = sm90::smem_u32(p);
  return p + (((a + 1023) & ~1023u) - a);
}

// grid (ceil(S / 128), Nkv * B), kWgThreads threads: warpgroup 0 produces
// (its warp 0 works, all four give their registers to the consumers),
// warpgroups 1 and 2 consume, each with 64 of the block's keys
template <typename T, int D>
__global__ void __launch_bounds__(kWgThreads, 1) flash_bwd_dkv_wgmma(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_o, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ lse,
    const float* __restrict__ delta, const uint8_t* __restrict__ kv_mask, T* __restrict__ dk,
    T* __restrict__ dv, int S, int N, int Nkv, int rep, int causal, float sm_scale) {
  using C = Dkv<D>;
  constexpr int BQ = C::BQ;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* Ks = sm;
  unsigned char* Vs = sm + C::kKV;
  float* vec = reinterpret_cast<float*>(sm + C::kOffVec);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::kOffBar);
  uint64_t* empty = full + kStages;
  uint64_t* kv_bar = empty + kStages;

  const int g = blockIdx.y % Nkv;
  const int b = blockIdx.y / Nkv;
  const int k0 = blockIdx.x * kKeys;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const bool fused = delta == nullptr;
  // causal: query tiles before the block's first key see none of its keys
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  const int steps = (S - q_begin + BQ - 1) / BQ * rep;

  // a consumer's keys: rows 16 w + gid and + 8 of its accumulators
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int kw0 = k0 + (wg - 1) * kWgKeys;
  const int kp0 = kw0 + warp * 16 + (lane >> 2);
  bool key_ok[2] = {true, true};
  if (kv_mask != nullptr && wg > 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kp = kp0 + 8 * i;
      key_ok[i] = kp >= S || kv_mask[(size_t)b * S + kp] != 0;
    }
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 32);      // the producer's 32 lanes
      sm90::mbar_init(&empty[s], 256);    // both consumers' threads
    }
    sm90::mbar_init(kv_bar, 1);
    sm90::mbar_fence_init();
  }
  // a masked key masks pairs on every tile of the block
  const bool any_masked = __syncthreads_or(!(key_ok[0] && key_ok[1])) != 0;

  if (wg == 0) {
    // ---- producer: K, V once, then one stage per step ----
    sm90::setmaxnreg_dec<24>();
    if (warp != 0) return;
    if (lane == 0) {
      sm90::prefetch_map(&tm_q);
      sm90::prefetch_map(&tm_do);
      sm90::mbar_arrive_tx(kv_bar, 2 * C::kKV);
#pragma unroll
      for (int p = 0; p < C::P; ++p) {
        sm90::tma_load_4d(Ks + p * C::kPanelK, &tm_k, kv_bar, 64 * p, g, k0, b);
        sm90::tma_load_4d(Vs + p * C::kPanelK, &tm_v, kv_bar, 64 * p, g, k0, b);
      }
    }
    for (int t = 0; t < steps; ++t) {
      const int s = t % kStages;
      sm90::mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
      const int qi = t / rep;
      const int q0 = q_begin + qi * BQ;
      const int head = g * rep + (t - qi * rep);
      float* lse_s = vec + s * 4 * BQ;
      float* dl_s = lse_s + BQ;
      // rows past S: LSE = +inf, so their p is exactly 0
      for (int i = lane; i < BQ; i += 32) {
        const int pos = q0 + i;
        const size_t ri = ((size_t)b * N + head) * S + pos;
        lse_s[i] = pos < S ? lse[ri] * kLog2e : __int_as_float(0x7f800000);
        if (!fused) dl_s[i] = pos < S ? delta[ri] : 0.f;
      }
      if (lane == 0) {
        unsigned char* st = sm + C::kOffStage + s * C::kStage;
        sm90::mbar_arrive_tx(&full[s], (fused ? 3 : 2) * C::kTile);
#pragma unroll
        for (int p = 0; p < C::P; ++p) {
          sm90::tma_load_4d(st + p * C::kPanelQ, &tm_q, &full[s], 64 * p, head, q0, b);
          sm90::tma_load_4d(st + C::kTile + p * C::kPanelQ, &tm_do, &full[s], 64 * p, head, q0, b);
          if (fused)
            sm90::tma_load_4d(st + 2 * C::kTile + p * C::kPanelQ, &tm_o, &full[s], 64 * p, head,
                              q0, b);
        }
      } else {
        sm90::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---- consumer warpgroup cw: keys kw0 .. kw0 + 63 ----
  sm90::setmaxnreg_inc<240>();
  const int cw = wg - 1;
  const int wtid = tid & 127;
  const int tig = lane & 3;
  const float c_scale = sm_scale * kLog2e;
  const unsigned char* Kw = Ks + cw * kWgKeys * 128;
  const unsigned char* Vw = Vs + cw * kWgKeys * 128;
  float dk_acc[D / 2], dv_acc[D / 2];   // m64nD accumulators
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  sm90::mbar_wait(kv_bar, 0);
  sm90::pingpong_start(cw);

  for (int t = 0; t < steps; ++t) {
    const int s = t % kStages;
    const int qi = t / rep;
    const int q0 = q_begin + qi * BQ;
    unsigned char* Qs = sm + C::kOffStage + s * C::kStage;
    unsigned char* dOs = Qs + C::kTile;
    unsigned char* Os = dOs + C::kTile;
    const float* lse_s = vec + s * 4 * BQ;
    // delta: the caller's (staged by the producer) or this consumer's own sum
    float* dl_s = vec + s * 4 * BQ + (fused ? 2 + cw : 1) * BQ;
    sm90::mbar_wait(&full[s], (t / kStages) & 1);

    // S^T = K Q^T, dP^T = V dO^T (k steps of 16 along D: 32 bytes a step
    // inside a 128-byte row, the next panel every 4 steps)
    float st[BQ / 2], pt[BQ / 2];
    sm90::pingpong_take(cw);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk >> 2) * C::kPanelK + (kk & 3) * 32;
      const int offq = (kk >> 2) * C::kPanelQ + (kk & 3) * 32;
      const uint64_t da = sm90::desc_sw128(Kw + off, 16, 1024);
      const uint64_t db = sm90::desc_sw128(Qs + offq, 16, 1024);
      if constexpr (BQ == 64) sm90::wgmma_ss_n64<T>(st, da, db, kk > 0);
      else sm90::wgmma_ss_n32<T>(st, da, db, kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk >> 2) * C::kPanelK + (kk & 3) * 32;
      const int offq = (kk >> 2) * C::kPanelQ + (kk & 3) * 32;
      const uint64_t da = sm90::desc_sw128(Vw + off, 16, 1024);
      const uint64_t db = sm90::desc_sw128(dOs + offq, 16, 1024);
      if constexpr (BQ == 64) sm90::wgmma_ss_n64<T>(pt, da, db, kk > 0);
      else sm90::wgmma_ss_n32<T>(pt, da, db, kk > 0);
    }
    sm90::wgmma_commit();
    sm90::pingpong_pass(cw);
    if (fused) {
      // delta = rowsum(dO * O) from the staged tiles, while the products
      // run: 128 / BQ threads a row, 4 chunks of 16 bytes each
      constexpr int TPR = 128 / BQ;
      const int row = wtid / TPR;
      const int part = wtid % TPR;
      float sum = 0.f;
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4) {
        const int c = part * 4 + c4;
        const int off = (c >> 3) * C::kPanelQ + row * 128 + (((c & 7) ^ (row & 7)) << 4);
        const uint4 oo = *reinterpret_cast<const uint4*>(Os + off);
        const uint4 gg = *reinterpret_cast<const uint4*>(dOs + off);
        const uint32_t* o2 = reinterpret_cast<const uint32_t*>(&oo);
        const uint32_t* g2 = reinterpret_cast<const uint32_t*>(&gg);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 a = unpack<T>(o2[j]);
          const float2 d2 = unpack<T>(g2[j]);
          sum += a.x * d2.x + a.y * d2.y;
        }
      }
#pragma unroll
      for (int sh = 1; sh < TPR; sh <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, sh);
      if (part == 0) dl_s[row] = sum;
      sm90::named_sync(1 + cw, 128);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs<BQ / 2>(st);
    sm90::fence_regs<BQ / 2>(pt);

    // p^T in place of S^T, dS^T in place of dP^T. Masks only where the
    // tile holds masked pairs: a key of the block is masked, or (causal)
    // some query row of the tile precedes this consumer's last key
    const bool mask_tile = any_masked || (causal && q0 < kw0 + kWgKeys - 1);
    if (mask_tile) {
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i) {
        const int col = 8 * i + 2 * tig;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
        const float2 d2 = *reinterpret_cast<const float2*>(dl_s + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = kp0 + 8 * (e >> 1);
          const bool ok = key_ok[e >> 1] && !(causal && kp > q0 + col + (e & 1));
          const float p =
              ok ? sm90::exp2_approx(st[4 * i + e] * c_scale - ((e & 1) ? l2.y : l2.x)) : 0.f;
          st[4 * i + e] = p;
          pt[4 * i + e] = p * (pt[4 * i + e] - ((e & 1) ? d2.y : d2.x)) * sm_scale;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i) {
        const int col = 8 * i + 2 * tig;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
        const float2 d2 = *reinterpret_cast<const float2*>(dl_s + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = sm90::exp2_approx(st[4 * i + e] * c_scale - ((e & 1) ? l2.y : l2.x));
          st[4 * i + e] = p;
          pt[4 * i + e] = p * (pt[4 * i + e] - ((e & 1) ? d2.y : d2.x)) * sm_scale;
        }
      }
    }

    // dV += P^T dO, dK += dS^T Q over this step's rows (k steps of 16 rows:
    // 2048 bytes; the next 64 columns of N one panel on: LBO)
    uint32_t ph[BQ / 16][4], pl[BQ / 16][4], sh[BQ / 16][4], sl[BQ / 16][4];
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      split_a<T>(reinterpret_cast<const float(*)[4]>(st), j, ph[j], pl[j]);
      split_a<T>(reinterpret_cast<const float(*)[4]>(pt), j, sh[j], sl[j]);
    }
    sm90::pingpong_take(cw);
    sm90::wgmma_fence();
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      const uint64_t db = sm90::desc_sw128(dOs + j * 2048, C::kPanelQ, 1024);
      if constexpr (D == 64) {
        sm90::wgmma_rs_n64_t<T>(dv_acc, ph[j], db);
        sm90::wgmma_rs_n64_t<T>(dv_acc, pl[j], db);
      } else {
        sm90::wgmma_rs_n128_t<T>(dv_acc, ph[j], db);
        sm90::wgmma_rs_n128_t<T>(dv_acc, pl[j], db);
      }
    }
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      const uint64_t db = sm90::desc_sw128(Qs + j * 2048, C::kPanelQ, 1024);
      if constexpr (D == 64) {
        sm90::wgmma_rs_n64_t<T>(dk_acc, sh[j], db);
        sm90::wgmma_rs_n64_t<T>(dk_acc, sl[j], db);
      } else {
        sm90::wgmma_rs_n128_t<T>(dk_acc, sh[j], db);
        sm90::wgmma_rs_n128_t<T>(dk_acc, sl[j], db);
      }
    }
    sm90::wgmma_commit();
    sm90::pingpong_pass(cw);
    sm90::wgmma_wait<0>();
    sm90::fence_regs<D / 2>(dv_acc);
    sm90::fence_regs<D / 2>(dk_acc);
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      sm90::fence_regs<4>(ph[j]);
      sm90::fence_regs<4>(pl[j]);
      sm90::fence_regs<4>(sh[j]);
      sm90::fence_regs<4>(sl[j]);
    }
    sm90::mbar_arrive(&empty[s]);   // this stage's tiles are read
  }
  sm90::pingpong_end(cw);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kp = kp0 + 8 * i;
    if (kp >= S) continue;
    const size_t off = (((size_t)b * S + kp) * Nkv + g) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + 2 * tig;
      *reinterpret_cast<uint32_t*>(dk + off + c) = pack<T>(dk_acc[4 * n + 2 * i], dk_acc[4 * n + 2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + c) = pack<T>(dv_acc[4 * n + 2 * i], dv_acc[4 * n + 2 * i + 1]);
    }
  }
}

template <typename T, int D>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o, const void* dout,
                 const float* lse, const float* delta, const uint8_t* kv_mask, void* dk, void* dv,
                 int B, int S, int N, int Nkv, int causal, float sm_scale, cudaStream_t stream) {
  constexpr int BQ = Dkv<D>::BQ;
  CUtensorMap tq, tdo, to, tk, tv;
  int err = sm90_host::make_map<T>(&tq, q, B, S, N, D, 1, BQ);
  if (!err) err = sm90_host::make_map<T>(&tdo, dout, B, S, N, D, 1, BQ);
  if (!err) err = sm90_host::make_map<T>(&to, o, B, S, N, D, 1, BQ);
  if (!err) err = sm90_host::make_map<T>(&tk, k, B, S, Nkv, D, 1, kKeys);
  if (!err) err = sm90_host::make_map<T>(&tv, v, B, S, Nkv, D, 1, kKeys);
  if (err) return err;
  const int smem = Dkv<D>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkv_wgmma<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((S + kKeys - 1) / kKeys, Nkv * B);
  flash_bwd_dkv_wgmma<T, D><<<grid, kWgThreads, smem, stream>>>(
      tq, tdo, to, tk, tv, lse, delta, kv_mask, static_cast<T*>(dk), static_cast<T*>(dv), S,
      N, Nkv, N / Nkv, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// dtype 0: the f32 CUDA-core kernel; 1: the bf16 wgmma kernel; 2: its f16 twin
template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, const float* delta, const uint8_t* kv_mask,
           void* dk, void* dv, int B, int S, int N, int Nkv, int causal, float sm_scale,
           cudaStream_t stream) {
  if (dtype == 1)
    return launch_wgmma<bf16, D>(q, k, v, o, dout, lse, delta, kv_mask, dk, dv, B, S, N, Nkv,
                                 causal, sm_scale, stream);
  if (dtype == 2)
    return launch_wgmma<__half, D>(q, k, v, o, dout, lse, delta, kv_mask, dk, dv, B, S, N, Nkv,
                                   causal, sm_scale, stream);
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
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. lse: [B, N, S] f32 from the forward.
// delta: null (fused: computed here from o) or [B, N, S] f32. kv_mask: null
// or [B, S] uint8 (nonzero = key visible). Returns a cudaError_t value
// (0 = launched).
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const void* lse, const void* delta,
                             const void* kv_mask, void* dk, void* dv, int B, int S, int N,
                             int Nkv, int D, int dtype, int causal, float sm_scale,
                             void* stream) {
  if (B < 1 || S < 1 || Nkv < 1 || N % Nkv != 0 || dtype < 0 || dtype > 2) {
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
