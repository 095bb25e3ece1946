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
// of the repeat); LSE and delta [B, N, S] f32. dK and dV are written in
// the input dtype, from f32 accumulators.
//
// What bounds it on an H100: operations. Four products of 2 * D flops per
// visible (query, key) pair (K Q^T, V dO^T, p^T dO, dS^T Q) against
// 989 TF/s in bf16, with p and dS as bf16 hi + lo pairs (f32-like
// precision, as the TPU kernel's f32 dots: 6 products, not 4); the unique
// bytes (Q, K, V, dO, LSE, delta read once, dK, dV written once) take
// about as long at the BigBird training shape. Beyond both, the load is
// uneven by design of the layouts: a global column (BigBird's key block 0)
// is listed by every query block, S / block entries where the median
// column has 2 (causal), so a CUDA block that walked a whole column would
// set the kernel's time at long S.
//
// What the design does about it (bf16; helpers in sm90.cuh; the pattern
// of flash_bwd_dkv.cu, B3). The work is a list of items made once per
// layout on the host (ops/sparse_attention.py, `work_list`): (key block,
// first column entry, entry count, partial slot). A column longer than C
// entries (C is about twice the mean column length: 8 at BigBird) is cut
// into pieces of at most C, so the global column becomes S / block / C
// pieces that run side by side; items longest first. One block per (64
// keys of an item's key block, head, batch), the item fastest: a (batch,
// head)'s items run together and share its Q and dO through L2. A block
// holds its 64 keys' K and V in shared memory and their dK and dV in f32
// registers of one consumer warpgroup; a producer warpgroup (one warp
// works) hands its registers over (setmaxnreg 24 / 232), so two blocks
// share an SM at 128 registers a thread at launch, and one's fixed cost
// (K/V load, the ring's fill, the epilogue) runs beside the other's
// products: the columns are short (2 entries at the BigBird median),
// where B3's one block an SM with two consumer warpgroups taking turns
// would leave that cost bare. The producer walks the item's entries of
// the column list, each listed query block cut into steps of BQ rows (64
// at D=64, 32 at D=128), steps wholly before the block's first key
// skipped (causal), and streams Q and dO (TMA, 128B-swizzled) with their
// LSE and delta through a 3-stage ring with completion on an mbarrier.
// A block whose walk is empty (a key block no query block lists) loads
// nothing and writes zeros. The consumer runs on wgmma (m64nNk16, f32
// accumulators):
//   S^T = K Q^T, dP^T = V dO^T   A = K, V (resident, K-major), B = Q, dO
//                                (the staged [BQ][D] tile is K-major);
//   dV += P^T dO, dK += dS^T Q   A = p, dS from registers as bf16 hi + lo
//                                (the accumulators of step 1 are the A
//                                fragments), B = the same staged dO, Q
//                                tile read MN-major (the descriptor's
//                                transpose): no transposed copy,
// software-pipelined as B1 is (flash_fwd.cu): S^T and dP^T of step t + 1
// are issued with dV, dK of step t, and the softmax of step t + 1 runs on
// the CUDA cores while those do. The causal mask applies only to steps
// with a row before the block's last key. An unsplit item writes dK and
// dV once in bf16; a piece writes f32 partials to its workspace slot, and
// split_sum.cuh's second pass adds the pieces in slot order and writes
// the bf16 rows. The f32 path (only the f32 cross-checks use it) runs as
// FMAs on the CUDA cores, one block per 32 keys, whole columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "sm90.cuh"
#include "split_sum.cuh"

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
// bf16: wgmma on TMA-fed tiles (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int kWgKeys = 64;                 // keys per block: the consumer's M
constexpr int kWgThreads = 256;             // the producer + the consumer warpgroup
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Dkv {
  static constexpr int P = D / 64;                  // 64-column panels
  static constexpr int BQ = D == 64 ? 64 : 32;      // query rows per step
  static constexpr int kStages = 3;
  static constexpr int kPanelK = kWgKeys * 128;     // bytes of a K/V panel
  static constexpr int kPanelQ = BQ * 128;          // bytes of a Q/dO panel
  static constexpr int kKV = P * kPanelK;           // bytes of the K (or V) rows
  static constexpr int kTile = P * kPanelQ;         // bytes of a Q (or dO) step
  static constexpr int kOffStage = 2 * kKV;
  static constexpr int kStage = 2 * kTile;          // Q, dO
  static constexpr int kOffVec = kOffStage + kStages * kStage;   // per stage LSE, delta
  static constexpr int kOffBar = kOffVec + kStages * 2 * BQ * 4;
  static constexpr int kBytes = kOffBar + (2 * kStages + 1) * 8 + 1024;  // + alignment
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = sm90::smem_u32(p);
  return p + (((a + 1023) & ~1023u) - a);
}

// The query steps of an item in walk order: its entries of the column's
// list, each listed query block cut into steps of BQ rows, without the
// steps wholly before the block's first key (causal). The producer and
// the consumer walk it alike.
template <int BQ>
struct QueryWalk {
  const int* list;
  int n, block, k_first, causal;
  int e, sub;
  __device__ __forceinline__ bool next(int& q0) {
    while (e < n) {
      const int q = list[e] * block + sub * BQ;
      if (++sub * BQ == block) {
        sub = 0;
        ++e;
      }
      if (!(causal && q + BQ - 1 < k_first)) {
        q0 = q;
        return true;
      }
    }
    return false;
  }
  __device__ __forceinline__ int count() const {
    QueryWalk w = *this;
    int q0, steps = 0;
    while (w.next(q0)) ++steps;
    return steps;
  }
};

// grid (items x block / 64, B * N) with the item fastest, kWgThreads
// threads, two blocks an SM (128 registers a thread at launch): warpgroup
// 0 produces (its warp 0 works) and gives its registers to warpgroup 1,
// which consumes with 64 keys. item = (key block, first entry, entries,
// slot): slot < 0 writes dK and dV, else their f32 partials to ws_dk /
// ws_dv[slot][b * N + h].
template <int D>
__global__ void __launch_bounds__(kWgThreads, 2) sparse_bwd_dkv_wgmma(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
    const float* __restrict__ lse, const float* __restrict__ delta, const int* __restrict__ cidx,
    const int4* __restrict__ items, bf16* __restrict__ dk, bf16* __restrict__ dv,
    float* __restrict__ ws_dk, float* __restrict__ ws_dv, int S, int N, int block, int ldc,
    int causal, float sm_scale) {
  using C = Dkv<D>;
  constexpr int BQ = C::BQ;
  constexpr int kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* Ks = sm;
  unsigned char* Vs = sm + C::kKV;
  float* vec = reinterpret_cast<float*>(sm + C::kOffVec);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::kOffBar);
  uint64_t* empty = full + kStages;
  uint64_t* kv_bar = empty + kStages;

  const int parts = block / kWgKeys;
  const int4 item = items[blockIdx.x / parts];
  const int bh = blockIdx.y;
  const int h = bh % N;
  const int b = bh / N;
  const int k0 = item.x * block + (blockIdx.x % parts) * kWgKeys;
  const int tid = threadIdx.x;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  QueryWalk<BQ> walk{cidx + (size_t)item.x * ldc + item.y, item.z, block, k0, causal, 0, 0};
  const int steps = walk.count();

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 32);     // the producer's 32 lanes
      sm90::mbar_init(&empty[s], 128);   // the consumer warpgroup
    }
    sm90::mbar_init(kv_bar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer: K, V once, then one stage per step ----
    sm90::setmaxnreg_dec<24>();
    if (warp != 0 || steps == 0) return;
    if (lane == 0) {
      sm90::prefetch_map(&tm_q);
      sm90::prefetch_map(&tm_do);
      sm90::mbar_arrive_tx(kv_bar, 2 * C::kKV);
#pragma unroll
      for (int p = 0; p < C::P; ++p) {
        sm90::tma_load_4d(Ks + p * C::kPanelK, &tm_k, kv_bar, 64 * p, h, k0, b);
        sm90::tma_load_4d(Vs + p * C::kPanelK, &tm_v, kv_bar, 64 * p, h, k0, b);
      }
    }
    int q0;
    for (int t = 0; walk.next(q0); ++t) {
      const int s = t % kStages;
      sm90::mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
      float* lse_s = vec + s * 2 * BQ;
      float* dl_s = lse_s + BQ;
      const size_t r0 = ((size_t)b * N + h) * S + q0;
      for (int i = lane; i < BQ; i += 32) {
        lse_s[i] = lse[r0 + i] * kLog2e;
        dl_s[i] = delta[r0 + i];
      }
      if (lane == 0) {
        unsigned char* st = sm + C::kOffStage + s * C::kStage;
        sm90::mbar_arrive_tx(&full[s], 2 * C::kTile);
#pragma unroll
        for (int p = 0; p < C::P; ++p) {
          sm90::tma_load_4d(st + p * C::kPanelQ, &tm_q, &full[s], 64 * p, h, q0, b);
          sm90::tma_load_4d(st + C::kTile + p * C::kPanelQ, &tm_do, &full[s], 64 * p, h, q0, b);
        }
      } else {
        sm90::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---- the consumer warpgroup: keys k0 .. k0 + 63 ----
  sm90::setmaxnreg_inc<232>();
  const int tig = lane & 3;
  const float c_scale = sm_scale * kLog2e;
  // this thread's keys: rows 16 warp + gid and + 8 of its accumulators
  const int kp0 = k0 + warp * 16 + (lane >> 2);
  float dk_acc[D / 2], dv_acc[D / 2];   // m64nD accumulators
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  float st[BQ / 2], pt[BQ / 2];
  uint32_t ph[BQ / 16][4], pl[BQ / 16][4], sh[BQ / 16][4], sl[BQ / 16][4];

  auto stage = [&](int t) { return sm + C::kOffStage + (t % kStages) * C::kStage; };
  // S^T = K Q^T, dP^T = V dO^T of step t (k steps of 16 along D: 32 bytes
  // a step inside a 128-byte row, the next panel every 4 steps)
  auto issue_s = [&](int t) {
    const unsigned char* Qs = stage(t);
    const unsigned char* dOs = Qs + C::kTile;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk >> 2) * C::kPanelK + (kk & 3) * 32;
      const int offq = (kk >> 2) * C::kPanelQ + (kk & 3) * 32;
      const uint64_t da = sm90::desc_sw128(Ks + off, 16, 1024);
      const uint64_t db = sm90::desc_sw128(Qs + offq, 16, 1024);
      if constexpr (BQ == 64) sm90::wgmma_ss_n64(st, da, db, kk > 0);
      else sm90::wgmma_ss_n32(st, da, db, kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk >> 2) * C::kPanelK + (kk & 3) * 32;
      const int offq = (kk >> 2) * C::kPanelQ + (kk & 3) * 32;
      const uint64_t da = sm90::desc_sw128(Vs + off, 16, 1024);
      const uint64_t db = sm90::desc_sw128(dOs + offq, 16, 1024);
      if constexpr (BQ == 64) sm90::wgmma_ss_n64(pt, da, db, kk > 0);
      else sm90::wgmma_ss_n32(pt, da, db, kk > 0);
    }
    sm90::wgmma_commit();
  };
  auto pin_s = [&]() {
    sm90::fence_regs<BQ / 2>(st);
    sm90::fence_regs<BQ / 2>(pt);
  };
  // p^T in place of S^T, dS^T in place of dP^T for step t at rows q0 ..;
  // the causal mask only on steps with a row before the block's last key
  auto softmax = [&](int t, int q0) {
    const float* lse_s = vec + (t % kStages) * 2 * BQ;
    const float* dl_s = lse_s + BQ;
    if (causal && q0 < k0 + kWgKeys - 1) {
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i) {
        const int col = 8 * i + 2 * tig;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
        const float2 d2 = *reinterpret_cast<const float2*>(dl_s + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = kp0 + 8 * (e >> 1) <= q0 + col + (e & 1);
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
  };
  auto split = [&]() {
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      split_a(reinterpret_cast<const float(*)[4]>(st), j, ph[j], pl[j]);
      split_a(reinterpret_cast<const float(*)[4]>(pt), j, sh[j], sl[j]);
    }
  };
  // dV += P^T dO, dK += dS^T Q over step t's rows (k steps of 16 rows:
  // 2048 bytes; the next 64 columns of N one panel on: LBO)
  auto issue_kv = [&](int t) {
    const unsigned char* Qs = stage(t);
    const unsigned char* dOs = Qs + C::kTile;
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      const uint64_t db = sm90::desc_sw128(dOs + j * 2048, C::kPanelQ, 1024);
      if constexpr (D == 64) {
        sm90::wgmma_rs_n64_t(dv_acc, ph[j], db);
        sm90::wgmma_rs_n64_t(dv_acc, pl[j], db);
      } else {
        sm90::wgmma_rs_n128_t(dv_acc, ph[j], db);
        sm90::wgmma_rs_n128_t(dv_acc, pl[j], db);
      }
    }
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      const uint64_t db = sm90::desc_sw128(Qs + j * 2048, C::kPanelQ, 1024);
      if constexpr (D == 64) {
        sm90::wgmma_rs_n64_t(dk_acc, sh[j], db);
        sm90::wgmma_rs_n64_t(dk_acc, sl[j], db);
      } else {
        sm90::wgmma_rs_n128_t(dk_acc, sh[j], db);
        sm90::wgmma_rs_n128_t(dk_acc, sl[j], db);
      }
    }
    sm90::wgmma_commit();
  };
  auto pin_kv = [&]() {     // the operands of dV += P^T dO, dK += dS^T Q
    sm90::fence_regs<D / 2>(dv_acc);
    sm90::fence_regs<D / 2>(dk_acc);
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      sm90::fence_regs<4>(ph[j]);
      sm90::fence_regs<4>(pl[j]);
      sm90::fence_regs<4>(sh[j]);
      sm90::fence_regs<4>(sl[j]);
    }
  };

  // Software pipeline, one turn on the tensor cores per step t: issue
  // S^T, dP^T of step t + 1 and dV, dK of step t together; the softmax of
  // step t + 1 runs while dV, dK of step t do. The last step is peeled
  // off, so every wait retires a known group, and the registers a batch
  // reads are pinned before its fence (otherwise ptxas serializes the
  // wgmmas), as in flash_fwd.cu.
  if (steps > 0) {
    int q0;
    walk.next(q0);
    sm90::mbar_wait(kv_bar, 0);
    sm90::mbar_wait(&full[0], 0);
    pin_s();
    sm90::wgmma_fence();
    issue_s(0);
    sm90::wgmma_wait<0>();
    pin_s();
    softmax(0, q0);
    split();
    for (int t = 0; t + 1 < steps; ++t) {
      walk.next(q0);
      sm90::mbar_wait(&full[(t + 1) % kStages], ((t + 1) / kStages) & 1);
      pin_kv();
      pin_s();
      sm90::wgmma_fence();
      issue_s(t + 1);
      issue_kv(t);
      sm90::wgmma_wait<1>();              // S(t + 1) is done, dV, dK(t) run on
      pin_s();
      softmax(t + 1, q0);
      sm90::wgmma_wait<0>();
      pin_kv();
      sm90::mbar_arrive(&empty[t % kStages]);   // this stage's tiles are read
      split();
    }
    pin_kv();
    sm90::wgmma_fence();
    issue_kv(steps - 1);
    sm90::wgmma_wait<0>();
    pin_kv();
    sm90::mbar_arrive(&empty[(steps - 1) % kStages]);
  }

  if (item.w < 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const size_t off = (((size_t)b * S + kp0 + 8 * i) * N + h) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int c = n * 8 + 2 * tig;
        *reinterpret_cast<uint32_t*>(dk + off + c) =
            pack(dk_acc[4 * n + 2 * i], dk_acc[4 * n + 2 * i + 1]);
        *reinterpret_cast<uint32_t*>(dv + off + c) =
            pack(dv_acc[4 * n + 2 * i], dv_acc[4 * n + 2 * i + 1]);
      }
    }
  } else {
    const size_t part = ((size_t)item.w * gridDim.y + bh) * block * D;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const size_t off = part + (size_t)(kp0 + 8 * i - item.x * block) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int c = n * 8 + 2 * tig;
        *reinterpret_cast<float2*>(ws_dk + off + c) =
            make_float2(dk_acc[4 * n + 2 * i], dk_acc[4 * n + 2 * i + 1]);
        *reinterpret_cast<float2*>(ws_dv + off + c) =
            make_float2(dv_acc[4 * n + 2 * i], dv_acc[4 * n + 2 * i + 1]);
      }
    }
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                 const float* delta, const int* cidx, const int4* items, int n_items,
                 const int* sums, int n_sums, float* ws_dk, float* ws_dv, void* dk, void* dv,
                 int B, int S, int N, int block, int ldc, int causal, float sm_scale,
                 cudaStream_t stream) {
  using C = Dkv<D>;
  CUtensorMap tq, tdo, tk, tv;
  int err = sm90_host::make_map(&tq, q, B, S, N, D, 1, C::BQ);
  if (!err) err = sm90_host::make_map(&tdo, dout, B, S, N, D, 1, C::BQ);
  if (!err) err = sm90_host::make_map(&tk, k, B, S, N, D, 1, kWgKeys);
  if (!err) err = sm90_host::make_map(&tv, v, B, S, N, D, 1, kWgKeys);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(sparse_bwd_dkv_wgmma<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(n_items * (block / kWgKeys), B * N);
  sparse_bwd_dkv_wgmma<D><<<grid, kWgThreads, C::kBytes, stream>>>(
      tq, tdo, tk, tv, lse, delta, cidx, items, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      ws_dk, ws_dv, S, N, block, ldc, causal, sm_scale);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return split_sum::launch(sums, n_sums, ws_dk, ws_dv, dk, dv, B, S, N, block, D, stream);
}

// dtype 0: the f32 CUDA-core kernel; 1: the bf16 wgmma kernel (then the
// second pass of its split columns)
template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, const int* cidx, const int* ccnt,
           const int4* items, int n_items, const int* sums, int n_sums, float* ws_dk,
           float* ws_dv, void* dk, void* dv, int B, int S, int N, int block, int ldc, int causal,
           float sm_scale, cudaStream_t stream) {
  if (dtype == 1)
    return launch_wgmma<D>(q, k, v, dout, lse, delta, cidx, items, n_items, sums, n_sums, ws_dk,
                           ws_dv, dk, dv, B, S, N, block, ldc, causal, sm_scale, stream);
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
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse: [B, N, S] f32 from the forward;
// delta: [B, N, S] f32 = rowsum(dO * O). cidx / ccnt: the transposed
// adjacency ([S / block, ldc] query blocks listing each key block, -1 past
// ccnt; [S / block] int32). bf16 only: items [n_items, 4] int32 (key
// block, first entry, entries, slot), sums [n_sums, 3] int32 (key block,
// first slot, pieces) and ws_dk / ws_dv, the f32 workspaces of the slots
// ([slots, B * N, block, D] each; null when nothing is split); the f32
// kernel walks whole columns and reads none of them. Returns a cudaError_t
// value (0 = launched).
extern "C" int sparse_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, const void* cidx,
                              const void* ccnt, const void* items, const void* sums,
                              void* ws_dk, void* ws_dv, void* dk, void* dv, int B, int S, int N,
                              int D, int block, int ldc, int n_items, int n_sums, int dtype,
                              int causal, float sm_scale, void* stream) {
  if (B < 1 || S < 1 || N < 1 || (block != 64 && block != 128) || S % block != 0 || ldc < 1 ||
      (dtype != 0 && dtype != 1) || (dtype == 1 && (n_items < 1 || n_sums < 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  const int* cidx_i = static_cast<const int*>(cidx);
  const int* ccnt_i = static_cast<const int*>(ccnt);
  const int4* items_i = static_cast<const int4*>(items);
  const int* sums_i = static_cast<const int*>(sums);
  float* wk = static_cast<float*>(ws_dk);
  float* wv = static_cast<float*>(ws_dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(dtype, q, k, v, dout, lse_f, delta_f, cidx_i, ccnt_i, items_i, n_items,
                      sums_i, n_sums, wk, wv, dk, dv, B, S, N, block, ldc, causal, sm_scale, st);
  if (D == 128)
    return launch<128>(dtype, q, k, v, dout, lse_f, delta_f, cidx_i, ccnt_i, items_i, n_items,
                       sums_i, n_sums, wk, wv, dk, dv, B, S, N, block, ldc, causal, sm_scale,
                       st);
  return static_cast<int>(cudaErrorInvalidValue);
}
