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
// written in the input dtype, from f32 accumulators.
//
// What bounds it on an H100: bytes and operations about equally. Three
// products of 2 * D flops per visible (query, key) pair (Q K^T, dO V^T,
// dS K) against 989 TF/s in bf16, and dS enters dS K as a bf16 hi + lo
// pair (f32-like precision, as the TPU kernel's f32 dot), so the tensor
// cores do 4 products, not 3. It reads Q, dO, LSE and delta once and each
// listed K/V block once per query block that lists it; at the BigBird
// training shape (B=2, S=8192, N=32, D=64, 220 listed block pairs) the
// unique bytes and the counted products take about the same time (~0.1
// ms each at the card's peaks).
//
// What the design does about it (bf16; helpers in sm90.cuh; the pattern
// of flash_bwd_dq.cu, B2). The work is a list of items made once per
// layout on the host (ops/sparse_attention.py, `work_list`): (query block,
// first list entry, entry count, partial slot). A row list longer than C
// entries is cut into pieces of at most C (C is about twice the mean list
// length: the non-causal BigBird global row, which lists every key block,
// becomes a few pieces as long as an ordinary row), items longest first.
// One block per (64 rows of an item's query block, head, batch), the item
// fastest: a (batch, head)'s items run together and share its K/V through
// L2. A block is a producer warpgroup (one thread works) and one consumer
// warpgroup holding its 64 rows' Q and dO in shared memory. Lists are
// short (3.4 entries at BigBird), so a block's fixed cost (its Q and dO
// load, the ring's fill, the epilogue) is a large share of its time: the
// producer hands its registers to the consumer (setmaxnreg 24 / 232) so
// that two blocks share an SM at 128 registers a thread at launch (64 KB
// of shared memory at D=64, 96 KB at D=128 with a 2-stage ring), and one
// block's fixed cost runs beside the other's products, where B2's one
// block an SM with two consumer warpgroups taking turns would leave it
// bare. The producer walks the item's entries of the adjacency list, each
// listed key block cut into 64-key tiles, tiles wholly after the block's
// last row skipped (causal: the first 64 rows of a 128-row block skip the
// second half of their diagonal block), and streams the K and V tiles
// through a ring of stages (TMA, 128B-swizzled, completion on an
// mbarrier). A block whose walk is empty (a query block that lists no key
// block) loads nothing and writes zeros. The consumer runs on wgmma
// (m64nNk16, f32 accumulators):
//   S = Q K^T, dP = dO V^T   A = Q, dO (resident, K-major), B = the K, V
//                            tile [keys][D] (K-major);
//   dQ += dS K               A = dS from registers as bf16 hi + lo (the
//                            accumulators of step 1 are the A fragments),
//                            B = the same K tile read MN-major (the
//                            descriptor's transpose): no transposed copy,
// software-pipelined as B1 is (flash_fwd.cu): S and dP of tile t + 1 are
// issued with dQ += dS K of tile t, and dS of tile t + 1 is computed on
// the CUDA cores while that runs; a stage is freed on a second mbarrier
// once its last product is done. The causal mask applies only to tiles
// that reach past the block's first row. An unsplit item writes dQ once
// in bf16; a piece writes its f32 partial to its workspace slot, and
// split_sum.cuh's second pass adds the pieces in slot order and writes
// the bf16 rows. The f32 path (only the f32 cross-checks use it) runs as
// FMAs on the CUDA cores, one block per 64 rows, whole lists.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "sm90.cuh"
#include "split_sum.cuh"

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
// bf16: wgmma on TMA-fed tiles (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;                 // query rows per block: the consumer's M
constexpr int kKeys = 64;                   // keys per K/V tile
constexpr int kWgThreads = 256;             // the producer + the consumer warpgroup
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Dq {
  static constexpr int P = D / 64;                  // 64-column panels
  static constexpr int kStages = D == 64 ? 3 : 2;   // two blocks an SM fit
  static constexpr int kPanelQ = kWgRows * 128;     // bytes of a Q/dO panel
  static constexpr int kPanelK = kKeys * 128;       // bytes of a K/V panel
  static constexpr int kQ = P * kPanelQ;            // the Q (or dO) rows
  static constexpr int kKV = P * kPanelK;           // one K (or V) tile
  static constexpr int kOffStage = 2 * kQ;
  static constexpr int kOffBar = kOffStage + kStages * 2 * kKV;
  static constexpr int kBytes = kOffBar + (2 * kStages + 1) * 8 + 1024;  // + alignment
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = sm90::smem_u32(p);
  return p + (((a + 1023) & ~1023u) - a);
}

// The K/V tiles of an item in walk order: its entries of the row's list,
// each listed key block cut into 64-key tiles, without the tiles wholly
// after the block's last row (causal). The producer and the consumer walk
// it alike.
struct KeyWalk {
  const int* list;
  int n, block, q_last, causal;
  int e, sub;
  __device__ __forceinline__ bool next(int& k0) {
    while (e < n) {
      const int k = list[e] * block + sub * kKeys;
      if (++sub * kKeys == block) {
        sub = 0;
        ++e;
      }
      if (!(causal && k > q_last)) {
        k0 = k;
        return true;
      }
    }
    return false;
  }
  __device__ __forceinline__ int count() const {
    KeyWalk w = *this;
    int k0, n_tiles = 0;
    while (w.next(k0)) ++n_tiles;
    return n_tiles;
  }
};

// grid (items x block / 64, B * N) with the item fastest, kWgThreads
// threads, two blocks an SM (128 registers a thread at launch): warpgroup
// 0 produces (one thread works) and gives its registers to warpgroup 1,
// which consumes with the block's 64 rows. item = (query block, first
// entry, entries, slot): slot < 0 writes dQ, else the f32 partial to
// ws[slot][b * N + h].
template <int D>
__global__ void __launch_bounds__(kWgThreads, 2) sparse_bwd_dq_wgmma(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
    const float* __restrict__ lse, const float* __restrict__ delta, const int* __restrict__ idx,
    const int4* __restrict__ items, bf16* __restrict__ dq, float* __restrict__ ws, int S, int N,
    int block, int ldi, int causal, float sm_scale) {
  using C = Dq<D>;
  constexpr int kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* Qs = sm;
  unsigned char* dOs = sm + C::kQ;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::kOffBar);
  uint64_t* empty = full + kStages;
  uint64_t* q_bar = empty + kStages;

  const int parts = block / kWgRows;
  const int4 item = items[blockIdx.x / parts];
  const int bh = blockIdx.y;
  const int h = bh % N;
  const int b = bh / N;
  const int q0 = item.x * block + (blockIdx.x % parts) * kWgRows;
  const int tid = threadIdx.x;
  KeyWalk walk{idx + (size_t)item.x * ldi + item.y, item.z, block, q0 + kWgRows - 1, causal, 0,
               0};
  const int tiles = walk.count();

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);      // the producer's one thread
      sm90::mbar_init(&empty[s], 128);   // the consumer warpgroup
    }
    sm90::mbar_init(q_bar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer: the Q and dO rows once, then the listed K/V tiles ----
    sm90::setmaxnreg_dec<24>();
    if (tid != 0 || tiles == 0) return;
    sm90::prefetch_map(&tm_k);
    sm90::prefetch_map(&tm_v);
    sm90::mbar_arrive_tx(q_bar, 2 * C::kQ);
#pragma unroll
    for (int p = 0; p < C::P; ++p) {
      sm90::tma_load_4d(Qs + p * C::kPanelQ, &tm_q, q_bar, 64 * p, h, q0, b);
      sm90::tma_load_4d(dOs + p * C::kPanelQ, &tm_do, q_bar, 64 * p, h, q0, b);
    }
    int k0;
    for (int t = 0; walk.next(k0); ++t) {
      const int s = t % kStages;
      sm90::mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
      unsigned char* st = sm + C::kOffStage + s * 2 * C::kKV;
      sm90::mbar_arrive_tx(&full[s], 2 * C::kKV);
#pragma unroll
      for (int p = 0; p < C::P; ++p) {
        sm90::tma_load_4d(st + p * C::kPanelK, &tm_k, &full[s], 64 * p, h, k0, b);
        sm90::tma_load_4d(st + C::kKV + p * C::kPanelK, &tm_v, &full[s], 64 * p, h, k0, b);
      }
    }
    return;
  }

  // ---- the consumer warpgroup: rows q0 .. q0 + 63 ----
  sm90::setmaxnreg_inc<232>();
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const float c_scale = sm_scale * kLog2e;
  // this thread's accumulator rows: 16 warp + gid and + 8
  int qpos[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qpos[i] = q0 + 16 * warp + gid + 8 * i;
    const size_t r = ((size_t)b * N + h) * S + qpos[i];
    lse_r[i] = lse[r] * kLog2e;
    delta_r[i] = delta[r];
  }
  float acc[D / 2];   // m64nD accumulator of dQ
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sacc[kKeys / 2], pacc[kKeys / 2];
  uint32_t hi[kKeys / 16][4], lo[kKeys / 16][4];

  auto stage = [&](int t) { return sm + C::kOffStage + (t % kStages) * 2 * C::kKV; };
  // S = Q K^T, dP = dO V^T of tile t (k steps of 16 along D: 32 bytes a
  // step inside a 128-byte row, the next panel every 4 steps)
  auto issue_s = [&](int t) {
    const unsigned char* Ks = stage(t);
    const unsigned char* Vs = Ks + C::kKV;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int offq = (kk >> 2) * C::kPanelQ + (kk & 3) * 32;
      const int offk = (kk >> 2) * C::kPanelK + (kk & 3) * 32;
      sm90::wgmma_ss_n64(sacc, sm90::desc_sw128(Qs + offq, 16, 1024),
                         sm90::desc_sw128(Ks + offk, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int offq = (kk >> 2) * C::kPanelQ + (kk & 3) * 32;
      const int offk = (kk >> 2) * C::kPanelK + (kk & 3) * 32;
      sm90::wgmma_ss_n64(pacc, sm90::desc_sw128(dOs + offq, 16, 1024),
                         sm90::desc_sw128(Vs + offk, 16, 1024), kk > 0);
    }
    sm90::wgmma_commit();
  };
  auto pin_s = [&]() {
    sm90::fence_regs<kKeys / 2>(sacc);
    sm90::fence_regs<kKeys / 2>(pacc);
  };
  // dS = p (dP - delta) sm_scale in place of S, then its bf16 hi + lo
  // halves; the causal mask only on tiles that reach past the first row
  auto ds = [&](int k0) {
    if (causal && k0 + kKeys - 1 > q0) {
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int col = n * 8 + 2 * tig + (e & 1);
          const float p = k0 + col <= qpos[i]
                              ? sm90::exp2_approx(sacc[4 * n + e] * c_scale - lse_r[i])
                              : 0.f;
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
  };
  auto split = [&]() {
#pragma unroll
    for (int j = 0; j < kKeys / 16; ++j)
      split_a(reinterpret_cast<const float(*)[4]>(sacc), j, hi[j], lo[j]);
  };
  // dQ += dS K of tile t: k steps of 16 keys (2048 bytes), N = D (the next
  // 64 columns one panel on: LBO)
  auto issue_dq = [&](int t) {
    const unsigned char* Ks = stage(t);
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
  };
  auto pin_dq = [&]() {     // the operands of dQ += dS K
    sm90::fence_regs<D / 2>(acc);
#pragma unroll
    for (int j = 0; j < kKeys / 16; ++j) {
      sm90::fence_regs<4>(hi[j]);
      sm90::fence_regs<4>(lo[j]);
    }
  };

  // Software pipeline, one turn on the tensor cores per tile t: issue
  // S, dP of tile t + 1 and dQ += dS K of tile t together; dS of tile
  // t + 1 runs while dQ of tile t does. The last tile is peeled off, so
  // every wait retires a known group, and the registers a batch reads are
  // pinned before its fence (otherwise ptxas serializes the wgmmas), as
  // in flash_fwd.cu.
  if (tiles > 0) {
    int k0;
    walk.next(k0);
    sm90::mbar_wait(q_bar, 0);
    sm90::mbar_wait(&full[0], 0);
    pin_s();
    sm90::wgmma_fence();
    issue_s(0);
    sm90::wgmma_wait<0>();
    pin_s();
    ds(k0);
    split();
    for (int t = 0; t + 1 < tiles; ++t) {
      walk.next(k0);
      sm90::mbar_wait(&full[(t + 1) % kStages], ((t + 1) / kStages) & 1);
      pin_dq();
      pin_s();
      sm90::wgmma_fence();
      issue_s(t + 1);
      issue_dq(t);
      sm90::wgmma_wait<1>();              // S(t + 1) is done, dQ(t) runs on
      pin_s();
      ds(k0);
      sm90::wgmma_wait<0>();
      pin_dq();
      sm90::mbar_arrive(&empty[t % kStages]);   // this stage's tiles are read
      split();
    }
    pin_dq();
    sm90::wgmma_fence();
    issue_dq(tiles - 1);
    sm90::wgmma_wait<0>();
    pin_dq();
    sm90::mbar_arrive(&empty[(tiles - 1) % kStages]);
  }

  if (item.w < 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      bf16* row = dq + (((size_t)b * S + qpos[i]) * N + h) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(row + n * 8 + 2 * tig) =
            pack(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]);
    }
  } else {
    float* part = ws + ((size_t)item.w * gridDim.y + bh) * block * D;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float* row = part + (size_t)(qpos[i] - item.x * block) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(row + n * 8 + 2 * tig) =
            make_float2(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]);
    }
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                 const float* delta, const int* idx, const int4* items, int n_items,
                 const int* sums, int n_sums, float* ws, void* dq, int B, int S, int N, int block,
                 int ldi, int causal, float sm_scale, cudaStream_t stream) {
  using C = Dq<D>;
  CUtensorMap tq, tdo, tk, tv;
  int err = sm90_host::make_map(&tq, q, B, S, N, D, 1, kWgRows);
  if (!err) err = sm90_host::make_map(&tdo, dout, B, S, N, D, 1, kWgRows);
  if (!err) err = sm90_host::make_map(&tk, k, B, S, N, D, 1, kKeys);
  if (!err) err = sm90_host::make_map(&tv, v, B, S, N, D, 1, kKeys);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(sparse_bwd_dq_wgmma<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(n_items * (block / kWgRows), B * N);
  sparse_bwd_dq_wgmma<D><<<grid, kWgThreads, C::kBytes, stream>>>(
      tq, tdo, tk, tv, lse, delta, idx, items, static_cast<bf16*>(dq), ws, S, N, block, ldi,
      causal, sm_scale);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return split_sum::launch(sums, n_sums, ws, nullptr, dq, nullptr, B, S, N, block, D, stream);
}

// dtype 0: the f32 CUDA-core kernel; 1: the bf16 wgmma kernel (then the
// second pass of its split rows)
template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, const int* idx, const int* cnt,
           const int4* items, int n_items, const int* sums, int n_sums, float* ws, void* dq,
           int B, int S, int N, int block, int ldi, int causal, float sm_scale,
           cudaStream_t stream) {
  if (dtype == 1)
    return launch_wgmma<D>(q, k, v, dout, lse, delta, idx, items, n_items, sums, n_sums, ws, dq,
                           B, S, N, block, ldi, causal, sm_scale, stream);
  dim3 grid(N, B, S / kRows);
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(sparse_bwd_dq_f32<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sparse_bwd_dq_f32<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, idx, cnt, static_cast<float*>(dq), S, N,
      block, ldi, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse: [B, N, S] f32 from the forward;
// delta: [B, N, S] f32 = rowsum(dO * O). idx / cnt: the forward's
// adjacency ([S / block, ldi] and [S / block] int32). bf16 only: items
// [n_items, 4] int32 (query block, first entry, entries, slot), sums
// [n_sums, 3] int32 (query block, first slot, pieces) and ws, the f32
// workspace of the slots ([slots, B * N, block, D]; null when nothing is
// split); the f32 kernel walks whole lists and reads none of them. Returns
// a cudaError_t value (0 = launched).
extern "C" int sparse_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* idx,
                             const void* cnt, const void* items, const void* sums, void* ws,
                             void* dq, int B, int S, int N, int D, int block, int ldi,
                             int n_items, int n_sums, int dtype, int causal, float sm_scale,
                             void* stream) {
  if (B < 1 || S < 1 || N < 1 || (block != 64 && block != 128) || S % block != 0 || ldi < 1 ||
      (dtype != 0 && dtype != 1) || (dtype == 1 && (n_items < 1 || n_sums < 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  const int* idx_i = static_cast<const int*>(idx);
  const int* cnt_i = static_cast<const int*>(cnt);
  const int4* items_i = static_cast<const int4*>(items);
  const int* sums_i = static_cast<const int*>(sums);
  float* ws_f = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(dtype, q, k, v, dout, lse_f, delta_f, idx_i, cnt_i, items_i, n_items,
                      sums_i, n_sums, ws_f, dq, B, S, N, block, ldi, causal, sm_scale, st);
  if (D == 128)
    return launch<128>(dtype, q, k, v, dout, lse_f, delta_f, idx_i, cnt_i, items_i, n_items,
                       sums_i, n_sums, ws_f, dq, B, S, N, block, ldi, causal, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
