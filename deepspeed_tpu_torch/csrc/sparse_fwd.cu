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
// O row once but each K/V block once per query block that lists it; p
// enters p V as a bf16 hi + lo pair (f32-like precision, as the TPU
// kernel's f32 dots), so the tensor cores do 3 products of 2 * D flops per
// visible pair, not 2. At the training shape (B=2, S=8192, N=32, D=64,
// causal, 220 listed block pairs) the unique bytes (Q, K, V, O, LSE once)
// take ~0.08 ms at 3.35 TB/s and the counted products ~0.04 ms at 989
// TF/s: bytes bound it. The first design (mma.sync, 128 threads a 64-row
// tile, each key tile loaded and then used) ran at 79 TF/s counted, and
// one block walked a whole row list: BigBird's non-causal global row,
// which lists every key block, set that case's time.
//
// What the design does about it (bf16; helpers in sm90.cuh, the pattern
// of sparse_bwd_dq.cu, B6). The work is B6's row work list, made once per
// layout on the host (ops/sparse_attention.py, `work_list`): items (query
// block, first list entry, entry count, partial slot), a list longer than
// C entries cut into pieces of at most C, items longest first. One block
// per (64 rows of an item's query block, head, batch), the item fastest. A
// block is a producer warpgroup (one thread works; it gives its registers
// away with setmaxnreg) and one consumer warpgroup. Walks are short (3.4
// entries, ~6 tiles at the training shape), so a block's fixed cost (the
// Q load, the ring's fill, the first S and the last P V, the epilogue)
// weighs, and more blocks an SM hide more of it: at D=64 three blocks
// share an SM (80 registers a thread at launch, the consumer raised to
// 136, a 3-stage ring, 57 KB of shared memory each), at D=128 two (128 at
// launch, the consumer raised to 232, a 2-stage ring). The producer loads the 64 query rows once, then walks the item's entries, each listed
// key block cut into 64-key tiles, tiles wholly after the block's last
// row skipped (causal), and streams the K and V tiles through a ring of
// stages (TMA, 128B-swizzled, completion on an mbarrier; a stage is freed
// on a second mbarrier once its last product is done). The consumer runs
// on wgmma (m64nNk16, f32 accumulators):
//   S = Q K^T      A = Q (resident, K-major), B = the K tile [keys][D]
//                  (K-major);
//   O += P V       A = P from registers as bf16 hi + lo (the S
//                  accumulators are the A fragments), B = the V tile read
//                  MN-major through the descriptor: no transposed copy,
// with the online softmax in f32 registers on exp2 (sm_scale * log2(e)
// folded into one FMA, the running max floored at M_FLOOR), software-
// pipelined as B1 (flash_fwd.cu): S of tile t + 1 is issued with P V of
// tile t and its softmax runs while P V does; the walk is counted first
// (lists are short), so the last step is peeled and every wait retires a
// known group. The causal mask applies only to tiles that reach past the
// block's first row. An unsplit item writes O (bf16) and LSE once; a walk
// with no tile (an empty list) writes O = 0 and LSE = -1e30 exactly. A
// piece writes its f32 partials (unnormalised acc, m, l) to its workspace
// slot, and split_sum.cuh's `lse_merge` merges each split block's pieces
// in slot order by the log-sum-exp rule and writes its O and LSE. No
// atomics: a second launch gives the same bits. The f32 path (only the
// f32 cross-checks use it) runs as FMAs on the CUDA cores, one block per
// 64 rows walking whole lists, each key tile loaded then used.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "sm90.cuh"
#include "split_sum.cuh"

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
// bf16: wgmma on TMA-fed tiles (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;                 // query rows per block: the consumer's M
constexpr int kKeys = 64;                   // keys per K/V tile
constexpr int kWgThreads = 256;             // the producer + the consumer warpgroup
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Fwd {
  static constexpr int P = D / 64;                  // 64-column panels
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr int kBlocksPerSM = D == 64 ? 3 : 2;
  // registers of a consumer thread once the producer gave its own away
  // (the block's allocation at launch: 65536 / kBlocksPerSM / 256 each)
  static constexpr int kConsumerRegs = kBlocksPerSM == 2 ? 232 : 136;
  static constexpr int kPanelQ = kWgRows * 128;     // bytes of a Q panel
  static constexpr int kPanelK = kKeys * 128;       // bytes of a K/V panel
  static constexpr int kQ = P * kPanelQ;            // the Q rows
  static constexpr int kKV = P * kPanelK;           // one K (or V) tile
  static constexpr int kOffStage = kQ;
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
  // the walk's tile count, the same in every lane of a warp: the lanes
  // read the entries side by side (a listed block has block / 64 tiles,
  // causal only those that start at or before q_last)
  __device__ __forceinline__ int count() const {
    const int parts = block / kKeys;
    int n_tiles = 0;
    for (int i = threadIdx.x & 31; i < n; i += 32) {
      const int k = list[i] * block;
      n_tiles += !causal ? parts : k > q_last ? 0 : min(parts, (q_last - k) / kKeys + 1);
    }
    return __reduce_add_sync(0xffffffffu, n_tiles);
  }
};

// grid (items x block / 64, B * N) with the item fastest, kWgThreads
// threads, two blocks an SM (128 registers a thread at launch): warpgroup
// 0 produces (one thread works) and gives its registers to warpgroup 1,
// which consumes with the block's 64 rows. item = (query block, first
// entry, entries, slot): slot < 0 writes O and LSE, else the f32 partials
// to ws[slot][b * N + h] (acc, [block][D]) and ws_ml[slot][b * N + h]
// ((m in log2 units, l), [block]).
template <int D>
__global__ void __launch_bounds__(kWgThreads, Fwd<D>::kBlocksPerSM) sparse_fwd_wgmma(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ idx,
    const int4* __restrict__ items, bf16* __restrict__ o, float* __restrict__ lse,
    float* __restrict__ ws, float2* __restrict__ ws_ml, int S, int N, int block, int ldi,
    int causal, float sm_scale) {
  using C = Fwd<D>;
  constexpr int kStages = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* Qs = sm;
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
    // ---- producer: the Q rows once, then the listed K/V tiles ----
    sm90::setmaxnreg_dec<24>();
    // an empty list loads nothing; a non-empty one has a tile for these
    // rows (a causal list holds no block after its query block)
    if (tid != 0 || item.z == 0) return;
    sm90::prefetch_map(&tm_k);
    sm90::prefetch_map(&tm_v);
    sm90::mbar_arrive_tx(q_bar, C::kQ);
#pragma unroll
    for (int p = 0; p < C::P; ++p)
      sm90::tma_load_4d(Qs + p * C::kPanelQ, &tm_q, q_bar, 64 * p, h, q0, b);
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
  sm90::setmaxnreg_inc<C::kConsumerRegs>();
  const int tiles = walk.count();
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const float c_scale = sm_scale * kLog2e;
  // this thread's accumulator rows: 16 warp + gid and + 8; m in log2 units
  // (scores times c_scale), l this thread's partial sum over its columns
  int qpos[2];
  float m[2], l[2], alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qpos[i] = q0 + 16 * warp + gid + 8 * i;
    m[i] = kMFloor;
    l[i] = 0.f;
  }
  float acc[D / 2];   // m64nD accumulator of O
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sacc[kKeys / 2];
  uint32_t hi[kKeys / 16][4], lo[kKeys / 16][4];

  auto stage = [&](int t) { return sm + C::kOffStage + (t % kStages) * 2 * C::kKV; };
  // S = Q K^T of tile t (k steps of 16 along D: 32 bytes a step inside a
  // 128-byte row, the next panel every 4 steps)
  auto issue_s = [&](int t) {
    const unsigned char* Ks = stage(t);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int offq = (kk >> 2) * C::kPanelQ + (kk & 3) * 32;
      const int offk = (kk >> 2) * C::kPanelK + (kk & 3) * 32;
      sm90::wgmma_ss_n64(sacc, sm90::desc_sw128(Qs + offq, 16, 1024),
                         sm90::desc_sw128(Ks + offk, 16, 1024), kk > 0);
    }
    sm90::wgmma_commit();
  };
  // One tile's scores turned into p in place: the causal mask (-inf) only
  // on a tile that reaches past the block's first row, then the online
  // softmax; alpha gets each row's rescale factor for O
  auto softmax = [&](int k0) {
    const float kInf = __int_as_float(0x7f800000);
    if (causal && k0 + kKeys - 1 > q0) {
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (k0 + n * 8 + 2 * tig + (e & 1) > qpos[e >> 1]) sacc[4 * n + e] = -kInf;
        }
      }
    }
    float mx[4] = {-kInf, -kInf, -kInf, -kInf};
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e] = fmaxf(mx[e], sacc[4 * n + e]);
    float m_new[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float x = fmaxf(mx[2 * i], mx[2 * i + 1]);
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      m_new[i] = fmaxf(m[i], x * c_scale);
      alpha[i] = sm90::exp2_approx(m[i] - m_new[i]);
      m[i] = m_new[i];
    }
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = sm90::exp2_approx(fmaf(sacc[4 * n + e], c_scale, -m_new[e >> 1]));
        sacc[4 * n + e] = p;
        sum[e] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + (sum[2 * i] + sum[2 * i + 1]);
  };
  auto split_p = [&]() {
#pragma unroll
    for (int j = 0; j < kKeys / 16; ++j)
      split_a(reinterpret_cast<const float(*)[4]>(sacc), j, hi[j], lo[j]);
  };
  // O += P V of tile t: k steps of 16 keys (2048 bytes), N = D (the next
  // 64 columns one panel on: LBO)
  auto issue_pv = [&](int t) {
    const unsigned char* Vs = stage(t) + C::kKV;
#pragma unroll
    for (int j = 0; j < kKeys / 16; ++j) {
      const uint64_t db = sm90::desc_sw128(Vs + j * 2048, C::kPanelK, 1024);
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
  auto pin_pv = [&]() {     // the operands of O += P V: O and the P halves
    sm90::fence_regs<D / 2>(acc);
#pragma unroll
    for (int j = 0; j < kKeys / 16; ++j) {
      sm90::fence_regs<4>(hi[j]);
      sm90::fence_regs<4>(lo[j]);
    }
  };

  // Software pipeline, one turn on the tensor cores per tile t: issue
  // S(t + 1) and O += P(t) V(t) together; the softmax of tile t + 1 runs
  // while P(t) V(t) does, and O is rescaled once that is done. The last
  // tile is peeled off, so every wait retires a known group, and the
  // registers a batch reads are pinned before its fence (otherwise ptxas
  // serializes the wgmmas), as in flash_fwd.cu.
  if (tiles > 0) {
    int k0;
    walk.next(k0);
    sm90::mbar_wait(q_bar, 0);
    sm90::mbar_wait(&full[0], 0);
    sm90::fence_regs<kKeys / 2>(sacc);
    sm90::wgmma_fence();
    issue_s(0);
    sm90::wgmma_wait<0>();
    sm90::fence_regs<kKeys / 2>(sacc);
    softmax(k0);
    split_p();
    for (int t = 0; t + 1 < tiles; ++t) {
      walk.next(k0);
      sm90::mbar_wait(&full[(t + 1) % kStages], ((t + 1) / kStages) & 1);
      pin_pv();
      sm90::fence_regs<kKeys / 2>(sacc);
      sm90::wgmma_fence();
      issue_s(t + 1);
      issue_pv(t);
      sm90::wgmma_wait<1>();              // S(t + 1) is done, P(t) V(t) runs on
      sm90::fence_regs<kKeys / 2>(sacc);
      softmax(k0);
      sm90::wgmma_wait<0>();
      pin_pv();
      sm90::mbar_arrive(&empty[t % kStages]);   // this stage's tiles are read
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * n + e] *= alpha[e >> 1];
      }
      split_p();
    }
    pin_pv();
    sm90::wgmma_fence();
    issue_pv(tiles - 1);
    sm90::wgmma_wait<0>();
    pin_pv();
    sm90::mbar_arrive(&empty[(tiles - 1) % kStages]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    if (item.w < 0) {
      // O = acc / l, LSE = m + log(l); an empty walk gives O = 0 (acc is
      // 0) and LSE = -1e30 exactly, as the loop that never ran in the TPU
      // kernel
      const float inv = li == 0.f ? 1.f : 1.f / li;
      bf16* row = o + (((size_t)b * S + qpos[i]) * N + h) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(row + n * 8 + 2 * tig) =
            pack(acc[4 * n + 2 * i] * inv, acc[4 * n + 2 * i + 1] * inv);
      if (tig == 0)
        lse[((size_t)b * N + h) * S + qpos[i]] =
            tiles == 0 ? kNegInf : m[i] * kLn2 + logf(li == 0.f ? 1.f : li);
    } else {
      const size_t r = ((size_t)item.w * gridDim.y + bh) * block + qpos[i] - item.x * block;
      float* part = ws + r * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(part + n * 8 + 2 * tig) =
            make_float2(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]);
      if (tig == 0) ws_ml[r] = make_float2(m[i], li);
    }
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const int* idx, const int4* items,
                 int n_items, const int* sums, int n_sums, float* ws, float2* ws_ml, void* o,
                 float* lse, int B, int S, int N, int block, int ldi, int causal,
                 float sm_scale, cudaStream_t stream) {
  using C = Fwd<D>;
  CUtensorMap tq, tk, tv;
  int err = sm90_host::make_map(&tq, q, B, S, N, D, 1, kWgRows);
  if (!err) err = sm90_host::make_map(&tk, k, B, S, N, D, 1, kKeys);
  if (!err) err = sm90_host::make_map(&tv, v, B, S, N, D, 1, kKeys);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(sparse_fwd_wgmma<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(n_items * (block / kWgRows), B * N);
  sparse_fwd_wgmma<D><<<grid, kWgThreads, C::kBytes, stream>>>(
      tq, tk, tv, idx, items, static_cast<bf16*>(o), lse, ws, ws_ml, S, N, block, ldi, causal,
      sm_scale);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return split_sum::launch_lse_merge(sums, n_sums, ws, ws_ml, o, lse, B, S, N, block, D,
                                     stream);
}

// dtype 0: the f32 CUDA-core kernel; 1: the bf16 wgmma kernel (then the
// second pass of its split rows)
template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, const int* idx, const int* cnt,
           const int4* items, int n_items, const int* sums, int n_sums, float* ws,
           float2* ws_ml, void* o, float* lse, int B, int S, int N, int block, int ldi,
           int causal, float sm_scale, cudaStream_t stream) {
  if (dtype == 1)
    return launch_wgmma<D>(q, k, v, idx, items, n_items, sums, n_sums, ws, ws_ml, o, lse, B, S,
                           N, block, ldi, causal, sm_scale, stream);
  dim3 grid(N, B, S / kRows);
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(sparse_fwd_f32<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sparse_fwd_f32<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      idx, cnt, static_cast<float*>(o), lse, S, N, block, ldi, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. idx: [S / block, ldi] int32 listed key
// blocks of each query block (-1 past cnt); cnt: [S / block] int32. block
// is 64 or 128 and divides S. bf16 only: items [n_items, 4] int32 (query
// block, first entry, entries, slot), sums [n_sums, 3] int32 (query block,
// first slot, pieces), and the f32 workspaces of the slots, ws [slots,
// B * N, block, D] and ws_ml [slots, B * N, block, 2] (null when nothing is
// split); the f32 kernel walks whole lists and reads none of them. Returns
// a cudaError_t value (0 = launched).
extern "C" int sparse_fwd(const void* q, const void* k, const void* v, const void* idx,
                          const void* cnt, const void* items, const void* sums, void* ws,
                          void* ws_ml, void* o, void* lse, int B, int S, int N, int D,
                          int block, int ldi, int n_items, int n_sums, int dtype, int causal,
                          float sm_scale, void* stream) {
  if (B < 1 || S < 1 || N < 1 || (block != 64 && block != 128) || S % block != 0 || ldi < 1 ||
      (dtype != 0 && dtype != 1) || (dtype == 1 && (n_items < 1 || n_sums < 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* idx_i = static_cast<const int*>(idx);
  const int* cnt_i = static_cast<const int*>(cnt);
  const int4* items_i = static_cast<const int4*>(items);
  const int* sums_i = static_cast<const int*>(sums);
  float* ws_f = static_cast<float*>(ws);
  float2* ml_f = static_cast<float2*>(ws_ml);
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(dtype, q, k, v, idx_i, cnt_i, items_i, n_items, sums_i, n_sums, ws_f, ml_f,
                      o, lse_f, B, S, N, block, ldi, causal, sm_scale, st);
  if (D == 128)
    return launch<128>(dtype, q, k, v, idx_i, cnt_i, items_i, n_items, sums_i, n_sums, ws_f,
                       ml_f, o, lse_f, B, S, N, block, ldi, causal, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
