// Flash attention forward for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/flash_attention.py, `_fwd_kernel` (:126) and
// `_fwd_kernel_nomask` (:177), launched by `_fwd` (pallas_call at :220).
//
// Computes GQA attention with an online softmax: for batch b, query head
// h (kv head g = h / rep) and query position i,
//   O[b, i, h]  = sum_j p_ij V[b, j, g] / sum_j p_ij,   p_ij = exp(s_ij - m_i)
//   LSE[b, h, i] = m_i + log(sum_j p_ij)
// over the keys j visible to i (j <= i when causal, kv_mask[b, j] != 0 when
// a key mask is given), with s_ij = sm_scale * q_i . k_j in f32. The running
// max is floored at M_FLOOR, so a fully masked row outputs 0 with LSE
// M_FLOOR, exactly as the TPU kernel does. Layout [B, S, N, D] for Q, K, V
// and O (the models' own layout, no transposes); LSE is [B, N, S] f32.
//
// What bounds it on an H100: operations. A causal call does
// 4 * B * Nq * D * S(S+1)/2 flops against 989 TF/s in bf16, and reads only
// (Q + K + V + O) bytes, so from a few hundred positions on the bound is
// the tensor-core rate. p enters the p V product as a bf16 hi + lo pair
// (f32-like precision, as the TPU kernel's f32 dot), so the tensor cores do
// 3 products of 2 * D flops per visible pair, not 2; and every score costs
// an exp and ~6 other instructions on the CUDA cores (scale, max, sum, the
// hi/lo split), which at D=64 is about as long as its share of the products.
//
// What the design does about it (bf16; helpers in sm90.cuh, as B2's).
// One block per (query tile, kv head, batch) holds 128 query rows, the
// whole query-head group of BQ = 128 / rep positions (32 at llama-1b's rep
// 4, 128 at rep 1), rows stacked by position then head (row = (pos - q0) *
// rep + head - g * rep), so one 4-D TMA box (64, rep, BQ) per 64-column
// panel loads them; Q stays resident in shared memory and each staged K/V
// tile serves all 128 rows. 384 threads in three warpgroups: a producer
// (one warp works; all four hand their registers to the others with
// setmaxnreg, 24 left) and two consumers of 64 rows (240 allowed). The
// producer streams the K and V tiles (128 keys each) up to the causal
// diagonal through a 3-stage ring (TMA, completion on an mbarrier; zeros
// past S), writing each tile's 128 key-mask bytes and a "tile has a masked
// key" flag; consumers free a stage on a second mbarrier. Each consumer
// warpgroup runs on wgmma (f32 accumulators):
//   S = Q K^T      m64n128k16, A = Q (resident, K-major), B = the K tile
//                  [keys][D] (K-major);
//   O += P V       m64nDk16, A = P from registers as bf16 hi + lo (the S
//                  accumulators are the A fragments), B = the V tile read
//                  MN-major through the descriptor: no transposed copy.
// The online softmax runs in registers on exp2 with sm_scale * log2(e)
// folded into one FMA; the running max m is kept in log2 units, and a row
// with l = 0 (every key masked) writes O = 0 and LSE = M_FLOOR directly.
// Each thread keeps a partial l over its own columns (the rescale factor is
// uniform across the 4 threads of a row), summed once at the end. The
// causal mask applies only to tiles that reach past the block's first
// position, the key mask only to flagged tiles, the S bound only to the
// tile that crosses it; rows past S are never written. Grid (Nkv * B,
// query tiles) with the query tile slowest, last tile first: under the
// causal mask the longest walks start first. O is written once in bf16,
// LSE once in f32; no atomics, so two launches give the same bits.
//
// Keeping the tensor cores fed: each consumer warpgroup issues S of tile
// t + 1 together with P V of tile t, then runs the softmax of tile t + 1
// while P V runs (the last step peeled off, so every wait retires a known
// wgmma group, and the operands of each batch pinned before its fence:
// without both, ptxas serialized the wgmmas); and the two warpgroups take
// turns to issue their batches (pingpong_*), so one's softmax also runs
// beside the other's products. On the H100, development builds with the
// softmax between the products (B2's pattern) ran slower at every shape
// timed. What bounds it now is the CUDA-core work of the softmax and the
// split (by the card's published rates, the exp alone, one MUFU op a
// score, needs about two thirds of the products' time at D=64) and, at
// the training shape's short walks (8.5 tiles a block on average), each
// block's fixed cost: the Q load, the first S and the last P V, which
// nothing overlaps.
//
// Tiles and resources: 128 query rows x 128 keys a step; shared memory
// 16 + 3 x 32 KB (D=64) or 32 + 3 x 64 KB (D=128), one block per SM;
// registers of a consumer thread: the S accumulators (64), the P halves
// of the tile before (64) and the O accumulators (D / 2), no spills. The
// f32 path (only the f32 cross-checks use it) runs as FMAs on the CUDA
// cores, 64 query rows x 32 keys a step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

using namespace mma_bf16;

constexpr float kNegInf = -1e30f;
constexpr float kMFloor = -1e20f;
constexpr int kThreads = 128;  // 16 row groups x 8 column groups
constexpr int kRows = 64;      // query rows per block (rep * BQ <= kRows)
constexpr int kBK = 32;        // keys per K/V tile
constexpr int kTM = kRows / 16;  // rows per thread
constexpr int kTN = kBK / 8;     // score columns per thread

template <int D>
constexpr int smem_floats() {
  return kRows * (D + 1) + kBK * (D + 1) + kBK * D + kRows * (kBK + 1);
}

// f32, on the CUDA cores (bf16 takes the tensor-core kernel below).
// grid (ceil(S / BQ), Nkv, B), kThreads threads. Row rho of the block is
// query head g*rep + rho / BQ at position q0 + rho % BQ (rows stacked by
// head, as the TPU kernel stacks them). Thread (ty, tx) owns rows
// ty*kTM .. ty*kTM+kTM-1, score columns tx + 8*j, and O columns tx + 8*c.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const uint8_t* __restrict__ kv_mask, float* __restrict__ o, float* __restrict__ lse,
    int S, int N, int Nkv, int rep, int BQ, int causal, float sm_scale) {
  constexpr int kTD = D / 8;  // O columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                    // [kRows][D + 1]
  float* Ks = Qs + kRows * (D + 1);    // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);      // [kBK][D]
  float* Ps = Vs + kBK * D;            // [kRows][kBK + 1]

  const int q0 = blockIdx.x * BQ;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;
  const int rows = rep * BQ;

  // stage the query group, pre-scaled; rows past the group or the sequence
  // are zero (their results are never written)
  for (int e = tid; e < kRows * D; e += kThreads) {
    const int rho = e / D;
    const int d = e - rho * D;
    const int pos = q0 + rho % BQ;
    float val = 0.f;
    if (rho < rows && pos < S) {
      const int head = g * rep + rho / BQ;
      val = q[(((size_t)b * S + pos) * N + head) * D + d] * sm_scale;
    }
    Qs[rho * (D + 1) + d] = val;
  }

  int qpos[kTM];
  float m[kTM], l[kTM], acc[kTM][kTD];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    qpos[i] = q0 + (ty * kTM + i) % BQ;
    m[i] = kNegInf;
    l[i] = 0.f;
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
      Vs[t * D + d] = vv;
    }
    __syncthreads();

    float sacc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) sacc[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[kTM], kv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) qv[i] = Qs[(ty * kTM + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < kTN; ++j) kv[j] = Ks[(tx + 8 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) sacc[i][j] += qv[i] * kv[j];
    }

    // mask: ragged edge, causal triangle, key-padding mask
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int kpos = k0 + tx + 8 * j;
      const bool key_ok = kpos < S && (kv_mask == nullptr || kv_mask[(size_t)b * S + kpos] != 0);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        if (!key_ok || (causal && kpos > qpos[i])) sacc[i][j] = kNegInf;
      }
    }

    // online softmax: a row's 8 column groups are 8 adjacent lanes
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      float mx = sacc[i][0];
#pragma unroll
      for (int j = 1; j < kTN; ++j) mx = fmaxf(mx, sacc[i][j]);
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(fmaxf(m[i], mx), kMFloor);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const float p = expf(sacc[i][j] - m_new);
        Ps[(ty * kTM + i) * (kBK + 1) + tx + 8 * j] = p;
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

    for (int t = 0; t < kBK; ++t) {
      float pv[kTM], vv[kTD];
#pragma unroll
      for (int i = 0; i < kTM; ++i) pv[i] = Ps[(ty * kTM + i) * (kBK + 1) + t];
#pragma unroll
      for (int c = 0; c < kTD; ++c) vv[c] = Vs[t * D + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int c = 0; c < kTD; ++c) acc[i][c] += pv[i] * vv[c];
    }
    __syncthreads();  // Ks, Vs and Ps are rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int rho = ty * kTM + i;
    if (rho >= rows || qpos[i] >= S) continue;
    const int head = g * rep + rho / BQ;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    const float inv = 1.f / l_safe;
    float* orow = o + (((size_t)b * S + qpos[i]) * N + head) * D;
#pragma unroll
    for (int c = 0; c < kTD; ++c) orow[tx + 8 * c] = acc[i][c] * inv;
    if (tx == 0) lse[((size_t)b * N + head) * S + qpos[i]] = m[i] + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma on TMA-fed tiles (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int kStages = 3;
constexpr int kBlockRows = 128;           // two consumer warpgroups of 64 rows
constexpr int kKeys = 128;                // keys per K/V tile
constexpr int kWgThreads = 384;           // producer warpgroup + 2 consumer warpgroups
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Fwd {
  static constexpr int P = D / 64;                  // 64-column panels
  static constexpr int kPanelQ = kBlockRows * 128;  // bytes of a Q panel
  static constexpr int kPanelK = kKeys * 128;       // bytes of a K/V panel
  static constexpr int kQ = P * kPanelQ;            // the Q rows
  static constexpr int kKV = P * kPanelK;           // one K (or V) tile
  static constexpr int kOffStage = kQ;
  static constexpr int kOffMask = kOffStage + kStages * 2 * kKV;  // [stage][kKeys] bytes
  static constexpr int kOffFlag = kOffMask + kStages * kKeys;     // [stage] int
  static constexpr int kOffBar = (kOffFlag + kStages * 4 + 7) & ~7;
  static constexpr int kBytes = kOffBar + (2 * kStages + 1) * 8 + 1024;  // + alignment
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = sm90::smem_u32(p);
  return p + (((a + 1023) & ~1023u) - a);
}

// grid (Nkv * B, ceil(S / BQ)), kWgThreads threads, BQ = 128 / rep
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1) flash_fwd_wgmma(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const uint8_t* __restrict__ kv_mask,
    bf16* __restrict__ o, float* __restrict__ lse, int S, int N, int Nkv, int rep, int BQ,
    int causal, float sm_scale) {
  using C = Fwd<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  unsigned char* Qs = sm;
  uint8_t* mask_s = sm + C::kOffMask;
  int* flag_s = reinterpret_cast<int*>(sm + C::kOffFlag);
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

  if (tid < 128) {
    // ---- producer warpgroup (its warp 0 works; all four give their
    // registers to the consumers): the Q rows once, then the K/V tiles ----
    sm90::setmaxnreg_dec<24>();
    if (tid >= 32) return;
    const int lane = tid;
    if (lane == 0) {
      sm90::prefetch_map(&tm_k);
      sm90::prefetch_map(&tm_v);
      sm90::mbar_arrive_tx(q_bar, rows * 128 * C::P);
#pragma unroll
      for (int p = 0; p < C::P; ++p)
        sm90::tma_load_4d(Qs + p * C::kPanelQ, &tm_q, q_bar, 64 * p, g * rep, q0, b);
    }
    for (int t = 0; t < tiles; ++t) {
      const int s = t % kStages;
      const int k0 = t * kKeys;
      sm90::mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
      if (kv_mask != nullptr) {
        // the tile's key mask (keys past S count as masked) and its flag
        bool bad = false;
#pragma unroll
        for (int i = 0; i < kKeys / 32; ++i) {
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

  // ---- consumer warpgroups: cw owns block rows 64 cw .. 64 cw + 63 ----
  sm90::setmaxnreg_inc<240>();
  const int cw = (tid >> 7) - 1;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const float c_scale = sm_scale * kLog2e;

  // this thread's accumulator rows: 16 warp + gid and + 8 of its warpgroup;
  // m in log2 units (scores times c_scale), l this thread's partial sum
  int qpos[2], head[2];
  bool rvalid[2];
  float m[2], l[2], alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rho = 64 * cw + 16 * warp + gid + 8 * i;
    qpos[i] = q0 + rho / rep;
    head[i] = g * rep + rho % rep;
    rvalid[i] = rho < rows && qpos[i] < S;
    m[i] = kMFloor;
    l[i] = 0.f;
  }
  float acc[D / 2];   // m64nD accumulator of O
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const unsigned char* Qw = Qs + cw * 64 * 128;

  float sacc[kKeys / 2];
  // S = Q K^T of tile t into sacc (k steps of 16 along D: 32 bytes a step
  // inside a 128-byte row, the next panel every 4 steps)
  auto issue_s = [&](int t) {
    const unsigned char* Ks = sm + C::kOffStage + (t % kStages) * 2 * C::kKV;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int offq = (kk >> 2) * C::kPanelQ + (kk & 3) * 32;
      const int offk = (kk >> 2) * C::kPanelK + (kk & 3) * 32;
      sm90::wgmma_ss_n128(sacc, sm90::desc_sw128(Qw + offq, 16, 1024),
                          sm90::desc_sw128(Ks + offk, 16, 1024), kk > 0);
    }
    sm90::wgmma_commit();
  };
  // One tile's scores (this thread's 64: rows 16 warp + gid and + 8 of its
  // warpgroup, columns 8 n + 2 tig (+ 1)) turned into p in place: scores
  // of invisible pairs to -inf, only on a tile that holds some (a flagged
  // key; causal and past the block's first position; past S), then the
  // online softmax; alpha gets each row's rescale factor for O
  auto softmax = [&](int t) {
    const int st = t % kStages;
    const int k0 = t * kKeys;
    const bool key_masked = kv_mask != nullptr && flag_s[st] != 0;
    const bool masked = key_masked || k0 + kKeys > S || (causal && k0 + kKeys - 1 > q0);
    const uint8_t* ms = mask_s + st * kKeys;
    const float kInf = __int_as_float(0x7f800000);
    if (masked) {
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + 2 * tig + (e & 1);
          const int kp = k0 + col;
          const bool ok = kp < S && !(causal && kp > qpos[e >> 1]) &&
                          (!key_masked || ms[col] != 0);
          if (!ok) sacc[4 * n + e] = -kInf;
        }
      }
    }
    // row maxima: two independent chains a row, then the quad's 4 threads
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
    // p = 2^(s c - m) in place; sums in two chains a row
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

  // Software pipeline, one turn on the tensor cores per step t: issue
  // S(t + 1) and O += P(t) V(t) together, then the softmax of tile t + 1
  // runs while P(t) V(t) does; O is rescaled once P(t) V(t) is done. The
  // last step is peeled off (no S to issue), so every wait retires a known
  // group, and the registers a batch reads are pinned before its fence:
  // otherwise ptxas serializes the wgmmas.
  uint32_t hi[kKeys / 16][4], lo[kKeys / 16][4];
  auto pin_pv = [&]() {     // the operands of O += P V: O and the P halves
    sm90::fence_regs<D / 2>(acc);
#pragma unroll
    for (int j = 0; j < kKeys / 16; ++j) {
      sm90::fence_regs<4>(hi[j]);
      sm90::fence_regs<4>(lo[j]);
    }
  };
  // O += P V: k steps of 16 keys (2048 bytes), N = D (the next 64 columns
  // one panel on: LBO)
  auto issue_pv = [&](int t) {
    const unsigned char* Vs = sm + C::kOffStage + (t % kStages) * 2 * C::kKV + C::kKV;
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
  auto split_p = [&]() {
#pragma unroll
    for (int j = 0; j < kKeys / 16; ++j)
      split_a(reinterpret_cast<const float(*)[4]>(sacc), j, hi[j], lo[j]);
  };

  sm90::mbar_wait(q_bar, 0);
  sm90::pingpong_start(cw);
  sm90::mbar_wait(&full[0], 0);
  sm90::pingpong_take(cw);
  sm90::fence_regs<kKeys / 2>(sacc);
  sm90::wgmma_fence();
  issue_s(0);
  sm90::pingpong_pass(cw);
  sm90::wgmma_wait<0>();
  sm90::fence_regs<kKeys / 2>(sacc);
  softmax(0);
  split_p();

  for (int t = 0; t + 1 < tiles; ++t) {
    sm90::mbar_wait(&full[(t + 1) % kStages], ((t + 1) / kStages) & 1);
    sm90::pingpong_take(cw);
    pin_pv();
    sm90::fence_regs<kKeys / 2>(sacc);
    sm90::wgmma_fence();
    issue_s(t + 1);
    issue_pv(t);
    sm90::pingpong_pass(cw);
    sm90::wgmma_wait<1>();                // S(t + 1) is done, P(t) V(t) runs on
    sm90::fence_regs<kKeys / 2>(sacc);
    softmax(t + 1);
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
  sm90::pingpong_take(cw);
  pin_pv();
  sm90::wgmma_fence();
  issue_pv(tiles - 1);
  sm90::pingpong_pass(cw);
  sm90::wgmma_wait<0>();
  pin_pv();
  sm90::mbar_arrive(&empty[(tiles - 1) % kStages]);
  sm90::pingpong_end(cw);

  // O = acc / l and LSE = m + log(l); a row with every key masked (l = 0)
  // gets O = 0 (acc is 0) and LSE = M_FLOOR exactly
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    if (!rvalid[i]) continue;
    const float inv = li == 0.f ? 1.f : 1.f / li;
    bf16* row = o + (((size_t)b * S + qpos[i]) * N + head[i]) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8 + 2 * tig) =
          pack(acc[4 * n + 2 * i] * inv, acc[4 * n + 2 * i + 1] * inv);
    if (tig == 0)
      lse[((size_t)b * N + head[i]) * S + qpos[i]] = li == 0.f ? kMFloor : m[i] * kLn2 + logf(li);
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const uint8_t* kv_mask, void* o,
                 float* lse, int B, int S, int N, int Nkv, int causal, float sm_scale,
                 cudaStream_t stream) {
  const int rep = N / Nkv;
  const int BQ = kBlockRows / rep;
  if ((S + BQ - 1) / BQ > 65535) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  int err = sm90_host::make_map(&tq, q, B, S, N, D, rep, BQ);
  if (!err) err = sm90_host::make_map(&tk, k, B, S, Nkv, D, 1, kKeys);
  if (!err) err = sm90_host::make_map(&tv, v, B, S, Nkv, D, 1, kKeys);
  if (err) return err;
  const int smem = Fwd<D>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_wgmma<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(Nkv * B, (S + BQ - 1) / BQ);
  flash_fwd_wgmma<D><<<grid, kWgThreads, smem, stream>>>(
      tq, tk, tv, kv_mask, static_cast<bf16*>(o), lse, S, N, Nkv, rep, BQ, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

// dtype 0: the f32 CUDA-core kernel; 1: the bf16 wgmma kernel
template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, const uint8_t* kv_mask, void* o,
           float* lse, int B, int S, int N, int Nkv, int causal, float sm_scale,
           cudaStream_t stream) {
  if (dtype == 1)
    return launch_wgmma<D>(q, k, v, kv_mask, o, lse, B, S, N, Nkv, causal, sm_scale, stream);
  const int rep = N / Nkv;
  const int BQ = kRows / rep;
  dim3 grid((S + BQ - 1) / BQ, Nkv, B);
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_f32<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      kv_mask, static_cast<float*>(o), lse, S, N, Nkv, rep, BQ, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. kv_mask: null or [B, S] uint8 (nonzero
// = key visible). Returns a cudaError_t value (0 = launched).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* kv_mask,
                         void* o, void* lse, int B, int S, int N, int Nkv, int D, int dtype,
                         int causal, float sm_scale, void* stream) {
  if (B < 1 || S < 1 || Nkv < 1 || N % Nkv != 0 || N / Nkv > kRows ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint8_t* mask = static_cast<const uint8_t*>(kv_mask);
  float* lse_f = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(dtype, q, k, v, mask, o, lse_f, B, S, N, Nkv, causal, sm_scale, st);
  if (D == 128)
    return launch<128>(dtype, q, k, v, mask, o, lse_f, B, S, N, Nkv, causal, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
