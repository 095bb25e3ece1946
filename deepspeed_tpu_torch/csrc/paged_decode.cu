// Paged single-token decode attention for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/decode_attention.py, `_kernel` (:55), launched
// by `paged_decode_attention` (pallas_call at :172).
//
// Computes, for every serving slot s and query head h (kv head g = h / rep):
//   out[s, h] = softmax([q.K_pool rows < len[s] ; q.k_row]) @ [V_pool rows ; v_row]
// where the pool rows are read through block_tables[s, :ceil(len/bs)] (len
// clamped to the table's MB * bs rows), the
// fresh (k_row, v_row) of the token being decoded is NOT in the pool and is
// folded into the softmax last, and a len == 0 slot outputs exactly v_row.
// Rows at or past len (stale rows, the trash block 0) are never read.
//
// What bounds it on an H100: memory. Per call the kernel must read
// sum_s len[s] * Nkv * D * 2 (K and V) elements of the pool; it does about
// 4 * rep flops per element read, far below the ~295 flop/byte the card
// needs before its tensor cores would be the limit. The bound is that byte
// count over 3.35 TB/s. Two things kept the first design (one CTA per
// (kv head, slot), 8 warps loading 4 rows each before their math) at about
// 28 % of it: the longest slots set the time (at 16 slots of 0..2048 rows
// the three longest hold half the rows, and at GQA 64/8 the grid was 128
// CTAs on 132 SMs), and a warp's loads never overlapped its math.
//
// What the design does about it:
// - Split walks. Each slot's rows are cut into pieces of R rows, R a
//   multiple of bs (the host picks R = 256 rounded down to whole blocks,
//   `decode_pieces` in ops/decode_attention.py: 4 blocks of 64 at the
//   serving path's bs). The grid is (Nkv, S, P) with P = ceil(MB * bs /
//   R): fixed by the table, so it needs no host copy of the lengths and a
//   CUDA graph can capture it. A piece at or past the slot's length exits
//   at once and writes nothing (the merge reads only the pieces below
//   ceil(len / R)). At the serving shape a piece is at most 128 KB of K and
//   V, so no slot's length sets the time, and GQA 64/8 gives 8 x 16 x 8
//   CTAs, a few per SM, of which the ones with rows run.
// - A bulk-copy ring. A piece's rows are staged as tiles of at most 32
//   rows that never cross a pool block: a (block, kv head) tile [bs, D] is
//   contiguous in the [NB, Nkv, bs, D] pool, so each K (and V) tile is one
//   cp.async.bulk of rows * D * sizeof(T) bytes (rows are 128-512 bytes at
//   D 64 / 128, always whole 16-byte units, so no shape needs a staged
//   path). One producer warp (one lane works) keeps a ring of 4 stages in
//   flight, completion on an mbarrier; the 8 consumer warps free a stage on
//   a second mbarrier once they have read it. 64 KB of shared memory a CTA
//   at bf16 D=128, so 3 CTAs share an SM and 12 stages are in flight.
// - GQA-native on the CUDA cores. A CTA holds its slot's query-head group
//   [rep, D] in registers, so each pool row is read once for the group; at
//   rep 1 (llama-7b) the work is a GEMV a row, which tensor cores would not
//   speed up. A consumer warp takes 4 rows of a tile (lanes split D, one
//   vector load of shared memory each) and sums the batch's rep x 4 dot
//   products in one transposed warp reduction (rep x 4 - 1 + log2(32 /
//   (rep x 4)) shuffles, where a reduction a score took 5 each and bound
//   the kernel at GQA 64/8); the lanes holding a head's scores keep its
//   running max and sum, every lane keeps the acc of all heads over its
//   columns in f32, and the 8 warps' states are merged in shared memory at
//   the end of the piece.
// - A second pass. Each piece writes its f32 partials (acc [rep, D]
//   relative to its max m, m, l) to a workspace from the caching
//   allocator; `paged_decode_merge` then merges the pieces of each (slot,
//   kv head) in piece order by the log-sum-exp rule, folds the fresh row
//   last with the running max floored at M_FLOOR, and writes the output.
//   No atomics: a second launch gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;
// floor of the running max, as the TPU kernel: keeps exp(s - m) == 0 for
// masked scores
constexpr float kMFloor = -1e20f;
constexpr int kConsumerWarps = 8;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kRowsPerStep = 4;            // key rows a warp takes at once
constexpr int kTileRows = kConsumerWarps * kRowsPerStep;  // rows a stage holds
constexpr int kStages = 4;
constexpr int kMergeThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums V values across the warp in V - 1 + log2(32 / V) shuffles, not 5 V: at
// each of the first log2(V) steps a lane keeps half of its values and adds
// its partner's share of them, so lane l ends with value l / (32 / V),
// summed over the 32 / V lanes that hold it once the last steps add them.
template <int V>
__device__ __forceinline__ float transposed_sum(float (&x)[V], int lane) {
#pragma unroll
  for (int n = V, o = 16; n > 1; n >>= 1, o >>= 1) {
    const bool up = lane & o;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = up ? x[i] : x[i + n / 2];
      const float keep = up ? x[i + n / 2] : x[i];
      x[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  float v = x[0];
#pragma unroll
  for (int o = 16 / V; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// E consecutive elements at p (aligned to E * sizeof(T)) as floats, in one
// vector load
__device__ __forceinline__ void load_vec(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load_vec(const float* p, float (&o)[2]) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  o[0] = v.x; o[1] = v.y;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&o)[2]) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  o[0] = a.x; o[1] = a.y;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The tiles of a piece, rows [row, end) of a slot, in walk order: at most
// kTileRows rows each, never across a pool block. The producer and the
// consumers walk it alike.
struct TileWalk {
  int row, end, bs;
  __device__ __forceinline__ bool next(int& r0, int& n) {
    if (row >= end) return false;
    n = min(min(end, (row / bs + 1) * bs) - row, kTileRows);
    r0 = row;
    row += n;
    return true;
  }
};

// grid (Nkv, S, P), kThreads threads: warps 0-7 consume, warp 8 produces.
// Piece p of slot s walks rows [p R, min(p R + R, len)) of kv head g and
// writes its partials to ws[s][g][p] ([rep][D + 2] floats: acc over D,
// then m and l). MAXREP bounds rep (registers). The explicit minimum of
// one block an SM keeps ptxas from squeezing registers for occupancy: at
// bf16 D=64, rep 1 it held the kernel to 40 registers and spilled.
template <typename T, int D, int MAXREP>
__global__ void __launch_bounds__(kThreads, 1) paged_decode_split(
    const T* __restrict__ q, const T* __restrict__ k_pool, const T* __restrict__ v_pool,
    const int* __restrict__ tables, const int* __restrict__ lens, float* __restrict__ ws,
    int Nkv, int rep, int bs, int MB, int R, float sm_scale) {
  constexpr int E = D / 32;
  constexpr int kTile = kTileRows * D;  // elements of one K (or V) stage
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + kStages * 2 * kTile * sizeof(T));
  uint64_t* empty = full + kStages;

  const int g = blockIdx.x;
  const int s = blockIdx.y;
  const int p = blockIdx.z;
  // a slot past its table's capacity (a request that reached its budget
  // mid-quantum keeps counting) reads only its MB blocks, as the plain
  // version's gather over [S, MB] does
  const int len = min(lens[s], MB * bs);
  const int row0 = p * R;
  if (row0 >= len) return;  // past the slot's length: the merge never reads it
  const int row_end = min(row0 + R, len);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      sm90::mbar_init(&full[i], 1);                // the producer's one lane
      sm90::mbar_init(&empty[i], kConsumerWarps);  // one lane of each consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---- producer: one bulk copy each of a tile's K and V rows ----
    if (lane == 0) {
      const int* tab = tables + (size_t)s * MB;
      TileWalk walk{row0, row_end, bs};
      int r0, n;
      for (int t = 0; walk.next(r0, n); ++t) {
        const int st = t % kStages;
        sm90::mbar_wait(&empty[st], ((t / kStages) & 1) ^ 1);
        const size_t off = (((size_t)tab[r0 / bs] * Nkv + g) * bs + r0 % bs) * D;
        const uint32_t bytes = n * D * sizeof(T);
        T* stage = ring + st * 2 * kTile;
        sm90::mbar_arrive_tx(&full[st], 2 * bytes);
        sm90::bulk_load(stage, k_pool + off, bytes, &full[st]);
        sm90::bulk_load(stage + kTile, v_pool + off, bytes, &full[st]);
      }
    }
    return;
  }

  // ---- consumers: lane l owns columns [l E, l E + E) of every row ----
  const int Nq = Nkv * rep;
  float qr[MAXREP][E];  // the query group, pre-scaled
  const T* qg = q + ((size_t)s * Nq + (size_t)g * rep) * D + lane * E;
#pragma unroll
  for (int r = 0; r < MAXREP; ++r) {
    if (r < rep) {
      load_vec(qg + (size_t)r * D, qr[r]);
#pragma unroll
      for (int e = 0; e < E; ++e) qr[r][e] *= sm_scale;
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qr[r][e] = 0.f;
    }
  }
  float acc[MAXREP][E];
#pragma unroll
  for (int r = 0; r < MAXREP; ++r)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  // A batch's V = MAXREP x 4 scores (query head r, row u) leave the
  // transposed reduction with score r * 4 + u in lanes G (r * 4 + u) ..
  // + G - 1, G = 32 / V; this lane's: query head hr, row hu. It keeps the
  // running max of hr and its share of hr's l (its row's terms).
  constexpr int V = MAXREP * kRowsPerStep;
  constexpr int G = 32 / V;
  const int hr = lane / G / kRowsPerStep;
  const int hu = lane / G % kRowsPerStep;
  float m_h = kNegInf, l_h = 0.f;

  TileWalk walk{row0, row_end, bs};
  int r0, n;
  for (int t = 0; walk.next(r0, n); ++t) {
    const int st = t % kStages;
    sm90::mbar_wait(&full[st], (t / kStages) & 1);
    const T* Kt = ring + st * 2 * kTile + lane * E;
    const T* Vt = Kt + kTile;
    for (int b0 = warp * kRowsPerStep; b0 < n; b0 += kTileRows) {
      float kv[kRowsPerStep][E], vv[kRowsPerStep][E];
#pragma unroll
      for (int u = 0; u < kRowsPerStep; ++u) {
        if (b0 + u < n) {
          load_vec(Kt + (b0 + u) * D, kv[u]);
          load_vec(Vt + (b0 + u) * D, vv[u]);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) kv[u][e] = vv[u][e] = 0.f;
        }
      }
      float x[V];   // this lane's share of every score of the batch
#pragma unroll
      for (int r = 0; r < MAXREP; ++r) {
#pragma unroll
        for (int u = 0; u < kRowsPerStep; ++u) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) dot += qr[r][e] * kv[u][e];
          x[r * kRowsPerStep + u] = dot;
        }
      }
      const float s_all = transposed_sum(x, lane);   // every lane shuffles
      const float sc = b0 + hu < n ? s_all : kNegInf;
      // the online softmax of hr, over the batch's rows: its 4 scores sit
      // in lanes G apart
      float mx = fmaxf(sc, __shfl_xor_sync(0xffffffffu, sc, G));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2 * G));
      const float m_new = fmaxf(m_h, mx);
      const float c = expf(m_h - m_new);
      const float p = expf(sc - m_new);
      l_h = l_h * c + p;
      m_h = m_new;
      // acc of every head of the group, each lane over its columns, from
      // the rescale factor and the weights the owning lanes computed
#pragma unroll
      for (int r = 0; r < MAXREP; ++r) {
        if (r < rep) {
          const float cr = __shfl_sync(0xffffffffu, c, r * kRowsPerStep * G);
          float pr[kRowsPerStep];
#pragma unroll
          for (int u = 0; u < kRowsPerStep; ++u)
            pr[u] = __shfl_sync(0xffffffffu, p, (r * kRowsPerStep + u) * G);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            float a = acc[r][e] * cr;
#pragma unroll
            for (int u = 0; u < kRowsPerStep; ++u) a += pr[u] * vv[u][e];
            acc[r][e] = a;
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[st]);  // this warp has read the stage
  }

  // the piece's state: the 8 warps' merged in shared memory (the ring is
  // free once every consumer is past its last tile)
  l_h += __shfl_xor_sync(0xffffffffu, l_h, G);       // hr's l: its 4 rows' terms
  l_h += __shfl_xor_sync(0xffffffffu, l_h, 2 * G);
  sm90::named_sync(1, kConsumers);
  float* acc_sh = reinterpret_cast<float*>(smem_raw);  // [kConsumerWarps][MAXREP][D]
  float* m_sh = acc_sh + kConsumerWarps * MAXREP * D;   // [kConsumerWarps][MAXREP]
  float* l_sh = m_sh + kConsumerWarps * MAXREP;
#pragma unroll
  for (int r = 0; r < MAXREP; ++r) {
    if (r < rep) {
#pragma unroll
      for (int e = 0; e < E; ++e) acc_sh[(warp * MAXREP + r) * D + lane * E + e] = acc[r][e];
    }
  }
  if (hr < rep && lane % (kRowsPerStep * G) == 0) {
    m_sh[warp * MAXREP + hr] = m_h;
    l_sh[warp * MAXREP + hr] = l_h;
  }
  sm90::named_sync(1, kConsumers);
  float* part = ws + (((size_t)s * Nkv + g) * gridDim.z + p) * rep * (D + 2);
  for (int i = tid; i < rep * D; i += kConsumers) {
    const int r = i / D;
    const int d = i - r * D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kConsumerWarps; ++w) M = fmaxf(M, m_sh[w * MAXREP + r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kConsumerWarps; ++w) {
      const float f = expf(m_sh[w * MAXREP + r] - M);
      L += l_sh[w * MAXREP + r] * f;
      A += acc_sh[(w * MAXREP + r) * D + d] * f;
    }
    part[r * (D + 2) + d] = A;
    if (d == 0) {
      part[r * (D + 2) + D] = M;
      part[r * (D + 2) + D + 1] = L;
    }
  }
}

// grid (Nkv, S), kMergeThreads threads: the pieces of slot s, kv head g
// merged in piece order, then the fresh row folded last
template <typename T, int D>
__global__ void __launch_bounds__(kMergeThreads) paged_decode_merge(
    const T* __restrict__ q, const int* __restrict__ lens, const T* __restrict__ k_row,
    const T* __restrict__ v_row, const float* __restrict__ ws, T* __restrict__ out, int Nkv,
    int rep, int bs, int MB, int R, int P, float sm_scale) {
  constexpr int E = D / 32;
  __shared__ float s1_sh[8];
  const int g = blockIdx.x;
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int Nq = Nkv * rep;
  const int len = min(lens[s], MB * bs);
  const int pieces = (len + R - 1) / R;
  const size_t row_off = ((size_t)s * Nkv + g) * D;
  if (warp < rep) {  // the fresh row's score of query head g rep + warp
    float qv[E], kr[E];
    load_vec(q + ((size_t)s * Nq + (size_t)g * rep + warp) * D + lane * E, qv);
    load_vec(k_row + row_off + lane * E, kr);
    float dot = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) dot += qv[e] * sm_scale * kr[e];
    dot = warp_sum(dot);
    if (lane == 0) s1_sh[warp] = dot;
  }
  __syncthreads();
  const float* base = ws + ((size_t)s * Nkv + g) * P * rep * (D + 2);
  const size_t piece = (size_t)rep * (D + 2);
  for (int i = tid; i < rep * D; i += kMergeThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const float* part = base + r * (D + 2);
    float M = kNegInf;
    for (int p = 0; p < pieces; ++p) M = fmaxf(M, part[p * piece + D]);
    float L = 0.f, A = 0.f;
    for (int p = 0; p < pieces; ++p) {
      const float f = expf(part[p * piece + D] - M);
      L += part[p * piece + D + 1] * f;
      A += part[p * piece + d] * f;
    }
    const float s1 = s1_sh[r];
    const float m_new = fmaxf(fmaxf(M, s1), kMFloor);
    const float p1 = expf(s1 - m_new);
    const float alpha = expf(M - m_new);
    const float l_new = L * alpha + p1;
    const float o = A * alpha + p1 * to_f(v_row[row_off + d]);
    const float l_safe = l_new == 0.f ? 1.f : l_new;
    out[((size_t)s * Nq + (size_t)g * rep + r) * D + d] = from_f<T>(o / l_safe);
  }
}

template <typename T, int D, int MAXREP>
int launch(const void* q, const void* k_pool, const void* v_pool, const int* tables,
           const int* lens, const void* k_row, const void* v_row, float* ws, void* out, int S,
           int Nkv, int rep, int bs, int MB, int R, float sm_scale, cudaStream_t stream) {
  const int P = (MB * bs + R - 1) / R;
  const int smem = kStages * 2 * kTileRows * D * sizeof(T) + 2 * kStages * 8;
  cudaError_t e = cudaFuncSetAttribute(paged_decode_split<T, D, MAXREP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  paged_decode_split<T, D, MAXREP><<<dim3(Nkv, S, P), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      tables, lens, ws, Nkv, rep, bs, MB, R, sm_scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  paged_decode_merge<T, D><<<dim3(Nkv, S), kMergeThreads, 0, stream>>>(
      static_cast<const T*>(q), lens, static_cast<const T*>(k_row), static_cast<const T*>(v_row),
      ws, static_cast<T*>(out), Nkv, rep, bs, MB, R, P, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_rep(const void* q, const void* k_pool, const void* v_pool, const int* tables,
               const int* lens, const void* k_row, const void* v_row, float* ws, void* out,
               int S, int Nkv, int rep, int bs, int MB, int R, float sm_scale,
               cudaStream_t stream) {
  if (rep == 1)
    return launch<T, D, 1>(q, k_pool, v_pool, tables, lens, k_row, v_row, ws, out, S, Nkv, rep,
                           bs, MB, R, sm_scale, stream);
  if (rep == 2)
    return launch<T, D, 2>(q, k_pool, v_pool, tables, lens, k_row, v_row, ws, out, S, Nkv, rep,
                           bs, MB, R, sm_scale, stream);
  if (rep <= 4)
    return launch<T, D, 4>(q, k_pool, v_pool, tables, lens, k_row, v_row, ws, out, S, Nkv, rep,
                           bs, MB, R, sm_scale, stream);
  return launch<T, D, 8>(q, k_pool, v_pool, tables, lens, k_row, v_row, ws, out, S, Nkv, rep,
                         bs, MB, R, sm_scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Every pointer must be 16-byte aligned.
// R: rows a piece walks, a multiple of bs; ws: the f32 workspace of the
// pieces' partials, [S, Nkv, ceil(MB bs / R), rep, D + 2]. Two launches on
// `stream` (the pieces, then their merge). Returns a cudaError_t value
// (0 = launched).
extern "C" int paged_decode(const void* q, const void* k_pool, const void* v_pool,
                            const void* tables, const void* lens, const void* k_row,
                            const void* v_row, void* ws, void* out, int S, int Nq, int Nkv,
                            int D, int bs, int MB, int R, int dtype, float sm_scale,
                            void* stream) {
  if (S < 1 || Nkv < 1 || Nq % Nkv != 0 || Nq / Nkv > 8 || bs < 1 || MB < 1 || R < bs ||
      R % bs != 0 || (MB * bs + R - 1) / R > 65535 || S > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rep = Nq / Nkv;
  const int* tab = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lens);
  float* w = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_rep<float, 64>(q, k_pool, v_pool, tab, ln, k_row, v_row, w, out, S, Nkv, rep,
                                 bs, MB, R, sm_scale, st);
  if (dtype == 0 && D == 128)
    return launch_rep<float, 128>(q, k_pool, v_pool, tab, ln, k_row, v_row, w, out, S, Nkv,
                                  rep, bs, MB, R, sm_scale, st);
  if (dtype == 1 && D == 64)
    return launch_rep<__nv_bfloat16, 64>(q, k_pool, v_pool, tab, ln, k_row, v_row, w, out, S,
                                         Nkv, rep, bs, MB, R, sm_scale, st);
  if (dtype == 1 && D == 128)
    return launch_rep<__nv_bfloat16, 128>(q, k_pool, v_pool, tab, ln, k_row, v_row, w, out, S,
                                          Nkv, rep, bs, MB, R, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
