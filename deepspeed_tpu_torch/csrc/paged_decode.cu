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
// count over 3.35 TB/s.
//
// What the design does about it: one block per (kv head, slot) holds the
// whole query-head group [rep, D] in registers, so each K/V row of the pool
// is read from device memory exactly once for the group (GQA never repeats
// K/V), and only the valid rows of the valid blocks are visited; no
// gathered copy of the pool is ever written. A slot's rows are dealt out
// to the block's 8 warps four at a time, so a long sequence is read by 8
// warps in parallel (a slot's time is set by its length: splitting it is
// what keeps the longest slot off the critical path). A warp loads a key
// row with the lanes splitting D in one vector load each (one coalesced
// 2*D-byte read per row), issues the K and V loads of its four rows
// before any math, and keeps its own online softmax (m, l, acc) in f32
// registers. At the end the 8 warps' states are merged in shared memory
// and the fresh row is folded in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
// floor of the running max, as the TPU kernel: keeps exp(s - m) == 0 for
// masked scores
constexpr float kMFloor = -1e20f;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerStep = 4;  // key rows a warp loads before its math

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
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

// grid (Nkv, S), kThreads threads. Lane l of a warp owns columns
// [l*E, l*E + E) of every row it touches. MAXREP bounds rep (registers).
template <typename T, int D, int MAXREP>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool, const T* __restrict__ v_pool,
    const int* __restrict__ tables, const int* __restrict__ lens,
    const T* __restrict__ k_row, const T* __restrict__ v_row, T* __restrict__ out,
    int Nkv, int rep, int bs, int MB, float sm_scale) {
  constexpr int E = D / 32;
  const int g = blockIdx.x;
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int Nq = Nkv * rep;
  // a slot past its table's capacity (a request that reached its budget
  // mid-quantum keeps counting) reads only its MB blocks, as the plain
  // version's gather over [S, MB] does
  const int len = min(lens[s], MB * bs);

  __shared__ float acc_sh[kWarps][MAXREP][D];
  __shared__ float m_sh[kWarps][MAXREP];
  __shared__ float l_sh[kWarps][MAXREP];
  __shared__ float s1_sh[MAXREP];

  // the query group, pre-scaled, in registers
  float qr[MAXREP][E];
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
  float m[MAXREP], l[MAXREP], acc[MAXREP][E];
#pragma unroll
  for (int r = 0; r < MAXREP; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  const int* tab = tables + (size_t)s * MB;
  const size_t head_off = (size_t)g * bs * D + lane * E;
  const size_t block_stride = (size_t)Nkv * bs * D;
  for (int t0 = warp * kRowsPerStep; t0 < len; t0 += kWarps * kRowsPerStep) {
    float kv[kRowsPerStep][E], vv[kRowsPerStep][E];
#pragma unroll
    for (int u = 0; u < kRowsPerStep; ++u) {
      const int t = t0 + u;
      if (t < len) {
        const size_t off = (size_t)tab[t / bs] * block_stride + head_off +
                           (size_t)(t % bs) * D;
        load_vec(k_pool + off, kv[u]);
        load_vec(v_pool + off, vv[u]);
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) kv[u][e] = vv[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < MAXREP; ++r) {
      if (r < rep) {
        float sc[kRowsPerStep];
        float mx = m[r];
#pragma unroll
        for (int u = 0; u < kRowsPerStep; ++u) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) dot += qr[r][e] * kv[u][e];
          sc[u] = t0 + u < len ? warp_sum(dot) : kNegInf;
          mx = fmaxf(mx, sc[u]);
        }
        const float c = expf(m[r] - mx);
        float p[kRowsPerStep];
        float psum = 0.f;
#pragma unroll
        for (int u = 0; u < kRowsPerStep; ++u) {
          p[u] = expf(sc[u] - mx);
          psum += p[u];
        }
        l[r] = l[r] * c + psum;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          float a = acc[r][e] * c;
#pragma unroll
          for (int u = 0; u < kRowsPerStep; ++u) a += p[u] * vv[u][e];
          acc[r][e] = a;
        }
        m[r] = mx;
      }
    }
  }

  // merge the warps' softmax states; fold the fresh row last
#pragma unroll
  for (int r = 0; r < MAXREP; ++r) {
    if (r < rep) {
#pragma unroll
      for (int e = 0; e < E; ++e) acc_sh[warp][r][lane * E + e] = acc[r][e];
      if (lane == 0) {
        m_sh[warp][r] = m[r];
        l_sh[warp][r] = l[r];
      }
    }
  }
  const size_t row_off = ((size_t)s * Nkv + g) * D;
  if (warp == 0) {
    float kr[E];
    load_vec(k_row + row_off + lane * E, kr);
#pragma unroll
    for (int r = 0; r < MAXREP; ++r) {
      if (r < rep) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot += qr[r][e] * kr[e];
        dot = warp_sum(dot);
        if (lane == 0) s1_sh[r] = dot;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < rep * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, m_sh[w][r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(m_sh[w][r] - M);
      L += l_sh[w][r] * f;
      A += acc_sh[w][r][d] * f;
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
           const int* lens, const void* k_row, const void* v_row, void* out, int S, int Nkv,
           int rep, int bs, int MB, float sm_scale, cudaStream_t stream) {
  dim3 grid(Nkv, S);
  paged_decode_kernel<T, D, MAXREP><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      tables, lens, static_cast<const T*>(k_row), static_cast<const T*>(v_row),
      static_cast<T*>(out), Nkv, rep, bs, MB, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_rep(const void* q, const void* k_pool, const void* v_pool, const int* tables,
               const int* lens, const void* k_row, const void* v_row, void* out, int S,
               int Nkv, int rep, int bs, int MB, float sm_scale, cudaStream_t stream) {
  if (rep == 1)
    return launch<T, D, 1>(q, k_pool, v_pool, tables, lens, k_row, v_row, out, S, Nkv, rep,
                           bs, MB, sm_scale, stream);
  if (rep == 2)
    return launch<T, D, 2>(q, k_pool, v_pool, tables, lens, k_row, v_row, out, S, Nkv, rep,
                           bs, MB, sm_scale, stream);
  if (rep <= 4)
    return launch<T, D, 4>(q, k_pool, v_pool, tables, lens, k_row, v_row, out, S, Nkv, rep,
                           bs, MB, sm_scale, stream);
  return launch<T, D, 8>(q, k_pool, v_pool, tables, lens, k_row, v_row, out, S, Nkv, rep, bs,
                         MB, sm_scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Every pointer must be aligned to
// (D / 32) elements. Returns a cudaError_t value (0 = launched).
extern "C" int paged_decode(const void* q, const void* k_pool, const void* v_pool,
                            const void* tables, const void* lens, const void* k_row,
                            const void* v_row, void* out, int S, int Nq, int Nkv, int D,
                            int bs, int MB, int dtype, float sm_scale, void* stream) {
  if (S < 1 || Nkv < 1 || Nq % Nkv != 0 || Nq / Nkv > 8 || bs < 1 || MB < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rep = Nq / Nkv;
  const int* tab = static_cast<const int*>(tables);
  const int* ln = static_cast<const int*>(lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_rep<float, 64>(q, k_pool, v_pool, tab, ln, k_row, v_row, out, S, Nkv, rep,
                                 bs, MB, sm_scale, st);
  if (dtype == 0 && D == 128)
    return launch_rep<float, 128>(q, k_pool, v_pool, tab, ln, k_row, v_row, out, S, Nkv, rep,
                                  bs, MB, sm_scale, st);
  if (dtype == 1 && D == 64)
    return launch_rep<__nv_bfloat16, 64>(q, k_pool, v_pool, tab, ln, k_row, v_row, out, S,
                                         Nkv, rep, bs, MB, sm_scale, st);
  if (dtype == 1 && D == 128)
    return launch_rep<__nv_bfloat16, 128>(q, k_pool, v_pool, tab, ln, k_row, v_row, out, S,
                                          Nkv, rep, bs, MB, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
