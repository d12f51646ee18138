// Sectored decode attention over the head-major KV layout for Hopper
// (sm_90a), f32 or bf16 inputs, all arithmetic in f32.
//
// Replaces the TPU kernel `_ref_kernel` of the JAX package
// (src/repro/kernels/sectored_attention.py, wrapper `sectored_attention`,
// bitwise target `kernels/ref.py:sectored_attention_ref`). For each
// (batch b, kv-head h) it reads only the K selected pages named by
// page_idx[b, 0 if shared else h, :] of the cache (B, Hkv, P, page, hd)
// and computes, for the `rep` query heads of that kv head:
//
//   s[r, c, p] = q[r] . K[c, p] / sqrt(hd)   (f32)
//   s          = -1e30 where page_idx*page + p >= length[b]  (count mask)
//   m[r]       = max over (c, p) of s[r]     (one softmax over K x page)
//   e          = exp(s - m), 0 where masked  (kept in f32)
//   out[r]     = sum e V / max(sum e, 1e-30)
//
// A duplicated page index is read, and counted, twice, as in the
// reference. A length of 0, or selected pages wholly past it, gives 0.
//
// What bounds it on this card: bytes. The decode shapes (B=4, Hkv=4, K=5
// pages of 128 x 128) read ~2.6 MB of bf16 K and V (f32: twice that)
// against ~42 MFLOP, far below the card's FLOP-per-byte ridge.
//
// Design: the one of csrc/sectored_attention_paged.cu (three launches
// over K * ceil(page / 32) blocks per (b, h) with an f32 global scratch:
// scores; values, where each block re-reduces the exact row max so all
// blocks form the same e; combine, adding the chunks' partial sums in a
// fixed order), with the head-major addressing of this layout, q and K/V
// in f32 or bf16 (upcast exactly on load), e contracted with V in f32
// (the reference does not round it), and no per-page mass. The paged
// source is left untouched so the serving path's kernel does not change.
//
// Built without --use_fast_math: expf and IEEE division, like the plain
// PyTorch version it is checked against.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kChunk = 32;  // tokens per block in passes 1 and 2
constexpr int kRows = 8;    // query rows a thread accumulates at once

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Geometry shared by the three passes and the wrapper's scratch size.
struct Geometry {
  int Hkv, rep, hd, P, page, K, idx_heads;
  __host__ __device__ int chunks_per_page() const {
    return (page + kChunk - 1) / kChunk;
  }
  __host__ __device__ int chunks() const { return K * chunks_per_page(); }
  __host__ __device__ int n() const { return K * page; }
  // f32 scratch of one (b, h): scores (rep, K*page), then the chunks'
  // partial numerators (chunks, rep, hd), then their row sums (chunks, rep)
  __host__ __device__ size_t scratch_per_bh() const {
    return size_t(rep) * n() + size_t(chunks()) * rep * hd +
           size_t(chunks()) * rep;
  }
};

// The selected page of slot c for block (b, h), or -1 when the index lies
// outside [0, P): such a page selects nothing, its tokens stay masked and
// are never read (the plain version raises on it).
__device__ __forceinline__ int selected_page(const int32_t* page_idx,
                                             const Geometry& g, int b, int h,
                                             int c) {
  const int hsel = g.idx_heads == 1 ? 0 : h;
  const int pg = page_idx[(size_t(b) * g.idx_heads + hsel) * g.K + c];
  return (pg >= 0 && pg < g.P) ? pg : -1;
}

// tokens [p0, end) of page pg hold valid positions (< len); p0 if none
__device__ __forceinline__ int valid_end(int pg, int p0, int p1, int page,
                                         long long len) {
  if (pg < 0) return p0;
  const long long fill = len - static_cast<long long>(pg) * page;
  if (fill <= p0) return p0;
  return fill < p1 ? static_cast<int>(fill) : p1;
}

// first element of page pg of head (b, h) in the (B, Hkv, P, page, hd) cache
__device__ __forceinline__ size_t page_base(const Geometry& g, int b, int h,
                                            int pg) {
  return ((size_t(b) * g.Hkv + h) * g.P + pg) * size_t(g.page) * g.hd;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) scores_kernel(
    const T* __restrict__ q,              // (B, Hkv, rep, hd)
    const T* __restrict__ k,              // (B, Hkv, P, page, hd)
    const int32_t* __restrict__ page_idx, // (B, idx_heads, K)
    const int32_t* __restrict__ length,   // (B,) count of valid tokens
    float* __restrict__ scratch, Geometry g) {
  extern __shared__ float q_s[];  // rep * hd
  const int b = blockIdx.x / g.Hkv;
  const int h = blockIdx.x - b * g.Hkv;
  const int cpp = g.chunks_per_page();
  const int c = blockIdx.y / cpp;
  const int p0 = (blockIdx.y - c * cpp) * kChunk;
  const int p1 = min(p0 + kChunk, g.page);
  const int rep = g.rep, hd = g.hd, n = g.n();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t bh = size_t(b) * g.Hkv + h;

  const int pg = selected_page(page_idx, g, b, h, c);
  const int pv = valid_end(pg, p0, p1, g.page, length[b]);
  float* s_bh = scratch + bh * g.scratch_per_bh();
  for (int i = threadIdx.x; i < rep * hd; i += blockDim.x)
    q_s[i] = to_f32(q[bh * rep * hd + i]);
  for (int i = threadIdx.x; i < rep * (p1 - pv); i += blockDim.x) {
    const int r = i / (p1 - pv);
    s_bh[size_t(r) * n + c * g.page + pv + (i - r * (p1 - pv))] = kNegInf;
  }
  __syncthreads();

  const float root_hd = sqrtf(static_cast<float>(hd));
  for (int p = p0 + warp; p < pv; p += nwarps) {
    const T* krow = k + page_base(g, b, h, pg) + size_t(p) * hd;
    for (int r0 = 0; r0 < rep; r0 += kRows) {
      float acc[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
#pragma unroll 4
      for (int d = lane; d < hd; d += 32) {
        const float kv = to_f32(krow[d]);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          if (r0 + i < rep) acc[i] += q_s[(r0 + i) * hd + d] * kv;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float s = warp_sum(acc[i]);
        if (lane == 0 && r0 + i < rep)
          s_bh[size_t(r0 + i) * n + c * g.page + p] = s / root_hd;
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) values_kernel(
    const T* __restrict__ v,              // (B, Hkv, P, page, hd)
    const int32_t* __restrict__ page_idx, // (B, idx_heads, K)
    const int32_t* __restrict__ length,   // (B,)
    float* __restrict__ scratch, Geometry g) {
  extern __shared__ float smem[];
  float* m_s = smem;         // rep
  float* e_s = m_s + g.rep;  // rep * kChunk
  const int b = blockIdx.x / g.Hkv;
  const int h = blockIdx.x - b * g.Hkv;
  const int cpp = g.chunks_per_page();
  const int chunk = blockIdx.y;
  const int c = chunk / cpp;
  const int p0 = (chunk - c * cpp) * kChunk;
  const int p1 = min(p0 + kChunk, g.page);
  const int rep = g.rep, hd = g.hd, n = g.n();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t bh = size_t(b) * g.Hkv + h;

  const int pg = selected_page(page_idx, g, b, h, c);
  const int pv = valid_end(pg, p0, p1, g.page, length[b]);
  const float* s_bh = scratch + bh * g.scratch_per_bh();
  float* num = scratch + bh * g.scratch_per_bh() + size_t(rep) * n +
               size_t(chunk) * rep * hd;
  float* rsum = scratch + bh * g.scratch_per_bh() + size_t(rep) * n +
                size_t(g.chunks()) * rep * hd + size_t(chunk) * rep;

  // row maxima over every selected token of this (b, h)
  for (int r = warp; r < rep; r += nwarps) {
    const float* srow = s_bh + size_t(r) * n;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, srow[j]);
    m = warp_max(m);
    if (lane == 0) m_s[r] = m;
  }
  __syncthreads();
  for (int i = tid; i < rep * kChunk; i += blockDim.x) {
    const int r = i / kChunk;
    const int p = p0 + (i - r * kChunk);
    e_s[i] = p < pv ? expf(s_bh[size_t(r) * n + c * g.page + p] - m_s[r])
                    : 0.f;
  }
  __syncthreads();
  for (int r = warp; r < rep; r += nwarps) {
    float part = 0.f;
    for (int t = lane; t < kChunk; t += 32) part += e_s[r * kChunk + t];
    part = warp_sum(part);
    if (lane == 0) rsum[r] = part;
  }

  // num[r, d] = sum over this chunk's valid tokens of e * V[:, d]
  const int groups = blockDim.x / hd;  // the wrapper keeps hd <= blockDim
  const int grp = tid / hd;
  const int d = tid - grp * hd;
  if (grp >= groups) return;
  const T* vcol = v + page_base(g, b, h, pg < 0 ? 0 : pg) + d;
  for (int rb = grp; rb < rep; rb += groups * kRows) {
    float acc[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
#pragma unroll 8
    for (int p = p0; p < pv; ++p) {
      const float vv = to_f32(vcol[size_t(p) * hd]);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = rb + i * groups;
        if (r < rep) acc[i] += e_s[r * kChunk + (p - p0)] * vv;
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = rb + i * groups;
      if (r < rep) num[size_t(r) * hd + d] = acc[i];
    }
  }
}

__global__ void __launch_bounds__(kThreads) combine_kernel(
    const float* __restrict__ scratch, float* __restrict__ out, Geometry g) {
  extern __shared__ float den_s[];  // rep
  const int rep = g.rep, hd = g.hd, chunks = g.chunks();
  const size_t bh = blockIdx.x;
  const float* num = scratch + bh * g.scratch_per_bh() + size_t(rep) * g.n();
  const float* rsum = num + size_t(chunks) * rep * hd;

  for (int r = threadIdx.x; r < rep; r += blockDim.x) {
    float den = 0.f;
    for (int j = 0; j < chunks; ++j) den += rsum[size_t(j) * rep + r];
    den_s[r] = den;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rep * hd; i += blockDim.x) {
    float acc = 0.f;
#pragma unroll 4
    for (int j = 0; j < chunks; ++j) acc += num[size_t(j) * rep * hd + i];
    out[bh * rep * hd + i] = acc / fmaxf(den_s[i / hd], 1e-30f);
  }
}

template <typename Fn>
cudaError_t allow_smem(Fn kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* page_idx,
           const void* length, void* out, void* scratch, int B, int Hkv,
           int rep, int hd, int P, int page, int K, int idx_heads,
           void* stream) {
  if (B * Hkv == 0) return 0;
  if (hd > kThreads || hd % 32 != 0 || rep < 1 || K < 1 || page < 1)
    return int(cudaErrorInvalidValue);
  const Geometry g{Hkv, rep, hd, P, page, K, idx_heads};
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* i32_idx = static_cast<const int32_t*>(page_idx);
  const auto* i32_len = static_cast<const int32_t*>(length);
  auto* f_scratch = static_cast<float*>(scratch);
  const dim3 grid(B * Hkv, g.chunks());

  auto scores = scores_kernel<T>;
  const size_t smem1 = sizeof(float) * size_t(rep) * hd;
  cudaError_t err = allow_smem(scores, smem1);
  if (err != cudaSuccess) return int(err);
  scores<<<grid, kThreads, smem1, st>>>(static_cast<const T*>(q),
                                        static_cast<const T*>(k), i32_idx,
                                        i32_len, f_scratch, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  auto values = values_kernel<T>;
  const size_t smem2 = sizeof(float) * size_t(rep) * (kChunk + 1);
  err = allow_smem(values, smem2);
  if (err != cudaSuccess) return int(err);
  values<<<grid, kThreads, smem2, st>>>(static_cast<const T*>(v), i32_idx,
                                        i32_len, f_scratch, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  const size_t smem3 = sizeof(float) * size_t(rep);
  err = allow_smem(combine_kernel, smem3);
  if (err != cudaSuccess) return int(err);
  combine_kernel<<<B * Hkv, kThreads, smem3, st>>>(
      f_scratch, static_cast<float*>(out), g);
  return int(cudaGetLastError());
}

}  // namespace

// f32 elements of the scratch buffer one call needs
extern "C" long long sectored_attention_scratch(int B, int Hkv, int rep,
                                                int hd, int page, int K) {
  const Geometry g{Hkv, rep, hd, 0, page, K, 1};
  return static_cast<long long>(size_t(B) * Hkv * g.scratch_per_bh());
}

extern "C" int sectored_attention_f32(
    const void* q, const void* k, const void* v, const void* page_idx,
    const void* length, void* out, void* scratch, int B, int Hkv, int rep,
    int hd, int P, int page, int K, int idx_heads, void* stream) {
  return launch<float>(q, k, v, page_idx, length, out, scratch, B, Hkv, rep,
                       hd, P, page, K, idx_heads, stream);
}

extern "C" int sectored_attention_bf16(
    const void* q, const void* k, const void* v, const void* page_idx,
    const void* length, void* out, void* scratch, int B, int Hkv, int rep,
    int hd, int P, int page, int K, int idx_heads, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, page_idx, length, out, scratch, B,
                               Hkv, rep, hd, P, page, K, idx_heads, stream);
}
