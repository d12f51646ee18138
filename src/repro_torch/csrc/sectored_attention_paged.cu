// Paged sectored decode attention for Hopper (sm_90a): one kernel, two
// flavors (bf16 K/V, and int8 K/V with per-(sequence, page, kv-head) f32
// scales).
//
// Replaces the TPU kernel `_paged_kernel` of the JAX package
// (src/repro/kernels/sectored_attention.py, wrapper
// `sectored_attention_paged`). For each (batch b, kv-head h) it reads only
// the K selected KV pages named by page_idx[b, 0 if shared else h, :] of
// the page-major cache (B, P, page, Hkv, hd) and computes, for the `rep`
// query heads of that kv head:
//
//   s[r, c, p] = q[r] . K[c, p] / sqrt(hd)   (f32 accumulation)
//   s          = -1e30 where page*page_idx + p >= length[b]  (count mask)
//   m[r]       = max over (c, p) of s[r]     (one softmax over K x page)
//   e          = exp(s - m), 0 where masked
//   out[r]     = sum e' V / max(sum e, 1e-30)   e' = bf16(e) | e (int8)
//   mass[c]    = sum_{r, p} e / max(sum_{r, c, p} e, 1e-30)
//
// What bounds it on this card: bytes. One decode call at the yi-6b serving
// shapes (B=4, Hkv=4, K=5 pages of 128 x 128) moves about 4.75 MB of bf16
// K and V (int8: half) against ~42 MFLOP, far below the ~295 FLOP/byte
// ridge of an H100, so the kernel can only be as fast as its reads; at
// these sizes a launch and a few dependent memory latencies are the cost,
// so the design spends one launch and no round trip through global memory.
//
// Design: one launch, one thread-block cluster of C blocks per (b, h)
// (C chosen by the wrapper from K * page, at most 8, or 16 where shared
// memory needs it), no global scratch. The K * page token slots of a
// (b, h) are cut into C contiguous slices, one per block (every block gets
// at least one slot):
//   1. each block puts every valid K and V row of its slice in flight at
//      once (cp.async into shared memory; masked rows are zero-filled,
//      never read), then computes the scores of its valid tokens for the
//      `rep` query rows on the tensor cores (`mma` with bf16 operands: q
//      and K are bf16, or K is int8, which bf16 holds exactly, with its
//      scale applied to the f32 sum; the products are exact in f32),
//      masked scores -1e30, and its local row maxima;
//   2. the blocks exchange the maxima through distributed shared memory
//      after a cluster barrier, so every block holds the exact global row
//      max m before any e is formed, and the bf16 flavor rounds bf16(e)
//      exactly where the reference does;
//   3. each block forms e, its per-row and per-page sums of e, and its
//      partial e' V (rep x hd) in f32, all in shared memory: on the tensor
//      cores in the bf16 flavor (bf16(e) and bf16 V, exact products), on
//      the CUDA cores in f32 in the int8 flavor, which keeps e and the
//      dequantized V in f32;
//   4. after a second cluster barrier the partials are reduced over
//      distributed shared memory in rank order (each rank takes a share of
//      the outputs), divided by the row sums, and written; a last barrier
//      keeps every block's shared memory alive until all reads are done.
// The sums are added in a fixed order: deterministic, no atomics. What is
// left at these sizes is latency: two dependent trips to device memory
// (page indices, then K and V rows), three cluster barriers and the
// launch.
//
// Built without --use_fast_math: expf and IEEE division, like the plain
// PyTorch version it is checked against.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may use

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

__device__ __forceinline__ void load4(const int8_t* p, float (&x)[4]) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  x[0] = c.x;
  x[1] = c.y;
  x[2] = c.z;
  x[3] = c.w;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// C += A B on the tensor cores, one 16 x 8 x 16 tile: bf16 operands in
// `mma` fragments, f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the B fragments of a 16 x 8 tile of a row-major (k x n) bf16 matrix in
// shared memory: lane l gives the address of row l % 16 of the tile
template <typename T>
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& b0, uint32_t& b1,
                                              const T* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b0), "=r"(b1)
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(row))));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// Shape of one call, and the cluster plan the wrapper chose: C blocks per
// (b, h), block `rank` taking token slots [rank * chunk, (rank + 1) * chunk)
// of the K * page slots, cut at n.
struct Geometry {
  int Hkv, rep, hd, P, page, K, idx_heads, C, chunk;
  __host__ __device__ int n() const { return K * page; }
};

// shared memory of one block, in this order: K rows (T, padded by 16
// bytes) and V rows, each rounded up to 16 rows, then floats (q with rows
// padded by 4, scores with rows of chunk + 1, partial numerator, local and
// global row maxima, local and global row sums, page mass, per-slot column
// sums and K and V scales), then the per-slot cache rows (int)
template <typename T>
__host__ __device__ size_t smem_bytes(const Geometry& g) {
  const size_t floats = size_t(g.rep) * (2 * g.hd + 4) +
                        size_t(g.rep) * (g.chunk + 1) + 4 * size_t(g.rep) +
                        size_t(g.K) + 3 * size_t(g.chunk);
  // whole 16-row tiles of K and V, K's rows padded by 16 bytes
  const size_t rows16 = (size_t(g.chunk) + 15) & ~size_t(15);
  return rows16 * (2 * g.hd * sizeof(T) + 16) + 4 * floats +
         4 * size_t(g.chunk);
}

// The selected page of slot c for (b, h), or -1 when the index lies
// outside [0, P): such a page selects nothing, its tokens stay masked and
// are never read (the plain version raises on it).
__device__ __forceinline__ int selected_page(const int32_t* page_idx,
                                             const Geometry& g, int b, int h,
                                             int c) {
  const int hsel = g.idx_heads == 1 ? 0 : h;
  const int pg = page_idx[(size_t(b) * g.idx_heads + hsel) * g.K + c];
  return (pg >= 0 && pg < g.P) ? pg : -1;
}

template <typename T, bool kQuant>
__global__ void __launch_bounds__(kThreads) sectored_paged_cluster_kernel(
    const __nv_bfloat16* __restrict__ q,  // (B, Hkv, rep, hd)
    const T* __restrict__ k,              // (B, P, page, Hkv, hd)
    const T* __restrict__ v,              // (B, P, page, Hkv, hd)
    const float* __restrict__ k_scale,    // (B, P, Hkv), int8 flavor only
    const float* __restrict__ v_scale,    // (B, P, Hkv), int8 flavor only
    const int32_t* __restrict__ page_idx, // (B, idx_heads, K)
    const int32_t* __restrict__ length,   // (B,) count of valid tokens
    float* __restrict__ out,              // (B, Hkv, rep, hd)
    float* __restrict__ mass,             // (B, Hkv, K)
    Geometry g) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x / g.C;
  const int b = bh / g.Hkv;
  const int h = bh - b * g.Hkv;
  const int rep = g.rep, hd = g.hd, page = g.page;
  const int sp = g.chunk + 1;  // score row stride
  const int j0 = rank * g.chunk;
  const int nj = min(j0 + g.chunk, g.n()) - j0;  // this block's slots
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t tok_stride = size_t(g.Hkv) * hd;

  extern __shared__ float4 smem4[];
  // K and q rows are padded by 16 bytes (no bank conflicts); K and V
  // hold whole 16-row tiles, the rows past the slice zero-filled
  const int k_stride = hd + 16 / int(sizeof(T));
  const int qs = hd + 4;
  const int nj16 = (nj + 15) & ~15;
  const int rows16 = (g.chunk + 15) & ~15;
  T* k_s = reinterpret_cast<T*>(smem4);       // rows16 x k_stride
  T* v_s = k_s + size_t(rows16) * k_stride;   // rows16 x hd
  float* q_s = reinterpret_cast<float*>(v_s + size_t(rows16) * hd);
  float* s_s = q_s + rep * qs;                           // rep x sp
  float* acc_s = s_s + size_t(rep) * sp;                 // rep x hd
  float* m_s = acc_s + rep * hd;                         // rep, local
  float* gm_s = m_s + rep;                               // rep, global
  float* rsum_s = gm_s + rep;                            // rep, local
  float* den_s = rsum_s + rep;                           // rep, global
  float* mass_s = den_s + rep;                           // K
  float* colsum_s = mass_s + g.K;                        // chunk
  float* ksc_s = colsum_s + g.chunk;                     // chunk
  float* vsc_s = ksc_s + g.chunk;                        // chunk
  int* tok_s = reinterpret_cast<int*>(vsc_s + g.chunk);  // chunk

  // -- phase 1: the cache row of every slot (-1 when masked), then every
  // valid K and V row of the slice in flight at once, then the scores --
  for (int i = tid; i < rep * hd; i += kThreads)
    q_s[(i / hd) * qs + i % hd] =
        __bfloat162float(q[size_t(bh) * rep * hd + i]);
  const long long len = length[b];
  for (int t = tid; t < nj; t += kThreads) {
    const int j = j0 + t;
    const int c = j / page;
    const int pg = selected_page(page_idx, g, b, h, c);
    const int p = j - c * page;
    const bool valid = pg >= 0 && static_cast<long long>(pg) * page + p < len;
    tok_s[t] = valid ? (b * g.P + pg) * page + p : -1;
    if (kQuant) {
      const size_t sc = (size_t(b) * g.P + (valid ? pg : 0)) * g.Hkv + h;
      ksc_s[t] = valid ? k_scale[sc] : 0.f;
      vsc_s[t] = valid ? v_scale[sc] : 0.f;
    }
  }
  __syncthreads();

  // the valid rows of K or V of this slice into shared memory, in flight
  // as one commit group; half a warp a slot, a lane a 16-byte piece;
  // masked rows, and the rows up to the next multiple of 16, are
  // zero-filled and never read from the cache
  auto fetch_rows = [&](const T* src, T* dst_s, int stride) {
    constexpr int kElems = 16 / sizeof(T);  // elements per 16-byte copy
    const int cpr = hd / kElems;
    for (int t = 2 * warp + lane / 16; t < nj16; t += 2 * kWarps) {
      const int tok = t < nj ? tok_s[t] : -1;
      T* dst = dst_s + size_t(t) * stride;
      const T* row = src + size_t(tok < 0 ? 0 : tok) * tok_stride +
                     size_t(h) * hd;
      for (int c = lane % 16; c < cpr; c += 16) {
        if (tok >= 0)
          cp_async16(dst + c * kElems, row + c * kElems);
        else
          *reinterpret_cast<uint4*>(dst + c * kElems) = make_uint4(0, 0, 0,
                                                                  0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  fetch_rows(k, k_s, k_stride);
  fetch_rows(v, v_s, hd);
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // K has landed
  __syncthreads();

  const float root_hd = sqrtf(static_cast<float>(hd));
  const int g8 = lane >> 2;  // mma fragments: row (or column) group
  const int t4 = lane & 3;   // and the pair within it
  // scores on the tensor cores: S = Q K^T in 16 x 8 tiles, bf16 operands
  // (q is bf16; K is bf16, or int8, which bf16 holds exactly, its scale
  // applied to the sum), products exact in f32, summed in f32. A warp
  // takes two 8-slot tiles at a time, for two independent chains.
  auto k_pair = [&](int row, int d) -> uint32_t {
    const T* p = k_s + size_t(row) * k_stride + d;
    if constexpr (kQuant) {
      const char2 c = *reinterpret_cast<const char2*>(p);
      return pack_bf16(c.x, c.y);
    } else {
      return *reinterpret_cast<const uint32_t*>(p);
    }
  };
  for (int m0 = 0; m0 < rep; m0 += 16)
    for (int n0 = 8 * warp; n0 < nj; n0 += 16 * kWarps) {
      const int n1 = n0 + 8 * kWarps;  // the second tile, if any
      float c[2][4] = {};
#pragma unroll 2
      for (int d0 = 0; d0 < hd; d0 += 16) {
        uint32_t a[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int r = m0 + g8 + 8 * (u & 1);
          const float2 x =
              r < rep ? *reinterpret_cast<const float2*>(
                            q_s + r * qs + d0 + 2 * t4 + 8 * (u >> 1))
                      : make_float2(0.f, 0.f);
          a[u] = pack_bf16(x.x, x.y);
        }
        const int d = d0 + 2 * t4;
        mma_bf16(c[0], a, k_pair(n0 + g8, d), k_pair(n0 + g8, d + 8));
        if (n1 < nj)
          mma_bf16(c[1], a, k_pair(n1 + g8, d), k_pair(n1 + g8, d + 8));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int r = m0 + g8 + 8 * (u >> 1);
          const int t = (i ? n1 : n0) + 2 * t4 + (u & 1);
          if (r < rep && t < nj) {
            const float dot = kQuant ? c[i][u] * ksc_s[t] : c[i][u];
            s_s[r * sp + t] = tok_s[t] >= 0 ? dot / root_hd : kNegInf;
          }
        }
    }
  __syncthreads();
  for (int r = warp; r < rep; r += kWarps) {
    float mx = kNegInf;
    for (int t = lane; t < nj; t += 32) mx = fmaxf(mx, s_s[r * sp + t]);
    mx = warp_max(mx);
    if (lane == 0) m_s[r] = mx;
  }

  // -- the exact global row max, from every block's local maxima --
  cluster.sync();
  for (int r = tid; r < rep; r += kThreads) {
    float x[kMaxCluster];
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c)
      x[c] = c < g.C ? cluster.map_shared_rank(m_s, c)[r] : kNegInf;
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) mx = fmaxf(mx, x[c]);
    gm_s[r] = mx;
  }
  __syncthreads();

  // -- phase 2: e, its row and page sums, and the partial e' V --
  for (int r = 0; r < rep; ++r)
    for (int t = tid; t < nj; t += kThreads)
      s_s[r * sp + t] = tok_s[t] >= 0 ? expf(s_s[r * sp + t] - gm_s[r]) : 0.f;
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // V has landed
  __syncthreads();
  for (int r = warp; r < rep; r += kWarps) {
    float sum = 0.f;
    for (int t = lane; t < nj; t += 32) sum += s_s[r * sp + t];
    sum = warp_sum(sum);
    if (lane == 0) rsum_s[r] = sum;
  }
  for (int t = tid; t < nj; t += kThreads) {
    float sum = 0.f;
    for (int r = 0; r < rep; ++r) sum += s_s[r * sp + t];
    colsum_s[t] = sum;
  }
  __syncthreads();
  for (int c = warp; c < g.K; c += kWarps) {  // 0 outside this slice
    const int lo = max(c * page, j0) - j0;
    const int hi = min((c + 1) * page, j0 + nj) - j0;
    float sum = 0.f;
    for (int t = lo + lane; t < hi; t += 32) sum += colsum_s[t];
    sum = warp_sum(sum);
    if (lane == 0) mass_s[c] = sum;
  }

  if constexpr (!kQuant) {
    // e' V on the tensor cores in 16 x 8 tiles: e' = bf16(e), as the
    // reference's e.astype(v.dtype) (the sums above took e unrounded), and
    // bf16 V, so the products are exact in f32; a warp takes two 8-column
    // tiles at a time, for two independent chains
    for (int m0 = 0; m0 < rep; m0 += 16)
      for (int n0 = 8 * warp; n0 < hd; n0 += 16 * kWarps) {
        const int n1 = n0 + 8 * kWarps;  // the second tile, if any
        float c[2][4] = {};
#pragma unroll 2
        for (int k0 = 0; k0 < nj16; k0 += 16) {
          uint32_t a[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int r = m0 + g8 + 8 * (u & 1);
            const int t = k0 + 2 * t4 + 8 * (u >> 1);
            const float* er = s_s + r * sp + t;
            a[u] = pack_bf16(r < rep && t < nj ? er[0] : 0.f,
                             r < rep && t + 1 < nj ? er[1] : 0.f);
          }
          const T* vrow = v_s + size_t(k0 + (lane & 15)) * hd;
          uint32_t b0, b1;
          ldsm_x2_trans(b0, b1, vrow + n0);
          mma_bf16(c[0], a, b0, b1);
          if (n1 < hd) {
            ldsm_x2_trans(b0, b1, vrow + n1);
            mma_bf16(c[1], a, b0, b1);
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int r = m0 + g8 + 8 * (u >> 1);
            if (r < rep && (i == 0 || n1 < hd))
              acc_s[r * hd + (i ? n1 : n0) + 2 * t4 + (u & 1)] = c[i][u];
          }
      }
  } else {
    // int8: thread (r, qd) accumulates columns 4 qd ... 4 qd + 3 of row r
    // (and of r + rows_per_pass ...) in f32, e and the dequantized V in
    // f32 as the reference keeps them; slots t = 0, 1, 2, 3 mod 4 go to
    // four partial sums (instruction-level parallelism) added in a fixed
    // order; masked slots hold e = 0 and zero V rows
    const int quads = hd / 4;
    const int rows_per_pass = kThreads / quads;
    const int qd = tid % quads;
    if (tid / quads < rows_per_pass) {
      for (int r = tid / quads; r < rep; r += rows_per_pass) {
        float a[4][4] = {};
        const float* srow = s_s + r * sp;
        const T* vcol = v_s + 4 * qd;
        auto step = [&](int t, float (&acc)[4]) {
          float vv[4];
          load4(vcol + size_t(t) * hd, vv);
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[u] += srow[t] * (vv[u] * vsc_s[t]);
        };
        int t = 0;
        for (; t + 3 < nj; t += 4) {
#pragma unroll
          for (int j = 0; j < 4; ++j) step(t + j, a[j]);
        }
        for (; t < nj; ++t) step(t, a[0]);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          acc_s[r * hd + 4 * qd + u] =
              (a[0][u] + a[1][u]) + (a[2][u] + a[3][u]);
      }
    }
  }

  // -- reduce the C partials in rank order, each rank a share of them --
  cluster.sync();
  for (int r = tid; r < rep; r += kThreads) {
    float x[kMaxCluster];
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c)
      x[c] = c < g.C ? cluster.map_shared_rank(rsum_s, c)[r] : 0.f;
    float den = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c)
      if (c < g.C) den += x[c];
    den_s[r] = den;
  }
  __syncthreads();
  const int total = rep * hd;
  for (int i = rank * kThreads + tid; i < total; i += g.C * kThreads) {
    float x[kMaxCluster];
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c)
      x[c] = c < g.C ? cluster.map_shared_rank(acc_s, c)[i] : 0.f;
    float num = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c)
      if (c < g.C) num += x[c];
    out[size_t(bh) * total + i] = num / fmaxf(den_s[i / hd], 1e-30f);
  }
  for (int c = rank * kThreads + tid; c < g.K; c += g.C * kThreads) {
    float x[kMaxCluster];
#pragma unroll
    for (int q2 = 0; q2 < kMaxCluster; ++q2)
      x[q2] = q2 < g.C ? cluster.map_shared_rank(mass_s, q2)[c] : 0.f;
    float mc = 0.f, tot = 0.f;
#pragma unroll
    for (int q2 = 0; q2 < kMaxCluster; ++q2)
      if (q2 < g.C) mc += x[q2];
    for (int r = 0; r < rep; ++r) tot += den_s[r];
    mass[size_t(bh) * g.K + c] = mc / fmaxf(tot, 1e-30f);
  }
  cluster.sync();  // no block leaves while another reads its memory
}

template <typename T, bool kQuant>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* page_idx, const void* length,
           void* out, void* mass, int B, int Hkv, int rep, int hd, int P,
           int page, int K, int idx_heads, int C, int chunk, void* stream) {
  if (B * Hkv == 0) return 0;
  const Geometry g{Hkv, rep, hd, P, page, K, idx_heads, C, chunk};
  // the plan must give every block at least one slot, and cover all n
  // a cache row is an int (token index) in the kernel
  if (size_t(B) * P * page > size_t(INT_MAX)) return int(cudaErrorInvalidValue);
  if (hd > 256 || hd % 32 != 0 || rep < 1 || K < 1 || page < 1 || C < 1 ||
      C > kMaxCluster || chunk < 1 || (C - 1) * chunk >= g.n() ||
      size_t(C) * chunk < size_t(g.n()))
    return int(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<T>(g);
  if (smem > kMaxSmem) return int(cudaErrorInvalidValue);
  auto kernel = sectored_paged_cluster_kernel<T, kQuant>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  if (C > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return int(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * B * Hkv);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const __nv_bfloat16*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int32_t*>(page_idx),
      static_cast<const int32_t*>(length), static_cast<float*>(out),
      static_cast<float*>(mass), g);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // namespace

// q (B, Hkv, rep, hd) bf16; k, v (B, P, page, Hkv, hd); page_idx
// (B, idx_heads, K) int32; length (B,) int32; out (B, Hkv, rep, hd) f32;
// mass (B, Hkv, K) f32; every pointer 16-byte aligned. C blocks per
// (b, h) in one cluster, block r taking token slots [r chunk, (r+1) chunk).
// Returns a cudaError_t.
extern "C" int sectored_attention_paged_bf16(
    const void* q, const void* k, const void* v, const void* page_idx,
    const void* length, void* out, void* mass, int B, int Hkv, int rep,
    int hd, int P, int page, int K, int idx_heads, int C, int chunk,
    void* stream) {
  return launch<__nv_bfloat16, false>(q, k, v, nullptr, nullptr, page_idx,
                                      length, out, mass, B, Hkv, rep, hd, P,
                                      page, K, idx_heads, C, chunk, stream);
}

extern "C" int sectored_attention_paged_int8(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* page_idx, const void* length, void* out,
    void* mass, int B, int Hkv, int rep, int hd, int P, int page, int K,
    int idx_heads, int C, int chunk, void* stream) {
  return launch<int8_t, true>(q, k, v, k_scale, v_scale, page_idx, length,
                              out, mass, B, Hkv, rep, hd, P, page, K,
                              idx_heads, C, chunk, stream);
}
