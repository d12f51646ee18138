// Blocked flash attention for Hopper (sm_90a), causal or not, f32 or bf16
// inputs, all arithmetic in f32.
//
// Replaces the TPU kernel `_kernel` of the JAX package
// (src/repro/kernels/flash_attention.py, wrapper `flash_attention`). For
// q, k, v of shape (B, H, S, hd) it computes, per (b, h) and query row i,
//
//   s[i, j] = (q[i] . k[j]) * (1 / sqrt(hd))    (f32)
//   s[i, j] = -1e30 where j > i                  (causal only)
//   out[i]  = sum_j p[i, j] v[j] / max(sum_j p[i, j], 1e-30)
//
// with p = exp(s - m) and the row max m found online, tile by tile, as the
// TPU kernel does: each new key tile rescales the running sum and output
// by alpha = exp(m_prev - m_new), and masked entries of p are set to 0.
// The result is written in the input type.
//
// What bounds it on this card: operations. At the yi-6b prefill shapes
// (H = 32, S = 2048, hd = 128) it does ~34 GFLOP causal against ~67 MB of
// bf16 inputs and output, far above the FLOP-per-byte ridge. This first
// kernel spends those operations as f32 FMAs on the CUDA cores (the f32
// peak, ~1/15 of the bf16 tensor-core peak): a right, simple kernel first;
// wgmma and TMA are later work.
//
// Design. The TPU kernel walks the key blocks of one (b*h, query block) in
// order, carrying m, l and acc in VMEM scratch from one grid step to the
// next. Here one block of 256 threads owns one (b*h, 64-row query tile)
// and walks the 64-row key tiles in ascending order in a loop, with m, l
// and acc in registers: thread (ty, tx) of a 16 x 16 grid owns query rows
// ty + 16 i (i < 4), the score columns tx + 16 j (j < 4) and the output
// columns tx + 16 j (j < hd / 16); the 16 threads of a row reduce its max
// and sum with shuffles inside a half warp. Q, K and V tiles are upcast to
// f32 in shared memory (rows of Q and K padded to hd + 1 words, so the
// 16 rows a warp reads at once fall in 16 banks). Under the causal mask a
// key tile wholly above the diagonal is skipped: after the first tile,
// every row has a finite max, so such a tile would give alpha = 1 and
// p = 0 and change nothing. The TPU's block shapes do not change the
// function, only the order of the float sums.
//
// Built without --use_fast_math: expf and IEEE division, like the plain
// PyTorch version it is checked against.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kTile = 64;      // query rows and key rows per tile
constexpr int kThreads = 256;  // a 16 x 16 grid
constexpr int kRowsPer = kTile / 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// max / sum over the 16 threads of one row (lanes tx = 0..15 of a half warp)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int HD>
constexpr size_t smem_floats() {
  // Q and K tiles (padded rows), the V tile, and the p tile (padded rows)
  return size_t(2) * kTile * (HD + 1) + size_t(kTile) * HD +
         size_t(kTile) * (kTile + 1);
}

// rows [row0, row0 + kTile) of a (S, HD) slab into a (kTile, stride) f32
// tile; rows at or past S read as 0
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const T* __restrict__ src,
                                          int row0, int S) {
  for (int i = threadIdx.x; i < kTile * HD; i += kThreads) {
    const int r = i / HD;
    const int d = i - r * HD;
    const int row = row0 + r;
    dst[r * stride + d] = row < S ? to_f32(src[size_t(row) * HD + d]) : 0.f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int S, int causal) {
  constexpr int kCols = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                        // kTile x (HD + 1)
  float* k_s = q_s + kTile * (HD + 1);      // kTile x (HD + 1)
  float* v_s = k_s + kTile * (HD + 1);      // kTile x HD
  float* p_s = v_s + kTile * HD;            // kTile x (kTile + 1)

  // blocks start in x-major order: the longest (causal) query tiles first
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * kTile;
  const size_t slab = size_t(blockIdx.x) * S * HD;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));

  load_tile<T, HD>(q_s, HD + 1, q + slab, q0, S);

  float m[kRowsPer], l[kRowsPer], acc[kRowsPer][kCols];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  const int n_kt = (S + kTile - 1) / kTile;
  const int last = causal ? min(qt, n_kt - 1) : n_kt - 1;
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, HD>(k_s, HD + 1, k + slab, k0, S);
    load_tile<T, HD>(v_s, HD, v + slab, k0, S);
    __syncthreads();

    float s[kRowsPer][kRowsPer];
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
      for (int j = 0; j < kRowsPer; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[kRowsPer], b[kRowsPer];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
        a[i] = q_s[(ty + 16 * i) * (HD + 1) + d];
        b[i] = k_s[(tx + 16 * i) * (HD + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
        for (int j = 0; j < kRowsPer; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const int qpos = q0 + ty + 16 * i;
      bool valid[kRowsPer];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kRowsPer; ++j) {
        const int kpos = k0 + tx + 16 * j;
        valid[j] = kpos < S && (!causal || kpos <= qpos);
        s[i][j] = valid[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kRowsPer; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        p_s[(ty + 16 * i) * (kTile + 1) + tx + 16 * j] = p;
        sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float vv[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) vv[j] = v_s[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
        const float p = p_s[(ty + 16 * i) * (kTile + 1) + c];
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      store(out + slab + size_t(row) * HD + tx + 16 * j, acc[i][j] / den);
  }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out,
              int BH, int S, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<HD>();
  auto kernel = flash_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(BH, (S + kTile - 1) / kTile);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, causal);
  return int(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int S, int hd, int causal, void* stream) {
  if (BH < 0 || S < 0 || (S + kTile - 1) / kTile > 65535)
    return int(cudaErrorInvalidValue);
  if (BH == 0 || S == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch_hd<T, 32>(q, k, v, out, BH, S, causal, st);
    case 64: return launch_hd<T, 64>(q, k, v, out, BH, S, causal, st);
    case 128: return launch_hd<T, 128>(q, k, v, out, BH, S, causal, st);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v, out: (B*H, S, hd) contiguous, hd in {32, 64, 128},
// S <= 65535 * 64.
// Returns a cudaError_t.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, int BH, int S,
                                   int hd, int causal, void* stream) {
  return launch<float>(q, k, v, out, BH, S, hd, causal, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int BH, int S,
                                    int hd, int causal, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, BH, S, hd, causal, stream);
}
