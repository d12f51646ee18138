// Blocked flash attention for Hopper (sm_90a), causal or not, f32 or bf16
// inputs, softmax statistics and p in f32.
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
// Under the causal mask a key tile wholly above the diagonal is skipped:
// after the first tile every row has a finite max, so such a tile would
// give alpha = 1 and p = 0 and change nothing. Blocks start with the
// longest (causal) query tiles. The result is written in the input type.
//
// What bounds it on this card: operations. At the yi-6b prefill shapes
// (H = 32, S = 2048, hd = 128) it does ~34 GFLOP causal against ~67 MB of
// bf16 inputs and output, far above the FLOP-per-byte ridge. The two
// flavors spend those operations on different units:
//
// bf16: the tensor cores, through `wgmma`. A block owns 128 query rows:
// two warpgroups of 64 rows each, sharing 128-key tiles that thread 0
// loads with TMA (Q once, K and V in two stages each, mbarriers for full
// and empty stages; no block-wide barrier in the key loop, so the
// warpgroups drift apart and one's softmax overlaps the other's
// products). Q, K and V stay bf16 in shared memory in the swizzled layout
// `wgmma` reads (128-byte rows, 64-byte rows at hd = 32; TMA writes it). S = Q K^T is `wgmma` with both operands in shared memory and f32
// accumulation: products of bf16 values are exact in f32, so S differs
// from the reference's f32 math only in the order of the sums. The
// reference keeps p in f32 for P V, so p is split in registers into
// hi = bf16(p) and lo = bf16(p - hi), and P V is the two products
// hi V + lo V (A from registers, V from shared memory, f32 accumulation):
// the part of p left out is ~2^-17 of it, and P V costs twice the tensor
// work of a bf16 p. The online softmax runs on the accumulator fragments
// in registers (a row lives in the four threads of a quad), in the log2
// domain: p = ex2.approx(s * log2(e) / sqrt(hd) - m), one fused
// multiply-add and one special-function op a score, whose 2-ulp error is
// far below the bf16 output's; only tiles that cross the diagonal or S
// compute the mask. The key loop is software-pipelined: S of the next tile
// and P V of this one are issued back to back, and the next tile's softmax
// runs while P V is in flight.
//
// f32: the CUDA cores, exact f32 products (no TF32, whose 10-bit mantissa
// the 2e-5 tolerance does not allow). A block of 256 threads owns 128
// query rows and walks 128-key tiles; thread (ty, tx) of a 16 x 16 grid
// owns rows ty + 16 i and keys tx + 16 j (i, j < 8), an 8 x 8 micro-tile
// of S, and rows ty + 16 i of the output at hd / 16 columns. Q and K rows
// are staged padded to hd + 4 floats, so one float4 read serves 4 steps
// of the dot product and the 16 rows a warp reads fall in distinct banks:
// 16 shared loads feed 256 FMAs of S, and 16 loads (p as float4 along the
// keys, V as float4 along the row) feed 32 * hd / 16 FMAs of P V. P is
// staged over K's buffer once S is done.
//
// Built without --use_fast_math: IEEE division like the plain PyTorch
// version it is checked against; the exponentials are exp2 of scores
// scaled by log2(e) (a few ulps, far inside both flavors' tolerances).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// bf16 flavor: wgmma
// ---------------------------------------------------------------------------
namespace wg {

constexpr int kWGs = 2;           // consumer warpgroups, 64 rows each
constexpr int kRows = 64 * kWGs;  // query rows per block
constexpr int kKeys = 128;        // keys per tile
constexpr int kThreads = 128 * kWGs;

// Shared-memory layout of a (rows x HD) bf16 tile as `wgmma` reads it and
// TMA writes it: column blocks of kColElems values (one TMA box each),
// each block rows x kRowBytes bytes, row-major inside; the 16-byte chunks
// of a row are permuted by the hardware's swizzle (byte-address bits
// [4, 7) ^= bits [7, 10) for 128-byte rows, bits [4, 6) ^= bits [7, 9) for
// 64-byte rows), so a tile must start at a multiple of 1024 bytes.
template <int HD>
struct Layout {
  static constexpr int kRowBytes = HD >= 64 ? 128 : 64;
  static constexpr int kColElems = kRowBytes / 2;
  static constexpr int kColBlocks = HD / kColElems;
  // descriptor swizzle mode: 1 = 128-byte, 2 = 64-byte
  static constexpr uint64_t kMode = kRowBytes == 128 ? 1 : 2;

  // `wgmma` matrix descriptor: start address, leading byte offset (for an
  // MN-major operand, the stride between column blocks along N; unused for
  // a K-major one), stride byte offset (8-row groups), swizzle mode
  __device__ static uint64_t desc(uint32_t addr, uint32_t lead) {
    constexpr uint64_t kGroup = (8 * kRowBytes) >> 4;
    return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lead >> 4) << 16) |
           (kGroup << 32) | (kMode << 62);
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// registers a `wgmma` writes or reads asynchronously: keep the compiler
// from moving their uses across the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D (+)= A . B, A and B from shared memory, both K-major: N = 128
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D += A . B, A from registers, B from shared memory, MN-major: N = 64,
// 32, 128 (N = hd)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x by the special-function unit (ex2.approx: 2 ulp; results below
// 2^-126 flush to 0, as p underflows there anyway)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// S = Q K^T for one key tile, over hd in steps of 16 (column block, then
// 32 bytes within it); issued, not waited for
template <int HD>
__device__ __forceinline__ void issue_qk(float (&s)[kKeys / 2],
                                         uint32_t q_s, uint32_t kb) {
  using L = Layout<HD>;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const uint32_t cb = ks * 16 / L::kColElems;
    const uint32_t in_row = (ks * 16 % L::kColElems) * 2;
    wgmma_ss(s, L::desc(q_s + cb * kRows * L::kRowBytes + in_row, 0),
             L::desc(kb + cb * kKeys * L::kRowBytes + in_row, 0), ks > 0);
  }
}

// O += hi V + lo V over one key tile, in steps of 16 keys; issued, not
// waited for
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         const uint32_t (&hi)[kKeys / 16][4],
                                         const uint32_t (&lo)[kKeys / 16][4],
                                         uint32_t vb) {
  using L = Layout<HD>;
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    // N = hd in one instruction: column blocks kKeys rows apart
    const uint64_t dv =
        L::desc(vb + kk * 16 * L::kRowBytes, kKeys * L::kRowBytes);
    wgmma_rs(o, hi[kk], dv);
    wgmma_rs(o, lo[kk], dv);
  }
}

// Online softmax of one S tile held as accumulator fragments, in the log2
// domain (`scale` is log2(e) / sqrt(hd), m is kept scaled): this thread's
// rows row0 and row0 + 8; fragment i holds column 8 (i / 4) + col0 + i % 2
// of row half (i / 2) % 2. Leaves p in s and each row's rescale factor in
// alpha.
template <bool kMask>
__device__ __forceinline__ void softmax_tile(float (&s)[kKeys / 2], int k0,
                                             int row0, int col0, int S,
                                             int causal, float scale,
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    bool valid[kKeys / 4];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeys / 4; ++j) {
      const int i = 4 * (j / 2) + 2 * h + j % 2;
      const int key = k0 + 8 * (j / 2) + col0 + j % 2;
      valid[j] = !kMask || (key < S && (!causal || key <= row));
      if (valid[j]) mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // the scale is positive: the max of the scaled scores is the scaled
    // max, and each p is one fused multiply-add and one exp2
    const float m_new = fmaxf(m[h], mx * scale);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys / 4; ++j) {
      const int i = 4 * (j / 2) + 2 * h + j % 2;
      s[i] = valid[j] ? exp2_ftz(fmaf(s[i], scale, -m_new)) : 0.f;
      sum += s[i];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    alpha[h] = exp2_ftz(m[h] - m_new);
    l[h] = l[h] * alpha[h] + sum;
    m[h] = m_new;
  }
}

// p = hi + lo in bf16 pairs, laid out as `wgmma`'s A fragments: the 16 keys
// of step kk are accumulator columns 16 kk ... 16 kk + 15
__device__ __forceinline__ void split_p(const float (&s)[kKeys / 2],
                                        uint32_t (&hi)[kKeys / 16][4],
                                        uint32_t (&lo)[kKeys / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float a = s[8 * kk + 2 * r];
      const float b = s[8 * kk + 2 * r + 1];
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(a, b);
      const float2 hf = __bfloat1622float2(h2);
      hi[kk][r] = bits(h2);
      lo[kk][r] = bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
    }
}

// mbarriers: init, arrive, arrive with expected transaction bytes, wait
// for the phase of a given parity to complete
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
// (a wait that never ends is a fault: after ~2^28 polls, seconds, the
// kernel traps instead of hanging the card)
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one box of a (BH, S, HD) bf16 tensor map into shared memory: columns
// [c0, c0 + box), rows [row, row + box rows) of slab bh; rows past S read
// as 0; completion is counted on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int row,
                                         int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(row),
      "r"(bh)
      : "memory");
}

// A block of kWGs warpgroups, 64 query rows each, sharing the K and V
// tiles. Thread 0 loads Q once and K and V tile by tile with TMA into two
// stages each: at the top of its iteration j it issues V of tile j + 1 and
// K of tile j + 2. Full barriers count the TMA bytes; empty barriers count
// one arrival per warpgroup once its `wgmma` reads of a stage are done.
// Iteration kt issues S for key tile kt + 1 and P V for tile kt back to
// back, runs the softmax of tile kt + 1 while P V is in flight, then
// rescales O. No block-wide barrier in the loop: the warpgroups drift
// apart (by up to an iteration), and one's softmax overlaps the other's
// products. (All 256 threads compute, so each may hold 255 registers.)
template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_bf16_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
    int S, int causal) {
  using L = Layout<HD>;
  constexpr int kTileBytes = kKeys * HD * 2;
  constexpr int kNB = L::kColBlocks;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t k_s = q_s + kRows * HD * 2;  // two stages
  const uint32_t v_s = k_s + 2 * kTileBytes;  // two stages
  // barriers: q_full, k_full[2], v_full[2], k_empty[2], v_empty[2]
  const uint32_t bars = v_s + 2 * kTileBytes;
  const uint32_t q_full = bars;
  auto k_full = [&](int st) { return bars + 8 * (1 + st); };
  auto v_full = [&](int st) { return bars + 8 * (3 + st); };
  auto k_empty = [&](int st) { return bars + 8 * (5 + st); };
  auto v_empty = [&](int st) { return bars + 8 * (7 + st); };

  // blocks start in x-major order: the longest (causal) query tiles first
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * kRows;
  const int bh = blockIdx.x;
  const int n_kt = (S + kKeys - 1) / kKeys;
  // the block loads key tiles up to `last`
  const int last =
      causal ? min((q0 + kRows - 1) / kKeys, n_kt - 1) : n_kt - 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < 2; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), kWGs);
      mbar_init(v_empty(st), kWGs);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the loads, by thread 0; tile t goes to stage t & 1 once both
  // warpgroups released tile t - 2 from it
  auto load = [&](const CUtensorMap* map, uint32_t dst, uint32_t full,
                  uint32_t empty, int t) {
    if (t > last) return;
    mbar_wait(empty, ((t >> 1) & 1) ^ 1);  // first use: no wait
    mbar_expect_tx(full, kTileBytes);
    for (int cb = 0; cb < kNB; ++cb)
      tma_load(dst + (t & 1) * kTileBytes + cb * kKeys * L::kRowBytes, map,
               full, cb * L::kColElems, t * kKeys, bh);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_full, kRows * HD * 2);
    for (int cb = 0; cb < kNB; ++cb)
      tma_load(q_s + cb * kRows * L::kRowBytes, &tq, q_full,
               cb * L::kColElems, q0, bh);
    load(&tk, k_s, k_full(0), k_empty(0), 0);
    load(&tv, v_s, v_full(0), v_empty(0), 0);
    load(&tk, k_s, k_full(1), k_empty(1), 1);
  }

  const int wgi = threadIdx.x / 128;  // warpgroup: rows q0 + 64 wgi ...
  const bool leader = threadIdx.x % 128 == 0;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  // accumulator fragments: this thread holds rows row0 and row0 + 8, and
  // in every 8-column block the columns col0 and col0 + 1
  const int wg_row0 = q0 + 64 * wgi;
  const int row0 = wg_row0 + 16 * warp + lane / 4;
  const int col0 = 2 * (lane % 4);
  const float scale = kLog2e / sqrtf(static_cast<float>(HD));
  const uint32_t q_wg = q_s + 64 * wgi * L::kRowBytes;
  // this warpgroup computes key tiles up to `mine` (under the causal
  // mask, tiles wholly above its diagonal are skipped)
  const int mine = causal ? min((wg_row0 + 63) / kKeys, n_kt - 1) : n_kt - 1;
  // a key tile needs the mask where it crosses the diagonal or S
  auto masked = [&](int kt) {
    return (kt + 1) * kKeys > S || (causal && (kt + 1) * kKeys - 1 > wg_row0);
  };

  float o[HD / 2];  // the output row fragments, N = hd
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float alpha[2];
  float s[kKeys / 2];
#pragma unroll
  for (int i = 0; i < kKeys / 2; ++i) s[i] = 0.f;
  uint32_t hi[kKeys / 16][4], lo[kKeys / 16][4];

  mbar_wait(q_full, 0);
  mbar_wait(k_full(0), 0);
  wgmma_fence();
  issue_qk<HD>(s, q_wg, k_s);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  if (leader) mbar_arrive(k_empty(0));
  if (masked(0))
    softmax_tile<true>(s, 0, row0, col0, S, causal, scale, m, l, alpha);
  else
    softmax_tile<false>(s, 0, row0, col0, S, causal, scale, m, l, alpha);
  split_p(s, hi, lo);

  for (int kt = 0; kt <= mine; ++kt) {
    const int st = kt & 1;
    const bool next = kt < mine;
    if (threadIdx.x == 0) {
      load(&tv, v_s, v_full(st ^ 1), v_empty(st ^ 1), kt + 1);
      load(&tk, k_s, k_full(st), k_empty(st), kt + 2);
    }
    if (next) mbar_wait(k_full(st ^ 1), ((kt + 1) >> 1) & 1);
    mbar_wait(v_full(st), (kt >> 1) & 1);
    wgmma_fence();
    if (next) issue_qk<HD>(s, q_wg, k_s + (st ^ 1) * kTileBytes);
    wgmma_commit();
    issue_pv<HD>(o, hi, lo, v_s + st * kTileBytes);
    wgmma_commit();

    if (next) {
      wgmma_wait<1>();  // S of tile kt + 1; P V of tile kt still runs
      fence_regs(s);
      if (leader) mbar_arrive(k_empty(st ^ 1));
      const int k0 = (kt + 1) * kKeys;
      if (masked(kt + 1))
        softmax_tile<true>(s, k0, row0, col0, S, causal, scale, m, l, alpha);
      else
        softmax_tile<false>(s, k0, row0, col0, S, causal, scale, m, l,
                            alpha);
    }
    wgmma_wait<0>();
#pragma unroll
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      fence_regs(hi[kk]);
      fence_regs(lo[kk]);
    }
    if (leader) mbar_arrive(v_empty(st));
    if (next) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 2 * h; i < HD / 2; i += 4) {
          o[i] *= alpha[h];
          o[i + 1] *= alpha[h];
        }
      split_p(s, hi, lo);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= S) continue;
    const float den = fmaxf(l[h], 1e-30f);
    __nv_bfloat16* orow = out + (size_t(bh) * S + row) * HD;
#pragma unroll
    for (int i = 2 * h; i < HD / 2; i += 4) {
      const int col = 8 * (i / 4) + col0;
      *reinterpret_cast<__nv_bfloat162*>(orow + col) =
          __floats2bfloat162_rn(o[i] / den, o[i + 1] / den);
    }
  }
}

// cuTensorMapEncodeTiled from the driver, found at run time (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

cudaError_t encode_fn(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || ptr == nullptr)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(ptr);
  }
  *fn = cached;
  return cudaSuccess;
}

// a (BH, S, HD) bf16 tensor as boxes of (rows, one swizzle row of HD)
template <int HD>
cudaError_t make_map(CUtensorMap* map, EncodeTiled encode, const void* ptr,
                     int BH, int S, int rows) {
  using L = Layout<HD>;
  const cuuint64_t dims[3] = {cuuint64_t(HD), cuuint64_t(S), cuuint64_t(BH)};
  const cuuint64_t strides[2] = {cuuint64_t(HD) * 2,
                                 cuuint64_t(S) * HD * 2};
  const cuuint32_t box[3] = {cuuint32_t(L::kColElems), cuuint32_t(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      L::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out, int BH,
              int S, int causal, cudaStream_t stream) {
  // 1024 bytes of slack to align the tiles to the swizzle period, then
  // the nine barriers
  constexpr size_t smem = 1024 + size_t(kRows) * HD * 2 +
                          4 * size_t(kKeys) * HD * 2 + 9 * 8;
  EncodeTiled encode;
  cudaError_t err = encode_fn(&encode);
  if (err != cudaSuccess) return int(err);
  CUtensorMap tq, tk, tv;
  if ((err = make_map<HD>(&tq, encode, q, BH, S, kRows)) != cudaSuccess ||
      (err = make_map<HD>(&tk, encode, k, BH, S, kKeys)) != cudaSuccess ||
      (err = make_map<HD>(&tv, encode, v, BH, S, kKeys)) != cudaSuccess)
    return int(err);
  auto kernel = flash_bf16_kernel<HD>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(BH, (S + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), S, causal);
  return int(cudaGetLastError());
}

}  // namespace wg

// ---------------------------------------------------------------------------
// f32 flavor: register-tiled f32 FMAs on the CUDA cores
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int kRows = 128;     // query rows per block
constexpr int kKeys = 128;     // keys per tile
constexpr int kThreads = 256;  // a 16 x 16 grid
constexpr int kMicro = 8;      // rows (and keys) per thread
constexpr int kPStride = kKeys + 4;

template <int HD>
constexpr int kStride = HD + 4;  // padded Q and K rows, in floats

// K's buffer also holds the p tile once the scores are done
template <int HD>
__host__ __device__ constexpr size_t kk_floats() {
  return size_t(kKeys) * kStride<HD> > size_t(kRows) * kPStride
             ? size_t(kKeys) * kStride<HD>
             : size_t(kRows) * kPStride;
}

template <int HD>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(kRows) * kStride<HD> + kk_floats<HD>() +
                          size_t(kKeys) * HD);
}

// rows [row0, row0 + R) of a (S, HD) f32 slab into rows of `stride` floats;
// rows at or past S read as 0
template <int HD, int R>
__device__ __forceinline__ void load_rows(float* dst, int stride,
                                          const float* src, int row0,
                                          int S) {
  constexpr int kChunks = HD / 4;
  for (int i = threadIdx.x; i < R * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    const bool valid = row0 + r < S;
    const float* p = src + (valid ? size_t(row0 + r) * HD + c * 4 : 0);
    cp_async16(smem_u32(dst + r * stride + c * 4), p, valid);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1) flash_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int S,
    int causal) {
  constexpr int QS = kStride<HD>;
  constexpr int kCols = HD / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // kRows x QS
  float* k_s = q_s + kRows * QS;                 // kKeys x QS, then p
  float* p_s = k_s;                              // kRows x kPStride
  float* v_s = k_s + kk_floats<HD>();            // kKeys x HD

  const int qt = gridDim.y - 1 - blockIdx.y;  // longest tiles first
  const int q0 = qt * kRows;
  const size_t slab = size_t(blockIdx.x) * S * HD;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  // scores in the log2 domain: p = exp2(s log2(e) / sqrt(hd) - m)
  const float scale = kLog2e / sqrtf(static_cast<float>(HD));
  // output column c of this thread (float4 groups, or a pair at hd = 32)
  auto col = [&](int c) {
    return kCols >= 4 ? 64 * (c / 4) + 4 * tx + c % 4 : 2 * tx + c;
  };

  load_rows<HD, kRows>(q_s, QS, q + slab, q0, S);
  cp_async_commit();

  float m[kMicro], l[kMicro], acc[kMicro][kCols];
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const int n_kt = (S + kKeys - 1) / kKeys;
  const int last = causal ? min(qt, n_kt - 1) : n_kt - 1;
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kKeys;
    __syncthreads();  // the previous tile's p and V readers are done
    load_rows<HD, kKeys>(k_s, QS, k + slab, k0, S);
    cp_async_commit();
    load_rows<HD, kKeys>(v_s, HD, v + slab, k0, S);
    cp_async_commit();
    cp_async_wait<1>();  // Q and K have landed; V may still be in flight
    __syncthreads();

    // S micro-tile: rows ty + 16 i, keys tx + 16 j
    float s[kMicro][kMicro];
#pragma unroll
    for (int i = 0; i < kMicro; ++i)
#pragma unroll
      for (int j = 0; j < kMicro; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 b[kMicro];
#pragma unroll
      for (int j = 0; j < kMicro; ++j)
        b[j] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * j) * QS + d);
#pragma unroll
      for (int i = 0; i < kMicro; ++i) {
        const float4 a =
            *reinterpret_cast<const float4*>(q_s + (ty + 16 * i) * QS + d);
#pragma unroll
        for (int j = 0; j < kMicro; ++j) {
          s[i][j] = fmaf(a.x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a.y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a.z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a.w, b[j].w, s[i][j]);
        }
      }
    }
    __syncthreads();  // K is read: its buffer takes p

#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      const int qpos = q0 + ty + 16 * i;
      bool valid[kMicro];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kMicro; ++j) {
        const int kpos = k0 + tx + 16 * j;
        valid[j] = kpos < S && (!causal || kpos <= qpos);
        s[i][j] = valid[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kMicro; ++j) {
        const float p = valid[j] ? exp2f(s[i][j] - m_new) : 0.f;
        p_s[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float alpha = exp2f(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    cp_async_wait<0>();
    __syncthreads();  // p and V are in shared memory

#pragma unroll 2
    for (int c0 = 0; c0 < kKeys; c0 += 4) {
      float4 p[kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
        p[i] = *reinterpret_cast<const float4*>(p_s + (ty + 16 * i) * kPStride
                                                + c0);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = v_s + (c0 + cc) * HD;
        float vv[kCols];
        if constexpr (kCols >= 4) {
#pragma unroll
          for (int g = 0; g < kCols / 4; ++g) {
            const float4 x =
                *reinterpret_cast<const float4*>(vrow + 64 * g + 4 * tx);
            vv[4 * g] = x.x;
            vv[4 * g + 1] = x.y;
            vv[4 * g + 2] = x.z;
            vv[4 * g + 3] = x.w;
          }
        } else {
          const float2 x = *reinterpret_cast<const float2*>(vrow + 2 * tx);
          vv[0] = x.x;
          vv[1] = x.y;
        }
#pragma unroll
        for (int i = 0; i < kMicro; ++i) {
          const float pi = cc == 0   ? p[i].x
                           : cc == 1 ? p[i].y
                           : cc == 2 ? p[i].z
                                     : p[i].w;
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            acc[i][c] = fmaf(pi, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = out + slab + size_t(row) * HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c) orow[col(c)] = acc[i][c] / den;
  }
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out, int BH,
              int S, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kernel = flash_f32_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(BH, (S + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, causal);
  return int(cudaGetLastError());
}

}  // namespace f32

template <typename Flavor>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int S, int hd, int causal, void* stream) {
  if (BH < 0 || S < 0 || (S + 63) / 64 > 65535)
    return int(cudaErrorInvalidValue);
  if (BH == 0 || S == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return Flavor::template run<32>(q, k, v, out, BH, S, causal, st);
    case 64: return Flavor::template run<64>(q, k, v, out, BH, S, causal, st);
    case 128:
      return Flavor::template run<128>(q, k, v, out, BH, S, causal, st);
    default: return int(cudaErrorInvalidValue);
  }
}

struct F32 {
  template <int HD>
  static int run(const void* q, const void* k, const void* v, void* out,
                 int BH, int S, int causal, cudaStream_t st) {
    return f32::launch_hd<HD>(q, k, v, out, BH, S, causal, st);
  }
};
struct BF16 {
  template <int HD>
  static int run(const void* q, const void* k, const void* v, void* out,
                 int BH, int S, int causal, cudaStream_t st) {
    return wg::launch_hd<HD>(q, k, v, out, BH, S, causal, st);
  }
};

}  // namespace

// q, k, v, out: (B*H, S, hd) contiguous and 16-byte aligned, hd in
// {32, 64, 128}, S <= 65535 * 64.
// Returns a cudaError_t.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, int BH, int S,
                                   int hd, int causal, void* stream) {
  return launch<F32>(q, k, v, out, BH, S, hd, causal, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int BH, int S,
                                    int hd, int causal, void* stream) {
  return launch<BF16>(q, k, v, out, BH, S, hd, causal, stream);
}
