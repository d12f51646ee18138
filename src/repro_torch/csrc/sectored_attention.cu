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
// against ~42 MFLOP, far below the card's FLOP-per-byte ridge; at these
// sizes a launch and a few dependent trips to memory are the cost, so the
// design spends one launch and no round trip through global memory.
//
// Design: one launch, one thread-block cluster of C blocks per (b, h) and
// per 64 query rows (grid y), no global scratch. The K * page token slots
// of a (b, h) are cut into C contiguous slices, one per block
// (kernels/sectored_attention.py:head_major_plan). In this layout the
// valid rows of a selected page inside a slice are one contiguous byte
// range, so a block brings its K and V rows into shared memory with one
// Hopper bulk copy (cp.async.bulk, completing on an mbarrier) per page
// piece; rows at or past `length` are never read. (16-byte cp.async by
// every thread, and one bulk copy per row into padded rows, both measured
// slower: the copy engine takes bulk copies one at a time.)
//   1. Where the slice fits (the decode shapes), every K and V load of it
//      is in flight before any compute, started by warp 0 as soon as the
//      barriers exist. Otherwise the block walks the
//      slice in tiles of `tile` rows through a ring of stages: K tiles,
//      then V tiles (and, where even the slice's scores do not fit, K
//      tiles again to recompute the scores).
//   2. Scores in exact f32 FMAs on the CUDA cores for both flavors (bf16
//      upcasts exactly): a warp takes one slot per 16-byte vector lane
//      group, q rows in registers as loaded (converted at use, so no
//      thread waits for them before K lands), partial dots reduced across
//      the lanes with a transposing butterfly; masked slots -1e30.
//   3. The blocks exchange their row maxima through distributed shared
//      memory after a cluster barrier, so every block forms e against the
//      exact global max.
//   4. e (f32, never rounded) and the partial e V (rep x hd) on the CUDA
//      cores: a warp takes a share of the slots for 8 query rows, lanes
//      take 4 columns each; the warps' partials are added in warp order.
//   5. After a second cluster barrier the partials and row sums are
//      reduced over distributed shared memory in rank order (deterministic,
//      no atomics), divided by max(sum e, 1e-30) and written; a last
//      barrier keeps every block's shared memory alive until all reads are
//      done.
// What is left at these sizes is latency: the launch, two dependent trips
// to device memory (page indices, then K and V rows) and the cluster
// barriers.
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
constexpr int kRowGroup = 8;       // query rows a thread carries at once
constexpr int kMaxRows = 64;       // query rows of one block (grid y)
constexpr int kMaxCluster = 16;
constexpr int kMaxStages = 8;      // ring stages of the tiled walk
constexpr size_t kScoreBudget = 65536;  // scores kept whole up to this
constexpr size_t kMaxSmem = 232448;     // 227 KB, the most a block may use

// -- device helpers (copied, not shared, so the paged kernel's source and
// its build hash stay as they are) --------------------------------------------

// 16 bytes of shared memory as f32: 4 floats or 8 bf16
__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&x)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// element e of 16 raw bytes holding 4 floats or 8 bf16, as f32
template <typename T>
__device__ __forceinline__ float elem_f32(const uint4& v, int e) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w[e]);
  } else {
    return __uint_as_float(e & 1 ? w[e / 2] & 0xffff0000u : w[e / 2] << 16);
  }
}

// 16 bytes of device memory with no alignment: VEC element loads
__device__ __forceinline__ uint4 load16_any(const float* p) {
  return make_uint4(__float_as_uint(p[0]), __float_as_uint(p[1]),
                    __float_as_uint(p[2]), __float_as_uint(p[3]));
}
__device__ __forceinline__ uint4 load16_any(const __nv_bfloat16* p) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = uint32_t(__bfloat16_as_ushort(p[2 * i])) |
           (uint32_t(__bfloat16_as_ushort(p[2 * i + 1])) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 4 consecutive elements of shared memory as f32
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.y));
  x[0] = a.x;
  x[1] = a.y;
  x[2] = b.x;
  x[3] = b.y;
}

// Sum each of N values over aligned groups of L lanes (offsets O = L/2 ..
// 1), halving the values a lane holds at each of the first rounds: lane i
// of a group sends the half it does not keep. With N = 8 and L >= 8 a
// lane ends with one group sum, of value (i / (L / 8)); with L < 8 with
// 8 / L of them, slot s holding value s + (8 / L) * i.
template <int N, int O>
__device__ __forceinline__ void group_sum(float* a, int lane) {
  if constexpr (O >= 1) {
    if constexpr (N > 1) {
      constexpr int H = N / 2;
      const bool upper = (lane & O) != 0;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = upper ? a[i] : a[i + H];
        const float keep = upper ? a[i + H] : a[i];
        a[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      group_sum<H, O / 2>(a, lane);
    } else {
      a[0] += __shfl_xor_sync(0xffffffffu, a[0], O);
      group_sum<1, O / 2>(a, lane);
    }
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// raise the transaction bytes the current phase waits for
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// wait for the phase of the given parity to complete (a wait that never
// ends is a fault: after two seconds the kernel traps instead of hanging
// the card)
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  const uint64_t t0 = global_ns();
  for (uint32_t polls = 1; !done; ++polls) {
    if (polls % 1024 == 0 && global_ns() - t0 > 2000000000ull) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory into this block's shared memory, counted on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// order this thread's generic writes to shared memory before later bulk
// copies into the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- the plan ----------------------------------------------------------------

// Shape of one call, the wrapper's cluster plan (C blocks per (b, h), block
// r taking token slots [r chunk, (r + 1) chunk) of the K * page slots, cut
// at n, walked in tiles of `tile` slots) and the shared-memory layout it
// implies (smem_plan).
struct Geometry {
  int Hkv, rep, hd, P, page, K, idx_heads, C, chunk, tile;
  int stages;  // ring stages (2 where the slice is loaded whole)
  int store;   // the slice's scores are kept (1) or recomputed per tile (0)
  int sslots;  // score columns kept: chunk or tile
  int aligned;  // q, k and v 16-byte aligned: bulk copies and vector
                // loads, else plain loads
  unsigned scores_off, acc_off, stats_off, flags_off, bars_off, smem;
};

size_t a16(size_t x) { return (x + 15) & ~size_t(15); }

// Shared memory of one block, in this order: the ring of K / V tiles
// (after the walk, the warps' partial e V and row sums), the scores (rows
// of sslots + 1 floats), the block's partial e V (rows x hd f32), four
// row statistics (local and global max, local and global sum), per-slot
// validity bytes, the ring's mbarriers. Mirrored by
// kernels/sectored_attention.py:head_major_layout.
void smem_plan(Geometry& g, int itemsize) {
  const size_t rows = g.rep < kMaxRows ? g.rep : kMaxRows;
  const bool whole = g.tile >= g.chunk;
  const int nt = (g.chunk + g.tile - 1) / g.tile;
  g.store = whole || 4 * rows * (size_t(g.chunk) + 1) <= kScoreBudget;
  g.sslots = g.store ? g.chunk : g.tile;
  const size_t tile_bytes = size_t(g.tile) * g.hd * itemsize;
  const size_t partial = 4 * size_t(kRowGroup) * kWarps * (g.hd + 1);
  const size_t scores = a16(4 * rows * (size_t(g.sslots) + 1));
  const size_t acc = 4 * rows * g.hd;
  const size_t stats = a16(16 * rows);
  const size_t flags = a16(g.sslots);
  const size_t fixed = scores + acc + stats + flags;
  if (whole) {
    g.stages = 2;
  } else {
    const size_t loads = size_t(g.store ? 2 : 3) * nt;
    const size_t room = kMaxSmem > fixed + 8 * kMaxStages
                            ? kMaxSmem - fixed - 8 * kMaxStages
                            : 0;
    size_t st = room / tile_bytes;
    if (st > loads) st = loads;
    if (st > kMaxStages) st = kMaxStages;
    g.stages = int(st);
  }
  size_t ring = size_t(g.stages) * tile_bytes;
  ring = a16(ring > partial ? ring : partial);
  g.scores_off = unsigned(ring);
  g.acc_off = unsigned(ring + scores);
  g.stats_off = unsigned(ring + scores + acc);
  g.flags_off = unsigned(ring + scores + acc + stats);
  g.bars_off = unsigned(ring + fixed);
  g.smem = unsigned(ring + fixed + 8 * size_t(g.stages));
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

// rows of selected page pg that hold valid positions (< len)
__device__ __forceinline__ int valid_rows(int pg, int page, long long len) {
  if (pg < 0) return 0;
  const long long fill = len - static_cast<long long>(pg) * page;
  return fill <= 0 ? 0 : (fill < page ? static_cast<int>(fill) : page);
}

// -- the kernel ----------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2) head_major_cluster_kernel(
    const T* __restrict__ q,              // (B, Hkv, rep, hd)
    const T* __restrict__ k,              // (B, Hkv, P, page, hd)
    const T* __restrict__ v,              // (B, Hkv, P, page, hd)
    const int32_t* __restrict__ page_idx, // (B, idx_heads, K)
    const int32_t* __restrict__ length,   // (B,) count of valid tokens
    float* __restrict__ out,              // (B, Hkv, rep, hd)
    const Geometry g) {
  // scores: a warp takes G slots at a time, L lanes a slot, VPL 16-byte
  // vectors (VEC elements) of the slot's row a lane
  constexpr int VEC = 16 / int(sizeof(T));
  constexpr int NV = HD / VEC;
  constexpr int L = NV > 16 ? 32 : (NV > 8 ? 16 : (NV > 4 ? 8 : 4));
  constexpr int VPL = (NV + L - 1) / L;
  constexpr int G = 32 / L;
  // after the butterfly a lane holds S row sums, each held by SH lanes
  constexpr int S = L >= kRowGroup ? 1 : kRowGroup / L;
  constexpr int SH = L >= kRowGroup ? L / kRowGroup : 1;
  // e V: a lane takes UPL units of 4 columns
  constexpr int UN = HD / 4;
  constexpr int UPL = (UN + 31) / 32;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x / g.C;
  const int b = bh / g.Hkv;
  const int h = bh - b * g.Hkv;
  const int r0 = blockIdx.y * kMaxRows;
  const int rows = min(kMaxRows, g.rep - r0);
  const int page = g.page;
  const int j0 = rank * g.chunk;
  const int nj = min(j0 + g.chunk, g.K * page) - j0;  // this block's slots
  const int nt = (nj + g.tile - 1) / g.tile;           // and tiles
  const int loads = (g.store ? 2 : 3) * nt;
  const int ss = g.sslots + 1;  // score row stride
  const int RG = (rows + kRowGroup - 1) / kRowGroup;
  const int SG = kWarps / RG;  // e V: slot groups of warps
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long len = length[b];
  const size_t tile_bytes = size_t(g.tile) * HD * sizeof(T);
  const size_t head_base = (size_t(b) * g.Hkv + h) * g.P;

  extern __shared__ __align__(16) unsigned char smem[];
  float* part = reinterpret_cast<float*>(smem);  // after the walk
  float* rpart = part + kWarps * kRowGroup * HD;
  float* s_s = reinterpret_cast<float*>(smem + g.scores_off);
  float* acc_s = reinterpret_cast<float*>(smem + g.acc_off);
  float* m_s = reinterpret_cast<float*>(smem + g.stats_off);
  float* gm_s = m_s + rows;
  float* rsum_s = gm_s + rows;
  float* den_s = rsum_s + rows;
  uint8_t* flag_s = smem + g.flags_off;
  const uint32_t bars = smem_u32(smem + g.bars_off);
  auto stage_of = [&](int l) -> unsigned char* {
    return smem + size_t(l % g.stages) * tile_bytes;
  };

  auto slot_valid = [&](int j) -> uint8_t {
    const int c = j / page;
    return (j - c * page) < valid_rows(selected_page(page_idx, g, b, h, c),
                                       page, len);
  };
  // validity of this block's slots [t0, t0 + count) into flag_s from 0
  auto fill_flags = [&](int t0, int count) {
    for (int t = tid; t < count; t += kThreads)
      flag_s[t] = slot_valid(j0 + t0 + t);
  };

  // load l of the walk: K tiles 0 .. nt-1, then V tiles (kept scores), or
  // K and V of each tile in turn (recomputed scores)
  auto load_tile = [&](int l) {
    if (l < nt) return l;
    return g.store ? l - nt : (l - nt) / 2;
  };
  auto load_is_v = [&](int l) {
    return l >= nt && (g.store || ((l - nt) & 1));
  };
  // Start loads l .. l + count - 1, all of one tile (count 2: its K and V).
  // Run by warp 0: each lane takes pages of the tile, announces their
  // bytes and starts one bulk copy of each page's valid rows; lane 0 then
  // arrives.
  auto start_loads = [&](int l, int count) {
    const int tile_i = load_tile(l);
    const int J0 = j0 + tile_i * g.tile;
    const int J1 = j0 + min((tile_i + 1) * g.tile, nj);
    const int c0 = J0 / page, c1 = (J1 - 1) / page;
    // the valid rows [lo, hi) of selected page c inside the tile, and the
    // offset of row lo in the cache
    auto piece = [&](int c, int& lo, int& hi) -> size_t {
      const int pg = selected_page(page_idx, g, b, h, c);
      lo = max(J0, c * page) - c * page;
      hi = min(min(J1, (c + 1) * page) - c * page, valid_rows(pg, page, len));
      return ((head_base + (pg < 0 ? 0 : pg)) * page + lo) * HD;
    };
    auto stage_row = [&](int n, int c, int lo) {
      return reinterpret_cast<T*>(stage_of(l + n)) +
             size_t(c * page + lo - J0) * HD;
    };
    if (g.aligned) {
      for (int c = c0 + lane; c <= c1; c += 32) {
        int lo, hi;
        const size_t at = piece(c, lo, hi);
        if (hi <= lo) continue;
        const uint32_t bytes = uint32_t(hi - lo) * HD * sizeof(T);
        for (int n = 0; n < count; ++n) {
          const uint32_t bar = bars + 8 * ((l + n) % g.stages);
          mbar_expect(bar, bytes);
          bulk_load(smem_u32(stage_row(n, c, lo)),
                    (load_is_v(l + n) ? v : k) + at, bytes, bar);
        }
      }
    } else {  // not 16-byte aligned: the warp copies the rows itself
      for (int c = c0; c <= c1; ++c) {
        int lo, hi;
        const size_t at = piece(c, lo, hi);
        for (int n = 0; n < count; ++n) {
          const T* from = (load_is_v(l + n) ? v : k) + at;
          T* to = stage_row(n, c, lo);
          for (int i = lane; i < (hi - lo) * HD; i += 32) to[i] = from[i];
        }
      }
      __threadfence_block();
    }
    __syncwarp();
    if (lane == 0)
      for (int n = 0; n < count; ++n)
        mbar_arrive(bars + 8 * ((l + n) % g.stages));
  };
  auto wait_load = [&](int l) {
    mbar_wait(bars + 8 * (l % g.stages), (l / g.stages) & 1);
  };

  // q rows [8 rg, 8 rg + 8) of this block, this lane's 16-byte vectors,
  // kept as loaded (converted at use: no wait for them here)
  uint4 qr[kRowGroup][VPL];
  const int sub = lane / L, li = lane % L;
  auto load_q = [&](int rg) {
#pragma unroll
    for (int i = 0; i < kRowGroup; ++i) {
      const int r = kRowGroup * rg + i;
      const T* qv = q + ((size_t(bh) * g.rep) + r0 + r) * HD;
#pragma unroll
      for (int kk = 0; kk < VPL; ++kk) {
        const int vi = li + L * kk;
        if (vi >= NV || r >= rows)
          qr[i][kk] = make_uint4(0, 0, 0, 0);
        else if (g.aligned)
          qr[i][kk] = *reinterpret_cast<const uint4*>(qv + vi * VEC);
        else
          qr[i][kk] = load16_any(qv + vi * VEC);
      }
    }
  };

  // the scores of the tile in stage buffer kb (tr slots) into score
  // columns [off, off + tr), flags from flag_s[off]
  const float root_hd = sqrtf(static_cast<float>(HD));
  auto scores = [&](const T* kb, int tr, int off, bool reload) {
    for (int rg = 0; rg < RG; ++rg) {
      if (reload) load_q(rg);
      for (int step = warp; step * G < tr; step += kWarps) {
        const int t = step * G + sub;
        const bool in = t < tr;
        float kv[VPL][VEC];
#pragma unroll
        for (int kk = 0; kk < VPL; ++kk) {
          const int vi = li + L * kk;
          if (in && vi < NV) {
            load16(kb + size_t(t) * HD + vi * VEC, kv[kk]);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) kv[kk][e] = 0.f;
          }
        }
        float a[kRowGroup];
#pragma unroll
        for (int i = 0; i < kRowGroup; ++i) {
          float x = 0.f;
#pragma unroll
          for (int kk = 0; kk < VPL; ++kk)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              x = fmaf(elem_f32<T>(qr[i][kk], e), kv[kk][e], x);
          a[i] = x;
        }
        group_sum<kRowGroup, L / 2>(a, lane);
        if (in && li % SH == 0) {
          const bool ok = flag_s[off + t];
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const int r = kRowGroup * rg + (S == 1 ? li / SH : s + S * li);
            if (r < rows) s_s[r * ss + off + t] = ok ? a[s] / root_hd : kNegInf;
          }
        }
      }
    }
  };

  // -- prologue: the first loads (warp 0, as soon as the barriers exist;
  // K and V together where the slice is loaded whole), then q, the row
  // maxima and the slots' validity while they are in flight --
  if (warp == 0) {
    if (lane == 0) {
      for (int s = 0; s < g.stages; ++s) mbar_init(bars + 8 * s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    if (g.tile >= g.chunk) {
      start_loads(0, 2);
    } else {
      for (int l = 0; l < min(g.stages, loads); ++l) start_loads(l, 1);
    }
  }
  if (RG == 1) load_q(0);
  for (int r = tid; r < rows; r += kThreads) m_s[r] = kNegInf;
  if (g.store) fill_flags(0, nj);
  __syncthreads();

  // -- phase 1: the scores of every tile, and the local row maxima --
  for (int i = 0; i < nt; ++i) {
    const int t0 = i * g.tile;
    const int tr = min(g.tile, nj - t0);
    const int off = g.store ? t0 : 0;
    if (!g.store) {
      fill_flags(t0, tr);
      __syncthreads();
    }
    wait_load(i);
    scores(reinterpret_cast<const T*>(stage_of(i)), tr, off, RG > 1);
    __syncthreads();
    for (int r = warp; r < rows; r += kWarps) {
      float mx = kNegInf;
      for (int t = lane; t < tr; t += 32) mx = fmaxf(mx, s_s[r * ss + off + t]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      if (lane == 0) m_s[r] = fmaxf(m_s[r], mx);
    }
    __syncthreads();
    if (warp == 0 && i + g.stages < loads) start_loads(i + g.stages, 1);
  }

  // -- the exact global row max, from every block's local maxima --
  cluster.sync();
  for (int r = tid; r < rows; r += kThreads) {
    float mx = kNegInf;
    for (int c = 0; c < g.C; ++c)
      mx = fmaxf(mx, cluster.map_shared_rank(m_s, c)[r]);
    gm_s[r] = mx;
  }
  __syncthreads();

  // -- phase 2: e and the partial e V, tile by tile --
  const int rg_w = warp / SG, sg_w = warp % SG;  // this warp's e V share
  const bool ev_warp = rg_w < RG;
  float acc[kRowGroup][UPL][4];
  float rsum[kRowGroup];
#pragma unroll
  for (int i = 0; i < kRowGroup; ++i) {
    rsum[i] = 0.f;
#pragma unroll
    for (int u = 0; u < UPL; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][u][c] = 0.f;
  }
  for (int i = 0; i < nt; ++i) {
    const int t0 = i * g.tile;
    const int tr = min(g.tile, nj - t0);
    const int off = g.store ? t0 : 0;
    int lv = nt + i;  // the V tile's load
    if (!g.store) {
      const int lk = nt + 2 * i;
      lv = lk + 1;
      fill_flags(t0, tr);
      __syncthreads();
      wait_load(lk);
      scores(reinterpret_cast<const T*>(stage_of(lk)), tr, 0, true);
      __syncthreads();
      if (warp == 0 && lk + g.stages < loads) start_loads(lk + g.stages, 1);
    }
    wait_load(lv);
    T* vb = reinterpret_cast<T*>(stage_of(lv));
    // e in place of the scores; masked rows of V are zeroed (never read
    // from the cache, so they hold stale bytes) and have e = 0
    for (int x = tid; x < rows * tr; x += kThreads) {
      const int t = x / rows;
      const int r = x - t * rows;
      const bool ok = flag_s[off + t];
      float* e = s_s + r * ss + off + t;
      *e = ok ? expf(*e - gm_s[r]) : 0.f;
      if (!ok && r == 0) {
        uint4* row = reinterpret_cast<uint4*>(vb + size_t(t) * HD);
        for (int w = 0; w < HD * int(sizeof(T)) / 16; ++w)
          row[w] = make_uint4(0, 0, 0, 0);
      }
    }
    fence_proxy_async();
    __syncthreads();
    if (ev_warp) {
      for (int t = sg_w; t < tr; t += SG) {
        float vv[UPL][4];
#pragma unroll
        for (int u = 0; u < UPL; ++u) {
          const int un = lane + 32 * u;
          if (un < UN) {
            load4(vb + size_t(t) * HD + 4 * un, vv[u]);
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c) vv[u][c] = 0.f;
          }
        }
#pragma unroll
        for (int ii = 0; ii < kRowGroup; ++ii) {
          const int r = kRowGroup * rg_w + ii;
          const float e = r < rows ? s_s[r * ss + off + t] : 0.f;
          rsum[ii] += e;
#pragma unroll
          for (int u = 0; u < UPL; ++u)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[ii][u][c] = fmaf(e, vv[u][c], acc[ii][u][c]);
        }
      }
    }
    __syncthreads();
    if (warp == 0 && lv + g.stages < loads) start_loads(lv + g.stages, 1);
  }

  // -- the warps' partials (over the idle ring) added in warp order --
  if (ev_warp) {
    float* p = part + size_t(warp) * kRowGroup * HD;
#pragma unroll
    for (int ii = 0; ii < kRowGroup; ++ii)
#pragma unroll
      for (int u = 0; u < UPL; ++u) {
        const int un = lane + 32 * u;
        if (un < UN)
          *reinterpret_cast<float4*>(p + ii * HD + 4 * un) = make_float4(
              acc[ii][u][0], acc[ii][u][1], acc[ii][u][2], acc[ii][u][3]);
      }
    if (lane == 0)
#pragma unroll
      for (int ii = 0; ii < kRowGroup; ++ii)
        rpart[warp * kRowGroup + ii] = rsum[ii];
  }
  __syncthreads();
  for (int x = tid; x < rows * HD; x += kThreads) {
    const int r = x / HD;
    const int w0 = (r / kRowGroup) * SG;
    const int at = (r % kRowGroup) * HD + (x - r * HD);
    float sum = 0.f;
    for (int sg = 0; sg < SG; ++sg)
      sum += part[size_t(w0 + sg) * kRowGroup * HD + at];
    acc_s[x] = sum;
  }
  for (int r = tid; r < rows; r += kThreads) {
    const int w0 = (r / kRowGroup) * SG;
    float sum = 0.f;
    for (int sg = 0; sg < SG; ++sg)
      sum += rpart[(w0 + sg) * kRowGroup + r % kRowGroup];
    rsum_s[r] = sum;
  }

  // -- reduce the C partials in rank order, each rank a share of them --
  cluster.sync();
  for (int r = tid; r < rows; r += kThreads) {
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
  const int total = rows * HD;
  float* out_bh = out + (size_t(bh) * g.rep + r0) * HD;
  for (int i = rank * kThreads + tid; i < total; i += g.C * kThreads) {
    float x[kMaxCluster];
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c)
      x[c] = c < g.C ? cluster.map_shared_rank(acc_s, c)[i] : 0.f;
    float num = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c)
      if (c < g.C) num += x[c];
    out_bh[i] = num / fmaxf(den_s[i / HD], 1e-30f);
  }
  cluster.sync();  // no block leaves while another reads its memory
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v,
              const void* page_idx, const void* length, void* out, int B,
              const Geometry& g, void* stream) {
  auto kernel = head_major_cluster_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(g.smem));
  if (err != cudaSuccess) return int(err);
  if (g.C > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return int(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.C * B * g.Hkv, (g.rep + kMaxRows - 1) / kMaxRows);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = g.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q),
                           static_cast<const T*>(k), static_cast<const T*>(v),
                           static_cast<const int32_t*>(page_idx),
                           static_cast<const int32_t*>(length),
                           static_cast<float*>(out), g);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* page_idx,
           const void* length, void* out, int B, int Hkv, int rep, int hd,
           int P, int page, int K, int idx_heads, int C, int chunk, int tile,
           void* stream) {
  if (B * Hkv == 0) return 0;
  Geometry g{Hkv, rep, hd, P, page, K, idx_heads, C, chunk, tile};
  const size_t n = size_t(K) * page;
  // the plan must give every block at least one slot and cover all n; a
  // slot and a tile row are ints in the kernel
  if (hd > 256 || hd % 32 != 0 || rep < 1 || K < 1 || page < 1 || C < 1 ||
      C > kMaxCluster || chunk < 1 || tile < 1 || tile > chunk ||
      n > size_t(INT_MAX) || size_t(C - 1) * chunk >= n ||
      size_t(C) * chunk < n)
    return int(cudaErrorInvalidValue);
  smem_plan(g, int(sizeof(T)));
  if (g.stages < 1 || g.smem > kMaxSmem) return int(cudaErrorInvalidValue);
  g.aligned = (reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
               reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
               reinterpret_cast<uintptr_t>(v) % 16 == 0);
  switch (hd) {
    case 32:
      return launch_hd<T, 32>(q, k, v, page_idx, length, out, B, g, stream);
    case 64:
      return launch_hd<T, 64>(q, k, v, page_idx, length, out, B, g, stream);
    case 96:
      return launch_hd<T, 96>(q, k, v, page_idx, length, out, B, g, stream);
    case 128:
      return launch_hd<T, 128>(q, k, v, page_idx, length, out, B, g, stream);
    case 160:
      return launch_hd<T, 160>(q, k, v, page_idx, length, out, B, g, stream);
    case 192:
      return launch_hd<T, 192>(q, k, v, page_idx, length, out, B, g, stream);
    case 224:
      return launch_hd<T, 224>(q, k, v, page_idx, length, out, B, g, stream);
    default:
      return launch_hd<T, 256>(q, k, v, page_idx, length, out, B, g, stream);
  }
}

}  // namespace

// q (B, Hkv, rep, hd), k, v (B, Hkv, P, page, hd), all f32 or all bf16;
// page_idx (B, idx_heads, K) int32; length (B,) int32; out (B, Hkv, rep, hd)
// f32. C blocks per (b, h) in one cluster, block r taking token slots
// [r chunk, (r+1) chunk), walked in tiles of `tile` slots (tile = chunk:
// the slice is loaded whole). Returns a cudaError_t.
extern "C" int sectored_attention_f32(
    const void* q, const void* k, const void* v, const void* page_idx,
    const void* length, void* out, int B, int Hkv, int rep, int hd, int P,
    int page, int K, int idx_heads, int C, int chunk, int tile,
    void* stream) {
  return launch<float>(q, k, v, page_idx, length, out, B, Hkv, rep, hd, P,
                       page, K, idx_heads, C, chunk, tile, stream);
}

extern "C" int sectored_attention_bf16(
    const void* q, const void* k, const void* v, const void* page_idx,
    const void* length, void* out, int B, int Hkv, int rep, int hd, int P,
    int page, int K, int idx_heads, int C, int chunk, int tile,
    void* stream) {
  return launch<__nv_bfloat16>(q, k, v, page_idx, length, out, B, Hkv, rep,
                               hd, P, page, K, idx_heads, C, chunk, tile,
                               stream);
}
