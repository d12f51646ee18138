// Variable Burst Length (VBL) sector compaction for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of the JAX package
// (src/repro/kernels/vbl_gather.py, wrapper `vbl_gather`). Row n of the
// input holds the 8 sectors of one cache line, W elements each; bits 0-7
// of masks[n] enable sectors. For every row:
//
//   slot(s)  = popc(mask & ((1 << s) - 1))     the 8->3 encoder
//   out[n, slot(s)] = data[n, s]   for each enabled sector s
//   out[n, j]       = 0            for j in [count, 8)
//   counts[n]       = popc(mask & 0xFF)
//
// What bounds it on this card: bytes. It does no arithmetic; it reads the
// enabled sectors once and writes all 8 slots once, so its least time is
// those bytes over the HBM rate.
//
// Design. The TPU kernel takes one row per grid step and loops over the 8
// sectors in VMEM. Here one block of 8 warps takes one row: warp j owns
// output slot j, finds the sector that lands there (the j-th enabled one)
// and copies it, or writes zeros when j >= count. Nothing is staged in
// shared memory: each warp streams one sector from device memory to device
// memory, in 16-byte words when a sector's bytes and both base pointers
// allow it, else in the element's own 2- or 4-byte words. Disabled sectors
// are never read. The kernel moves bits, not values: a -0.0 or a NaN
// payload arrives as it left.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kSectors = 8;
constexpr int kThreads = 32 * kSectors;  // one warp per output slot

// U is the word the copy moves: uint4 (16 bytes), uint32_t or uint16_t.
template <typename U>
__global__ void __launch_bounds__(kThreads) vbl_gather_kernel(
    const U* __restrict__ data,       // (N, 8, words)
    const uint32_t* __restrict__ masks,  // (N,)
    U* __restrict__ out,              // (N, 8, words)
    int32_t* __restrict__ counts,     // (N,)
    int words) {                      // words of U per sector
  const size_t n = blockIdx.x;
  const int slot = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint32_t mask = masks[n] & 0xFFu;
  const int count = __popc(mask);
  if (threadIdx.x == 0) counts[n] = count;

  // the enabled sector whose exclusive prefix popcount is `slot`
  int src = -1;
#pragma unroll
  for (int s = 0; s < kSectors; ++s)
    if (((mask >> s) & 1u) && __popc(mask & ((1u << s) - 1u)) == slot)
      src = s;

  U* dst = out + (n * kSectors + slot) * size_t(words);
  if (src < 0) {
    const U zero{};
    for (int i = lane; i < words; i += 32) dst[i] = zero;
    return;
  }
  const U* from = data + (n * kSectors + src) * size_t(words);
  for (int i = lane; i < words; i += 32) dst[i] = from[i];
}

template <typename U>
int launch(const void* data, const void* masks, void* out, void* counts,
           int n, int words, cudaStream_t stream) {
  vbl_gather_kernel<U><<<n, kThreads, 0, stream>>>(
      static_cast<const U*>(data), static_cast<const uint32_t*>(masks),
      static_cast<U*>(out), static_cast<int32_t*>(counts), words);
  return int(cudaGetLastError());
}

}  // namespace

// data/out (N, 8, W) of `elem_bytes`-byte elements (2 or 4); masks (N,)
// 32-bit words; counts (N,) int32. Returns a cudaError_t.
extern "C" int vbl_gather(const void* data, const void* masks, void* out,
                          void* counts, int n, int w, int elem_bytes,
                          void* stream) {
  if (n < 0 || w < 0 || (elem_bytes != 2 && elem_bytes != 4))
    return int(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const size_t sector_bytes = size_t(w) * elem_bytes;
  const bool vec = sector_bytes % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(data) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec)
    return launch<uint4>(data, masks, out, counts, n, int(sector_bytes / 16),
                         st);
  if (elem_bytes == 4)
    return launch<uint32_t>(data, masks, out, counts, n, w, st);
  return launch<uint16_t>(data, masks, out, counts, n, w, st);
}
