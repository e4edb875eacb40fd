// SiM paired point lookup on Hopper: row i matches query i against its key
// page, takes the first matching user slot and gathers that slot's 64 B
// chunk from its value page — search, slot select and value gather in one
// launch.  Key and value pages are read in place from the PlaneStore arena
// through two row indices.
//
// Replaces the TPU kernel src/repro/kernels/sim_fused/sim_fused.py
// (_lookup_kernel, launched by sim_lookup_kernel).  The cross-product
// _fused_kernel in the same file is ported in sim_fused.cu; the two select
// chunks differently (this one masks the header chunk, that one does not).
//
// What bounds it on the H100: latency.  A row reads its 4 KiB of key planes
// once, runs about 45 integer operations per slot (the §IV-C1 stream
// regeneration dominates, since each key page meets one query), and reads
// one 64 B value chunk on a hit: under 0.1 us of work at the replay's burst
// of B = 64 rows.  What a launch waits for is its chain of dependent memory
// trips: row indices -> key planes -> match -> value chunk.  On the replay
// the arena (128 MiB) is larger than the 50 MB L2, so both plane reads go to
// device memory.
//
// Design:
// * In place.  `key_rows` and `value_rows` (B,) map row i to its key and
//   value pages in the arena, so the flush issues no gather copies.  A null
//   index means rows 0..B-1 of its planes.  The host checks every index
//   against the resident rows before it uploads them; the kernel trusts
//   them.  The kernel reads the arena when it runs: every arena write and
//   every launch go to the same CUDA stream, and stream order keeps a
//   launch reading the planes of its flush.
// * The value row's two 2 KiB planes are prefetched into L2 with
//   cp.async.bulk.prefetch.L2 as soon as its index is known, while the key
//   row is loaded and matched, so the chunk read after the match finds L2
//   instead of device memory: the chain pays one trip to device memory,
//   not two.
// * 256 threads a row, two slots a thread (slots t and t + 256; 128 and
//   512 threads were slower when timed in turns on the H100; PERF.md):
//   each warp load is 128 contiguous bytes, each thread has two
//   independent stream chains, and ballot k of warp w is bitmap word
//   v = 8k + w, whose lane i is slot 32v + i (the TPU kernel's bit
//   order).  The stream is XORed into the stored words, as in
//   sim_search.cu.
// * First user slot: the header chunk (slots 0..7) is masked out of word 0
//   for the first-match only (the emitted bitmap keeps every match, as the
//   TPU kernel's does); each warp takes its lowest word with a user bit and
//   __ffs; after one barrier warp 0 combines the eight with
//   __reduce_min_sync, then lanes 0..15 copy chunk min(slot >> 3, 63) of
//   the value planes, interleaving lo/hi words per slot (word 2s is slot
//   s's lo word, 2s + 1 its hi word), or write zeros on a miss, while lanes
//   16..31 store the bitmap: each a 64 B row.  The chunk leaves still
//   randomized, as stored: the host tail de-randomizes it.

#include "sim_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = sim::kSlots / kThreads;
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kRowPlaneBytes = sim::kSlots * sizeof(uint32_t);

__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(p),
               "r"(bytes)
               : "memory");
}

__global__ void __launch_bounds__(kThreads) lookup_kernel(
    const uint32_t* __restrict__ klo, const uint32_t* __restrict__ khi,
    const uint32_t* __restrict__ vlo, const uint32_t* __restrict__ vhi,
    const uint2* __restrict__ queries, const uint2* __restrict__ masks,
    const uint32_t* __restrict__ key_ids,
    const uint32_t* __restrict__ key_seeds,
    const int32_t* __restrict__ key_rows,
    const int32_t* __restrict__ value_rows, uint32_t* __restrict__ bitmap_out,
    uint32_t* __restrict__ value_out, int32_t* __restrict__ slot_out,
    int randomized) {
  __shared__ uint32_t bitmap[sim::kBitmapWords];
  __shared__ uint32_t warp_first[kWarps];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;

  const size_t krow = key_rows ? static_cast<uint32_t>(key_rows[b])
                               : static_cast<uint32_t>(b);
  const size_t vrow = value_rows ? static_cast<uint32_t>(value_rows[b])
                                 : static_cast<uint32_t>(b);
  const uint32_t* vlo_row = vlo + vrow * sim::kSlots;
  const uint32_t* vhi_row = vhi + vrow * sim::kSlots;
  if (t == 0) {
    prefetch_l2(vlo_row, kRowPlaneBytes);
    prefetch_l2(vhi_row, kRowPlaneBytes);
  }
  const uint32_t* klo_row = klo + krow * sim::kSlots;
  const uint32_t* khi_row = khi + krow * sim::kSlots;
  uint32_t d_lo[kPerThread], d_hi[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    d_lo[k] = klo_row[t + k * kThreads];
    d_hi[k] = khi_row[t + k * kThreads];
  }
  const uint2 q = queries[b];
  const uint2 m = masks[b];
  if (randomized) {
    const uint32_t id = key_ids[krow];
    const uint32_t seed = key_seeds[krow];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const uint32_t ctr = sim::stream_ctr(id, seed, t + k * kThreads);
      d_lo[k] ^= sim::mix2_32(ctr, sim::kLoSalt);
      d_hi[k] ^= sim::mix2_32(ctr, sim::kHiSalt);
    }
  }

  uint32_t first = sim::kNoSlot;
#pragma unroll
  for (int k = kPerThread - 1; k >= 0; --k) {   // the lowest word wins
    const bool hit = (((d_lo[k] ^ q.x) & m.x) | ((d_hi[k] ^ q.y) & m.y)) == 0u;
    const uint32_t bits = __ballot_sync(0xFFFFFFFFu, hit);
    const int w = k * kWarps + warp;
    if (lane == 0) bitmap[w] = bits;
    // Slots 0..7 are the header chunk: never a user entry.
    const uint32_t user = w == 0 ? (bits & 0xFFFFFF00u) : bits;
    if (user != 0u) first = static_cast<uint32_t>(w * 32 + __ffs(user) - 1);
  }
  if (lane == 0) warp_first[warp] = first;
  __syncthreads();
  if (warp != 0) return;

  first = __reduce_min_sync(0xFFFFFFFFu,
                            lane < kWarps ? warp_first[lane] : sim::kNoSlot);
  if (lane < sim::kChunkWords) {
    uint32_t v = 0u;
    if (first < sim::kNoSlot) {
      const uint32_t chunk =
          min(first >> 3, static_cast<uint32_t>(sim::kChunks - 1));
      const uint32_t src = chunk * sim::kSlotsPerChunk + (lane >> 1);
      v = (lane & 1) ? vhi_row[src] : vlo_row[src];
    }
    value_out[static_cast<size_t>(b) * sim::kChunkWords + lane] = v;
  } else {
    const int w = lane - sim::kChunkWords;
    bitmap_out[static_cast<size_t>(b) * sim::kBitmapWords + w] = bitmap[w];
  }
  if (lane == 0) slot_out[b] = static_cast<int32_t>(first);
}

}  // namespace

// klo, khi, vlo, vhi: key and value planes, (cap, 512) arenas (the same
// arena may be passed as both); key_ids, key_seeds: (cap,) of the key
// planes; key_rows, value_rows: (B,) int32 rows, or null for rows 0..B-1;
// queries, masks: (B, 2); bitmap_out, value_out: (B, 16); slot_out: (B,)
// int32.  uint32 unless noted, contiguous, on `device`.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int sim_lookup_launch(const void* klo, const void* khi,
                                 const void* vlo, const void* vhi,
                                 const void* queries, const void* masks,
                                 const void* key_ids, const void* key_seeds,
                                 const void* key_rows, const void* value_rows,
                                 void* bitmap_out, void* value_out,
                                 void* slot_out, int n_rows, int randomized,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  lookup_kernel<<<n_rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(klo), static_cast<const uint32_t*>(khi),
      static_cast<const uint32_t*>(vlo), static_cast<const uint32_t*>(vhi),
      static_cast<const uint2*>(queries), static_cast<const uint2*>(masks),
      static_cast<const uint32_t*>(key_ids),
      static_cast<const uint32_t*>(key_seeds),
      static_cast<const int32_t*>(key_rows),
      static_cast<const int32_t*>(value_rows),
      static_cast<uint32_t*>(bitmap_out), static_cast<uint32_t*>(value_out),
      static_cast<int32_t*>(slot_out), randomized);
  return static_cast<int>(cudaGetLastError());
}
