// SiM paired point lookup on Hopper: row i matches query i against key page
// i, takes the first matching user slot and gathers that slot's 64 B chunk
// from the paired value page i — search, slot select and value gather in one
// launch.
//
// Replaces the TPU kernel src/repro/kernels/sim_fused/sim_fused.py
// (_lookup_kernel, launched by sim_lookup_kernel).  The cross-product
// _fused_kernel in the same file is ported in sim_fused.cu; the two select
// chunks differently (this one masks the header chunk, that one does not).
//
// What bounds it on the H100: bytes, then latency.  A row reads its 4 KiB of
// key planes once, runs about 45 integer operations per slot (the §IV-C1
// stream regeneration dominates, since each key page meets one query), and
// reads one 64 B value chunk on a hit.  At the replay's burst shapes (B = 64
// rows) the grid is 64 blocks, fewer than the 132 SMs, so a launch is
// latency-bound.
//
// Design: one block per row, one thread per slot.  The match is the one of
// sim_search.cu (stream XORed into the stored words, __ballot_sync packs a
// warp's 32 bits into bitmap word w, lane i = slot 32w + i).  The header
// chunk (slots 0..7) is masked out of the first-match ballot only; the
// emitted bitmap keeps every match, as the TPU kernel's does.  Each warp
// takes its first user slot with __ffs and the block's minimum is an
// atomicMin in shared memory; then 16 threads copy the chunk
// min(slot >> 3, 63) of the value planes, interleaving lo/hi words per slot
// (word 2s is slot s's lo word, word 2s + 1 its hi word), or write zeros on
// a miss.  The chunk leaves still randomized, as stored: the host tail
// de-randomizes it.

#include "sim_common.cuh"

namespace {

__global__ void __launch_bounds__(sim::kSlots) lookup_kernel(
    const uint32_t* __restrict__ klo, const uint32_t* __restrict__ khi,
    const uint32_t* __restrict__ vlo, const uint32_t* __restrict__ vhi,
    const uint32_t* __restrict__ queries, const uint32_t* __restrict__ masks,
    const uint32_t* __restrict__ key_ids,
    const uint32_t* __restrict__ key_seeds, uint32_t* __restrict__ bitmap_out,
    uint32_t* __restrict__ value_out, int32_t* __restrict__ slot_out,
    int randomized) {
  __shared__ unsigned int first_slot;
  const int row = blockIdx.x;
  const int slot = threadIdx.x;
  const int warp = slot >> 5;
  const int lane = slot & 31;
  if (slot == 0) first_slot = sim::kNoSlot;

  const size_t word = static_cast<size_t>(row) * sim::kSlots + slot;
  uint32_t d_lo = klo[word];
  uint32_t d_hi = khi[word];
  if (randomized) {
    const uint32_t ctr = sim::stream_ctr(key_ids[row], key_seeds[row], slot);
    d_lo ^= sim::mix2_32(ctr, sim::kLoSalt);
    d_hi ^= sim::mix2_32(ctr, sim::kHiSalt);
  }
  const uint32_t q_lo = queries[2 * row];
  const uint32_t q_hi = queries[2 * row + 1];
  const uint32_t m_lo = masks[2 * row];
  const uint32_t m_hi = masks[2 * row + 1];
  const bool hit = (((d_lo ^ q_lo) & m_lo) | ((d_hi ^ q_hi) & m_hi)) == 0u;
  const uint32_t bits = __ballot_sync(0xFFFFFFFFu, hit);
  __syncthreads();                       // first_slot is initialised
  if (lane == 0) {
    bitmap_out[static_cast<size_t>(row) * sim::kBitmapWords + warp] = bits;
    // Slots 0..7 are the header chunk: never a user entry.
    const uint32_t user = warp == 0 ? (bits & 0xFFFFFF00u) : bits;
    if (user != 0u) {
      atomicMin(&first_slot, static_cast<unsigned int>(warp * 32 + __ffs(user) - 1));
    }
  }
  __syncthreads();

  const uint32_t first = first_slot;
  if (slot < sim::kChunkWords) {
    uint32_t v = 0u;
    if (first < sim::kNoSlot) {
      const uint32_t chunk = min(first >> 3, static_cast<uint32_t>(sim::kChunks - 1));
      const size_t src = static_cast<size_t>(row) * sim::kSlots +
                         chunk * sim::kSlotsPerChunk + (slot >> 1);
      v = (slot & 1) ? vhi[src] : vlo[src];
    }
    value_out[static_cast<size_t>(row) * sim::kChunkWords + slot] = v;
  }
  if (slot == 0) slot_out[row] = static_cast<int32_t>(first);
}

}  // namespace

// klo, khi, vlo, vhi: (B, 512); queries, masks: (B, 2); key_ids,
// key_seeds: (B,); bitmap_out, value_out: (B, 16); slot_out: (B,) int32.
// uint32 unless noted, contiguous, on `device`.  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int sim_lookup_launch(const void* klo, const void* khi,
                                 const void* vlo, const void* vhi,
                                 const void* queries, const void* masks,
                                 const void* key_ids, const void* key_seeds,
                                 void* bitmap_out, void* value_out,
                                 void* slot_out, int n_rows, int randomized,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  lookup_kernel<<<n_rows, sim::kSlots, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(klo), static_cast<const uint32_t*>(khi),
      static_cast<const uint32_t*>(vlo), static_cast<const uint32_t*>(vhi),
      static_cast<const uint32_t*>(queries), static_cast<const uint32_t*>(masks),
      static_cast<const uint32_t*>(key_ids),
      static_cast<const uint32_t*>(key_seeds),
      static_cast<uint32_t*>(bitmap_out), static_cast<uint32_t*>(value_out),
      static_cast<int32_t*>(slot_out), randomized);
  return static_cast<int>(cudaGetLastError());
}
