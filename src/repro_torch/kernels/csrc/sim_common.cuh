// Shared device helpers for the SiM kernels: the §IV-C1 randomization
// stream and the page geometry.  Bit-identical to core/bits.py::mix2_32 and
// core/randomize.py (uint32 arithmetic wraps mod 2^32 on both sides).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sim {

constexpr int kSlots = 512;         // 8-byte slots per 4 KiB page
constexpr int kBitmapWords = 16;    // 512 match bits packed into uint32 words
constexpr int kChunks = 64;         // 64 B chunks per page
constexpr int kChunkWords = 16;     // uint32 words per chunk (8 slots x lo/hi)
constexpr int kSlotsPerChunk = 8;
constexpr uint32_t kNoSlot = 512;   // first-match sentinel: no user slot matched
constexpr uint32_t kLoSalt = 0x9E3779B9u;
constexpr uint32_t kHiSalt = 0x7F4A7C15u;

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t mix2_32(uint32_t x, uint32_t salt) {
  return fmix32(fmix32(x) ^ salt);
}

// Stream counter of slot `slot` of a page at flash address `page_id` on a
// chip with seed `seed`: (page_id * 512 + slot) ^ seed.
__device__ __forceinline__ uint32_t stream_ctr(uint32_t page_id, uint32_t seed,
                                               int slot) {
  return (page_id * static_cast<uint32_t>(kSlots) +
          static_cast<uint32_t>(slot)) ^ seed;
}

// Streaming multiprocessors of `device` (132 on the H100 SXM if the query
// fails), read once per device.
inline int sm_count(int device) {
  static int counts[64];
  if (device < 0 || device >= 64) return 132;
  if (counts[device] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess || n <= 0) {
      n = 132;
    }
    counts[device] = n;
  }
  return counts[device];
}

// Query tiles of the kernels whose grid is (page, query tile): at most
// kMaxQueryTile queries a block, halving (64, 32, 16, 8) while the grid has
// fewer blocks than the card has SMs.
constexpr int kMaxQueryTile = 64;
constexpr int kMinQueryTile = 8;

inline int query_tile(int n_pages, int n_queries, int device) {
  const int sms = sm_count(device);
  int tile = kMaxQueryTile;
  while (tile > kMinQueryTile &&
         static_cast<long long>(n_pages) * ((n_queries + tile - 1) / tile) <
             sms) {
    tile >>= 1;
  }
  return tile;
}

}  // namespace sim
