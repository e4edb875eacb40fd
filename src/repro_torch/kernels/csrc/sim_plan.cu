// SiM fused range plan on Hopper: G plan groups of P masked-equality passes
// against N pages, ONE combined 512-bit bitmap per (group, page): the OR of
// the include passes' matches AND-NOT the OR of the exclude passes' matches
// (paper Fig 10, the in-latch accumulation of a §V-C range decomposition).
//
// Replaces the TPU kernel src/repro/kernels/sim_plan/sim_plan.py
// (_plan_kernel, launched by _sim_plan_call / sim_plan_kernel).
//
// What bounds it on the H100: the page planes are read once (4 KiB a page)
// and 64 B of bitmap is written per (group, page), while every real pass
// costs about 7 integer operations per slot; with a few passes the 32-bit
// integer issue rate, not HBM, is the bound.  At the replay's shapes (one
// group, one or two pages padded to 32) the grid is 32 blocks, a quarter
// of the 132 SMs, so a launch is latency-bound in practice.
//
// Design: one block per page, one thread per slot (512 threads, 16 warps),
// as in sim_search.cu.  Each thread loads its lo/hi words once and XORs the
// §IV-C1 stream into them once, not into every pass.  The TPU kernel keeps
// a (P, pages, 512) match intermediate in VMEM and reduces it; here each
// thread keeps two booleans across the pass loop instead: `inc` ORs the
// include matches and `exc` the exclude matches.  A group's pass rows are
// staged through shared memory kPassTile at a time (query and mask as one
// uint4, read by every warp as a broadcast), so any P fits.  The flag alone
// decides how a row enters: a PASS_PAD row has q = 0 and m = 0, which
// matches every slot, so it is skipped by its flag, never by its value;
// an all-PAD group, or one with no include pass, yields an all-zero bitmap.
// __ballot_sync(inc && !exc) packs one bitmap word per warp (bit i of word
// w = slot 32w + i).

#include "sim_common.cuh"

namespace {

constexpr int kPassTile = 256;          // pass rows staged per tile
constexpr uint32_t kPassInclude = 1u;   // kernels/sim_plan/ref.py PASS_*
constexpr uint32_t kPassExclude = 2u;

__global__ void __launch_bounds__(sim::kSlots) plan_kernel(
    const uint32_t* __restrict__ lo, const uint32_t* __restrict__ hi,
    const uint32_t* __restrict__ queries, const uint32_t* __restrict__ masks,
    const uint32_t* __restrict__ flags, const uint32_t* __restrict__ page_ids,
    const uint32_t* __restrict__ page_seeds, uint32_t* __restrict__ out,
    int n_pages, int n_groups, int n_passes, int randomized) {
  __shared__ uint4 s_qm[kPassTile];     // (q_lo, q_hi, m_lo, m_hi)
  __shared__ uint32_t s_flag[kPassTile];
  const int page = blockIdx.x;
  const int slot = threadIdx.x;
  const int warp = slot >> 5;
  const int lane = slot & 31;
  const size_t word = static_cast<size_t>(page) * sim::kSlots + slot;
  uint32_t d_lo = lo[word];
  uint32_t d_hi = hi[word];
  if (randomized) {
    const uint32_t ctr = sim::stream_ctr(page_ids[page], page_seeds[page], slot);
    d_lo ^= sim::mix2_32(ctr, sim::kLoSalt);
    d_hi ^= sim::mix2_32(ctr, sim::kHiSalt);
  }
  for (int g = 0; g < n_groups; ++g) {
    const size_t row0 = static_cast<size_t>(g) * n_passes;
    bool inc = false;
    bool exc = false;
    for (int p0 = 0; p0 < n_passes; p0 += kPassTile) {
      const int n = min(kPassTile, n_passes - p0);
      __syncthreads();                  // every warp is done with the last tile
      if (slot < n) {
        const size_t r = row0 + p0 + slot;
        s_qm[slot] = make_uint4(queries[2 * r], queries[2 * r + 1],
                                masks[2 * r], masks[2 * r + 1]);
        s_flag[slot] = flags[r];
      }
      __syncthreads();
      for (int p = 0; p < n; ++p) {
        const uint32_t f = s_flag[p];   // uniform across the block
        if (f != kPassInclude && f != kPassExclude) continue;   // PASS_PAD
        const uint4 qm = s_qm[p];
        const bool hit =
            (((d_lo ^ qm.x) & qm.z) | ((d_hi ^ qm.y) & qm.w)) == 0u;
        if (f == kPassInclude) {
          inc |= hit;
        } else {
          exc |= hit;
        }
      }
    }
    const uint32_t bits = __ballot_sync(0xFFFFFFFFu, inc && !exc);
    if (lane == 0) {
      out[(static_cast<size_t>(g) * n_pages + page) * sim::kBitmapWords +
          warp] = bits;
    }
  }
}

}  // namespace

// lo, hi: (N, 512); queries, masks: (G, P, 2); flags: (G, P);
// page_ids, page_seeds: (N,); out: (G, N, 16).  All uint32, contiguous, on
// `device`.  Launches on `stream` and returns cudaGetLastError().
extern "C" int sim_plan_launch(const void* lo, const void* hi,
                               const void* queries, const void* masks,
                               const void* flags, const void* page_ids,
                               const void* page_seeds, void* out, int n_pages,
                               int n_groups, int n_passes, int randomized,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  plan_kernel<<<n_pages, sim::kSlots, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
      static_cast<const uint32_t*>(queries), static_cast<const uint32_t*>(masks),
      static_cast<const uint32_t*>(flags),
      static_cast<const uint32_t*>(page_ids),
      static_cast<const uint32_t*>(page_seeds), static_cast<uint32_t*>(out),
      n_pages, n_groups, n_passes, randomized);
  return static_cast<int>(cudaGetLastError());
}
