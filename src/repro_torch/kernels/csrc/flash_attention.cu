// Flash attention on Hopper: tiled online-softmax attention with GQA,
// causal and sliding-window masks, for prefill (Sq = Sk) and decode (Sq = 1
// against a cache) alike.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// (_attn_kernel, launched by flash_attention_kernel).  The TPU version walks
// its k tiles as a sequential grid axis and carries (acc, m, l) in VMEM
// scratch between grid steps; here one block loops over the k tiles itself
// and keeps the running state in registers.  Unlike the TPU wrapper, which
// falls back to dense XLA attention for shapes that do not tile, this kernel
// takes any Sq and Sk.
//
// Semantics (held against ref.py::attention_ref): q (BH, Sq, D), k/v
// (BHkv, Sk, D), flattened head-major, q row bh reads kv row bh / group.
// Query row i sits at absolute position q_offset + i and sees key j when
// j <= q_offset + i (causal) and j > q_offset + i - window (window > 0).
// Logits, running max, denominator and accumulator are float32; masked
// logits are -1e30, so exp() of a masked logit is 0 and never NaN; a row
// that sees no key gives 0.  The output is rounded once, to q's dtype.
//
// What bounds it on the H100: at the serve path's shapes (prefill Sq = Sk
// <= 16; decode Sq = 1 against a 128-token cache) the bytes: q, k and v are
// read once and the output written once, a few hundred KB a launch against
// 2 * BH * Sq * Sk * D multiply-adds, so a launch is latency-bound.  At
// Sq = Sk = 256 the operations bound it, and this kernel runs them on the
// CUDA cores in float32, not on the tensor cores: wgmma, TMA and a bf16
// product are for a later change.
//
// Design: grid (ceil(Sq / 16), BH), 128 threads = 4 warps, each warp owning
// 4 query rows.  The block stages its q tile (16 x D) and then, one 32-key
// tile at a time, k and v (32 x D) in shared memory as float32; k rows are
// padded to D + 1 words so that lane j reading key j's word d hits bank
// (j + d) % 32.  Lane j scores key j of the tile against a row (D
// multiply-adds, q read as a broadcast), the warp takes the tile's max and
// sum with butterfly shuffles, and lane l accumulates output dims l, l + 32,
// ... with the 32 probabilities broadcast by __shfl_sync.  k tiles outside
// the block's visible range (past the last row's causal limit, before the
// first row's window) are never loaded; a row skips a tile in which it sees
// no key.  Templated on the element type (float, bf16) and on D in {32, 64,
// 128}; shared memory is 41,088 bytes at D = 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;
constexpr int kBlockK = 32;                    // one key per lane
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) attn_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int sq, int sk, int group, float scale, int causal,
    int window, int q_offset) {
  constexpr int kPerLane = D / 32;
  __shared__ float q_s[kBlockQ][D];
  __shared__ float k_s[kBlockK][D + 1];
  __shared__ float v_s[kBlockK][D];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const T* q_bh = q + static_cast<size_t>(bh) * sq * D;
  const T* k_bh = k + static_cast<size_t>(bh / group) * sk * D;
  const T* v_bh = v + static_cast<size_t>(bh / group) * sk * D;

  for (int i = threadIdx.x; i < kBlockQ * D; i += kThreads) {
    const int r = i / D;
    q_s[r][i % D] = q0 + r < sq
        ? to_f32(q_bh[static_cast<size_t>(q0 + r) * D + i % D]) : 0.f;
  }

  // Keys [k_begin, k_end) are the only ones any row of this block can see.
  const int last_pos = q_offset + min(q0 + kBlockQ, sq) - 1;
  const int k_end = causal ? min(sk, last_pos + 1) : sk;
  const int k_begin = window > 0 ? max(0, q_offset + q0 - window + 1) : 0;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kPerLane];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) acc[rr][i] = 0.f;
  }

  for (int kt = (k_begin / kBlockK) * kBlockK; kt < k_end; kt += kBlockK) {
    __syncthreads();                     // the previous tile is consumed
    for (int i = threadIdx.x; i < kBlockK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const bool in = kt + r < sk;
      const size_t src = static_cast<size_t>(kt + r) * D + d;
      k_s[r][d] = in ? to_f32(k_bh[src]) : 0.f;
      v_s[r][d] = in ? to_f32(v_bh[src]) : 0.f;
    }
    __syncthreads();                     // q (first time), k and v staged

    const int col = kt + lane;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      if (q0 + r >= sq) continue;        // uniform across the warp
      const int pos = q_offset + q0 + r;
      bool keep = col < sk;
      if (causal) keep = keep && col <= pos;
      if (window > 0) keep = keep && col > pos - window;
      float s = kNegInf;
      if (keep) {
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot += q_s[r][d] * k_s[lane][d];
        s = dot * scale;
      }
      const float m_cur = warp_max(s);
      if (m_cur == kNegInf) continue;    // the row sees no key in this tile
      const float m_new = fmaxf(m[rr], m_cur);
      const float p = keep ? expf(s - m_new) : 0.f;
      const float corr = expf(m[rr] - m_new);
      l[rr] = corr * l[rr] + warp_sum(p);
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) acc[rr][i] *= corr;
#pragma unroll 4
      for (int j = 0; j < kBlockK; ++j) {
        const float pj = __shfl_sync(kFull, p, j);
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) acc[rr][i] += pj * v_s[j][lane + 32 * i];
      }
      m[rr] = m_new;
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    if (q0 + r >= sq) continue;
    T* o = out + (static_cast<size_t>(bh) * sq + q0 + r) * D;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      store(o + lane + 32 * i, l[rr] == 0.f ? 0.f : acc[rr][i] / l[rr]);
    }
  }
}

template <typename T, int D>
int launch_typed(const void* q, const void* k, const void* v, void* out,
                 int bh, int sq, int sk, int group, float scale, int causal,
                 int window, int q_offset, cudaStream_t stream) {
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, bh);
  attn_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, sk, group, scale,
      causal, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(const void* q, const void* k, const void* v, void* out, int bh,
               int sq, int sk, int d, int group, float scale, int causal,
               int window, int q_offset, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch_typed<T, 32>(q, k, v, out, bh, sq, sk, group, scale,
                                 causal, window, q_offset, stream);
    case 64:
      return launch_typed<T, 64>(q, k, v, out, bh, sq, sk, group, scale,
                                 causal, window, q_offset, stream);
    case 128:
      return launch_typed<T, 128>(q, k, v, out, bh, sq, sk, group, scale,
                                  causal, window, q_offset, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, out: (bh, sq, d); k, v: (bh / group, sk, d); all of one element type,
// dtype 0 = float32, 1 = bfloat16; d in {32, 64, 128}; window 0 = none.
// Contiguous, on `device`.  Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for a dtype or d it does not
// take).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int bh, int sq,
                                      int sk, int d, int group, float scale,
                                      int causal, int window, int q_offset,
                                      int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_dim<float>(q, k, v, out, bh, sq, sk, d, group, scale, causal,
                             window, q_offset, s);
  }
  if (dtype == 1) {
    return launch_dim<__nv_bfloat16>(q, k, v, out, bh, sq, sk, d, group, scale,
                                     causal, window, q_offset, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
