// The mamba heads' recurrence on Hopper: the depthwise causal conv step
// with its SiLU (mamba_conv_kernel) and the selective scan
// (mamba_scan_kernel), the two kernels that models/ssm.py's apply_mamba
// runs around its three projections when it serves.
//
// Replaces no Pallas kernel: the JAX package scans with jax.lax.scan and
// has no kernel for the recurrence.  These were added because the plain
// PyTorch version dispatches some 36 kernels a layer at a decode step and
// about 13 a 16-position chunk in a prefill, each a few microseconds of
// host time for a few hundred kilobytes of state.
//
// Semantics (held against ../mamba_scan/ref.py): xz (B, S, 2e) is the
// in_proj product in T (float or bf16), u its first e columns and z its
// last e, both read in place through xz's row stride.
// - mamba_conv: y[t] = silu(sum_i upad[t + i] w[i]), upad = [tail | u]
//   along the sequence, K taps.  Each product and each partial sum is
//   rounded to T in the plain version's order (0 + p0 + p1 + ...), the
//   SiLU runs in float32 and rounds once, so the output is the plain
//   version's bit for bit.  The new tail, the last K - 1 inputs, is written
//   over the old one.
// - mamba_scan: from the x_proj product (B, S, 2N + 1) in T or float32
//   (b_t, c_t, dt), delta = softplus(dt) in logaddexp(dt, 0)'s form,
//   a = -exp(a_log); each position in order h = exp(delta a) h +
//   (delta u) b_t, y = c_t . h + u d_skip, in float32; the output
//   T(T(y) T(silu(z))).  Every product and sum is rounded where the plain
//   version rounds (no fused multiply-adds); only the sum over the N states
//   of c_t . h runs in another order (a tree of shuffles).  The final state is
//   written over the initial one.
//
// What bounds them on the H100: at a decode step (S = 1) the bytes, about
// 0.6 MB a layer at hymba-1.5b-base's widths (state read and written,
// a_log), some 0.2 us at 3.35 TB/s, so a launch is latency-bound and what
// counts is that it is one launch.  In a prefill the scan walks its S
// positions in order: at S = 1,024 its bytes (proj, u, z and y, some
// 20 MB) bound it at 6.1 us, its float32 operations (7 a state and
// position, 9 more a channel and position) at 5.9, and the walk takes
// about 31 times that; the conv is bound by its bytes.
//
// Design:
// - In place.  Both kernels read their channel's old state (the conv tail,
//   the scan state) before they write the new one, and no other thread
//   reads it, so the caller hands them its caches' views and copies
//   nothing back.
// - mamba_conv: one thread a (row, channel, chunk of 16 positions), grid
//   (channel tiles of 128, chunks, B): a thread loads its chunk's 16 + K - 1
//   inputs into registers at once (consecutive threads read consecutive
//   channels of a position), then sums its 16 positions.  Only chunk 0
//   reads the old tail (16 >= K - 1), and the same thread writes the new
//   one after it has read all of it.
// - mamba_scan: one thread a (row, channel, state), a channel's N states
//   (N a power of two, 4 to 32, a template parameter) on N neighbouring
//   lanes.  A block of 128 threads walks the sequence in order, 64
//   positions a tile: the tile's b, c and softplus(dt) (shared by every
//   channel), its channels' u and T(silu(z)) are staged in shared memory
//   first.  A lane runs N positions' updates back to back, keeping each
//   position's c_t h_t, so the dependent chain of a step is a multiply and
//   an add (the exp's operand does not depend on h); the N positions' sums
//   over the N lanes then take N - 1 shuffles (a transposing reduction:
//   lane n ends with position n's sum) instead of N log N, and lane n
//   writes position n's output.  Without branches in the step loop, the
//   next group's updates overlap this group's shuffles.  At decode
//   3,200 x 16 = 51,200 threads fill the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxConv = 8;          // taps K
constexpr int kConvThreads = 128;    // channels a conv block
constexpr int kConvChunk = 16;       // positions a conv thread; >= K - 1
constexpr int kScanThreads = 128;
constexpr int kScanTile = 64;        // positions staged at once
constexpr unsigned kFull = 0xFFFFFFFFu;

static_assert(kConvChunk >= kMaxConv - 1, "only chunk 0 may read the tail");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T, as a float: the rounding point of an operation in T.
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

// PyTorch's silu in float32: x / (1 + exp(-x)).
__device__ __forceinline__ float silu(float x) {
  return __fdiv_rn(x, __fadd_rn(1.0f, expf(-x)));
}

// softplus as torch.logaddexp(x, 0) computes it.
__device__ __forceinline__ float softplus(float x) {
  return __fadd_rn(fmaxf(x, 0.0f), log1pf(expf(-fabsf(x))));
}

template <typename T>
__global__ void __launch_bounds__(kConvThreads) mamba_conv_kernel(
    const T* __restrict__ xz, T* tail, const T* __restrict__ w,
    T* __restrict__ y, int seq, int width, int taps) {
  const int c = blockIdx.x * kConvThreads + threadIdx.x;
  if (c >= width) return;
  const int b = blockIdx.z;
  const int t0 = blockIdx.y * kConvChunk;
  const int k1 = taps - 1;
  const size_t row = 2 * static_cast<size_t>(width);
  const T* u = xz + static_cast<size_t>(b) * seq * row + c;
  T* tl = tail + static_cast<size_t>(b) * k1 * width + c;
  T* out = y + static_cast<size_t>(b) * seq * width + c;
  // in[i] = upad[t0 + i], i < 16 + K - 1: the chunk's inputs and the K - 1
  // after its first, all loaded before any is used; position t0 + p reads
  // in[p + q] for tap q
  float in[kConvChunk + kMaxConv - 1];
  float tap[kMaxConv];
#pragma unroll
  for (int q = 0; q < kMaxConv; ++q) {
    tap[q] = q < taps ? to_f(w[static_cast<size_t>(q) * width + c]) : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kConvChunk + kMaxConv - 1; ++i) {
    const int j = t0 + i;
    in[i] = i >= kConvChunk + k1 || j >= seq + k1 ? 0.0f
            : j < k1 ? to_f(tl[static_cast<size_t>(j) * width])
                     : to_f(u[static_cast<size_t>(j - k1) * row]);
  }
#pragma unroll
  for (int p = 0; p < kConvChunk; ++p) {
    if (t0 + p < seq) {
      float acc = 0.0f;
#pragma unroll
      for (int q = 0; q < kMaxConv; ++q) {
        if (q < taps) {
          acc = rnd<T>(__fadd_rn(acc, rnd<T>(__fmul_rn(in[p + q], tap[q]))));
        }
      }
      out[static_cast<size_t>(t0 + p) * width] = from_f<T>(silu(acc));
    }
  }
  if (blockIdx.y == 0) {
    // The new tail is upad[S .. S + K - 2], read (the old tail where S < K
    // - 1, else u) before any of it is written.
    float next[kMaxConv - 1];
#pragma unroll
    for (int j = 0; j < kMaxConv - 1; ++j) {
      const int src = seq + j;
      next[j] = j >= k1   ? 0.0f
                : src < k1 ? to_f(tl[static_cast<size_t>(src) * width])
                           : to_f(u[static_cast<size_t>(src - k1) * row]);
    }
#pragma unroll
    for (int j = 0; j < kMaxConv - 1; ++j) {
      if (j < k1) tl[static_cast<size_t>(j) * width] = from_f<T>(next[j]);
    }
  }
}

// Lane n of a channel's N lanes holds v[j] = its term of position j's sum;
// returns, on lane n, position n's sum over the N lanes: each halving
// step trades half of a lane's positions with its partner's (N - 1
// shuffles for N sums, against N log N for N separate trees).
template <int N>
__device__ __forceinline__ float transpose_sum(float (&v)[N], int n) {
#pragma unroll
  for (int o = N / 2; o > 0; o /= 2) {
    const bool upper = n & o;
#pragma unroll
    for (int j = 0; j < o; ++j) {
      const float send = upper ? v[j] : v[j + o];
      const float keep = upper ? v[j + o] : v[j];
      v[j] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, o));
    }
  }
  return v[0];
}

template <typename T, typename P, int N>
__global__ void __launch_bounds__(kScanThreads) mamba_scan_kernel(
    const T* __restrict__ xz, const T* __restrict__ u,
    const P* __restrict__ proj, const float* __restrict__ a_log,
    const float* __restrict__ d_skip, float* state, T* __restrict__ y,
    int seq, int width) {
  constexpr int kPer = kScanThreads / N;   // channels a block
  constexpr int kCols = 2 * N + 1;         // b, c, dt of a position
  static_assert(kScanTile % N == 0, "a tile holds whole groups");
  __shared__ float s_proj[kScanTile * kCols];   // dt as softplus(dt)
  __shared__ float s_u[kScanTile][kPer + 1];
  __shared__ float s_g[kScanTile][kPer + 1];    // T(silu(z))
  const int n = threadIdx.x % N;
  const int cl = threadIdx.x / N;
  const int c0 = blockIdx.x * kPer;
  const int c = c0 + cl;
  const int b = blockIdx.y;
  const bool live = c < width;
  const size_t row = 2 * static_cast<size_t>(width);
  float* st = state + (static_cast<size_t>(b) * width + c) * N + n;
  float a = 0.0f, h = 0.0f, skip = 0.0f;
  if (live) {
    a = -expf(a_log[static_cast<size_t>(c) * N + n]);
    h = *st;
    skip = d_skip[c];
  }
  const P* pb = proj + static_cast<size_t>(b) * seq * kCols;
  const T* zb = xz + static_cast<size_t>(b) * seq * row + width;
  const T* ub = u + static_cast<size_t>(b) * seq * width;
  T* yb = y + static_cast<size_t>(b) * seq * width;
  for (int t0 = 0; t0 < seq; t0 += kScanTile) {
    const int cnt = min(kScanTile, seq - t0);
    // Positions past the sequence, up to a whole group, stage as zeros:
    // delta 0 and u 0 leave h as it is (exp(0) h + 0).
    const int span = (cnt + N - 1) / N * N;
    __syncthreads();   // the last tile's reads are done
    for (int i = threadIdx.x; i < span * kCols; i += kScanThreads) {
      const float v =
          i < cnt * kCols ? to_f(pb[static_cast<size_t>(t0) * kCols + i])
                          : 0.0f;
      s_proj[i] = i % kCols == 2 * N && i < cnt * kCols ? softplus(v) : v;
    }
    for (int i = threadIdx.x; i < span * kPer; i += kScanThreads) {
      const int p = i / kPer, j = i - p * kPer;
      float uv = 0.0f, g = 0.0f;
      if (p < cnt && c0 + j < width) {
        const size_t t = t0 + p;
        uv = to_f(ub[t * width + c0 + j]);
        g = rnd<T>(silu(to_f(zb[t * row + c0 + j])));
      }
      s_u[p][j] = uv;
      s_g[p][j] = g;
    }
    __syncthreads();
    for (int q = 0; q < span; q += N) {
      float term[N];   // this lane's c_t h_t, t = q .. q + N - 1
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float* pp = s_proj + (q + j) * kCols;
        const float dl = pp[2 * N];
        const float decay = expf(__fmul_rn(dl, a));
        h = __fadd_rn(__fmul_rn(decay, h),
                      __fmul_rn(__fmul_rn(dl, s_u[q + j][cl]), pp[n]));
        term[j] = __fmul_rn(h, pp[N + n]);
      }
      const float sum = transpose_sum<N>(term, n);
      const int p = q + n;
      if (live && p < cnt) {
        const float yv = __fadd_rn(sum, __fmul_rn(s_u[p][cl], skip));
        yb[static_cast<size_t>(t0 + p) * width + c] =
            from_f<T>(__fmul_rn(rnd<T>(yv), s_g[p][cl]));
      }
    }
  }
  if (live) *st = h;
}

template <typename T, typename P>
int launch_scan(const void* xz, const void* u, const void* proj,
                const void* a_log, const void* d_skip, void* state, void* y,
                int batch, int seq, int width, int n_state,
                cudaStream_t stream) {
  const auto go = [&](auto kernel, int n) {
    const int per = kScanThreads / n;
    const dim3 grid((width + per - 1) / per, batch);
    kernel<<<grid, kScanThreads, 0, stream>>>(
        static_cast<const T*>(xz), static_cast<const T*>(u),
        static_cast<const P*>(proj), static_cast<const float*>(a_log),
        static_cast<const float*>(d_skip), static_cast<float*>(state),
        static_cast<T*>(y), seq, width);
    return static_cast<int>(cudaGetLastError());
  };
  switch (n_state) {
    case 4: return go(mamba_scan_kernel<T, P, 4>, 4);
    case 8: return go(mamba_scan_kernel<T, P, 8>, 8);
    case 16: return go(mamba_scan_kernel<T, P, 16>, 16);
    case 32: return go(mamba_scan_kernel<T, P, 32>, 32);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// xz: (B, S, 2e) T; tail: (B, K - 1, e) T, read and then written; w: (K, e)
// T; y: (B, S, e) T.  T is float (dtype 0) or bf16 (dtype 1); contiguous,
// on `device`.  Launches on `stream` and returns cudaGetLastError().
extern "C" int mamba_conv_launch(const void* xz, void* tail, const void* w,
                                 void* y, int batch, int seq, int width,
                                 int taps, int dtype, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (taps < 1 || taps > kMaxConv) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((width + kConvThreads - 1) / kConvThreads,
                  (seq + kConvChunk - 1) / kConvChunk, batch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    mamba_conv_kernel<float><<<grid, kConvThreads, 0, s>>>(
        static_cast<const float*>(xz), static_cast<float*>(tail),
        static_cast<const float*>(w), static_cast<float*>(y), seq, width,
        taps);
  } else if (dtype == 1) {
    mamba_conv_kernel<__nv_bfloat16><<<grid, kConvThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(xz),
        static_cast<__nv_bfloat16*>(tail),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(y), seq, width, taps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// xz: (B, S, 2e) T; u: (B, S, e) T; proj: (B, S, 2N + 1), T or float
// (proj_f32); a_log: (e, N), d_skip: (e,), state: (B, e, N) float, the state
// read and then written; y: (B, S, e) T.  T as for mamba_conv_launch;
// N a power of two from 4 to 32.
extern "C" int mamba_scan_launch(const void* xz, const void* u,
                                 const void* proj, const void* a_log,
                                 const void* d_skip, void* state, void* y,
                                 int batch, int seq, int width, int n_state,
                                 int dtype, int proj_f32, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && proj_f32) {
    return launch_scan<float, float>(xz, u, proj, a_log, d_skip, state, y,
                                     batch, seq, width, n_state, s);
  }
  if (dtype == 1 && proj_f32) {
    return launch_scan<__nv_bfloat16, float>(xz, u, proj, a_log, d_skip,
                                             state, y, batch, seq, width,
                                             n_state, s);
  }
  if (dtype == 1) {
    return launch_scan<__nv_bfloat16, __nv_bfloat16>(
        xz, u, proj, a_log, d_skip, state, y, batch, seq, width, n_state, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
