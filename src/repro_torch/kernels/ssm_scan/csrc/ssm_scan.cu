// Mamba selective-state-space scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ssm_kernel` in
// src/repro/kernels/ssm_scan/ssm_scan.py (launched by `ssm_scan_fwd`,
// reached through `ops.ssm_scan`).
//
// What it computes.  For dt, x (B, S, di) in f32 or bf16, a (di, N),
// b, c (B, S, N) and h0 (B, di, N), all f32:
//     h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t
//     y_t = sum_n h_t[:, n] * C_t[n]
// with y (B, S, di) in dt's dtype and h_final (B, di, N) in f32.  All
// arithmetic is f32 and uses `expf` (the build has no fast-math flag), so
// it agrees with the plain version to f32 rounding.  Any S >= 1 is taken
// as it is: the TPU wrapper pads S to a chunk multiple with dt = 0; here
// the last time tile is simply shorter.  A ragged di is masked.
//
// What bounds it.  The bytes are dt, x and y (B*S*di each) plus b, c, a,
// h0 and h_final; at hymba-1.5b prefill (di = 3200, N = 16, S = 300, f32)
// about 12.2 MB, 3.6 us at 3.35 TB/s.  The arithmetic (about 6 flops per
// state element per step) is below that.  What really limits it is the
// serial chain: each state element takes S dependent steps of an exp, an
// fma and a 16-lane shuffle reduction, and only B * di * N = 51,200
// elements exist at B = 1, too few to hide that latency on 132 SMs.
//
// What the design does about it.  The TPU grid carries h in VMEM across
// its sequential chunk axis; here the time loop runs inside one block and
// nothing passes between blocks.  One thread per (channel, n): a block of
// 256 threads holds 256 / N channels, their state in registers, and y_t
// is a shuffle reduction over the N lanes of a channel.  Grid
// (ceil(di / (256 / N)), B): 200 blocks at hymba for B = 1.  A tile of
// time steps of dt and x (the block's channels) and of b and c is staged
// in shared memory by all threads, so each step reads them from shared
// memory, and the tile's y is staged there too and written out row by
// row.  Not yet used: splitting the sequence into chunks scanned in
// parallel with a second pass to carry the state, cp.async / TMA
// prefetch of the next tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmemBytes = 48 * 1024;   // no opt-in needed below this

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Shared memory per time step of a tile: dt, x, y for the block's
// channels and b, c for the N states (floats).
__host__ __device__ constexpr int floats_per_step(int n) {
  return 3 * (kThreads / n) + 2 * n;
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ dt, const T* __restrict__ x,
                const float* __restrict__ a, const float* __restrict__ bm,
                const float* __restrict__ cm, const float* __restrict__ h0,
                T* __restrict__ y, float* __restrict__ hf, int S, int di,
                int tile) {
  constexpr int CPB = kThreads / N;   // channels per block
  extern __shared__ float smem[];
  float* sDt = smem;
  float* sX = sDt + tile * CPB;
  float* sY = sX + tile * CPB;
  float* sB = sY + tile * CPB;
  float* sC = sB + tile * N;

  const int tid = threadIdx.x;
  const int cl = tid / N, n = tid % N;
  const int c0 = blockIdx.x * CPB;
  const int ch = c0 + cl;
  const long long b = blockIdx.y;
  const bool live = ch < di;
  const long long hidx = (b * di + ch) * N + n;

  const float an = live ? a[static_cast<long long>(ch) * N + n] : 0.f;
  float h = live ? h0[hidx] : 0.f;

  for (int t0 = 0; t0 < S; t0 += tile) {
    const int nt = min(tile, S - t0);
    const long long row0 = b * S + t0;   // row of (b, t0) in (B*S, ·)
    __syncthreads();                     // the last tile's sY is written
    for (int i = tid; i < nt * CPB; i += kThreads) {
      const int t = i / CPB, c = i % CPB;
      const bool ok = c0 + c < di;
      const long long off = (row0 + t) * di + c0 + c;
      sDt[i] = ok ? to_f(dt[off]) : 0.f;
      sX[i] = ok ? to_f(x[off]) : 0.f;
    }
    for (int i = tid; i < nt * N; i += kThreads) {
      sB[i] = bm[row0 * N + i];
      sC[i] = cm[row0 * N + i];
    }
    __syncthreads();

    // every thread runs every step (dead channels on zeros), so all 32
    // lanes of each warp reach the shuffles
    for (int t = 0; t < nt; ++t) {
      const float d = sDt[t * CPB + cl];
      const float dx = d * sX[t * CPB + cl];
      h = expf(d * an) * h + dx * sB[t * N + n];
      float p = h * sC[t * N + n];
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (n == 0) sY[t * CPB + cl] = p;
    }
    __syncthreads();

    for (int i = tid; i < nt * CPB; i += kThreads) {
      const int t = i / CPB, c = i % CPB;
      if (c0 + c < di) store_f(y + (row0 + t) * di + c0 + c, sY[i]);
    }
  }
  if (live) hf[hidx] = h;
}

template <typename T, int N>
int launch(const void* dt, const void* x, const void* a, const void* b,
           const void* c, const void* h0, void* y, void* hf, int B, int S,
           int di, int chunk, cudaStream_t stream) {
  constexpr int CPB = kThreads / N;
  constexpr int kStepBytes = floats_per_step(N) * static_cast<int>(sizeof(float));
  // time steps per tile: the caller's chunk, at most S and at most what
  // fits in 48 KB of shared memory
  const int tile = std::max(
      1, std::min({chunk, std::max(S, 1), kMaxSmemBytes / kStepBytes}));
  const int smem = tile * kStepBytes;
  dim3 grid((di + CPB - 1) / CPB, B);
  ssm_scan_kernel<T, N><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(x),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(h0),
      static_cast<T*>(y), static_cast<float*>(hf), S, di, tile);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_n(int N, const void* dt, const void* x, const void* a,
               const void* b, const void* c, const void* h0, void* y,
               void* hf, int B, int S, int di, int chunk,
               cudaStream_t stream) {
#define SSM_CASE(NN)                                                     \
  case NN:                                                               \
    return launch<T, NN>(dt, x, a, b, c, h0, y, hf, B, S, di, chunk,     \
                         stream);
  switch (N) {
    SSM_CASE(1)
    SSM_CASE(2)
    SSM_CASE(4)
    SSM_CASE(8)
    SSM_CASE(16)
    SSM_CASE(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SSM_CASE
}

}  // namespace

// dtype of dt, x and y: 0 = float32, 1 = bfloat16.  a, b, c, h0 and hf
// are float32.  All tensors contiguous.  `chunk` caps the time steps
// staged in shared memory at once.
extern "C" int ssm_scan_launch(const void* dt, const void* x, const void* a,
                               const void* b, const void* c, const void* h0,
                               void* y, void* hf, int dtype, int B, int S,
                               int di, int N, int chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk < 1 || B < 1 || di < 1 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_n<float>(N, dt, x, a, b, c, h0, y, hf, B, S, di, chunk, s);
  if (dtype == 1)
    return dispatch_n<__nv_bfloat16>(N, dt, x, a, b, c, h0, y, hf, B, S, di,
                                     chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
