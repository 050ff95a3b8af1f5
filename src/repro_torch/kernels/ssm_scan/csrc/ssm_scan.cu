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
// as it is (the TPU wrapper pads S with dt = 0); a ragged di is masked.
//
// What bounds it.  The bytes are dt, x and y (B*S*di each) plus b, c, a,
// h0 and h_final; at hymba-1.5b prefill (di = 3200, N = 16, S = 300, f32)
// about 12.2 MB, 3.6 us at 3.35 TB/s.  The arithmetic is one expf and
// three fma per state element and step, twice over (below): about 15
// instructions a state and step, some 14 M warp instructions at S = 300,
// 14 us at one instruction per cycle on every SM scheduler.  So the
// kernel is bound by instruction issue, not bytes.  What limited the
// first port was the serial chain: each state element walked all S
// steps, and only B * di * N = 51,200 chains existed at B = 1.
//
// What the design does about it.
// - Time chunks scanned in parallel.  The wrapper cuts S into n_chunks
//   chunks of chunk_len steps (the last one ragged; `chunk_plan` in
//   ops.py fills the SMs, and decode or a short prompt keeps one chunk).
//   Pass 1 (`ssm_chunk_state`, chunks 0 .. n_chunks-2) scans each chunk
//   from h = 0 (chunk 0 from h0) and keeps its end state and its decay,
//   the product of the same per-step factors expf(dt_t * a) that the
//   scan applies (never exp(a * sum dt), which rounds differently).
//   `ssm_carry` then carries the state over the chunks in order,
//   H_k = decay_k * H_{k-1} + end_k, one thread per (batch row, state,
//   channel) chain.  Pass 2 (`ssm_scan_kernel`) rescans every chunk from
//   its carried state, writes y, and the last chunk writes h_final.  One
//   chunk: pass 2 alone, from h0.  So a call is one CUDA launch at decode
//   and for prompts under 32 steps, three above.
// - One thread per channel, its N states, N decay factors and the N
//   entries of A in registers: no shuffle, and N independent chains per
//   thread.  The y sum over N uses four partial sums, off the h chain.
//   128 channels per block; grid (channel blocks, chunks, B).
// - Time tiles of dt, x (the block's channels) and b, c staged in shared
//   memory, double-buffered: the next tile is loaded with cp.async while
//   this one is scanned (bf16 dt/x take ordinary loads).
//
// The backward (`ssm_scan_bwd_launch`, behind `ops.ssm_scan_bwd` and
// `SSMScan.backward`).  It replaces no TPU kernel: `repro` lets XLA
// differentiate its chunked scan (src/repro/layers/mamba.py:129 calls
// `ssm_scan_chunked`); this computes what `ref.ssm_scan_bwd_plain` does.
// The cotangent of the state runs backward in time,
//     g_t = exp(dt_{t+1} A) * g_{t+1} + gy_t * C_t,   from ghf,
// and with gf_t = g_t * h_{t-1} * exp(dt_t A):
//     d dt_t = sum_n gf_t A + x_t sum_n g_t B_t,  d x_t = dt_t sum_n g_t B_t,
//     d A = sum_{b,t} dt_t gf_t,  d B_t = sum_d g_t dt_t x_t,
//     d C_t = sum_d h_t gy_t,  d h0 = exp(dt_0 A) g_0.
// Precision: over a state that lives hundreds of steps (mamba's dt and
// A at hymba-1.5b's train shape) a float32 backward misses the exact
// d dt and d C by more than 2e-5 where their terms cancel, so both
// recurrences, the factors exp(dt A) and every sum run in float64, as
// the plain version does; reads and writes stay in the inputs' dtypes.
// What bounds it: about 20 float64 operations a state element and step
// (2 x 256 x 3200 x 16 at hymba: 0.52 GFLOP, 15 us at the 34 TFLOP/s of
// float64 outside the tensor cores) against 34.5 MB of inputs,
// cotangents and gradients (10 us at 3.35 TB/s).
// Design, four launches in a fixed order and no atomics, so a call's
// bits do not depend on scheduling:
// - chunks of 16 steps; pass 1 (`ssm_bwd_chunk`), one thread per (row,
//   chunk, channel, state), keeps each chunk's end state from 0, its
//   decay, and the cotangent it sends back when none arrives at its end;
// - `ssm_bwd_carry` runs both carries over the chunks (forward from h0,
//   backward from ghf), in place, and writes d h0;
// - pass 2 (`ssm_bwd_grad`) rescans a chunk's 16 states from its start
//   into registers and walks back from its carried cotangent; the sums
//   over N (d dt, d x) and over a block's channels (d B, d C) are taken
//   in shared memory in a fixed order.  No tensor holds a state for
//   every step: the chunk aggregates are 3 / 16 of one;
// - `ssm_bwd_reduce` sums d A over rows and chunks and d B, d C over the
//   channel blocks, in order.
//
// C interface: ssm_scan_launch and ssm_scan_bwd_launch return 0 or a
// cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 128;      // channels per block
constexpr int kTile = 16;          // time steps per staged tile, at most

__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <int N>
struct Tiles {
  float dt[2][kTile][kThreads];
  float x[2][kTile][kThreads];
  float b[2][kTile][N];
  float c[2][kTile][N];
};

// Issue the loads of steps [t0, t0 + nt) of batch row `bi` into buffer
// `buf`: f32 through cp.async, bf16 by ordinary loads.
template <typename T, int N>
__device__ __forceinline__ void stage(Tiles<N>& sm, int buf, const T* dt,
                                      const T* x, const float* bm,
                                      const float* cm, long long bi, int S,
                                      int di, int ch, bool live, int t0,
                                      int nt, bool need_c) {
  const int tid = threadIdx.x;
  const long long row0 = bi * S + t0;
  if (live) {
    for (int i = 0; i < nt; ++i) {
      const long long off = (row0 + i) * di + ch;
      if constexpr (sizeof(T) == 4) {
        cp_async4(&sm.dt[buf][i][tid], dt + off);
        cp_async4(&sm.x[buf][i][tid], x + off);
      } else {
        sm.dt[buf][i][tid] = to_f(dt[off]);
        sm.x[buf][i][tid] = to_f(x[off]);
      }
    }
  }
  for (int i = tid; i < nt * N; i += kThreads) {
    cp_async4(&sm.b[buf][0][0] + i, bm + row0 * N + i);
    if (need_c) cp_async4(&sm.c[buf][0][0] + i, cm + row0 * N + i);
  }
  cp_async_commit();
}

// One channel's row of N floats of a or h0 into registers, with 16-byte
// loads where N and the address allow.
template <int N>
__device__ __forceinline__ void load_row(float (&r)[N], const float* p) {
  if constexpr (N % 4 == 0) {
    if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
      for (int n = 0; n < N; n += 4) {
        const float4 v = *reinterpret_cast<const float4*>(p + n);
        r[n] = v.x;
        r[n + 1] = v.y;
        r[n + 2] = v.z;
        r[n + 3] = v.w;
      }
      return;
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) r[n] = p[n];
}

// Pass 1: end state (from h = 0, or h0 for chunk 0) and decay of chunks
// 0 .. n_chunks-2.  agg: [2][B][n_chunks-1][N][di] (end states, then
// decays; channel fastest, so every access is coalesced).
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
ssm_chunk_state(const T* __restrict__ dt, const T* __restrict__ x,
                const float* __restrict__ a, const float* __restrict__ bm,
                const float* __restrict__ h0, float* __restrict__ agg, int S,
                int di, int chunk_len, int n_chunks, int tile) {
  __shared__ __align__(16) Tiles<N> sm;
  const int tid = threadIdx.x;
  const int ch = blockIdx.x * kThreads + tid;
  const int k = blockIdx.y;
  const long long bi = blockIdx.z;
  const bool live = ch < di;
  const int t_begin = k * chunk_len;
  const int len = min(chunk_len, S - t_begin);
  const long long nk = n_chunks - 1;
  const long long kstride = static_cast<long long>(N) * di;
  const long long plane = static_cast<long long>(gridDim.z) * nk * kstride;

  float an[N], h[N], dec[N];
  if (live) {
    load_row<N>(an, a + static_cast<long long>(ch) * N);
    if (k == 0) load_row<N>(h, h0 + (bi * di + ch) * N);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    if (!live) an[n] = 0.f;
    if (!live || k != 0) h[n] = 0.f;
    dec[n] = 1.f;
  }

  int buf = 0;
  int nt = min(tile, len);
  stage<T, N>(sm, 0, dt, x, bm, bm, bi, S, di, ch, live, t_begin, nt, false);
  for (int t0 = 0; t0 < len; t0 += tile) {
    const int next = t0 + tile;
    const int nt_next = min(tile, len - next);
    if (nt_next > 0) {
      stage<T, N>(sm, buf ^ 1, dt, x, bm, bm, bi, S, di, ch, live,
                  t_begin + next, nt_next, false);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll 2
    for (int i = 0; i < nt; ++i) {
      const float d = live ? sm.dt[buf][i][tid] : 0.f;
      const float dx = live ? d * sm.x[buf][i][tid] : 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float f = expf(d * an[n]);
        h[n] = f * h[n] + dx * sm.b[buf][i][n];
        dec[n] *= f;
      }
    }
    __syncthreads();   // this buffer is refilled two tiles on
    buf ^= 1;
    nt = nt_next;
  }

  if (live) {
    float* end = agg + (bi * nk + k) * kstride + ch;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      end[n * di] = h[n];
      end[plane + n * di] = dec[n];
    }
  }
}

// The carry, H_k = decay_k * H_{k-1} + end_k from H_0 = chunk 0's end
// state (it started from h0), in place over the end states: one thread
// per (batch row, state, channel) chain, coalesced.  The loads of eight
// chunks are issued before any of their results is stored, so the chain
// waits on one L2 round trip per eight chunks.
constexpr int kCarryThreads = 256;
constexpr int kCarryBatch = 8;

__global__ void __launch_bounds__(kCarryThreads)
ssm_carry(float* __restrict__ agg, long long chains, long long total,
          int nk) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kCarryThreads + threadIdx.x;
  if (idx >= total) return;
  const long long bi = idx / chains;
  float* e = agg + bi * nk * chains + idx % chains;
  const float* d = e + total * nk;
  float hc = e[0];
  for (int j0 = 1; j0 < nk; j0 += kCarryBatch) {
    float dv[kCarryBatch], ev[kCarryBatch];
#pragma unroll
    for (int u = 0; u < kCarryBatch; ++u) {
      const long long j = j0 + u < nk ? j0 + u : j0;
      dv[u] = d[j * chains];
      ev[u] = e[j * chains];
    }
#pragma unroll
    for (int u = 0; u < kCarryBatch; ++u) {
      if (j0 + u < nk) {
        hc = dv[u] * hc + ev[u];
        e[(j0 + u) * chains] = hc;
      }
    }
  }
}

// Pass 2: scan every chunk from its carried state (h0 for chunk 0, else
// H_{k-1} from pass 1), write y; the last chunk writes h_final.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ dt, const T* __restrict__ x,
                const float* __restrict__ a, const float* __restrict__ bm,
                const float* __restrict__ cm, const float* __restrict__ h0,
                const float* __restrict__ carried, T* __restrict__ y,
                float* __restrict__ hf, int S, int di, int chunk_len,
                int n_chunks, int tile) {
  __shared__ __align__(16) Tiles<N> sm;
  const int tid = threadIdx.x;
  const int ch = blockIdx.x * kThreads + tid;
  const int k = blockIdx.y;
  const long long bi = blockIdx.z;
  const bool live = ch < di;
  const int t_begin = k * chunk_len;
  const int len = min(chunk_len, S - t_begin);

  // h0 is (B, di, N); the carried states are [B][n_chunks-1][N][di]
  float an[N], h[N];
  if (live) {
    load_row<N>(an, a + static_cast<long long>(ch) * N);
    if (k == 0) {
      load_row<N>(h, h0 + (bi * di + ch) * N);
    } else {
      const float* hin =
          carried + ((bi * (n_chunks - 1) + (k - 1)) * N) * di + ch;
#pragma unroll
      for (int n = 0; n < N; ++n) h[n] = hin[n * di];
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    if (!live) an[n] = 0.f;
    if (!live) h[n] = 0.f;
  }

  int buf = 0;
  int nt = min(tile, len);
  stage<T, N>(sm, 0, dt, x, bm, cm, bi, S, di, ch, live, t_begin, nt, true);
  for (int t0 = 0; t0 < len; t0 += tile) {
    const int next = t0 + tile;
    const int nt_next = min(tile, len - next);
    if (nt_next > 0) {
      stage<T, N>(sm, buf ^ 1, dt, x, bm, cm, bi, S, di, ch, live,
                  t_begin + next, nt_next, true);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    T* yrow = y + (bi * S + t_begin + t0) * di + ch;
#pragma unroll 2
    for (int i = 0; i < nt; ++i) {
      const float d = live ? sm.dt[buf][i][tid] : 0.f;
      const float dx = live ? d * sm.x[buf][i][tid] : 0.f;
      float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = expf(d * an[n]) * h[n] + dx * sm.b[buf][i][n];
        p[n & 3] += h[n] * sm.c[buf][i][n];
      }
      if (live) store_f(yrow + static_cast<long long>(i) * di,
                        (p[0] + p[1]) + (p[2] + p[3]));
    }
    __syncthreads();
    buf ^= 1;
    nt = nt_next;
  }
  if (live && k == n_chunks - 1) {
    float* out = hf + (bi * di + ch) * N;
    if constexpr (N % 4 == 0) {
#pragma unroll
      for (int n = 0; n < N; n += 4)
        *reinterpret_cast<float4*>(out + n) =
            make_float4(h[n], h[n + 1], h[n + 2], h[n + 3]);
    } else {
#pragma unroll
      for (int n = 0; n < N; ++n) out[n] = h[n];
    }
  }
}

struct Args {
  const void *dt, *x, *a, *b, *c, *h0;
  void *y, *hf;
  float* agg;
  int B, S, di, chunk_len, n_chunks, tile;
  cudaStream_t stream;
};

template <typename T, int N>
int launch(const Args& g) {
  const int cbs = (g.di + kThreads - 1) / kThreads;
  const T* dt = static_cast<const T*>(g.dt);
  const T* x = static_cast<const T*>(g.x);
  const float* a = static_cast<const float*>(g.a);
  const float* b = static_cast<const float*>(g.b);
  const float* c = static_cast<const float*>(g.c);
  const float* h0 = static_cast<const float*>(g.h0);
  if (g.n_chunks > 1) {
    ssm_chunk_state<T, N><<<dim3(cbs, g.n_chunks - 1, g.B), kThreads, 0,
                            g.stream>>>(dt, x, a, b, h0, g.agg, g.S, g.di,
                                        g.chunk_len, g.n_chunks, g.tile);
    const long long chains = static_cast<long long>(N) * g.di;
    const long long total = chains * g.B;
    ssm_carry<<<static_cast<unsigned>((total + kCarryThreads - 1) /
                                      kCarryThreads),
                kCarryThreads, 0, g.stream>>>(g.agg, chains, total,
                                              g.n_chunks - 1);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ssm_scan_kernel<T, N><<<dim3(cbs, g.n_chunks, g.B), kThreads, 0,
                          g.stream>>>(dt, x, a, b, c, h0, g.agg,
                                      static_cast<T*>(g.y),
                                      static_cast<float*>(g.hf), g.S, g.di,
                                      g.chunk_len, g.n_chunks, g.tile);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_n(int N, const Args& g) {
  switch (N) {
    case 1: return launch<T, 1>(g);
    case 2: return launch<T, 2>(g);
    case 4: return launch<T, 4>(g);
    case 8: return launch<T, 8>(g);
    case 16: return launch<T, 16>(g);
    case 32: return launch<T, 32>(g);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// Backward: the gradients of (y, h_final), in float64
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 256;   // one thread per (channel, state)
constexpr int kBwdChunk = 16;      // time steps a chunk (held in registers)
constexpr int kBwdGroups = 4;      // channel groups the gradient pass walks
constexpr int kMaxDevices = 64;

__device__ __forceinline__ double to_d(float v) {
  return static_cast<double>(v);
}
__device__ __forceinline__ double to_d(__nv_bfloat16 v) {
  return static_cast<double>(__bfloat162float(v));
}

// A load the compiler may not merge with an earlier one of the same
// address: the gradient pass reads a step's inputs again on its way back
// (from L1) instead of holding 16 steps of them in registers.
__device__ __forceinline__ double ld_again(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return static_cast<double>(v);
}
__device__ __forceinline__ double ld_again(const __nv_bfloat16* p) {
  unsigned short v;
  asm volatile("ld.global.nc.b16 %0, [%1];" : "=h"(v) : "l"(p));
  return static_cast<double>(__bfloat162float(__ushort_as_bfloat16(v)));
}

// Pass 1, one thread per (batch row, chunk, channel, state): the chunk's
// end state from h = 0 (E), its decay D = prod exp(dt_t a), and the
// cotangent it sends back through its first step when none arrives at
// its end, Eg = sum_t (prod_{s <= t} exp(dt_s a)) * gy_t c_t.
// agg: [3][B][n_chunks][di * N] doubles (E, D, Eg).
template <typename T, int N>
__global__ void __launch_bounds__(kBwdThreads)
ssm_bwd_chunk(const T* __restrict__ dt, const T* __restrict__ x,
              const float* __restrict__ a, const float* __restrict__ bm,
              const float* __restrict__ cm, const T* __restrict__ gy,
              double* __restrict__ agg, int S, int di, int n_chunks) {
  const long long din = static_cast<long long>(di) * N;
  const long long j = static_cast<long long>(blockIdx.x) * kBwdThreads +
                      threadIdx.x;
  if (j >= din) return;
  const int d = static_cast<int>(j / N), n = static_cast<int>(j % N);
  const int k = blockIdx.y;
  const long long bi = blockIdx.z;
  const int t0 = k * kBwdChunk;
  const int len = min(kBwdChunk, S - t0);
  const double an = a[j];
  double h = 0.0, dec = 1.0, eg = 0.0;
#pragma unroll 4
  for (int i = 0; i < len; ++i) {
    const long long row = bi * S + t0 + i;
    const double dtv = to_d(dt[row * di + d]);
    const double f = exp(dtv * an);
    h = f * h + (dtv * to_d(x[row * di + d])) * static_cast<double>(bm[row * N + n]);
    dec *= f;
    if (gy != nullptr)
      eg += dec * (to_d(gy[row * di + d]) * static_cast<double>(cm[row * N + n]));
  }
  const long long plane = static_cast<long long>(gridDim.z) * n_chunks * din;
  double* out = agg + (bi * n_chunks + k) * din + j;
  out[0] = h;
  out[plane] = dec;
  out[2 * plane] = eg;
}

// The two carries, one thread per (batch row, channel, state) chain, in
// place: forward from h0, E_k becomes chunk k's start state; backward
// from ghf, Eg_k becomes the cotangent arriving at chunk k's last step.
// What is left after chunk 0 is the cotangent of h0.  Eight chunks'
// loads are issued before their results are stored.
constexpr int kCarryBatchBwd = 8;

__global__ void __launch_bounds__(kBwdThreads)
ssm_bwd_carry(double* __restrict__ agg, const float* __restrict__ h0,
              const float* __restrict__ ghf, float* __restrict__ dh0,
              long long din, long long total, int nk) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kBwdThreads + threadIdx.x;
  if (idx >= total) return;
  const long long bi = idx / din, j = idx % din;
  const long long plane = total * nk;
  double* e = agg + bi * nk * din + j;
  const double* dec = e + plane;
  double* eg = e + 2 * plane;
  double h = h0[idx];
  for (int k0 = 0; k0 < nk; k0 += kCarryBatchBwd) {
    double ev[kCarryBatchBwd], dv[kCarryBatchBwd];
#pragma unroll
    for (int u = 0; u < kCarryBatchBwd; ++u) {
      const long long k = k0 + u < nk ? k0 + u : k0;
      ev[u] = e[k * din];
      dv[u] = dec[k * din];
    }
#pragma unroll
    for (int u = 0; u < kCarryBatchBwd; ++u) {
      if (k0 + u < nk) {
        e[(k0 + u) * din] = h;
        h = dv[u] * h + ev[u];
      }
    }
  }
  double g = ghf != nullptr ? static_cast<double>(ghf[idx]) : 0.0;
  for (int k1 = nk - 1; k1 >= 0; k1 -= kCarryBatchBwd) {
    double ev[kCarryBatchBwd], dv[kCarryBatchBwd];
#pragma unroll
    for (int u = 0; u < kCarryBatchBwd; ++u) {
      const long long k = k1 - u >= 0 ? k1 - u : k1;
      ev[u] = eg[k * din];
      dv[u] = dec[k * din];
    }
#pragma unroll
    for (int u = 0; u < kCarryBatchBwd; ++u) {
      if (k1 - u >= 0) {
        eg[(k1 - u) * din] = g;
        g = dv[u] * g + ev[u];
      }
    }
  }
  dh0[idx] = static_cast<float>(g);
}

// Pass 2: the gradients.  A block takes one chunk of one batch row and
// walks kBwdGroups groups of 256 / N channels; a thread owns one
// (channel, state).  It rescans the chunk's 16 states from the carried
// start state into registers, then walks back from the carried
// cotangent: g_t = exp(dt_{t+1} a) g_{t+1} + gy_t c_t.  The sums over N
// (d dt, d x) are taken across the channel's N lanes with shuffles (a
// fixed butterfly), and the channel's first lane stages d dt and d x in
// shared memory for one coalesced write of the group.  The terms of d b
// and d c go to shared memory, where the group's channels are summed in
// order; d b and d c are summed over the groups in registers and written
// as the block's partial; each thread's d a over the chunk overwrites D
// in agg (no longer read).  part: [2][n_cb][B][S][N] doubles.  In shared
// memory a channel's N terms of a step sit in a row of N + 1 doubles
// (N > 1), so that the sums read 16 different banks across a half warp.
// About 72 KB of shared memory at N = 16.
template <int N>
struct BwdRed {
  static constexpr int kCh = kBwdThreads / N;               // channels a group
  static constexpr int kPairs = (kBwdChunk * N + kBwdThreads - 1) /
                                kBwdThreads;                // (t, n) a thread
  static constexpr int kRow = N == 1 ? 1 : N + 1;          // a channel's terms
  static constexpr int kStep = kCh * kRow;                  // a step's terms
  static constexpr int kBytes = 2 * kBwdChunk * kStep * 8 +
                                2 * kBwdChunk * kCh * 4;
};

template <typename T, int N>
__global__ void __launch_bounds__(kBwdThreads)
ssm_bwd_grad(const T* __restrict__ dt, const T* __restrict__ x,
             const float* __restrict__ a, const float* __restrict__ bm,
             const float* __restrict__ cm, const T* __restrict__ gy,
             double* __restrict__ agg, double* __restrict__ part,
             T* __restrict__ ddt, T* __restrict__ dx, int S, int di,
             int n_chunks) {
  using R = BwdRed<N>;
  // [2][kBwdChunk][kCh][N + 1] doubles, then [2][kBwdChunk][kCh] floats
  extern __shared__ __align__(16) double red[];
  double* r_c = red;
  double* r_b = red + kBwdChunk * R::kStep;
  float* o_dt = reinterpret_cast<float*>(red + 2 * kBwdChunk * R::kStep);
  float* o_dx = o_dt + kBwdChunk * R::kCh;
  const int tid = threadIdx.x;
  const int n = tid % N, cl = tid / N;
  const int k = blockIdx.y;
  const long long bi = blockIdx.z;
  const int t0 = k * kBwdChunk;
  const int len = min(kBwdChunk, S - t0);
  const long long din = static_cast<long long>(di) * N;
  const long long plane = static_cast<long long>(gridDim.z) * n_chunks * din;
  const long long chunk_off = (bi * n_chunks + k) * din;
  double acc_c[R::kPairs], acc_b[R::kPairs];
#pragma unroll
  for (int q = 0; q < R::kPairs; ++q) acc_c[q] = acc_b[q] = 0.0;

  for (int grp = 0; grp < kBwdGroups; ++grp) {
    const int base = (blockIdx.x * kBwdGroups + grp) * R::kCh;
    if (base >= di) break;                       // uniform over the block
    const int d = base + cl;
    const bool live = d < di;
    const long long j = static_cast<long long>(d) * N + n;
    const double an = live ? static_cast<double>(a[j]) : 0.0;
    const double h_start = live ? agg[chunk_off + j] : 0.0;
    double g = live ? agg[2 * plane + chunk_off + j] : 0.0;

    double hs[kBwdChunk], fs[kBwdChunk];
    double h = h_start;
#pragma unroll
    for (int i = 0; i < kBwdChunk; ++i) {
      const bool in = live && i < len;
      const long long row = bi * S + t0 + i;
      const double dtv = in ? to_d(dt[row * di + d]) : 0.0;
      const double xv = in ? to_d(x[row * di + d]) : 0.0;
      const double bv = i < len ? static_cast<double>(bm[row * N + n]) : 0.0;
      const double f = exp(dtv * an);
      h = f * h + (dtv * xv) * bv;
      hs[i] = h;
      fs[i] = f;
    }
    double da = 0.0;
#pragma unroll
    for (int i = kBwdChunk - 1; i >= 0; --i) {
      const bool in = live && i < len;
      const long long row = bi * S + t0 + i;
      const double dtv = in ? ld_again(dt + row * di + d) : 0.0;
      const double xv = in ? ld_again(x + row * di + d) : 0.0;
      const double gyv = in && gy != nullptr ? to_d(gy[row * di + d]) : 0.0;
      const double bv = i < len ? ld_again(bm + row * N + n) : 0.0;
      const double cv = i < len ? static_cast<double>(cm[row * N + n]) : 0.0;
      g = g + gyv * cv;                                   // g_t
      const double hp = i > 0 ? hs[i - 1] : h_start;     // h_{t-1}
      const double gf = g * hp * fs[i];                  // d / d(dt a)
      double s_dt = gf * an, s_u = g * bv;
#pragma unroll
      for (int o = N / 2; o > 0; o >>= 1) {
        s_dt += __shfl_xor_sync(0xffffffffu, s_dt, o);
        s_u += __shfl_xor_sync(0xffffffffu, s_u, o);
      }
      if (n == 0) {
        o_dt[i * R::kCh + cl] = static_cast<float>(s_dt + xv * s_u);
        o_dx[i * R::kCh + cl] = static_cast<float>(dtv * s_u);
      }
      const int at = i * R::kStep + cl * R::kRow + n;
      r_c[at] = hs[i] * gyv;
      r_b[at] = g * (dtv * xv);
      da += gf * dtv;
      g = fs[i] * g;                                      // to h_{t-1}
    }
    if (live) agg[plane + chunk_off + j] = da;
    __syncthreads();
    // d dt = sum_n gf a + x sum_n g b and d x = dt sum_n g b of the
    // group, written a step at a time across its channels
    for (int p = tid; p < R::kCh * kBwdChunk; p += kBwdThreads) {
      const int c2 = p % R::kCh, i = p / R::kCh;
      const int d2 = base + c2;
      if (d2 < di && i < len) {
        const long long at = (bi * S + t0 + i) * di + d2;
        store_f(ddt + at, o_dt[i * R::kCh + c2]);
        store_f(dx + at, o_dx[i * R::kCh + c2]);
      }
    }
    // d c and d b: one (step, state) a thread, the group's channels
    // summed in order, the groups in order
#pragma unroll
    for (int q = 0; q < R::kPairs; ++q) {
      const int p = tid + q * kBwdThreads;
      if (p < kBwdChunk * N) {
        const int i = p / N, m = p % N;
        double s_c = 0.0, s_b = 0.0;
        for (int c2 = 0; c2 < R::kCh; ++c2) {
          s_c += r_c[i * R::kStep + c2 * R::kRow + m];
          s_b += r_b[i * R::kStep + c2 * R::kRow + m];
        }
        acc_c[q] += s_c;
        acc_b[q] += s_b;
      }
    }
    __syncthreads();   // the terms are rewritten by the next group
  }
  const long long bsn = static_cast<long long>(gridDim.z) * S * N;
#pragma unroll
  for (int q = 0; q < R::kPairs; ++q) {
    const int p = tid + q * kBwdThreads;
    if (p < kBwdChunk * N) {
      const int i = p / N, m = p % N;
      if (i < len) {
        const long long at = blockIdx.x * bsn + (bi * S + t0 + i) * N + m;
        part[at] = acc_c[q];
        part[gridDim.x * bsn + at] = acc_b[q];
      }
    }
  }
}

// The cross-block sums in a fixed order: d a over batch rows and chunks,
// d c and d b over the channel blocks.
__global__ void __launch_bounds__(kBwdThreads)
ssm_bwd_reduce(const double* __restrict__ agg,
               const double* __restrict__ part, float* __restrict__ da,
               float* __restrict__ dc, float* __restrict__ db,
               long long din, long long bsn, int rows_chunks, int n_cb) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kBwdThreads + threadIdx.x;
  if (idx < din) {
    const double* p = agg + static_cast<long long>(rows_chunks) * din + idx;
    double s = 0.0;
    for (int r = 0; r < rows_chunks; ++r) s += p[r * din];
    da[idx] = static_cast<float>(s);
  } else if (idx < din + bsn) {
    const long long m = idx - din;
    double s_c = 0.0, s_b = 0.0;
    for (int cb = 0; cb < n_cb; ++cb) {
      s_c += part[cb * bsn + m];
      s_b += part[(n_cb + cb) * bsn + m];
    }
    dc[m] = static_cast<float>(s_c);
    db[m] = static_cast<float>(s_b);
  }
}

// the channel blocks of the gradient pass
int bwd_channel_blocks(int di, int N) {
  const int per = (kBwdThreads / N) * kBwdGroups;
  return (di + per - 1) / per;
}

long long bwd_chunks(int S) { return (S + kBwdChunk - 1) / kBwdChunk; }

struct BwdArgs {
  const void *dt, *x, *a, *b, *c, *h0, *gy, *ghf;
  void *ddt, *dx, *da, *db, *dc, *dh0;
  double* work;
  int B, S, di;
  cudaStream_t stream;
};

template <typename T, int N>
int launch_bwd(const BwdArgs& g) {
  using R = BwdRed<N>;
  auto grad = ssm_bwd_grad<T, N>;
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(
        grad, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev].store(true, std::memory_order_relaxed);
  }
  const T* dt = static_cast<const T*>(g.dt);
  const T* x = static_cast<const T*>(g.x);
  const T* gy = static_cast<const T*>(g.gy);
  const float* a = static_cast<const float*>(g.a);
  const float* b = static_cast<const float*>(g.b);
  const float* c = static_cast<const float*>(g.c);
  const int nk = static_cast<int>(bwd_chunks(g.S));
  const long long din = static_cast<long long>(g.di) * N;
  const long long total = din * g.B;
  const long long bsn = static_cast<long long>(g.B) * g.S * N;
  const int n_cb = bwd_channel_blocks(g.di, N);
  double* agg = g.work;
  double* part = g.work + 3 * total * nk;
  ssm_bwd_chunk<T, N><<<dim3(static_cast<unsigned>(
                                 (din + kBwdThreads - 1) / kBwdThreads),
                             nk, g.B),
                        kBwdThreads, 0, g.stream>>>(dt, x, a, b, c, gy, agg,
                                                    g.S, g.di, nk);
  ssm_bwd_carry<<<static_cast<unsigned>((total + kBwdThreads - 1) /
                                        kBwdThreads),
                  kBwdThreads, 0, g.stream>>>(
      agg, static_cast<const float*>(g.h0),
      static_cast<const float*>(g.ghf), static_cast<float*>(g.dh0), din,
      total, nk);
  grad<<<dim3(n_cb, nk, g.B), kBwdThreads, R::kBytes, g.stream>>>(
      dt, x, a, b, c, gy, agg, part, static_cast<T*>(g.ddt),
      static_cast<T*>(g.dx), g.S, g.di, nk);
  ssm_bwd_reduce<<<static_cast<unsigned>((din + bsn + kBwdThreads - 1) /
                                         kBwdThreads),
                   kBwdThreads, 0, g.stream>>>(
      agg, part, static_cast<float*>(g.da), static_cast<float*>(g.dc),
      static_cast<float*>(g.db), din, bsn, g.B * nk, n_cb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_bwd(int N, const BwdArgs& g) {
  switch (N) {
    case 1: return launch_bwd<T, 1>(g);
    case 2: return launch_bwd<T, 2>(g);
    case 4: return launch_bwd<T, 4>(g);
    case 8: return launch_bwd<T, 8>(g);
    case 16: return launch_bwd<T, 16>(g);
    case 32: return launch_bwd<T, 32>(g);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Doubles of scratch ssm_scan_bwd_launch needs: the chunk aggregates
// (3 * B * ceil(S / 16) * di * N) and the d b / d c partials of the
// channel blocks (2 * n_cb * B * S * N).
extern "C" long long ssm_scan_bwd_scratch(int B, int S, int di, int N) {
  if (B < 1 || S < 1 || di < 1 || N < 1 || N > 32) return -1;
  return 3LL * B * bwd_chunks(S) * di * N +
         2LL * bwd_channel_blocks(di, N) * B * S * N;
}

// Gradients of (y, h_final) = scan(dt, x, a, b, c, h0) for the
// cotangents gy (B, S, di) in dt's dtype and ghf (B, di, N) float32;
// either may be null (zero).  Writes ddt, dx (dt's dtype) and da, db,
// dc, dh0 (float32); `work` holds ssm_scan_bwd_scratch(...) doubles.
// dtype: 0 = float32, 1 = bfloat16.  Four launches, no atomics: the
// same inputs give the same bits.
extern "C" int ssm_scan_bwd_launch(const void* dt, const void* x,
                                   const void* a, const void* b,
                                   const void* c, const void* h0,
                                   const void* gy, const void* ghf,
                                   void* ddt, void* dx, void* da, void* db,
                                   void* dc, void* dh0, void* work,
                                   int dtype, int B, int S, int di, int N,
                                   void* stream) {
  if (B < 1 || S < 1 || di < 1 || work == nullptr ||
      bwd_chunks(S) > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs g{dt, x, a, b, c, h0, gy, ghf, ddt, dx, da, db, dc, dh0,
            static_cast<double*>(work), B, S, di,
            static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_bwd<float>(N, g);
  if (dtype == 1) return dispatch_bwd<__nv_bfloat16>(N, g);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype of dt, x and y: 0 = float32, 1 = bfloat16.  a, b, c, h0 and hf
// are float32; all tensors contiguous.  The sequence is cut into
// n_chunks chunks of chunk_len steps (only the last may be shorter);
// with n_chunks > 1, `agg` holds 2 * B * (n_chunks - 1) * di * N floats of
// scratch.  `tile` caps the time steps staged in shared memory at once.
extern "C" int ssm_scan_launch(const void* dt, const void* x, const void* a,
                               const void* b, const void* c, const void* h0,
                               void* y, void* hf, void* agg, int dtype, int B,
                               int S, int di, int N, int chunk_len,
                               int n_chunks, int tile, void* stream) {
  if (B < 1 || di < 1 || S < 1 || chunk_len < 1 || n_chunks < 1 ||
      n_chunks > 65535 || tile < 1 ||
      static_cast<long long>(chunk_len) * (n_chunks - 1) >= S ||
      static_cast<long long>(chunk_len) * n_chunks < S ||
      (n_chunks > 1 && agg == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args g{dt, x, a, b, c, h0, y, hf, static_cast<float*>(agg), B, S, di,
         chunk_len, n_chunks, tile < kTile ? tile : kTile,
         static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_n<float>(N, g);
  if (dtype == 1) return dispatch_n<__nv_bfloat16>(N, g);
  return static_cast<int>(cudaErrorInvalidValue);
}
