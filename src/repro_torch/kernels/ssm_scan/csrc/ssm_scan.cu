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
// C interface: ssm_scan_launch returns 0 or a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace

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
