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
// The bound: about 20 float64 operations a state element and step plus
// at least one exp(dt a) (2 x 256 x 3200 x 16 at hymba: 0.52 GFLOP, 15 us
// at the 34 TFLOP/s of float64 outside the tensor cores; 26 us with this
// file's exp at 14 operations) against 34.5 MB of inputs, cotangents and
// gradients (10 us at 3.35 TB/s).
// What bounds it on this card is latency, not a pipe: the shape has only
// B * di * N = 102,400 chains, each serial in time, so 800 warps at four
// states a thread, one or two an SM sub-partition; each warp's own
// instruction-level parallelism sets the time.  The four-launch kernel
// before this one (0.76 ms) lost it to a branch around every inlined
// exp, which kept the compiler from overlapping them, to 8 float
// conversions, 5 global loads and 64-bit index arithmetic a state step,
// and to chunk aggregates and carries written to and read from device
// memory (tools/kernel_ab.py cuts; PERF.md).
// Design, two launches in a fixed order and no atomics, so a call's bits
// do not depend on scheduling:
// - `ssm_bwd_grad`: a thread owns 4 states of one channel (N >= 4) and
//   walks their chains through the whole sequence in 8-step tiles: a
//   forward sweep that keeps the state at each tile start in scratch
//   (1 / 8 of a state in doubles), then, from the last tile to the first,
//   a rescan of the tile's factors and states into registers and the walk
//   of the cotangent.  No chunk aggregate or carry exists, and nothing of
//   a chain leaves registers but its tile starts.
// - Each tile's inputs are staged in shared memory as float64 once, for
//   the block's channels, double-buffered: each value is converted once a
//   block, not once a state.
// - The factor is this file's table exponential (`exp_bwd`, 8 float64
//   instructions, within 4.1e-11 of exp): float64 throughout, as the
//   plain version; a float32 expf would miss the gate (PERF.md).  A tile
//   computes all its factors before its chains, with no branch inside.
// - Sums over N (d dt, d x) by a butterfly over the channel's 4 lanes;
//   over a warp's channels (d b, d c) by a reduce-scatter of shuffles,
//   then over its warps in shared memory; d a over steps in registers.
// - `ssm_bwd_reduce` adds the blocks' d b, d c and the rows' d a in a
//   fixed order, eight threads an element.
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

constexpr int kBwdThreads = 128;
constexpr int kBwdTile = 8;        // steps a tile, rescanned into registers
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kMaxDevices = 64;

// A block's share of the work at state size N: a thread owns kS states of
// one channel, kG threads a channel, kC channels a block (one batch row).
constexpr int bwd_states(int N) { return N < 4 ? N : 4; }

template <int N>
struct BwdPlan {
  static constexpr int kS = bwd_states(N);
  static constexpr int kG = N / kS;
  static constexpr int kC = kBwdThreads / kG;
  // a tile's loads a thread: channel values, then b and c
  static constexpr int kLoads = (kBwdTile * kC + kBwdThreads - 1) /
                                kBwdThreads;
  static constexpr int kLoadsN = (kBwdTile * N + kBwdThreads - 1) /
                                 kBwdThreads;
};

// Shared memory of the gradient kernel: two buffers of a tile's inputs
// in float64 (the block's channels; b and c), and, by tile parity, each
// warp's sums over its channels of the d b and d c terms and a tile's
// d dt and d x for one coalesced write.
template <int N>
struct BwdSmem {
  using P = BwdPlan<N>;
  double dt[2][kBwdTile][P::kC], x[2][kBwdTile][P::kC];
  double dtx[2][kBwdTile][P::kC], gy[2][kBwdTile][P::kC];
  double b[2][kBwdTile][N], c[2][kBwdTile][N];
  double red[2][2][kBwdTile][kBwdWarps][N];     // [parity][d b, d c]
  float odt[2][kBwdTile][P::kC], odx[2][kBwdTile][P::kC];
  double table[16];
  double amax[kBwdWarps];                 // each warp's largest |a|
};

// 2^(i / 16), i = 0..15 (ref.EXP_TABLE)
__constant__ double kExpTable[16] = {
    0x1.0000000000000p+0, 0x1.0b5586cf9890fp+0, 0x1.172b83c7d517bp+0,
    0x1.2387a6e756238p+0, 0x1.306fe0a31b715p+0, 0x1.3dea64c123422p+0,
    0x1.4bfdad5362a27p+0, 0x1.5ab07dd485429p+0, 0x1.6a09e667f3bcdp+0,
    0x1.7a11473eb0187p+0, 0x1.8ace5422aa0dbp+0, 0x1.9c49182a3f090p+0,
    0x1.ae89f995ad3adp+0, 0x1.c199bdd85529cp+0, 0x1.d5818dcfba487p+0,
    0x1.ea4afa2a490dap+0};

// 16 / ln2, -ln2 / 16 and the polynomial's 1/24 and 1/6: read from the
// constant bank as operands (as literals nvcc rebuilt them at every call)
__constant__ double kExpC[4] = {0x1.71547652b82fep+4, -0x1.62e42fefa39efp-5,
                                1.0 / 24, 1.0 / 6};

// exp(x) in float64 (`ref.exp_f64`): x = j ln2 / 16 + r, |r| <= ln2 / 32,
// exp(x) = 2^(j >> 4) 2^((j & 15) / 16) p(r), p exp's Taylor polynomial
// of degree 4 (relative error below 4.1e-11): 8 float64 instructions and
// a table read, against libdevice's 16 (tools/kernel_sass.py).  The table
// sits in shared memory, where its 16 doubles fill the 32 banks once.  It
// holds for |x| < 700; a tile whose |dt a| may reach that (or NaN) takes
// libdevice's exp instead (kFar), so the common path has no branch that
// would keep the compiler from interleaving a tile's exponentials.
template <bool kFar>
__device__ __forceinline__ double exp_bwd(double x, const double* table) {
  if constexpr (kFar) {
    return exp(x);
  } else {
    const double shift = 0x1.8p52;       // j lands in the low word
    const double t = fma(x, kExpC[0], shift);
    const int j = __double2loint(t);
    const double r = fma(t - shift, kExpC[1], x);
    double p = fma(r, kExpC[2], kExpC[3]);
    p = fma(p, r, 0.5);
    p = fma(p, r, 1.0);
    p = fma(p, r, 1.0);
    const double y = table[j & 15] * p;
    return __hiloint2double(__double2hiint(y) + ((j >> 4) << 20),
                            __double2loint(y));
  }
}

__device__ __forceinline__ float to_f(float v) { return v; }

// The sum over a warp's channels of one term per state: the lanes that
// differ in bits M, M/2, .., G hold the same states of other channels.
// While a lane holds more than one sum it keeps half and sends half (a
// reduce-scatter), then the rest is a butterfly.  The order is fixed, so
// the bits are.  At the end each lane holds the sum of one of its states,
// state `off`, and the lanes whose butterfly bits are 0 write it.
template <int M, int G, int C, int S>
__device__ __forceinline__ void channel_sum(double (&v)[S], int lane,
                                            int& off, int& dup) {
  if constexpr (M >= G) {
    if constexpr (C > 1) {
      constexpr int H = C / 2;
      const bool up = lane & M;
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const double send = up ? v[j] : v[j + H];
        const double keep = up ? v[j + H] : v[j];
        v[j] = keep + __shfl_xor_sync(0xffffffffu, send, M);
      }
      if (up) off += H;
      channel_sum<M / 2, G, H, S>(v, lane, off, dup);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], M);
      dup |= M;
      channel_sum<M / 2, G, 1, S>(v, lane, off, dup);
    }
  }
}

// A warp's sums over its channels of the terms v (kS states a lane), at
// step i, into red[i][warp][n].
template <int N>
__device__ __forceinline__ void warp_channel_sums(
    double (&v)[BwdPlan<N>::kS], double (*red)[kBwdWarps][N], int i,
    int lane, int q) {
  using P = BwdPlan<N>;
  int off = 0, dup = 0;
  channel_sum<16, P::kG, P::kS, P::kS>(v, lane, off, dup);
  if ((lane & dup) == 0) red[i][threadIdx.x >> 5][q * P::kS + off] = v[0];
}

// One tile's inputs in registers, loaded from global memory (zero past S
// and di) while the tile before it is computed, then stored to a shared
// buffer in float64.
template <typename T, int N>
struct BwdTileRegs {
  using P = BwdPlan<N>;
  float dt[P::kLoads], x[P::kLoads], gy[P::kLoads];
  float b[P::kLoadsN], c[P::kLoadsN];

  __device__ __forceinline__ void load(const T* dtp, const T* xp,
                                       const T* gyp, const float* bm,
                                       const float* cm, int bi, int t0, int S,
                                       int di, int d0) {
#pragma unroll
    for (int j = 0; j < P::kLoads; ++j) {
      const int e = threadIdx.x + j * kBwdThreads;
      const int i = e / P::kC, d = d0 + e % P::kC, t = t0 + i;
      const bool ok = e < kBwdTile * P::kC && t < S && d < di;
      const size_t at = (static_cast<size_t>(bi) * S + t) * di + d;
      dt[j] = ok ? to_f(dtp[at]) : 0.f;
      x[j] = ok ? to_f(xp[at]) : 0.f;
      gy[j] = ok && gyp != nullptr ? to_f(gyp[at]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < P::kLoadsN; ++j) {
      const int e = threadIdx.x + j * kBwdThreads;
      const int t = t0 + e / N;
      const bool ok = e < kBwdTile * N && t < S;
      const size_t at = (static_cast<size_t>(bi) * S + t) * N + e % N;
      b[j] = ok ? bm[at] : 0.f;
      c[j] = ok ? cm[at] : 0.f;
    }
  }

  // whether a loaded |dt| may take |dt a| to 700 (or is NaN)
  __device__ __forceinline__ bool far(double dt_far) const {
    bool f = false;
#pragma unroll
    for (int j = 0; j < P::kLoads; ++j) f |= !(fabs(dt[j]) < dt_far);
    return f;
  }

  __device__ __forceinline__ void store(BwdSmem<N>& sm, int buf) const {
#pragma unroll
    for (int j = 0; j < P::kLoads; ++j) {
      const int e = threadIdx.x + j * kBwdThreads;
      const int i = e / P::kC, cl = e % P::kC;
      const double dtv = dt[j], xv = x[j];
      if (e < kBwdTile * P::kC) {
        sm.dt[buf][i][cl] = dtv;
        sm.x[buf][i][cl] = xv;
        sm.dtx[buf][i][cl] = dtv * xv;    // exact: two floats' product
        sm.gy[buf][i][cl] = gy[j];
      }
    }
#pragma unroll
    for (int j = 0; j < P::kLoadsN; ++j) {
      const int e = threadIdx.x + j * kBwdThreads;
      if (e < kBwdTile * N) {
        sm.b[buf][e / N][e % N] = b[j];
        sm.c[buf][e / N][e % N] = c[j];
      }
    }
  }
};

// A forward tile: the thread's kS states through the tile's steps.
template <bool kFar, int N>
__device__ __forceinline__ void forward_tile(
    double (&h)[BwdPlan<N>::kS], const BwdSmem<N>& sm, int buf, int cl,
    int q, const double (&an)[BwdPlan<N>::kS]) {
  constexpr int kS = BwdPlan<N>::kS;
#pragma unroll
  for (int i = 0; i < kBwdTile; ++i) {
    const double dtv = sm.dt[buf][i][cl], dtxv = sm.dtx[buf][i][cl];
#pragma unroll
    for (int s = 0; s < kS; ++s)
      h[s] = fma(dtxv, sm.b[buf][i][q * kS + s],
                 exp_bwd<kFar>(dtv * an[s], sm.table) * h[s]);
  }
}

// A backward tile's factors f_t = exp(dt_t a), all computed before its
// walk: the branch on the far range then holds no shuffle of the walk (a
// shuffle in a branch the compiler cannot prove uniform costs a sync).
template <bool kFar, int N>
__device__ __forceinline__ void tile_factors(
    double (&fr)[kBwdTile][BwdPlan<N>::kS], const BwdSmem<N>& sm, int buf,
    int cl, const double (&an)[BwdPlan<N>::kS]) {
#pragma unroll
  for (int i = 0; i < kBwdTile; ++i) {
    const double dtv = sm.dt[buf][i][cl];
#pragma unroll
    for (int s = 0; s < BwdPlan<N>::kS; ++s)
      fr[i][s] = exp_bwd<kFar>(dtv * an[s], sm.table);
  }
}

// The gradient kernel.  A block takes kC channels of one batch row; a
// thread walks its kS (channel, state) chains through all S steps, a
// tile of kBwdTile steps at a time, in two sweeps.
// - Forward, tiles 0 .. T-2: the state, kept at the start of tiles
//   1 .. T-2 in `ckpt` ([B][T-2][di * N]); the start of tile T-1 stays in
//   registers.
// - Backward, tiles T-1 .. 0: the tile's factors f_t = exp(dt_t a) and
//   products f_t h_{t-1} are rescanned from its start state into
//   registers (the terms h_t gy_t of d c on the way), then the cotangent
//   walks back, g_t = g + gy_t c_t, gf = g_t f_t h_{t-1}, g <- f_t g_t,
//   summing d dt, d x over the channel's states (its kG lanes, a
//   butterfly), d a over the steps in registers, and the d b terms
//   g_t dt_t x_t and the d c terms over the block's channels (each warp
//   by `channel_sum`, the warps in order in shared memory).  After tile
//   0, g is d h0.
// The block writes d dt, d x, d h0, its d a ([B][di * N] doubles in `dap`)
// and its d b, d c partials (`part`: [2][n_cb][B][S][N] doubles); no
// tensor holds a state for every step.
template <typename T, int N>
__global__ void __launch_bounds__(kBwdThreads)
ssm_bwd_grad(const T* __restrict__ dtp, const T* __restrict__ xp,
             const float* __restrict__ a, const float* __restrict__ bm,
             const float* __restrict__ cm, const float* __restrict__ h0,
             const T* __restrict__ gyp, const float* __restrict__ ghf,
             T* __restrict__ ddt, T* __restrict__ dx,
             float* __restrict__ dh0, double* __restrict__ ckpt,
             double* __restrict__ dap, double* __restrict__ part, int S,
             int di) {
  using P = BwdPlan<N>;
  constexpr int kS = P::kS, kC = P::kC, L = kBwdTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem<N>& sm = *reinterpret_cast<BwdSmem<N>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cl = tid / P::kG, q = tid % P::kG;
  const int cb = blockIdx.x, bi = blockIdx.y, B = gridDim.y;
  const int d0 = cb * kC, d = d0 + cl;
  const bool live = d < di;
  const int nt = (S + L - 1) / L;     // tiles
  const size_t din = static_cast<size_t>(di) * N;
  const size_t row = static_cast<size_t>(bi) * din + d * N + q * kS;
  if (tid < 16) sm.table[tid] = kExpTable[tid];

  double an[kS], h[kS], hn[kS], g[kS], da[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    an[s] = live ? a[static_cast<size_t>(d) * N + q * kS + s] : 0.0;
    h[s] = live ? h0[row + s] : 0.0;
    g[s] = live && ghf != nullptr ? ghf[row + s] : 0.0;
    da[s] = 0.0;
  }

  // A tile whose |dt| reaches 700 / (the block's largest |a|), or a block
  // with a NaN or infinite a, takes libdevice's exp (`exp_bwd<true>`).
  double am = 0.0;
  bool bad = false;
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    bad |= !(fabs(an[s]) <= 0x1.fffffffffffffp+1023);
    am = fmax(am, fabs(an[s]));
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
    am = fmax(am, __shfl_xor_sync(0xffffffffu, am, m));
  if (lane == 0) sm.amax[warp] = am;

  BwdTileRegs<T, N> regs;
  regs.load(dtp, xp, gyp, bm, cm, bi, 0, S, di, d0);
  regs.store(sm, 0);
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kBwdWarps; ++w) am = fmax(am, sm.amax[w]);
  const double dt_far = 700.0 / am;
  bool far = __syncthreads_or(bad || regs.far(dt_far));

  int buf = 0;
  // tile steps: forward 0 .. T-2, then backward T-1 .. 0
  for (int step = 0; step < 2 * nt - 1; ++step) {
    const bool fwd = step < nt - 1, more = step + 1 < 2 * nt - 1;
    const int k = fwd ? step : 2 * nt - 2 - step;
    const int t0 = k * L;
    if (more) {
      const int kn = step + 1 < nt - 1 ? step + 1 : 2 * nt - 3 - step;
      regs.load(dtp, xp, gyp, bm, cm, bi, kn * L, S, di, d0);
    }
    if (fwd) {
      if (far)
        forward_tile<true, N>(h, sm, buf, cl, q, an);
      else
        forward_tile<false, N>(h, sm, buf, cl, q, an);
      if (k + 1 < nt - 1 && live) {
        double* out = ckpt + (static_cast<size_t>(bi) * (nt - 2) + k) * din +
                      d * N + q * kS;
#pragma unroll
        for (int s = 0; s < kS; ++s) out[s] = h[s];
      }
    } else {
      const int par = k & 1;
      // the tile's start state (tile T-1: the forward's last, in h); the
      // next tile's is loaded now: a kept state or h0
      if (k < nt - 1) {
#pragma unroll
        for (int s = 0; s < kS; ++s) h[s] = hn[s];
      }
      if (k > 0) {
#pragma unroll
        for (int s = 0; s < kS; ++s)
          hn[s] = !live ? 0.0
                  : k == 1 ? static_cast<double>(h0[row + s])
                           : ckpt[(static_cast<size_t>(bi) * (nt - 2) + k - 2) *
                                      din + d * N + q * kS + s];
      }
      double fr[L][kS], fh[L][kS];
      if (far)
        tile_factors<true, N>(fr, sm, buf, cl, an);
      else
        tile_factors<false, N>(fr, sm, buf, cl, an);
#pragma unroll
      for (int i = 0; i < L; ++i) {               // the rescan
        const double dtxv = sm.dtx[buf][i][cl], gyv = sm.gy[buf][i][cl];
        double v[kS];
#pragma unroll
        for (int s = 0; s < kS; ++s) {
          fh[i][s] = fr[i][s] * h[s];
          h[s] = fma(dtxv, sm.b[buf][i][q * kS + s], fh[i][s]);
          v[s] = h[s] * gyv;
        }
        warp_channel_sums<N>(v, sm.red[par][1], i, lane, q);
      }
#pragma unroll
      for (int i = L - 1; i >= 0; --i) {          // the walk back
        const double dtv = sm.dt[buf][i][cl], xv = sm.x[buf][i][cl];
        const double dtxv = sm.dtx[buf][i][cl], gyv = sm.gy[buf][i][cl];
        double s_dt = 0.0, s_u = 0.0, v[kS];
#pragma unroll
        for (int s = 0; s < kS; ++s) {
          g[s] = fma(gyv, sm.c[buf][i][q * kS + s], g[s]);
          const double gf = g[s] * fh[i][s];
          s_dt = fma(gf, an[s], s_dt);
          s_u = fma(g[s], sm.b[buf][i][q * kS + s], s_u);
          da[s] = fma(gf, dtv, da[s]);
          v[s] = g[s] * dtxv;
          g[s] *= fr[i][s];
        }
        warp_channel_sums<N>(v, sm.red[par][0], i, lane, q);
#pragma unroll
        for (int m = P::kG / 2; m > 0; m >>= 1) {
          s_dt += __shfl_xor_sync(0xffffffffu, s_dt, m);
          s_u += __shfl_xor_sync(0xffffffffu, s_u, m);
        }
        if (q == 0) {
          sm.odt[par][i][cl] = static_cast<float>(fma(xv, s_u, s_dt));
          sm.odx[par][i][cl] = static_cast<float>(dtv * s_u);
        }
      }
    }
    if (more) regs.store(sm, buf ^ 1);
    far = __syncthreads_or(bad || (more && regs.far(dt_far)));
    if (!fwd) {
      // the tile's outputs, read by other threads than wrote them; the
      // next tile writes the other parity
      const int par = k & 1;
      for (int e = tid; e < L * kC; e += kBwdThreads) {
        const int i = e / kC, c2 = e % kC;
        if (t0 + i < S && d0 + c2 < di) {
          const size_t at = (static_cast<size_t>(bi) * S + t0 + i) * di +
                            d0 + c2;
          store_f(ddt + at, sm.odt[par][i][c2]);
          store_f(dx + at, sm.odx[par][i][c2]);
        }
      }
      const size_t bsn = static_cast<size_t>(B) * S * N;
      for (int e = tid; e < 2 * L * N; e += kBwdThreads) {
        const int kind = e / (L * N), i = e / N % L, n = e % N;
        if (t0 + i < S) {
          double sum = 0.0;
#pragma unroll
          for (int w = 0; w < kBwdWarps; ++w)
            sum += sm.red[par][kind][i][w][n];
          part[(kind * gridDim.x + cb) * bsn +
               (static_cast<size_t>(bi) * S + t0 + i) * N + n] = sum;
        }
      }
    }
    buf ^= 1;
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      dh0[row + s] = static_cast<float>(g[s]);
      dap[row + s] = da[s];
    }
  }
}

// The cross-block sums in a fixed order.  Blocks 0 .. ceil(din / 256) - 1
// sum d a over the batch rows, a thread an element.  The rest sum d b and
// d c over the channel blocks: 32 consecutive elements a block, 8 threads
// an element, each over its eighth of the channel blocks in order, then
// the eighths in order in shared memory.
constexpr int kReduceParts = 8;

__global__ void __launch_bounds__(256)
ssm_bwd_reduce(const double* __restrict__ dap,
               const double* __restrict__ part, float* __restrict__ da,
               float* __restrict__ db, float* __restrict__ dc,
               long long din, long long bsn, int B, int n_cb) {
  __shared__ double sums[2][kReduceParts][32];
  const long long da_blocks = (din + 255) / 256;
  if (blockIdx.x < da_blocks) {
    const long long idx = static_cast<long long>(blockIdx.x) * 256 +
                          threadIdx.x;
    if (idx < din) {
      double s = 0.0;
      for (int r = 0; r < B; ++r) s += dap[r * din + idx];
      da[idx] = static_cast<float>(s);
    }
    return;
  }
  const int lane = threadIdx.x & 31, pt = threadIdx.x >> 5;
  const long long m = (blockIdx.x - da_blocks) * 32 + lane;
  const int per = (n_cb + kReduceParts - 1) / kReduceParts;
  const int k0 = pt * per, k1 = min(n_cb, k0 + per);
  double s_b = 0.0, s_c = 0.0;
  if (m < bsn) {
    for (int k = k0; k < k1; ++k) {
      s_b += part[k * bsn + m];
      s_c += part[(n_cb + k) * bsn + m];
    }
  }
  sums[0][pt][lane] = s_b;
  sums[1][pt][lane] = s_c;
  __syncthreads();
  if (pt == 0 && m < bsn) {
    double t_b = 0.0, t_c = 0.0;
#pragma unroll
    for (int p = 0; p < kReduceParts; ++p) {
      t_b += sums[0][p][lane];
      t_c += sums[1][p][lane];
    }
    db[m] = static_cast<float>(t_b);
    dc[m] = static_cast<float>(t_c);
  }
}

// the channel blocks of the gradient kernel (BwdPlan<N>::kC channels each)
int bwd_channel_blocks(int di, int N) {
  const int per = kBwdThreads * bwd_states(N) / N;
  return (di + per - 1) / per;
}

long long bwd_tiles(int S) { return (S + kBwdTile - 1) / kBwdTile; }

struct BwdArgs {
  const void *dt, *x, *a, *b, *c, *h0, *gy, *ghf;
  void *ddt, *dx, *da, *db, *dc, *dh0;
  double* work;
  int B, S, di;
  cudaStream_t stream;
};

template <typename T, int N>
int launch_bwd(const BwdArgs& g) {
  auto grad = ssm_bwd_grad<T, N>;
  constexpr int kBytes = sizeof(BwdSmem<N>);
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(
        grad, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev].store(true, std::memory_order_relaxed);
  }
  const long long nt = bwd_tiles(g.S);
  const long long din = static_cast<long long>(g.di) * N;
  const long long bsn = static_cast<long long>(g.B) * g.S * N;
  const int n_cb = bwd_channel_blocks(g.di, N);
  double* ckpt = g.work;
  double* dap = ckpt + (nt > 2 ? nt - 2 : 0) * g.B * din;
  double* part = dap + g.B * din;
  grad<<<dim3(n_cb, g.B), kBwdThreads, kBytes, g.stream>>>(
      static_cast<const T*>(g.dt), static_cast<const T*>(g.x),
      static_cast<const float*>(g.a), static_cast<const float*>(g.b),
      static_cast<const float*>(g.c), static_cast<const float*>(g.h0),
      static_cast<const T*>(g.gy), static_cast<const float*>(g.ghf),
      static_cast<T*>(g.ddt), static_cast<T*>(g.dx),
      static_cast<float*>(g.dh0), ckpt, dap, part, g.S, g.di);
  ssm_bwd_reduce<<<static_cast<unsigned>((din + 255) / 256 +
                                         (bsn + 31) / 32),
                   256, 0, g.stream>>>(
      dap, part, static_cast<float*>(g.da), static_cast<float*>(g.db),
      static_cast<float*>(g.dc), din, bsn, g.B, n_cb);
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

// Doubles of scratch ssm_scan_bwd_launch needs: the states kept at tile
// starts (B * (ceil(S / 8) - 2) * di * N), d a per batch row (B * di * N)
// and the d b / d c partials of the channel blocks (2 * n_cb * B * S * N).
extern "C" long long ssm_scan_bwd_scratch(int B, int S, int di, int N) {
  if (B < 1 || S < 1 || di < 1 || N < 1 || N > 32) return -1;
  const long long nt = bwd_tiles(S);
  const long long din = static_cast<long long>(di) * N;
  return ((nt > 2 ? nt - 2 : 0) + 1) * B * din +
         2LL * bwd_channel_blocks(di, N) * B * S * N;
}

// Gradients of (y, h_final) = scan(dt, x, a, b, c, h0) for the
// cotangents gy (B, S, di) in dt's dtype and ghf (B, di, N) float32;
// either may be null (zero).  Writes ddt, dx (dt's dtype) and da, db,
// dc, dh0 (float32); `work` holds ssm_scan_bwd_scratch(...) doubles.
// dtype: 0 = float32, 1 = bfloat16.  Two launches, no atomics: the same
// inputs give the same bits.
extern "C" int ssm_scan_bwd_launch(const void* dt, const void* x,
                                   const void* a, const void* b,
                                   const void* c, const void* h0,
                                   const void* gy, const void* ghf,
                                   void* ddt, void* dx, void* da, void* db,
                                   void* dc, void* dh0, void* work,
                                   int dtype, int B, int S, int di, int N,
                                   void* stream) {
  if (B < 1 || S < 1 || di < 1 || work == nullptr || B > 65535)
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
