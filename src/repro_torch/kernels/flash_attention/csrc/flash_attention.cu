// Flash-attention forward (prefill) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel` in
// src/repro/kernels/flash_attention/flash_attention.py (launched by
// `flash_attention_fwd`, reached through `ops.flash_attention`).
//
// What it computes.  Online-softmax attention over q (B, Sq, H, D) and
// k/v (B, Skv, KVH, D) in the framework's (B, S, H, D) layout, query
// positions 0..Sq-1 and key positions 0..Skv-1.  GQA reads kv head
// h / (H / KVH).  Runtime scalars: `window` (0 = global; it changes per
// layer, so it is not a template argument), `valid_len`, `causal`,
// `logit_cap` (tanh soft cap, 0 = off).  Scale 1/sqrt(D).  Masked logits
// are NEG_INF = -2^30, masked probabilities are 0, so a fully masked row
// gives 0.  The softmax state (m, l) and the output accumulator are f32.
// Whole kv tiles are skipped past `valid_len`, above the causal diagonal
// or left of the window, exactly as the TPU kernel skips blocks; ragged
// tiles at the end of a sequence are masked instead of shrinking the
// tiles to a divisor of S as the TPU wrapper does.
//
// What bounds it.  At gemma3-1b prefill shapes (H=4, KVH=1, D=256,
// S <= 2048, window 512 on 5 of 6 layers) the work is 4*D flops per
// unmasked (q, k) pair against (Sq*H + 2*Skv*KVH)*D*2 bytes, which is
// above the H100's ~295 flop/byte ridge: the bound is the tensor cores'
// 989 TFLOP/s in bf16.
//
// What the design does about it.  One block of 4 warps per
// (q tile, head, batch).  bf16 inputs take the tensor cores through
// WMMA 16x16x16 (bf16 in, f32 accumulate) for both products; f32 inputs
// (the smoke configs) take a CUDA-core path.  Q, K, V, the score tile, P
// (bf16) and the f32 output accumulator live in shared memory (190 KB at
// D=256, above 48 KB, hence cudaFuncSetAttribute).  This is the simple
// correct form: the accumulator round-trips through shared memory every
// kv tile and there is one block per SM.  Not yet used: wgmma, TMA, a
// register-resident accumulator, warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <atomic>

namespace {

using namespace nvcuda;

constexpr float kNegInf = -1073741824.0f;   // -2^30, as the TPU kernel
constexpr int kThreads = 128;               // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
struct Tiles;   // BQ x BK tile geometry per input type

template <>
struct Tiles<__nv_bfloat16> {
  static constexpr int BQ = 64, BK = 64;   // 16 query rows per warp
  static constexpr bool kWmma = true;
};

template <>
struct Tiles<float> {
  static constexpr int BQ = 32, BK = 32;
  static constexpr bool kWmma = false;
};

__host__ __device__ constexpr int round128(int bytes) {
  return (bytes + 127) / 128 * 128;
}

template <typename T, int D>
struct Layout {
  static constexpr int BQ = Tiles<T>::BQ, BK = Tiles<T>::BK;
  static constexpr int LDT = D + 16 / static_cast<int>(sizeof(T));  // Q/K/V rows
  static constexpr int LDS = BK + 4;                                 // f32 scores
  static constexpr int LDP = BK + 16 / static_cast<int>(sizeof(T));  // P rows
  static constexpr int LDO = D + 4;                                  // f32 output
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + round128(BQ * LDT * sizeof(T));
  static constexpr int V_OFF = K_OFF + round128(BK * LDT * sizeof(T));
  static constexpr int S_OFF = V_OFF + round128(BK * LDT * sizeof(T));
  static constexpr int P_OFF = S_OFF + round128(BQ * LDS * 4);
  static constexpr int O_OFF = P_OFF + round128(BQ * LDP * sizeof(T));
  static constexpr int M_OFF = O_OFF + round128(BQ * LDO * 4);
  static constexpr int L_OFF = M_OFF + round128(BQ * 4);
  static constexpr int BYTES = L_OFF + round128(BQ * 4);
};

// Copy `rows` rows of D elements (row r at src + r * src_stride) into
// shared memory with row stride LDT, zero-filling rows >= valid_rows.
template <typename T, int D, int LDT>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          long long src_stride, int rows,
                                          int valid_rows) {
  constexpr int kVec = D * static_cast<int>(sizeof(T)) / 16;   // uint4 per row
  for (int i = threadIdx.x; i < rows * kVec; i += kThreads) {
    const int r = i / kVec, c = i % kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid_rows) {
      val = reinterpret_cast<const uint4*>(src + r * src_stride)[c];
    }
    reinterpret_cast<uint4*>(dst + r * LDT)[c] = val;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
                 int H, int KVH, int causal, int window, int valid_len,
                 float logit_cap, float scale) {
  using L = Layout<T, D>;
  constexpr int BQ = L::BQ, BK = L::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + L::Q_OFF);
  T* sK = reinterpret_cast<T*>(smem + L::K_OFF);
  T* sV = reinterpret_cast<T*>(smem + L::V_OFF);
  float* sS = reinterpret_cast<float*>(smem + L::S_OFF);
  T* sP = reinterpret_cast<T*>(smem + L::P_OFF);
  float* sO = reinterpret_cast<float*>(smem + L::O_OFF);
  float* sM = reinterpret_cast<float*>(smem + L::M_OFF);
  float* sL = reinterpret_cast<float*>(smem + L::L_OFF);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q_start = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const long long q_stride = static_cast<long long>(H) * D;
  const long long kv_stride = static_cast<long long>(KVH) * D;

  load_rows<T, D, L::LDT>(sQ, q + (static_cast<long long>(b) * Sq + q_start) * q_stride +
                                  static_cast<long long>(h) * D,
                          q_stride, BQ, Sq - q_start);
  for (int i = tid; i < BQ * L::LDO; i += kThreads) sO[i] = 0.f;
  for (int i = tid; i < BQ; i += kThreads) {
    sM[i] = kNegInf;
    sL[i] = 0.f;
  }

  const int n_kt = (Skv + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k_start = kt * BK;
    bool run = k_start < valid_len;
    if (causal) run = run && (k_start <= q_start + BQ - 1);
    if (window > 0) run = run && (k_start + BK - 1 > q_start - window);
    if (!run) continue;   // uniform over the block

    __syncthreads();      // the previous tile is no longer read
    const T* kb = k + (static_cast<long long>(b) * Skv + k_start) * kv_stride +
                  static_cast<long long>(kvh) * D;
    const T* vb = v + (static_cast<long long>(b) * Skv + k_start) * kv_stride +
                  static_cast<long long>(kvh) * D;
    load_rows<T, D, L::LDT>(sK, kb, kv_stride, BK, Skv - k_start);
    load_rows<T, D, L::LDT>(sV, vb, kv_stride, BK, Skv - k_start);
    __syncthreads();

    // ---- S = Q K^T (raw dot products, f32) ----
    if constexpr (Tiles<T>::kWmma) {
      const int r0 = warp * 16;
      for (int nf = 0; nf < BK / 16; ++nf) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
        for (int kk = 0; kk < D / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> fb;
          wmma::load_matrix_sync(fa, sQ + r0 * L::LDT + kk * 16, L::LDT);
          wmma::load_matrix_sync(fb, sK + nf * 16 * L::LDT + kk * 16, L::LDT);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(sS + r0 * L::LDS + nf * 16, acc, L::LDS,
                                wmma::mem_row_major);
      }
    } else {
      for (int i = tid; i < BQ * BK; i += kThreads) {
        const int r = i / BK, c = i % BK;
        float acc = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) {
          acc = fmaf(to_f(sQ[r * L::LDT + d]), to_f(sK[c * L::LDT + d]), acc);
        }
        sS[r * L::LDS + c] = acc;
      }
    }
    __syncthreads();

    // ---- online softmax, one warp per row ----
    for (int r = warp; r < BQ; r += kWarps) {
      const int qpos = q_start + r;
      constexpr int kPer = BK / 32;
      float s[kPer];
      bool ok[kPer];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int c = lane + 32 * j;
        const int kpos = k_start + c;
        float x = sS[r * L::LDS + c] * scale;
        if (logit_cap > 0.f) x = logit_cap * tanhf(x / logit_cap);
        bool valid = kpos < valid_len && kpos < Skv;
        if (causal) valid = valid && kpos <= qpos;
        if (window > 0) valid = valid && (qpos - kpos < window);
        ok[j] = valid;
        s[j] = valid ? x : kNegInf;
        mx = fmaxf(mx, s[j]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float p = ok[j] ? expf(s[j] - m_new) : 0.f;
        sum += p;
        store_f(sP + r * L::LDP + lane + 32 * j, p);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m_prev - m_new);
      for (int d = lane; d < D; d += 32) sO[r * L::LDO + d] *= corr;
      __syncwarp();
      if (lane == 0) {
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // ---- O += P V ----
    if constexpr (Tiles<T>::kWmma) {
      const int r0 = warp * 16;
      for (int nf = 0; nf < D / 16; ++nf) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::load_matrix_sync(acc, sO + r0 * L::LDO + nf * 16, L::LDO,
                               wmma::mem_row_major);
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fb;
          wmma::load_matrix_sync(fa, sP + r0 * L::LDP + kk * 16, L::LDP);
          wmma::load_matrix_sync(fb, sV + kk * 16 * L::LDT + nf * 16, L::LDT);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(sO + r0 * L::LDO + nf * 16, acc, L::LDO,
                                wmma::mem_row_major);
      }
    } else {
      for (int i = tid; i < BQ * D; i += kThreads) {
        const int r = i / D, d = i % D;
        float acc = 0.f;
#pragma unroll 8
        for (int c = 0; c < BK; ++c) {
          acc = fmaf(to_f(sP[r * L::LDP + c]), to_f(sV[c * L::LDT + d]), acc);
        }
        sO[r * L::LDO + d] += acc;
      }
    }
  }
  __syncthreads();

  // ---- normalise and write (B, Sq, H, D) ----
  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    if (q_start + r >= Sq) continue;
    const float denom = fmaxf(sL[r], 1e-30f);
    store_f(o + (static_cast<long long>(b) * Sq + q_start + r) * q_stride +
                static_cast<long long>(h) * D + d,
            sO[r * L::LDO + d] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int H, int KVH, int causal, int window,
           int valid_len, float logit_cap, float scale, cudaStream_t stream) {
  using L = Layout<T, D>;
  auto kern = flash_fwd_kernel<T, D>;
  // the shared-memory opt-in, once per device and instantiation
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev].store(true, std::memory_order_relaxed);
  }
  dim3 grid((Sq + L::BQ - 1) / L::BQ, H, B);
  kern<<<grid, kThreads, L::BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, H, KVH, causal,
      window, valid_len, logit_cap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               int B, int Sq, int Skv, int H, int KVH, int causal, int window,
               int valid_len, float logit_cap, float scale,
               cudaStream_t stream) {
#define FLASH_CASE(DD)                                                      \
  case DD:                                                                  \
    return launch<T, DD>(q, k, v, o, B, Sq, Skv, H, KVH, causal, window,   \
                         valid_len, logit_cap, scale, stream);
  switch (D) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(128)
    FLASH_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int B, int Sq, int Skv, int H, int KVH,
                                      int D, int causal, int window,
                                      int valid_len, float logit_cap,
                                      float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, Sq, Skv, H, KVH,
                                     causal, window, valid_len, logit_cap,
                                     scale, s);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, B, Sq, Skv, H, KVH, causal,
                             window, valid_len, logit_cap, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
