// Dataplane bounce / cost kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_bounce_kernel` in
// src/repro/kernels/dataplane/bounce.py (launched by `_bounce_fwd`), the
// one kernel body behind `bounce_copy` and `mediated_cost`.
//
// What it computes.  A flat payload of `n_bytes` is cut into chunks of
// `chunk_bytes` (the wrapper's element chunk times the element size).
// Every chunk is copied global -> shared slot A, makes `copies - 1` extra
// round trips A -> B -> A through a second shared slot, and is copied
// out.  The bytes are moved as raw 16-byte words (bytes where a piece is
// unaligned), never through a float register, so the output is
// bit-identical to the input for every dtype, NaN and -0.0 included.
// One serial chain of `n_chunks * iters_per_chunk` dependent fma steps
// (`v = v * 1.0000001f + 1e-9f`, the TPU kernel's `_burn`) runs in thread
// 0 of block 0.  Its result feeds the head tie (the first output byte is
// selected on `tok == tok`, a select that is always true at run time but
// that the compiler cannot fold) and the per-chunk counters
// (`COST_ITERS = iters_per_chunk * (tok == tok)`, `COST_COPIES = copies`),
// so `-O3` cannot delete the chain, and the launch ends only after it.
//
// What bounds it.  The copy is bound by device memory: 2 * n_bytes over
// 3.35 TB/s (0.72 ms for the 1.21 GB gemma3-1b embedding table).  The
// chain is bound by the latency of one dependent fma per iteration and
// cannot be spread over threads: burning each chunk's share in parallel
// would divide the emulated syscall cost by the number of blocks.
//
// What the design does about it.  The copy is spread over a grid of up to
// three blocks per SM, each walking chunks grid-stride through two 32 KiB
// shared slots with 16-byte loads and stores.  Block 0 runs the chain
// after its own chunks, so the launch takes about the copy time plus the
// chain, as the TPU kernel's copy-in / burn / copy-out does.  On the TPU
// each chunk's head is tied to that chunk's burn; here the first output
// element is tied to the whole chain, which keeps the same value and the
// same total serial work.  Not yet used: TMA bulk copies and mbarriers.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr long long kSlotBytes = 32768;

// Copy `len` bytes; thread `tid` of `nthr` starts at residue
// (tid + rot) % nthr, so consecutive passes hand each word to another
// thread and no pass can be forwarded through registers.
__device__ __forceinline__ void copy_bytes(unsigned char* dst,
                                           const unsigned char* src,
                                           long long len, int tid, int nthr,
                                           int rot) {
  const int start = (tid + rot) % nthr;
  long long done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const long long n16 = len >> 4;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll 4
    for (long long i = start; i < n16; i += nthr) d[i] = s[i];
    done = n16 << 4;
  }
  for (long long i = done + start; i < len; i += nthr) dst[i] = src[i];
}

__global__ void __launch_bounds__(kThreads)
bounce_kernel(const unsigned char* __restrict__ x,
              unsigned char* __restrict__ out, int* __restrict__ ctrs,
              long long n_bytes, long long chunk_bytes, long long n_chunks,
              int copies, long long iters_per_chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* slot_a = smem;
  unsigned char* slot_b = smem + kSlotBytes;
  __shared__ float tok_s;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;

  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const long long c0 = c * chunk_bytes;
    const long long c_len = min(chunk_bytes, n_bytes - c0);
    for (long long p0 = 0; p0 < c_len; p0 += kSlotBytes) {
      const long long len = min(kSlotBytes, c_len - p0);
      copy_bytes(slot_a, x + c0 + p0, len, tid, nthr, 0);      // copy-in
      __syncthreads();
      for (int k = 1; k < copies; ++k) {                        // extra passes
        copy_bytes(slot_b, slot_a, len, tid, nthr, 1);
        __syncthreads();
        copy_bytes(slot_a, slot_b, len, tid, nthr, 2);
        __syncthreads();
      }
      copy_bytes(out + c0 + p0, slot_a, len, tid, nthr, 3);    // copy-out
      __syncthreads();
    }
  }

  if (blockIdx.x != 0) return;
  if (tid == 0) {
    float v = 1.0f;
    const long long total = n_chunks * iters_per_chunk;
    for (long long i = 0; i < total; ++i) v = fmaf(v, 1.0000001f, 1e-9f);
    tok_s = v;
  }
  __syncthreads();
  const float tok = tok_s;
  const int live = (tok == tok) ? 1 : 0;
  if (tid == 0 && n_bytes > 0) {
    // chunk 0 went out through this block before the barrier above
    const unsigned char head = out[0];
    out[0] = live ? head : static_cast<unsigned char>(head + 1);
  }
  for (long long c = tid; c < n_chunks; c += nthr) {
    ctrs[2 * c] = static_cast<int>(iters_per_chunk * live);
    ctrs[2 * c + 1] = copies;
  }
}

constexpr int kSmem = static_cast<int>(2 * kSlotBytes);
constexpr int kMaxDevices = 64;
// SM count per device once its launch setup is done, 0 before
std::atomic<int> g_sms[kMaxDevices];

}  // namespace

extern "C" int bounce_launch(const void* x, void* out, void* ctrs,
                             long long n_bytes, long long chunk_bytes,
                             long long n_chunks, int copies,
                             long long iters_per_chunk, void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  int sms = g_sms[dev].load(std::memory_order_relaxed);
  if (sms == 0) {   // first launch on this device
    err = cudaFuncSetAttribute(
        bounce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (sms < 1) sms = 1;
    g_sms[dev].store(sms, std::memory_order_relaxed);
  }
  long long grid = static_cast<long long>(sms) * 3;
  if (grid > n_chunks) grid = n_chunks;
  if (grid < 1) grid = 1;
  bounce_kernel<<<static_cast<unsigned>(grid), kThreads, kSmem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(x), static_cast<unsigned char*>(out),
      static_cast<int*>(ctrs), n_bytes, chunk_bytes, n_chunks, copies,
      iters_per_chunk);
  return static_cast<int>(cudaGetLastError());
}
