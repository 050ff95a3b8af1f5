// Dataplane bounce / cost kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_bounce_kernel` in
// src/repro/kernels/dataplane/bounce.py (launched by `_bounce_fwd`), the
// one kernel body behind `bounce_copy` and `mediated_cost`.
//
// What it computes.  A flat payload of `n_bytes` goes through shared
// memory (the bounce buffer) and out again; each piece makes `copies - 1`
// extra round trips through a second shared region.  The bytes are only
// moved, never through a float register, so the output is bit-identical
// to the input for every dtype, NaN and -0.0 included.  One serial chain
// of `n_chunks * iters_per_chunk` dependent fma steps
// (`v = v * 1.0000001f + 1e-9f`, the TPU kernel's `_burn`) runs in one
// thread of block 0 after that block's share of the copy.  Its result
// feeds the head tie (the first output byte is selected on `tok == tok`,
// always true at run time but not foldable by the compiler) and the
// counters of every logical chunk (`COST_ITERS = iters_per_chunk *
// (tok == tok)`, `COST_COPIES = copies`), so `-O3` cannot delete it and
// the launch ends only after it.  The logical chunks (8192 elements, the
// wrapper's split) exist only in the counters; the copy has its own
// tiles.
//
// What bounds it.  The copy is bound by device memory: 2 * n_bytes over
// 3.35 TB/s (0.72 ms for the 1.21 GB gemma3-1b embedding table).  The
// chain is bound by the latency of one dependent fma per iteration and is
// never spread over threads: that would divide the emulated syscall cost.
// It runs in series with the copy, as the TPU kernel burns between a
// chunk's copy-in and copy-out, so the launch takes the copy time plus
// the chain time.  Small payloads (the 9 KB to 1 MB activations of the
// serve path) are bound by launch latency and the wrapper's host time.
//
// What the design does about it.
// - A persistent grid of at most one block per SM, sized to the payload's
//   tiles (a 9 KB payload wakes one block).  Tiles of 2-32 KB, the
//   payload's body cut evenly over the SMs; tile t goes to block
//   t % grid, so block 0 copies the head of the payload.
// - Each block runs a ring of kStages tiles in shared memory.  Thread 0
//   (the producer) issues `cp.async.bulk` global -> shared loads that
//   complete a stage's `full` mbarrier with the byte count
//   (`complete_tx`).  Thread 32 (the storer) waits on `full`, sends the
//   stage out with a `cp.async.bulk` shared -> global store (one bulk
//   group per tile) and, once the store of the previous tile has read its
//   stage (`wait_group.read 1`), arrives on that stage's `empty` mbarrier,
//   on which the producer waits before reloading it.  No thread spends a
//   register on the payload.
// - Extra passes (copies >= 2): warps 1-7 copy the stage to a second
//   shared region and back with 16-byte loads and stores (each pass hands
//   every word to another thread, so nothing is forwarded through
//   registers), then `fence.proxy.async.shared::cta` before the bulk
//   store reads what the generic proxy wrote.
// - Bulk copies need 16-byte aligned addresses and sizes.  When x and
//   out agree modulo 16, the unaligned head and tail bytes (< 16 each)
//   are copied by the storer of block 0 with ordinary loads and stores
//   through shared memory; when they do not (a view at an odd storage
//   offset), the whole payload takes the same ordinary path over the
//   grid, through two shared slots, with the widest word both sides
//   allow.
// - The head tie writes out[0] after the chain, once the bulk stores of
//   block 0 have completed (`wait_group 0`, then a proxy fence).
// Every mbarrier wait traps after 2 s instead of hanging the card.
//
// C interface: bounce_launch returns 0 or a cudaError_t.  The caller
// passes the device index and its SM count, so the launch makes no
// device query; the shared-memory opt-in is made once per device.
//
// The QoS stall (bounce_stall_launch).  `repro`'s token bucket stalls a
// throttled op by a serial chain whose trip count is a traced value
// (`delay_chain_dyn`, an XLA while loop, not the Pallas kernel).  Here
// one thread runs the same fma chain with its trip count read from an
// int32 on the card, so the host never reads the deficit and never waits
// for the device; stream order makes the payload's next use wait for the
// chain, so the payload is neither copied nor touched.  The chain's
// result goes to a one-word scratch buffer, or nvcc would delete the
// loop.  A trip count <= 0 runs no iteration.  The stall writes no cost
// counter: `repro`'s stall is not the kernel and is not in its counters.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;            // warp 0 producer, warps 1-7 consumers
constexpr int kConsumers = kThreads - 32;
constexpr int kStages = 4;
constexpr long long kTileMax = 32768;    // bytes of one ring stage
constexpr long long kTileMin = 2048;
constexpr int kSmemMax = static_cast<int>((kStages + 1) * kTileMax);
constexpr unsigned long long kHangNs = 2000000000ull;   // 2 s
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed; trap after
// kHangNs instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      " .reg .pred p;\n"
      " .reg .u64 t0, t1;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @p bra DONE;\n"
      " mov.u64 t0, %%globaltimer;\n"
      "WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @p bra DONE;\n"
      " mov.u64 t1, %%globaltimer;\n"
      " sub.u64 t1, t1, t0;\n"
      " setp.gt.u64 p, t1, %2;\n"
      " @p trap;\n"
      " bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity), "l"(kHangNs)
      : "memory");
}

// global -> shared, completing `bytes` on mbarrier `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// shared -> global, in the current bulk group
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// at most N bulk groups still reading their shared source
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// every bulk group complete: its writes are done
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Copy `len` bytes in words of W bytes where both sides allow it; thread
// `tid` of `nthr` starts at residue (tid + rot) % nthr, so consecutive
// passes hand each word to another thread and no pass is forwarded
// through registers.
template <typename W>
__device__ __forceinline__ long long copy_words(unsigned char* dst,
                                                const unsigned char* src,
                                                long long len, int start,
                                                int nthr) {
  const long long n = len / static_cast<long long>(sizeof(W));
  const W* s = reinterpret_cast<const W*>(src);
  W* d = reinterpret_cast<W*>(dst);
#pragma unroll 4
  for (long long i = start; i < n; i += nthr) d[i] = s[i];
  return n * static_cast<long long>(sizeof(W));
}

__device__ __forceinline__ void copy_bytes(unsigned char* dst,
                                           const unsigned char* src,
                                           long long len, int tid, int nthr,
                                           int rot) {
  const int start = (tid + rot) % nthr;
  const uintptr_t both = reinterpret_cast<uintptr_t>(dst) |
                         reinterpret_cast<uintptr_t>(src);
  long long done = 0;
  if ((both & 15) == 0)
    done = copy_words<uint4>(dst, src, len, start, nthr);
  else if ((both & 7) == 0)
    done = copy_words<uint2>(dst, src, len, start, nthr);
  else if ((both & 3) == 0)
    done = copy_words<unsigned>(dst, src, len, start, nthr);
  for (long long i = done + start; i < len; i += nthr) dst[i] = src[i];
}

// The unaligned head or tail (< 16 bytes) of a ring-mode payload, by one
// thread, through `sa` and, for each extra pass, `sb` and back.
__device__ __forceinline__ void copy_edge(unsigned char* dst,
                                          const unsigned char* src, int len,
                                          int copies, volatile unsigned char* sa,
                                          volatile unsigned char* sb) {
  for (int i = 0; i < len; ++i) sa[i] = src[i];
  for (int k = 1; k < copies; ++k) {
    for (int i = 0; i < len; ++i) sb[i] = sa[i];
    for (int i = 0; i < len; ++i) sa[i] = sb[i];
  }
  for (int i = 0; i < len; ++i) dst[i] = sa[i];
}

struct Plan {
  long long head, body, tail;   // bytes; ring mode only
  long long tile, n_tiles;      // ring tiles, or ordinary-path pieces
  int ring;                     // x and out agree modulo 16
  int grid, smem;
};

// The tile plan, mirrored by `ring_plan` in bounce.py.
Plan make_plan(const void* x, const void* out, long long n_bytes, int copies,
               int sms) {
  Plan p{};
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  p.ring = ((xa - reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (p.ring) {
    p.head = static_cast<long long>((16 - (xa & 15)) & 15);
    if (p.head > n_bytes) p.head = n_bytes;
    p.body = (n_bytes - p.head) & ~15LL;
    p.tail = n_bytes - p.head - p.body;
    long long per = (p.body + sms - 1) / sms;
    per = (per + 15) & ~15LL;
    p.tile = per < kTileMin ? kTileMin : (per > kTileMax ? kTileMax : per);
    p.n_tiles = (p.body + p.tile - 1) / p.tile;
    p.smem = static_cast<int>(kStages * p.tile + (copies >= 2 ? p.tile : 0));
  } else {
    p.tile = kTileMax;
    p.n_tiles = (n_bytes + kTileMax - 1) / kTileMax;
    p.smem = static_cast<int>(2 * kTileMax);
  }
  long long grid = p.n_tiles < sms ? p.n_tiles : sms;
  p.grid = static_cast<int>(grid < 1 ? 1 : grid);
  return p;
}

__global__ void __launch_bounds__(kThreads, 1)
bounce_kernel(const unsigned char* __restrict__ x,
              unsigned char* __restrict__ out, int* __restrict__ ctrs,
              long long n_bytes, Plan p, long long n_chunks, int copies,
              long long iters_per_chunk) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  __shared__ unsigned char edge[2][16];
  __shared__ float tok_s;
  const int tid = threadIdx.x;

  if (p.ring) {
    if (tid == 0) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(smem_u32(&full[s]), 1);
        mbar_init(smem_u32(&empty[s]), 1);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    const long long mine =
        p.n_tiles > blockIdx.x
            ? (p.n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x
            : 0;
    const unsigned char* xb = x + p.head;
    unsigned char* ob = out + p.head;
    const bool passes = copies >= 2;
    if (tid == 0) {                                       // producer
      for (long long j = 0; j < mine; ++j) {
        const int s = static_cast<int>(j % kStages);
        if (j >= kStages)
          mbar_wait(smem_u32(&empty[s]),
                    static_cast<uint32_t>((j / kStages - 1) & 1));
        const long long off = (blockIdx.x + j * gridDim.x) * p.tile;
        const long long len = min(p.tile, p.body - off);
        mbar_expect_tx(smem_u32(&full[s]), static_cast<uint32_t>(len));
        bulk_load(smem_u32(smem + s * p.tile), xb + off,
                  static_cast<uint32_t>(len), smem_u32(&full[s]));
      }
    } else if (tid >= 32 && (passes || tid == 32)) {      // consumers
      unsigned char* region_b = smem + kStages * p.tile;
      for (long long j = 0; j < mine; ++j) {
        const int s = static_cast<int>(j % kStages);
        unsigned char* stage = smem + s * p.tile;
        const long long off = (blockIdx.x + j * gridDim.x) * p.tile;
        const long long len = min(p.tile, p.body - off);
        mbar_wait(smem_u32(&full[s]), static_cast<uint32_t>((j / kStages) & 1));
        if (passes) {
          const int ct = tid - 32;
          for (int k = 1; k < copies; ++k) {
            copy_bytes(region_b, stage, len, ct, kConsumers, 1);
            asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
            copy_bytes(stage, region_b, len, ct, kConsumers, 2);
            asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
          }
          // generic writes to the stage before the bulk store reads it
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
        }
        if (tid == 32) {                                  // storer
          bulk_store(ob + off, smem_u32(stage), static_cast<uint32_t>(len));
          bulk_commit();
          if (j > 0) {
            bulk_wait_read<1>();    // the previous tile's stage is read
            mbar_arrive(smem_u32(&empty[(j - 1) % kStages]));
          }
        }
      }
      if (tid == 32) {
        if (blockIdx.x == 0) {    // the unaligned head and tail bytes
          copy_edge(out, x, static_cast<int>(p.head), copies, edge[0],
                    edge[1]);
          copy_edge(out + p.head + p.body, x + p.head + p.body,
                    static_cast<int>(p.tail), copies, edge[0], edge[1]);
        }
        bulk_wait_all();
        asm volatile("fence.proxy.async.global;" ::: "memory");
      }
    }
  } else {
    // x and out disagree modulo 16: ordinary loads and stores over the
    // grid, through shared slots A and B
    unsigned char* slot_a = smem;
    unsigned char* slot_b = smem + kTileMax;
    for (long long c = blockIdx.x; c < p.n_tiles; c += gridDim.x) {
      const long long c0 = c * kTileMax;
      const long long len = min(kTileMax, n_bytes - c0);
      copy_bytes(slot_a, x + c0, len, tid, kThreads, 0);      // copy-in
      __syncthreads();
      for (int k = 1; k < copies; ++k) {                       // extra passes
        copy_bytes(slot_b, slot_a, len, tid, kThreads, 1);
        __syncthreads();
        copy_bytes(slot_a, slot_b, len, tid, kThreads, 2);
        __syncthreads();
      }
      copy_bytes(out + c0, slot_a, len, tid, kThreads, 3);     // copy-out
      __syncthreads();
    }
  }

  __syncthreads();   // this block's copies are complete
  if (blockIdx.x != 0) return;
  if (tid == 32) {
    float v = 1.0f;
    const long long total = n_chunks * iters_per_chunk;
    for (long long i = 0; i < total; ++i) v = fmaf(v, 1.0000001f, 1e-9f);
    tok_s = v;
    const int live = (v == v) ? 1 : 0;
    if (n_bytes > 0) {   // out[0] went out through this block, completed
      const unsigned char head = out[0];
      out[0] = live ? head : static_cast<unsigned char>(head + 1);
    }
  }
  __syncthreads();
  const float tok = tok_s;
  const int iters = static_cast<int>(iters_per_chunk * ((tok == tok) ? 1 : 0));
  int2* c2 = reinterpret_cast<int2*>(ctrs);
  for (long long c = tid; c < n_chunks; c += kThreads)
    c2[c] = make_int2(iters, copies);
}

// the shared-memory opt-in, made once per device
std::atomic<int> g_ready[kMaxDevices];

}  // namespace

extern "C" int bounce_launch(const void* x, void* out, void* ctrs,
                             long long n_bytes, long long n_chunks, int copies,
                             long long iters_per_chunk, int device, int sms,
                             void* stream) {
  if (device < 0 || device >= kMaxDevices || sms < 1)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (!g_ready[device].load(std::memory_order_relaxed)) {
    const cudaError_t err = cudaFuncSetAttribute(
        bounce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_ready[device].store(1, std::memory_order_relaxed);
  }
  Plan p = make_plan(x, out, n_bytes, copies, sms);
  const unsigned char* xp = static_cast<const unsigned char*>(x);
  unsigned char* op = static_cast<unsigned char*>(out);
  int* cp = static_cast<int*>(ctrs);
  void* args[] = {&xp, &op, &cp, &n_bytes, &p, &n_chunks, &copies,
                  &iters_per_chunk};
  return static_cast<int>(cudaLaunchKernel(
      reinterpret_cast<const void*>(bounce_kernel), dim3(p.grid),
      dim3(kThreads), args, static_cast<size_t>(p.smem),
      static_cast<cudaStream_t>(stream)));
}

namespace {

__global__ void stall_kernel(const int* __restrict__ iters,
                             float* __restrict__ sink) {
  const int n = *iters;
  float v = 1.0f;
  for (int i = 0; i < n; ++i) v = fmaf(v, 1.0000001f, 1e-9f);
  *sink = v;
}

}  // namespace

extern "C" int bounce_stall_launch(const void* iters, void* sink,
                                   void* stream) {
  stall_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(iters), static_cast<float*>(sink));
  return static_cast<int>(cudaGetLastError());
}
