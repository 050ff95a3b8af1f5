// Flash-attention forward (prefill) and backward for Hopper (sm_90a).
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
// `logit_cap` (tanh soft cap, 0 = off).  Scale 1/sqrt(D), given by the
// caller.  Masked logits are NEG_INF = -2^30 and masked probabilities
// exactly 0, so a fully masked row gives 0.  bf16 inputs, f32 softmax
// state and accumulators, P rounded to bf16 before P.V.  Whole kv tiles
// are skipped past `valid_len`, above the causal diagonal or left of the
// window, exactly as the TPU kernel skips blocks; ragged tiles at the
// end of a sequence are masked instead of shrinking the tiles to a
// divisor of S as the TPU wrapper does.
//
// What bounds it.  4*D flops per unmasked (q, k) pair against
// (2*Sq*H + 2*Skv*KVH)*D*2 bytes (each input read once, the output
// written once).  At gemma3-1b's prefill shapes (H=4, KVH=1, D=256) that
// bound is the bytes at S <= 512 (0.78 us at S=512 causal, at 3.35 TB/s)
// and the operations at S=2048 (8.7 us global causal, at the 989 TFLOP/s
// of the bf16 tensor cores); chip_smoke.py phase 2 computes both for
// every case.  A block walks at most 32 kv tiles, so what the card loses
// is latency: each tile's copy, the chain Q.K^T -> softmax -> P.V inside
// a tile, and few blocks (32 at gemma3 S=512).
//
// What the design does about it (bf16, D in {64, 128, 256}; the wrapper
// zero-pads bf16 D in {16, 32} to 64 and passes the scale of the real D):
// - One block per (64-row q tile, head, batch); causal q tiles are
//   launched heaviest first (blockIdx.x reversed).
// - Warp specialisation: warps 0-3 are one consumer warpgroup that owns
//   the 64 query rows; warp 4 is the producer.  One consumer warpgroup at
//   every D: at D=64 a block takes 41 KB and 128 registers a thread, so
//   three blocks share an SM and overlap one another's softmax and wgmma,
//   which a second consumer warpgroup would buy with a second code path;
//   at D=256 a second one would halve the blocks (16 at S=512).  No
//   setmaxnreg: one block fills the SM at D >= 128, where the launch
//   bounds already give the consumers 255 registers (D=256 uses 255 with
//   no spill), and a producer of one warp frees too few to matter.  With
//   launch bounds for two blocks ptxas capped the kernel at 168 registers
//   and the D=256 consumer spilled, setmaxnreg or not.
// - The producer fills a K/V ring in shared memory (3 stages at D=256,
//   2 below) with TMA: a 3-D tensor map over (B, S, heads*D), 64x64 boxes
//   with the 128-byte swizzle the wgmma descriptors read, rows past S
//   zero-filled; full/empty mbarriers.  Q arrives the same way once.
// - S = Q.K^T is wgmma m64n64k16 with both operands in shared memory
//   (K-major, 128-byte swizzle); the f32 scores stay in registers.
// - The online softmax runs on those registers: the row max is two
//   shuffles across the 4 threads that share a row, m and l stay in
//   registers (l as per-thread partial sums, reduced once at the end),
//   log2(e) is folded into the scale so each p is one exp2.  Only tiles
//   that cut the causal diagonal, the window edge, valid_len or Skv build
//   a mask.
// - O += P.V is wgmma m64n64k16 per 64 output columns with P converted
//   to bf16 in registers as the A operand (the accumulator layout of
//   Q.K^T is the A-fragment layout) and V from shared memory through the
//   transpose bit (V is stored kv-row-major).  O lives in registers for
//   the whole block (128 f32 a thread at D=256) and is rescaled there.
// - Within the warpgroup, Q.K^T of tile j+1 is issued before P.V of tile
//   j, and the softmax of tile j+1 runs while P.V of tile j does.  The
//   loop has no conditional wgmma and the barrier waits loop inside their
//   asm, so ptxas keeps the wgmma asynchronous (no C7514/C7520 warning).
// - Epilogue: normalise by max(l, 1e-30), stage bf16 O in Q's shared
//   memory, write it with 16-byte stores.
// - Optional log-sum-exp (B, H, Sq) f32, for the training backward
//   (`repro`'s `_flash_fwd_impl` returns it as (B, KVH, G, Sq), the same
//   memory since h = kvh * G + g).  m and l are kept in base 2 (log2(e)
//   is folded into the scale), so a row's natural-log lse of its scaled,
//   soft-capped logits is (m + log2 l) * ln 2.  One of the four threads
//   of a row writes it once O is staged, when O's registers are free.
//   The wrapper refuses a call with a fully masked row, whose lse would
//   be meaningless.  With a null pointer nothing more is done.
// Every mbarrier wait traps after 2 s instead of hanging the card.
//
// f32 inputs (the smoke configs), any D in {16, 32, 64, 128, 256}, take
// the f32 kernel further down: the same masks, skips, online softmax and
// lse, with both products on the tensor cores as mma.sync at about f32
// accuracy, three TF32 products for each f32 one.  What bounds it at
// train_lm's rank shape (B=2 S=256, 8 over 4 heads, D=64: 0.13 GFLOP,
// 3.1 MB) is latency again: a 64-row block walks at most 4 kv tiles.
//
// The backward (`flash_attention_bwd_launch`, behind
// `ops.flash_attention_bwd` and `FlashAttention.backward`).  It replaces
// no TPU kernel: `repro`'s gradient is `_flash_bwd`
// (src/repro/layers/attention.py:248), the custom_vjp partner of the
// Pallas forward, which XLA compiles; this computes what
// `ref.flash_attention_bwd_plain` does.  From q, k, v, o, dO and the
// forward's lse: P = exp(cap(q.k * scale) - lse) on the pairs the masks
// leave, delta = rowsum(dO * O), dS = P (dO.v - delta) times the soft
// cap's derivative 1 - tanh^2, dV = P^T dO, dK = dS^T q * scale,
// dQ = dS k * scale; every mask the forward with lse takes (causal,
// window, soft cap, GQA, Sq != Skv, ragged ends).
//
// What bounds it.  10 * D operations a pair (five products) against q,
// k, v, o, dO, lse read and dQ, dK, dV written once: the operations at
// whisper's encoder (17.3 GFLOP, 17.5 us at 989 TFLOP/s), the bytes at
// the S=256 train shapes (1.6 us at gemma3-1b's B=2).  Without atomics the
// design pays two more products (S and dP are recomputed in a second
// pass), 14 * D a pair.  What the card loses is latency and occupancy:
// each 64 x 64 tile pair chains a product, a pass over its scores in
// registers and a product that depends on them.  At D=64 that pass over
// the scores (exp, masks, the exchange), not the products, bounds both
// passes, so it is kept short: it is specialised at compile time on the
// mask and the soft cap (an interior tile without a cap evaluates
// neither), exp is one ex2.approx (exp2f costs several instructions),
// and the exchange and the rows' lse and delta move as float4 / float2.
// Whisper's encoder has 288 dK/dV blocks for 264 places (two an SM): two
// waves.
//
// The bf16 path (D in {64, 128, 256}; the wrapper zero-pads D of 16 and
// 32 to 64 and passes the scale of the real D), in three to five
// launches: delta (one warp a row), then two passes that each recompute
// S and P from the lse, as the f32 path always did.
// - dK/dV pass, one block per (64-row kv tile, kv head, batch): K and V
//   stay in shared memory; a TMA ring (3 stages, 2 at D=256) streams Q,
//   dO and the rows' lse and delta over the G query heads of the group
//   times the q tiles the masks leave (heads outer, tiles skipped above
//   the diagonal and left of the window as the forward skips them), so
//   the group's sum stays in the block.  Two consumer warpgroups split
//   the products, not the rows: group 0 computes S^T = K Q^T
//   (m64n64k16, both operands K-major from shared memory), turns it into
//   P^T in f32 registers and accumulates dV += P^T dO with P^T in bf16
//   as the register A operand and dO through wgmma's transpose bit (the
//   forward's P.V); group 1 computes dP^T = V dO^T and dK += dS^T Q the
//   same way.  dS^T = P^T dcap (dP^T - delta) needs group 0's P^T dcap:
//   it crosses through 16 KB of shared memory, thread to thread in the
//   accumulator layout (no swizzle, no proxy fence), behind two named
//   barriers (written / read).  Each group holds one 64 x D f32
//   accumulator: 128 registers a thread at D=256, where a producer
//   warpgroup hands its registers to the consumers (setmaxnreg 40 / 232;
//   one block an SM by shared memory, 210 KB) and nothing spills.
// - dQ pass, one block per (64-row q tile, head, batch): Q, dO and the
//   rows' lse and delta stay resident, a TMA ring streams K and V (3
//   stages at D=64, 2 above); one consumer warpgroup computes S = Q K^T
//   and dP = dO V^T, dS in registers and dQ += dS K with dS as the
//   register A operand.  Three blocks an SM at D=64.
// - All five kinds of product run on the bf16 tensor cores with f32
//   accumulators; P and dS are rounded to bf16 before they enter a
//   product, as the forward rounds P; the masks, the soft cap and its
//   derivative stay in f32.  One producer warp issues the TMA loads
//   (64 x 64 boxes, 128-byte swizzle, rows past S read as 0) behind
//   full/empty mbarriers that trap after 2 s.
// - No atomics: each block sums its reduction list in a fixed order.
//   Where the grid is too small for the card (gemma3-1b's one kv head:
//   8 dK/dV blocks at B=2, S=256) a pass cuts its list into up to 8
//   contiguous runs, one block each, whose f32 partials a sum kernel adds
//   in order (`bwd_plan` picks the runs from the shape and the SM
//   count).  So two calls give the same bits.
// The f32 path (the smoke configs, any D of 16-256): the same two passes
// and plan, tiles of 64 x 64 (32 x 32 at D = 256), a warp a 16-row band
// of the resident tile, and all five products on the tensor cores as
// mma.sync with three TF32 products for each f32 one (one TF32 product
// would miss the 2e-5 gates by two orders of magnitude).  The streamed
// tiles are double-buffered with cp.async; P^T and dS^T enter their
// products straight from the accumulators.
//
// C interface: flash_attention_launch and flash_attention_bwd_launch
// return 0, a cudaError_t, or (the forward) kErrTensorMap below.

#include <cuda.h>   // CUtensorMap and its enums; the driver is reached
                    // through cudaGetDriverEntryPoint, so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <chrono>

namespace {

constexpr float kNegInf = -1073741824.0f;   // -2^30, as the TPU kernel
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 64;
constexpr int kErrTensorMap = 10001;   // cuTensorMapEncodeTiled refused

// ---------------------------------------------------------------------------
// bf16 path: wgmma + TMA, warp-specialised
// ---------------------------------------------------------------------------

constexpr int kBQ = 64, kBK = 64;          // q rows and kv rows per tile
constexpr int kConsumers = 128;            // one warpgroup
constexpr int kThreads = kConsumers + 32;  // + one producer warp
constexpr int kPanelBytes = 64 * 128;      // one TMA box: 64 rows x 128 B
constexpr uint64_t kHangNs = 2000000000ull;

template <int D>
struct Smem {
  static constexpr int kPanels = D / 64;   // 64-column panels of a tile
  static constexpr int kTile = kPanels * kPanelBytes;
  // K/V ring depth: 3 at D=256 (224 KB with Q), 2 below
  static constexpr int kStages = D == 256 ? 3 : 2;
  // blocks an SM holds: one at D >= 128 (shared memory at D=256, about
  // 220 consumer registers at D=128), three at D=64
  static constexpr int kMinBlocks = D >= 128 ? 1 : 3;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + kTile;
  static constexpr int V_OFF = K_OFF + kStages * kTile;
  static constexpr int BAR_OFF = V_OFF + kStages * kTile;
  // full[kStages], empty[kStages], q
  static constexpr int BYTES = BAR_OFF + (2 * kStages + 1) * 8;
  static constexpr int ALLOC = BYTES + 1024;   // to align the base to 1 KB
};

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

// Wait until the phase of parity `parity` has completed.  The loop is
// inside the asm, so the compiler sees no divergent branch before the
// wgmma that follow.  A ring that never fills traps after kHangNs
// instead of hanging the card.
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

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle mode in bits 62-63.
constexpr uint64_t kSwizzle128 = 1ull << 62;

__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | swizzle;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>   // until at most N committed groups are in flight
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keeps the compiler from moving register reads or writes across the
// asynchronous wgmma that owns the register.
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// d (64x64 f32) (+)= A (64x16, shared, K-major) . B (16x64, shared,
// K-major).  accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64x64 f32) += A (64x16 bf16, registers) . B (16x64, shared,
// MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The online-softmax step on one tile's scores.  Thread layout of the
// m64n64 accumulator (and of mma.sync's m16n8 tiles side by side):
// s[4i + {0,1}] is row ra, columns 8i + 2c + {0,1}; s[4i + {2,3}] is row
// ra + 8.  On return s holds p (f32), m/l are updated, and corr_a/corr_b
// rescale this thread's rows of O.
template <bool kMask, int N>
__device__ __forceinline__ void softmax_tile(
    float (&s)[N], float& m_a, float& m_b, float& l_a, float& l_b,
    float& corr_a, float& corr_b, float scale_log2, float cap,
    float cap_scale, int qa, int k0, int c, int kv_end, int causal,
    int window) {
#pragma unroll
  for (int e = 0; e < N; ++e) {
    s[e] = cap > 0.f ? cap * kLog2e * tanhf(s[e] * cap_scale)
                     : s[e] * scale_log2;
  }
  uint32_t ok = 0xffffffffu;
  if constexpr (kMask) {
    ok = 0u;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int kpos = k0 + 8 * (e >> 2) + 2 * c + (e & 1);
      const int qpos = qa + ((e & 2) ? 8 : 0);
      bool valid = kpos < kv_end;
      if (causal) valid = valid && kpos <= qpos;
      if (window > 0) valid = valid && qpos - kpos < window;
      ok |= (valid ? 1u : 0u) << e;
      s[e] = valid ? s[e] : kNegInf;
    }
  }
  float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    if (e & 2) mx_b = fmaxf(mx_b, s[e]);
    else mx_a = fmaxf(mx_a, s[e]);
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
  }
  const float new_a = fmaxf(m_a, mx_a), new_b = fmaxf(m_b, mx_b);
  corr_a = exp2f(m_a - new_a);
  corr_b = exp2f(m_b - new_b);
  m_a = new_a;
  m_b = new_b;
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    float p = exp2f(s[e] - ((e & 2) ? new_b : new_a));
    if constexpr (kMask) p = ((ok >> e) & 1u) ? p : 0.f;
    s[e] = p;
    if (e & 2) sum_b += p;
    else sum_a += p;
  }
  l_a = l_a * corr_a + sum_a;
  l_b = l_b * corr_b + sum_b;
}

// S = Q K^T for one kv tile: D/16 k-steps of 32 bytes inside the
// 128-byte rows of Q's and K's panels.  Issued, not waited for.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t sQ,
                                         uint32_t sK) {
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = 0.f;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kPanelBytes + (kk % 4) * 32;
    wgmma_ss(s, desc(sQ + off, 16, 1024, kSwizzle128),
             desc(sK + off, 16, 1024, kSwizzle128), kk > 0);
  }
  wg_commit();
}

// O += P V for one kv tile: V rows 16kk.. start 2 KB apart in a panel, 64
// output columns a panel.  Issued, not waited for.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 64][32],
                                         const uint32_t (&pa)[4][4],
                                         uint32_t sV) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int p = 0; p < D / 64; ++p)
      wgmma_rs(acc[p], pa[kk],
               desc(sV + p * kPanelBytes + kk * 2048, kPanelBytes, 1024,
                    kSwizzle128));
  wg_commit();
}

// P (bf16) as wgmma's A operand: k-step kk is score blocks 2kk and 2kk+1.
__device__ __forceinline__ void pack_p(uint32_t (&pa)[4][4],
                                       const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int D>
__device__ __forceinline__ void rescale(float (&acc)[D / 64][32], float ca,
                                        float cb) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc[p][4 * i + 0] *= ca;
      acc[p][4 * i + 1] *= ca;
      acc[p][4 * i + 2] *= cb;
      acc[p][4 * i + 3] *= cb;
    }
}

template <int D>
__global__ void __launch_bounds__(kThreads, Smem<D>::kMinBlocks)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int Sq, int Skv, int H,
                      int KVH, int causal, int window, int valid_len,
                      float logit_cap, float scale) {
  using L = Smem<D>;
  constexpr int kPanels = L::kPanels, kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // 128-byte swizzle atoms
  uint8_t* gbase = smem_raw + (base - raw);       // its generic address
  const uint32_t sQ = base + L::Q_OFF;
  const uint32_t bars = base + L::BAR_OFF;        // full, empty, q
  const uint32_t q_bar = bars + 8u * (2 * kStages);

  // heaviest causal q tile first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int q_last = min(q0 + kBQ - 1, Sq - 1);
  const int kv_end = min(valid_len, Skv);    // keys at or past it: masked
  int kt_end = (max(kv_end, 0) + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, q_last / kBK + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / kBK;
  const int n_tiles = max(kt_end - kt_begin, 0);

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bars + 8u * st, 1);
      mbar_init(bars + 8u * (kStages + st), kConsumers);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kConsumers / 32) {
    // ---------------- producer warp ----------------
    if (lane == 0) {
      mbar_expect_tx(q_bar, L::kTile);
      for (int p = 0; p < kPanels; ++p)
        tma_load(sQ + p * kPanelBytes, &tm_q, q_bar, h * D + 64 * p, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        const int k0 = (kt_begin + j) * kBK;
        const uint32_t full = bars + 8u * st;
        mbar_wait(bars + 8u * (kStages + st), ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(full, 2 * L::kTile);
        const uint32_t sK = base + L::K_OFF + st * L::kTile;
        const uint32_t sV = base + L::V_OFF + st * L::kTile;
        for (int p = 0; p < kPanels; ++p) {
          tma_load(sK + p * kPanelBytes, &tm_k, full, kvh * D + 64 * p, k0, b);
          tma_load(sV + p * kPanelBytes, &tm_v, full, kvh * D + 64 * p, k0, b);
        }
      }
    }
  } else {
    // ---------------- consumer warpgroup ----------------
    const int g = lane / 4, c = lane % 4;
    const int ra = warp * 16 + g;               // rows ra and ra + 8
    const float scale_log2 = scale * kLog2e;
    const float cap_scale = logit_cap > 0.f ? scale / logit_cap : 0.f;

    float acc[kPanels][32];
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[p][e] = 0.f;
    float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
    float s[32];
    uint32_t pa[4][4];

    // wait for tile j's K/V and issue its S = Q K^T
    auto start_qk = [&](int j) {
      const int st = j % kStages;
      mbar_wait(bars + 8u * st, (j / kStages) & 1);
      issue_qk<D>(s, sQ, base + L::K_OFF + st * L::kTile);
    };
    // the online softmax of tile j on s; returns O's rescale factors
    auto softmax = [&](int j, float& ca, float& cb) {
#pragma unroll
      for (int e = 0; e < 32; ++e) reg_fence(s[e]);
      const int k0 = (kt_begin + j) * kBK;
      // a mask only where the tile cuts valid_len / Skv, the causal
      // diagonal or the window edge
      const bool need_mask = k0 + kBK > kv_end ||
                             (causal && k0 + kBK - 1 > q0) ||
                             (window > 0 && q_last - k0 >= window);
      if (need_mask)
        softmax_tile<true>(s, m_a, m_b, l_a, l_b, ca, cb, scale_log2,
                           logit_cap, cap_scale, q0 + ra, k0, c, kv_end,
                           causal, window);
      else
        softmax_tile<false>(s, m_a, m_b, l_a, l_b, ca, cb, scale_log2,
                            logit_cap, cap_scale, q0 + ra, k0, c, kv_end,
                            causal, window);
    };
    auto fence_acc = [&]() {
#pragma unroll
      for (int p = 0; p < kPanels; ++p)
#pragma unroll
        for (int e = 0; e < 32; ++e) reg_fence(acc[p][e]);
    };

    mbar_wait(q_bar, 0);
    // Q K^T of tile j+1 runs on the tensor cores while P V of tile j
    // waits behind it; the softmax of tile j+1 runs while P V of tile j
    // does.  The last tile is peeled off, so no wgmma is conditional.
    if (n_tiles > 0) {
      float ca, cb;
      start_qk(0);
      wg_wait<0>();
      softmax(0, ca, cb);        // O is still 0: nothing to rescale
      pack_p(pa, s);
      for (int j = 0; j + 1 < n_tiles; ++j) {
        const int st = j % kStages;
        start_qk(j + 1);
        issue_pv<D>(acc, pa, base + L::V_OFF + st * L::kTile);
        wg_wait<1>();            // S of tile j+1 is in; P V of j may run
        softmax(j + 1, ca, cb);
        wg_wait<0>();
        fence_acc();
        mbar_arrive(bars + 8u * (kStages + st));   // the stage may be refilled
        rescale<D>(acc, ca, cb);   // O where m moved
        pack_p(pa, s);
      }
      const int st = (n_tiles - 1) % kStages;
      issue_pv<D>(acc, pa, base + L::V_OFF + st * L::kTile);
      wg_wait<0>();
      fence_acc();
      mbar_arrive(bars + 8u * (kStages + st));
    }

    // ---- epilogue: normalise, stage bf16 O in Q's panels, 16-byte stores
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
    const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");  // Q read
    const int rb = ra + 8;
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        uint8_t* panel = gbase + L::Q_OFF + p * kPanelBytes;
        *reinterpret_cast<uint32_t*>(panel + ra * 128 + ((i ^ (ra & 7)) << 4) +
                                     4 * c) =
            pack_bf16(acc[p][4 * i] * inv_a, acc[p][4 * i + 1] * inv_a);
        *reinterpret_cast<uint32_t*>(panel + rb * 128 + ((i ^ (rb & 7)) << 4) +
                                     4 * c) =
            pack_bf16(acc[p][4 * i + 2] * inv_b, acc[p][4 * i + 3] * inv_b);
      }
    asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
    if (lse != nullptr && c == 0) {
      constexpr float kLn2 = 0.6931471805599453f;
      float* lrow = lse + (static_cast<long long>(b) * H + h) * Sq + q0;
      if (q0 + ra < Sq) lrow[ra] = (m_a + log2f(fmaxf(l_a, 1e-30f))) * kLn2;
      if (q0 + rb < Sq) lrow[rb] = (m_b + log2f(fmaxf(l_b, 1e-30f))) * kLn2;
    }
    constexpr int kChunks = D / 8;   // 16-byte chunks in a row
    for (int idx = threadIdx.x; idx < kBQ * kChunks; idx += kConsumers) {
      const int r = idx / kChunks, ch = idx % kChunks;
      if (q0 + r >= Sq) break;   // rows only grow with idx
      const uint4 val = *reinterpret_cast<const uint4*>(
          gbase + L::Q_OFF + (ch / 8) * kPanelBytes + r * 128 +
          (((ch % 8) ^ (r & 7)) << 4));
      *reinterpret_cast<uint4*>(
          o + ((static_cast<long long>(b) * Sq + q0 + r) * H + h) * D +
          ch * 8) = val;
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static std::atomic<EncodeTiled> fn{nullptr};
  EncodeTiled f = fn.load(std::memory_order_acquire);
  if (f != nullptr) return f;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
  cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
  f = reinterpret_cast<EncodeTiled>(p);
  fn.store(f, std::memory_order_release);
  return f;
}

// A 3-D map over a (B, S, width) bf16 tensor: 64x64 boxes (64 columns =
// 128 bytes) with the 128-byte swizzle; rows past S read as 0.
bool encode_rows(EncodeTiled fn, CUtensorMap* map, const void* ptr, int B,
                 int S, int width) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(width) * 2,
                                 static_cast<cuuint64_t>(S) * width * 2};
  const cuuint32_t box[3] = {64, kBQ, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool encode_qkv(CUtensorMap* maps, const void* q, const void* k,
                const void* v, int B, int Sq, int Skv, int H, int KVH,
                int D) {
  EncodeTiled fn = encoder();
  return fn != nullptr && encode_rows(fn, &maps[0], q, B, Sq, H * D) &&
         encode_rows(fn, &maps[1], k, B, Skv, KVH * D) &&
         encode_rows(fn, &maps[2], v, B, Skv, KVH * D);
}

template <int D>
int launch_sm90(const void* q, const void* k, const void* v, void* o,
                void* lse, int B,
                int Sq, int Skv, int H, int KVH, int causal, int window,
                int valid_len, float logit_cap, float scale,
                cudaStream_t stream) {
  using L = Smem<D>;
  auto kern = flash_fwd_sm90_kernel<D>;
  // the shared-memory opt-in, once per device
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::ALLOC);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev].store(true, std::memory_order_relaxed);
  }
  CUtensorMap maps[3];
  if (!encode_qkv(maps, q, k, v, B, Sq, Skv, H, KVH, D)) return kErrTensorMap;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, L::ALLOC, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), Sq, Skv, H, KVH, causal, window, valid_len,
      logit_cap, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32 path: three TF32 tensor-core products for each f32 product
// ---------------------------------------------------------------------------
//
// Every product of the f32 forward and backward runs on the tensor cores
// as mma.sync m16n8k8 with TF32 operands.  Each f32 operand x is split
// into hi = tf32(x) and lo = tf32(x - hi) (to nearest, ties away from
// zero, as cvt.rna rounds), and a k-step of 8 sums lo.hi, hi.lo and
// hi.hi, the small terms first, into fresh registers, which the CUDA
// cores then add to the f32 accumulator.  A product of two TF32 values is
// exact in f32; the dropped lo.lo and lo's own rounding cost about 2^-22
// of a term.  The k-steps are added outside the tensor core because its
// sums may truncate: the CPU mirror (tools/flash_f32_precision.py),
// which assumes they do, holds every f32 gate this way and misses them at
// train_lm's shape with the three products chained through one
// accumulator.  The operands come from shared memory with plain 32-bit
// loads, rows D + 4 floats apart, so every fragment load of a warp hits
// 32 banks.

// Fragments of mma.sync m16n8k8 .tf32, each as its hi and lo parts.
// Thread (g, t) = (lane / 4, lane % 4) holds A (16 x 8) rows g and g + 8
// at columns t and t + 4, B (8 x 8) rows t and t + 4 at column g, and the
// f32 accumulator (16 x 8) rows g and g + 8 at columns 2t and 2t + 1.
struct TfA {
  uint32_t hi[4], lo[4];
};
struct TfB {
  uint32_t hi[2], lo[2];
};

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero): half an ulp added to the magnitude, the 13 low bits
// cleared.  Two integer operations where cvt.rna, which also checks for
// Inf and NaN (attention's operands are finite), takes four.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as hi + lo, two TF32 values: hi = tf32(x), lo = tf32(x - hi) (x - hi
// is exact in f32).
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ TfA tf_a(float a0, float a1, float a2,
                                    float a3) {
  TfA f;
  tf32_split(a0, f.hi[0], f.lo[0]);
  tf32_split(a1, f.hi[1], f.lo[1]);
  tf32_split(a2, f.hi[2], f.lo[2]);
  tf32_split(a3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ TfB tf_b(float b0, float b1) {
  TfB f;
  tf32_split(b0, f.hi[0], f.lo[0]);
  tf32_split(b1, f.hi[1], f.lo[1]);
  return f;
}

// d (16 x 8 f32) += a . b, one TF32 product on the tensor cores
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a . b at about f32 accuracy: lo.hi, hi.lo and hi.hi into fresh
// registers, then added to d on the CUDA cores.
__device__ __forceinline__ void mma3(float* d, const TfA& a, const TfB& b) {
  float x[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(x, a.lo, b.hi);
  mma_tf32(x, a.hi, b.lo);
  mma_tf32(x, a.hi, b.hi);
#pragma unroll
  for (int u = 0; u < 4; ++u) d[u] += x[u];
}

// The A fragment at rows r0.. and columns k0.. of a row-major tile.
__device__ __forceinline__ TfA frag_a(const float* s, int ld, int r0, int k0,
                                      int g, int t) {
  const float* p = s + (r0 + g) * ld + k0 + t;
  return tf_a(p[0], p[8 * ld], p[4], p[8 * ld + 4]);
}

// The B fragment B(k, n) = T[n0 + n][k0 + k]: a tile whose rows are B's
// columns (K in Q.K^T).
__device__ __forceinline__ TfB frag_bt(const float* s, int ld, int n0, int k0,
                                       int g, int t) {
  const float* p = s + (n0 + g) * ld + k0 + t;
  return tf_b(p[0], p[4]);
}

// A 16 x 8 accumulator tile as the A fragment over its 8 columns.  The
// accumulator holds columns 2t and 2t + 1 where the fragment wants t and
// t + 4, and a product sums over k in any order, so k = t and t + 4 stand
// for columns 2t and 2t + 1: the accumulator becomes the fragment with no
// shuffle.  frag_bp reads B's rows in the same order.
__device__ __forceinline__ TfA frag_acc(const float* c) {
  return tf_a(c[0], c[2], c[1], c[3]);
}

// The B fragment B(k, n) = T[k0 + k][n0 + n] with its k permuted as
// frag_acc's: fragment rows t and t + 4 are tile rows 2t and 2t + 1.
__device__ __forceinline__ TfB frag_bp(const float* s, int ld, int k0, int n0,
                                       int g, int t) {
  const float* p = s + (k0 + 2 * t) * ld + n0 + g;
  return tf_b(p[0], p[ld]);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>   // until at most N committed groups are in flight
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Rows [r0, r0 + R) of head hd of a (B, S, NH, D) f32 tensor into dst,
// rows D + 4 floats apart, with cp.async by NT threads; rows at or past S
// are zero-filled (nothing is read for them).
template <int D, int R, int NT>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int b, int r0, int S, int NH,
                                           int hd) {
  constexpr int kVec = D / 4;   // 16-byte chunks a row
  for (int i = threadIdx.x; i < R * kVec; i += NT) {
    const int r = i / kVec, c = i % kVec;
    const bool in = r0 + r < S;
    const float* at =
        in ? src + ((static_cast<long long>(b) * S + r0 + r) * NH + hd) * D +
                 4 * c
           : src;
    cp_async16(dst + r * (D + 4) + 4 * c, at, in);
  }
}

// The lse and delta of rows [r0, r0 + R) of head h, (B, H, Sq) each, into
// dst[0, R) and dst[R, 2R) with cp.async by NT threads; rows past Sq
// read 0.
template <int R, int NT>
__device__ __forceinline__ void stage_lse(float* dst, const float* lse,
                                          const float* delta, int b, int h,
                                          int H, int r0, int Sq) {
  for (int i = threadIdx.x; i < 2 * R; i += NT) {
    const int r = i % R;
    const bool in = r0 + r < Sq;
    const float* src = i < R ? lse : delta;
    cp_async4(dst + i,
              in ? src + (static_cast<long long>(b) * H + h) * Sq + r0 + r
                 : src,
              in);
  }
}

constexpr int kF32Warps = 8;
constexpr int kF32Threads = 32 * kF32Warps;

// The f32 forward's tiles and shared memory (floats): Q of the block's
// BQ rows, then two stages of K and V tiles of BK rows.  Two warps share
// each 16-row band of Q, one for each half of a tile's keys; at the end
// the halves' softmax state and O meet in XCH floats over the K/V stages.
template <int D>
struct F32Fwd {
  static constexpr int BQ = 64;
  static constexpr int BK = D >= 128 ? 32 : 64;
  static constexpr int LD = D + 4;
  static constexpr int K_OFF = BQ * LD;
  static constexpr int V_OFF = K_OFF + 2 * BK * LD;
  static constexpr int BYTES = (V_OFF + 2 * BK * LD) * 4;
  static constexpr int XCH = (4 + D / 2) * kF32Threads / 2;
  static_assert(XCH <= 4 * BK * LD, "the halves' exchange fits");
};

// One block per (64-row q tile, head, batch), heaviest causal tile first.
// Its eight warps take the tile's four 16-row bands twice: warp w and
// w + 4 own the same rows, w the first half of every K/V tile's keys and
// w + 4 the second, each with its own online softmax; the two merge at
// the end.  So a block runs eight chains of dependent products, not four,
// and each chain is half as long.  K/V tiles are double-buffered with
// cp.async, so tile j + 1's copy runs under tile j's products.  S = Q K^T
// and O += P V are three-TF32-product mma.sync; S, O and the softmax
// state stay in registers (the bf16 path's online softmax, softmax_tile,
// on the same accumulator layout), P goes from S's accumulator into P V's
// A fragment with no shuffle, and a warp skips a half tile that none of
// its rows sees.  Whole tiles are skipped past valid_len, above the
// causal diagonal and left of the window, as on the bf16 path; ragged
// tiles are masked, rows past Skv read as 0.
template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Skv, int H, int KVH,
                     int causal, int window, int valid_len, float logit_cap,
                     float scale) {
  using L = F32Fwd<D>;
  constexpr int BQ = L::BQ, BK = L::BK, LD = L::LD;
  constexpr int KH = BK / 2;   // keys of a tile a warp takes
  constexpr int NS = KH / 8;   // n-tiles of its S, k-steps of its P V
  constexpr int NO = D / 8;    // k-steps of Q K^T, n-tiles of O
  extern __shared__ __align__(16) float fsm[];
  const float* sQ = fsm;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int band = warp % 4, half = warp / 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int q_last = min(q0 + BQ - 1, Sq - 1);
  const int kv_end = min(valid_len, Skv);    // keys at or past it: masked
  int kt_end = (max(kv_end, 0) + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, q_last / BK + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BK;
  const int n_tiles = max(kt_end - kt_begin, 0);

  auto stage_kv = [&](int j) {
    const int k0 = (kt_begin + j) * BK;
    stage_rows<D, BK, kF32Threads>(fsm + L::K_OFF + (j & 1) * BK * LD, k, b,
                                   k0, Skv, KVH, kvh);
    stage_rows<D, BK, kF32Threads>(fsm + L::V_OFF + (j & 1) * BK * LD, v, b,
                                   k0, Skv, KVH, kvh);
  };
  stage_rows<D, BQ, kF32Threads>(fsm, q, b, q0, Sq, H, h);
  if (n_tiles > 0) stage_kv(0);
  cp_commit();

  const int qw = q0 + 16 * band;   // the warp's rows qw .. qw + 15
  const int ra = qw + g;           // this thread's rows ra and ra + 8
  const float scale_log2 = scale * kLog2e;
  const float cap_scale = logit_cap > 0.f ? scale / logit_cap : 0.f;
  float acc[NO * 4];
#pragma unroll
  for (int e = 0; e < NO * 4; ++e) acc[e] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) stage_kv(j + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const int k0 = (kt_begin + j) * BK + half * KH;   // keys k0 .. k0+KH-1
    const float* sK = fsm + L::K_OFF + ((j & 1) * BK + half * KH) * LD;
    const float* sV = fsm + L::V_OFF + ((j & 1) * BK + half * KH) * LD;
    // a row of this warp sees a key of its half tile
    bool live = qw < Sq && k0 < kv_end;
    if (causal) live = live && k0 <= qw + 15;
    if (window > 0) live = live && qw - (k0 + KH - 1) < window;
    if (live) {
      float s[NS * 4];
#pragma unroll
      for (int e = 0; e < NS * 4; ++e) s[e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NO; ++kk) {
        const TfA qf = frag_a(sQ, LD, 16 * band, 8 * kk, g, t);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const TfB kf = frag_bt(sK, LD, 8 * n, 8 * kk, g, t);
          mma3(s + 4 * n, qf, kf);   // S = Q K^T
        }
      }
      // a mask only where the half tile cuts valid_len / Skv, the causal
      // diagonal or the window edge for this warp's rows
      const bool need_mask = k0 + KH > kv_end ||
                             (causal && k0 + KH - 1 > qw) ||
                             (window > 0 && qw + 15 - k0 >= window);
      float ca, cb;
      if (need_mask)
        softmax_tile<true>(s, m_a, m_b, l_a, l_b, ca, cb, scale_log2,
                           logit_cap, cap_scale, ra, k0, t, kv_end, causal,
                           window);
      else
        softmax_tile<false>(s, m_a, m_b, l_a, l_b, ca, cb, scale_log2,
                            logit_cap, cap_scale, ra, k0, t, kv_end, causal,
                            window);
#pragma unroll
      for (int n = 0; n < NO; ++n) {   // O where m moved
        acc[4 * n] *= ca;
        acc[4 * n + 1] *= ca;
        acc[4 * n + 2] *= cb;
        acc[4 * n + 3] *= cb;
      }
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        const TfA pf = frag_acc(s + 4 * kk);
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          const TfB vf = frag_bp(sV, LD, 8 * kk, 8 * n, g, t);
          mma3(acc + 4 * n, pf, vf);   // O += P V
        }
      }
    }
    __syncthreads();   // the stage is refilled at tile j + 2
  }
  cp_wait<0>();

  // ---- the halves merge: warp w + 4 hands m, l and O to warp w through
  // the K/V stages, which no warp reads any more (element i of a thread at
  // xch[i * 128], so a warp's stores hit 32 banks)
  float* xch = fsm + L::K_OFF + band * 32 + lane;
  constexpr int kX = kF32Threads / 2;
  if (half == 1) {
    xch[0] = m_a;
    xch[kX] = m_b;
    xch[2 * kX] = l_a;
    xch[3 * kX] = l_b;
#pragma unroll
    for (int e = 0; e < NO * 4; ++e) xch[(4 + e) * kX] = acc[e];
  }
  __syncthreads();
  if (half == 1) return;
  {
    const float m2a = xch[0], m2b = xch[kX];
    const float na = fmaxf(m_a, m2a), nb = fmaxf(m_b, m2b);
    const float c1a = exp2f(m_a - na), c2a = exp2f(m2a - na);
    const float c1b = exp2f(m_b - nb), c2b = exp2f(m2b - nb);
    l_a = l_a * c1a + xch[2 * kX] * c2a;
    l_b = l_b * c1b + xch[3 * kX] * c2b;
    m_a = na;
    m_b = nb;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[4 * n] = acc[4 * n] * c1a + xch[(4 + 4 * n) * kX] * c2a;
      acc[4 * n + 1] = acc[4 * n + 1] * c1a + xch[(5 + 4 * n) * kX] * c2a;
      acc[4 * n + 2] = acc[4 * n + 2] * c1b + xch[(6 + 4 * n) * kX] * c2b;
      acc[4 * n + 3] = acc[4 * n + 3] * c1b + xch[(7 + 4 * n) * kX] * c2b;
    }
  }

  // ---- epilogue: normalise, write (B, Sq, H, D) and the natural-log lse
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
  const int rb = ra + 8;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = h * D + 8 * n + 2 * t;
    if (ra < Sq)
      *reinterpret_cast<float2*>(
          o + (static_cast<long long>(b) * Sq + ra) * H * D + col) =
          make_float2(acc[4 * n] * inv_a, acc[4 * n + 1] * inv_a);
    if (rb < Sq)
      *reinterpret_cast<float2*>(
          o + (static_cast<long long>(b) * Sq + rb) * H * D + col) =
          make_float2(acc[4 * n + 2] * inv_b, acc[4 * n + 3] * inv_b);
  }
  if (lse != nullptr && t == 0) {   // m and l are in base 2
    constexpr float kLn2 = 0.6931471805599453f;
    float* lrow = lse + (static_cast<long long>(b) * H + h) * Sq;
    if (ra < Sq) lrow[ra] = (m_a + log2f(fmaxf(l_a, 1e-30f))) * kLn2;
    if (rb < Sq) lrow[rb] = (m_b + log2f(fmaxf(l_b, 1e-30f))) * kLn2;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* lse, int B,
               int Sq, int Skv, int H, int KVH, int causal, int window,
               int valid_len, float logit_cap, float scale,
               cudaStream_t stream) {
  using L = F32Fwd<D>;
  auto kern = flash_fwd_f32_kernel<D>;
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
  kern<<<grid, kF32Threads, L::BYTES, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), Sq, Skv, H, KVH, causal, window, valid_len,
      logit_cap, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Backward: the delta rows and the partials' sum (both dtypes); dQ, dK,
// dV of the f32 path on the tensor cores (three TF32 products each)
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 256;

__device__ __forceinline__ float ld_f(const float* p) { return *p; }
__device__ __forceinline__ float ld_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void st_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Whether the masks leave the pair (qpos, kpos) of a backward call.
__device__ __forceinline__ bool bwd_pair_ok(int qpos, int kpos, int Sq,
                                            int Skv, int causal, int window) {
  bool ok = qpos < Sq && kpos < Skv;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && qpos - kpos < window;
  return ok;
}

// P and dS of one (query, key) pair from its raw score s = q.k and dp =
// dO.v: p = exp(cap(s * scale) - lse) where the masks leave the pair (ok),
// else 0, into s; dS = p (dp - delta) times the soft cap's derivative
// 1 - tanh^2(s * scale / cap), into dp.  cap_scale = scale / cap.
__device__ __forceinline__ void bwd_score(float& s, float& dp, bool ok,
                                          float lse, float delta,
                                          float logit_cap, float cap_scale,
                                          float scale) {
  float x = s * scale, dcap = 1.f;
  if (logit_cap > 0.f) {
    const float th = tanhf(s * cap_scale);
    x = logit_cap * th;
    dcap = 1.f - th * th;
  }
  const float p = ok ? expf(x - lse) : 0.f;
  s = p;
  dp = p * (dp - delta) * dcap;
}

// delta = rowsum(dO * O), (B, H, Sq) f32: one warp a (b, i, h) row.
template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ delta, long long rows, int Sq, int H) {
  const long long row = static_cast<long long>(blockIdx.x) *
                            (kBwdThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float s = 0.f;
  for (int c = lane; c < D; c += 32)
    s = fmaf(ld_f(dout + row * D + c), ld_f(o + row * D + c), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const long long b = row / (static_cast<long long>(Sq) * H);
    const long long rem = row % (static_cast<long long>(Sq) * H);
    delta[(b * H + rem % H) * Sq + rem / H] = s;
  }
}

// A block's share of a reduction list of `items` entries cut into
// `nsplit` contiguous runs: [lo, hi).
__device__ __forceinline__ void split_range(int items, int nsplit, int split,
                                            int& lo, int& hi) {
  lo = static_cast<int>(static_cast<long long>(items) * split / nsplit);
  hi = static_cast<int>(static_cast<long long>(items) * (split + 1) / nsplit);
}

// Tiles of the f32 backward: BQ query rows by BK key rows (32 x 32 at
// D = 256, 64 x 64 below), rows D + 4 floats apart.  Each 16-row band of
// the resident tile has two warps, one for each half of a streamed tile's
// rows; their partial sums meet at the end over the stages.  A block
// accumulates DC of the D columns of dK and dV (or dQ): its tile is
// blockIdx.x / NC, its columns blockIdx.x % NC.  A warp's accumulators
// and scores then take at most 160 registers a thread (D = 256).
template <int D>
struct F32Bwd {
  static constexpr int BQ = D >= 256 ? 32 : 64;
  static constexpr int BK = BQ;
  static constexpr int DC = D == 128 ? 64 : D == 256 ? 128 : D;
  static constexpr int NC = D / DC;
  static constexpr int LD = D + 4;
  static constexpr int BANDS = BQ / 16;
  static constexpr int THREADS = 64 * BANDS;
  // two blocks an SM where shared memory allows (D <= 64)
  static constexpr int MIN_BLOCKS = D <= 64 ? 2 : 1;
  // dK/dV pass: K and V, then two stages of (Q, dO, lse, delta)
  static constexpr int KV_STAGE = 2 * BQ * LD + 2 * BQ;
  static constexpr int KV_BYTES = (2 * BK * LD + 2 * KV_STAGE) * 4;
  // dQ pass: Q, dO, lse and delta, then two stages of (K, V)
  static constexpr int Q_STAGE = 2 * BK * LD;
  static constexpr int Q_BYTES = (2 * BQ * LD + 2 * BQ + 2 * Q_STAGE) * 4;
  static_assert(DC * THREADS / 2 <= 2 * KV_STAGE &&
                    DC * THREADS / 4 <= 2 * Q_STAGE,
                "the halves' exchange fits over the stages");
};

// dK and dV (columns [c0, c0 + DC)) of one kv tile of one kv head, f32.
// K and V stay in shared memory; cp.async double-buffers (Q, dO, lse,
// delta) over the tile's reduction list: the G query heads of the group
// times the q tiles its masks leave (heads outer).  A block takes run
// `split` of it (blockIdx.z = b * nsplit + split), so the group's sum
// stays in the block when nsplit = 1.  Warps w and w + BANDS own the same
// 16 keys, w the first half of each q tile's queries and w + BANDS the
// second: S^T = K Q^T and dP^T = V dO^T, P^T and dS^T in registers, then
// dV += P^T dO and dK += dS^T Q with P^T and dS^T as A fragments straight
// from the accumulators (the transposes are index changes in the fragment
// loads), all three-TF32-product mma.sync; the second half's sums are
// added to the first's at the end, in that order.  With nsplit > 1 each
// block writes its f32 partial sums to `part` ([nsplit][B][Skv][KVH][D]
// for dK, then as much for dV) and `flash_bwd_sum` adds the runs in
// order.
template <int D>
__global__ void __launch_bounds__(F32Bwd<D>::THREADS, F32Bwd<D>::MIN_BLOCKS)
flash_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, float* __restrict__ part, int Sq,
                   int Skv, int H, int KVH, int causal, int window,
                   float logit_cap, float scale, int nsplit) {
  using L = F32Bwd<D>;
  constexpr int BQ = L::BQ, BK = L::BK, LD = L::LD, DC = L::DC;
  constexpr int NT = L::THREADS, BANDS = L::BANDS;
  constexpr int QH = BQ / 2;    // queries of a q tile a warp takes
  constexpr int KS = D / 8;     // k-steps of S^T and dP^T
  constexpr int NQ = QH / 8;    // their n-tiles, the k-steps of dV and dK
  constexpr int CT = DC / 8;    // n-tiles of dV and dK
  extern __shared__ __align__(16) float fsm[];
  const float* sK = fsm;
  const float* sV = fsm + BK * LD;
  float* stages = fsm + 2 * BK * LD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int band = warp % BANDS, half = warp / BANDS;
  const int k0 = blockIdx.x / L::NC * BK, c0 = blockIdx.x % L::NC * DC;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z / nsplit, split = blockIdx.z % nsplit;
  const int G = H / KVH;
  const float cap_scale = logit_cap > 0.f ? scale / logit_cap : 0.f;
  // query rows that see a key of this tile: causal, q >= k0; a window,
  // q - (k0 + BK - 1) < window
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? static_cast<int>(min(
      static_cast<long long>(Sq),
      static_cast<long long>(k0) + BK - 1 + window)) : Sq;
  const int qt0 = q_lo / BQ * BQ;
  const int n_qt = q_hi > qt0 ? (q_hi - qt0 + BQ - 1) / BQ : 0;
  int it_lo, it_hi;
  split_range(G * n_qt, nsplit, split, it_lo, it_hi);
  auto load = [&](int it, int st) {   // Q, dO, lse, delta of item it
    const int h = kvh * G + it / n_qt, i0 = qt0 + (it % n_qt) * BQ;
    float* sq = stages + st * L::KV_STAGE;
    stage_rows<D, BQ, NT>(sq, q, b, i0, Sq, H, h);
    stage_rows<D, BQ, NT>(sq + BQ * LD, dout, b, i0, Sq, H, h);
    stage_lse<BQ, NT>(sq + 2 * BQ * LD, lse, delta, b, h, H, i0, Sq);
  };
  stage_rows<D, BK, NT>(fsm, k, b, k0, Skv, KVH, kvh);
  stage_rows<D, BK, NT>(fsm + BK * LD, v, b, k0, Skv, KVH, kvh);
  if (it_lo < it_hi) load(it_lo, 0);
  cp_commit();

  const int kw = k0 + 16 * band;   // the warp's keys kw .. kw + 15
  float acc_k[CT * 4], acc_v[CT * 4];
#pragma unroll
  for (int e = 0; e < CT * 4; ++e) acc_k[e] = acc_v[e] = 0.f;
  for (int it = it_lo; it < it_hi; ++it) {
    const int st = (it - it_lo) & 1;
    if (it + 1 < it_hi) load(it + 1, st ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    // this warp's queries iw .. iw + QH - 1 of the item's q tile
    const int iw = qt0 + (it % n_qt) * BQ + half * QH;
    const float* sq = stages + st * L::KV_STAGE + half * QH * LD;
    const float* sdo = sq + BQ * LD;
    const float* sl = stages + st * L::KV_STAGE + 2 * BQ * LD + half * QH;
    bool live = kw < Skv && iw < Sq;   // a key of the warp sees a query
    if (causal) live = live && kw <= iw + QH - 1;
    if (window > 0) live = live && iw - (kw + 15) < window;
    if (live) {
      float s[NQ * 4], dp[NQ * 4];
#pragma unroll
      for (int e = 0; e < NQ * 4; ++e) s[e] = dp[e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const TfA kf = frag_a(sK, LD, 16 * band, 8 * kk, g, t);
#pragma unroll
        for (int n = 0; n < NQ; ++n)
          mma3(s + 4 * n, kf, frag_bt(sq, LD, 8 * n, 8 * kk, g, t));
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const TfA vf = frag_a(sV, LD, 16 * band, 8 * kk, g, t);
#pragma unroll
        for (int n = 0; n < NQ; ++n)
          mma3(dp + 4 * n, vf, frag_bt(sdo, LD, 8 * n, 8 * kk, g, t));
      }
      // P^T and dS^T: rows the keys kw + g and kw + g + 8, columns the
      // queries iw + 8n + 2t and iw + 8n + 2t + 1
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const int col = 8 * n + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(sl + col);
        const float2 d2 = *reinterpret_cast<const float2*>(sl + BQ + col);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool ok = bwd_pair_ok(iw + col + (u & 1),
                                      kw + g + ((u & 2) ? 8 : 0), Sq, Skv,
                                      causal, window);
          bwd_score(s[4 * n + u], dp[4 * n + u], ok, (u & 1) ? l2.y : l2.x,
                    (u & 1) ? d2.y : d2.x, logit_cap, cap_scale, scale);
        }
      }
      // dV += P^T dO and dK += dS^T Q: the sum runs over the warp's
      // queries
#pragma unroll
      for (int kk = 0; kk < NQ; ++kk) {
        const TfA pf = frag_acc(s + 4 * kk);
        const TfA df = frag_acc(dp + 4 * kk);
#pragma unroll
        for (int n = 0; n < CT; ++n) {
          mma3(acc_v + 4 * n, pf, frag_bp(sdo, LD, 8 * kk, c0 + 8 * n, g, t));
          mma3(acc_k + 4 * n, df, frag_bp(sq, LD, 8 * kk, c0 + 8 * n, g, t));
        }
      }
    }
    __syncthreads();   // the stage is refilled at item it + 2
  }
  cp_wait<0>();
  // the second half's sums to the first (element i of a thread at
  // xch[i * NT / 2]), then added in that order
  float* xch = stages + band * 32 + lane;
  constexpr int kX = NT / 2;
  if (half == 1) {
#pragma unroll
    for (int e = 0; e < CT * 4; ++e) {
      xch[e * kX] = acc_k[e];
      xch[(CT * 4 + e) * kX] = acc_v[e];
    }
  }
  __syncthreads();
  if (half == 1) return;
#pragma unroll
  for (int e = 0; e < CT * 4; ++e) {
    acc_k[e] += xch[e * kX];
    acc_v[e] += xch[(CT * 4 + e) * kX];
  }
  const long long plane = static_cast<long long>(gridDim.z / nsplit) * Skv *
                          KVH * D;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int kr = kw + g + 8 * hr;
    if (kr >= Skv) continue;
    const long long at =
        ((static_cast<long long>(b) * Skv + kr) * KVH + kvh) * D + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < CT; ++n) {
      const float* ak = acc_k + 4 * n + 2 * hr;
      const float* av = acc_v + 4 * n + 2 * hr;
      const long long e = at + 8 * n;
      if (nsplit == 1) {
        *reinterpret_cast<float2*>(dk + e) =
            make_float2(ak[0] * scale, ak[1] * scale);
        *reinterpret_cast<float2*>(dv + e) = make_float2(av[0], av[1]);
      } else {
        *reinterpret_cast<float2*>(part + split * plane + e) =
            make_float2(ak[0], ak[1]);
        *reinterpret_cast<float2*>(part + (nsplit + split) * plane + e) =
            make_float2(av[0], av[1]);
      }
    }
  }
}

// dQ (columns [c0, c0 + DC)) of one q tile of one head, f32.  Q, dO and
// the rows' lse and delta stay in shared memory; cp.async double-buffers
// K and V over the kv tiles the masks leave, in order.  Warps w and
// w + BANDS own the same 16 queries, w the first half of each kv tile's
// keys and w + BANDS the second: S = Q K^T and dP = dO V^T, dS in
// registers, dQ += dS K with dS as the A fragment, all
// three-TF32-product mma.sync; the second half's sum is added to the
// first's at the end.  A block takes run `split` of the list (blockIdx.z
// = b * nsplit + split), and with nsplit > 1 writes its f32 partial to
// `part` ([nsplit][B][Sq][H][D]) for `flash_bwd_sum`.
template <int D>
__global__ void __launch_bounds__(F32Bwd<D>::THREADS, F32Bwd<D>::MIN_BLOCKS)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 float* __restrict__ part, int Sq, int Skv, int H, int KVH,
                 int causal, int window, float logit_cap, float scale,
                 int nsplit) {
  using L = F32Bwd<D>;
  constexpr int BQ = L::BQ, BK = L::BK, LD = L::LD, DC = L::DC;
  constexpr int NT = L::THREADS, BANDS = L::BANDS;
  constexpr int KH = BK / 2;    // keys of a kv tile a warp takes
  constexpr int KS = D / 8;     // k-steps of S and dP
  constexpr int NK = KH / 8;    // their n-tiles, the k-steps of dQ
  constexpr int CT = DC / 8;    // n-tiles of dQ
  extern __shared__ __align__(16) float fsm[];
  const float* sQ = fsm;
  const float* sdO = fsm + BQ * LD;
  const float* sL = fsm + 2 * BQ * LD;   // lse, then delta
  float* stages = fsm + 2 * BQ * LD + 2 * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int band = warp % BANDS, half = warp / BANDS;
  const int i0 = blockIdx.x / L::NC * BQ, c0 = blockIdx.x % L::NC * DC;
  const int h = blockIdx.y;
  const int b = blockIdx.z / nsplit, split = blockIdx.z % nsplit;
  const int kvh = h / (H / KVH);
  const float cap_scale = logit_cap > 0.f ? scale / logit_cap : 0.f;
  // keys that a row of this tile sees: a window, k > i0 - window;
  // causal, k <= i0 + BQ - 1
  const int k_lo = window > 0 ? max(0, i0 - window + 1) : 0;
  const int k_hi = causal ? min(Skv, i0 + BQ) : Skv;
  const int kt0 = k_lo / BK * BK;
  const int n_kt = k_hi > kt0 ? (k_hi - kt0 + BK - 1) / BK : 0;
  int it_lo, it_hi;
  split_range(n_kt, nsplit, split, it_lo, it_hi);
  auto load = [&](int it, int st) {   // K and V of tile it
    const int k0 = kt0 + it * BK;
    float* sk = stages + st * L::Q_STAGE;
    stage_rows<D, BK, NT>(sk, k, b, k0, Skv, KVH, kvh);
    stage_rows<D, BK, NT>(sk + BK * LD, v, b, k0, Skv, KVH, kvh);
  };
  stage_rows<D, BQ, NT>(fsm, q, b, i0, Sq, H, h);
  stage_rows<D, BQ, NT>(fsm + BQ * LD, dout, b, i0, Sq, H, h);
  stage_lse<BQ, NT>(fsm + 2 * BQ * LD, lse, delta, b, h, H, i0, Sq);
  if (it_lo < it_hi) load(it_lo, 0);
  cp_commit();

  const int qw = i0 + 16 * band;   // the warp's rows qw .. qw + 15
  const int qa = qw + g;           // this thread's rows qa and qa + 8
  float acc[CT * 4];
#pragma unroll
  for (int e = 0; e < CT * 4; ++e) acc[e] = 0.f;
  for (int it = it_lo; it < it_hi; ++it) {
    const int st = (it - it_lo) & 1;
    if (it + 1 < it_hi) load(it + 1, st ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    // this warp's keys kw .. kw + KH - 1 of the tile
    const int kw = kt0 + it * BK + half * KH;
    const float* sk = stages + st * L::Q_STAGE + half * KH * LD;
    const float* sv = sk + BK * LD;
    bool live = qw < Sq && kw < Skv;   // a row of the warp sees a key
    if (causal) live = live && kw <= qw + 15;
    if (window > 0) live = live && qw - (kw + KH - 1) < window;
    if (live) {
      float s[NK * 4], dp[NK * 4];
#pragma unroll
      for (int e = 0; e < NK * 4; ++e) s[e] = dp[e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const TfA qf = frag_a(sQ, LD, 16 * band, 8 * kk, g, t);
#pragma unroll
        for (int n = 0; n < NK; ++n)
          mma3(s + 4 * n, qf, frag_bt(sk, LD, 8 * n, 8 * kk, g, t));
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const TfA of = frag_a(sdO, LD, 16 * band, 8 * kk, g, t);
#pragma unroll
        for (int n = 0; n < NK; ++n)
          mma3(dp + 4 * n, of, frag_bt(sv, LD, 8 * n, 8 * kk, g, t));
      }
      // P and dS: rows the queries qa and qa + 8, columns the keys
      // kw + 8n + 2t and kw + 8n + 2t + 1
      const int ra = 16 * band + g;
      const float lse_a = sL[ra], lse_b = sL[ra + 8];
      const float del_a = sL[BQ + ra], del_b = sL[BQ + ra + 8];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool lower = (u & 2) != 0;
          const bool ok = bwd_pair_ok(qa + (lower ? 8 : 0),
                                      kw + 8 * n + 2 * t + (u & 1), Sq, Skv,
                                      causal, window);
          bwd_score(s[4 * n + u], dp[4 * n + u], ok, lower ? lse_b : lse_a,
                    lower ? del_b : del_a, logit_cap, cap_scale, scale);
        }
      // dQ += dS K: the sum runs over the warp's keys
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const TfA df = frag_acc(dp + 4 * kk);
#pragma unroll
        for (int n = 0; n < CT; ++n)
          mma3(acc + 4 * n, df, frag_bp(sk, LD, 8 * kk, c0 + 8 * n, g, t));
      }
    }
    __syncthreads();   // the stage is refilled at tile it + 2
  }
  cp_wait<0>();
  // the second half's sum to the first, then added in that order
  float* xch = stages + band * 32 + lane;
  constexpr int kX = NT / 2;
  if (half == 1) {
#pragma unroll
    for (int e = 0; e < CT * 4; ++e) xch[e * kX] = acc[e];
  }
  __syncthreads();
  if (half == 1) return;
#pragma unroll
  for (int e = 0; e < CT * 4; ++e) acc[e] += xch[e * kX];
  const long long plane = static_cast<long long>(gridDim.z / nsplit) * Sq *
                          H * D;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qr = qa + 8 * hr;
    if (qr >= Sq) continue;
    const long long at =
        ((static_cast<long long>(b) * Sq + qr) * H + h) * D + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < CT; ++n) {
      const float* a = acc + 4 * n + 2 * hr;
      const long long e = at + 8 * n;
      if (nsplit == 1)
        *reinterpret_cast<float2*>(dq + e) =
            make_float2(a[0] * scale, a[1] * scale);
      else
        *reinterpret_cast<float2*>(part + split * plane + e) =
            make_float2(a[0], a[1]);
    }
  }
}

// out[e] = (sum over the runs s, in order, of part[s][e]) * scale, for
// `n` elements of each of `outs` outputs whose partials follow one
// another in `part`.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_sum(const float* __restrict__ part, T* __restrict__ out0,
              T* __restrict__ out1, long long n, int nsplit, float scale0,
              float scale1) {
  const long long e = static_cast<long long>(blockIdx.x) * kBwdThreads +
                      threadIdx.x;
  if (e >= n) return;
  const int which = blockIdx.y;
  const float* p = part + which * nsplit * n + e;
  float acc = 0.f;
  for (int sp = 0; sp < nsplit; ++sp) acc += p[sp * n];
  if (which == 0)
    st_f(out0 + e, acc * scale0);
  else
    st_f(out1 + e, acc * scale1);
}
// ---------------------------------------------------------------------------
// Backward, bf16 path: wgmma + TMA, warp-specialised
// ---------------------------------------------------------------------------

constexpr int kWG = 128;                      // threads of a warpgroup
constexpr int kQThreads = kWG + 32;           // the dQ group + producer
constexpr int kBarExchange = 1;               // named barriers of the dK/dV
constexpr int kBarFree = 2;                   // pass's P exchange

// Shared memory of the two bf16 passes: 64-row tiles of D columns in
// 64-column panels (one TMA box each, 128-byte swizzle).
template <int D>
struct BwdSmem {
  static constexpr int kPanels = D / 64;
  static constexpr int kTile = kPanels * kPanelBytes;
  // dK/dV pass: K and V resident, a ring of (Q, dO, lse, delta), and the
  // P exchange (32 f32 a thread of a warpgroup)
  static constexpr int kKvStages = D == 256 ? 2 : 3;
  static constexpr int KV_K = 0;
  static constexpr int KV_V = KV_K + kTile;
  static constexpr int KV_Q = KV_V + kTile;
  static constexpr int KV_DO = KV_Q + kKvStages * kTile;
  static constexpr int KV_X = KV_DO + kKvStages * kTile;
  static constexpr int KV_ROWS = KV_X + 32 * kWG * 4;   // [st][lse, delta]
  static constexpr int KV_BAR = KV_ROWS + kKvStages * 2 * kBQ * 4;
  // full[st], empty[st], kv
  static constexpr int KV_ALLOC = KV_BAR + (2 * kKvStages + 1) * 8 + 1024;
  // dQ pass: Q and dO resident, a ring of (K, V)
  static constexpr int kQStages = D == 64 ? 3 : 2;
  static constexpr int Q_Q = 0;
  static constexpr int Q_DO = kTile;
  static constexpr int Q_K = 2 * kTile;
  static constexpr int Q_V = Q_K + kQStages * kTile;
  static constexpr int Q_BAR = Q_V + kQStages * kTile;
  // full[st], empty[st], q
  static constexpr int Q_ALLOC = Q_BAR + (2 * kQStages + 1) * 8 + 1024;
  // dV and dK groups + a producer warp; at D=256 a whole producer
  // warpgroup, which hands its registers to the other two (setmaxnreg)
  static constexpr bool kRebalance = D == 256;
  static constexpr int kKvThreads = kRebalance ? 3 * kWG : 2 * kWG + 32;
  // blocks an SM should hold (launch bounds): registers cap them
  static constexpr int kKvMinBlocks = D == 64 ? 2 : 1;
  static constexpr int kQMinBlocks = D == 256 ? 1 : D == 128 ? 2 : 3;
};

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Whether any (q, k) pair of a 64 x 64 tile pair is masked: rows past Sq
// or Skv, the causal diagonal, the window edge.
__device__ __forceinline__ bool bwd_tile_cut(int i0, int k0, int Sq, int Skv,
                                             int causal, int window) {
  return i0 + kBQ > Sq || k0 + kBK > Skv || (causal && k0 + kBK - 1 > i0) ||
         (window > 0 && i0 + kBQ - 1 - k0 >= window);
}

// The scaled (soft-capped) base-2 logit of a raw score.
struct BwdLogit {
  float scale_log2, cap, cap_scale;   // cap_scale = scale / cap
};

// The masks of a backward call.
struct BwdMask {
  int Sq, Skv, causal, window;
};

// 2^x in one MUFU instruction (2 ulp; subnormal results flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// p = exp(logit - lse) of a raw score s, lse2 the row's lse in base 2;
// dc = the soft cap's derivative 1 - tanh^2 (1 without a cap).  The cap
// is a template argument, so a call without one computes no tanh.
template <bool kCap>
__device__ __forceinline__ float bwd_prob(float s, float lse2,
                                          const BwdLogit& lg, float& dc) {
  if constexpr (kCap) {
    const float t = tanhf(s * lg.cap_scale);
    dc = 1.f - t * t;
    return ex2(lg.cap * kLog2e * t - lse2);
  }
  dc = 1.f;
  return ex2(s * lg.scale_log2 - lse2);
}

// dK/dV pass, group 0: P^T of one tile from S^T in s (rows the keys ka
// and ka + 8, columns the queries i0 + col), and P^T dcap to `xrow`
// (this thread's float4 column of the exchange, [8][kWG] float4).  lse2
// holds the tile's rows.  Elements 4i..4i+3 are columns 8i + 2c and
// 8i + 2c + 1 of both rows.
template <bool kMask, bool kCap>
__device__ __forceinline__ void bwd_probs_t(float (&s)[32], float4* xrow,
                                            const float* lse2,
                                            const BwdLogit& lg,
                                            const BwdMask& mk, int i0,
                                            int ka, int c) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = 8 * i + 2 * c;
    const float2 l2 = *reinterpret_cast<const float2*>(lse2 + col);
    float pd[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = 4 * i + u;
      float dc;
      float p = bwd_prob<kCap>(s[e], (u & 1) ? l2.y : l2.x, lg, dc);
      if constexpr (kMask) {
        if (!bwd_pair_ok(i0 + col + (u & 1), ka + ((u & 2) ? 8 : 0), mk.Sq,
                         mk.Skv, mk.causal, mk.window))
          p = 0.f;
      }
      s[e] = p;
      pd[u] = p * dc;
    }
    xrow[i * kWG] = make_float4(pd[0], pd[1], pd[2], pd[3]);
  }
}

// dQ pass: dS = P dcap (dP - delta) of one tile in s, from S in s and dP
// (rows the queries qa and qa + 8, columns the keys k0 + col).
template <bool kMask, bool kCap>
__device__ __forceinline__ void bwd_grads_q(float (&s)[32],
                                            const float (&dp)[32],
                                            const BwdLogit& lg,
                                            const BwdMask& mk, float lse_a,
                                            float lse_b, float del_a,
                                            float del_b, int qa, int k0,
                                            int c) {
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const bool lower = (e & 2) != 0;
    float dc;
    float p = bwd_prob<kCap>(s[e], lower ? lse_b : lse_a, lg, dc);
    if constexpr (kMask) {
      if (!bwd_pair_ok(qa + (lower ? 8 : 0),
                       k0 + 8 * (e >> 2) + 2 * c + (e & 1), mk.Sq, mk.Skv,
                       mk.causal, mk.window))
        p = 0.f;
    }
    s[e] = p * dc * (dp[e] - (lower ? del_b : del_a));
  }
}

// The dV and dK group's product wait: the group's stage is read, its
// accumulators are settled.
template <int D>
__device__ __forceinline__ void settle(float (&acc)[D / 64][32]) {
  wg_wait<0>();
#pragma unroll
  for (int p = 0; p < D / 64; ++p)
#pragma unroll
    for (int e = 0; e < 32; ++e) reg_fence(acc[p][e]);
}

// dK and dV of one 64-row kv tile of one kv head, bf16.  Its reduction
// list is the G query heads of the group times the q tiles its masks
// leave (heads outer); a block takes run `split` of it (blockIdx.z =
// b * nsplit + split).  Warpgroup 0 owns dV: S^T = K Q^T, P^T =
// exp(S^T - lse) in f32 registers, dV += P^T dO with P^T as the
// register A operand.  Warpgroup 1 owns dK: dP^T = V dO^T, dS^T = P^T
// (dP^T - delta) dcap, dK += dS^T Q.  P^T dcap crosses from group 0 to
// group 1 through shared memory, thread to thread in the accumulator
// layout, behind two named barriers.  With nsplit > 1 the f32 partials
// go to `part` ([nsplit][B][Skv][KVH][D] for dK, then as much for dV).
template <int D>
__global__ void __launch_bounds__(BwdSmem<D>::kKvThreads,
                                  BwdSmem<D>::kKvMinBlocks)
flash_bwd_dkdv_sm90(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, float* __restrict__ part,
                    int Sq, int Skv, int H, int KVH, int causal, int window,
                    float logit_cap, float scale, int nsplit) {
  using L = BwdSmem<D>;
  constexpr int kPanels = L::kPanels, kStages = L::kKvStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // 128-byte swizzle atoms
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t bars = base + L::KV_BAR;         // full, empty, kv
  const uint32_t kv_bar = bars + 8u * (2 * kStages);
  float* xbuf = reinterpret_cast<float*>(gbase + L::KV_X);
  float* rows = reinterpret_cast<float*>(gbase + L::KV_ROWS);

  const int k0 = blockIdx.x * kBK, kvh = blockIdx.y;
  const int b = blockIdx.z / nsplit, split = blockIdx.z % nsplit;
  const int G = H / KVH;
  // query rows that see a key of this tile: causal, q >= k0; a window,
  // q - (k0 + 63) < window
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? static_cast<int>(min(
      static_cast<long long>(Sq),
      static_cast<long long>(k0) + kBK - 1 + window)) : Sq;
  const int qt0 = q_lo / kBQ * kBQ;
  const int n_qt = q_hi > qt0 ? (q_hi - qt0 + kBQ - 1) / kBQ : 0;
  int it_lo, it_hi;
  split_range(G * n_qt, nsplit, split, it_lo, it_hi);
  const int n_items = it_hi - it_lo;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bars + 8u * st, 32);                  // the producer warp
      mbar_init(bars + 8u * (kStages + st), 2 * kWG);
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 2 * kWG / 32) {
    // ---------------- producer warp ----------------
    // one block an SM at D=256 (its shared memory): 128 x 40 + 256 x 232
    // registers fit the SM's 65,536
    if constexpr (L::kRebalance)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (warp == 2 * kWG / 32 && n_items > 0) {
      if (lane == 0) {
        mbar_expect_tx(kv_bar, 2 * L::kTile);
        for (int p = 0; p < kPanels; ++p) {
          tma_load(base + L::KV_K + p * kPanelBytes, &tm_k, kv_bar,
                   kvh * D + 64 * p, k0, b);
          tma_load(base + L::KV_V + p * kPanelBytes, &tm_v, kv_bar,
                   kvh * D + 64 * p, k0, b);
        }
      }
      for (int j = 0; j < n_items; ++j) {
        const int it = it_lo + j, st = j % kStages;
        const int h = kvh * G + it / n_qt, i0 = qt0 + (it % n_qt) * kBQ;
        const uint32_t filled = bars + 8u * st;
        mbar_wait(bars + 8u * (kStages + st), ((j / kStages) & 1) ^ 1);
        // lse (in base 2) and delta of the tile's 64 rows, 0 past Sq
        float* r = rows + st * 2 * kBQ;
        const long long at = (static_cast<long long>(b) * H + h) * Sq;
        for (int x = lane; x < kBQ; x += 32) {
          const bool in = i0 + x < Sq;
          r[x] = in ? lse[at + i0 + x] * kLog2e : 0.f;
          r[kBQ + x] = in ? delta[at + i0 + x] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(filled, 2 * L::kTile);
          const uint32_t sQ = base + L::KV_Q + st * L::kTile;
          const uint32_t sdO = base + L::KV_DO + st * L::kTile;
          for (int p = 0; p < kPanels; ++p) {
            tma_load(sQ + p * kPanelBytes, &tm_q, filled, h * D + 64 * p, i0,
                     b);
            tma_load(sdO + p * kPanelBytes, &tm_do, filled, h * D + 64 * p,
                     i0, b);
          }
        } else {
          mbar_arrive(filled);
        }
      }
    }
  } else {
    // ---------------- consumer warpgroups: 0 dV, 1 dK ----------------
    if constexpr (L::kRebalance)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    const int wg = warp / 4, tid = threadIdx.x % kWG;
    const int g = lane / 4, c = lane % 4;
    const int ra = (warp % 4) * 16 + g;   // kv rows ra and ra + 8
    const bool capped = logit_cap > 0.f;
    const BwdLogit lg{scale * kLog2e, logit_cap,
                      capped ? scale / logit_cap : 0.f};
    const BwdMask mk{Sq, Skv, causal, window};
    const uint32_t sMine = base + (wg == 0 ? L::KV_K : L::KV_V);

    float acc[kPanels][32];
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[p][e] = 0.f;
    float s[32];
    uint32_t fa[4][4];

    if (n_items > 0) mbar_wait(kv_bar, 0);
    for (int j = 0; j < n_items; ++j) {
      const int it = it_lo + j, st = j % kStages;
      const int i0 = qt0 + (it % n_qt) * kBQ;
      const uint32_t sQ = base + L::KV_Q + st * L::kTile;
      const uint32_t sdO = base + L::KV_DO + st * L::kTile;
      const float* r = rows + st * 2 * kBQ;
      mbar_wait(bars + 8u * st, (j / kStages) & 1);
      // S^T = K Q^T (group 0) or dP^T = V dO^T (group 1): rows are keys,
      // columns the tile's queries
      issue_qk<D>(s, sMine, wg == 0 ? sQ : sdO);
      wg_wait<0>();
#pragma unroll
      for (int e = 0; e < 32; ++e) reg_fence(s[e]);
      const bool cut = bwd_tile_cut(i0, k0, Sq, Skv, causal, window);
      if (wg == 0) {
        // P^T in s; P^T dcap to group 1
        if (j > 0) named_sync(kBarFree, 2 * kWG);   // group 1 read the last
        float4* xrow = reinterpret_cast<float4*>(xbuf) + tid;
        if (cut && capped)
          bwd_probs_t<true, true>(s, xrow, r, lg, mk, i0, k0 + ra, c);
        else if (cut)
          bwd_probs_t<true, false>(s, xrow, r, lg, mk, i0, k0 + ra, c);
        else if (capped)
          bwd_probs_t<false, true>(s, xrow, r, lg, mk, i0, k0 + ra, c);
        else
          bwd_probs_t<false, false>(s, xrow, r, lg, mk, i0, k0 + ra, c);
        named_arrive(kBarExchange, 2 * kWG);
      } else {
        // dS^T = P^T dcap (dP^T - delta) in s
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float2 d2 =
              *reinterpret_cast<const float2*>(r + kBQ + 8 * i + 2 * c);
#pragma unroll
          for (int u = 0; u < 4; ++u) s[4 * i + u] -= (u & 1) ? d2.y : d2.x;
        }
        named_sync(kBarExchange, 2 * kWG);
        const float4* xrow = reinterpret_cast<const float4*>(xbuf) + tid;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 x4 = xrow[i * kWG];
          s[4 * i] *= x4.x;
          s[4 * i + 1] *= x4.y;
          s[4 * i + 2] *= x4.z;
          s[4 * i + 3] *= x4.w;
        }
        if (j + 1 < n_items) named_arrive(kBarFree, 2 * kWG);
      }
      // dV += P^T dO (group 0), dK += dS^T Q (group 1); P and dS rounded
      // to bf16 as the register A operand
      pack_p(fa, s);
      issue_pv<D>(acc, fa, wg == 0 ? sdO : sQ);
      settle<D>(acc);
      mbar_arrive(bars + 8u * (kStages + st));   // the stage may be refilled
    }

    // ---- epilogue: dV (group 0) or dK * scale (group 1)
    const float mult = wg == 0 ? 1.f : scale;
    __nv_bfloat16* out = wg == 0 ? dv : dk;
    const long long plane = static_cast<long long>(gridDim.z / nsplit) * Skv *
                            KVH * D;
    float* mine = nsplit == 1 ? nullptr
        : part + static_cast<long long>(wg == 0 ? nsplit + split : split) *
                     plane;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kr = k0 + ra + 8 * half;
      if (kr >= Skv) continue;
      const long long at =
          ((static_cast<long long>(b) * Skv + kr) * KVH + kvh) * D;
#pragma unroll
      for (int p = 0; p < kPanels; ++p)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int col = 64 * p + 8 * i + 2 * c;
          const float lo = acc[p][4 * i + 2 * half];
          const float hi = acc[p][4 * i + 2 * half + 1];
          if (nsplit == 1)
            *reinterpret_cast<uint32_t*>(out + at + col) =
                pack_bf16(lo * mult, hi * mult);
          else
            *reinterpret_cast<float2*>(mine + at + col) = make_float2(lo, hi);
        }
    }
  }
}

// dQ of one 64-row q tile of one head, bf16.  Q, dO and the rows' lse and
// delta stay resident; the kv tiles the masks leave stream through a
// ring.  Per tile: S = Q K^T and dP = dO V^T (two wgmma groups), dS = P
// (dP - delta) dcap in f32 registers, dQ += dS K with dS as the register
// A operand.  A block takes run `split` of the kv tiles and with nsplit
// > 1 writes its f32 partial to `part` ([nsplit][B][Sq][H][D]).
template <int D>
__global__ void __launch_bounds__(kQThreads, BwdSmem<D>::kQMinBlocks)
flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_do,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dq, float* __restrict__ part,
                  int Sq, int Skv, int H, int KVH, int causal, int window,
                  float logit_cap, float scale, int nsplit) {
  using L = BwdSmem<D>;
  constexpr int kPanels = L::kPanels, kStages = L::kQStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + L::Q_BAR;          // full, empty, q
  const uint32_t q_bar = bars + 8u * (2 * kStages);

  const int i0 = blockIdx.x * kBQ, h = blockIdx.y;
  const int b = blockIdx.z / nsplit, split = blockIdx.z % nsplit;
  const int kvh = h / (H / KVH);
  // keys that a row of this tile sees: a window, k > i0 - window;
  // causal, k <= i0 + 63
  const int k_lo = window > 0 ? max(0, i0 - window + 1) : 0;
  const int k_hi = causal ? min(Skv, i0 + kBQ) : Skv;
  const int kt0 = k_lo / kBK * kBK;
  const int n_kt = k_hi > kt0 ? (k_hi - kt0 + kBK - 1) / kBK : 0;
  int it_lo, it_hi;
  split_range(n_kt, nsplit, split, it_lo, it_hi);
  const int n_items = it_hi - it_lo;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bars + 8u * st, 1);
      mbar_init(bars + 8u * (kStages + st), kWG);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kWG / 32) {
    // ---------------- producer warp ----------------
    if (lane == 0 && n_items > 0) {
      mbar_expect_tx(q_bar, 2 * L::kTile);
      for (int p = 0; p < kPanels; ++p) {
        tma_load(base + L::Q_Q + p * kPanelBytes, &tm_q, q_bar,
                 h * D + 64 * p, i0, b);
        tma_load(base + L::Q_DO + p * kPanelBytes, &tm_do, q_bar,
                 h * D + 64 * p, i0, b);
      }
      for (int j = 0; j < n_items; ++j) {
        const int st = j % kStages;
        const int k0 = kt0 + (it_lo + j) * kBK;
        const uint32_t filled = bars + 8u * st;
        mbar_wait(bars + 8u * (kStages + st), ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(filled, 2 * L::kTile);
        for (int p = 0; p < kPanels; ++p) {
          tma_load(base + L::Q_K + st * L::kTile + p * kPanelBytes, &tm_k,
                   filled, kvh * D + 64 * p, k0, b);
          tma_load(base + L::Q_V + st * L::kTile + p * kPanelBytes, &tm_v,
                   filled, kvh * D + 64 * p, k0, b);
        }
      }
    }
  } else {
    // ---------------- consumer warpgroup ----------------
    const int g = lane / 4, c = lane % 4;
    const int ra = warp * 16 + g;   // q rows ra and ra + 8
    const bool capped = logit_cap > 0.f;
    const BwdLogit lg{scale * kLog2e, logit_cap,
                      capped ? scale / logit_cap : 0.f};
    const BwdMask mk{Sq, Skv, causal, window};
    const long long at = (static_cast<long long>(b) * H + h) * Sq + i0;
    const bool in_a = i0 + ra < Sq, in_b = i0 + ra + 8 < Sq;
    const float lse_a = in_a ? lse[at + ra] * kLog2e : 0.f;
    const float lse_b = in_b ? lse[at + ra + 8] * kLog2e : 0.f;
    const float del_a = in_a ? delta[at + ra] : 0.f;
    const float del_b = in_b ? delta[at + ra + 8] : 0.f;

    float acc[kPanels][32];
#pragma unroll
    for (int p = 0; p < kPanels; ++p)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[p][e] = 0.f;
    float s[32], dp[32];
    uint32_t fa[4][4];

    if (n_items > 0) mbar_wait(q_bar, 0);
    for (int j = 0; j < n_items; ++j) {
      const int st = j % kStages;
      const int k0 = kt0 + (it_lo + j) * kBK;
      const uint32_t sK = base + L::Q_K + st * L::kTile;
      mbar_wait(bars + 8u * st, (j / kStages) & 1);
      issue_qk<D>(s, base + L::Q_Q, sK);
      issue_qk<D>(dp, base + L::Q_DO, base + L::Q_V + st * L::kTile);
      wg_wait<0>();
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        reg_fence(s[e]);
        reg_fence(dp[e]);
      }
      // dS = P dcap (dP - delta) in s
      const bool cut = bwd_tile_cut(i0, k0, Sq, Skv, causal, window);
      const int qa = i0 + ra;
      if (cut && capped)
        bwd_grads_q<true, true>(s, dp, lg, mk, lse_a, lse_b, del_a, del_b,
                                qa, k0, c);
      else if (cut)
        bwd_grads_q<true, false>(s, dp, lg, mk, lse_a, lse_b, del_a, del_b,
                                 qa, k0, c);
      else if (capped)
        bwd_grads_q<false, true>(s, dp, lg, mk, lse_a, lse_b, del_a, del_b,
                                 qa, k0, c);
      else
        bwd_grads_q<false, false>(s, dp, lg, mk, lse_a, lse_b, del_a, del_b,
                                  qa, k0, c);
      pack_p(fa, s);
      issue_pv<D>(acc, fa, sK);   // dQ += dS K
      settle<D>(acc);
      mbar_arrive(bars + 8u * (kStages + st));
    }

    // ---- epilogue: dQ * scale, or the f32 partial
    const long long plane = static_cast<long long>(gridDim.z / nsplit) * Sq *
                            H * D;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int qr = i0 + ra + 8 * half;
      if (qr >= Sq) continue;
      const long long row = ((static_cast<long long>(b) * Sq + qr) * H + h) *
                            D;
#pragma unroll
      for (int p = 0; p < kPanels; ++p)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int col = 64 * p + 8 * i + 2 * c;
          const float lo = acc[p][4 * i + 2 * half];
          const float hi = acc[p][4 * i + 2 * half + 1];
          if (nsplit == 1)
            *reinterpret_cast<uint32_t*>(dq + row + col) =
                pack_bf16(lo * scale, hi * scale);
          else
            *reinterpret_cast<float2*>(part + split * plane + row + col) =
                make_float2(lo, hi);
        }
    }
  }
}

// How a backward call is cut: splits of the dK/dV and dQ reductions
// that bring each pass to about two blocks a SM (at most kMaxSplit), and
// the f32 scratch their partials take.  bq x bk are the pass's tiles:
// F32Bwd's on the f32 path, 64 x 64 on the bf16 path.
constexpr int kMaxSplit = 8;

struct BwdPlan {
  int split_kv, split_q;
  long long scratch;   // floats
};

BwdPlan bwd_plan(int bq, int bk, int B, int Sq, int Skv, int H, int KVH,
                 int D, int sms) {
  const long long want = 2LL * sms;
  const long long kv_tiles = (Skv + bk - 1) / bk;
  const long long q_tiles = (Sq + bq - 1) / bq;
  auto split = [&](long long blocks, long long items) {
    long long n = (want + blocks - 1) / blocks;
    n = n < kMaxSplit ? n : kMaxSplit;
    n = n < items ? n : items;
    return static_cast<int>(n < 1 ? 1 : n);
  };
  BwdPlan p;
  p.split_kv = split(kv_tiles * KVH * B, (H / KVH) * q_tiles);
  p.split_q = split(q_tiles * H * B, kv_tiles);
  const long long kv = p.split_kv > 1
      ? 2LL * p.split_kv * B * Skv * KVH * D : 0;
  const long long qq = p.split_q > 1 ? 1LL * p.split_q * B * Sq * H * D : 0;
  p.scratch = kv > qq ? kv : qq;
  return p;
}

template <typename Kern>
int opt_in(Kern kern, int bytes, std::atomic<bool>* ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev].store(true, std::memory_order_relaxed);
  }
  return 0;
}

// delta = rowsum(dO * O) for every (b, i, h) row, the first launch of a
// backward call.
template <typename T, int D>
void launch_delta(const void* o, const void* dout, float* delta, int B,
                  int Sq, int H, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * Sq * H;
  constexpr int kRowsPerBlock = kBwdThreads / 32;
  flash_bwd_delta<T, D><<<static_cast<unsigned>((rows + kRowsPerBlock - 1) /
                                                kRowsPerBlock),
                          kBwdThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, Sq,
      H);
}

// The in-order sum of `nsplit` runs' partials into `outs` outputs of n
// elements (dK then dV, or dQ alone).
template <typename T>
void launch_sum(const float* part, void* out0, void* out1, long long n,
                int outs, int nsplit, float scale0, float scale1,
                cudaStream_t stream) {
  flash_bwd_sum<T><<<dim3(static_cast<unsigned>((n + kBwdThreads - 1) /
                                                kBwdThreads), outs),
                     kBwdThreads, 0, stream>>>(
      part, static_cast<T*>(out0), static_cast<T*>(out1), n, nsplit, scale0,
      scale1);
}

// The f32 backward: the delta rows, the dK/dV pass (and its sum), the
// dQ pass (and its sum).
template <int D>
int launch_bwd_f32(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const void* lse,
                   void* delta, void* dq, void* dk, void* dv, void* scratch,
                   int B, int Sq, int Skv, int H, int KVH, int causal,
                   int window, float logit_cap, float scale, int sms,
                   cudaStream_t stream) {
  using L = F32Bwd<D>;
  static std::atomic<bool> ready_kv[kMaxDevices], ready_q[kMaxDevices];
  auto kern_kv = flash_bwd_dkdv_f32<D>;
  auto kern_q = flash_bwd_dq_f32<D>;
  int err = opt_in(kern_kv, L::KV_BYTES, ready_kv);
  if (err == 0) err = opt_in(kern_q, L::Q_BYTES, ready_q);
  if (err != 0) return err;
  const BwdPlan plan = bwd_plan(L::BQ, L::BK, B, Sq, Skv, H, KVH, D, sms);
  float* part = static_cast<float*>(scratch);
  if (plan.scratch > 0 && part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  const float* fdo = static_cast<const float*>(dout);
  const float* flse = static_cast<const float*>(lse);
  float* fdelta = static_cast<float*>(delta);
  launch_delta<float, D>(o, dout, fdelta, B, Sq, H, stream);
  kern_kv<<<dim3((Skv + L::BK - 1) / L::BK * L::NC, KVH,
                 B * plan.split_kv),
            L::THREADS, L::KV_BYTES, stream>>>(
      fq, fk, fv, fdo, flse, fdelta, static_cast<float*>(dk),
      static_cast<float*>(dv), part, Sq, Skv, H, KVH, causal, window,
      logit_cap, scale, plan.split_kv);
  if (plan.split_kv > 1)
    launch_sum<float>(part, dk, dv,
                      static_cast<long long>(B) * Skv * KVH * D, 2,
                      plan.split_kv, scale, 1.f, stream);
  kern_q<<<dim3((Sq + L::BQ - 1) / L::BQ * L::NC, H, B * plan.split_q),
           L::THREADS, L::Q_BYTES, stream>>>(
      fq, fk, fv, fdo, flse, fdelta, static_cast<float*>(dq), part, Sq, Skv,
      H, KVH, causal, window, logit_cap, scale, plan.split_q);
  if (plan.split_q > 1)
    launch_sum<float>(part, dq, dq, static_cast<long long>(B) * Sq * H * D,
                      1, plan.split_q, scale, scale, stream);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 backward: the delta rows, the dK/dV pass (and its sum), the
// dQ pass (and its sum), with q, k, v and dO read through four tensor
// maps of 64 x 64 boxes.
template <int D>
int launch_bwd_sm90(const void* q, const void* k, const void* v,
                    const void* o, const void* dout, const void* lse,
                    void* delta, void* dq, void* dk, void* dv, void* scratch,
                    int B, int Sq, int Skv, int H, int KVH, int causal,
                    int window, float logit_cap, float scale, int sms,
                    cudaStream_t stream) {
  using L = BwdSmem<D>;
  using bf16 = __nv_bfloat16;
  static std::atomic<bool> ready_kv[kMaxDevices], ready_q[kMaxDevices];
  auto kern_kv = flash_bwd_dkdv_sm90<D>;
  auto kern_q = flash_bwd_dq_sm90<D>;
  int err = opt_in(kern_kv, L::KV_ALLOC, ready_kv);
  if (err == 0) err = opt_in(kern_q, L::Q_ALLOC, ready_q);
  if (err != 0) return err;
  const BwdPlan plan = bwd_plan(kBQ, kBK, B, Sq, Skv, H, KVH, D, sms);
  float* part = static_cast<float*>(scratch);
  if (plan.scratch > 0 && part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];   // q, k, v, dO
  EncodeTiled fn = encoder();
  if (fn == nullptr || !encode_rows(fn, &maps[0], q, B, Sq, H * D) ||
      !encode_rows(fn, &maps[1], k, B, Skv, KVH * D) ||
      !encode_rows(fn, &maps[2], v, B, Skv, KVH * D) ||
      !encode_rows(fn, &maps[3], dout, B, Sq, H * D))
    return kErrTensorMap;
  const float* flse = static_cast<const float*>(lse);
  float* fdelta = static_cast<float*>(delta);
  launch_delta<bf16, D>(o, dout, fdelta, B, Sq, H, stream);
  kern_kv<<<dim3((Skv + kBK - 1) / kBK, KVH, B * plan.split_kv),
            L::kKvThreads, L::KV_ALLOC, stream>>>(
      maps[0], maps[1], maps[2], maps[3], flse, fdelta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), part, Sq, Skv, H, KVH, causal, window,
      logit_cap, scale, plan.split_kv);
  if (plan.split_kv > 1)
    launch_sum<bf16>(part, dk, dv, static_cast<long long>(B) * Skv * KVH * D,
                     2, plan.split_kv, scale, 1.f, stream);
  kern_q<<<dim3((Sq + kBQ - 1) / kBQ, H, B * plan.split_q), kQThreads,
           L::Q_ALLOC, stream>>>(
      maps[0], maps[1], maps[2], maps[3], flse, fdelta, static_cast<bf16*>(dq),
      part, Sq, Skv, H, KVH, causal, window, logit_cap, scale, plan.split_q);
  if (plan.split_q > 1)
    launch_sum<bf16>(part, dq, dq, static_cast<long long>(B) * Sq * H * D, 1,
                     plan.split_q, scale, scale, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The f32 scratch (floats) flash_attention_bwd_launch needs for this
// dtype and shape on a card of `sms` SMs: the partials of the runs it
// cuts the dK/dV and dQ reductions into (0 when it cuts none); -1 for a
// dtype or D it does not take.
extern "C" long long flash_attention_bwd_scratch(int dtype, int B, int Sq,
                                                 int Skv, int H, int KVH,
                                                 int D, int sms) {
  if (dtype == 1)
    return D == 64 || D == 128 || D == 256
        ? bwd_plan(kBQ, kBK, B, Sq, Skv, H, KVH, D, sms).scratch : -1;
  if (dtype != 0) return -1;
#define FLASH_SCRATCH_CASE(DD)                                               \
  case DD:                                                                   \
    return bwd_plan(F32Bwd<DD>::BQ, F32Bwd<DD>::BK, B, Sq, Skv, H, KVH, D, \
                    sms).scratch;
  switch (D) {
    FLASH_SCRATCH_CASE(16)
    FLASH_SCRATCH_CASE(32)
    FLASH_SCRATCH_CASE(64)
    FLASH_SCRATCH_CASE(128)
    FLASH_SCRATCH_CASE(256)
    default:
      return -1;
  }
#undef FLASH_SCRATCH_CASE
}

// The gradients (dQ, dK, dV) of the forward with lse: q, o, dout, dq
// (B, Sq, H, D), k, v, dk, dv (B, Skv, KVH, D) in one dtype (0 = float32,
// D in {16, 32, 64, 128, 256}, three TF32 products for each f32 one;
// 1 = bfloat16, D in {64, 128, 256}), lse (B, H, Sq) float32 as the forward
// wrote it, `delta` (B, H, Sq) float32 scratch and `scratch` the f32
// scratch flash_attention_bwd_scratch names for the same dtype, shape
// and `sms` (null when it names none).  The masks are the forward's:
// causal, window, tanh soft cap; every kv position below Skv is valid.
// Three to five launches (delta, dK/dV, their sum, dQ, its sum), no
// atomics: the same inputs on the same card give the same bits.  Returns
// 0, a cudaError_t, or kErrTensorMap (bf16).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, void* scratch, int dtype, int B, int Sq, int Skv, int H,
    int KVH, int D, int causal, int window, float logit_cap, float scale,
    int sms, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KVH < 1 || H % KVH != 0 || H > 65535 ||
      static_cast<long long>(B) * kMaxSplit > 65535 || sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_BWD_CASE(FN, DD)                                              \
  case DD:                                                                  \
    return FN(q, k, v, o, dout, lse, delta, dq, dk, dv, scratch, B, Sq,     \
              Skv, H, KVH, causal, window, logit_cap, scale, sms, s);
  if (dtype == 0) {
    switch (D) {
      FLASH_BWD_CASE(launch_bwd_f32<16>, 16)
      FLASH_BWD_CASE(launch_bwd_f32<32>, 32)
      FLASH_BWD_CASE(launch_bwd_f32<64>, 64)
      FLASH_BWD_CASE(launch_bwd_f32<128>, 128)
      FLASH_BWD_CASE(launch_bwd_f32<256>, 256)
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype == 1) {
    switch (D) {
      FLASH_BWD_CASE(launch_bwd_sm90<64>, 64)
      FLASH_BWD_CASE(launch_bwd_sm90<128>, 128)
      FLASH_BWD_CASE(launch_bwd_sm90<256>, 256)
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#undef FLASH_BWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype: 0 = float32 (D in {16, 32, 64, 128, 256}), 1 = bfloat16 (D in
// {64, 128, 256}).  `lse`: null, or (B, H, Sq) float32 for the rows'
// natural-log log-sum-exp.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int dtype,
                                      int B, int Sq, int Skv, int H, int KVH,
                                      int D, int causal, int window,
                                      int valid_len, float logit_cap,
                                      float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(FN, DD)                                                  \
  case DD:                                                                  \
    return FN<DD>(q, k, v, o, lse, B, Sq, Skv, H, KVH, causal, window,     \
                  valid_len, logit_cap, scale, s);
  if (dtype == 1) {
    switch (D) {
      FLASH_CASE(launch_sm90, 64)
      FLASH_CASE(launch_sm90, 128)
      FLASH_CASE(launch_sm90, 256)
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype == 0) {
    switch (D) {
      FLASH_CASE(launch_f32, 16)
      FLASH_CASE(launch_f32, 32)
      FLASH_CASE(launch_f32, 64)
      FLASH_CASE(launch_f32, 128)
      FLASH_CASE(launch_f32, 256)
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#undef FLASH_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// Host cost of the bf16 path's per-call set-up: nanoseconds to encode the
// three tensor maps of one call, averaged over `iters`; -1 on failure.
extern "C" double flash_attention_map_ns(const void* q, const void* k,
                                         const void* v, int B, int Sq,
                                         int Skv, int H, int KVH, int D,
                                         int iters) {
  CUtensorMap maps[3];
  if (iters <= 0 || !encode_qkv(maps, q, k, v, B, Sq, Skv, H, KVH, D))
    return -1.0;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i) {
    if (!encode_qkv(maps, q, k, v, B, Sq, Skv, H, KVH, D)) return -1.0;
  }
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::nano>(t1 - t0).count() / iters;
}
