// Causal flash attention forward for Hopper (sm_90a): O = softmax(Q K^T *
// scale + causal) V and the row log-sum-exp, bf16 in, fp32 accumulation,
// built from TMA copies, wgmma and warp specialisation.
//
// Replaces the forward of the TPU kernels reached from
// ray_tpu/models/llama.py: _splash_attention (:334; JAX's Pallas splash
// forward, splash_attention_kernel.py pallas_call :1137) and
// _flash_attention (:365; JAX's Pallas flash forward, flash_attention.py
// :758). The backward kernels are in flash_attention.cu and read this
// kernel's o and lse: lse is (m + log2 l) * ln 2, the natural-log LSE.
//
// Layouts: q/o [B, T, H, D], k/v [B, T, KV, D] through their strides (unit
// head_dim stride, other strides multiples of 16 bytes, 16-byte aligned
// start: what TMA needs); lse fp32 [B, H, T]. Query head h reads kv head
// h / G (GQA without repeating K/V). The scale multiplies the fp32 scores.
//
// Bound, at the training path's shape (B 4, H 16, T 2048, D 128, causal):
// 4*B*H*D*T(T+1)/2 = 6.88e10 FLOPs, 69.5 us at 989 TFLOP/s, against 40 us
// for its ~134 MB of q, k, v, o at 3.35 TB/s: the tensor cores bound it.
// But each CTA reads every K/V tile up to its diagonal, ~8.5x the K/V bytes
// at that shape, so L2 must hold the K/V that the CTAs in flight share,
// and the per-item start and end must hide behind other work. The design:
//   - persistent: one CTA of 3 warpgroups per SM walks work items (a
//     128-row Q block of one q head and batch) that a counter hands out,
//     in sections of (head, batch) pairs whose K/V fit in 32 MB of L2, and
//     within a section heaviest causal blocks first. Warpgroup 0 is the
//     producer: one thread claims the items and issues every TMA copy, and
//     the warpgroup gives its registers away (setmaxnreg 24). Warpgroups 1
//     and 2 are consumers (setmaxnreg 240), 64 Q rows each;
//   - TMA: Q into one of 2 buffers (the next item's Q loads while this one
//     runs); K and V tiles of 128 keys through a 2-stage ring with full and
//     empty mbarriers, K and V on barriers of their own so Q K^T starts
//     before V lands. Tiles land 128-byte swizzled, as [rows][64 columns]
//     halves (a swizzled box is at most 128 bytes wide), rows past T
//     zero-filled by TMA;
//   - S = Q K^T is wgmma m64n128k16 with both operands in shared memory
//     (K-major); O += P V takes P from registers (the S accumulator after
//     the softmax, packed to bf16 in place: the accumulator and the A
//     fragment share a layout) and V from shared memory as an MN-major B
//     through wgmma's transpose bit;
//   - causal: key tiles past the diagonal are never loaded; tiles run from
//     the diagonal down, so only the first tile of an item (the diagonal,
//     or the ragged end of T) is masked;
//   - overlap: each consumer issues the next tile's Q K^T before this
//     tile's softmax, beside the P V product of the tile before. The two
//     consumers run unsynchronised, so one's softmax also overlaps the
//     other's products (making them take turns on named barriers measured
//     no faster: PERF.md, PR 5);
//   - epilogue: O / l goes in bf16 over the warpgroup's own Q rows in
//     shared memory and out by a TMA store, which clips at T, while the
//     consumers move on; lse is (m + log2 l) ln 2, as the backward reads it.
// A lost mbarrier arrival traps after seconds instead of hanging the card.
//
// C interface (loaded with ctypes): rt_flash_attn_fwd returns
// cudaGetLastError() after its launch, -1 if the driver's
// cuTensorMapEncodeTiled cannot be found, or -(1000 + CUresult) if it
// refuses a tensor map.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBlockM = 128;  // query rows per CTA
constexpr int kBlockN = 128;  // keys per K/V tile
constexpr int kStages = 2;    // K/V tiles in flight
constexpr int kConsumers = 2;  // warpgroups of 64 query rows
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kHalfBytes = 128 * 128;  // 128 rows x 64 bf16: one swizzled box
// K/V bytes that the CTAs in flight should share out of the 50 MB L2 (32 MB
// read faster than 8 and 16 MB over three shapes: PERF.md, PR 5)
constexpr long long kL2Budget = 32ll << 20;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct FwdParams {
  float* lse;
  int* next_work;    // the scheduler's counter, 0 at launch
  int per_section;   // (head, batch) pairs a work section
  int B, T, H, G;
  float scale_log2;
  int causal;
};

// ---------------------------------------------------------------------------
// PTX: shared memory, mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// arrive once and expect `bytes` of TMA transactions in this phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// until the phase of parity `parity` has completed; a wait of more than
// ~2^34 cycles (seconds) traps, so a lost arrival faults the launch instead
// of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 34)) {
      __trap();
    }
  }
}

// one box of a 4-D tensor map (coordinates innermost first) into shared
// memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// one box from shared memory into a 4-D tensor map (rows past the map's
// extent are not written), as a bulk async-group of this thread
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit_and_wait_read() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// generic-proxy writes to shared memory, before an async-proxy (TMA) read
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a named barrier over the 128 threads of one warpgroup (id 0 is
// __syncthreads)
__device__ __forceinline__ void bar_sync_wg(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(128) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving register reads or writes across an
// asynchronous wgmma: each register "changes" here.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle. K-major tiles (Q, K):
// 8-row groups 1024 bytes apart (SBO), the leading offset unused. MN-major
// tiles (V as B): `lbo` is the distance between 64-column halves.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

#define RT_D8(i)                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64x128] (+)= A[64x16] B[16x128], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : RT_D8(0), RT_D8(8), RT_D8(16), RT_D8(24), RT_D8(32), RT_D8(40), RT_D8(48), RT_D8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64x128] += A[64x16] B[16x128], A in registers, B MN-major in shared
// memory (transpose bit set)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : RT_D8(0), RT_D8(8), RT_D8(16), RT_D8(24), RT_D8(32), RT_D8(40), RT_D8(48), RT_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64x64] += A[64x16] B[16x64], as above
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : RT_D8(0), RT_D8(8), RT_D8(16), RT_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef RT_D8

// 2^x on the special-function unit, subnormal results flushed to 0 (a P
// below 2^-126 adds nothing to a bf16 product)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// One consumer warpgroup's steps
// ---------------------------------------------------------------------------

// s = Q K^T for this warpgroup's 64 rows and one 128-key tile (issued,
// committed, not waited for)
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t q, uint32_t k) {
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    const uint32_t off = (i / 4) * kHalfBytes + (i % 4) * 32;  // half, then k16 step
    wgmma_ss_n128(s, desc_sw128(q + off, 16), desc_sw128(k + off, 16), i > 0);
  }
  wgmma_commit();
}

// o += P V for one 128-key tile (issued, committed, not waited for)
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pf)[8][4],
                                         uint32_t v) {
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < kBlockN / 16; ++i) {
    const uint64_t db = desc_sw128(v + i * 16 * 128, kHalfBytes);  // 16 keys of 128 bytes
    if constexpr (D == 128) {
      wgmma_rs_n128(o, pf[i], db);
    } else {
      wgmma_rs_n64(o, pf[i], db);
    }
  }
  wgmma_commit();
}

// Online softmax over one tile of scores, in place: s becomes P (unscaled
// by the running sum), m and l the running max (log2 domain) and this
// thread's share of the row sum, corr the factor for O. A thread holds rows
// row0 and row0 + 8, columns col0 + 8j + 2t + {0, 1} (the wgmma
// accumulator layout).
template <bool kMask>
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], float scale_log2, int col0,
                                             int row0, int T, bool causal) {
  // column offset (from col0) of the last key that row row0 + 8r sees
  int last[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) last[r] = (causal ? min(row0 + 8 * r, T - 1) : T - 1) - col0;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    float x = s[i] * scale_log2;
    if (kMask && (i / 4) * 8 + (i & 1) > last[(i >> 1) & 1]) x = -INFINITY;
    s[i] = x;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m[r];
#pragma unroll
    for (int j = 0; j < 16; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mref = mx == -INFINITY ? 0.f : mx;
    corr[r] = ex2(m[r] - mref);
    m[r] = mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      s[4 * j + 2 * r] = ex2(s[4 * j + 2 * r] - mref);
      s[4 * j + 2 * r + 1] = ex2(s[4 * j + 2 * r + 1] - mref);
      sum += s[4 * j + 2 * r] + s[4 * j + 2 * r + 1];
    }
    l[r] = l[r] * corr[r] + sum;
  }
}

// P as the A operand of the P V product: k16 step i is columns 16i..16i+15,
// the accumulator's n8 blocks 2i and 2i + 1
__device__ __forceinline__ void pack_p(const float (&s)[64], uint32_t (&pf)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    pf[i][0] = pack_bf16(s[8 * i], s[8 * i + 1]);
    pf[i][1] = pack_bf16(s[8 * i + 2], s[8 * i + 3]);
    pf[i][2] = pack_bf16(s[8 * i + 4], s[8 * i + 5]);
    pf[i][3] = pack_bf16(s[8 * i + 6], s[8 * i + 7]);
  }
}

template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2], const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
}

// ---------------------------------------------------------------------------
// The kernel: persistent CTAs, each walking work items (a 128-row Q block
// of one q head and batch)
// ---------------------------------------------------------------------------
template <int D>
struct Layout {
  static constexpr int kTile = kBlockN * D * 2;  // a Q, K or V tile, bytes
  static constexpr int kQ = 0;                      // + buffer * kTile
  static constexpr int kK = 2 * kTile;              // + stage * kTile
  static constexpr int kV = (2 + kStages) * kTile;  // + stage * kTile
  static constexpr int kBars = (2 + 2 * kStages) * kTile;
  // q_full[2], q_empty[2], k_full[kStages], v_full[kStages],
  // k_empty[kStages], v_empty[kStages]
  static constexpr int kNumBars = 4 + 4 * kStages;
  static constexpr int kSlots = kBars + 8 * kNumBars;  // int[2]: each Q buffer's work item
  static constexpr int kSmem = 1024 + kSlots + 8;    // 1024: alignment slack
};

// The work items: Q blocks of (head, batch) pairs, taken in sections of
// `per_section` consecutive pairs (their K/V fit in L2 together; a kv
// head's G query heads are neighbours), and within a section heaviest
// causal blocks first, every pair's block before the next lighter block.
struct Work {
  int qb, h, b;
  __device__ __forceinline__ Work(int w, int nqb, int H, int B, int per_section) {
    const int per = nqb * per_section;  // items of a full section
    const int sec = w / per, first = sec * per_section;
    const int pairs = min(per_section, H * B - first);  // the last may be short
    const int r = w - sec * per;
    qb = nqb - 1 - r / pairs;
    const int hb = first + r % pairs;
    h = hb % H;
    b = hb / H;
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_o, const FwdParams p) {
  static_assert(kBlockM == kBlockN, "the causal block count assumes square tiles");
  using L = Layout<D>;
  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles want 1024-byte alignment
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  auto q_tile = [&](int qs) { return base + L::kQ + qs * L::kTile; };
  auto k_tile = [&](int st) { return base + L::kK + st * L::kTile; };
  auto v_tile = [&](int st) { return base + L::kV + st * L::kTile; };
  const uint32_t bars = base + L::kBars;
  auto q_full = [&](int qs) { return bars + 8 * qs; };
  auto q_empty = [&](int qs) { return bars + 8 * (2 + qs); };
  auto k_full = [&](int st) { return bars + 8 * (4 + st); };
  auto v_full = [&](int st) { return bars + 8 * (4 + kStages + st); };
  auto k_empty = [&](int st) { return bars + 8 * (4 + 2 * kStages + st); };
  auto v_empty = [&](int st) { return bars + 8 * (4 + 3 * kStages + st); };
  volatile int* work_slot =
      reinterpret_cast<int*>(smem_raw + (base - smem_u32(smem_raw)) + L::kSlots);

  const int T = p.T;
  const int nqb = (T + kBlockM - 1) / kBlockM;
  const int n_work = nqb * p.H * p.B;
  // K/V tiles of a Q block: up to the diagonal, or all of T
  auto n_tiles = [&](int qb) { return p.causal ? qb + 1 : nqb; };
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int qs = 0; qs < 2; ++qs) {
      mbar_init(q_full(qs), 1);
      mbar_init(q_empty(qs), 128 * kConsumers);
    }
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), 128 * kConsumers);
      mbar_init(v_empty(st), 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Work items are handed out dynamically: a CTA's first is its index, each
  // later one the next from the counter, claimed by the producer and passed
  // to the consumers in the slot of its Q buffer (n_work or more: stop).
  // Producer and consumers walk the same items and K/V tiles: `n` counts
  // this CTA's K/V tiles (ring slot n % kStages, round n / kStages), `j` its
  // items (Q buffer j % 2, round j / 2).
  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      uint32_t n = 0;
      int w = blockIdx.x;
      for (int j = 0;; ++j) {
        const int qs = j % 2;
        mbar_wait(q_empty(qs), ((j / 2) & 1) ^ 1);  // a fresh barrier passes
        work_slot[qs] = w;
        if (w >= n_work) {
          mbar_arrive(q_full(qs));
          break;
        }
        const Work wk(w, nqb, p.H, p.B, p.per_section);
        const int kvh = wk.h / p.G, nk = n_tiles(wk.qb);
        mbar_expect_tx(q_full(qs), L::kTile);
        for (int hh = 0; hh < D / 64; ++hh)
          tma_load_4d(q_tile(qs) + hh * kHalfBytes, &tm_q, q_full(qs), hh * 64, wk.h,
                      wk.qb * kBlockM, wk.b);
        for (int it = 0; it < nk; ++it, ++n) {
          const int st = n % kStages;
          const uint32_t free_parity = ((n / kStages) & 1) ^ 1;
          const int k0 = (nk - 1 - it) * kBlockN;  // from the diagonal down
          mbar_wait(k_empty(st), free_parity);
          mbar_expect_tx(k_full(st), L::kTile);
          for (int hh = 0; hh < D / 64; ++hh)
            tma_load_4d(k_tile(st) + hh * kHalfBytes, &tm_k, k_full(st), hh * 64, kvh, k0, wk.b);
          mbar_wait(v_empty(st), free_parity);
          mbar_expect_tx(v_full(st), L::kTile);
          for (int hh = 0; hh < D / 64; ++hh)
            tma_load_4d(v_tile(st) + hh * kHalfBytes, &tm_v, v_full(st), hh * 64, kvh, k0, wk.b);
        }
        w = gridDim.x + atomicAdd(p.next_work, 1);
      }
    }
    return;
  }

  // ---- consumers: 64 query rows each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int row_t = 64 * c + 16 * warp + lane / 4;  // this thread's rows in a block: +0, +8
  const int col_t = 2 * (lane % 4);
  const bool mask_first = p.causal || T % kBlockN != 0;

  float o[D / 2], s[64], m[2], l[2], corr[2];
  uint32_t pf[8][4];
  uint32_t n = 0;
  for (int j = 0;; ++j) {
    const int qs = j % 2;
    mbar_wait(q_full(qs), (j / 2) & 1);
    const int w = work_slot[qs];
    if (w >= n_work) break;
    const Work wk(w, nqb, p.H, p.B, p.per_section);
    const int nk = n_tiles(wk.qb), row0 = wk.qb * kBlockM + row_t;
    const uint32_t q_rows = q_tile(qs) + c * 64 * 128;  // this warpgroup's rows in each half
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
    auto softmax = [&](bool masked, int it) {
      const int col0 = (nk - 1 - it) * kBlockN + col_t;
      if (masked) {
        softmax_tile<true>(s, m, l, corr, p.scale_log2, col0, row0, T, p.causal);
      } else {
        softmax_tile<false>(s, m, l, corr, p.scale_log2, col0, row0, T, p.causal);
      }
    };

    // the first tile (the only masked one): its scores, then its softmax;
    // O is still 0, so no rescale
    mbar_wait(k_full(n % kStages), (n / kStages) & 1);
    issue_qk<D>(s, q_rows, k_tile(n % kStages));
    wgmma_wait<0>();
    reg_fence(s);
    mbar_arrive(k_empty(n % kStages));
    softmax(mask_first, 0);
    pack_p(s, pf);

    for (int it = 1; it < nk; ++it, ++n) {
      const int st = (n + 1) % kStages, pst = n % kStages;
      const uint32_t parity = ((n + 1) / kStages) & 1, pparity = (n / kStages) & 1;
      mbar_wait(k_full(st), parity);
      issue_qk<D>(s, q_rows, k_tile(st));  // this tile's scores ...
      mbar_wait(v_full(pst), pparity);
      reg_fence(o);
      issue_pv<D>(o, pf, v_tile(pst));  // ... beside the last tile's P V
      wgmma_wait<1>();  // the scores are in
      reg_fence(s);
      mbar_arrive(k_empty(st));
      softmax(false, it);
      wgmma_wait<0>();  // P V is done: O and P may change
      reg_fence(o);
      reg_fence(pf);
      mbar_arrive(v_empty(pst));
      rescale<D>(o, corr);
      pack_p(s, pf);
    }
    const int lst = n % kStages;
    mbar_wait(v_full(lst), (n / kStages) & 1);
    reg_fence(o);
    issue_pv<D>(o, pf, v_tile(lst));
    wgmma_wait<0>();
    reg_fence(o);
    reg_fence(pf);
    mbar_arrive(v_empty(lst));
    ++n;

    // ---- epilogue: O / l in bf16 over this warpgroup's Q rows in shared
    // memory (same 128-byte swizzle), then out by TMA, which clips at T;
    // lse = (m + log2 l) ln 2 ----
    const int g = lane / 4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = 1.f / sum;
      const uint32_t row_addr = q_rows + (16 * warp + g + 8 * r) * 128 + 2 * col_t;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const uint32_t v = pack_bf16(o[4 * i + 2 * r] * inv, o[4 * i + 2 * r + 1] * inv);
        const uint32_t addr = row_addr + (i / 8) * kHalfBytes + (((i % 8) ^ g) * 16);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
      }
      const int row = row0 + 8 * r;
      if (lane % 4 == 0 && row < T)
        p.lse[((long long)wk.b * p.H + wk.h) * T + row] = (m[r] + log2f(sum)) * kLn2;
    }
    fence_proxy_async();
    bar_sync_wg(1 + c);
    if (tid == 0) {
      for (int hh = 0; hh < D / 64; ++hh)
        tma_store_4d(&tm_o, q_rows + hh * kHalfBytes, hh * 64, wk.h, wk.qb * kBlockM + 64 * c,
                     wk.b);
      tma_store_commit_and_wait_read();
    }
    mbar_arrive(q_empty(qs));  // thread 0 once its store has read the rows
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");  // stores done
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// A [B, T, heads, D] bf16 tensor with strides s (elements; [b, t, head])
// as a 4-D map (D, heads, T, B) with boxes of 64 columns x 1 head x `rows`
// x 1 batch, 128-byte swizzled; rows past T read as zeros and are not
// written. A dimension of extent 1 gets its packed stride (its own may be
// anything).
CUresult make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, const long long* s,
                  int B, int T, int heads, int D, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)T, (cuuint64_t)B};
  const long long packed[3] = {(long long)D, (long long)D * heads, (long long)D * heads * T};
  const long long elems[3] = {s[2], s[1], s[0]};  // heads, T, B
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = (cuuint64_t)(dims[i + 1] == 1 ? packed[i] : elems[i]) * sizeof(bf16);
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D>
cudaError_t launch(const CUtensorMap& q, const CUtensorMap& k, const CUtensorMap& v,
                   const CUtensorMap& o, const FwdParams& p, cudaStream_t stream) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<D>::kSmem);
  if (attr != cudaSuccess) return attr;
  // one CTA an SM (at most one item each to start with)
  const int n_work = (p.T + kBlockM - 1) / kBlockM * p.H * p.B;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int grid = n_work < sms ? n_work : sms;
  flash_fwd_wgmma_kernel<D>
      <<<grid, kThreads, Layout<D>::kSmem, stream>>>(q, k, v, o, p);
  return cudaGetLastError();
}

}  // namespace

// strides: 24 int64, [batch, time, head] for q, k, v, o, do, dq, dk, dv
// (only q, k, v and o are read). next_work: one int32 on the device, 0 at
// launch (the scheduler's counter). D must be 64 or 128.
extern "C" int rt_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                 float* lse, int* next_work, const long long* strides, int B,
                                 int T, int H, int KV, int D, float scale, int causal,
                                 void* stream) {
  if (D != 64 && D != 128) return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  CUtensorMap tq, tk, tv, to;  // o: a consumer warpgroup's 64 rows a box
  CUresult r = make_map(encode, &tq, q, strides, B, T, H, D, kBlockM);
  if (r == CUDA_SUCCESS) r = make_map(encode, &tk, k, strides + 3, B, T, KV, D, kBlockN);
  if (r == CUDA_SUCCESS) r = make_map(encode, &tv, v, strides + 6, B, T, KV, D, kBlockN);
  if (r == CUDA_SUCCESS)
    r = make_map(encode, &to, o, strides + 9, B, T, H, D, kBlockM / kConsumers);
  if (r != CUDA_SUCCESS) return -(1000 + static_cast<int>(r));
  FwdParams p;
  p.lse = lse;
  p.next_work = next_work;
  // (head, batch) pairs whose K/V take at most kL2Budget together
  const long long kv_bytes = 2LL * T * D * sizeof(bf16) * KV / H;  // a query head's share
  const long long per_section = kL2Budget / (kv_bytes > 0 ? kv_bytes : 1);
  p.per_section = per_section < 1 ? 1 : per_section > B * H ? B * H : (int)per_section;
  p.B = B;
  p.T = T;
  p.H = H;
  p.G = H / KV;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch<64>(tq, tk, tv, to, p, s) : launch<128>(tq, tk, tv, to, p, s);
}
