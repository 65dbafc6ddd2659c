// Causal flash attention backward for Hopper (sm_90a): dQ and dK/dV, bf16
// in, fp32 accumulation, built from TMA copies, wgmma and warp
// specialisation like the forward (flash_attention_fwd.cu), whose o and
// natural-log lse these kernels read. The PTX helpers, the tensor maps and
// the mbarrier trap are in hopper.cuh.
//
// Replaces the backward of the TPU kernels reached from
// ray_tpu/models/llama.py:
//   - _splash_attention (:334): JAX's Pallas splash kernel
//     (jax/experimental/pallas/ops/tpu/splash_attention/
//     splash_attention_kernel.py), backward dQ pallas_call :1635, backward
//     dK/dV :2196;
//   - _flash_attention (:365): JAX's Pallas flash kernel
//     (jax/experimental/pallas/ops/tpu/flash_attention.py), backward dK/dV
//     :1121, backward dQ :1456.
// Both compute the gradient of softmax(Q K^T * sm_scale + causal) V from
// the saved row log-sum-exp (LSE). Differences from the TPU path, on
// purpose:
//   - GQA: JAX repeats K/V to the query head count before its kernel
//     (llama.py:315-322); here query head h reads kv head h / G directly,
//     and dK/dV sums over the G query heads of a kv head inside one work
//     item, so there are no atomics and no repeated K/V: both kernels give
//     the same bits on every run.
//   - sm_scale is applied in fp32 to the scores, as flash_attention and
//     dense_attention do; splash pre-scales q in bf16 (llama.py:348).
//   - delta = rowsum(O * dO) is folded into the dQ kernel (JAX computes it
//     in XLA, splash :2285, flash :273); the dK/dV kernel reads it back.
//
// Layouts: q/o/do/dq [B, T, H, D], k/v/dk/dv [B, T, KV, D] through their
// strides (unit head_dim stride, other strides multiples of 16 bytes,
// 16-byte aligned start: what TMA needs); lse and delta fp32 [B, H, T],
// contiguous.
//
// Bound, at the training path's shape (B 4, H 16, T 2048, D 128, causal):
// the backward function does 2.5x the forward's 6.88e10 FLOPs (S, dP, dV,
// dK, dQ), 174 us at 989 TFLOP/s; as two kernels each recomputes S and dP,
// so dQ does 6 and dK/dV 8 FLOPs per causal (query, key) pair and head
// dim: 104 and 139 us. The tensor cores bound both. The design, per kernel:
//   - persistent: one CTA of 3 warpgroups per SM walks work items that a
//     counter hands out (heaviest causal blocks first, in sections of
//     (head, batch) pairs whose streamed tiles fit in 16 MB (dQ) or 32 MB
//     (dK/dV) of L2).
//     Warpgroup 0 is the producer (setmaxnreg 24): one thread claims items
//     and issues every TMA copy. Warpgroups 1 and 2 are consumers
//     (setmaxnreg 240), 64 rows of the item each;
//   - dQ (query-major): an item is 128 query rows of one (q head, batch).
//     Q and dO land in one of 2 buffers (the next item's load while this
//     one runs), O in a buffer of its own that frees as soon as the
//     consumers have taken delta = rowsum(O * dO) from it. K and V stream
//     in 64-key tiles, from the diagonal down, through a 2-stage ring.
//     Per tile: S = Q K^T and dP = dO V^T (SS wgmma, n64), P = exp2(S s
//     log2e - lse log2e) against the row's lse, dS = P (dP - delta),
//     dQ += dS K (RS wgmma: dS packed to bf16 in place as the A fragment,
//     K an MN-major B through the transpose bit). 64-key tiles keep S, dP
//     and the dQ accumulator within the consumer's registers, and the
//     shared memory holds the double-buffered Q/dO beside the ring;
//   - dK/dV (key-major): an item is 128 keys of one (kv head, batch); its
//     K and V land in one of 2 buffers. The producer streams 64-row Q and
//     dO tiles of each of the kv head's G query heads, the causal ones at
//     or after the diagonal, through a 3-stage ring; a second producer
//     warp writes their lse (times log2e; +inf past T, so padded rows give
//     P = 0) and delta rows beside them. Per tile: S^T = K Q^T and
//     dP^T = V dO^T (SS, n64), P^T with lse broadcast along the columns,
//     dV += P^T dO (RS, P^T packed in place, dO MN-major), dS^T =
//     P^T (dP^T - delta), dK += dS^T Q (RS). dK and dV stay in registers
//     for the whole item;
//   - causal: tiles wholly past the diagonal are never loaded; only the
//     tiles that cross it are masked. Rows past T are zero-filled by TMA
//     and clipped by its store: no other edge handling;
//   - epilogue: dQ s, dK s and dV go in bf16 over the consumer's own rows
//     of a buffer it has finished reading (Q, K, V) and out by TMA store.
//
// C interface (loaded with ctypes): each entry point returns
// cudaGetLastError() after its launch, -1 if cuTensorMapEncodeTiled cannot
// be found, or -(1000 + CUresult) if it refuses a tensor map.

#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kConsumers = 2;  // warpgroups of 64 rows
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kStages = 2;     // dQ: K/V tiles in flight
// dK/dV: Q/dO tiles in flight (3 read 1-2% faster than 2 at three shapes:
// PERF.md §6; the shared memory holds no more)
constexpr int kQStages = 3;
constexpr int kItemRows = 128;  // query rows (dQ) or keys (dK/dV) of an item
constexpr int kTileRows = 64;   // keys (dQ) or query rows (dK/dV) of a streamed tile
constexpr int kItemHalf = kItemRows * 128;  // one 64-column half of an item tile, bytes
constexpr int kTileHalf = kTileRows * 128;  // one half of a streamed tile, bytes
// streamed bytes that the CTAs in flight should share out of the 50 MB L2:
// dQ's K/V and dK/dV's Q/dO (16 MB read 2-5% faster than 32 for dQ; 16 MB
// slowed dK/dV at gqa3b, whose sections then hold fewer items than there
// are CTAs: PERF.md §6)
constexpr long long kDqL2Budget = 16ll << 20;
constexpr long long kDkdvL2Budget = 32ll << 20;
constexpr float kLog2e = 1.4426950408889634f;

struct BwdParams {
  const float* lse;  // natural log, [B, H, T]
  float* delta;      // [B, H, T]: written by dQ, read by dK/dV
  int* next_work;    // the scheduler's counter, 0 at launch
  int per_section;   // (head, batch) pairs a work section
  int B, T, H, KV, G;
  float scale, scale_log2;
  int causal;
};

// The work items: blocks of (head, batch) pairs, taken in sections of
// `per_section` consecutive pairs, and within a section by rank (0: the
// heaviest block), every pair's block before the next lighter one.
struct Work {
  int rank, pair;
  __device__ __forceinline__ Work(int w, int nblk, int npairs, int per_section) {
    const int per = nblk * per_section;  // items of a full section
    const int sec = w / per, first = sec * per_section;
    const int pairs = min(per_section, npairs - first);  // the last may be short
    const int r = w - sec * per;
    rank = r / pairs;
    pair = first + r % pairs;
  }
};

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}
__device__ __forceinline__ float2 ld_shared_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}
__device__ __forceinline__ void st_shared_f32(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

// the dot product of 8 bf16 pairs (16 bytes each side), in fp32
__device__ __forceinline__ float dot8(const uint4& a, const uint4& b) {
  const uint32_t av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&av[i]));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bv[i]));
    s += x.x * y.x + x.y * y.y;
  }
  return s;
}

// d = A B^T for this warpgroup's 64 rows of A (K-major, halves `a_half`
// apart) and a 64-row K-major tile B (halves kTileHalf apart): issued and
// committed, not waited for
template <int D>
__device__ __forceinline__ void issue_ss(float (&d)[32], uint32_t a, uint32_t a_half, uint32_t b) {
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < D / 16; ++i) {
    const uint32_t off = (i % 4) * 32;  // k16 step within a half
    wgmma_ss_n64(d, desc_sw128(a + (i / 4) * a_half + off, 16),
                 desc_sw128(b + (i / 4) * kTileHalf + off, 16), i > 0);
  }
  wgmma_commit();
}

// d += A B over 64 rows of B: A the packed fragments of a 64-column
// accumulator, B a 64-row tile read MN-major (its rows are the product's
// depth, 16 of them 2048 bytes); issued and committed, not waited for
template <int D>
__device__ __forceinline__ void issue_rs(float (&d)[D / 2], const uint32_t (&a)[4][4], uint32_t b) {
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < 4; ++i) wgmma_rs<D>(d, a[i], desc_sw128(b + i * 16 * 128, kTileHalf));
  wgmma_commit();
}

// acc * mul in bf16 over this warpgroup's 64 rows of a swizzled tile
// (`rows`: its first row in the first half; halves `half` apart), as the
// accumulator lays them out: a thread holds rows g and g + 8 of its warp's
// 16, columns 8i + 2(lane % 4) + {0, 1}
template <int D>
__device__ __forceinline__ void stage_rows(uint32_t rows, uint32_t half, const float (&acc)[D / 2],
                                           float mul, int warp, int lane) {
  const int g = lane / 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const uint32_t row_addr = rows + (16 * warp + g + 8 * r) * 128 + 4 * (lane % 4);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const uint32_t v = pack_bf16(acc[4 * i + 2 * r] * mul, acc[4 * i + 2 * r + 1] * mul);
      const uint32_t addr = row_addr + (i / 8) * half + (((i % 8) ^ g) * 16);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = 0.f;
}

// ---------------------------------------------------------------------------
// dQ (and delta): an item is 128 query rows of one (q head, batch)
// ---------------------------------------------------------------------------
template <int D>
struct DqLayout {
  static constexpr int kQTile = kItemRows * D * 2;  // a Q, dO or O tile, bytes
  static constexpr int kKTile = kTileRows * D * 2;  // a K or V tile
  static constexpr int kQ = 0;                      // + buffer * kQTile
  static constexpr int kDo = 2 * kQTile;            // + buffer * kQTile
  static constexpr int kO = 4 * kQTile;
  static constexpr int kK = 5 * kQTile;                     // + stage * kKTile
  static constexpr int kV = kK + kStages * kKTile;          // + stage * kKTile
  static constexpr int kBars = kV + kStages * kKTile;
  // q_full[2], q_empty[2], o_full, o_empty, k_full[kStages],
  // v_full[kStages], k_empty[kStages], v_empty[kStages]
  static constexpr int kNumBars = 6 + 4 * kStages;
  static constexpr int kSlots = kBars + 8 * kNumBars;  // int[2]: each Q buffer's work item
  static constexpr int kSmem = 1024 + kSlots + 8;      // 1024: alignment slack
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_o,
                        const __grid_constant__ CUtensorMap tm_do,
                        const __grid_constant__ CUtensorMap tm_dq, const BwdParams p) {
  using L = DqLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  auto q_tile = [&](int qs) { return base + L::kQ + qs * L::kQTile; };
  auto do_tile = [&](int qs) { return base + L::kDo + qs * L::kQTile; };
  const uint32_t o_tile = base + L::kO;
  auto k_tile = [&](int st) { return base + L::kK + st * L::kKTile; };
  auto v_tile = [&](int st) { return base + L::kV + st * L::kKTile; };
  const uint32_t bars = base + L::kBars;
  auto q_full = [&](int qs) { return bars + 8 * qs; };
  auto q_empty = [&](int qs) { return bars + 8 * (2 + qs); };
  const uint32_t o_full = bars + 8 * 4, o_empty = bars + 8 * 5;
  auto k_full = [&](int st) { return bars + 8 * (6 + st); };
  auto v_full = [&](int st) { return bars + 8 * (6 + kStages + st); };
  auto k_empty = [&](int st) { return bars + 8 * (6 + 2 * kStages + st); };
  auto v_empty = [&](int st) { return bars + 8 * (6 + 3 * kStages + st); };
  volatile int* work_slot =
      reinterpret_cast<int*>(smem_raw + (base - smem_u32(smem_raw)) + L::kSlots);

  const int T = p.T;
  const int nqb = (T + kItemRows - 1) / kItemRows;
  const int nkt = (T + kTileRows - 1) / kTileRows;
  const int n_work = nqb * p.H * p.B;
  // K/V tiles of a Q block: up to the diagonal, or all of T
  auto n_tiles = [&](int qb) { return p.causal ? min(nkt, 2 * qb + 2) : nkt; };
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int qs = 0; qs < 2; ++qs) {
      mbar_init(q_full(qs), 1);
      mbar_init(q_empty(qs), 128 * kConsumers);
    }
    mbar_init(o_full, 1);
    mbar_init(o_empty, 128 * kConsumers);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), 128 * kConsumers);
      mbar_init(v_empty(st), 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // As in the forward: a CTA's first item is its index, each later one the
  // next from the counter, passed to the consumers in the slot of its Q
  // buffer (n_work or more: stop). `n` counts this CTA's K/V tiles (ring
  // slot n % kStages), `j` its items (Q buffer j % 2, O phase j).
  if (wg == 0) {
    // ---- producer: one thread keeps the buffers and the ring full ----
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
        const Work wk(w, nqb, p.H * p.B, p.per_section);
        const int qb = nqb - 1 - wk.rank, h = wk.pair % p.H, b = wk.pair / p.H;
        const int kvh = h / p.G, nk = n_tiles(qb), q0 = qb * kItemRows;
        mbar_expect_tx(q_full(qs), 2 * L::kQTile);
        for (int hh = 0; hh < D / 64; ++hh) {
          tma_load_4d(q_tile(qs) + hh * kItemHalf, &tm_q, q_full(qs), hh * 64, h, q0, b);
          tma_load_4d(do_tile(qs) + hh * kItemHalf, &tm_do, q_full(qs), hh * 64, h, q0, b);
        }
        mbar_wait(o_empty, (j & 1) ^ 1);
        mbar_expect_tx(o_full, L::kQTile);
        for (int hh = 0; hh < D / 64; ++hh)
          tma_load_4d(o_tile + hh * kItemHalf, &tm_o, o_full, hh * 64, h, q0, b);
        for (int it = 0; it < nk; ++it, ++n) {
          const int st = n % kStages;
          const uint32_t free_parity = ((n / kStages) & 1) ^ 1;
          const int k0 = (nk - 1 - it) * kTileRows;  // from the diagonal down
          mbar_wait(k_empty(st), free_parity);
          mbar_expect_tx(k_full(st), L::kKTile);
          for (int hh = 0; hh < D / 64; ++hh)
            tma_load_4d(k_tile(st) + hh * kTileHalf, &tm_k, k_full(st), hh * 64, kvh, k0, b);
          mbar_wait(v_empty(st), free_parity);
          mbar_expect_tx(v_full(st), L::kKTile);
          for (int hh = 0; hh < D / 64; ++hh)
            tma_load_4d(v_tile(st) + hh * kTileHalf, &tm_v, v_full(st), hh * 64, kvh, k0, b);
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
  const int g = lane / 4;
  const int rl = 16 * warp + g;       // this thread's rows in the warpgroup's 64: +0, +8
  const int col_t = 2 * (lane % 4);   // and its columns in each n8 block: +0, +1

  float dq[D / 2], s[32], dp[32];
  uint32_t af[4][4];
  uint32_t n = 0;
  for (int j = 0;; ++j) {
    const int qs = j % 2;
    mbar_wait(q_full(qs), (j / 2) & 1);
    const int w = work_slot[qs];
    if (w >= n_work) break;
    const Work wk(w, nqb, p.H * p.B, p.per_section);
    const int qb = nqb - 1 - wk.rank, h = wk.pair % p.H, b = wk.pair / p.H;
    const int nk = n_tiles(qb), q0 = qb * kItemRows, row0 = q0 + 64 * c + rl;
    const long long bh = (long long)b * p.H + h;
    const uint32_t q_rows = q_tile(qs) + c * 64 * 128;  // this warpgroup's rows in each half
    const uint32_t do_rows = do_tile(qs) + c * 64 * 128;

    // delta = rowsum(O * dO) for this thread's two rows, the quad's four
    // threads taking every fourth 16-byte chunk; the row's lse in log2
    mbar_wait(o_full, j & 1);
    float dlt[2], lse2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rl + 8 * r;  // of the warpgroup's 64 (row % 8 == g)
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < D / 32; ++k) {
        const int cc = 4 * k + lane % 4;
        const uint32_t off = (cc / 8) * kItemHalf + row * 128 + (((cc % 8) ^ g) * 16);
        sum += dot8(ld_shared_v4(o_tile + c * 64 * 128 + off), ld_shared_v4(do_rows + off));
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      dlt[r] = sum;
      const int t = row0 + 8 * r;
      lse2[r] = t < T ? p.lse[bh * T + t] * kLog2e : INFINITY;  // padded rows: P = 0
      if (lane % 4 == 0 && t < T) p.delta[bh * T + t] = sum;
    }
    mbar_arrive(o_empty);

    zero(dq);
    for (int it = 0; it < nk; ++it, ++n) {
      const int st = n % kStages;
      const uint32_t parity = (n / kStages) & 1;
      const int k0 = (nk - 1 - it) * kTileRows;
      mbar_wait(k_full(st), parity);
      issue_ss<D>(s, q_rows, kItemHalf, k_tile(st));  // S = Q K^T
      mbar_wait(v_full(st), parity);
      issue_ss<D>(dp, do_rows, kItemHalf, v_tile(st));  // dP = dO V^T
      wgmma_wait<1>();
      reg_fence(s);
      // P = exp2(S s log2e - lse log2e), 0 above the diagonal
      const bool masked = p.causal && k0 + kTileRows - 1 > q0 + 64 * c;
      const int last = row0 - k0 - col_t;  // column offset of the last key row 0 sees
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        const float pr = ex2(s[i] * p.scale_log2 - lse2[r]);
        s[i] = masked && (i / 4) * 8 + (i & 1) > last + 8 * r ? 0.f : pr;
      }
      wgmma_wait<0>();
      reg_fence(dp);
      mbar_arrive(v_empty(st));
      // dS = P (dP - delta), the A operand of dQ += dS K
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= dp[i] - dlt[(i >> 1) & 1];
      pack_a<kTileRows>(s, af);
      reg_fence(dq);
      issue_rs<D>(dq, af, k_tile(st));
      wgmma_wait<0>();
      reg_fence(dq);
      reg_fence(af);
      mbar_arrive(k_empty(st));
    }

    // ---- epilogue: dQ s in bf16 over this warpgroup's Q rows (read for the
    // last time above), then out by TMA, which clips at T ----
    stage_rows<D>(q_rows, kItemHalf, dq, p.scale, warp, lane);
    fence_proxy_async();
    bar_sync_wg(1 + c);
    if (tid == 0) {
      for (int hh = 0; hh < D / 64; ++hh)
        tma_store_4d(&tm_dq, q_rows + hh * kItemHalf, hh * 64, h, q0 + 64 * c, b);
      tma_store_commit_and_wait_read();
    }
    mbar_arrive(q_empty(qs));  // thread 0 once its store has read the rows
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");  // stores done
}

// ---------------------------------------------------------------------------
// dK/dV: an item is 128 keys of one (kv head, batch)
// ---------------------------------------------------------------------------
template <int D>
struct DkdvLayout {
  static constexpr int kKTile = kItemRows * D * 2;  // a K or V tile, bytes
  static constexpr int kQTile = kTileRows * D * 2;  // a Q or dO tile
  static constexpr int kK = 0;                      // + buffer * kKTile
  static constexpr int kV = 2 * kKTile;             // + buffer * kKTile
  static constexpr int kQ = 4 * kKTile;             // + stage * kQTile
  static constexpr int kDo = kQ + kQStages * kQTile;  // + stage * kQTile
  // per stage: lse * log2e [64], then delta [64], fp32
  static constexpr int kRows = kDo + kQStages * kQTile;
  static constexpr int kBars = kRows + kQStages * 2 * kTileRows * 4;
  // kv_full[2], kv_empty[2], full[kQStages], empty[kQStages]
  static constexpr int kNumBars = 4 + 2 * kQStages;
  static constexpr int kSlots = kBars + 8 * kNumBars;  // int[2]: each K/V buffer's work item
  static constexpr int kSmem = 1024 + kSlots + 8;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_dk,
                          const __grid_constant__ CUtensorMap tm_dv, const BwdParams p) {
  using L = DkdvLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  auto k_tile = [&](int ks) { return base + L::kK + ks * L::kKTile; };
  auto v_tile = [&](int ks) { return base + L::kV + ks * L::kKTile; };
  auto q_tile = [&](int st) { return base + L::kQ + st * L::kQTile; };
  auto do_tile = [&](int st) { return base + L::kDo + st * L::kQTile; };
  auto lse_rows = [&](int st) { return base + L::kRows + st * 2 * kTileRows * 4; };
  const uint32_t bars = base + L::kBars;
  auto kv_full = [&](int ks) { return bars + 8 * ks; };
  auto kv_empty = [&](int ks) { return bars + 8 * (2 + ks); };
  auto full = [&](int st) { return bars + 8 * (4 + st); };
  auto empty = [&](int st) { return bars + 8 * (4 + kQStages + st); };
  volatile int* work_slot =
      reinterpret_cast<int*>(smem_raw + (base - smem_u32(smem_raw)) + L::kSlots);

  const int T = p.T;
  const int nkb = (T + kItemRows - 1) / kItemRows;
  const int nqt = (T + kTileRows - 1) / kTileRows;
  const int n_work = nkb * p.KV * p.B;
  // the first Q tile of a key block: at the diagonal, or 0
  auto first_tile = [&](int kb) { return p.causal ? kb * (kItemRows / kTileRows) : 0; };
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int ks = 0; ks < 2; ++ks) {
      mbar_init(kv_full(ks), 1);
      mbar_init(kv_empty(ks), 128 * kConsumers);
    }
    for (int st = 0; st < kQStages; ++st) {
      mbar_init(full(st), 1 + 32);  // the TMA thread and the lse warp
      mbar_init(empty(st), 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // `j` counts this CTA's items (K/V buffer j % 2), `n` its Q/dO tiles
  // (ring slot n % kQStages). The TMA thread claims each item and passes it
  // in the slot of its K/V buffer; the lse warp reads it there once the
  // buffer is full.
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (threadIdx.x == 0) {
      // ---- producer: K/V of each item, then its Q/dO tiles ----
      uint32_t n = 0;
      int w = blockIdx.x;
      for (int j = 0;; ++j) {
        const int ks = j % 2;
        mbar_wait(kv_empty(ks), ((j / 2) & 1) ^ 1);
        work_slot[ks] = w;
        if (w >= n_work) {
          mbar_arrive(kv_full(ks));
          break;
        }
        const Work wk(w, nkb, p.KV * p.B, p.per_section);
        const int kb = wk.rank, kvh = wk.pair % p.KV, b = wk.pair / p.KV;
        mbar_expect_tx(kv_full(ks), 2 * L::kKTile);
        for (int hh = 0; hh < D / 64; ++hh) {
          tma_load_4d(k_tile(ks) + hh * kItemHalf, &tm_k, kv_full(ks), hh * 64, kvh,
                      kb * kItemRows, b);
          tma_load_4d(v_tile(ks) + hh * kItemHalf, &tm_v, kv_full(ks), hh * 64, kvh,
                      kb * kItemRows, b);
        }
        for (int hq = 0; hq < p.G; ++hq) {
          const int h = kvh * p.G + hq;
          for (int qt = first_tile(kb); qt < nqt; ++qt, ++n) {
            const int st = n % kQStages;
            mbar_wait(empty(st), ((n / kQStages) & 1) ^ 1);
            mbar_expect_tx(full(st), 2 * L::kQTile);
            for (int hh = 0; hh < D / 64; ++hh) {
              tma_load_4d(q_tile(st) + hh * kTileHalf, &tm_q, full(st), hh * 64, h,
                          qt * kTileRows, b);
              tma_load_4d(do_tile(st) + hh * kTileHalf, &tm_do, full(st), hh * 64, h,
                          qt * kTileRows, b);
            }
          }
        }
        w = gridDim.x + atomicAdd(p.next_work, 1);
      }
    } else if (warp == 1) {
      // ---- the lse warp: each tile's lse (log2) and delta rows ----
      uint32_t n = 0;
      for (int j = 0;; ++j) {
        const int ks = j % 2;
        mbar_wait(kv_full(ks), (j / 2) & 1);
        const int w = work_slot[ks];
        if (w >= n_work) break;
        const Work wk(w, nkb, p.KV * p.B, p.per_section);
        const int kb = wk.rank, kvh = wk.pair % p.KV, b = wk.pair / p.KV;
        for (int hq = 0; hq < p.G; ++hq) {
          const long long bh = (long long)b * p.H + kvh * p.G + hq;
          for (int qt = first_tile(kb); qt < nqt; ++qt, ++n) {
            const int st = n % kQStages;
            mbar_wait(empty(st), ((n / kQStages) & 1) ^ 1);
            for (int r = lane; r < kTileRows; r += 32) {
              const int t = qt * kTileRows + r;
              st_shared_f32(lse_rows(st) + 4 * r, t < T ? p.lse[bh * T + t] * kLog2e : INFINITY);
              st_shared_f32(lse_rows(st) + 4 * (kTileRows + r), t < T ? p.delta[bh * T + t] : 0.f);
            }
            mbar_arrive(full(st));
          }
        }
      }
    }
    return;
  }

  // ---- consumers: 64 keys each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int kl = 16 * warp + lane / 4;  // this thread's keys in the warpgroup's 64: +0, +8
  const int col_t = 2 * (lane % 4);     // and its query columns in each n8 block: +0, +1

  float dk[D / 2], dv[D / 2], s[32], dp[32];
  uint32_t pf[4][4], sf[4][4];
  uint32_t n = 0;
  for (int j = 0;; ++j) {
    const int ks = j % 2;
    mbar_wait(kv_full(ks), (j / 2) & 1);
    const int w = work_slot[ks];
    if (w >= n_work) break;
    const Work wk(w, nkb, p.KV * p.B, p.per_section);
    const int kb = wk.rank, kvh = wk.pair % p.KV, b = wk.pair / p.KV;
    const int k0 = kb * kItemRows + 64 * c, key0 = k0 + kl;  // the warpgroup's first key, this thread's
    const uint32_t k_rows = k_tile(ks) + c * 64 * 128, v_rows = v_tile(ks) + c * 64 * 128;
    zero(dk);
    zero(dv);
    for (int hq = 0; hq < p.G; ++hq) {
      for (int qt = first_tile(kb); qt < nqt; ++qt, ++n) {
        const int st = n % kQStages;
        mbar_wait(full(st), (n / kQStages) & 1);
        issue_ss<D>(s, k_rows, kItemHalf, q_tile(st));    // S^T = K Q^T
        issue_ss<D>(dp, v_rows, kItemHalf, do_tile(st));  // dP^T = V dO^T
        wgmma_wait<1>();
        reg_fence(s);
        // P^T = exp2(S^T s log2e - lse log2e), lse along the columns; 0
        // where the key is past the query
        const int q0 = qt * kTileRows;
        const bool masked = p.causal && q0 < k0 + 63;
        const int first = key0 - q0 - col_t;  // column offset of the first query that key 0 sees
#pragma unroll
        for (int blk = 0; blk < 8; ++blk) {
          const float2 l2 = ld_shared_f2(lse_rows(st) + 4 * (8 * blk + col_t));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * blk + e, r = e >> 1;
            const float pr = ex2(s[i] * p.scale_log2 - ((e & 1) ? l2.y : l2.x));
            s[i] = masked && 8 * blk + (e & 1) < first + 8 * r ? 0.f : pr;
          }
        }
        pack_a<kTileRows>(s, pf);
        reg_fence(dv);
        issue_rs<D>(dv, pf, do_tile(st));  // dV += P^T dO
        wgmma_wait<1>();                   // dP^T is in
        reg_fence(dp);
        // dS^T = P^T (dP^T - delta), delta along the columns
#pragma unroll
        for (int blk = 0; blk < 8; ++blk) {
          const float2 d2 = ld_shared_f2(lse_rows(st) + 4 * (kTileRows + 8 * blk + col_t));
#pragma unroll
          for (int e = 0; e < 4; ++e) s[4 * blk + e] *= dp[4 * blk + e] - ((e & 1) ? d2.y : d2.x);
        }
        pack_a<kTileRows>(s, sf);
        reg_fence(dk);
        issue_rs<D>(dk, sf, q_tile(st));  // dK += dS^T Q
        wgmma_wait<0>();
        reg_fence(dv);
        reg_fence(dk);
        reg_fence(pf);
        reg_fence(sf);
        mbar_arrive(empty(st));
      }
    }

    // ---- epilogue: dK s and dV in bf16 over this warpgroup's K and V rows
    // (read for the last time above), then out by TMA, which clips at T ----
    stage_rows<D>(k_rows, kItemHalf, dk, p.scale, warp, lane);
    stage_rows<D>(v_rows, kItemHalf, dv, 1.f, warp, lane);
    fence_proxy_async();
    bar_sync_wg(1 + c);
    if (tid == 0) {
      for (int hh = 0; hh < D / 64; ++hh) {
        tma_store_4d(&tm_dk, k_rows + hh * kItemHalf, hh * 64, kvh, k0, b);
        tma_store_4d(&tm_dv, v_rows + hh * kItemHalf, hh * 64, kvh, k0, b);
      }
      tma_store_commit_and_wait_read();
    }
    mbar_arrive(kv_empty(ks));  // thread 0 once its stores have read the rows
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------
enum { Q_, K_, V_, O_, DO_, DQ_, DK_, DV_ };  // stride triples, [batch, time, head]

BwdParams make_params(const float* lse, float* delta, int* next_work, long long budget,
                      long long streamed_per_pair, int B, int T, int H, int KV, float scale,
                      int causal, int pairs) {
  BwdParams p;
  p.lse = lse;
  p.delta = delta;
  p.next_work = next_work;
  // (head, batch) pairs whose streamed tiles take at most `budget`
  // together, in sections of equal size: a short last section starts its
  // heaviest items last and leaves a tail (at gqa3b, sections of 10, 10, 10
  // and 2 kv heads made dK/dV 21% slower than 8 x 4: PERF.md §6)
  long long most = budget / (streamed_per_pair > 0 ? streamed_per_pair : 1);
  most = most < 1 ? 1 : most > pairs ? pairs : most;
  const long long sections = (pairs + most - 1) / most;
  p.per_section = (int)((pairs + sections - 1) / sections);
  p.B = B;
  p.T = T;
  p.H = H;
  p.KV = KV;
  p.G = H / KV;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal;
  return p;
}

// One CTA an SM, at most one item each to start with.
template <int D>
cudaError_t launch_dq(const CUtensorMap* maps, const BwdParams& p, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, DqLayout<D>::kSmem);
  if (attr != cudaSuccess) return attr;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int n_work = (p.T + kItemRows - 1) / kItemRows * p.H * p.B;
  flash_bwd_dq_kernel<D><<<n_work < sms ? n_work : sms, kThreads, DqLayout<D>::kSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkdv(const CUtensorMap* maps, const BwdParams& p, cudaStream_t stream) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           DkdvLayout<D>::kSmem);
  if (attr != cudaSuccess) return attr;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int n_work = (p.T + kItemRows - 1) / kItemRows * p.KV * p.B;
  flash_bwd_dkdv_kernel<D>
      <<<n_work < sms ? n_work : sms, kThreads, DkdvLayout<D>::kSmem, stream>>>(
          maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], p);
  return cudaGetLastError();
}

}  // namespace

// strides: 24 int64, [batch, time, head] for q, k, v, o, do, dq, dk, dv
// (unused tensors' entries are ignored). next_work: one int32 on the
// device, 0 at launch (the scheduler's counter). D must be 64 or 128.
// dQ of every query head, and delta = rowsum(o * do) [B, H, T] for dK/dV.
extern "C" int rt_flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                    const void* dout, void* dq, const float* lse, float* delta,
                                    int* next_work, const long long* strides, int B, int T, int H,
                                    int KV, int D, float scale, int causal, void* stream) {
  if (D != 64 && D != 128) return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  const long long* s = strides;
  CUtensorMap maps[6];  // q, k, v, o, do: loads; dq: a consumer's 64 rows a box
  CUresult r = make_map(encode, &maps[0], q, s + 3 * Q_, B, T, H, D, kItemRows);
  if (r == CUDA_SUCCESS) r = make_map(encode, &maps[1], k, s + 3 * K_, B, T, KV, D, kTileRows);
  if (r == CUDA_SUCCESS) r = make_map(encode, &maps[2], v, s + 3 * V_, B, T, KV, D, kTileRows);
  if (r == CUDA_SUCCESS) r = make_map(encode, &maps[3], o, s + 3 * O_, B, T, H, D, kItemRows);
  if (r == CUDA_SUCCESS) r = make_map(encode, &maps[4], dout, s + 3 * DO_, B, T, H, D, kItemRows);
  if (r == CUDA_SUCCESS) r = make_map(encode, &maps[5], dq, s + 3 * DQ_, B, T, H, D, 64);
  if (r != CUDA_SUCCESS) return -(1000 + static_cast<int>(r));
  // a query head's share of its kv head's K/V
  const long long kv_bytes = 2LL * T * D * sizeof(bf16) * KV / H;
  const BwdParams p =
      make_params(lse, delta, next_work, kDqL2Budget, kv_bytes, B, T, H, KV, scale, causal, B * H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch_dq<64>(maps, p, st) : launch_dq<128>(maps, p, st);
}

// dK, dV of every kv head; reads the delta that rt_flash_attn_bwd_dq wrote.
extern "C" int rt_flash_attn_bwd_dkdv(const void* q, const void* k, const void* v,
                                      const void* dout, void* dk, void* dv, const float* lse,
                                      const float* delta, int* next_work,
                                      const long long* strides, int B, int T, int H, int KV,
                                      int D, float scale, int causal, void* stream) {
  if (D != 64 && D != 128) return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  const long long* s = strides;
  CUtensorMap maps[6];  // q, k, v, do: loads; dk, dv: a consumer's 64 keys a box
  CUresult r = make_map(encode, &maps[0], q, s + 3 * Q_, B, T, H, D, kTileRows);
  if (r == CUDA_SUCCESS) r = make_map(encode, &maps[1], k, s + 3 * K_, B, T, KV, D, kItemRows);
  if (r == CUDA_SUCCESS) r = make_map(encode, &maps[2], v, s + 3 * V_, B, T, KV, D, kItemRows);
  if (r == CUDA_SUCCESS) r = make_map(encode, &maps[3], dout, s + 3 * DO_, B, T, H, D, kTileRows);
  if (r == CUDA_SUCCESS) r = make_map(encode, &maps[4], dk, s + 3 * DK_, B, T, KV, D, 64);
  if (r == CUDA_SUCCESS) r = make_map(encode, &maps[5], dv, s + 3 * DV_, B, T, KV, D, 64);
  if (r != CUDA_SUCCESS) return -(1000 + static_cast<int>(r));
  // the Q and dO of a kv head's G query heads
  const long long qdo_bytes = 2LL * T * D * sizeof(bf16) * (H / KV);
  const BwdParams p = make_params(lse, const_cast<float*>(delta), next_work, kDkdvL2Budget,
                                  qdo_bytes, B, T, H, KV, scale, causal, B * KV);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D == 64 ? launch_dkdv<64>(maps, p, st) : launch_dkdv<128>(maps, p, st);
}
