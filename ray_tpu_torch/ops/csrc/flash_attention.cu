// Causal flash attention backward for Hopper (sm_90a): dQ and dK/dV, bf16
// in, fp32 accumulation, on tensor cores through mma.sync.m16n8k16
// (bf16 x bf16 -> fp32). The forward, whose o and natural-log lse these
// kernels read, is in flash_attention_fwd.cu.
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
//     and dK/dV sums over the G query heads of a kv head inside one CTA,
//     so there are no atomics and no repeated K/V.
//   - sm_scale is applied in fp32 to the scores, as flash_attention and
//     dense_attention do; splash pre-scales q in bf16 (llama.py:348).
//   - di = rowsum(O * dO) is folded into the dQ kernel (JAX computes it in
//     XLA, splash :2285, flash :273); the dK/dV kernel reads it back.
//
// Layouts: q/o/do/dq [B, T, H, D], k/v/dk/dv [B, T, KV, D], read and
// written through their batch/time/head strides (the head_dim stride is 1;
// the wrapper checks 16-byte alignment); lse and delta fp32 [B, H, T].
//
// Bound, at the training path's shapes (B 4, H 16, T 2048, D 128, causal):
// the backward does 2.5x the forward's 6.88e10 FLOPs as a function (S, dP,
// dV, dK, dQ), 174 us at 989 TFLOP/s; as two kernels it recomputes S and
// dP once more. The design aims at the tensor cores and at skipping work:
//   - dQ: one CTA of 4 warps per (b, h, 64-row Q block); each warp owns 16
//     rows and keeps its S, dP and dQ tiles in mma.sync registers (dS feeds
//     the dS K product straight from the accumulator);
//   - dK/dV: one CTA per (b, kv head, 64-key block), looping over the G
//     query heads and the 32-row Q blocks at or below the diagonal;
//   - K/V (dQ) and Q/dO (dK/dV) tiles in shared memory, double-buffered
//     with cp.async so the next tile loads while this one computes; rows
//     padded by 16 bytes so ldmatrix reads are free of bank conflicts;
//   - causal: blocks past the diagonal are never loaded, and only the
//     diagonal and the ragged last block are masked.
// wgmma, TMA and warp specialisation, as the forward uses them, are later
// work here.
//
// C interface (loaded with ctypes): each entry point returns
// cudaGetLastError() after its launch, so a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;   // 4 warps
constexpr int kBlockQ = 64;     // query rows per CTA (dQ): 16 a warp
constexpr int kBlockK = 64;     // keys per tile (dQ) and per CTA (dK/dV)
constexpr int kBwdBlockQ = 32;  // query rows per tile in dK/dV
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// strides, in elements, of [batch, time, head]; head_dim stride is 1
enum { Q_, K_, V_, O_, DO_, DQ_, DK_, DV_, kTensors };

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;  // the forward's output
  const bf16* dout;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* lse;
  float* delta;
  long long s[kTensors][3];
  int B, T, H, KV, G;
  float scale, scale_log2;
  int causal;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (the ragged edge)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c[16x8] += a[16x16] * b[16x8], bf16 operands, fp32 accumulator
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment loads from a row-major shared tile with row stride S elements.
// A operand, rows [r0, r0+16) x cols [c0, c0+16).
template <int S>
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* tile, int r0, int c0, int lane) {
  ldsm_x4(a, smem_u32(tile + (r0 + (lane & 15)) * S + c0 + ((lane >> 4) << 3)));
}
// B operands of two n8 tiles from a tile stored [n][k] (B = tile^T):
// n [n0, n0+16), k [k0, k0+16). b[0..1]: n0..n0+7, b[2..3]: n0+8..n0+15.
template <int S>
__device__ __forceinline__ void load_b_nk(uint32_t* b, const bf16* tile, int n0, int k0, int lane) {
  ldsm_x4(b, smem_u32(tile + (n0 + ((lane >> 4) << 3) + (lane & 7)) * S + k0 +
                      (((lane >> 3) & 1) << 3)));
}
// B operands of two n8 tiles from a tile stored [k][n] (B = tile).
template <int S>
__device__ __forceinline__ void load_b_kn(uint32_t* b, const bf16* tile, int k0, int n0, int lane) {
  ldsm_x4_trans(b, smem_u32(tile + (k0 + (((lane >> 3) & 1) << 3) + (lane & 7)) * S + n0 +
                            ((lane >> 4) << 3)));
}

// Rows [t0, t0+ROWS) of one (batch, head) slice -> shared [ROWS][D+8];
// rows at or past T are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* smem, const bf16* base, long long s_t, int t0,
                                          int T) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  static_assert(ROWS * kChunks % kThreads == 0, "tile must split evenly over the CTA");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const int t = t0 + r;
    const bool ok = t < T;
    cp_async16(smem_u32(smem + r * (D + 8) + col), ok ? base + t * s_t + col : base, ok);
  }
}

template <int D>
__device__ __forceinline__ void store_rows(bf16* base, long long s_t, int row, int T,
                                           const float (*acc)[4], int half, float mul, int tig) {
  if (row >= T) return;
  bf16* dst = base + row * s_t + tig * 2;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    *reinterpret_cast<uint32_t*>(dst + dt * 8) =
        pack_bf16(acc[dt][2 * half] * mul, acc[dt][2 * half + 1] * mul);
  }
}

// ---------------------------------------------------------------------------
// Backward dQ (and delta = rowsum(O * dO)): one CTA per (64-row Q block, h, b).
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const Params p) {
  constexpr int S = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + kBlockQ * S;
  bf16* sK = sdO + kBlockQ * S;  // [2][kBlockK][S]; sK[1] holds O at first
  bf16* sV = sK + 2 * kBlockK * S;
  float* sLse = reinterpret_cast<float*>(sV + 2 * kBlockK * S);
  float* sDelta = sLse + kBlockQ;

  const int qb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / p.G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int T = p.T, q0 = qb * kBlockQ;
  const long long bh = (long long)b * p.H + h;

  const bf16* kbase = p.k + b * p.s[K_][0] + kvh * p.s[K_][2];
  const bf16* vbase = p.v + b * p.s[V_][0] + kvh * p.s[V_][2];
  const int nk_all = (T + kBlockK - 1) / kBlockK;
  const int nk = p.causal ? min(nk_all, (q0 + kBlockQ - 1) / kBlockK + 1) : nk_all;

  load_tile<D, kBlockQ>(sQ, p.q + b * p.s[Q_][0] + h * p.s[Q_][2], p.s[Q_][1], q0, T);
  load_tile<D, kBlockQ>(sdO, p.dout + b * p.s[DO_][0] + h * p.s[DO_][2], p.s[DO_][1], q0, T);
  load_tile<D, kBlockQ>(sK + kBlockK * S, p.o + b * p.s[O_][0] + h * p.s[O_][2], p.s[O_][1], q0,
                        T);
  load_tile<D, kBlockK>(sK, kbase, p.s[K_][1], 0, T);
  load_tile<D, kBlockK>(sV, vbase, p.s[V_][1], 0, T);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  {  // delta for this block's rows, 2 threads a row; padded rows read 0
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    const bf16* orow = sK + kBlockK * S + r * S + half * (D / 2);
    const bf16* drow = sdO + r * S + half * (D / 2);
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < D / 2; c += 2) {
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(orow + c));
      const float2 d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(drow + c));
      sum += a.x * d.x + a.y * d.y;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const int row = q0 + r;
    if (half == 0) {
      sDelta[r] = sum;
      sLse[r] = row < T ? p.lse[bh * T + row] * kLog2e : INFINITY;
      if (row < T) p.delta[bh * T + row] = sum;
    }
  }
  __syncthreads();
  const int rl = warp * 16 + g;  // this thread's rows in the block: rl, rl + 8
  const float lse2[2] = {sLse[rl], sLse[rl + 8]};
  const float dlt[2] = {sDelta[rl], sDelta[rl + 8]};
  const int row0 = q0 + rl;

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int it = 0; it < nk; ++it) {
    if (it > 0) cp_async_wait_all();
    __syncthreads();
    if (it + 1 < nk) {
      const int nb = (it + 1) & 1;
      load_tile<D, kBlockK>(sK + nb * kBlockK * S, kbase, p.s[K_][1], (it + 1) * kBlockK, T);
      load_tile<D, kBlockK>(sV + nb * kBlockK * S, vbase, p.s[V_][1], (it + 1) * kBlockK, T);
      cp_async_commit();
    }
    const bf16* tK = sK + (it & 1) * kBlockK * S;
    const bf16* tV = sV + (it & 1) * kBlockK * S;
    const int k0 = it * kBlockK;

    float s[kBlockK / 8][4], dp[kBlockK / 8][4];
#pragma unroll
    for (int i = 0; i < kBlockK / 8; ++i) {
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t qa[4], da[4];
      load_a<S>(qa, sQ, warp * 16, ks * 16, lane);
      load_a<S>(da, sdO, warp * 16, ks * 16, lane);
#pragma unroll
      for (int np = 0; np < kBlockK / 16; ++np) {
        uint32_t bf[4];
        load_b_nk<S>(bf, tK, np * 16, ks * 16, lane);
        mma(s[2 * np], qa, bf[0], bf[1]);
        mma(s[2 * np + 1], qa, bf[2], bf[3]);
        load_b_nk<S>(bf, tV, np * 16, ks * 16, lane);
        mma(dp[2 * np], da, bf[0], bf[1]);
        mma(dp[2 * np + 1], da, bf[2], bf[3]);
      }
    }
    const bool masked = (p.causal && k0 + kBlockK - 1 > q0) || k0 + kBlockK > T;
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float pr = exp2f(s[nt][e] * p.scale_log2 - lse2[r]);
        if (masked) {
          const int col = k0 + nt * 8 + tig * 2 + (e & 1);
          if (col >= T || (p.causal && col > row0 + r * 8)) pr = 0.f;
        }
        s[nt][e] = pr * (dp[nt][e] - dlt[r]);  // dS
      }
    }
    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t a[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]), pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp2 = 0; dp2 < D / 16; ++dp2) {
        uint32_t bf[4];
        load_b_kn<S>(bf, tK, kk * 16, dp2 * 16, lane);
        mma(acc[2 * dp2], a, bf[0], bf[1]);
        mma(acc[2 * dp2 + 1], a, bf[2], bf[3]);
      }
    }
  }
  bf16* base = p.dq + b * p.s[DQ_][0] + h * p.s[DQ_][2];
  store_rows<D>(base, p.s[DQ_][1], row0, T, acc, 0, p.scale, tig);
  store_rows<D>(base, p.s[DQ_][1], row0 + 8, T, acc, 1, p.scale, tig);
}

// ---------------------------------------------------------------------------
// Backward dK/dV: one CTA per (64-key block, kv head, b); loops over the G
// query heads of the kv head and the 32-row Q blocks at or below the
// diagonal, accumulating in registers (no atomics).
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(const Params p) {
  constexpr int S = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kBlockK * S;
  bf16* sQ = sV + kBlockK * S;        // [2][kBwdBlockQ][S]
  bf16* sdO = sQ + 2 * kBwdBlockQ * S;  // [2][kBwdBlockQ][S]
  float* sLse = reinterpret_cast<float*>(sdO + 2 * kBwdBlockQ * S);  // [2][kBwdBlockQ]
  float* sDelta = sLse + 2 * kBwdBlockQ;                               // [2][kBwdBlockQ]

  const int kb = blockIdx.x;  // low key blocks see the most queries: first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int T = p.T, k0 = kb * kBlockK;
  const int nq_all = (T + kBwdBlockQ - 1) / kBwdBlockQ;
  const int qb_first = p.causal ? k0 / kBwdBlockQ : 0;
  const int per_head = nq_all - qb_first;
  const int n_it = p.G * per_head;

  load_tile<D, kBlockK>(sK, p.k + b * p.s[K_][0] + kvh * p.s[K_][2], p.s[K_][1], k0, T);
  load_tile<D, kBlockK>(sV, p.v + b * p.s[V_][0] + kvh * p.s[V_][2], p.s[V_][1], k0, T);

  // Q, dO tiles and lse/delta rows of iteration i into buffer i & 1
  auto load_q = [&](int i) {
    const int h = kvh * p.G + i / per_head;
    const int qs = (qb_first + i % per_head) * kBwdBlockQ;
    const int nb = i & 1;
    load_tile<D, kBwdBlockQ>(sQ + nb * kBwdBlockQ * S, p.q + b * p.s[Q_][0] + h * p.s[Q_][2],
                             p.s[Q_][1], qs, T);
    load_tile<D, kBwdBlockQ>(sdO + nb * kBwdBlockQ * S,
                             p.dout + b * p.s[DO_][0] + h * p.s[DO_][2], p.s[DO_][1], qs, T);
    if (threadIdx.x < kBwdBlockQ) {
      const int row = qs + threadIdx.x;
      const long long bh = (long long)b * p.H + h;
      sLse[nb * kBwdBlockQ + threadIdx.x] = row < T ? p.lse[bh * T + row] * kLog2e : INFINITY;
      sDelta[nb * kBwdBlockQ + threadIdx.x] = row < T ? p.delta[bh * T + row] : 0.f;
    }
  };
  if (n_it > 0) load_q(0);
  cp_async_commit();

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < n_it) {
      load_q(it + 1);
      cp_async_commit();
    }
    const int qs = (qb_first + it % per_head) * kBwdBlockQ;
    const bf16* tQ = sQ + (it & 1) * kBwdBlockQ * S;
    const bf16* tdO = sdO + (it & 1) * kBwdBlockQ * S;
    const float* tL = sLse + (it & 1) * kBwdBlockQ;
    const float* tD = sDelta + (it & 1) * kBwdBlockQ;

    // S^T = K Q^T and dP^T = V dO^T: [16 keys x 32 queries] a warp
    float st[kBwdBlockQ / 8][4], dpt[kBwdBlockQ / 8][4];
#pragma unroll
    for (int i = 0; i < kBwdBlockQ / 8; ++i) {
      st[i][0] = st[i][1] = st[i][2] = st[i][3] = 0.f;
      dpt[i][0] = dpt[i][1] = dpt[i][2] = dpt[i][3] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t ka[4], va[4];
      load_a<S>(ka, sK, warp * 16, ks * 16, lane);
      load_a<S>(va, sV, warp * 16, ks * 16, lane);
#pragma unroll
      for (int np = 0; np < kBwdBlockQ / 16; ++np) {
        uint32_t bf[4];
        load_b_nk<S>(bf, tQ, np * 16, ks * 16, lane);
        mma(st[2 * np], ka, bf[0], bf[1]);
        mma(st[2 * np + 1], ka, bf[2], bf[3]);
        load_b_nk<S>(bf, tdO, np * 16, ks * 16, lane);
        mma(dpt[2 * np], va, bf[0], bf[1]);
        mma(dpt[2 * np + 1], va, bf[2], bf[3]);
      }
    }
    const bool masked = (p.causal && qs < k0 + kBlockK - 1) || qs + kBwdBlockQ > T ||
                        k0 + kBlockK > T;
#pragma unroll
    for (int nt = 0; nt < kBwdBlockQ / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = nt * 8 + tig * 2 + (e & 1);
        float pr = exp2f(st[nt][e] * p.scale_log2 - tL[ql]);
        if (masked) {
          const int key = key0 + (e >> 1) * 8, row = qs + ql;
          if (row >= T || key >= T || (p.causal && key > row)) pr = 0.f;
        }
        st[nt][e] = pr;                            // P^T
        dpt[nt][e] = pr * (dpt[nt][e] - tD[ql]);  // dS^T
      }
    }
    // dV += P^T dO, dK += dS^T Q
#pragma unroll
    for (int kk = 0; kk < kBwdBlockQ / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(st[2 * kk][0], st[2 * kk][1]), pack_bf16(st[2 * kk][2], st[2 * kk][3]),
          pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
          pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
      const uint32_t sa[4] = {
          pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]), pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
          pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
          pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
      for (int dp2 = 0; dp2 < D / 16; ++dp2) {
        uint32_t bf[4];
        load_b_kn<S>(bf, tdO, kk * 16, dp2 * 16, lane);
        mma(dv[2 * dp2], pa, bf[0], bf[1]);
        mma(dv[2 * dp2 + 1], pa, bf[2], bf[3]);
        load_b_kn<S>(bf, tQ, kk * 16, dp2 * 16, lane);
        mma(dk[2 * dp2], sa, bf[0], bf[1]);
        mma(dk[2 * dp2 + 1], sa, bf[2], bf[3]);
      }
    }
  }
  bf16* dkb = p.dk + b * p.s[DK_][0] + kvh * p.s[DK_][2];
  bf16* dvb = p.dv + b * p.s[DV_][0] + kvh * p.s[DV_][2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    store_rows<D>(dkb, p.s[DK_][1], key0 + r * 8, T, dk, r, p.scale, tig);
    store_rows<D>(dvb, p.s[DV_][1], key0 + r * 8, T, dv, r, 1.f, tig);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------
template <int D>
constexpr int dq_smem() { return (2 * kBlockQ + 4 * kBlockK) * (D + 8) * 2 + 2 * kBlockQ * 4; }
template <int D>
constexpr int dkdv_smem() {
  return (2 * kBlockK + 4 * kBwdBlockQ) * (D + 8) * 2 + 4 * kBwdBlockQ * 4;
}

// Opt in to more than 48 KB of dynamic shared memory, once per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  static const cudaError_t attr = allow_smem(flash_bwd_dq_kernel<D>, dq_smem<D>());
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.T + kBlockQ - 1) / kBlockQ, p.H, p.B);
  flash_bwd_dq_kernel<D><<<grid, kThreads, dq_smem<D>(), stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkdv(const Params& p, cudaStream_t stream) {
  static const cudaError_t attr = allow_smem(flash_bwd_dkdv_kernel<D>, dkdv_smem<D>());
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.T + kBlockK - 1) / kBlockK, p.KV, p.B);
  flash_bwd_dkdv_kernel<D><<<grid, kThreads, dkdv_smem<D>(), stream>>>(p);
  return cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   void* dq, void* dk, void* dv, float* lse, float* delta,
                   const long long* strides, int B, int T, int H, int KV, float scale,
                   int causal) {
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<const bf16*>(o);
  p.dout = static_cast<const bf16*>(dout);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.lse = lse;
  p.delta = delta;
  for (int t = 0; t < kTensors; ++t)
    for (int i = 0; i < 3; ++i) p.s[t][i] = strides[3 * t + i];
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

}  // namespace

// strides: 24 int64, [batch, time, head] for q, k, v, o, do, dq, dk, dv
// (unused tensors' entries are ignored). D must be 64 or 128.
// dQ of every query head, and delta = rowsum(o * do) [B, H, T] for dK/dV.
extern "C" int rt_flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                    const void* dout, void* dq, const float* lse, float* delta,
                                    const long long* strides, int B, int T, int H, int KV, int D,
                                    float scale, int causal, void* stream) {
  const Params p = make_params(q, k, v, o, dout, dq, nullptr, nullptr,
                               const_cast<float*>(lse), delta, strides, B, T, H, KV, scale,
                               causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_dq<64>(p, s);
  if (D == 128) return launch_dq<128>(p, s);
  return cudaErrorInvalidValue;
}

// dK, dV of every kv head; reads the delta that rt_flash_attn_bwd_dq wrote.
extern "C" int rt_flash_attn_bwd_dkdv(const void* q, const void* k, const void* v,
                                      const void* dout, void* dk, void* dv, const float* lse,
                                      const float* delta, const long long* strides, int B, int T,
                                      int H, int KV, int D, float scale, int causal,
                                      void* stream) {
  const Params p = make_params(q, k, v, nullptr, dout, nullptr, dk, dv,
                               const_cast<float*>(lse), const_cast<float*>(delta), strides, B, T,
                               H, KV, scale, causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_dkdv<64>(p, s);
  if (D == 128) return launch_dkdv<128>(p, s);
  return cudaErrorInvalidValue;
}
