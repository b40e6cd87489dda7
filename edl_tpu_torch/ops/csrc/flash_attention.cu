// Flash attention for NVIDIA Hopper (sm_90a): the forward kernel and the two
// backward kernels, behind a plain C interface that Python loads with ctypes.
//
// They replace the three Pallas TPU kernels of edl_tpu/ops/flash_attention.py
// and compute the same functions:
//
//   flash_fwd_kernel      <- _fwd_kernel      O = softmax(Q Kᵀ · scale) V and lse = m + log l
//   flash_bwd_dq_kernel   <- _bwd_dq_kernel   dQ = Σ_k dS K
//   flash_bwd_dkv_kernel  <- _bwd_dkv_kernel  dV = Σ_q Pᵀ dO,  dK = Σ_q dSᵀ Q
//
// with P = exp(S − lse) recomputed from the forward's lse and
// dS = P ∘ (dO Vᵀ − delta) · scale, delta = rowsum(dO ∘ O) − dlse computed by
// the caller in plain PyTorch, as the JAX package computes it outside Pallas,
// from the same bf16 dO that these kernels read.
//
// Semantics kept from the TPU kernels:
//  * q, k, v are (B, S, H, D) views with unit stride along D. The kernels read
//    them through their batch, sequence and head strides, so the q/k/v slices
//    of the model's fused (B, S, 3, H, D) projection are never copied. dO, O,
//    dQ, dK and dV are contiguous (B, S, H, D); lse and delta are (B, H, Sq) f32.
//  * Causality is evaluated in GLOBAL positions: key j is visible to query i
//    iff k_offset + j <= q_offset + i. Key tiles wholly in a query tile's
//    causal future are skipped (and, in dkv, query tiles wholly in its past).
//  * The ragged edge is masked in the kernel: keys at or beyond Sk never count,
//    query rows at or beyond Sq are never written. Nothing is padded by copy.
//  * Masked scores carry the finite sentinel -1e30 (_NEG_INF), and every exp()
//    is masked through the validity bit, never through the score: a row that
//    sees no key ends with its running max exactly on the sentinel, where
//    exp(s − m) would be 1. Such a row gets O = 0 and lse = -1e30 exactly,
//    which the ring's logaddexp merge relies on.
//  * Scores, softmax statistics and accumulators are f32.
//
// Precision: every product runs on the tensor cores as mma.sync m16n8k16 with
// bf16 operands and f32 accumulation. Q·Kᵀ and dO·Vᵀ take the bf16 inputs as
// they are, which is exact up to summation order, as on the TPU. P and dS are
// rounded to bf16 before P·V, Pᵀ·dO, dS·K and dSᵀ·Q, where the Pallas kernels
// multiply in f32: one bf16 rounding (relative 2^-9) per term, which the bf16
// tolerances against the plain PyTorch versions cover.
//
// Design, this first version: each thread block has 4 warps and owns one
// 64-row tile (queries in fwd and dq, keys in dkv) of one (batch, head); each
// warp owns 16 of its rows and keeps their operand fragments and f32
// accumulators in registers. The TPU grid's sequential third axis, which
// carried m, l and the accumulators from one grid step to the next, is a loop
// inside the block over 64-row tiles of the other operand, staged in shared
// memory (rows padded by 8 bf16 so the fragment loads spread over all banks).
// dkv runs key-tile outer, query-tile inner, so no atomics are needed and the
// result is deterministic. Not yet done: TMA, wgmma, double buffering and
// warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;          // rows per thread block and per inner tile
constexpr int kWarps = 4;          // each warp owns 16 rows of the block's tile
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;            // bf16 padding per shared-memory row
constexpr float kNegInf = -1e30f;  // the TPU kernels' _NEG_INF sentinel

struct Strides {  // element strides of a (B, S, H, D) view; D has unit stride
  long long b, s, h;
};

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Columns d and d + 1 of row `row`; zero outside [0, n_rows) x [0, D).
__device__ __forceinline__ uint32_t ld_pair(const bf16* base, long long row_stride,
                                            int row, int n_rows, int d, int D) {
  if (row >= n_rows || d >= D) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + row * row_stride + d);
}

// Rows [row0, row0 + kTile) of a (S, D) slice into shared memory, laid out as
// kTile x (DP + kPad) and zero-filled past the ragged edge and past D.
template <int DP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base, long long row_stride,
                                          int row0, int n_rows, int D) {
  constexpr int kPairs = DP / 2;
  for (int i = threadIdx.x; i < kTile * kPairs; i += kThreads) {
    const int r = i / kPairs, c = (i % kPairs) * 2;
    *reinterpret_cast<uint32_t*>(dst + r * (DP + kPad) + c) =
        ld_pair(base, row_stride, row0 + r, n_rows, c, D);
  }
}

// One warp's A operand: rows [row0, row0 + 16) x DP, row-major, from global memory.
template <int DP>
__device__ __forceinline__ void load_a(uint32_t (&a)[DP / 16][4], const bf16* base,
                                       long long row_stride, int row0, int n_rows, int D) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int d = kk * 16 + 2 * t;
    a[kk][0] = ld_pair(base, row_stride, row0 + g, n_rows, d, D);
    a[kk][1] = ld_pair(base, row_stride, row0 + g + 8, n_rows, d, D);
    a[kk][2] = ld_pair(base, row_stride, row0 + g, n_rows, d + 8, D);
    a[kk][3] = ld_pair(base, row_stride, row0 + g + 8, n_rows, d + 8, D);
  }
}

// B operand of X·Yᵀ with Y in shared memory as [n][k]: Y[n][k], Y[n][k + 1].
__device__ __forceinline__ uint32_t lds_nk(const bf16* s, int ld, int n, int k) {
  return *reinterpret_cast<const uint32_t*>(s + n * ld + k);
}

// B operand of X·Y with Y in shared memory as [k][n]: Y[k][n], Y[k + 1][n].
__device__ __forceinline__ uint32_t lds_kn(const bf16* s, int ld, int k, int n) {
  __nv_bfloat162 v;
  v.x = s[k * ld + n];
  v.y = s[(k + 1) * ld + n];
  return *reinterpret_cast<uint32_t*>(&v);
}

// c (16 x 8·NT, accumulator layout) += A (16 x DP) · Yᵀ, Y = NT·8 rows of DP in smem.
template <int DP, int NT>
__device__ __forceinline__ void mma_abt(float (&c)[NT][4], const uint32_t (&a)[DP / 16][4],
                                        const bf16* s) {
  constexpr int ld = DP + kPad;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      mma16816(c[j], a[kk], lds_nk(s, ld, j * 8 + g, kk * 16 + 2 * t),
               lds_nk(s, ld, j * 8 + g, kk * 16 + 2 * t + 8));
    }
  }
}

// c (16 x DP) += P (16 x kTile, f32 in accumulator layout, rounded to bf16 here)
// · Y (kTile x DP in smem as [k][n]). The accumulator layout of P is the A
// operand's layout, so P never leaves registers.
template <int DP>
__device__ __forceinline__ void mma_pv(float (&c)[DP / 8][4], const float (&p)[kTile / 8][4],
                                       const bf16* s) {
  constexpr int ld = DP + kPad;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    const uint32_t a[4] = {
        pack_bf16(p[2 * kk][0], p[2 * kk][1]), pack_bf16(p[2 * kk][2], p[2 * kk][3]),
        pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]), pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      mma16816(c[i], a, lds_kn(s, ld, kk * 16 + 2 * t, i * 8 + g),
               lds_kn(s, ld, kk * 16 + 2 * t + 8, i * 8 + g));
    }
  }
}

// Key tiles [0, n) holding a key that some row of the query tile at local row
// q0 can see.
__device__ __forceinline__ int key_tiles(int Sk, int q0, int q_offset, int k_offset, int causal) {
  int n = (Sk + kTile - 1) / kTile;
  if (causal) {
    const long long last = (long long)q_offset + q0 + kTile - 1 - k_offset;  // last visible key
    const long long lim = last < 0 ? 0 : last / kTile + 1;
    if (lim < n) n = (int)lim;
  }
  return n;
}

// The first query tile that sees some key of the key tile at local key k0.
__device__ __forceinline__ int first_query_tile(int k0, int q_offset, int k_offset, int causal) {
  if (!causal) return 0;
  const long long need = (long long)k_offset + k0 - q_offset - (kTile - 1);
  return need <= 0 ? 0 : (int)((need + kTile - 1) / kTile);
}

// -- forward ------------------------------------------------------------------
//
// Replaces _fwd_kernel of edl_tpu/ops/flash_attention.py.
// Bound on the H100: at head_dim 64 it does 4·D = 256 FLOPs per visible
// (query, key) pair against 8·D bytes per row moved, so a 1024-token causal
// sequence sits near the ridge (~15 µs of bytes and ~13 µs of bf16 FLOPs for
// the slice's 96 heads). The design keeps S and P in registers (the (S, S)
// matrix never reaches device memory), reads each K/V tile once per 64 query
// rows, and skips causal-future tiles, so device memory traffic stays
// O(S·D) per query tile.
template <int DP>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    void* __restrict__ o, float* __restrict__ lse, int H, int Sq, int Sk, int D,
    Strides qs, Strides ks, Strides vs, int q_offset, int k_offset, float scale, int causal,
    int out_f32) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = DP + kPad;
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + kTile * ld;

  const int n_qt = (Sq + kTile - 1) / kTile;
  const int bh = blockIdx.x / n_qt, qt = blockIdx.x % n_qt;
  const int b = bh / H, h = bh % H;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = qt * kTile + (threadIdx.x >> 5) * 16;  // this warp's first query row
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;

  uint32_t qa[DP / 16][4];
  load_a<DP>(qa, qb, qs.s, row0, Sq, D);
  float acc[DP / 8][4];
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // rows g and g + 8
  const int qpos = q_offset + row0 + g;                 // global position of row g

  const int n_kt = key_tiles(Sk, qt * kTile, q_offset, k_offset, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile<DP>(sk, kb, ks.s, kt * kTile, Sk, D);
    load_tile<DP>(sv, vb, vs.s, kt * kTile, Sk, D);
    __syncthreads();

    float s[kTile / 8][4];
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mma_abt<DP, kTile / 8>(s, qa, sk);

    uint32_t valid = 0;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int key = kt * kTile + j * 8 + 2 * t + (e & 1);
        const bool ok = key < Sk && (!causal || k_offset + key <= qpos + 8 * r);
        s[j][e] = ok ? s[j][e] * scale : kNegInf;
        valid |= (uint32_t)ok << (j * 4 + e);
        mx[r] = fmaxf(mx[r], s[j][e]);
      }
    }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
    const float alpha[2] = {expf(m[0] - mx[0]), expf(m[1] - mx[1])};
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = (valid >> (j * 4 + e)) & 1u ? expf(s[j][e] - mx[r]) : 0.f;
        s[j][e] = p;
        rs[r] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * alpha[r] + rs[r];  // per-thread partial sum; reduced once at the end
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }
    mma_pv<DP>(acc, s, sv);
  }

  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= Sq) continue;
    const float safe = l[r] > 0.f ? l[r] : 1.f;  // a row with no key: acc is 0, so O = 0
    const long long base = (((long long)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int d = i * 8 + 2 * t;
      if (d >= D) continue;
      const float x0 = acc[i][2 * r] / safe, x1 = acc[i][2 * r + 1] / safe;
      if (out_f32) {
        *reinterpret_cast<float2*>(static_cast<float*>(o) + base + d) = make_float2(x0, x1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(o) + base + d) =
            __floats2bfloat162_rn(x0, x1);
      }
    }
    if (t == 0) lse[(long long)bh * Sq + row] = l[r] > 0.f ? m[r] + logf(safe) : kNegInf;
  }
}

// -- backward: dQ -------------------------------------------------------------
//
// Replaces _bwd_dq_kernel of edl_tpu/ops/flash_attention.py.
// Bound on the H100: 6·D FLOPs per visible pair (S, dP and dQ products)
// against 10·D bytes per row (q, k, v, dO in, dQ out): at the slice's shape
// about as much bytes time as FLOP time (~19-20 µs each). One block per
// (batch·head, 64 query rows) holds Q, dO, lse and delta for its rows in
// registers and streams K and V tiles through shared memory up to the causal
// limit; dQ accumulates in f32 registers and is written once.
template <int DP>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int H, int Sq, int Sk, int D,
    Strides qs, Strides ks, Strides vs, int q_offset, int k_offset, float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = DP + kPad;
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + kTile * ld;

  const int n_qt = (Sq + kTile - 1) / kTile;
  const int bh = blockIdx.x / n_qt, qt = blockIdx.x % n_qt;
  const int b = bh / H, h = bh % H;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = qt * kTile + (threadIdx.x >> 5) * 16;
  const Strides os = {(long long)Sq * H * D, (long long)H * D, D};  // dO and dQ: contiguous
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;

  uint32_t qa[DP / 16][4], da[DP / 16][4];
  load_a<DP>(qa, q + b * qs.b + h * qs.h, qs.s, row0, Sq, D);
  load_a<DP>(da, dout + b * os.b + h * os.h, os.s, row0, Sq, D);
  float lrow[2], drow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    lrow[r] = row < Sq ? lse[(long long)bh * Sq + row] : 0.f;
    drow[r] = row < Sq ? delta[(long long)bh * Sq + row] : 0.f;
  }
  float acc[DP / 8][4];
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  const int qpos = q_offset + row0 + g;

  const int n_kt = key_tiles(Sk, qt * kTile, q_offset, k_offset, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_tile<DP>(sk, kb, ks.s, kt * kTile, Sk, D);
    load_tile<DP>(sv, vb, vs.s, kt * kTile, Sk, D);
    __syncthreads();

    float s[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
    mma_abt<DP, kTile / 8>(s, qa, sk);   // S = Q Kᵀ
    mma_abt<DP, kTile / 8>(dp, da, sv);  // dP = dO Vᵀ
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int key = kt * kTile + j * 8 + 2 * t + (e & 1);
        const bool ok = key < Sk && (!causal || k_offset + key <= qpos + 8 * r);
        const float p = ok ? expf(s[j][e] * scale - lrow[r]) : 0.f;
        s[j][e] = p * (dp[j][e] - drow[r]) * scale;  // dS
      }
    }
    mma_pv<DP>(acc, s, sk);  // dQ += dS K
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= Sq) continue;
    const long long base = (((long long)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int d = i * 8 + 2 * t;
      if (d < D) {
        *reinterpret_cast<__nv_bfloat162*>(dq + base + d) =
            __floats2bfloat162_rn(acc[i][2 * r], acc[i][2 * r + 1]);
      }
    }
  }
}

// -- backward: dK and dV ------------------------------------------------------
//
// Replaces _bwd_dkv_kernel of edl_tpu/ops/flash_attention.py.
// Bound on the H100: 8·D FLOPs per visible pair (Sᵀ, dPᵀ, dV and dK products)
// against 12·D bytes per row: FLOP-bound at the slice's shape (~26 µs against
// ~23 µs of bytes). Key-tile outer, query-tile inner: one block per
// (batch·head, 64 keys) holds K and V for its keys in registers, streams Q, dO,
// lse and delta tiles from the first query tile that can see its keys, and
// keeps dK and dV in f32 registers, written once. Each block owns its output
// rows, so there are no atomics and the sums are deterministic.
template <int DP>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
    int Sq, int Sk, int D, Strides qs, Strides ks, Strides vs, int q_offset, int k_offset,
    float scale, int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = DP + kPad;
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sdo = sq + kTile * ld;
  float* slse = reinterpret_cast<float*>(sdo + kTile * ld);
  float* sdelta = slse + kTile;

  const int n_kt = (Sk + kTile - 1) / kTile;
  const int bh = blockIdx.x / n_kt, kt = blockIdx.x % n_kt;
  const int b = bh / H, h = bh % H;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int krow0 = kt * kTile + (threadIdx.x >> 5) * 16;  // this warp's first key row
  const Strides os = {(long long)Sq * H * D, (long long)H * D, D};  // dO: contiguous
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* dob = dout + b * os.b + h * os.h;
  const float* lseb = lse + (long long)bh * Sq;
  const float* deltab = delta + (long long)bh * Sq;

  uint32_t ka[DP / 16][4], va[DP / 16][4];
  load_a<DP>(ka, k + b * ks.b + h * ks.h, ks.s, krow0, Sk, D);
  load_a<DP>(va, v + b * vs.b + h * vs.h, vs.s, krow0, Sk, D);
  float dk_acc[DP / 8][4], dv_acc[DP / 8][4];
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    dk_acc[i][0] = dk_acc[i][1] = dk_acc[i][2] = dk_acc[i][3] = 0.f;
    dv_acc[i][0] = dv_acc[i][1] = dv_acc[i][2] = dv_acc[i][3] = 0.f;
  }
  const int kpos = k_offset + krow0 + g;  // global position of key row g
  const bool key_ok[2] = {krow0 + g < Sk, krow0 + g + 8 < Sk};

  const int n_qt = (Sq + kTile - 1) / kTile;
  for (int qt = first_query_tile(kt * kTile, q_offset, k_offset, causal); qt < n_qt; ++qt) {
    __syncthreads();
    load_tile<DP>(sq, qb, qs.s, qt * kTile, Sq, D);
    load_tile<DP>(sdo, dob, os.s, qt * kTile, Sq, D);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const int row = qt * kTile + i;
      slse[i] = row < Sq ? lseb[row] : 0.f;
      sdelta[i] = row < Sq ? deltab[row] : 0.f;
    }
    __syncthreads();

    float st[kTile / 8][4], dpt[kTile / 8][4];  // Sᵀ and dPᵀ: rows are keys
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
      dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
    }
    mma_abt<DP, kTile / 8>(st, ka, sq);    // Sᵀ = K Qᵀ
    mma_abt<DP, kTile / 8>(dpt, va, sdo);  // dPᵀ = V dOᵀ
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int qi = j * 8 + 2 * t + (e & 1);  // query row within the tile
        const int qrow = qt * kTile + qi;
        const bool ok = key_ok[r] && qrow < Sq &&
                        (!causal || kpos + 8 * r <= q_offset + qrow);
        const float p = ok ? expf(st[j][e] * scale - slse[qi]) : 0.f;
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - sdelta[qi]) * scale;  // dSᵀ
      }
    }
    mma_pv<DP>(dv_acc, st, sdo);  // dV += Pᵀ dO
    mma_pv<DP>(dk_acc, dpt, sq);  // dK += dSᵀ Q
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = krow0 + g + 8 * r;
    if (row >= Sk) continue;
    const long long base = (((long long)b * Sk + row) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int d = i * 8 + 2 * t;
      if (d < D) {
        *reinterpret_cast<__nv_bfloat162*>(dk + base + d) =
            __floats2bfloat162_rn(dk_acc[i][2 * r], dk_acc[i][2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + base + d) =
            __floats2bfloat162_rn(dv_acc[i][2 * r], dv_acc[i][2 * r + 1]);
      }
    }
  }
}

// -- launchers ----------------------------------------------------------------

template <int DP>
constexpr size_t tiles_smem() {
  return 2 * kTile * (DP + kPad) * sizeof(bf16);
}
// All three kernels stay under the 48 KB of static shared memory a launch may
// take without cudaFuncSetAttribute(..., MaxDynamicSharedMemorySize, ...).
static_assert(tiles_smem<64>() + 2 * kTile * sizeof(float) <= 48 * 1024, "shared memory");

// The padded head dim a kernel is compiled for: D even, 2 <= D <= 64.
int padded_head_dim(int D) {
  if (D <= 0 || D % 2 || D > 64) return 0;
  return D <= 16 ? 16 : D <= 32 ? 32 : 64;
}

template <int DP>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
                int Sq, int Sk, int D, Strides qs, Strides ks, Strides vs, int q_offset,
                int k_offset, float scale, int causal, int out_f32, cudaStream_t stream) {
  const int blocks = B * H * ((Sq + kTile - 1) / kTile);
  flash_fwd_kernel<DP><<<blocks, kThreads, tiles_smem<DP>(), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), o,
      lse, H, Sq, Sk, D, qs, ks, vs, q_offset, k_offset, scale, causal, out_f32);
  return cudaGetLastError();
}

template <int DP>
cudaError_t bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, int B, int H, int Sq, int Sk,
                   int D, Strides qs, Strides ks, Strides vs, int q_offset, int k_offset,
                   float scale, int causal, cudaStream_t stream) {
  const int blocks = B * H * ((Sq + kTile - 1) / kTile);
  flash_bwd_dq_kernel<DP><<<blocks, kThreads, tiles_smem<DP>(), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), H, Sq, Sk, D, qs, ks,
      vs, q_offset, k_offset, scale, causal);
  return cudaGetLastError();
}

template <int DP>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dk, void* dv, int B, int H,
                    int Sq, int Sk, int D, Strides qs, Strides ks, Strides vs, int q_offset,
                    int k_offset, float scale, int causal, cudaStream_t stream) {
  const int blocks = B * H * ((Sk + kTile - 1) / kTile);
  const size_t smem = tiles_smem<DP>() + 2 * kTile * sizeof(float);
  flash_bwd_dkv_kernel<DP><<<blocks, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, Sq, Sk, D, qs, ks, vs, q_offset, k_offset, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// -- C interface (ctypes) -----------------------------------------------------
//
// Every function launches on `stream`, does not synchronise, allocates nothing
// and returns the cudaError_t of the launch (0 on success). q, k, v: bf16
// (B, S, H, D) with the given element strides; every other tensor contiguous.

extern "C" {

const char* edl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int edl_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
                  int Sq, int Sk, int D, long long q_sb, long long q_ss, long long q_sh,
                  long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                  long long v_sh, int q_offset, int k_offset, float scale, int causal,
                  int out_f32, void* stream) {
  const Strides qs = {q_sb, q_ss, q_sh}, ks = {k_sb, k_ss, k_sh}, vs = {v_sb, v_ss, v_sh};
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (padded_head_dim(D)) {
    case 16: return fwd<16>(q, k, v, o, l, B, H, Sq, Sk, D, qs, ks, vs, q_offset, k_offset, scale, causal, out_f32, st);
    case 32: return fwd<32>(q, k, v, o, l, B, H, Sq, Sk, D, qs, ks, vs, q_offset, k_offset, scale, causal, out_f32, st);
    case 64: return fwd<64>(q, k, v, o, l, B, H, Sq, Sk, D, qs, ks, vs, q_offset, k_offset, scale, causal, out_f32, st);
    default: return cudaErrorInvalidValue;
  }
}

int edl_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dq, int B, int H, int Sq, int Sk,
                     int D, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                     long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                     long long v_sh, int q_offset, int k_offset, float scale, int causal,
                     void* stream) {
  const Strides qs = {q_sb, q_ss, q_sh}, ks = {k_sb, k_ss, k_sh}, vs = {v_sb, v_ss, v_sh};
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (padded_head_dim(D)) {
    case 16: return bwd_dq<16>(q, k, v, dout, l, dl, dq, B, H, Sq, Sk, D, qs, ks, vs, q_offset, k_offset, scale, causal, st);
    case 32: return bwd_dq<32>(q, k, v, dout, l, dl, dq, B, H, Sq, Sk, D, qs, ks, vs, q_offset, k_offset, scale, causal, st);
    case 64: return bwd_dq<64>(q, k, v, dout, l, dl, dq, B, H, Sq, Sk, D, qs, ks, vs, q_offset, k_offset, scale, causal, st);
    default: return cudaErrorInvalidValue;
  }
}

int edl_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dk, void* dv, int B, int H,
                      int Sq, int Sk, int D, long long q_sb, long long q_ss, long long q_sh,
                      long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                      long long v_ss, long long v_sh, int q_offset, int k_offset, float scale,
                      int causal, void* stream) {
  const Strides qs = {q_sb, q_ss, q_sh}, ks = {k_sb, k_ss, k_sh}, vs = {v_sb, v_ss, v_sh};
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (padded_head_dim(D)) {
    case 16: return bwd_dkv<16>(q, k, v, dout, l, dl, dk, dv, B, H, Sq, Sk, D, qs, ks, vs, q_offset, k_offset, scale, causal, st);
    case 32: return bwd_dkv<32>(q, k, v, dout, l, dl, dk, dv, B, H, Sq, Sk, D, qs, ks, vs, q_offset, k_offset, scale, causal, st);
    case 64: return bwd_dkv<64>(q, k, v, dout, l, dl, dk, dv, B, H, Sq, Sk, D, qs, ks, vs, q_offset, k_offset, scale, causal, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
