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
// Precision: every product runs on the tensor cores with bf16 operands and f32
// accumulation. Q·Kᵀ and dO·Vᵀ take the bf16 inputs as they are, which is
// exact up to summation order, as on the TPU. P and dS are rounded to bf16
// before P·V, Pᵀ·dO, dS·K and dSᵀ·Q, where the Pallas kernels multiply in f32:
// one bf16 rounding (relative 2^-9) per term, which the bf16 tolerances against
// the plain PyTorch versions cover. Every kernel takes exp as 2^x on the
// special-function unit with scale·log2(e) folded into one multiply.
//
// One design serves all three (see the note above each kernel): a producer
// warp streams tiles by TMA into a ring of shared-memory stages guarded by
// mbarriers, and two consumer warpgroups run every product as wgmma while the
// next tiles load.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;          // rows one consumer warpgroup owns (wgmma's M)
constexpr float kNegInf = -1e30f;  // the TPU kernels' _NEG_INF sentinel

struct Strides {  // element strides of a (B, S, H, D) view; D has unit stride
  long long b, s, h;
};

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

// Key tiles [0, n_open) that every row of the warpgroup whose first row is
// wg_row0 sees whole: each tile is wholly inside Sk and wholly visible to
// that first row (and so to every later row, none of which sees no key).
// The masked tiles (the diagonal, the ragged edge) come after them.
__device__ __forceinline__ int open_key_tiles(int n_kt, int Sk, int wg_row0, int q_offset,
                                              int k_offset, int causal) {
  int last_open = Sk - kTile;
  const int last_visible = q_offset + wg_row0 - k_offset - kTile + 1;
  if (causal && last_visible < last_open) last_open = last_visible;
  const int n_open = last_open < 0 ? 0 : last_open / kTile + 1;
  return n_open < n_kt ? n_open : n_kt;
}

// -- shared pieces --------------------------------------------------------------
//
// Every kernel runs two consumer warpgroups and one producer warp: each
// consumer warpgroup owns 64 rows of the block's tile and runs wgmma on them;
// one thread of the producer warp issues the TMA loads. With 9 warps a block,
// three share one quarter of the SM's register file, so ptxas gives each
// thread at most 168 registers. The tiles are sized to that: 64 keys per
// forward and dq stage (S, P and O, or S, dP, dS and dQ, in registers
// together), and a dkv that forms Pᵀ and dSᵀ only between its products.

constexpr int kConsumers = 2;  // consumer warpgroups
constexpr int kWsThreads = kConsumers * 128 + 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

constexpr int kFwdRows = 128;   // query rows per forward block
constexpr int kFwdKeys = 64;    // keys per forward pipeline stage
constexpr int kFwdStages = 4;
constexpr int kDqRows = 128;    // query rows per dq block
constexpr int kDqKeys = 64;     // keys per dq pipeline stage
constexpr int kDqStages = 4;
constexpr int kDkvKeys = 128;   // keys per dkv block
constexpr int kDkvRows = 64;    // query rows per dkv pipeline stage
constexpr int kDkvStages = 3;
static_assert(kDkvRows == kTile, "first_query_tile() counts dkv query tiles of kTile rows");
static_assert(kFwdKeys == kTile && kDqKeys == kTile,
              "key_tiles() and open_key_tiles() count key tiles of kTile keys");
static_assert(kFwdRows == kConsumers * kTile && kDqRows == kConsumers * kTile,
              "each consumer warpgroup owns kTile query rows");

// The block's dynamic shared memory, moved up to a 1024-byte boundary (the
// 128-byte swizzle's period); launches ask for 1024 bytes of slack.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024u - (hopper::smem_addr(raw) & 1023u)) & 1023u);
}

// A 64 x 64 tile (f32, accumulator layout) to the bf16 A fragments of a
// product that reduces over its 64 columns, 16 columns each: the accumulator
// layout of a 64 x 16 slice is the A operand's layout.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[jj][e] = pack_bf16(x[8 * jj + 2 * e], x[8 * jj + 2 * e + 1]);
}

// X = A_x·B_xᵀ and Y = A_y·B_yᵀ (64 x 64 each) for one warpgroup, in one
// commit group: A_x and A_y are the warpgroup's own 64 rows (descriptors ax,
// ay), B_x and B_y tiles of 64 rows, all K-major. dq: S = Q·Kᵀ and
// dP = dO·Vᵀ; dkv: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ.
template <int DP>
__device__ __forceinline__ void issue_abt_pair(float (&x)[32], float (&y)[32], uint64_t ax,
                                               uint64_t ay, const bf16* bx_tile,
                                               const bf16* by_tile) {
  const uint64_t bx = hopper::make_desc<DP>(bx_tile), by = hopper::make_desc<DP>(by_tile);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    hopper::wgmma_ss_n64(x, hopper::desc_add(ax, kk * 32), hopper::desc_add(bx, kk * 32), kk);
  }
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    hopper::wgmma_ss_n64(y, hopper::desc_add(ay, kk * 32), hopper::desc_add(by, kk * 32), kk);
  }
  hopper::wgmma_commit();
}

// acc (64 x DP) += A·B for one warpgroup, left uncommitted: A (64 x 64) in
// bf16 A fragments in registers, B a tile of 64 rows read MN-major (its rows
// are the reduction index). P·V, dS·K, Pᵀ·dO and dSᵀ·Q.
template <int DP>
__device__ __forceinline__ void issue_rs_mn(float (&acc)[DP / 2], const uint32_t (&a)[4][4],
                                            const bf16* b_tile) {
  const uint64_t b = hopper::make_desc<DP>(b_tile);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    hopper::wgmma_rs_mn<DP>(acc, a[kk], hopper::desc_add(b, kk * 16 * DP * 2));
  }
}

// -- forward ------------------------------------------------------------------

// What the forward's softmax needs to mask one thread's two rows of an S
// tile: the global position of row g (row g + 8 is 8 further), the lane's
// column pair t, and the request.
struct FwdRows {
  int qpos, t, Sk, causal, k_offset;
  float scale_log2;
};

// One S tile's online-softmax step, in place: sc (Q·Kᵀ of keys key0 + ...)
// becomes P = 2^(S·scale·log2 e − m_new) in f32, with every masked entry
// exactly 0 through its validity, never through its score; m moves to the new
// row max (log2 units), the per-thread partial sum l is rescaled and grows,
// and alpha is the factor that rescales O. Unless kMasked, every entry is
// visible and no mask is evaluated. The code is branch-free, so it can run
// while a wgmma is in flight.
template <bool kMasked, int NC>
__device__ __forceinline__ void fwd_softmax(float (&sc)[NC][32], float (&m)[2], float (&l)[2],
                                            float (&alpha)[2], int key0, const FwdRows& q) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const int key = key0 + c * 64 + (i >> 2) * 8 + 2 * q.t + (i & 1);
      const bool ok =
          !kMasked || (key < q.Sk && (!q.causal || q.k_offset + key <= q.qpos + 8 * r));
      const float x = ok ? sc[c][i] * q.scale_log2 : kNegInf;
      sc[c][i] = x;
      mx[r] = fmaxf(mx[r], x);
    }
  }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const int key = key0 + c * 64 + (i >> 2) * 8 + 2 * q.t + (i & 1);
      const bool ok =
          !kMasked || (key < q.Sk && (!q.causal || q.k_offset + key <= q.qpos + 8 * r));
      const float p = ok ? hopper::exp2_approx(sc[c][i] - mx[r]) : 0.f;
      sc[c][i] = p;
      rs[r] += p;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    alpha[r] = hopper::exp2_approx(m[r] - mx[r]);
    l[r] = l[r] * alpha[r] + rs[r];  // per-thread partial sum; reduced once at the end
    m[r] = mx[r];
  }
}

// S (64 x kFwdKeys) = Q·Kᵀ for one warpgroup: its Q rows (descriptor dq) and
// a K tile, both K-major, in chunks of 64 keys.
template <int DP>
__device__ __forceinline__ void fwd_issue_s(float (&sc)[kFwdKeys / 64][32], uint64_t dq,
                                            const bf16* k_tile) {
  const uint64_t dk = hopper::make_desc<DP>(k_tile);
#pragma unroll
  for (int c = 0; c < kFwdKeys / 64; ++c) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      hopper::wgmma_ss_n64(sc[c], hopper::desc_add(dq, kk * 32),
                           hopper::desc_add(dk, c * 64 * DP * 2 + kk * 32), kk);
    }
  }
  hopper::wgmma_commit();
}

// One step of a consumer warpgroup's pipeline at key tile kt >= 1: issue
// S = Q·K_ktᵀ and O += P_(kt-1)·V_(kt-1), run the softmax of tile kt while
// P·V runs, release tile kt - 1's stage, rescale O and pack P_kt.
template <int DP, bool kMasked>
__device__ __forceinline__ void fwd_step(int kt, float (&sc)[kFwdKeys / 64][32],
                                         uint32_t (&pa)[kFwdKeys / 16][4], float (&acc)[DP / 2],
                                         float (&m)[2], float (&l)[2], uint64_t dq,
                                         const bf16* sk, const bf16* sv, uint64_t* full,
                                         uint64_t* empty, const FwdRows& rows) {
  using namespace hopper;
  const int s = kt % kFwdStages, prev = (kt - 1) % kFwdStages;
  mbar_wait(&full[s], (kt / kFwdStages) & 1);
  wgmma_fence();
  fwd_issue_s<DP>(sc, dq, sk + s * kFwdKeys * DP);
  issue_rs_mn<DP>(acc, pa, sv + prev * kFwdKeys * DP);
  wgmma_commit();
  wgmma_wait<1>();  // S done, P·V may still run
  fence_regs(sc);
  float alpha[2];
  fwd_softmax<kMasked>(sc, m, l, alpha, kt * kFwdKeys, rows);
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(pa);
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[prev]);
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
  pack_a(pa, sc[0]);
}

// Replaces _fwd_kernel of edl_tpu/ops/flash_attention.py.
// Bound on the H100: at head_dim 64 it does 4·D = 256 FLOPs per visible
// (query, key) pair against 8·D bytes per row moved, so a 1024-token causal
// sequence sits near the ridge (~15 µs of bytes and ~13 µs of bf16 FLOPs for
// the slice's 96 heads). Design: one block owns 128 query rows of one
// (batch, head), the heaviest query tiles launched first. The producer loads
// the Q tile once and streams 64-key K and V tiles by TMA through a
// 4-stage ring (full/empty mbarriers), so later tiles load while this one is
// multiplied. Each consumer warpgroup computes S = Q·Kᵀ for its 64 rows as
// wgmma with both operands in shared memory, runs the online softmax on the
// accumulator fragment (the mask is evaluated only on tiles that cross the
// diagonal or the ragged edge), rounds P to bf16 in registers and feeds it as
// the register operand of O += P·V, with V read MN-major. The warpgroup
// issues S of tile kt and P·V of tile kt - 1 together and runs the softmax
// of tile kt while P·V runs, so the exponentials overlap the tensor cores.
// S and P never leave registers; each K/V tile is read once per 128 rows.
template <int DP>
__global__ void __launch_bounds__(kWsThreads, 1) flash_fwd_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, void* __restrict__ o, float* __restrict__ lse,
    int H, int Sq, int Sk, int D, int q_offset, int k_offset, float scale_log2, int causal,
    int out_f32) {
  using namespace hopper;
  constexpr int kQBytes = kFwdRows * DP * 2, kKVBytes = kFwdKeys * DP * 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = reinterpret_cast<bf16*>(smem + kQBytes);
  bf16* sv = reinterpret_cast<bf16*>(smem + kQBytes + kFwdStages * kKVBytes);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + kQBytes + 2 * kFwdStages * kKVBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kFwdStages;

  const int n_qt = (Sq + kFwdRows - 1) / kFwdRows;
  const int BH = gridDim.x / n_qt;
  const int qt = n_qt - 1 - blockIdx.x / BH;  // the last query tiles carry the most keys
  const int bh = blockIdx.x % BH, b = bh / H, h = bh % H;
  const int q0 = qt * kFwdRows;
  // the key tiles that the block's last kTile rows see
  const int n_kt = key_tiles(Sk, q0 + kFwdRows - kTile, q_offset, k_offset, causal);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {  // the producer warp
    if (threadIdx.x == kConsumers * 128) {  // one thread issues every load
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      mbar_arrive_expect_tx(q_full, kQBytes);
      tma_load_4d(sq, &tq, q_full, 0, h, q0, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kFwdStages;
        mbar_wait(&empty[s], ((kt / kFwdStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * kKVBytes);
        tma_load_4d(sk + s * kFwdKeys * DP, &tk, &full[s], 0, h, kt * kFwdKeys, b);
        tma_load_4d(sv + s * kFwdKeys * DP, &tv, &full[s], 0, h, kt * kFwdKeys, b);
      }
    }
  } else {  // consumer warpgroup wg: query rows q0 + 64·wg ...
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int wg_row0 = q0 + wg * 64;
    const int row0 = wg_row0 + ((threadIdx.x >> 5) & 3) * 16;  // this warp's first row
    const FwdRows rows = {q_offset + row0 + (lane >> 2), t, Sk, causal, k_offset, scale_log2};

    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // rows g and g + 8, log2 units
    float sc[kFwdKeys / 64][32];    // S, then P in f32, keys 64·c + ..., accumulator layout
    uint32_t pa[kFwdKeys / 16][4];  // P in bf16: the A fragments of P·V
    float alpha[2];                 // the first tile's: O is still 0

    mbar_wait(q_full, 0);
    const uint64_t dq = make_desc<DP>(sq + wg * 64 * DP);
    const int n_open = open_key_tiles(n_kt, Sk, wg_row0, q_offset, k_offset, causal);

    // Software pipeline inside the warpgroup: while the tensor cores run
    // O += P·V of tile kt - 1, the softmax of tile kt runs on S. The code
    // between a wgmma's issue and its wait has no branch: the mask is a
    // template parameter of each loop, not a runtime test.
    if (n_kt > 0) {
      mbar_wait(&full[0], 0);
      wgmma_fence();
      fwd_issue_s<DP>(sc, dq, sk);
      wgmma_wait<0>();
      fence_regs(sc);
      if (n_open > 0) {
        fwd_softmax<false>(sc, m, l, alpha, 0, rows);
      } else {
        fwd_softmax<true>(sc, m, l, alpha, 0, rows);
      }
      pack_a(pa, sc[0]);
    }
    for (int kt = 1; kt < n_open; ++kt) {
      fwd_step<DP, false>(kt, sc, pa, acc, m, l, dq, sk, sv, full, empty, rows);
    }
    for (int kt = n_open > 1 ? n_open : 1; kt < n_kt; ++kt) {
      fwd_step<DP, true>(kt, sc, pa, acc, m, l, dq, sk, sv, full, empty, rows);
    }
    if (n_kt > 0) {
      wgmma_fence();
      issue_rs_mn<DP>(acc, pa, sv + (n_kt - 1) % kFwdStages * kFwdKeys * DP);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
    }

    const int g = lane >> 2;
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      if (row >= Sq) continue;
      const float safe = l[r] > 0.f ? l[r] : 1.f;  // a row with no key: acc is 0, so O = 0
      const long long base = (((long long)b * Sq + row) * H + h) * D;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int d = j * 8 + 2 * t;
        if (d >= D) continue;
        const float x0 = acc[4 * j + 2 * r] / safe, x1 = acc[4 * j + 2 * r + 1] / safe;
        if (out_f32) {
          *reinterpret_cast<float2*>(static_cast<float*>(o) + base + d) = make_float2(x0, x1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(o) + base + d) =
              __floats2bfloat162_rn(x0, x1);
        }
      }
      if (t == 0) {
        lse[(long long)bh * Sq + row] = l[r] > 0.f ? m[r] * kLn2 + logf(safe) : kNegInf;
      }
    }
  }
}

// -- backward: dQ -------------------------------------------------------------

// What dq's probabilities need for one thread's two query rows (g and g + 8
// of its warp's 16): the global position of row g, the lane's column pair t,
// each row's lse (times log2 e) and delta, and the request.
struct DqRows {
  int qpos, t, Sk, causal, k_offset;
  float scale, scale_log2, lse_log2[2], delta[2];
};

// dS = P ∘ (dP − delta) · scale in place of dp, with P = 2^(S·scale·log2 e −
// lse·log2 e) from sc (Q·Kᵀ of keys key0 + ...); masked entries are exactly 0
// through their validity, never through the score (a row that sees no key
// has lse = -1e30, where the exponent overflows). Unless kMasked, every entry
// is visible and no mask is evaluated. Branch-free, so it can run while a
// wgmma is in flight.
template <bool kMasked>
__device__ __forceinline__ void dq_probs(const float (&sc)[32], float (&dp)[32], int key0,
                                         const DqRows& q) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    const int key = key0 + (i >> 2) * 8 + 2 * q.t + (i & 1);
    const bool ok =
        !kMasked || (key < q.Sk && (!q.causal || q.k_offset + key <= q.qpos + 8 * r));
    const float p = ok ? hopper::exp2_approx(sc[i] * q.scale_log2 - q.lse_log2[r]) : 0.f;
    dp[i] = p * (dp[i] - q.delta[r]) * q.scale;
  }
}

// One step of a consumer warpgroup's pipeline at key tile kt >= 1: issue
// S = Q·K_ktᵀ and dP = dO·V_ktᵀ, then dQ += dS_(kt-1)·K_(kt-1); form dS_kt
// while that product runs, release tile kt - 1's stage and pack dS_kt.
template <int DP, bool kMasked>
__device__ __forceinline__ void dq_step(int kt, float (&sc)[32], float (&dp)[32],
                                        uint32_t (&da)[4][4], float (&acc)[DP / 2], uint64_t dqd,
                                        uint64_t dod, const bf16* sk, const bf16* sv,
                                        uint64_t* full, uint64_t* empty, const DqRows& rows) {
  using namespace hopper;
  const int s = kt % kDqStages, prev = (kt - 1) % kDqStages;
  mbar_wait(&full[s], (kt / kDqStages) & 1);
  wgmma_fence();
  issue_abt_pair<DP>(sc, dp, dqd, dod, sk + s * kDqKeys * DP, sv + s * kDqKeys * DP);
  issue_rs_mn<DP>(acc, da, sk + prev * kDqKeys * DP);
  wgmma_commit();
  wgmma_wait<1>();  // S and dP done, dS·K may still run
  fence_regs(sc);
  fence_regs(dp);
  dq_probs<kMasked>(sc, dp, kt * kDqKeys, rows);
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(da);
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[prev]);
  pack_a(da, dp);
}

// Replaces _bwd_dq_kernel of edl_tpu/ops/flash_attention.py.
// Bound on the H100: 6·D FLOPs per visible pair (S, dP and dS·K products)
// against 10·D bytes per row (q, k, v, dO in, dQ out): at the slice's shape
// about as much bytes time as FLOP time (~19-20 µs each). Design: the
// forward's dataflow. One block owns 128 query rows of one (batch, head),
// the heaviest query tiles launched first; each consumer warpgroup owns 64 of
// them and keeps their lse (times log2 e) and delta in registers. The
// producer loads the Q and dO tiles once and streams 64-key K and V tiles by
// TMA through a 4-stage ring. S = Q·Kᵀ and dP = dO·Vᵀ are wgmma with both
// operands in shared memory; dS is formed in registers (masked only on tiles
// that cross the warpgroup's diagonal or the ragged edge), rounded to bf16
// and fed as the register operand of dQ += dS·K, with the same K tile read
// MN-major. The warpgroup issues S and dP of tile kt together with dS·K of
// tile kt - 1 and forms dS of tile kt while that product runs. dQ stays in
// f32 registers and is written once: each block owns its output rows, so
// there are no atomics and the sums are deterministic. Both warpgroups wait
// on and release every stage the producer fills, also where their rows see
// no key of it; a block that sees no key loads nothing and writes dQ = 0.
template <int DP>
__global__ void __launch_bounds__(kWsThreads, 1) flash_bwd_dq_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dq,
    int H, int Sq, int Sk, int D, int q_offset, int k_offset, float scale, float scale_log2,
    int causal) {
  using namespace hopper;
  constexpr int kQBytes = kDqRows * DP * 2, kKVBytes = kDqKeys * DP * 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sdo = reinterpret_cast<bf16*>(smem + kQBytes);
  bf16* sk = reinterpret_cast<bf16*>(smem + 2 * kQBytes);
  bf16* sv = reinterpret_cast<bf16*>(smem + 2 * kQBytes + kDqStages * kKVBytes);
  uint64_t* qdo_full =
      reinterpret_cast<uint64_t*>(smem + 2 * kQBytes + 2 * kDqStages * kKVBytes);
  uint64_t* full = qdo_full + 1;
  uint64_t* empty = full + kDqStages;

  const int n_qt = (Sq + kDqRows - 1) / kDqRows;
  const int BH = gridDim.x / n_qt;
  const int qt = n_qt - 1 - blockIdx.x / BH;  // the last query tiles carry the most keys
  const int bh = blockIdx.x % BH, b = bh / H, h = bh % H;
  const int q0 = qt * kDqRows;
  // the key tiles that the block's last kTile rows see
  const int n_kt = key_tiles(Sk, q0 + kDqRows - kTile, q_offset, k_offset, causal);

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {  // the producer warp
    if (threadIdx.x == kConsumers * 128 && n_kt > 0) {  // one thread issues every load
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tdo);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      mbar_arrive_expect_tx(qdo_full, 2 * kQBytes);
      tma_load_4d(sq, &tq, qdo_full, 0, h, q0, b);
      tma_load_4d(sdo, &tdo, qdo_full, 0, h, q0, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kDqStages;
        mbar_wait(&empty[s], ((kt / kDqStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * kKVBytes);
        tma_load_4d(sk + s * kDqKeys * DP, &tk, &full[s], 0, h, kt * kDqKeys, b);
        tma_load_4d(sv + s * kDqKeys * DP, &tv, &full[s], 0, h, kt * kDqKeys, b);
      }
    }
  } else {  // consumer warpgroup wg: query rows q0 + 64·wg ...
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int wg_row0 = q0 + wg * 64;
    const int row0 = wg_row0 + ((threadIdx.x >> 5) & 3) * 16;  // this warp's first row
    DqRows rows = {q_offset + row0 + g, t, Sk, causal, k_offset, scale, scale_log2,
                   {0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // rows at or beyond Sq stay finite and are never written
      const int row = row0 + g + 8 * r;
      if (row < Sq) {
        rows.lse_log2[r] = lse[(long long)bh * Sq + row] * kLog2e;
        rows.delta[r] = delta[(long long)bh * Sq + row];
      }
    }

    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

    if (n_kt > 0) {
      float sc[32], dp[32];  // S and dP, then dS in dp: f32, accumulator layout
      uint32_t da[4][4];     // dS in bf16: the A fragments of dS·K
      mbar_wait(qdo_full, 0);
      const uint64_t dqd = make_desc<DP>(sq + wg * 64 * DP);
      const uint64_t dod = make_desc<DP>(sdo + wg * 64 * DP);
      const int n_open = open_key_tiles(n_kt, Sk, wg_row0, q_offset, k_offset, causal);

      // The code between a wgmma's issue and its wait has no branch: the mask
      // is a template parameter of each loop, not a runtime test.
      mbar_wait(&full[0], 0);
      wgmma_fence();
      issue_abt_pair<DP>(sc, dp, dqd, dod, sk, sv);
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      if (n_open > 0) {
        dq_probs<false>(sc, dp, 0, rows);
      } else {
        dq_probs<true>(sc, dp, 0, rows);
      }
      pack_a(da, dp);
      for (int kt = 1; kt < n_open; ++kt) {
        dq_step<DP, false>(kt, sc, dp, da, acc, dqd, dod, sk, sv, full, empty, rows);
      }
      for (int kt = n_open > 1 ? n_open : 1; kt < n_kt; ++kt) {
        dq_step<DP, true>(kt, sc, dp, da, acc, dqd, dod, sk, sv, full, empty, rows);
      }
      wgmma_fence();
      issue_rs_mn<DP>(acc, da, sk + (n_kt - 1) % kDqStages * kDqKeys * DP);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(da);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      if (row >= Sq) continue;
      const long long base = (((long long)b * Sq + row) * H + h) * D;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int d = j * 8 + 2 * t;
        if (d < D) {
          *reinterpret_cast<__nv_bfloat162*>(dq + base + d) =
              __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

// -- backward: dK and dV ------------------------------------------------------

// What dkv's probabilities need to mask one thread's two key rows of a
// transposed tile: the global position of key row g (row g + 8 is 8 further),
// its local index, the lane's column pair t, and the request.
struct DkvKeys {
  int kpos, krow, t, Sq, Sk, causal, q_offset;
  float scale, scale_log2;
};

// Pᵀ = exp(Sᵀ·scale − lse) and dSᵀ = Pᵀ ∘ (dPᵀ − delta) · scale in place, for
// the query tile at q0 whose lse (times log2 e) and delta are `ls` and `dl`;
// masked entries are exactly 0 through their validity. Unless kMasked,
// every entry is visible and no mask is evaluated.
template <bool kMasked>
__device__ __forceinline__ void dkv_probs(float (&st)[32], float (&dpt)[32], const float* ls,
                                          const float* dl, int q0, const DkvKeys& k) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    const int qi = (i >> 2) * 8 + 2 * k.t + (i & 1);  // query row within the tile
    const bool ok = !kMasked || (k.krow + 8 * r < k.Sk && q0 + qi < k.Sq &&
                                (!k.causal || k.kpos + 8 * r <= k.q_offset + q0 + qi));
    const float p = ok ? hopper::exp2_approx(st[i] * k.scale_log2 - ls[qi]) : 0.f;
    st[i] = p;
    dpt[i] = p * (dpt[i] - dl[qi]) * k.scale;
  }
}

// Replaces _bwd_dkv_kernel of edl_tpu/ops/flash_attention.py.
// Bound on the H100: 8·D FLOPs per visible pair (Sᵀ, dPᵀ, dV and dK products)
// against 12·D bytes per row: FLOP-bound at the slice's shape (~26 µs against
// ~23 µs of bytes). Design: key-tile outer, query-tile inner. One block owns
// 128 keys of one (batch, head), the earliest (most-seen) key tiles launched
// first; each consumer warpgroup owns 64 of them. K and V are loaded once by
// TMA; 64-query tiles of Q and dO stream through a 3-stage ring by TMA, with
// their lse (pre-multiplied by log2 e) and delta stored beside them by the
// producer warp, from the first query tile that can see the block's keys.
// Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ are wgmma with both operands in shared memory;
// Pᵀ and dSᵀ are formed in registers (masked only on tiles that cross the
// diagonal or the ragged edge), rounded to bf16 and fed as register operands
// of dV += Pᵀ·dO and dK += dSᵀ·Q with dO and Q read MN-major. dK and dV stay
// in f32 registers and are written once: each block owns its output rows, so
// there are no atomics and the sums are deterministic.
template <int DP>
__global__ void __launch_bounds__(kWsThreads, 1) flash_bwd_dkv_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int H, int Sq, int Sk, int D, int q_offset, int k_offset,
    float scale, float scale_log2, int causal) {
  using namespace hopper;
  constexpr int kKVBytes = kDkvKeys * DP * 2, kQBytes = kDkvRows * DP * 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = reinterpret_cast<bf16*>(smem + kKVBytes);
  bf16* sq = reinterpret_cast<bf16*>(smem + 2 * kKVBytes);
  bf16* sdo = reinterpret_cast<bf16*>(smem + 2 * kKVBytes + kDkvStages * kQBytes);
  float* slse = reinterpret_cast<float*>(smem + 2 * kKVBytes + 2 * kDkvStages * kQBytes);
  float* sdelta = slse + kDkvStages * kDkvRows;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sdelta + kDkvStages * kDkvRows);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kDkvStages;

  const int n_kt = (Sk + kDkvKeys - 1) / kDkvKeys;
  const int BH = gridDim.x / n_kt;
  const int kt = blockIdx.x / BH;  // the first key tiles are seen by the most queries
  const int bh = blockIdx.x % BH, b = bh / H, h = bh % H;
  const int k0 = kt * kDkvKeys;
  const int n_qt = (Sq + kDkvRows - 1) / kDkvRows;
  const int qt0 = first_query_tile(k0, q_offset, k_offset, causal);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kDkvStages; ++s) {
      mbar_init(&full[s], 32);               // the producer warp's 32 lanes
      mbar_init(&empty[s], kConsumers * 4);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;
  if (wg == kConsumers) {  // the producer warp
    if (lane == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tdo);
      mbar_arrive_expect_tx(kv_full, 2 * kKVBytes);
      tma_load_4d(sk, &tk, kv_full, 0, h, k0, b);
      tma_load_4d(sv, &tv, kv_full, 0, h, k0, b);
    }
    const float* lseb = lse + (long long)bh * Sq;
    const float* deltab = delta + (long long)bh * Sq;
    for (int qt = qt0, it = 0; qt < n_qt; ++qt, ++it) {
      const int s = it % kDkvStages, q0 = qt * kDkvRows;
      mbar_wait(&empty[s], ((it / kDkvStages) & 1) ^ 1);
      for (int r = lane; r < kDkvRows; r += 32) {
        const bool ok = q0 + r < Sq;
        slse[s * kDkvRows + r] = ok ? lseb[q0 + r] * kLog2e : 0.f;
        sdelta[s * kDkvRows + r] = ok ? deltab[q0 + r] : 0.f;
      }
      if (lane == 0) {  // its arrival releases its own stores, as every lane's does
        mbar_arrive_expect_tx(&full[s], 2 * kQBytes);
        tma_load_4d(sq + s * kDkvRows * DP, &tq, &full[s], 0, h, q0, b);
        tma_load_4d(sdo + s * kDkvRows * DP, &tdo, &full[s], 0, h, q0, b);
      } else {
        mbar_arrive(&full[s]);
      }
    }
  } else {  // consumer warpgroup wg: keys k0 + 64·wg ...
    const int g = lane >> 2, t = lane & 3;
    const int wg_key0 = k0 + wg * 64;
    const int krow0 = wg_key0 + ((threadIdx.x >> 5) & 3) * 16;  // this warp's first key
    const int kpos = k_offset + krow0 + g;                       // global position of key g

    float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    float st[32], dpt[32];        // Sᵀ and dPᵀ, then Pᵀ and dSᵀ in f32: rows are keys
    uint32_t pa[4][4], da[4][4];  // Pᵀ and dSᵀ in bf16: the A fragments

    mbar_wait(kv_full, 0);
    const uint64_t dkd = make_desc<DP>(sk + wg * 64 * DP);
    const uint64_t dvd = make_desc<DP>(sv + wg * 64 * DP);
    const DkvKeys keys = {kpos, krow0 + g, t, Sq, Sk, causal, q_offset, scale, scale_log2};
    // Query tile qt is masked iff it crosses the ragged edge or this
    // warpgroup's diagonal (its first query does not see all 64 keys).
    const bool keys_ragged = wg_key0 + 64 > Sk;
    const int diag = k_offset + wg_key0 + 63 - q_offset;  // first query that sees all

    for (int qt = qt0, it = 0; qt < n_qt; ++qt, ++it) {
      const int s = it % kDkvStages, q0 = qt * kDkvRows;
      const bf16* q_tile = sq + s * kDkvRows * DP;
      const bf16* do_tile = sdo + s * kDkvRows * DP;
      mbar_wait(&full[s], (it / kDkvStages) & 1);
      wgmma_fence();
      issue_abt_pair<DP>(st, dpt, dkd, dvd, q_tile, do_tile);
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      if (keys_ragged || q0 + kDkvRows > Sq || (causal && q0 < diag)) {
        dkv_probs<true>(st, dpt, slse + s * kDkvRows, sdelta + s * kDkvRows, q0, keys);
      } else {
        dkv_probs<false>(st, dpt, slse + s * kDkvRows, sdelta + s * kDkvRows, q0, keys);
      }
      pack_a(pa, st);
      pack_a(da, dpt);
      wgmma_fence();
      issue_rs_mn<DP>(dv_acc, pa, do_tile);
      issue_rs_mn<DP>(dk_acc, da, q_tile);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(pa);
      fence_regs(da);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = krow0 + g + 8 * r;
      if (row >= Sk) continue;
      const long long base = (((long long)b * Sk + row) * H + h) * D;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int d = j * 8 + 2 * t;
        if (d < D) {
          *reinterpret_cast<__nv_bfloat162*>(dk + base + d) =
              __floats2bfloat162_rn(dk_acc[4 * j + 2 * r], dk_acc[4 * j + 2 * r + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dv + base + d) =
              __floats2bfloat162_rn(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

// -- launchers ----------------------------------------------------------------

// Shared memory of the kernels, with 1024 bytes of slack for alignment.
template <int DP>
constexpr size_t fwd_smem() {
  return 1024 + (kFwdRows + 2 * kFwdStages * kFwdKeys) * DP * 2 + (1 + 2 * kFwdStages) * 8;
}
template <int DP>
constexpr size_t dq_smem() {
  return 1024 + (2 * kDqRows + 2 * kDqStages * kDqKeys) * DP * 2 + (1 + 2 * kDqStages) * 8;
}
template <int DP>
constexpr size_t dkv_smem() {
  return 1024 + (2 * kDkvKeys + 2 * kDkvStages * kDkvRows) * DP * 2 +
         2 * kDkvStages * kDkvRows * sizeof(float) + (1 + 2 * kDkvStages) * 8;
}
static_assert(fwd_smem<64>() <= 227 * 1024 && dq_smem<64>() <= 227 * 1024 &&
                  dkv_smem<64>() <= 227 * 1024,
              "shared memory");

// The padded head dim a kernel is compiled for: D a multiple of 8, 8 <= D <= 64
// (TMA moves rows of 16-byte multiples).
int padded_head_dim(int D) {
  if (D <= 0 || D % 8 || D > 64) return 0;
  return D <= 16 ? 16 : D <= 32 ? 32 : 64;
}

// cuTensorMapEncodeTiled, a driver-API function, fetched through the runtime
// so that the library needs no link against libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
    const cudaError_t rc =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    return rc == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// The TMA map of a (B, S, H, D) bf16 view with element strides `st` (unit
// stride along D), in boxes of DP x 1 x `rows` x 1 elements, swizzled by the
// span of one box row. TMA needs a 16-byte aligned start and byte strides that
// are multiples of 16; elements outside the view (d >= D, s >= S) load as 0.
template <int DP>
cudaError_t view_map(CUtensorMap* map, const void* base, int B, int S, int H, int D, Strides st,
                     int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.s * 2, (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {DP, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = DP == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : DP == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult rc = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                             strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Lets `kernel` take `bytes` of dynamic shared memory (above the default 48 KB)
// on the current device. Set at every launch, so that every device has it.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int DP>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
                int Sq, int Sk, int D, Strides qs, Strides ks, Strides vs, int q_offset,
                int k_offset, float scale, int causal, int out_f32, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t rc = allow_smem(flash_fwd_kernel<DP>, fwd_smem<DP>());
  if (rc == cudaSuccess) rc = view_map<DP>(&tq, q, B, Sq, H, D, qs, kFwdRows);
  if (rc == cudaSuccess) rc = view_map<DP>(&tk, k, B, Sk, H, D, ks, kFwdKeys);
  if (rc == cudaSuccess) rc = view_map<DP>(&tv, v, B, Sk, H, D, vs, kFwdKeys);
  if (rc != cudaSuccess) return rc;
  const int blocks = B * H * ((Sq + kFwdRows - 1) / kFwdRows);
  flash_fwd_kernel<DP><<<blocks, kWsThreads, fwd_smem<DP>(), stream>>>(
      tq, tk, tv, o, lse, H, Sq, Sk, D, q_offset, k_offset, scale * kLog2e, causal, out_f32);
  return cudaGetLastError();
}

template <int DP>
cudaError_t bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, int B, int H, int Sq, int Sk,
                   int D, Strides qs, Strides ks, Strides vs, int q_offset, int k_offset,
                   float scale, int causal, cudaStream_t stream) {
  const Strides os = {(long long)Sq * H * D, (long long)H * D, D};  // dO: contiguous
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t rc = allow_smem(flash_bwd_dq_kernel<DP>, dq_smem<DP>());
  if (rc == cudaSuccess) rc = view_map<DP>(&tq, q, B, Sq, H, D, qs, kDqRows);
  if (rc == cudaSuccess) rc = view_map<DP>(&tdo, dout, B, Sq, H, D, os, kDqRows);
  if (rc == cudaSuccess) rc = view_map<DP>(&tk, k, B, Sk, H, D, ks, kDqKeys);
  if (rc == cudaSuccess) rc = view_map<DP>(&tv, v, B, Sk, H, D, vs, kDqKeys);
  if (rc != cudaSuccess) return rc;
  const int blocks = B * H * ((Sq + kDqRows - 1) / kDqRows);
  flash_bwd_dq_kernel<DP><<<blocks, kWsThreads, dq_smem<DP>(), stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dq), H, Sq, Sk, D, q_offset, k_offset,
      scale, scale * kLog2e, causal);
  return cudaGetLastError();
}

template <int DP>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dk, void* dv, int B, int H,
                    int Sq, int Sk, int D, Strides qs, Strides ks, Strides vs, int q_offset,
                    int k_offset, float scale, int causal, cudaStream_t stream) {
  const Strides os = {(long long)Sq * H * D, (long long)H * D, D};  // dO: contiguous
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t rc = allow_smem(flash_bwd_dkv_kernel<DP>, dkv_smem<DP>());
  if (rc == cudaSuccess) rc = view_map<DP>(&tq, q, B, Sq, H, D, qs, kDkvRows);
  if (rc == cudaSuccess) rc = view_map<DP>(&tdo, dout, B, Sq, H, D, os, kDkvRows);
  if (rc == cudaSuccess) rc = view_map<DP>(&tk, k, B, Sk, H, D, ks, kDkvKeys);
  if (rc == cudaSuccess) rc = view_map<DP>(&tv, v, B, Sk, H, D, vs, kDkvKeys);
  if (rc != cudaSuccess) return rc;
  const int blocks = B * H * ((Sk + kDkvKeys - 1) / kDkvKeys);
  flash_bwd_dkv_kernel<DP><<<blocks, kWsThreads, dkv_smem<DP>(), stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Sq, Sk, D,
      q_offset, k_offset, scale, scale * kLog2e, causal);
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
