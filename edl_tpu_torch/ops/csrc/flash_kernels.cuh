// Flash attention for NVIDIA Hopper (sm_90a): the forward kernel and the two
// backward kernels for 16-bit inputs (bf16 and f16), templates that the
// flash_fwd_*.cu and flash_bwd_*.cu units instantiate.
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
// from the same dO (in q's type) that these kernels read. The f32 inputs go to
// the kernels of flash_f32.cu instead, and head dims past 256 to the sliced
// kernels of flash_sliced.cuh.
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
//    query rows at or beyond Sq are never written. Nothing is padded by copy;
//    head-dim columns from D up to the compiled DP load as zeros.
//  * Masked scores carry the finite sentinel -1e30 (_NEG_INF), and every exp()
//    is masked through the validity bit, never through the score: a row that
//    sees no key ends with its running max exactly on the sentinel, where
//    exp(s − m) would be 1. Such a row gets O = 0 and lse = -1e30 exactly,
//    which the ring's logaddexp merge relies on.
//  * Scores, softmax statistics and accumulators are f32.
//
// Precision: every product runs on the tensor cores with 16-bit operands of
// the input's type and f32 accumulation. Q·Kᵀ and dO·Vᵀ take the inputs as
// they are, which is exact up to summation order, as on the TPU. P and dS are
// rounded to the input's type before P·V, Pᵀ·dO, dS·K and dSᵀ·Q, where the
// Pallas kernels multiply in f32: one rounding (relative 2^-9 in bf16, 2^-12
// in f16) per term, which the tolerances against the plain PyTorch versions
// cover. The forward divides O by the sum of the rounded P that P·V
// multiplied, so that O's weights sum to 1 as they do in exact arithmetic,
// and takes lse from the sum of the unrounded P: a row whose O were off by
// a scale (the rounded and unrounded sums differ by up to 2^-9 of the sum)
// would carry that scale into delta = rowsum(dO ∘ O), and where a row's dQ
// nearly cancels, delta's error is most of it. Every kernel takes exp as
// 2^x on the special-function unit with scale·log2(e) folded into one
// multiply.
//
// One design serves all three (see the note above each kernel): a producer
// warp streams tiles by TMA into a ring of shared-memory stages guarded by
// mbarriers, and one or two consumer warpgroups run every product as wgmma
// while the next tiles load.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_launch.h"
#include "hopper.cuh"

namespace edl_flash {

constexpr int kTile = 64;          // rows one consumer warpgroup owns (wgmma's M)
constexpr float kNegInf = -1e30f;  // the TPU kernels' _NEG_INF sentinel
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {  // element strides of a (B, S, H, D) view; D has unit stride
  long long b, s, h;
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Key tiles of TK keys [0, n) holding a key that some row of the kTile-row
// query tile at local row q0 can see.
template <int TK>
__device__ __forceinline__ int key_tiles(int Sk, int q0, int q_offset, int k_offset, int causal) {
  int n = (Sk + TK - 1) / TK;
  if (causal) {
    const long long last = (long long)q_offset + q0 + kTile - 1 - k_offset;  // last visible key
    const long long lim = last < 0 ? 0 : last / TK + 1;
    if (lim < n) n = (int)lim;
  }
  return n;
}

// The first query tile of kTile rows that sees some key of the key tile at
// local key k0.
__device__ __forceinline__ int first_query_tile(int k0, int q_offset, int k_offset, int causal) {
  if (!causal) return 0;
  const long long need = (long long)k_offset + k0 - q_offset - (kTile - 1);
  return need <= 0 ? 0 : (int)((need + kTile - 1) / kTile);
}

// Key tiles of TK keys [0, n_open) that every row of the warpgroup whose
// first row is wg_row0 sees whole: each tile is wholly inside Sk and wholly
// visible to that first row (and so to every later row, none of which sees no
// key). The masked tiles (the diagonal, the ragged edge) come after them.
template <int TK>
__device__ __forceinline__ int open_key_tiles(int n_kt, int Sk, int wg_row0, int q_offset,
                                              int k_offset, int causal) {
  int last_open = Sk - TK;
  const int last_visible = q_offset + wg_row0 - k_offset - TK + 1;
  if (causal && last_visible < last_open) last_open = last_visible;
  const int n_open = last_open < 0 ? 0 : last_open / TK + 1;
  return n_open < n_kt ? n_open : n_kt;
}

// -- shared pieces --------------------------------------------------------------
//
// Every kernel runs one or two consumer warpgroups and one producer warp:
// each consumer warpgroup owns 64 rows of the block's tile and runs wgmma on
// them; one thread of the producer warp issues the TMA loads (in dkv the
// whole warp also stages lse and delta). With two consumer warpgroups (9
// warps a block), three warps share one quarter of the SM's register file,
// so ptxas gives each thread at most 168 registers; with one (5 warps), two
// share a quarter, and ptxas gives up to 255. The tiles are sized to that.
// Up to DP 64: two consumers, 64 keys per forward and dq stage (S, P and O,
// or S, dP, dS and dQ, in registers together), and a dkv that forms Pᵀ and
// dSᵀ only between its products. At DP 128 the accumulators double (dQ 64
// registers a thread, dK and dV 128): dq and the forward's 128-key tile
// spill a little, and dkv, whose dK and dV alone take 128, runs one consumer
// warpgroup a block (`dkv_consumers`). (Handing the producer's registers to
// the consumers with setmaxnreg left ptxas's allocation at 168: PERF.md.) At
// DP 192 and 256 one warpgroup's O or dQ takes 96 or 128 registers a thread,
// so the forward and dq run one consumer warpgroup a block too
// (`row_consumers`), dq with 32-key stages (`dq_keys`: S, dP and dS then
// take 40 registers, not 80); and dK plus dV (192 or 256) no longer fit one
// thread's 255, so dkv runs as two passes over the same tiles
// (`dkv_passes`): one recomputes P and sums dV, the other recomputes P and
// dP and sums dK.

constexpr int kSmemMax = 232448;  // dynamic shared memory a block can take on the H100

constexpr int kDkvRows = 64;  // query rows per dkv pipeline stage
static_assert(kDkvRows == kTile, "first_query_tile() counts dkv query tiles of kTile rows");

// The forward's and dq's consumer warpgroups a block, kTile query rows each:
// two up to DP 128, one from DP 192.
template <int DP>
__host__ __device__ constexpr int row_consumers() {
  return DP >= 192 ? 1 : 2;
}

// dq's keys a pipeline stage: 64, and 32 from DP 192.
template <int DP>
__host__ __device__ constexpr int dq_keys() {
  return DP >= 192 ? 32 : 64;
}

// dkv's consumer warpgroups a block, 64 keys each: one from DP 128, two below.
template <int DP>
__host__ __device__ constexpr int dkv_consumers() {
  return DP >= 128 ? 1 : 2;
}

// What one dkv launch sums: dK and dV together, or (from DP 192, where they
// do not fit one thread's registers together) dV alone, then dK alone.
enum DkvPass { kDkvBoth = 0, kDkvDv = 1, kDkvDk = 2 };

template <int DP>
__host__ __device__ constexpr int dkv_passes() {
  return DP >= 192 ? 2 : 1;
}

__host__ __device__ constexpr int block_threads(int consumers) { return consumers * 128 + 32; }

// Every layout's shared memory below is checked against kSmemMax where it is
// instantiated, so each compiled variant is known to fit.

// The forward's shared memory at DP, ROWS query rows a block and KEYS keys a
// stage: the Q tile, the K/V stages (as many as fit, at most 4) and the
// barriers.
template <int DP, int ROWS, int KEYS>
struct FwdSmem {
  static constexpr int kQBytes = ROWS * DP * 2, kKVBytes = KEYS * DP * 2;
  static constexpr int kFit = (kSmemMax - 1024 - kQBytes - 9 * 8) / (2 * kKVBytes);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr size_t kBytes = 1024 + kQBytes + 2 * kStages * kKVBytes + (1 + 2 * kStages) * 8;
  static_assert(kStages >= 2 && kBytes <= kSmemMax, "forward shared memory");
};

// dq's: the Q and dO tiles of ROWS rows, the K/V stages of KEYS keys (as
// many as fit, at most 4) and the barriers.
template <int DP, int ROWS, int KEYS>
struct DqSmem {
  static constexpr int kQBytes = ROWS * DP * 2, kKVBytes = KEYS * DP * 2;
  static constexpr int kFit = (kSmemMax - 1024 - 2 * kQBytes - 9 * 8) / (2 * kKVBytes);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr size_t kBytes =
      1024 + 2 * kQBytes + 2 * kStages * kKVBytes + (1 + 2 * kStages) * 8;
  static_assert(kStages >= 2 && kBytes <= kSmemMax, "dq shared memory");
};

// dkv's: the K and V tiles of KEYS keys, the Q/dO stages of kDkvRows rows
// with their lse and delta (as many as fit, at most 3) and the barriers.
template <int DP, int KEYS>
struct DkvSmem {
  static constexpr int kKVBytes = KEYS * DP * 2, kQBytes = kDkvRows * DP * 2;
  static constexpr int kStageBytes = 2 * kQBytes + 2 * kDkvRows * (int)sizeof(float);
  static constexpr int kFit = (kSmemMax - 1024 - 2 * kKVBytes - 7 * 8) / kStageBytes;
  static constexpr int kStages = kFit < 3 ? kFit : 3;
  static constexpr size_t kBytes =
      1024 + 2 * kKVBytes + kStages * kStageBytes + (1 + 2 * kStages) * 8;
  static_assert(kStages >= 2 && kBytes <= kSmemMax, "dkv shared memory");
};

// The block's dynamic shared memory, moved up to a 1024-byte boundary (the
// 128-byte swizzle's period); launches ask for 1024 bytes of slack.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024u - (hopper::smem_addr(raw) & 1023u)) & 1023u);
}

// 64 x (2·N) columns of a tile (f32, accumulator layout: N values a thread)
// to the A fragments of a product that reduces over those columns, 16
// columns each: the accumulator layout of a 64 x 16 slice is the A
// operand's layout.
template <typename T, int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 8][4], const float (&x)[N]) {
#pragma unroll
  for (int jj = 0; jj < N / 8; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[jj][e] = hopper::Elem<T>::pack(x[8 * jj + 2 * e], x[8 * jj + 2 * e + 1]);
}

// The same for NC chunks of 64 columns, each chunk's accumulator of its own.
template <typename T, int NC>
__device__ __forceinline__ void pack_a(uint32_t (&a)[NC * 4][4], const float (&x)[NC][32]) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        a[4 * c + jj][e] =
            hopper::Elem<T>::pack(x[c][8 * jj + 2 * e], x[c][8 * jj + 2 * e + 1]);
}

// Two adjacent outputs of a thread's row to global memory in T.
template <typename T>
__device__ __forceinline__ void store2(T* p, float x0, float x1) {
  *reinterpret_cast<uint32_t*>(p) = hopper::Elem<T>::pack(x0, x1);
}

// X = A·Bᵀ (64 x BROWS) for one warpgroup, left uncommitted: A is the
// warpgroup's own 64 rows (descriptor ax, of a tile of AROWS rows), B a tile
// of BROWS rows (32 or 64), both K-major.
template <typename T, int DP, int AROWS, int BROWS>
__device__ __forceinline__ void issue_abt(float (&x)[BROWS / 2], uint64_t ax, const T* bx_tile) {
  using hopper::desc_add;
  using hopper::kmajor_step;
  const uint64_t bx = hopper::make_desc<DP, BROWS>(bx_tile);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    hopper::wgmma_ss<T, BROWS>(x, desc_add(ax, kmajor_step<DP, AROWS>(kk)),
                               desc_add(bx, kmajor_step<DP, BROWS>(kk)), kk);
  }
}

// X = A_x·B_xᵀ and Y = A_y·B_yᵀ for one warpgroup, in one commit group.
// dq: S = Q·Kᵀ and dP = dO·Vᵀ; dkv: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ.
template <typename T, int DP, int AROWS, int BROWS>
__device__ __forceinline__ void issue_abt_pair(float (&x)[BROWS / 2], float (&y)[BROWS / 2],
                                               uint64_t ax, uint64_t ay, const T* bx_tile,
                                               const T* by_tile) {
  issue_abt<T, DP, AROWS, BROWS>(x, ax, bx_tile);
  issue_abt<T, DP, AROWS, BROWS>(y, ay, by_tile);
  hopper::wgmma_commit();
}

// acc (64 x DP) += A·B for one warpgroup, left uncommitted: A (64 x K) in
// fragments in registers, B a tile of K rows read MN-major (its rows are the
// reduction index, its DP columns N, across the chunks). P·V, dS·K, Pᵀ·dO
// and dSᵀ·Q. Past DP 128 each step is two products, on columns 0-127 and on
// the rest (from chunk 2 on): a thread's accumulator of the 64 x DP product
// is theirs laid end to end.
template <typename T, int DP, int K>
__device__ __forceinline__ void issue_rs_mn(float (&acc)[DP / 2], const uint32_t (&a)[K / 16][4],
                                            const T* b_tile) {
  constexpr int kN0 = DP > 128 ? 128 : DP, kN1 = DP - kN0;
  constexpr uint32_t kN1Offset = 2 * K * hopper::Span<DP>::kSpan * 2;  // chunk 2's bytes
  const uint64_t b = hopper::make_desc<DP, K>(b_tile);
  float(&acc0)[kN0 / 2] = *reinterpret_cast<float(*)[kN0 / 2]>(&acc[0]);
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t step = kk * 16 * hopper::Span<DP>::kSpan * 2;
    hopper::wgmma_rs_mn<T, kN0>(acc0, a[kk], hopper::desc_add(b, step));
    if constexpr (kN1 > 0) {
      float(&acc1)[kN1 / 2] = *reinterpret_cast<float(*)[kN1 / 2]>(&acc[kN0 / 2]);
      hopper::wgmma_rs_mn<T, kN1>(acc1, a[kk], hopper::desc_add(b, kN1Offset + step));
    }
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
// row max (log2 units), the per-thread partial sum l of P is rescaled and
// grows, and alpha is the factor that rescales O (and the sum of the rounded
// P, `packed_row_sums`). Unless kMasked, every entry is visible and no mask
// is evaluated. The code is branch-free, so it can run while a wgmma is in
// flight.
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

// lr (the two rows' per-thread partial sums of P as P·V multiplies it, in
// T) rescaled by alpha and grown by this tile's packed P: the values the
// pack rounded, read back from the pairs without a conversion.
template <typename T, int N>
__device__ __forceinline__ void packed_row_sums(float (&lr)[2], const float (&alpha)[2],
                                                const uint32_t (&pa)[N][4]) {
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int jj = 0; jj < N; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[e & 1] += hopper::Elem<T>::sum2(pa[jj][e]);  // row e & 1
  lr[0] = lr[0] * alpha[0] + s[0];
  lr[1] = lr[1] * alpha[1] + s[1];
}

// S (64 x KEYS) = Q·Kᵀ for one warpgroup: its Q rows (descriptor dq, of the
// ROWS-row Q tile) and a K tile of KEYS rows, both K-major, in chunks of 64
// keys.
template <typename T, int DP, int KEYS, int ROWS>
__device__ __forceinline__ void fwd_issue_s(float (&sc)[KEYS / 64][32], uint64_t dq,
                                            const T* k_tile) {
  using hopper::desc_add;
  using hopper::kmajor_step;
#pragma unroll
  for (int c = 0; c < KEYS / 64; ++c) {
    const uint64_t dk = hopper::make_desc<DP, KEYS>(k_tile + c * 64 * hopper::Span<DP>::kSpan);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      hopper::wgmma_ss<T, 64>(sc[c], desc_add(dq, kmajor_step<DP, ROWS>(kk)),
                              desc_add(dk, kmajor_step<DP, KEYS>(kk)), kk);
    }
  }
  hopper::wgmma_commit();
}

// One step of a consumer warpgroup's pipeline at key tile kt >= 1: issue
// S = Q·K_ktᵀ and O += P_(kt-1)·V_(kt-1), run the softmax of tile kt while
// P·V runs, release tile kt - 1's stage, rescale O and pack P_kt.
template <typename T, int DP, int KEYS, int ROWS, int STAGES, bool kMasked>
__device__ __forceinline__ void fwd_step(int kt, float (&sc)[KEYS / 64][32],
                                         uint32_t (&pa)[KEYS / 16][4], float (&acc)[DP / 2],
                                         float (&m)[2], float (&l)[2], float (&lr)[2], uint64_t dq,
                                         const T* sk, const T* sv, uint64_t* full,
                                         uint64_t* empty, const FwdRows& rows) {
  using namespace hopper;
  const int s = kt % STAGES, prev = (kt - 1) % STAGES;
  mbar_wait(&full[s], (kt / STAGES) & 1);
  wgmma_fence();
  fwd_issue_s<T, DP, KEYS, ROWS>(sc, dq, sk + s * KEYS * DP);
  issue_rs_mn<T, DP, KEYS>(acc, pa, sv + prev * KEYS * DP);
  wgmma_commit();
  wgmma_wait<1>();  // S done, P·V may still run
  fence_regs(sc);
  float alpha[2];
  fwd_softmax<kMasked>(sc, m, l, alpha, kt * KEYS, rows);
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(pa);
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[prev]);
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
  pack_a<T>(pa, sc);
  packed_row_sums<T>(lr, alpha, pa);
}

// Replaces _fwd_kernel of edl_tpu/ops/flash_attention.py.
// Bound on the H100: 4·D FLOPs per visible (query, key) pair against 8·D
// bytes per row moved (16-bit q, k, v, o), so a causal sequence of 1024 at D
// 64 sits near the ridge and the LM's 2048 at D 128 is FLOP-bound (~0.069 ms
// of bf16 FLOPs at B 4, H 16; 0.139 ms at D 256). Design: one block owns 128
// query rows (64 from DP 192: `row_consumers`) of one (batch, head), the
// heaviest query tiles launched first. The producer loads
// the Q tile once and streams KEYS-key K and V tiles by TMA through a ring of
// stages (full/empty mbarriers), so later tiles load while this one is
// multiplied. Each consumer warpgroup computes S = Q·Kᵀ for its 64 rows as
// wgmma with both operands in shared memory, runs the online softmax on the
// accumulator fragment (the mask is evaluated only on tiles that cross the
// diagonal or the ragged edge), rounds P to T in registers and feeds it as
// the register operand of O += P·V, with V read MN-major. The warpgroup
// issues S of tile kt and P·V of tile kt - 1 together and runs the softmax
// of tile kt while P·V runs, so the exponentials overlap the tensor cores.
// S and P never leave registers; each K/V tile is read once per block.
// KEYS (64 or 128) is the tile that the tuning table picks
// (ops/flash_tuning.py): 128 halves the stages' barrier round trips and
// doubles the softmax's registers. NC is the consumer warpgroups a block.
template <typename T, int DP, int KEYS, int NC>
__global__ void __launch_bounds__(block_threads(NC), 1) flash_fwd_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, void* __restrict__ o, float* __restrict__ lse,
    int H, int Sq, int Sk, int D, int q_offset, int k_offset, float scale_log2, int causal,
    int out_f32) {
  using namespace hopper;
  constexpr int kRows = NC * kTile;  // query rows a block
  using Smem = FwdSmem<DP, kRows, KEYS>;
  constexpr int kStages = Smem::kStages, kQBytes = Smem::kQBytes, kKVBytes = Smem::kKVBytes;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  T* sq = reinterpret_cast<T*>(smem);
  T* sk = reinterpret_cast<T*>(smem + kQBytes);
  T* sv = reinterpret_cast<T*>(smem + kQBytes + kStages * kKVBytes);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + kQBytes + 2 * kStages * kKVBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int n_qt = (Sq + kRows - 1) / kRows;
  const int BH = gridDim.x / n_qt;
  const int qt = n_qt - 1 - blockIdx.x / BH;  // the last query tiles carry the most keys
  const int bh = blockIdx.x % BH, b = bh / H, h = bh % H;
  const int q0 = qt * kRows;
  // the key tiles that the block's last kTile rows see
  const int n_kt = key_tiles<KEYS>(Sk, q0 + kRows - kTile, q_offset, k_offset, causal);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC * 4);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NC) {  // the producer warp
    if (threadIdx.x == NC * 128) {  // one thread issues every load
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      mbar_arrive_expect_tx(q_full, kQBytes);
      tma_load_tile<DP, kRows>(sq, &tq, q_full, h, q0, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * kKVBytes);
        tma_load_tile<DP, KEYS>(sk + s * KEYS * DP, &tk, &full[s], h, kt * KEYS, b);
        tma_load_tile<DP, KEYS>(sv + s * KEYS * DP, &tv, &full[s], h, kt * KEYS, b);
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
    float m[2] = {kNegInf, kNegInf};  // rows g and g + 8, log2 units
    float l[2] = {0.f, 0.f}, lr[2] = {0.f, 0.f};  // the sums of P and of P rounded to T
    float sc[KEYS / 64][32];    // S, then P in f32, keys 64·c + ..., accumulator layout
    uint32_t pa[KEYS / 16][4];  // P in T: the A fragments of P·V
    float alpha[2];             // the first tile's: O is still 0

    mbar_wait(q_full, 0);
    const uint64_t dq = make_desc<DP, kRows>(sq + wg * 64 * Span<DP>::kSpan);
    const int n_open = open_key_tiles<KEYS>(n_kt, Sk, wg_row0, q_offset, k_offset, causal);

    // Software pipeline inside the warpgroup: while the tensor cores run
    // O += P·V of tile kt - 1, the softmax of tile kt runs on S. The code
    // between a wgmma's issue and its wait has no branch: the mask is a
    // template parameter of each loop, not a runtime test.
    if (n_kt > 0) {
      mbar_wait(&full[0], 0);
      wgmma_fence();
      fwd_issue_s<T, DP, KEYS, kRows>(sc, dq, sk);
      wgmma_wait<0>();
      fence_regs(sc);
      if (n_open > 0) {
        fwd_softmax<false>(sc, m, l, alpha, 0, rows);
      } else {
        fwd_softmax<true>(sc, m, l, alpha, 0, rows);
      }
      pack_a<T>(pa, sc);
      packed_row_sums<T>(lr, alpha, pa);
    }
    for (int kt = 1; kt < n_open; ++kt) {
      fwd_step<T, DP, KEYS, kRows, kStages, false>(kt, sc, pa, acc, m, l, lr, dq, sk, sv, full,
                                                   empty, rows);
    }
    for (int kt = n_open > 1 ? n_open : 1; kt < n_kt; ++kt) {
      fwd_step<T, DP, KEYS, kRows, kStages, true>(kt, sc, pa, acc, m, l, lr, dq, sk, sv, full,
                                                  empty, rows);
    }
    if (n_kt > 0) {
      wgmma_fence();
      issue_rs_mn<T, DP, KEYS>(acc, pa, sv + (n_kt - 1) % kStages * KEYS * DP);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
    }

    const int g = lane >> 2;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = quad_sum(l[r]);
      lr[r] = quad_sum(lr[r]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      if (row >= Sq) continue;
      // O's weights are the rounded P; a row with no key: acc is 0, so O = 0
      const float norm = lr[r] > 0.f ? lr[r] : 1.f;
      const long long base = (((long long)b * Sq + row) * H + h) * D;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int d = j * 8 + 2 * t;
        if (d >= D) continue;
        const float x0 = acc[4 * j + 2 * r] / norm, x1 = acc[4 * j + 2 * r + 1] / norm;
        if (out_f32) {
          *reinterpret_cast<float2*>(static_cast<float*>(o) + base + d) = make_float2(x0, x1);
        } else {
          store2(static_cast<T*>(o) + base + d, x0, x1);
        }
      }
      if (t == 0) {
        lse[(long long)bh * Sq + row] = l[r] > 0.f ? m[r] * kLn2 + logf(l[r]) : kNegInf;
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
template <bool kMasked, int N>
__device__ __forceinline__ void dq_probs(const float (&sc)[N], float (&dp)[N], int key0,
                                         const DqRows& q) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
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
template <typename T, int DP, int ROWS, int KEYS, int STAGES, bool kMasked>
__device__ __forceinline__ void dq_step(int kt, float (&sc)[KEYS / 2], float (&dp)[KEYS / 2],
                                        uint32_t (&da)[KEYS / 16][4], float (&acc)[DP / 2],
                                        uint64_t dqd, uint64_t dod, const T* sk, const T* sv,
                                        uint64_t* full, uint64_t* empty, const DqRows& rows) {
  using namespace hopper;
  const int s = kt % STAGES, prev = (kt - 1) % STAGES;
  mbar_wait(&full[s], (kt / STAGES) & 1);
  wgmma_fence();
  issue_abt_pair<T, DP, ROWS, KEYS>(sc, dp, dqd, dod, sk + s * KEYS * DP, sv + s * KEYS * DP);
  issue_rs_mn<T, DP, KEYS>(acc, da, sk + prev * KEYS * DP);
  wgmma_commit();
  wgmma_wait<1>();  // S and dP done, dS·K may still run
  fence_regs(sc);
  fence_regs(dp);
  dq_probs<kMasked>(sc, dp, kt * KEYS, rows);
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(da);
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[prev]);
  pack_a<T>(da, dp);
}

// Replaces _bwd_dq_kernel of edl_tpu/ops/flash_attention.py.
// Bound on the H100: 6·D FLOPs per visible pair (S, dP and dS·K products)
// against 10·D bytes per row (q, k, v, dO in, dQ out): FLOP-bound at the
// LM's shapes. Design: the forward's dataflow. One block owns 128 query rows
// (64 from DP 192: `row_consumers`) of one (batch, head), the heaviest query
// tiles launched first; each consumer warpgroup owns 64 of them and keeps
// their lse (times log2 e) and delta in registers. The producer loads the Q
// and dO tiles once and streams KEYS-key K and V tiles (`dq_keys`: 64, 32
// from DP 192) by TMA through a ring of up to 4 stages. S = Q·Kᵀ and dP = dO·Vᵀ
// are wgmma with both operands in shared memory; dS is formed in registers
// (masked only on tiles that cross the warpgroup's diagonal or the ragged
// edge), rounded to T and fed as the register operand of dQ += dS·K, with
// the same K tile read MN-major. The warpgroup issues S and dP of tile kt
// together with dS·K of tile kt - 1 and forms dS of tile kt while that
// product runs. dQ stays in f32 registers and is written once: each block
// owns its output rows, so there are no atomics and the sums are
// deterministic. Both warpgroups wait on and release every stage the
// producer fills, also where their rows see no key of it; a block that sees
// no key loads nothing and writes dQ = 0.
template <typename T, int DP, int NC, int KEYS>
__global__ void __launch_bounds__(block_threads(NC), 1) flash_bwd_dq_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dq,
    int H, int Sq, int Sk, int D, int q_offset, int k_offset, float scale, float scale_log2,
    int causal) {
  using namespace hopper;
  constexpr int kRows = NC * kTile;  // query rows a block
  using Smem = DqSmem<DP, kRows, KEYS>;
  constexpr int kStages = Smem::kStages, kQBytes = Smem::kQBytes, kKVBytes = Smem::kKVBytes;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  T* sq = reinterpret_cast<T*>(smem);
  T* sdo = reinterpret_cast<T*>(smem + kQBytes);
  T* sk = reinterpret_cast<T*>(smem + 2 * kQBytes);
  T* sv = reinterpret_cast<T*>(smem + 2 * kQBytes + kStages * kKVBytes);
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(smem + 2 * kQBytes + 2 * kStages * kKVBytes);
  uint64_t* full = qdo_full + 1;
  uint64_t* empty = full + kStages;

  const int n_qt = (Sq + kRows - 1) / kRows;
  const int BH = gridDim.x / n_qt;
  const int qt = n_qt - 1 - blockIdx.x / BH;  // the last query tiles carry the most keys
  const int bh = blockIdx.x % BH, b = bh / H, h = bh % H;
  const int q0 = qt * kRows;
  // the key tiles that the block's last kTile rows see
  const int n_kt = key_tiles<KEYS>(Sk, q0 + kRows - kTile, q_offset, k_offset, causal);

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC * 4);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NC) {  // the producer warp
    if (threadIdx.x == NC * 128 && n_kt > 0) {  // one thread issues every load
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tdo);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      mbar_arrive_expect_tx(qdo_full, 2 * kQBytes);
      tma_load_tile<DP, kRows>(sq, &tq, qdo_full, h, q0, b);
      tma_load_tile<DP, kRows>(sdo, &tdo, qdo_full, h, q0, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * kKVBytes);
        tma_load_tile<DP, KEYS>(sk + s * KEYS * DP, &tk, &full[s], h, kt * KEYS, b);
        tma_load_tile<DP, KEYS>(sv + s * KEYS * DP, &tv, &full[s], h, kt * KEYS, b);
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
      float sc[KEYS / 2], dp[KEYS / 2];  // S and dP, then dS in dp: f32, accumulator layout
      uint32_t da[KEYS / 16][4];         // dS in T: the A fragments of dS·K
      mbar_wait(qdo_full, 0);
      const uint64_t dqd = make_desc<DP, kRows>(sq + wg * 64 * Span<DP>::kSpan);
      const uint64_t dod = make_desc<DP, kRows>(sdo + wg * 64 * Span<DP>::kSpan);
      const int n_open = open_key_tiles<KEYS>(n_kt, Sk, wg_row0, q_offset, k_offset, causal);

      // The code between a wgmma's issue and its wait has no branch: the mask
      // is a template parameter of each loop, not a runtime test.
      mbar_wait(&full[0], 0);
      wgmma_fence();
      issue_abt_pair<T, DP, kRows, KEYS>(sc, dp, dqd, dod, sk, sv);
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      if (n_open > 0) {
        dq_probs<false>(sc, dp, 0, rows);
      } else {
        dq_probs<true>(sc, dp, 0, rows);
      }
      pack_a<T>(da, dp);
      for (int kt = 1; kt < n_open; ++kt) {
        dq_step<T, DP, kRows, KEYS, kStages, false>(kt, sc, dp, da, acc, dqd, dod, sk, sv, full,
                                                    empty, rows);
      }
      for (int kt = n_open > 1 ? n_open : 1; kt < n_kt; ++kt) {
        dq_step<T, DP, kRows, KEYS, kStages, true>(kt, sc, dp, da, acc, dqd, dod, sk, sv, full,
                                                   empty, rows);
      }
      wgmma_fence();
      issue_rs_mn<T, DP, KEYS>(acc, da, sk + (n_kt - 1) % kStages * KEYS * DP);
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
        if (d < D) store2(dq + base + d, acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
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
// every entry is visible and no mask is evaluated. The dV pass forms Pᵀ
// alone (dpt is not read), the dK pass dSᵀ alone (st is left as Sᵀ).
template <bool kMasked, int PASS>
__device__ __forceinline__ void dkv_probs(float (&st)[32], float (&dpt)[32], const float* ls,
                                          const float* dl, int q0, const DkvKeys& k) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    const int qi = (i >> 2) * 8 + 2 * k.t + (i & 1);  // query row within the tile
    const bool ok = !kMasked || (k.krow + 8 * r < k.Sk && q0 + qi < k.Sq &&
                                (!k.causal || k.kpos + 8 * r <= k.q_offset + q0 + qi));
    const float p = ok ? hopper::exp2_approx(st[i] * k.scale_log2 - ls[qi]) : 0.f;
    if constexpr (PASS != kDkvDk) st[i] = p;
    if constexpr (PASS != kDkvDv) dpt[i] = p * (dpt[i] - dl[qi]) * k.scale;
  }
}

// Replaces _bwd_dkv_kernel of edl_tpu/ops/flash_attention.py.
// Bound on the H100: 8·D FLOPs per visible pair (Sᵀ, dPᵀ, dV and dK products)
// against 12·D bytes per row: FLOP-bound at the LM's shapes. Design:
// key-tile outer, query-tile inner. One block owns 64 keys a consumer
// warpgroup (`dkv_consumers`: 128 keys, 64 from DP 128) of one (batch, head),
// the earliest (most-seen) key tiles launched first. K and V are loaded once
// by TMA; 64-query tiles of Q and dO stream through a ring of up to 3 stages
// by TMA, with their lse (pre-multiplied by log2 e) and delta stored beside
// them by the producer warp, from the first query tile that can see the
// block's keys. Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ are wgmma with both operands in
// shared memory; Pᵀ and dSᵀ are formed in registers (masked only on tiles
// that cross the diagonal or the ragged edge), rounded to T and fed as
// register operands of dV += Pᵀ·dO and dK += dSᵀ·Q with dO and Q read
// MN-major. dK and dV stay in f32 registers and are written once: each block
// owns its output rows, so there are no atomics and the sums are
// deterministic. PASS (`DkvPass`) is what the launch sums: from DP 192 the
// dV pass (Sᵀ, Pᵀ, Pᵀ·dO; V is not loaded) and then the dK pass (Sᵀ, dPᵀ,
// dSᵀ, dSᵀ·Q) each recompute Pᵀ from lse, 10·D FLOPs a visible pair in all.
template <typename T, int DP, int PASS>
__global__ void __launch_bounds__(block_threads(dkv_consumers<DP>()), 1) flash_bwd_dkv_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dk,
    T* __restrict__ dv, int H, int Sq, int Sk, int D, int q_offset, int k_offset,
    float scale, float scale_log2, int causal) {
  using namespace hopper;
  constexpr bool kSumDv = PASS != kDkvDk, kSumDk = PASS != kDkvDv;
  constexpr int kConsumersDkv = dkv_consumers<DP>(), kKeys = kConsumersDkv * kTile;
  using Smem = DkvSmem<DP, kKeys>;
  constexpr int kStages = Smem::kStages, kKVBytes = Smem::kKVBytes, kQBytes = Smem::kQBytes;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  T* sk = reinterpret_cast<T*>(smem);
  T* sv = reinterpret_cast<T*>(smem + kKVBytes);
  T* sq = reinterpret_cast<T*>(smem + 2 * kKVBytes);
  T* sdo = reinterpret_cast<T*>(smem + 2 * kKVBytes + kStages * kQBytes);
  float* slse = reinterpret_cast<float*>(smem + 2 * kKVBytes + 2 * kStages * kQBytes);
  float* sdelta = slse + kStages * kDkvRows;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sdelta + kStages * kDkvRows);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int n_kt = (Sk + kKeys - 1) / kKeys;
  const int BH = gridDim.x / n_kt;
  const int kt = blockIdx.x / BH;  // the first key tiles are seen by the most queries
  const int bh = blockIdx.x % BH, b = bh / H, h = bh % H;
  const int k0 = kt * kKeys;
  const int n_qt = (Sq + kDkvRows - 1) / kDkvRows;
  const int qt0 = first_query_tile(k0, q_offset, k_offset, causal);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);                  // the producer warp's 32 lanes
      mbar_init(&empty[s], kConsumersDkv * 4);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;
  if (wg == kConsumersDkv) {  // the producer warp
    if (lane == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tdo);
      mbar_arrive_expect_tx(kv_full, (kSumDk ? 2 : 1) * kKVBytes);
      tma_load_tile<DP, kKeys>(sk, &tk, kv_full, h, k0, b);
      if constexpr (kSumDk) tma_load_tile<DP, kKeys>(sv, &tv, kv_full, h, k0, b);
    }
    const float* lseb = lse + (long long)bh * Sq;
    const float* deltab = delta + (long long)bh * Sq;
    for (int qt = qt0, it = 0; qt < n_qt; ++qt, ++it) {
      const int s = it % kStages, q0 = qt * kDkvRows;
      mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      for (int r = lane; r < kDkvRows; r += 32) {
        const bool ok = q0 + r < Sq;
        slse[s * kDkvRows + r] = ok ? lseb[q0 + r] * kLog2e : 0.f;
        sdelta[s * kDkvRows + r] = ok ? deltab[q0 + r] : 0.f;
      }
      if (lane == 0) {  // its arrival releases its own stores, as every lane's does
        mbar_arrive_expect_tx(&full[s], 2 * kQBytes);
        tma_load_tile<DP, kDkvRows>(sq + s * kDkvRows * DP, &tq, &full[s], h, q0, b);
        tma_load_tile<DP, kDkvRows>(sdo + s * kDkvRows * DP, &tdo, &full[s], h, q0, b);
      } else {
        mbar_arrive(&full[s]);
      }
    }
  } else {  // consumer warpgroup wg: keys k0 + 64·wg ...
    const int g = lane >> 2, t = lane & 3;
    const int wg_key0 = k0 + wg * 64;
    const int krow0 = wg_key0 + ((threadIdx.x >> 5) & 3) * 16;  // this warp's first key
    const int kpos = k_offset + krow0 + g;                       // global position of key g

    // dK and dV, each only in the pass that sums it
    float dk_acc[kSumDk ? DP / 2 : 1], dv_acc[kSumDv ? DP / 2 : 1];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) {
      if constexpr (kSumDk) dk_acc[i] = 0.f;
      if constexpr (kSumDv) dv_acc[i] = 0.f;
    }

    float st[32], dpt[32];        // Sᵀ and dPᵀ, then Pᵀ and dSᵀ in f32: rows are keys
    uint32_t pa[4][4], da[4][4];  // Pᵀ and dSᵀ in T: the A fragments

    mbar_wait(kv_full, 0);
    const uint64_t dkd = make_desc<DP, kKeys>(sk + wg * 64 * Span<DP>::kSpan);
    const uint64_t dvd = make_desc<DP, kKeys>(sv + wg * 64 * Span<DP>::kSpan);
    const DkvKeys keys = {kpos, krow0 + g, t, Sq, Sk, causal, q_offset, scale, scale_log2};
    // Query tile qt is masked iff it crosses the ragged edge or this
    // warpgroup's diagonal (its first query does not see all 64 keys).
    const bool keys_ragged = wg_key0 + 64 > Sk;
    const int diag = k_offset + wg_key0 + 63 - q_offset;  // first query that sees all

    for (int qt = qt0, it = 0; qt < n_qt; ++qt, ++it) {
      const int s = it % kStages, q0 = qt * kDkvRows;
      const T* q_tile = sq + s * kDkvRows * DP;
      const T* do_tile = sdo + s * kDkvRows * DP;
      mbar_wait(&full[s], (it / kStages) & 1);
      wgmma_fence();
      if constexpr (kSumDk) {
        issue_abt_pair<T, DP, kKeys, kDkvRows>(st, dpt, dkd, dvd, q_tile, do_tile);
      } else {
        issue_abt<T, DP, kKeys, kDkvRows>(st, dkd, q_tile);
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs(st);
      if constexpr (kSumDk) fence_regs(dpt);
      if (keys_ragged || q0 + kDkvRows > Sq || (causal && q0 < diag)) {
        dkv_probs<true, PASS>(st, dpt, slse + s * kDkvRows, sdelta + s * kDkvRows, q0, keys);
      } else {
        dkv_probs<false, PASS>(st, dpt, slse + s * kDkvRows, sdelta + s * kDkvRows, q0, keys);
      }
      if constexpr (kSumDv) pack_a<T>(pa, st);
      if constexpr (kSumDk) pack_a<T>(da, dpt);
      wgmma_fence();
      if constexpr (kSumDv) issue_rs_mn<T, DP, kDkvRows>(dv_acc, pa, do_tile);
      if constexpr (kSumDk) issue_rs_mn<T, DP, kDkvRows>(dk_acc, da, q_tile);
      wgmma_commit();
      wgmma_wait<0>();
      if constexpr (kSumDv) {
        fence_regs(dv_acc);
        fence_regs(pa);
      }
      if constexpr (kSumDk) {
        fence_regs(dk_acc);
        fence_regs(da);
      }
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
          if constexpr (kSumDk) {
            store2(dk + base + d, dk_acc[4 * j + 2 * r], dk_acc[4 * j + 2 * r + 1]);
          }
          if constexpr (kSumDv) {
            store2(dv + base + d, dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
          }
        }
      }
    }
  }
}

// -- launchers ----------------------------------------------------------------

// cuTensorMapEncodeTiled, a driver-API function, fetched through the runtime
// so that the library needs no link against libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
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

// The TMA map of a (B, S, H, D) view of T with element strides `st` (unit
// stride along D), in boxes of one chunk's columns x 1 x `rows` x 1
// elements, swizzled by the span of one chunk row. TMA needs a 16-byte
// aligned start and byte strides that are multiples of 16; elements outside
// the view (d >= D, s >= S) load as 0.
template <typename T, int DP>
cudaError_t view_map(CUtensorMap* map, const void* base, int B, int S, int H, int D, Strides st,
                     int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  constexpr int kSpan = hopper::Span<DP>::kSpan;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.s * 2, (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {kSpan, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = kSpan == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : kSpan == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult rc = encode(map, hopper::Elem<T>::kTma, 4, const_cast<void*>(base), dims,
                             strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int DP>
cudaError_t view_map(CUtensorMap* map, const View& x, int B, int S, int H, int D, int rows) {
  return view_map<T, DP>(map, x.ptr, B, S, H, D, Strides{x.sb, x.ss, x.sh}, rows);
}

template <typename T, int DP, int KEYS>
cudaError_t launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  constexpr int kNC = row_consumers<DP>(), kRows = kNC * kTile;
  using Smem = FwdSmem<DP, kRows, KEYS>;
  CUtensorMap tq, tk, tv;
  cudaError_t rc = allow_smem(flash_fwd_kernel<T, DP, KEYS, kNC>, Smem::kBytes);
  if (rc == cudaSuccess) rc = view_map<T, DP>(&tq, a.q, a.B, a.Sq, a.H, a.D, kRows);
  if (rc == cudaSuccess) rc = view_map<T, DP>(&tk, a.k, a.B, a.Sk, a.H, a.D, KEYS);
  if (rc == cudaSuccess) rc = view_map<T, DP>(&tv, a.v, a.B, a.Sk, a.H, a.D, KEYS);
  if (rc != cudaSuccess) return rc;
  const int blocks = a.B * a.H * ((a.Sq + kRows - 1) / kRows);
  flash_fwd_kernel<T, DP, KEYS, kNC><<<blocks, block_threads(kNC), Smem::kBytes, stream>>>(
      tq, tk, tv, a.o, a.lse, a.H, a.Sq, a.Sk, a.D, a.q_offset, a.k_offset, a.scale * kLog2e,
      a.causal, a.out_f32);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_bwd_dq(const BwdArgs& a, cudaStream_t stream) {
  constexpr int kNC = row_consumers<DP>(), kRows = kNC * kTile, kKeys = dq_keys<DP>();
  using Smem = DqSmem<DP, kRows, kKeys>;
  const View dout = {a.dout, (long long)a.Sq * a.H * a.D, (long long)a.H * a.D, a.D};
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t rc = allow_smem(flash_bwd_dq_kernel<T, DP, kNC, kKeys>, Smem::kBytes);
  if (rc == cudaSuccess) rc = view_map<T, DP>(&tq, a.q, a.B, a.Sq, a.H, a.D, kRows);
  if (rc == cudaSuccess) rc = view_map<T, DP>(&tdo, dout, a.B, a.Sq, a.H, a.D, kRows);
  if (rc == cudaSuccess) rc = view_map<T, DP>(&tk, a.k, a.B, a.Sk, a.H, a.D, kKeys);
  if (rc == cudaSuccess) rc = view_map<T, DP>(&tv, a.v, a.B, a.Sk, a.H, a.D, kKeys);
  if (rc != cudaSuccess) return rc;
  const int blocks = a.B * a.H * ((a.Sq + kRows - 1) / kRows);
  flash_bwd_dq_kernel<T, DP, kNC, kKeys><<<blocks, block_threads(kNC), Smem::kBytes, stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<T*>(a.dq), a.H, a.Sq, a.Sk, a.D, a.q_offset,
      a.k_offset, a.scale, a.scale * kLog2e, a.causal);
  return cudaGetLastError();
}

// One dkv launch summing what PASS names (`DkvPass`).
template <typename T, int DP, int PASS>
cudaError_t launch_bwd_dkv_pass(const BwdArgs& a, cudaStream_t stream) {
  constexpr int kNC = dkv_consumers<DP>(), kKeys = kNC * kTile;
  using Smem = DkvSmem<DP, kKeys>;
  const View dout = {a.dout, (long long)a.Sq * a.H * a.D, (long long)a.H * a.D, a.D};
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t rc = allow_smem(flash_bwd_dkv_kernel<T, DP, PASS>, Smem::kBytes);
  if (rc == cudaSuccess) rc = view_map<T, DP>(&tq, a.q, a.B, a.Sq, a.H, a.D, kDkvRows);
  if (rc == cudaSuccess) rc = view_map<T, DP>(&tdo, dout, a.B, a.Sq, a.H, a.D, kDkvRows);
  if (rc == cudaSuccess) rc = view_map<T, DP>(&tk, a.k, a.B, a.Sk, a.H, a.D, kKeys);
  if (rc == cudaSuccess) rc = view_map<T, DP>(&tv, a.v, a.B, a.Sk, a.H, a.D, kKeys);
  if (rc != cudaSuccess) return rc;
  const int blocks = a.B * a.H * ((a.Sk + kKeys - 1) / kKeys);
  flash_bwd_dkv_kernel<T, DP, PASS><<<blocks, block_threads(kNC), Smem::kBytes, stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.Sq,
      a.Sk, a.D, a.q_offset, a.k_offset, a.scale, a.scale * kLog2e, a.causal);
  return cudaGetLastError();
}

// dK and dV: one launch, or (`dkv_passes`) the dV pass and then the dK pass
// on the same stream.
template <typename T, int DP>
cudaError_t launch_bwd_dkv(const BwdArgs& a, cudaStream_t stream) {
  if constexpr (dkv_passes<DP>() == 1) {
    return launch_bwd_dkv_pass<T, DP, kDkvBoth>(a, stream);
  } else {
    const cudaError_t rc = launch_bwd_dkv_pass<T, DP, kDkvDv>(a, stream);
    return rc == cudaSuccess ? launch_bwd_dkv_pass<T, DP, kDkvDk>(a, stream) : rc;
  }
}

}  // namespace edl_flash
