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
// the 3xTF32 kernels of flash_*_f32*.cu instead, and head dims past 256 to
// the sliced kernels of flash_sliced.cuh.
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
// One dataflow serves all three (see the note above each kernel): a producer
// streams tiles by TMA into a ring of shared-memory stages guarded by
// mbarriers, and consumer warpgroups run every product as wgmma while the
// next tiles load. All three run a producer warpgroup and two consumer
// warpgroups, with the registers moved to the consumers by setmaxnreg.

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

// The warpgroup of this thread, broadcast from lane 0, so that the compiler
// knows the role branches that test it are warp-uniform: ptxas allocates the
// code after a setmaxnreg against its new limit only in such a branch.
__device__ __forceinline__ int warpgroup_index() {
  return __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
}

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

// Column slices of `width` that cover a head dim D (the sliced kernels).
__host__ __device__ constexpr int slices_of(int D, int width) { return (D + width - 1) / width; }

// The grid of a sliced kernel: (batch, head) x row tiles of `rows` x column
// slices of `width`, or 0 if that is past one launch's 2^31 - 1 blocks.
inline unsigned sliced_blocks(int B, int H, int S, int D, int rows, int width) {
  const long long n = (long long)B * H * ((S + rows - 1) / rows) * slices_of(D, width);
  return n < (1ll << 31) ? (unsigned)n : 0u;
}

// A warp's release of a ring stage or buffer (an mbarrier that counts one
// arrival per consumer warp): its lanes are done with it.
__device__ __forceinline__ void release_stage(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(bar);
}

// -- shared pieces --------------------------------------------------------------
//
// The register budget. Every kernel of this file runs three warpgroups a
// block (384 threads): a producer warpgroup, one thread of which issues every
// TMA load (in dkv one warp of it also stages lse and delta), and two
// consumer warpgroups that run every product as wgmma. At launch the SM's
// 65,536 registers give each of the 384 threads 168, which is what `ptxas
// -v` reports for these kernels. Right after the role split the producer
// warpgroup drops to kProducerRegs with setmaxnreg.dec and the consumers
// rise to kConsumerRegs with setmaxnreg.inc (128·24 + 256·240 = 64,512), and
// ptxas allocates each role's code against its own limit: the consumers'
// SASS names registers past 168 (up to R219 in the forward at DP 256, R189
// in dkv) and holds no local-memory load or store (chip_smoke.py checks
// both). That holds only while the kernel holds no `trap`: with an
// mbarrier wait that traps after a time bound ptxas still named registers
// past 168 but chose its spills against 168, so every wait spins without a
// bound (`mbar_wait_spin`; PERF.md §7). At DP 256 a forward consumer
// holds O (128 registers a thread) and S (32) or P packed (16); a dkv
// consumer holds dV or dK (128) and its 32 query columns of Sᵀ and dPᵀ (16
// each); a dq consumer holds dQ (128), S and dP of a 32-key stage (16 each)
// and dS packed (8).

constexpr int kWsThreads = 384;  // a block: 2 consumer + 1 producer warpgroups
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kPingBarrier = 1;  // named barriers 1 and 2: the forward's and dq's ping-pong
constexpr int kDkvBarrier = 1;   // dkv's hand-over of Pᵀ and dSᵀ

constexpr int kSmemMax = 232448;  // dynamic shared memory a block can take on the H100

constexpr int kDkvRows = 64;  // query rows per dkv pipeline stage
static_assert(kDkvRows == kTile, "first_query_tile() counts dkv query tiles of kTile rows");

// Whether a forward consumer warpgroup issues S of key tile kt together with
// P·V of tile kt - 1 and runs the softmax of tile kt while P·V runs: up to DP
// 128. From DP 192 O, S and P together with the products in flight need more
// than the consumers' kConsumerRegs, so a warpgroup runs S, the softmax and
// P·V of a tile in turn, and the other warpgroup's products fill the tensor
// cores meanwhile (`PingPong`).
template <int DP>
__host__ __device__ constexpr bool fwd_overlap() {
  return DP <= 128;
}

// How dkv's two consumer warpgroups share a block's keys. Up to DP 128 each
// owns 64 of the block's 128 keys and forms its Pᵀ and dSᵀ in registers, the
// register operands of its own dV and dK products (at DP 128 dK, dV, Sᵀ,
// dPᵀ and their packed forms take up to R223 of the consumers' 240); 64 keys
// a block would stream Q and dO twice as often for the same sums. From DP
// 192 (dK and dV together no longer fit a thread) the two share 64 keys:
// each forms Pᵀ and dSᵀ for half of a query tile's columns into shared
// memory, then warpgroup 0 sums dV and warpgroup 1 dK.
template <int DP>
__host__ __device__ constexpr bool dkv_own_keys() {
  return DP <= 128;
}

// dq's keys a pipeline stage: 64, and 32 from DP 192. At DP 256 a stage of
// 64 keys (64 KB of K and V) leaves room for one stage beside the 128 KB of
// Q and dO; 32 keys leave room for three. At DP 192, 32 keys (four stages)
// ran faster on the H100 than 64 (two stages): PERF.md §6.
template <int DP>
__host__ __device__ constexpr int dq_keys() {
  return DP >= 192 ? 32 : 64;
}

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

// dkv's: the K and V tiles of kKeys keys (`dkv_own_keys`: 128 or 64), where
// the warpgroups share the keys two Pᵀ and two dSᵀ tiles (kTile keys x
// kDkvRows queries, one for the query tile being formed and one for the
// tile being summed), the Q/dO stages of kDkvRows rows with their lse and
// delta (as many as fit, at most 3) and the barriers.
template <int DP>
struct DkvSmem {
  static constexpr int kKeys = dkv_own_keys<DP>() ? 2 * kTile : kTile;
  static constexpr int kKVBytes = kKeys * DP * 2, kQBytes = kDkvRows * DP * 2;
  static constexpr int kPBytes = dkv_own_keys<DP>() ? 0 : 2 * 2 * kTile * kDkvRows * 2;
  static constexpr int kStageBytes = 2 * kQBytes + 2 * kDkvRows * (int)sizeof(float);
  static constexpr int kFit = (kSmemMax - 1024 - 2 * kKVBytes - kPBytes - 7 * 8) / kStageBytes;
  static constexpr int kStages = kFit < 3 ? kFit : 3;
  static constexpr size_t kBytes =
      1024 + 2 * kKVBytes + kPBytes + kStages * kStageBytes + (1 + 2 * kStages) * 8;
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

// X = A·Bᵀ (64 x N) for one warpgroup, left uncommitted: A is the
// warpgroup's own 64 rows (descriptor ax, of a tile of AROWS rows), B the N
// rows (32 or 64) from bx_rows of a tile of BROWS rows, both K-major.
template <typename T, int DP, int AROWS, int BROWS, int N = BROWS>
__device__ __forceinline__ void issue_abt(float (&x)[N / 2], uint64_t ax, const T* bx_rows) {
  using hopper::desc_add;
  using hopper::kmajor_step;
  const uint64_t bx = hopper::make_desc<DP, BROWS>(bx_rows);
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    hopper::wgmma_ss<T, N>(x, desc_add(ax, kmajor_step<DP, AROWS>(kk)),
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

// The same with A (64 x K) in shared memory, a kTile-row tile of K
// 16-bit columns stored K-major and 128B-swizzled (`store_swizzled`;
// descriptor a): dkv's Pᵀ·dO and dSᵀ·Q.
template <typename T, int DP, int K>
__device__ __forceinline__ void issue_ss_mn(float (&acc)[DP / 2], uint64_t a, const T* b_tile) {
  constexpr int kN0 = DP > 128 ? 128 : DP, kN1 = DP - kN0;
  constexpr uint32_t kN1Offset = 2 * K * hopper::Span<DP>::kSpan * 2;  // chunk 2's bytes
  const uint64_t b = hopper::make_desc<DP, K>(b_tile);
  float(&acc0)[kN0 / 2] = *reinterpret_cast<float(*)[kN0 / 2]>(&acc[0]);
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t step = kk * 16 * hopper::Span<DP>::kSpan * 2;
    const uint64_t ak = hopper::desc_add(a, hopper::kmajor_step<K, kTile>(kk));
    hopper::wgmma_ss_mn<T, kN0>(acc0, ak, hopper::desc_add(b, step));
    if constexpr (kN1 > 0) {
      float(&acc1)[kN1 / 2] = *reinterpret_cast<float(*)[kN1 / 2]>(&acc[kN0 / 2]);
      hopper::wgmma_ss_mn<T, kN1>(acc1, ak, hopper::desc_add(b, kN1Offset + step));
    }
  }
}

// A thread's part of a kTile x 64 tile in the accumulator layout (x: N / 4
// groups of 8 columns from column col0, rows row and row + 8), rounded to T
// and stored as TMA stores a tile of 64 16-bit columns: 128-byte rows,
// 128B-swizzled (the 16-byte unit u of row R at unit u ^ (R mod 8)), so that
// `make_desc<64, kTile>` reads it. The tile starts on a 1024-byte boundary.
template <typename T, int N>
__device__ __forceinline__ void store_swizzled(T* tile, const float (&x)[N], int row, int col0) {
  unsigned char* base = reinterpret_cast<unsigned char*>(tile);
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int R = row + 8 * r, C = col0 + 8 * j;
      const int off = R * 128 + ((((C >> 3) ^ R) & 7) << 4) + (C & 7) * 2;
      *reinterpret_cast<uint32_t*>(base + off) =
          hopper::Elem<T>::pack(x[4 * j + 2 * r], x[4 * j + 2 * r + 1]);
    }
}

// The order of the two consumer warpgroups' wgmma issues (the ping-pong),
// over named barriers kPingBarrier (warpgroup 0 waits there) and
// kPingBarrier + 1 (warpgroup 1): before each issue a warpgroup waits for
// the other's arrival after its previous issue, and after the issue it
// arrives for the other, so that one warpgroup's products run on the tensor
// cores while the other runs its softmax. Warpgroup 0 issues first: it skips
// its first wait and warpgroup 1 its last arrival, so each barrier completes
// as often as it is waited on. Both pass the same n issue points.
struct PingPong {
  int wg, n, i;
  __device__ __forceinline__ void before() {
    if (wg == 1 || i > 0) hopper::named_bar_sync(kPingBarrier + wg, 256);
  }
  __device__ __forceinline__ void after() {
    if (wg == 0 || i < n - 1) hopper::named_bar_arrive(kPingBarrier + (wg ^ 1), 256);
    ++i;
  }
};

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
// S = Q·K_ktᵀ and O += P_(kt-1)·V_(kt-1) in the warpgroups' turn (`pp`), run
// the softmax of tile kt while P·V runs, release tile kt - 1's stage,
// rescale O and pack P_kt.
template <typename T, int DP, int KEYS, int ROWS, int STAGES, bool kMasked>
__device__ __forceinline__ void fwd_step(int kt, float (&sc)[KEYS / 64][32],
                                         uint32_t (&pa)[KEYS / 16][4], float (&acc)[DP / 2],
                                         float (&m)[2], float (&l)[2], float (&lr)[2], uint64_t dq,
                                         const T* sk, const T* sv, uint64_t* full,
                                         uint64_t* empty, const FwdRows& rows, PingPong& pp) {
  using namespace hopper;
  const int s = kt % STAGES, prev = (kt - 1) % STAGES;
  mbar_wait_spin(&full[s], (kt / STAGES) & 1);
  pp.before();
  wgmma_fence();
  fwd_issue_s<T, DP, KEYS, ROWS>(sc, dq, sk + s * KEYS * DP);
  issue_rs_mn<T, DP, KEYS>(acc, pa, sv + prev * KEYS * DP);
  wgmma_commit();
  pp.after();
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

// One tile of a consumer warpgroup that does not overlap its own products
// (`fwd_overlap`): S = Q·K_ktᵀ in the warpgroups' turn, the softmax, O
// rescaled, P packed, O += P·V, and tile kt's stage released.
template <typename T, int DP, int KEYS, int ROWS, int STAGES, bool kMasked>
__device__ __forceinline__ void fwd_tile(int kt, float (&sc)[KEYS / 64][32],
                                         uint32_t (&pa)[KEYS / 16][4], float (&acc)[DP / 2],
                                         float (&m)[2], float (&l)[2], float (&lr)[2], uint64_t dq,
                                         const T* sk, const T* sv, uint64_t* full,
                                         uint64_t* empty, const FwdRows& rows, PingPong& pp) {
  using namespace hopper;
  const int s = kt % STAGES;
  mbar_wait_spin(&full[s], (kt / STAGES) & 1);
  pp.before();
  wgmma_fence();
  fwd_issue_s<T, DP, KEYS, ROWS>(sc, dq, sk + s * KEYS * DP);
  pp.after();
  wgmma_wait<0>();
  fence_regs(sc);
  float alpha[2];
  fwd_softmax<kMasked>(sc, m, l, alpha, kt * KEYS, rows);
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
  pack_a<T>(pa, sc);
  packed_row_sums<T>(lr, alpha, pa);
  wgmma_fence();
  issue_rs_mn<T, DP, KEYS>(acc, pa, sv + s * KEYS * DP);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(pa);
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[s]);
}

// Replaces _fwd_kernel of edl_tpu/ops/flash_attention.py.
// Bound on the H100: 4·D FLOPs per visible (query, key) pair against 8·D
// bytes per row moved (16-bit q, k, v, o), so a causal sequence of 1024 at D
// 64 sits near the ridge and the LM's 2048 at D 128 is FLOP-bound (~0.069 ms
// of bf16 FLOPs at B 4, H 16; 0.139 ms at D 256). Design: one block owns 128
// query rows of one (batch, head) at every DP, the heaviest query tiles
// launched first, so each K/V tile read from L2 serves 128 rows. A producer
// warpgroup (setmaxnreg down to kProducerRegs) loads the Q tile once and
// streams KEYS-key K and V tiles by TMA through a ring of stages
// (full/empty mbarriers). Two consumer warpgroups (setmaxnreg up to
// kConsumerRegs) own 64 rows each: each computes S = Q·Kᵀ for its rows as
// wgmma with both operands in shared memory, runs the online softmax on the
// accumulator fragment (the mask is evaluated only on tiles that cross the
// diagonal or the ragged edge), rounds P to T in registers and feeds it as
// the register operand of O += P·V, with V read MN-major. Inside a
// warpgroup, S of tile kt and P·V of tile kt - 1 issue together and the
// softmax of tile kt runs while P·V runs (up to DP 128: `fwd_overlap`);
// between the warpgroups, named barriers take turns (`PingPong`), so one
// warpgroup's products run while the other's softmax does. S and P never leave registers; each K/V tile is
// read once per block. KEYS (64 or 128) is the tile that the tuning table
// picks (ops/flash_tuning.py): 128 halves the stages' barrier round trips
// and doubles the softmax's registers.
template <typename T, int DP, int KEYS>
__global__ void __launch_bounds__(kWsThreads, 1) flash_fwd_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, void* __restrict__ o, float* __restrict__ lse,
    int H, int Sq, int Sk, int D, int q_offset, int k_offset, float scale_log2, int causal,
    int out_f32) {
  using namespace hopper;
  constexpr int kRows = 2 * kTile;  // query rows a block
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
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = warpgroup_index();
  if (wg == 2) {  // the producer warpgroup
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 256) {  // one thread issues every load
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      mbar_arrive_expect_tx(q_full, kQBytes);
      tma_load_tile<DP, kRows>(sq, &tq, q_full, h, q0, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        mbar_wait_spin(&empty[s], ((kt / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * kKVBytes);
        tma_load_tile<DP, KEYS>(sk + s * KEYS * DP, &tk, &full[s], h, kt * KEYS, b);
        tma_load_tile<DP, KEYS>(sv + s * KEYS * DP, &tv, &full[s], h, kt * KEYS, b);
      }
    }
  } else {  // consumer warpgroup wg: query rows q0 + 64·wg ...
    setmaxnreg_inc<kConsumerRegs>();
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

    mbar_wait_spin(q_full, 0);
    const uint64_t dq = make_desc<DP, kRows>(sq + wg * 64 * Span<DP>::kSpan);
    const int n_open = open_key_tiles<KEYS>(n_kt, Sk, wg_row0, q_offset, k_offset, causal);

    // The code between a wgmma's issue and its wait has no branch: the mask
    // is a template parameter of each loop, not a runtime test.
    if constexpr (fwd_overlap<DP>()) {
      // Software pipeline inside the warpgroup: while the tensor cores run
      // O += P·V of tile kt - 1, the softmax of tile kt runs on S. n_kt + 1
      // issue points: S of tile 0, the n_kt - 1 steps, the last P·V.
      PingPong pp = {wg, n_kt + 1, 0};
      float alpha[2];  // the first tile's: O is still 0
      if (n_kt > 0) {
        mbar_wait_spin(&full[0], 0);
        pp.before();
        wgmma_fence();
        fwd_issue_s<T, DP, KEYS, kRows>(sc, dq, sk);
        pp.after();
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
        fwd_step<T, DP, KEYS, kRows, kStages, false>(kt, sc, pa, acc, m, l, lr, dq, sk, sv,
                                                     full, empty, rows, pp);
      }
      for (int kt = n_open > 1 ? n_open : 1; kt < n_kt; ++kt) {
        fwd_step<T, DP, KEYS, kRows, kStages, true>(kt, sc, pa, acc, m, l, lr, dq, sk, sv,
                                                    full, empty, rows, pp);
      }
      if (n_kt > 0) {
        pp.before();
        wgmma_fence();
        issue_rs_mn<T, DP, KEYS>(acc, pa, sv + (n_kt - 1) % kStages * KEYS * DP);
        wgmma_commit();
        pp.after();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(pa);
      }
    } else {
      PingPong pp = {wg, n_kt, 0};  // one issue point a tile: its S
      for (int kt = 0; kt < n_open; ++kt) {
        fwd_tile<T, DP, KEYS, kRows, kStages, false>(kt, sc, pa, acc, m, l, lr, dq, sk, sv,
                                                     full, empty, rows, pp);
      }
      for (int kt = n_open; kt < n_kt; ++kt) {
        fwd_tile<T, DP, KEYS, kRows, kStages, true>(kt, sc, pa, acc, m, l, lr, dq, sk, sv,
                                                    full, empty, rows, pp);
      }
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
// S = Q·K_ktᵀ and dP = dO·V_ktᵀ, then dQ += dS_(kt-1)·K_(kt-1), in the
// warpgroups' turn (`pp`); form dS_kt while that product runs, release
// tile kt - 1's stage and pack dS_kt.
template <typename T, int DP, int ROWS, int KEYS, int STAGES, bool kMasked>
__device__ __forceinline__ void dq_step(int kt, float (&sc)[KEYS / 2], float (&dp)[KEYS / 2],
                                        uint32_t (&da)[KEYS / 16][4], float (&acc)[DP / 2],
                                        uint64_t dqd, uint64_t dod, const T* sk, const T* sv,
                                        uint64_t* full, uint64_t* empty, const DqRows& rows,
                                        PingPong& pp) {
  using namespace hopper;
  const int s = kt % STAGES, prev = (kt - 1) % STAGES;
  mbar_wait_spin(&full[s], (kt / STAGES) & 1);
  pp.before();
  wgmma_fence();
  issue_abt_pair<T, DP, ROWS, KEYS>(sc, dp, dqd, dod, sk + s * KEYS * DP, sv + s * KEYS * DP);
  issue_rs_mn<T, DP, KEYS>(acc, da, sk + prev * KEYS * DP);
  wgmma_commit();
  pp.after();
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
// LM's shapes (~0.104 ms at B 4, S 2048, H 16, D 128; 0.209 ms at D 256).
// Design: the forward's. One block owns 128 query rows of one (batch, head)
// at every DP, the heaviest query tiles launched first, so each K/V tile
// read from L2 serves 128 rows. A producer warpgroup (setmaxnreg down to
// kProducerRegs) loads the Q and dO tiles once and streams KEYS-key K and V
// tiles (`dq_keys`: 64, 32 from DP 192) by TMA through a ring of up to 4
// stages. Two consumer warpgroups (setmaxnreg up to kConsumerRegs) own 64
// rows each and keep their lse (times log2 e) and delta in registers: S =
// Q·Kᵀ and dP = dO·Vᵀ are wgmma with both operands in shared memory; dS is
// formed in registers (masked only on tiles that cross the warpgroup's
// diagonal or the ragged edge), rounded to T and fed as the register
// operand of dQ += dS·K, with the same K tile read MN-major. A warpgroup
// issues S and dP of tile kt together with dS·K of tile kt - 1 and forms dS
// of tile kt while that product runs; between the warpgroups, named
// barriers take turns at the issues (`PingPong`). dQ stays in
// f32 registers and is written once: each block owns its output rows, so
// there are no atomics and the sums are deterministic. Both warpgroups wait
// on and release every stage the producer fills, also where their rows see
// no key of it; a block that sees no key loads nothing and writes dQ = 0.
template <typename T, int DP, int KEYS>
__global__ void __launch_bounds__(kWsThreads, 1) flash_bwd_dq_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dq,
    int H, int Sq, int Sk, int D, int q_offset, int k_offset, float scale, float scale_log2,
    int causal) {
  using namespace hopper;
  constexpr int kRows = 2 * kTile;  // query rows a block
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
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = warpgroup_index();
  if (wg == 2) {  // the producer warpgroup
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 256 && n_kt > 0) {  // one thread issues every load
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tdo);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      mbar_arrive_expect_tx(qdo_full, 2 * kQBytes);
      tma_load_tile<DP, kRows>(sq, &tq, qdo_full, h, q0, b);
      tma_load_tile<DP, kRows>(sdo, &tdo, qdo_full, h, q0, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        mbar_wait_spin(&empty[s], ((kt / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * kKVBytes);
        tma_load_tile<DP, KEYS>(sk + s * KEYS * DP, &tk, &full[s], h, kt * KEYS, b);
        tma_load_tile<DP, KEYS>(sv + s * KEYS * DP, &tv, &full[s], h, kt * KEYS, b);
      }
    }
  } else {  // consumer warpgroup wg: query rows q0 + 64·wg ...
    setmaxnreg_inc<kConsumerRegs>();
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
      // n_kt + 1 issue points: S and dP of tile 0, the n_kt - 1 steps, the last dS·K
      PingPong pp = {wg, n_kt + 1, 0};
      mbar_wait_spin(qdo_full, 0);
      const uint64_t dqd = make_desc<DP, kRows>(sq + wg * 64 * Span<DP>::kSpan);
      const uint64_t dod = make_desc<DP, kRows>(sdo + wg * 64 * Span<DP>::kSpan);
      const int n_open = open_key_tiles<KEYS>(n_kt, Sk, wg_row0, q_offset, k_offset, causal);

      // The code between a wgmma's issue and its wait has no branch: the mask
      // is a template parameter of each loop, not a runtime test.
      mbar_wait_spin(&full[0], 0);
      pp.before();
      wgmma_fence();
      issue_abt_pair<T, DP, kRows, KEYS>(sc, dp, dqd, dod, sk, sv);
      pp.after();
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
                                                    empty, rows, pp);
      }
      for (int kt = n_open > 1 ? n_open : 1; kt < n_kt; ++kt) {
        dq_step<T, DP, kRows, KEYS, kStages, true>(kt, sc, dp, da, acc, dqd, dod, sk, sv, full,
                                                   empty, rows, pp);
      }
      pp.before();
      wgmma_fence();
      issue_rs_mn<T, DP, KEYS>(acc, da, sk + (n_kt - 1) % kStages * KEYS * DP);
      wgmma_commit();
      pp.after();
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

// Pᵀ = exp(Sᵀ·scale − lse) and dSᵀ = Pᵀ ∘ (dPᵀ − delta) · scale in place, on
// a thread's part of N / 4 groups of 8 query columns whose first query is
// q0, with their lse (times log2 e) and delta at `ls` and `dl`; masked
// entries are exactly 0 through their validity. Unless kMasked, every entry
// is visible and no mask is evaluated.
template <bool kMasked, int N>
__device__ __forceinline__ void dkv_probs(float (&st)[N], float (&dpt)[N], const float* ls,
                                          const float* dl, int q0, const DkvKeys& k) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = (i >> 1) & 1;
    const int qi = (i >> 2) * 8 + 2 * k.t + (i & 1);  // query column from q0
    const bool ok = !kMasked || (k.krow + 8 * r < k.Sk && q0 + qi < k.Sq &&
                                (!k.causal || k.kpos + 8 * r <= k.q_offset + q0 + qi));
    const float p = ok ? hopper::exp2_approx(st[i] * k.scale_log2 - ls[qi]) : 0.f;
    st[i] = p;
    dpt[i] = p * (dpt[i] - dl[qi]) * k.scale;
  }
}

// Replaces _bwd_dkv_kernel of edl_tpu/ops/flash_attention.py.
// Bound on the H100: 8·D FLOPs per visible pair (Sᵀ, dPᵀ, dV and dK products)
// against 12·D bytes per row: FLOP-bound at the LM's shapes. Design:
// key-tile outer, query-tile inner, one launch at every DP and no product
// recomputed. One block owns kKeys keys of one (batch, head), the earliest
// (most-seen) key tiles launched first. A producer warpgroup (setmaxnreg
// down) loads K and V once by TMA and streams 64-query tiles of Q and dO
// through a ring of stages, with their lse (pre-multiplied by log2 e) and
// delta stored beside them by its first warp, from the first query tile
// that can see the block's keys. Two consumer warpgroups (setmaxnreg up)
// compute Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ as wgmma with both operands in shared
// memory and form Pᵀ and dSᵀ in f32 (masked only on tiles that cross the
// diagonal or the ragged edge), in one of two layouts (`dkv_own_keys`):
//  * up to DP 128, 128 keys a block, 64 a warpgroup: each warpgroup forms
//    all of its tile's Pᵀ and dSᵀ, rounds them to T in registers and feeds
//    them as the register operands of dV += Pᵀ·dO and dK += dSᵀ·Q, with dO
//    and Q read MN-major;
//  * from DP 192, 64 keys a block, shared: warpgroup w computes Sᵀ and dPᵀ
//    for queries 32w ... 32w + 31 (N = 32) and stores Pᵀ and dSᵀ, rounded
//    to T, into shared memory as 128B-swizzled K-major tiles; a named
//    barrier hands the two halves over, and warpgroup 0 sums dV += Pᵀ·dO
//    and warpgroup 1 dK += dSᵀ·Q, each a wgmma with A the whole 64 x 64
//    tile in shared memory. The Pᵀ and dSᵀ tiles are double-buffered, so a
//    warpgroup may form tile i + 1 while the other still sums tile i.
// dK and dV stay in f32 registers and are written once: each block owns its
// output rows, so there are no atomics and the sums are deterministic.
template <typename T, int DP>
__global__ void __launch_bounds__(kWsThreads, 1) flash_bwd_dkv_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dk,
    T* __restrict__ dv, int H, int Sq, int Sk, int D, int q_offset, int k_offset,
    float scale, float scale_log2, int causal) {
  using namespace hopper;
  using Smem = DkvSmem<DP>;
  constexpr int kStages = Smem::kStages, kKVBytes = Smem::kKVBytes, kQBytes = Smem::kQBytes;
  constexpr int kKeys = Smem::kKeys;
  constexpr int kPTile = Smem::kPBytes ? kTile * kDkvRows : 0;  // one Pᵀ or dSᵀ tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  T* sk = reinterpret_cast<T*>(smem);
  T* sv = reinterpret_cast<T*>(smem + kKVBytes);
  T* sq = reinterpret_cast<T*>(smem + 2 * kKVBytes);
  T* sdo = reinterpret_cast<T*>(smem + 2 * kKVBytes + kStages * kQBytes);
  T* spt = reinterpret_cast<T*>(smem + 2 * kKVBytes + 2 * kStages * kQBytes);  // 2 Pᵀ tiles
  T* sdst = spt + 2 * kPTile;                                                   // 2 dSᵀ tiles
  float* slse = reinterpret_cast<float*>(sdst + 2 * kPTile);
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
      mbar_init(&full[s], 32);  // the producer warp's 32 lanes
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = warpgroup_index();
  const int lane = threadIdx.x & 31;
  if (wg == 2) {  // the producer warpgroup; its first warp works
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 256 + 32) {
      if (lane == 0) {
        tma_prefetch_map(&tq);
        tma_prefetch_map(&tdo);
        mbar_arrive_expect_tx(kv_full, 2 * kKVBytes);
        tma_load_tile<DP, kKeys>(sk, &tk, kv_full, h, k0, b);
        tma_load_tile<DP, kKeys>(sv, &tv, kv_full, h, k0, b);
      }
      const float* lseb = lse + (long long)bh * Sq;
      const float* deltab = delta + (long long)bh * Sq;
      for (int qt = qt0, it = 0; qt < n_qt; ++qt, ++it) {
        const int s = it % kStages, q0 = qt * kDkvRows;
        mbar_wait_spin(&empty[s], ((it / kStages) & 1) ^ 1);
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
    }
  } else if constexpr (dkv_own_keys<DP>()) {  // consumer warpgroup wg: keys k0 + 64·wg ...
    setmaxnreg_inc<kConsumerRegs>();
    const int g = lane >> 2, t = lane & 3;
    const int wg_key0 = k0 + wg * 64;
    const int krow0 = wg_key0 + ((threadIdx.x >> 5) & 3) * 16;  // this warp's first key
    const DkvKeys keys = {k_offset + krow0 + g, krow0 + g, t, Sq, Sk, causal, q_offset,
                          scale, scale_log2};

    float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    float st[32], dpt[32];        // Sᵀ and dPᵀ, then Pᵀ and dSᵀ in f32: rows are keys
    uint32_t pa[4][4], da[4][4];  // Pᵀ and dSᵀ in T: the A fragments

    mbar_wait_spin(kv_full, 0);
    const uint64_t kd = make_desc<DP, kKeys>(sk + wg * 64 * Span<DP>::kSpan);
    const uint64_t vd = make_desc<DP, kKeys>(sv + wg * 64 * Span<DP>::kSpan);
    // Query tile qt is masked iff it crosses the ragged edge or this
    // warpgroup's diagonal (its first query does not see all 64 keys).
    const bool keys_ragged = wg_key0 + 64 > Sk;
    const int diag = k_offset + wg_key0 + 63 - q_offset;  // first query that sees all

    for (int qt = qt0, it = 0; qt < n_qt; ++qt, ++it) {
      const int s = it % kStages, q0 = qt * kDkvRows;
      const T* q_tile = sq + s * kDkvRows * DP;
      const T* do_tile = sdo + s * kDkvRows * DP;
      mbar_wait_spin(&full[s], (it / kStages) & 1);
      wgmma_fence();
      issue_abt_pair<T, DP, kKeys, kDkvRows>(st, dpt, kd, vd, q_tile, do_tile);
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      const float* ls = slse + s * kDkvRows;
      const float* dl = sdelta + s * kDkvRows;
      if (keys_ragged || q0 + kDkvRows > Sq || (causal && q0 < diag)) {
        dkv_probs<true>(st, dpt, ls, dl, q0, keys);
      } else {
        dkv_probs<false>(st, dpt, ls, dl, q0, keys);
      }
      pack_a<T>(pa, st);
      pack_a<T>(da, dpt);
      wgmma_fence();
      issue_rs_mn<T, DP, kDkvRows>(dv_acc, pa, do_tile);
      issue_rs_mn<T, DP, kDkvRows>(dk_acc, da, q_tile);
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
          store2(dk + base + d, dk_acc[4 * j + 2 * r], dk_acc[4 * j + 2 * r + 1]);
          store2(dv + base + d, dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
        }
      }
    }
  } else {  // consumer warpgroup wg: queries 32·wg ... of each tile; dV (0) or dK (1)
    setmaxnreg_inc<kConsumerRegs>();
    const int g = lane >> 2, t = lane & 3;
    const int krow = ((threadIdx.x >> 5) & 3) * 16 + g;  // this thread's first key row
    const int col0 = 32 * wg;                            // this warpgroup's first query column
    const DkvKeys keys = {k_offset + k0 + krow, k0 + krow, t, Sq, Sk, causal, q_offset,
                          scale, scale_log2};

    float acc[DP / 2];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    float st[16], dpt[16];  // Sᵀ and dPᵀ, then Pᵀ and dSᵀ in f32: rows keys, 32 query columns

    mbar_wait_spin(kv_full, 0);
    const uint64_t kd = make_desc<DP, kTile>(sk);
    const uint64_t vd = make_desc<DP, kTile>(sv);
    // Query tile qt is masked iff it crosses the ragged edge or the block's
    // diagonal (its first query does not see all 64 keys).
    const bool keys_ragged = k0 + kTile > Sk;
    const int diag = k_offset + k0 + kTile - 1 - q_offset;  // first query that sees all

    for (int qt = qt0, it = 0; qt < n_qt; ++qt, ++it) {
      const int s = it % kStages, q0 = qt * kDkvRows;
      const T* q_tile = sq + s * kDkvRows * DP;
      const T* do_tile = sdo + s * kDkvRows * DP;
      mbar_wait_spin(&full[s], (it / kStages) & 1);
      wgmma_fence();
      issue_abt<T, DP, kTile, kDkvRows, 32>(st, kd, q_tile + col0 * Span<DP>::kSpan);
      issue_abt<T, DP, kTile, kDkvRows, 32>(dpt, vd, do_tile + col0 * Span<DP>::kSpan);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      const float* ls = slse + s * kDkvRows + col0;
      const float* dl = sdelta + s * kDkvRows + col0;
      if (keys_ragged || q0 + kDkvRows > Sq || (causal && q0 < diag)) {
        dkv_probs<true>(st, dpt, ls, dl, q0 + col0, keys);
      } else {
        dkv_probs<false>(st, dpt, ls, dl, q0 + col0, keys);
      }
      T* pt = spt + (it & 1) * kPTile;
      T* dst = sdst + (it & 1) * kPTile;
      store_swizzled<T>(pt, st, krow, col0 + 2 * t);
      store_swizzled<T>(dst, dpt, krow, col0 + 2 * t);
      fence_proxy_async();
      named_bar_sync(kDkvBarrier, 256);  // both halves of Pᵀ and dSᵀ are in place
      wgmma_fence();
      issue_ss_mn<T, DP, kDkvRows>(acc, make_desc<64, kTile>(wg == 0 ? pt : dst),
                                   wg == 0 ? do_tile : q_tile);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    T* out = wg == 0 ? dv : dk;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = k0 + krow + 8 * r;
      if (row >= Sk) continue;
      const long long base = (((long long)b * Sk + row) * H + h) * D;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int d = j * 8 + 2 * t;
        if (d < D) store2(out + base + d, acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
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
  constexpr int kRows = 2 * kTile;
  using Smem = FwdSmem<DP, kRows, KEYS>;
  CUtensorMap tq, tk, tv;
  cudaError_t rc = allow_smem(flash_fwd_kernel<T, DP, KEYS>, Smem::kBytes);
  if (rc == cudaSuccess) rc = view_map<T, DP>(&tq, a.q, a.B, a.Sq, a.H, a.D, kRows);
  if (rc == cudaSuccess) rc = view_map<T, DP>(&tk, a.k, a.B, a.Sk, a.H, a.D, KEYS);
  if (rc == cudaSuccess) rc = view_map<T, DP>(&tv, a.v, a.B, a.Sk, a.H, a.D, KEYS);
  if (rc != cudaSuccess) return rc;
  const int blocks = a.B * a.H * ((a.Sq + kRows - 1) / kRows);
  flash_fwd_kernel<T, DP, KEYS><<<blocks, kWsThreads, Smem::kBytes, stream>>>(
      tq, tk, tv, a.o, a.lse, a.H, a.Sq, a.Sk, a.D, a.q_offset, a.k_offset, a.scale * kLog2e,
      a.causal, a.out_f32);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_bwd_dq(const BwdArgs& a, cudaStream_t stream) {
  constexpr int kRows = 2 * kTile, kKeys = dq_keys<DP>();
  using Smem = DqSmem<DP, kRows, kKeys>;
  const View dout = {a.dout, (long long)a.Sq * a.H * a.D, (long long)a.H * a.D, a.D};
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t rc = allow_smem(flash_bwd_dq_kernel<T, DP, kKeys>, Smem::kBytes);
  if (rc == cudaSuccess) rc = view_map<T, DP>(&tq, a.q, a.B, a.Sq, a.H, a.D, kRows);
  if (rc == cudaSuccess) rc = view_map<T, DP>(&tdo, dout, a.B, a.Sq, a.H, a.D, kRows);
  if (rc == cudaSuccess) rc = view_map<T, DP>(&tk, a.k, a.B, a.Sk, a.H, a.D, kKeys);
  if (rc == cudaSuccess) rc = view_map<T, DP>(&tv, a.v, a.B, a.Sk, a.H, a.D, kKeys);
  if (rc != cudaSuccess) return rc;
  const int blocks = a.B * a.H * ((a.Sq + kRows - 1) / kRows);
  flash_bwd_dq_kernel<T, DP, kKeys><<<blocks, kWsThreads, Smem::kBytes, stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<T*>(a.dq), a.H, a.Sq, a.Sk, a.D, a.q_offset,
      a.k_offset, a.scale, a.scale * kLog2e, a.causal);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_bwd_dkv(const BwdArgs& a, cudaStream_t stream) {
  using Smem = DkvSmem<DP>;
  const View dout = {a.dout, (long long)a.Sq * a.H * a.D, (long long)a.H * a.D, a.D};
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t rc = allow_smem(flash_bwd_dkv_kernel<T, DP>, Smem::kBytes);
  if (rc == cudaSuccess) rc = view_map<T, DP>(&tq, a.q, a.B, a.Sq, a.H, a.D, kDkvRows);
  if (rc == cudaSuccess) rc = view_map<T, DP>(&tdo, dout, a.B, a.Sq, a.H, a.D, kDkvRows);
  if (rc == cudaSuccess) rc = view_map<T, DP>(&tk, a.k, a.B, a.Sk, a.H, a.D, Smem::kKeys);
  if (rc == cudaSuccess) rc = view_map<T, DP>(&tv, a.v, a.B, a.Sk, a.H, a.D, Smem::kKeys);
  if (rc != cudaSuccess) return rc;
  const int blocks = a.B * a.H * ((a.Sk + Smem::kKeys - 1) / Smem::kKeys);
  flash_bwd_dkv_kernel<T, DP><<<blocks, kWsThreads, Smem::kBytes, stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.Sq,
      a.Sk, a.D, a.q_offset, a.k_offset, a.scale, a.scale * kLog2e, a.causal);
  return cudaGetLastError();
}

}  // namespace edl_flash
