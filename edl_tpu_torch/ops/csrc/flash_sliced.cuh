// Flash attention for NVIDIA Hopper (sm_90a) at head dims past 256: the
// forward kernel and the two backward kernels for 16-bit inputs (bf16 and
// f16), templates that the flash_*_sliced.cu units instantiate. They compute
// what flash_kernels.cuh's kernels compute, with the same semantics (global
// positions, the ragged edge masked in the kernel, the -1e30 sentinel, masking
// through the validity bit, O divided by the sum of the rounded P and lse
// from the unrounded one; see that file's head), and replace the same Pallas
// TPU kernels of edl_tpu/ops/flash_attention.py where D > 256:
//
//   flash_fwd_sliced_kernel      <- _fwd_kernel
//   flash_bwd_dq_sliced_kernel   <- _bwd_dq_kernel
//   flash_bwd_dkv_sliced_kernel  <- _bwd_dkv_kernel
//
// What D past 256 changes. wgmma's N stops at 256, and at D 256 one consumer
// warpgroup's O or dQ already takes 128 of a thread's 240 registers; a
// 64-row tile of D 512 is 64 KB. So no warpgroup holds a whole row of the
// output, and no block holds every input of a tile:
//  * Column slices. A block owns the rows of a tile and a slice of the
//    output's columns: 256 of O (for 128 query rows, 64 a consumer
//    warpgroup), 512 of dQ (64 rows; each consumer warpgroup sums one
//    256-column half), 256 of dK and of dV (each consumer sums one). The last
//    slice is short where D is not a multiple of the slice: only its
//    64-column chunks that hold a column below D are loaded and multiplied.
//  * Chunked scores. The full-width scores are a sum over 64-column chunks
//    of the head dim, S = Σ_c Q_c·K_cᵀ (K-major wgmma, f32 accumulation),
//    with the chunks streamed by TMA through a ring of stages; the number of
//    chunks, ceil(D / 64), is a run-time loop, and columns past D load as
//    zeros. One compiled variant a dtype and kernel serves every D past 256.
// Every block that shares a row computes the same S, m, l and P (dq: S, dP
// and dS) with the same instructions in the same order, chunk 0 first, so
// the slices' outputs compose into the one-block result; only slice 0 of
// the forward writes lse.
//
// Each kernel runs flash_kernels.cuh's block: a producer warpgroup that
// drops to kProducerRegs with setmaxnreg and issues every TMA load, and two
// consumer warpgroups that rise to kConsumerRegs and run every product as
// wgmma. Every wait spins without a bound (`mbar_wait_spin`): a trap in the
// kernel would make ptxas spill against the launch's 168 registers.
//
// Work and L2 reads per visible (query, key) pair, against the bound's 4·D
// (fwd), 6·D (dq) and 8·D (dkv) FLOPs: the forward 2·D·(slices) + 2·D, 6·D at
// D 512, reading K and a V slice once a 128-row block and key tile, Q once a
// block up to D 512; dq 6·D, the scores once a 512-column slice, reading Q,
// K and V once a 64-row block and key tile, dO once a block up to D 512;
// dkv 4·D·(slices) + 4·D, 12·D at D 512, reading K and V once a 64-key
// block and query tile and Q and dO once a slice.

#pragma once

#include "flash_kernels.cuh"

namespace edl_flash {

constexpr int kChunk = 64;                    // head-dim columns a chunk (a 128 B swizzle span)
constexpr int kChunkElems = kTile * kChunk;   // a 64-row chunk
constexpr int kChunkBytes = kChunkElems * 2;  // 8 KB in 16 bits
constexpr int kRowSlice = 256;                // O's columns a block; dQ's a consumer warpgroup
constexpr int kDqSlice = 2 * kRowSlice;       // dQ's columns a block
constexpr int kKeySlice = 256;                // dK's and dV's columns a block
constexpr int kDsBarrier = 1;                 // dq's hand-over of dS (a named barrier)

__host__ __device__ constexpr int chunks_of(int D) { return (D + kChunk - 1) / kChunk; }

// The forward's shared memory, for 128 query rows a block: eight Q slots of
// one 128-row chunk each, four K slots of one 64-key chunk each (the ring's
// stages), two V slices (256 columns of 64 keys as four chunks; key tile kt
// in slice kt mod 2) and the barriers. Up to 8 chunks (D 512) the block's Q
// is loaded into the Q slots once, with the first key tile's chunks, and
// stays; past that Q's chunks stream with K's through the ring (stage s is
// Q slot s and K slot s). 230,496 bytes of the 232,448.
struct FwdSlicedSmem {
  static constexpr int kRows = 2 * kTile;  // query rows a block
  static constexpr int kQSlots = 8, kStages = 4, kVStages = 2;
  static constexpr int kQChunkBytes = kRows * kChunk * 2;
  static constexpr int kVBytes = kRowSlice / kChunk * kChunkBytes;
  static constexpr size_t kBytes = 1024 + kQSlots * kQChunkBytes + kStages * kChunkBytes +
                                   kVStages * kVBytes + (2 * kStages + 2 * kVStages) * 8;
  static_assert(kBytes <= kSmemMax, "sliced forward shared memory");
};

// dq's, for 64 query rows a block: 128 KB for the chunk ring, the K buffer
// (the tile's K chunks of the block's own 512 columns, which serve S and
// then dS·K, so K is read once), two dS tiles (64 queries x 64 keys, tile kt
// in buffer kt mod 2) and the barriers. Up to 8 chunks (D 512) the ring's
// first 64 KB hold the block's dO, loaded once with the first key tile's
// chunks, and the rest is eight 8 KB stages (a V chunk in dP's pass, a Q
// chunk in S's); past that it is eight 16 KB stages (dO and V chunks; a Q
// chunk, with the K chunk where it lies outside the block's columns).
// 214,216 bytes of the 232,448.
struct DqSlicedSmem {
  static constexpr int kStages = 8;
  static constexpr int kStageBytes = 2 * kChunkBytes;
  static constexpr int kKChunks = kDqSlice / kChunk;
  static constexpr int kDsBytes = kTile * kTile * 2;
  static constexpr size_t kBytes = 1024 + kStages * kStageBytes + kKChunks * kChunkBytes +
                                   2 * kDsBytes + (2 * kStages + kKChunks + 1) * 8;
  static_assert(kBytes <= kSmemMax, "sliced dq shared memory");
};

// dkv's: ring stages of the K, V, Q and dO chunks (64 rows each; four
// stages, 128 KB in flight from L2); the Q slice and the dO slice (256
// columns of 64 rows each, as 64-column chunks), into which the chunk stream
// loads the Q and dO chunks of the block's slice, so that they are read
// once; two buffers of Pᵀ and dSᵀ tiles (64 keys x 64 queries: query tile i
// in buffer i mod 2, so that one warpgroup may form tile i + 1 while the
// other still sums tile i); the tile's lse and delta; the barriers. 230,992
// bytes of the 232,448.
struct DkvSlicedSmem {
  static constexpr int kStages = 4;
  static constexpr int kStageBytes = 4 * kChunkBytes;
  static constexpr int kSliceBytes = kKeySlice / kChunk * kChunkBytes;  // one of Q's, dO's
  static constexpr int kPBytes = kTile * kTile * 2;                     // one of Pᵀ, dSᵀ
  static constexpr size_t kBytes = 1024 + kStages * kStageBytes + 2 * kSliceBytes +
                                   2 * 2 * kPBytes + 2 * kTile * sizeof(float) +
                                   (2 * kStages + 2) * 8;
  static_assert(kBytes <= kSmemMax, "sliced dkv shared memory");
};

// The 64-column chunks of a slice starting at column col0 that hold a
// column below D (padded up to a chunk).
__device__ __forceinline__ int slice_chunks(int D, int col0, int width) {
  const int n = chunks_of(D) - col0 / kChunk;
  return n < width / kChunk ? n : width / kChunk;
}

// X (64 x N) (+)= A_c·B_cᵀ over one 64-column chunk for one warpgroup: A a
// 64-row chunk, B N rows (64, or 32 from a multiple of 8 rows into a chunk),
// both K-major; the first chunk (`first`) overwrites X.
template <typename T, int N = 64>
__device__ __forceinline__ void issue_chunk(float (&x)[N / 2], const T* a, const T* b,
                                            bool first) {
  const uint64_t da = hopper::make_desc<64, kTile>(a), db = hopper::make_desc<64, kTile>(b);
#pragma unroll
  for (int kk = 0; kk < kChunk / 16; ++kk) {
    hopper::wgmma_ss<T, N>(x, hopper::desc_add(da, kk * 32), hopper::desc_add(db, kk * 32),
                           !first || kk > 0);
  }
}

// acc (64 x W) += A·B for one warpgroup, left uncommitted: A (64 x 64) in
// fragments in registers, B a slice of 64 rows read MN-major, stored as
// 64-column chunks of 64 rows. Only the slice's first `chunks` chunks are
// multiplied: as 128-column products, and a 64-column one for an odd last
// chunk. A thread's accumulator is theirs laid end to end.
template <typename T, int W>
__device__ __forceinline__ void issue_rs_slice(float (&acc)[W / 2], const uint32_t (&a)[4][4],
                                               const T* b_tile, int chunks) {
#pragma unroll
  for (int p = 0; p < W / 128; ++p) {
    const int left = chunks - 2 * p;
    if (left <= 0) break;
    const uint64_t b = hopper::make_desc<128, kTile>(b_tile + 2 * p * kChunkElems);
    if (left >= 2) {
      float(&acc128)[64] = *reinterpret_cast<float(*)[64]>(&acc[64 * p]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_rs_mn<T, 128>(acc128, a[kk], hopper::desc_add(b, kk * 16 * kChunk * 2));
    } else {
      float(&acc64)[32] = *reinterpret_cast<float(*)[32]>(&acc[64 * p]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_rs_mn<T, 64>(acc64, a[kk], hopper::desc_add(b, kk * 16 * kChunk * 2));
    }
  }
}

// The same with A (64 x 64) in shared memory, a tile stored K-major and
// 128B-swizzled (`store_swizzled`; descriptor a).
template <typename T, int W>
__device__ __forceinline__ void issue_ss_slice(float (&acc)[W / 2], uint64_t a,
                                               const T* b_tile, int chunks) {
#pragma unroll
  for (int p = 0; p < W / 128; ++p) {
    const int left = chunks - 2 * p;
    if (left <= 0) break;
    const uint64_t b = hopper::make_desc<128, kTile>(b_tile + 2 * p * kChunkElems);
    if (left >= 2) {
      float(&acc128)[64] = *reinterpret_cast<float(*)[64]>(&acc[64 * p]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_ss_mn<T, 128>(acc128, hopper::desc_add(a, kk * 32),
                                    hopper::desc_add(b, kk * 16 * kChunk * 2));
    } else {
      float(&acc64)[32] = *reinterpret_cast<float(*)[32]>(&acc[64 * p]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_ss_mn<T, 64>(acc64, hopper::desc_add(a, kk * 32),
                                   hopper::desc_add(b, kk * 16 * kChunk * 2));
    }
  }
}

// -- forward ------------------------------------------------------------------

// Replaces _fwd_kernel of edl_tpu/ops/flash_attention.py for D > 256.
// Bound: 4·D FLOPs a visible pair, FLOP-bound at the LM's shapes (0.139 ms
// at B 4, S 2048, H 8, D 512, causal). Design: one block owns 128 query rows
// and one 256-column slice of O of one (batch, head), the heaviest query
// tiles launched first, in flash_kernels.cuh's block: a producer warpgroup
// (setmaxnreg down; one thread issues every load) and two consumer
// warpgroups (setmaxnreg up) of 64 rows each, which share every K chunk and
// V slice, so that each read from L2 serves 128 rows. Up to 8 chunks (D 512)
// the producer loads the block's Q once, chunk by chunk beside the first key
// tile's K chunks, into Q slots where it stays (128 KB at D 512); past that
// each key tile streams Q's chunks again beside K's (`q_held`). For each
// 64-key tile it streams the K chunks through a 4-stage ring and then the
// tile's V slice through two V buffers. A consumer sums S over the chunks
// for its 64 rows (each chunk's stage released as the next chunk's product
// is issued), runs the online softmax on S as flash_kernels.cuh's forward
// does, rescales O (its 256 columns, 128 registers a thread), rounds P to T
// and issues O += P·V_slice, which runs while the next tile's chunks are
// multiplied. The two consumers take the chunk stream together: a
// ping-pong of their issues, as flash_kernels.cuh's forward runs it, would
// have one warpgroup sum a whole tile's chunks while the other waits, and
// the ring (8 KB a chunk stage) frees a stage only once both have used it.
// Every wait spins without a bound (`mbar_wait_spin`).
template <typename T>
__global__ void __launch_bounds__(kWsThreads, 1) flash_fwd_sliced_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, void* __restrict__ o, float* __restrict__ lse,
    int H, int Sq, int Sk, int D, int q_offset, int k_offset, float scale_log2, int causal,
    int out_f32) {
  using namespace hopper;
  using Smem = FwdSlicedSmem;
  constexpr int kStages = Smem::kStages, kVStages = Smem::kVStages, kRows = Smem::kRows;
  constexpr int kQChunkElems = Smem::kQChunkBytes / 2, kVElems = Smem::kVBytes / 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  T* sq = reinterpret_cast<T*>(smem);         // Q slot i: a 128-row chunk
  T* sk = sq + Smem::kQSlots * kQChunkElems;  // K slot s: a 64-key chunk
  T* sv = sk + kStages * kChunkElems;         // the V slices
  uint64_t* full = reinterpret_cast<uint64_t*>(sv + kVStages * kVElems);
  uint64_t* empty = full + kStages;
  uint64_t* vfull = empty + kStages;
  uint64_t* vempty = vfull + kVStages;

  const int n_ch = chunks_of(D), n_sl = slices_of(D, kRowSlice);
  // Q's chunks fit the Q slots: chunk c lands in slot c with the first key
  // tile and stays; else chunk c of a tile streams into the slot of its
  // stage
  const bool q_held = n_ch <= Smem::kQSlots;
  const int n_qt = (Sq + kRows - 1) / kRows;
  const int per_qt = gridDim.x / n_qt, BH = per_qt / n_sl;  // blocks a query tile
  const int qt = n_qt - 1 - blockIdx.x / per_qt;  // the last query tiles carry the most keys
  const int sl = blockIdx.x % per_qt / BH, bh = blockIdx.x % BH, b = bh / H, h = bh % H;
  const int q0 = qt * kRows, col0 = sl * kRowSlice;
  const int v_chunks = slice_chunks(D, col0, kRowSlice);
  // the key tiles that the block's last kTile rows see
  const int n_kt = key_tiles<kTile>(Sk, q0 + kRows - kTile, q_offset, k_offset, causal);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < kVStages; ++s) {
      mbar_init(&vfull[s], 1);
      mbar_init(&vempty[s], 8);
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
      for (int kt = 0, it = 0; kt < n_kt; ++kt) {
        const bool load_q = !q_held || kt == 0;
        for (int c = 0; c < n_ch; ++c, ++it) {
          const int s = it % kStages;
          mbar_wait_spin(&empty[s], ((it / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], (load_q ? Smem::kQChunkBytes : 0) + kChunkBytes);
          if (load_q) {
            tma_load_4d(sq + (q_held ? c : s) * kQChunkElems, &tq, &full[s], c * kChunk, h, q0,
                        b);
          }
          tma_load_4d(sk + s * kChunkElems, &tk, &full[s], c * kChunk, h, kt * kTile, b);
        }
        const int vs = kt % kVStages;
        mbar_wait_spin(&vempty[vs], ((kt / kVStages) & 1) ^ 1);  // P·V of tile kt - 2 is done
        mbar_arrive_expect_tx(&vfull[vs], v_chunks * kChunkBytes);
        for (int c = 0; c < v_chunks; ++c) {
          tma_load_4d(sv + vs * kVElems + c * kChunkElems, &tv, &vfull[vs], col0 + c * kChunk, h,
                      kt * kTile, b);
        }
      }
    }
  } else {  // consumer warpgroup wg: query rows q0 + 64·wg ...
    setmaxnreg_inc<kConsumerRegs>();
    const int lane = threadIdx.x & 31, t = lane & 3, g = lane >> 2;
    const int wg_row0 = q0 + wg * kTile;
    const int row0 = wg_row0 + ((threadIdx.x >> 5) & 3) * 16;  // this warp's first row
    const FwdRows rows = {q_offset + row0 + g, t, Sk, causal, k_offset, scale_log2};
    const int n_open = open_key_tiles<kTile>(n_kt, Sk, wg_row0, q_offset, k_offset, causal);

    float acc[kRowSlice / 2];
#pragma unroll
    for (int i = 0; i < kRowSlice / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};              // rows g and g + 8, log2 units
    float l[2] = {0.f, 0.f}, lr[2] = {0.f, 0.f};  // the sums of P and of P rounded to T
    float sc[1][32];                              // S, then P in f32
    uint32_t pa[4][4];                            // P in T: the A fragments of P·V

    for (int kt = 0, it = 0; kt < n_kt; ++kt) {
      for (int c = 0; c < n_ch; ++c, ++it) {
        const int s = it % kStages;
        const T* qc = sq + (q_held ? c : s) * kQChunkElems + wg * kChunkElems;  // its rows
        mbar_wait_spin(&full[s], (it / kStages) & 1);
        wgmma_fence();
        issue_chunk<T>(sc[0], qc, sk + s * kChunkElems, c == 0);
        wgmma_commit();
        wgmma_wait<1>();  // every product but this chunk's is done
        if (c > 0) {
          release_stage(&empty[(it - 1) % kStages]);
        } else if (kt > 0) {
          release_stage(&vempty[(kt - 1) % kVStages]);  // O += P·V of tile kt - 1 is done
        }
      }
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(acc);
      fence_regs(pa);
      release_stage(&empty[(it - 1) % kStages]);
      float alpha[2];
      if (kt < n_open) {
        fwd_softmax<false>(sc, m, l, alpha, kt * kTile, rows);
      } else {
        fwd_softmax<true>(sc, m, l, alpha, kt * kTile, rows);
      }
#pragma unroll
      for (int i = 0; i < kRowSlice / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      pack_a<T>(pa, sc);
      packed_row_sums<T>(lr, alpha, pa);
      const int vs = kt % kVStages;
      mbar_wait_spin(&vfull[vs], (kt / kVStages) & 1);
      wgmma_fence();
      issue_rs_slice<T, kRowSlice>(acc, pa, sv + vs * kVElems, v_chunks);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);

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
      for (int j = 0; j < kRowSlice / 8; ++j) {
        const int d = col0 + j * 8 + 2 * t;
        if (d >= D) continue;
        const float x0 = acc[4 * j + 2 * r] / norm, x1 = acc[4 * j + 2 * r + 1] / norm;
        if (out_f32) {
          *reinterpret_cast<float2*>(static_cast<float*>(o) + base + d) = make_float2(x0, x1);
        } else {
          store2(static_cast<T*>(o) + base + d, x0, x1);
        }
      }
      if (t == 0 && sl == 0) {  // every slice has the same statistics; one writes them
        lse[(long long)bh * Sq + row] = l[r] > 0.f ? m[r] * kLn2 + logf(l[r]) : kNegInf;
      }
    }
  }
}

// -- backward: dQ -------------------------------------------------------------

// Replaces _bwd_dq_kernel of edl_tpu/ops/flash_attention.py for D > 256.
// Bound: 6·D FLOPs a visible pair (0.209 ms at the LM's D-512 shape). Its
// chunk reads from L2 do not bound it: holding dO, which cut them from 4.4
// to 3.3 GB a call at that shape, took 3 % off its time (PERF.md). Design:
// one block owns 64 query rows and 512 columns of dQ of one (batch, head)
// (one block covers a row at D 512), the heaviest query tiles first, in
// flash_kernels.cuh's block: a producer warpgroup (setmaxnreg down) and two
// consumer warpgroups (setmaxnreg up) that split each 64-key tile's scores
// by keys, as the sliced dkv splits its queries: consumer w sums S = Q·Kᵀ
// and dP = dO·Vᵀ for keys 32w ... 32w + 31 of the tile (N = 32) over every
// chunk, forms dS as flash_kernels.cuh's dq does (its rows' lse, times
// log2 e, and delta in registers), rounds it to T and stores it into a
// 128B-swizzled K-major dS tile; a named barrier hands the two halves over,
// and consumer w issues dQ_w += dS·K_w, its own 256-column half (128 f32
// registers a thread), with A the whole 64 x 64 dS tile in shared memory,
// which runs while the next tile's first chunks are summed. So the scores
// are summed once a 512-column slice (6·D FLOPs a pair). Per tile the
// producer's first warp streams the V chunks (dP's pass) and then the Q
// chunks (S's pass, with the K chunks outside the block's columns) through
// an 8-stage ring; up to 8 chunks (D 512) the block's dO is loaded once,
// beside the first tile's V chunks, and stays (`do_held`), past that dO's
// chunks stream beside V's. Its second warp loads the tile's K chunks of
// the block's columns into the K buffer once the last tile's dS·K is done,
// and they serve S and then dS·K, so K is read once; dP's pass runs while
// they load. dQ stays in f32 registers and is written once: no atomics,
// deterministic sums. A block that sees no key loads nothing and writes
// dQ = 0. Every wait spins without a bound (`mbar_wait_spin`).
template <typename T>
__global__ void __launch_bounds__(kWsThreads, 1) flash_bwd_dq_sliced_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dq,
    int H, int Sq, int Sk, int D, int q_offset, int k_offset, float scale, float scale_log2,
    int causal) {
  using namespace hopper;
  using Smem = DqSlicedSmem;
  constexpr int kStages = Smem::kStages, kKChunks = Smem::kKChunks;
  constexpr int kHalfChunks = kRowSlice / kChunk;  // a consumer's chunks of dQ
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  T* sring = reinterpret_cast<T*>(smem);       // dO held, then stages; or stages
  T* skb = sring + kStages * 2 * kChunkElems;  // the K buffer: the block's chunks
  T* sds = skb + kKChunks * kChunkElems;       // two dS tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(sds + 2 * kTile * kTile);
  uint64_t* empty = full + kStages;
  uint64_t* kfull = empty + kStages;  // one a K buffer chunk
  uint64_t* kempty = kfull + kKChunks;

  const int n_ch = chunks_of(D), n_sl = slices_of(D, kDqSlice);
  const int n_qt = (Sq + kTile - 1) / kTile;
  const int per_qt = gridDim.x / n_qt, BH = per_qt / n_sl;
  const int qt = n_qt - 1 - blockIdx.x / per_qt;
  const int sl = blockIdx.x % per_qt / BH, bh = blockIdx.x % BH, b = bh / H, h = bh % H;
  const int q0 = qt * kTile, col0 = sl * kDqSlice, c0 = col0 / kChunk;
  const int own = slice_chunks(D, col0, kDqSlice);  // the block's chunks: c0 ... c0 + own - 1
  const int n_kt = key_tiles<kTile>(Sk, q0, q_offset, k_offset, causal);
  // dO's chunks fit the ring's first half: chunk c stays in slot c, and a
  // stage is one 8 KB chunk after them; else a stage is two chunks
  const bool do_held = n_ch <= kStages;
  T* const stages = do_held ? sring + kStages * kChunkElems : sring;
  const int stage_elems = do_held ? kChunkElems : 2 * kChunkElems;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    for (int i = 0; i < kKChunks; ++i) mbar_init(&kfull[i], 1);
    mbar_init(kempty, 8);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = warpgroup_index();
  const int lane = threadIdx.x & 31;
  if (wg == 2) {  // the producer warpgroup: its first warp feeds the ring, its second the K buffer
    setmaxnreg_dec<kProducerRegs>();
    const int warp = (threadIdx.x >> 5) & 3;
    if (warp == 0 && lane == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tdo);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      for (int kt = 0, it = 0; kt < n_kt; ++kt) {
        for (int j = 0; j < 2 * n_ch; ++j, ++it) {
          const int s = it % kStages;
          T* dst = stages + s * stage_elems;
          mbar_wait_spin(&empty[s], ((it / kStages) & 1) ^ 1);
          if (j < n_ch) {  // dP's pass: V_c, and dO_c unless it is held
            const bool load_do = !do_held || kt == 0;
            mbar_arrive_expect_tx(&full[s], (load_do ? 2 : 1) * kChunkBytes);
            if (load_do) {
              tma_load_4d(do_held ? sring + j * kChunkElems : dst + kChunkElems, &tdo, &full[s],
                          j * kChunk, h, q0, b);
            }
            tma_load_4d(dst, &tv, &full[s], j * kChunk, h, kt * kTile, b);
          } else {  // S's pass: Q_c, and K_c outside the block's columns
            const int c = j - n_ch;
            const bool other = c < c0 || c >= c0 + own;
            mbar_arrive_expect_tx(&full[s], (other ? 2 : 1) * kChunkBytes);
            tma_load_4d(dst, &tq, &full[s], c * kChunk, h, q0, b);
            if (other) tma_load_4d(dst + kChunkElems, &tk, &full[s], c * kChunk, h, kt * kTile, b);
          }
        }
      }
    } else if (warp == 1 && lane == 0) {
      for (int kt = 0; kt < n_kt; ++kt) {
        mbar_wait_spin(kempty, (kt & 1) ^ 1);  // dQ += dS·K of tile kt - 1 is done
        for (int i = 0; i < own; ++i) {
          mbar_arrive_expect_tx(&kfull[i], kChunkBytes);
          tma_load_4d(skb + i * kChunkElems, &tk, &kfull[i], (c0 + i) * kChunk, h, kt * kTile,
                      b);
        }
      }
    }
  } else {  // consumer warpgroup wg: keys 32·wg ... of each tile; dQ's half wg
    setmaxnreg_inc<kConsumerRegs>();
    const int g = lane >> 2, t = lane & 3;
    const int qrow = ((threadIdx.x >> 5) & 3) * 16 + g;  // this thread's first row of the tile
    const int key0 = 32 * wg;                            // this warpgroup's first key column
    DqRows rows = {q_offset + q0 + qrow, t, Sk, causal, k_offset, scale, scale_log2,
                   {0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // rows at or beyond Sq stay finite and are never written
      const int row = q0 + qrow + 8 * r;
      if (row < Sq) {
        rows.lse_log2[r] = lse[(long long)bh * Sq + row] * kLog2e;
        rows.delta[r] = delta[(long long)bh * Sq + row];
      }
    }
    const int n_open = open_key_tiles<kTile>(n_kt, Sk, q0, q_offset, k_offset, causal);
    // this warpgroup's chunks of the K buffer, for its half of dQ
    const int half = own - kHalfChunks * wg;
    const int half_chunks = half < 0 ? 0 : half < kHalfChunks ? half : kHalfChunks;

    float acc[kRowSlice / 2];  // dQ's half wg
#pragma unroll
    for (int i = 0; i < kRowSlice / 2; ++i) acc[i] = 0.f;
    float sc[16], dp[16];  // S and dP, then dS in dp: f32, 64 rows x the warpgroup's 32 keys

    for (int kt = 0, it = 0; kt < n_kt; ++kt) {
      for (int c = 0; c < n_ch; ++c, ++it) {  // dP = dO·Vᵀ
        const int s = it % kStages;
        const T* stage = stages + s * stage_elems;  // V_c, then dO_c unless it is held
        const T* doc = do_held ? sring + c * kChunkElems : stage + kChunkElems;
        mbar_wait_spin(&full[s], (it / kStages) & 1);
        wgmma_fence();
        issue_chunk<T, 32>(dp, doc, stage + key0 * kChunk, c == 0);
        wgmma_commit();
        wgmma_wait<1>();  // every product but this chunk's is done
        if (c > 0) {
          release_stage(&empty[(it - 1) % kStages]);
        } else if (kt > 0) {
          release_stage(kempty);  // dQ += dS·K of tile kt - 1 is done: the K buffer is free
        }
      }
      for (int c = 0; c < n_ch; ++c, ++it) {  // S = Q·Kᵀ
        const int s = it % kStages;
        const T* stage = stages + s * stage_elems;
        const bool other = c < c0 || c >= c0 + own;
        const T* kc = other ? stage + kChunkElems : skb + (c - c0) * kChunkElems;
        mbar_wait_spin(&full[s], (it / kStages) & 1);
        if (!other) mbar_wait_spin(&kfull[c - c0], kt & 1);
        wgmma_fence();
        issue_chunk<T, 32>(sc, stage, kc + key0 * kChunk, c == 0);
        wgmma_commit();
        wgmma_wait<1>();
        release_stage(&empty[(it - 1) % kStages]);  // the chunk before (dP's last at c == 0)
      }
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      fence_regs(acc);
      release_stage(&empty[(it - 1) % kStages]);
      if (kt < n_open) {
        dq_probs<false>(sc, dp, kt * kTile + key0, rows);
      } else {
        dq_probs<true>(sc, dp, kt * kTile + key0, rows);
      }
      // tile kt's dS buffer was last read by tile kt - 2's dS·K, which both
      // warpgroups waited for before they passed tile kt - 1's barrier
      T* ds = sds + (kt & 1) * kTile * kTile;
      store_swizzled<T>(ds, dp, qrow, key0 + 2 * t);
      fence_proxy_async();
      named_bar_sync(kDsBarrier, 256);  // both halves of dS are in place
      wgmma_fence();
      issue_ss_slice<T, kRowSlice>(acc, make_desc<64, kTile>(ds),
                                   skb + kHalfChunks * wg * kChunkElems, half_chunks);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(acc);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + qrow + 8 * r;
      if (row >= Sq) continue;
      const long long base = (((long long)b * Sq + row) * H + h) * D;
#pragma unroll
      for (int j = 0; j < kRowSlice / 8; ++j) {
        const int d = col0 + kRowSlice * wg + j * 8 + 2 * t;
        if (d < D) store2(dq + base + d, acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

// -- backward: dK and dV ------------------------------------------------------

// Replaces _bwd_dkv_kernel of edl_tpu/ops/flash_attention.py for D > 256.
// Bound: 8·D FLOPs a visible pair (0.278 ms at the LM's D-512 shape). Design:
// one block owns 64 keys and one 256-column slice of dK and of dV of one
// (batch, head), the earliest key tiles first, so one launch serves a call
// and the scores are summed once a slice (12·D FLOPs a pair at D 512). The
// block runs flash_kernels.cuh's dkv layout from DP 192: a producer
// warpgroup (setmaxnreg down; its first warp works) and two consumer
// warpgroups (setmaxnreg up) that share the 64 keys. For each 64-query tile
// from the first that sees the keys, the producer streams the tile's (K_c,
// V_c, Q_c, dO_c) chunk quadruples through a 4-stage ring, the slice's own
// chunks last (`chunk_at`), and stores the tile's lse (times log2 e) and
// delta; the Q and dO chunks of the block's slice land in the slice buffer
// instead of the ring, so that they are read from L2 once, not once for
// the scores and once for the products. Consumer warpgroup w sums Sᵀ = K·Qᵀ
// and dPᵀ = V·dOᵀ over the chunks for queries 32w ... 32w + 31 (N = 32),
// forms Pᵀ and dSᵀ as flash_kernels.cuh's dkv does and stores them, rounded
// to T, into 128B-swizzled K-major tiles; a named barrier hands the two
// halves over, and warpgroup 0 issues dV_slice += Pᵀ·dO_slice and warpgroup
// 1 dK_slice += dSᵀ·Q_slice, each a wgmma with A the whole 64 x 64 tile in
// shared memory, which runs while the next tile's first chunks are summed.
// The kernel is bound by the chunks' reads from L2 (every tile re-reads
// the block's K and V chunks), so the ring holds as many bytes in flight as
// shared memory leaves. dK and dV stay in f32 registers and are written
// once: no atomics, deterministic sums. The slices sum a tile's chunks in
// different orders, so their Pᵀ differ by f32 rounding. Every wait spins
// without a bound (`mbar_wait_spin`): a trap in the kernel would make ptxas
// spill against the launch's 168 registers (flash_kernels.cuh).
template <typename T>
__global__ void __launch_bounds__(kWsThreads, 1) flash_bwd_dkv_sliced_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dk,
    T* __restrict__ dv, int H, int Sq, int Sk, int D, int q_offset, int k_offset,
    float scale, float scale_log2, int causal) {
  using namespace hopper;
  using Smem = DkvSlicedSmem;
  constexpr int kStages = Smem::kStages;
  constexpr int kSliceElems = Smem::kSliceBytes / 2, kPElems = Smem::kPBytes / 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  T* schunks = reinterpret_cast<T*>(smem);  // stage s: the K, V, Q and dO chunks
  T* sslice = schunks + kStages * 4 * kChunkElems;  // the Q slice, then the dO slice
  T* spt = sslice + 2 * kSliceElems;                // buffer: the Pᵀ tile, then dSᵀ
  float* slse = reinterpret_cast<float*>(spt + 2 * 2 * kPElems);
  float* sdelta = slse + kTile;
  uint64_t* full = reinterpret_cast<uint64_t*>(sdelta + kTile);
  uint64_t* empty = full + kStages;
  uint64_t* tfull = empty + kStages;  // the tile's lse and delta are stored
  uint64_t* sfree = tfull + 1;        // the last tile's slice products are done

  const int n_ch = chunks_of(D), n_sl = slices_of(D, kKeySlice);
  const int n_kt = (Sk + kTile - 1) / kTile;
  const int per_kt = gridDim.x / n_kt, BH = per_kt / n_sl;
  const int kt = blockIdx.x / per_kt;  // the first key tiles are seen by the most queries
  const int sl = blockIdx.x % per_kt / BH, bh = blockIdx.x % BH, b = bh / H, h = bh % H;
  const int k0 = kt * kTile, col0 = sl * kKeySlice;
  const int c0 = col0 / kChunk, q_chunks = slice_chunks(D, col0, kKeySlice);
  const int n_other = n_ch - q_chunks;  // the chunks outside the slice, streamed first
  // the chunk streamed j-th in a tile: the others in order after the slice's,
  // then the slice's own (chunk c0 + j - n_other)
  auto chunk_at = [&](int j) { return (c0 + q_chunks + j) % n_ch; };
  const int n_qt = (Sq + kTile - 1) / kTile;
  const int qt0 = first_query_tile(k0, q_offset, k_offset, causal);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init(tfull, 32);  // the producer warp's 32 lanes
    mbar_init(sfree, 8);
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
        tma_prefetch_map(&tk);
        tma_prefetch_map(&tv);
      }
      const float* lseb = lse + (long long)bh * Sq;
      const float* deltab = delta + (long long)bh * Sq;
      for (int qt = qt0, i = 0, it = 0; qt < n_qt; ++qt, ++i) {
        const int q0 = qt * kTile;
        for (int j = 0; j < n_ch; ++j, ++it) {
          if (j == n_other) {
            // the last tile's slice products, and its reads of lse and
            // delta, are done: the slice buffer and lse and delta are free
            mbar_wait_spin(sfree, (i & 1) ^ 1);
            for (int r = lane; r < kTile; r += 32) {
              const bool ok = q0 + r < Sq;
              slse[r] = ok ? lseb[q0 + r] * kLog2e : 0.f;
              sdelta[r] = ok ? deltab[q0 + r] : 0.f;
            }
            mbar_arrive(tfull);  // each lane's arrival releases its own stores
          }
          if (lane == 0) {
            const int c = chunk_at(j), s = it % kStages;
            T* dst = schunks + s * 4 * kChunkElems;
            const bool mine = j >= n_other;  // a chunk of the block's slice
            T* qc = mine ? sslice + (c - c0) * kChunkElems : dst + 2 * kChunkElems;
            T* doc = mine ? sslice + kSliceElems + (c - c0) * kChunkElems
                          : dst + 3 * kChunkElems;
            mbar_wait_spin(&empty[s], ((it / kStages) & 1) ^ 1);
            mbar_arrive_expect_tx(&full[s], 4 * kChunkBytes);
            tma_load_4d(dst, &tk, &full[s], c * kChunk, h, k0, b);
            tma_load_4d(dst + kChunkElems, &tv, &full[s], c * kChunk, h, k0, b);
            tma_load_4d(qc, &tq, &full[s], c * kChunk, h, q0, b);
            tma_load_4d(doc, &tdo, &full[s], c * kChunk, h, q0, b);
          }
          __syncwarp();
        }
      }
    }
  } else {  // consumer warpgroup wg: queries 32·wg ... of each tile; dV (0) or dK (1)
    setmaxnreg_inc<kConsumerRegs>();
    const int g = lane >> 2, t = lane & 3;
    const int krow = ((threadIdx.x >> 5) & 3) * 16 + g;  // this thread's first key row
    const int qcol0 = 32 * wg;                           // this warpgroup's first query column
    const DkvKeys keys = {k_offset + k0 + krow, k0 + krow, t, Sq, Sk, causal, q_offset, scale,
                          scale_log2};
    // a query tile is masked iff it crosses the ragged edge or the diagonal
    const bool keys_ragged = k0 + kTile > Sk;
    const int diag = k_offset + k0 + kTile - 1 - q_offset;  // the first query that sees all

    float acc[kKeySlice / 2];  // dV (warpgroup 0) or dK (warpgroup 1) of the slice
#pragma unroll
    for (int i = 0; i < kKeySlice / 2; ++i) acc[i] = 0.f;
    float st[16], dpt[16];  // Sᵀ and dPᵀ, then Pᵀ and dSᵀ in f32: rows keys, 32 query columns

    for (int qt = qt0, i = 0, it = 0; qt < n_qt; ++qt, ++i) {
      const int q0 = qt * kTile;
      for (int j = 0; j < n_ch; ++j, ++it) {
        const int c = chunk_at(j), s = it % kStages;
        const T* stage = schunks + s * 4 * kChunkElems;
        const bool mine = j >= n_other;
        const T* qc = mine ? sslice + (c - c0) * kChunkElems : stage + 2 * kChunkElems;
        const T* doc = mine ? sslice + kSliceElems + (c - c0) * kChunkElems
                            : stage + 3 * kChunkElems;
        mbar_wait_spin(&full[s], (it / kStages) & 1);
        wgmma_fence();
        issue_chunk<T, 32>(st, stage, qc + qcol0 * kChunk, j == 0);
        issue_chunk<T, 32>(dpt, stage + kChunkElems, doc + qcol0 * kChunk, j == 0);
        wgmma_commit();
        wgmma_wait<1>();  // every product but this chunk's is done
        if (j > 0) {
          release_stage(&empty[(it - 1) % kStages]);
        } else if (i > 0) {
          release_stage(sfree);  // tile i - 1's slice products are done
        }
      }
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      fence_regs(acc);
      release_stage(&empty[(it - 1) % kStages]);
      mbar_wait_spin(tfull, i & 1);
      if (keys_ragged || q0 + kTile > Sq || (causal && q0 < diag)) {
        dkv_probs<true>(st, dpt, slse + qcol0, sdelta + qcol0, q0 + qcol0, keys);
      } else {
        dkv_probs<false>(st, dpt, slse + qcol0, sdelta + qcol0, q0 + qcol0, keys);
      }
      T* pt = spt + (i & 1) * 2 * kPElems;
      T* dst = pt + kPElems;
      store_swizzled<T>(pt, st, krow, qcol0 + 2 * t);
      store_swizzled<T>(dst, dpt, krow, qcol0 + 2 * t);
      fence_proxy_async();
      named_bar_sync(kDkvBarrier, 256);  // both halves of Pᵀ and dSᵀ are in place
      wgmma_fence();
      issue_ss_slice<T, kKeySlice>(acc, make_desc<64, kTile>(wg == 0 ? pt : dst),
                                   wg == 0 ? sslice + kSliceElems : sslice, q_chunks);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(acc);

    T* out = wg == 0 ? dv : dk;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = k0 + krow + 8 * r;
      if (row >= Sk) continue;
      const long long base = (((long long)b * Sk + row) * H + h) * D;
#pragma unroll
      for (int j = 0; j < kKeySlice / 8; ++j) {
        const int d = col0 + j * 8 + 2 * t;
        if (d < D) store2(out + base + d, acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

// -- launchers ----------------------------------------------------------------

template <typename T>
cudaError_t launch_fwd_sliced(const FwdArgs& a, cudaStream_t stream) {
  constexpr size_t kBytes = FwdSlicedSmem::kBytes;
  const unsigned blocks = sliced_blocks(a.B, a.H, a.Sq, a.D, FwdSlicedSmem::kRows, kRowSlice);
  if (blocks == 0) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  cudaError_t rc = allow_smem(flash_fwd_sliced_kernel<T>, kBytes);
  if (rc == cudaSuccess) {
    rc = view_map<T, 256>(&tq, a.q, a.B, a.Sq, a.H, a.D, FwdSlicedSmem::kRows);
  }
  if (rc == cudaSuccess) rc = view_map<T, 256>(&tk, a.k, a.B, a.Sk, a.H, a.D, kTile);
  if (rc == cudaSuccess) rc = view_map<T, 256>(&tv, a.v, a.B, a.Sk, a.H, a.D, kTile);
  if (rc != cudaSuccess) return rc;
  flash_fwd_sliced_kernel<T><<<blocks, kWsThreads, kBytes, stream>>>(
      tq, tk, tv, a.o, a.lse, a.H, a.Sq, a.Sk, a.D, a.q_offset, a.k_offset, a.scale * kLog2e,
      a.causal, a.out_f32);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_dq_sliced(const BwdArgs& a, cudaStream_t stream) {
  constexpr size_t kBytes = DqSlicedSmem::kBytes;
  const unsigned blocks = sliced_blocks(a.B, a.H, a.Sq, a.D, kTile, kDqSlice);
  if (blocks == 0) return cudaErrorInvalidValue;
  const View dout = {a.dout, (long long)a.Sq * a.H * a.D, (long long)a.H * a.D, a.D};
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t rc = allow_smem(flash_bwd_dq_sliced_kernel<T>, kBytes);
  if (rc == cudaSuccess) rc = view_map<T, 256>(&tq, a.q, a.B, a.Sq, a.H, a.D, kTile);
  if (rc == cudaSuccess) rc = view_map<T, 256>(&tdo, dout, a.B, a.Sq, a.H, a.D, kTile);
  if (rc == cudaSuccess) rc = view_map<T, 256>(&tk, a.k, a.B, a.Sk, a.H, a.D, kTile);
  if (rc == cudaSuccess) rc = view_map<T, 256>(&tv, a.v, a.B, a.Sk, a.H, a.D, kTile);
  if (rc != cudaSuccess) return rc;
  flash_bwd_dq_sliced_kernel<T><<<blocks, kWsThreads, kBytes, stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<T*>(a.dq), a.H, a.Sq, a.Sk, a.D, a.q_offset,
      a.k_offset, a.scale, a.scale * kLog2e, a.causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_dkv_sliced(const BwdArgs& a, cudaStream_t stream) {
  constexpr size_t kBytes = DkvSlicedSmem::kBytes;
  const unsigned blocks = sliced_blocks(a.B, a.H, a.Sk, a.D, kTile, kKeySlice);
  if (blocks == 0) return cudaErrorInvalidValue;
  const View dout = {a.dout, (long long)a.Sq * a.H * a.D, (long long)a.H * a.D, a.D};
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t rc = allow_smem(flash_bwd_dkv_sliced_kernel<T>, kBytes);
  if (rc == cudaSuccess) rc = view_map<T, 256>(&tq, a.q, a.B, a.Sq, a.H, a.D, kTile);
  if (rc == cudaSuccess) rc = view_map<T, 256>(&tdo, dout, a.B, a.Sq, a.H, a.D, kTile);
  if (rc == cudaSuccess) rc = view_map<T, 256>(&tk, a.k, a.B, a.Sk, a.H, a.D, kTile);
  if (rc == cudaSuccess) rc = view_map<T, 256>(&tv, a.v, a.B, a.Sk, a.H, a.D, kTile);
  if (rc != cudaSuccess) return rc;
  flash_bwd_dkv_sliced_kernel<T><<<blocks, kWsThreads, kBytes, stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.Sq,
      a.Sk, a.D, a.q_offset, a.k_offset, a.scale, a.scale * kLog2e, a.causal);
  return cudaGetLastError();
}

}  // namespace edl_flash
