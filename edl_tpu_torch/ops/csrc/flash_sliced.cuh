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
// warpgroup's O or dQ already takes 128 of a thread's 255 registers; a
// 64-row tile of D 512 is 64 KB. So no block holds a whole row of the output
// or of an input:
//  * Column slices. A block owns the rows of one tile and one slice of the
//    output's columns: 256 of O, of dQ, and of dK and dV (dkv's two consumer
//    warpgroups sum one each, 128 registers a thread). The last slice is
//    short where D is not a multiple of the slice: only its 64-column chunks
//    that hold a column below D are loaded and multiplied.
//  * Chunked scores. Every block recomputes the full-width scores as a sum
//    over 64-column chunks of the head dim, S = Σ_c Q_c·K_cᵀ (K-major wgmma,
//    f32 accumulation), with each chunk pair streamed by TMA through a ring
//    of stages; the number of chunks, ceil(D / 64), is a run-time loop, and
//    columns past D load as zeros. One compiled variant a dtype and kernel
//    serves every D past 256.
// Every slice of a row computes the same S, m, l and P with the same
// instructions in the same order, so the slices' outputs compose into the
// one-block result; only slice 0 writes lse.
//
// Work per visible (query, key) pair, against the bound's 4·D (fwd), 6·D (dq)
// and 8·D (dkv) FLOPs: the forward 2·D·(slices) + 2·D, dq 4·D·(slices) + 2·D,
// dkv 4·D·(slices) + 4·D; at D 512 6·D, 10·D and 12·D. Every block also
// re-reads its row operand's chunks (Q; dkv: K and V) from L2 for each tile
// it walks. Keeping the row operand whole in shared memory where it fits is
// later work (PERF.md).

#pragma once

#include "flash_kernels.cuh"

namespace edl_flash {

constexpr int kChunk = 64;                    // head-dim columns a chunk (a 128 B swizzle span)
constexpr int kChunkElems = kTile * kChunk;   // a 64-row chunk
constexpr int kChunkBytes = kChunkElems * 2;  // 8 KB in 16 bits
constexpr int kRowSlice = 256;                // O's and dQ's columns a block
constexpr int kKeySlice = 256;                // dK's and dV's columns a block

__host__ __device__ constexpr int chunks_of(int D) { return (D + kChunk - 1) / kChunk; }
__host__ __device__ constexpr int slices_of(int D, int width) { return (D + width - 1) / width; }

// The forward's shared memory: stages of a Q chunk and a K chunk, stages of a
// V slice (256 columns as four 64-column chunks of 64 keys), the barriers.
struct FwdSlicedSmem {
  static constexpr int kStages = 8, kVStages = 2;
  static constexpr int kStageBytes = 2 * kChunkBytes, kVBytes = kRowSlice / kChunk * kChunkBytes;
  static constexpr size_t kBytes =
      1024 + kStages * kStageBytes + kVStages * kVBytes + 2 * (kStages + kVStages) * 8;
  static_assert(kBytes <= kSmemMax, "sliced forward shared memory");
};

// dq's: stages of the Q, dO, K and V chunks, stages of a K slice, the barriers.
struct DqSlicedSmem {
  static constexpr int kStages = 4, kKStages = 2;
  static constexpr int kStageBytes = 4 * kChunkBytes, kKBytes = kRowSlice / kChunk * kChunkBytes;
  static constexpr size_t kBytes =
      1024 + kStages * kStageBytes + kKStages * kKBytes + 2 * (kStages + kKStages) * 8;
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

// A warp's release of a stage: its lanes are done with it.
__device__ __forceinline__ void release_stage(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(bar);
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
// at B 4, S 2048, H 8, D 512, causal). Design: one block owns 64 query rows
// and one 256-column slice of O of one (batch, head), the heaviest query
// tiles launched first; one consumer warpgroup and a producer warp. For each
// 64-key tile the producer streams the (Q_c, K_c) chunk pairs through an
// 8-stage ring and then the tile's V slice through a 2-stage ring; the
// consumer sums S over the chunks (each chunk's stage released as the next
// chunk's product is issued), runs the online softmax on S as
// flash_kernels.cuh's forward does, rescales O, rounds P to T and issues
// O += P·V_slice, which runs while the next tile's chunks are multiplied.
template <typename T>
__global__ void __launch_bounds__(block_threads(1), 1) flash_fwd_sliced_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, void* __restrict__ o, float* __restrict__ lse,
    int H, int Sq, int Sk, int D, int q_offset, int k_offset, float scale_log2, int causal,
    int out_f32) {
  using namespace hopper;
  using Smem = FwdSlicedSmem;
  constexpr int kStages = Smem::kStages, kVStages = Smem::kVStages;
  constexpr int kVElems = Smem::kVBytes / 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  T* sqk = reinterpret_cast<T*>(smem);  // stage s: the Q chunk, then the K chunk
  T* sv = reinterpret_cast<T*>(smem + kStages * Smem::kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * Smem::kStageBytes +
                                               kVStages * Smem::kVBytes);
  uint64_t* empty = full + kStages;
  uint64_t* vfull = empty + kStages;
  uint64_t* vempty = vfull + kVStages;

  const int n_ch = chunks_of(D), n_sl = slices_of(D, kRowSlice);
  const int n_qt = (Sq + kTile - 1) / kTile;
  const int per_qt = gridDim.x / n_qt, BH = per_qt / n_sl;  // blocks a query tile
  const int qt = n_qt - 1 - blockIdx.x / per_qt;  // the last query tiles carry the most keys
  const int sl = blockIdx.x % per_qt / BH, bh = blockIdx.x % BH, b = bh / H, h = bh % H;
  const int q0 = qt * kTile, col0 = sl * kRowSlice;
  const int v_chunks = slice_chunks(D, col0, kRowSlice);
  const int n_kt = key_tiles<kTile>(Sk, q0, q_offset, k_offset, causal);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    for (int s = 0; s < kVStages; ++s) {
      mbar_init(&vfull[s], 1);
      mbar_init(&vempty[s], 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer warp
    if (threadIdx.x == 128) {  // one thread issues every load
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      for (int kt = 0, it = 0; kt < n_kt; ++kt) {
        for (int c = 0; c < n_ch; ++c, ++it) {
          const int s = it % kStages;
          T* dst = sqk + s * 2 * kChunkElems;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], 2 * kChunkBytes);
          tma_load_4d(dst, &tq, &full[s], c * kChunk, h, q0, b);
          tma_load_4d(dst + kChunkElems, &tk, &full[s], c * kChunk, h, kt * kTile, b);
        }
        const int vs = kt % kVStages;
        mbar_wait(&vempty[vs], ((kt / kVStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&vfull[vs], v_chunks * kChunkBytes);
        for (int c = 0; c < v_chunks; ++c) {
          tma_load_4d(sv + vs * kVElems + c * kChunkElems, &tv, &vfull[vs], col0 + c * kChunk, h,
                      kt * kTile, b);
        }
      }
    }
  } else {  // the consumer warpgroup: query rows q0 ...
    const int lane = threadIdx.x & 31, t = lane & 3, g = lane >> 2;
    const int row0 = q0 + (threadIdx.x >> 5) * 16;  // this warp's first row
    const FwdRows rows = {q_offset + row0 + g, t, Sk, causal, k_offset, scale_log2};
    const int n_open = open_key_tiles<kTile>(n_kt, Sk, q0, q_offset, k_offset, causal);

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
        const T* stage = sqk + s * 2 * kChunkElems;
        mbar_wait(&full[s], (it / kStages) & 1);
        wgmma_fence();
        issue_chunk<T>(sc[0], stage, stage + kChunkElems, c == 0);
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
      mbar_wait(&vfull[vs], (kt / kVStages) & 1);
      wgmma_fence();
      issue_rs_slice<T, kRowSlice>(acc, pa, sv + vs * kVElems, v_chunks);
      wgmma_commit();
    }
    if (n_kt > 0) {
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      release_stage(&vempty[(n_kt - 1) % kVStages]);
    }

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
// Bound: 6·D FLOPs a visible pair (0.209 ms at the LM's D-512 shape). Design:
// one block owns 64 query rows and one 256-column slice of dQ of one (batch,
// head), the heaviest query tiles first; one consumer warpgroup keeps the
// rows' lse (times log2 e) and delta in registers. For each 64-key tile the
// producer streams (Q_c, dO_c, K_c, V_c) chunk quadruples through a 4-stage
// ring and then the tile's K slice through a 2-stage ring; the consumer sums
// S = Q·Kᵀ and dP = dO·Vᵀ over the chunks, forms dS as flash_kernels.cuh's dq
// does, rounds it to T and sums dQ_slice += dS·K_slice. dS·K is not overlapped
// with the next tile's chunks: S, dP and dQ already take 192 registers a
// thread. A block that sees no key loads nothing and writes dQ = 0.
template <typename T>
__global__ void __launch_bounds__(block_threads(1), 1) flash_bwd_dq_sliced_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta, T* __restrict__ dq,
    int H, int Sq, int Sk, int D, int q_offset, int k_offset, float scale, float scale_log2,
    int causal) {
  using namespace hopper;
  using Smem = DqSlicedSmem;
  constexpr int kStages = Smem::kStages, kKStages = Smem::kKStages;
  constexpr int kKElems = Smem::kKBytes / 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  T* schunks = reinterpret_cast<T*>(smem);  // stage s: the Q, dO, K and V chunks
  T* sk = reinterpret_cast<T*>(smem + kStages * Smem::kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * Smem::kStageBytes +
                                               kKStages * Smem::kKBytes);
  uint64_t* empty = full + kStages;
  uint64_t* kfull = empty + kStages;
  uint64_t* kempty = kfull + kKStages;

  const int n_ch = chunks_of(D), n_sl = slices_of(D, kRowSlice);
  const int n_qt = (Sq + kTile - 1) / kTile;
  const int per_qt = gridDim.x / n_qt, BH = per_qt / n_sl;
  const int qt = n_qt - 1 - blockIdx.x / per_qt;
  const int sl = blockIdx.x % per_qt / BH, bh = blockIdx.x % BH, b = bh / H, h = bh % H;
  const int q0 = qt * kTile, col0 = sl * kRowSlice;
  const int k_chunks = slice_chunks(D, col0, kRowSlice);
  const int n_kt = key_tiles<kTile>(Sk, q0, q_offset, k_offset, causal);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    for (int s = 0; s < kKStages; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&kempty[s], 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer warp
    if (threadIdx.x == 128) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tdo);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      for (int kt = 0, it = 0; kt < n_kt; ++kt) {
        for (int c = 0; c < n_ch; ++c, ++it) {
          const int s = it % kStages;
          T* dst = schunks + s * 4 * kChunkElems;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], 4 * kChunkBytes);
          tma_load_4d(dst, &tq, &full[s], c * kChunk, h, q0, b);
          tma_load_4d(dst + kChunkElems, &tdo, &full[s], c * kChunk, h, q0, b);
          tma_load_4d(dst + 2 * kChunkElems, &tk, &full[s], c * kChunk, h, kt * kTile, b);
          tma_load_4d(dst + 3 * kChunkElems, &tv, &full[s], c * kChunk, h, kt * kTile, b);
        }
        const int ks = kt % kKStages;
        mbar_wait(&kempty[ks], ((kt / kKStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&kfull[ks], k_chunks * kChunkBytes);
        for (int c = 0; c < k_chunks; ++c) {
          tma_load_4d(sk + ks * kKElems + c * kChunkElems, &tk, &kfull[ks], col0 + c * kChunk, h,
                      kt * kTile, b);
        }
      }
    }
  } else {  // the consumer warpgroup: query rows q0 ...
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int row0 = q0 + (threadIdx.x >> 5) * 16;  // this warp's first row
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
    const int n_open = open_key_tiles<kTile>(n_kt, Sk, q0, q_offset, k_offset, causal);

    float acc[kRowSlice / 2];
#pragma unroll
    for (int i = 0; i < kRowSlice / 2; ++i) acc[i] = 0.f;
    float sc[32], dp[32];  // S and dP, then dS in dp: f32, accumulator layout
    uint32_t da[4][4];     // dS in T: the A fragments of dS·K

    for (int kt = 0, it = 0; kt < n_kt; ++kt) {
      for (int c = 0; c < n_ch; ++c, ++it) {
        const int s = it % kStages;
        const T* stage = schunks + s * 4 * kChunkElems;
        mbar_wait(&full[s], (it / kStages) & 1);
        wgmma_fence();
        issue_chunk<T>(sc, stage, stage + 2 * kChunkElems, c == 0);
        issue_chunk<T>(dp, stage + kChunkElems, stage + 3 * kChunkElems, c == 0);
        wgmma_commit();
        wgmma_wait<1>();
        if (c > 0) release_stage(&empty[(it - 1) % kStages]);
      }
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      release_stage(&empty[(it - 1) % kStages]);
      if (kt < n_open) {
        dq_probs<false>(sc, dp, kt * kTile, rows);
      } else {
        dq_probs<true>(sc, dp, kt * kTile, rows);
      }
      pack_a<T>(da, dp);
      const int ks = kt % kKStages;
      mbar_wait(&kfull[ks], (kt / kKStages) & 1);
      wgmma_fence();
      issue_rs_slice<T, kRowSlice>(acc, da, sk + ks * kKElems, k_chunks);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(da);
      release_stage(&kempty[ks]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      if (row >= Sq) continue;
      const long long base = (((long long)b * Sq + row) * H + h) * D;
#pragma unroll
      for (int j = 0; j < kRowSlice / 8; ++j) {
        const int d = col0 + j * 8 + 2 * t;
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

// The grid of a sliced kernel: (batch, head) x row tiles x column slices, or
// 0 if that is past one launch's 2^31 - 1 blocks.
inline unsigned sliced_blocks(int B, int H, int S, int D, int width) {
  const long long n = (long long)B * H * ((S + kTile - 1) / kTile) * slices_of(D, width);
  return n < (1ll << 31) ? (unsigned)n : 0u;
}

template <typename T>
cudaError_t launch_fwd_sliced(const FwdArgs& a, cudaStream_t stream) {
  constexpr size_t kBytes = FwdSlicedSmem::kBytes;
  const unsigned blocks = sliced_blocks(a.B, a.H, a.Sq, a.D, kRowSlice);
  if (blocks == 0) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  cudaError_t rc = allow_smem(flash_fwd_sliced_kernel<T>, kBytes);
  if (rc == cudaSuccess) rc = view_map<T, 256>(&tq, a.q, a.B, a.Sq, a.H, a.D, kTile);
  if (rc == cudaSuccess) rc = view_map<T, 256>(&tk, a.k, a.B, a.Sk, a.H, a.D, kTile);
  if (rc == cudaSuccess) rc = view_map<T, 256>(&tv, a.v, a.B, a.Sk, a.H, a.D, kTile);
  if (rc != cudaSuccess) return rc;
  flash_fwd_sliced_kernel<T><<<blocks, block_threads(1), kBytes, stream>>>(
      tq, tk, tv, a.o, a.lse, a.H, a.Sq, a.Sk, a.D, a.q_offset, a.k_offset, a.scale * kLog2e,
      a.causal, a.out_f32);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_dq_sliced(const BwdArgs& a, cudaStream_t stream) {
  constexpr size_t kBytes = DqSlicedSmem::kBytes;
  const unsigned blocks = sliced_blocks(a.B, a.H, a.Sq, a.D, kRowSlice);
  if (blocks == 0) return cudaErrorInvalidValue;
  const View dout = {a.dout, (long long)a.Sq * a.H * a.D, (long long)a.H * a.D, a.D};
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t rc = allow_smem(flash_bwd_dq_sliced_kernel<T>, kBytes);
  if (rc == cudaSuccess) rc = view_map<T, 256>(&tq, a.q, a.B, a.Sq, a.H, a.D, kTile);
  if (rc == cudaSuccess) rc = view_map<T, 256>(&tdo, dout, a.B, a.Sq, a.H, a.D, kTile);
  if (rc == cudaSuccess) rc = view_map<T, 256>(&tk, a.k, a.B, a.Sk, a.H, a.D, kTile);
  if (rc == cudaSuccess) rc = view_map<T, 256>(&tv, a.v, a.B, a.Sk, a.H, a.D, kTile);
  if (rc != cudaSuccess) return rc;
  flash_bwd_dq_sliced_kernel<T><<<blocks, block_threads(1), kBytes, stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<T*>(a.dq), a.H, a.Sq, a.Sk, a.D, a.q_offset,
      a.k_offset, a.scale, a.scale * kLog2e, a.causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_dkv_sliced(const BwdArgs& a, cudaStream_t stream) {
  constexpr size_t kBytes = DkvSlicedSmem::kBytes;
  const unsigned blocks = sliced_blocks(a.B, a.H, a.Sk, a.D, kKeySlice);
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
