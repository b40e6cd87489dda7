// flash_fwd_f32_sliced_kernel: the forward for f32 inputs past a head dim of
// 256, on the tensor cores in 3xTF32 (flash_tf32.cuh), compiled on its own so
// that the build runs one nvcc process per unit (flash_launch.h).
//
// Replaces _fwd_kernel of edl_tpu/ops/flash_attention.py for f32 q, k and v
// where D > 256, with flash_fwd_f32.cu's semantics: global positions, the
// ragged edge masked in the kernel, masking through the validity bit, a row
// that sees no key writes O = 0 and lse = -1e30 exactly, lse (B, H, Sq) f32,
// O contiguous f32, the heaviest query tiles first, causally dead key tiles
// skipped. The Pallas kernel multiplies in f32; 3xTF32 keeps each product
// within about 2^-21 of it.
//
// Bound: 4·D FLOPs a visible pair, at 495/3 TFLOP/s (3xTF32). Design: the
// sliced dq's (flash_bwd_dq_f32_sliced.cu) with V in K's place. One block
// owns 64 query rows and 512 columns of O of one (batch, head), the heaviest
// query tiles first, in flash_kernels.cuh's block: a producer warpgroup
// (setmaxnreg down) and two consumer warpgroups (setmaxnreg up). Per 64-key
// tile the producer's first warp streams (Q_c, K_c) chunk pairs for S =
// Q·Kᵀ through a 5-stage ring; its second warp loads the tile's V chunks of
// the block's 512 columns into the V buffer once the last tile's P·V is
// done. Consumer w sums S for keys 32w ... 32w + 31 of the tile over every
// chunk in order (warp i: rows 16i ... 16i + 15), each step's three products
// into a fresh accumulator (`chunk_scores`' kStepSums), and the two exchange
// the rows' statistics through shared memory (`fwd_tile_softmax`,
// flash_tf32.cuh), store P into the score tile and hand it over with a named
// barrier; warp i of consumer w scales its rows of O by alpha and sums O +=
// P·V for all 64 rows and the block's chunks 8w + 2i and 8w + 2i + 1 (128
// f32 registers a thread). So the scores are summed once a 512-column slice
// (4·D FLOPs a pair up to D 512), every slice of a row in the same order, so
// that every slice holds the same m and l; only slice 0 writes lse. O stays
// in registers and is written once, divided by l. Every wait spins without a
// bound (`mbar_wait_spin`).
//
// Shared memory (kSmemMax 232,448): the V buffer, 16 chunks of 8 KB
// (131,072); the ring, 5 stages of two chunks (81,920); the P tile (16,384);
// the row statistics (1,536); 12 barriers (96); 1,024 of alignment slack:
// 232,032. Q cannot stay (another 128 KB at D 512): it comes with K.

#include "flash_tf32.cuh"

namespace edl_flash {
namespace {

using namespace tf32;

constexpr int kFwdSliceF32 = 512;  // O's columns a block: 256 a consumer warpgroup

struct FwdF32Smem {
  static constexpr int kStages = 5;
  static constexpr int kVChunks = kFwdSliceF32 / kChunk;
  static constexpr size_t kBytes = 1024 + kStages * 2 * kChunkBytes + kVChunks * kChunkBytes +
                                   kScoreElems * 4 + sizeof(RowStats) + (2 * kStages + 2) * 8;
  static_assert(kBytes <= kSmemMax, "f32 sliced forward shared memory");
};

__global__ void __launch_bounds__(kWsThreads, 1) flash_fwd_f32_sliced_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, float* __restrict__ o, float* __restrict__ lse,
    int H, int Sq, int Sk, int D, int q_offset, int k_offset, float scale, int causal) {
  using namespace hopper;
  using Smem = FwdF32Smem;
  constexpr int kStages = Smem::kStages, kVChunks = Smem::kVChunks;
  constexpr int kStageElems = 2 * kChunkElems;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  float* sring = reinterpret_cast<float*>(smem);  // stage s: Q_c, then K_c
  float* svb = sring + kStages * kStageElems;     // the V buffer: the block's chunks
  float* sp = svb + kVChunks * kChunkElems;       // the P tile
  RowStats& st = *reinterpret_cast<RowStats*>(sp + kScoreElems);
  uint64_t* full = reinterpret_cast<uint64_t*>(&st + 1);
  uint64_t* empty = full + kStages;
  uint64_t* vfull = empty + kStages;  // the V buffer landed
  uint64_t* vempty = vfull + 1;       // the V buffer's last P·V is done

  const int n_ch = chunks_of(D), n_sl = slices_of(D, kFwdSliceF32);
  const int n_qt = (Sq + kTile - 1) / kTile;
  const int per_qt = gridDim.x / n_qt, BH = per_qt / n_sl;
  const int qt = n_qt - 1 - blockIdx.x / per_qt;  // the last query tiles carry the most keys
  const int sl = blockIdx.x % per_qt / BH, bh = blockIdx.x % BH, b = bh / H, h = bh % H;
  const int q0 = qt * kTile, c0 = sl * kVChunks;
  const int own = slice_chunks(D, c0, kFwdSliceF32);  // the block's chunks: c0 ... c0 + own - 1
  const int n_kt = key_tiles<kTile>(Sk, q0, q_offset, k_offset, causal);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init(vfull, 1);
    mbar_init(vempty, 8);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = warpgroup_index();
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  if (wg == 2) {  // the producer warpgroup: its first warp feeds the ring, its second the V buffer
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 0 && lane == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      for (int kt = 0, it = 0; kt < n_kt; ++kt) {
        for (int c = 0; c < n_ch; ++c, ++it) {
          const int s = it % kStages;
          float* dst = sring + s * kStageElems;
          mbar_wait_spin(&empty[s], ((it / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], 2 * kChunkBytes);
          tma_load_4d(dst, &tq, &full[s], c * kChunk, h, q0, b);
          tma_load_4d(dst + kChunkElems, &tk, &full[s], c * kChunk, h, kt * kTile, b);
        }
      }
    } else if (warp == 1 && lane == 0) {
      tma_prefetch_map(&tv);
      for (int kt = 0; kt < n_kt; ++kt) {
        mbar_wait_spin(vempty, (kt & 1) ^ 1);  // O += P·V of tile kt - 1 is done
        mbar_arrive_expect_tx(vfull, own * kChunkBytes);
        for (int i = 0; i < own; ++i) {
          tma_load_4d(svb + i * kChunkElems, &tv, vfull, (c0 + i) * kChunk, h, kt * kTile, b);
        }
      }
    }
  } else {  // consumer warpgroup wg: keys 32·wg ... of each tile's scores; O's chunks 8·wg ...
    setmaxnreg_inc<kConsumerRegs>();
    const int g = lane >> 2, t = lane & 3;
    const int srow = warp * 16;  // this warp's first row of the scores
    const F32Rows rows = {q_offset + q0 + srow + g, t, Sk, causal, k_offset, scale};
    // this warp's chunks of O: the block's chunks mine and mine + 1, those below own
    const int mine = 8 * wg + 2 * warp;
    const int n_mine = own - mine < 0 ? 0 : own - mine < 2 ? own - mine : 2;

    float acc[4][8][4];  // O: 64 rows x this warp's 64 columns
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][i][e] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // the score rows srow + g, + 8

    for (int kt = 0, it = 0; kt < n_kt; ++kt) {
      float sc[16];  // S, then P: 16 rows x the warpgroup's 32 keys
#pragma unroll
      for (int i = 0; i < 16; ++i) sc[i] = 0.f;
      for (int c = 0; c < n_ch; ++c, ++it) {  // S = Q·Kᵀ
        const int s = it % kStages;
        const float* stage = sring + s * kStageElems;  // Q_c, then K_c
        mbar_wait_spin(&full[s], (it / kStages) & 1);
        chunk_scores<2, true>(sc, stage, srow, stage + kChunkElems, 32 * wg);
        release_stage(&empty[s]);
      }
      float alpha[2];
      fwd_tile_softmax(sc, m, alpha, st, sp, wg, srow, kt * kTile + 32 * wg, rows);
      named_bar_sync(kHandBarrier, 256);  // both halves of P, the sums and alpha are in place
      fwd_row_sums(l, alpha, st, srow);
      rows_by<false>(acc, st.alpha, 0);
      mbar_wait_spin(vfull, kt & 1);
      tile_product(acc, sp, svb + mine * kChunkElems, n_mine);
      release_stage(vempty);  // this warp is done with the V buffer
    }
    if (wg == 0 && t == 0) {  // one writer a row; lse from slice 0 only
      st.l[srow + g] = l[0];
      st.l[srow + g + 8] = l[1];
      if (sl == 0) store_lse(lse, m, l, bh, Sq, q0, srow);
    }
    named_bar_sync(kStatBarrier, 256);  // every row's l is in place
    rows_by<true>(acc, st.l, 0);
    store_rows(o, acc, b, h, H, Sq, D, q0, (c0 + mine) * kChunk, n_mine);
  }
}

}  // namespace

// Past a head dim of 256: one launch, (batch, head) x 64-row query tiles x
// 512-column slices of O blocks.
cudaError_t launch_fwd_f32_sliced(const FwdArgs& a, cudaStream_t stream) {
  constexpr size_t kBytes = FwdF32Smem::kBytes;
  const unsigned blocks = sliced_blocks(a.B, a.H, a.Sq, a.D, kTile, kFwdSliceF32);
  if (blocks == 0) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  cudaError_t rc = allow_smem(flash_fwd_f32_sliced_kernel, kBytes);
  if (rc == cudaSuccess) rc = f32_map(&tq, a.q, a.B, a.Sq, a.H, a.D);
  if (rc == cudaSuccess) rc = f32_map(&tk, a.k, a.B, a.Sk, a.H, a.D);
  if (rc == cudaSuccess) rc = f32_map(&tv, a.v, a.B, a.Sk, a.H, a.D);
  if (rc != cudaSuccess) return rc;
  flash_fwd_f32_sliced_kernel<<<blocks, kWsThreads, kBytes, stream>>>(
      tq, tk, tv, static_cast<float*>(a.o), a.lse, a.H, a.Sq, a.Sk, a.D, a.q_offset, a.k_offset,
      a.scale, a.causal);
  return cudaGetLastError();
}

}  // namespace edl_flash
