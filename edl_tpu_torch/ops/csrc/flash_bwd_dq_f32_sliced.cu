// flash_bwd_dq_f32_sliced_kernel: dQ for f32 inputs past a head dim of 256,
// on the tensor cores in 3xTF32 (flash_tf32.cuh), compiled on its own so that
// the build runs one nvcc process per unit (flash_launch.h).
//
// Replaces _bwd_dq_kernel of edl_tpu/ops/flash_attention.py for f32 q, k and
// v where D > 256, with flash_kernels.cuh's semantics: global positions, the
// ragged edge masked in the kernel, masking through the validity bit, a row
// that sees no key writes dQ = 0 exactly, lse and delta (B, H, Sq) f32, dO
// f32 and contiguous. The Pallas kernel multiplies in f32; 3xTF32 keeps each
// product within about 2^-21 of it.
//
// Bound: 6·D FLOPs a visible pair, at 495/3 TFLOP/s (3xTF32). Design: one
// block owns 64 query rows and 512 columns of dQ of one (batch, head), the
// heaviest query tiles first, in flash_kernels.cuh's block: a producer
// warpgroup (setmaxnreg down) and two consumer warpgroups (setmaxnreg up).
// Per 64-key tile the producer's first warp streams (V_c, dO_c) chunk pairs
// for dP = dO·Vᵀ and then Q_c (with K_c where c lies outside the block's
// columns) for S = Q·Kᵀ through a 5-stage ring; its second warp loads the
// tile's K chunks of the block's 512 columns into the K buffer once the last
// tile's dS·K is done, and they serve S and then dS·K, so K is read once.
// Consumer w sums S and dP for keys 32w ... 32w + 31 of the tile over every
// chunk in order (warp i: rows 16i ... 16i + 15), forms dS as flash_kernels.cuh's
// dq does, and stores it into the dS tile; a named barrier hands the two
// halves over, and warp i of consumer w sums dQ += dS·K for all 64 rows and
// the block's chunks 8w + 2i and 8w + 2i + 1 (128 f32 registers a thread).
// So the scores are summed once a 512-column slice (6·D FLOPs a pair up to D
// 512), every slice of a row in the same order. dQ stays in registers and
// is written once: no atomics, deterministic sums. Every wait spins without
// a bound (`mbar_wait_spin`).
//
// Shared memory (kSmemMax 232,448): the K buffer, 16 chunks of 8 KB
// (131,072); the ring, 5 stages of two chunks (81,920); the dS tile
// (16,384); 27 barriers (216); 1,024 of alignment slack: 230,616. The ring
// holds what is left (4 stages would leave 16 KB idle); dO cannot stay
// (another 128 KB at D 512).

#include "flash_tf32.cuh"

namespace edl_flash {
namespace {

using namespace tf32;

constexpr int kDqSliceF32 = 512;  // dQ's columns a block: 256 a consumer warpgroup

struct DqF32Smem {
  static constexpr int kStages = 5;
  static constexpr int kKChunks = kDqSliceF32 / kChunk;
  static constexpr size_t kBytes = 1024 + kStages * 2 * kChunkBytes + kKChunks * kChunkBytes +
                                   kScoreElems * 4 + (2 * kStages + kKChunks + 1) * 8;
  static_assert(kBytes <= kSmemMax, "f32 sliced dq shared memory");
};

__global__ void __launch_bounds__(kWsThreads, 1) flash_bwd_dq_f32_sliced_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dq,
    int H, int Sq, int Sk, int D, int q_offset, int k_offset, float scale, float scale_log2,
    int causal) {
  using namespace hopper;
  using Smem = DqF32Smem;
  constexpr int kStages = Smem::kStages, kKChunks = Smem::kKChunks;
  constexpr int kStageElems = 2 * kChunkElems;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  float* sring = reinterpret_cast<float*>(smem);  // stage s: V_c and dO_c, or Q_c (and K_c)
  float* skb = sring + kStages * kStageElems;     // the K buffer: the block's chunks
  float* sds = skb + kKChunks * kChunkElems;      // the dS tile
  uint64_t* full = reinterpret_cast<uint64_t*>(sds + kScoreElems);
  uint64_t* empty = full + kStages;
  uint64_t* kfull = empty + kStages;  // one a K buffer chunk
  uint64_t* kempty = kfull + kKChunks;

  const int n_ch = chunks_of(D), n_sl = slices_of(D, kDqSliceF32);
  const int n_qt = (Sq + kTile - 1) / kTile;
  const int per_qt = gridDim.x / n_qt, BH = per_qt / n_sl;
  const int qt = n_qt - 1 - blockIdx.x / per_qt;  // the last query tiles carry the most keys
  const int sl = blockIdx.x % per_qt / BH, bh = blockIdx.x % BH, b = bh / H, h = bh % H;
  const int q0 = qt * kTile, c0 = sl * kKChunks;
  const int own = slice_chunks(D, c0, kDqSliceF32);  // the block's chunks: c0 ... c0 + own - 1
  const int n_kt = key_tiles<kTile>(Sk, q0, q_offset, k_offset, causal);

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
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  if (wg == 2) {  // the producer warpgroup: its first warp feeds the ring, its second the K buffer
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 0 && lane == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tdo);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      for (int kt = 0, it = 0; kt < n_kt; ++kt) {
        for (int j = 0; j < 2 * n_ch; ++j, ++it) {
          const int s = it % kStages;
          float* dst = sring + s * kStageElems;
          mbar_wait_spin(&empty[s], ((it / kStages) & 1) ^ 1);
          if (j < n_ch) {  // dP's pass: V_c and dO_c
            mbar_arrive_expect_tx(&full[s], 2 * kChunkBytes);
            tma_load_4d(dst, &tv, &full[s], j * kChunk, h, kt * kTile, b);
            tma_load_4d(dst + kChunkElems, &tdo, &full[s], j * kChunk, h, q0, b);
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
  } else {  // consumer warpgroup wg: keys 32·wg ... of each tile's scores; dQ's chunks 8·wg ...
    setmaxnreg_inc<kConsumerRegs>();
    const int g = lane >> 2, t = lane & 3;
    const int qrow = warp * 16 + g;  // this thread's first row of the scores
    const int key0 = 32 * wg;        // this warpgroup's first key column
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
    // this warp's chunks of dQ: the block's chunks mine and mine + 1, those below own
    const int mine = 8 * wg + 2 * warp;
    const int n_mine = own - mine < 0 ? 0 : own - mine < 2 ? own - mine : 2;

    float acc[4][8][4];  // dQ: 64 rows x this warp's 64 columns
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][i][e] = 0.f;

    for (int kt = 0, it = 0; kt < n_kt; ++kt) {
      float sc[16], dp[16];  // S and dP, then dS in dp: 16 rows x the warpgroup's 32 keys
#pragma unroll
      for (int i = 0; i < 16; ++i) sc[i] = dp[i] = 0.f;
      for (int c = 0; c < n_ch; ++c, ++it) {  // dP = dO·Vᵀ
        const int s = it % kStages;
        const float* stage = sring + s * kStageElems;  // V_c, then dO_c
        mbar_wait_spin(&full[s], (it / kStages) & 1);
        chunk_scores(dp, stage + kChunkElems, warp * 16, stage, key0);
        release_stage(&empty[s]);
      }
      for (int c = 0; c < n_ch; ++c, ++it) {  // S = Q·Kᵀ
        const int s = it % kStages;
        const float* stage = sring + s * kStageElems;  // Q_c (and K_c outside the block's)
        const bool other = c < c0 || c >= c0 + own;
        mbar_wait_spin(&full[s], (it / kStages) & 1);
        if (!other) mbar_wait_spin(&kfull[c - c0], kt & 1);
        chunk_scores(sc, stage, warp * 16,
                     other ? stage + kChunkElems : skb + (c - c0) * kChunkElems, key0);
        release_stage(&empty[s]);
      }
      if (kt < n_open) {
        dq_probs<false>(sc, dp, kt * kTile + key0, rows);
      } else {
        dq_probs<true>(sc, dp, kt * kTile + key0, rows);
      }
      if (kt > 0) named_bar_sync(kFreeBarrier, 256);  // both warpgroups' dS·K of tile kt - 1 is done
      store_scores(sds, dp, warp * 16, key0);
      named_bar_sync(kHandBarrier, 256);  // both halves of dS are in place
      tile_product(acc, sds, skb + mine * kChunkElems, n_mine);
      release_stage(kempty);  // this warp is done with the K buffer
    }
    store_rows(dq, acc, b, h, H, Sq, D, q0, (c0 + mine) * kChunk, n_mine);
  }
}

}  // namespace

// Past a head dim of 256: one launch, (batch, head) x 64-row query tiles x
// 512-column slices of dQ blocks.
cudaError_t launch_bwd_dq_f32_sliced(const BwdArgs& a, cudaStream_t stream) {
  constexpr size_t kBytes = DqF32Smem::kBytes;
  const unsigned blocks = sliced_blocks(a.B, a.H, a.Sq, a.D, kTile, kDqSliceF32);
  if (blocks == 0) return cudaErrorInvalidValue;
  const View dout = {a.dout, (long long)a.Sq * a.H * a.D, (long long)a.H * a.D, a.D};
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t rc = allow_smem(flash_bwd_dq_f32_sliced_kernel, kBytes);
  if (rc == cudaSuccess) rc = f32_map(&tq, a.q, a.B, a.Sq, a.H, a.D);
  if (rc == cudaSuccess) rc = f32_map(&tdo, dout, a.B, a.Sq, a.H, a.D);
  if (rc == cudaSuccess) rc = f32_map(&tk, a.k, a.B, a.Sk, a.H, a.D);
  if (rc == cudaSuccess) rc = f32_map(&tv, a.v, a.B, a.Sk, a.H, a.D);
  if (rc != cudaSuccess) return rc;
  flash_bwd_dq_f32_sliced_kernel<<<blocks, kWsThreads, kBytes, stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<float*>(a.dq), a.H, a.Sq, a.Sk, a.D,
      a.q_offset, a.k_offset, a.scale, a.scale * kLog2e, a.causal);
  return cudaGetLastError();
}

}  // namespace edl_flash
