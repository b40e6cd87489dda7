// flash_bwd_dkv_f32_sliced_kernel: dK and dV for f32 inputs past a head dim
// of 256, on the tensor cores in 3xTF32 (flash_tf32.cuh), compiled on its own
// so that the build runs one nvcc process per unit (flash_launch.h).
//
// Replaces _bwd_dkv_kernel of edl_tpu/ops/flash_attention.py for f32 q, k and
// v where D > 256, with flash_kernels.cuh's semantics: global positions, the
// ragged edge masked in the kernel, masking through the validity bit, a key
// that no query sees writes dK = dV = 0 exactly, lse and delta (B, H, Sq)
// f32, dO f32 and contiguous. The Pallas kernel multiplies in f32; 3xTF32
// keeps each product within about 2^-21 of it.
//
// Bound: 8·D FLOPs a visible pair, at 495/3 TFLOP/s (3xTF32). Design: one
// block owns 64 keys and one 256-column slice of dK and of dV of one (batch,
// head), the earliest key tiles first, in flash_kernels.cuh's block: a
// producer warpgroup (setmaxnreg down; its first warp works) and two
// consumer warpgroups (setmaxnreg up). For each 64-query tile from the
// first that sees the keys, the producer streams the tile's (K_c, V_c, Q_c,
// dO_c) chunk quadruples through a 2-stage ring in chunk order; the Q and dO
// chunks of the block's slice land in the slice buffers instead of the ring,
// so that they are read from L2 once, not once for the scores and once for
// the products; before the slice's first chunk it stores the tile's lse
// (times log2 e) and delta. Consumer w sums Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ over
// every chunk for queries 32w ... 32w + 31 (warp i: keys 16i ... 16i + 15),
// forms Pᵀ and dSᵀ as flash_kernels.cuh's dkv does and stores them into
// score tiles; a named barrier hands the two halves over, and warp i of
// warpgroup 0 sums dV += Pᵀ·dO and of warpgroup 1 dK += dSᵀ·Q, for all 64
// keys and the slice's chunks 2i and 2i + 1 (128 f32 registers a thread).
// So the scores are summed twice a tile at D 512 (12·D FLOPs a pair), every
// slice of a key in the same chunk order. dK and dV stay in registers and
// are written once: no atomics, deterministic sums. Every wait spins
// without a bound (`mbar_wait_spin`).
//
// Shared memory (kSmemMax 232,448): the Q and dO slice buffers, 8 chunks of
// 8 KB each (131,072); the ring, 2 stages of four chunks (65,536); the Pᵀ
// and dSᵀ tiles (32,768); the tile's lse and delta (512); 6 barriers (48);
// 1,024 of alignment slack: 230,960. A third stage would not fit.

#include "flash_tf32.cuh"

namespace edl_flash {
namespace {

using namespace tf32;

constexpr int kKeySliceF32 = 256;  // dK's and dV's columns a block

struct DkvF32Smem {
  static constexpr int kStages = 2;
  static constexpr int kSliceElems = kKeySliceF32 / kChunk * kChunkElems;  // one of Q's, dO's
  static constexpr size_t kBytes = 1024 + kStages * 4 * kChunkBytes + 2 * kSliceElems * 4 +
                                   2 * kScoreElems * 4 + 2 * kTile * 4 + (2 * kStages + 2) * 8;
  static_assert(kBytes <= kSmemMax, "f32 sliced dkv shared memory");
};

__global__ void __launch_bounds__(kWsThreads, 1) flash_bwd_dkv_f32_sliced_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, int H, int Sq, int Sk, int D, int q_offset, int k_offset,
    float scale, float scale_log2, int causal) {
  using namespace hopper;
  using Smem = DkvF32Smem;
  constexpr int kStages = Smem::kStages, kSliceElems = Smem::kSliceElems;
  constexpr int kStageElems = 4 * kChunkElems;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  float* sring = reinterpret_cast<float*>(smem);  // stage s: K_c, V_c, Q_c, dO_c
  float* sslice = sring + kStages * kStageElems;  // the Q slice, then the dO slice
  float* spt = sslice + 2 * kSliceElems;          // the Pᵀ tile, then the dSᵀ tile
  float* slse = spt + 2 * kScoreElems;
  float* sdelta = slse + kTile;
  uint64_t* full = reinterpret_cast<uint64_t*>(sdelta + kTile);
  uint64_t* empty = full + kStages;
  uint64_t* tfull = empty + kStages;  // the tile's lse and delta are stored
  uint64_t* sfree = tfull + 1;        // the last tile's slice products are done

  const int n_ch = chunks_of(D), n_sl = slices_of(D, kKeySliceF32);
  const int n_kt = (Sk + kTile - 1) / kTile;
  const int per_kt = gridDim.x / n_kt, BH = per_kt / n_sl;
  const int kt = blockIdx.x / per_kt;  // the first key tiles are seen by the most queries
  const int sl = blockIdx.x % per_kt / BH, bh = blockIdx.x % BH, b = bh / H, h = bh % H;
  const int k0 = kt * kTile, c0 = sl * (kKeySliceF32 / kChunk);
  const int q_chunks = slice_chunks(D, c0, kKeySliceF32);  // the slice's: c0 ... c0 + q_chunks - 1
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
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  if (wg == 2) {  // the producer warpgroup; its first warp works
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 0) {
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
        for (int c = 0; c < n_ch; ++c, ++it) {
          const bool mine = c >= c0 && c < c0 + q_chunks;  // a chunk of the block's slice
          if (c == c0) {
            // the last tile's slice products, and its reads of lse and
            // delta, are done: the slice buffers and lse and delta are free
            mbar_wait_spin(sfree, (i & 1) ^ 1);
            for (int r = lane; r < kTile; r += 32) {
              const bool ok = q0 + r < Sq;
              slse[r] = ok ? lseb[q0 + r] * kLog2e : 0.f;
              sdelta[r] = ok ? deltab[q0 + r] : 0.f;
            }
            mbar_arrive(tfull);  // each lane's arrival releases its own stores
          }
          if (lane == 0) {
            const int s = it % kStages;
            float* dst = sring + s * kStageElems;
            float* qc = mine ? sslice + (c - c0) * kChunkElems : dst + 2 * kChunkElems;
            float* doc = mine ? sslice + kSliceElems + (c - c0) * kChunkElems
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
  } else {  // consumer warpgroup wg: queries 32·wg ... of each tile's scores; dV (0) or dK (1)
    setmaxnreg_inc<kConsumerRegs>();
    const int g = lane >> 2, t = lane & 3;
    const int krow = warp * 16 + g;  // this thread's first key row of the scores
    const int qcol0 = 32 * wg;       // this warpgroup's first query column
    const DkvKeys keys = {k_offset + k0 + krow, k0 + krow, t, Sq, Sk, causal, q_offset, scale,
                          scale_log2};
    // a query tile is masked iff it crosses the ragged edge or the diagonal
    const bool keys_ragged = k0 + kTile > Sk;
    const int diag = k_offset + k0 + kTile - 1 - q_offset;  // the first query that sees all
    // this warp's chunks of dK or dV: the slice's chunks mine and mine + 1, those below q_chunks
    const int mine = 2 * warp;
    const int n_mine = q_chunks - mine < 0 ? 0 : q_chunks - mine < 2 ? q_chunks - mine : 2;

    float acc[4][8][4];  // dV (warpgroup 0) or dK (warpgroup 1): 64 keys x this warp's 64 columns
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][i][e] = 0.f;

    for (int qt = qt0, i = 0, it = 0; qt < n_qt; ++qt, ++i) {
      const int q0 = qt * kTile;
      float st[16], dpt[16];  // Sᵀ and dPᵀ, then Pᵀ and dSᵀ: 16 keys x 32 query columns
#pragma unroll
      for (int x = 0; x < 16; ++x) st[x] = dpt[x] = 0.f;
      for (int c = 0; c < n_ch; ++c, ++it) {
        const int s = it % kStages;
        const float* stage = sring + s * kStageElems;
        const bool mine_c = c >= c0 && c < c0 + q_chunks;
        const float* qc = mine_c ? sslice + (c - c0) * kChunkElems : stage + 2 * kChunkElems;
        const float* doc = mine_c ? sslice + kSliceElems + (c - c0) * kChunkElems
                                  : stage + 3 * kChunkElems;
        mbar_wait_spin(&full[s], (it / kStages) & 1);
        chunk_scores(st, stage, warp * 16, qc, qcol0);
        chunk_scores(dpt, stage + kChunkElems, warp * 16, doc, qcol0);
        release_stage(&empty[s]);
      }
      mbar_wait_spin(tfull, i & 1);
      if (keys_ragged || q0 + kTile > Sq || (causal && q0 < diag)) {
        dkv_probs<true>(st, dpt, slse + qcol0, sdelta + qcol0, q0 + qcol0, keys);
      } else {
        dkv_probs<false>(st, dpt, slse + qcol0, sdelta + qcol0, q0 + qcol0, keys);
      }
      if (i > 0) named_bar_sync(kFreeBarrier, 256);  // both warpgroups' products of tile i - 1 are done
      store_scores(spt, st, warp * 16, qcol0);
      store_scores(spt + kScoreElems, dpt, warp * 16, qcol0);
      named_bar_sync(kHandBarrier, 256);  // both halves of Pᵀ and dSᵀ are in place
      tile_product(acc, wg == 0 ? spt : spt + kScoreElems,
                   (wg == 0 ? sslice + kSliceElems : sslice) + mine * kChunkElems, n_mine);
      release_stage(sfree);  // this warp is done with the slice buffers, lse and delta
    }
    store_rows(wg == 0 ? dv : dk, acc, b, h, H, Sk, D, k0, (c0 + mine) * kChunk, n_mine);
  }
}

}  // namespace

// Past a head dim of 256: one launch, (batch, head) x 64-key tiles x
// 256-column slices of dK and dV blocks.
cudaError_t launch_bwd_dkv_f32_sliced(const BwdArgs& a, cudaStream_t stream) {
  constexpr size_t kBytes = DkvF32Smem::kBytes;
  const unsigned blocks = sliced_blocks(a.B, a.H, a.Sk, a.D, kTile, kKeySliceF32);
  if (blocks == 0) return cudaErrorInvalidValue;
  const View dout = {a.dout, (long long)a.Sq * a.H * a.D, (long long)a.H * a.D, a.D};
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t rc = allow_smem(flash_bwd_dkv_f32_sliced_kernel, kBytes);
  if (rc == cudaSuccess) rc = f32_map(&tq, a.q, a.B, a.Sq, a.H, a.D);
  if (rc == cudaSuccess) rc = f32_map(&tdo, dout, a.B, a.Sq, a.H, a.D);
  if (rc == cudaSuccess) rc = f32_map(&tk, a.k, a.B, a.Sk, a.H, a.D);
  if (rc == cudaSuccess) rc = f32_map(&tv, a.v, a.B, a.Sk, a.H, a.D);
  if (rc != cudaSuccess) return rc;
  flash_bwd_dkv_f32_sliced_kernel<<<blocks, kWsThreads, kBytes, stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.H, a.Sq, a.Sk, a.D, a.q_offset, a.k_offset, a.scale, a.scale * kLog2e, a.causal);
  return cudaGetLastError();
}

}  // namespace edl_flash
