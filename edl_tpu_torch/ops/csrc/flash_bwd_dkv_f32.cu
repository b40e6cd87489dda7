// flash_bwd_dkv_f32_kernel: dK and dV for f32 inputs up to a head dim of
// 256, on the tensor cores in 3xTF32 (flash_tf32.cuh), compiled on its own so
// that the build runs one nvcc process per unit (flash_launch.h). Past 256
// the call goes to flash_bwd_dkv_f32_sliced.cu.
//
// Replaces _bwd_dkv_kernel of edl_tpu/ops/flash_attention.py for f32 q, k and
// v where D <= 256, with flash_kernels.cuh's semantics: global positions, the
// ragged edge masked in the kernel, masking through the validity bit, a key
// that no query sees writes dK = dV = 0 exactly, lse and delta (B, H, Sq)
// f32, dO f32 and contiguous, the earliest (most seen) key tiles first. The
// Pallas kernel multiplies in f32; 3xTF32 keeps each product within about
// 2^-21 of it.
//
// Bound: 8·D FLOPs a visible pair, at 495/3 TFLOP/s (3xTF32). Design: one
// block owns 64 keys and all D columns of dK and dV of one (batch, head), so
// the scores are summed once a query tile (8·D FLOPs a pair, the bound's
// own), in flash_kernels.cuh's block: a producer warpgroup (setmaxnreg down;
// its first warp loads K and V, its second each query tile's Q and dO, its
// third stores the tile's lse, times log2 e, and delta) and two consumer
// warpgroups (setmaxnreg up). For each 64-query tile from the first that
// sees the keys, consumer w sums Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ over every chunk
// for queries 32w ... 32w + 31 (warp i: keys 16i ... 16i + 15), forms Pᵀ
// and dSᵀ as flash_kernels.cuh's dkv
// does and stores them into score tiles; a named barrier hands the two
// halves over, and warpgroup 0 sums dV += Pᵀ·dO, warpgroup 1 dK += dSᵀ·Q,
// each for all 64 keys, its warp i the head dim's 8-column tiles i, i + 4,
// i + 8, ... (`spread_product`). Each consumer warp's share of the two
// products, 64 keys by:
//   D 64: 2 column tiles (16 columns);  D 128: 4 (32);  D 256: 8 (64),
// so no warp idles at any head dim (at D 192, 6 each). Two forms, by the
// largest head dim compiled:
//   DMAX 128: the block's K and V stay in shared memory, loaded once; each
//     query tile's Q and dO (and its lse and delta) land in one of two
//     buffers, so the next tile's loads run under this tile's products.
//   DMAX 256: K, V, Q and dO do not all fit. The tile's Q and dO land in
//     one buffer of the tile's chunks, which serves the scores and the
//     products; the block's K and V chunks stream through a 4-stage ring
//     every tile, the next tile's first ones while this tile's products run.
// dK and dV stay in registers (64 f32 a thread in the variant up to 128, 128
// in the one up to 256, where the scores' steps run one at a time:
// unrolled by 2, ptxas spilled) and are written once: no atomics,
// deterministic sums. Every wait spins without a bound (`mbar_wait_spin`).
//
// Shared memory (kSmemMax 232,448):
//   DMAX 128: K and V, 4 chunks of 8 KB each (65,536); two Q and dO buffers
//     of 4 + 4 chunks (131,072); the Pᵀ and dSᵀ tiles (32,768); each
//     buffer's lse and delta (1,024); 13 barriers (104); 1,024 of alignment
//     slack: 231,528.
//   DMAX 256: the ring, 4 stages of K_c and V_c (65,536); one Q and dO
//     buffer of 8 + 8 chunks (131,072); the Pᵀ and dSᵀ tiles (32,768); lse
//     and delta (512); 18 barriers (144); 1,024 of slack: 231,056.

#include "flash_tf32.cuh"

namespace edl_flash {
namespace {

using namespace tf32;

template <int DMAX>
struct DkvF32TileSmem {
  static constexpr int kCh = DMAX / kChunk;       // chunks of a row: 4 or 8
  static constexpr bool kHold = DMAX <= 128;      // K and V held, else streamed through a ring
  static constexpr int kQBufs = kHold ? 2 : 1;    // Q and dO buffers
  static constexpr int kStages = kHold ? 0 : 4;   // the ring's stages, K_c and V_c each
  static constexpr int kKVChunks = kHold ? 2 * kCh : 2 * kStages;
  static constexpr int kBars = (kHold ? 1 : 2 * kStages) + kQBufs * (kCh + 2);
  static constexpr size_t kBytes = 1024 + (size_t)(kKVChunks + kQBufs * 2 * kCh) * kChunkBytes +
                                   2 * kScoreElems * 4 + kQBufs * 2 * kTile * 4 + kBars * 8;
  static_assert(kBytes <= kSmemMax, "f32 dkv shared memory");
};

template <int DMAX>
__global__ void __launch_bounds__(kWsThreads, 1) flash_bwd_dkv_f32_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, int H, int Sq, int Sk, int D, int q_offset, int k_offset,
    float scale, float scale_log2, int causal) {
  using namespace hopper;
  using Smem = DkvF32TileSmem<DMAX>;
  constexpr int kCh = Smem::kCh, kQBufs = Smem::kQBufs, kStages = Smem::kStages;
  constexpr bool kHold = Smem::kHold;
  constexpr int kBufElems = 2 * kCh * kChunkElems;  // a Q and dO buffer
  constexpr int kScoreUnroll = kHold ? 2 : 1;  // dK or dV take 128 registers at DMAX 256
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  float* skv = reinterpret_cast<float*>(smem);  // kHold: K's chunks, V's; else the ring
  float* sqd = skv + Smem::kKVChunks * kChunkElems;  // buffer i: Q's chunks, then dO's
  float* spt = sqd + kQBufs * kBufElems;             // the Pᵀ tile, then the dSᵀ tile
  float* sstat = spt + 2 * kScoreElems;              // buffer i: lse (times log2 e), then delta
  uint64_t* full = reinterpret_cast<uint64_t*>(sstat + kQBufs * 2 * kTile);
  uint64_t* empty = full + (kHold ? 1 : kStages);  // the ring's (kHold: none)
  uint64_t* qfull = empty + kStages;               // buffer i, chunk c: qfull[i·kCh + c]
  uint64_t* tfull = qfull + kQBufs * kCh;          // buffer i's lse and delta are stored
  uint64_t* qempty = tfull + kQBufs;               // buffer i's products are done

  const int n_ch = chunks_of(D), n_jt = (D + 7) / 8;
  const int n_kt = (Sk + kTile - 1) / kTile;
  const int BH = gridDim.x / n_kt;
  const int kt = blockIdx.x / BH;  // the first key tiles are seen by the most queries
  const int bh = blockIdx.x % BH, b = bh / H, h = bh % H;
  const int k0 = kt * kTile;
  const int n_qt = (Sq + kTile - 1) / kTile;
  const int qt0 = first_query_tile(k0, q_offset, k_offset, causal);

  if (threadIdx.x == 0) {
    if constexpr (kHold) {
      mbar_init(full, 1);  // K and V landed
    } else {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], 8);  // one arrival per consumer warp
      }
    }
    for (int i = 0; i < kQBufs * kCh; ++i) mbar_init(&qfull[i], 1);
    for (int i = 0; i < kQBufs; ++i) {
      mbar_init(&tfull[i], 32);  // the third producer warp's 32 lanes
      mbar_init(&qempty[i], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = warpgroup_index();
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  if (wg == 2) {  // the producer warpgroup: K and V, Q and dO, lse and delta, a warp each
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 0 && lane == 0) {
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      if constexpr (kHold) {
        if (qt0 < n_qt) {  // a block whose keys no query sees loads nothing
          mbar_arrive_expect_tx(full, 2 * n_ch * kChunkBytes);
          for (int c = 0; c < n_ch; ++c) {
            tma_load_4d(skv + c * kChunkElems, &tk, full, c * kChunk, h, k0, b);
            tma_load_4d(skv + (kCh + c) * kChunkElems, &tv, full, c * kChunk, h, k0, b);
          }
        }
      } else {  // every query tile's K and V chunks, as far ahead as the ring holds
        for (int qt = qt0, it = 0; qt < n_qt; ++qt) {
          for (int c = 0; c < n_ch; ++c, ++it) {
            const int s = it % kStages;
            float* dst = skv + s * 2 * kChunkElems;
            mbar_wait_spin(&empty[s], ((it / kStages) & 1) ^ 1);
            mbar_arrive_expect_tx(&full[s], 2 * kChunkBytes);
            tma_load_4d(dst, &tk, &full[s], c * kChunk, h, k0, b);
            tma_load_4d(dst + kChunkElems, &tv, &full[s], c * kChunk, h, k0, b);
          }
        }
      }
    } else if (warp == 1 && lane == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tdo);
      for (int qt = qt0, i = 0; qt < n_qt; ++qt, ++i) {
        const int buf = i % kQBufs;
        mbar_wait_spin(&qempty[buf], ((i / kQBufs) & 1) ^ 1);  // its last products are done
        float* qb = sqd + buf * kBufElems;
        for (int c = 0; c < n_ch; ++c) {
          uint64_t* bar = &qfull[buf * kCh + c];
          mbar_arrive_expect_tx(bar, 2 * kChunkBytes);
          tma_load_4d(qb + c * kChunkElems, &tq, bar, c * kChunk, h, qt * kTile, b);
          tma_load_4d(qb + (kCh + c) * kChunkElems, &tdo, bar, c * kChunk, h, qt * kTile, b);
        }
      }
    } else if (warp == 2) {
      const float* lseb = lse + (long long)bh * Sq;
      const float* deltab = delta + (long long)bh * Sq;
      for (int qt = qt0, i = 0; qt < n_qt; ++qt, ++i) {
        const int buf = i % kQBufs, q0 = qt * kTile;
        // the buffer's last products, and their reads of lse and delta, are done
        mbar_wait_spin(&qempty[buf], ((i / kQBufs) & 1) ^ 1);
        float* st = sstat + buf * 2 * kTile;
        for (int r = lane; r < kTile; r += 32) {
          const bool ok = q0 + r < Sq;
          st[r] = ok ? lseb[q0 + r] * kLog2e : 0.f;
          st[kTile + r] = ok ? deltab[q0 + r] : 0.f;
        }
        mbar_arrive(&tfull[buf]);  // each lane's arrival releases its own stores
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

    float acc[4][kCh][4];  // dV (warpgroup 0) or dK (1): 64 keys x column tiles warp, warp + 4, ...
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int i = 0; i < kCh; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][i][e] = 0.f;

    for (int qt = qt0, i = 0, it = 0; qt < n_qt; ++qt, ++i) {
      const int buf = i % kQBufs, q0 = qt * kTile;
      const uint32_t ph = (i / kQBufs) & 1;
      const float* qb = sqd + buf * kBufElems;
      float st[16], dpt[16];  // Sᵀ and dPᵀ, then Pᵀ and dSᵀ: 16 keys x 32 query columns
#pragma unroll
      for (int x = 0; x < 16; ++x) st[x] = dpt[x] = 0.f;
      if (kHold && i == 0) mbar_wait_spin(full, 0);
      for (int c = 0; c < n_ch; ++c) {
        const float* kc = skv + c * kChunkElems;
        const float* vc = skv + (kCh + c) * kChunkElems;
        int s = 0;
        if constexpr (!kHold) {
          s = it % kStages;
          kc = skv + s * 2 * kChunkElems;
          vc = kc + kChunkElems;
          mbar_wait_spin(&full[s], (it / kStages) & 1);
        }
        mbar_wait_spin(&qfull[buf * kCh + c], ph);
        chunk_scores<kScoreUnroll>(st, kc, warp * 16, qb + c * kChunkElems, qcol0);
        chunk_scores<kScoreUnroll>(dpt, vc, warp * 16, qb + (kCh + c) * kChunkElems, qcol0);
        if constexpr (!kHold) {
          release_stage(&empty[s]);
          ++it;
        }
      }
      const float* stat = sstat + buf * 2 * kTile;
      mbar_wait_spin(&tfull[buf], ph);
      if (keys_ragged || q0 + kTile > Sq || (causal && q0 < diag)) {
        dkv_probs<true>(st, dpt, stat + qcol0, stat + kTile + qcol0, q0 + qcol0, keys);
      } else {
        dkv_probs<false>(st, dpt, stat + qcol0, stat + kTile + qcol0, q0 + qcol0, keys);
      }
      if (i > 0) named_bar_sync(kFreeBarrier, 256);  // both warpgroups' products of tile i - 1 are done
      store_scores(spt, st, warp * 16, qcol0);
      store_scores(spt + kScoreElems, dpt, warp * 16, qcol0);
      named_bar_sync(kHandBarrier, 256);  // both halves of Pᵀ and dSᵀ are in place
      spread_product<4, kCh>(acc, wg == 0 ? spt : spt + kScoreElems, 0,
                                wg == 0 ? qb + kCh * kChunkElems : qb, warp, n_jt);
      release_stage(&qempty[buf]);  // this warp is done with the buffer, its lse and delta
    }
    store_spread<4, kCh>(wg == 0 ? dv : dk, acc, b, h, H, Sk, D, k0, warp);
  }
}

template <int DMAX>
cudaError_t launch_dkv_f32_at(const BwdArgs& a, cudaStream_t stream) {
  constexpr size_t kBytes = DkvF32TileSmem<DMAX>::kBytes;
  const long long blocks = (long long)a.B * a.H * ((a.Sk + kTile - 1) / kTile);
  if (blocks <= 0 || blocks >= (1ll << 31)) return cudaErrorInvalidValue;
  const View dout = {a.dout, (long long)a.Sq * a.H * a.D, (long long)a.H * a.D, a.D};
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t rc = allow_smem(flash_bwd_dkv_f32_kernel<DMAX>, kBytes);
  if (rc == cudaSuccess) rc = f32_map(&tq, a.q, a.B, a.Sq, a.H, a.D);
  if (rc == cudaSuccess) rc = f32_map(&tdo, dout, a.B, a.Sq, a.H, a.D);
  if (rc == cudaSuccess) rc = f32_map(&tk, a.k, a.B, a.Sk, a.H, a.D);
  if (rc == cudaSuccess) rc = f32_map(&tv, a.v, a.B, a.Sk, a.H, a.D);
  if (rc != cudaSuccess) return rc;
  flash_bwd_dkv_f32_kernel<DMAX><<<(unsigned)blocks, kWsThreads, kBytes, stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.H, a.Sq, a.Sk, a.D, a.q_offset, a.k_offset, a.scale, a.scale * kLog2e, a.causal);
  return cudaGetLastError();
}

}  // namespace

// One launch, (batch, head) x 64-key tiles blocks: the variant for head dims
// up to 128 or up to 256, or past 256 the sliced kernel.
cudaError_t launch_bwd_dkv_f32(const BwdArgs& a, cudaStream_t stream) {
  if (a.D <= 0) return cudaErrorInvalidValue;
  if (a.D > 256) return launch_bwd_dkv_f32_sliced(a, stream);
  return a.D <= 128 ? launch_dkv_f32_at<128>(a, stream) : launch_dkv_f32_at<256>(a, stream);
}

}  // namespace edl_flash
