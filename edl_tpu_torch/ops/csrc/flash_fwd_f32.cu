// flash_fwd_f32_kernel: the forward for f32 inputs up to a head dim of 256,
// on the tensor cores in 3xTF32 (flash_tf32.cuh), compiled on its own so that
// the build runs one nvcc process per unit (flash_launch.h). Past 256 the
// call goes to flash_fwd_f32_sliced.cu.
//
// Replaces _fwd_kernel of edl_tpu/ops/flash_attention.py for f32 q, k and v
// where D <= 256, with its semantics: causality over global positions
// (q_offset, k_offset), the ragged edge masked in the kernel, masking through
// the validity bit, a row that sees no key writes O = 0 and lse = -1e30
// exactly, lse (B, H, Sq) f32, O contiguous f32, the heaviest query tiles
// first, causally dead key tiles skipped. The Pallas kernel multiplies in
// f32; 3xTF32 keeps each product within about 2^-21 of it. exp and log are
// the accurate expf and logf.
//
// Bound: 4·D FLOPs a visible pair, at 495/3 TFLOP/s (3xTF32). Design: dq's
// (flash_bwd_dq_f32.cu) with K and V in each other's place. One block owns
// 64 query rows and all D columns of O of one (batch, head), in
// flash_kernels.cuh's block: a producer warpgroup (setmaxnreg down) and two
// consumer warpgroups (setmaxnreg up). The producer's first warp loads the
// block's Q chunks once, then streams each key tile's K chunks through a
// ring; its second warp loads each key tile's V chunks into a V buffer once
// the buffer's last P·V is done. Consumer w sums S = Q·Kᵀ for keys 32w ...
// 32w + 31 of the tile over every chunk (warp i: rows 16i ... 16i + 15),
// each step's three products into a fresh accumulator (`chunk_scores`'
// kStepSums), and the two consumers exchange the rows' statistics through
// shared memory (`fwd_tile_softmax`, flash_tf32.cuh), store P into the
// score tile and hand it over with a named barrier. O += P·V is spread over
// all eight consumer warps (`spread_product`): warpgroup w owns rows 32w ...
// 32w + 31 of O, its warp i the head dim's 8-column tiles i, i + 4, ...,
// scaled by each row's alpha first. O stays in registers (32 f32 a thread in
// the variant up to 128, 64 in the one up to 256) and is written once,
// divided by l; lse is m + log(l). Every wait spins without a bound
// (`mbar_wait_spin`).
//
// Shared memory (kSmemMax 232,448), by the largest head dim compiled:
//   DMAX 256: Q, 8 chunks of 8 KB (65,536); one V buffer of 8 chunks
//     (65,536); the K ring, 8 stages of one chunk (65,536); the P tile
//     (16,384); the row statistics (1,536); 19 barriers (152); 1,024 of
//     alignment slack: 215,704. With one V buffer the next tile's V loads
//     while its S runs from the K ring.
//   DMAX 128: Q, 4 chunks (32,768); two V buffers of 4 chunks (65,536), so
//     the next tile's V loads while this tile's P·V runs; the K ring, 8
//     stages (65,536); the P tile (16,384); the row statistics (1,536); 21
//     barriers (168); 1,024 of slack: 182,952.

#include "flash_tf32.cuh"

namespace edl_flash {
namespace {

using namespace tf32;

template <int DMAX>
struct FwdF32TileSmem {
  static constexpr int kCh = DMAX / kChunk;           // chunks of a row: 4 or 8
  static constexpr int kVBufs = DMAX <= 128 ? 2 : 1;  // V buffers
  static constexpr int kStages = 8;                   // the K ring's stages, one chunk each
  static constexpr int kBars = 2 * kStages + 1 + 2 * kVBufs;
  static constexpr size_t kBytes = 1024 + (size_t)(1 + kVBufs) * kCh * kChunkBytes +
                                   kStages * kChunkBytes + kScoreElems * 4 + sizeof(RowStats) +
                                   kBars * 8;
  static_assert(kBytes <= kSmemMax, "f32 forward shared memory");
};

template <int DMAX>
__global__ void __launch_bounds__(kWsThreads, 1) flash_fwd_f32_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, float* __restrict__ o, float* __restrict__ lse,
    int H, int Sq, int Sk, int D, int q_offset, int k_offset, float scale, int causal) {
  using namespace hopper;
  using Smem = FwdF32TileSmem<DMAX>;
  constexpr int kCh = Smem::kCh, kVBufs = Smem::kVBufs, kStages = Smem::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  float* sq = reinterpret_cast<float*>(smem);       // Q's chunks
  float* svb = sq + kCh * kChunkElems;              // V buffer i: chunks from svb + i·kCh chunks
  float* sring = svb + kVBufs * kCh * kChunkElems;  // stage s: K_c
  float* sp = sring + kStages * kChunkElems;        // the P tile
  RowStats& st = *reinterpret_cast<RowStats*>(sp + kScoreElems);
  uint64_t* full = reinterpret_cast<uint64_t*>(&st + 1);
  uint64_t* empty = full + kStages;
  uint64_t* qfull = empty + kStages;  // Q landed
  uint64_t* vfull = qfull + 1;        // V buffer i landed
  uint64_t* vempty = vfull + kVBufs;  // V buffer i's last P·V is done

  const int n_ch = chunks_of(D), n_jt = (D + 7) / 8;
  const int n_qt = (Sq + kTile - 1) / kTile;
  const int BH = gridDim.x / n_qt;
  const int qt = n_qt - 1 - blockIdx.x / BH;  // the last query tiles carry the most keys
  const int bh = blockIdx.x % BH, b = bh / H, h = bh % H;
  const int q0 = qt * kTile;
  const int n_kt = key_tiles<kTile>(Sk, q0, q_offset, k_offset, causal);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init(qfull, 1);
    for (int i = 0; i < kVBufs; ++i) {
      mbar_init(&vfull[i], 1);
      mbar_init(&vempty[i], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = warpgroup_index();
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  if (wg == 2) {  // the producer warpgroup: its first warp loads Q and K, its second V
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 0 && lane == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      if (n_kt > 0) {  // a block that sees no key loads nothing
        mbar_arrive_expect_tx(qfull, n_ch * kChunkBytes);
        for (int c = 0; c < n_ch; ++c) {
          tma_load_4d(sq + c * kChunkElems, &tq, qfull, c * kChunk, h, q0, b);
        }
      }
      for (int kt = 0, it = 0; kt < n_kt; ++kt) {
        for (int c = 0; c < n_ch; ++c, ++it) {
          const int s = it % kStages;
          mbar_wait_spin(&empty[s], ((it / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], kChunkBytes);
          tma_load_4d(sring + s * kChunkElems, &tk, &full[s], c * kChunk, h, kt * kTile, b);
        }
      }
    } else if (warp == 1 && lane == 0) {
      tma_prefetch_map(&tv);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int buf = kt % kVBufs;
        mbar_wait_spin(&vempty[buf], ((kt / kVBufs) & 1) ^ 1);  // its last P·V is done
        mbar_arrive_expect_tx(&vfull[buf], n_ch * kChunkBytes);
        for (int c = 0; c < n_ch; ++c) {
          tma_load_4d(svb + (buf * kCh + c) * kChunkElems, &tv, &vfull[buf], c * kChunk, h,
                      kt * kTile, b);
        }
      }
    }
  } else {  // consumer warpgroup wg: keys 32·wg ... of each tile's scores; O's rows 32·wg ...
    setmaxnreg_inc<kConsumerRegs>();
    const int g = lane >> 2, t = lane & 3;
    const int srow = warp * 16;  // this warp's first row of the scores
    const F32Rows rows = {q_offset + q0 + srow + g, t, Sk, causal, k_offset, scale};

    float acc[2][kCh][4];  // O: rows 32·wg ... + 31 x column tiles warp, warp + 4, ...
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < kCh; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][i][e] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // the score rows srow + g, + 8

    for (int kt = 0, it = 0; kt < n_kt; ++kt) {
      const int buf = kt % kVBufs;
      float sc[16];  // S, then P: 16 rows x the warpgroup's 32 keys
#pragma unroll
      for (int i = 0; i < 16; ++i) sc[i] = 0.f;
      if (kt == 0) mbar_wait_spin(qfull, 0);
      for (int c = 0; c < n_ch; ++c, ++it) {  // S = Q·Kᵀ
        const int s = it % kStages;
        mbar_wait_spin(&full[s], (it / kStages) & 1);
        chunk_scores<2, true>(sc, sq + c * kChunkElems, srow, sring + s * kChunkElems, 32 * wg);
        release_stage(&empty[s]);
      }
      float alpha[2];
      fwd_tile_softmax(sc, m, alpha, st, sp, wg, srow, kt * kTile + 32 * wg, rows);
      named_bar_sync(kHandBarrier, 256);  // both halves of P, the sums and alpha are in place
      fwd_row_sums(l, alpha, st, srow);
      rows_by<false>(acc, st.alpha, 32 * wg);
      mbar_wait_spin(&vfull[buf], (kt / kVBufs) & 1);
      spread_product<2, kCh, kCh>(acc, sp, 32 * wg, svb + buf * kCh * kChunkElems, warp, n_jt);
      release_stage(&vempty[buf]);  // this warp is done with the V buffer
    }
    if (wg == 0 && t == 0) {  // one writer a row
      st.l[srow + g] = l[0];
      st.l[srow + g + 8] = l[1];
      store_lse(lse, m, l, bh, Sq, q0, srow);
    }
    named_bar_sync(kStatBarrier, 256);  // every row's l is in place
    rows_by<true>(acc, st.l, 32 * wg);
    store_spread<2, kCh>(o, acc, b, h, H, Sq, D, q0 + 32 * wg, warp);
  }
}

template <int DMAX>
cudaError_t launch_fwd_f32_at(const FwdArgs& a, cudaStream_t stream) {
  constexpr size_t kBytes = FwdF32TileSmem<DMAX>::kBytes;
  const long long blocks = (long long)a.B * a.H * ((a.Sq + kTile - 1) / kTile);
  if (blocks <= 0 || blocks >= (1ll << 31)) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  cudaError_t rc = allow_smem(flash_fwd_f32_kernel<DMAX>, kBytes);
  if (rc == cudaSuccess) rc = f32_map(&tq, a.q, a.B, a.Sq, a.H, a.D);
  if (rc == cudaSuccess) rc = f32_map(&tk, a.k, a.B, a.Sk, a.H, a.D);
  if (rc == cudaSuccess) rc = f32_map(&tv, a.v, a.B, a.Sk, a.H, a.D);
  if (rc != cudaSuccess) return rc;
  flash_fwd_f32_kernel<DMAX><<<(unsigned)blocks, kWsThreads, kBytes, stream>>>(
      tq, tk, tv, static_cast<float*>(a.o), a.lse, a.H, a.Sq, a.Sk, a.D, a.q_offset,
      a.k_offset, a.scale, a.causal);
  return cudaGetLastError();
}

}  // namespace

// One launch, (batch, head) x 64-row query tiles blocks: the variant for head
// dims up to 128 or up to 256, or past 256 the sliced kernel. O is f32.
cudaError_t launch_fwd_f32(const FwdArgs& a, cudaStream_t stream) {
  if (a.D <= 0 || !a.out_f32) return cudaErrorInvalidValue;
  if (a.D > 256) return launch_fwd_f32_sliced(a, stream);
  return a.D <= 128 ? launch_fwd_f32_at<128>(a, stream) : launch_fwd_f32_at<256>(a, stream);
}

}  // namespace edl_flash
