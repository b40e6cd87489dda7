// flash_bwd_dq_f32_kernel: dQ for f32 inputs up to a head dim of 256, on the
// tensor cores in 3xTF32 (flash_tf32.cuh), compiled on its own so that the
// build runs one nvcc process per unit (flash_launch.h). Past 256 the call
// goes to flash_bwd_dq_f32_sliced.cu.
//
// Replaces _bwd_dq_kernel of edl_tpu/ops/flash_attention.py for f32 q, k and
// v where D <= 256, with flash_kernels.cuh's semantics: global positions, the
// ragged edge masked in the kernel, masking through the validity bit, a row
// that sees no key writes dQ = 0 exactly, lse and delta (B, H, Sq) f32, dO
// f32 and contiguous, the heaviest query tiles first. The Pallas kernel
// multiplies in f32; 3xTF32 keeps each product within about 2^-21 of it.
//
// Bound: 6·D FLOPs a visible pair, at 495/3 TFLOP/s (3xTF32). Design: one
// block owns 64 query rows and all D columns of dQ of one (batch, head), in
// flash_kernels.cuh's block: a producer warpgroup (setmaxnreg down) and two
// consumer warpgroups (setmaxnreg up). The producer's first warp loads the
// block's Q and dO chunks once, then streams each key tile's V chunks
// through a ring; its second warp loads each key tile's K chunks into a K
// buffer once the buffer's last dS·K is done, and K serves both S and dS·K,
// so K and V are read once a key tile. Consumer w sums dP = dO·Vᵀ and then S
// = Q·Kᵀ for keys 32w ... 32w + 31 of the tile over every chunk (warp i:
// rows 16i ... 16i + 15), forms dS as flash_kernels.cuh's dq does, and
// stores it into the dS tile; a named barrier hands the two halves over.
// dQ += dS·K is spread over all eight consumer warps (`spread_product`):
// warpgroup w sums rows 32w ... 32w + 31, its warp i the head dim's
// 8-column tiles i, i + 4, i + 8, ... (columns 8i ... 8i + 7 of every
// 32-column chunk). Each consumer warp's share of dQ += dS·K, 32 rows by:
//   D 64: 2 column tiles (16 columns);  D 128: 4 (32);  D 256: 8 (64),
// so no warp idles at any head dim (at D 192, 6 each). A warp splits each
// dS fragment once for all its chunks (a group of kCh column tiles). dQ
// stays in registers (32 f32 a thread in the variant up to 128, 64 in the
// one up to 256, beside as many of partial sums) and is written once: no
// atomics, deterministic sums. The scores sum each step's three products
// apart (`chunk_scores`' kStepSums): with 12-deep chains of the tensor
// cores' truncated adds, rows whose dQ cancels fell outside the f32 bound
// at (2, 1024, 4, 64) (PERF.md §6). Every wait spins without a bound
// (`mbar_wait_spin`).
//
// Shared memory (kSmemMax 232,448), by the largest head dim compiled:
//   DMAX 256: Q and dO, 8 chunks of 8 KB each (131,072); one K buffer of 8
//     chunks (65,536); the V ring, 2 stages of one chunk (16,384); the dS
//     tile (16,384); 14 barriers (112); 1,024 of alignment slack: 230,512.
//   DMAX 128: Q and dO, 4 chunks each (65,536); two K buffers of 4 chunks
//     (65,536), so the next tile's K loads while this tile's dS·K runs; the V
//     ring, 4 stages (32,768); the dS tile (16,384); 19 barriers (152); 1,024
//     of slack: 181,400.
// With one K buffer the next tile's K loads while its dP runs from the V ring.

#include "flash_tf32.cuh"

namespace edl_flash {
namespace {

using namespace tf32;

template <int DMAX>
struct DqF32TileSmem {
  static constexpr int kCh = DMAX / kChunk;            // chunks of a row: 4 or 8
  static constexpr int kKBufs = DMAX <= 128 ? 2 : 1;   // K buffers
  static constexpr int kStages = DMAX <= 128 ? 4 : 2;  // the V ring's stages, one chunk each
  static constexpr int kBars = 2 * kStages + 1 + kKBufs * kCh + kKBufs;
  static constexpr size_t kBytes = 1024 + (size_t)(2 + kKBufs) * kCh * kChunkBytes +
                                   kStages * kChunkBytes + kScoreElems * 4 + kBars * 8;
  static_assert(kBytes <= kSmemMax, "f32 dq shared memory");
};

template <int DMAX>
__global__ void __launch_bounds__(kWsThreads, 1) flash_bwd_dq_f32_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dq,
    int H, int Sq, int Sk, int D, int q_offset, int k_offset, float scale, float scale_log2,
    int causal) {
  using namespace hopper;
  using Smem = DqF32TileSmem<DMAX>;
  constexpr int kCh = Smem::kCh, kKBufs = Smem::kKBufs, kStages = Smem::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  float* sq = reinterpret_cast<float*>(smem);      // Q's chunks
  float* sdo = sq + kCh * kChunkElems;             // dO's chunks
  float* skb = sdo + kCh * kChunkElems;            // K buffer i: chunks from skb + i·kCh chunks
  float* sring = skb + kKBufs * kCh * kChunkElems;  // stage s: V_c
  float* sds = sring + kStages * kChunkElems;      // the dS tile
  uint64_t* full = reinterpret_cast<uint64_t*>(sds + kScoreElems);
  uint64_t* empty = full + kStages;
  uint64_t* qfull = empty + kStages;  // Q and dO landed
  uint64_t* kfull = qfull + 1;        // K buffer i, chunk c: kfull[i·kCh + c]
  uint64_t* kempty = kfull + kKBufs * kCh;

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
    for (int i = 0; i < kKBufs * kCh; ++i) mbar_init(&kfull[i], 1);
    for (int i = 0; i < kKBufs; ++i) mbar_init(&kempty[i], 8);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = warpgroup_index();
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  if (wg == 2) {  // the producer warpgroup: its first warp loads Q, dO and V, its second K
    setmaxnreg_dec<kProducerRegs>();
    if (warp == 0 && lane == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tdo);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      if (n_kt > 0) {  // a block that sees no key loads nothing
        mbar_arrive_expect_tx(qfull, 2 * n_ch * kChunkBytes);
        for (int c = 0; c < n_ch; ++c) {
          tma_load_4d(sdo + c * kChunkElems, &tdo, qfull, c * kChunk, h, q0, b);
          tma_load_4d(sq + c * kChunkElems, &tq, qfull, c * kChunk, h, q0, b);
        }
      }
      for (int kt = 0, it = 0; kt < n_kt; ++kt) {
        for (int c = 0; c < n_ch; ++c, ++it) {
          const int s = it % kStages;
          mbar_wait_spin(&empty[s], ((it / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], kChunkBytes);
          tma_load_4d(sring + s * kChunkElems, &tv, &full[s], c * kChunk, h, kt * kTile, b);
        }
      }
    } else if (warp == 1 && lane == 0) {
      for (int kt = 0; kt < n_kt; ++kt) {
        const int buf = kt % kKBufs;
        mbar_wait_spin(&kempty[buf], ((kt / kKBufs) & 1) ^ 1);  // its last dS·K is done
        for (int c = 0; c < n_ch; ++c) {
          uint64_t* bar = &kfull[buf * kCh + c];
          mbar_arrive_expect_tx(bar, kChunkBytes);
          tma_load_4d(skb + (buf * kCh + c) * kChunkElems, &tk, bar, c * kChunk, h, kt * kTile,
                      b);
        }
      }
    }
  } else {  // consumer warpgroup wg: keys 32·wg ... of each tile's scores; dQ's rows 32·wg ...
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

    float acc[2][kCh][4];  // dQ: rows 32·wg ... + 31 x column tiles warp, warp + 4, ...
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < kCh; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][i][e] = 0.f;

    for (int kt = 0, it = 0; kt < n_kt; ++kt) {
      const int buf = kt % kKBufs;
      const float* kb = skb + buf * kCh * kChunkElems;
      float sc[16], dp[16];  // S and dP, then dS in dp: 16 rows x the warpgroup's 32 keys
#pragma unroll
      for (int i = 0; i < 16; ++i) sc[i] = dp[i] = 0.f;
      if (kt == 0) mbar_wait_spin(qfull, 0);
      for (int c = 0; c < n_ch; ++c, ++it) {  // dP = dO·Vᵀ
        const int s = it % kStages;
        mbar_wait_spin(&full[s], (it / kStages) & 1);
        chunk_scores<2, true>(dp, sdo + c * kChunkElems, warp * 16, sring + s * kChunkElems,
                              key0);
        release_stage(&empty[s]);
      }
      for (int c = 0; c < n_ch; ++c) {  // S = Q·Kᵀ
        mbar_wait_spin(&kfull[buf * kCh + c], (kt / kKBufs) & 1);
        chunk_scores<2, true>(sc, sq + c * kChunkElems, warp * 16, kb + c * kChunkElems, key0);
      }
      if (kt < n_open) {
        dq_probs<false>(sc, dp, kt * kTile + key0, rows);
      } else {
        dq_probs<true>(sc, dp, kt * kTile + key0, rows);
      }
      if (kt > 0) named_bar_sync(kFreeBarrier, 256);  // both warpgroups' dS·K of tile kt - 1 is done
      store_scores(sds, dp, warp * 16, key0);
      named_bar_sync(kHandBarrier, 256);  // both halves of dS are in place
      spread_product<2, kCh, kCh>(acc, sds, 32 * wg, kb, warp, n_jt);
      release_stage(&kempty[buf]);  // this warp is done with the K buffer
    }
    store_spread<2, kCh>(dq, acc, b, h, H, Sq, D, q0 + 32 * wg, warp);
  }
}

template <int DMAX>
cudaError_t launch_dq_f32_at(const BwdArgs& a, cudaStream_t stream) {
  constexpr size_t kBytes = DqF32TileSmem<DMAX>::kBytes;
  const long long blocks = (long long)a.B * a.H * ((a.Sq + kTile - 1) / kTile);
  if (blocks <= 0 || blocks >= (1ll << 31)) return cudaErrorInvalidValue;
  const View dout = {a.dout, (long long)a.Sq * a.H * a.D, (long long)a.H * a.D, a.D};
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t rc = allow_smem(flash_bwd_dq_f32_kernel<DMAX>, kBytes);
  if (rc == cudaSuccess) rc = f32_map(&tq, a.q, a.B, a.Sq, a.H, a.D);
  if (rc == cudaSuccess) rc = f32_map(&tdo, dout, a.B, a.Sq, a.H, a.D);
  if (rc == cudaSuccess) rc = f32_map(&tk, a.k, a.B, a.Sk, a.H, a.D);
  if (rc == cudaSuccess) rc = f32_map(&tv, a.v, a.B, a.Sk, a.H, a.D);
  if (rc != cudaSuccess) return rc;
  flash_bwd_dq_f32_kernel<DMAX><<<(unsigned)blocks, kWsThreads, kBytes, stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<float*>(a.dq), a.H, a.Sq, a.Sk, a.D,
      a.q_offset, a.k_offset, a.scale, a.scale * kLog2e, a.causal);
  return cudaGetLastError();
}

}  // namespace

// One launch, (batch, head) x 64-row query tiles blocks: the variant for head
// dims up to 128 or up to 256, or past 256 the sliced kernel.
cudaError_t launch_bwd_dq_f32(const BwdArgs& a, cudaStream_t stream) {
  if (a.D <= 0) return cudaErrorInvalidValue;
  if (a.D > 256) return launch_bwd_dq_f32_sliced(a, stream);
  return a.D <= 128 ? launch_dq_f32_at<128>(a, stream) : launch_dq_f32_at<256>(a, stream);
}

}  // namespace edl_flash
