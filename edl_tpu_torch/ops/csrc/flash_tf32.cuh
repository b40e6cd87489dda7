// Building blocks of the f32 flash kernels on the tensor cores: f32 chunks
// loaded by TMA, and 3xTF32 products on them (hopper.cuh, mma.sync m16n8k8).
// All six f32 kernels are built from them, in flash_kernels.cuh's block (a
// producer warpgroup and two consumer warpgroups with setmaxnreg): up to a
// head dim of 256 in flash_fwd_f32.cu, flash_bwd_dq_f32.cu and
// flash_bwd_dkv_f32.cu, past it in the three *_f32_sliced.cu units.
//
// Layouts in shared memory:
//  * A chunk is 64 rows (queries or keys) of 32 f32 head-dim columns as TMA
//    writes it: 128-byte rows, 128B-swizzled (`hopper::f32_swizzled`), 8 KB,
//    on a 1024-byte boundary. A tile of D columns is ceil(D / 32) chunks.
//  * A score tile is 64 x 64 f32 (P, dS, Pᵀ or dSᵀ of a 64-row block and a
//    64-row tile): 256-byte rows whose 16-byte units are XOR'ed with the row
//    mod 8 (`score_at`), 16 KB, stored from the score accumulators and read
//    as A fragments of the second product.
// The mma's reduction index is permuted within each 8-wide step: its slots
// t and t + 4 (the fragments' two k values) take columns 2t and 2t + 1, so
// that a lane's two values of a row are adjacent and load as one 64-bit
// access. A sum over the step is the same in any order of its terms. Loads
// whose rows are the reduction (a product's B operand: rows 2t and 2t + 1 of
// the step) are 32-bit and free of bank conflicts, since the 128-byte
// swizzle maps a lane's column unit through the row mod 8.

#pragma once

#include "flash_kernels.cuh"

namespace edl_flash {
namespace tf32 {

constexpr int kChunk = hopper::kF32Span;      // f32 head-dim columns a chunk
constexpr int kChunkElems = kTile * kChunk;   // a 64-row chunk
constexpr int kChunkBytes = kChunkElems * 4;  // 8 KB
constexpr int kScoreElems = kTile * kTile;    // a 64 x 64 score tile, 16 KB
constexpr int kHandBarrier = 1;  // named barrier: both consumers' halves of a score tile are stored
constexpr int kFreeBarrier = 2;  // named barrier: both consumers are done with the last score tile
constexpr int kStatBarrier = 3;  // named barrier: both consumers' row maxima are stored

__host__ __device__ constexpr int chunks_of(int D) { return (D + kChunk - 1) / kChunk; }

// The number of the block's `width`-column slice's chunks that start below
// D, from chunk c0: short for the last slice.
__device__ __forceinline__ int slice_chunks(int D, int c0, int width) {
  const int n = chunks_of(D) - c0;
  return n < width / kChunk ? n : width / kChunk;
}

// Element offset of (row, col) in a score tile.
__device__ __forceinline__ int score_at(int row, int col) {
  return row * kTile + (((col >> 2) ^ (row & 7)) << 2) + (col & 3);
}

// The chunk column held by a lane's accumulator value e (0 or 1 of a row)
// in 8-column tile j (0-3) of a product that spans one chunk.
__device__ __forceinline__ int col_of(int j, int t, int e) { return 8 * j + 2 * t + e; }

// The split halves of a lane's A fragment pair, rows r and r + 8 of a step:
// lo and hi of (row r, slot t), (r + 8, t), (r, t + 4), (r + 8, t + 4) from
// the pairs p0 (row r, columns 2t and 2t + 1 of the step) and p1 (row r + 8).
__device__ __forceinline__ void split_a(float2 p0, float2 p1, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  hopper::tf32_split(p0.x, hi[0], lo[0]);
  hopper::tf32_split(p1.x, hi[1], lo[1]);
  hopper::tf32_split(p0.y, hi[2], lo[2]);
  hopper::tf32_split(p1.y, hi[3], lo[3]);
}

// X (16 x 32) += A·Bᵀ over one chunk's 32 columns, for one warp: A the
// chunk a's rows a_row0 ... a_row0 + 15, B the chunk b's rows b_row0 ...
// b_row0 + 31 (both multiples of 8), in 3xTF32, summed into a fresh
// accumulator and added to X in f32. x[4j + e] is the m16n8 accumulator of
// 8-column tile j: the lane's row g + 8(e >> 1), column 8j + 2t + (e & 1)
// (a wgmma accumulator's layout, so flash_kernels.cuh's dq_probs and
// dkv_probs read it). fwd and dq: S = Q·Kᵀ; dq: dP = dO·Vᵀ; dkv: Sᵀ = K·Qᵀ
// and dPᵀ = V·dOᵀ. UNROLL unrolls the chunk's four steps: 2, or 1 where a
// kernel's registers are short (ptxas spills at 2). With kStepSums each step's three
// products go into a fresh accumulator added to the chunk's in f32, so no
// tensor-core chain is more than 3 deep (12 otherwise): dq's rows whose dQ
// cancels weigh the scores' truncated adds.
template <int UNROLL = 2, bool kStepSums = false>
__device__ __forceinline__ void chunk_scores(float (&x)[16], const float* a, int a_row0,
                                             const float* b, int b_row0) {
  using hopper::f32_swizzled;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ra = a_row0 + g;
  float part[4][4] = {};
#pragma unroll UNROLL
  for (int kk = 0; kk < kChunk / 8; ++kk) {
    const int c = 8 * kk + 2 * t;
    uint32_t ah[4], al[4];
    split_a(*reinterpret_cast<const float2*>(a + f32_swizzled(ra, c)),
            *reinterpret_cast<const float2*>(a + f32_swizzled(ra + 8, c)), ah, al);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 bv = *reinterpret_cast<const float2*>(b + f32_swizzled(b_row0 + 8 * j + g, c));
      uint32_t bh[2], bl[2];
      hopper::tf32_split(bv.x, bh[0], bl[0]);
      hopper::tf32_split(bv.y, bh[1], bl[1]);
      if constexpr (kStepSums) {
        float step[4] = {};
        hopper::mma_3xtf32(step, ah, al, bh, bl);
#pragma unroll
        for (int e = 0; e < 4; ++e) part[j][e] += step[e];
      } else {
        hopper::mma_3xtf32(part[j], ah, al, bh, bl);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[4 * j + e] += part[j][e];
}

// A warp's X (16 x 32, `chunk_scores`' layout) into a score tile at rows
// row0 ..., columns col0 ....
__device__ __forceinline__ void store_scores(float* tile, const float (&x)[16], int row0,
                                             int col0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + g + 8 * r;
      *reinterpret_cast<float2*>(tile + score_at(row, col0 + 8 * j + 2 * t)) =
          make_float2(x[4 * j + 2 * r], x[4 * j + 2 * r + 1]);
    }
}

// acc (64 x 64) += P·B for one warp, in 3xTF32: P a score tile (its columns
// the reduction), B 64 rows of the chunks b and b + kChunkElems (rows the
// reduction, the two chunks' 64 columns N), only the first n (0-2) of them.
// Each 32 x 32 quarter is summed into a fresh accumulator (24 products
// deep) and added to acc in f32, so acc, which sums every tile of a row or
// key, never takes a truncated tensor-core addition. acc[m][4cc + j] is the
// m16n8 accumulator of rows 16m ... 16m + 15 and of columns 8j ... 8j + 7 of
// chunk cc: the lane's value e is row 16m + g + 8(e >> 1), column col_of(j,
// t, e & 1) of chunk cc. fwd: O += P·V; dq: dQ += dS·K; dkv: dV += Pᵀ·dO and
// dK += dSᵀ·Q.
__device__ __forceinline__ void tile_product(float (&acc)[4][8][4], const float* p,
                                             const float* b, int n) {
  using hopper::f32_swizzled;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int cc = 0; cc < 2; ++cc) {
    if (cc >= n) break;
    const float* bc = b + cc * kChunkElems;
#pragma unroll
    for (int mp = 0; mp < 2; ++mp) {  // rows 32mp ... 32mp + 31
      float part[2][4][4] = {};
#pragma unroll 2
      for (int kk = 0; kk < kTile / 8; ++kk) {
        const int c = 8 * kk + 2 * t;  // the lane's reduction pair of the step: c and c + 1
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int r = 32 * mp + 16 * m + g;
          split_a(*reinterpret_cast<const float2*>(p + score_at(r, c)),
                  *reinterpret_cast<const float2*>(p + score_at(r + 8, c)), ah[m], al[m]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bh[2], bl[2];
          hopper::tf32_split(bc[f32_swizzled(c, 8 * j + g)], bh[0], bl[0]);
          hopper::tf32_split(bc[f32_swizzled(c + 1, 8 * j + g)], bh[1], bl[1]);
#pragma unroll
          for (int m = 0; m < 2; ++m) hopper::mma_3xtf32(part[m][j], ah[m], al[m], bh, bl);
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[2 * mp + m][4 * cc + j][e] += part[m][j][e];
    }
  }
}

// A warp's acc (`tile_product`'s layout) into out, a contiguous (B, S, H,
// D) f32 tensor: rows row0 + ... below S of head h, batch b, columns d0 +
// ... below D (n chunks).
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[4][8][4], int b, int h,
                                           int H, int S, int D, int row0, int d0, int n) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 16 * m + g + 8 * r;
      if (row >= S) continue;
      float* dst = out + (((long long)b * S + row) * H + h) * D;
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        if (cc >= n) break;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = d0 + cc * kChunk + col_of(j, t, 0);
          if (d < D) {
            *reinterpret_cast<float2*>(dst + d) =
                make_float2(acc[m][4 * cc + j][2 * r], acc[m][4 * cc + j][2 * r + 1]);
          }
        }
      }
    }
}

// acc += P·B for one warp's share of a product whose output rows are a
// score tile's and whose output columns are the head dim's, in 3xTF32: P a
// score tile (its 64 columns the reduction), of which the warp takes M row
// tiles of 16 from row0; B a tile of kChunk-column chunks at b (chunk i at b
// + i·kChunkElems, its 64 rows the reduction), of which the warp takes the
// 8-column tile j0 (0-3) of chunks 0 ... NT - 1, those that start below D:
// head-dim column tiles jt = j0 + 4i below n_jt = ceil(D / 8). Each group
// of two row tiles by TG chunks' column tiles (32 x 8·TG) is summed into a
// fresh accumulator over the reduction (24 products deep) and added to acc
// in f32, as in `tile_product`; a wider group splits each P fragment for
// more products. acc[m][i][e] is row row0 + 16m + g + 8(e >> 1),
// head-dim column 32i + 8·j0 + 2t + (e & 1). The kernels up to a head dim of
// 256 spread their second products over all eight consumer warps this way,
// at every head dim: four warps take the four column tiles of every chunk.
template <int M, int NT, int TG = 4>
__device__ __forceinline__ void spread_product(float (&acc)[M][NT][4], const float* p, int row0,
                                               const float* b, int j0, int n_jt) {
  using hopper::f32_swizzled;
  static_assert(M % 2 == 0 && NT % TG == 0, "groups of two row tiles by TG chunks");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int col = 8 * j0 + g;  // the lane's column of each chunk
#pragma unroll
  for (int mp = 0; mp < M / 2; ++mp) {  // rows row0 + 32mp ... row0 + 32mp + 31
#pragma unroll
    for (int tg = 0; tg < NT / TG; ++tg) {  // chunks TG·tg ... TG·tg + TG - 1
      if (j0 + 4 * TG * tg >= n_jt) break;  // warp-uniform: the head dim ends before the group
      float part[2][TG][4] = {};
#pragma unroll 2
      for (int kk = 0; kk < kTile / 8; ++kk) {
        const int c = 8 * kk + 2 * t;  // the lane's reduction pair of the step: c and c + 1
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int r = row0 + 32 * mp + 16 * m + g;
          split_a(*reinterpret_cast<const float2*>(p + score_at(r, c)),
                  *reinterpret_cast<const float2*>(p + score_at(r + 8, c)), ah[m], al[m]);
        }
        const float* b0 = b + f32_swizzled(c, col);
        const float* b1 = b + f32_swizzled(c + 1, col);
#pragma unroll
        for (int j = 0; j < TG; ++j) {
          const int i = TG * tg + j;  // the chunk
          if (j0 + 4 * i < n_jt) {  // warp-uniform
            uint32_t bh[2], bl[2];
            hopper::tf32_split(b0[i * kChunkElems], bh[0], bl[0]);
            hopper::tf32_split(b1[i * kChunkElems], bh[1], bl[1]);
#pragma unroll
            for (int m = 0; m < 2; ++m) hopper::mma_3xtf32(part[m][j], ah[m], al[m], bh, bl);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < TG; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[2 * mp + m][TG * tg + j][e] += part[m][j][e];
    }
  }
}

// A warp's acc (`spread_product`'s layout, column tile j0 of each chunk)
// into out, a contiguous (B, S, H, D) f32 tensor: rows row0 + ... below S of
// head h, batch b, columns below D.
template <int M, int NT>
__device__ __forceinline__ void store_spread(float* out, const float (&acc)[M][NT][4], int b,
                                             int h, int H, int S, int D, int row0, int j0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 16 * m + g + 8 * r;
      if (row >= S) continue;
      float* dst = out + (((long long)b * S + row) * H + h) * D + 8 * j0 + 2 * t;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        // D is a multiple of 8, so d + 1 < D where d = 32i + 8·j0 + 2t < D
        if (32 * i + 8 * j0 + 2 * t < D) {
          *reinterpret_cast<float2*>(dst + 32 * i) =
              make_float2(acc[m][i][2 * r], acc[m][i][2 * r + 1]);
        }
      }
    }
}

// -- the forwards' online softmax -----------------------------------------------
//
// In the two f32 forwards the consumer warpgroups split each 64-key tile's
// scores by keys, as dq does: warpgroup w holds keys 32w ... 32w + 31 of
// every row (its warp i rows 16i ... 16i + 15). A row's softmax statistics
// need both halves, so the two exchange them through shared memory: each
// stores its half's row maxima, and after a named barrier both form the same
// new maximum m_new, rescale factor alpha = exp(m - m_new) and P = exp(s -
// m_new) in f32 (masked entries exactly 0 through their validity), store
// their half of P into the score tile and their half's row sums of P. The
// barrier that hands P over (kHandBarrier) also hands over the sums, from
// which both grow the same l in f32, and alpha, by which the warps that own
// a row of O rescale it. The next tile's statistics are stored only after
// every consumer thread has passed its next kStatBarrier, that is, after its
// P·V of this tile: so P, alpha and the sums need no second buffer.

// Each row's statistics of the current key tile, in shared memory.
struct RowStats {
  float max[2][kTile];  // warpgroup w's maximum of its 32 scores of each row
  float sum[2][kTile];  // warpgroup w's sum of its 32 P of each row
  float alpha[kTile];   // exp(m - m_new): the factor that rescales each row of O
  float l[kTile];       // each row's sum of P once every key tile is summed
};

// What the forwards' softmax needs to mask one thread's two rows of a
// score tile: the global position of row g (row g + 8 is 8 further), the
// lane's column pair t, and the request.
struct F32Rows {
  int qpos, t, Sk, causal, k_offset;
  float scale;
};

// Whether key `key` (of the call's keys) counts for the thread's row g + 8r.
__device__ __forceinline__ bool f32_visible(const F32Rows& q, int key, int r) {
  return key < q.Sk && (!q.causal || q.k_offset + key <= q.qpos + 8 * r);
}

// One score tile's online-softmax step for one consumer warp, in place: x
// (Q·Kᵀ of the warp's 16 rows from row0 and its warpgroup's 32 keys from
// key0, `chunk_scores`' layout) becomes P = exp(x·scale - m_new), which is
// stored into the score tile `ptile`; m moves to m_new and alpha is
// exp(m - m_new), for the thread's rows g and g + 8. exp is expf: P·V and l
// take P in f32, as the f32 plain version does. After it the caller's
// kHandBarrier, then `fwd_row_sums`.
__device__ __forceinline__ void fwd_tile_softmax(float (&x)[16], float (&m)[2], float (&alpha)[2],
                                                 RowStats& st, float* ptile, int wg, int row0,
                                                 int key0, const F32Rows& q) {
  const int g = (threadIdx.x & 31) >> 2;
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = (i >> 1) & 1;
    x[i] *= q.scale;
    if (f32_visible(q, key0 + (i >> 2) * 8 + 2 * q.t + (i & 1), r)) mx[r] = fmaxf(mx[r], x[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    if (q.t == 0) st.max[wg][row0 + g + 8 * r] = mx[r];
  }
  hopper::named_bar_sync(kStatBarrier, 256);  // both halves' maxima are in place
  float m_new[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    m_new[r] = fmaxf(m[r], fmaxf(st.max[0][row], st.max[1][row]));
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int r = (i >> 1) & 1;
    const bool ok = f32_visible(q, key0 + (i >> 2) * 8 + 2 * q.t + (i & 1), r);
    x[i] = ok ? expf(x[i] - m_new[r]) : 0.f;
    rs[r] += x[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    rs[r] = quad_sum(rs[r]);
    alpha[r] = expf(m[r] - m_new[r]);  // 1 while a row has seen no key: m = m_new = -1e30
    m[r] = m_new[r];
    if (q.t == 0) {
      st.sum[wg][row] = rs[r];
      if (wg == 0) st.alpha[row] = alpha[r];
    }
  }
  store_scores(ptile, x, row0, 32 * wg);
}

// l (the thread's rows g and g + 8 from row0: their sums of P) rescaled by
// alpha and grown by both warpgroups' sums of the tile, warpgroup 0's first,
// so that both hold the same l; after the kHandBarrier that follows
// `fwd_tile_softmax`.
__device__ __forceinline__ void fwd_row_sums(float (&l)[2], const float (&alpha)[2],
                                             const RowStats& st, int row0) {
  const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    l[r] = l[r] * alpha[r] + (st.sum[0][row] + st.sum[1][row]);
  }
}

// A warp's accumulator rows (`spread_product`'s or `tile_product`'s layout:
// the lane's value e of acc[m][i] is row row0 + 16m + g + 8(e >> 1)) times
// f[row], or (kDivide) divided by f[row] where f[row] > 0 (a row that sees no
// key keeps its zeros).
template <bool kDivide, int M, int NT>
__device__ __forceinline__ void rows_by(float (&acc)[M][NT][4], const float* f, int row0) {
  const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float x = f[row0 + 16 * m + g + 8 * r];
      const float safe = x > 0.f ? x : 1.f;
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          if constexpr (kDivide) {
            acc[m][i][e] = acc[m][i][e] / safe;
          } else {
            acc[m][i][e] *= x;
          }
        }
    }
}

// The thread's two rows' lse, m + log(l), or -1e30 for a row that sees no
// key, into lse (row q0 + row0 + g + 8r of (batch, head) bh) where the row
// is below Sq.
__device__ __forceinline__ void store_lse(float* lse, const float (&m)[2], const float (&l)[2],
                                          long long bh, int Sq, int q0, int row0) {
  const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row0 + g + 8 * r;
    if (row < Sq) lse[bh * Sq + row] = l[r] > 0.f ? m[r] + logf(l[r]) : kNegInf;
  }
}

// The TMA map of a (B, S, H, D) f32 view, in boxes of one chunk's 32
// columns x 1 x 64 rows x 1, 128B-swizzled; elements outside the view (d >=
// D, s >= S) load as 0. TMA needs a 16-byte aligned start and byte strides
// that are multiples of 16.
inline cudaError_t f32_map(CUtensorMap* map, const View& x, int B, int S, int H, int D) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)x.sh * 4, (cuuint64_t)x.ss * 4, (cuuint64_t)x.sb * 4};
  const cuuint32_t box[4] = {kChunk, 1, kTile, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult rc = encode(map, hopper::Elem<float>::kTma, 4, const_cast<void*>(x.ptr), dims,
                             strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace tf32
}  // namespace edl_flash
