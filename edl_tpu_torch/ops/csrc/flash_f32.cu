// Flash attention for f32 inputs: the forward kernels, on the CUDA cores in
// f32 fused multiply-adds. The two backward kernels run on the tensor cores
// in 3xTF32: up to a head dim of 256 in flash_bwd_dq_f32.cu and
// flash_bwd_dkv_f32.cu, past it in flash_bwd_dq_f32_sliced.cu and
// flash_bwd_dkv_f32_sliced.cu.
//
// They replace _fwd_kernel of edl_tpu/ops/flash_attention.py where q, k and v
// are f32, as flash_kernels.cuh does for 16-bit inputs, and compute the same
// function with the same semantics: global-position causality, the ragged
// edge masked in the kernel, masking through the validity bit, the -1e30
// sentinel for rows that see no key (O = 0, lse = -1e30), lse (B, H, Sq)
// f32. The Pallas kernel multiplies f32 inputs in f32; so do these. exp and
// log are the accurate expf and logf.
//
// Bound on the H100: the same FLOPs as the 16-bit forward (4·D a visible
// pair) at the card's 67 TFLOP/s of f32 outside the tensor cores, and twice
// its bytes. Design, simple and not tuned: a block of 256 threads owns 64
// query rows of one (batch, head) and walks COLS-key tiles staged in shared
// memory; four threads share a row, each taking every fourth score of a tile
// and every fourth head-dim column of the accumulator; the scores pass
// through shared memory to the second product. Causally dead tiles are
// skipped, as in the 16-bit kernels. The kernel is compiled for head dims up
// to DMAX: 128 and 256 (accumulators of 64 floats a thread), both with
// 64-key tiles. Past 256 a sliced form serves every head dim (below): column
// slices of O, scores summed over 64-column chunks, no whole row in shared
// memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_launch.h"

namespace edl_flash {
namespace {

constexpr int kRows = 64;              // query rows a block
constexpr int kThreadsF32 = 4 * kRows;  // four a row
constexpr float kNegInfF32 = -1e30f;   // the TPU kernels' _NEG_INF sentinel

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows [row0, row0 + ROWS) of head h, batch b of view x into shared memory
// (row stride LD); rows at or beyond S load as 0.
template <int ROWS, int LD>
__device__ __forceinline__ void load_rows(float* dst, const View& x, int b, int h, int row0, int S,
                                          int D) {
  const float* src = static_cast<const float*>(x.ptr);
  for (int i = threadIdx.x; i < ROWS * D; i += kThreadsF32) {
    const int r = i / D, d = i % D, s = row0 + r;
    dst[r * LD + d] = s < S ? src[b * x.sb + s * x.ss + h * x.sh + d] : 0.f;
  }
}

// Key tiles of COLS keys [0, n) that some row of the query block at local
// row q0 sees.
template <int COLS>
__device__ __forceinline__ int key_tiles_f32(int Sk, int q0, int q_offset, int k_offset,
                                             int causal) {
  int n = (Sk + COLS - 1) / COLS;
  if (causal) {
    const long long last = (long long)q_offset + q0 + kRows - 1 - k_offset;
    const long long lim = last < 0 ? 0 : last / COLS + 1;
    if (lim < n) n = (int)lim;
  }
  return n;
}

// x[i] (+)= a · b[c + 4i] over the head dim for a thread's COLS / 4 columns
// of a tile: a is a staged row, b the staged tile (row stride LD); kAdd adds
// to x, else x is overwritten. The head dim is the outer loop, so each of
// a's elements is loaded once.
template <int COLS, int LD, bool kAdd = false>
__device__ __forceinline__ void dot_cols(float (&x)[COLS / 4], const float* a, const float* b,
                                         int c, int D) {
  if constexpr (!kAdd) {
#pragma unroll
    for (int i = 0; i < COLS / 4; ++i) x[i] = 0.f;
  }
#pragma unroll 2
  for (int d = 0; d < D; ++d) {
    const float ad = a[d];
#pragma unroll
    for (int i = 0; i < COLS / 4; ++i) x[i] = fmaf(ad, b[(c + 4 * i) * LD + d], x[i]);
  }
}

// acc[i] += Σ_j p[j] · b[j][c + 4i] for a thread's head-dim columns c + 4i <
// D: p a staged score row of COLS, b a staged tile. The tile's rows are the
// outer loop, so each score is loaded once.
template <int DMAX, int COLS, int LD>
__device__ __forceinline__ void acc_cols(float (&acc)[DMAX / 4], const float* p, const float* b,
                                         int c, int D) {
#pragma unroll 2
  for (int j = 0; j < COLS; ++j) {
    const float pj = p[j];
#pragma unroll
    for (int i = 0; i < DMAX / 4; ++i) {
      if (c + 4 * i < D) acc[i] = fmaf(pj, b[j * LD + c + 4 * i], acc[i]);
    }
  }
}

// Replaces _fwd_kernel of edl_tpu/ops/flash_attention.py for f32 inputs.
template <int DMAX, int COLS>
__global__ void __launch_bounds__(kThreadsF32) flash_fwd_f32_kernel(FwdArgs a) {
  constexpr int kLd = DMAX + 1, kPLd = COLS + 1;  // row strides: rows on distinct banks
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + kRows * kLd;
  float* sv = sk + COLS * kLd;
  float* sp = sv + COLS * kLd;

  const int n_qt = (a.Sq + kRows - 1) / kRows;
  const int BH = gridDim.x / n_qt;
  const int qt = n_qt - 1 - blockIdx.x / BH;  // the last query tiles carry the most keys
  const int bh = blockIdx.x % BH, b = bh / a.H, h = bh % a.H;
  const int q0 = qt * kRows, r = threadIdx.x >> 2, c = threadIdx.x & 3;
  const int qpos = a.q_offset + q0 + r;
  const int n_kt = key_tiles_f32<COLS>(a.Sk, q0, a.q_offset, a.k_offset, a.causal);

  load_rows<kRows, kLd>(sq, a.q, b, h, q0, a.Sq, a.D);
  float acc[DMAX / 4];
#pragma unroll
  for (int i = 0; i < DMAX / 4; ++i) acc[i] = 0.f;
  float m = kNegInfF32, l = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();  // the last tile's reads are done
    load_rows<COLS, kLd>(sk, a.k, b, h, kt * COLS, a.Sk, a.D);
    load_rows<COLS, kLd>(sv, a.v, b, h, kt * COLS, a.Sk, a.D);
    __syncthreads();
    float s[COLS / 4];
    bool ok[COLS / 4];
    float mx = m;
    dot_cols<COLS, kLd>(s, sq + r * kLd, sk, c, a.D);
#pragma unroll
    for (int i = 0; i < COLS / 4; ++i) {
      const int key = kt * COLS + c + 4 * i;
      ok[i] = key < a.Sk && (!a.causal || a.k_offset + key <= qpos);
      s[i] = ok[i] ? s[i] * a.scale : kNegInfF32;
      mx = fmaxf(mx, s[i]);
    }
    mx = quad_max(mx);
    float rs = 0.f;
#pragma unroll
    for (int i = 0; i < COLS / 4; ++i) {
      const float p = ok[i] ? expf(s[i] - mx) : 0.f;
      sp[r * kPLd + c + 4 * i] = p;
      rs += p;
    }
    const float alpha = expf(m - mx);
    l = l * alpha + quad_sum(rs);
    m = mx;
    __syncwarp();  // the row's four threads share its P
#pragma unroll
    for (int i = 0; i < DMAX / 4; ++i) acc[i] *= alpha;
    acc_cols<DMAX, COLS, kLd>(acc, sp + r * kPLd, sv, c, a.D);
  }
  const int row = q0 + r;
  if (row >= a.Sq) return;
  const float safe = l > 0.f ? l : 1.f;  // a row with no key: acc is 0, so O = 0
  float* o = static_cast<float*>(a.o) + (((long long)b * a.Sq + row) * a.H + h) * a.D;
#pragma unroll
  for (int i = 0; i < DMAX / 4; ++i) {
    const int d = c + 4 * i;
    if (d < a.D) o[d] = acc[i] / safe;
  }
  if (c == 0) a.lse[(long long)bh * a.Sq + row] = l > 0.f ? m + logf(l) : kNegInfF32;
}

// -- past a head dim of 256: column slices and chunked scores -----------------
//
// The forward: no whole-D row lives in shared memory. A block owns the rows
// of one tile and one slice of kSliceF32 columns of O, sums each tile's
// scores over kChunkF32-column chunks of the head dim staged one at a time,
// then stages the tile's rows of the slice for the second product. The head
// dim is read at run time, so one variant serves every D past 256. Every
// slice of a row computes the same scores and statistics; only slice 0
// writes lse. The backward kernels past 256 run on the tensor cores
// (flash_bwd_dq_f32_sliced.cu, flash_bwd_dkv_f32_sliced.cu).

constexpr int kChunkF32 = 64;      // head-dim columns a staged chunk
constexpr int kSliceF32 = 256;     // O's columns a block
constexpr int kLdC = kChunkF32 + 1;  // a staged chunk's row stride: rows on distinct banks

// Rows [row0, row0 + ROWS) x columns [col0, col0 + COLS) of head h, batch b of
// view x into shared memory (row stride LD); rows at or beyond S and columns
// at or beyond D load as 0.
template <int ROWS, int COLS, int LD>
__device__ __forceinline__ void load_block(float* dst, const View& x, int b, int h, int row0,
                                           int S, int col0, int D) {
  const float* src = static_cast<const float*>(x.ptr);
  for (int i = threadIdx.x; i < ROWS * COLS; i += kThreadsF32) {
    const int r = i / COLS, d = i % COLS, s = row0 + r, col = col0 + d;
    dst[r * LD + d] = s < S && col < D ? src[b * x.sb + s * x.ss + h * x.sh + col] : 0.f;
  }
}

// The (batch, head), row tile and slice of a sliced block: the grid is row
// tiles x slices x (batch, head), the heaviest row tiles first (`last`: the
// last tiles carry the most keys) or the earliest.
struct SliceBlock {
  int tile, slice, bh;
};

__device__ __forceinline__ SliceBlock slice_block(int n_tiles, int n_slices, bool last) {
  const int per_tile = gridDim.x / n_tiles, BH = per_tile / n_slices;
  const int i = blockIdx.x / per_tile;
  return {last ? n_tiles - 1 - i : i, (int)(blockIdx.x % per_tile) / BH, (int)(blockIdx.x % BH)};
}

// Replaces _fwd_kernel of edl_tpu/ops/flash_attention.py for f32 inputs past
// a head dim of 256.
template <int COLS>
__global__ void __launch_bounds__(kThreadsF32) flash_fwd_f32_sliced_kernel(FwdArgs a) {
  constexpr int kLdS = kSliceF32 + 1, kPLd = COLS + 1;
  extern __shared__ float smem[];
  float* sq = smem;               // a Q chunk
  float* sk = sq + kRows * kLdC;  // a K chunk
  float* sv = sk + COLS * kLdC;   // the tile's V slice
  float* sp = sv + COLS * kLdS;   // P

  const int n_ch = (a.D + kChunkF32 - 1) / kChunkF32;
  const SliceBlock blk = slice_block((a.Sq + kRows - 1) / kRows,
                                     (a.D + kSliceF32 - 1) / kSliceF32, true);
  const int b = blk.bh / a.H, h = blk.bh % a.H, col0 = blk.slice * kSliceF32;
  const int q0 = blk.tile * kRows, r = threadIdx.x >> 2, c = threadIdx.x & 3;
  const int qpos = a.q_offset + q0 + r;
  const int n_kt = key_tiles_f32<COLS>(a.Sk, q0, a.q_offset, a.k_offset, a.causal);

  float acc[kSliceF32 / 4];
#pragma unroll
  for (int i = 0; i < kSliceF32 / 4; ++i) acc[i] = 0.f;
  float m = kNegInfF32, l = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    float s[COLS / 4];
#pragma unroll
    for (int i = 0; i < COLS / 4; ++i) s[i] = 0.f;
    for (int ch = 0; ch < n_ch; ++ch) {
      __syncthreads();  // the last chunk's (and tile's) reads are done
      load_block<kRows, kChunkF32, kLdC>(sq, a.q, b, h, q0, a.Sq, ch * kChunkF32, a.D);
      load_block<COLS, kChunkF32, kLdC>(sk, a.k, b, h, kt * COLS, a.Sk, ch * kChunkF32, a.D);
      __syncthreads();
      dot_cols<COLS, kLdC, true>(s, sq + r * kLdC, sk, c, kChunkF32);
    }
    bool ok[COLS / 4];
    float mx = m;
#pragma unroll
    for (int i = 0; i < COLS / 4; ++i) {
      const int key = kt * COLS + c + 4 * i;
      ok[i] = key < a.Sk && (!a.causal || a.k_offset + key <= qpos);
      s[i] = ok[i] ? s[i] * a.scale : kNegInfF32;
      mx = fmaxf(mx, s[i]);
    }
    mx = quad_max(mx);
    float rs = 0.f;
#pragma unroll
    for (int i = 0; i < COLS / 4; ++i) {
      const float p = ok[i] ? expf(s[i] - mx) : 0.f;
      sp[r * kPLd + c + 4 * i] = p;
      rs += p;
    }
    const float alpha = expf(m - mx);
    l = l * alpha + quad_sum(rs);
    m = mx;
    __syncthreads();
    load_block<COLS, kSliceF32, kLdS>(sv, a.v, b, h, kt * COLS, a.Sk, col0, a.D);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kSliceF32 / 4; ++i) acc[i] *= alpha;
    acc_cols<kSliceF32, COLS, kLdS>(acc, sp + r * kPLd, sv, c, a.D - col0);
  }
  const int row = q0 + r;
  if (row >= a.Sq) return;
  const float safe = l > 0.f ? l : 1.f;  // a row with no key: acc is 0, so O = 0
  float* o = static_cast<float*>(a.o) + (((long long)b * a.Sq + row) * a.H + h) * a.D;
#pragma unroll
  for (int i = 0; i < kSliceF32 / 4; ++i) {
    const int d = col0 + c + 4 * i;
    if (d < a.D) o[d] = acc[i] / safe;
  }
  if (c == 0 && blk.slice == 0) {
    a.lse[(long long)blk.bh * a.Sq + row] = l > 0.f ? m + logf(l) : kNegInfF32;
  }
}

template <int DMAX, int COLS>
constexpr size_t fwd_smem_f32() {
  constexpr int kLd = DMAX + 1, kPLd = COLS + 1;  // row strides: rows on distinct banks
  return (kRows * kLd + 2 * COLS * kLd + kRows * kPLd) * sizeof(float);
}

// The sliced forward's shared memory, at COLS keys a tile.
template <int COLS>
constexpr size_t fwd_sliced_smem_f32() {
  return ((kRows + COLS) * kLdC + COLS * (kSliceF32 + 1) + kRows * (COLS + 1)) * sizeof(float);
}

constexpr size_t kSmemMaxF32 = 232448;  // dynamic shared memory a block can take on the H100

// The compiled variants: (head dims up to DMAX, tile COLS) by kernel.
static_assert(fwd_smem_f32<128, 64>() <= kSmemMaxF32 && fwd_smem_f32<256, 64>() <= kSmemMaxF32,
              "forward shared memory");
// Past a head dim of 256 (tiles of kSliced keys).
constexpr int kSliced = 64;
static_assert(fwd_sliced_smem_f32<kSliced>() <= kSmemMaxF32, "sliced shared memory");

template <int DMAX, int COLS>
cudaError_t launch_fwd_f32_at(const FwdArgs& a, cudaStream_t stream) {
  constexpr size_t kBytes = fwd_smem_f32<DMAX, COLS>();
  cudaError_t rc = allow_smem(flash_fwd_f32_kernel<DMAX, COLS>, kBytes);
  if (rc != cudaSuccess) return rc;
  const int blocks = a.B * a.H * ((a.Sq + kRows - 1) / kRows);
  flash_fwd_f32_kernel<DMAX, COLS><<<blocks, kThreadsF32, kBytes, stream>>>(a);
  return cudaGetLastError();
}

// A sliced kernel's launch: (batch, head) x row tiles x column slices blocks,
// refused past one launch's 2^31 - 1.
template <typename Kernel, typename Args>
cudaError_t launch_sliced_f32(Kernel kernel, size_t bytes, const Args& a, int S, int width,
                              cudaStream_t stream) {
  const long long blocks = (long long)a.B * a.H * ((S + kRows - 1) / kRows) *
                           ((a.D + width - 1) / width);
  if (blocks >= (1ll << 31)) return cudaErrorInvalidValue;
  cudaError_t rc = allow_smem(kernel, bytes);
  if (rc != cudaSuccess) return rc;
  kernel<<<(unsigned)blocks, kThreadsF32, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Each call runs the variant for its head dim: up to 128, up to 256, or the
// sliced one past 256.

cudaError_t launch_fwd_f32(const FwdArgs& a, cudaStream_t stream) {
  if (a.D <= 0 || !a.out_f32) return cudaErrorInvalidValue;
  if (a.D > 256) {
    return launch_sliced_f32(flash_fwd_f32_sliced_kernel<kSliced>, fwd_sliced_smem_f32<kSliced>(),
                             a, a.Sq, kSliceF32, stream);
  }
  return a.D <= 128 ? launch_fwd_f32_at<128, 64>(a, stream) : launch_fwd_f32_at<256, 64>(a, stream);
}

}  // namespace edl_flash
