// Flash attention for f32 inputs: the forward kernel and the two backward
// kernels on the CUDA cores, in f32 fused multiply-adds.
//
// They replace the same Pallas TPU kernels as flash_kernels.cuh
// (edl_tpu/ops/flash_attention.py's _fwd_kernel, _bwd_dq_kernel and
// _bwd_dkv_kernel) where q, k and v are f32, and compute the same functions
// with the same semantics: global-position causality, the ragged edge masked
// in the kernel, masking through the validity bit, the -1e30 sentinel for rows
// that see no key (O = 0, lse = -1e30), lse and delta (B, H, Sq) f32, dO f32
// and contiguous. The Pallas kernels multiply f32 inputs in f32; so do these,
// where the wgmma path could not: wgmma's TF32 form takes both operands
// K-major only, while P·V and dkv's two products read V, dO and Q MN-major,
// and one TF32 rounding of the inputs and of P may miss the JAX on-chip
// check's 2e-3. exp and log are the accurate expf and logf.
//
// Bound on the H100: the same FLOPs as the 16-bit kernels (4·D, 6·D and 8·D
// a visible pair) at the card's 67 TFLOP/s of f32 outside the tensor cores,
// and twice their bytes. Design, simple and not tuned: a block of 256
// threads owns 64 query rows (dkv: 64 keys) of one (batch, head) and walks
// 64-key (dkv: 64-query) tiles staged in shared memory; four threads share a
// row, each taking every fourth score of a tile and every fourth head-dim
// column of the accumulators; the scores pass through shared memory to the
// second product. Causally dead tiles are skipped, as in the 16-bit kernels.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_launch.h"

namespace edl_flash {
namespace {

constexpr int kRows = 64;              // query rows a block (dkv: keys a block)
constexpr int kCols = 64;              // keys a tile (dkv: query rows a tile)
constexpr int kThreadsF32 = 4 * kRows;  // four a row
constexpr int kDMax = 128;             // the largest head dim
constexpr int kLd = kDMax + 1;         // row stride of a staged tile: rows on distinct banks
constexpr int kPLd = kCols + 1;        // row stride of a staged score tile
constexpr float kNegInfF32 = -1e30f;   // the TPU kernels' _NEG_INF sentinel

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows [row0, row0 + kRows) of head h, batch b of view x into shared memory
// (row stride kLd); rows at or beyond S load as 0.
__device__ __forceinline__ void load_rows(float* dst, const View& x, int b, int h, int row0, int S,
                                          int D) {
  const float* src = static_cast<const float*>(x.ptr);
  for (int i = threadIdx.x; i < kRows * D; i += kThreadsF32) {
    const int r = i / D, d = i % D, s = row0 + r;
    dst[r * kLd + d] = s < S ? src[b * x.sb + s * x.ss + h * x.sh + d] : 0.f;
  }
}

// Key tiles [0, n) that some row of the query block at local row q0 sees.
__device__ __forceinline__ int key_tiles_f32(int Sk, int q0, int q_offset, int k_offset,
                                             int causal) {
  int n = (Sk + kCols - 1) / kCols;
  if (causal) {
    const long long last = (long long)q_offset + q0 + kRows - 1 - k_offset;
    const long long lim = last < 0 ? 0 : last / kCols + 1;
    if (lim < n) n = (int)lim;
  }
  return n;
}

// x[i] (+)= a · b[c + 4i] over the head dim for a thread's 16 columns of a
// tile: a is a staged row, b the staged tile (row stride kLd). The head dim
// is the outer loop, so each of a's elements is loaded once.
__device__ __forceinline__ void dot_cols(float (&x)[kCols / 4], const float* a, const float* b,
                                         int c, int D) {
#pragma unroll
  for (int i = 0; i < kCols / 4; ++i) x[i] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; ++d) {
    const float ad = a[d];
#pragma unroll
    for (int i = 0; i < kCols / 4; ++i) x[i] = fmaf(ad, b[(c + 4 * i) * kLd + d], x[i]);
  }
}

// acc[i] += Σ_j p[j] · b[j][c + 4i] for a thread's head-dim columns c + 4i <
// D: p a staged score row, b a staged tile. The tile's rows are the outer
// loop, so each score is loaded once.
__device__ __forceinline__ void acc_cols(float (&acc)[kDMax / 4], const float* p, const float* b,
                                         int c, int D) {
#pragma unroll 2
  for (int j = 0; j < kCols; ++j) {
    const float pj = p[j];
#pragma unroll
    for (int i = 0; i < kDMax / 4; ++i) {
      if (c + 4 * i < D) acc[i] = fmaf(pj, b[j * kLd + c + 4 * i], acc[i]);
    }
  }
}

// Replaces _fwd_kernel of edl_tpu/ops/flash_attention.py for f32 inputs.
__global__ void __launch_bounds__(kThreadsF32) flash_fwd_f32_kernel(FwdArgs a) {
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + kRows * kLd;
  float* sv = sk + kCols * kLd;
  float* sp = sv + kCols * kLd;

  const int n_qt = (a.Sq + kRows - 1) / kRows;
  const int BH = gridDim.x / n_qt;
  const int qt = n_qt - 1 - blockIdx.x / BH;  // the last query tiles carry the most keys
  const int bh = blockIdx.x % BH, b = bh / a.H, h = bh % a.H;
  const int q0 = qt * kRows, r = threadIdx.x >> 2, c = threadIdx.x & 3;
  const int qpos = a.q_offset + q0 + r;
  const int n_kt = key_tiles_f32(a.Sk, q0, a.q_offset, a.k_offset, a.causal);

  load_rows(sq, a.q, b, h, q0, a.Sq, a.D);
  float acc[kDMax / 4];
#pragma unroll
  for (int i = 0; i < kDMax / 4; ++i) acc[i] = 0.f;
  float m = kNegInfF32, l = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();  // the last tile's reads are done
    load_rows(sk, a.k, b, h, kt * kCols, a.Sk, a.D);
    load_rows(sv, a.v, b, h, kt * kCols, a.Sk, a.D);
    __syncthreads();
    float s[kCols / 4];
    bool ok[kCols / 4];
    float mx = m;
    dot_cols(s, sq + r * kLd, sk, c, a.D);
#pragma unroll
    for (int i = 0; i < kCols / 4; ++i) {
      const int key = kt * kCols + c + 4 * i;
      ok[i] = key < a.Sk && (!a.causal || a.k_offset + key <= qpos);
      s[i] = ok[i] ? s[i] * a.scale : kNegInfF32;
      mx = fmaxf(mx, s[i]);
    }
    mx = quad_max(mx);
    float rs = 0.f;
#pragma unroll
    for (int i = 0; i < kCols / 4; ++i) {
      const float p = ok[i] ? expf(s[i] - mx) : 0.f;
      sp[r * kPLd + c + 4 * i] = p;
      rs += p;
    }
    const float alpha = expf(m - mx);
    l = l * alpha + quad_sum(rs);
    m = mx;
    __syncwarp();  // the row's four threads share its P
#pragma unroll
    for (int i = 0; i < kDMax / 4; ++i) acc[i] *= alpha;
    acc_cols(acc, sp + r * kPLd, sv, c, a.D);
  }
  const int row = q0 + r;
  if (row >= a.Sq) return;
  const float safe = l > 0.f ? l : 1.f;  // a row with no key: acc is 0, so O = 0
  float* o = static_cast<float*>(a.o) + (((long long)b * a.Sq + row) * a.H + h) * a.D;
#pragma unroll
  for (int i = 0; i < kDMax / 4; ++i) {
    const int d = c + 4 * i;
    if (d < a.D) o[d] = acc[i] / safe;
  }
  if (c == 0) a.lse[(long long)bh * a.Sq + row] = l > 0.f ? m + logf(l) : kNegInfF32;
}

// Replaces _bwd_dq_kernel of edl_tpu/ops/flash_attention.py for f32 inputs.
__global__ void __launch_bounds__(kThreadsF32) flash_bwd_dq_f32_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  float* sq = smem;
  float* sdo = sq + kRows * kLd;
  float* sk = sdo + kRows * kLd;
  float* sv = sk + kCols * kLd;
  float* sds = sv + kCols * kLd;

  const int n_qt = (a.Sq + kRows - 1) / kRows;
  const int BH = gridDim.x / n_qt;
  const int qt = n_qt - 1 - blockIdx.x / BH;
  const int bh = blockIdx.x % BH, b = bh / a.H, h = bh % a.H;
  const int q0 = qt * kRows, r = threadIdx.x >> 2, c = threadIdx.x & 3;
  const int row = q0 + r, qpos = a.q_offset + row;
  const int n_kt = key_tiles_f32(a.Sk, q0, a.q_offset, a.k_offset, a.causal);
  // rows at or beyond Sq stay finite and are never written
  const float lse = row < a.Sq ? a.lse[(long long)bh * a.Sq + row] : 0.f;
  const float delta = row < a.Sq ? a.delta[(long long)bh * a.Sq + row] : 0.f;
  const View dout = {a.dout, (long long)a.Sq * a.H * a.D, (long long)a.H * a.D, a.D};

  load_rows(sq, a.q, b, h, q0, a.Sq, a.D);
  load_rows(sdo, dout, b, h, q0, a.Sq, a.D);
  float acc[kDMax / 4];
#pragma unroll
  for (int i = 0; i < kDMax / 4; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();
    load_rows(sk, a.k, b, h, kt * kCols, a.Sk, a.D);
    load_rows(sv, a.v, b, h, kt * kCols, a.Sk, a.D);
    __syncthreads();
    float s[kCols / 4], dp[kCols / 4];
    dot_cols(s, sq + r * kLd, sk, c, a.D);
    dot_cols(dp, sdo + r * kLd, sv, c, a.D);
#pragma unroll
    for (int i = 0; i < kCols / 4; ++i) {
      const int j = c + 4 * i, key = kt * kCols + j;
      const bool ok = key < a.Sk && (!a.causal || a.k_offset + key <= qpos);
      const float p = ok ? expf(s[i] * a.scale - lse) : 0.f;
      sds[r * kPLd + j] = ok ? p * (dp[i] - delta) * a.scale : 0.f;
    }
    __syncwarp();
    acc_cols(acc, sds + r * kPLd, sk, c, a.D);
  }
  if (row >= a.Sq) return;
  float* dq = static_cast<float*>(a.dq) + (((long long)b * a.Sq + row) * a.H + h) * a.D;
#pragma unroll
  for (int i = 0; i < kDMax / 4; ++i) {
    const int d = c + 4 * i;
    if (d < a.D) dq[d] = acc[i];
  }
}

// Replaces _bwd_dkv_kernel of edl_tpu/ops/flash_attention.py for f32 inputs.
__global__ void __launch_bounds__(kThreadsF32) flash_bwd_dkv_f32_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  float* sk = smem;
  float* sv = sk + kRows * kLd;
  float* sq = sv + kRows * kLd;
  float* sdo = sq + kCols * kLd;
  float* sp = sdo + kCols * kLd;
  float* sds = sp + kRows * kPLd;
  float* slse = sds + kRows * kPLd;
  float* sdelta = slse + kCols;

  const int n_kt = (a.Sk + kRows - 1) / kRows;
  const int BH = gridDim.x / n_kt;
  const int kt = blockIdx.x / BH;  // the first key tiles are seen by the most queries
  const int bh = blockIdx.x % BH, b = bh / a.H, h = bh % a.H;
  const int k0 = kt * kRows, r = threadIdx.x >> 2, c = threadIdx.x & 3;
  const int key = k0 + r, kpos = a.k_offset + key;
  const int n_qt = (a.Sq + kCols - 1) / kCols;
  int qt0 = 0;  // the first query tile that sees some key of the block
  if (a.causal) {
    const long long need = (long long)a.k_offset + k0 - a.q_offset - (kCols - 1);
    qt0 = need <= 0 ? 0 : (int)((need + kCols - 1) / kCols);
  }
  const View dout = {a.dout, (long long)a.Sq * a.H * a.D, (long long)a.H * a.D, a.D};

  load_rows(sk, a.k, b, h, k0, a.Sk, a.D);
  load_rows(sv, a.v, b, h, k0, a.Sk, a.D);
  float dk[kDMax / 4], dv[kDMax / 4];
#pragma unroll
  for (int i = 0; i < kDMax / 4; ++i) dk[i] = dv[i] = 0.f;
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kCols;
    __syncthreads();
    load_rows(sq, a.q, b, h, q0, a.Sq, a.D);
    load_rows(sdo, dout, b, h, q0, a.Sq, a.D);
    if (threadIdx.x < kCols) {
      const int qi = q0 + threadIdx.x;
      slse[threadIdx.x] = qi < a.Sq ? a.lse[(long long)bh * a.Sq + qi] : 0.f;
      sdelta[threadIdx.x] = qi < a.Sq ? a.delta[(long long)bh * a.Sq + qi] : 0.f;
    }
    __syncthreads();
    float st[kCols / 4], dpt[kCols / 4];
    dot_cols(st, sk + r * kLd, sq, c, a.D);
    dot_cols(dpt, sv + r * kLd, sdo, c, a.D);
#pragma unroll
    for (int i = 0; i < kCols / 4; ++i) {
      const int j = c + 4 * i;
      const bool ok = key < a.Sk && q0 + j < a.Sq && (!a.causal || kpos <= a.q_offset + q0 + j);
      const float p = ok ? expf(st[i] * a.scale - slse[j]) : 0.f;
      sp[r * kPLd + j] = p;
      sds[r * kPLd + j] = ok ? p * (dpt[i] - sdelta[j]) * a.scale : 0.f;
    }
    __syncwarp();
    acc_cols(dv, sp + r * kPLd, sdo, c, a.D);
    acc_cols(dk, sds + r * kPLd, sq, c, a.D);
  }
  if (key >= a.Sk) return;
  const long long base = (((long long)b * a.Sk + key) * a.H + h) * a.D;
  float* dkp = static_cast<float*>(a.dk) + base;
  float* dvp = static_cast<float*>(a.dv) + base;
#pragma unroll
  for (int i = 0; i < kDMax / 4; ++i) {
    const int d = c + 4 * i;
    if (d < a.D) {
      dkp[d] = dk[i];
      dvp[d] = dv[i];
    }
  }
}

constexpr size_t kFwdSmemF32 = (kRows * kLd + 2 * kCols * kLd + kRows * kPLd) * sizeof(float);
constexpr size_t kDqSmemF32 = (2 * kRows * kLd + 2 * kCols * kLd + kRows * kPLd) * sizeof(float);
constexpr size_t kDkvSmemF32 =
    (2 * kRows * kLd + 2 * kCols * kLd + 2 * kRows * kPLd + 2 * kCols) * sizeof(float);
static_assert(kDkvSmemF32 <= 232448, "shared memory");

}  // namespace

cudaError_t launch_fwd_f32(const FwdArgs& a, cudaStream_t stream) {
  if (a.D <= 0 || a.D > kDMax || !a.out_f32) return cudaErrorInvalidValue;
  cudaError_t rc = allow_smem(flash_fwd_f32_kernel, kFwdSmemF32);
  if (rc != cudaSuccess) return rc;
  const int blocks = a.B * a.H * ((a.Sq + kRows - 1) / kRows);
  flash_fwd_f32_kernel<<<blocks, kThreadsF32, kFwdSmemF32, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_bwd_dq_f32(const BwdArgs& a, cudaStream_t stream) {
  if (a.D <= 0 || a.D > kDMax) return cudaErrorInvalidValue;
  cudaError_t rc = allow_smem(flash_bwd_dq_f32_kernel, kDqSmemF32);
  if (rc != cudaSuccess) return rc;
  const int blocks = a.B * a.H * ((a.Sq + kRows - 1) / kRows);
  flash_bwd_dq_f32_kernel<<<blocks, kThreadsF32, kDqSmemF32, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_bwd_dkv_f32(const BwdArgs& a, cudaStream_t stream) {
  if (a.D <= 0 || a.D > kDMax) return cudaErrorInvalidValue;
  cudaError_t rc = allow_smem(flash_bwd_dkv_f32_kernel, kDkvSmemF32);
  if (rc != cudaSuccess) return rc;
  const int blocks = a.B * a.H * ((a.Sk + kRows - 1) / kRows);
  flash_bwd_dkv_f32_kernel<<<blocks, kThreadsF32, kDkvSmemF32, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace edl_flash
