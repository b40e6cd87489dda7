// Flash attention for NVIDIA Hopper: the plain C interface that Python loads
// with ctypes (edl_tpu_torch/ops/flash_attention.py), dispatching each call to
// the variant compiled for its element type, padded head dim and, in the
// forward, keys a stage.
//
// The kernels replace the three Pallas TPU kernels of
// edl_tpu/ops/flash_attention.py: flash_fwd_kernel, flash_bwd_dq_kernel and
// flash_bwd_dkv_kernel (flash_kernels.cuh, wgmma and TMA, for bf16 and f16),
// their sliced forms past a head dim of 256 (flash_sliced.cuh) and their f32
// counterparts (3xTF32 on the tensor cores: flash_*_f32.cu, past 256
// flash_*_f32_sliced.cu). The compiled set:
//
//   element type   padded head dim               forward tile (rows, keys a stage)
//   bf16           16, 32, 64, 128               (128, 64); also (128, 128) at 64 and 128
//                  192, 256                      (128, 64)
//                  past 256: D up to a multiple  (128, 64), sliced: a block owns 256
//                  of 64, read at run time       columns of O, 512 of dQ, or 256 of
//                                                dK and of dV
//   f16            16, 32, 64, 128               (128, 64)
//                  192, 256                      (128, 64)
//                  past 256, as bf16             (128, 64), sliced
//   f32            any D up to 256               (64, 64); all three on the tensor cores
//                                                in 3xTF32, a block owning all D columns
//                                                of O, of dQ, or of dK and dV
//                  past 256, read at run time    (64, 64), sliced: 512 columns of O, 512
//                                                of dQ, or 256 of dK and of dV
//
// A head dim D (a multiple of 8) runs the variant of the next padded head
// dim; columns from D on load as zeros. flash_attention.py's
// `compiled_blocks` mirrors this table. Every call is one launch; past 256
// its grid holds the column slices.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "flash_launch.h"

namespace {

using namespace edl_flash;

enum Dtype { kBf16 = 0, kF16 = 1, kF32 = 2 };

// The padded head dim a 16-bit kernel is compiled for: D a multiple of 8
// (TMA moves rows of 16-byte multiples) up to 256; past 256, D up to a
// multiple of 64, served by the sliced kernels; 0 if none.
int padded_head_dim(int D) {
  if (D <= 0 || D % 8) return 0;
  if (D > 256) return (D + 63) / 64 * 64;
  return D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : D <= 192 ? 192 : 256;
}

template <typename T>
cudaError_t fwd16(const FwdArgs& a, int block_k, cudaStream_t s) {
  const int dp = padded_head_dim(a.D);
  if (block_k == 64) {
    if (dp > 256) return launch_fwd_sliced<T>(a, s);
    switch (dp) {
      case 16: return launch_fwd<T, 16, 64>(a, s);
      case 32: return launch_fwd<T, 32, 64>(a, s);
      case 64: return launch_fwd<T, 64, 64>(a, s);
      case 128: return launch_fwd<T, 128, 64>(a, s);
      case 192: return launch_fwd<T, 192, 64>(a, s);
      case 256: return launch_fwd<T, 256, 64>(a, s);
    }
  }
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (block_k == 128) {
      switch (dp) {
        case 64: return launch_fwd<T, 64, 128>(a, s);
        case 128: return launch_fwd<T, 128, 128>(a, s);
      }
    }
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dq16(const BwdArgs& a, cudaStream_t s) {
  if (padded_head_dim(a.D) > 256) return launch_bwd_dq_sliced<T>(a, s);
  switch (padded_head_dim(a.D)) {
    case 16: return launch_bwd_dq<T, 16>(a, s);
    case 32: return launch_bwd_dq<T, 32>(a, s);
    case 64: return launch_bwd_dq<T, 64>(a, s);
    case 128: return launch_bwd_dq<T, 128>(a, s);
    case 192: return launch_bwd_dq<T, 192>(a, s);
    case 256: return launch_bwd_dq<T, 256>(a, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dkv16(const BwdArgs& a, cudaStream_t s) {
  if (padded_head_dim(a.D) > 256) return launch_bwd_dkv_sliced<T>(a, s);
  switch (padded_head_dim(a.D)) {
    case 16: return launch_bwd_dkv<T, 16>(a, s);
    case 32: return launch_bwd_dkv<T, 32>(a, s);
    case 64: return launch_bwd_dkv<T, 64>(a, s);
    case 128: return launch_bwd_dkv<T, 128>(a, s);
    case 192: return launch_bwd_dkv<T, 192>(a, s);
    case 256: return launch_bwd_dkv<T, 256>(a, s);
  }
  return cudaErrorInvalidValue;
}

BwdArgs bwd_args(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                 const void* delta, void* dq, void* dk, void* dv, int B, int H, int Sq, int Sk,
                 int D, const long long* st, int q_offset, int k_offset, float scale,
                 int causal) {
  return BwdArgs{{q, st[0], st[1], st[2]}, {k, st[3], st[4], st[5]}, {v, st[6], st[7], st[8]},
                 dout, static_cast<const float*>(lse), static_cast<const float*>(delta), dq, dk,
                 dv, B, H, Sq, Sk, D, q_offset, k_offset, scale, causal};
}

}  // namespace

// -- C interface (ctypes) -----------------------------------------------------
//
// Every function launches on `stream`, does not synchronise, allocates nothing
// and returns the cudaError_t of the launch (0 on success; cudaErrorInvalidValue
// for a variant that is not compiled). q, k, v: (B, S, H, D) of `dtype` (0
// bf16, 1 f16, 2 f32) with the given element strides; every other tensor
// contiguous, dO in q's type.

extern "C" {

const char* edl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int edl_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
                  int Sq, int Sk, int D, long long q_sb, long long q_ss, long long q_sh,
                  long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                  long long v_sh, int q_offset, int k_offset, float scale, int causal,
                  int out_f32, int dtype, int block_k, void* stream) {
  const FwdArgs a = {{q, q_sb, q_ss, q_sh}, {k, k_sb, k_ss, k_sh}, {v, v_sb, v_ss, v_sh}, o,
                     static_cast<float*>(lse), B, H, Sq, Sk, D, q_offset, k_offset, scale,
                     causal, out_f32};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBf16: return fwd16<__nv_bfloat16>(a, block_k, st);
    case kF16: return fwd16<__half>(a, block_k, st);
    case kF32: return block_k == 64 ? launch_fwd_f32(a, st) : cudaErrorInvalidValue;
  }
  return cudaErrorInvalidValue;
}

int edl_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dq, int B, int H, int Sq, int Sk,
                     int D, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                     long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                     long long v_sh, int q_offset, int k_offset, float scale, int causal,
                     int dtype, void* stream) {
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  const BwdArgs a = bwd_args(q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, H, Sq, Sk, D,
                             st, q_offset, k_offset, scale, causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBf16: return dq16<__nv_bfloat16>(a, s);
    case kF16: return dq16<__half>(a, s);
    case kF32: return launch_bwd_dq_f32(a, s);
  }
  return cudaErrorInvalidValue;
}

int edl_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dk, void* dv, int B, int H,
                      int Sq, int Sk, int D, long long q_sb, long long q_ss, long long q_sh,
                      long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                      long long v_ss, long long v_sh, int q_offset, int k_offset, float scale,
                      int causal, int dtype, void* stream) {
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  const BwdArgs a = bwd_args(q, k, v, dout, lse, delta, nullptr, dk, dv, B, H, Sq, Sk, D, st,
                             q_offset, k_offset, scale, causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBf16: return dkv16<__nv_bfloat16>(a, s);
    case kF16: return dkv16<__half>(a, s);
    case kF32: return launch_bwd_dkv_f32(a, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
