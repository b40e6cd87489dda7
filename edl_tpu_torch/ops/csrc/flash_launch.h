// The launchers of the flash-attention kernels, as the C interface
// (flash_attention.cu) calls them. Each variant is compiled in its own
// translation unit (flash_fwd_*.cu, flash_bwd_*.cu, flash_*_sliced.cu,
// flash_*_f32.cu, flash_*_f32_sliced.cu), so that the build runs one nvcc
// process per unit, all at once.

#pragma once

#include <cuda_runtime.h>

namespace edl_flash {

// A (B, S, H, D) view: its start and its element strides (unit stride along D).
struct View {
  const void* ptr;
  long long sb, ss, sh;
};

struct FwdArgs {
  View q, k, v;
  void* o;     // contiguous (B, Sq, H, D): f32 if out_f32, else q's type
  float* lse;  // (B, H, Sq)
  int B, H, Sq, Sk, D, q_offset, k_offset;
  float scale;
  int causal, out_f32;
};

struct BwdArgs {
  View q, k, v;
  const void* dout;    // contiguous (B, Sq, H, D), q's type
  const float* lse;    // (B, H, Sq)
  const float* delta;  // (B, H, Sq)
  void* dq;            // contiguous, q's shape and type (dq kernels)
  void* dk;            // contiguous, k's shape and type (dkv kernels)
  void* dv;
  int B, H, Sq, Sk, D, q_offset, k_offset;
  float scale;
  int causal;
};

// The wgmma kernels: T is __nv_bfloat16 or __half, DP the padded head dim
// (16, 32, 64, 128, 192 or 256), KEYS the forward's keys a pipeline stage (64
// or 128).
template <typename T, int DP, int KEYS>
cudaError_t launch_fwd(const FwdArgs& a, cudaStream_t stream);
template <typename T, int DP>
cudaError_t launch_bwd_dq(const BwdArgs& a, cudaStream_t stream);
template <typename T, int DP>
cudaError_t launch_bwd_dkv(const BwdArgs& a, cudaStream_t stream);

// The sliced wgmma kernels (flash_sliced.cuh): T is __nv_bfloat16 or __half,
// the head dim any multiple of 8 past 256, read at run time; each block owns
// a slice of the output's columns (256 of O, 512 of dQ, or 256 of dK and of
// dV). One launch a call.
template <typename T>
cudaError_t launch_fwd_sliced(const FwdArgs& a, cudaStream_t stream);
template <typename T>
cudaError_t launch_bwd_dq_sliced(const BwdArgs& a, cudaStream_t stream);
template <typename T>
cudaError_t launch_bwd_dkv_sliced(const BwdArgs& a, cudaStream_t stream);

// The f32 kernels (any head dim: whole rows up to 256, column slices past
// it), all three on the tensor cores in 3xTF32, up to 256 with a block owning
// all D columns of O, of dQ, or of dK and dV (flash_fwd_f32.cu,
// flash_bwd_dq_f32.cu, flash_bwd_dkv_f32.cu), past 256 through the three
// sliced launchers below.
cudaError_t launch_fwd_f32(const FwdArgs& a, cudaStream_t stream);
cudaError_t launch_bwd_dq_f32(const BwdArgs& a, cudaStream_t stream);
cudaError_t launch_bwd_dkv_f32(const BwdArgs& a, cudaStream_t stream);

// The f32 kernels past a head dim of 256, on the tensor cores in 3xTF32
// (flash_fwd_f32_sliced.cu, flash_bwd_dq_f32_sliced.cu,
// flash_bwd_dkv_f32_sliced.cu), which the three above call for D > 256: a
// block owns 512 columns of O, 512 of dQ, or 256 of dK and of dV.
cudaError_t launch_fwd_f32_sliced(const FwdArgs& a, cudaStream_t stream);
cudaError_t launch_bwd_dq_f32_sliced(const BwdArgs& a, cudaStream_t stream);
cudaError_t launch_bwd_dkv_f32_sliced(const BwdArgs& a, cudaStream_t stream);

// Lets `kernel` take `bytes` of dynamic shared memory (above the default 48 KB)
// on the current device. Set at every launch, so that every device has it.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace edl_flash
