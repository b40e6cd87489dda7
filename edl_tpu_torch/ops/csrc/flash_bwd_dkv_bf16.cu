// The bf16 variants of flash_bwd_dkv_kernel (flash_kernels.cuh) by padded head
// dim, compiled on their own so that the build runs one nvcc process per unit
// (flash_launch.h).

#include "flash_kernels.cuh"

namespace edl_flash {

template cudaError_t launch_bwd_dkv<__nv_bfloat16, 16>(const BwdArgs&, cudaStream_t);
template cudaError_t launch_bwd_dkv<__nv_bfloat16, 32>(const BwdArgs&, cudaStream_t);
template cudaError_t launch_bwd_dkv<__nv_bfloat16, 64>(const BwdArgs&, cudaStream_t);
template cudaError_t launch_bwd_dkv<__nv_bfloat16, 128>(const BwdArgs&, cudaStream_t);

}  // namespace edl_flash
