// The bf16 variants of flash_fwd_kernel (flash_kernels.cuh) by padded head
// dim, keys a stage, compiled on their own so that the build runs one nvcc
// process per unit (flash_launch.h).

#include "flash_kernels.cuh"

namespace edl_flash {

template cudaError_t launch_fwd<__nv_bfloat16, 16, 64>(const FwdArgs&, cudaStream_t);
template cudaError_t launch_fwd<__nv_bfloat16, 32, 64>(const FwdArgs&, cudaStream_t);
template cudaError_t launch_fwd<__nv_bfloat16, 64, 64>(const FwdArgs&, cudaStream_t);
template cudaError_t launch_fwd<__nv_bfloat16, 128, 64>(const FwdArgs&, cudaStream_t);
template cudaError_t launch_fwd<__nv_bfloat16, 64, 128>(const FwdArgs&, cudaStream_t);
template cudaError_t launch_fwd<__nv_bfloat16, 128, 128>(const FwdArgs&, cudaStream_t);

}  // namespace edl_flash
