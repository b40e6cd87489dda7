// The bf16 variants of flash_fwd_kernel (flash_kernels.cuh) at padded head dims
// 192 and 256, compiled on their own so that the build runs one nvcc process
// per unit (flash_launch.h).

#include "flash_kernels.cuh"

namespace edl_flash {

template cudaError_t launch_fwd<__nv_bfloat16, 192, 64>(const FwdArgs&, cudaStream_t);
template cudaError_t launch_fwd<__nv_bfloat16, 256, 64>(const FwdArgs&, cudaStream_t);

}  // namespace edl_flash
