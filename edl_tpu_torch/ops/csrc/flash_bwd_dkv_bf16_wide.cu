// The bf16 variants of flash_bwd_dkv_kernel (flash_kernels.cuh) at padded head
// dims 192 and 256, compiled on their own so that the build runs one nvcc
// process per unit (flash_launch.h).

#include "flash_kernels.cuh"

namespace edl_flash {

template cudaError_t launch_bwd_dkv<__nv_bfloat16, 192>(const BwdArgs&, cudaStream_t);
template cudaError_t launch_bwd_dkv<__nv_bfloat16, 256>(const BwdArgs&, cudaStream_t);

}  // namespace edl_flash
