// The bf16 variant of flash_bwd_dkv_sliced_kernel (flash_sliced.cuh), which serves
// every head dim past 256, compiled on its own so that the build runs one nvcc
// process per unit (flash_launch.h).

#include "flash_sliced.cuh"

namespace edl_flash {

template cudaError_t launch_bwd_dkv_sliced<__nv_bfloat16>(const BwdArgs&, cudaStream_t);

}  // namespace edl_flash
