// The f16 variant of flash_fwd_sliced_kernel (flash_sliced.cuh), which serves
// every head dim past 256, compiled on its own so that the build runs one nvcc
// process per unit (flash_launch.h).

#include "flash_sliced.cuh"

namespace edl_flash {

template cudaError_t launch_fwd_sliced<__half>(const FwdArgs&, cudaStream_t);

}  // namespace edl_flash
