// Error text for the codes the kernels' C entry points return.
#include <cuda_runtime.h>

extern "C" const char* tpu_torch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
