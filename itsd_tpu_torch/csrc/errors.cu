// Error text for the codes the C entry points return.
#include <cuda_runtime.h>

extern "C" const char* itsd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
