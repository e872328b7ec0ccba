// Names a cudaError_t returned by a launcher, for the Python wrappers'
// error messages.
#include <cuda_runtime.h>

extern "C" const char* repro_torch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
