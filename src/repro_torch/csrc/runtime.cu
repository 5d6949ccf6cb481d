// Error reporting for the ctypes wrappers: each launcher returns the
// cudaError_t of its launch, and the wrapper raises with this text.
#include <cuda_runtime.h>

extern "C" const char* repro_torch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
