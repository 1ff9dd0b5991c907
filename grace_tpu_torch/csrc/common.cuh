// Shared by every kernel library: the error-string export the Python
// binding reads after a failed launch.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* grace_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
