// Shared by the kernel sources under csrc/.  Each source is built into a
// library of its own (ops/_build.py), so every library gets its own copy of
// the entry points defined here.
#pragma once

#include <cuda_runtime.h>

#define NNS_EXPORT extern "C" __attribute__((visibility("default")))

// Text of a CUDA error code returned by an entry point.
NNS_EXPORT const char* nns_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
