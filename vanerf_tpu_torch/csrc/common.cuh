// Shared helpers of the port's CUDA kernels.
//
// Every kernel here is built by nvcc into one shared library with a plain
// C interface (see ops/_cuda.py) for sm_90a, with -fmad=false: each
// kernel then rounds every product and sum on its own, exactly as the
// plain-PyTorch twin in the same Python module does, so kernel and twin
// agree bit for bit wherever they evaluate the same expression in the same
// order.  The entry points launch on the caller's stream, allocate
// nothing, and return cudaGetLastError() as an int.
#pragma once

#include <cuda_runtime.h>

#define VT_EXPORT extern "C" __attribute__((visibility("default")))

static inline cudaStream_t vt_stream(void* s) {
  return reinterpret_cast<cudaStream_t>(s);
}

static inline int vt_blocks(long long n, int threads) {
  return static_cast<int>((n + threads - 1) / threads);
}
