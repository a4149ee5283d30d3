// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel is exported through a plain C function that launches on the
// caller's stream and returns the cudaError_t of the launch (0 = success),
// so the Python wrapper (ctypes) can raise right after a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define IDT_EXPORT extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ float idt_warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// Raise the dynamic shared-memory cap of `kernel` to `bytes` (needed above
// 48 KB) and return the error, if any.
template <typename K>
static cudaError_t idt_allow_smem(K kernel, size_t bytes) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}
