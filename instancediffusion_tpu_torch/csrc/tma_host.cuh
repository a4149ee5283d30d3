// Host side of the TMA kernels: cuTensorMapEncodeTiled, reached through the
// runtime's entry-point query (nothing new is linked).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

namespace idt_tma {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The encoder, or nullptr when the installed CUDA has none. The encoder is a
// libcuda call: the calling thread's device context is made current first (a
// thread that has made no runtime call yet, such as autograd's backward
// thread, has none, and libcuda then refuses the map).
inline EncodeTiled encoder() {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || cudaSetDevice(dev) != cudaSuccess) return nullptr;
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                             cudaEnableDefault, &q) != cudaSuccess)
            return nullptr;
#else
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess)
            return nullptr;
#endif
        if (q != cudaDriverEntryPointSuccess) return nullptr;
        fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

}  // namespace idt_tma
