#include "common.cuh"

// Message for a cudaError_t returned by one of the launchers.
IDT_EXPORT const char* idt_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
