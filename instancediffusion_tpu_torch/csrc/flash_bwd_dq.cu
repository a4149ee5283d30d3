// The backward flash kernels (flash_bwd_sm90.cuh), DKV=false, LABELED=false, for
// every head dim they take; one instantiation set per source so that nvcc
// builds the four in parallel.
#include "flash_bwd_sm90.cuh"

IDT_FB_INSTANTIATE(false, false)
