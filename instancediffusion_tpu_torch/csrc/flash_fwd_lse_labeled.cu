// The flash forward kernel (flash_fwd_sm90.cuh), LABELED=true, WITH_LSE=true, for
// every head dim it takes; one instantiation set per source so that nvcc
// builds the four in parallel.
#include "flash_fwd_sm90.cuh"

IDT_FA_INSTANTIATE(true, true)
