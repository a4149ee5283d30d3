// The flash forward kernel (flash_fwd_sm90.cuh), LABELED=true, WITH_LSE=true, for
// head dims 8-64 (72-128 in flash_fwd_lse_labeled_wide.cu) and the launcher that picks
// among all of them; one instantiation set per source so that nvcc builds
// them in parallel.
#include "flash_fwd_sm90.cuh"

IDT_FA_WIDE(IDT_FA_EXTERN, true, true)
IDT_FA_INSTANTIATE(true, true)
