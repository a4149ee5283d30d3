// The flash forward kernel (flash_fwd_sm90.cuh), LABELED=true, WITH_LSE=false, for
// head dims 72-128; flash_fwd_labeled.cu holds the rest and the launcher.
#include "flash_fwd_sm90.cuh"

IDT_FA_WIDE(IDT_FA_DEFINE, true, false)
