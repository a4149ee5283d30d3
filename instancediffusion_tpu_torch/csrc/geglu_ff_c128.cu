// fused GEGLU feed-forward, C = 128: see geglu_ff_sm90.cuh
#include "geglu_ff_sm90.cuh"

IDT_FF_INSTANTIATE(128)
