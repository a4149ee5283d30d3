// fused GEGLU feed-forward, C = 64: see geglu_ff_sm90.cuh
#include "geglu_ff_sm90.cuh"

IDT_FF_INSTANTIATE(64)
