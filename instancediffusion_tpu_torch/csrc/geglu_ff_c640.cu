// fused GEGLU feed-forward, C = 640 (clusters of two blocks): see geglu_ff_sm90.cuh
#include "geglu_ff_sm90.cuh"

IDT_FF_INSTANTIATE(640)
