// fused GEGLU feed-forward, C = 768 (clusters of three blocks, the SDXL
// refiner's ds2): see geglu_ff_sm90.cuh
#include "geglu_ff_sm90.cuh"

IDT_FF_INSTANTIATE(768)
