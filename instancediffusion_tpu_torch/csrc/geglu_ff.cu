// Host side of the fused GEGLU feed-forward kernel (geglu_ff_sm90.cuh): the
// TMA tensor maps and the C entry point.
//
// Replaces instancediffusion_tpu/kernels/geglu_ff.py::fused_ff_geglu
// (_ff_kernel); the kernel's header says what bounds it on this card (the
// registers a block with a producer warpgroup gets, the shared-memory bytes
// per product, the gate on the fp32 lanes, the shared memory left for the w1
// ring at C = 640, the one-tile w2 slots at C = 768) and what its design
// does. The
// Python wrapper (kernels/geglu_ff.py::ff_plan) derives the three maps; this
// file encodes them (tma_host.cuh) and picks the instantiation by C.
#include "geglu_ff_sm90.cuh"
#include "tma_host.cuh"

namespace idt_ff {
template <>
cudaError_t launch<64>(const Launch& a);
template <>
cudaError_t launch<128>(const Launch& a);
template <>
cudaError_t launch<320>(const Launch& a);
template <>
cudaError_t launch<640>(const Launch& a);
template <>
cudaError_t launch<768>(const Launch& a);
}  // namespace idt_ff

namespace {

constexpr int kMapArgs = 6;  // ptr, columns, rows, row stride in bytes, box columns, box rows

// A row-major bf16 matrix as a 2-D map of 64-column boxes, 128-byte swizzled;
// rows and columns past the extent read as zero.
bool encode_matrix(idt_tma::EncodeTiled enc, CUtensorMap* map, const long long* a) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(a[1]), static_cast<cuuint64_t>(a[2])};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(a[3])};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(a[4]), static_cast<cuuint32_t>(a[5])};
    const cuuint32_t estr[2] = {1, 1};
    if (box[0] != 64) return false;
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, reinterpret_cast<void*>(a[0]), dims,
               strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}


// the x, w1 and w2 boxes the plan chose must be the ones the kernel loads
// (kernels/geglu_ff.py::ff_plan), and the inner width whole turns
template <int C>
int launch_checked(const idt_ff::Launch& a, const long long* maps) {
    if (a.p.I % idt_ff::turn_cols<C>() || maps[5] != idt_ff::kRows || maps[kMapArgs + 5] != idt_ff::w1_box_rows<C>() ||
        maps[2 * kMapArgs + 5] != idt_ff::w2_box_rows<C>())
        return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(idt_ff::launch<C>(a));
}

}  // namespace

// maps: 3 x 6 int64 plan values for x (M, C; box of a block's 64 rows), w1
// (2I, C) and w2 (C, I; boxes of one ring slot's rows), all bf16
// and contiguous. out: (M, C) bf16. b1 (2I,), b2 (C,): both bf16 (bias_fp32
// = 0) or both fp32 (1), read as stored. Requires C in {64, 128, 320, 640,
// 768} and I a multiple of the kernel's turn width (64; 128 at C = 640, 192
// at C = 768); other
// shapes return cudaErrorInvalidValue.
IDT_EXPORT int idt_geglu_ff(const long long* maps, const void* b1, const void* b2, void* out,
                            int M, int C, int I, int bias_fp32, void* stream) {
    if (M <= 0 || I <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const idt_tma::EncodeTiled enc = idt_tma::encoder();
    if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
    idt_ff::Launch a{};
    if (!(encode_matrix(enc, &a.tx, maps) && encode_matrix(enc, &a.tw1, maps + kMapArgs) &&
          encode_matrix(enc, &a.tw2, maps + 2 * kMapArgs)))
        return static_cast<int>(cudaErrorInvalidValue);
    a.p.out = static_cast<__nv_bfloat16*>(out);
    a.p.b1 = b1;
    a.p.b2 = b2;
    a.p.bias_fp32 = bias_fp32;
    a.p.M = M;
    a.p.I = I;
    a.stream = static_cast<cudaStream_t>(stream);
    switch (C) {
        case 64: return launch_checked<64>(a, maps);
        case 128: return launch_checked<128>(a, maps);
        case 320: return launch_checked<320>(a, maps);
        case 640: return launch_checked<640>(a, maps);
        case 768: return launch_checked<768>(a, maps);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
