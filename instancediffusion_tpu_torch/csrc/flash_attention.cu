// Host side of the forward flash-attention kernel (flash_fwd_sm90.cuh): the
// TMA tensor maps and the C entry point.
//
// Replaces instancediffusion_tpu/kernels/flash_attention.py::flash_attention,
// ::flash_attention_packed (with and without labels) and _fwd_with_stats; the
// kernel's header says what bounds it (the exponentials, at c = 40) and how
// its design answers that.
//
// The Python wrapper (kernels/flash_attention.py::tma_plan) derives each
// operand's map: its dims (head dim first, then batch, head and row in order
// of stride), byte strides, box and where (head, row, batch) sit among the
// coordinates. This file encodes them with cuTensorMapEncodeTiled (tma_host.cuh) and
// passes them to the kernel as __grid_constant__ parameters.
#include <chrono>

#include "flash_fwd_sm90.cuh"
#include "tma_host.cuh"

namespace {

using idt_tma::EncodeTiled;
using idt_tma::encoder;

constexpr int kMapArgs = 15;  // ptr, dims[4], byte strides[3], box[4], (head, row, batch) slots

// One bf16 operand map from its 15 plan values, 128-byte swizzled; the box
// must be 64 columns by the kernel's 128 rows.
bool encode_operand(EncodeTiled enc, CUtensorMap* map, idt_fa::MapOrder* order,
                    const long long* a) {
    cuuint64_t dims[4], strides[3];
    cuuint32_t box[4], estr[4] = {1, 1, 1, 1};
    for (int i = 0; i < 4; ++i) dims[i] = static_cast<cuuint64_t>(a[1 + i]);
    for (int i = 0; i < 3; ++i) strides[i] = static_cast<cuuint64_t>(a[5 + i]);
    for (int i = 0; i < 4; ++i) box[i] = static_cast<cuuint32_t>(a[8 + i]);
    *order = {static_cast<int>(a[12]), static_cast<int>(a[13]), static_cast<int>(a[14])};
    if (box[0] != 64 || box[order->row] != idt_fa::kBK) return false;
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, reinterpret_cast<void*>(a[0]), dims,
               strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// (B, label_stride) int32 labels, 128 keys per box
bool encode_labels(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B, int stride) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(stride), static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride) * 4};
    const cuuint32_t box[2] = {idt_fa::kBK, 1}, estr[2] = {1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, const_cast<void*>(ptr), dims, strides, box,
               estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

double g_encode_us = 0.0;

}  // namespace

// maps: 3 x 15 int64 plan values for q (rows N), k and v (rows kv_len).
// out_strides: (batch, head, row) element strides of o. lse: null, or fp32
// (B*H, N) log-sum-exp in base 2. bits/open: int32 instance labels,
// label_stride entries per batch row (a multiple of 4) covering max(N,
// kv_len) positions, or both null. Requires c % 8 == 0, c <= 128.
IDT_EXPORT int idt_flash_attention(const long long* maps, void* o, void* lse, const void* bits,
                                   const void* open, int label_stride, int B, int H, int N,
                                   int kv_len, int c, const long long* out_strides, float scale,
                                   void* stream) {
    if ((bits == nullptr) != (open == nullptr) || (bits != nullptr && label_stride % 4))
        return static_cast<int>(cudaErrorInvalidValue);
    const EncodeTiled enc = encoder();
    if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
    idt_fa::Launch a{};
    const auto t0 = std::chrono::steady_clock::now();
    bool ok = encode_operand(enc, &a.tq, &a.p.q, maps) &&
              encode_operand(enc, &a.tk, &a.p.k, maps + kMapArgs) &&
              encode_operand(enc, &a.tv, &a.p.v, maps + 2 * kMapArgs);
    if (ok && bits != nullptr)
        ok = encode_labels(enc, &a.tbits, bits, B, label_stride) &&
             encode_labels(enc, &a.topen, open, B, label_stride);
    g_encode_us =
        std::chrono::duration<double, std::micro>(std::chrono::steady_clock::now() - t0).count();
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    a.p.o = static_cast<__nv_bfloat16*>(o);
    a.p.lse = static_cast<float*>(lse);
    a.p.qbits = static_cast<const int*>(bits);
    a.p.qopen = static_cast<const int*>(open);
    a.p.osb = out_strides[0];
    a.p.osh = out_strides[1];
    a.p.osr = out_strides[2];
    a.p.label_stride = label_stride;
    a.p.H = H;
    a.p.N = N;
    a.p.kv_len = kv_len;
    a.p.sl2 = scale * idt_fa::kLog2e;
    a.B = B;
    a.c = c;
    a.stream = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (bits != nullptr)
        err = lse != nullptr ? idt_fa::launch<true, true>(a) : idt_fa::launch<true, false>(a);
    else
        err = lse != nullptr ? idt_fa::launch<false, true>(a) : idt_fa::launch<false, false>(a);
    return static_cast<int>(err);
}

// Host microseconds the last idt_flash_attention call spent encoding its
// tensor maps.
IDT_EXPORT double idt_flash_encode_us() { return g_encode_us; }
