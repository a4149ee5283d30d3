// Host side of the backward flash-attention kernels (flash_bwd_sm90.cuh,
// instantiated in flash_bwd_{dq,dq_labeled,dkv,dkv_labeled}.cu): the TMA
// tensor maps and the C entry points.
//
// Replaces instancediffusion_tpu/kernels/flash_attention.py::_flash_bwd
// (_bwd_dq_kernel, _bwd_dkv_kernel, unlabeled and labeled); the kernels'
// header says what bounds them on the H100 (tensor-core FLOPs and the
// exponentials, about equally at c = 40) and how the design meets it.
//
// The Python wrapper (kernels/flash_attention.py: tma_plan, bwd_plan) derives
// each operand's 4-D map from its view and each launch's plan (streamed tile
// rows, ring stages, shared bytes); the launcher checks the plan against the
// kernel's own layout and refuses a mismatch. lse and delta are B*H rows of
// N fp32 values at a row stride that is a multiple of 4 (the wrapper pads a
// copy when N is not).
#include <chrono>

#include "flash_bwd_sm90.cuh"
#include "tma_host.cuh"

namespace {

using idt_tma::EncodeTiled;
using idt_tma::encoder;

constexpr int kMapArgs = 15;  // ptr, dims[4], byte strides[3], box[4], (head, row, batch) slots

// One bf16 operand map from its 15 plan values, 128-byte swizzled; the box
// must be 64 columns by `rows` rows.
bool encode_operand(EncodeTiled enc, CUtensorMap* map, idt_fb::MapOrder* order,
                    const long long* a, int rows) {
    cuuint64_t dims[4], strides[3];
    cuuint32_t box[4], estr[4] = {1, 1, 1, 1};
    for (int i = 0; i < 4; ++i) dims[i] = static_cast<cuuint64_t>(a[1 + i]);
    for (int i = 0; i < 3; ++i) strides[i] = static_cast<cuuint64_t>(a[5 + i]);
    for (int i = 0; i < 4; ++i) box[i] = static_cast<cuuint32_t>(a[8 + i]);
    *order = {static_cast<int>(a[12]), static_cast<int>(a[13]), static_cast<int>(a[14])};
    if (box[0] != 64 || order->row < 1 || order->row > 3 ||
        box[order->row] != static_cast<cuuint32_t>(rows))
        return false;
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, reinterpret_cast<void*>(a[0]), dims,
               strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// (B, label_stride) int32 labels, `rows` positions per box
bool encode_labels(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B, int stride,
                   int rows) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(stride), static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride) * 4};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(rows), 1}, estr[2] = {1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, const_cast<void*>(ptr), dims, strides, box,
               estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// (B*H, N) fp32 rows at row stride `stride` (a multiple of 4), `rows`
// values per box
bool encode_rows(EncodeTiled enc, CUtensorMap* map, const void* ptr, int bh, int n, int stride,
                 int rows) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(bh)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride) * 4};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(rows), 1}, estr[2] = {1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims, strides,
               box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

double g_encode_us = 0.0;

// What both entry points share: labels, sizes, plan, scale, stream.
bool common(idt_fb::Launch* a, const void* bits, const void* open, int label_stride, int B,
            int H, int N, int kv_len, int c, int rows, int stages, int smem, float scale,
            void* stream) {
    if ((bits == nullptr) != (open == nullptr) || (bits != nullptr && label_stride % 4) ||
        N < 1 || kv_len < 1)
        return false;
    a->p.bits = static_cast<const int*>(bits);
    a->p.open = static_cast<const int*>(open);
    a->p.label_stride = label_stride;
    a->p.H = H;
    a->p.N = N;
    a->p.kv_len = kv_len;
    a->p.scale = scale;
    a->p.sl2 = scale * idt_fb::kLog2e;
    a->B = B;
    a->c = c;
    a->plan[0] = rows;
    a->plan[1] = stages;
    a->plan[2] = smem;
    a->stream = static_cast<cudaStream_t>(stream);
    return true;
}

}  // namespace

// maps: 5 x 15 int64 plan values for q, dO and O (rows N, boxes of 128 rows)
// and k, v (rows kv_len, boxes of `rows` keys), in the order q, k, v, dO, O.
// lse: fp32, B*H rows of N at row stride lse_stride. delta: written with
// rowsum(dO * O) for the dk/dv kernel at row stride delta_stride, or null. dq: written through dq_strides (batch, head,
// row). bits/open: int32 labels, label_stride (a multiple of 4) entries per
// batch row covering max(N, kv_len) positions, or both null. rows, stages,
// smem: the plan (bwd_plan). Requires c % 8 == 0, c <= 128.
IDT_EXPORT int idt_flash_bwd_dq(const long long* maps, const void* lse, int lse_stride,
                                void* delta, int delta_stride, void* dq,
                                const long long* dq_strides, const void* bits, const void* open,
                                int label_stride, int B, int H, int N, int kv_len, int c,
                                int rows, int stages, int smem, float scale, void* stream) {
    idt_fb::Launch a{};
    if (!common(&a, bits, open, label_stride, B, H, N, kv_len, c, rows, stages, smem, scale,
                stream))
        return static_cast<int>(cudaErrorInvalidValue);
    const EncodeTiled enc = encoder();
    if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const auto t0 = std::chrono::steady_clock::now();
    bool ok = encode_operand(enc, &a.tq, &a.p.q, maps, 128) &&
              encode_operand(enc, &a.tk, &a.p.k, maps + kMapArgs, rows) &&
              encode_operand(enc, &a.tv, &a.p.v, maps + 2 * kMapArgs, rows) &&
              encode_operand(enc, &a.tdo, &a.p.dout, maps + 3 * kMapArgs, 128) &&
              encode_operand(enc, &a.to, &a.p.o, maps + 4 * kMapArgs, 128);
    if (ok && bits != nullptr)
        ok = encode_labels(enc, &a.tbits, bits, B, label_stride, rows) &&
             encode_labels(enc, &a.topen, open, B, label_stride, rows);
    g_encode_us =
        std::chrono::duration<double, std::micro>(std::chrono::steady_clock::now() - t0).count();
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    a.p.g0 = static_cast<__nv_bfloat16*>(dq);
    a.p.lse = static_cast<const float*>(lse);
    a.p.delta = static_cast<float*>(delta);
    a.p.lse_stride = lse_stride;
    a.p.delta_stride = delta_stride;
    for (int i = 0; i < 3; ++i) a.p.gs[i] = dq_strides[i];
    const cudaError_t err =
        bits != nullptr ? idt_fb::launch<false, true>(a) : idt_fb::launch<false, false>(a);
    return static_cast<int>(err);
}

// maps: 4 x 15 int64 plan values for q, dO (rows N, boxes of `rows` q rows)
// and k, v (rows kv_len, boxes of the block's keys), in the order q, k, v,
// dO. lse, delta: fp32, B*H rows of N at row strides lse_stride and
// delta_stride, each a multiple of 4. dk, dv: written through
// strides (batch, head, row of dk, then of dv). Labels and plan as for
// idt_flash_bwd_dq.
IDT_EXPORT int idt_flash_bwd_dkv(const long long* maps, const void* lse, int lse_stride,
                                 const void* delta, int delta_stride, void* dk, void* dv, const long long* strides, const void* bits,
                                 const void* open, int label_stride, int B, int H, int N,
                                 int kv_len, int c, int rows, int stages, int smem, float scale,
                                 void* stream) {
    idt_fb::Launch a{};
    if (!common(&a, bits, open, label_stride, B, H, N, kv_len, c, rows, stages, smem, scale,
                stream))
        return static_cast<int>(cudaErrorInvalidValue);
    const EncodeTiled enc = encoder();
    if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const int block_keys = c <= 96 ? 128 : 64;
    const auto t0 = std::chrono::steady_clock::now();
    bool ok = encode_operand(enc, &a.tq, &a.p.q, maps, rows) &&
              encode_operand(enc, &a.tk, &a.p.k, maps + kMapArgs, block_keys) &&
              encode_operand(enc, &a.tv, &a.p.v, maps + 2 * kMapArgs, block_keys) &&
              encode_operand(enc, &a.tdo, &a.p.dout, maps + 3 * kMapArgs, rows) &&
              encode_rows(enc, &a.tlse, lse, B * H, N, lse_stride, rows) &&
              encode_rows(enc, &a.tdelta, delta, B * H, N, delta_stride, rows);
    if (ok && bits != nullptr)
        ok = encode_labels(enc, &a.tbits, bits, B, label_stride, rows) &&
             encode_labels(enc, &a.topen, open, B, label_stride, rows);
    g_encode_us =
        std::chrono::duration<double, std::micro>(std::chrono::steady_clock::now() - t0).count();
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    a.p.g0 = static_cast<__nv_bfloat16*>(dk);
    a.p.g1 = static_cast<__nv_bfloat16*>(dv);
    for (int i = 0; i < 6; ++i) a.p.gs[i] = strides[i];
    const cudaError_t err =
        bits != nullptr ? idt_fb::launch<true, true>(a) : idt_fb::launch<true, false>(a);
    return static_cast<int>(err);
}

// Host microseconds the last backward launch spent encoding its tensor maps.
IDT_EXPORT double idt_flash_bwd_encode_us() { return g_encode_us; }
