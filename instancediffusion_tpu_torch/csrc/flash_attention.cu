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
//
// Under labels, the wrapper first launches the tile plan (tile_plan_kernel
// below, on the same stream, no host sync): the label words the kernel reads
// and, for each (batch row, 128-row q block), the key tiles that keep a score.
#include <algorithm>
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

// (B, label_stride) int32 label words, 128 keys per box
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

constexpr int kPlanThreads = 256;
constexpr int kPlanWarps = kPlanThreads / 32;
constexpr int kSummary = 8;  // ints per 128-position chunk in shared memory

// One block per batch row. (1) The label words: bits | bit 31 where open.
// (2) For each 128-position chunk, over its positions below N (as q rows)
// and below kv_len (as keys): the OR of the bits, the AND of the bits of
// positions that are not open, and flags 1 = some position open, 2 = some
// not open. (3) For each q block qb and key tile t, from those summaries:
//   listed: some row open, or some key open, or (OR_q & OR_k) != 0 (a row
//     and a key share a bit), or t == qb (the diagonal);
//   full:   t does not straddle kv_len, and no row or no key is closed, or
//     (AND_q & AND_k) != 0 (every closed row shares a bit with every closed key);
//   edge:   listed, not full, and t == qb or t straddles kv_len; else words.
// `listed` is exact: it holds iff some score of the tile is kept. `full`
// implies that every score is kept. The plan row is [n listed, end of the
// word tiles, end of the full tiles, 0, then the diagonal's edge tile, the
// word tiles, the full tiles (each part ascending), the straddling edge
// tile, -1 ...] (a diagonal tile that also straddles goes first).
// counter (optional): += tiles listed, tiles in the grid (q blocks x tiles).
__global__ void __launch_bounds__(kPlanThreads)
    tile_plan_kernel(const int* bits, const int* open, int stride, int N, int kv_len,
                     int qblocks, int tiles, int chunks, int* words, int* plan,
                     unsigned long long* counter) {
    extern __shared__ unsigned summary[];
    const int b = blockIdx.x;
    const int* bb = bits + (long long)b * stride;
    const int* ob = open + (long long)b * stride;
    int* wb = words + (long long)b * stride;
    for (int j = threadIdx.x; j < stride; j += kPlanThreads)
        wb[j] = bb[j] | (ob[j] > 0 ? idt_fa::kOpenBit : 0);

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int span = max(N, kv_len);
    for (int c = warp; c < chunks; c += kPlanWarps) {
        unsigned qor = 0, qand = ~0u, qf = 0, kor = 0, kand = ~0u, kf = 0;
        for (int e = 0; e < idt_fa::kBK / 32; ++e) {
            const int pos = c * idt_fa::kBK + e * 32 + lane;
            if (pos >= span) break;
            const unsigned x = static_cast<unsigned>(bb[pos]);
            const bool op = ob[pos] > 0;
            if (pos < N) {
                qor |= x;
                qf |= op ? 1u : 2u;
                if (!op) qand &= x;
            }
            if (pos < kv_len) {
                kor |= x;
                kf |= op ? 1u : 2u;
                if (!op) kand &= x;
            }
        }
        qor = __reduce_or_sync(~0u, qor);
        qand = __reduce_and_sync(~0u, qand);
        qf = __reduce_or_sync(~0u, qf);
        kor = __reduce_or_sync(~0u, kor);
        kand = __reduce_and_sync(~0u, kand);
        kf = __reduce_or_sync(~0u, kf);
        if (lane == 0) {
            unsigned* sm = summary + c * kSummary;
            sm[0] = qor;
            sm[1] = qand;
            sm[2] = qf;
            sm[3] = kor;
            sm[4] = kand;
            sm[5] = kf;
        }
    }
    __syncthreads();

    const bool ragged = kv_len % idt_fa::kBK != 0;
    unsigned long long n_listed = 0;
    for (int qb = warp; qb < qblocks; qb += kPlanWarps) {
        const unsigned* sq = summary + qb * kSummary;
        const unsigned qor = sq[0], qand = sq[1], qf = sq[2];
        // 0 the diagonal's edge tile, 1 words, 2 full, 3 the straddling
        // edge tile, 4 not listed
        auto kind = [&](int t) {
            const unsigned* sk = summary + t * kSummary;
            const unsigned kor = sk[3], kand = sk[4], kf = sk[5];
            const bool diag = t == qb, straddle = ragged && t == tiles - 1;
            if (!straddle && (!(qf & 2u) || !(kf & 2u) || (qand & kand) != 0)) return 2;
            if (!((qf & 1u) || (kf & 1u) || (qor & kor) != 0 || diag)) return 4;
            return diag ? 0 : (straddle ? 3 : 1);
        };
        int* row = plan + ((long long)b * qblocks + qb) * (tiles + idt_fa::kPlanHead);
        int* list = row + idt_fa::kPlanHead;
        int n = 0, ends[4];
        for (int k = 0; k < 4; ++k) {
            for (int base = 0; base < tiles; base += 32) {
                const int t = base + lane;
                const bool hit = t < tiles && kind(t) == k;
                const unsigned m = __ballot_sync(~0u, hit);
                if (hit) list[n + __popc(m & ((1u << lane) - 1u))] = t;
                n += __popc(m);
            }
            ends[k] = n;
        }
        for (int i = n + lane; i < tiles; i += 32) list[i] = -1;
        if (lane == 0) {
            row[0] = n;
            row[1] = ends[1];
            row[2] = ends[2];
            row[3] = 0;
        }
        n_listed += n;
    }
    if (counter != nullptr) {
        if (lane == 0 && n_listed > 0) atomicAdd(counter, n_listed);
        if (threadIdx.x == 0)
            atomicAdd(counter + 1, static_cast<unsigned long long>(qblocks) * tiles);
    }
}

}  // namespace

// The tile plan of a labeled call (tile_plan_kernel): bits/open int32 (B,
// label_stride) with label_stride >= max(N, kv_len); words int32 (B,
// label_stride); plan int32 (B, ceil(N/128), ceil(kv_len/128) + 4); counter
// null or two uint64 (tiles listed, tiles in the grid) to add to.
IDT_EXPORT int idt_flash_tile_plan(const void* bits, const void* open, int label_stride, int B,
                                   int N, int kv_len, void* words, void* plan, void* counter,
                                   void* stream) {
    if (B < 1 || N < 1 || kv_len < 1 || label_stride < std::max(N, kv_len))
        return static_cast<int>(cudaErrorInvalidValue);
    const int qblocks = (N + idt_fa::kBQ - 1) / idt_fa::kBQ;
    const int tiles = (kv_len + idt_fa::kBK - 1) / idt_fa::kBK;
    const int chunks = std::max(qblocks, tiles);
    const size_t smem = static_cast<size_t>(chunks) * kSummary * sizeof(unsigned);
    if (smem > 48 * 1024) {
        const cudaError_t err = idt_allow_smem(tile_plan_kernel, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    tile_plan_kernel<<<B, kPlanThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(bits), static_cast<const int*>(open), label_stride, N, kv_len,
        qblocks, tiles, chunks, static_cast<int*>(words), static_cast<int*>(plan),
        static_cast<unsigned long long*>(counter));
    return static_cast<int>(cudaGetLastError());
}

// maps: 3 x 15 int64 plan values for q (rows N), k and v (rows kv_len).
// out_strides: (batch, head, row) element strides of o. lse: null, or fp32
// (B*H, N) log-sum-exp in base 2. words/plan: the tile plan's label words
// (int32, label_stride entries per batch row, a multiple of 4, covering
// max(N, kv_len) positions) and tile plans (idt_flash_tile_plan), or both
// null. Requires c % 8 == 0, c <= 128.
IDT_EXPORT int idt_flash_attention(const long long* maps, void* o, void* lse, const void* words,
                                   const void* plan, int label_stride, int B, int H, int N,
                                   int kv_len, int c, const long long* out_strides, float scale,
                                   void* stream) {
    if ((words == nullptr) != (plan == nullptr) || (words != nullptr && label_stride % 4))
        return static_cast<int>(cudaErrorInvalidValue);
    const EncodeTiled enc = encoder();
    if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
    idt_fa::Launch a{};
    const auto t0 = std::chrono::steady_clock::now();
    bool ok = encode_operand(enc, &a.tq, &a.p.q, maps) &&
              encode_operand(enc, &a.tk, &a.p.k, maps + kMapArgs) &&
              encode_operand(enc, &a.tv, &a.p.v, maps + 2 * kMapArgs);
    if (ok && words != nullptr) ok = encode_labels(enc, &a.twords, words, B, label_stride);
    g_encode_us =
        std::chrono::duration<double, std::micro>(std::chrono::steady_clock::now() - t0).count();
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    a.p.o = static_cast<__nv_bfloat16*>(o);
    a.p.lse = static_cast<float*>(lse);
    a.p.words = static_cast<const int*>(words);
    a.p.plan = static_cast<const int*>(plan);
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
    if (words != nullptr)
        err = lse != nullptr ? idt_fa::launch<true, true>(a) : idt_fa::launch<true, false>(a);
    else
        err = lse != nullptr ? idt_fa::launch<false, true>(a) : idt_fa::launch<false, false>(a);
    return static_cast<int>(err);
}

// Host microseconds the last idt_flash_attention call spent encoding its
// tensor maps.
IDT_EXPORT double idt_flash_encode_us() { return g_encode_us; }
