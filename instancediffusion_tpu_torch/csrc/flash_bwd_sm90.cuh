// The backward flash-attention kernels for Hopper: a dq kernel and a dk/dv
// kernel, TMA loads fed by one producer thread, wgmma products in consumer
// warpgroups of 64 rows, no atomics.
//
// Replaces instancediffusion_tpu/kernels/flash_attention.py::_flash_bwd:
// _bwd_dq_kernel and _bwd_dkv_kernel, unlabeled (behind
// flash_attention_trainable) and with labeled=True (template flag LABELED,
// behind flash_attention_trainable_labeled: score (i, j) of q row i and key
// j, both sequence positions, is kept iff open_i | open_j | (bits_i &
// bits_j) != 0 | i == j, the forward's predicate).
//
// Inputs: q, k, v, dO (bf16, unscaled q, read in place through 4-D TMA
// tensor maps over their (batch, head, row) views), the forward's fp32
// log-sum-exp lse (base 2 of the scaled scores, flash_fwd_sm90.cuh) and, for
// dk/dv, delta = rowsum(dO * O) in fp32, both B*H rows of N values whose row
// stride is a multiple of 4 (16 bytes, as a tensor map needs). With s = q k^T:
//   p  = exp2(s * scale * log2(e) - lse)     (the forward's probabilities)
//   dp = dO v^T,  ds = p * (dp - delta)
//   dq = scale * ds k,  dk = scale * ds^T q,  dv = p^T dO
// p is rounded to bf16 before p^T dO and ds before its two products, as the
// TPU kernels round them to the input type. A masked pair (labels, a key at
// or past kv_len, a q row at or past N) gives 0 by a select, so a row with
// no kept key (lse = -inf) gives 0 and never NaN.
//
// What bounds them. Per (q row, key) pair dq does 6c tensor-core FLOPs and
// dk/dv 8c, against one exp2 each (16 per clock per SM) and a few FP32
// operations: at c = 40 the products, the exponentials and the FP32 work
// each take a comparable share, all far above the operands' bytes. A
// warpgroup's step is a chain (score products, then exponentials, then the
// accumulating products), so the design keeps two consumer warpgroups per
// block and every product on wgmma:
//   - a block owns 128 rows (64 per consumer warpgroup; 64 rows and one
//     warpgroup for a dk/dv head dim above 96, where dK and dV alone take 128
//     registers a thread): dq owns q rows with Q, dO and O resident, dk/dv
//     owns keys with K and V resident, each loaded once by TMA;
//   - one producer thread streams the other side (dq: K and V tiles of 64
//     keys, 32 above c = 96, with their key labels; dk/dv: Q and dO tiles of
//     64 q rows at c <= 48, 32 above, with their lse, delta and q labels)
//     through a ring of mbarrier stages, so loads never wait on the products;
//   - the score products (S = Q K^T, dP = dO V^T; for dk/dv S^T = K Q^T and
//     dP^T = V dO^T) are one wgmma batch from shared memory, K-major, depth
//     c rounded up to 16 by TMA's zero fill; the accumulating products take
//     P^T and dS^T (dq: dS) from registers, converted from the score
//     accumulators as the forward converts P for P V, and the streamed tile
//     (dk/dv: dO and Q; dq: K) read MN-major, N = c with no padded column;
//   - dq issues tile n-1's dQ product in the same batch as tile n's score
//     products, and its two warpgroups take turns on named barriers to issue
//     them, so one warpgroup's exponentials run under the other's products
//     (17 % less time at ds1 on an H100 than a step that waits for each
//     product). dk/dv keeps the plain step: its P^T and dS^T fragments held
//     across the next tile's score products spill in the labeled kernels at
//     c = 40 and 80, and it was no faster that way (PERF.md);
//   - exponentials as one FFMA and ex2.approx.ftz; the dq kernel also
//     computes delta for its rows from the resident O and dO tiles (both
//     128-byte swizzled alike, so a row's bytes pair up in place) and writes
//     it for the dk/dv kernel that follows on the same stream.
// Each block owns its outputs, so the sums are deterministic. Every wgmma
// batch is fenced, committed and waited for with no register of it written
// in between, and masked and unmasked steps run in separate loops chosen by
// trip counts (a register written inside a batch, or a branch between step
// variants inside a loop, makes ptxas serialise every wgmma: C7513 / C7515).
#pragma once

#include <type_traits>

#include "sm90.cuh"

namespace idt_fb {

constexpr int kSmall = 256;  // a stage's slot for one tile's lse, delta, bits or open
constexpr int kMaskNone = 0, kMaskEdge = 1, kMaskLabels = 2;
constexpr int kBarTurn = 1;  // named barriers 1, 2: the consumer warpgroups' turns
constexpr int kBarVote = 3;  // named barriers 3, 4: each consumer warpgroup's vote
constexpr float kLog2e = 1.4426950408889634f;

// consumer warpgroups of a dk/dv block (one above c = 96: dK and dV alone
// take c registers a thread) and of a dq block
template <int C>
__host__ __device__ constexpr int dkv_warpgroups() {
    return C <= 96 ? 2 : 1;
}
// rows of a streamed tile: q rows (dk/dv), keys (dq)
template <int C>
__host__ __device__ constexpr int dkv_tile_rows() {
    return C <= 48 ? 64 : 32;
}
template <int C>
__host__ __device__ constexpr int dq_tile_rows() {
    return C <= 96 ? 64 : 32;
}

// Where (head, row, batch) go among a tensor map's coordinates 1..3.
struct MapOrder {
    int head, row, batch;
};

// Shared memory of one block: RES resident operands of BR rows, then a ring
// of stages of two streamed tiles of T rows and SMALLS small slots, then the
// mbarriers. Every operand is 64-column atoms with the 128-byte swizzle.
template <int C, int BR, int T, int RES, int SMALLS>
struct Layout {
    static constexpr int ATOMS = (C + 63) / 64;
    static constexpr int KD = (C + 15) / 16;  // k-steps of a score product
    static constexpr int res_atom = BR * 128;
    static constexpr int tile_atom = T * 128;
    static constexpr int tile_bytes = ATOMS * tile_atom;
    static constexpr int res_bytes = RES * ATOMS * res_atom;
    static constexpr int stage_bytes = (2 * tile_bytes + SMALLS * kSmall + 1023) / 1024 * 1024;
    static constexpr int stage_tx = 2 * tile_bytes + SMALLS * T * 4;
    static constexpr int small_off = 2 * tile_bytes;
    static constexpr int stages_fit = (200 * 1024 - res_bytes) / stage_bytes;
    static constexpr int stages = stages_fit < 4 ? stages_fit : 4;
    static_assert(stages >= 2, "two ring stages must fit");
    static constexpr int bars = res_bytes + stages * stage_bytes;
    // + 1 KB to align the base: the 128-byte swizzle repeats every 1024 bytes
    static constexpr int bytes = bars + (2 * stages + 1) * 8 + 1024;
};

template <int C, bool LABELED>
using DqLayout = Layout<C, 128, dq_tile_rows<C>(), 3, LABELED ? 2 : 0>;
template <int C, bool LABELED>
using DkvLayout =
    Layout<C, 64 * dkv_warpgroups<C>(), dkv_tile_rows<C>(), 2, LABELED ? 4 : 2>;

struct Params {
    __nv_bfloat16* g0;  // dq: dq; dk/dv: dk
    __nv_bfloat16* g1;  // dk/dv: dv
    const float* lse;   // dq: read per row
    float* delta;       // dq: written for the dk/dv kernel (or null)
    const int* bits;    // labels, (B, label_stride) int32
    const int* open;
    long long gs[6];  // (batch, head, row) element strides of g0, then g1
    int label_stride, H, N, kv_len;
    int lse_stride, delta_stride;  // dq: row strides of lse and delta (B*H rows of N)
    MapOrder q, k, v, dout, o;
    float scale, sl2;  // scale, scale * log2(e)
};

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ int pick(const MapOrder& o, int slot, int h, int r, int b) {
    return o.head == slot ? h : (o.row == slot ? r : b);
}

// rows r .. of an operand: one TMA box per 64-column atom
__device__ __forceinline__ void load_rows(unsigned char* dst, const CUtensorMap* map, uint64_t* bar,
                                          int atoms, int atom_bytes, const MapOrder& o, int h,
                                          int r, int b) {
    const int c1 = pick(o, 1, h, r, b), c2 = pick(o, 2, h, r, b), c3 = pick(o, 3, h, r, b);
    for (int a = 0; a < atoms; ++a)
        tma_load_4d(dst + a * atom_bytes, map, bar, a * 64, c1, c2, c3);
}

// K-major operand (rows = M or N, columns = the depth c): k-step kk
__device__ __forceinline__ uint64_t desc_k(uint32_t base, int kk, int atom_bytes) {
    return wgmma_desc_sw128(base + (kk / 4) * atom_bytes + (kk % 4) * 32, 16, 1024);
}

// MN-major B operand (rows = the depth, columns = N = c): depth step kc of 16
// rows; the next 64 columns are the next atom
__device__ __forceinline__ uint64_t desc_mn(uint32_t base, int kc, int atom_bytes) {
    return wgmma_desc_sw128(base + kc * 16 * 128, atom_bytes, 1024);
}

__device__ __forceinline__ bool label_keep(int bits_i, int open_i, int bits_j, int open_j, int i,
                                           int j) {
    return (open_i | open_j) > 0 || (bits_i & bits_j) != 0 || i == j;
}

template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) reg_fence(r[i]);
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) reg_fence(r[i][e]);
}

template <int N>
__device__ __forceinline__ void pin(uint64_t (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) reg_fence(r[i]);
}

// bf16 dot product of the 128-byte rows at a and b (same swizzle, so the
// pieces pair up wherever the swizzle put them): pieces t and t + 4
__device__ __forceinline__ float row_dot(const unsigned char* a, const unsigned char* b, int t) {
    float acc = 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        const uint4 x = *reinterpret_cast<const uint4*>(a + (t + 4 * hh) * 16);
        const uint4 y = *reinterpret_cast<const uint4*>(b + (t + 4 * hh) * 16);
        const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 xf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[i]));
            const float2 yf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ys[i]));
            acc = fmaf(xf.x, yf.x, acc);
            acc = fmaf(xf.y, yf.y, acc);
        }
    }
    return acc;
}

// Store a warpgroup's 64 x C fp32 accumulator (rows lo, lo + 8 of this lane)
// times mul as bf16 through (batch, head, row) strides; rows >= limit are not
// written.
template <int C>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long row_stride,
                                           const float (&acc)[C / 2], int row_lo, int limit,
                                           int t, float mul) {
    const int row_hi = row_lo + 8;
#pragma unroll
    for (int d = 0; d < C / 8; ++d) {
        const int col = d * 8 + 2 * t;
        if (row_lo < limit)
            *reinterpret_cast<__nv_bfloat162*>(base + (long long)row_lo * row_stride + col) =
                __floats2bfloat162_rn(acc[4 * d] * mul, acc[4 * d + 1] * mul);
        if (row_hi < limit)
            *reinterpret_cast<__nv_bfloat162*>(base + (long long)row_hi * row_stride + col) =
                __floats2bfloat162_rn(acc[4 * d + 2] * mul, acc[4 * d + 3] * mul);
    }
}

// ---------------------------------------------------------------------------
// dk/dv: a block owns 64 keys per consumer warpgroup; Q, dO, lse, delta (and
// the q labels) stream by q tiles of T rows.
// ---------------------------------------------------------------------------

template <int C, bool LABELED>
__global__ void __launch_bounds__(128 * (dkv_warpgroups<C>() + 1), 1)
    flash_bwd_dkv_sm90(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tlse,
                       const __grid_constant__ CUtensorMap tdelta,
                       const __grid_constant__ CUtensorMap tbits,
                       const __grid_constant__ CUtensorMap topen, const Params p) {
    constexpr int NWG = dkv_warpgroups<C>();
    constexpr int BR = 64 * NWG;
    constexpr int T = dkv_tile_rows<C>();
    using L = DkvLayout<C, LABELED>;
    constexpr int S = L::stages;
    constexpr int KD = L::KD;
    constexpr int KC = T / 16;  // depth steps of dV += P^T dO
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
    uint64_t* empty = full + S;
    uint64_t* kvbar = empty + S;
    const int bh = blockIdx.y;
    const int b = bh / p.H;
    const int h = bh % p.H;
    const int k0 = blockIdx.x * BR;
    const int tiles = (p.N + T - 1) / T;
    const int wg = threadIdx.x / 128;

    if (threadIdx.x == 0) {
        for (int s = 0; s < S; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 128 * NWG);
        }
        mbar_init(kvbar, 1);
        mbar_fence_init();
    }
    __syncthreads();

    if (wg == 0) {
        // producer: one thread issues every TMA load
        reg_dealloc<40>();
        if (threadIdx.x == 0) {
            mbar_expect_tx(kvbar, L::res_bytes);
            load_rows(smem, &tk, kvbar, L::ATOMS, L::res_atom, p.k, h, k0, b);
            load_rows(smem + L::ATOMS * L::res_atom, &tv, kvbar, L::ATOMS, L::res_atom, p.v, h,
                      k0, b);
            for (int n = 0; n < tiles; ++n) {
                const int s = n % S;
                if (n >= S) mbar_wait(&empty[s], ((n / S) - 1) & 1);
                unsigned char* st = smem + L::res_bytes + s * L::stage_bytes;
                mbar_expect_tx(&full[s], L::stage_tx);
                load_rows(st, &tq, &full[s], L::ATOMS, L::tile_atom, p.q, h, n * T, b);
                load_rows(st + L::tile_bytes, &tdo, &full[s], L::ATOMS, L::tile_atom, p.dout, h,
                          n * T, b);
                // lse and delta: (N, B*H) maps, rows past N read as zero
                tma_load_2d(st + L::small_off, &tlse, &full[s], n * T, bh);
                tma_load_2d(st + L::small_off + kSmall, &tdelta, &full[s], n * T, bh);
                if constexpr (LABELED) {
                    tma_load_2d(st + L::small_off + 2 * kSmall, &tbits, &full[s], n * T, b);
                    tma_load_2d(st + L::small_off + 3 * kSmall, &topen, &full[s], n * T, b);
                }
            }
        }
    } else {
        reg_alloc<232>();
        const int wgi = wg - 1;
        const int tid = threadIdx.x - 128 * wg;
        const int warp = tid >> 5, lane = tid & 31;
        const int g = lane >> 2, t = lane & 3;
        const int key_lo = k0 + wgi * 64 + warp * 16 + g, key_hi = key_lo + 8;

        // keys past kv_len are never stored: they count as open, so they do
        // not keep a warpgroup from skipping the labels
        int kb_lo = 0, ko_lo = 1, kb_hi = 0, ko_hi = 1;
        if constexpr (LABELED) {
            const int* bb = p.bits + (long long)b * p.label_stride;
            const int* ob = p.open + (long long)b * p.label_stride;
            if (key_lo < p.kv_len) {
                kb_lo = bb[key_lo];
                ko_lo = ob[key_lo];
            }
            if (key_hi < p.kv_len) {
                kb_hi = bb[key_hi];
                ko_hi = ob[key_hi];
            }
        }
        // a warpgroup whose keys are all open keeps every pair and need not
        // read the q labels
        bool wg_open = !LABELED;
        if constexpr (LABELED) wg_open = named_bar_all(kBarVote + wgi, 128, ko_lo > 0 && ko_hi > 0);

        float dk[C / 2], dv[C / 2];
#pragma unroll
        for (int i = 0; i < C / 2; ++i) dk[i] = dv[i] = 0.f;
        float sacc[T / 2], dpacc[T / 2];
        uint32_t pf[KC][4], dsf[KC][4];

        const uint32_t sk = smem_u32(smem) + wgi * 64 * 128;  // this warpgroup's keys
        const uint32_t sv = sk + L::ATOMS * L::res_atom;
        const uint32_t sring = smem_u32(smem) + L::res_bytes;
        uint64_t ak[KD], av[KD];
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
            ak[kk] = desc_k(sk, kk, L::res_atom);
            av[kk] = desc_k(sv, kk, L::res_atom);
        }
        mbar_wait(kvbar, 0);

        auto step = [&](const int n, auto mask_kind) {
            constexpr int MASK = decltype(mask_kind)::value;
            const int s = n % S;
            const uint32_t st = sring + s * L::stage_bytes;
            mbar_wait(&full[s], (n / S) & 1);
            // S^T = K Q^T and dP^T = V dO^T, one batch
            uint64_t bq[KD], bdo[KD];
#pragma unroll
            for (int kk = 0; kk < KD; ++kk) {
                bq[kk] = desc_k(st, kk, L::tile_atom);
                bdo[kk] = desc_k(st + L::tile_bytes, kk, L::tile_atom);
            }
            pin(bq);
            pin(bdo);
            pin(ak);
            pin(av);
            pin(sacc);
            pin(dpacc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < KD; ++kk) wgmma_ss<T>(sacc, ak[kk], bq[kk], kk > 0);
#pragma unroll
            for (int kk = 0; kk < KD; ++kk) wgmma_ss<T>(dpacc, av[kk], bdo[kk], kk > 0);
            wgmma_commit();
            wgmma_wait<0>();
            pin(sacc);
            pin(dpacc);

            // P^T and dS^T (rows = keys, columns = q rows of the tile)
            const unsigned char* small = smem + L::res_bytes + s * L::stage_bytes + L::small_off;
            const float* sl = reinterpret_cast<const float*>(small);
            const float* sd = reinterpret_cast<const float*>(small + kSmall);
            const int* lbits = reinterpret_cast<const int*>(small + 2 * kSmall);
            const int* lopen = reinterpret_cast<const int*>(small + 3 * kSmall);
#pragma unroll
            for (int j = 0; j < T / 8; ++j) {
                const int col = 8 * j + 2 * t;
                const float2 lse2 = *reinterpret_cast<const float2*>(sl + col);
                const float2 del2 = *reinterpret_cast<const float2*>(sd + col);
                float pv[4], dsv[4];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const float lse = e ? lse2.y : lse2.x;
                    const float del = e ? del2.y : del2.x;
                    const int qi = n * T + col + e;
                    bool keep_lo = true, keep_hi = true;
                    if constexpr (MASK != kMaskNone) {
                        keep_lo = keep_hi = qi < p.N;
                        if constexpr (MASK == kMaskLabels) {
                            const int qb = lbits[col + e], qo = lopen[col + e];
                            keep_lo = keep_lo && label_keep(qb, qo, kb_lo, ko_lo, qi, key_lo);
                            keep_hi = keep_hi && label_keep(qb, qo, kb_hi, ko_hi, qi, key_hi);
                        }
                    }
                    const float p_lo = keep_lo ? ex2(fmaf(sacc[4 * j + e], p.sl2, -lse)) : 0.f;
                    const float p_hi = keep_hi ? ex2(fmaf(sacc[4 * j + 2 + e], p.sl2, -lse)) : 0.f;
                    pv[e] = p_lo;
                    pv[2 + e] = p_hi;
                    dsv[e] = p_lo * (dpacc[4 * j + e] - del);
                    dsv[2 + e] = p_hi * (dpacc[4 * j + 2 + e] - del);
                }
                pf[j / 2][2 * (j % 2)] = pack_bf16(pv[0], pv[1]);
                pf[j / 2][2 * (j % 2) + 1] = pack_bf16(pv[2], pv[3]);
                dsf[j / 2][2 * (j % 2)] = pack_bf16(dsv[0], dsv[1]);
                dsf[j / 2][2 * (j % 2) + 1] = pack_bf16(dsv[2], dsv[3]);
            }

            // dV += P^T dO and dK += dS^T Q, dO and Q read MN-major
            uint64_t mdo[KC], mq[KC];
#pragma unroll
            for (int kc = 0; kc < KC; ++kc) {
                mdo[kc] = desc_mn(st + L::tile_bytes, kc, L::tile_atom);
                mq[kc] = desc_mn(st, kc, L::tile_atom);
            }
            pin(mdo);
            pin(mq);
            pin(pf);
            pin(dsf);
            pin(dk);
            pin(dv);
            wgmma_fence();
#pragma unroll
            for (int kc = 0; kc < KC; ++kc) wgmma_rs<C>(dv, pf[kc], mdo[kc]);
#pragma unroll
            for (int kc = 0; kc < KC; ++kc) wgmma_rs<C>(dk, dsf[kc], mq[kc]);
            wgmma_commit();
            wgmma_wait<0>();
            pin(dk);
            pin(dv);
            pin(pf);
            pin(dsf);
            mbar_arrive(&empty[s]);
        };
        // Full q tiles need no mask, unless the warpgroup has keys that are
        // not open under labels; a ragged last tile masks q rows >= N. Each
        // loop runs whole steps of one variant, chosen by trip counts.
        const int full_tiles = wg_open ? p.N / T : 0;
        for (int n = 0; n < full_tiles; ++n) step(n, std::integral_constant<int, kMaskNone>{});
        const int edge_end = wg_open ? tiles : 0;
        for (int n = full_tiles; n < edge_end; ++n)
            step(n, std::integral_constant<int, kMaskEdge>{});
        if constexpr (LABELED)
            for (int n = edge_end; n < tiles; ++n)
                step(n, std::integral_constant<int, kMaskLabels>{});

        store_rows<C>(p.g0 + b * p.gs[0] + h * p.gs[1], p.gs[2], dk, key_lo, p.kv_len, t,
                      p.scale);
        store_rows<C>(p.g1 + b * p.gs[3] + h * p.gs[4], p.gs[5], dv, key_lo, p.kv_len, t, 1.f);
    }
}

// ---------------------------------------------------------------------------
// dq: a block owns 128 q rows (64 per consumer warpgroup) with Q, dO and O
// resident; K and V (and the key labels) stream by key tiles of T rows.
// ---------------------------------------------------------------------------

template <int C, bool LABELED>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap to,
                      const __grid_constant__ CUtensorMap tbits,
                      const __grid_constant__ CUtensorMap topen, const Params p) {
    constexpr int T = dq_tile_rows<C>();
    using L = DqLayout<C, LABELED>;
    constexpr int S = L::stages;
    constexpr int KD = L::KD;
    constexpr int KC = T / 16;  // depth steps of dQ += dS K
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
    uint64_t* empty = full + S;
    uint64_t* qbar = empty + S;
    const int bh = blockIdx.y;
    const int b = bh / p.H;
    const int h = bh % p.H;
    const int q0 = blockIdx.x * 128;
    const int tiles = (p.kv_len + T - 1) / T;
    const int wg = threadIdx.x / 128;
    constexpr int kDoOff = L::ATOMS * L::res_atom, kOOff = 2 * L::ATOMS * L::res_atom;

    if (threadIdx.x == 0) {
        for (int s = 0; s < S; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 256);
        }
        mbar_init(qbar, 1);
        mbar_fence_init();
    }
    __syncthreads();

    if (wg == 0) {
        reg_dealloc<40>();
        if (threadIdx.x == 0) {
            mbar_expect_tx(qbar, L::res_bytes);
            load_rows(smem, &tq, qbar, L::ATOMS, L::res_atom, p.q, h, q0, b);
            load_rows(smem + kDoOff, &tdo, qbar, L::ATOMS, L::res_atom, p.dout, h, q0, b);
            load_rows(smem + kOOff, &to, qbar, L::ATOMS, L::res_atom, p.o, h, q0, b);
            for (int n = 0; n < tiles; ++n) {
                const int s = n % S;
                if (n >= S) mbar_wait(&empty[s], ((n / S) - 1) & 1);
                unsigned char* st = smem + L::res_bytes + s * L::stage_bytes;
                mbar_expect_tx(&full[s], L::stage_tx);
                load_rows(st, &tk, &full[s], L::ATOMS, L::tile_atom, p.k, h, n * T, b);
                load_rows(st + L::tile_bytes, &tv, &full[s], L::ATOMS, L::tile_atom, p.v, h, n * T,
                          b);
                if constexpr (LABELED) {
                    tma_load_2d(st + L::small_off, &tbits, &full[s], n * T, b);
                    tma_load_2d(st + L::small_off + kSmall, &topen, &full[s], n * T, b);
                }
            }
        }
    } else {
        reg_alloc<232>();
        const int wgi = wg - 1;
        const int tid = threadIdx.x - 128 * wg;
        const int warp = tid >> 5, lane = tid & 31;
        const int g = lane >> 2, t = lane & 3;
        const int lrow = wgi * 64 + warp * 16 + g;  // row within the block
        const int row_lo = q0 + lrow, row_hi = row_lo + 8;

        // rows past N load zeros (lse 0) and are never stored; they count as
        // open
        const float* lb = p.lse + (long long)bh * p.lse_stride;
        const float lse_lo = row_lo < p.N ? lb[row_lo] : 0.f;
        const float lse_hi = row_hi < p.N ? lb[row_hi] : 0.f;
        int qb_lo = 0, qo_lo = 1, qb_hi = 0, qo_hi = 1;
        if constexpr (LABELED) {
            const int* bb = p.bits + (long long)b * p.label_stride;
            const int* ob = p.open + (long long)b * p.label_stride;
            if (row_lo < p.N) {
                qb_lo = bb[row_lo];
                qo_lo = ob[row_lo];
            }
            if (row_hi < p.N) {
                qb_hi = bb[row_hi];
                qo_hi = ob[row_hi];
            }
        }
        bool wg_open = !LABELED;
        if constexpr (LABELED) wg_open = named_bar_all(kBarVote + wgi, 128, qo_lo > 0 && qo_hi > 0);

        mbar_wait(qbar, 0);
        // delta = rowsum(dO * O) of this lane's two rows, from the resident
        // tiles; the four lanes of a row each sum a quarter of it
        float d_lo = 0.f, d_hi = 0.f;
#pragma unroll
        for (int a = 0; a < L::ATOMS; ++a) {
            const unsigned char* ro = smem + kOOff + a * L::res_atom;
            const unsigned char* rd = smem + kDoOff + a * L::res_atom;
            d_lo += row_dot(ro + lrow * 128, rd + lrow * 128, t);
            d_hi += row_dot(ro + (lrow + 8) * 128, rd + (lrow + 8) * 128, t);
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
            d_lo += __shfl_xor_sync(0xffffffffu, d_lo, off);
            d_hi += __shfl_xor_sync(0xffffffffu, d_hi, off);
        }
        if (p.delta != nullptr && t == 0) {
            float* dr = p.delta + (long long)bh * p.delta_stride;
            if (row_lo < p.N) dr[row_lo] = d_lo;
            if (row_hi < p.N) dr[row_hi] = d_hi;
        }

        float dq[C / 2];
#pragma unroll
        for (int i = 0; i < C / 2; ++i) dq[i] = 0.f;
        float sacc[T / 2], dpacc[T / 2];
        uint32_t dsf[KC][4];
        const uint32_t sq = smem_u32(smem) + wgi * 64 * 128;  // this warpgroup's rows
        const uint32_t sdo = sq + kDoOff;
        const uint32_t sring = smem_u32(smem) + L::res_bytes;
        uint64_t aq[KD], ado[KD];
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
            aq[kk] = desc_k(sq, kk, L::res_atom);
            ado[kk] = desc_k(sdo, kk, L::res_atom);
        }

        // The two warpgroups take turns on the tensor cores: one issues a
        // turn's products while the other computes its exponentials.
        // Warpgroup 0 goes first.
        if (wgi == 1) named_bar_arrive(kBarTurn, 256);

        // One turn of products: dQ += dS K of tile nb (HAS_B; dS from
        // registers, K read MN-major) and S = Q K^T, dP = dO V^T of tile na
        // (HAS_A), one wgmma batch; then tile nb's stage is free.
        auto products = [&](const int nb, const int na, auto has_b, auto has_a) {
            constexpr bool HAS_B = decltype(has_b)::value, HAS_A = decltype(has_a)::value;
            uint64_t bk[KD], bv[KD], mk[KC];
            if constexpr (HAS_A) {
                const uint32_t st = sring + (na % S) * L::stage_bytes;
                mbar_wait(&full[na % S], (na / S) & 1);
#pragma unroll
                for (int kk = 0; kk < KD; ++kk) {
                    bk[kk] = desc_k(st, kk, L::tile_atom);
                    bv[kk] = desc_k(st + L::tile_bytes, kk, L::tile_atom);
                }
                pin(bk);
                pin(bv);
            }
            if constexpr (HAS_B) {
                const uint32_t st = sring + (nb % S) * L::stage_bytes;
#pragma unroll
                for (int kc = 0; kc < KC; ++kc) mk[kc] = desc_mn(st, kc, L::tile_atom);
                pin(mk);
            }
            pin(aq);
            pin(ado);
            named_bar_sync(kBarTurn + wgi, 256);
            pin(sacc);
            pin(dpacc);
            pin(dsf);
            pin(dq);
            wgmma_fence();
            if constexpr (HAS_B) {
#pragma unroll
                for (int kc = 0; kc < KC; ++kc) wgmma_rs<C>(dq, dsf[kc], mk[kc]);
            }
            if constexpr (HAS_A) {
#pragma unroll
                for (int kk = 0; kk < KD; ++kk) wgmma_ss<T>(sacc, aq[kk], bk[kk], kk > 0);
#pragma unroll
                for (int kk = 0; kk < KD; ++kk) wgmma_ss<T>(dpacc, ado[kk], bv[kk], kk > 0);
            }
            wgmma_commit();
            named_bar_arrive(kBarTurn + (1 - wgi), 256);
            wgmma_wait<0>();
            pin(sacc);
            pin(dpacc);
            pin(dsf);
            pin(dq);
            if constexpr (HAS_B) mbar_arrive(&empty[nb % S]);
        };
        // dS of tile n into dsf
        auto scores = [&](const int n, auto mask_kind) {
            constexpr int MASK = decltype(mask_kind)::value;
            const unsigned char* small =
                smem + L::res_bytes + (n % S) * L::stage_bytes + L::small_off;
            const int* lbits = reinterpret_cast<const int*>(small);
            const int* lopen = reinterpret_cast<const int*>(small + kSmall);
#pragma unroll
            for (int j = 0; j < T / 8; ++j) {
                float dsv[4];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int kj = 8 * j + 2 * t + e;
                    const int key = n * T + kj;
                    bool keep_lo = true, keep_hi = true;
                    if constexpr (MASK != kMaskNone) {
                        keep_lo = keep_hi = key < p.kv_len;
                        if constexpr (MASK == kMaskLabels) {
                            const int kb = lbits[kj], ko = lopen[kj];
                            keep_lo = keep_lo && label_keep(qb_lo, qo_lo, kb, ko, row_lo, key);
                            keep_hi = keep_hi && label_keep(qb_hi, qo_hi, kb, ko, row_hi, key);
                        }
                    }
                    const float p_lo =
                        keep_lo ? ex2(fmaf(sacc[4 * j + e], p.sl2, -lse_lo)) : 0.f;
                    const float p_hi =
                        keep_hi ? ex2(fmaf(sacc[4 * j + 2 + e], p.sl2, -lse_hi)) : 0.f;
                    dsv[e] = p_lo * (dpacc[4 * j + e] - d_lo);
                    dsv[2 + e] = p_hi * (dpacc[4 * j + 2 + e] - d_hi);
                }
                dsf[j / 2][2 * (j % 2)] = pack_bf16(dsv[0], dsv[1]);
                dsf[j / 2][2 * (j % 2) + 1] = pack_bf16(dsv[2], dsv[3]);
            }
        };
        using MaskNone = std::integral_constant<int, kMaskNone>;
        using MaskEdge = std::integral_constant<int, kMaskEdge>;
        using MaskLabels = std::integral_constant<int, kMaskLabels>;
        // The first tile's score products, then per tile the previous tile's
        // dQ product with this one's score products, then the last tile's dQ
        // product. Full key tiles need no mask, unless the warpgroup has rows
        // that are not open under labels; a ragged last tile masks keys >=
        // kv_len. The first tile takes a masked step; each loop runs whole
        // steps of one variant, chosen by trip counts (a branch between
        // variants inside a loop makes ptxas serialise the wgmmas).
        products(0, 0, std::false_type{}, std::true_type{});
        scores(0, std::conditional_t<LABELED, MaskLabels, MaskEdge>{});
        const int full_tiles = wg_open ? p.kv_len / T : 0;
        for (int n = 1; n < full_tiles; ++n) {
            products(n - 1, n, std::true_type{}, std::true_type{});
            scores(n, MaskNone{});
        }
        const int edge_end = wg_open ? tiles : 0;
        for (int n = max(1, full_tiles); n < edge_end; ++n) {
            products(n - 1, n, std::true_type{}, std::true_type{});
            scores(n, MaskEdge{});
        }
        if constexpr (LABELED)
            for (int n = max(1, edge_end); n < tiles; ++n) {
                products(n - 1, n, std::true_type{}, std::true_type{});
                scores(n, MaskLabels{});
            }
        products(tiles - 1, 0, std::true_type{}, std::false_type{});
        if (wgi == 0) named_bar_sync(kBarTurn, 256);

        store_rows<C>(p.g0 + b * p.gs[0] + h * p.gs[1], p.gs[2], dq, row_lo, p.N, t, p.scale);
    }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// Everything a launch needs; the tensor maps are encoded on the host. plan:
// the Python plan's (tile rows, stages, shared bytes), checked against the
// kernel's own layout.
struct Launch {
    CUtensorMap tq, tk, tv, tdo, to, tlse, tdelta, tbits, topen;
    Params p;
    int B, c;
    int plan[3];
    cudaStream_t stream;
};

template <int C, bool LABELED>
cudaError_t launch_dq_c(const Launch& a) {
    using L = DqLayout<C, LABELED>;
    if (a.plan[0] != dq_tile_rows<C>() || a.plan[1] != L::stages || a.plan[2] != L::bytes)
        return cudaErrorInvalidValue;
    auto kern = flash_bwd_dq_sm90<C, LABELED>;
    cudaError_t err = idt_allow_smem(kern, L::bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.p.N + 127) / 128, a.B * a.p.H);
    kern<<<grid, 384, L::bytes, a.stream>>>(a.tq, a.tk, a.tv, a.tdo, a.to, a.tbits, a.topen,
                                            a.p);
    return cudaGetLastError();
}

template <int C, bool LABELED>
cudaError_t launch_dkv_c(const Launch& a) {
    using L = DkvLayout<C, LABELED>;
    if (a.plan[0] != dkv_tile_rows<C>() || a.plan[1] != L::stages || a.plan[2] != L::bytes)
        return cudaErrorInvalidValue;
    constexpr int NWG = dkv_warpgroups<C>();
    auto kern = flash_bwd_dkv_sm90<C, LABELED>;
    cudaError_t err = idt_allow_smem(kern, L::bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.p.kv_len + 64 * NWG - 1) / (64 * NWG), a.B * a.p.H);
    kern<<<grid, 128 * (NWG + 1), L::bytes, a.stream>>>(a.tq, a.tk, a.tv, a.tdo, a.tlse,
                                                        a.tdelta, a.tbits, a.topen, a.p);
    return cudaGetLastError();
}

// c in {8, 16, ..., 128}; other values return cudaErrorInvalidValue. Each
// defined by IDT_FB_INSTANTIATE in its own source (flash_bwd_*.cu), so nvcc
// compiles the four in parallel.
template <bool DKV, bool LABELED>
cudaError_t launch(const Launch& a);
template <>
cudaError_t launch<false, false>(const Launch& a);
template <>
cudaError_t launch<false, true>(const Launch& a);
template <>
cudaError_t launch<true, false>(const Launch& a);
template <>
cudaError_t launch<true, true>(const Launch& a);

template <int C, bool DKV, bool LABELED>
cudaError_t launch_c(const Launch& a) {
    if constexpr (DKV)
        return launch_dkv_c<C, LABELED>(a);
    else
        return launch_dq_c<C, LABELED>(a);
}

#define IDT_FB_CASE(C, DKV, LABELED) \
    case C:                          \
        return launch_c<C, DKV, LABELED>(a);

#define IDT_FB_INSTANTIATE(DKV, LABELED)                                                       \
    namespace idt_fb {                                                                         \
    template <>                                                                                \
    cudaError_t launch<DKV, LABELED>(const Launch& a) {                                        \
        switch (a.c) {                                                                         \
            IDT_FB_CASE(8, DKV, LABELED)                                                       \
            IDT_FB_CASE(16, DKV, LABELED)                                                      \
            IDT_FB_CASE(24, DKV, LABELED)                                                      \
            IDT_FB_CASE(32, DKV, LABELED)                                                      \
            IDT_FB_CASE(40, DKV, LABELED)                                                      \
            IDT_FB_CASE(48, DKV, LABELED)                                                      \
            IDT_FB_CASE(56, DKV, LABELED)                                                      \
            IDT_FB_CASE(64, DKV, LABELED)                                                      \
            IDT_FB_CASE(72, DKV, LABELED)                                                      \
            IDT_FB_CASE(80, DKV, LABELED)                                                      \
            IDT_FB_CASE(88, DKV, LABELED)                                                      \
            IDT_FB_CASE(96, DKV, LABELED)                                                      \
            IDT_FB_CASE(104, DKV, LABELED)                                                     \
            IDT_FB_CASE(112, DKV, LABELED)                                                     \
            IDT_FB_CASE(120, DKV, LABELED)                                                     \
            IDT_FB_CASE(128, DKV, LABELED)                                                     \
            default: return cudaErrorInvalidValue;                                             \
        }                                                                                      \
    }                                                                                          \
    }

}  // namespace idt_fb
