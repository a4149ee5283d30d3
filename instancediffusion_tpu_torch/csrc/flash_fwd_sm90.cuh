// The forward flash-attention kernel for Hopper: TMA loads, wgmma products,
// one producer warp and two ping-ponging consumer warpgroups.
//
// Replaces instancediffusion_tpu/kernels/flash_attention.py: flash_attention
// (_flash_kernel; _flash_kernel_labeled with labels), flash_attention_packed
// (_flash_kernel_packed, _flash_kernel_packed_labeled) and _fwd_with_stats
// (the training forward, WITH_LSE). One kernel serves every layout: q, k and
// v are read in place through 4-D TMA tensor maps over (head dim, and the
// batch, head and row axes in order of stride), so head views of (B,N,H*c)
// projections and the packed (B,N,H*c) layout need no copy. The output is
// written through (batch, head, row) strides.
//
// What bounds it. At c = 40 (ds1) a score costs 4c = 160 tensor-core FLOPs
// and one exp2. An H100 SM does about 4096 bf16 tensor FLOPs per clock but
// only 16 MUFU.EX2, so the exponentials take ~1.6x the products' time: the
// kernel is bound by the exponential unit, and the design hides the products
// and the loads under the softmax:
//   - a block owns 128 query rows (two consumer warpgroups of 64), halving
//     the K/V re-reads of a 64-row block;
//   - one producer warp keeps a ring of kStages K/V tiles (128 keys each) in
//     flight with TMA, completed on mbarriers; no consumer thread spends
//     registers or issue slots on a copy, and setmaxnreg moves the producer's
//     registers to the consumers. Each box is 64 head-dim columns (128 bytes)
//     by 128 rows with the 128-byte swizzle, so TMA moves a tile in one
//     request per row per 64 columns (with boxes of 8 columns, 16 bytes a
//     row, the loads alone took as long as the whole kernel does now);
//   - S = Q K^T is one wgmma m64n128k16 per 16 head-dim columns, Q and K both
//     K-major in shared memory; P stays in registers (bf16) as wgmma's A
//     operand for O += P V, with V read MN-major (transposed) from shared
//     memory; PV's N is c itself (40 at ds1) and S's depth c rounded up to
//     16 (48): columns past c in shared memory are TMA's zero fill and are
//     never multiplied;
//   - the two consumer warpgroups ping-pong on named barriers: one issues its
//     products while the other runs its softmax, and within a warpgroup the
//     next tile's S = Q K^T and the last tile's P V are issued together,
//     before the softmax that needs only S;
//   - the score is scaled and shifted in one FFMA (s * scale * log2 e - m)
//     and exponentiated with ex2.approx.ftz (one MUFU.EX2); row maxima and
//     sums run as four partial chains.
// The softmax is online, in fp32 and in base 2 of the scaled scores. ptxas
// serialises every wgmma of the kernel (C7513 / C7515) if a register that a
// wgmma batch reads or writes is defined between its fence and its wait, so
// the loop is written for it: descriptors and operands are pinned before
// each fence, the first tile is peeled, unmasked, kv-masked and label-masked
// tiles run in separate loops of whole steps chosen by trip counts, and S is
// only read while P V is in flight.
//
// kv_len. The k/v maps' row extent is kv_len, so TMA reads keys past it as
// zero; the first tile and the one straddling kv_len mask scores to -inf.
// That covers a ragged kv (4280 fuser keys) and one pre-padded past kv_len
// (4608).
//
// LABELED: int32 bits and open per sequence position, one row of
// label_stride entries per batch, shared by all heads; a 2-D tensor map
// brings each tile's 128 key labels into its ring stage on the same mbarrier.
// Score (i, j) is kept iff open_i | open_j | (bits_i & bits_j) != 0 | i == j,
// on top of the kv_len test. A consumer warpgroup whose 64 rows are all open
// (the CFG null half; one vote on a named barrier) runs the unlabeled steps
// and never reads the key labels. While a row's running max is still -inf
// the softmax subtracts 0 (exp2(-inf - -inf) would be NaN); a row with no
// kept key comes out 0.
//
// WITH_LSE: each q row also writes lse = m + log2(l) in base 2 of the scaled
// scores (fp32, (B*H, N)), -inf for a row with no kept key; the backward
// kernels (flash_attention_bwd.cu) read it.
#pragma once

#include <type_traits>

#include "sm90.cuh"

namespace idt_fa {

constexpr int kBQ = 128;            // query rows per block (2 warpgroups x 64)
constexpr int kBK = 128;            // keys per tile
constexpr int kThreads = 384;       // producer warpgroup + 2 consumer warpgroups
constexpr int kAtom = kBK * 128;    // one 128-row x 64-column (128-byte) swizzle atom
constexpr int kBarWG = 1;           // named barriers 1, 2: the consumers' turns; 3, 4: votes
// what a key tile's step masks: nothing, keys at or past kv_len, or also by labels
constexpr int kMaskNone = 0, kMaskKv = 1, kMaskLabels = 2;
constexpr float kLog2e = 1.4426950408889634f;

// Where (head, row, batch) go among a tensor map's coordinates 1..3.
struct MapOrder {
    int head, row, batch;
};

struct Params {
    __nv_bfloat16* o;
    float* lse;
    const int* qbits;
    const int* qopen;
    long long osb, osh, osr;
    int label_stride, H, N, kv_len;
    MapOrder q, k, v;
    float sl2;  // scale * log2(e)
};

template <int C, bool LABELED>
struct Layout {
    static constexpr int KD = (C + 15) / 16;     // k-steps of S = Q K^T (c padded to 16)
    static constexpr int ATOMS = (C + 63) / 64;  // 64-column atoms of a Q, K or V tile
    static constexpr int q_bytes = ATOMS * kAtom;
    static constexpr int label_bytes = LABELED ? 1024 : 0;  // 2 x 128 int32, 1 KB aligned
    static constexpr int stage_bytes = 2 * ATOMS * kAtom + label_bytes;
    static constexpr int stages_fit = (200 * 1024 - q_bytes) / stage_bytes;
    static constexpr int kStages = stages_fit < 4 ? stages_fit : 4;
    static_assert(kStages >= 2, "two ring stages must fit");
    static constexpr int ring = q_bytes;
    static constexpr int k_off = 0, v_off = ATOMS * kAtom, l_off = 2 * ATOMS * kAtom;
    static constexpr int bars = ring + kStages * stage_bytes;
    // + 1 KB to align the base: the 128-byte swizzle repeats every 1024 bytes
    static constexpr int bytes = bars + (2 * kStages + 1) * 8 + 1024;
};

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ int pick(const MapOrder& o, int slot, int h, int r, int b) {
    return o.head == slot ? h : (o.row == slot ? r : b);
}

// A 128-row tile of an operand: one TMA box per 64-column atom
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map,
                                          uint64_t* bar, int atoms, const MapOrder& o, int h,
                                          int r, int b) {
    const int c1 = pick(o, 1, h, r, b), c2 = pick(o, 2, h, r, b), c3 = pick(o, 3, h, r, b);
    for (int a = 0; a < atoms; ++a) tma_load_4d(dst + a * kAtom, map, bar, a * 64, c1, c2, c3);
}

// K-major operand (Q or K) of S = Q K^T: k-step kk of a tile at `base`
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t base, int kk) {
    return wgmma_desc_sw128(base + (kk / 4) * kAtom + (kk % 4) * 32, 16, 1024);
}

// Pin every register a wgmma batch reads or writes before its wgmma.fence,
// so the compiler cannot sink a write to them past the fence (ptxas would
// then serialise the wgmmas).
template <int C>
__device__ __forceinline__ void fence_operands(float (&sacc)[64], float (&o)[C / 2],
                                               uint32_t (&pf)[kBK / 16][4]) {
#pragma unroll
    for (int i = 0; i < 64; ++i) reg_fence(sacc[i]);
#pragma unroll
    for (int i = 0; i < C / 2; ++i) reg_fence(o[i]);
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc)
#pragma unroll
        for (int i = 0; i < 4; ++i) reg_fence(pf[kc][i]);
}

template <int C, bool LABELED, bool WITH_LSE>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tbits,
                   const __grid_constant__ CUtensorMap topen, const Params p) {
    using L = Layout<C, LABELED>;
    constexpr int S = L::kStages;
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
    uint64_t* empty = full + S;
    uint64_t* qbar = empty + S;
    const int b = blockIdx.y / p.H;
    const int h = blockIdx.y % p.H;
    const int q0 = blockIdx.x * kBQ;
    const int tiles = (p.kv_len + kBK - 1) / kBK;
    const int wg = threadIdx.x / 128;

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
        // producer: one thread issues every TMA load
        reg_dealloc<40>();
        if (threadIdx.x == 0) {
            mbar_expect_tx(qbar, L::q_bytes);
            load_tile(smem, &tq, qbar, L::ATOMS, p.q, h, q0, b);
            for (int n = 0; n < tiles; ++n) {
                const int s = n % S;
                if (n >= S) mbar_wait(&empty[s], ((n / S) - 1) & 1);
                unsigned char* st = smem + L::ring + s * L::stage_bytes;
                mbar_expect_tx(&full[s], L::stage_bytes);
                load_tile(st + L::k_off, &tk, &full[s], L::ATOMS, p.k, h, n * kBK, b);
                load_tile(st + L::v_off, &tv, &full[s], L::ATOMS, p.v, h, n * kBK, b);
                if constexpr (LABELED) {
                    tma_load_2d(st + L::l_off, &tbits, &full[s], n * kBK, b);
                    tma_load_2d(st + L::l_off + kBK * 4, &topen, &full[s], n * kBK, b);
                }
            }
        }
    } else {
        reg_alloc<232>();
        const int wgi = wg - 1;                // consumer warpgroup 0 or 1
        const int tid = threadIdx.x - 128 * wg;
        const int warp = tid >> 5, lane = tid & 31;
        const int g = lane >> 2, t = lane & 3;
        const int row_lo = q0 + wgi * 64 + warp * 16 + g, row_hi = row_lo + 8;
        const uint32_t sq = smem_u32(smem) + wgi * 64 * 128;  // this warpgroup's Q rows
        const uint32_t sring = smem_u32(smem) + L::ring;

        int qb_lo = 0, qo_lo = 0, qb_hi = 0, qo_hi = 0;
        if constexpr (LABELED) {
            const int* bb = p.qbits + (long long)b * p.label_stride;
            const int* ob = p.qopen + (long long)b * p.label_stride;
            if (row_lo < p.N) {
                qb_lo = bb[row_lo];
                qo_lo = ob[row_lo];
            }
            if (row_hi < p.N) {
                qb_hi = bb[row_hi];
                qo_hi = ob[row_hi];
            }
        }
        // a warpgroup whose rows are all open (the CFG null half) keeps every
        // key below kv_len and need not read the key labels
        bool wg_open = !LABELED;
        if constexpr (LABELED) wg_open = named_bar_all(3 + wgi, 128, qo_lo > 0 && qo_hi > 0);

        float o[C / 2];
#pragma unroll
        for (int i = 0; i < C / 2; ++i) o[i] = 0.f;
        float sacc[64];
        uint32_t pf[kBK / 16][4];
        float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

        constexpr int KD = L::KD;
        uint64_t dq[KD];
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) dq[kk] = desc_kmajor(sq, kk);

        mbar_wait(qbar, 0);
        if (wgi == 1) named_bar_arrive(kBarWG, 256);  // consumer 0 goes first
        // One key tile: S = Q K^T of tile n and (HAS_PV) P V of tile n - 1.
        // The first tile has no P V; it gets its own copy of the body, so
        // that every wait below is unconditional and ptxas can see which
        // wgmmas are in flight where.
        auto step = [&](const int n, auto has_pv, auto mask_kind) {
            constexpr bool HAS_PV = decltype(has_pv)::value;
            constexpr int MASK = decltype(mask_kind)::value;
            constexpr bool MASKED = MASK != kMaskNone;
            const int s = n % S;
            const uint32_t st = sring + s * L::stage_bytes;
            mbar_wait(&full[s], (n / S) & 1);
            // every descriptor is computed before the fence: a register
            // defined between two wgmmas of a batch serialises them (C7513)
            uint64_t dk[KD], dv[kBK / 16];
#pragma unroll
            for (int kk = 0; kk < KD; ++kk) {
                dk[kk] = desc_kmajor(st + L::k_off, kk);
                reg_fence(dk[kk]);
            }
            if constexpr (HAS_PV) {
                const uint32_t sv = sring + ((n - 1) % S) * L::stage_bytes + L::v_off;
#pragma unroll
                for (int kc = 0; kc < kBK / 16; ++kc) {
                    dv[kc] = wgmma_desc_sw128(sv + kc * 16 * 128, kAtom, 1024);
                    reg_fence(dv[kc]);
                }
            }
            named_bar_sync(kBarWG + wgi, 256);
            fence_operands<C>(sacc, o, pf);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < KD; ++kk) wgmma_ss_n128(sacc, dq[kk], dk[kk], kk > 0);
            wgmma_commit();
            if constexpr (HAS_PV) {
#pragma unroll
                for (int kc = 0; kc < kBK / 16; ++kc) wgmma_rs<C>(o, pf[kc], dv[kc]);
                wgmma_commit();
            }
            named_bar_arrive(kBarWG + (1 - wgi), 256);
            if constexpr (HAS_PV)
                wgmma_wait<1>();
            else
                wgmma_wait<0>();
#pragma unroll
            for (int i = 0; i < 64; ++i) reg_fence(sacc[i]);

            // From here until P V is waited for, sacc is only read: a
            // register write to it while a wgmma is in flight would make
            // ptxas serialise every wgmma (C7515). The mask is kept as bits
            // (bit 2j + e of row lo / hi: key 8j + 2t + e of the tile).
            const int k0 = n * kBK;
            uint32_t keep_lo = ~0u, keep_hi = ~0u;
            if constexpr (MASKED) {
                const int* lb = reinterpret_cast<const int*>(smem + L::ring + s * L::stage_bytes +
                                                             L::l_off);
                auto mask = [&](auto by_labels) {
#pragma unroll
                    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const int kj = j * 8 + 2 * t + e;
                            const int col = k0 + kj;
                            bool k_lo = col < p.kv_len, k_hi = k_lo;
                            if constexpr (decltype(by_labels)::value) {
                                const int kbits = lb[kj];
                                const bool kopen = lb[kBK + kj] > 0;
                                k_lo = k_lo && (kopen || qo_lo > 0 || (qb_lo & kbits) != 0 ||
                                                row_lo == col);
                                k_hi = k_hi && (kopen || qo_hi > 0 || (qb_hi & kbits) != 0 ||
                                                row_hi == col);
                            }
                            if (!k_lo) keep_lo &= ~(1u << (2 * j + e));
                            if (!k_hi) keep_hi &= ~(1u << (2 * j + e));
                        }
                    }
                };
                mask(std::bool_constant<MASK == kMaskLabels>{});
            }
            // online softmax in base 2 of the scaled scores
            float ms_lo, ms_hi, mn_lo, mn_hi, rs_lo = 0.f, rs_hi = 0.f;
            uint32_t pn[kBK / 16][4];  // this tile's P; pf still feeds the P V in flight
            {
                auto kept = [](uint32_t bits, int i, float v) {
                    return !MASKED || ((bits >> i) & 1u) ? v : -INFINITY;
                };
                // four partial maxima and sums per row: short dependency chains
                float ml[4], mh[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) ml[i] = mh[i] = -INFINITY;
#pragma unroll
                for (int j = 0; j < kBK / 8; ++j) {
                    ml[j % 4] = fmaxf(ml[j % 4], fmaxf(kept(keep_lo, 2 * j, sacc[4 * j]),
                                                       kept(keep_lo, 2 * j + 1, sacc[4 * j + 1])));
                    mh[j % 4] = fmaxf(mh[j % 4], fmaxf(kept(keep_hi, 2 * j, sacc[4 * j + 2]),
                                                       kept(keep_hi, 2 * j + 1, sacc[4 * j + 3])));
                }
                float mx_lo = fmaxf(fmaxf(ml[0], ml[1]), fmaxf(ml[2], ml[3]));
                float mx_hi = fmaxf(fmaxf(mh[0], mh[1]), fmaxf(mh[2], mh[3]));
#pragma unroll
                for (int off = 1; off < 4; off <<= 1) {
                    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
                    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
                }
                mn_lo = fmaxf(m_lo, mx_lo * p.sl2);
                mn_hi = fmaxf(m_hi, mx_hi * p.sl2);
                // subtrahend: the new running max, or 0 while a labeled row
                // has no kept key yet (so exp2 gives 0, not NaN)
                ms_lo = mn_lo;
                ms_hi = mn_hi;
                if constexpr (LABELED) {
                    if (ms_lo == -INFINITY) ms_lo = 0.f;
                    if (ms_hi == -INFINITY) ms_hi = 0.f;
                }
                float sl[4] = {0.f, 0.f, 0.f, 0.f}, sh[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
                for (int j = 0; j < kBK / 8; ++j) {
                    const float p0 = ex2(fmaf(kept(keep_lo, 2 * j, sacc[4 * j]), p.sl2, -ms_lo));
                    const float p1 =
                        ex2(fmaf(kept(keep_lo, 2 * j + 1, sacc[4 * j + 1]), p.sl2, -ms_lo));
                    const float p2 =
                        ex2(fmaf(kept(keep_hi, 2 * j, sacc[4 * j + 2]), p.sl2, -ms_hi));
                    const float p3 =
                        ex2(fmaf(kept(keep_hi, 2 * j + 1, sacc[4 * j + 3]), p.sl2, -ms_hi));
                    sl[j % 4] += p0 + p1;
                    sh[j % 4] += p2 + p3;
                    pn[j / 2][2 * (j % 2)] = pack_bf16(p0, p1);
                    pn[j / 2][2 * (j % 2) + 1] = pack_bf16(p2, p3);
                }
                rs_lo = (sl[0] + sl[1]) + (sl[2] + sl[3]);
                rs_hi = (sh[0] + sh[1]) + (sh[2] + sh[3]);
            }
            const float a_lo = ex2(m_lo - ms_lo), a_hi = ex2(m_hi - ms_hi);
            m_lo = mn_lo;
            m_hi = mn_hi;

            if constexpr (HAS_PV) {  // P V of the previous tile is done: O is stable, its stage free
                wgmma_wait<0>();
#pragma unroll
                for (int i = 0; i < C / 2; ++i) reg_fence(o[i]);
#pragma unroll
                for (int kc = 0; kc < kBK / 16; ++kc)
#pragma unroll
                    for (int i = 0; i < 4; ++i) reg_fence(pf[kc][i]);
                mbar_arrive(&empty[(n - 1) % S]);
            }
#pragma unroll
            for (int d = 0; d < C / 8; ++d) {
                o[4 * d] *= a_lo;
                o[4 * d + 1] *= a_lo;
                o[4 * d + 2] *= a_hi;
                o[4 * d + 3] *= a_hi;
            }
            l_lo = l_lo * a_lo + rs_lo;
            l_hi = l_hi * a_hi + rs_hi;
#pragma unroll
            for (int kc = 0; kc < kBK / 16; ++kc)
#pragma unroll
                for (int i = 0; i < 4; ++i) pf[kc][i] = pn[kc][i];
        };
        // The first tile and the one straddling kv_len take a masked step;
        // the full tiles between need no mask, unless the warpgroup has rows
        // that are not open under labels. Each loop runs whole steps of one
        // variant, chosen by its trip count (uniform over the warpgroup): a
        // branch inside a loop makes ptxas serialise the wgmmas (C7513).
        using MaskKv = std::integral_constant<int, kMaskKv>;
        using MaskLabels = std::integral_constant<int, kMaskLabels>;
        step(0, std::false_type{}, std::conditional_t<LABELED, MaskLabels, MaskKv>{});
        const int none_end = wg_open ? p.kv_len / kBK : 1;
        for (int n = 1; n < none_end; ++n)
            step(n, std::true_type{}, std::integral_constant<int, kMaskNone>{});
        const int kv_end = wg_open ? tiles : 1;
        for (int n = max(1, none_end); n < kv_end; ++n) step(n, std::true_type{}, MaskKv{});
        if constexpr (LABELED)
            for (int n = max(1, kv_end); n < tiles; ++n) step(n, std::true_type{}, MaskLabels{});
        // P V of the last tile
        {
            const uint32_t sv = sring + ((tiles - 1) % S) * L::stage_bytes + L::v_off;
            uint64_t dv[kBK / 16];
#pragma unroll
            for (int kc = 0; kc < kBK / 16; ++kc) {
                dv[kc] = wgmma_desc_sw128(sv + kc * 16 * 128, kAtom, 1024);
                reg_fence(dv[kc]);
            }
            named_bar_sync(kBarWG + wgi, 256);
            fence_operands<C>(sacc, o, pf);
            wgmma_fence();
#pragma unroll
            for (int kc = 0; kc < kBK / 16; ++kc) wgmma_rs<C>(o, pf[kc], dv[kc]);
        }
        wgmma_commit();
        if (wgi == 0) named_bar_arrive(kBarWG + 1, 256);
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < C / 2; ++i) reg_fence(o[i]);

        // full row sums, normalise, store
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
            l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
            l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
        }
        const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f), inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
        if constexpr (WITH_LSE) {
            if (t == 0) {  // the four lanes of a row hold the same m and l
                float* lr = p.lse + (long long)blockIdx.y * p.N;
                if (row_lo < p.N)
                    lr[row_lo] = m_lo == -INFINITY ? -INFINITY : m_lo + log2f(fmaxf(l_lo, 1e-30f));
                if (row_hi < p.N)
                    lr[row_hi] = m_hi == -INFINITY ? -INFINITY : m_hi + log2f(fmaxf(l_hi, 1e-30f));
            }
        }
        __nv_bfloat16* ob = p.o + b * p.osb + h * p.osh;
#pragma unroll
        for (int d = 0; d < C / 8; ++d) {
            const int col = d * 8 + 2 * t;
            if (row_lo < p.N)
                *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row_lo * p.osr + col) =
                    __floats2bfloat162_rn(o[4 * d] * inv_lo, o[4 * d + 1] * inv_lo);
            if (row_hi < p.N)
                *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row_hi * p.osr + col) =
                    __floats2bfloat162_rn(o[4 * d + 2] * inv_hi, o[4 * d + 3] * inv_hi);
        }
    }
}

// Everything a launch needs; the tensor maps are encoded on the host.
struct Launch {
    CUtensorMap tq, tk, tv, tbits, topen;
    Params p;
    int B, c;
    cudaStream_t stream;
};

template <int C, bool LABELED, bool WITH_LSE>
cudaError_t launch_c(const Launch& a) {
    auto kern = flash_fwd_sm90<C, LABELED, WITH_LSE>;
    const int smem = Layout<C, LABELED>::bytes;
    cudaError_t err = idt_allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.p.N + kBQ - 1) / kBQ, a.B * a.p.H);
    kern<<<grid, kThreads, smem, a.stream>>>(a.tq, a.tk, a.tv, a.tbits, a.topen, a.p);
    return cudaGetLastError();
}

// c in {8, 16, ..., 128}; other values return cudaErrorInvalidValue.
template <bool LABELED, bool WITH_LSE>
cudaError_t launch(const Launch& a);
// each defined by IDT_FA_INSTANTIATE in its own source (flash_fwd_*.cu), so
// nvcc compiles the four in parallel
template <>
cudaError_t launch<false, false>(const Launch& a);
template <>
cudaError_t launch<true, false>(const Launch& a);
template <>
cudaError_t launch<false, true>(const Launch& a);
template <>
cudaError_t launch<true, true>(const Launch& a);

#define IDT_FA_INSTANTIATE(LABELED, WITH_LSE)                                          \
    namespace idt_fa {                                                                 \
    template <>                                                                        \
    cudaError_t launch<LABELED, WITH_LSE>(const Launch& a) {                           \
        switch (a.c) {                                                                 \
            case 8: return launch_c<8, LABELED, WITH_LSE>(a);                          \
            case 16: return launch_c<16, LABELED, WITH_LSE>(a);                        \
            case 24: return launch_c<24, LABELED, WITH_LSE>(a);                        \
            case 32: return launch_c<32, LABELED, WITH_LSE>(a);                        \
            case 40: return launch_c<40, LABELED, WITH_LSE>(a);                        \
            case 48: return launch_c<48, LABELED, WITH_LSE>(a);                        \
            case 56: return launch_c<56, LABELED, WITH_LSE>(a);                        \
            case 64: return launch_c<64, LABELED, WITH_LSE>(a);                        \
            case 72: return launch_c<72, LABELED, WITH_LSE>(a);                        \
            case 80: return launch_c<80, LABELED, WITH_LSE>(a);                        \
            case 88: return launch_c<88, LABELED, WITH_LSE>(a);                        \
            case 96: return launch_c<96, LABELED, WITH_LSE>(a);                        \
            case 104: return launch_c<104, LABELED, WITH_LSE>(a);                      \
            case 112: return launch_c<112, LABELED, WITH_LSE>(a);                      \
            case 120: return launch_c<120, LABELED, WITH_LSE>(a);                      \
            case 128: return launch_c<128, LABELED, WITH_LSE>(a);                      \
            default: return cudaErrorInvalidValue;                                     \
        }                                                                              \
    }                                                                                  \
    }

}  // namespace idt_fa
