// The fused GEGLU feed-forward kernel for Hopper: out = (a * gelu(g)) @ w2^T
// + b2 with [a | g] = x @ w1^T + b1 and erf GELU, in one launch, with TMA
// loads from a producer warpgroup, wgmma products and two consumer
// warpgroups a block; at C = 640 two blocks of a cluster share one row tile.
//
// Replaces instancediffusion_tpu/kernels/geglu_ff.py::fused_ff_geglu
// (_ff_kernel). The TPU kernel used tanh-GELU only because Mosaic lowers no
// erf; the model's formula (and the JAX fallback _apply_ff_geglu) is erf.
//
// What bounds it. A call does 6*M*C*I FLOPs (I = 4C) on 4*M*C bytes of
// activations and 6*C*I of weights: 1920 FLOPs per activation byte at C = 320,
// far above the card's 295, so device memory never bounds it, and the loads
// hide behind the products. The limits are inside the SM (PERF.md has the
// times):
//   - Registers decide the shape. ptxas gives a block of more than 256
//     threads 168 registers a thread (setmaxnreg does not raise its budget,
//     and 288 threads are allotted registers like 384), and a 256-thread
//     block has no warp to spare for the loads: a consumer thread that also
//     issued them cost more than half the kernel's time in hand-offs. So the
//     block has a producer warpgroup, and the consumers' fp32 output tile
//     (64 rows x its columns over two warpgroups) and first product's tile
//     (32 registers) must fit 168: at most 320 output columns a block. At
//     C = 640 a cluster of two blocks takes the same 64 rows, each block 320
//     output columns, and each computes half of every gated tile and writes
//     it into both blocks' shared memory, so no product is done twice.
//     C = 1280 is not served: x alone (64 x 1280) is 160 KB of each block's
//     shared memory; `ff_fits` sends it to the unfused route.
//   - Shared-memory bytes per product. A wgmma with both operands in shared
//     memory reads 64 x 16 of A and N x 16 of B for 64 x N x 16 products; at
//     N = 64 that is the SM's whole shared-memory rate, so the first
//     product (two thirds of the FLOPs) cannot reach the tensor cores' full
//     rate; the second runs at N = 160.
//   - The gate. One erf per gated element beside bias adds, packing and the
//     store: the warpgroups gate at the same time (they exchange the gated
//     tile every turn), so most of its time adds to the products'; only the
//     second product of the turn before overlaps it.
//   - Shared memory at C = 640: x (80 KB), two gated tiles (32 KB) and one
//     turn of w2 (80 KB) leave the w1 ring 4 slots, two a warpgroup, so the
//     first product there waits for its loads.
//   - A cluster whose blocks took different rows and multicast each weight
//     tile was built and measured: it divides the L2 reads, which are not the
//     limit, and makes every slot wait for the slowest block. Slower; removed.
// The design: no fp32 partial and no (M, 2I) intermediate leaves the SM. A
// cluster of CL blocks (1, or 2 at C = 640) owns 64 rows; x (64 x C) is loaded
// once into every block and stays in shared memory. The inner dimension is a
// loop inside the block, P = 64 CL columns per turn, and the 2 CL consumer
// warpgroups of the cluster split the columns of both products:
//   first product: warpgroup q multiplies x by the rows of w1 that give a
//     and g of its 32 columns of the turn (one m64n64k16 per 16 columns of C;
//     a in the low half of the tile, g in the high half, so a thread holds a
//     and g of the same element), adds the bias, applies a * gelu(g) in
//     registers and stores the bf16 result into the turn's gated tile (64 x
//     P, 128-byte swizzle, written by hand, double-buffered) in its own
//     block's shared memory and, through the cluster's address window, in
//     the other block's;
//   they meet: the two warpgroups of a lone block on a named barrier, those
//     of a cluster on an mbarrier in every block on which each warp arrives
//     (release, cluster scope) once its stores are out;
//   second product: each multiplies the whole gated tile by its own C / (2 CL)
//     rows of w2 (m64n160k16 at C = 320 and 640) into its fp32 output tile,
//     which stays in registers for the whole loop. A turn issues the next
//     turn's first product and then this turn's second back to back and
//     waits only for the first, so the next gate runs while the second
//     product is still on the tensor cores.
// Weights stream through two rings of swizzled slots, w1 tiles (the 32 a
// rows and the 32 g rows x 64 columns, 8 KB) and w2 slots (a warpgroup's
// C / (2 CL) rows x the turn's columns, one tile per 64), each filled by one
// thread of the producer warpgroup with TMA in the order the consumers use
// them and completed on mbarriers; the warpgroups take alternate slots. A
// slot is freed by one arrival per consumer warp once the wgmma group that
// read it has completed.
#pragma once

#include <type_traits>

#include "sm90.cuh"

namespace idt_ff {

// 2 consumer warpgroups, and a third of which two threads issue the loads
constexpr int kThreads = 384;
constexpr int kChunk = 64 * 128;   // 64 rows x 64 bf16 columns, 128-byte swizzle
constexpr int kSmemCap = 232448;   // shared memory a block can use
constexpr int kBarAg = 1;          // named barrier: the consumers publish the gated tile
constexpr int kRows = 64;          // rows per cluster
constexpr int kGated = 32;         // gated columns per warpgroup and turn
constexpr int kMaxBlockCols = 320; // output columns a block's registers hold

struct Params {
    __nv_bfloat16* out;
    const void* b1;
    const void* b2;
    int bias_fp32;  // b1, b2 are fp32 (1) or bf16 (0), as the module keeps them
    int M, I;
};

template <int C>
struct Layout {
    static constexpr int CL = (C + kMaxBlockCols - 1) / kMaxBlockCols;  // blocks a cluster
    static_assert(C % 64 == 0 && CL <= 2, "C in 64-column blocks, at most two blocks a cluster");
    static constexpr int KS = C / 64;             // 64-column slices of x and w1
    static constexpr int NC = C / (2 * CL);       // output columns per warpgroup and wgmma
    static_assert(NC % 8 == 0, "a w2 tile is whole 8-row swizzle blocks");
    static constexpr int P = 2 * CL * kGated;     // inner columns per turn
    static constexpr int KP = P / 64;             // 64-column chunks of the gated tile
    static constexpr int slot1 = 2 * kGated * 128;  // w1 slot: the a rows, then the g rows
    static constexpr int tile2 = NC * 128;          // w2 tile: a warpgroup's rows x 64 columns
    static constexpr int slot2 = KP * tile2;        // w2 slot: a warpgroup's tiles of one turn
    static constexpr int n1 = 2 * KS;             // w1 slots per turn (both warpgroups)
    static constexpr int S2 = 4 / KP;             // w2 slots: two turns a warpgroup, or one
    static constexpr int x_bytes = KS * kChunk;
    static constexpr int ag_off = x_bytes;        // gated tile, double-buffered
    static constexpr int ring2 = ag_off + 2 * KP * kChunk;
    static constexpr int ring1 = ring2 + S2 * slot2;
    static constexpr int fit = (kSmemCap - 1024 - 256 - ring1) / slot1;
    static constexpr int S1 = (fit < 16 ? fit : 16) & ~1;  // even: a warpgroup takes every other
    static_assert(S1 >= 4, "w1 ring too short");
    static constexpr int bars = ring1 + S1 * slot1;
    static constexpr int n_bars = 2 * S1 + 2 * S2 + 1 + 2;  // rings, x, the two gated tiles
    // + 1 KB to align the base: the 128-byte swizzle repeats every 1024 bytes
    static constexpr int bytes = bars + n_bars * 8 + 1024;
    static_assert(bytes <= kSmemCap, "shared memory");
};

// x Phi(x) with erf as z P(z^2) / Q(z^2), z clamped to [-4, 4]: the fp32
// rational approximation XLA evaluates for lax.erf (what jax.nn.gelu(
// approximate=False) computes in the JAX package), no branch, one division;
// CUDA's erff takes two branches and measured slower here
__device__ __forceinline__ float gelu_erf(float v) {
    const float z = fminf(fmaxf(v * 0.70710678118654752f, -4.f), 4.f);
    const float z2 = z * z;
    float a = fmaf(z2, -2.72614225801306e-10f, 2.77068142495902e-08f);
    a = fmaf(a, z2, -2.10102402082508e-06f);
    a = fmaf(a, z2, -5.69250639462346e-05f);
    a = fmaf(a, z2, -7.34990630326855e-04f);
    a = fmaf(a, z2, -2.95459980854025e-03f);
    a = fmaf(a, z2, -1.60960333262415e-02f);
    float b = fmaf(z2, -1.45660718464996e-05f, -2.13374055278905e-04f);
    b = fmaf(b, z2, -1.68282697438203e-03f);
    b = fmaf(b, z2, -7.37332916720468e-03f);
    b = fmaf(b, z2, -1.42647390514189e-02f);
    return 0.5f * v * (1.f + __fdividef(a * z, b));
}

// two neighbouring values of a bias (i even), read as stored
template <bool FP32>
__device__ __forceinline__ float2 ld_bias2(const void* b, int i) {
    if constexpr (FP32) {
        return *reinterpret_cast<const float2*>(static_cast<const float*>(b) + i);
    } else {
        return __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(static_cast<const __nv_bfloat16*>(b) + i));
    }
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) reg_fence(r[i]);
}

template <int C, bool BIAS_FP32>
__global__ void __launch_bounds__(kThreads, 1)
    geglu_ff_sm90(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw1,
                  const __grid_constant__ CUtensorMap tw2, const Params p) {
    using L = Layout<C>;
    constexpr int S1 = L::S1, S2 = L::S2, KS = L::KS, NC = L::NC, KP = L::KP, CL = L::CL,
                  GH = kGated;
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    // the same offset in every block of a cluster: the kernel's shared memory
    // starts at the same address in each
    const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
    unsigned char* smem = smem_raw + pad;
    const uint32_t sbase = smem_u32(smem);
    const uint32_t full1 = sbase + L::bars, empty1 = full1 + S1 * 8, full2 = empty1 + S1 * 8,
                   empty2 = full2 + S2 * 8, xbar = empty2 + S2 * 8, agbar = xbar + 8;
    const uint32_t rank = CL > 1 ? cluster_ctarank() : 0;  // which columns of the row tile
    const int m0 = (blockIdx.x / CL) * kRows;
    const int turns = p.I / L::P;

    if (threadIdx.x == 0) {
        uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::bars);
        // a slot is read by one warpgroup: 4 warps, one arrival each
        for (int s = 0; s < S1; ++s) {
            mbar_init(bar + s, 1);
            mbar_init(bar + S1 + s, 4);
        }
        for (int s = 0; s < S2; ++s) {
            mbar_init(bar + 2 * S1 + s, 1);
            mbar_init(bar + 2 * S1 + S2 + s, 4);
        }
        mbar_init(bar + 2 * S1 + 2 * S2, 1);
        // a gated tile is written by the 8 consumer warps of every block
        mbar_init(bar + 2 * S1 + 2 * S2 + 1, 8 * CL);
        mbar_init(bar + 2 * S1 + 2 * S2 + 2, 8 * CL);
        mbar_fence_init();
    }
    __syncthreads();
    if constexpr (CL > 1) cluster_sync();  // no arrival on a barrier the other block has not set up

    if (threadIdx.x >= 256) {
        // The producers, one thread a ring, each in the order the consumers
        // use its slots: x and then per turn the w1 slots (k-slice by
        // k-slice, warpgroup 0's then warpgroup 1's); per turn the w2 slots
        // (chunk by chunk of the gated tile, warpgroup 0's then 1's).
        if (threadIdx.x == 256) {
            mbar_expect_tx_at(xbar, L::x_bytes);
            for (int k = 0; k < KS; ++k) tma_load_2d_at(sbase + k * kChunk, &tx, xbar, k * 64, m0);
            int s1 = 0;
            uint32_t ph1 = 1;  // parity of the phase that frees a slot (first pass: free)
            for (int tn = 0; tn < turns; ++tn)
                for (int j = 0; j < L::n1; ++j) {
                    mbar_wait_at(empty1 + s1 * 8, ph1);
                    const int k = j >> 1, w = j & 1;
                    const int a0 = tn * L::P + (rank * 2 + w) * GH;
                    const uint32_t dst = sbase + L::ring1 + s1 * L::slot1, bar = full1 + s1 * 8;
                    mbar_expect_tx_at(bar, L::slot1);
                    tma_load_2d_at(dst, &tw1, bar, k * 64, a0);
                    tma_load_2d_at(dst + GH * 128, &tw1, bar, k * 64, p.I + a0);
                    if (++s1 == S1) {
                        s1 = 0;
                        ph1 ^= 1;
                    }
                }
        } else if (threadIdx.x == 288) {
            int s2 = 0;
            uint32_t ph2 = 1;
            for (int tn = 0; tn < turns; ++tn)
                for (int w = 0; w < 2; ++w) {
                    mbar_wait_at(empty2 + s2 * 8, ph2);
                    const uint32_t bar = full2 + s2 * 8;
                    mbar_expect_tx_at(bar, L::slot2);
                    for (int kc = 0; kc < KP; ++kc)
                        tma_load_2d_at(sbase + L::ring2 + s2 * L::slot2 + kc * L::tile2, &tw2, bar,
                                       tn * L::P + kc * 64, (rank * 2 + w) * NC);
                    if (++s2 == S2) {
                        s2 = 0;
                        ph2 ^= 1;
                    }
                }
        }
        __syncwarp();
    } else {
        const int wgi = threadIdx.x >> 7;  // warpgroup 0 or 1 of the block
        const int q = rank * 2 + wgi;      // and of the cluster
        const int tid = threadIdx.x & 127;
        const int warp = tid >> 5, lane = tid & 31;
        const int g = lane >> 2, t = lane & 3;
        const int lrow = warp * 16 + g;  // row within the cluster's 64 (and + 8)
        const uint64_t dx0 = wgmma_desc_sw128(sbase, 16, 1024);
        const uint64_t dag0 = wgmma_desc_sw128(sbase + L::ag_off, 16, 1024);
        const uint64_t dr1 = wgmma_desc_sw128(sbase + L::ring1, 16, 1024);
        const uint64_t dr2 = wgmma_desc_sw128(sbase + L::ring2, 16, 1024);

        float acc[NC / 2];
#pragma unroll
        for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
        float h[GH];  // this warpgroup's 64 x [a GH | g GH] tile of the first product

        // the rings as this warpgroup walks them: every other slot
        int s1 = wgi, s2 = wgi;
        uint32_t ph1 = 0, ph2 = 0;
        // the slot of the newest committed wgmma group; freed once the next
        // group is committed and all older ones have completed (deeper
        // queues of groups in flight measured no faster)
        uint32_t pending = 0;
        auto release = [&](uint32_t empty_bar) {
            if (lane == 0) mbar_arrive_at(empty_bar);
        };
        auto committed = [&](uint32_t empty_bar, bool have_pending) {
            wgmma_commit();
            if (have_pending) {
                wgmma_wait<1>();
                release(pending);
            }
            pending = empty_bar;
        };
        auto drain = [&]() {
            wgmma_wait<0>();
            release(pending);
        };

        // h = x @ [a | g rows of w1]^T for the next turn of the stream
        auto gemm1 = [&](bool have_pending) {
#pragma unroll
            for (int k = 0; k < KS; ++k) {
                mbar_wait_at(full1 + s1 * 8, ph1);
                const uint64_t da = dx0 + static_cast<uint64_t>(k * (kChunk >> 4));
                const uint64_t db = dr1 + static_cast<uint64_t>(s1 * (L::slot1 >> 4));
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                    wgmma_ss<2 * GH>(h, da + 2 * kk, db + 2 * kk, k > 0 || kk > 0);
                committed(empty1 + s1 * 8, have_pending || k > 0);
                s1 += 2;
                if (s1 >= S1) {
                    s1 -= S1;
                    ph1 ^= 1;
                }
            }
        };
        // out[:, own columns] += gated tile (shared) @ w2[own rows, turn]^T,
        // one wgmma group over the tile's chunks
        auto gemm2 = [&](int tn, bool have_pending) {
            mbar_wait_at(full2 + s2 * 8, ph2);
            const uint64_t da = dag0 + static_cast<uint64_t>((tn & 1) * KP * (kChunk >> 4));
            const uint64_t db = dr2 + static_cast<uint64_t>(s2 * (L::slot2 >> 4));
            wgmma_fence();
#pragma unroll
            for (int kc = 0; kc < KP; ++kc)
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                    wgmma_ss<NC>(acc, da + kc * (kChunk >> 4) + 2 * kk,
                                 db + kc * (L::tile2 >> 4) + 2 * kk, 1);
            committed(empty2 + s2 * 8, have_pending);
            s2 += 2;
            if (s2 >= S2) {
                s2 -= S2;
                ph2 ^= 1;
            }
        };
        // bias, a * gelu(g) in fp32 (exact erf), rounded once to bf16, into
        // this warpgroup's columns of the turn's gated tile, in every block
        auto gate = [&](int tn) {
            const int i0 = tn * L::P + q * GH;
            const uint32_t row_off = L::ag_off + (tn & 1) * (KP * kChunk) + lrow * 128 + t * 4;
#pragma unroll
            for (int jj = 0; jj < GH / 8; ++jj) {
                const int col = i0 + jj * 8 + 2 * t;
                const float2 ba = ld_bias2<BIAS_FP32>(p.b1, col);
                const float2 bg = ld_bias2<BIAS_FP32>(p.b1, p.I + col);
                const float y0 = (h[4 * jj] + ba.x) * gelu_erf(h[GH / 2 + 4 * jj] + bg.x);
                const float y1 = (h[4 * jj + 1] + ba.y) * gelu_erf(h[GH / 2 + 4 * jj + 1] + bg.y);
                const float y2 = (h[4 * jj + 2] + ba.x) * gelu_erf(h[GH / 2 + 4 * jj + 2] + bg.x);
                const float y3 = (h[4 * jj + 3] + ba.y) * gelu_erf(h[GH / 2 + 4 * jj + 3] + bg.y);
                // rows lrow and lrow + 8 (the same swizzle phase g), 16-byte
                // piece pc of the tile's row (8 pieces a chunk), 4 bytes at 2 t
                const int pc = q * (GH / 8) + jj;
                const uint32_t off = row_off + (pc >> 3) * kChunk + (((pc & 7) ^ g) << 4);
                const uint32_t lo = pack_bf16(y0, y1), hi = pack_bf16(y2, y3);
                *reinterpret_cast<uint32_t*>(smem + off) = lo;
                *reinterpret_cast<uint32_t*>(smem + off + 1024) = hi;
                if constexpr (CL > 1) {
                    const uint32_t there = cluster_map(sbase + off, rank ^ 1);
                    st_cluster_u32(there, lo);
                    st_cluster_u32(there + 1024, hi);
                }
            }
        };
        // every consumer warpgroup of the cluster has written tile `tn`
        auto publish = [&](int tn) {
            if constexpr (CL == 1) {
                fence_proxy_async();
                named_bar_sync(kBarAg, 256);
            } else {
                const uint32_t bar = agbar + (tn & 1) * 8;
                fence_proxy_async_cluster();
                __syncwarp();
                if (lane < CL) mbar_arrive_cluster(cluster_map(bar, lane));
                mbar_wait_cluster_at(bar, (tn >> 1) & 1);
                fence_proxy_async();
            }
        };

        mbar_wait_at(xbar, 0);
        fence_regs(h);
        gemm1(false);
        drain();
        fence_regs(h);
        // One turn: gate its tile (while the turn before it is still being
        // multiplied into the output: the second product is the last thing a
        // turn issues and is not waited for), publish, run the next turn's
        // first product and then this turn's second. A warpgroup has finished
        // reading a gated tile before it arrives for the next, so two tiles
        // are enough, also across the blocks of a cluster.
        auto turn = [&](int tn, auto first, auto last) {
            gate(tn);
            if constexpr (!decltype(first)::value) {
                drain();  // the second product of the turn before
                fence_regs(acc);
            }
            publish(tn);
            fence_regs(h);
            if constexpr (!decltype(last)::value) gemm1(false);
            gemm2(tn, !decltype(last)::value);  // waits for the first product, not for itself
            fence_regs(h);
        };
        if (turns == 1) {
            turn(0, std::true_type{}, std::true_type{});
        } else {
            turn(0, std::true_type{}, std::false_type{});
            for (int tn = 1; tn + 1 < turns; ++tn) turn(tn, std::false_type{}, std::false_type{});
            turn(turns - 1, std::false_type{}, std::true_type{});
        }
        drain();
        fence_regs(acc);

        // + b2, one rounding, store
        const int row_lo = m0 + lrow, row_hi = row_lo + 8;
#pragma unroll
        for (int jj = 0; jj < NC / 8; ++jj) {
            const int col = q * NC + jj * 8 + 2 * t;
            const float2 c2 = ld_bias2<BIAS_FP32>(p.b2, col);
            const float c0 = c2.x, c1 = c2.y;
            if (row_lo < p.M)
                *reinterpret_cast<__nv_bfloat162*>(p.out + (long long)row_lo * C + col) =
                    __floats2bfloat162_rn(acc[4 * jj] + c0, acc[4 * jj + 1] + c1);
            if (row_hi < p.M)
                *reinterpret_cast<__nv_bfloat162*>(p.out + (long long)row_hi * C + col) =
                    __floats2bfloat162_rn(acc[4 * jj + 2] + c0, acc[4 * jj + 3] + c1);
        }
    }
    // no block leaves while the other may still write to its shared memory
    if constexpr (CL > 1) cluster_sync();
}

// Everything a launch needs; the tensor maps are encoded on the host.
struct Launch {
    CUtensorMap tx, tw1, tw2;
    Params p;
    cudaStream_t stream;
};

template <int C>
cudaError_t launch_c(const Launch& a) {
    using L = Layout<C>;
    auto kern = a.p.bias_fp32 ? geglu_ff_sm90<C, true> : geglu_ff_sm90<C, false>;
    cudaError_t err = idt_allow_smem(kern, L::bytes);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg{};
    cfg.gridDim = dim3((a.p.M + kRows - 1) / kRows * L::CL);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = L::bytes;
    cfg.stream = a.stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = L::CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kern, a.tx, a.tw1, a.tw2, a.p);
}

// the rows of a w1 / w2 box the tensor maps must have for these constants
template <int C>
constexpr int w1_box_rows() { return kGated; }
template <int C>
constexpr int w2_box_rows() { return Layout<C>::NC; }
// the inner width must be whole turns
template <int C>
constexpr int turn_cols() { return Layout<C>::P; }

// One instantiation per source (geglu_ff_c*.cu), so nvcc compiles them in
// parallel.
template <int C>
cudaError_t launch(const Launch& a);

#define IDT_FF_INSTANTIATE(C)                  \
    namespace idt_ff {                         \
    template <>                                \
    cudaError_t launch<C>(const Launch& a) {   \
        return launch_c<C>(a);                 \
    }                                          \
    }

}  // namespace idt_ff
