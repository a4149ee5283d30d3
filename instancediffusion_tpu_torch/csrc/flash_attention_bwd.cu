// Backward of flash attention on strided (batch, head, row) views: the dq
// kernel and the dk/dv kernel, bf16 in and out, fp32 accumulation.
//
// Replaces instancediffusion_tpu/kernels/flash_attention.py::_flash_bwd:
// _bwd_dq_kernel and _bwd_dkv_kernel, unlabeled (behind
// flash_attention_trainable) and with labeled=True (behind
// flash_attention_trainable_labeled; template flag LABELED here, the same
// keep predicate as the forward: open_i | open_j | (bits_i & bits_j) != 0 |
// i == j, with i a q row and j a key, both sequence positions).
//
// Inputs: q, k, v, dO (bf16, unscaled q), the forward's fp32 log-sum-exp
// lse (base 2 of the scaled scores, see flash_attention.cu) and delta =
// rowsum(dO * O) in fp32, both (B*H, N). With s = q k^T:
//   p  = exp2(s * scale * log2(e) - lse)     (the forward's probabilities)
//   dp = dO v^T,  ds = p * (dp - delta)
//   dq = scale * ds k,  dk = scale * ds^T q,  dv = p^T dO
// Masked pairs (kv_len, labels) and q rows >= N contribute 0; a masked
// score never enters exp2, so a row with no kept key (lse = -inf) gives 0
// and not NaN. ds and p are rounded to bf16 before their products, as the
// TPU kernels round them to the input type.
//
// Design: the plain recompute one (FlashAttention-2's backward without
// atomics). The dq kernel owns 64 q rows per block (grid ceil(N/64) x
// B*H), holds their q and dO fragments and loops over 64-key tiles; the
// dk/dv kernel owns 64 keys per block (grid ceil(kv_len/64) x B*H), holds
// their k and v fragments and loops over 32-row q tiles. Each block owns
// its output rows, so there are no atomics and no second pass: that is
// Hopper's counterpart of the TPU's sequential grid. Both kernels recompute
// s and dp, so the pair does 14*N*M*c FLOPs per head where one fused pass
// would do 10. Each warp holds 16 rows in mma.sync m16n8k16 fragments, as
// in the forward; tiles come from shared memory through ldmatrix; c=40 is
// zero-padded to DP=48 in shared memory only.
//
// Bound on the H100: tensor-core FLOPs (dq: 6*N*M*c, dk/dv: 8*N*M*c per
// head against 2*(2N + 2M)*c bytes of bf16 operands, far above the ~295
// FLOP/byte ridge). Loads are not overlapped with the products: a later
// change, like wgmma and TMA.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr int kRows = 64;      // dq: q rows per block; dk/dv: keys per block
constexpr int kKT = 64;        // dq: keys per tile
constexpr int kQT = 32;        // dk/dv: q rows per tile
constexpr float kLog2e = 1.4426950408889634f;

// (batch, head, row) element strides of q, k, v, dO, dq, dk, dv in order
struct Strides {
    long long s[21];
};

// Copy ROWS rows of c bf16 values starting at row r0 into a DP-wide shared
// tile of pitch DP + 8; rows >= limit and columns >= c are zero.
template <int DP, int ROWS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long row_stride, int r0, int limit, int c) {
    constexpr int kVec = DP / 8;
    for (int idx = threadIdx.x; idx < ROWS * kVec; idx += kThreads) {
        const int r = idx / kVec;
        const int col = (idx % kVec) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (r0 + r < limit && col < c)
            val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * row_stride + col);
        *reinterpret_cast<uint4*>(dst + r * (DP + 8) + col) = val;
    }
}

// A fragments of rows r0 .. r0 + 15 of a shared tile (16 x DP)
template <int DP>
__device__ __forceinline__ void load_a(uint32_t (&f)[DP / 16][4], const __nv_bfloat16* tile,
                                       int r0, int lane) {
    const int lm = lane >> 3, lr = lane & 7;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
        ldsm_x4(f[kk], tile + (r0 + (lm & 1) * 8 + lr) * (DP + 8) + kk * 16 + (lm >> 1) * 8);
}

// acc (16 x 8*NS) += A (16 x DP) * T^T, T a shared tile of 8*NS rows x DP
template <int DP, int NS>
__device__ __forceinline__ void mma_abt(float (&acc)[NS][4], const uint32_t (&a)[DP / 16][4],
                                        const __nv_bfloat16* tile, int lane) {
    const int lm = lane >> 3, lr = lane & 7;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < NS; j += 2) {
            uint32_t bf[4];  // b0/b1 of column tiles j and j + 1
            ldsm_x4(bf, tile + ((j + (lm >> 1)) * 8 + lr) * (DP + 8) + kk * 16 + (lm & 1) * 8);
            mma_bf16(acc[j], a[kk], bf[0], bf[1]);
            mma_bf16(acc[j + 1], a[kk], bf[2], bf[3]);
        }
    }
}

// acc (16 x DP) += P (16 x 8*NS, bf16 pairs: pf[j][0] row g, pf[j][1] row
// g + 8 of column tile j) * T, T a shared tile of 8*NS rows x DP read
// transposed
template <int DP, int NS>
__device__ __forceinline__ void mma_pt(float (&acc)[DP / 8][4], const uint32_t (&pf)[NS][2],
                                       const __nv_bfloat16* tile, int lane) {
    const int lm = lane >> 3, lr = lane & 7;
#pragma unroll
    for (int kc = 0; kc < NS / 2; ++kc) {
        const uint32_t pa[4] = {pf[2 * kc][0], pf[2 * kc][1], pf[2 * kc + 1][0],
                                pf[2 * kc + 1][1]};
#pragma unroll
        for (int d = 0; d < DP / 8; d += 2) {
            uint32_t tf[4];
            ldsm_x4_trans(tf, tile + (kc * 16 + (lm & 1) * 8 + lr) * (DP + 8) + (d + (lm >> 1)) * 8);
            mma_bf16(acc[d], pa, tf[0], tf[1]);
            mma_bf16(acc[d + 1], pa, tf[2], tf[3]);
        }
    }
}

__device__ __forceinline__ bool label_keep(int bits_i, int open_i, int bits_j, int open_j, int i,
                                           int j) {
    return open_i > 0 || open_j > 0 || (bits_i & bits_j) != 0 || i == j;
}

// Store a 16 x DP fp32 accumulator (rows row_lo, row_lo + 8 of this lane)
// times mul as bf16; rows >= limit and columns >= c are not written.
template <int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long long row_stride,
                                           const float (&acc)[DP / 8][4], int row_lo, int limit,
                                           int c, int t, float mul) {
#pragma unroll
    for (int d = 0; d < DP / 8; ++d) {
        const int col = d * 8 + 2 * t;
        if (col >= c) continue;
        if (row_lo < limit)
            *reinterpret_cast<__nv_bfloat162*>(dst + (long long)row_lo * row_stride + col) =
                __floats2bfloat162_rn(acc[d][0] * mul, acc[d][1] * mul);
        if (row_lo + 8 < limit)
            *reinterpret_cast<__nv_bfloat162*>(dst + (long long)(row_lo + 8) * row_stride + col) =
                __floats2bfloat162_rn(acc[d][2] * mul, acc[d][3] * mul);
    }
}

template <int DP>
constexpr size_t dq_smem(bool labeled) {
    return sizeof(__nv_bfloat16) * (2 * kRows + 2 * kKT) * (DP + 8) +
           (labeled ? 2 * sizeof(int) * kKT : 0);
}

template <int DP>
constexpr size_t dkv_smem(bool labeled) {
    return sizeof(__nv_bfloat16) * (2 * kRows + 2 * kQT) * (DP + 8) + 2 * sizeof(float) * kQT +
           (labeled ? 2 * sizeof(int) * kQT : 0);
}

template <int DP, bool LABELED>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, const int* __restrict__ lbits,
    const int* __restrict__ lopen, int label_stride, int H, int N, int kv_len, int c,
    Strides st, float scale) {
    constexpr int LDB = DP + 8;
    constexpr int NS = kKT / 8;  // 8-wide score column tiles
    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* sO = sQ + kRows * LDB;  // dO
    __nv_bfloat16* sK = sO + kRows * LDB;
    __nv_bfloat16* sV = sK + kKT * LDB;
    int* sLB = reinterpret_cast<int*>(sV + kKT * LDB);  // key labels
    int* sLO = sLB + kKT;

    const long long* S = st.s;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int bh = blockIdx.y, b = bh / H, h = bh % H;
    const int q0 = blockIdx.x * kRows, wr = warp * 16;
    const int row_lo = q0 + wr + g, row_hi = row_lo + 8;

    load_rows<DP, kRows>(sQ, q + b * S[0] + h * S[1], S[2], q0, N, c);
    load_rows<DP, kRows>(sO, dout + b * S[9] + h * S[10], S[11], q0, N, c);
    // rows past N load zeros and are never stored
    const float* lb = lse + (long long)bh * N;
    const float* db = delta + (long long)bh * N;
    float lse_lo = 0.f, lse_hi = 0.f, d_lo = 0.f, d_hi = 0.f;
    if (row_lo < N) lse_lo = lb[row_lo], d_lo = db[row_lo];
    if (row_hi < N) lse_hi = lb[row_hi], d_hi = db[row_hi];
    int qb_lo = 0, qo_lo = 0, qb_hi = 0, qo_hi = 0;
    const int* bb = nullptr;
    const int* obl = nullptr;
    if constexpr (LABELED) {
        bb = lbits + (long long)b * label_stride;
        obl = lopen + (long long)b * label_stride;
        if (row_lo < N) qb_lo = bb[row_lo], qo_lo = obl[row_lo];
        if (row_hi < N) qb_hi = bb[row_hi], qo_hi = obl[row_hi];
    }
    __syncthreads();
    uint32_t qf[DP / 16][4], of[DP / 16][4];
    load_a<DP>(qf, sQ, wr, lane);
    load_a<DP>(of, sO, wr, lane);

    float acc[DP / 8][4];
#pragma unroll
    for (int d = 0; d < DP / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
    const float sl2 = scale * kLog2e;
    const __nv_bfloat16* kb = k + b * S[3] + h * S[4];
    const __nv_bfloat16* vb = v + b * S[6] + h * S[7];

    for (int k0 = 0; k0 < kv_len; k0 += kKT) {
        __syncthreads();  // previous tile's reads are done
        load_rows<DP, kKT>(sK, kb, S[5], k0, kv_len, c);
        load_rows<DP, kKT>(sV, vb, S[8], k0, kv_len, c);
        if constexpr (LABELED) {
            if (threadIdx.x < kKT) {
                const int j = k0 + threadIdx.x;
                sLB[threadIdx.x] = j < kv_len ? bb[j] : 0;
                sLO[threadIdx.x] = j < kv_len ? obl[j] : 0;
            }
        }
        __syncthreads();

        float sf[NS][4], dpf[NS][4];  // S = Q K^T and dP = dO V^T
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) sf[j][e] = dpf[j][e] = 0.f;
        mma_abt<DP, NS>(sf, qf, sK, lane);
        mma_abt<DP, NS>(dpf, of, sV, lane);

        uint32_t dsf[NS][2];  // dS as bf16 pairs, rows g and g + 8
#pragma unroll
        for (int j = 0; j < NS; ++j) {
            float ds[4];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int col = k0 + j * 8 + 2 * t + e;
                bool keep_lo = col < kv_len, keep_hi = keep_lo;
                if constexpr (LABELED) {
                    const int kbits = sLB[j * 8 + 2 * t + e], kopen = sLO[j * 8 + 2 * t + e];
                    keep_lo = keep_lo && label_keep(qb_lo, qo_lo, kbits, kopen, row_lo, col);
                    keep_hi = keep_hi && label_keep(qb_hi, qo_hi, kbits, kopen, row_hi, col);
                }
                const float p_lo = keep_lo ? exp2f(sf[j][e] * sl2 - lse_lo) : 0.f;
                const float p_hi = keep_hi ? exp2f(sf[j][2 + e] * sl2 - lse_hi) : 0.f;
                ds[e] = p_lo * (dpf[j][e] - d_lo);
                ds[2 + e] = p_hi * (dpf[j][2 + e] - d_hi);
            }
            dsf[j][0] = pack_bf16(ds[0], ds[1]);
            dsf[j][1] = pack_bf16(ds[2], ds[3]);
        }
        mma_pt<DP, NS>(acc, dsf, sK, lane);  // dQ += dS K
    }
    store_rows<DP>(dq + b * S[12] + h * S[13], S[14], acc, row_lo, N, c, t, scale);
}

template <int DP, bool LABELED>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    const int* __restrict__ lbits, const int* __restrict__ lopen, int label_stride, int H,
    int N, int kv_len, int c, Strides st, float scale) {
    constexpr int LDB = DP + 8;
    constexpr int NS = kQT / 8;  // 8-wide q column tiles
    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* sV = sK + kRows * LDB;
    __nv_bfloat16* sQ = sV + kRows * LDB;
    __nv_bfloat16* sO = sQ + kQT * LDB;  // dO
    float* sL = reinterpret_cast<float*>(sO + kQT * LDB);  // lse of the q tile
    float* sD = sL + kQT;                                  // delta of the q tile
    int* sQB = reinterpret_cast<int*>(sD + kQT);           // q labels
    int* sQO = sQB + kQT;

    const long long* S = st.s;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int bh = blockIdx.y, b = bh / H, h = bh % H;
    const int k0 = blockIdx.x * kRows, wr = warp * 16;
    const int key_lo = k0 + wr + g, key_hi = key_lo + 8;  // this lane's keys

    load_rows<DP, kRows>(sK, k + b * S[3] + h * S[4], S[5], k0, kv_len, c);
    load_rows<DP, kRows>(sV, v + b * S[6] + h * S[7], S[8], k0, kv_len, c);
    int kb_lo = 0, ko_lo = 0, kb_hi = 0, ko_hi = 0;
    const int* bb = nullptr;
    const int* obl = nullptr;
    if constexpr (LABELED) {
        bb = lbits + (long long)b * label_stride;
        obl = lopen + (long long)b * label_stride;
        if (key_lo < kv_len) kb_lo = bb[key_lo], ko_lo = obl[key_lo];
        if (key_hi < kv_len) kb_hi = bb[key_hi], ko_hi = obl[key_hi];
    }
    __syncthreads();
    uint32_t kf[DP / 16][4], vf[DP / 16][4];
    load_a<DP>(kf, sK, wr, lane);
    load_a<DP>(vf, sV, wr, lane);

    float dka[DP / 8][4], dva[DP / 8][4];
#pragma unroll
    for (int d = 0; d < DP / 8; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) dka[d][e] = dva[d][e] = 0.f;
    const float sl2 = scale * kLog2e;
    const __nv_bfloat16* qb = q + b * S[0] + h * S[1];
    const __nv_bfloat16* ob = dout + b * S[9] + h * S[10];
    const float* lb = lse + (long long)bh * N;
    const float* db = delta + (long long)bh * N;

    for (int q0 = 0; q0 < N; q0 += kQT) {
        __syncthreads();  // previous tile's reads are done
        load_rows<DP, kQT>(sQ, qb, S[2], q0, N, c);
        load_rows<DP, kQT>(sO, ob, S[11], q0, N, c);
        if (threadIdx.x < kQT) {
            const int i = q0 + threadIdx.x;
            sL[threadIdx.x] = i < N ? lb[i] : 0.f;
            sD[threadIdx.x] = i < N ? db[i] : 0.f;
            if constexpr (LABELED) {
                sQB[threadIdx.x] = i < N ? bb[i] : 0;
                sQO[threadIdx.x] = i < N ? obl[i] : 0;
            }
        }
        __syncthreads();

        float sf[NS][4], dpf[NS][4];  // S^T = K Q^T and dP^T = V dO^T
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) sf[j][e] = dpf[j][e] = 0.f;
        mma_abt<DP, NS>(sf, kf, sQ, lane);
        mma_abt<DP, NS>(dpf, vf, sO, lane);

        uint32_t pf[NS][2], dsf[NS][2];  // P^T and dS^T as bf16 pairs
#pragma unroll
        for (int j = 0; j < NS; ++j) {
            float p[4], ds[4];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int ci = j * 8 + 2 * t + e;  // q row within the tile
                const int i = q0 + ci;
                bool keep_lo = i < N && key_lo < kv_len, keep_hi = i < N && key_hi < kv_len;
                if constexpr (LABELED) {
                    const int qbits = sQB[ci], qopen = sQO[ci];
                    keep_lo = keep_lo && label_keep(qbits, qopen, kb_lo, ko_lo, i, key_lo);
                    keep_hi = keep_hi && label_keep(qbits, qopen, kb_hi, ko_hi, i, key_hi);
                }
                p[e] = keep_lo ? exp2f(sf[j][e] * sl2 - sL[ci]) : 0.f;
                p[2 + e] = keep_hi ? exp2f(sf[j][2 + e] * sl2 - sL[ci]) : 0.f;
                ds[e] = p[e] * (dpf[j][e] - sD[ci]);
                ds[2 + e] = p[2 + e] * (dpf[j][2 + e] - sD[ci]);
            }
            pf[j][0] = pack_bf16(p[0], p[1]);
            pf[j][1] = pack_bf16(p[2], p[3]);
            dsf[j][0] = pack_bf16(ds[0], ds[1]);
            dsf[j][1] = pack_bf16(ds[2], ds[3]);
        }
        mma_pt<DP, NS>(dva, pf, sO, lane);   // dV += P^T dO
        mma_pt<DP, NS>(dka, dsf, sQ, lane);  // dK += dS^T Q
    }
    store_rows<DP>(dk + b * S[15] + h * S[16], S[17], dka, key_lo, kv_len, c, t, scale);
    store_rows<DP>(dv + b * S[18] + h * S[19], S[20], dva, key_lo, kv_len, c, t, 1.f);
}

struct BwdArgs {
    const void *q, *k, *v, *dout;
    const float *lse, *delta;
    void *dq, *dk, *dv;
    const int *bits, *open;
    int label_stride, B, H, N, kv_len, c;
    Strides st;
    float scale;
    cudaStream_t stream;
};

using bf16p = __nv_bfloat16*;
using cbf16p = const __nv_bfloat16*;

template <int DP, bool LABELED>
int launch_dq(const BwdArgs& a) {
    const size_t smem = dq_smem<DP>(LABELED);
    cudaError_t err = idt_allow_smem(flash_bwd_dq_kernel<DP, LABELED>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.N + kRows - 1) / kRows, a.B * a.H);
    flash_bwd_dq_kernel<DP, LABELED><<<grid, kThreads, smem, a.stream>>>(
        static_cast<cbf16p>(a.q), static_cast<cbf16p>(a.k), static_cast<cbf16p>(a.v),
        static_cast<cbf16p>(a.dout), a.lse, a.delta, static_cast<bf16p>(a.dq), a.bits, a.open,
        a.label_stride, a.H, a.N, a.kv_len, a.c, a.st, a.scale);
    return cudaGetLastError();
}

template <int DP, bool LABELED>
int launch_dkv(const BwdArgs& a) {
    const size_t smem = dkv_smem<DP>(LABELED);
    cudaError_t err = idt_allow_smem(flash_bwd_dkv_kernel<DP, LABELED>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.kv_len + kRows - 1) / kRows, a.B * a.H);
    flash_bwd_dkv_kernel<DP, LABELED><<<grid, kThreads, smem, a.stream>>>(
        static_cast<cbf16p>(a.q), static_cast<cbf16p>(a.k), static_cast<cbf16p>(a.v),
        static_cast<cbf16p>(a.dout), a.lse, a.delta, static_cast<bf16p>(a.dk),
        static_cast<bf16p>(a.dv), a.bits, a.open, a.label_stride, a.H, a.N, a.kv_len, a.c,
        a.st, a.scale);
    return cudaGetLastError();
}

template <int DP>
int dispatch(const BwdArgs& a, bool dkv) {
    const bool labeled = a.bits != nullptr;
    if (dkv) return labeled ? launch_dkv<DP, true>(a) : launch_dkv<DP, false>(a);
    return labeled ? launch_dq<DP, true>(a) : launch_dq<DP, false>(a);
}

int run(const BwdArgs& a, bool dkv) {
    if ((a.bits == nullptr) != (a.open == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
    switch ((a.c + 15) / 16) {
        case 1: return dispatch<16>(a, dkv);
        case 2: return dispatch<32>(a, dkv);
        case 3: return dispatch<48>(a, dkv);
        case 4: return dispatch<64>(a, dkv);
        case 5: return dispatch<80>(a, dkv);
        case 6: return dispatch<96>(a, dkv);
        case 7: return dispatch<112>(a, dkv);
        case 8: return dispatch<128>(a, dkv);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

BwdArgs make_args(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, void* dq, void* dk, void* dv,
                  const void* bits, const void* open, int label_stride, int B, int H, int N,
                  int kv_len, int c, const long long* strides, float scale, void* stream) {
    BwdArgs a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
              dq, dk, dv, static_cast<const int*>(bits), static_cast<const int*>(open),
              label_stride, B, H, N, kv_len, c, {}, scale, static_cast<cudaStream_t>(stream)};
    for (int i = 0; i < 21; ++i) a.st.s[i] = strides[i];
    return a;
}

}  // namespace

// strides: 21 element strides, (batch, head, row) for q, k, v, dO, dq, dk,
// dv in order (each launcher reads the ones it uses). lse, delta: fp32
// (B*H, N). bits/open: int32 labels as for idt_flash_attention, or both
// null. Requires c % 8 == 0, c <= 128, 16-byte aligned rows, kv_len >= 1.
IDT_EXPORT int idt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dq,
                                const void* bits, const void* open, int label_stride, int B,
                                int H, int N, int kv_len, int c, const long long* strides,
                                float scale, void* stream) {
    return run(make_args(q, k, v, dout, lse, delta, dq, nullptr, nullptr, bits, open,
                         label_stride, B, H, N, kv_len, c, strides, scale, stream),
               false);
}

IDT_EXPORT int idt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dk, void* dv, const void* bits, const void* open,
                                 int label_stride, int B, int H, int N, int kv_len, int c,
                                 const long long* strides, float scale, void* stream) {
    return run(make_args(q, k, v, dout, lse, delta, nullptr, dk, dv, bits, open, label_stride,
                         B, H, N, kv_len, c, strides, scale, stream),
               true);
}
