// Forward flash attention on strided (batch, head, row) views, bf16 in/out.
//
// Replaces instancediffusion_tpu/kernels/flash_attention.py::flash_attention
// (_flash_kernel) and ::flash_attention_packed (_flash_kernel_packed): the
// two compute the same function on the (B,H,N,c) and (B,N,H*c) layouts, so
// one kernel takes base pointers plus (batch, head, row) element strides and
// serves both. The head dim must be contiguous.
//
// Bound on the H100: tensor-core FLOPs. At ds1 (N=4096, c=40) a (q-tile x
// full K) pass does 4*N*M*c FLOPs against 2*(N+2M)*c bytes of bf16 input,
// far above the card's ~295 FLOP/byte ridge. The design keeps the (N x M)
// score matrix out of device memory and out of shared memory
// (FlashAttention-2 layout): each warp owns 16 query rows, and its scores
// S, probabilities P and fp32 output O live in the registers of mma.sync
// m16n8k16 fragments; the online softmax (fp32, as on the TPU) reduces
// across the 4 lanes that share a row. Q, K and V tiles come from shared
// memory through ldmatrix (transposed for V). c=40 is not a multiple of 16,
// so the head dim is zero-padded to DP (48 for c=40) in shared memory only;
// HBM keeps c.
//
// Grid (ceil(N/64), B*H). A block of 4 warps owns 64 query rows and loops
// over 64-key tiles of [0, kv_len); the next tile's K/V loads into
// registers start before the current tile computes. Keys at or above
// kv_len are never loaded and score -inf, so a caller may pass a ragged kv
// sequence or one pre-padded past kv_len.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // 4 warps x 16 query rows
constexpr float kLog2e = 1.4426950408889634f;

template <int DP>
struct Smem {
    static constexpr int LDB = DP + 8;  // bf16 row pitch (16-byte rows, no ldmatrix conflicts)
    static constexpr size_t q = 0;
    static constexpr size_t k = q + sizeof(__nv_bfloat16) * kBQ * LDB;
    static constexpr size_t v = k + sizeof(__nv_bfloat16) * kBK * LDB;
    static constexpr size_t bytes = v + sizeof(__nv_bfloat16) * kBK * LDB;
};

// One thread's share of a 64-row tile of c bf16 values (c % 8 == 0), held
// in registers so the next tile's global loads overlap the current tile's
// products; rows >= limit and columns >= c are zero.
template <int DP>
struct TileRegs {
    static constexpr int kVec = DP / 8;                 // 16-byte vectors per row
    static constexpr int kPer = kBK * kVec / kThreads;  // per thread (DP / 16)
    uint4 v[kPer];

    __device__ __forceinline__ void fetch(const __nv_bfloat16* src, long long row_stride,
                                          int r0, int limit, int c) {
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
            const int idx = threadIdx.x + e * kThreads;
            const int r = idx / kVec;
            const int col = (idx % kVec) * 8;
            v[e] = make_uint4(0u, 0u, 0u, 0u);
            if (r0 + r < limit && col < c)
                v[e] = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * row_stride + col);
        }
    }

    __device__ __forceinline__ void store(__nv_bfloat16* dst) const {
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
            const int idx = threadIdx.x + e * kThreads;
            *reinterpret_cast<uint4*>(dst + (idx / kVec) * Smem<DP>::LDB + (idx % kVec) * 8) = v[e];
        }
    }
};

// Copy kBQ rows of c bf16 values starting at row r0 into a DP-wide shared
// tile; rows >= limit and columns >= c are zero.
template <int DP>
__device__ __forceinline__ void load_q(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                       long long row_stride, int r0, int limit, int c) {
    constexpr int kVec = DP / 8;
    for (int idx = threadIdx.x; idx < kBQ * kVec; idx += kThreads) {
        const int r = idx / kVec;
        const int col = (idx % kVec) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (r0 + r < limit && col < c)
            val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * row_stride + col);
        *reinterpret_cast<uint4*>(dst + r * Smem<DP>::LDB + col) = val;
    }
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int H, int N,
    int kv_len, int c, long long qsb, long long qsh, long long qsr, long long ksb,
    long long ksh, long long ksr, long long vsb, long long vsh, long long vsr,
    long long osb, long long osh, long long osr, float scale) {
    using L = Smem<DP>;
    constexpr int LDB = L::LDB;
    constexpr int KD = DP / 16;   // k-steps over the head dim
    constexpr int ND = DP / 8;    // 8-wide output column tiles
    constexpr int NS = kBK / 8;   // 8-wide score column tiles
    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + L::q);
    __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + L::k);
    __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + L::v);

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;  // fragment row (and row + 8)
    const int t = lane & 3;   // fragment column pair
    const int b = blockIdx.y / H;
    const int h = blockIdx.y % H;
    const int q0 = blockIdx.x * kBQ;
    const int wr = warp * 16;  // this warp's first query row in the tile
    const __nv_bfloat16* kb = k + b * ksb + h * ksh;
    const __nv_bfloat16* vb = v + b * vsb + h * vsh;
    // ldmatrix row address pattern: matrix lane / 8, row lane % 8
    const int lm = lane >> 3, lr = lane & 7;

    TileRegs<DP> rk, rv;
    rk.fetch(kb, ksr, 0, kv_len, c);
    rv.fetch(vb, vsr, 0, kv_len, c);
    load_q<DP>(sQ, q + b * qsb + h * qsh, qsr, q0, N, c);
    __syncthreads();

    // Q fragments of this warp's 16 rows, held for the whole key loop
    uint32_t qf[KD][4];
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
        ldsm_x4(qf[kk], sQ + (wr + (lm & 1) * 8 + lr) * LDB + kk * 16 + (lm >> 1) * 8);

    float of[ND][4];
#pragma unroll
    for (int d = 0; d < ND; ++d) of[d][0] = of[d][1] = of[d][2] = of[d][3] = 0.f;
    float m_lo = -INFINITY, m_hi = -INFINITY;  // running max (log2 units), rows g, g+8
    float l_lo = 0.f, l_hi = 0.f;              // this lane's share of the row sums
    const float sl2 = scale * kLog2e;

    for (int k0 = 0; k0 < kv_len; k0 += kBK) {
        __syncthreads();  // previous tile's K/V reads are done
        rk.store(sK);
        rv.store(sV);
        __syncthreads();
        if (k0 + kBK < kv_len) {
            rk.fetch(kb, ksr, k0 + kBK, kv_len, c);
            rv.fetch(vb, vsr, k0 + kBK, kv_len, c);
        }

        // S = Q K^T: 16 rows x 64 keys in NS fragments
        float sf[NS][4];
#pragma unroll
        for (int j = 0; j < NS; ++j) sf[j][0] = sf[j][1] = sf[j][2] = sf[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
            for (int j = 0; j < NS; j += 2) {
                // b0/b1 of key tiles j and j + 1
                uint32_t kf[4];
                ldsm_x4(kf, sK + ((j + (lm >> 1)) * 8 + lr) * LDB + kk * 16 + (lm & 1) * 8);
                mma_bf16(sf[j], qf[kk], kf[0], kf[1]);
                mma_bf16(sf[j + 1], qf[kk], kf[2], kf[3]);
            }
        }

        // online softmax in log2 units; columns past kv_len score -inf
        float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const bool keep = k0 + j * 8 + 2 * t + e < kv_len;
                sf[j][e] = keep ? sf[j][e] * sl2 : -INFINITY;
                sf[j][2 + e] = keep ? sf[j][2 + e] * sl2 : -INFINITY;
                mx_lo = fmaxf(mx_lo, sf[j][e]);
                mx_hi = fmaxf(mx_hi, sf[j][2 + e]);
            }
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
            mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
            mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
        }
        const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
        const float a_lo = exp2f(m_lo - mn_lo), a_hi = exp2f(m_hi - mn_hi);
        m_lo = mn_lo;
        m_hi = mn_hi;
        l_lo *= a_lo;
        l_hi *= a_hi;
#pragma unroll
        for (int d = 0; d < ND; ++d) {
            of[d][0] *= a_lo;
            of[d][1] *= a_lo;
            of[d][2] *= a_hi;
            of[d][3] *= a_hi;
        }
        uint32_t pf[NS][2];  // P as bf16 pairs: rows g and g + 8
#pragma unroll
        for (int j = 0; j < NS; ++j) {
            const float p0 = exp2f(sf[j][0] - mn_lo), p1 = exp2f(sf[j][1] - mn_lo);
            const float p2 = exp2f(sf[j][2] - mn_hi), p3 = exp2f(sf[j][3] - mn_hi);
            l_lo += p0 + p1;
            l_hi += p2 + p3;
            pf[j][0] = pack_bf16(p0, p1);
            pf[j][1] = pack_bf16(p2, p3);
        }

        // O += P V: key chunks of 16 (score tiles 2kc, 2kc + 1)
#pragma unroll
        for (int kc = 0; kc < kBK / 16; ++kc) {
            const uint32_t pa[4] = {pf[2 * kc][0], pf[2 * kc][1], pf[2 * kc + 1][0],
                                    pf[2 * kc + 1][1]};
#pragma unroll
            for (int d = 0; d < ND; d += 2) {
                // b0/b1 of output tiles d and d + 1, V read transposed
                uint32_t vf[4];
                ldsm_x4_trans(vf, sV + (kc * 16 + (lm & 1) * 8 + lr) * LDB + (d + (lm >> 1)) * 8);
                mma_bf16(of[d], pa, vf[0], vf[1]);
                mma_bf16(of[d + 1], pa, vf[2], vf[3]);
            }
        }
    }

    // full row sums, normalise, store (bf16 pairs)
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
        l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
        l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
    const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f), inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
    __nv_bfloat16* ob = o + b * osb + h * osh;
    const int row_lo = q0 + wr + g, row_hi = row_lo + 8;
#pragma unroll
    for (int d = 0; d < ND; ++d) {
        const int col = d * 8 + 2 * t;
        if (col >= c) continue;
        if (row_lo < N)
            *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row_lo * osr + col) =
                __floats2bfloat162_rn(of[d][0] * inv_lo, of[d][1] * inv_lo);
        if (row_hi < N)
            *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row_hi * osr + col) =
                __floats2bfloat162_rn(of[d][2] * inv_hi, of[d][3] * inv_hi);
    }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int N,
           int kv_len, int c, const long long* st, float scale, cudaStream_t stream) {
    const size_t smem = Smem<DP>::bytes;
    cudaError_t err = idt_allow_smem(flash_fwd_kernel<DP>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((N + kBQ - 1) / kBQ, B * H);
    flash_fwd_kernel<DP><<<grid, kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H, N, kv_len, c,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
        scale);
    return cudaGetLastError();
}

}  // namespace

// strides: 12 element strides, (batch, head, row) for q, k, v, o in order.
// Requires c % 8 == 0, c <= 128, 16-byte aligned rows, kv_len >= 1.
IDT_EXPORT int idt_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   int B, int H, int N, int kv_len, int c,
                                   const long long* strides, float scale, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch ((c + 15) / 16) {
        case 1: return launch<16>(q, k, v, o, B, H, N, kv_len, c, strides, scale, s);
        case 2: return launch<32>(q, k, v, o, B, H, N, kv_len, c, strides, scale, s);
        case 3: return launch<48>(q, k, v, o, B, H, N, kv_len, c, strides, scale, s);
        case 4: return launch<64>(q, k, v, o, B, H, N, kv_len, c, strides, scale, s);
        case 5: return launch<80>(q, k, v, o, B, H, N, kv_len, c, strides, scale, s);
        case 6: return launch<96>(q, k, v, o, B, H, N, kv_len, c, strides, scale, s);
        case 7: return launch<112>(q, k, v, o, B, H, N, kv_len, c, strides, scale, s);
        case 8: return launch<128>(q, k, v, o, B, H, N, kv_len, c, strides, scale, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
