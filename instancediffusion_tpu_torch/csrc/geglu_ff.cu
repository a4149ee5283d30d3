// Fused GEGLU feed-forward: out = (a * gelu(g)) @ w2^T + b2,
// [a | g] = x @ w1^T + b1, with exact-erf GELU.
//
// Replaces instancediffusion_tpu/kernels/geglu_ff.py::fused_ff_geglu
// (_ff_kernel). The TPU kernel used tanh-GELU only because Mosaic lowers no
// erf; the model's formula (and the JAX fallback _apply_ff_geglu) is erf.
//
// Work per call: 6*M*C*I FLOPs (I = 4C). Unfused, the (M, 2I) bf16
// intermediate would cross HBM at 4*M*I bytes each way. The TPU kernel kept
// both weights resident in VMEM;
// at C=1280 they are 26 MB, far above 227 KB of shared memory, and an
// (M x C) fp32 output block does not fit a block's registers either. So the
// inner dimension is split across blocks:
//   grid (ceil(M/64), I/IS), IS <= 256 inner columns per block. A block of
//   8 warps computes its (64 x IS) slice of a*gelu(g) in 64-wide chunks:
//   x and w1 tiles stream through shared memory (the next tile's loads in
//   flight in registers while the current one computes), mma.sync m16n8k16
//   products with ldmatrix operands accumulate a and g in fp32 registers,
//   and bias + a*gelu(g) are applied there, rounded once to bf16 into a
//   shared-memory slice. Then the slice is multiplied by w2[:, slice] for
//   all C output columns, 64 at a time, straight from registers to HBM.
//   With one split (IS = I) the block adds b2 and writes bf16; otherwise it
//   writes an fp32 partial (split, M, C), and ff_reduce_kernel sums the
//   splits in a fixed order, adds b2 and rounds once.
// Nothing of (M, 2I) reaches HBM and every product is computed once, but
// the fp32 partials of I/IS > 1 splits do: M*C*I/64 bytes written and read
// back, C/256 times the unfused intermediate (1.25x at C=320, 5x at
// C=1280). Whether FLOPs or these bytes bound the kernel is not measured.
// Weights are torch Linear layout: w1 (2I, C), w2 (C, I), row-major.
#include "common.cuh"

namespace {

constexpr int kBM = 64;         // rows per block
constexpr int kChunk = 64;      // inner chunk of the first product, C tile
constexpr int kMaxSplit = 256;  // inner columns per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kLDK = 72;             // bf16 pitch of 64-wide tiles
constexpr int kLDG = kMaxSplit + 8;  // bf16 pitch of the gated slice

struct Smem {
    static constexpr size_t x = 0;
    static constexpr size_t w1a = x + sizeof(__nv_bfloat16) * kBM * kLDK;
    static constexpr size_t w1g = w1a + sizeof(__nv_bfloat16) * kChunk * kLDK;
    static constexpr size_t gated = w1g + sizeof(__nv_bfloat16) * kChunk * kLDK;
    static constexpr size_t bytes = gated + sizeof(__nv_bfloat16) * kBM * kLDG;
};

// One thread's share of a 64 x 64 bf16 tile (2 16-byte vectors), so the
// next tile's global loads overlap the current tile's products.
struct Tile64 {
    uint4 v[2];

    // rows row0.. of a row-major matrix (pitch ld), columns col0..col0+63;
    // rows >= limit read as zero
    __device__ __forceinline__ void fetch(const __nv_bfloat16* src, long long ld, int row0,
                                          int limit, int col0) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int idx = threadIdx.x + e * kThreads;
            const int r = idx >> 3, col = (idx & 7) * 8;
            v[e] = make_uint4(0u, 0u, 0u, 0u);
            if (row0 + r < limit)
                v[e] = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * ld + col0 + col);
        }
    }

    __device__ __forceinline__ void store(__nv_bfloat16* dst) const {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int idx = threadIdx.x + e * kThreads;
            *reinterpret_cast<uint4*>(dst + (idx >> 3) * kLDK + (idx & 7) * 8) = v[e];
        }
    }
};

__device__ __forceinline__ float gelu_erf(float x) {
    return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

template <bool kPartial>
__global__ void __launch_bounds__(kThreads) geglu_ff_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
    const float* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
    const float* __restrict__ b2, __nv_bfloat16* __restrict__ out, float* __restrict__ partial,
    int M, int C, int I, int split_i) {
    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(smem + Smem::x);
    __nv_bfloat16* sW1a = reinterpret_cast<__nv_bfloat16*>(smem + Smem::w1a);
    __nv_bfloat16* sW1g = reinterpret_cast<__nv_bfloat16*>(smem + Smem::w1g);
    __nv_bfloat16* sG = reinterpret_cast<__nv_bfloat16*>(smem + Smem::gated);

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;    // mma fragment row / column pair
    const int lm = lane >> 3, lr = lane & 7;  // ldmatrix matrix / row
    const int wrow = (warp & 3) * 16;         // this warp's 16 rows
    const int wcol = (warp >> 2) * 32;        // and 32 of the 64 tile columns
    const int m0 = blockIdx.x * kBM;
    const int i_begin = blockIdx.y * split_i;

    // 1) gated slice: sG[:, 0:split_i] = a * gelu(g) for inner columns
    //    [i_begin, i_begin + split_i)
    for (int ic = 0; ic < split_i; ic += kChunk) {
        const int i0 = i_begin + ic;
        float fa[4][4], fg[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) fa[j][e] = fg[j][e] = 0.f;
        Tile64 tx, ta, tg;
        tx.fetch(x, C, m0, M, 0);
        ta.fetch(w1, C, i0, 2 * I, 0);
        tg.fetch(w1, C, I + i0, 2 * I, 0);
        for (int kc = 0; kc < C; kc += kChunk) {
            __syncthreads();  // the previous tile's readers are done
            tx.store(sX);
            ta.store(sW1a);
            tg.store(sW1g);
            __syncthreads();
            if (kc + kChunk < C) {
                tx.fetch(x, C, m0, M, kc + kChunk);
                ta.fetch(w1, C, i0, 2 * I, kc + kChunk);
                tg.fetch(w1, C, I + i0, 2 * I, kc + kChunk);
            }
#pragma unroll
            for (int kk = 0; kk < kChunk / 16; ++kk) {
                uint32_t af[4];
                ldsm_x4(af, sX + (wrow + (lm & 1) * 8 + lr) * kLDK + kk * 16 + (lm >> 1) * 8);
#pragma unroll
                for (int j = 0; j < 4; j += 2) {
                    const int brow = wcol + (j + (lm >> 1)) * 8 + lr;
                    uint32_t bf[4];
                    ldsm_x4(bf, sW1a + brow * kLDK + kk * 16 + (lm & 1) * 8);
                    mma_bf16(fa[j], af, bf[0], bf[1]);
                    mma_bf16(fa[j + 1], af, bf[2], bf[3]);
                    ldsm_x4(bf, sW1g + brow * kLDK + kk * 16 + (lm & 1) * 8);
                    mma_bf16(fg[j], af, bf[0], bf[1]);
                    mma_bf16(fg[j + 1], af, bf[2], bf[3]);
                }
            }
        }
        // bias, a * gelu(g) in fp32 (exact erf), one rounding to bf16
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int col = wcol + j * 8 + 2 * t;
            const float2 ba = *reinterpret_cast<const float2*>(b1 + i0 + col);
            const float2 bg = *reinterpret_cast<const float2*>(b1 + I + i0 + col);
#pragma unroll
            for (int hrow = 0; hrow < 2; ++hrow) {
                const float y0 = (fa[j][2 * hrow] + ba.x) * gelu_erf(fg[j][2 * hrow] + bg.x);
                const float y1 = (fa[j][2 * hrow + 1] + ba.y) * gelu_erf(fg[j][2 * hrow + 1] + bg.y);
                *reinterpret_cast<__nv_bfloat162*>(sG + (wrow + g + 8 * hrow) * kLDG + ic + col) =
                    __floats2bfloat162_rn(y0, y1);
            }
        }
    }

    // 2) out[:, n0:n0+64] (+)= sG[:, 0:split_i] @ w2[n0:n0+64, slice]^T,
    //    w2 tiles streamed through sW1a; the first __syncthreads below also
    //    publishes sG
    __nv_bfloat16* sW2 = sW1a;
    for (int n0 = 0; n0 < C; n0 += kChunk) {
        float fo[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) fo[j][e] = 0.f;
        Tile64 tw;
        tw.fetch(w2, I, n0, C, i_begin);
        for (int kc = 0; kc < split_i; kc += kChunk) {
            __syncthreads();
            tw.store(sW2);
            __syncthreads();
            if (kc + kChunk < split_i) tw.fetch(w2, I, n0, C, i_begin + kc + kChunk);
#pragma unroll
            for (int kk = 0; kk < kChunk / 16; ++kk) {
                uint32_t af[4];
                ldsm_x4(af, sG + (wrow + (lm & 1) * 8 + lr) * kLDG + kc + kk * 16 + (lm >> 1) * 8);
#pragma unroll
                for (int j = 0; j < 4; j += 2) {
                    uint32_t bf[4];
                    ldsm_x4(bf, sW2 + (wcol + (j + (lm >> 1)) * 8 + lr) * kLDK + kk * 16 +
                                    (lm & 1) * 8);
                    mma_bf16(fo[j], af, bf[0], bf[1]);
                    mma_bf16(fo[j + 1], af, bf[2], bf[3]);
                }
            }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int col = n0 + wcol + j * 8 + 2 * t;
#pragma unroll
            for (int hrow = 0; hrow < 2; ++hrow) {
                const int row = m0 + wrow + g + 8 * hrow;
                if (row >= M) continue;
                const long long off = (long long)row * C + col;
                if (kPartial) {
                    *reinterpret_cast<float2*>(partial + (long long)blockIdx.y * M * C + off) =
                        make_float2(fo[j][2 * hrow], fo[j][2 * hrow + 1]);
                } else {
                    *reinterpret_cast<__nv_bfloat162*>(out + off) = __floats2bfloat162_rn(
                        fo[j][2 * hrow] + b2[col], fo[j][2 * hrow + 1] + b2[col + 1]);
                }
            }
        }
    }
}

// out = bf16(sum over splits of partial + b2), two elements per step
__global__ void __launch_bounds__(256) ff_reduce_kernel(const float* __restrict__ partial,
                                                        const float* __restrict__ b2,
                                                        __nv_bfloat16* __restrict__ out,
                                                        long long MC, int C, int splits) {
    const long long stride = (long long)gridDim.x * blockDim.x * 2;
    for (long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 2; i < MC;
         i += stride) {
        float2 acc = *reinterpret_cast<const float2*>(partial + i);
        for (int s = 1; s < splits; ++s) {
            const float2 p = *reinterpret_cast<const float2*>(partial + s * MC + i);
            acc.x += p.x;
            acc.y += p.y;
        }
        const int ch = (int)(i % C);
        *reinterpret_cast<__nv_bfloat162*>(out + i) =
            __floats2bfloat162_rn(acc.x + b2[ch], acc.y + b2[ch + 1]);
    }
}

}  // namespace

// x, out: (M, C) contiguous bf16; w1: (2I, C) bf16; b1: (2I,) fp32;
// w2: (C, I) bf16; b2: (C,) fp32; partial: fp32 scratch of
// (I / split_i) * M * C, unused when split_i == I. Requires C % 64 == 0,
// split_i % 64 == 0, split_i <= 256, I % split_i == 0.
IDT_EXPORT int idt_geglu_ff(const void* x, const void* w1, const void* b1, const void* w2,
                            const void* b2, void* out, void* partial, int M, int C, int I,
                            int split_i, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int splits = I / split_i;
    const dim3 grid((M + kBM - 1) / kBM, splits);
    const auto* xp = static_cast<const __nv_bfloat16*>(x);
    const auto* w1p = static_cast<const __nv_bfloat16*>(w1);
    const auto* b1p = static_cast<const float*>(b1);
    const auto* w2p = static_cast<const __nv_bfloat16*>(w2);
    const auto* b2p = static_cast<const float*>(b2);
    auto* outp = static_cast<__nv_bfloat16*>(out);
    auto* pp = static_cast<float*>(partial);
    cudaError_t err;
    if (splits == 1) {
        err = idt_allow_smem(geglu_ff_kernel<false>, Smem::bytes);
        if (err != cudaSuccess) return err;
        geglu_ff_kernel<false><<<grid, kThreads, Smem::bytes, s>>>(xp, w1p, b1p, w2p, b2p, outp,
                                                                  pp, M, C, I, split_i);
        return cudaGetLastError();
    }
    err = idt_allow_smem(geglu_ff_kernel<true>, Smem::bytes);
    if (err != cudaSuccess) return err;
    geglu_ff_kernel<true><<<grid, kThreads, Smem::bytes, s>>>(xp, w1p, b1p, w2p, b2p, outp, pp,
                                                             M, C, I, split_i);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long mc = (long long)M * C;
    const long long blocks = (mc / 2 + 255) / 256;
    ff_reduce_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(pp, b2p, outp, mc,
                                                                             C, splits);
    return cudaGetLastError();
}
