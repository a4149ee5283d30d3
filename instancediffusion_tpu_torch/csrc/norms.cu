// GroupNorm(+SiLU) over (rows, C) bf16 activations and LayerNorm over bf16
// or fp32 ones.
//
// GroupNorm replaces instancediffusion_tpu/kernels/norms.py::fused_group_norm
// (_gn_kernel); LayerNorm replaces ::fused_layer_norm (_ln_kernel).
//
// Both are bound by device-memory bytes: a handful of FLOPs per element
// against 4 bytes moved (one bf16 read, one bf16 write) at best. The design
// keeps that to one read for statistics (a second from L1/L2 for LayerNorm's
// rows) and one read-modify-write, with fp32 math and one rounding on store.
//
// GroupNorm. The TPU kernel held a whole batch row in VMEM with grid=(B,);
// on the card that would be 8-16 blocks for 132 SMs, and a VAE row is
// 262144 x 128. So the rows of each sample are split across blocks:
//   gn_stats_kernel  grid (splits, B): per-thread fp32 sums over at most a
//                    few hundred elements, combined per group in fp64 in
//                    shared memory, written as one fp64 partial per block
//                    (no global atomics, so the result is deterministic);
//   gn_apply_kernel  grid (chunks, B): reduces the partials of its sample in
//                    fp64 (E[x^2] - E[x]^2 in fp64 does not cancel at a
//                    million elements per group), then normalises, applies
//                    the affine and the optional SiLU, and rounds once.
//
// LayerNorm: one warp per row, two passes over the row for mean and
// variance (the row is at most a few KB and stays in L1), fp32 math. It takes
// bf16 rows (UNet, CLIP) and fp32 rows (ConvNeXt in the grounding tokenizer).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroups = 64;

__global__ void __launch_bounds__(kThreads) gn_stats_kernel(const __nv_bfloat16* __restrict__ x,
                                                            double* __restrict__ partial, int N,
                                                            int C, int G, int rows_per) {
    __shared__ double sums[2 * kMaxGroups];
    const int b = blockIdx.y;
    const int split = blockIdx.x;
    for (int i = threadIdx.x; i < 2 * G; i += kThreads) sums[i] = 0.0;
    __syncthreads();

    const int r0 = split * rows_per;
    const int r1 = min(N, r0 + rows_per);
    // threads cover `lanes` consecutive channels of `row_groups` rows at once
    const int lanes = min(C, kThreads);
    const int row_groups = kThreads / lanes;
    const int t = threadIdx.x;
    const int cg = C / G;
    if (t < lanes * row_groups) {
        const __nv_bfloat16* xb = x + (long long)b * N * C;
        for (int ch = t % lanes; ch < C; ch += lanes) {
            float s1 = 0.f, s2 = 0.f;
            for (int r = r0 + t / lanes; r < r1; r += row_groups) {
                const float val = __bfloat162float(xb[(long long)r * C + ch]);
                s1 += val;
                s2 += val * val;
            }
            atomicAdd(&sums[ch / cg], (double)s1);
            atomicAdd(&sums[G + ch / cg], (double)s2);
        }
    }
    __syncthreads();
    double* out = partial + ((long long)b * gridDim.x + split) * 2 * G;
    for (int i = threadIdx.x; i < 2 * G; i += kThreads) out[i] = sums[i];
}

__global__ void __launch_bounds__(kThreads) gn_apply_kernel(
    const __nv_bfloat16* __restrict__ x, const double* __restrict__ partial,
    const float* __restrict__ scale, const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
    int N, int C, int G, int splits, int rows_per, float eps, int silu) {
    __shared__ float mean_g[kMaxGroups];
    __shared__ float inv_g[kMaxGroups];
    const int b = blockIdx.y;
    if (threadIdx.x < G) {
        const double* pb = partial + (long long)b * splits * 2 * G;
        double s1 = 0.0, s2 = 0.0;
        for (int s = 0; s < splits; ++s) {
            s1 += pb[s * 2 * G + threadIdx.x];
            s2 += pb[s * 2 * G + G + threadIdx.x];
        }
        const double cnt = (double)N * (double)(C / G);
        const double mean = s1 / cnt;
        const double var = fmax(s2 / cnt - mean * mean, 0.0);
        mean_g[threadIdx.x] = (float)mean;
        inv_g[threadIdx.x] = (float)(1.0 / sqrt(var + (double)eps));
    }
    __syncthreads();

    const int r0 = blockIdx.x * rows_per;
    const int r1 = min(N, r0 + rows_per);
    const int half = C / 2;
    const int cg = C / G;
    const long long base = ((long long)b * N + r0) * C;
    const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(x + base);
    __nv_bfloat162* yv = reinterpret_cast<__nv_bfloat162*>(y + base);
    const int pairs = (r1 - r0) * half;
    for (int i = threadIdx.x; i < pairs; i += kThreads) {
        const int ch = (i % half) * 2;
        const float2 f = __bfloat1622float2(xv[i]);
        const int g0 = ch / cg, g1 = (ch + 1) / cg;
        float y0 = (f.x - mean_g[g0]) * inv_g[g0] * scale[ch] + bias[ch];
        float y1 = (f.y - mean_g[g1]) * inv_g[g1] * scale[ch + 1] + bias[ch + 1];
        if (silu) {
            y0 = y0 / (1.f + expf(-y0));
            y1 = y1 / (1.f + expf(-y1));
        }
        yv[i] = __floats2bfloat162_rn(y0, y1);
    }
}

constexpr int kRowsPerLnBlock = kThreads / 32;

// Pairs of adjacent channels, loaded to and stored from fp32.
__device__ __forceinline__ float2 ln_load(const __nv_bfloat162& v) { return __bfloat1622float2(v); }
__device__ __forceinline__ float2 ln_load(const float2& v) { return v; }
__device__ __forceinline__ void ln_store(__nv_bfloat162* p, float a, float b) {
    *p = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void ln_store(float2* p, float a, float b) { *p = make_float2(a, b); }

// T2 is __nv_bfloat162 (bf16 activations) or float2 (fp32 activations, the
// grounding tokenizer, which runs in fp32 like the reference's).
template <typename T2>
__global__ void __launch_bounds__(kThreads) ln_kernel(const T2* __restrict__ x,
                                                      const float* __restrict__ scale,
                                                      const float* __restrict__ bias,
                                                      T2* __restrict__ y, long long rows, int C,
                                                      float eps) {
    const int lane = threadIdx.x & 31;
    const long long row = (long long)blockIdx.x * kRowsPerLnBlock + (threadIdx.x >> 5);
    if (row >= rows) return;
    const int half = C / 2;
    const T2* xr = x + row * half;
    T2* yr = y + row * half;

    float s = 0.f;
    for (int i = lane; i < half; i += 32) {
        const float2 f = ln_load(xr[i]);
        s += f.x + f.y;
    }
    const float mean = idt_warp_sum(s) / C;
    float ss = 0.f;
    for (int i = lane; i < half; i += 32) {
        const float2 f = ln_load(xr[i]);
        const float d0 = f.x - mean, d1 = f.y - mean;
        ss += d0 * d0 + d1 * d1;
    }
    const float inv = rsqrtf(idt_warp_sum(ss) / C + eps);
    for (int i = lane; i < half; i += 32) {
        const float2 f = ln_load(xr[i]);
        const int ch = 2 * i;
        ln_store(yr + i, (f.x - mean) * inv * scale[ch] + bias[ch],
                 (f.y - mean) * inv * scale[ch + 1] + bias[ch + 1]);
    }
}

}  // namespace

// x, y: (B, N, C) contiguous bf16; scale, bias: (C,) fp32; partial: fp64
// scratch of B * stat_splits * 2 * G. Requires C % G == 0, C even, G <= 64.
IDT_EXPORT int idt_group_norm(const void* x, const void* scale, const void* bias, void* y,
                              void* partial, int B, int N, int C, int G, int stat_splits,
                              int stat_rows, int apply_chunks, int apply_rows, float eps,
                              int silu, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    gn_stats_kernel<<<dim3(stat_splits, B), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<double*>(partial), N, C, G, stat_rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    gn_apply_kernel<<<dim3(apply_chunks, B), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const double*>(partial),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<__nv_bfloat16*>(y), N, C, G, stat_splits, apply_rows, eps, silu);
    return cudaGetLastError();
}

// x, y: (rows, C) contiguous, bf16 (fp32 = 0) or fp32 (fp32 = 1); scale,
// bias: (C,) fp32. Requires C even.
IDT_EXPORT int idt_layer_norm(const void* x, const void* scale, const void* bias, void* y,
                              long long rows, int C, float eps, int fp32, void* stream) {
    const long long blocks = (rows + kRowsPerLnBlock - 1) / kRowsPerLnBlock;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* sc = static_cast<const float*>(scale);
    const float* bi = static_cast<const float*>(bias);
    if (fp32) {
        ln_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(static_cast<const float2*>(x), sc, bi,
                                                        static_cast<float2*>(y), rows, C, eps);
    } else {
        ln_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
            static_cast<const __nv_bfloat162*>(x), sc, bi, static_cast<__nv_bfloat162*>(y),
            rows, C, eps);
    }
    return cudaGetLastError();
}
