// GroupNorm(+SiLU) over (rows, C) bf16 activations and LayerNorm over bf16
// or fp32 ones.
//
// GroupNorm replaces instancediffusion_tpu/kernels/norms.py::fused_group_norm
// (_gn_kernel); LayerNorm replaces ::fused_layer_norm (_ln_kernel).
//
// Both are bound by device-memory bytes: a handful of FLOPs per element
// against 4 bytes moved (one bf16 read, one bf16 write) at best.
//
// GroupNorm. The TPU kernel held a whole batch row in VMEM with grid=(B,);
// on the card that would be 8-16 blocks for 132 SMs, and a VAE row is
// 262144 x 128. So each sample's rows are split across the blocks of one
// cooperative grid (at most kCoopBlocksPerSM blocks per SM, all resident),
// in one launch, with the affine read as the module keeps it (bf16 or fp32).
// Every thread owns one 16-byte vector of 8 channels and walks rows with
// 16-byte loads; its fp32 per-channel sums are folded into the groups in
// shared memory in a fixed order, each block writes its fp64 group sums, a
// grid barrier, then every block reduces its sample's partials in a fixed
// order (deterministic: no atomics in any sum; fp64 E[x^2] - E[x]^2 does not
// cancel at a million elements per group) and normalises its rows walking
// them in reverse, so the rows it read last come from L2. It applies the
// affine and the optional SiLU in fp32 and rounds once.
//
// A one-read design that keeps a sample in a thread-block cluster's shared
// memory (a bulk copy per CTA, the groups' sums all-reduced through
// distributed shared memory) was built and timed against this one on the
// H100 and lost at every main-path shape: a (4096, 320) sample needs 16
// CTAs of 164 KB, so each CTA runs alone on its SM, few such clusters fit
// the card at once, and no CTA overlaps its load with its store. Reading x
// twice, the second time partly from L2, costs less than that.
//
// LayerNorm: one read and one write. 8, 16 or 32 lanes share a row (so a warp
// takes up to four of the narrow rows), load it with 16-byte loads and keep
// it in registers between the statistics (mean, then the centred sum of
// squares, fp32, reduced by shuffles) and the normalise; the affine is read
// as the module keeps it (bf16 or fp32). Rows of bf16 (UNet, CLIP) and fp32
// (ConvNeXt in the grounding tokenizer); a generic three-pass loop serves
// widths off the vector size or past 8 vectors a lane.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroups = 64;
constexpr int kGnMaxThreads = 320;  // C / 8 vectors per row, up to C = 2560
constexpr int kCoopBlocksPerSM = 4;

__device__ __forceinline__ void unpack8(const uint4& raw, float (&f)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 v = __bfloat1622float2(h[i]);
        f[2 * i] = v.x;
        f[2 * i + 1] = v.y;
    }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
    uint4 raw;
    uint32_t* w = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = pack_bf16(f[2 * i], f[2 * i + 1]);
    return raw;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// The thread's place: vector v (channels 8v..8v+7) of row slot rs; rows
// rs, rs + R, ... of its chunk. blockDim = (C / 8) * R.
struct GnThread {
    int lanes, R, v, rs, cg;
    __device__ GnThread(int C, int G) {
        lanes = C / 8;
        R = blockDim.x / lanes;
        v = threadIdx.x % lanes;
        rs = threadIdx.x / lanes;
        cg = C / G;
    }
};

// Fold every thread's 8 per-channel values into per-group sums in a fixed
// order: red holds R x C floats; out[g] for g < G (threads 0..G-1 write).
template <typename T>
__device__ void fold_groups(const GnThread& th, const float (&acc)[8], float* red, T* out, int C,
                            int G) {
#pragma unroll
    for (int e = 0; e < 8; ++e) red[th.rs * C + 8 * th.v + e] = acc[e];
    __syncthreads();
    if (threadIdx.x < G) {
        T s = 0;
        for (int r = 0; r < th.R; ++r)
            for (int ch = threadIdx.x * th.cg; ch < (threadIdx.x + 1) * th.cg; ++ch)
                s += static_cast<T>(red[r * C + ch]);
        out[threadIdx.x] = s;
    }
    __syncthreads();
}

// load(0) + ... + load(count - 1) in a fixed order, eight loads in flight
// (the cross-block combine reads global memory)
template <typename T, typename F>
__device__ __forceinline__ T sum_fixed_order(int count, F load) {
    T acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0;
    int i = 0;
    for (; i + 8 <= count; i += 8) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] += load(i + j);
    }
    for (; i < count; ++i) acc[0] += load(i);
    return ((acc[0] + acc[1]) + (acc[2] + acc[3])) + ((acc[4] + acc[5]) + (acc[6] + acc[7]));
}

// y = x * a + b per channel, optional SiLU, one rounding
__device__ __forceinline__ uint4 gn_apply8(const uint4& raw, const float (&a)[8],
                                           const float (&b)[8], int silu) {
    float f[8];
    unpack8(raw, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
        float y = fmaf(f[e], a[e], b[e]);
        if (silu) y = y / (1.f + __expf(-y));
        f[e] = y;
    }
    return pack8(f);
}

template <typename AT>
__device__ __forceinline__ void gn_affine(const GnThread& th, const AT* scale, const AT* bias,
                                          const float* mean, const float* rstd, float (&a)[8],
                                          float (&b)[8]) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
        const int ch = 8 * th.v + e;
        const int g = ch / th.cg;
        a[e] = rstd[g] * to_f(scale[ch]);
        b[e] = to_f(bias[ch]) - mean[g] * a[e];
    }
}

// Grid (splits, B), launched cooperatively; partial: fp64 (B, splits, 2,
// G); dynamic shared memory R x C fp32.
template <typename AT>
__global__ void __launch_bounds__(kGnMaxThreads, kCoopBlocksPerSM) gn_kernel(
    const __nv_bfloat16* __restrict__ x, const AT* __restrict__ scale,
    const AT* __restrict__ bias, __nv_bfloat16* __restrict__ y, double* __restrict__ partial,
    int N, int C, int G, int rows_per, float eps, int silu) {
    extern __shared__ __align__(128) unsigned char smem[];
    __shared__ double s1g[kMaxGroups], s2g[kMaxGroups];
    __shared__ float mean[kMaxGroups], rstd[kMaxGroups];
    const GnThread th(C, G);
    const int b = blockIdx.y, split = blockIdx.x, splits = gridDim.x;
    const int r0 = split * rows_per;
    const int rows = max(0, min(N, r0 + rows_per) - r0);
    float* red = reinterpret_cast<float*>(smem);
    const long long base = ((long long)b * N + r0) * C;
    const uint4* xv = reinterpret_cast<const uint4*>(x + base);

    float a1[8], a2[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) a1[e] = a2[e] = 0.f;
#pragma unroll 4
    for (int r = th.rs; r < rows; r += th.R) {
        float f[8];
        unpack8(__ldg(xv + (long long)r * th.lanes + th.v), f);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            a1[e] += f[e];
            a2[e] = fmaf(f[e], f[e], a2[e]);
        }
    }
    fold_groups(th, a1, red, s1g, C, G);
    fold_groups(th, a2, red, s2g, C, G);
    double* pb = partial + (long long)b * splits * 2 * G;
    if (threadIdx.x < G) {
        pb[split * 2 * G + threadIdx.x] = s1g[threadIdx.x];
        pb[split * 2 * G + G + threadIdx.x] = s2g[threadIdx.x];
    }
    cg::this_grid().sync();
    if (threadIdx.x < G) {
        const double s1 = sum_fixed_order<double>(
            splits, [&](int s) { return pb[s * 2 * G + threadIdx.x]; });
        const double s2 = sum_fixed_order<double>(
            splits, [&](int s) { return pb[s * 2 * G + G + threadIdx.x]; });
        const double cnt = (double)N * th.cg;
        const double mu = s1 / cnt;
        mean[threadIdx.x] = static_cast<float>(mu);
        rstd[threadIdx.x] = static_cast<float>(1.0 / sqrt(fmax(s2 / cnt - mu * mu, 0.0) + eps));
    }
    __syncthreads();

    float a[8], c0[8];
    gn_affine(th, scale, bias, mean, rstd, a, c0);
    uint4* yv = reinterpret_cast<uint4*>(y + base);
    const int last = rows > th.rs ? th.rs + (rows - 1 - th.rs) / th.R * th.R : -1;
#pragma unroll 4
    for (int r = last; r >= 0; r -= th.R) {
        const long long i = (long long)r * th.lanes + th.v;
        yv[i] = gn_apply8(__ldg(xv + i), a, c0, silu);
    }
}

template <typename AT>
cudaError_t gn_launch(const void* x, const void* scale, const void* bias, void* y, void* partial,
                      int B, int N, int C, int G, int splits, int rows_per, int threads, int smem,
                      float eps, int silu, cudaStream_t s) {
    const auto* xp = static_cast<const __nv_bfloat16*>(x);
    const auto* sp = static_cast<const AT*>(scale);
    const auto* bp = static_cast<const AT*>(bias);
    auto* yp = static_cast<__nv_bfloat16*>(y);
    auto* pp = static_cast<double*>(partial);
    auto kern = gn_kernel<AT>;
    cudaError_t err = idt_allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    void* args[] = {&xp, &sp, &bp, &yp, &pp, &N, &C, &G, &rows_per, &eps, &silu};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern), dim3(splits, B),
                                      dim3(threads), args, smem, s);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

constexpr int kLnWarps = kThreads / 32;
constexpr int kLnVecs = 8;  // 16-byte vectors of a row one lane can hold

// One 16-byte vector of a row as fp32, and back.
__device__ __forceinline__ void ln_unpack(const uint4& raw, float (&f)[8]) { unpack8(raw, f); }
__device__ __forceinline__ void ln_unpack(const uint4& raw, float (&f)[4]) {
    f[0] = __uint_as_float(raw.x);
    f[1] = __uint_as_float(raw.y);
    f[2] = __uint_as_float(raw.z);
    f[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ uint4 ln_pack(const float (&f)[8]) { return pack8(f); }
__device__ __forceinline__ uint4 ln_pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
}

// E consecutive affine values starting at p (E * sizeof(AT)-byte aligned), as
// the module keeps them
template <int E>
__device__ __forceinline__ void ln_affine(const float* p, float (&f)[E]) {
#pragma unroll
    for (int e = 0; e < E; e += 4) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(p + e));
        f[e] = v.x;
        f[e + 1] = v.y;
        f[e + 2] = v.z;
        f[e + 3] = v.w;
    }
}
__device__ __forceinline__ void ln_affine(const __nv_bfloat16* p, float (&f)[8]) {
    unpack8(__ldg(reinterpret_cast<const uint4*>(p)), f);
}
__device__ __forceinline__ void ln_affine(const __nv_bfloat16* p, float (&f)[4]) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    f[0] = lo.x;
    f[1] = lo.y;
    f[2] = hi.x;
    f[3] = hi.y;
}

// sum over the `lanes` (a power of two) neighbouring lanes that share a row
__device__ __forceinline__ float ln_group_sum(float v, int lanes) {
    for (int off = lanes >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// The row lives in registers between the statistics and the normalise, so
// device memory is read once: `lanes` (8, 16 or 32) lanes share a row, each
// holding up to kLnVecs 16-byte vectors of it, and a warp takes 32 / lanes
// rows. T: bf16 or fp32 rows; AT: the affine's type. Requires C a multiple
// of the vector's 16 / sizeof(T) elements and C <= lanes * kLnVecs of them.
template <typename T, typename AT>
__global__ void __launch_bounds__(kThreads) ln_rows_kernel(const T* __restrict__ x,
                                                           const AT* __restrict__ scale,
                                                           const AT* __restrict__ bias,
                                                           T* __restrict__ y, long long rows,
                                                           int C, int lanes, float eps) {
    constexpr int E = 16 / sizeof(T);
    const int lane = threadIdx.x & 31;
    const int sub = lane % lanes;
    const long long row =
        ((long long)blockIdx.x * kLnWarps + (threadIdx.x >> 5)) * (32 / lanes) + lane / lanes;
    const int nv = C / E;
    const bool live = row < rows;
    const uint4* xr = reinterpret_cast<const uint4*>(x + (live ? row : 0) * C);

    float f[kLnVecs][E];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kLnVecs; ++i) {
        const int v = sub + i * lanes;
        if (live && v < nv) {
            ln_unpack(__ldg(xr + v), f[i]);
#pragma unroll
            for (int e = 0; e < E; ++e) s += f[i][e];
        }
    }
    const float mean = ln_group_sum(s, lanes) / C;
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < kLnVecs; ++i) {
        if (live && sub + i * lanes < nv) {
#pragma unroll
            for (int e = 0; e < E; ++e) {
                const float d = f[i][e] - mean;
                ss = fmaf(d, d, ss);
            }
        }
    }
    const float inv = rsqrtf(ln_group_sum(ss, lanes) / C + eps);
    uint4* yr = reinterpret_cast<uint4*>(y + (live ? row : 0) * C);
#pragma unroll
    for (int i = 0; i < kLnVecs; ++i) {
        const int v = sub + i * lanes;
        if (live && v < nv) {
            float a[E], b[E];
            ln_affine(scale + v * E, a);
            ln_affine(bias + v * E, b);
#pragma unroll
            for (int e = 0; e < E; ++e) f[i][e] = (f[i][e] - mean) * inv * a[e] + b[e];
            yr[v] = ln_pack(f[i]);
        }
    }
}

// Any width: one warp per row, one element per lane per step, the row read
// three times (the second and third time from L1).
template <typename T, typename AT>
__global__ void __launch_bounds__(kThreads) ln_generic_kernel(const T* __restrict__ x,
                                                              const AT* __restrict__ scale,
                                                              const AT* __restrict__ bias,
                                                              T* __restrict__ y, long long rows,
                                                              int C, float eps) {
    const int lane = threadIdx.x & 31;
    const long long row = (long long)blockIdx.x * kLnWarps + (threadIdx.x >> 5);
    if (row >= rows) return;
    const T* xr = x + row * C;
    T* yr = y + row * C;
    float s = 0.f;
    for (int i = lane; i < C; i += 32) s += to_f(xr[i]);
    const float mean = idt_warp_sum(s) / C;
    float ss = 0.f;
    for (int i = lane; i < C; i += 32) {
        const float d = to_f(xr[i]) - mean;
        ss = fmaf(d, d, ss);
    }
    const float inv = rsqrtf(idt_warp_sum(ss) / C + eps);
    for (int i = lane; i < C; i += 32)
        yr[i] = static_cast<T>((to_f(xr[i]) - mean) * inv * to_f(scale[i]) + to_f(bias[i]));
}

template <typename T, typename AT>
cudaError_t ln_launch(const void* x, const void* scale, const void* bias, void* y, long long rows,
                      int C, float eps, int lanes, cudaStream_t s) {
    const auto* xp = static_cast<const T*>(x);
    const auto* sp = static_cast<const AT*>(scale);
    const auto* bp = static_cast<const AT*>(bias);
    auto* yp = static_cast<T*>(y);
    if (lanes == 0) {
        const long long blocks = (rows + kLnWarps - 1) / kLnWarps;
        ln_generic_kernel<T, AT><<<(unsigned)blocks, kThreads, 0, s>>>(xp, sp, bp, yp, rows, C, eps);
        return cudaGetLastError();
    }
    constexpr int E = 16 / sizeof(T);
    if ((lanes != 8 && lanes != 16 && lanes != 32) || C % E || C / E > lanes * kLnVecs)
        return cudaErrorInvalidValue;
    const long long per_block = (long long)kLnWarps * (32 / lanes);
    const long long blocks = (rows + per_block - 1) / per_block;
    ln_rows_kernel<T, AT><<<(unsigned)blocks, kThreads, 0, s>>>(xp, sp, bp, yp, rows, C, lanes, eps);
    return cudaGetLastError();
}

}  // namespace

// x, y: (B, N, C) contiguous bf16; scale, bias: (C,) bf16 (affine_fp32 = 0)
// or fp32 (1); partial: fp64 scratch of B * splits * 2 * G. Each sample's
// rows are cut into `splits` chunks of rows_per; threads = (C / 8) * R, smem
// = R x C fp32. Requires C % 8 == 0, C % G == 0, G <= 64, threads <= 320,
// and B * splits blocks resident at once (the launch fails otherwise).
IDT_EXPORT int idt_group_norm(const void* x, const void* scale, const void* bias, void* y,
                              void* partial, int B, int N, int C, int G, int splits, int rows_per,
                              int threads, int smem, float eps, int silu, int affine_fp32,
                              void* stream) {
    if (C % 8 || C % G || G > kMaxGroups || threads > kGnMaxThreads || threads % (C / 8))
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return static_cast<int>(
        affine_fp32 ? gn_launch<float>(x, scale, bias, y, partial, B, N, C, G, splits, rows_per,
                                       threads, smem, eps, silu, s)
                    : gn_launch<__nv_bfloat16>(x, scale, bias, y, partial, B, N, C, G, splits,
                                               rows_per, threads, smem, eps, silu, s));
}

// x, y: (rows, C) contiguous, bf16 (fp32 = 0) or fp32 (fp32 = 1); scale,
// bias: (C,) bf16 (affine_fp32 = 0) or fp32 (1), read as stored. lanes: 8, 16
// or 32 lanes per row on the register-resident route (x, y, scale and bias
// 16-byte aligned, C a multiple of the 16-byte vector, at most 8 vectors a
// lane), or 0 for the generic loop (any C).
IDT_EXPORT int idt_layer_norm(const void* x, const void* scale, const void* bias, void* y,
                              long long rows, int C, float eps, int fp32, int affine_fp32,
                              int lanes, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (fp32)
        err = affine_fp32
                  ? ln_launch<float, float>(x, scale, bias, y, rows, C, eps, lanes, s)
                  : ln_launch<float, __nv_bfloat16>(x, scale, bias, y, rows, C, eps, lanes, s);
    else
        err = affine_fp32
                  ? ln_launch<__nv_bfloat16, float>(x, scale, bias, y, rows, C, eps, lanes, s)
                  : ln_launch<__nv_bfloat16, __nv_bfloat16>(x, scale, bias, y, rows, C, eps,
                                                            lanes, s);
    return static_cast<int>(err);
}
