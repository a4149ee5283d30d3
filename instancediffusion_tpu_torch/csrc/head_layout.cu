// Projection GEMMs that split or merge attention heads in their addressing:
//   K8  proj_split:  out_j[b, h, r, :] = (x[b, r, :] @ w_j^T)[h*c:(h+1)*c],
//                    rows r >= M written as zeros, for 1 or 2 weights w_j;
//   K8' merge_proj:  out[b, r, :] = merge_heads(o)[b, r, :] @ w^T + bias.
//
// Replaces instancediffusion_tpu/kernels/head_layout.py::proj_split
// (_proj_split_kernel) and ::merge_proj (_merge_proj_kernel). On the TPU
// the head relayout was a VMEM shuffle of a (block_n, H*c) tile; here it is
// only an address: the product is an ordinary (rows x K) @ (K x N) GEMM, and
// a column j of the projection belongs to head j / c, channel j % c. With c
// a multiple of 8, each 16-byte vector of 8 bf16 lies inside one head, so
// the head-split store (K8) and the head-merged load (K8') move whole
// vectors, and a 64-wide tile that straddles heads needs no special case.
//
// Work per call at the ds1 serving shape (B=16, 4096 rows, 320 x 320):
// 13.4 GFLOP per weight against 84 MB (K8 q, K8') or 126 MB (K8 k/v) of
// HBM traffic, so the bytes bound it on the H100 (25 / 38 us); the FLOPs
// would take 13.6 us per weight at the bf16 tensor-core peak. This first
// version is simple: 64 x 64 output tiles, 8 warps of mma.sync m16n8k16
// with ldmatrix operands and fp32 accumulators, the next 64-deep K chunk
// fetched into registers while the current one is multiplied, and the
// output staged through shared memory so the stores are 16-byte vectors.
// One block computes its tile for every weight, so the k/v call reads x
// once. No TMA, no wgmma: it will not reach the byte bound.
#include "common.cuh"

namespace {

constexpr int kBM = 64;  // rows per block
constexpr int kBN = 64;  // output columns per block
constexpr int kBK = 64;  // K chunk
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kLD = 72;  // bf16 pitch of a 64-wide tile (16-byte rows, no ldmatrix conflicts)

// A matrix whose columns are cut into heads of hc contiguous elements:
// element (b, r, col) lives at b*sb + (col / hc)*sh + r*sr + col % hc.
// A plain row-major (rows x n) matrix is hc = n, sh = 0.
struct HeadView {
    long long sb, sh, sr;
    int hc;

    __device__ __forceinline__ long long offset(int b, int r, int col) const {
        return (long long)b * sb + (long long)(col / hc) * sh + (long long)r * sr + col % hc;
    }
};

struct Params {
    const __nv_bfloat16* a;  // A (rows x K) addressed by a_view
    HeadView a_view;
    int a_rows;              // rows >= a_rows read as zero
    const __nv_bfloat16* w[2];  // W_j (n_cols x K), row-major (torch Linear layout)
    const float* bias;       // (n_cols,) fp32, or null
    __nv_bfloat16* out[2];   // Y_j addressed by out_view
    HeadView out_view;
    int out_rows;            // rows [0, out_rows) are written
    int zero_from;           // rows >= zero_from are written as zeros
    int K, n_cols;
};

// One thread's share (2 16-byte vectors) of a 64 x 64 bf16 tile: rows
// row0.. of `view`, columns col0..col0+63; rows >= limit read as zero.
struct Tile {
    uint4 v[2];

    __device__ __forceinline__ void fetch(const __nv_bfloat16* src, const HeadView& view, int b,
                                          int row0, int limit, int col0) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int idx = threadIdx.x + e * kThreads;
            const int r = idx >> 3, col = (idx & 7) * 8;
            v[e] = make_uint4(0u, 0u, 0u, 0u);
            if (row0 + r < limit)
                v[e] = *reinterpret_cast<const uint4*>(src + view.offset(b, row0 + r, col0 + col));
        }
    }

    __device__ __forceinline__ void store(__nv_bfloat16* dst) const {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int idx = threadIdx.x + e * kThreads;
            *reinterpret_cast<uint4*>(dst + (idx >> 3) * kLD + (idx & 7) * 8) = v[e];
        }
    }
};

template <int NOUT>
__global__ void __launch_bounds__(kThreads) head_gemm_kernel(const Params p) {
    // sA holds the A chunk, sW[j] the W_j chunk; after the K loop they
    // stage the output tiles (tile j in buffer j of {sA, sW[0]})
    __shared__ __align__(16) __nv_bfloat16 sA[kBM * kLD];
    __shared__ __align__(16) __nv_bfloat16 sW[NOUT][kBN * kLD];

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;    // mma fragment row / column pair
    const int lm = lane >> 3, lr = lane & 7;  // ldmatrix matrix / row
    const int wrow = (warp & 3) * 16;         // this warp's 16 rows
    const int wcol = (warp >> 2) * 32;        // and 32 of the 64 tile columns
    const int n0 = blockIdx.x * kBN;
    const int m0 = blockIdx.y * kBM;
    const int b = blockIdx.z;
    const HeadView w_view{0, 0, p.K, p.K};

    float acc[NOUT][4][4];
#pragma unroll
    for (int j = 0; j < NOUT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][q][e] = 0.f;

    Tile ta, tw[NOUT];
    ta.fetch(p.a, p.a_view, b, m0, p.a_rows, 0);
#pragma unroll
    for (int j = 0; j < NOUT; ++j) tw[j].fetch(p.w[j], w_view, 0, n0, p.n_cols, 0);
    for (int kc = 0; kc < p.K; kc += kBK) {
        __syncthreads();  // the previous chunk's readers are done
        ta.store(sA);
#pragma unroll
        for (int j = 0; j < NOUT; ++j) tw[j].store(sW[j]);
        __syncthreads();
        if (kc + kBK < p.K) {
            ta.fetch(p.a, p.a_view, b, m0, p.a_rows, kc + kBK);
#pragma unroll
            for (int j = 0; j < NOUT; ++j) tw[j].fetch(p.w[j], w_view, 0, n0, p.n_cols, kc + kBK);
        }
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
            uint32_t af[4];
            ldsm_x4(af, sA + (wrow + (lm & 1) * 8 + lr) * kLD + kk * 16 + (lm >> 1) * 8);
#pragma unroll
            for (int j = 0; j < NOUT; ++j) {
#pragma unroll
                for (int q = 0; q < 4; q += 2) {
                    uint32_t bf[4];
                    ldsm_x4(bf, sW[j] + (wcol + (q + (lm >> 1)) * 8 + lr) * kLD + kk * 16 +
                                    (lm & 1) * 8);
                    mma_bf16(acc[j][q], af, bf[0], bf[1]);
                    mma_bf16(acc[j][q + 1], af, bf[2], bf[3]);
                }
            }
        }
    }

    // epilogue: bias in fp32, zeroed pad rows, one rounding to bf16 into
    // shared memory, then 16-byte stores through out_view
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NOUT; ++j) {
        __nv_bfloat16* stage = j == 0 ? sA : sW[0];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int col = wcol + q * 8 + 2 * t;
            float b0 = 0.f, b1 = 0.f;
            if (p.bias != nullptr) {
                b0 = p.bias[n0 + col];
                b1 = p.bias[n0 + col + 1];
            }
#pragma unroll
            for (int hrow = 0; hrow < 2; ++hrow) {
                const int r = wrow + g + 8 * hrow;
                const bool zero = m0 + r >= p.zero_from;
                const float y0 = zero ? 0.f : acc[j][q][2 * hrow] + b0;
                const float y1 = zero ? 0.f : acc[j][q][2 * hrow + 1] + b1;
                *reinterpret_cast<__nv_bfloat162*>(stage + r * kLD + col) =
                    __floats2bfloat162_rn(y0, y1);
            }
        }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NOUT; ++j) {
        const __nv_bfloat16* stage = j == 0 ? sA : sW[0];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int idx = threadIdx.x + e * kThreads;
            const int r = idx >> 3, col = (idx & 7) * 8;
            if (m0 + r < p.out_rows)
                *reinterpret_cast<uint4*>(p.out[j] + p.out_view.offset(b, m0 + r, n0 + col)) =
                    *reinterpret_cast<const uint4*>(stage + r * kLD + col);
        }
    }
}

cudaError_t launch(const Params& p, int n_out, int batch, void* stream) {
    const dim3 grid(p.n_cols / kBN, (p.out_rows + kBM - 1) / kBM, batch);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n_out == 1)
        head_gemm_kernel<1><<<grid, kThreads, 0, s>>>(p);
    else
        head_gemm_kernel<2><<<grid, kThreads, 0, s>>>(p);
    return cudaGetLastError();
}

}  // namespace

// K8. x: (B, M, C_in) bf16 with element strides (x_sb, x_sr), channels
// contiguous; w0/w1: (H*c, C_in) bf16 row-major (w1 null for one weight);
// out0/out1: (B, H, Mpad, c) bf16 contiguous, rows >= M zeroed. Requires
// C_in % 64 == 0, H*c % 64 == 0, c % 8 == 0, strides % 8 == 0.
IDT_EXPORT int idt_proj_split(const void* x, long long x_sb, long long x_sr, const void* w0,
                              const void* w1, void* out0, void* out1, int B, int M, int Mpad,
                              int C_in, int H, int c, void* stream) {
    Params p{};
    p.a = static_cast<const __nv_bfloat16*>(x);
    p.a_view = HeadView{x_sb, 0, x_sr, C_in};
    p.a_rows = M;
    p.w[0] = static_cast<const __nv_bfloat16*>(w0);
    p.w[1] = static_cast<const __nv_bfloat16*>(w1);
    p.bias = nullptr;
    p.out[0] = static_cast<__nv_bfloat16*>(out0);
    p.out[1] = static_cast<__nv_bfloat16*>(out1);
    p.out_view = HeadView{(long long)H * Mpad * c, (long long)Mpad * c, c, c};
    p.out_rows = Mpad;
    p.zero_from = M;
    p.K = C_in;
    p.n_cols = H * c;
    return launch(p, w1 == nullptr ? 1 : 2, B, stream);
}

// K8'. o: (B, H, N, c) bf16 with element strides (o_sb, o_sh, o_sr),
// channels contiguous; w: (C_out, H*c) bf16 row-major; bias: (C_out,) fp32
// or null; out: (B, N, C_out) bf16 contiguous. Requires H*c % 64 == 0,
// C_out % 64 == 0, c % 8 == 0, strides % 8 == 0.
IDT_EXPORT int idt_merge_proj(const void* o, long long o_sb, long long o_sh, long long o_sr,
                              const void* w, const void* bias, void* out, int B, int N, int H,
                              int c, int C_out, void* stream) {
    Params p{};
    p.a = static_cast<const __nv_bfloat16*>(o);
    p.a_view = HeadView{o_sb, o_sh, o_sr, c};
    p.a_rows = N;
    p.w[0] = static_cast<const __nv_bfloat16*>(w);
    p.w[1] = nullptr;
    p.bias = static_cast<const float*>(bias);
    p.out[0] = static_cast<__nv_bfloat16*>(out);
    p.out[1] = nullptr;
    p.out_view = HeadView{(long long)N * C_out, 0, C_out, C_out};
    p.out_rows = N;
    p.zero_from = N;
    p.K = H * c;
    p.n_cols = C_out;
    return launch(p, 1, B, stream);
}
