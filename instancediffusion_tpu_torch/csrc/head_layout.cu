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
// a multiple of 8, each 16-byte vector of 8 output columns lies inside one
// head, and a column tile that straddles heads needs no special case.
//
// What bounds it on the H100. At the ds1 serving shape (B=16, 4096 rows,
// K = 320, 320 columns a weight) a call must move 84 MB (q, K8') or 126 MB
// (k and v) through device memory: 25 / 38 us at 3.35 TB/s, against 13.6 us
// of tensor-core work per weight. Bytes bound it, and with K = 320 the
// weights are as large as 80 rows of activations: a kernel that keeps the
// activations resident and streams the weights per 128-row tile reads 2.5x
// more from L2 than from device memory, and measured 0.060 ms (q) and 0.103
// ms (k, v) on an H100 80GB HBM3 at 700 W, slower than F.linear.
// So the weights stay resident and the activations stream, once:
//   - A cluster of CL blocks shares each 64-row activation tile: CL = the
//     weights' column tiles (q and K8': 2 x 160 columns; k and v: 2 x 2).
//     Block r of the cluster keeps its (160 x K) slice of one weight in
//     shared memory for the whole launch (100 KB at K = 320), loaded once.
//   - The activation tiles stream through three slots (two where K is 8
//     heads); each block loads its share of a tile's 64-column,
//     128-byte-swizzled boxes by TMA multicast into every block of the
//     cluster, so device memory is read once per tile whatever CL is. A slot
//     is free again when every block's reader has read it (a remote mbarrier
//     arrival per warp). Load latency is what the slots hide, so there are
//     as many as fit.
//   - Two consumer warpgroups take alternate tiles: one multiplies its tile
//     with wgmma (m64n160, both operands in shared memory, K-major; the
//     64 x 160 fp32 accumulator is 80 of the 168 registers a thread of a
//     384-thread block gets) while the other writes its results, so the
//     tensor cores, the loads and the stores overlap.
//   - The epilogue adds the bias in fp32, rounds once and stores 16-byte
//     vectors straight from registers: the four threads that hold a row's
//     column pairs trade them by shuffles (a 4 x 4 transpose), so no shared
//     memory is spent on staging. Rows >= M of K8 come out zero with no
//     test: the activation map ends at row M and TMA fills rows past it with
//     zeros.
//   - The slot is freed with a CTA-scope mbarrier arrival on each block of
//     the cluster. A cluster-scope release there makes ptxas put a
//     MEMBAR.GPU before it, which waits for the thread's earlier global
//     stores: with it (and a transpose the compiler had turned into
//     branches) the epilogue took ~6600 cycles a warpgroup and tile against
//     ~2400 without (clock64 inside the kernel; q 0.048 -> 0.036 ms).
//   - The grid is persistent: as many clusters as the card holds at once
//     (cudaOccupancyMaxActiveClusters), each walking the row tiles.
// K8' takes the flash kernel's output, a head view of a (B, N, H, c)
// buffer, as the plain (B, N, H*c) matrix it is. Any other head view (a
// contiguous (B, H, N, c) tensor) is read per head: chunk k is head k, a
// box of the (c, N, H, B) map zero-filled from c to 64 columns, multiplied
// by the same box of a (c, H, C_out) map of w; the slices are then 64
// columns wide (CL = 5 at C_out = 320) to fit the 8 chunks.
//
// The Python wrapper's plan (kernels/head_layout.py: split_plan,
// merge_plan) mirrors `make_plan` below; `idt_head_plan` reports this
// file's plan so the wrapper can refuse a launch whose plan differs.
#include <initializer_list>

#include "sm90.cuh"
#include "tma_host.cuh"

namespace {

constexpr int kRows = 64;                  // rows per activation tile and warpgroup
constexpr int kBoxBytes = kRows * 128;     // a 64-column box of a tile, 128-byte swizzle
constexpr int kThreads = 384;              // 2 consumer warpgroups + 1 producer warpgroup
constexpr int kSmemCap = 232448;           // shared memory a block can use
constexpr int kMaxChunks = 8;              // K up to 512 (or 8 heads)
constexpr int kMaxCluster = 8;             // portable cluster size
constexpr int kMaxSlots = 3;               // activation tiles in flight
constexpr int kBarBytes = 128;             // w; full per warpgroup and slot; empty per slot

// A matrix whose columns are cut into heads of hc contiguous elements:
// element (b, r, col) lives at b*sb + (col / hc)*sh + r*sr + col % hc.
// A plain row-major (rows x n) matrix is hc = n, sh = 0.
struct HeadView {
    long long sb, sh, sr;
    int hc;
};

struct Params {
    __nv_bfloat16* out[2];  // one per weight
    HeadView out_view;
    const float* bias;      // (n_cols,) fp32, or null
    int out_rows;           // rows [0, out_rows) of each sample are written
    int row_tiles;          // ceil(out_rows / kRows)
    int tiles;              // B * row_tiles
    int chunks;             // 64-column (or per-head) chunks of K
    int per_head;           // chunk k: A columns [64k, +64) (0) or head k (1)
    int slots;              // activation slots
    int n_cols;             // output columns per weight
};

// shared bytes of a block besides its activation slots: the weight slice,
// barriers, and 1 KB to align the base (the 128-byte swizzle repeats every
// 1024 bytes)
int fixed_bytes(int nt, int chunks) { return chunks * nt * 128 + kBarBytes + 1024; }

// activation slots (64 rows x K) that fit beside them, at most kMaxSlots
int slots_that_fit(int nt, int chunks) {
    const int fit = (kSmemCap - fixed_bytes(nt, chunks)) / (chunks * kBoxBytes);
    return fit < kMaxSlots ? fit : kMaxSlots;
}

// The plan of one launch: column tile, cluster, shared bytes, tiles, grid
// and the two tensor maps (dims innermost first, byte strides of dims 1..,
// box).
struct Plan {
    int col_tile, chunks, per_head, cluster, slots, smem, tiles, row_tiles, grid, max_clusters;
    int a_rank, w_rank;
    long long a_dims[4], a_strides[3], w_dims[3], w_strides[2];
    int a_box[4], w_box[3];

    void flatten(long long* v) const {
        const long long head[10] = {kRows, col_tile, chunks, per_head, cluster,
                                    slots, smem,     tiles,  grid,     max_clusters};
        int i = 0;
        for (long long x : head) v[i++] = x;
        v[i++] = a_rank;
        for (int d = 0; d < 4; ++d) v[i++] = d < a_rank ? a_dims[d] : 0;
        for (int d = 0; d < 3; ++d) v[i++] = d + 1 < a_rank ? a_strides[d] : 0;
        for (int d = 0; d < 4; ++d) v[i++] = d < a_rank ? a_box[d] : 0;
        v[i++] = w_rank;
        for (int d = 0; d < 3; ++d) v[i++] = d < w_rank ? w_dims[d] : 0;
        for (int d = 0; d < 2; ++d) v[i++] = d + 1 < w_rank ? w_strides[d] : 0;
        for (int d = 0; d < 3; ++d) v[i++] = d < w_rank ? w_box[d] : 0;
    }
};

int max_active_clusters(int nt, int cluster, int smem);

// Fill the layout part of a plan; false if the kernel does not take it.
// max_clusters <= 0: ask the card how many clusters of this plan fit at once.
bool make_plan(Plan* p, int B, int out_rows, int chunks, int per_head, int n_cols, int n_out,
               int max_clusters) {
    if (B < 1 || out_rows < 1 || n_cols < 1 || chunks < 1 || chunks > kMaxChunks || n_out < 1 ||
        n_out > 2)
        return false;
    p->col_tile = 0;
    for (int nt : {160, 64}) {
        const int cl = n_out * (n_cols / nt);
        if (n_cols % nt == 0 && cl <= kMaxCluster && slots_that_fit(nt, chunks) >= 2) {
            p->col_tile = nt;
            p->cluster = cl;
            break;
        }
    }
    if (p->col_tile == 0) return false;
    p->chunks = chunks;
    p->per_head = per_head;
    p->slots = slots_that_fit(p->col_tile, chunks);
    p->smem = fixed_bytes(p->col_tile, chunks) + p->slots * chunks * kBoxBytes;
    p->row_tiles = (out_rows + kRows - 1) / kRows;
    p->tiles = B * p->row_tiles;
    p->max_clusters =
        max_clusters > 0 ? max_clusters : max_active_clusters(p->col_tile, p->cluster, p->smem);
    if (p->max_clusters < 1) return false;
    p->grid = (p->tiles < p->max_clusters ? p->tiles : p->max_clusters) * p->cluster;
    return true;
}

// A as the (K, rows, B) matrix it is (row stride sr, batch stride sb, in
// elements), and w (n_cols, K) row-major
void plain_maps(Plan* p, int K, int rows, int B, long long sr, long long sb, int n_cols) {
    p->a_rank = 3;
    p->a_dims[0] = K, p->a_dims[1] = rows, p->a_dims[2] = B;
    p->a_strides[0] = 2 * sr, p->a_strides[1] = 2 * sb;
    p->a_box[0] = 64, p->a_box[1] = kRows, p->a_box[2] = 1;
    p->w_rank = 2;
    p->w_dims[0] = K, p->w_dims[1] = n_cols;
    p->w_strides[0] = 2LL * K;
    p->w_box[0] = 64, p->w_box[1] = p->col_tile;
}

bool split_plan(Plan* p, long long x_sb, long long x_sr, int B, int M, int Mpad, int C_in,
                int H, int c, int n_out, int max_clusters) {
    // a sample's output offsets are 32-bit in the epilogue
    if (M < 1 || Mpad < M || c % 8 || C_in % 8 || H < 1 || (long long)H * Mpad * c >= (1LL << 31))
        return false;
    if (!make_plan(p, B, Mpad, (C_in + 63) / 64, 0, H * c, n_out, max_clusters)) return false;
    plain_maps(p, C_in, M, B, x_sr, x_sb, H * c);
    return true;
}

bool merge_plan(Plan* p, long long o_sb, long long o_sh, long long o_sr, int B, int N, int H,
                int c, int C_out, int max_clusters) {
    if (N < 1 || H < 1 || c % 8) return false;
    const int K = H * c;
    if (o_sh == c || H == 1) {  // heads side by side: the (B, N, H*c) matrix
        if (!make_plan(p, B, N, (K + 63) / 64, 0, C_out, 1, max_clusters)) return false;
        plain_maps(p, K, N, B, o_sr, o_sb, C_out);
        return true;
    }
    if (c > 64 || !make_plan(p, B, N, H, 1, C_out, 1, max_clusters)) return false;
    p->a_rank = 4;
    p->a_dims[0] = c, p->a_dims[1] = N, p->a_dims[2] = H, p->a_dims[3] = B;
    p->a_strides[0] = 2 * o_sr, p->a_strides[1] = 2 * o_sh, p->a_strides[2] = 2 * o_sb;
    p->a_box[0] = 64, p->a_box[1] = kRows, p->a_box[2] = 1, p->a_box[3] = 1;
    p->w_rank = 3;
    p->w_dims[0] = c, p->w_dims[1] = H, p->w_dims[2] = C_out;
    p->w_strides[0] = 2LL * c, p->w_strides[1] = 2LL * K;
    p->w_box[0] = 64, p->w_box[1] = 1, p->w_box[2] = p->col_tile;
    return true;
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) reg_fence(r[i]);
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
    head_gemm_sm90(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw0,
                   const __grid_constant__ CUtensorMap tw1, const Params p) {
    constexpr int kWBox = NT * 128;  // NT rows of w x 64 columns
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    // the same offset in every block of a cluster: the kernel's shared memory
    // starts at the same address in each
    unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    const int KC = p.chunks, S = p.slots;
    const int x_bytes = KC * kBoxBytes;
    unsigned char* wres = smem;             // this block's weight slice, KC boxes
    unsigned char* xs = smem + KC * kWBox;  // S activation slots of KC boxes
    uint64_t* bars = reinterpret_cast<uint64_t*>(xs + S * x_bytes);
    // xfull[w * kMaxSlots + s]: a tile for warpgroup w has landed in slot s
    // of this block. A parity names a phase only while the barrier is at
    // most one phase away, and with three slots the two warpgroups take
    // turns on each slot: a barrier per warpgroup keeps each one's phases
    // in the order it waits for them. xempty[s]: every block's reader of
    // slot s has read it.
    uint64_t* wfull = bars;
    uint64_t* xfull = bars + 1;
    uint64_t* xempty = bars + 1 + 2 * kMaxSlots;

    uint32_t cl_size;
    asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(cl_size));
    const int cl = static_cast<int>(cl_size);
    const uint32_t rank = cluster_ctarank();
    const int cluster_id = blockIdx.x / cl, n_clusters = gridDim.x / cl;
    const int col_tiles = p.n_cols / NT;
    const int wj = rank / col_tiles, n0 = (rank % col_tiles) * NT;  // this block's slice

    if (threadIdx.x == 0) {
        mbar_init(wfull, 1);
        for (int s = 0; s < S; ++s) {
            mbar_init(xfull + s, 1);
            mbar_init(xfull + kMaxSlots + s, 1);
            mbar_init(xempty + s, 4 * cl);  // one warpgroup in every block: 4 warps each
        }
        mbar_fence_init();
    }
    __syncthreads();
    cluster_sync();  // no multicast or remote arrival reaches a barrier not yet set up

    if (threadIdx.x == 256) {
        // the producer: this block's weight slice once, then its share of
        // every activation tile of the cluster, multicast to all its blocks
        const CUtensorMap* tw = wj == 0 ? &tw0 : &tw1;
        mbar_expect_tx(wfull, KC * kWBox);
        for (int k = 0; k < KC; ++k) {
            if (p.per_head)
                tma_load_3d(wres + k * kWBox, tw, wfull, 0, k, n0);
            else
                tma_load_2d(wres + k * kWBox, tw, wfull, 64 * k, n0);
        }
        const uint16_t mask = static_cast<uint16_t>((1u << cl) - 1);
        int i = 0;
        for (int tile = cluster_id; tile < p.tiles; tile += n_clusters, ++i) {
            const int s = i % S;
            mbar_wait(xempty + s, ((i / S) & 1) ^ 1);  // a fresh barrier passes parity 1
            uint64_t* full = xfull + ((i & 1) * kMaxSlots + s);  // for warpgroup i % 2
            mbar_expect_tx(full, x_bytes);
            const int b = tile / p.row_tiles, r0 = (tile % p.row_tiles) * kRows;
            unsigned char* dst = xs + s * x_bytes;
            for (int k = rank; k < KC; k += cl) {
                if (p.per_head)
                    tma_load_4d_mc(dst + k * kBoxBytes, &ta, full, mask, 0, r0, k, b);
                else
                    tma_load_3d_mc(dst + k * kBoxBytes, &ta, full, mask, 64 * k, r0, b);
            }
        }
    } else if (threadIdx.x < 256) {
        const int wg = threadIdx.x >> 7;  // takes the cluster's tiles wg, wg + 2, ...
        const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
        const int g = lane >> 2, t = lane & 3;
        const uint64_t dw0 = wgmma_desc_sw128(smem_u32(wres), 16, 1024);
        __nv_bfloat16* out = wj == 0 ? p.out[0] : p.out[1];
        const HeadView ov = p.out_view;
        // a thread stores the 16-byte column block 4q + t of its rows: its
        // offset within a sample, less the row's
        int coff[NT / 32];
#pragma unroll
        for (int q = 0; q < NT / 32; ++q) {
            const int col = n0 + 8 * (4 * q + t);
            coff[q] = (col / ov.hc) * static_cast<int>(ov.sh) + col % ov.hc;
        }

        float acc[NT / 2];
#pragma unroll
        for (int e = 0; e < NT / 2; ++e) acc[e] = 0.f;
        mbar_wait(wfull, 0);

        for (int i = wg, tile = cluster_id + wg * n_clusters; tile < p.tiles;
             i += 2, tile += 2 * n_clusters) {
            const int s = i % S;
            // this warpgroup's n-th tile in slot s comes every lcm(2, S) tiles
            mbar_wait(xfull + (wg * kMaxSlots + s), (i / (S % 2 == 0 ? S : 2 * S)) & 1);
            const uint64_t dx0 = wgmma_desc_sw128(smem_u32(xs + s * x_bytes), 16, 1024);
            // one wgmma group per chunk, waited for once
            for (int k = 0; k < KC; ++k) {
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                    wgmma_ss<NT>(acc, dx0 + k * (kBoxBytes >> 4) + 2 * kk,
                                 dw0 + k * (kWBox >> 4) + 2 * kk, k > 0 || kk > 0);
                wgmma_commit();
            }
            wgmma_wait<0>();
            fence_regs(acc);
            // the slot is read: free it in every block of the cluster
            __syncwarp();
            if (lane < cl) mbar_arrive_remote(cluster_map(smem_u32(xempty + s), lane));

            // + bias in fp32, one rounding, 16-byte stores through the output
            // view: the quad's four threads trade their column pairs (a 4 x 4
            // transpose in two shuffle rounds), so that thread t holds all 8
            // columns of block 4q + t of its row
            const int b = tile / p.row_tiles;
            const int row0 = (tile % p.row_tiles) * kRows + warp * 16 + g;
            __nv_bfloat16* base = out + b * ov.sb;
            const bool odd = t & 1, high = t & 2;
#pragma unroll
            for (int q = 0; q < NT / 32; ++q) {
                float2 bb[4];
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    bb[u] = make_float2(0.f, 0.f);
                    if (p.bias != nullptr)
                        bb[u] = *reinterpret_cast<const float2*>(p.bias + n0 + 8 * (4 * q + u) +
                                                                 2 * t);
                }
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    uint32_t v[4];  // block 4q + u, this thread's column pair
#pragma unroll
                    for (int u = 0; u < 4; ++u) {
                        const int j = 4 * q + u;
                        v[u] = pack_bf16(acc[4 * j + 2 * h] + bb[u].x,
                                         acc[4 * j + 2 * h + 1] + bb[u].y);
                    }
                    // round 1, lanes t and t ^ 1: keep blocks odd and odd + 2,
                    // as (even lane's pair, odd lane's pair)
                    const uint32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[1], 1);
                    const uint32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? v[2] : v[3], 1);
                    const uint32_t k0 = odd ? v[1] : v[0], k1 = odd ? v[3] : v[2];
                    const uint32_t p0 = odd ? r0 : k0, q0 = odd ? k0 : r0;  // block odd
                    const uint32_t p1 = odd ? r1 : k1, q1 = odd ? k1 : r1;  // block odd + 2
                    // round 2, lanes t and t ^ 2: keep block t, take the other
                    // lane pair's half of it
                    const uint32_t rp = __shfl_xor_sync(0xffffffffu, high ? p0 : p1, 2);
                    const uint32_t rq = __shfl_xor_sync(0xffffffffu, high ? q0 : q1, 2);
                    const uint32_t kp = high ? p1 : p0, kq = high ? q1 : q0;
                    const uint4 o = high ? make_uint4(rp, rq, kp, kq) : make_uint4(kp, kq, rp, rq);
                    const int row = row0 + 8 * h;
                    if (row < p.out_rows)
                        *reinterpret_cast<uint4*>(base + row * ov.sr + coff[q]) = o;
                }
            }
            fence_regs(acc);
        }
    }
    // no block leaves while another may still write to its shared memory or
    // arrive on its barriers
    __syncwarp();
    cluster_sync();
}

bool encode(idt_tma::EncodeTiled enc, CUtensorMap* map, const void* ptr, int rank,
            const long long* dims, const long long* strides, const int* box,
            CUtensorMapL2promotion promo) {
    cuuint64_t d[4], st[3];
    cuuint32_t bx[4], estr[4] = {1, 1, 1, 1};
    for (int i = 0; i < rank; ++i) {
        d[i] = static_cast<cuuint64_t>(dims[i]);
        bx[i] = static_cast<cuuint32_t>(box[i]);
        if (i + 1 < rank) st[i] = static_cast<cuuint64_t>(strides[i]);
    }
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), d, st, bx,
               estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, promo,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NT>
cudaLaunchConfig_t launch_config(int grid, int cluster, int smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg{};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

template <int NT>
int max_active_clusters_nt(int cluster, int smem) {
    auto kern = head_gemm_sm90<NT>;
    if (idt_allow_smem(kern, smem) != cudaSuccess) return 0;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = launch_config<NT>(cluster * 132, cluster, smem, 0, attr);
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, kern, &cfg) != cudaSuccess) return 0;
    return n;
}

// clusters of this shape the card holds at once (asked once per shape and
// device)
int max_active_clusters(int nt, int cluster, int smem) {
    struct Entry {
        int dev, nt, cluster, smem, n;
    };
    static Entry cache[32];
    static int used = 0;
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 0;
    for (int i = 0; i < used; ++i)
        if (cache[i].dev == dev && cache[i].nt == nt && cache[i].cluster == cluster &&
            cache[i].smem == smem)
            return cache[i].n;
    const int n = nt == 160 ? max_active_clusters_nt<160>(cluster, smem)
                            : max_active_clusters_nt<64>(cluster, smem);
    if (n > 0 && used < 32) cache[used++] = Entry{dev, nt, cluster, smem, n};
    return n;
}

template <int NT>
cudaError_t launch_nt(const CUtensorMap& ta, const CUtensorMap& tw0, const CUtensorMap& tw1,
                      const Params& p, const Plan& plan, cudaStream_t stream) {
    auto kern = head_gemm_sm90<NT>;
    const cudaError_t err = idt_allow_smem(kern, plan.smem);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg =
        launch_config<NT>(plan.grid, plan.cluster, plan.smem, stream, attr);
    return cudaLaunchKernelEx(&cfg, kern, ta, tw0, tw1, p);
}

// Encode the maps of `plan` and launch. a: the activations; w[n_out].
int launch(const Plan& plan, const void* a, const void* const* w, int n_out, Params p,
           void* stream) {
    const idt_tma::EncodeTiled enc = idt_tma::encoder();
    if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
    CUtensorMap ta, tw[2];
    if (!encode(enc, &ta, a, plan.a_rank, plan.a_dims, plan.a_strides, plan.a_box,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B))
        return static_cast<int>(cudaErrorInvalidValue);
    for (int j = 0; j < n_out; ++j)
        if (!encode(enc, &tw[j], w[j], plan.w_rank, plan.w_dims, plan.w_strides, plan.w_box,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_256B))
            return static_cast<int>(cudaErrorInvalidValue);
    if (n_out == 1) tw[1] = tw[0];
    p.row_tiles = plan.row_tiles;
    p.tiles = plan.tiles;
    p.chunks = plan.chunks;
    p.per_head = plan.per_head;
    p.slots = plan.slots;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err = plan.col_tile == 160
                                ? launch_nt<160>(ta, tw[0], tw[1], p, plan, s)
                                : launch_nt<64>(ta, tw[0], tw[1], p, plan, s);
    return static_cast<int>(err);
}

}  // namespace

// K8. x: (B, M, C_in) bf16 with element strides (x_sb, x_sr), channels
// contiguous; w0/w1: (H*c, C_in) bf16 row-major (w1 null for one weight);
// out0/out1: (B, H, Mpad, c) bf16 contiguous, rows >= M zeroed. Requires
// c % 8 == 0, C_in % 8 == 0 and C_in <= 512, H*c a multiple of 64 (at most
// 8 column tiles over the weights), strides multiples of 8 and x 16-byte
// aligned; other calls return cudaErrorInvalidValue.
IDT_EXPORT int idt_proj_split(const void* x, long long x_sb, long long x_sr, const void* w0,
                              const void* w1, void* out0, void* out1, int B, int M, int Mpad,
                              int C_in, int H, int c, void* stream) {
    const int n_out = w1 == nullptr ? 1 : 2;
    Plan plan{};
    if (!split_plan(&plan, x_sb, x_sr, B, M, Mpad, C_in, H, c, n_out, 0))
        return static_cast<int>(cudaErrorInvalidValue);
    Params p{};
    p.out[0] = static_cast<__nv_bfloat16*>(out0);
    p.out[1] = static_cast<__nv_bfloat16*>(out1);
    p.out_view = HeadView{(long long)H * Mpad * c, (long long)Mpad * c, c, c};
    p.bias = nullptr;
    p.out_rows = Mpad;
    p.n_cols = H * c;
    const void* w[2] = {w0, w1};
    return launch(plan, x, w, n_out, p, stream);
}

// K8'. o: (B, H, N, c) bf16 with element strides (o_sb, o_sh, o_sr),
// channels contiguous; w: (C_out, H*c) bf16 row-major; bias: (C_out,) fp32
// or null; out: (B, N, C_out) bf16 contiguous. Requires c % 8 == 0, C_out a
// multiple of 64, strides multiples of 8, and H*c <= 512 when the heads lie
// side by side (o_sh == c), else H <= 8 and c <= 64; other calls return
// cudaErrorInvalidValue.
IDT_EXPORT int idt_merge_proj(const void* o, long long o_sb, long long o_sh, long long o_sr,
                              const void* w, const void* bias, void* out, int B, int N, int H,
                              int c, int C_out, void* stream) {
    Plan plan{};
    if (!merge_plan(&plan, o_sb, o_sh, o_sr, B, N, H, c, C_out, 0))
        return static_cast<int>(cudaErrorInvalidValue);
    Params p{};
    p.out[0] = p.out[1] = static_cast<__nv_bfloat16*>(out);
    p.out_view = HeadView{(long long)N * C_out, 0, C_out, C_out};
    p.bias = static_cast<const float*>(bias);
    p.out_rows = N;
    p.n_cols = C_out;
    const void* w2[2] = {w, nullptr};
    return launch(plan, o, w2, 1, p, stream);
}

// The plan the launchers above derive for a call (kind 0: idt_proj_split
// with sizes (B, M, Mpad, C_in, H, c, n_out) and strides (x_sb, x_sr); kind
// 1: idt_merge_proj with (B, N, H, c, C_out) and (o_sb, o_sh, o_sr)), as
// 31 int64 values in kernels/head_layout.py::HeadPlan's order.
// max_clusters > 0 stands in for the card's count of co-resident clusters.
// Returns 0, or cudaErrorInvalidValue for a call the kernel refuses.
IDT_EXPORT int idt_head_plan(int kind, const long long* sizes, const long long* strides,
                             int max_clusters, long long* values) {
    Plan plan{};
    const bool ok =
        kind == 0
            ? split_plan(&plan, strides[0], strides[1], (int)sizes[0], (int)sizes[1],
                         (int)sizes[2], (int)sizes[3], (int)sizes[4], (int)sizes[5],
                         (int)sizes[6], max_clusters)
            : merge_plan(&plan, strides[0], strides[1], strides[2], (int)sizes[0], (int)sizes[1],
                         (int)sizes[2], (int)sizes[3], (int)sizes[4], max_clusters);
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    plan.flatten(values);
    return 0;
}

// Clusters of `cluster` blocks of the kernel with column tile `col_tile` and
// `smem` shared bytes that the current card holds at once (0 on error).
IDT_EXPORT int idt_head_max_clusters(int col_tile, int cluster, int smem) {
    return max_active_clusters(col_tile, cluster, smem);
}
