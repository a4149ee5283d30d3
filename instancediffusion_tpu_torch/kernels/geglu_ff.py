"""GEGLU feed-forward: out = (a * gelu(g)) @ w2^T + b2 with [a | g] = x @
w1^T + b1 and erf GELU, as one fused kernel where the shape fits it.

CUDA source: `csrc/geglu_ff_sm90.cuh` (the kernel, one instantiation per
`csrc/geglu_ff_c*.cu`) and `csrc/geglu_ff.cu` (tensor maps, C entry point).
It replaces `instancediffusion_tpu/kernels/geglu_ff.py::fused_ff_geglu`
(`_ff_kernel`). The Pallas kernel's tanh-GELU was a Mosaic limitation; this
kernel uses erf like the model
(`instancediffusion_tpu/models/unet.py::_apply_ff_geglu`), evaluated by the
fp32 rational approximation XLA uses for `lax.erf`.

What bounds it on an H100: not device memory (1920 FLOPs per activation byte
at C=320) but the SM. Registers decide the shape: a block with a producer
warpgroup gets 168 registers a thread, which must hold the fp32 output tile
of the block's 64 rows (over two consumer warpgroups) and the first
product's tile, so a block owns at most 320 output columns. The first
product's wgmma (N=64, both operands in shared memory) runs at the
shared-memory rate, not the tensor cores', and the gate's time (erf, bias,
packing) adds to the products'. At C=640 shared memory is the limit as well:
x, the gated tiles and one turn of w2 leave the w1 ring four slots, so the
first product waits for its loads. The kernel's header gives the reckoning
and `PERF.md` the measurements. The design keeps everything between x and
out on the SM: the inner dimension is a loop inside the block, the weights
arrive by TMA through two rings of swizzled slots filled by a producer
warpgroup, two consumer warpgroups a block run wgmma and split the columns of
both products, sharing a*gelu(g) through a swizzled shared-memory tile, and
the fp32 output tile stays in registers for the whole loop. At C=640 a
cluster of two blocks takes the same 64 rows, 320 output columns each; each
block gates half of every tile and writes it into both blocks' shared memory
(distributed shared memory, an mbarrier per tile with cluster-scope release
and acquire). No fp32 partial and no (N, 2*inner) intermediate reaches
device memory; the wrapper allocates the output and nothing else, and the
biases are read as stored (bf16 or fp32).

`ff_fits(m, c, inner)` says which shapes the kernel serves; `ff_geglu` is the
one switch: a bf16 call that fits goes to the kernel, any other to the
unfused route (`ff_geglu_unfused`: two `F.linear` and `a * gelu(g)` in the
compute dtype, the JAX package's `_ff_unfused`), counted in `LAUNCHES` and
`ROUTES`. Of the UNet's levels ds1 (C=320) and ds2 (C=640) fit. ds4 and ds8
(C=1280) fit no cluster: x alone (64 x 1280) would take 160 KB of each
block's shared memory; the JAX package's own `ff_fits` keeps those two
levels on XLA as well.

Weights are in torch Linear layout: w1 (2*inner, C), w2 (C, inner). Under
autograd the kernel's gradient is autograd of `ff_geglu_unfused`, recomputed
from the saved inputs in the compute dtype with fp32 accumulation
(`_vjp.py`), as `jax.vjp(_ff_unfused)` in the JAX package. `ff_geglu_plain`
(all fp32, one rounding) is the forward kernel's oracle.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from instancediffusion_tpu_torch.kernels import LAUNCHES, ROUTES, kernel_dtype
from instancediffusion_tpu_torch.kernels import _build
from instancediffusion_tpu_torch.kernels._vjp import plain_vjp

SMEM_CAP = 232448  # shared memory a block can use on an H100
CHUNK_BYTES = 64 * 128  # 64 rows x 64 bf16 columns (128-byte swizzle)
BLOCK_ROWS = 64  # rows per cluster
GATED = 32  # gated columns per warpgroup and turn
MAX_BLOCK_COLS = 320  # output columns a block's registers hold
W2_TILES = 4  # w2 tiles (a warpgroup's rows x 64 columns) a block keeps
AG_BUFFERS = 2  # the gated tile is double-buffered
MAX_W1_STAGES = 16
KERNEL_WIDTHS = (64, 128, 320, 640)  # instantiations in csrc/geglu_ff_c*.cu


def cluster_blocks(c: int) -> int:
    """Blocks of a cluster: they take the same 64 rows and c / blocks output
    columns each."""
    return -(-c // MAX_BLOCK_COLS)


def turn_cols(c: int) -> int:
    """Inner columns a cluster takes per turn: GATED for each of its
    warpgroups, two a block."""
    return 2 * cluster_blocks(c) * GATED


# erf(z) = z P(z^2) / Q(z^2) on [-4, 4], highest power first: the fp32 rational
# the kernel's gate evaluates (csrc/geglu_ff_sm90.cuh::gelu_erf), the one XLA
# uses for lax.erf
ERF_P = (-2.72614225801306e-10, 2.77068142495902e-08, -2.10102402082508e-06,
         -5.69250639462346e-05, -7.34990630326855e-04, -2.95459980854025e-03,
         -1.60960333262415e-02)
ERF_Q = (-1.45660718464996e-05, -2.13374055278905e-04, -1.68282697438203e-03,
         -7.37332916720468e-03, -1.42647390514189e-02)


def erf_rational(z):
    """The kernel's erf in fp32, step for step (Horner with fused
    multiply-adds on the card, here plain fp32)."""
    z = z.float().clamp(-4.0, 4.0)
    z2 = z * z
    num = torch.full_like(z, ERF_P[0])
    for coef in ERF_P[1:]:
        num = num * z2 + coef
    den = torch.full_like(z, ERF_Q[0])
    for coef in ERF_Q[1:]:
        den = den * z2 + coef
    return num * z / den


def ff_geglu_plain(x, w1, b1, w2, b2):
    """fp32 math, one rounding on the output."""
    h = F.linear(x.float(), w1.float(), b1.float())
    a, g = h.chunk(2, dim=-1)
    ag = a * F.gelu(g)
    return F.linear(ag, w2.float(), b2.float()).to(x.dtype)


def ff_geglu_unfused(x, w1, b1, w2, b2):
    """Both products and a * gelu(g) in x's dtype (fp32 accumulation inside
    each product, each result rounded to that dtype)."""
    dt = x.dtype
    h = F.linear(x, w1.to(dt), b1.to(dt))
    a, g = h.chunk(2, dim=-1)
    return F.linear(a * F.gelu(g), w2.to(dt), b2.to(dt))


def ff_fits(m: int, c: int, inner: int) -> bool:
    """Whether the fused kernel serves m rows of width c with this inner
    width: c one of the built widths and inner in whole turns. The fp32
    output tile of a block's 64 rows must fit the registers of two
    warpgroups beside the first product's tile, within the 168 a thread that
    a block with a producer warpgroup gets: 320 columns a block, so c = 640
    (the UNet's ds2) takes a cluster of two blocks. c = 1280 fits no
    cluster: x alone (64 x 1280) would take 160 KB of each block's shared
    memory."""
    return m > 0 and c in KERNEL_WIDTHS and inner > 0 and inner % turn_cols(c) == 0


class MatrixMap(NamedTuple):
    """2-D TMA tensor map of a row-major bf16 matrix: extent and box in
    (columns, rows), the row stride in bytes."""
    cols: int
    rows: int
    row_bytes: int
    box_cols: int
    box_rows: int

    def args(self, ptr: int) -> list:
        return [ptr, *self]


class FFPlan(NamedTuple):
    """How the kernel covers one (m, c) x inner call (mirrors `Layout` in
    csrc/geglu_ff_sm90.cuh). A cluster of `cluster` blocks owns 64 rows; per
    turn it takes `turn_cols(c)` inner columns, of which each of its 2 *
    cluster consumer warpgroups gates GATED and then multiplies the whole
    gated tile into its own c / (2 * cluster) output columns. A block's
    producers fill two rings: `w1_turn` names the w1 slots of one turn in the
    order block 0 loads them, ("w1", warpgroup, k) = the a rows [turn start +
    GATED * warpgroup, + GATED) and the same g rows of w1, columns [64 k, +
    64); `w2_turn` the w2 slots, ("w2", warpgroup, row, chunk) = rows [row, +
    c / (2 * cluster)) of w2, columns [turn start + 64 chunk, + 64). Block r
    of a cluster takes warpgroups 2 r and 2 r + 1 of both lists; within a
    block the two take alternate slots of each ring."""
    blocks: int
    cluster: int
    turns: int
    w1_stages: int
    w2_stages: int
    w1_turn: tuple
    w2_turn: tuple
    smem: int
    x: MatrixMap
    w1: MatrixMap
    w2: MatrixMap


@functools.lru_cache(maxsize=256)
def ff_plan(m: int, c: int, inner: int) -> FFPlan:
    """Tile plan of `fused_ff_geglu` (cached: a path asks for the same few
    shapes on every call). Raises on a shape `ff_fits` refuses."""
    if not ff_fits(m, c, inner):
        raise ValueError(f"ff_plan: ({m}, {c}) x inner {inner} does not fit the kernel "
                         f"(C in {KERNEL_WIDTHS}, inner in whole turns)")
    cl = cluster_blocks(c)
    cols = c // (2 * cl)  # output columns per warpgroup
    chunks = turn_cols(c) // 64  # 64-column chunks of the gated tile
    w1_turn = tuple(("w1", 2 * r + w, k) for r in range(cl) for k in range(c // 64)
                    for w in range(2))
    w2_turn = tuple(("w2", 2 * r + w, (2 * r + w) * cols, kc) for r in range(cl)
                    for kc in range(chunks) for w in range(2))
    slot1, slot2 = 2 * GATED * 128, cols * 128
    w2_stages = W2_TILES // chunks  # a slot holds a warpgroup's tiles of one turn
    resident = ((c // 64) * CHUNK_BYTES + AG_BUFFERS * chunks * CHUNK_BYTES
                + W2_TILES * slot2)
    w1_stages = min(MAX_W1_STAGES, (SMEM_CAP - 1024 - 256 - resident) // slot1) & ~1
    barriers = 2 * w1_stages + 2 * w2_stages + 1 + AG_BUFFERS
    smem = resident + w1_stages * slot1 + barriers * 8 + 1024
    return FFPlan(
        -(-m // BLOCK_ROWS) * cl, cl, inner // turn_cols(c), w1_stages, w2_stages, w1_turn,
        w2_turn, smem,
        MatrixMap(c, m, 2 * c, 64, BLOCK_ROWS),
        MatrixMap(c, 2 * inner, 2 * c, 64, GATED),
        MatrixMap(inner, c, 2 * inner, 64, cols),
    )


def ff_geglu(x, w1, b1, w2, b2):
    """x (..., C) -> (..., C), by the one switch between the two routes: the
    fused kernel for a bf16 call that `ff_fits`, the unfused route for any
    other. On the CPU the kernel route is its plain version."""
    c = x.shape[-1]
    if kernel_dtype(x.dtype) and ff_fits(x.numel() // c, c, w2.shape[-1]):
        return fused_ff_geglu(x, w1, b1, w2, b2)
    ROUTES["ff_geglu_unfused"] += 1
    return ff_geglu_unfused(x, w1, b1, w2, b2)


def fused_ff_geglu(x, w1, b1, w2, b2):
    """x (..., C) -> (..., C) through the fused kernel (its plain version
    on the CPU)."""
    if x.device.type == "cpu":
        return ff_geglu_plain(x, w1, b1, w2, b2)
    return plain_vjp(_ff_geglu_kernel, ff_geglu_unfused, x, w1, b1, w2, b2)


def _ff_geglu_kernel(x, w1, b1, w2, b2):
    _build.require_cuda("fused_ff_geglu", x, w1, w2)
    c = x.shape[-1]
    two_inner = w1.shape[0]
    inner = two_inner // 2
    if w1.shape != (two_inner, c) or w2.shape != (c, inner) or two_inner % 2:
        raise ValueError(
            f"fused_ff_geglu: w1 {tuple(w1.shape)} / w2 {tuple(w2.shape)} do "
            f"not fit C={c}"
        )
    if b1.shape != (two_inner,) or b2.shape != (c,):
        raise ValueError(f"fused_ff_geglu: b1 {tuple(b1.shape)} / b2 {tuple(b2.shape)} do "
                         f"not fit inner={inner}, C={c}")
    m = x.numel() // c
    plan = ff_plan(m, c, inner)
    x = x.contiguous()
    w1, w2 = w1.contiguous(), w2.contiguous()
    # biases as stored when both are bf16 or both fp32 (every module's are)
    if b1.dtype != b2.dtype or b1.dtype not in (torch.bfloat16, torch.float32):
        b1, b2 = b1.float(), b2.float()
    b1, b2 = b1.to(x.device).contiguous(), b2.to(x.device).contiguous()
    out = torch.empty_like(x)
    maps = (plan.x.args(x.data_ptr()) + plan.w1.args(w1.data_ptr())
            + plan.w2.args(w2.data_ptr()))
    maps = (ctypes.c_longlong * len(maps))(*maps)
    lib = _build.lib()
    with torch.cuda.device(x.device):
        err = lib.idt_geglu_ff(
            maps, b1.data_ptr(), b2.data_ptr(), out.data_ptr(), m, c, inner,
            int(b1.dtype == torch.float32), _build.stream_of(x),
        )
    _build.check(err, "fused_ff_geglu")
    LAUNCHES["fused_ff_geglu"] += 1
    return out
