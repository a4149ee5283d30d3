"""Projection GEMMs that split or merge attention heads (K8, K8').

CUDA source: `csrc/head_layout.cu`. It replaces
`instancediffusion_tpu/kernels/head_layout.py::proj_split` (`_proj_split_kernel`)
and `::merge_proj` (`_merge_proj_kernel`):

  proj_split(x, [w...]) = [split_heads(x @ w^T) for w]   -> (B, H, Mpad, c)
  merge_proj(o, w, b)   = merge_heads(o) @ w^T + b        -> (B, N, C_out)

The head relayout is an address computation inside the GEMM: column j of
the projection is head j // c, channel j % c, and with c a multiple of 8
each pair of columns a thread stores lies in one head. `proj_split` writes
the contiguous (B, H, Mpad, c) arrays the flash kernel reads, with rows >= M
zeroed; `merge_proj` reads any (B, H, N, c) view whose channels are
contiguous (the flash kernel's output is a head view of a (B, N, H, c)
buffer) and adds the bias in fp32 before its one rounding. Both accumulate
in fp32. The TPU's relayout switches (`IDTPU_HEADS_SPLIT`,
`IDTPU_HEADS_MERGE`) chose between Mosaic shuffles of the same function
and have no counterpart here.

What bounds them on an H100: device memory (K = 320 at the UNet's ds1, so
a call does ~160 FLOPs per byte it must move, below the card's ~295). The
weights stay in shared memory and the activations stream once: a cluster of
blocks shares each 64-row activation tile (TMA multicast into every block),
each block keeping a 160-column slice of one weight (q and K8': 2 blocks, k
and v: 4), three activation tiles in flight; two consumer warpgroups a block
take alternate tiles, so one multiplies with wgmma while the other stores
16-byte vectors straight from its registers; the grid is persistent.
`split_plan` / `merge_plan` give the tiling and the two TMA maps of a call; `csrc/head_layout.cu` derives the same plan, and the
wrapper refuses to launch where the two differ (checked once per shape,
through `idt_head_plan`).

Weights are in torch Linear layout: (out, in). On a CPU tensor the wrappers
use the plain versions; on a CUDA tensor they launch the kernel or raise.
Inference only: the outputs carry no gradient.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from instancediffusion_tpu_torch.kernels import LAUNCHES
from instancediffusion_tpu_torch.kernels import _build

SEQ_TILE = 64  # proj_split pads the sequence to a multiple of this by default
ROWS = 64  # rows per activation tile: one consumer warpgroup's
CHUNK_COLS = 64  # K columns per box (128 bytes: one swizzle atom)
BOX_BYTES = ROWS * 128
THREADS = 384  # two consumer warpgroups and a producer warpgroup
SMEM_CAP = 232448  # shared memory a block can use on an H100
MAX_CHUNKS = 8  # boxes of K a block keeps (K <= 512, or 8 heads)
MAX_CLUSTER = 8  # the portable cluster size
MAX_SLOTS = 3  # activation tiles in flight
BARRIER_BYTES = 128  # w; full per warpgroup and slot; empty per slot
COL_TILES = (160, 64)  # a block's weight slice: the first width that divides and fits
REG_LIMIT = 168  # registers a thread of a block above 256 threads gets
SMS = 132  # the H100 SXM's SMs: the default bound on resident clusters


def _seq_pad(m: int, seq_pad: int | None) -> int:
    mpad = -(-m // SEQ_TILE) * SEQ_TILE if seq_pad is None else int(seq_pad)
    if mpad < m:
        raise ValueError(f"seq_pad={seq_pad} is below the sequence length {m}")
    return mpad


def slots_that_fit(col_tile: int, chunks: int) -> int:
    """Activation slots (64 rows x K) that fit beside a block's weight slice
    (col_tile rows x K), its barriers and 1 KB to align the base, at most
    MAX_SLOTS."""
    fixed = chunks * col_tile * 128 + BARRIER_BYTES + 1024
    return min(MAX_SLOTS, (SMEM_CAP - fixed) // (chunks * BOX_BYTES))


class HeadMap(NamedTuple):
    """A bf16 TMA tensor map, 128-byte swizzled: dims and box innermost
    first, the byte strides of dims 1 and up."""
    dims: tuple
    strides: tuple
    box: tuple


class HeadPlan(NamedTuple):
    """How one launch tiles its call (mirrors `Plan` in csrc/head_layout.cu).
    Block r of a cluster of `cluster` blocks keeps a `col_tile`-wide slice of
    one weight (`chunks` boxes of 64 columns of K, or one head each where
    `per_head`) in shared memory; the cluster's activation tiles of `rows`
    rows (`tiles` = B x ceil(out_rows / rows)) arrive through `slots` slots
    by TMA multicast into all its blocks, whose two consumer warpgroups take
    alternate tiles. The
    grid is persistent: min(tiles, max_clusters) clusters, max_clusters
    being what the card holds at once. acc_regs: fp32 accumulator registers
    a consumer thread holds, against reg_limit."""
    rows: int
    col_tile: int
    chunks: int
    per_head: bool
    cluster: int
    slots: int
    smem: int
    tiles: int
    grid: int
    threads: int
    max_clusters: int
    a: HeadMap
    w: HeadMap
    acc_regs: int
    reg_limit: int

    def values(self) -> tuple:
        """The plan as `idt_head_plan` reports it: 31 int64 values, maps
        padded with zeros to rank 4 (activations) and 3 (weights)."""
        def pad(t, n):
            return tuple(t) + (0,) * (n - len(t))
        return (self.rows, self.col_tile, self.chunks, int(self.per_head), self.cluster,
                self.slots, self.smem, self.tiles, self.grid, self.max_clusters,
                len(self.a.dims), *pad(self.a.dims, 4), *pad(self.a.strides, 3),
                *pad(self.a.box, 4), len(self.w.dims), *pad(self.w.dims, 3),
                *pad(self.w.strides, 2), *pad(self.w.box, 3))


def _layout(b, out_rows, chunks, per_head, n_cols, n_out, max_clusters, what):
    if not 1 <= chunks <= MAX_CHUNKS:
        raise ValueError(f"{what}: {chunks} chunks of K; the kernel keeps at most {MAX_CHUNKS} "
                         f"(K <= {MAX_CHUNKS * CHUNK_COLS}, or {MAX_CHUNKS} heads)")
    if b < 1 or out_rows < 1 or n_out not in (1, 2):
        raise ValueError(f"{what}: empty call or {n_out} weights")
    for col_tile in COL_TILES:
        cluster = n_out * (n_cols // col_tile)
        if (n_cols % col_tile == 0 and cluster <= MAX_CLUSTER
                and slots_that_fit(col_tile, chunks) >= 2):
            break
    else:
        raise ValueError(f"{what}: output widths must be multiples of {COL_TILES[-1]} that fit "
                         f"at most {MAX_CLUSTER} slices ({n_out} x {n_cols})")
    tiles = b * -(-out_rows // ROWS)
    if max_clusters is None:
        max_clusters = SMS // cluster
    slots = slots_that_fit(col_tile, chunks)
    smem = chunks * col_tile * 128 + slots * chunks * BOX_BYTES + BARRIER_BYTES + 1024
    return dict(rows=ROWS, col_tile=col_tile, chunks=chunks, per_head=per_head,
                cluster=cluster, slots=slots, smem=smem, tiles=tiles,
                grid=min(tiles, max_clusters) * cluster, threads=THREADS,
                max_clusters=max_clusters, acc_regs=col_tile // 2, reg_limit=REG_LIMIT)


def _plain_maps(k, rows, b, sr, sb, n_cols, col_tile):
    """The activations as the (K, rows, B) matrix they are, w as (n_cols, K)."""
    return (HeadMap((k, rows, b), (2 * sr, 2 * sb), (CHUNK_COLS, ROWS, 1)),
            HeadMap((k, n_cols), (2 * k,), (CHUNK_COLS, col_tile)))


def _check_strides(what, strides):
    if any(s % 8 or s <= 0 for s in strides):
        raise ValueError(f"{what}: strides {tuple(strides)} must be positive multiples of 8 "
                         "elements (16-byte aligned rows)")


@functools.lru_cache(maxsize=256)
def split_plan(b: int, m: int, mpad: int, c_in: int, heads: int, c: int, n_out: int,
               x_strides: tuple, max_clusters: int | None = None) -> HeadPlan:
    """The plan of `proj_split` on x (b, m, c_in) with element strides
    x_strides = (batch, row), into (b, heads, mpad, c) per weight, with
    `max_clusters` clusters resident at once (default: the SMs of an H100
    SXM over the cluster size). The activation map ends at
    row m, so rows m..mpad come out zero."""
    if c % 8 or c_in % 8:
        raise ValueError(f"proj_split: head dim {c} and C_in={c_in} must be multiples of 8")
    if mpad < m or m < 1:
        raise ValueError(f"proj_split: seq_pad {mpad} below the sequence length {m}")
    if heads * mpad * c >= 1 << 31:
        raise ValueError(f"proj_split: a sample's output ({heads} x {mpad} x {c}) needs "
                         "64-bit offsets")
    _check_strides("proj_split", x_strides)
    lay = _layout(b, mpad, -(-c_in // CHUNK_COLS), False, heads * c, n_out, max_clusters,
                  "proj_split")
    a, w = _plain_maps(c_in, m, b, x_strides[1], x_strides[0], heads * c, lay["col_tile"])
    return HeadPlan(a=a, w=w, **lay)


@functools.lru_cache(maxsize=256)
def merge_plan(b: int, n: int, heads: int, c: int, c_out: int, o_strides: tuple,
               max_clusters: int | None = None) -> HeadPlan:
    """The plan of `merge_proj` on o (b, heads, n, c) with element strides
    o_strides = (batch, head, row). Heads side by side (head stride c, the
    flash kernel's output) are the plain (b, n, heads*c) matrix; any other
    view is read per head, a box of the (c, n, heads, b) map zero-filled
    from c to 64 columns, against the same box of a (c, heads, c_out) map of
    w."""
    if c % 8:
        raise ValueError(f"merge_proj: head dim {c} is not a multiple of 8")
    sb, sh, sr = o_strides
    _check_strides("merge_proj", o_strides)
    k = heads * c
    if sh == c or heads == 1:
        lay = _layout(b, n, -(-k // CHUNK_COLS), False, c_out, 1, max_clusters, "merge_proj")
        a, w = _plain_maps(k, n, b, sr, sb, c_out, lay["col_tile"])
        return HeadPlan(a=a, w=w, **lay)
    if c > CHUNK_COLS:
        raise ValueError(f"merge_proj: a head view with head dim {c} > {CHUNK_COLS} whose "
                         "heads are not side by side")
    lay = _layout(b, n, heads, True, c_out, 1, max_clusters, "merge_proj")
    a = HeadMap((c, n, heads, b), (2 * sr, 2 * sh, 2 * sb), (CHUNK_COLS, ROWS, 1, 1))
    w = HeadMap((c, heads, c_out), (2 * c, 2 * k), (CHUNK_COLS, 1, lay["col_tile"]))
    return HeadPlan(a=a, w=w, **lay)


@functools.lru_cache(maxsize=64)
def _max_clusters(index: int, col_tile: int, cluster: int, smem: int) -> int:
    """Clusters of this shape card `index` holds at once (asked once)."""
    with torch.cuda.device(index):
        n = _build.lib().idt_head_max_clusters(col_tile, cluster, smem)
    if n < 1:
        raise RuntimeError(f"head_layout: no cluster of {cluster} blocks with {smem} shared "
                           "bytes fits the card")
    return n


def _card_plan(plan_fn, index, *args) -> HeadPlan:
    """The plan at the card's own count of co-resident clusters."""
    first = plan_fn(*args, 1)
    return plan_fn(*args, _max_clusters(index, first.col_tile, first.cluster, first.smem))


@functools.lru_cache(maxsize=256)
def _confirm(kind: int, sizes: tuple, strides: tuple, plan: HeadPlan) -> None:
    """Raise unless csrc/head_layout.cu derives the same plan for this call
    (asked once per call shape)."""
    vals = (ctypes.c_longlong * 31)()
    err = _build.lib().idt_head_plan(kind, (ctypes.c_longlong * len(sizes))(*sizes),
                                     (ctypes.c_longlong * len(strides))(*strides),
                                     plan.max_clusters, vals)
    name = ("proj_split", "merge_proj")[kind]
    if err != 0 or tuple(vals) != plan.values():
        raise RuntimeError(f"{name}: the kernel's plan {tuple(vals) if err == 0 else 'refused'}"
                           f" differs from the wrapper's {plan.values()}")


def _check_split(x, weights, num_heads):
    if len(weights) not in (1, 2):
        raise ValueError(f"proj_split takes 1 or 2 weights, got {len(weights)}")
    inner, c_in = weights[0].shape
    if x.dim() != 3 or x.shape[2] != c_in or any(w.shape != (inner, c_in) for w in weights):
        raise ValueError(f"proj_split: x {tuple(x.shape)} and weights "
                         f"{[tuple(w.shape) for w in weights]} do not fit")
    if inner % num_heads:
        raise ValueError(f"proj_split: width {inner} is not {num_heads} heads")
    return inner, inner // num_heads


def proj_split_plain(x, weights, num_heads: int, seq_pad: int | None = None):
    """[split_heads(x @ w^T) for w in weights] in fp32, rounded once to x's
    dtype: (B, H, Mpad, c) contiguous, rows >= M zero."""
    _, c = _check_split(x, weights, num_heads)
    b, m, _ = x.shape
    mpad = _seq_pad(m, seq_pad)
    outs = []
    for w in weights:
        y = F.pad(F.linear(x.float(), w.float()), (0, 0, 0, mpad - m)).to(x.dtype)
        outs.append(y.reshape(b, mpad, num_heads, c).transpose(1, 2).contiguous())
    return outs


def merge_proj_plain(o, w, bias=None):
    """merge_heads(o) @ w^T + bias in fp32, rounded once to o's dtype:
    (B, N, C_out)."""
    b, h, n, c = o.shape
    y = F.linear(o.transpose(1, 2).reshape(b, n, h * c).float(), w.float(),
                 None if bias is None else bias.float())
    return y.to(o.dtype)


def proj_split(x, weights, num_heads: int, seq_pad: int | None = None):
    """x (B, M, C_in) (rows may be strided: a row slice of a longer
    sequence is read in place), weights: 1 or 2 bias-free (H*c, C_in)
    projections. Returns a list of (B, H, Mpad, c) tensors, Mpad = seq_pad
    or M rounded up to 64, rows >= M zero."""
    if x.device.type == "cpu":
        return proj_split_plain(x, weights, num_heads, seq_pad)
    _, c = _check_split(x, weights, num_heads)
    b, m, c_in = x.shape
    mpad = _seq_pad(m, seq_pad)
    _build.require_cuda("proj_split", x, *weights)
    if x.stride(2) != 1 or x.data_ptr() % 16:
        raise ValueError("proj_split: x needs contiguous channels and 16-byte aligned rows")
    strides = (x.stride(0), x.stride(1))
    sizes = (b, m, mpad, c_in, num_heads, c, len(weights))
    _confirm(0, sizes, strides, _card_plan(split_plan, x.device.index, *sizes, strides))
    weights = [w.contiguous() for w in weights]
    outs = [torch.empty((b, num_heads, mpad, c), dtype=x.dtype, device=x.device)
            for _ in weights]
    w1, out1 = (weights[1].data_ptr(), outs[1].data_ptr()) if len(weights) == 2 else (0, 0)
    lib = _build.lib()
    with torch.cuda.device(x.device):
        err = lib.idt_proj_split(x.data_ptr(), *strides, weights[0].data_ptr(),
                                 w1, outs[0].data_ptr(), out1, b, m, mpad, c_in, num_heads, c,
                                 _build.stream_of(x))
    _build.check(err, "proj_split")
    LAUNCHES["proj_split"] += 1
    return outs


def merge_proj(o, w, bias=None):
    """o (B, H, N, c), any view with contiguous channels; w (C_out, H*c);
    bias (C_out,) or None. Returns (B, N, C_out); a caller that padded the
    sequence slices [:, :n]."""
    b, h, n, c = o.shape
    c_out = w.shape[0]
    if w.shape != (c_out, h * c) or (bias is not None and bias.shape != (c_out,)):
        raise ValueError(f"merge_proj: o {tuple(o.shape)}, w {tuple(w.shape)} do not fit")
    if o.device.type == "cpu":
        return merge_proj_plain(o, w, bias)
    _build.require_cuda("merge_proj", o, w)
    if o.stride(3) != 1 or o.data_ptr() % 16:
        raise ValueError("merge_proj: o needs contiguous channels and 16-byte aligned rows")
    strides = (o.stride(0), o.stride(1), o.stride(2))
    sizes = (b, n, h, c, c_out)
    _confirm(1, sizes, strides, _card_plan(merge_plan, o.device.index, *sizes, strides))
    w = w.contiguous()
    if bias is not None:
        bias = bias.to(device=o.device, dtype=torch.float32).contiguous()
        if bias.data_ptr() % 8:  # read as float2
            bias = bias.clone()
    out = torch.empty((b, n, c_out), dtype=o.dtype, device=o.device)
    lib = _build.lib()
    with torch.cuda.device(o.device):
        err = lib.idt_merge_proj(o.data_ptr(), *strides, w.data_ptr(),
                                 0 if bias is None else bias.data_ptr(),
                                 out.data_ptr(), b, n, h, c, c_out, _build.stream_of(o))
    _build.check(err, "merge_proj")
    LAUNCHES["merge_proj"] += 1
    return out
