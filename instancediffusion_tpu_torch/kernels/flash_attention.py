"""Forward flash attention on the (B,H,N,c) and (B,N,H*c) layouts.

CUDA source: `csrc/flash_fwd_sm90.cuh` (the kernel; one instantiation set
per `csrc/flash_fwd_*.cu`) and `csrc/flash_attention.cu` (tensor maps, C
entry point), one kernel for both entry points. It replaces
`instancediffusion_tpu/kernels/flash_attention.py`: `flash_attention`
(`_flash_kernel`, and `_flash_kernel_labeled` with `labels=`) and
`flash_attention_packed` (`_flash_kernel_packed`,
`_flash_kernel_packed_labeled`), forward. The kernel reads q, k and v in
place through 4-D TMA tensor maps (`tma_plan` derives them from the views'
strides), so the split-heads entry point reads the head views of the
projection output without a head-split copy and the packed one slices heads
in the map. At c=40 it is bound by the exponentials (16 exp2 per clock per
SM against ~4096 bf16 tensor-core FLOPs); the kernel's header says how its
design (TMA ring, wgmma, two ping-ponging consumer warpgroups) hides the
products under the softmax. c=40 is padded to 48 in shared memory only, by
TMA's zero fill.

`kv_len`: the true kv length when the caller pre-padded k/v. The k/v maps
end at kv_len, so callers may also pass unpadded kv.

`labels=(bits, open)`: instance-masked attention. Two (B, L) int32 arrays
indexed by sequence position over the k tokens (L >= kv_len; positions past
kv_len are ignored); q covers the first N positions. Labels are per batch
row and shared by every head. The kernel keeps score (i, j) iff
open_i | open_j | (bits_i & bits_j) != 0 | i == j (`instance_labels` gives
the encoding); the plain version is `sdpa_fp32` under `labels_to_dense`.

Training (`flash_attention_trainable`, `_labeled`): autograd Functions over
the same (B,H,N,c) head views, unscaled q, no kv_len padding. Their forward
is the same kernel's WITH_LSE instantiation (it replaces `_fwd_with_stats`)
and also writes the fp32 (B,H,N) log-sum-exp, in base 2 of the scaled
scores (`flash_attention_fwd_lse_plain` says how). Their backward launches
the dq kernel and the dk/dv kernel of `csrc/flash_bwd_sm90.cuh` (host side
`csrc/flash_attention_bwd.cu`; they replace `_flash_bwd`): TMA + wgmma, one
producer thread, tiles planned by `bwd_plan`. The dq kernel also computes
delta = rowsum(dO * O) in fp32 for its rows and writes it for the dk/dv
kernel; both write into (B,N,H,c) buffers; the labels get no gradient. The
plain versions are `flash_attention_fwd_lse_plain` and
`flash_attention_bwd_plain` (`_flash_bwd`'s formulas in fp32); on the CPU
the trainable functions are autograd of `sdpa_fp32`.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from instancediffusion_tpu_torch.kernels import LAUNCHES
from instancediffusion_tpu_torch.kernels import _build
from instancediffusion_tpu_torch.ops.attention import labels_to_dense, sdpa_fp32

_MAX_HEAD_DIM = 128
GROUNDING_BIT = 1 << 30
LOG2E = 1.4426950408889634


def _true_kv(m: int, kv_len: int | None) -> int:
    true_m = m if kv_len is None else int(kv_len)
    if not 1 <= true_m <= m:
        raise ValueError(f"kv_len={kv_len} outside [1, {m}]")
    return true_m


def _check_labels(name, labels, b, n, kv_len):
    """(bits, open) as two int32 (B, L) tensors with L >= max(N, kv_len)."""
    bits, open_ = labels
    for t in (bits, open_):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != b:
            raise ValueError(f"{name}: labels must be int32 (B={b}, L), got "
                             f"{t.dtype} {tuple(t.shape)}")
    if bits.shape != open_.shape or bits.shape[1] < max(n, kv_len):
        raise ValueError(f"{name}: labels {tuple(bits.shape)} do not cover "
                         f"{max(n, kv_len)} positions")


def _plain_mask(labels, n, kv_len):
    """(B,1,N,kv_len) keep-mask of the labels, for the plain version."""
    return labels_to_dense(*labels)[:, :, :n, :kv_len]


def _check_operands(name, tensors, strides, b, h, c):
    if c % 8 or c > _MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {c} must be a multiple of 8 <= "
                         f"{_MAX_HEAD_DIM}")
    for t in tensors:
        if t.stride(-1) != 1 or t.data_ptr() % 16:
            raise ValueError(f"{name}: head dim must be contiguous and 16-byte "
                             "aligned")
    if any(s % 8 for s in strides):
        raise ValueError(f"{name}: strides {strides} are not 16-byte multiples")
    if b * h > 65535:
        raise ValueError(f"{name}: B*H={b * h} exceeds the grid limit")


def _label_args(name, labels, q):
    """(bits pointer, open pointer, label stride, kernel name, kept tensors)
    for the C launchers; null pointers for unlabeled attention. The rows are
    padded to a multiple of 4 entries (16 bytes), as the forward kernel's
    label tensor map needs."""
    if labels is None:
        return 0, 0, 0, name, None
    bits, open_ = (t.contiguous() for t in labels)
    if bits.device != q.device or open_.device != q.device:
        raise ValueError(f"{name}: labels on {bits.device}, q on {q.device}")
    pad = -bits.shape[1] % 4
    if pad:
        bits, open_ = F.pad(bits, (0, pad)), F.pad(open_, (0, pad))
    return bits.data_ptr(), open_.data_ptr(), bits.shape[1], name + "_labeled", (bits, open_)


TMA_BOX_ROWS = 128  # rows per TMA box: the kernel's query block and key tile
TMA_BOX_COLS = 64  # head-dim columns per box: 128 bytes, one 128-byte swizzle atom


class TmaPlan(NamedTuple):
    """One operand's 4-D TMA tensor map: dims and box innermost first (head
    dim, then the batch, head and row axes in order of stride), the byte
    strides of dims 1-3, and the coordinate slot (1-3) of the head, row and
    batch axes."""
    dims: tuple
    strides: tuple
    box: tuple
    order: tuple

    def args(self, ptr: int) -> list:
        """The 15 int64 values `idt_flash_attention` takes per operand."""
        return [ptr, *self.dims, *self.strides, *self.box, *self.order]


def tma_plan(sizes, strides, c, rows, box_rows=TMA_BOX_ROWS, elem_bytes=2):
    """TmaPlan of a (B, H, rows, c) view with head dim contiguous. sizes:
    (B, H); strides: (batch, head, row) element strides. The box is 64
    columns (128 bytes, the swizzle's width) by box_rows rows; a column past
    c or a row past `rows` reads as zero. An axis of extent 1 goes last, with a stride
    that continues the others. Raises if a stride is not a multiple of 16
    bytes or too large for a tensor map."""
    if c % 8:
        raise ValueError(f"tma_plan: head dim {c} is not a multiple of 8")
    b, h = sizes
    axes = [("batch", b, strides[0]), ("head", h, strides[1]), ("row", rows, strides[2])]
    live = sorted((a for a in axes if a[1] > 1), key=lambda a: a[2])
    for name, _, st in live:
        nbytes = st * elem_bytes
        if nbytes % 16 or not 0 < nbytes < 1 << 40:
            raise ValueError(f"tma_plan: {name} stride {st} elements ({nbytes} bytes) is not "
                             "a positive multiple of 16 bytes below 2**40")
    end = live[-1][1] * live[-1][2] if live else c
    dead = [(name, n, end) for name, n, _ in axes if n <= 1]
    order = live + dead
    dims = (c, *(n for _, n, _ in order))
    byte_strides = tuple(-(-st * elem_bytes // 16) * 16 for _, _, st in order)
    box = (TMA_BOX_COLS, *(box_rows if name == "row" else 1 for name, _, _ in order))
    slot = {name: i + 1 for i, (name, _, _) in enumerate(order)}
    return TmaPlan(dims, byte_strides, box, (slot["head"], slot["row"], slot["batch"]))


BWD_SMALL = 256  # a ring stage's slot for one tile's lse, delta, label bits or open
BWD_MAX_SMEM = 232448  # shared bytes a block may use on the H100


class BwdPlan(NamedTuple):
    """How one backward kernel launch tiles its shape (`csrc/flash_bwd_sm90.cuh`
    holds the same layout and refuses a launch whose plan differs). kind:
    "dq" (a block owns q rows, K and V stream) or "dkv" (a block owns keys, Q
    and dO stream). block_rows: rows a block owns (64 per consumer
    warpgroup); tile_rows: rows of each streamed tile; stages: ring stages;
    smem: shared bytes; grid: (blocks over the owned rows, B*H); threads: a
    producer warpgroup and the consumer warpgroups; tiles: streamed tiles per
    block; acc_regs: fp32 accumulator registers a consumer thread holds at
    once (score products and outputs), against reg_limit, what ptxas gives a
    thread of a block of `threads`."""
    kind: str
    block_rows: int
    tile_rows: int
    stages: int
    smem: int
    grid: tuple
    threads: int
    tiles: int
    acc_regs: int
    reg_limit: int


def bwd_plan(kind, b, h, n, m, c, labeled=False) -> BwdPlan:
    """The plan of the dq (`kind="dq"`) or dk/dv (`"dkv"`) kernel for q
    (B,H,N,c) against k/v (B,H,M,c). Streamed tiles: dk/dv 64 q rows at c <=
    48 and 32 above (S^T, dP^T, dK and dV then fit the registers), dq 64 keys
    up to c = 96 and 32 above; a dk/dv block owns 128 keys (two consumer
    warpgroups) up to c = 96 and 64 above. Raises on what the kernels do not
    take."""
    if kind not in ("dq", "dkv"):
        raise ValueError(f"bwd_plan: kind {kind!r} is not 'dq' or 'dkv'")
    if c % 8 or not 8 <= c <= _MAX_HEAD_DIM:
        raise ValueError(f"bwd_plan: head dim {c} must be a multiple of 8 <= {_MAX_HEAD_DIM}")
    if b * h > 65535:
        raise ValueError(f"bwd_plan: B*H={b * h} exceeds the grid limit")
    if n < 1 or m < 1:
        raise ValueError(f"bwd_plan: empty attention ({n} x {m})")
    atoms = -(-c // 64)
    if kind == "dkv":
        wgs = 2 if c <= 96 else 1
        rows = 64 if c <= 48 else 32
        res, smalls = 2, 4 if labeled else 2  # K, V; lse, delta (+ q bits, open)
        own, stream = m, n
        acc = rows + c  # S^T, dP^T (rows / 2 each), dK, dV (c / 2 each)
    else:
        wgs = 2
        rows = 64 if c <= 96 else 32
        res, smalls = 3, 2 if labeled else 0  # Q, dO, O (+ key bits, open)
        own, stream = n, m
        acc = rows + c // 2  # S, dP, dQ
    block = 64 * wgs
    tile = atoms * rows * 128
    res_bytes = res * atoms * block * 128
    stage = -(-(2 * tile + smalls * BWD_SMALL) // 1024) * 1024
    stages = min(4, (200 * 1024 - res_bytes) // stage)
    smem = res_bytes + stages * stage + (2 * stages + 1) * 8 + 1024
    threads = 128 * (wgs + 1)
    return BwdPlan(kind, block, rows, stages, smem, (-(-own // block), b * h), threads,
                   -(-stream // rows), acc, 168 if threads > 256 else 255)


def encode_us() -> float:
    """Host microseconds the last forward launch spent encoding its tensor
    maps."""
    return _build.lib().idt_flash_encode_us()


def _head_strides(*tensors):
    strides = []
    for t in tensors:
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    return strides


def _launch(name, q, k, v, out, b, h, n, kv_len, c, strides, pre_scaled,
            labels=None, lse=None):
    """strides: (batch, head, row) element strides of q, k, v, out. lse:
    fp32 (B,H,N) buffer for the log-sum-exp, or None."""
    _build.require_cuda(name, q, k, v)
    _check_operands(name, (q, k, v, out), strides, b, h, c)
    scale = 1.0 if pre_scaled else 1.0 / math.sqrt(c)
    maps = []
    for i, (t, rows) in enumerate(((q, n), (k, kv_len), (v, kv_len))):
        maps += tma_plan((b, h), strides[3 * i:3 * i + 3], c, rows).args(t.data_ptr())
    maps = (ctypes.c_longlong * len(maps))(*maps)
    out_strides = (ctypes.c_longlong * 3)(*strides[9:12])
    bits_ptr, open_ptr, label_stride, name, _keep = _label_args(name, labels, q)
    lib = _build.lib()
    with torch.cuda.device(q.device):
        err = lib.idt_flash_attention(
            maps, out.data_ptr(), 0 if lse is None else lse.data_ptr(), bits_ptr, open_ptr,
            label_stride, b, h, n, kv_len, c, out_strides, float(scale), _build.stream_of(q),
        )
    _build.check(err, name)
    LAUNCHES[name] += 1


def _check_shapes(name, q, k, v, same):
    """k and v alike; q agrees with them on the axes in `same`."""
    if k.shape != v.shape or any(q.shape[i] != k.shape[i] for i in same):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")


def flash_attention(q, k, v, labels=None, pre_scaled=False, kv_len=None):
    """q (B,H,N,c), k/v (B,H,M,c) -> (B,H,N,c). The inputs may be strided
    head views of (B,N,H*c) projections; the output is a (B,H,N,c) view of
    a (B,N,H,c) buffer, so merging heads afterwards is free."""
    _check_shapes("flash_attention", q, k, v, (0, 1, 3))
    b, h, n, c = q.shape
    true_m = _true_kv(k.shape[2], kv_len)
    if labels is not None:
        _check_labels("flash_attention", labels, b, n, true_m)
    if q.device.type == "cpu":
        mask = None if labels is None else _plain_mask(labels, n, true_m)
        return sdpa_fp32(q, k[:, :, :true_m], v[:, :, :true_m], mask=mask,
                        pre_scaled=pre_scaled)
    out = torch.empty((b, n, h, c), dtype=q.dtype, device=q.device)
    out_v = out.permute(0, 2, 1, 3)
    _launch("flash_attention", q, k, v, out_v, b, h, n, true_m, c,
            _head_strides(q, k, v, out_v), pre_scaled, labels)
    return out_v


def flash_attention_packed(q, k, v, num_heads=8, labels=None,
                           pre_scaled=False, kv_len=None):
    """q (B,N,H*c), k/v (B,M,H*c) -> (B,N,H*c), heads sliced in-kernel."""
    _check_shapes("flash_attention_packed", q, k, v, (0, 2))
    b, n, hc = q.shape
    if hc % num_heads:
        raise ValueError(f"flash_attention_packed: width {hc} is not "
                         f"{num_heads} heads")
    c = hc // num_heads
    true_m = _true_kv(k.shape[1], kv_len)
    if labels is not None:
        _check_labels("flash_attention_packed", labels, b, n, true_m)
    if q.device.type == "cpu":
        split = lambda t: t.reshape(b, t.shape[1], num_heads, c).transpose(1, 2)
        mask = None if labels is None else _plain_mask(labels, n, true_m)
        out = sdpa_fp32(split(q), split(k[:, :true_m]), split(v[:, :true_m]),
                       mask=mask, pre_scaled=pre_scaled)
        return out.transpose(1, 2).reshape(b, n, hc)
    out = torch.empty((b, n, hc), dtype=q.dtype, device=q.device)
    strides = []
    for t in (q, k, v, out):
        strides += [t.stride(0), c, t.stride(1)]
    _launch("flash_attention_packed", q, k, v, out, b, num_heads, n, true_m, c,
            strides, pre_scaled, labels)
    return out


# ---------------------------------------------------------------------------
# training: forward with log-sum-exp, backward kernels, autograd Functions
# ---------------------------------------------------------------------------


def _scores_log2(q, k, labels):
    """fp32 (B,H,N,M) scores in the kernels' base-2 domain, s * scale *
    log2(e), with masked pairs at -inf; and the keep-mask (or None)."""
    c = q.shape[-1]
    s = torch.einsum("bhnc,bhmc->bhnm", q.float(), k.float()) * (c ** -0.5 * LOG2E)
    if labels is None:
        return s, None
    keep = _plain_mask(labels, q.shape[2], k.shape[2])
    return s.masked_fill(~keep, -math.inf), keep


def flash_attention_fwd_lse_plain(q, k, v, labels=None):
    """(out, lse) of the training forward in fp32: out (B,H,N,c) rounded once
    to q's dtype, lse (B,H,N) fp32 in base 2 of the scaled scores, lse_i =
    log2 sum_j exp2(s_ij * scale * log2(e)) = (natural log-sum-exp) / ln 2;
    -inf for a row with no kept key (whose output is 0)."""
    s, _ = _scores_log2(q, k, labels)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp2(s - torch.where(m == -math.inf, 0.0, m))
    l = e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhnm,bhmc->bhnc", e / l.clamp_min(1e-30), v.float())
    lse = torch.where(m == -math.inf, -math.inf, m + torch.log2(l.clamp_min(1e-30)))
    return out.to(q.dtype), lse[..., 0]


def flash_attention_bwd_plain(q, k, v, out, lse, dout, labels=None, kv_len=None):
    """(dq, dk, dv) from the forward's residuals, `_flash_bwd`'s formulas in
    fp32, each rounded once to its input's dtype. lse in base 2 as
    `flash_attention_fwd_lse_plain` gives it; keys at or above kv_len are
    masked and get zero gradients."""
    m = k.shape[2]
    kv = m if kv_len is None else int(kv_len)
    c = q.shape[-1]
    scale = c ** -0.5
    s, keep = _scores_log2(q, k[:, :, :kv], labels)
    p = torch.exp2(s - torch.where(lse == -math.inf, 0.0, lse)[..., None])
    if keep is not None:
        p = torch.where(keep, p, 0.0)
    do, vf = dout.float(), v[:, :, :kv].float()
    delta = (do * out.float()).sum(dim=-1, keepdim=True)
    ds = p * (torch.einsum("bhnc,bhmc->bhnm", do, vf) - delta)
    dq = torch.einsum("bhnm,bhmc->bhnc", ds, k[:, :, :kv].float()) * scale
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    dk[:, :, :kv] = torch.einsum("bhnm,bhnc->bhmc", ds, q.float()) * scale
    dv[:, :, :kv] = torch.einsum("bhnm,bhnc->bhmc", p, do)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_fwd_lse(q, k, v, labels=None):
    """K6: (out (B,H,N,c), lse (B,H,N) fp32) of q (B,H,N,c), k/v (B,H,M,c)
    head views; unscaled q, lse in base 2. The output is a view of a
    (B,N,H,c) buffer."""
    _check_shapes("flash_attention_trainable", q, k, v, (0, 1, 3))
    b, h, n, c = q.shape
    m = k.shape[2]
    if labels is not None:
        _check_labels("flash_attention_trainable", labels, b, n, m)
    if q.device.type == "cpu":
        return flash_attention_fwd_lse_plain(q, k, v, labels)
    out = torch.empty((b, n, h, c), dtype=q.dtype, device=q.device)
    out_v = out.permute(0, 2, 1, 3)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    _launch("flash_attention_trainable", q, k, v, out_v, b, h, n, m, c,
            _head_strides(q, k, v, out_v), False, labels, lse)
    return out_v, lse


def _delta(out, dout):
    """rowsum(dO * O) in fp32, (B,H,N) contiguous."""
    return (dout.float() * out.float()).sum(dim=-1).contiguous()


def _rows_buffer(b, h, n, device):
    """An fp32 (B,H,N) view whose rows are 16-byte multiples apart, as the
    backward kernels' tensor maps of lse and delta need."""
    return torch.empty((b, h, -(-n // 4) * 4), dtype=torch.float32, device=device)[..., :n]


def _rows_ok(t):
    """t is fp32 (B,H,N) with contiguous rows a multiple of 4 values apart."""
    return (t.dtype == torch.float32 and t.dim() == 3 and t.stride(2) == 1
            and t.stride(1) % 4 == 0 and t.stride(1) >= t.shape[2]
            and t.stride(0) == t.shape[1] * t.stride(1) and t.data_ptr() % 16 == 0)


def _kernel_rows(t):
    """lse or delta as the backward kernels take it (`_rows_ok`): t itself,
    or a copy with padded rows when N is not a multiple of 4."""
    if _rows_ok(t):
        return t
    rows = _rows_buffer(*t.shape, t.device)
    rows.copy_(t)
    return rows


def _launch_bwd(which, q, k, v, dout, lse, delta, grads, labels, out=None):
    """which: "dq" (grads = (dq,); the kernel also writes delta from `out`)
    or "dkv" (grads = (dk, dv); reads delta); every tensor a (B,H,*,c) view,
    lse and delta fp32 (B,H,N) as `_kernel_rows` gives them."""
    name = f"flash_attention_bwd_{which}"
    b, h, n, c = q.shape
    m = k.shape[2]
    views = (q, k, v, dout) + ((out,) if which == "dq" else ())
    _build.require_cuda(name, *views, *grads)
    strides = _head_strides(*views, *grads)
    _check_operands(name, views + tuple(grads), strides, b, h, c)
    for t in (lse, delta):
        if not _rows_ok(t) or t.shape != (b, h, n):
            raise ValueError(f"{name}: lse and delta must be fp32 {(b, h, n)} with rows "
                             "16-byte multiples apart")
    plan = bwd_plan(which, b, h, n, m, c, labels is not None)
    # box rows of the q-side (q, dO, O) and the key-side (k, v) maps
    qbox, kbox = ((plan.block_rows, plan.tile_rows) if which == "dq"
                  else (plan.tile_rows, plan.block_rows))
    maps = []
    for t, rows, box in ((q, n, qbox), (k, m, kbox), (v, m, kbox), (dout, n, qbox)):
        maps += tma_plan((b, h), _head_strides(t), c, rows, box).args(t.data_ptr())
    if which == "dq":
        maps += tma_plan((b, h), _head_strides(out), c, n, qbox).args(out.data_ptr())
    maps = (ctypes.c_longlong * len(maps))(*maps)
    gstrides = (ctypes.c_longlong * 6)(*strides[3 * len(views):], *([0] * (6 - 3 * len(grads))))
    bits_ptr, open_ptr, label_stride, name, _keep = _label_args(name, labels, q)
    lib = _build.lib()
    tail = (bits_ptr, open_ptr, label_stride, b, h, n, m, c, plan.tile_rows, plan.stages,
            plan.smem, float(1.0 / math.sqrt(c)), _build.stream_of(q))
    with torch.cuda.device(q.device):
        rows = (lse.data_ptr(), lse.stride(1), delta.data_ptr(), delta.stride(1))
        if which == "dq":
            err = lib.idt_flash_bwd_dq(maps, *rows, grads[0].data_ptr(), gstrides, *tail)
        else:
            err = lib.idt_flash_bwd_dkv(maps, *rows, grads[0].data_ptr(), grads[1].data_ptr(),
                                        gstrides, *tail)
    _build.check(err, name)
    LAUNCHES[name] += 1


def bwd_encode_us() -> float:
    """Host microseconds the last backward launch spent encoding its tensor
    maps."""
    return _build.lib().idt_flash_bwd_encode_us()


def _grad_buffer(t):
    """A (B,H,L,c) view of a fresh (B,L,H,c) buffer shaped like t."""
    b, h, length, c = t.shape
    return torch.empty((b, length, h, c), dtype=t.dtype, device=t.device).permute(0, 2, 1, 3)


def _kernel_dout(dout):
    """dO as the kernels take it: head dim contiguous, 16-byte rows."""
    ok = (dout.stride(-1) == 1 and dout.data_ptr() % 16 == 0
          and all(s % 8 == 0 for s in dout.stride()[:3]))
    return dout if ok else dout.contiguous()


def flash_attention_bwd_dq(q, k, v, out, lse, dout, labels=None, with_delta=False):
    """dq kernel (replaces `_bwd_dq_kernel`); the plain version's dq on the
    CPU. with_delta: also return the fp32 (B,H,N) delta = rowsum(dO * O) the
    kernel computes for the dk/dv kernel (`_delta` on the CPU)."""
    if q.device.type == "cpu":
        dq = flash_attention_bwd_plain(q, k, v, out, lse, dout, labels)[0]
        return (dq, _delta(out, dout)) if with_delta else dq
    dq = _grad_buffer(q)
    delta = _rows_buffer(*lse.shape, q.device)
    _launch_bwd("dq", q, k, v, _kernel_dout(dout), _kernel_rows(lse), delta, (dq,), labels,
                out=out)
    return (dq, delta) if with_delta else dq


def flash_attention_bwd_dkv(q, k, v, out, lse, dout, labels=None, delta=None):
    """dk/dv kernel (replaces `_bwd_dkv_kernel`); the plain version's dk, dv
    on the CPU. delta: the fp32 (B,H,N) rowsum(dO * O) (the dq kernel's, as
    the training backward passes it), or None to compute it with `_delta`."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, labels)[1:]
    dout = _kernel_dout(dout)
    dk, dv = _grad_buffer(k), _grad_buffer(v)
    if delta is None:
        delta = _delta(out, dout)
    _launch_bwd("dkv", q, k, v, dout, _kernel_rows(lse), _kernel_rows(delta), (dk, dv), labels)
    return dk, dv


class _FlashTrainFn(torch.autograd.Function):
    """Forward K6 on CUDA head views; backward the dq and dk/dv kernels."""

    @staticmethod
    def forward(ctx, q, k, v, bits, open_):
        labels = None if bits is None else (bits, open_)
        out, lse = flash_attention_fwd_lse(q, k, v, labels)
        ctx.save_for_backward(q, k, v, out, lse, bits, open_)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, bits, open_ = ctx.saved_tensors
        labels = None if bits is None else (bits, open_)
        dq, delta = flash_attention_bwd_dq(q, k, v, out, lse, dout, labels, with_delta=True)
        dk, dv = flash_attention_bwd_dkv(q, k, v, out, lse, dout, labels, delta)
        return dq, dk, dv, None, None


def flash_attention_trainable(q, k, v):
    """Differentiable attention over (B,H,N,c) x (B,H,M,c) head views with
    unscaled q: kernels K6 / dq / dk-dv on CUDA, autograd of `sdpa_fp32` on
    the CPU. Returns a (B,H,N,c) view of a (B,N,H,c) tensor."""
    _check_shapes("flash_attention_trainable", q, k, v, (0, 1, 3))
    if q.device.type == "cpu":
        return sdpa_fp32(q, k, v)
    return _FlashTrainFn.apply(q, k, v, None, None)


def flash_attention_trainable_labeled(q, k, v, bits, open_):
    """`flash_attention_trainable` under the instance-label predicate; the
    labels (int32 (B, L), L >= max(N, M)) get no gradient."""
    _check_shapes("flash_attention_trainable", q, k, v, (0, 1, 3))
    b, _, n, _ = q.shape
    m = k.shape[2]
    _check_labels("flash_attention_trainable_labeled", (bits, open_), b, n, m)
    if q.device.type == "cpu":
        return sdpa_fp32(q, k, v, mask=_plain_mask((bits, open_), n, m))
    return _FlashTrainFn.apply(q, k, v, bits, open_)


def instance_labels(att_masks, n_objs: int, seg_tokens: int = 64):
    """(B, n_objs, S, S) binary box/instance rasters -> per-token (bits,
    open) int32 (B, S*S + 4*n_objs + seg_tokens) labels over [visual |
    box, point, scribble, polygon grounding | seg] tokens:
      visual token:           bits = OR of (1 << k) over instances k covering it
      box/polygon token k:    bits = GROUNDING_BIT | (1 << k), not open
      point/scribble tokens:  bits = GROUNDING_BIT, open
      seg tokens:             bits = GROUNDING_BIT, open
    A sample with no mask at all is open everywhere (unmasked)."""
    b, n, s, _ = att_masks.shape
    dev = att_masks.device
    masks = att_masks.reshape(b, n, s * s) > 0
    powers = (1 << torch.arange(n, dtype=torch.int32, device=dev))
    # OR == sum: instance bits are disjoint powers of two
    vis_bits = torch.where(masks, powers[None, :, None], 0).sum(1, dtype=torch.int32)
    vis_open = torch.zeros((b, s * s), dtype=torch.int32, device=dev)

    inst_bits = (powers | GROUNDING_BIT).expand(b, n)
    gb = torch.full((b, n), GROUNDING_BIT, dtype=torch.int32, device=dev)
    closed = torch.zeros((b, n), dtype=torch.int32, device=dev)
    opened = torch.ones((b, n), dtype=torch.int32, device=dev)
    # token order [box, point, scribble, polygon]: box and polygon
    # restricted, point and scribble open
    g_bits = torch.cat([inst_bits, gb, gb, inst_bits], dim=1)
    g_open = torch.cat([closed, opened, opened, closed], dim=1)
    seg_bits = torch.full((b, seg_tokens), GROUNDING_BIT, dtype=torch.int32, device=dev)
    seg_open = torch.ones((b, seg_tokens), dtype=torch.int32, device=dev)

    bits = torch.cat([vis_bits, g_bits, seg_bits], dim=1)
    open_ = torch.cat([vis_open, g_open, seg_open], dim=1)
    has_mask = masks.any(dim=2).any(dim=1)
    return bits, torch.where(has_mask[:, None], open_, 1)
