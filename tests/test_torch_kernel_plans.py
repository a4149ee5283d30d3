"""The pure-Python plans behind the port's redesigned kernels, on the CPU.

`tma_plan` derives the 4-D TMA tensor map of each flash-attention operand
from the view the wrapper is given; `gn_plan` cuts each sample's rows over
the GroupNorm kernel's cooperative grid (and a large batch over several
launches); `ff_fits` / `ff_plan` say which feed-forward shapes the fused
kernel serves and how it tiles them; `ln_plan` picks the lanes that share a
LayerNorm row; `takes_kernel` / `flash_route` route a call by dtype;
`bwd_plan` tiles the backward flash kernels and `padded_scores` pads the
key axis of the plain route's fp32 scores; `split_plan` / `merge_plan` tile
the fused projection kernels and give their TMA maps. None
needs a card, so the shapes and views of the main path are checked here:
strides, boxes and coordinate slots of the maps, and that every row, channel
and inner chunk is covered exactly once.
"""

import numpy as np
import pytest
import torch

from instancediffusion_tpu_torch import kernels
from instancediffusion_tpu_torch.kernels import flash_attention as fa
from instancediffusion_tpu_torch.kernels import geglu_ff as ff
from instancediffusion_tpu_torch.kernels import head_layout as hl
from instancediffusion_tpu_torch.kernels import norms
from instancediffusion_tpu_torch.nn import core as pnn
from instancediffusion_tpu_torch.ops.attention import flash_route, padded_scores

# GroupNorm shapes (B, rows, C) of the B=16 gate-1 UNet forward and of the
# VAE decoder at B=8
GN_SHAPES = [(16, n, c) for n, c in (
    (4096, 320), (4096, 640), (4096, 960), (1024, 320), (1024, 640), (1024, 960), (1024, 1280),
    (1024, 1920), (256, 640), (256, 1280), (256, 1920), (256, 2560), (64, 1280), (64, 2560))]
GN_SHAPES += [(8, n, c) for n, c in (
    (4096, 512), (16384, 512), (65536, 256), (65536, 512), (262144, 128), (262144, 256))]
# the SDXL refiner's B=16 forward at 512 px (8 images under CFG): its decoder
# joins reach 3072 channels, which take the wide form (384 threads, 3 blocks
# an SM)
REFINER_GN_SHAPES = [(16, n, c) for n, c in (
    (4096, 384), (4096, 768), (4096, 1152), (1024, 384), (1024, 768), (1024, 1152),
    (1024, 1536), (1024, 2304), (256, 768), (256, 1536), (256, 2304), (256, 3072),
    (64, 1536), (64, 3072))]
GN_SHAPES += REFINER_GN_SHAPES


def _heads(t, h):
    return t.reshape(t.shape[0], t.shape[1], h, -1).transpose(1, 2)


def _strides(t):
    return t.stride(0), t.stride(1), t.stride(2)


def test_tma_plan_ds1_head_view():
    """A (16,8,4096,40) head view of a (16,4096,320) projection, read in
    place: head dim, then head (80 B), row (640 B), batch."""
    q = _heads(torch.empty(16, 4096, 320, device="meta"), 8)
    plan = fa.tma_plan((16, 8), _strides(q), 40, 4096)
    assert plan.dims == (40, 8, 4096, 16)
    assert plan.strides == (80, 640, 4096 * 640)
    assert plan.box == (64, 1, 128, 1)
    assert plan.order == (1, 2, 3)  # head, row, batch slots
    assert plan.args(1234) == [1234, 40, 8, 4096, 16, 80, 640, 4096 * 640, 64, 1, 128, 1, 1, 2, 3]


def test_tma_plan_ds2_packed_layout():
    """flash_attention_packed's (batch, head, row) strides of a (B,N,8*80)
    tensor: heads sliced in the map, 160-byte head stride."""
    x = torch.empty(16, 1208, 640, device="meta")
    plan = fa.tma_plan((16, 8), (x.stride(0), 80, x.stride(1)), 80, 1208)
    assert plan.dims == (80, 8, 1208, 16)
    assert plan.strides == (160, 1280, 1208 * 1280)
    assert plan.box == (64, 1, 128, 1) and plan.order == (1, 2, 3)


def test_tma_plan_refiner_ds2_packed_layout():
    """The SDXL refiner's ds2 self-attention, (B,1024,12*64): one 64-column
    box covers a head, 128-byte head stride."""
    x = torch.empty(16, 1024, 768, device="meta")
    plan = fa.tma_plan((16, 12), (x.stride(0), 64, x.stride(1)), 64, 1024)
    assert plan.dims == (64, 12, 1024, 16)
    assert plan.strides == (128, 1536, 1024 * 1536)
    assert plan.box == (64, 1, 128, 1) and plan.order == (1, 2, 3)


def test_tma_plan_row_slice_view():
    """q from the visual rows of the fuser's [x | objs] (the K8 route's
    row slice): the batch stride is that of the 4280-row tensor."""
    cat = torch.empty(2, 4280, 320, device="meta")
    q = _heads(cat[:, :4096], 8)
    plan = fa.tma_plan((2, 8), _strides(q), 40, 4096)
    assert plan.dims == (40, 8, 4096, 2)
    assert plan.strides == (80, 640, 4280 * 640)


def test_tma_plan_pre_padded_kv():
    """kv pre-padded to 4608 rows with kv_len 4280: the map ends at kv_len
    (TMA reads rows past it as zero), the batch stride spans 4608 rows."""
    k = _heads(torch.empty(2, 4608, 320, device="meta"), 8)
    plan = fa.tma_plan((2, 8), _strides(k), 40, 4280)
    assert plan.dims == (40, 8, 4280, 2)
    assert plan.strides == (80, 640, 4608 * 640)


def test_tma_plan_orders_axes_by_stride():
    """A contiguous (B,H,N,c) tensor: the row axis has the smallest stride,
    so it comes first; the coordinate slots follow."""
    t = torch.empty(2, 8, 300, 40, device="meta")
    plan = fa.tma_plan((2, 8), _strides(t), 40, 300)
    assert plan.dims == (40, 300, 8, 2)
    assert plan.strides == (80, 300 * 80, 8 * 300 * 80)
    assert plan.box == (64, 128, 1, 1)
    assert plan.order == (2, 1, 3)


def test_tma_plan_puts_a_unit_axis_last():
    """B=1: the batch axis is degenerate and goes last, with a stride that
    continues the row axis (its own may be anything)."""
    q = _heads(torch.empty(1, 4096, 320, device="meta"), 8)
    plan = fa.tma_plan((1, 8), (7, *_strides(q)[1:]), 40, 4096)
    assert plan.dims == (40, 8, 4096, 1)
    assert plan.strides == (80, 640, 4096 * 640)
    assert plan.order == (1, 2, 3)


@pytest.mark.parametrize("strides", [(4096 * 352, 44, 352), (4096 * 324, 40, 324)])
def test_tma_plan_rejects_strides_off_16_bytes(strides):
    """A head stride of 88 bytes or a row stride of 648 bytes is not a
    multiple of 16: TMA cannot take it, and the plan says so."""
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        fa.tma_plan((2, 8), strides, 40, 4096)


def test_tma_plan_rejects_a_ragged_head_dim():
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.tma_plan((2, 8), (4096 * 320, 40, 320), 36, 4096)


def test_label_rows_padded_to_16_bytes():
    """The label tensor map needs rows of a multiple of 4 int32: a 4281-wide
    row is padded with zeros (closed, no instance) to 4284."""
    bits = torch.arange(2 * 4281, dtype=torch.int32).reshape(2, 4281)
    open_ = torch.ones(2, 4281, dtype=torch.int32)
    _, _, stride, name, (pb, po) = fa._label_args("flash_attention", (bits, open_), bits)
    assert stride == 4284 and name == "flash_attention_labeled"
    assert torch.equal(pb[:, :4281], bits) and not pb[:, 4281:].any()
    assert torch.equal(po[:, :4281], open_) and not po[:, 4281:].any()


# the H100 SXM, the H100 PCIe, half a card
@pytest.mark.parametrize("sm_count", [132, 114, 66])
@pytest.mark.parametrize("shape", GN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gn_plan_covers_every_row_and_channel_once(shape, sm_count):
    b, n, c = shape
    plan = norms.gn_plan(b, n, c, sm_count)
    # rows: chunk i is [i * rows_per, min(n, (i + 1) * rows_per)), none empty
    assert plan.splits * plan.rows_per >= n > (plan.splits - 1) * plan.rows_per
    rows = torch.zeros(n, dtype=torch.int32)
    for i in range(plan.splits):
        rows[i * plan.rows_per:(i + 1) * plan.rows_per] += 1
    assert bool((rows == 1).all())
    # channels: thread t owns the 8 channels of vector t % (C / 8)
    lanes = c // 8
    assert plan.threads % lanes == 0 and plan.threads <= norms.GN_MAX_THREADS
    assert sorted(8 * (t % lanes) + e for t in range(lanes) for e in range(8)) == list(range(c))
    # the whole cooperative grid is resident for its barrier
    assert b * plan.splits <= sm_count * norms.gn_coop_blocks(c)
    assert plan.launches(b) == [(0, b)]
    assert plan.smem == plan.threads * 8 * 4


def test_gn_plan_fills_the_card_at_the_main_path_shapes():
    """At B=16 and B=8 the grid takes at least 90 % of the blocks the card
    holds resident (rows_per is rounded up, so a few chunks may go)."""
    for b, n, c in GN_SHAPES:
        plan = norms.gn_plan(b, n, c, 132)
        per_sample = 132 * norms.gn_coop_blocks(c) // b
        assert plan.splits >= 0.9 * min(n, per_sample), (b, n, c, plan)


@pytest.mark.parametrize("b, n, c", [(2, 64, 36), (2, 64, 3080)])
def test_gn_plan_rejects_what_the_kernel_cannot_take(b, n, c):
    """A channel count off 8 or past 3072."""
    with pytest.raises(ValueError):
        norms.gn_plan(b, n, c, 132)


# 558: generate at mis=0.36 with 30 instances and 9 images (2 * 31 * 9 rows)
@pytest.mark.parametrize("sm_count", [132, 114, 66])
@pytest.mark.parametrize("b, n, c", [(558, 4096, 320), (558, 64, 1280), (600, 64, 320),
                                     (529, 1024, 640), (2000, 256, 1280), (600, 64, 3072)])
def test_gn_plan_cuts_a_large_batch_into_resident_launches(b, n, c, sm_count):
    """A batch above the blocks the card holds resident goes in several
    cooperative launches: every sample in exactly one, every launch's grid
    resident, the launches as equal as the batch allows."""
    resident = sm_count * norms.gn_coop_blocks(c)
    plan = norms.gn_plan(b, n, c, sm_count)
    launches = plan.launches(b)
    seen = torch.zeros(b, dtype=torch.int32)
    for first, count in launches:
        assert 0 < count <= plan.batch_chunk
        assert count * plan.splits <= resident
        seen[first:first + count] += 1
    assert bool((seen == 1).all())
    assert len(launches) == -(-b // resident)  # the fewest that can be resident
    counts = [count for _, count in launches]
    assert max(counts) - min(counts) <= len(launches)
    assert plan.splits * plan.rows_per >= n > (plan.splits - 1) * plan.rows_per


@pytest.mark.parametrize("c, narrow", [(2560, True), (2568, False), (3072, False)])
def test_gn_wide_form_above_320_threads(c, narrow):
    """Up to 320 threads (C=2560) the narrow form, 4 blocks an SM; wider
    rows one thread per vector still, 3 blocks an SM."""
    plan = norms.gn_plan(16, 256, c, 132)
    assert plan.threads == c // 8
    assert norms.gn_coop_blocks(c) == (4 if narrow else 3)
    assert (plan.threads <= norms.GN_NARROW_THREADS) == narrow


@pytest.mark.parametrize("c, groups, fits", [
    (3072, 32, True), (2304, 32, True), (384, 32, True), (3080, 8, False), (3200, 32, False),
    (100, 4, False), (96, 12, True), (640, 128, False), (640, 48, False)])
def test_group_norm_routes_by_shape(c, groups, fits, monkeypatch):
    """`nn/core.group_norm` sends a bf16 width the kernel does not take
    (`group_norm_fits`) to the plain version before the call, and never
    raises on a width; one it takes goes to the kernel's wrapper."""
    assert norms.group_norm_fits(c, groups) == fits
    called = []
    real = pnn.fused_group_norm
    monkeypatch.setattr(pnn, "fused_group_norm",
                        lambda *a, **k: called.append(1) or real(*a, **k))
    x = torch.randn(2, 4, 4, c).to(torch.bfloat16)
    p = pnn.Norm(c)
    out = pnn.group_norm(p, x, num_groups=groups) if c % groups == 0 else None
    if out is not None:
        assert out.shape == x.shape and bool(out.isfinite().all())
        assert called == ([1] if fits else [])


# ---------------------------------------------------------------------------
# GEGLU feed-forward: which shapes the fused kernel serves, and its tiles
# ---------------------------------------------------------------------------

# (rows per sample, C) of every transformer FF of the UNet, with how many run
# in one gate-1 forward (ds8 is the mid block)
UNET_FF = {"ds1": (4096, 320, 10), "ds2": (1024, 640, 10), "ds4": (256, 1280, 10),
           "ds8": (64, 1280, 2)}
# the SDXL refiner's at 512 px: depth-4 transformers, 5 at ds2 and at ds4
# (2 in, 3 out), the middle at ds8
REFINER_FF = {"ds2": (1024, 768, 20), "ds4": (256, 1536, 20), "ds8": (64, 1536, 4)}


@pytest.mark.parametrize("batch", [2, 16, 80])
def test_ff_fits_routes_each_unet_level(batch):
    """ds1 and ds2 go to the fused kernel (C=640 on clusters of two blocks);
    ds4 and ds8 (C=1280: x alone would take 160 KB of each block's shared
    memory; the JAX package's ff_fits keeps these two on XLA as well) go to
    the unfused route. Per gate-1 forward that is 20 kernel launches and 12
    unfused calls, the counts chip_smoke.py checks."""
    fits = {k: ff.ff_fits(batch * n, c, 4 * c) for k, (n, c, _) in UNET_FF.items()}
    assert fits == {"ds1": True, "ds2": True, "ds4": False, "ds8": False}
    fused = sum(cnt for k, (_, _, cnt) in UNET_FF.items() if fits[k])
    assert (fused, sum(cnt for _, _, cnt in UNET_FF.values()) - fused) == (20, 12)


@pytest.mark.parametrize("batch", [2, 16])
def test_ff_fits_routes_each_refiner_level(batch):
    """The refiner's ds2 (C=768, inner 3072: clusters of three blocks) goes
    to the fused kernel, as JAX's ff_fits takes it; ds4 and the middle
    (C=1536) to the unfused route. Per forward: 20 kernel launches, 24
    unfused calls."""
    fits = {k: ff.ff_fits(batch * n, c, 4 * c) for k, (n, c, _) in REFINER_FF.items()}
    assert fits == {"ds2": True, "ds4": False, "ds8": False}
    fused = sum(cnt for k, (_, _, cnt) in REFINER_FF.items() if fits[k])
    assert (fused, sum(cnt for _, _, cnt in REFINER_FF.values()) - fused) == (20, 24)


def test_ff_gate_erf_is_the_rational_of_the_source():
    """The gate's erf: the coefficients in csrc/geglu_ff_sm90.cuh are the
    ones `erf_rational` mirrors, and that rational is erf to a few fp32
    roundings (|error| <= 5e-7 over [-6, 6], evaluated in fp32; the bf16
    rounding of the gated value that follows is 4e-3 relative), odd, and
    saturating within 3e-7 of +-1."""
    import re
    from pathlib import Path

    src = (Path(ff.__file__).parents[1] / "csrc" / "geglu_ff_sm90.cuh").read_text()
    body = src[src.index("const float z2 = z * z;"):src.index("__fdividef(a * z, b)")]
    found = [float(v) for v in re.findall(r"(-?\d\.\d+e-\d+)f", body)]
    assert tuple(found) == ff.ERF_P + ff.ERF_Q
    z = torch.linspace(-6.0, 6.0, 200001)
    got = ff.erf_rational(z)
    assert got.dtype == torch.float32
    assert (got.double() - torch.erf(z.double())).abs().max().item() <= 5e-7
    assert torch.equal(got, -ff.erf_rational(-z)) and got.abs().max().item() <= 1.0 + 3e-7


def _ff_args(g, c, dt):
    return [t.to(dt) for t in (
        torch.randn(2, 8, c, generator=g), torch.randn(8 * c, c, generator=g) * c ** -0.5,
        torch.randn(8 * c, generator=g) * 0.1, torch.randn(c, 4 * c, generator=g) * 0.05,
        torch.randn(c, generator=g) * 0.1)]


def test_ff_geglu_switch_counts_both_routes():
    """The one switch: a bf16 call that fits takes the kernel route (its
    plain version on the CPU), anything else the unfused route, and the
    unfused calls are counted."""
    g = torch.Generator().manual_seed(0)
    kernels.reset_launch_counts()
    a = _ff_args(g, 64, torch.bfloat16)
    assert torch.equal(ff.ff_geglu(*a), ff.ff_geglu_plain(*a))
    assert kernels.ROUTES["ff_geglu_unfused"] == 0
    for c, dt in ((64, torch.float32), (96, torch.bfloat16)):
        a = _ff_args(g, c, dt)
        assert torch.equal(ff.ff_geglu(*a), ff.ff_geglu_unfused(*a))
    assert kernels.ROUTES["ff_geglu_unfused"] == 2


@pytest.mark.parametrize("m, c", [(65536, 320), (32768, 320), (8229, 320), (2053, 320),
                                  (128, 64), (200, 128), (16384, 640), (2048, 640),
                                  (2053, 640), (16384, 768), (1024, 768), (2053, 768)])
def test_ff_plan_covers_every_inner_chunk_once(m, c):
    """The tile plan: the three tensor maps (64-column boxes over the
    contiguous matrices, the weights' boxes one ring slot's rows); a cluster
    of one block (two at C=640, three at C=768) per 64 rows; per turn every (warpgroup, C
    slice) of w1 and every (warpgroup's output rows, gated chunk) of w2 in
    exactly one ring slot, the two warpgroups of a block on alternate slots;
    every inner column gated once, every output column and every row owned
    once; the shared memory within the block's 232,448 bytes."""
    inner = 4 * c
    plan = ff.ff_plan(m, c, inner)
    cl = plan.cluster
    assert cl == ff.cluster_blocks(c) == {640: 2, 768: 3}.get(c, 1)
    cols = c // (2 * cl)  # output columns a warpgroup
    assert cols <= ff.MAX_BLOCK_COLS // 2
    assert plan.x == (c, m, 2 * c, 64, 64)
    assert plan.w1 == (c, 2 * inner, 2 * c, 64, ff.GATED)
    assert plan.w2 == (inner, c, 2 * inner, 64, cols)
    assert plan.x.args(77) == [77, c, m, 2 * c, 64, 64]
    # whole 8-row swizzle blocks per box
    assert plan.w1.box_rows % 8 == 0 and plan.w2.box_rows % 8 == 0
    assert plan.blocks % cl == 0
    assert plan.blocks // cl * 64 >= m > (plan.blocks // cl - 1) * 64
    turn = ff.turn_cols(c)
    assert plan.turns * turn == inner and turn == 2 * cl * ff.GATED
    chunks = turn // 64
    for r in range(cl):  # block r's loads, in order: its two warpgroups alternate
        for slots in (plan.w1_turn, plan.w2_turn):
            mine = [s[1] - 2 * r for s in slots if s[1] // 2 == r]
            assert mine == [i % 2 for i in range(len(mine))]
    # w1: each warpgroup takes every 64-column slice of C once
    for q in range(2 * cl):
        assert [k for _, wg, k in plan.w1_turn if wg == q] == list(range(c // 64))
    # inner columns: turn t, warpgroup q gates [turn t + 32 q, + 32)
    gated = torch.zeros(inner, dtype=torch.int32)
    for t in range(plan.turns):
        for q in range(2 * cl):
            lo = turn * t + ff.GATED * q
            gated[lo:lo + ff.GATED] += 1
    assert bool((gated == 1).all())
    # w2: a warpgroup owns its output columns and loads them once per chunk
    # of the turn's gated tile
    out = torch.zeros(c, dtype=torch.int32)
    for q in range(2 * cl):
        mine = [(row, kc) for _, wg, row, kc in plan.w2_turn if wg == q]
        assert mine == [(q * cols, kc) for kc in range(chunks)]
        out[q * cols:(q + 1) * cols] += 1
    assert bool((out == 1).all())
    # shared memory: x, the double-buffered gated tile, both rings, the
    # barriers, 1 KB to align
    assert plan.w1_stages % 2 == 0 and plan.w2_stages % 2 == 0
    assert plan.smem == (c * 128 + 2 * chunks * 8192 + plan.w2_stages * plan.w2_tiles * cols * 128
                         + plan.w1_stages * 8192
                         + (2 * plan.w1_stages + 2 * plan.w2_stages + 3) * 8 + 1024)
    assert plan.smem <= 232448
    # the w1 ring holds a whole turn's slots where C allows (C=320: 10);
    # C=640 leaves it two slots a warpgroup, C=768 three
    assert plan.w1_stages >= {640: 4, 768: 6}.get(c, min(16, 2 * (c // 64)))
    if chunks <= 2:
        # a w2 slot holds a warpgroup's rows for a whole turn: two turns
        # each (C=640: one)
        assert plan.w2_tiles == chunks and plan.w2_stages * chunks == 4
    else:
        # C=768: a turn's three tiles would not fit; one tile a slot, one
        # slot a warpgroup
        assert (chunks, plan.w2_tiles, plan.w2_stages) == (3, 1, 2)


@pytest.mark.parametrize("m, c, inner", [(4096, 1280, 5120), (16384, 640, 2560 + 64),
                                         (64, 96, 384), (64, 320, 1000), (0, 320, 1280)])
def test_ff_plan_refuses_what_does_not_fit(m, c, inner):
    assert not ff.ff_fits(m, c, inner)
    with pytest.raises(ValueError, match="does not fit"):
        ff.ff_plan(m, c, inner)


@pytest.mark.parametrize("c", [1024, 1280])
def test_ff_plan_refuses_a_w1_ring_under_two_slots_a_warpgroup(c, monkeypatch):
    """A width whose x, gated tiles and w2 slots leave the w1 ring fewer
    than two slots a warpgroup is refused by the plan itself (the first
    product frees a slot only after issuing the next one's wgmma, so one
    slot a warpgroup would deadlock), even if it were built."""
    monkeypatch.setattr(ff, "KERNEL_WIDTHS", ff.KERNEL_WIDTHS + (c,))
    ff.ff_plan.cache_clear()
    try:
        with pytest.raises(ValueError, match="two a warpgroup"):
            ff.ff_plan(1024, c, 4 * c)
    finally:
        ff.ff_plan.cache_clear()


# ---------------------------------------------------------------------------
# LayerNorm: lanes per row
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c, elem, lanes", [(320, 2, 8), (640, 2, 16), (1280, 2, 32),
                                            (768, 2, 32), (96, 4, 8), (192, 4, 16),
                                            (384, 4, 32), (768, 4, 32), (2048, 2, 32),
                                            (64, 2, 8)])
def test_ln_plan_rows_per_warp(c, elem, lanes):
    """Narrow rows go several to a warp (the UNet's C=320: four; ConvNeXt's
    fp32 C=96: four); every 16-byte vector of a row belongs to one lane, at
    most LN_MAX_VECS a lane."""
    assert norms.ln_plan(c, elem) == lanes
    vecs = c * elem // 16
    owned = sorted(sub + i * lanes for sub in range(lanes) for i in range(norms.LN_MAX_VECS)
                   if sub + i * lanes < vecs)
    assert owned == list(range(vecs))


@pytest.mark.parametrize("c, elem", [(100, 2), (2560, 2), (1026, 4), (7, 4)])
def test_ln_plan_sends_odd_widths_to_the_generic_loop(c, elem):
    assert norms.ln_plan(c, elem) == 0


# ---------------------------------------------------------------------------
# routing by dtype (bf16 to the kernels, any other dtype plain)
# ---------------------------------------------------------------------------


def test_norms_route_by_dtype():
    bf, fp, half = (torch.empty(1, 4, 8, dtype=d) for d in (torch.bfloat16, torch.float32,
                                                            torch.float16))
    assert pnn.takes_kernel(bf) and not pnn.takes_kernel(fp) and not pnn.takes_kernel(half)
    assert (pnn.takes_kernel(bf, fp32_too=True) and pnn.takes_kernel(fp, fp32_too=True)
            and not pnn.takes_kernel(half, fp32_too=True))
    # one rule for the norms, flash attention and the feed-forward
    assert kernels.kernel_dtype(torch.bfloat16) and not kernels.kernel_dtype(torch.float32)
    assert kernels.kernel_dtype(torch.float32, fp32_too=True)
    assert not kernels.kernel_dtype(torch.float16, fp32_too=True)
    with pnn.plain_kernels():
        assert not pnn.takes_kernel(bf) and not pnn.takes_kernel(fp, fp32_too=True)


@pytest.mark.parametrize("impl, n, m, dtype, c, labels, mask, want", [
    ("kernel", 4096, 4096, torch.bfloat16, 40, None, None, "split"),
    ("kernel", 1024, 1208, torch.bfloat16, 80, None, None, "packed"),
    ("kernel", 4096, 4280, torch.bfloat16, 40, "labels", None, "split"),
    ("kernel", 256, 256, torch.bfloat16, 160, None, None, "plain"),      # ds4: short
    ("kernel", 4096, 77, torch.bfloat16, 40, None, None, "plain"),       # cross-attention
    ("kernel", 4096, 4280, torch.bfloat16, 40, None, "mask", "plain"),   # dense mask
    ("kernel", 4096, 4096, torch.float32, 40, None, None, "plain"),      # fp32 compute
    ("kernel", 64, 248, torch.float32, 40, "labels", None, "plain"),
    ("kernel_train", 4096, 4096, torch.bfloat16, 40, None, None, "train"),
    ("kernel_train", 1024, 1208, torch.bfloat16, 80, None, None, "train"),
    ("kernel_train", 4096, 4096, torch.float32, 40, None, None, "plain"),
    ("plain", 4096, 4096, torch.bfloat16, 40, None, None, "plain"),
])
def test_flash_route(impl, n, m, dtype, c, labels, mask, want):
    assert flash_route(impl, n, m, dtype, c, labels, mask) == want


# the training step's attention shapes at B=4, 8 heads: (N, M, c, labeled)
TRAIN_SHAPES = [(4096, 4096, 40, False), (4096, 4280, 40, False), (1024, 1024, 80, False),
                (1024, 1208, 80, False), (4096, 4280, 40, True)]


def _check_bwd_plan(plan, kind, b, h, n, m, c):
    own, streamed = (n, m) if kind == "dq" else (m, n)
    assert plan.kind == kind
    # every owned row in exactly one block, every streamed row in one tile
    assert plan.grid[1] == b * h
    assert plan.grid[0] * plan.block_rows >= own > (plan.grid[0] - 1) * plan.block_rows
    assert plan.tiles * plan.tile_rows >= streamed > (plan.tiles - 1) * plan.tile_rows
    # 64 rows per consumer warpgroup, whole wgmma depth steps per streamed tile
    assert plan.block_rows % 64 == 0 and plan.tile_rows % 16 == 0
    assert plan.threads == 128 * (plan.block_rows // 64 + 1)
    # the shared memory: at least two ring stages within the block's 232,448 bytes
    assert 2 <= plan.stages <= 4 and plan.smem <= fa.BWD_MAX_SMEM
    atoms = -(-c // 64)
    res = (3 if kind == "dq" else 2) * atoms * plan.block_rows * 128
    assert plan.smem >= res + plan.stages * 2 * atoms * plan.tile_rows * 128
    # registers: a block above 256 threads gets 168 a thread; the
    # accumulators must leave room for descriptors, addresses and labels
    assert plan.reg_limit == (168 if plan.threads > 256 else 255)
    assert plan.acc_regs + 40 <= plan.reg_limit


@pytest.mark.parametrize("kind", ["dq", "dkv"])
@pytest.mark.parametrize("shape", TRAIN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bwd_plan_at_the_training_shapes(kind, shape):
    """The backward kernels' plans at B=4: the ds1 shapes (c=40) stream
    64-row tiles, the ds2 ones (c=80) 32 q rows (dk/dv, whose S^T, dP^T, dK
    and dV would not fit 168 registers at 64) or 64 keys (dq); 128 rows a
    block."""
    n, m, c, labeled = shape
    plan = fa.bwd_plan(kind, 4, 8, n, m, c, labeled)
    _check_bwd_plan(plan, kind, 4, 8, n, m, c)
    assert plan.block_rows == 128
    assert plan.tile_rows == (32 if (kind, c) == ("dkv", 80) else 64)


@pytest.mark.parametrize("kind", ["dq", "dkv"])
@pytest.mark.parametrize("c", [16, 40, 64, 80, 128])
def test_bwd_plan_head_dims(kind, c):
    """Every head-dim class, on ragged lengths (N = 1000, M = 1208); above
    c = 96 a dk/dv block is one consumer warpgroup, which ptxas gives 255
    registers."""
    for labeled in (False, True):
        plan = fa.bwd_plan(kind, 2, 8, 1000, 1208, c, labeled)
        _check_bwd_plan(plan, kind, 2, 8, 1000, 1208, c)
    assert (plan.block_rows == 64) == (kind == "dkv" and c > 96)


@pytest.mark.parametrize("args, match", [
    ((2, 8, 4096, 4096, 36), "multiple of 8"),
    ((2, 8, 4096, 4096, 136), "multiple of 8"),
    ((8192, 9, 64, 64, 40), "grid limit"),
])
def test_bwd_plan_refuses_what_the_kernels_do_not_take(args, match):
    for kind in ("dq", "dkv"):
        with pytest.raises(ValueError, match=match):
            fa.bwd_plan(kind, *args)


@pytest.mark.parametrize("m", [77, 80, 1])
def test_padded_scores_equal_the_unpadded_scores(m):
    """The plain route's fp32 scores through a key axis padded to a
    multiple of 8 (77 -> 80) and sliced back: exactly the unpadded product.
    The values are multiples of 1/8 below 4 in bf16, so every sum is exact
    in fp32 and any summation order gives the same bits."""
    g = torch.Generator().manual_seed(0)
    q = (torch.randint(-32, 32, (16, 96, 40), generator=g) / 8).bfloat16()
    k = (torch.randint(-32, 32, (16, m, 40), generator=g) / 8).bfloat16()
    out = padded_scores(q, k)
    ref = torch.einsum("gnc,gmc->gnm", q.float(), k.float())
    assert out.dtype == torch.float32 and out.shape == (16, 96, m)
    assert torch.equal(out, ref)


# the fused projection kernels (K8 proj_split, K8' merge_proj) at the serving
# batch and at batch 2: (b, m, mpad, weights, x batch stride) of the ds1
# attentions' q (a row slice of the fuser's [x | objs]), k/v over the
# self-attention's rows and over the fuser's 4280 (padded to 4288)
HEAD_SPLIT_CASES = [(b, m, mpad, n_w, sb) for b in (2, 16) for m, mpad, n_w, sb in (
    (4096, 4096, 1, 4280 * 320), (4096, 4096, 2, 4096 * 320), (4280, 4288, 2, 4280 * 320))]


def _check_head_plan(plan, b, out_rows, n_cols, n_out):
    # a cluster's blocks hold the weights' column slices; rows in 64-row tiles
    assert plan.cluster == n_out * n_cols // plan.col_tile <= hl.MAX_CLUSTER
    assert plan.tiles == b * -(-out_rows // plan.rows) and plan.rows == 64
    assert plan.grid == min(plan.tiles, plan.max_clusters) * plan.cluster <= hl.SMS
    # the weight slice, the activation slots and the barriers in 232,448 bytes
    assert 2 <= plan.slots <= hl.MAX_SLOTS and plan.smem <= hl.SMEM_CAP
    assert plan.smem >= plan.chunks * (plan.col_tile + plan.slots * 64) * 128
    # registers: 384 threads get 168 a thread, of which the fp32 accumulator
    # takes col_tile / 2
    assert plan.threads == 384 and plan.reg_limit == 168
    assert plan.acc_regs == plan.col_tile // 2 and plan.acc_regs + 40 <= plan.reg_limit


@pytest.mark.parametrize("case", HEAD_SPLIT_CASES, ids=lambda c: "b{}_m{}_w{}".format(*c[:2], c[3]))
def test_split_plan_at_the_serving_shapes(case):
    """proj_split: 160-column slices (2 blocks a cluster for q, 4 for k and
    v), three 40 KB activation slots beside the 100 KB slice, the
    activations read in place as a (C_in, M, B) map (the q row slice with
    batch stride 4280 * 320), the weight as (C_in, H*c)."""
    b, m, mpad, n_w, sb = case
    plan = hl.split_plan(b, m, mpad, 320, 8, 40, n_w, (sb, 320))
    _check_head_plan(plan, b, mpad, 320, n_w)
    assert (plan.col_tile, plan.chunks, plan.slots, plan.per_head) == (160, 5, 3, False)
    assert plan.cluster == 2 * n_w and plan.max_clusters == hl.SMS // plan.cluster
    assert plan.a == hl.HeadMap((320, m, b), (640, 2 * sb), (64, 64, 1))
    assert plan.w == hl.HeadMap((320, 320), (640,), (64, 160))


@pytest.mark.parametrize("m, seq_pad, tiles", [(4280, None, 67), (100, None, 2), (100, 512, 8)])
def test_split_plan_ragged_rows(m, seq_pad, tiles):
    """Rows past M: the map ends at row M (TMA reads zeros past it) while the
    tiles cover Mpad (4280 -> 4288, 100 -> 128, or an explicit seq_pad of
    512, whose last tiles lie wholly past the activations)."""
    mpad = hl._seq_pad(m, seq_pad)
    plan = hl.split_plan(2, m, mpad, 320, 8, 40, 2, (m * 320, 320))
    _check_head_plan(plan, 2, mpad, 320, 2)
    assert plan.a.dims == (320, m, 2) and plan.tiles == 2 * tiles


@pytest.mark.parametrize("b", [2, 16])
@pytest.mark.parametrize("layout", ["flash_out", "contiguous"])
def test_merge_plan_layouts(b, layout):
    """merge_proj on the flash kernel's output (heads side by side: the
    (B, N, H*c) matrix, 160-column slices) and on a contiguous (B, H, N, c)
    tensor (per head: 8 chunks of one head each, boxes zero-filled from 40 to
    64 columns, 64-column slices so two slots fit)."""
    o = torch.empty(b, 4096, 8, 40).permute(0, 2, 1, 3)
    if layout == "contiguous":
        o = o.contiguous()
    strides = tuple(o.stride()[:3])
    plan = hl.merge_plan(b, 4096, 8, 40, 320, strides)
    _check_head_plan(plan, b, 4096, 320, 1)
    if layout == "flash_out":
        assert (plan.col_tile, plan.chunks, plan.slots, plan.per_head) == (160, 5, 3, False)
        assert plan.a == hl.HeadMap((320, 4096, b), (640, 4096 * 640), (64, 64, 1))
        assert plan.w == hl.HeadMap((320, 320), (640,), (64, 160))
    else:
        assert (plan.col_tile, plan.chunks, plan.slots, plan.per_head) == (64, 8, 2, True)
        assert plan.a == hl.HeadMap((40, 4096, 8, b), (80, 4096 * 80, 8 * 4096 * 80),
                                    (64, 64, 1, 1))
        assert plan.w == hl.HeadMap((40, 8, 320), (80, 640), (64, 1, 64))


@pytest.mark.parametrize("call, match", [
    (lambda: hl.split_plan(2, 64, 64, 320, 6, 12, 1, (64 * 320, 320)), "multiples of 8"),
    (lambda: hl.split_plan(2, 64, 64, 576, 8, 40, 1, (64 * 576, 576)), "at most 8"),
    (lambda: hl.split_plan(2, 64, 64, 320, 2, 48, 1, (64 * 320, 320)), "multiples of 64"),
    (lambda: hl.split_plan(2, 64, 32, 320, 8, 40, 1, (64 * 320, 320)), "below the sequence"),
    (lambda: hl.split_plan(2, 64, 64, 320, 8, 40, 1, (64 * 324, 324)), "multiples of 8"),
    (lambda: hl.split_plan(2, 64, 64, 320, 8, 160, 2, (64 * 320, 320)), "slices"),
    (lambda: hl.merge_plan(2, 64, 4, 80, 320, (4 * 64 * 80, 64 * 80, 80)), "not side by side"),
    (lambda: hl.merge_plan(2, 64, 8, 36, 320, (8 * 64 * 40, 40, 320)), "multiple of 8"),
])
def test_head_plans_refuse_what_the_kernel_does_not_take(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def _head_store_offsets(plan, n_cols, n_out, out_rows, view):
    """Every (weight, element offset) the kernel stores, as csrc/head_layout.cu
    walks them: clusters over row tiles, block r of a cluster on column
    slice r, warp w and lane (g, t) of a warpgroup on rows 16 w + g (+ 8) and
    on the 8-column blocks 4 q + t of the slice."""
    sb, sh, sr, hc = view
    col_tiles = n_cols // plan.col_tile
    n_clusters = plan.grid // plan.cluster
    row_tiles = -(-out_rows // plan.rows)
    rows = (16 * np.arange(4)[:, None, None] + np.arange(8)[None, :, None]
            + 8 * np.arange(2)[None, None, :]).ravel()
    blocks = (4 * np.arange(plan.col_tile // 32)[:, None] + np.arange(4)[None, :]).ravel()
    cols = (8 * blocks[:, None] + np.arange(8)[None, :]).ravel()
    seen = []
    for cid in range(n_clusters):
        for tile in range(cid, plan.tiles, n_clusters):
            b, r0 = tile // row_tiles, (tile % row_tiles) * plan.rows
            for rank in range(plan.cluster):
                wj, n0 = rank // col_tiles, (rank % col_tiles) * plan.col_tile
                r = r0 + rows[rows + r0 < out_rows]
                c = n0 + cols
                off = b * sb + (c // hc)[None, :] * sh + r[:, None] * sr + (c % hc)[None, :]
                seen.append(off.ravel() + wj * (1 << 40))
    return np.concatenate(seen)


@pytest.mark.parametrize("b, m, mpad, n_w", [(2, 100, 128, 2), (3, 4280, 4288, 1),
                                             (2, 300, 640, 2)])
def test_split_plan_stores_every_output_once(b, m, mpad, n_w):
    """The kernel's walk writes every element of each (B, H, Mpad, c) output
    exactly once, on a grid of fewer clusters than tiles."""
    plan = hl.split_plan(b, m, mpad, 320, 8, 40, n_w, (m * 320, 320), max_clusters=3)
    got = np.sort(_head_store_offsets(plan, 320, n_w, mpad,
                                      (8 * mpad * 40, mpad * 40, 40, 40)))
    size = b * 8 * mpad * 40
    want = np.sort(np.concatenate([np.arange(size) + j * (1 << 40) for j in range(n_w)]))
    assert np.array_equal(got, want)


def test_merge_plan_stores_every_output_once():
    plan = hl.merge_plan(2, 333, 8, 40, 320, (8 * 333 * 40, 333 * 40, 40), max_clusters=4)
    got = np.sort(_head_store_offsets(plan, 320, 1, 333, (333 * 320, 0, 320, 320)))
    assert np.array_equal(got, np.arange(2 * 333 * 320))
