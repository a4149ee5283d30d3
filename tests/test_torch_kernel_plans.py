"""The pure-Python plans behind the port's redesigned kernels, on the CPU.

`tma_plan` derives the 4-D TMA tensor map of each flash-attention operand
from the view the wrapper is given; `gn_plan` cuts each sample's rows over
the GroupNorm kernel's cooperative grid. Neither needs a card, so the shapes and
views of the main path are checked here: strides, boxes and coordinate
slots of the maps, and that every row and channel of a GroupNorm call is
covered exactly once.
"""

import pytest
import torch

from instancediffusion_tpu_torch.kernels import flash_attention as fa
from instancediffusion_tpu_torch.kernels import norms

# GroupNorm shapes (B, rows, C) of the B=16 gate-1 UNet forward and of the
# VAE decoder at B=8
GN_SHAPES = [(16, n, c) for n, c in (
    (4096, 320), (4096, 640), (4096, 960), (1024, 320), (1024, 640), (1024, 960), (1024, 1280),
    (1024, 1920), (256, 640), (256, 1280), (256, 1920), (256, 2560), (64, 1280), (64, 2560))]
GN_SHAPES += [(8, n, c) for n, c in (
    (4096, 512), (16384, 512), (65536, 256), (65536, 512), (262144, 128), (262144, 256))]


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
    assert b * plan.splits <= sm_count * norms.GN_COOP_BLOCKS_PER_SM
    assert plan.smem == plan.threads * 8 * 4


def test_gn_plan_fills_the_card_at_the_main_path_shapes():
    """At B=16 and B=8 the grid takes at least 90 % of the blocks the card
    holds resident (rows_per is rounded up, so a few chunks may go)."""
    for b, n, c in GN_SHAPES:
        plan = norms.gn_plan(b, n, c, 132)
        per_sample = 132 * norms.GN_COOP_BLOCKS_PER_SM // b
        assert plan.splits >= 0.9 * min(n, per_sample), (b, n, c, plan)


@pytest.mark.parametrize("b, n, c", [(2, 64, 36), (2, 64, 2568), (600, 64, 320)])
def test_gn_plan_rejects_what_the_kernel_cannot_take(b, n, c):
    """A channel count off 8 or past 2560; a batch larger than the
    cooperative grid can hold resident."""
    with pytest.raises(ValueError):
        norms.gn_plan(b, n, c, 132)
