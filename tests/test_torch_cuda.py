"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test is marked `cuda` and skips without a CUDA device. The file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

Tolerance: bf16 inputs on both sides; the plain versions compute in fp32
and round once, so max |kernel - plain| <= 1e-2 * max |plain| (the same
bound `chip_smoke.py` holds them to at every main-path shape). LayerNorm on
fp32 rows (ConvNeXt in the grounding tokenizer) differs from its plain
version only in fp32 summation order: 1e-5.
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
from instancediffusion_tpu_torch.ops.attention import labels_to_dense, sdpa_fp32
from instancediffusion_tpu_torch.ops.instance_mask import rasterize_boxes

REL_TOL = 1e-2
FP32_REL_TOL = 1e-5


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _rnd(g, dev, *shape, std=1.0):
    return (torch.randn(shape, generator=g, device=dev) * std).bfloat16()


def _heads(t, h):
    return t.reshape(t.shape[0], t.shape[1], h, -1).transpose(1, 2)


# two samples: sample 0 masked by three boxes, sample 1 all open (the CFG
# null half)
BOXES = [[0.05, 0.35, 0.45, 0.90], [0.55, 0.30, 0.95, 0.90], [0.42, 0.05, 0.58, 0.25]]


def _box_labels(dev, size, n_objs=30, seg_tokens=64):
    boxes = torch.zeros(2, n_objs, 4, device=dev)
    boxes[0, :3] = torch.tensor(BOXES, device=dev)
    return fa.instance_labels(rasterize_boxes(boxes, size), n_objs, seg_tokens)


def _late_labels(dev, length, split):
    """Positions < split carry instance 0, the rest instance 1, nothing
    open: rows >= split find no kept key in their first split keys."""
    bits = torch.where(torch.arange(length, device=dev) < split, 1, 2).int()
    return bits.expand(2, length).contiguous(), torch.zeros(2, length, dtype=torch.int32,
                                                            device=dev)


def _labeled_split(q, k, v, labels, kv_len):
    n = q.shape[1]
    mask = labels_to_dense(*labels)[:, :, :n, :kv_len]
    return (lambda: fa.flash_attention(_heads(q, 8), _heads(k, 8), _heads(v, 8), labels=labels,
                                       kv_len=kv_len),
            lambda: sdpa_fp32(_heads(q, 8), _heads(k[:, :kv_len], 8), _heads(v[:, :kv_len], 8),
                             mask=mask), REL_TOL)


def _case(name, dev):
    """(kernel fn, plain fn, tolerance) at a main-path shape, batch 2."""
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s, std=1.0: _rnd(g, dev, *s, std=std)
    if name == "flash_attention":  # ds1 fuser: unpadded ragged kv
        q, k, v = rnd(2, 4096, 320), rnd(2, 4280, 320), rnd(2, 4280, 320)
        return (lambda: fa.flash_attention(_heads(q, 8), _heads(k, 8), _heads(v, 8)),
                lambda: sdpa_fp32(_heads(q, 8), _heads(k, 8), _heads(v, 8)), REL_TOL)
    if name == "flash_attention_kv_len":  # ds1 fuser, kv pre-padded past kv_len
        q, k, v = rnd(2, 4096, 320), rnd(2, 4608, 320), rnd(2, 4608, 320)
        return (lambda: fa.flash_attention(_heads(q, 8), _heads(k, 8), _heads(v, 8),
                                           kv_len=4280),
                lambda: sdpa_fp32(_heads(q, 8), _heads(k[:, :4280], 8),
                                 _heads(v[:, :4280], 8)), REL_TOL)
    if name == "flash_attention_labeled":  # ds1 masked fuser over 4280 keys
        q, k, v = rnd(2, 4096, 320), rnd(2, 4280, 320), rnd(2, 4280, 320)
        return _labeled_split(q, k, v, _box_labels(dev, 64), 4280)
    if name == "flash_attention_labeled_late":  # first 16 key tiles fully masked
        q, k, v = rnd(2, 2048, 320), rnd(2, 2304, 320), rnd(2, 2304, 320)
        return _labeled_split(q, k, v, _late_labels(dev, 2304, 1024), 2100)
    if name == "flash_attention_packed_labeled":  # ds2-shaped, labels at a 32x32 raster
        q, k, v = rnd(2, 1024, 640), rnd(2, 1208, 640), rnd(2, 1208, 640)
        labels = _box_labels(dev, 32)
        mask = labels_to_dense(*labels)[:, :, :1024, :1208]

        def plain():
            out = sdpa_fp32(_heads(q, 8), _heads(k, 8), _heads(v, 8), mask=mask)
            return out.transpose(1, 2).reshape(2, 1024, 640)

        return lambda: fa.flash_attention_packed(q, k, v, 8, labels=labels), plain, REL_TOL
    if name == "flash_attention_packed":  # ds2 fuser, kv pre-padded past kv_len
        q, k, v = rnd(2, 1024, 640), rnd(2, 1536, 640), rnd(2, 1536, 640)

        def plain():
            out = sdpa_fp32(_heads(q, 8), _heads(k[:, :1208], 8), _heads(v[:, :1208], 8))
            return out.transpose(1, 2).reshape(2, 1024, 640)

        return lambda: fa.flash_attention_packed(q, k, v, 8, kv_len=1208), plain, REL_TOL
    if name == "fused_group_norm":  # VAE decoder row
        x, sc, bi = rnd(2, 65536, 256, std=3.0), rnd(256), rnd(256)
        return (lambda: norms.fused_group_norm(x, sc, bi, 32, 1e-6, "silu"),
                lambda: norms.group_norm_plain(x, sc, bi, 32, 1e-6, "silu"), REL_TOL)
    if name == "fused_layer_norm":  # ds1 fuser concat rows
        x, sc, bi = rnd(2, 4280, 320, std=2.0), rnd(320), rnd(320)
        return (lambda: norms.fused_layer_norm(x, sc, bi),
                lambda: norms.layer_norm_plain(x, sc, bi), REL_TOL)
    if name == "fused_layer_norm_fp32":  # ConvNeXt stem rows, fp32
        x = torch.randn((1, 16384, 96), generator=g, device=dev) * 2.0 + 0.3
        sc, bi = torch.randn(96, generator=g, device=dev), torch.randn(96, generator=g, device=dev)
        return (lambda: norms.fused_layer_norm(x, sc, bi, 1e-6),
                lambda: norms.layer_norm_plain(x, sc, bi, 1e-6), FP32_REL_TOL)
    assert name == "fused_ff_geglu"  # ds1 transformer FF
    x = rnd(2, 4096, 320)
    w1, b1 = rnd(2560, 320, std=320 ** -0.5), rnd(2560, std=0.1)
    w2, b2 = rnd(320, 1280, std=1280 ** -0.5), rnd(320, std=0.1)
    return (lambda: ff.fused_ff_geglu(x, w1, b1, w2, b2),
            lambda: ff.ff_geglu_plain(x, w1, b1, w2, b2), REL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_kv_len",
                                  "flash_attention_labeled", "flash_attention_labeled_late",
                                  "flash_attention_packed", "flash_attention_packed_labeled",
                                  "fused_group_norm",
                                  "fused_layer_norm", "fused_layer_norm_fp32",
                                  "fused_ff_geglu"])
def test_kernel_matches_plain_on_card(dev, name):
    kernels.reset_launch_counts()
    kern, plain, tol = _case(name, dev)
    out, ref = kern().float(), plain().float()
    torch.cuda.synchronize()
    plans = int("labeled" in name)  # a labeled call launches its tile plan first
    assert kernels.LAUNCHES["flash_tile_plan"] == plans
    assert sum(kernels.LAUNCHES.values()) == 1 + plans
    assert out.shape == ref.shape and torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= tol * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["q", "kv_self", "kv_fuser", "ragged"])
def test_proj_split_matches_plain_on_card(dev, case):
    """K8 at the ds1 shapes (batch 2, 8 heads of 40): q from a row slice of
    the fuser's [x | objs] (batch stride (N+G)*C), k/v over 4096 rows and
    over the unpadded 4280 (padded to 4288, tail zero); and a small ragged
    case (100 rows, 1 padded tile)."""
    g = torch.Generator(device=dev).manual_seed(3)
    rows, n_w = {"q": (4096, 1), "kv_self": (4096, 2), "kv_fuser": (4280, 2),
                 "ragged": (100, 2)}[case]
    x = _rnd(g, dev, 2, 4280, 320)[:, :rows] if case == "q" else _rnd(g, dev, 2, rows, 320)
    ws = [_rnd(g, dev, 320, 320, std=320 ** -0.5) for _ in range(n_w)]
    kernels.reset_launch_counts()
    outs = hl.proj_split(x, ws, 8)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"proj_split": 1}
    refs = hl.proj_split_plain(x, ws, 8)
    mpad = -(-rows // 64) * 64
    for out, ref in zip(outs, refs):
        assert out.shape == ref.shape == (2, 8, mpad, 40)
        assert (out.float() - ref.float()).abs().max() <= REL_TOL * ref.float().abs().max()
        assert not out[:, :, rows:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["flash_out", "contiguous"])
def test_merge_proj_matches_plain_on_card(dev, layout):
    """K8' on the flash kernel's output (a head view of a (B,N,H,c) buffer)
    and on a contiguous (B,H,N,c) tensor, with the fp32 bias."""
    g = torch.Generator(device=dev).manual_seed(4)
    o = _rnd(g, dev, 2, 4096, 8, 40)
    o = o.permute(0, 2, 1, 3) if layout == "flash_out" else o.permute(0, 2, 1, 3).contiguous()
    w = _rnd(g, dev, 320, 320, std=320 ** -0.5)
    bias = torch.randn(320, generator=g, device=dev)
    kernels.reset_launch_counts()
    out = hl.merge_proj(o, w, bias)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"merge_proj": 1}
    ref = hl.merge_proj_plain(o, w, bias)
    assert out.shape == ref.shape == (2, 4096, 320)
    assert (out.float() - ref.float()).abs().max() <= REL_TOL * ref.float().abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["kv_row_slice", "ragged_tile", "seq_pad", "batch16_q"])
def test_proj_split_edges_on_card(dev, case):
    """K8 beyond the path's shapes: two weights on a row slice (batch
    stride 4280*320); M = 333, not a multiple of the 128-row tile (padded
    to 384); an explicit seq_pad of 640 above the rounded 320 (whole row
    tiles past the activations, all zero); and the serving batch 16 on q's
    row slice, whose 512 row tiles outnumber the persistent grid."""
    g = torch.Generator(device=dev).manual_seed(6)
    b, rows, n_w, seq_pad = {"kv_row_slice": (2, 4096, 2, None), "ragged_tile": (2, 333, 2, None),
                             "seq_pad": (2, 300, 2, 640), "batch16_q": (16, 4096, 1, None)}[case]
    x = _rnd(g, dev, b, 4280, 320)[:, :rows] if rows == 4096 else _rnd(g, dev, b, rows, 320)
    ws = [_rnd(g, dev, 320, 320, std=320 ** -0.5) for _ in range(n_w)]
    kernels.reset_launch_counts()
    outs = hl.proj_split(x, ws, 8, seq_pad=seq_pad)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"proj_split": 1}
    refs = hl.proj_split_plain(x, ws, 8, seq_pad=seq_pad)
    mpad = seq_pad or -(-rows // 64) * 64
    for out, ref in zip(outs, refs):
        assert out.shape == ref.shape == (b, 8, mpad, 40)
        assert (out.float() - ref.float()).abs().max() <= REL_TOL * ref.float().abs().max()
        assert not out[:, :, rows:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["flash_out", "contiguous"])
def test_merge_proj_without_bias_on_card(dev, layout):
    """K8' with no bias, on both layouts, at a sequence (333) that is not a
    multiple of the 128-row tile."""
    g = torch.Generator(device=dev).manual_seed(7)
    o = _rnd(g, dev, 2, 333, 8, 40).permute(0, 2, 1, 3)
    if layout == "contiguous":
        o = o.contiguous()
    w = _rnd(g, dev, 320, 320, std=320 ** -0.5)
    kernels.reset_launch_counts()
    out = hl.merge_proj(o, w)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"merge_proj": 1}
    ref = hl.merge_proj_plain(o, w)
    assert out.shape == ref.shape == (2, 333, 320)
    assert (out.float() - ref.float()).abs().max() <= REL_TOL * ref.float().abs().max()


@pytest.mark.cuda
def test_head_layout_plans_agree_with_the_kernel(dev):
    """The launcher's own plan (idt_head_plan) equals the wrapper's at the
    four B=16 cases, at batch 2 and for the per-head merge, at the card's
    count of co-resident clusters; a call the kernel does not take raises
    before any launch."""
    for b in (2, 16):
        for m, mpad, n_w, sb in ((4096, 4096, 1, 4280 * 320), (4096, 4096, 2, 4096 * 320),
                                 (4280, 4288, 2, 4280 * 320)):
            sizes = (b, m, mpad, 320, 8, 40, n_w)
            plan = hl._card_plan(hl.split_plan, 0, *sizes, (sb, 320))
            assert plan.max_clusters * plan.cluster <= torch.cuda.get_device_properties(
                0).multi_processor_count
            hl._confirm(0, sizes, (sb, 320), plan)
        for strides in ((4096 * 320, 40, 320), (8 * 4096 * 40, 4096 * 40, 40)):
            sizes = (b, 4096, 8, 40, 320)
            hl._confirm(1, sizes, strides, hl._card_plan(hl.merge_plan, 0, *sizes, strides))
    g = torch.Generator(device=dev).manual_seed(8)
    x, w = _rnd(g, dev, 2, 64, 320), _rnd(g, dev, 96, 320)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="multiples of 64"):
        hl.proj_split(x, [w], 2)  # 96 output columns: no column tile
    assert kernels.LAUNCHES == {}


@pytest.mark.cuda
def test_fused_route_launches_head_layout_kernels(dev, monkeypatch):
    """FUSED_PROJ on: a ds1-shaped attention goes through proj_split (q, then
    k/v), the flash kernel and merge_proj, and agrees with the unfused
    route."""
    from instancediffusion_tpu_torch.models import unet as punet

    g = torch.Generator(device=dev).manual_seed(5)
    mod = punet.MHA(320, 320, 320, generator=g, device=dev).to(torch.bfloat16)
    x = _rnd(g, dev, 2, 4096, 320)
    unfused = punet._apply_mha(mod, x, x, 8, "kernel")
    monkeypatch.setattr(punet, "FUSED_PROJ", True)
    kernels.reset_launch_counts()
    fused = punet._apply_mha(mod, x, x, 8, "kernel")
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"proj_split": 2, "flash_attention": 1, "merge_proj": 1}
    err = (fused.float() - unfused.float()).abs().max()
    assert err <= 2 * REL_TOL * unfused.float().abs().max()


@pytest.mark.cuda
def test_nn_dispatch_launches_kernels_outside_plain_kernels(dev):
    """On a bf16 CUDA tensor the layer functions go through the kernels,
    and only plain_kernels() keeps them off."""
    x = torch.randn(2, 64, 320, device=dev).bfloat16()
    gn, ln = pnn.Norm(320, device=dev), pnn.Norm(320, device=dev)
    kernels.reset_launch_counts()
    pnn.group_norm(gn, x, act="silu")
    pnn.layer_norm(ln, x)
    assert kernels.LAUNCHES == {"fused_group_norm": 1, "fused_layer_norm": 1}
    with pnn.plain_kernels():
        pnn.group_norm(gn, x, act="silu")
        pnn.layer_norm(ln, x)
    assert sum(kernels.LAUNCHES.values()) == 2


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(dev):
    kernels.reset_launch_counts()
    x16 = torch.zeros(1, 64, 64, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="got torch.float16"):
        norms.fused_layer_norm(x16, torch.ones(64), torch.zeros(64))
    with pytest.raises(ValueError, match="got torch.float32"):
        norms.fused_group_norm(x16.float(), torch.ones(64), torch.zeros(64))
    q = torch.zeros(1, 2, 64, 36, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.flash_attention(q, q, q)
    x = torch.zeros(2, 8, 96, device=dev, dtype=torch.bfloat16)
    w1 = torch.zeros(768, 96, device=dev, dtype=torch.bfloat16)
    w2 = torch.zeros(96, 384, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="does not fit the kernel"):
        ff.fused_ff_geglu(x, w1, torch.zeros(768), w2, torch.zeros(96))
    with pytest.raises(ValueError, match="multiples of 64"):
        hl.proj_split(x, [w1[:96]], 4)
    with pytest.raises(ValueError, match="multiples of 64"):
        hl.merge_proj(x.reshape(2, 8, 4, 24).transpose(1, 2), w1[:96])
    assert sum(kernels.LAUNCHES.values()) == 0


# ---------------------------------------------------------------------------
# the redesigned forward attention (TMA, wgmma) and GroupNorm kernels
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["self", "fuser", "fuser_kv_len", "labeled", "packed",
                                  "packed_c64"])
def test_flash_forward_at_main_batch_on_card(dev, case):
    """K1 / K1-L / K2 at the UNet's B=16: ds1 self, the 4280-key fuser
    (unpadded, and pre-padded to 4608 with kv_len), the labeled fuser (META-
    like boxes on half the batch) and the packed ds2 fuser; and K2 at the
    SDXL refiner's ds2 self-attention, 12 heads of 64 (one 64-column box a
    head)."""
    g = torch.Generator(device=dev).manual_seed(6)
    b = 16
    if case.startswith("packed"):
        h, c, m = (12, 64, 1024) if case == "packed_c64" else (8, 80, 1208)
        q = _rnd(g, dev, b, 1024, h * c)
        k, v = _rnd(g, dev, b, m, h * c), _rnd(g, dev, b, m, h * c)
        kern = lambda: fa.flash_attention_packed(q, k, v, h)
        ref = sdpa_fp32(_heads(q, h), _heads(k, h), _heads(v, h)).transpose(1, 2).reshape(
            b, 1024, h * c)
    else:
        m = {"self": 4096, "fuser": 4280, "fuser_kv_len": 4608, "labeled": 4280}[case]
        kv = 4280 if case == "fuser_kv_len" else m
        q, k, v = (_heads(_rnd(g, dev, b, s, 320), 8) for s in (4096, m, m))
        labels = mask = None
        if case == "labeled":
            bits, open_ = _box_labels(dev, 64)
            labels = (bits.repeat_interleave(8, 0), open_.repeat_interleave(8, 0))
            mask = labels_to_dense(*labels)[:, :, :4096, :kv]
        kern = lambda: fa.flash_attention(q, k, v, labels=labels, kv_len=kv)
        ref = sdpa_fp32(q, k[:, :, :kv], v[:, :, :kv], mask=mask)
    kernels.reset_launch_counts()
    out = kern()
    torch.cuda.synchronize()
    plans = int(case == "labeled")  # a labeled call launches its tile plan first
    assert kernels.LAUNCHES["flash_tile_plan"] == plans
    assert sum(kernels.LAUNCHES.values()) == 1 + plans
    assert out.shape == ref.shape and torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max() <= REL_TOL * ref.float().abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("c", [8, 16, 24, 40, 64, 80, 128])
def test_flash_forward_head_dims_on_card(dev, c):
    """Every head-dim class the kernel takes (one or two 64-column atoms, a
    depth padded to 16), on ragged lengths (N and kv_len off the 128-row
    tiles, a single key tile), with and without log-sum-exp."""
    g = torch.Generator(device=dev).manual_seed(c)
    q = _heads(_rnd(g, dev, 2, 200, 3 * c), 3)
    k, v = (_heads(_rnd(g, dev, 2, 333, 3 * c), 3) for _ in range(2))
    for m in (333, 77):
        out = fa.flash_attention(q, k, v, kv_len=m)
        ref = sdpa_fp32(q, k[:, :, :m], v[:, :, :m])
        assert (out.float() - ref.float()).abs().max() <= REL_TOL * ref.float().abs().max()
    out, lse = fa.flash_attention_fwd_lse(q, k, v)
    pout, plse = fa.flash_attention_fwd_lse_plain(q, k, v)
    assert (out.float() - pout.float()).abs().max() <= REL_TOL * pout.float().abs().max()
    assert (lse - plse).abs().max() <= LSE_ATOL


@pytest.mark.cuda
def test_labeled_fully_masked_rows_on_card(dev):
    """q rows 128..255 see 128 keys, none open, none sharing their instance
    bit and none their own position: output 0 and lse -inf, not NaN, on the
    inference and the training forward; the rows before are attended."""
    g = torch.Generator(device=dev).manual_seed(8)
    q = _heads(_rnd(g, dev, 2, 256, 80), 2)
    k, v = (_heads(_rnd(g, dev, 2, 128, 80), 2) for _ in range(2))
    pos = torch.arange(256, device=dev)
    bits = torch.where(pos < 128, 1, 4).int().expand(2, 256).contiguous()
    open_ = torch.zeros(2, 256, dtype=torch.int32, device=dev)
    out = fa.flash_attention(q, k, v, labels=(bits, open_))
    out2, lse = fa.flash_attention_fwd_lse(q, k, v, (bits, open_))
    torch.cuda.synchronize()
    for o in (out, out2):
        assert torch.isfinite(o.float()).all()
        assert not o[:, :, 128:].any() and o[:, :, :128].abs().amax() > 0
    assert bool((lse[:, :, 128:] == -float("inf")).all()) and torch.isfinite(lse[:, :, :128]).all()
    pout, plse = fa.flash_attention_fwd_lse_plain(q, k, v, (bits, open_))
    assert (out2.float() - pout.float()).abs().max() <= REL_TOL * pout.float().abs().max()
    assert torch.equal(torch.isinf(lse), torch.isinf(plse))


# ---------------------------------------------------------------------------
# the labeled kernel's tile plan (the pre-pass) and the tiles it skips
# ---------------------------------------------------------------------------


def _mis_mix_labels(dev, size=64):
    """(bits, open) of the B=80 masked MIS call: 8 rows with META-like
    boxes (the images' global trajectories), 32 with one of those boxes
    each (the instances' own), 40 open (the CFG null half)."""
    import chip_smoke

    return chip_smoke.mis_mix_labels(torch, dev, BOXES + [[0.02, 0.55, 0.98, 0.98]], size)


def _plan_layouts(dev):
    """(labels, n, kv_len) of the layouts the device plan is checked on."""
    late = _late_labels(dev, 2304, 1024)
    pos = torch.arange(256, device=dev)
    no_keys = (torch.where(pos < 128, 1, 4).int().expand(2, 256).contiguous(),
               torch.zeros(2, 256, dtype=torch.int32, device=dev))
    padded = tuple(torch.nn.functional.pad(t, (0, 328)) for t in _box_labels(dev, 64))
    return [(_mis_mix_labels(dev), 4096, 4280), (_box_labels(dev, 32), 1024, 1208),
            (late, 2048, 2100), (no_keys, 256, 128), (padded, 4096, 4280),
            (tuple(t[:, :4281] for t in _box_labels(dev, 64, seg_tokens=65)), 4096, 4281)]


@pytest.mark.cuda
def test_tile_plan_kernel_matches_plain_on_card(dev):
    """The pre-pass's plans and label words equal `tile_plan_plain` and
    `label_words_plain` exactly: the MIS mix, a ds2 raster, late labels,
    rows with no kept key, labels pre-padded past kv_len, and a ragged
    4281-wide row padded to the 16-byte stride."""
    for labels, n, kv_len in _plan_layouts(dev):
        plan, words = fa.tile_plan(labels, n, kv_len)
        torch.cuda.synchronize()
        cpu = tuple(t.cpu() for t in labels)
        assert torch.equal(plan.cpu(), fa.tile_plan_plain(*cpu, n, kv_len)), (n, kv_len)
        width = cpu[0].shape[1]
        assert words.shape[1] == -(-width // 4) * 4
        assert torch.equal(words[:, :width].cpu(), fa.label_words_plain(*cpu))


@pytest.mark.cuda
@pytest.mark.parametrize("lse", [False, True], ids=["k1l", "k6l"])
def test_labeled_kernel_at_the_mis_mix_on_card(dev, lse):
    """K1-L (and K6-L, the training forward with lse) at the B=80 masked MIS
    call: 40 open rows, 8 four-instance and 32 one-instance rows, ds1's
    4096 x 4280 fuser, against plain fp32 in slices of 8 rows."""
    g = torch.Generator(device=dev).manual_seed(19)
    labels = _mis_mix_labels(dev)
    q, k, v = (_heads(_rnd(g, dev, 80, s, 320), 8) for s in (4096, 4280, 4280))
    kernels.reset_launch_counts()
    if lse:
        out, got_lse = fa.flash_attention_fwd_lse(q, k, v, labels)
    else:
        out = fa.flash_attention(q, k, v, labels=labels)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["flash_attention_trainable_labeled" if lse
                            else "flash_attention_labeled"] == 1
    assert kernels.LAUNCHES["flash_tile_plan"] == 1
    for r in range(0, 80, 8):
        sl = tuple(t[r:r + 8] for t in labels)
        if lse:
            ref, ref_lse = fa.flash_attention_fwd_lse_plain(q[r:r + 8], k[r:r + 8], v[r:r + 8], sl)
            assert (got_lse[r:r + 8] - ref_lse).abs().max() <= LSE_ATOL
        else:
            ref = sdpa_fp32(q[r:r + 8], k[r:r + 8], v[r:r + 8],
                            mask=labels_to_dense(*sl)[:, :, :4096, :4280])
        got = out[r:r + 8].float()
        assert torch.isfinite(got).all()
        assert (got - ref.float()).abs().max() <= REL_TOL * ref.float().abs().max()


@pytest.mark.cuda
def test_labeled_kernel_mixed_open_rows_on_card(dev):
    """Open rows among closed ones in a warpgroup (positions 1000-1029 of
    both samples, 3000-3099 of the second): that warpgroup takes the full
    test on its word tiles; against plain, forward and lse."""
    g = torch.Generator(device=dev).manual_seed(21)
    bits, open_ = _box_labels(dev, 64)
    open_ = open_.clone()
    open_[:, 1000:1030] = 1
    open_[1, 3000:3100] = 1
    q, k, v = (_heads(_rnd(g, dev, 2, s, 320), 8) for s in (4096, 4280, 4280))
    out = fa.flash_attention(q, k, v, labels=(bits, open_))
    out2, lse = fa.flash_attention_fwd_lse(q, k, v, (bits, open_))
    ref, ref_lse = fa.flash_attention_fwd_lse_plain(q, k, v, (bits, open_))
    for o in (out, out2):
        assert (o.float() - ref.float()).abs().max() <= REL_TOL * ref.float().abs().max()
    assert (lse - ref_lse).abs().max() <= LSE_ATOL


@pytest.mark.cuda
def test_labeled_kernel_graph_replays_bit_equal_on_card(dev):
    """The plan and the kernel inside a CUDA graph (as the masked MIS
    variant captures them): a replay on new q, k, v and labels equals the
    eager call bit for bit, and adds to the tile counters as the eager call
    does."""
    g = torch.Generator(device=dev).manual_seed(20)
    labels = [_mis_mix_labels(dev)[0][:16].clone(), _mis_mix_labels(dev)[1][:16].clone()]
    q, k, v = (_heads(_rnd(g, dev, 16, s, 320), 8) for s in (4096, 4280, 4280))
    fa.flash_attention(q, k, v, labels=tuple(labels))  # warm-up: the counter, the library
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = fa.flash_attention(q, k, v, labels=tuple(labels))
    new = [_rnd(g, dev, 16, s, 320) for s in (4096, 4280, 4280)]
    other = fa.instance_labels(rasterize_boxes(torch.rand(16, 30, 4, device=dev).sort(-1)[0], 64),
                               30, 64)
    for t, src in zip((q, k, v), new):
        t.copy_(_heads(src, 8))
    for t, src in zip(labels, other):
        t.copy_(src)
    kernels.reset_launch_counts()
    graph.replay()
    torch.cuda.synchronize()
    replayed, counted = static_out.clone(), fa.label_tile_share()
    kernels.reset_launch_counts()
    eager = fa.flash_attention(q, k, v, labels=tuple(labels))
    torch.cuda.synchronize()
    assert torch.equal(replayed, eager)
    assert counted == fa.label_tile_share() and counted[1] == 16 * 32 * 34


@pytest.mark.cuda
def test_label_tile_share_counts_a_hand_built_case_on_card(dev):
    """Two rows of 256 positions, 256 keys (2 q blocks x 2 tiles each): row
    0 all open lists 4 tiles; row 1 holds instance 1 on positions 0-127 and
    instance 2 on 128-255, nothing open, so each q block lists its own tile
    alone: 6 of 8 tiles. A second call adds as much; reset_launch_counts
    zeroes the pair."""
    bits = torch.tensor([[0] * 256, [1] * 128 + [2] * 128], dtype=torch.int32, device=dev)
    open_ = torch.tensor([[1] * 256, [0] * 256], dtype=torch.int32, device=dev)
    q = _heads(_rnd(torch.Generator(device=dev).manual_seed(3), dev, 2, 256, 80), 2)
    kernels.reset_launch_counts()
    fa.flash_attention(q, q, q, labels=(bits, open_))
    assert fa.label_tile_share() == (6, 8)
    fa.flash_attention_fwd_lse(q, q, q, (bits, open_))
    assert fa.label_tile_share() == (12, 16)
    kernels.reset_launch_counts()
    assert fa.label_tile_share() == (0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 4096, 320), (16, 4096, 640), (16, 64, 2560),
                                   (16, 1024, 1920), (8, 262144, 128), (2, 7, 64),
                                   (16, 256, 3072), (16, 64, 3072), (16, 256, 2304),
                                   (16, 1024, 2304), (16, 4096, 1152), (2, 16384, 384)],
                         ids=lambda s: "x".join(map(str, s)))
def test_group_norm_main_shapes_on_card(dev, shape):
    """K3 at the ds1 (320 and 640 channels), ds8 and ds2 (1920) rows, the
    VAE decoder's largest rows and a sample with fewer rows than blocks,
    and at the SDXL refiner's rows (its decoder's 3072- and 2304-channel
    joins, the wide form above 2560; ds1 at 1024 px), with the affine in
    bf16 (as the modules keep it) and in fp32."""
    g = torch.Generator(device=dev).manual_seed(9)
    b, n, c = shape
    x = _rnd(g, dev, b, n, c, std=3.0) + 0.5
    for dtype in (torch.bfloat16, torch.float32):
        sc = torch.randn(c, generator=g, device=dev).to(dtype)
        bi = torch.randn(c, generator=g, device=dev).to(dtype)
        kernels.reset_launch_counts()
        y = norms.fused_group_norm(x, sc, bi, 32, 1e-6, "silu")
        torch.cuda.synchronize()
        assert kernels.LAUNCHES == {"fused_group_norm": 1}
        ref = norms.group_norm_plain(x, sc, bi, 32, 1e-6, "silu")
        assert (y.float() - ref.float()).abs().max() <= REL_TOL * ref.float().abs().max()


# ---------------------------------------------------------------------------
# training kernels and gradients
# ---------------------------------------------------------------------------
# bf16 gradients: ds and p are rounded to bf16 before their products, so
# max |kernel - plain| <= 2e-2 * max |plain|; lse is fp32 (1e-3 absolute,
# in base 2).
GRAD_REL_TOL = 2e-2
LSE_ATOL = 1e-3


def _train_case(dev, n, m, c, labels=None, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (_heads(_rnd(g, dev, 2, s, 2 * c), 2) for s in (n, m, m, n))
    return q, k, v, do, labels


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["self", "ragged", "labeled", "labeled_late"])
def test_training_kernels_match_plain_on_card(dev, case):
    """K6 (out, lse), dq and dk/dv against their plain versions, on
    strided head views, unlabeled, ragged (N, M not tile multiples) and
    labeled (box labels; late labels whose first key tiles are masked)."""
    n, m, c, labels = {
        "self": (256, 256, 40, None),
        "ragged": (200, 77 + 64, 80, None),
        "labeled": (1024, 1208, 40, _box_labels(dev, 32)),
        "labeled_late": (384, 400, 40, _late_labels(dev, 400, 256)),
    }[case]
    q, k, v, do, labels = _train_case(dev, n, m, c, labels)
    kernels.reset_launch_counts()
    out, lse = fa.flash_attention_fwd_lse(q, k, v, labels)
    dq = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, labels)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, out, lse, do, labels)
    torch.cuda.synchronize()
    sfx = "" if labels is None else "_labeled"
    assert kernels.LAUNCHES == {f"flash_attention_trainable{sfx}": 1,
                                f"flash_attention_bwd_dq{sfx}": 1,
                                f"flash_attention_bwd_dkv{sfx}": 1,
                                **({} if labels is None else {"flash_tile_plan": 1})}
    pout, plse = fa.flash_attention_fwd_lse_plain(q, k, v, labels)
    assert (out.float() - pout.float()).abs().max() <= REL_TOL * pout.float().abs().max()
    assert (lse - plse).abs().max() <= LSE_ATOL
    for got, want in zip((dq, dk, dv), fa.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                                     labels)):
        assert got.shape == want.shape and torch.isfinite(got.float()).all()
        assert (got.float() - want.float()).abs().max() <= GRAD_REL_TOL * want.float().abs().max()


def _bwd_against_plain(q, k, v, do, labels):
    """dq (with the kernel's delta), dk/dv against flash_attention_bwd_plain
    on the kernel forward's residuals; returns the kernels' (dq, dk, dv)."""
    out, lse = fa.flash_attention_fwd_lse(q, k, v, labels)
    kernels.reset_launch_counts()
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, labels, with_delta=True)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, out, lse, do, labels)
    torch.cuda.synchronize()
    sfx = "" if labels is None else "_labeled"
    assert kernels.LAUNCHES == {f"flash_attention_bwd_dq{sfx}": 1,
                                f"flash_attention_bwd_dkv{sfx}": 1}
    want_delta = fa._delta(out, do)
    assert (delta - want_delta).abs().max() <= 1e-5 * want_delta.abs().max()
    got = (dq, dk, dv)
    for g_, want in zip(got, fa.flash_attention_bwd_plain(q, k, v, out, lse, do, labels)):
        assert g_.shape == want.shape and torch.isfinite(g_.float()).all()
        assert (g_.float() - want.float()).abs().max() <= GRAD_REL_TOL * want.float().abs().max()
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("labeled", [False, True], ids=["plain", "labeled"])
@pytest.mark.parametrize("n, m, c", [(1000, 1208, 80), (4096, 4280, 40), (1000, 1208, 40),
                                     (333, 77, 80)])
def test_backward_kernels_ragged_head_views_on_card(dev, n, m, c, labeled):
    """dq and dk/dv on head views of (B,N,8*c) projections (not contiguous
    copies) with N and kv_len off every tile (4280 = 33*128 + 56, 1208 =
    9*128 + 56, 77 keys: one ragged tile), unlabeled and under box labels
    (sample 0 masked, sample 1 open), against the plain version; the
    kernel's delta against `_delta`."""
    g = torch.Generator(device=dev).manual_seed(n + m + c)
    q, do = (_heads(_rnd(g, dev, 2, n, 8 * c), 8) for _ in range(2))
    k, v = (_heads(_rnd(g, dev, 2, m, 8 * c), 8) for _ in range(2))
    assert not q.is_contiguous() and q.stride(1) == c
    labels = None
    if labeled:
        bits, open_ = _box_labels(dev, 64 if n >= 4096 else 32)
        length = max(n, m)
        labels = (_label_cols(bits, length), _label_cols(open_, length))
    _bwd_against_plain(q, k, v, do, labels)


def _label_cols(t, length):
    """Label rows cut or padded (closed, no instance) to `length` positions."""
    t = t[:, :length]
    return torch.nn.functional.pad(t, (0, length - t.shape[1]))


@pytest.mark.cuda
def test_backward_labeled_row_without_keys_on_card(dev):
    """q rows 128..255 keep no key (none open, no shared instance bit, their
    own positions past the keys): lse -inf, and dq 0 and finite there, not
    NaN; dk/dv finite and equal to the plain version."""
    g = torch.Generator(device=dev).manual_seed(12)
    q, do = (_heads(_rnd(g, dev, 2, 256, 80), 2) for _ in range(2))
    k, v = (_heads(_rnd(g, dev, 2, 128, 80), 2) for _ in range(2))
    pos = torch.arange(256, device=dev)
    bits = torch.where(pos < 128, 1, 4).int().expand(2, 256).contiguous()
    open_ = torch.zeros(2, 256, dtype=torch.int32, device=dev)
    dq, dk, dv = _bwd_against_plain(q, k, v, do, (bits, open_))
    assert not dq[:, :, 128:].any() and dq[:, :, :128].abs().amax() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["all_open", "all_closed"])
def test_backward_all_open_and_all_closed_labels_on_card(dev, rows):
    """Every position open (the CFG null half: the warpgroups skip the
    labels, the result equals the unlabeled kernels' bit for bit), or every
    position closed with bit (position mod 30) (each q row keeps one key in
    30: the labeled steps on every tile)."""
    g = torch.Generator(device=dev).manual_seed(13)
    q, do = (_heads(_rnd(g, dev, 2, 1000, 320), 8) for _ in range(2))
    k, v = (_heads(_rnd(g, dev, 2, 1208, 320), 8) for _ in range(2))
    if rows == "all_open":
        bits = torch.zeros(2, 1208, dtype=torch.int32, device=dev)
        open_ = torch.ones(2, 1208, dtype=torch.int32, device=dev)
    else:
        bits = (1 << (torch.arange(1208, device=dev) % 30)).int().expand(2, 1208).contiguous()
        open_ = torch.zeros(2, 1208, dtype=torch.int32, device=dev)
    got = _bwd_against_plain(q, k, v, do, (bits, open_))
    if rows == "all_open":
        plain = _bwd_against_plain(q, k, v, do, None)
        for a, b in zip(got, plain):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_plain_route_cross_attention_scores_on_tensor_cores(dev):
    """The plain route's ds1 cross-attention (B=16, 8 heads of 40, 77 keys,
    bf16) as the UNet calls it: no SIMT fp32 GEMM (cuBLAS `sgemm`, MAGMA's
    `magma_sgemmEx`) among its kernels, and the result of the unpadded fp32
    product."""
    from torch.profiler import ProfilerActivity, profile

    from instancediffusion_tpu_torch.ops.attention import sdpa_xla

    g = torch.Generator(device=dev).manual_seed(14)
    q = _heads(_rnd(g, dev, 16, 4096, 320), 8)
    k, v = (_heads(_rnd(g, dev, 16, 77, 320), 8) for _ in range(2))
    sdpa_xla(q, k, v)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = sdpa_xla(q, k, v)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.device_time_total > 0]
    assert names
    assert not [n for n in names if any(w in n.lower() for w in ("sgemm", "magma", "simt"))]
    ref = sdpa_fp32(q, k, v)
    assert (out.float() - ref.float()).abs().max() <= 2 * REL_TOL * ref.float().abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("labeled", [False, True])
def test_trainable_attention_autograd_on_card(dev, labeled):
    """flash_attention_trainable(_labeled) under autograd: the kernels'
    gradients against autograd of the plain attention (sdpa_fp32)."""
    labels = _box_labels(dev, 32) if labeled else None
    q, k, v, do, _ = _train_case(dev, 1024, 1208, 40, seed=1)
    ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
    refs = [t.detach().requires_grad_(True) for t in (q, k, v)]
    if labeled:
        out = fa.flash_attention_trainable_labeled(*ins, *labels)
        ref = sdpa_fp32(*refs, mask=labels_to_dense(*labels)[:, :, :1024, :1208])
    else:
        out = fa.flash_attention_trainable(*ins)
        ref = sdpa_fp32(*refs)
    out.backward(do)
    ref.backward(do)
    for a, b in zip(ins, refs):
        assert (a.grad.float() - b.grad.float()).abs().max() <= GRAD_REL_TOL * b.grad.float().abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["group_norm", "layer_norm", "ff_geglu"])
def test_norm_and_geglu_autograd_on_card(dev, kind):
    """K3-K5 under autograd: the kernel forward and the recomputed plain
    backward against autograd of the plain version."""
    g = torch.Generator(device=dev).manual_seed(2)
    x = _rnd(g, dev, 2, 256, 320, std=2.0)
    if kind == "ff_geglu":
        args = [x, _rnd(g, dev, 2560, 320, std=320 ** -0.5),
                torch.randn(2560, generator=g, device=dev) * 0.1,
                _rnd(g, dev, 320, 1280, std=1280 ** -0.5),
                torch.randn(320, generator=g, device=dev) * 0.1]
        kern, plain = ff.fused_ff_geglu, ff.ff_geglu_plain
    else:
        args = [x, torch.randn(320, generator=g, device=dev), torch.randn(320, generator=g,
                                                                           device=dev)]
        kern, plain = ((lambda *a: norms.fused_group_norm(*a, 32, 1e-5, "silu"),
                        lambda *a: norms.group_norm_plain(*a, 32, 1e-5, "silu"))
                       if kind == "group_norm" else (norms.fused_layer_norm, norms.layer_norm_plain))
    dy = _rnd(g, dev, 2, 256, 320)
    a = [t.detach().requires_grad_(True) for t in args]
    b = [t.detach().requires_grad_(True) for t in args]
    kernels.reset_launch_counts()
    kern(*a).backward(dy)
    assert sum(kernels.LAUNCHES.values()) == 1
    plain(*b).backward(dy)
    for ta, tb in zip(a, b):
        assert torch.isfinite(ta.grad.float()).all()
        assert (ta.grad.float() - tb.grad.float()).abs().max() <= REL_TOL * tb.grad.float().abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_tiny_train_step_on_card(dev, masked):
    """One bf16 train step at a small config whose attention is long enough
    for the kernels (1024 visual tokens, head dim 8): the trainable
    parameters get finite gradients, every trainable group a non-zero
    one, frozen parameters none; the step goes through the kernels."""
    import numpy as np

    from instancediffusion_tpu_torch.config import load_config
    from instancediffusion_tpu_torch.ops.schedules import make_diffusion_schedule
    from instancediffusion_tpu_torch.train import optimizer as popt
    from instancediffusion_tpu_torch.train import train_step as pts

    gcfg = dict(in_dim=64, out_dim=64, mid_dim=64, fourier_freqs=4, fourier_freqs_polygons=4,
                n_scribble_points=4, n_polygon_points=8, seg_channels=4, seg_resize_input=64,
                convnext_depths=(1, 1), convnext_dims=(32, 64), convnext_feature_dim=4096)
    cfg = load_config(overrides=dict(
        model=dict(image_size=32, model_channels=64, num_heads=8, context_dim=64, max_objs=4,
                   grounding_tokenizer=gcfg, channel_mult=(1,), num_res_blocks=1,
                   attention_resolutions=(1,), use_masked_att=masked),
        autoencoder=dict(ch=32, ch_mult=(1, 2), resolution=64),
        text_encoder=dict(vocab_size=512, hidden_size=64, intermediate_size=128,
                          num_hidden_layers=1, num_attention_heads=4)))
    state = pts.init_train_state(cfg, seed=0, device=dev)
    for name, p in state.unet.named_parameters():  # no zero-initialised gate
        if any(k in name for k in ("alpha", "scaleu", "out.conv", "out_conv", "proj_out")):
            p.data.normal_(0, 0.5, generator=torch.Generator(device=dev).manual_seed(len(name)))
    state.optimizer, state.scheduler = popt.make_optimizer(state.unet, 1e-4, warmup_steps=0)
    state = pts.cast_frozen_bf16(state)
    r = np.random.default_rng(0)
    b, n = 2, 4
    batch = {"image": r.standard_normal((b, 64, 64, 3)), "boxes": np.concatenate(
        [r.uniform(0, .4, (b, n, 2)), r.uniform(.5, 1, (b, n, 2))], -1),
        "masks": np.ones((b, n)), "text_embeddings": r.standard_normal((b, n, 64)),
        "scribbles": r.uniform(0, 1, (b, n, 8)), "polygons": r.uniform(0, 1, (b, n, 16)),
        "segs": (r.uniform(size=(b, n, 64, 64)) > 0.5), "points": r.uniform(0, 1, (b, n, 2))}
    batch = {k: torch.as_tensor(np.asarray(v, np.float32), device=dev) for k, v in batch.items()}
    batch["caption_ids"] = torch.as_tensor(r.integers(0, 512, (b, 77)), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    draws = pts.sample_draws(gen, b, pts.latent_shape(cfg, 64))
    draws.drop_all = False
    kernels.reset_launch_counts()
    loss = pts.make_loss_fn(cfg, make_diffusion_schedule())(state, batch, draws)
    loss.backward()
    torch.cuda.synchronize()
    sfx = "_labeled" if masked else ""
    for name in (f"flash_attention_trainable{sfx}", f"flash_attention_bwd_dq{sfx}",
                 f"flash_attention_bwd_dkv{sfx}", "fused_group_norm", "fused_layer_norm",
                 "fused_ff_geglu"):
        assert kernels.LAUNCHES[name] > 0, (name, dict(kernels.LAUNCHES))
    assert torch.isfinite(loss)
    groups = {}
    for name, p in state.unet.named_parameters():
        if not popt.is_trainable(name):
            assert p.grad is None, name
            continue
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        key = "fuser" if "fuser" in name else name.split(".")[0]
        groups[key] = groups.get(key, 0.0) + p.grad.float().pow(2).sum().item()
    assert set(groups) == {"fuser", "position_net", "scaleu"}
    assert all(v > 0 for v in groups.values()), groups


# ---------------------------------------------------------------------------
# the redesigned GEGLU feed-forward (TMA, wgmma) and LayerNorm kernels; the
# routes by shape and dtype; GroupNorm over batch chunks
# ---------------------------------------------------------------------------


def _ff_case(g, dev, m, c, bias_dtype):
    inner = 4 * c
    return [_rnd(g, dev, m, c), _rnd(g, dev, 2 * inner, c, std=c ** -0.5),
            _rnd(g, dev, 2 * inner, std=0.1).to(bias_dtype),
            _rnd(g, dev, c, inner, std=inner ** -0.5), _rnd(g, dev, c, std=0.1).to(bias_dtype)]


@pytest.mark.cuda
@pytest.mark.parametrize("bias_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("batch", [2, 16])
@pytest.mark.parametrize("level", ["ds1", "ds2", "ds4", "ds8", "refiner_ds2", "refiner_ds4"])
def test_ff_geglu_levels_on_card(dev, level, batch, bias_dtype):
    """Every transformer FF of the UNet through the one switch: ds1 and ds2
    (C=640, clusters of two blocks) launch the fused kernel once, ds4 and
    ds8 (C=1280) take the unfused route; the SDXL refiner's ds2 (C=768,
    clusters of three) the kernel and its ds4 (C=1536) the unfused route;
    both within tolerance of the fp32 plain version, biases bf16 or fp32 as
    stored, and the kernel bitwise equal across two runs."""
    n, c = {"ds1": (4096, 320), "ds2": (1024, 640), "ds4": (256, 1280), "ds8": (64, 1280),
            "refiner_ds2": (1024, 768), "refiner_ds4": (256, 1536)}[level]
    args = _ff_case(torch.Generator(device=dev).manual_seed(3), dev, batch * n, c, bias_dtype)
    args[0] = args[0].reshape(batch, n, c)
    kernels.reset_launch_counts()
    out = ff.ff_geglu(*args)
    torch.cuda.synchronize()
    fits = ff.ff_fits(batch * n, c, 4 * c)
    assert fits == (c in (320, 640, 768))
    assert kernels.LAUNCHES["fused_ff_geglu"] == int(fits)
    assert kernels.ROUTES["ff_geglu_unfused"] == int(not fits)
    ref = ff.ff_geglu_plain(*args).float()
    assert out.shape == ref.shape and torch.isfinite(out.float()).all()
    # the unfused route also rounds a, g and the first product to bf16
    tol = REL_TOL if fits else 2 * REL_TOL
    assert (out.float() - ref).abs().max().item() <= tol * ref.abs().max().item()
    assert torch.equal(out, ff.ff_geglu(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("m, c", [(8229, 320), (2053, 320), (77, 320), (1, 320), (200, 128),
                                  (130, 64), (2053, 640), (19328, 640), (1, 640), (2053, 768),
                                  (77, 768), (1, 768)])
def test_ff_geglu_ragged_rows_on_card(dev, m, c):
    """Row counts off the cluster's 64 rows: the last row tile's missing rows
    are read as zero and never stored."""
    args = _ff_case(torch.Generator(device=dev).manual_seed(4), dev, m, c, torch.float32)
    guard = torch.full((m + 256, c), 7.0, device=dev, dtype=torch.bfloat16)
    out = ff.fused_ff_geglu(*args)
    ref = ff.ff_geglu_plain(*args).float()
    assert (out.float() - ref).abs().max().item() <= REL_TOL * ref.abs().max().item()
    assert bool((guard == 7.0).all())
    assert torch.equal(out, ff.fused_ff_geglu(*args))


@pytest.mark.cuda
def test_ff_geglu_kernel_refuses_what_does_not_fit(dev):
    """Called directly, the kernel wrapper raises on a width it was not built
    for; only `ff_geglu` routes."""
    kernels.reset_launch_counts()
    for c in (960, 1280):
        args = _ff_case(torch.Generator(device=dev).manual_seed(5), dev, 64, c, torch.bfloat16)
        with pytest.raises(ValueError, match="does not fit"):
            ff.fused_ff_geglu(*args)
    with pytest.raises(ValueError, match="got torch.float32"):
        ff.fused_ff_geglu(*(a.float() for a in
                            _ff_case(torch.Generator(device=dev).manual_seed(5), dev, 64, 320,
                                     torch.float32)))
    assert sum(kernels.LAUNCHES.values()) == 0


# the B=16 LayerNorm rows of the UNet forward, CLIP's, and the fp32 ConvNeXt
# rows of the grounding tokenizer; a width off the vector size and one past
# eight vectors a lane (the generic loop)
LN_SHAPES = [(16 * 4096, 320, torch.bfloat16), (16 * 4280, 320, torch.bfloat16),
             (16 * 1024, 640, torch.bfloat16), (16 * 1208, 640, torch.bfloat16),
             (16 * 256, 1280, torch.bfloat16), (16 * 440, 1280, torch.bfloat16),
             (2 * 4096, 320, torch.bfloat16), (2 * 77, 768, torch.bfloat16),
             (16384, 96, torch.float32), (4096, 192, torch.float32), (1024, 384, torch.float32),
             (256, 768, torch.float32), (333, 100, torch.bfloat16), (100, 2560, torch.bfloat16),
             (5, 320, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("affine_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows, c, dtype", LN_SHAPES)
def test_layer_norm_shapes_on_card(dev, rows, c, dtype, affine_dtype):
    """K4 at every smoke shape with the affine as stored (bf16 or fp32): one
    launch, no cast, within tolerance of the plain version, bitwise equal
    across two runs, nothing written past the last row."""
    g = torch.Generator(device=dev).manual_seed(6)
    x = (torch.randn((rows, c), generator=g, device=dev) * 2.0 + 0.3).to(dtype)
    sc = torch.randn(c, generator=g, device=dev).to(affine_dtype)
    bi = torch.randn(c, generator=g, device=dev).to(affine_dtype)
    guard = torch.full((4096,), 7.0, device=dev, dtype=dtype)
    kernels.reset_launch_counts()
    out = norms.fused_layer_norm(x, sc, bi, 1e-5)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"fused_layer_norm": 1}
    ref = norms.layer_norm_plain(x, sc, bi, 1e-5).float()
    tol = REL_TOL if dtype == torch.bfloat16 else FP32_REL_TOL
    assert (out.float() - ref).abs().max().item() <= tol * ref.abs().max().item()
    assert bool((guard == 7.0).all())
    assert torch.equal(out, norms.fused_layer_norm(x, sc, bi, 1e-5))


@pytest.mark.cuda
@pytest.mark.parametrize("b, n, c", [(558, 64, 320), (600, 64, 1280), (558, 1024, 320),
                                     (600, 64, 3072)])
def test_group_norm_large_batch_on_card(dev, b, n, c):
    """A batch above the card's resident blocks (528 on an H100; 558 rows is
    generate at mis=0.36 with 30 instances and 9 images) runs in several
    cooperative launches and matches the plain version on every sample."""
    g = torch.Generator(device=dev).manual_seed(7)
    x = _rnd(g, dev, b, n, c, std=3.0) + 0.5
    sc, bi = _rnd(g, dev, c), _rnd(g, dev, c)
    plan = norms.gn_plan(b, n, c, torch.cuda.get_device_properties(dev).multi_processor_count)
    kernels.reset_launch_counts()
    out = norms.fused_group_norm(x, sc, bi, 32, 1e-5, "silu")
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"fused_group_norm": len(plan.launches(b))}
    assert len(plan.launches(b)) > 1
    ref = norms.group_norm_plain(x, sc, bi, 32, 1e-5, "silu").float()
    err = (out.float() - ref).abs().amax(dim=(1, 2))
    assert bool((err <= REL_TOL * ref.abs().max()).all()), err.max()


@pytest.mark.cuda
def test_fp32_compute_routes_plain_on_card(dev):
    """fp32 activations on the card: the layer functions and attention take
    the plain versions (LayerNorm's kernel keeps its fp32 rows), nothing
    raises; the kernel wrappers themselves still refuse fp32."""
    from instancediffusion_tpu_torch.ops.attention import multi_head_attention

    g = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn((2, 1024, 64), generator=g, device=dev)
    gn, ln = pnn.Norm(64, device=dev), pnn.Norm(64, device=dev)
    kernels.reset_launch_counts()
    y = pnn.group_norm(gn, x, act="silu")
    assert torch.equal(y, norms.group_norm_plain(x, gn.weight, gn.bias, 32, 1e-5, "silu"))
    out = multi_head_attention(x, x, x, 8, impl="kernel")
    assert torch.equal(out, multi_head_attention(x, x, x, 8, impl="plain"))
    pnn.layer_norm(ln, x)
    assert kernels.LAUNCHES == {"fused_layer_norm": 1}
    with pytest.raises(ValueError, match="got torch.float32"):
        norms.fused_group_norm(x, gn.weight, gn.bias)


def _tiny_card_pipe(dev, monkeypatch):
    """A tiny fp32 pipeline on the card with densified gates and output
    convs, and its two-instance meta; TF32 off."""
    from instancediffusion_tpu_torch.config import load_config
    from instancediffusion_tpu_torch.pipeline import InstanceDiffusionPipeline

    monkeypatch.setenv("IDTPU_ALLOW_HASH_TOKENIZER", "1")
    # full fp32 on both sides: cuDNN's TF32 convolutions (the default) pick
    # their algorithm per call and would differ by more than the kernels do
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    gcfg = dict(in_dim=64, out_dim=64, mid_dim=64, fourier_freqs=4, fourier_freqs_polygons=4,
                n_scribble_points=4, n_polygon_points=8, seg_channels=4, seg_resize_input=64,
                convnext_depths=(1, 1), convnext_dims=(32, 64), convnext_feature_dim=4096)
    cfg = load_config(overrides=dict(
        model=dict(image_size=32, model_channels=64, num_heads=8, context_dim=64, max_objs=4,
                   grounding_tokenizer=gcfg, channel_mult=(1, 2), num_res_blocks=1,
                   attention_resolutions=(1, 2)),
        autoencoder=dict(ch=32, ch_mult=(1, 2), resolution=64),
        text_encoder=dict(vocab_size=512, hidden_size=64, intermediate_size=128,
                          num_hidden_layers=1, num_attention_heads=4)))
    pipe = InstanceDiffusionPipeline.random_init(cfg, seed=0, device=dev, dtype=torch.float32)
    for name, p in pipe.unet.named_parameters():  # no zero-initialised gate or output conv
        if any(k in name for k in ("alpha", "scaleu", "out.conv", "out_conv", "proj_out")):
            p.data.normal_(0, 0.5, generator=torch.Generator(device=dev).manual_seed(len(name)))
    meta = {"prompt": "a cat and a dog", "phrases": ["a cat", "a dog"],
            "locations": [[0.1, 0.2, 0.5, 0.9], [0.5, 0.3, 0.9, 0.9]]}
    return pipe, meta


@pytest.mark.cuda
def test_tiny_fp32_generate_on_card(dev, monkeypatch):
    """A tiny fp32 pipeline (compute_dtype fp32, the JAX package's exact
    route) generates on the card: only LayerNorm's kernel launches, and the
    images match plain_kernels() within one uint8 level."""
    pipe, meta = _tiny_card_pipe(dev, monkeypatch)
    kernels.reset_launch_counts()
    imgs = pipe.generate(meta, num_images=2, steps=4, mis=0.0, seed=0)
    launched = {k for k, v in kernels.LAUNCHES.items() if v}
    assert launched == {"fused_layer_norm"}, dict(kernels.LAUNCHES)
    with pnn.plain_kernels():
        ref = pipe.generate(meta, num_images=2, steps=4, mis=0.0, seed=0)
    assert imgs.shape == ref.shape and imgs.dtype == ref.dtype
    assert int(imgs.max()) != int(imgs.min())
    assert abs(imgs.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("mis", [0.0, 0.5])
def test_tiny_capture_replays_bit_equal_on_card(dev, monkeypatch, tmp_path, mis):
    """enable_aot on the card: the first call of a variant captures a CUDA
    graph, later calls replay it; the images equal the eager calls bit for
    bit on new noise, the capture counted its launches, nothing fell back."""
    from instancediffusion_tpu_torch.pipeline import InstanceDiffusionPipeline

    pipe, meta = _tiny_card_pipe(dev, monkeypatch)
    eager = {s: pipe.generate(meta, num_images=2, steps=4, mis=mis, seed=s) for s in (0, 1, 2)}
    apipe = InstanceDiffusionPipeline(pipe.cfg, pipe.unet, pipe.vae, pipe.clip, pipe.tokenizer)
    apipe.enable_aot(str(tmp_path))
    for s in (0, 1, 2):
        np.testing.assert_array_equal(
            apipe.generate(meta, num_images=2, steps=4, mis=mis, seed=s), eager[s])
    stats = apipe._aot.stats
    assert (stats["captures"], stats["replays"], stats["fallbacks"]) == (1, 3, 0), \
        apipe._aot.errors
    [manifest] = apipe._aot.variants.values()
    assert manifest["launches"].get("fused_layer_norm", 0) > 0
    assert manifest["capture_s"] > 0 and manifest["pool_bytes"] >= 0


@pytest.mark.cuda
def test_pending_handle_owns_a_pinned_copy_on_card(dev, monkeypatch, tmp_path):
    """generate(block=False) under replay: each handle holds a pinned host
    copy and an event, so the next replay (which rewrites the graph's
    output buffer) leaves it alone."""
    from instancediffusion_tpu_torch.pipeline import InstanceDiffusionPipeline, PendingImages

    pipe, meta = _tiny_card_pipe(dev, monkeypatch)
    want = {s: pipe.generate(meta, num_images=2, steps=4, mis=0.0, seed=s) for s in (1, 2)}
    apipe = InstanceDiffusionPipeline(pipe.cfg, pipe.unet, pipe.vae, pipe.clip, pipe.tokenizer)
    apipe.enable_aot(str(tmp_path))
    apipe.generate(meta, num_images=2, steps=4, mis=0.0, seed=0)  # capture
    h1 = apipe.generate(meta, num_images=2, steps=4, mis=0.0, seed=1, block=False)
    h2 = apipe.generate(meta, num_images=2, steps=4, mis=0.0, seed=2, block=False)
    assert isinstance(h1, PendingImages) and h1.host_images.is_pinned()
    assert h1.event is not None and "fetch" not in h1.timings
    np.testing.assert_array_equal(h2.fetch(), want[2])
    np.testing.assert_array_equal(h1.fetch(), want[1])


# ---------------------------------------------------------------------------
# checkpoint files and the demo CLI on the card
# ---------------------------------------------------------------------------


def _ckpt_config():
    """A tiny config a reference-format checkpoint can fill (ConvNeXt-T in
    the seg branch) and the demo CLI can feed (20 scribble and 256 polygon
    points, 512x512 segs, up to 4 instances)."""
    from instancediffusion_tpu_torch.config import load_config

    gcfg = dict(in_dim=32, out_dim=32, mid_dim=32, fourier_freqs=4, fourier_freqs_polygons=4,
                n_scribble_points=20, n_polygon_points=256, seg_channels=4,
                seg_resize_input=512, convnext_feature_dim=3072)
    return load_config(overrides=dict(
        model=dict(image_size=8, model_channels=32, num_heads=4, context_dim=32, max_objs=4,
                   grounding_tokenizer=gcfg, channel_mult=(1,), num_res_blocks=1,
                   attention_resolutions=(1,), use_checkpoint=False),
        autoencoder=dict(ch=32, ch_mult=(1, 2), resolution=64),
        text_encoder=dict(vocab_size=512, hidden_size=32, intermediate_size=64,
                          num_hidden_layers=2, num_attention_heads=4)))


def _write_ckpt(path, cfg):
    import chip_smoke
    from instancediffusion_tpu_torch.io import checkpoint as ckpt_io
    from instancediffusion_tpu_torch.pipeline import InstanceDiffusionPipeline

    src = InstanceDiffusionPipeline.random_init(cfg, seed=0, device="cpu", dtype=torch.bfloat16,
                                                vae_encoder=True)
    for i, m in enumerate((src.unet, src.vae, src.clip)):
        chip_smoke.densify_(m, i + 1)
    torch.save(ckpt_io.reference_state_dict(src.unet, src.vae, src.clip), path)


@pytest.mark.cuda
def test_from_checkpoint_on_card_equals_cpu_load(dev, tmp_path):
    """from_checkpoint on the card gives bf16 CUDA weights equal to the
    same file loaded on the CPU."""
    from instancediffusion_tpu_torch.pipeline import InstanceDiffusionPipeline

    cfg = _ckpt_config()
    path = str(tmp_path / "tiny.pth")
    _write_ckpt(path, cfg)
    on_card = InstanceDiffusionPipeline.from_checkpoint(path, cfg, device=dev)
    on_cpu = InstanceDiffusionPipeline.from_checkpoint(path, cfg, device="cpu")
    assert on_card.device.type == "cuda" and on_card.dtype == torch.bfloat16
    for part in ("unet", "vae", "clip"):
        want = dict(getattr(on_cpu, part).named_parameters())
        for n, p in getattr(on_card, part).named_parameters():
            assert p.is_cuda and p.dtype == want[n].dtype == torch.bfloat16, n
            assert torch.equal(p.cpu(), want[n]), n


@pytest.mark.cuda
def test_cli_writes_pngs_from_the_card(dev, tmp_path, monkeypatch):
    """inference.main (device cuda by default) on a tiny checkpoint and the
    fox demo with --use_masks writes two images and the boxes image."""
    import os

    import numpy as np

    from instancediffusion_tpu_torch import inference
    from instancediffusion_tpu_torch.io.png import read_png

    cfg = _ckpt_config()
    path = str(tmp_path / "tiny.pth")
    _write_ckpt(path, cfg)
    monkeypatch.setenv("IDTPU_ALLOW_HASH_TOKENIZER", "1")
    monkeypatch.setattr(inference, "Config", lambda: cfg)
    demo = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "demos",
                        "demo_fox_meadow.json")
    paths = inference.main(["--input_json", demo, "--use_masks", "--ckpt", path,
                            "--num_images", "2", "--steps", "4",
                            "--output", str(tmp_path / "out")])
    assert len(paths) == 2
    for p in paths:
        img = read_png(open(p, "rb").read())
        assert img.shape == (16, 16, 3) and int(img.max()) > int(img.min())
    boxes = read_png((tmp_path / "out" / "gc7.5-seed0-alpha0.75" / "0_boxes.png").read_bytes())
    assert boxes.shape == (512, 512, 3) and (boxes == 0).any()


# ---------------------------------------------------------------------------
# the training driver on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_trainer_on_card(dev, tmp_path, monkeypatch):
    """The fixture JPEGs decode and center-crop to PIL's hashes on the card
    host; then the Trainer takes 2 bf16 steps on JSON records of them at a
    small config whose attention is long enough for the kernels (1024
    visual tokens), through the training kernels, from pinned batches, and
    saves checkpoint_latest."""
    import math

    import chip_smoke
    from instancediffusion_tpu_torch.config import load_config
    from instancediffusion_tpu_torch.train.trainer import Trainer

    assert chip_smoke.check_fixture_hashes() >= 9
    monkeypatch.setenv("IDTPU_ALLOW_HASH_TOKENIZER", "1")
    listing = chip_smoke.write_training_records(str(tmp_path / "records"), n=4)
    gcfg = dict(in_dim=768, out_dim=64, mid_dim=64, fourier_freqs=4, fourier_freqs_polygons=4,
                n_scribble_points=20, n_polygon_points=256, seg_channels=30,
                seg_resize_input=64, convnext_depths=(1, 1), convnext_dims=(32, 64),
                convnext_feature_dim=4096)
    cfg = load_config(overrides=dict(
        model=dict(image_size=32, model_channels=64, num_heads=8, context_dim=64, max_objs=30,
                   grounding_tokenizer=gcfg, channel_mult=(1,), num_res_blocks=1,
                   attention_resolutions=(1,)),
        autoencoder=dict(ch=32, ch_mult=(1, 2), resolution=64),
        text_encoder=dict(vocab_size=512, hidden_size=64, intermediate_size=128,
                          num_hidden_layers=1, num_attention_heads=4),
        data=dict(image_size=64),
        train=dict(batch_size=2, total_iters=2, warmup_steps=0, n_sample_batches=0,
                   output_dir=str(tmp_path / "OUTPUT"), workers=2)))
    kernels.reset_launch_counts()
    trainer = Trainer(cfg, listing, device=dev)
    assert trainer.start_training()
    stats = trainer.stats()
    assert stats["final_step"] == 2 and all(math.isfinite(x) for x in stats["losses"])
    for name in ("flash_attention_trainable", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv", "fused_group_norm", "fused_layer_norm",
                 "fused_ff_geglu"):
        assert stats["launches_per_step"].get(name, 0) > 0, (name, stats["launches_per_step"])
    assert (tmp_path / "OUTPUT" / "test" / "tag00" / "checkpoint_latest").exists()


@pytest.mark.cuda
def test_clip_judge_on_card_equals_cpu(dev, monkeypatch):
    """CLIPJudge on the card (float32, plain routes) against the same judge
    on the CPU: image and text features within 1e-4 * max |x| (TF32 off)."""
    import numpy as np

    from instancediffusion_tpu_torch.config import TextEncoderConfig
    from instancediffusion_tpu_torch.models import clip_vision as cv

    monkeypatch.setenv("IDTPU_ALLOW_HASH_TOKENIZER", "1")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    vcfg = cv.VisionConfig(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                           num_attention_heads=4, projection_dim=32)
    tcfg = TextEncoderConfig(vocab_size=512, hidden_size=64, intermediate_size=128,
                             num_hidden_layers=2, num_attention_heads=4)
    cpu = cv.CLIPJudge(vcfg, tcfg, generator=torch.Generator().manual_seed(0), device="cpu")
    card = cv.CLIPJudge(vcfg, tcfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    crop = np.random.default_rng(0).integers(0, 256, (90, 130, 3), np.uint8)
    for a, b in ((card.encode_images([crop]), cpu.encode_images([crop])),
                 (card.encode_texts(["a red kite"]), cpu.encode_texts(["a red kite"]))):
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()


@pytest.mark.cuda
def test_encode_phrases_on_card(dev, monkeypatch):
    """encode_phrases on the card's bf16 pipeline: fp32 (D,) features, finite,
    one per phrase, the same for a phrase alone or in a batch (within bf16)."""
    import numpy as np

    from instancediffusion_tpu_torch.config import Config
    from instancediffusion_tpu_torch.pipeline import InstanceDiffusionPipeline

    monkeypatch.setenv("IDTPU_ALLOW_HASH_TOKENIZER", "1")
    pipe = InstanceDiffusionPipeline.random_init(Config(), seed=0, device=dev)
    out = pipe.encode_phrases(["a dog", "a red kite in the sky", "bench"])
    assert len(out) == 3 and all(e.shape == (768,) and e.dtype == np.float32 for e in out)
    assert all(np.isfinite(e).all() for e in out)
    alone = pipe.encode_phrases(["bench"])[0]
    assert np.abs(alone - out[2]).max() <= 2e-2 * np.abs(out[2]).max()


# ---------------------------------------------------------------------------
# tensor parallelism: the kernels at a rank's local shapes (4 of 8 heads,
# half the FF inner width)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ds1_self", "ds1_fuser", "ds2_packed"])
def test_flash_forward_at_tensor_parallel_heads_on_card(dev, case):
    """K1 on ds1's self-attention (4096 keys) and fuser (4280), 4 heads of
    40, and K2 on ds2's 1024 x 1024 packed layout, 4 heads of 80: a tp=2
    rank's share of SD1.5's 8 heads, at B=16."""
    g = torch.Generator(device=dev).manual_seed(8)
    b, h = 16, 4
    if case == "ds2_packed":
        q, k, v = (_rnd(g, dev, b, 1024, h * 80) for _ in range(3))
        kern = lambda: fa.flash_attention_packed(q, k, v, h)
        ref = sdpa_fp32(_heads(q, h), _heads(k, h), _heads(v, h)).transpose(1, 2).reshape(
            b, 1024, h * 80)
    else:
        m = 4096 if case == "ds1_self" else 4280
        q, k, v = (_heads(_rnd(g, dev, b, s, h * 40), h) for s in (4096, m, m))
        kern = lambda: fa.flash_attention(q, k, v)
        ref = sdpa_fp32(q, k, v)
    kernels.reset_launch_counts()
    out = kern()
    torch.cuda.synchronize()
    assert sum(kernels.LAUNCHES.values()) == 1
    assert out.shape == ref.shape and torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max() <= REL_TOL * ref.float().abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("n, c", [(4096, 320), (1024, 640)], ids=["ds1", "ds2"])
def test_ff_geglu_tensor_parallel_width_on_card(dev, n, c):
    """K5 on a tp=2 rank's column shard: inner 640 at C=320 and 1280 at
    C=640, the down bias zero (the UNet adds it after the all_reduce), B=16."""
    g = torch.Generator(device=dev).manual_seed(9)
    inner = 2 * c
    args = [_rnd(g, dev, 16, n, c), _rnd(g, dev, 2 * inner, c, std=c ** -0.5),
            _rnd(g, dev, 2 * inner, std=0.1), _rnd(g, dev, c, inner, std=inner ** -0.5),
            torch.zeros(c, device=dev, dtype=torch.bfloat16)]
    kernels.reset_launch_counts()
    out = ff.ff_geglu(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fused_ff_geglu"] == 1
    ref = ff.ff_geglu_plain(*args).float()
    assert (out.float() - ref).abs().max().item() <= REL_TOL * ref.abs().max().item()
