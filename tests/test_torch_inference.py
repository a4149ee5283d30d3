"""The port's demo CLI and what it stands on, against the JAX package's and
the libraries the JAX package calls, on the CPU: the demo-JSON parser, the
numpy border follower (cv2.findContours), the nearest resize (cv2.resize),
the box outlines (PIL), the PNG reader (PIL), the LoRA merge (through the
parameter bridge), `inference.main` end to end, and serve's `--ckpt`.
Every comparison is exact except the generated images (uint8 within one
level: fp32 summation order can move a value across a floor boundary)."""

import copy
import dataclasses
import glob
import io
import json
import os
import re
import zlib

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from scipy import ndimage

from instancediffusion_tpu import inference as jinf
from instancediffusion_tpu.data import geometry as jgeo
from instancediffusion_tpu.io.lora import merge_lora as jax_merge_lora
from instancediffusion_tpu.models import clip_text as jclip
from instancediffusion_tpu.models import unet as junet
from instancediffusion_tpu.pipeline import InstanceDiffusionPipeline as JaxPipeline
from instancediffusion_tpu_torch import inference as pinf
from instancediffusion_tpu_torch import serve
from instancediffusion_tpu_torch.data import geometry as pgeo
from instancediffusion_tpu_torch.io import checkpoint as ckpt_io
from instancediffusion_tpu_torch.io import lora as plora
from instancediffusion_tpu_torch.io.jax_params import load_jax_params
from instancediffusion_tpu_torch.io.png import png_bytes, read_png
from instancediffusion_tpu_torch.models import clip_text, unet
from instancediffusion_tpu_torch.pipeline import InstanceDiffusionPipeline

from tests.test_pipeline import tiny_config
from tests.test_torch_bridge import densify_tree, port_config
from tests.test_torch_checkpoint import (assert_modules_equal, bridged_modules, ckpt_config,
                                         reference_trees)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMOS = sorted(glob.glob(os.path.join(REPO, "demos", "*.json")))
MASK_DEMO = os.path.join(REPO, "demos", "demo_collie_picnic_masks.json")


def _equal_meta(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], str):
            assert got[k] == want[k], k
            continue
        assert type(got[k]) is type(want[k]) and len(got[k]) == len(want[k]), k
        for a, b in zip(got[k], want[k]):
            assert type(a) is type(b), k
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("use_masks", [False, True])
@pytest.mark.parametrize("demo", [os.path.basename(d) for d in DEMOS])
def test_parse_demo_json_equals_jax(demo, use_masks):
    """Every list and array exactly as the JAX parser (cv2 contours and
    resize) gives them, from the same numpy seed."""
    assert len(DEMOS) == 12
    path = os.path.join(REPO, "demos", demo)
    got = pinf.parse_demo_json(path, use_masks=use_masks, rng=np.random.default_rng(3))
    want = jinf.parse_demo_json(path, use_masks=use_masks, rng=np.random.default_rng(3))
    _equal_meta(got, want)


def _cv2_contours(mask):
    cs, _ = cv2.findContours(mask.astype(np.uint8), cv2.RETR_LIST, cv2.CHAIN_APPROX_NONE)
    return [c.reshape(-1, 2) for c in cs]


def _demo_masks():
    with open(MASK_DEMO) as f:
        annos = json.load(f)["annos"]
    return [jgeo.decode_to_binary_mask(a["mask"])[:, :, 0] for a in annos]


def _blobs(seed: int, h: int, w: int) -> np.ndarray:
    """Seeded random blobs: filled discs and rings (holes, nested parts),
    noise speckle (one-pixel parts, diagonal contacts), lines one pixel
    wide, and parts touching the image's edges."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    m = np.zeros((h, w), bool)
    for _ in range(r.integers(2, 6)):
        cy, cx = r.uniform(0, h), r.uniform(0, w)
        rad = r.uniform(2, max(h, w) / 3)
        d = np.hypot(yy - cy, xx - cx)
        m |= (d < rad) & ((d > rad * r.uniform(0.3, 0.7)) if r.uniform() < 0.6 else True)
    m ^= r.uniform(size=(h, w)) < 0.03
    m[r.integers(0, h), :] ^= True
    m[:, r.integers(0, w)] ^= r.uniform(size=h) < 0.5
    return m


@pytest.mark.parametrize("case", [f"demo{i}" for i in range(6)]
                         + [f"blobs{s}" for s in range(6)] + ["noise", "tiny"])
def test_find_contours_equals_cv2(case):
    """find_contours gives cv2.findContours(RETR_LIST, CHAIN_APPROX_NONE)'s
    contours point for point, in the same order, and mask_boundary_points
    the JAX package's boundary points."""
    if case.startswith("demo"):
        masks = [_demo_masks()[int(case[4:])]]
    elif case.startswith("blobs"):
        s = int(case[5:])
        masks = [_blobs(s, 64 + 37 * s, 96 - 9 * s), ndimage.binary_opening(_blobs(s + 50, 80, 80))]
    elif case == "noise":
        r = np.random.default_rng(7)
        masks = [r.uniform(size=(h, w)) < p for h, w, p in
                 ((31, 47, 0.5), (40, 40, 0.2), (25, 60, 0.8))]
    else:  # one-pixel images, single pixels, lines, full masks
        masks = [np.ones((1, 1)), np.zeros((3, 3)), np.eye(5), np.ones((4, 7)),
                 np.pad(np.ones((1, 1)), 2), np.ones((1, 9)), np.ones((9, 1))]
    for m in masks:
        want = _cv2_contours(m)
        got = pgeo.find_contours(m)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(pgeo.mask_boundary_points(m),
                                      jgeo.mask_boundary_points(m))


@pytest.mark.parametrize("src,dst", [((512, 768), (512, 512)), ((768, 512), (512, 512)),
                                     ((333, 517), (512, 512)), ((7, 5), (13, 11)),
                                     ((100, 3), (7, 999)), ((1, 1), (5, 5)),
                                     ((1000, 999), (3, 7)), ((512, 512), (512, 512))])
def test_resize_nearest_equals_cv2(src, dst):
    """cv2's INTER_NEAREST index rule, at the demo sizes and odd ones."""
    m = np.random.default_rng(0).uniform(size=src).astype(np.float32)
    want = cv2.resize(m, (dst[1], dst[0]), interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(pgeo.resize_nearest(m, dst[1], dst[0]), want)


@pytest.mark.parametrize("case", ["demos", "random", "thin", "edges"])
def test_box_outlines_equal_pil(case):
    """The numpy outlines pixel for pixel as the JAX CLI's PIL drawing with
    empty labels (boxes thinner than the outline included)."""
    r = np.random.default_rng(1)
    if case == "demos":
        locs = [b for d in DEMOS for b in pinf.parse_demo_json(d)["locations"]]
    elif case == "random":
        lo = r.uniform(0, 1, (40, 2))
        locs = np.concatenate([lo, np.minimum(lo + r.uniform(0, 0.4, (40, 2)), 1)], 1).tolist()
    elif case == "thin":
        lo = r.uniform(0, 1, (40, 2))
        locs = np.concatenate([lo, lo + r.uniform(0, 0.01, (40, 2))], 1).tolist()
    else:
        locs = [[0, 0, 1, 1], [-0.1, 0.5, 0.3, 1.2], [0.99, 0.99, 1.0, 1.0], [0.5, 0.5, 0.5, 0.5]]
    want = np.asarray(jinf.draw_boxes_image(locs, [""] * len(locs), ""))
    np.testing.assert_array_equal(pinf.draw_boxes_image(locs), want)


def _png_with_filters(img: np.ndarray, filters) -> bytes:
    """An RGB / RGBA PNG whose row y uses filter filters[y % len]."""
    h, w, c = img.shape
    bpp, rows = c, img.reshape(h, w * c).astype(np.int64)
    out = []
    for y in range(h):
        f, x = filters[y % len(filters)], rows[y]
        up = rows[y - 1] if y else np.zeros_like(x)
        left = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        if f == 0:
            pred = 0
        elif f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        out.append(np.concatenate([[f], (x - pred) & 0xFF]).astype(np.uint8))
    ihdr = np.array([w, h], ">u4").tobytes() + bytes([8, 2 if c == 3 else 6, 0, 0, 0])

    def chunk(kind, data):
        return (len(data).to_bytes(4, "big") + kind + data
                + zlib.crc32(kind + data).to_bytes(4, "big"))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(np.concatenate(out).tobytes()))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("case", ["round_trip", "filter0", "filter1", "filter2", "filter3",
                                  "filter4", "mixed_rgba", "pil_rgb", "pil_rgba"])
def test_png_reader(case):
    """The writer and reader round-trip; the reader decodes each row filter
    and PIL's own files as PIL does."""
    r = np.random.default_rng(2)
    img = (r.uniform(size=(13, 17, 3)) * 40 + np.arange(17)[None, :, None] * 12).astype(np.uint8)
    if case == "round_trip":
        np.testing.assert_array_equal(read_png(png_bytes(img)), img)
        return
    if case.startswith("pil"):
        rgba = np.concatenate([img, r.integers(0, 256, (13, 17, 1), np.uint8)], -1)
        src = img if case == "pil_rgb" else rgba
        buf = io.BytesIO()
        Image.fromarray(src).save(buf, format="PNG")
        data = buf.getvalue()
    else:
        src = img if case != "mixed_rgba" else np.concatenate(
            [img, r.integers(0, 256, (13, 17, 1), np.uint8)], -1)
        data = _png_with_filters(src, [0, 1, 2, 3, 4] if case == "mixed_rgba" else [int(case[-1])])
    want = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(want, src)
    np.testing.assert_array_equal(read_png(data), want)


# -- LoRA: the port's merge against JAX's merge_lora ----------------------


def lora_config():
    """SD1.5's block topology (4 levels, attention at ds 1/2/4, two res
    blocks each) at tiny widths, so the diffusers block mapping lands on
    real transformers."""
    cfg = tiny_config()
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, channel_mult=(1, 2, 4, 4), num_res_blocks=2, attention_resolutions=(4, 2, 1)))


def _pair(prefix, c_in, c_out, rank=4, alpha=2.0, seed=0, conv=False):
    r = np.random.default_rng(seed)
    down = r.normal(size=(rank, c_in)).astype(np.float32)
    up = r.normal(size=(c_out, rank)).astype(np.float32)
    if conv:
        down, up = down[..., None, None], up[..., None, None]
    return {f"{prefix}.lora_down.weight": down, f"{prefix}.lora_up.weight": up,
            f"{prefix}.alpha": np.float32(alpha)}


def _lora_case(case: str):
    """(lora state dict, scale, with the text encoder) mirroring
    tests/test_lora.py's cases on the tiny SD1.5 topology (widths 32 / 64
    / 128, GEGLU inner 4x)."""
    if case == "kohya":
        sd = {**_pair("lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_attn1_to_q",
                      32, 32, seed=1),
              **_pair("lora_unet_mid_block_attentions_0_transformer_blocks_0_ff_net_2",
                      512, 128, seed=2),
              **_pair("lora_unet_up_blocks_1_attentions_2_transformer_blocks_0_attn2_to_out_0",
                      128, 128, seed=3),
              **_pair("lora_unet_down_blocks_1_attentions_1_transformer_blocks_0_ff_net_0_proj",
                      64, 512, seed=4)}
        return sd, 0.5, False
    if case == "conv1x1_unknown":
        sd = {**_pair("lora_unet_down_blocks_0_attentions_1_proj_in", 32, 32, alpha=4, seed=7,
                      conv=True),
              **_pair("lora_unet_up_blocks_3_attentions_2_proj_out", 32, 32, seed=8, conv=True),
              **_pair("lora_unet_time_embed_whatever", 32, 32, seed=9),
              "totally_random_key": np.zeros(1, np.float32)}
        return sd, 1.0, False
    r = np.random.default_rng(9)
    a, b = r.normal(size=(4, 32)).astype(np.float32), r.normal(size=(32, 4)).astype(np.float32)
    sd = {"unet.up_blocks.3.attentions.0.transformer_blocks.0.attn1.to_v.lora_A.weight": a,
          "unet.up_blocks.3.attentions.0.transformer_blocks.0.attn1.to_v.lora_B.weight": b,
          "text_encoder.text_model.encoder.layers.0.self_attn.q_proj.lora_A.weight": a,
          "text_encoder.text_model.encoder.layers.0.self_attn.q_proj.lora_B.weight": b,
          **_pair("lora_te_text_model_encoder_layers_1_mlp_fc1", 32, 64, seed=5)}
    return sd, 1.0, case == "peft_text_encoder"


@pytest.fixture(scope="module")
def lora_trees():
    cfg = lora_config()
    k = jax.random.PRNGKey(0)
    trees = {"unet": densify_tree(jax.eval_shape(lambda: junet.init_unet(k, cfg.model)), 3),
             "clip": densify_tree(jax.eval_shape(
                 lambda: jclip.init_clip_text(k, cfg.text_encoder)), 4)}
    return cfg, trees


def _port_lora_modules(cfg, trees):
    pc = port_config(cfg)
    gen = torch.Generator().manual_seed(0)
    mods = {"unet": unet.UNet(pc.model, generator=gen),
            "clip": clip_text.CLIPTextModel(pc.text_encoder, generator=gen)}
    for name, m in mods.items():
        load_jax_params(m, **{name: trees[name]})
    return mods


@pytest.mark.parametrize("case", ["kohya", "conv1x1_unknown", "peft_text_encoder",
                                  "text_encoder_skipped"])
def test_lora_merge_equals_jax(lora_trees, case):
    """The same stats as JAX's merge_lora, and weights equal to the bridge
    of JAX's merged trees, exactly."""
    cfg, trees = lora_trees
    sd, scale, with_te = _lora_case(case)
    jtrees = copy.deepcopy(trees)
    want = jax_merge_lora(jtrees["unet"], sd, scale=scale,
                          clip_params=jtrees["clip"] if with_te else None)
    mods = _port_lora_modules(cfg, trees)
    got = plora.merge_lora(mods["unet"], sd, scale=scale, clip=mods["clip"] if with_te else None)
    assert got == want
    assert got["applied_unet"] >= 1
    ref = _port_lora_modules(cfg, jtrees)
    assert_modules_equal(mods["unet"], ref["unet"])
    assert_modules_equal(mods["clip"], ref["clip"])
    before = dict(_port_lora_modules(cfg, trees)["unet"].named_parameters())
    changed = [n for n, p in mods["unet"].named_parameters() if not torch.equal(p, before[n])]
    assert len(changed) == got["applied_unet"]


def test_lora_shape_mismatch_raises(lora_trees):
    cfg, trees = lora_trees
    sd = _pair("lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_attn1_to_q", 16, 16)
    with pytest.raises(ValueError, match="does not match weight"):
        jax_merge_lora(copy.deepcopy(trees["unet"]), sd)
    with pytest.raises(ValueError, match="does not match weight"):
        plora.merge_lora(_port_lora_modules(cfg, trees)["unet"], sd)


def test_lora_merge_bf16_rounds_the_fp32_sum(lora_trees):
    """On bf16 weights the merge adds in float32 and rounds once."""
    cfg, trees = lora_trees
    sd, scale, _ = _lora_case("kohya")
    mods = _port_lora_modules(cfg, trees)
    mods["unet"].to(torch.bfloat16)
    w = mods["unet"].input_blocks[1][1].blocks[0].attn1.to_q.weight.detach().clone()
    plora.merge_lora(mods["unet"], sd, scale=scale)
    pfx = "lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_attn1_to_q"
    down, up = sd[pfx + ".lora_down.weight"], sd[pfx + ".lora_up.weight"]
    delta = (down.T @ up.T) * (float(sd[pfx + ".alpha"]) / 4) * scale
    want = (w.float() + torch.from_numpy(np.ascontiguousarray(delta.T))).to(torch.bfloat16)
    assert torch.equal(mods["unet"].input_blocks[1][1].blocks[0].attn1.to_q.weight, want)


# -- the CLI end to end -----------------------------------------------------


def cli_config():
    """A tiny config that takes the CLI's grounding as parse_demo_json
    makes it (20 scribble and 256 polygon points, 512x512 segs) for the
    mask demo's 6 instances, with the ConvNeXt-T the reference format
    fixes."""
    cfg = ckpt_config(n_scribble_points=20, n_polygon_points=256, seg_resize_input=512,
                      seg_channels=6)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, max_objs=6))


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    """(cfg, trees, checkpoint path, LoRA path): a flat SD-form file and a
    kohya LoRA on the tiny UNet's ds1 transformers (input block 1, output
    block 0) as torch pickles."""
    d = tmp_path_factory.mktemp("cli")
    cfg = cli_config()
    trees = reference_trees(cfg, 21)
    ckpt = str(d / "tiny.pth")
    torch.save(ckpt_io.reference_state_dict(**bridged_modules(cfg, trees)), ckpt)
    lora = {**_pair("lora_unet_down_blocks_0_attentions_0_proj_out", 32, 32, seed=11, conv=True),
            **_pair("lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_attn1_to_q",
                    32, 32, seed=12),
            **_pair("lora_unet_up_blocks_0_attentions_0_transformer_blocks_0_attn2_to_out_0",
                    32, 32, seed=13)}
    lora_path = str(d / "lora.pt")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in lora.items()}, lora_path)
    return cfg, trees, ckpt, lora_path


def test_cli_matches_jax_end_to_end(cli_files, tmp_path, monkeypatch):
    """The port's inference.main against the JAX package's on the same
    checkpoint, LoRA and mask demo (--use_masks, the default mask preset,
    mis 0.36, 4 PLMS steps, 2 images), both with float32 compute and the
    same numpy starting latents: the same file names, and the PNGs within
    one uint8 level."""
    cfg, trees, ckpt, lora = cli_files
    monkeypatch.setenv("IDTPU_ALLOW_HASH_TOKENIZER", "1")
    monkeypatch.setattr(jinf, "Config", lambda: cfg)
    monkeypatch.setattr(pinf, "Config", lambda: port_config(cfg))
    mc = cfg.model
    x0 = np.random.default_rng(0).standard_normal(
        (2, mc.image_size, mc.image_size, mc.in_channels)).astype(np.float32)
    jgen, pgen = JaxPipeline.generate, InstanceDiffusionPipeline.generate
    monkeypatch.setattr(JaxPipeline, "generate", lambda self, meta, **kw: jgen(
        self, meta, compute_dtype=jnp.float32, initial_latents=x0, **kw))
    monkeypatch.setattr(InstanceDiffusionPipeline, "generate", lambda self, meta, **kw: pgen(
        self, meta, initial_latents=x0, **kw))
    args = ["--input_json", MASK_DEMO, "--use_masks", "--ckpt", ckpt, "--lora", lora,
            "--num_images", "2", "--steps", "4"]
    jinf.main(args + ["--output", str(tmp_path / "jax")])
    paths = pinf.main(args + ["--output", str(tmp_path / "port"), "--device", "cpu"])
    folder = "gc7.5-seed0-alpha0.75"
    names = sorted(os.listdir(tmp_path / "jax" / folder))
    assert names == sorted(os.listdir(tmp_path / "port" / folder)) == \
        ["0.png", "0_boxes.png", "1.png"]
    assert paths == [str(tmp_path / "port" / folder / n) for n in ("0.png", "1.png")]
    for name in ("0.png", "1.png"):
        want = np.asarray(Image.open(tmp_path / "jax" / folder / name))
        got = np.asarray(Image.open(tmp_path / "port" / folder / name))
        assert got.shape == want.shape == (16, 16, 3)
        assert int(want.max()) - int(want.min()) > 10
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, name


def test_cli_img2img_and_refused_options(tmp_path, monkeypatch):
    """--img2img reads a PNG at the model's resolution and writes its
    edits; an image of another size is resized to the resolution with PIL's
    LANCZOS (it was refused before the port had LANCZOS)."""
    cfg = port_config(cli_config())
    monkeypatch.setenv("IDTPU_ALLOW_HASH_TOKENIZER", "1")
    monkeypatch.setattr(pinf, "Config", lambda: cfg)
    demo = os.path.join(REPO, "demos", "demo_kitchen_cat.json")
    src = np.random.default_rng(0).integers(0, 256, (16, 16, 3), np.uint8)
    (tmp_path / "in.png").write_bytes(png_bytes(src))
    base = ["--input_json", demo, "--device", "cpu", "--steps", "4", "--num_images", "1",
            "--output", str(tmp_path / "out")]
    paths = pinf.main(base + ["--img2img", str(tmp_path / "in.png"), "--strength", "0.5"])
    img = read_png((tmp_path / "out" / "gc7.5-seed0-alpha0.75" / "0.png").read_bytes())
    assert len(paths) == 1 and img.shape == (16, 16, 3)
    big = np.random.default_rng(1).integers(0, 256, (24, 16, 3), np.uint8)
    (tmp_path / "big.png").write_bytes(png_bytes(big))
    np.testing.assert_array_equal(
        pinf.read_image(str(tmp_path / "big.png"), 16),
        np.asarray(Image.fromarray(big).resize((16, 16), Image.LANCZOS)))
    paths = pinf.main(base + ["--img2img", str(tmp_path / "big.png"), "--output",
                              str(tmp_path / "out_big")])
    assert len(paths) == 1


class _Captured(Exception):
    pass


def test_cli_img2img_resizes_a_jpeg_as_jax(tmp_path, monkeypatch):
    """--img2img with a 40x27 JPEG: the port's CLI hands img2img exactly the
    array JAX's CLI hands it (PIL's decode and LANCZOS resize to the model's
    resolution); img2img itself is held to JAX's in test_torch_pipeline.py."""
    cfg = cli_config()
    monkeypatch.setenv("IDTPU_ALLOW_HASH_TOKENIZER", "1")
    monkeypatch.setattr(jinf, "Config", lambda: cfg)
    monkeypatch.setattr(pinf, "Config", lambda: port_config(cfg))
    y, x = np.mgrid[0:27, 0:40]
    src = np.stack([x * 6, y * 9, (x * y) % 256], -1).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(src).save(buf, format="JPEG", quality=90)
    (tmp_path / "in.jpg").write_bytes(buf.getvalue())
    got = {}

    def capture(name):
        def img2img(self, image, meta, **kw):
            got[name] = np.array(image)
            raise _Captured
        return img2img

    monkeypatch.setattr(JaxPipeline, "img2img", capture("jax"))
    monkeypatch.setattr(InstanceDiffusionPipeline, "img2img", capture("port"))
    # JAX's jitted init is most of a minute here, and img2img gets no weights
    monkeypatch.setattr(JaxPipeline, "random_init",
                        classmethod(lambda cls, cfg, seed=0: object.__new__(cls)))
    demo = os.path.join(REPO, "demos", "demo_kitchen_cat.json")
    args = ["--input_json", demo, "--steps", "4", "--num_images", "1",
            "--img2img", str(tmp_path / "in.jpg")]
    with pytest.raises(_Captured):
        jinf.main(args + ["--output", str(tmp_path / "jax")])
    with pytest.raises(_Captured):
        pinf.main(args + ["--output", str(tmp_path / "port"), "--device", "cpu"])
    res = cfg.model.image_size * 2 ** (len(cfg.autoencoder.ch_mult) - 1)
    assert got["port"].shape == got["jax"].shape == (res, res, 3)
    assert got["port"].dtype == got["jax"].dtype == np.uint8
    np.testing.assert_array_equal(got["port"], got["jax"])


@pytest.mark.parametrize("exists", [True, False])
def test_serve_ckpt_builds_from_the_file(cli_files, monkeypatch, capsys, exists):
    """serve's --ckpt path: the pipeline holds the file's weights; a
    missing file warns and falls back to seeded random weights, as the JAX
    server does."""
    cfg, trees, ckpt, _ = cli_files
    monkeypatch.setattr(serve, "Config", lambda: port_config(cfg))
    path = ckpt if exists else ckpt + ".missing"
    pipe = serve.build_pipeline(path, "box", seed=0, device="cpu")
    assert pipe.dtype == torch.float32 and pipe.device.type == "cpu"
    ref = bridged_modules(cfg, trees)
    clip_same = all(torch.equal(p, dict(ref["clip"].named_parameters())[n])
                    for n, p in pipe.clip.named_parameters())
    assert clip_same == exists
    assert ("not found; random init" in capsys.readouterr().out) != exists


# -- the port stays free of JAX, PIL, cv2 and safetensors ------------------

BANNED = ("jax", "instancediffusion_tpu", "PIL", "cv2", "safetensors")


@pytest.mark.parametrize("name", BANNED)
def test_port_sources_import_none_of(name):
    """No import of JAX, the JAX package, PIL, cv2 or safetensors in the
    port's sources or in chip_smoke.py."""
    rx = re.compile(rf"^\s*(import|from)\s+{re.escape(name)}(\.|\s|$)", re.M)
    files = glob.glob(os.path.join(REPO, "instancediffusion_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) > 30
    hits = [f for f in files if rx.search(open(f).read())]
    assert not hits, hits
