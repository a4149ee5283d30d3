"""The port's evaluation suite against the JAX package's
(`evalsuite/coco_eval.py`, `pim.py`, `attribute_binding.py`): metas, masks,
the written files and their names, job sharding, and the generated images
of a tiny bridged pipeline; every input from numpy seeds."""

import io
import os

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
import instancediffusion_tpu.data.grounding_input as gi
from instancediffusion_tpu.evalsuite import attribute_binding as jab
from instancediffusion_tpu.evalsuite import coco_eval as jce
from instancediffusion_tpu.evalsuite import pim as jpim
from instancediffusion_tpu.pipeline import InstanceDiffusionPipeline as JaxPipeline
from instancediffusion_tpu.pipeline import PipelineParams
from instancediffusion_tpu_torch.data.jpeg import decode_image
from instancediffusion_tpu_torch.evalsuite import attribute_binding as pab
from instancediffusion_tpu_torch.evalsuite import coco_eval as pce
from instancediffusion_tpu_torch.evalsuite import pim as ppim
from instancediffusion_tpu_torch.io.jax_params import load_jax_params
from instancediffusion_tpu_torch.pipeline import InstanceDiffusionPipeline

from tests.test_pipeline import tiny_config
from tests.test_torch_bridge import dense_params, port_config, to_jax

SIZES = [(f"{i:012d}.jpg", w, h) for i, (w, h) in enumerate(chip_smoke.COCO_SIZES)]


@pytest.fixture(scope="module")
def coco_files(tmp_path_factory):
    out = tmp_path_factory.mktemp("coco")
    return chip_smoke.write_synthetic_coco(str(out), SIZES, seed=3)


def _assert_same(a, b, where):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


@pytest.mark.parametrize("attribute_mode", [None, "colors", "textures"])
def test_metas_equal_jax(coco_files, attribute_mode):
    """build_meta_for_image gives JAX's metas key for key, exactly (the
    masks of polygon parts through fill_poly, RLE, a crowd annotation left
    out, the image without annotations None), with the same rng draws."""
    inst, caps = coco_files
    jc, pc = jce.CocoAnnotations(inst), pce.CocoAnnotations(inst)
    assert jc.image_ids() == pc.image_ids()
    metas = 0
    for img_id in jc.image_ids():
        info = jc.imgs[img_id]
        for ann in jc.img_anns[img_id]:
            np.testing.assert_array_equal(pc.ann_to_mask(ann, info), jc.ann_to_mask(ann, info))
        kw = dict(caption="a caption. ", attribute_mode=attribute_mode)
        ref = jce.build_meta_for_image(jc, img_id, rng=np.random.default_rng(img_id), **kw)
        out = pce.build_meta_for_image(pc, img_id, rng=np.random.default_rng(img_id), **kw)
        _assert_same(ref, out, f"image {img_id}")
        metas += ref is not None
    assert metas == len(SIZES) - 1


class _FakePipe:
    """generate_batch stand-in: seeded random images, no model."""

    def __init__(self):
        self.last_timings = {}
        self.calls = []

    def generate_batch(self, metas, seeds, **kw):
        self.calls.append(list(seeds))
        return np.stack([np.random.default_rng(s).integers(0, 256, (32, 24, 3), np.uint8)
                         for s in seeds])


@pytest.mark.parametrize("num_jobs,job_index,limit", [(1, 0, None), (3, 1, None), (3, 2, None),
                                                      (2, 0, 2), (1, 0, 5)])
def test_run_coco_eval_files_and_sharding(coco_files, tmp_path, num_jobs, job_index, limit):
    """run_coco_eval writes JAX's file names, count and batches for each job
    share and limit, and each .jpg is PIL's encoding of the array, byte for
    byte."""
    inst, caps = coco_files
    jp, pp = _FakePipe(), _FakePipe()
    kw = dict(captions_json=caps, num_jobs=num_jobs, job_index=job_index, limit=limit, seed=5,
              batch_size=3, steps=2)
    n_j = jce.run_coco_eval(jp, inst, str(tmp_path / "jax"), **kw)
    n_p = pce.run_coco_eval(pp, inst, str(tmp_path / "port"), **kw)
    assert n_j == n_p and jp.calls == pp.calls
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) and len(names) == n_p
    for name in names:
        got = (tmp_path / "port" / name).read_bytes()
        assert got == (tmp_path / "jax" / name).read_bytes(), name


def test_written_png_has_the_pixels(tmp_path):
    """A .png COCO name gets a PNG of the same pixels (PIL's own PNG bytes
    differ); another extension raises."""
    img = np.random.default_rng(0).integers(0, 256, (9, 7, 3), np.uint8)
    data = pce.image_file_bytes(img, "x.png")
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
    jpg = pce.image_file_bytes(img, "x.JPG")
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG")
    assert jpg == buf.getvalue()
    with pytest.raises(ValueError, match="bmp"):
        pce.image_file_bytes(img, "x.bmp")


@pytest.fixture(scope="module")
def eval_pipes():
    """The tiny config with the eval metas' grounding widths (20 scribble and
    256 polygon points, 512x512 segs), bridged from one densified JAX tree."""
    import dataclasses

    cfg = tiny_config()
    g = dataclasses.replace(cfg.model.grounding_tokenizer, n_scribble_points=20,
                            n_polygon_points=256, seg_resize_input=512)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, grounding_tokenizer=g))
    trees = dense_params(cfg, seed=21)
    jpipe = JaxPipeline(cfg, PipelineParams(**{k: to_jax(v) for k, v in trees.items()}))
    ppipe = InstanceDiffusionPipeline.random_init(port_config(cfg), seed=0, device="cpu",
                                                  dtype=torch.float32)
    load_jax_params(ppipe, **trees)
    old = (gi.N_SCRIBBLE_POINTS, gi.N_POLYGON_POINTS, gi.SEG_SIZE)
    gi.N_SCRIBBLE_POINTS, gi.N_POLYGON_POINTS, gi.SEG_SIZE = (
        g.n_scribble_points, g.n_polygon_points, g.seg_resize_input)
    yield cfg, jpipe, ppipe
    gi.N_SCRIBBLE_POINTS, gi.N_POLYGON_POINTS, gi.SEG_SIZE = old


def test_run_coco_eval_images_match_jax(coco_files, eval_pipes, tmp_path, monkeypatch):
    """run_coco_eval on the tiny bridged pipelines (fp32, 2 PLMS steps,
    batches of 4, colours): the images within one uint8 level of JAX's,
    from JAX's normal(PRNGKey(seed + id)) rows, and every .jpg the port
    writes is PIL's encoding of its own array, byte for byte."""
    import jax
    import jax.numpy as jnp

    inst, caps = coco_files
    cfg, jpipe, ppipe = eval_pipes
    mc = cfg.model
    shape = (1, mc.image_size, mc.image_size, mc.in_channels)
    got = {"jax": [], "port": []}
    jgen, pgen = jpipe.generate_batch, ppipe.generate_batch

    def jax_batch(metas, **kw):
        out = jgen(metas, compute_dtype=jnp.float32, **kw)
        got["jax"].append(out)
        return out

    def port_batch(metas, seeds, **kw):
        x0 = np.concatenate([np.asarray(jax.random.normal(jax.random.PRNGKey(s), shape))
                             for s in seeds])
        out = pgen(metas, seeds=seeds, initial_latents=x0, **kw)
        got["port"].append(out)
        return out

    monkeypatch.setattr(jpipe, "generate_batch", jax_batch)
    monkeypatch.setattr(ppipe, "generate_batch", port_batch)
    kw = dict(captions_json=caps, steps=2, batch_size=4, attribute_mode="colors", limit=5)
    n = jce.run_coco_eval(jpipe, inst, str(tmp_path / "jax"), **kw)
    assert pce.run_coco_eval(ppipe, inst, str(tmp_path / "port"), **kw) == n == 5
    ref, out = np.concatenate(got["jax"]), np.concatenate(got["port"])
    assert out.shape == ref.shape == (5, ppipe.image_size, ppipe.image_size, 3)
    assert int(ref.max()) - int(ref.min()) > 10
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    for name, img in zip(names, out):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG")
        data = (tmp_path / "port" / name).read_bytes()
        assert data == buf.getvalue(), name
        assert decode_image(data).shape == img.shape


def test_main_refuses_mesh_and_a_missing_card(coco_files, tmp_path):
    """--mesh with no rendezvous (no torchrun environment, no --coordinator)
    raises, as does --device cuda without a card."""
    inst, _ = coco_files
    with pytest.raises(ValueError, match="torchrun"):
        pce.main(["--instances_json", inst, "--mesh", "--save_dir", str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            pce.main(["--instances_json", inst, "--save_dir", str(tmp_path)])


def test_main_mesh_on_two_ranks_writes_the_one_rank_files(coco_files, eval_pipes, tmp_path,
                                                          monkeypatch):
    """coco_eval --mesh on 2 gloo ranks (the batches over "data", rank 0
    writing) leaves the folder one process writes, byte for byte: the tiny
    eval config's random weights, 2 PLMS steps, batches of 4 over 5 images
    (the last batch padded)."""
    from instancediffusion_tpu_torch import config

    from tests import torch_ranks

    inst, caps = coco_files
    pcfg = port_config(eval_pipes[0])
    argv = ["--instances_json", inst, "--captions_json", caps, "--steps", "2", "--limit", "5",
            "--batch_size", "4", "--add_random_colors"]
    got = torch_ranks.run_ranks(torch_ranks.coco_eval_main, 2, pcfg,
                                [*argv, "--save_dir", str(tmp_path / "mesh")], join=False)
    assert got == [5, 5]
    monkeypatch.setattr(config, "Config", lambda: pcfg)
    one = pce.main([*argv, "--device", "cpu", "--save_dir", str(tmp_path / "one")])
    assert one["images"] == 5
    names = sorted(os.listdir(tmp_path / "one"))
    assert names == sorted(os.listdir(tmp_path / "mesh")) and len(names) == 5
    for name in names:
        assert (tmp_path / "mesh" / name).read_bytes() == (tmp_path / "one" / name).read_bytes()


def test_main_refuses_a_missing_checkpoint(coco_files, tmp_path):
    """A --ckpt_path that names no file raises before any image is made
    (JAX's driver would evaluate random weights)."""
    inst, _ = coco_files
    with pytest.raises(FileNotFoundError, match="nope.pth"):
        pce.main(["--instances_json", inst, "--ckpt_path", str(tmp_path / "nope.pth"),
                  "--save_dir", str(tmp_path / "out"), "--device", "cpu"])
    assert not (tmp_path / "out").exists()


def _masks(rng, n, h=40, w=48):
    out = []
    for _ in range(n):
        m = np.zeros((h, w), np.uint8)
        y0, x0 = rng.integers(0, h - 8), rng.integers(0, w - 8)
        m[y0:y0 + rng.integers(3, 12), x0:x0 + rng.integers(3, 12)] = 1
        out.append(m)
    return out


@pytest.mark.parametrize("mode", ["point", "scribble"])
def test_pim_equals_jax(mode):
    """pim_score of the copy equals JAX's on random masks, and 1.0 in point
    mode when the predicted masks are the ground truth."""
    rng = np.random.default_rng(4)
    per_image = [(_masks(rng, 3), _masks(rng, int(rng.integers(1, 5)))) for _ in range(6)]
    ref = jpim.pim_score(per_image, mode, rng=np.random.default_rng(1))
    out = ppim.pim_score(per_image, mode, rng=np.random.default_rng(1))
    assert out == ref or (np.isnan(out) and np.isnan(ref))
    same = [(gt, list(gt)) for gt, _ in per_image]
    if mode == "point":
        assert ppim.pim_score(same, mode) == jpim.pim_score(same, mode) == 1.0


@pytest.mark.parametrize("mode", ["colors", "textures"])
def test_attribute_binding_equals_jax(mode):
    """attribute_binding_eval of the copy gives JAX's scores with the same
    (random, deterministic) encoders, batched: the label prompts once, an
    image's crops and phrases in one call each."""
    rng = np.random.default_rng(5)
    table = {}

    def encode_text(t):
        return table.setdefault(t, np.random.default_rng(abs(hash(t)) % 2**32)
                                .standard_normal(16).astype(np.float32))

    def encode_image(crop):
        return crop.astype(np.float32).reshape(-1, 3).mean(0).repeat(6)[:16] - 100.0

    attrs = pab.COLOR_LIST if mode == "colors" else pab.TEXTURE_LIST
    per_image = []
    for _ in range(4):
        img = rng.integers(0, 256, (50, 60, 3), np.uint8)
        locs = [sorted(rng.uniform(0, 1, 2)) for _ in range(3)]
        locs = [[a, b, a + 0.3, min(b + 0.4, 1.0)] for a, b in locs]
        phrases = [f"{attrs[int(rng.integers(len(attrs)))]} dog" for _ in locs]
        per_image.append((img, locs, phrases))
    calls = []

    def encode_images(crops):
        calls.append(("images", len(crops)))
        return np.stack([encode_image(c) for c in crops])

    def encode_texts(texts):
        calls.append(("texts", len(texts)))
        return np.stack([encode_text(t) for t in texts])

    ref = jab.attribute_binding_eval(per_image, mode, encode_image, encode_text)
    out = pab.attribute_binding_eval(per_image, mode, encode_images, encode_texts)
    assert out == ref
    # the label prompts once, then one batch of crops and one of phrases an
    # image (its non-empty crops)
    kept = [sum(c.size > 0 for c in pab.crop_instances(img, locs)) for img, locs, _ in per_image]
    assert calls == [("texts", len(attrs))] + [
        call for k in kept if k for call in (("images", k), ("texts", k))]
    assert pab.attach_attributes([{"id": 9, "category_name": "cat"}], mode) == \
        jab.attach_attributes([{"id": 9, "category_name": "cat"}], mode)
