"""The port's zoo adapters (`instancediffusion_tpu_torch/datagen/backends_zoo.py`)
against JAX's (`instancediffusion_tpu/datagen/backends_zoo.py`): each of
JAX's zoo tests (`tests/test_datagen_zoo.py`) runs on the same fakes
through both adapters, and the outputs (and what each adapter hands its
model) are equal. The port resizes without an imaging library: its
BILINEAR and RAM's default filter (Pillow's BICUBIC for RGB) are held to
Pillow bit for bit over Hypothesis sizes.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from instancediffusion_tpu.datagen import backends_zoo as jz
from instancediffusion_tpu.datagen.label import LabelingPipeline as JaxLabelingPipeline
from instancediffusion_tpu_torch.data import resample
from instancediffusion_tpu_torch.datagen import backends_zoo as pz
from instancediffusion_tpu_torch.datagen.label import LabelingPipeline

from tests.test_datagen_zoo import (
    _FakeBlip,
    _FakeDino,
    _FakeSamPredictor,
    _FakeTokenizer,
    _image,
)

Image = pytest.importorskip("PIL.Image")


def test_imagenet_tensor_contract():
    img = _image(16, 24)
    got, want = pz.imagenet_chw_tensor(img), jz.imagenet_chw_tensor(img)
    assert got.shape == (3, 16, 24) and got.dtype == torch.float32
    assert torch.equal(got, want)


@pytest.mark.parametrize("hw", [(240, 320), (240, 3200), (333, 500), (1200, 900)])
def test_resize_shortest_800_max_1333(hw):
    img = _image(*hw)
    got, want = pz.resize_shortest(img), jz.resize_shortest(img)
    assert got.shape == want.shape and min(got.shape[:2]) <= 800
    np.testing.assert_array_equal(got, want)


def test_cxcywh_to_xyxy_pixels():
    boxes = np.random.default_rng(0).random((5, 4)).astype(np.float32)
    got = pz.boxes_cxcywh_to_xyxy_pixels(boxes, width=320, height=240)
    np.testing.assert_array_equal(got, jz.boxes_cxcywh_to_xyxy_pixels(boxes, 320, 240))
    np.testing.assert_allclose(
        pz.boxes_cxcywh_to_xyxy_pixels(np.array([[0.5, 0.5, 0.5, 0.25]], np.float32), 320, 240),
        [[80, 90, 240, 150]], atol=1e-4)


def test_phrase_from_posmap_decodes_thresholded_tokens():
    tok = _FakeTokenizer()
    ids = tok("a dog on grass")["input_ids"]
    for posmap in ([False, True, False, True, False], [True] * 7, [False] * 5):
        pm = np.array(posmap)
        assert pz.phrase_from_posmap(pm, ids, tok) == jz.phrase_from_posmap(pm, ids, tok)
    assert pz.phrase_from_posmap(np.array([False, True, False, True, False]), ids,
                                 tok) == "tok1 tok3"


def test_ram_tagger_resizes_and_splits_tags():
    seen = {}

    def fake_inference(key):
        def run(tensor, model):
            seen[key] = tensor.clone()
            return ("dog | grass  | park", "unused-confidences")
        return run

    img = _image()
    got = pz.RamTagger(model=None, inference_fn=fake_inference("port"))(img)
    want = jz.RamTagger(model=None, inference_fn=fake_inference("jax"))(img)
    assert got == want == ["dog", "grass", "park"]
    assert seen["port"].shape == (1, 3, 384, 384)
    assert torch.equal(seen["port"], seen["jax"])  # Pillow's default filter, bit for bit


def test_dino_detector_contract():
    img = _image(240, 320)
    outs, models = {}, {}
    for name, mod in (("port", pz), ("jax", jz)):
        models[name] = _FakeDino()
        det = mod.GroundingDinoDetector(models[name], tokenizer=_FakeTokenizer())
        outs[name] = det(img, ["Dog", "grass"])
    (pb, ps, pp), (jb, js, jp) = outs["port"], outs["jax"]
    np.testing.assert_array_equal(pb, jb)
    np.testing.assert_array_equal(ps, js)
    assert pp == jp == ["tok1", "tok2"]
    assert pb.dtype == ps.dtype == np.float32 and pb.shape == (2, 4)
    assert models["port"].captions_seen == models["jax"].captions_seen == ["dog, grass."]
    assert models["port"].input_shape == models["jax"].input_shape == (1, 3, 800, 1067)


def test_sam_segmenter_contract():
    img = _image(64, 48)
    boxes = np.array([[4, 4, 20, 20], [8, 8, 40, 40]], np.float32)
    preds = {"port": _FakeSamPredictor(), "jax": _FakeSamPredictor()}
    got = pz.SamSegmenter(preds["port"])(img, boxes)
    want = jz.SamSegmenter(preds["jax"])(img, boxes)
    assert got.shape == (2, 64, 48) and got.dtype == bool
    np.testing.assert_array_equal(got, want)
    assert preds["port"].transform.orig_hw == preds["jax"].transform.orig_hw == (64, 48)
    assert torch.equal(preds["port"].boxes_seen, preds["jax"].boxes_seen)
    assert pz.SamSegmenter(_FakeSamPredictor())(img, np.zeros((0, 4), np.float32)).shape == \
        (0, 64, 48)


@pytest.mark.parametrize("box", [[10.0, 20.0, 110.0, 70.0],   # inside
                                 [-15.7, 200.0, 40.2, 260.0],  # off the left and bottom
                                 [300.0, -5.0, 330.0, 4.0]],   # off the right and top
                         ids=["inside", "left_bottom", "right_top"])
def test_blip2_captioner_crops_box(box):
    """The port crops as a numpy slice padded with zeros where the box
    leaves the image: the pixels of JAX's `Image.crop`."""
    crops = {}

    def vis_processor(key):
        def run(crop):
            crops[key] = np.asarray(crop)
            return torch.zeros((3, 224, 224))
        return run

    img = _image()
    got = pz.Blip2Captioner(_FakeBlip(), vis_processor("port"))(img, np.array(box))
    want = jz.Blip2Captioner(_FakeBlip(), vis_processor("jax"))(img, np.array(box))
    assert got == want == "a fluffy dog"
    assert crops["port"].dtype == np.uint8
    np.testing.assert_array_equal(crops["port"], crops["jax"])


def _fleet(mod, pipeline_cls):
    return pipeline_cls(
        tagger=mod.RamTagger(None, lambda t, m: ("dog | grass", None)),
        detector=mod.GroundingDinoDetector(_FakeDino(), tokenizer=_FakeTokenizer()),
        segmenter=mod.SamSegmenter(_FakeSamPredictor()),
        captioner=mod.Blip2Captioner(_FakeBlip(), lambda c: torch.zeros((3, 224, 224))),
        embedder=lambda texts: np.zeros((len(texts), 768), np.float32),
        box_threshold=0.25, iou_threshold=0.5,
    )


def test_fake_zoo_fleet_end_to_end():
    img = _image(240, 320)
    got = _fleet(pz, LabelingPipeline).label_image(img, "a dog on grass", "img0")
    want = _fleet(jz, JaxLabelingPipeline).label_image(img, "a dog on grass", "img0")
    assert got == want
    assert len(got["annos"]) == 2 and got["annos"][0]["bbox"] == [80, 90, 160, 60]
    assert got["annos"][0]["caption"].endswith("a fluffy dog")


@settings(max_examples=40, deadline=None, derandomize=True)
@given(w=st.integers(1, 120), h=st.integers(1, 120), ow=st.integers(1, 200),
       oh=st.integers(1, 200), gray=st.booleans(), seed=st.integers(0, 2**16))
def test_bilinear_and_default_resize_equal_pil(w, h, ow, oh, gray, seed):
    """BILINEAR (Resample.c's triangle filter, support 1) and RAM's
    `Image.resize((s, s))` with Pillow's default filter (BICUBIC for RGB
    and L), up and down: Pillow's bytes exactly, native and numpy passes."""
    img = np.random.default_rng(seed).integers(0, 256, (h, w) if gray else (h, w, 3),
                                               dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize((ow, oh), Image.BILINEAR))
    np.testing.assert_array_equal(resample.resize(img, (ow, oh), resample.BILINEAR), want)
    np.testing.assert_array_equal(resample.resize_numpy(img, (ow, oh), resample.BILINEAR), want)
    default = np.asarray(Image.fromarray(img).resize((ow, oh)))
    np.testing.assert_array_equal(resample.resize(img, (ow, oh), resample.BICUBIC), default)


def test_crop_box_refuses_an_inverted_box_as_pil_does():
    img = _image(20, 20)
    with pytest.raises(ValueError):
        Image.fromarray(img).crop((10, 0, 5, 5))
    with pytest.raises(ValueError, match="right < left"):
        pz.crop_box(img, [10, 0, 5, 5])
