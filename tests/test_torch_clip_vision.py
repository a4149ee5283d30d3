"""The port's CLIP ViT tower and attribute-binding judge
(`models/clip_vision.py`) against the JAX package's, in float32 on a
2-layer width-64 configuration; the converters on a random HF CLIPModel
state dict; the preprocessing exactly.

The JAX judge resizes with cv2 INTER_CUBIC. The PyPI cv2 carries Intel IPP
on x86, whose cubic resize rounds about one value in 10^4 the other way
near a half; `resize_cubic` is OpenCV's own route, so these tests turn
cv2's IPP route off (`cv2.ipp.setUseIPP(False)`) while they run."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancediffusion_tpu.config import TextEncoderConfig as JTextConfig
from instancediffusion_tpu.io import torch_convert as jtc
from instancediffusion_tpu.models import clip_text as jclip
from instancediffusion_tpu.models import clip_vision as jcv
from instancediffusion_tpu_torch.config import TextEncoderConfig
from instancediffusion_tpu_torch.io import torch_convert as ptc
from instancediffusion_tpu_torch.io.jax_params import load_jax_params
from instancediffusion_tpu_torch.models import clip_vision as pcv

from tests.test_torch_bridge import densify_tree

TEXT = dict(vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4)
# 224 px: the judge's preprocessing resizes every crop to 224, as JAX's does
VISION = dict(image_size=224, patch_size=14, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4, projection_dim=32)
# float32 against float32 in another summation order
TOL = 1e-5


@pytest.fixture(autouse=True)
def opencv_own_resize():
    old = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(old)


@pytest.fixture(scope="module")
def trees():
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(7), 3)
    vision = densify_tree(jcv.init_clip_vision(k1, jcv.VisionConfig(**VISION)), 31)
    text = densify_tree(jclip.init_clip_text(k2, JTextConfig(**TEXT)), 32)
    proj = {"w": np.asarray(jax.random.normal(k3, (64, 32)) * 0.1)}
    return vision, text, proj


def _close(out, ref):
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= TOL * max(np.abs(ref).max(), 1.0)


def test_apply_clip_vision_matches_jax(trees):
    """image_embeds and the pooled feature within 1e-5 * max |x| of JAX's."""
    vision, _, _ = trees
    vcfg = pcv.VisionConfig(**VISION)
    mod = pcv.CLIPVisionModel(vcfg)
    load_jax_params(mod, vision=vision)
    pixels = np.random.default_rng(0).standard_normal((2, 224, 224, 3)).astype(np.float32)
    ref = jcv.apply_clip_vision(jax.tree_util.tree_map(jnp.asarray, vision),
                                jcv.VisionConfig(**VISION), jnp.asarray(pixels))
    with torch.no_grad():
        out = pcv.apply_clip_vision(mod, torch.from_numpy(pixels))
    for key in ("image_embeds", "pooler_output"):
        _close(out[key].numpy(), ref[key])


def test_judge_matches_jax(trees):
    """CLIPJudge.encode_images / encode_texts against JAX's CLIPJudge with
    the hash tokenizer, crop by crop and text by text, on crops of several
    shapes (wide, tall, smaller and larger than 224); a batch's rows equal
    the same crops or texts encoded alone."""
    vision, text, proj = trees
    jt = jax.tree_util.tree_map(jnp.asarray, (vision, text, proj))
    jjudge = jcv.CLIPJudge(*jt, vcfg=jcv.VisionConfig(**VISION), tcfg=JTextConfig(**TEXT))
    pjudge = pcv.CLIPJudge(pcv.VisionConfig(**VISION), TextEncoderConfig(**TEXT), device="cpu")
    load_jax_params(pjudge, vision=vision, text=text, text_projection=proj)
    rng = np.random.default_rng(1)
    crops = [rng.integers(0, 256, (h, w, 3), np.uint8)
             for h, w in ((40, 90), (320, 233), (224, 224), (7, 300))]
    for crop in crops:
        _close(pjudge.encode_images([crop])[0], jjudge.encode_image(crop))
    batch = pjudge.encode_images(crops)
    for i, crop in enumerate(crops):
        np.testing.assert_allclose(batch[i], pjudge.encode_images([crop])[0],
                                   rtol=1e-5, atol=1e-6)
    phrases = ["a red object", "a fluffy dog on a wooden bench"]
    for phrase in phrases:
        _close(pjudge.encode_texts([phrase])[0], jjudge.encode_text(phrase))
    batch = pjudge.encode_texts(phrases)
    for i, phrase in enumerate(phrases):
        np.testing.assert_allclose(batch[i], pjudge.encode_texts([phrase])[0],
                                   rtol=1e-5, atol=1e-6)


def test_judge_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        pcv.CLIPJudge(pcv.VisionConfig(**VISION), TextEncoderConfig(**TEXT))


def _hf_state_dict(rng):
    """A random HF CLIPModel state dict at the test widths."""
    sd = {}
    d, m, p = 64, 128, 32
    lin = lambda o, i: rng.standard_normal((o, i)).astype(np.float32) * 0.1
    vec = lambda n: rng.standard_normal(n).astype(np.float32) * 0.1
    for pre in ("text_model.", "vision_model."):
        for i in range(2):
            lp = f"{pre}encoder.layers.{i}"
            for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
                sd[f"{lp}.self_attn.{name}.weight"] = lin(d, d)
                sd[f"{lp}.self_attn.{name}.bias"] = vec(d)
            for ln in ("layer_norm1", "layer_norm2"):
                sd[f"{lp}.{ln}.weight"], sd[f"{lp}.{ln}.bias"] = vec(d) + 1, vec(d)
            sd[f"{lp}.mlp.fc1.weight"], sd[f"{lp}.mlp.fc1.bias"] = lin(m, d), vec(m)
            sd[f"{lp}.mlp.fc2.weight"], sd[f"{lp}.mlp.fc2.bias"] = lin(d, m), vec(d)
    sd["text_model.embeddings.token_embedding.weight"] = lin(512, d)
    sd["text_model.embeddings.position_embedding.weight"] = lin(77, d)
    sd["text_model.final_layer_norm.weight"] = vec(d) + 1
    sd["text_model.final_layer_norm.bias"] = vec(d)
    sd["vision_model.embeddings.patch_embedding.weight"] = (
        rng.standard_normal((d, 3, 14, 14)).astype(np.float32) * 0.05)
    sd["vision_model.embeddings.class_embedding"] = vec(d)
    sd["vision_model.embeddings.position_embedding.weight"] = lin(257, d)
    sd["vision_model.pre_layrnorm.weight"] = vec(d) + 1  # (sic, HF's key)
    sd["vision_model.pre_layrnorm.bias"] = vec(d)
    sd["vision_model.post_layernorm.weight"] = vec(d) + 1
    sd["vision_model.post_layernorm.bias"] = vec(d)
    sd["visual_projection.weight"] = lin(p, d)
    sd["text_projection.weight"] = lin(p, d)
    return sd


def test_convert_clip_model_equals_jax():
    """convert_clip_model of the copy gives JAX's trees leaf for leaf, and
    from_state_dict loads them: the judge's features equal a judge built
    from JAX's trees."""
    sd = _hf_state_dict(np.random.default_rng(2))
    tcfg, vcfg = TextEncoderConfig(**TEXT), pcv.VisionConfig(**VISION)
    ref = jtc.convert_clip_model(sd, JTextConfig(**TEXT), jcv.VisionConfig(**VISION))
    out = ptc.convert_clip_model(sd, tcfg, vcfg)
    ref_leaves, ref_def = jax.tree_util.tree_flatten(ref)
    out_leaves, out_def = jax.tree_util.tree_flatten(out)
    assert ref_def == out_def
    for a, b in zip(ref_leaves, out_leaves):
        np.testing.assert_array_equal(a, b)
    judge = pcv.CLIPJudge.from_state_dict(sd, vcfg, tcfg, device="cpu")
    other = pcv.CLIPJudge(vcfg, tcfg, device="cpu")
    load_jax_params(other, vision=ref[0], text=ref[1], text_projection=ref[2])
    crop = np.random.default_rng(3).integers(0, 256, (64, 48, 3), np.uint8)
    np.testing.assert_array_equal(judge.encode_images([crop]), other.encode_images([crop]))
    np.testing.assert_array_equal(judge.encode_texts(["a cat"]), other.encode_texts(["a cat"]))


@pytest.mark.parametrize("shape", [(300, 500, 3), (500, 300, 3), (224, 224, 3), (17, 23, 3),
                                   (224, 900, 3), (1, 1, 3), (0, 5, 3)])
def test_preprocess_image_equals_jax(shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, np.uint8)
    ref = jcv.preprocess_image(img)
    out = pcv.preprocess_image(img)
    assert out.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(out, ref)
