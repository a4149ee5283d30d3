"""The whole port of `generate` against the JAX pipeline: tiny config,
densified random weights bridged into both, the same starting latents from
numpy, fp32 params and compute, 4 PLMS steps (alpha_type [0.75, 0, 0.25]
gives gates 1, 1, 1, 0, so both gate values and the first-conv swap run)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import instancediffusion_tpu.data.grounding_input as gi
from instancediffusion_tpu.pipeline import InstanceDiffusionPipeline as JaxPipeline
from instancediffusion_tpu.pipeline import PipelineParams
from instancediffusion_tpu_torch.io.jax_params import load_jax_params
from instancediffusion_tpu_torch.pipeline import InstanceDiffusionPipeline

from tests.test_pipeline import META, tiny_config
from tests.test_torch_bridge import dense_params, port_config, to_jax


@pytest.fixture(scope="module")
def pipes():
    cfg = tiny_config()
    trees = dense_params(cfg, seed=11)
    jpipe = JaxPipeline(cfg, PipelineParams(**{k: to_jax(v) for k, v in trees.items()}))
    ppipe = InstanceDiffusionPipeline.random_init(port_config(cfg), seed=0, device="cpu",
                                                  dtype=torch.float32)
    load_jax_params(ppipe, **trees)
    g = cfg.model.grounding_tokenizer
    meta = dict(META, scribbles=[[0.2] * (g.n_scribble_points * 2)] * 2,
                polygons=[[0.3] * (g.n_polygon_points * 2)] * 2, segs=None)
    # the tiny config's grounding widths for the JAX pipeline (as
    # tests/test_pipeline.py does); the port takes them from its config
    old = (gi.N_SCRIBBLE_POINTS, gi.N_POLYGON_POINTS, gi.SEG_SIZE)
    gi.N_SCRIBBLE_POINTS, gi.N_POLYGON_POINTS, gi.SEG_SIZE = (
        g.n_scribble_points, g.n_polygon_points, g.seg_resize_input)
    yield cfg, jpipe, ppipe, meta
    gi.N_SCRIBBLE_POINTS, gi.N_POLYGON_POINTS, gi.SEG_SIZE = old


def test_generate_matches_jax(pipes):
    """uint8 images within one level of the JAX pipeline everywhere (fp32
    differences in summation order can move a value across a floor
    boundary)."""
    cfg, jpipe, ppipe, meta = pipes
    mc = cfg.model
    x0 = np.random.default_rng(0).standard_normal(
        (2, mc.image_size, mc.image_size, mc.in_channels)).astype(np.float32)
    ref = jpipe.generate(meta, num_images=2, steps=4, mis=0.0, compute_dtype=jnp.float32,
                         initial_latents=x0)
    out = ppipe.generate(meta, num_images=2, steps=4, mis=0.0, initial_latents=x0)
    assert out.shape == ref.shape == (2, ppipe.image_size, ppipe.image_size, 3)
    assert out.dtype == np.uint8
    assert int(ref.max()) - int(ref.min()) > 10  # densified weights: not flat
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


def test_generate_seeded_noise_is_deterministic(pipes):
    _, _, ppipe, meta = pipes
    a = ppipe.generate(meta, num_images=1, steps=4, mis=0.0, seed=3)
    b = ppipe.generate(meta, num_images=1, steps=4, mis=0.0, seed=3)
    c = ppipe.generate(meta, num_images=1, steps=4, mis=0.0, seed=4)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_generate_keeps_grounding_fp32_with_bf16_weights(pipes, monkeypatch):
    """A bf16 pipeline feeds UniFusion fp32 grounding (as the JAX pipeline
    does), so the Fourier features of box coordinates are not rounded to
    bf16 before the sine."""
    import instancediffusion_tpu_torch.pipeline as ppipeline

    cfg, _, _, meta = pipes
    pipe = InstanceDiffusionPipeline.random_init(port_config(cfg), seed=0, device="cpu",
                                                 dtype=torch.bfloat16)
    seen = []
    inner = ppipeline.unifusion.apply_unifusion

    def spy(p, gcfg, g, drops):
        out = inner(p, gcfg, g, drops)
        seen.append((g["boxes"].dtype, g["positive_embeddings"].dtype, out.dtype))
        return out

    monkeypatch.setattr(ppipeline.unifusion, "apply_unifusion", spy)
    out = pipe.generate(meta, num_images=1, steps=4, mis=0.0, seed=0)
    assert out.shape == (1, pipe.image_size, pipe.image_size, 3)
    assert seen == [(torch.float32,) * 3] * 2  # cond and null grounding


@pytest.mark.parametrize("kwargs", [
    {"mis": 0.36},
    {},                           # the config's default mis (0.36)
    {"mis": 0.0, "sampler": "dpm"},
    {"mis": 0.0, "sampler": "ddim"},
])
def test_generate_refuses_unported_paths(pipes, kwargs):
    _, _, ppipe, meta = pipes
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ppipe.generate(meta, num_images=1, steps=4, **kwargs)
