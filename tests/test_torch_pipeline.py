"""The whole port of `generate` against the JAX pipeline: tiny config,
densified random weights bridged into both, the same starting latents from
numpy, fp32 params and compute, 4 PLMS steps (alpha_type [0.75, 0, 0.25]
gives gates 1, 1, 1, 0, so both gate values and the first-conv swap run),
without and with the Multi-Instance Sampler and instance-masked fuser
attention."""

import dataclasses

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


@pytest.fixture(scope="module")
def masked_pipes(pipes):
    """The same weights under a config with instance-masked fuser attention."""
    cfg, jpipe, ppipe, meta = pipes
    mcfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, use_masked_att=True))
    return (JaxPipeline(mcfg, jpipe.params),
            InstanceDiffusionPipeline(port_config(mcfg), ppipe.unet, ppipe.vae, ppipe.clip,
                                      ppipe.tokenizer))


@pytest.mark.parametrize("mis,masked", [
    (0.5, False),   # Multi-Instance Sampler: 2 trajectory steps, then 2 global
    (0.0, True),    # instance-masked fuser attention
    (0.5, True),    # both
])
def test_generate_matches_jax_on_mis_and_masked_paths(pipes, masked_pipes, mis, masked):
    """uint8 within one level of the JAX pipeline with MIS (mean merge,
    trajectory 0's eps history carried across the merge) and with the
    fuser masked by instance labels (the CFG null half unmasked)."""
    cfg, jpipe, ppipe, meta = pipes
    if masked:
        jpipe, ppipe = masked_pipes
    mc = cfg.model
    x0 = np.random.default_rng(1).standard_normal(
        (2, mc.image_size, mc.image_size, mc.in_channels)).astype(np.float32)
    ref = jpipe.generate(meta, num_images=2, steps=4, mis=mis, compute_dtype=jnp.float32,
                         initial_latents=x0)
    out = ppipe.generate(meta, num_images=2, steps=4, mis=mis, initial_latents=x0)
    assert out.shape == ref.shape and out.dtype == np.uint8
    assert int(ref.max()) - int(ref.min()) > 10
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


def test_generate_default_mis_is_the_configs(pipes):
    """mis=None resolves to the config's 0.36 for PLMS (as in the JAX
    pipeline): at 4 steps one trajectory step, then 3 global steps."""
    _, _, ppipe, meta = pipes
    assert ppipe.cfg.sampler.mis == 0.36
    a = ppipe.generate(meta, num_images=1, steps=4, seed=5)
    b = ppipe.generate(meta, num_images=1, steps=4, mis=0.36, seed=5)
    c = ppipe.generate(meta, num_images=1, steps=4, mis=0.0, seed=5)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("kwargs", [
    {"mis": 0.5, "sampler": "dpm"},
    {"mis": 0.5, "sampler": "ddim"},
])
def test_generate_refuses_unported_paths(pipes, kwargs):
    """MIS is a PLMS construction: an explicit mis > 0 with DPM or DDIM
    raises (as in the JAX pipeline); an unknown sampler too."""
    _, _, ppipe, meta = pipes
    with pytest.raises(ValueError, match="does not support MIS"):
        ppipe.generate(meta, num_images=1, steps=4, **kwargs)
    with pytest.raises(ValueError, match="unknown sampler"):
        ppipe.generate(meta, num_images=1, steps=4, mis=0.0, sampler="euler")


@pytest.mark.parametrize("sampler", ["dpm", "ddim"])
def test_generate_matches_jax_on_dpm_and_ddim(pipes, sampler):
    """4 steps of DPM-Solver++(2M) (first-order last step) or DDIM (eta 0),
    within one uint8 level of the JAX pipeline; an unset mis becomes 0 for
    them (the config's 0.36 applies to PLMS only)."""
    cfg, jpipe, ppipe, meta = pipes
    mc = cfg.model
    x0 = np.random.default_rng(2).standard_normal(
        (2, mc.image_size, mc.image_size, mc.in_channels)).astype(np.float32)
    ref = jpipe.generate(meta, num_images=2, steps=4, sampler=sampler,
                         compute_dtype=jnp.float32, initial_latents=x0)
    out = ppipe.generate(meta, num_images=2, steps=4, sampler=sampler, initial_latents=x0)
    assert out.shape == ref.shape and out.dtype == np.uint8
    assert int(ref.max()) - int(ref.min()) > 10
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1
    plms = ppipe.generate(meta, num_images=2, steps=4, mis=0.0, initial_latents=x0)
    assert not np.array_equal(out, plms)
    assert set(ppipe.last_timings) >= {"text_encode", "grounding_prep", "sample", "fetch"}


def _batch_metas(cfg):
    """Three metas with 2, 1 and 0 instances (uneven MIS trajectory counts)."""
    g = cfg.model.grounding_tokenizer
    one = {"prompt": "one shape", "phrases": ["a green triangle"],
           "locations": [[0.2, 0.3, 0.7, 0.9]], "points": [[0.45, 0.6]],
           "scribbles": [[0.4] * (g.n_scribble_points * 2)]}
    none = {"prompt": "an empty field", "phrases": [], "locations": []}
    return [dict(META), one, none]


@pytest.mark.parametrize("mis,sampler", [
    (0.0, "dpm"),    # the serving configuration's sampler
    (0.5, "plms"),   # MIS: 4 padded trajectories, weights 0 on the padding
])
def test_generate_batch_matches_jax(pipes, mis, sampler):
    """One image per meta, each from its seed's noise (JAX's
    normal(PRNGKey(s)) rows passed in), within one uint8 level of JAX."""
    import jax

    cfg, jpipe, ppipe, _ = pipes
    mc = cfg.model
    metas = _batch_metas(cfg)
    seeds = [3, 1, 4]
    x0 = np.concatenate([np.asarray(jax.random.normal(
        jax.random.PRNGKey(s), (1, mc.image_size, mc.image_size, mc.in_channels)))
        for s in seeds])
    ref = jpipe.generate_batch(metas, steps=4, seeds=seeds, mis=mis, sampler=sampler,
                               compute_dtype=jnp.float32)
    out = ppipe.generate_batch(metas, steps=4, seeds=seeds, mis=mis, sampler=sampler,
                               initial_latents=x0)
    assert out.shape == ref.shape == (3, ppipe.image_size, ppipe.image_size, 3)
    assert int(ref.max()) - int(ref.min()) > 10
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1
    # each row is its own meta's image: the same meta alone gives the same
    alone = ppipe.generate_batch(metas[1:2], steps=4, seeds=seeds[1:2], mis=mis,
                                 sampler=sampler, initial_latents=x0[1:2])
    assert np.abs(alone.astype(int) - out[1:2].astype(int)).max() <= 1


def test_generate_batch_seeds_and_checks(pipes):
    cfg, _, ppipe, _ = pipes
    metas = _batch_metas(cfg)[:2]
    a = ppipe.generate_batch(metas, steps=4, seeds=[5, 5], mis=0.0)
    b = ppipe.generate_batch(metas[::-1], steps=4, seeds=[5, 5], mis=0.0)
    np.testing.assert_array_equal(a, b[::-1])  # a row depends on its meta and seed only
    with pytest.raises(ValueError, match="at least one meta"):
        ppipe.generate_batch([], steps=4)
    with pytest.raises(ValueError, match="does not support MIS"):
        ppipe.generate_batch(metas, steps=4, mis=0.5, sampler="dpm")


@pytest.fixture(scope="module")
def i2i_pipes(pipes):
    """The same UNet and CLIP weights with a whole VAE (encoder too)."""
    import jax

    from instancediffusion_tpu.models import vae as jvae

    from tests.test_torch_bridge import densify_tree

    cfg, jpipe, ppipe, meta = pipes
    vtree = densify_tree(jvae.init_vae(jax.random.PRNGKey(0), cfg.autoencoder), 21)
    jp = JaxPipeline(cfg, PipelineParams(unet=jpipe.params.unet, vae=to_jax(vtree),
                                         clip=jpipe.params.clip))
    pvae = InstanceDiffusionPipeline.random_init(port_config(cfg), seed=0, device="cpu",
                                                 dtype=torch.float32, vae_encoder=True).vae
    load_jax_params(pvae, vae=vtree)
    pp = InstanceDiffusionPipeline(ppipe.cfg, ppipe.unet, pvae, ppipe.clip, ppipe.tokenizer)
    return cfg, jp, pp, meta


def test_img2img_matches_jax(pipes, i2i_pipes):
    """strength 0.5 of 4 PLMS steps: encode (posterior sample), noise to
    step 2's alpha, 2 steps; JAX's two draws of split(PRNGKey(seed), 2)
    passed in. Within one uint8 level of JAX."""
    import jax

    cfg, jpipe, ppipe, meta = i2i_pipes
    size = ppipe.image_size
    img = np.random.default_rng(6).integers(0, 256, (size, size, 3), dtype=np.uint8)
    ref = jpipe.img2img(img, meta, strength=0.5, num_images=2, steps=4, seed=3,
                        compute_dtype=jnp.float32)
    mc = cfg.model
    latent = (2, mc.image_size, mc.image_size, cfg.autoencoder.embed_dim)
    enc_key, noise_key = jax.random.split(jax.random.PRNGKey(3), 2)
    enc_noise = np.asarray(jax.random.normal(enc_key, latent, jnp.float32))
    noise = np.asarray(jax.random.normal(noise_key, latent, jnp.float32))
    out = ppipe.img2img(img, meta, strength=0.5, num_images=2, steps=4, seed=3,
                        encode_noise=enc_noise, noise=noise)
    assert out.shape == ref.shape == (2, size, size, 3) and out.dtype == np.uint8
    assert int(ref.max()) - int(ref.min()) > 10
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1
    # the input image matters, and so does the strength
    other = ppipe.img2img(255 - img, meta, strength=0.5, num_images=2, steps=4, seed=3,
                          encode_noise=enc_noise, noise=noise)
    assert not np.array_equal(out, other)
    with pytest.raises(ValueError, match="strength"):
        ppipe.img2img(img, meta, strength=0.0, steps=4)
    with pytest.raises(ValueError, match="image must be"):
        ppipe.img2img(img[:8, :8], meta, strength=0.5, steps=4)
    with pytest.raises(ValueError, match="encoder"):
        pipes[2].img2img(img, meta, strength=0.5, steps=4)  # its VAE has no encoder
