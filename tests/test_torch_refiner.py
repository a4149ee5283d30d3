"""The port's SDXL-Refiner cascade against the JAX package's, on the CPU.

Tiny configs (the shapes of tests/test_refiner.py), densified random
weights drawn once with numpy and carried into both packages, float32
compute, JAX at jax_default_matmul_precision="highest" (tests/conftest.py).
Each comparison states its tolerance. One JAX compile per function is
shared by the module's fixtures.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancediffusion_tpu import config as jconfig
from instancediffusion_tpu import pipeline_refiner as jpr
from instancediffusion_tpu.io import torch_convert as jtc
from instancediffusion_tpu.models import clip_text as jclip
from instancediffusion_tpu.models import sdxl_refiner as jref
from instancediffusion_tpu.models import vae as jvae
from instancediffusion_tpu.ops.schedules import make_diffusion_schedule as j_diffusion
from instancediffusion_tpu.samplers.ddim import make_ddim_schedule as j_ddim
from instancediffusion_tpu_torch import config as pconfig
from instancediffusion_tpu_torch import inference as pinf
from instancediffusion_tpu_torch import pipeline_refiner as ppr
from instancediffusion_tpu_torch.io import torch_convert as ptc
from instancediffusion_tpu_torch.io.jax_params import load_jax_params
from instancediffusion_tpu_torch.io.png import read_png
from instancediffusion_tpu_torch.models import clip_text, vae
from instancediffusion_tpu_torch.models import sdxl_refiner as pref
from instancediffusion_tpu_torch.ops.schedules import make_diffusion_schedule
from instancediffusion_tpu_torch.samplers.ddim import make_ddim_schedule

from tests.test_refiner import TINY, _ldm_names_for
from tests.test_torch_bridge import densify_tree, to_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# fp32 on both sides: differences are summation order (and the two
# frameworks' fp32 sin / cos / erf) only, relative to the output's scale
REL = 1e-4

# the tiny cascade of tests/test_refiner.py::test_refiner_pipeline_tiny_e2e
E2E_UNET = dict(model_channels=32, attention_resolutions=(2,), num_res_blocks=1,
                channel_mult=(1, 2), num_head_channels=16, transformer_depth=1,
                context_dim=32, adm_in_channels=1280 + 48)
E2E_TEXT = dict(vocab_size=49408, max_length=77, hidden_size=32, intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=4, projection_dim=48)
E2E_VAE = dict(ch=32, ch_mult=(1, 1, 1, 1), scale_factor=0.13025)
TINY_TEXT = dict(vocab_size=128, max_length=16, hidden_size=32, intermediate_size=64,
                 num_hidden_layers=2, num_attention_heads=4, projection_dim=48)


def _port_cfg(cls, jcfg):
    return cls(**dataclasses.asdict(jcfg))


def _close(port, ref, rel=REL):
    """max |port - ref| <= rel * max |ref|."""
    port = port.detach().float().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def _openclip_sd(cfg, rng):
    """A synthetic open_clip text tower state dict (the sgm file's
    `conditioner.embedders.0.model.*`)."""
    d, m = cfg.hidden_size, cfg.intermediate_size
    sd = {
        "token_embedding.weight": 0.5 * rng.standard_normal((cfg.vocab_size, d)),
        "positional_embedding": 0.5 * rng.standard_normal((cfg.max_length, d)),
        "ln_final.weight": 1 + 0.1 * rng.standard_normal(d),
        "ln_final.bias": 0.1 * rng.standard_normal(d),
        "text_projection": rng.standard_normal((d, cfg.projection_dim)) / np.sqrt(d),
    }
    for i in range(cfg.num_hidden_layers):
        p = f"transformer.resblocks.{i}"
        sd[p + ".ln_1.weight"] = 1 + 0.1 * rng.standard_normal(d)
        sd[p + ".ln_1.bias"] = 0.1 * rng.standard_normal(d)
        sd[p + ".attn.in_proj_weight"] = rng.standard_normal((3 * d, d)) / np.sqrt(d)
        sd[p + ".attn.in_proj_bias"] = 0.1 * rng.standard_normal(3 * d)
        sd[p + ".attn.out_proj.weight"] = rng.standard_normal((d, d)) / np.sqrt(d)
        sd[p + ".attn.out_proj.bias"] = 0.1 * rng.standard_normal(d)
        sd[p + ".ln_2.weight"] = 1 + 0.1 * rng.standard_normal(d)
        sd[p + ".ln_2.bias"] = 0.1 * rng.standard_normal(d)
        sd[p + ".mlp.c_fc.weight"] = rng.standard_normal((m, d)) / np.sqrt(d)
        sd[p + ".mlp.c_fc.bias"] = 0.1 * rng.standard_normal(m)
        sd[p + ".mlp.c_proj.weight"] = rng.standard_normal((d, m)) / np.sqrt(m)
        sd[p + ".mlp.c_proj.bias"] = 0.1 * rng.standard_normal(d)
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


# -- config, schedule, ADM vector ---------------------------------------------


def test_slice_schedule_matches_jax():
    """The img2img slice of a 20-step DDIM schedule keeps the same 7 (and 1)
    lowest-noise steps, array for array."""
    full_p = make_ddim_schedule(make_diffusion_schedule(), 20)
    full_j = j_ddim(j_diffusion(), 20)
    for keep in (7, 1, 20):
        got, want = ppr._slice_schedule(full_p, keep), jpr._slice_schedule(full_j, keep)
        assert got.num_steps == want.num_steps == keep
        for f in ("ts", "a_t", "a_prev", "sqrt_one_minus_a_t", "sigmas", "gates"):
            np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)), f)


def test_refiner_adm_vector_matches_jax():
    """y = [pooled | 5 x 256 sinusoidal embeddings]: the pooled text copied,
    the embeddings (of 1024, 1024, 0, 0 and the score) within 1e-4
    absolute: the two frameworks' fp32 exp of a frequency may differ by an
    ulp (6e-8 relative), which an argument of 1024 turns into 6e-5 rad."""
    pooled = np.random.default_rng(0).standard_normal((3, 1280)).astype(np.float32)
    for size, crop, score in (((1024, 1024), (0, 0), 6.0), ((512, 768), (16, 8), 2.5)):
        got = pref.refiner_adm_vector(torch.from_numpy(pooled), size, crop, score)
        want = np.asarray(jref.refiner_adm_vector(jnp.asarray(pooled), size, crop, score))
        assert got.shape == want.shape == (3, 2560)
        np.testing.assert_array_equal(got[:, :1280].numpy(), pooled)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


# -- the OpenCLIP-bigG tower ---------------------------------------------------


def test_openclip_tower_matches_jax():
    """A synthetic open_clip state dict through both converters into both
    towers: the penultimate hidden states, the last hidden state and the
    projected pooled output within REL of their scale; erf GELU, the text
    projection's (width, proj) orientation and the fused in_proj split
    included."""
    jcfg = jconfig.OpenCLIPTextConfig(**TINY_TEXT)
    sd = _openclip_sd(jcfg, np.random.default_rng(1))
    jparams = to_jax(jtc.convert_openclip_text(sd, jcfg))
    tower = clip_text.CLIPTextModel(_port_cfg(pconfig.OpenCLIPTextConfig, jcfg))
    load_jax_params(tower, clip=ptc.convert_openclip_text(sd, tower.cfg))
    ids = np.stack([np.concatenate([np.arange(1, 15), [127, 0]]),
                    np.concatenate([[5, 9, 127], np.zeros(13, int)])]).astype(np.int32)
    want = jclip.apply_clip_text(jparams, jcfg, jnp.asarray(ids))
    got = clip_text.apply_clip_text(tower, torch.from_numpy(ids).long())
    for key in ("penultimate_hidden_state", "last_hidden_state", "projected_pooled"):
        _close(got[key], want[key])
    assert got["projected_pooled"].shape == (2, jcfg.projection_dim)
    # CLIP-L keeps its outputs and has no projection
    assert not hasattr(clip_text.CLIPTextModel(pconfig.TextEncoderConfig(num_hidden_layers=1)),
                       "text_projection")


# -- the refiner UNet ---------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_unet():
    """(densified JAX tree, bridged port RefinerUNet, inputs, JAX eps) at
    TINY: three levels, attention at ds 2 and 4 and the ds8 middle, the
    decoder's skip joins."""
    tree = densify_tree(jref.init_refiner_unet(jax.random.PRNGKey(0), TINY), 7)
    model = pref.RefinerUNet(_port_cfg(pconfig.RefinerUNetConfig, TINY))
    load_jax_params(model, unet=tree)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([10, 500], np.int32)
    ctx = rng.standard_normal((2, 77, TINY.context_dim)).astype(np.float32)
    y = rng.standard_normal((2, TINY.adm_in_channels)).astype(np.float32)
    fwd = jax.jit(lambda p, *a: jref.apply_refiner_unet(p, TINY, *a, attn_impl="xla"))
    eps = np.asarray(fwd(to_jax(tree), *(jnp.asarray(a) for a in (x, t, ctx, y))))
    return tree, model, (x, t, ctx, y), eps


def test_apply_refiner_unet_matches_jax(tiny_unet):
    """eps of the bridged port UNet within REL of max |eps| of JAX's (fp32,
    densified weights: no zero-initialised layer hides an error)."""
    _, model, (x, t, ctx, y), eps = tiny_unet
    t_ = torch.from_numpy
    got = pref.apply_refiner_unet(model, t_(x), t_(t).long(), t_(ctx), t_(y))
    assert np.abs(eps).max() > 0.1
    _close(got, eps)


def test_refiner_plan_and_parameters_mirror_jax(tiny_unet):
    """The port's plan is the JAX plan at the published widths; the module
    has exactly the JAX tree's leaves (the bridge leaves none unset) and no
    fuser anywhere."""
    full_p = pref.build_refiner_plan(pconfig.RefinerUNetConfig())
    full_j = jref.build_refiner_plan(jconfig.RefinerUNetConfig())
    assert [[dataclasses.astuple(s) for s in blk] for blk in full_p[0] + [full_p[1]]
            + full_p[2]] == [[(s.kind, s.in_ch, s.out_ch, s.ds) for s in blk]
                             for blk in full_j[0] + [full_j[1]] + full_j[2]]
    _, model, _, _ = tiny_unet
    assert not any("fuser" in n for n, _ in model.named_parameters())
    n_leaves = len(jax.tree_util.tree_leaves(jref.init_refiner_unet(jax.random.PRNGKey(0),
                                                                    TINY)))
    assert len(list(model.parameters())) == n_leaves


@pytest.mark.parametrize("linear_proj", [False, True])
def test_converter_reads_both_proj_in_forms(tiny_unet, linear_proj):
    """A synthetic sgm-layout UNet state dict through the port's
    `convert_refiner_unet`: the same tree as JAX's converter gives (conv
    proj_in / proj_out), and with the (C, C) Linear weights that
    `use_linear_in_transformer` files hold (the public sd_xl_refiner.yaml)
    the same tree again: a 2-D weight is the same per-pixel map as the
    1x1 conv. Loaded into the port, the forward equals that of the conv
    form."""
    names = _ldm_names_for(TINY)
    rng = np.random.default_rng(3)
    sd = {k: (rng.standard_normal(v) / np.sqrt(np.prod(v[1:]) if len(v) > 1 else 10.0))
          .astype(np.float32) for k, v in names.items()}
    want = jtc.convert_refiner_unet(sd, TINY)
    if linear_proj:
        sd = {k: (v[:, :, 0, 0] if ".proj_" in k and v.ndim == 4 else v) for k, v in sd.items()}
        n_attn = sum(s.kind == "attn" for blk in jref.build_refiner_plan(TINY)[0]
                     + [jref.build_refiner_plan(TINY)[1]] + jref.build_refiner_plan(TINY)[2]
                     for s in blk)
        assert sum(v.ndim == 2 and ".proj_" in k for k, v in sd.items()) == 2 * n_attn == 14
    got = ptc.convert_refiner_unet(sd, TINY)
    jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)
    model = pref.RefinerUNet(_port_cfg(pconfig.RefinerUNetConfig, TINY))
    load_jax_params(model, unet=got)
    _, _, (x, t, ctx, y), _ = tiny_unet
    t_ = torch.from_numpy
    out = pref.apply_refiner_unet(model, t_(x), t_(t).long(), t_(ctx), t_(y))
    assert bool(out.isfinite().all())


def test_split_refiner_ckpt_and_from_checkpoint(tmp_path, monkeypatch):
    """`split_refiner_ckpt` splits an sgm file by prefix as JAX's does, and
    `from_checkpoint` loads a synthetic safetensors-free torch file of that
    layout (Linear proj_in / proj_out) into all three modules."""
    jt = jconfig.OpenCLIPTextConfig(**E2E_TEXT)
    ju = jconfig.RefinerUNetConfig(**E2E_UNET)
    jv = jconfig.VAEConfig(**E2E_VAE)
    rng = np.random.default_rng(4)
    unet_sd = {k: rng.standard_normal(v).astype(np.float32) * 0.05
               for k, v in _ldm_names_for(ju).items()}
    unet_sd = {k: (v[:, :, 0, 0] if ".proj_" in k and v.ndim == 4 else v)
               for k, v in unet_sd.items()}
    pipe = ppr.SDXLRefinerPipeline.random_init(
        seed=1, device="cpu", dtype=torch.float32,
        unet_cfg=_port_cfg(pconfig.RefinerUNetConfig, ju),
        text_cfg=_port_cfg(pconfig.OpenCLIPTextConfig, jt),
        vae_cfg=_port_cfg(pconfig.VAEConfig, jv))
    from instancediffusion_tpu_torch.io.checkpoint import reference_state_dict

    vae_sd = {k[len("first_stage_model."):]: v.numpy() for k, v in
              reference_state_dict(None, pipe.vae, None).items()
              if k.startswith("first_stage_model.")}
    full = {**{"model.diffusion_model." + k: v for k, v in unet_sd.items()},
            **{"conditioner.embedders.0.model." + k: v
               for k, v in _openclip_sd(jt, rng).items()},
            **{"first_stage_model." + k: v for k, v in vae_sd.items()},
            "denoiser.sigmas": np.ones(3, np.float32)}
    parts_p, parts_j = ptc.split_refiner_ckpt(full), jtc.split_refiner_ckpt(full)
    assert {k: sorted(v) for k, v in parts_p.items()} == {k: sorted(v) for k, v in
                                                         parts_j.items()}
    path = tmp_path / "refiner.pth"
    torch.save({k: torch.from_numpy(v) for k, v in full.items()}, path)
    monkeypatch.setattr(ppr, "RefinerUNetConfig", lambda: pipe.cfg)
    monkeypatch.setattr(ppr, "OpenCLIPTextConfig", lambda: pipe.text_cfg)
    monkeypatch.setattr(ppr, "REFINER_VAE", pipe.vae_cfg)
    loaded = ppr.SDXLRefinerPipeline.from_checkpoint(str(path), device="cpu",
                                                     dtype=torch.float32)
    w = unet_sd["input_blocks.3.1.proj_in.weight"]
    assert w.ndim == 2
    assert torch.equal(loaded.unet.input_blocks[3][1].proj_in.weight[:, :, 0, 0],
                       torch.from_numpy(w))
    assert torch.equal(loaded.text.text_projection.weight,
                       torch.from_numpy(full["conditioner.embedders.0.model.text_projection"].T))
    for (n, a), (_, b) in zip(loaded.vae.named_parameters(), pipe.vae.named_parameters()):
        assert torch.equal(a, b), n


# -- refine end to end ----------------------------------------------------------


class _Fp32Numpy:
    """jax.numpy with `bfloat16` read as float32. JAX's refine fixes its
    compute dtype to bf16; the test runs the same function in float32, as
    the port computes on the CPU."""

    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture(scope="module")
def e2e():
    """(JAX pipeline, port pipeline) on the same densified tiny weights."""
    ju = jconfig.RefinerUNetConfig(**E2E_UNET)
    jt = jconfig.OpenCLIPTextConfig(**E2E_TEXT)
    jv = jconfig.VAEConfig(**E2E_VAE)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    trees = {"unet": densify_tree(jref.init_refiner_unet(k1, ju), 11),
             "vae": densify_tree(jvae.init_vae(k2, jv), 12),
             "text": densify_tree(jclip.init_clip_text(k3, jt), 13)}
    jpipe = jpr.SDXLRefinerPipeline(
        jpr.RefinerParams(**{k: to_jax(v) for k, v in trees.items()}), ju, jt, jv)
    ppipe = ppr.SDXLRefinerPipeline.random_init(
        seed=0, device="cpu", dtype=torch.float32,
        unet_cfg=_port_cfg(pconfig.RefinerUNetConfig, ju),
        text_cfg=_port_cfg(pconfig.OpenCLIPTextConfig, jt),
        vae_cfg=_port_cfg(pconfig.VAEConfig, jv))
    load_jax_params(ppipe, **trees)
    return jpipe, ppipe


def test_refine_matches_jax_on_the_same_noise(e2e, monkeypatch):
    """`refine` of two 64 px images (4 DDIM steps at strength 0.5: 2 kept,
    CFG 5, aesthetic 6.0 / 2.5) against JAX's on JAX's own noise
    (`normal(PRNGKey(seed))`, passed in), both in float32: the CLI's uint8
    conversion (truncation) within one level."""
    jpipe, ppipe = e2e
    monkeypatch.setenv("IDTPU_ALLOW_HASH_TOKENIZER", "1")
    monkeypatch.setattr(jpr, "jnp", _Fp32Numpy())
    imgs = np.random.default_rng(5).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    kw = dict(prompt="a photo of a cat", negative_prompt="blurry", steps=4, strength=0.5,
              seed=3)
    want = jpipe.refine(imgs, **kw)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (2, 8, 8, 4), jnp.float32))
    got = ppipe.refine(imgs, noise=noise, **kw)
    assert got.shape == want.shape == (2, 64, 64, 3) and got.dtype == np.float32
    u8 = lambda a: (a * 255).astype(np.uint8)
    assert int(u8(want).max()) - int(u8(want).min()) > 10
    assert np.abs(u8(got).astype(int) - u8(want).astype(int)).max() <= 1
    assert set(ppipe.last_timings) == {"text_encode", "sample"}


def test_refine_draws_its_noise_from_the_seed(e2e, monkeypatch):
    """Without `noise` the forward noise comes from a generator seeded with
    `seed`: the same seed gives the same images, another seed others; the
    hash tokenizer is refused unless allowed."""
    _, ppipe = e2e
    imgs = np.random.default_rng(6).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    monkeypatch.delenv("IDTPU_ALLOW_HASH_TOKENIZER", raising=False)
    with pytest.raises(RuntimeError):
        ppipe.refine(imgs, "x", steps=4, strength=0.5)
    monkeypatch.setenv("IDTPU_ALLOW_HASH_TOKENIZER", "1")
    a, b, c = (ppipe.refine(imgs, "x", steps=4, strength=0.5, seed=s) for s in (1, 1, 2))
    assert np.array_equal(a, b) and not np.array_equal(a, c)


# -- the CLI's cascade ----------------------------------------------------------


def test_cli_cascade_strength_writes_refined_pngs(e2e, tmp_path, monkeypatch):
    """`--cascade_strength 0.35` refines the CLI's images through the
    refiner (seeded random weights here at the tiny widths): files named as
    JAX's CLI names them, `{n}_xl_s{strength}_n20.png` beside `{n}.png`,
    returned first; uint8 PNGs equal to `(refine(images / 255) * 255)
    .astype(uint8)` (truncation) of the same weights."""
    from tests.test_torch_inference import cli_config
    from tests.test_torch_bridge import port_config

    _, ppipe = e2e
    monkeypatch.setenv("IDTPU_ALLOW_HASH_TOKENIZER", "1")
    monkeypatch.setattr(pinf, "Config", lambda: port_config(cli_config()))
    monkeypatch.setattr(ppr.SDXLRefinerPipeline, "random_init",
                        classmethod(lambda cls, **kw: ppipe))
    demo = os.path.join(REPO, "demos", "demo_kitchen_cat.json")
    out = tmp_path / "out"
    args = ["--input_json", demo, "--device", "cpu", "--steps", "2", "--num_images", "2",
            "--output", str(out), "--mis", "0"]
    paths = pinf.main(args + ["--cascade_strength", "0.35"])
    folder = out / "gc7.5-seed0-alpha0.75"
    assert sorted(os.listdir(folder)) == ["0.png", "0_boxes.png", "0_xl_s0.35_n20.png", "1.png",
                                          "1_xl_s0.35_n20.png"]
    assert paths == [str(folder / n) for n in ("0_xl_s0.35_n20.png", "1_xl_s0.35_n20.png",
                                               "0.png", "1.png")]
    base = np.stack([read_png((folder / f"{i}.png").read_bytes()) for i in range(2)])
    with open(demo) as f:
        import json
        prompt = json.load(f)["caption"]
    want = (ppipe.refine(base.astype(np.float32) / 255.0, prompt, strength=0.35, steps=20)
            * 255).astype(np.uint8)
    for i in range(2):
        got = read_png((folder / f"{i}_xl_s0.35_n20.png").read_bytes())
        assert got.dtype == np.uint8 and got.shape == base.shape[1:]
        np.testing.assert_array_equal(got, want[i])
