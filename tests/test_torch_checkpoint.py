"""Checkpoint files in the port (io/torch_convert, io/checkpoint,
pipeline.from_checkpoint, the training state's save and resume) against
the JAX package's converters and loaders and the parameter bridge, on the
CPU.

The files are written from densified random weights (numpy, the JAX
package's tree structure): `io/checkpoint.reference_state_dict` turns the
port's modules into reference key names, and the JAX package's own
converters anchor it. Every comparison of weights is exact: the converters
only rename and transpose.
"""

import dataclasses
import os
import re

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from instancediffusion_tpu.io import checkpoint as jckpt
from instancediffusion_tpu.io import torch_convert as jtc
from instancediffusion_tpu.models import clip_text as jclip
from instancediffusion_tpu.models import unet as junet
from instancediffusion_tpu.models import vae as jvae
from instancediffusion_tpu_torch.io import checkpoint as pckpt
from instancediffusion_tpu_torch.io import torch_convert as ptc
from instancediffusion_tpu_torch.io.jax_params import load_jax_params
from instancediffusion_tpu_torch.models import clip_text, unet, vae
from instancediffusion_tpu_torch.ops.schedules import make_diffusion_schedule
from instancediffusion_tpu_torch.pipeline import InstanceDiffusionPipeline
from instancediffusion_tpu_torch.train import optimizer as popt
from instancediffusion_tpu_torch.train import train_step as pts

from tests.test_pipeline import tiny_config
from tests.test_torch_bridge import _leaves, densify_tree, port_config

PREFIX = {"unet": "model.diffusion_model.", "vae": "first_stage_model.",
          "clip": "cond_stage_model."}
# the training form's component names
TRAIN_FORM = {"unet": "model", "vae": "autoencoder", "clip": "text_encoder"}


def ckpt_config(**grounding):
    """tiny_config with ConvNeXt-T in UniFusion's seg branch: the reference
    checkpoint format, and so both packages' converters, fixes ConvNeXt-T's
    four stages. Its seg features at the tiny seg size 64 are 2*2*768 wide.
    `grounding` overrides further UniFusion fields."""
    cfg = tiny_config()
    g = dataclasses.replace(cfg.model.grounding_tokenizer, convnext_depths=(3, 3, 9, 3),
                            convnext_dims=(96, 192, 384, 768), convnext_feature_dim=3072,
                            **grounding)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, grounding_tokenizer=g))


def reference_trees(cfg, seed: int) -> dict:
    """Densified numpy trees {"unet", "vae" (with its encoder), "clip"} in
    the JAX package's structure (its initialisers' shapes; values from
    numpy)."""
    k = jax.random.PRNGKey(0)
    shapes = {"unet": jax.eval_shape(lambda: junet.init_unet(k, cfg.model)),
              "vae": jax.eval_shape(lambda: jvae.init_vae(k, cfg.autoencoder)),
              "clip": jax.eval_shape(lambda: jclip.init_clip_text(k, cfg.text_encoder))}
    return {name: densify_tree(s, seed + i) for i, (name, s) in enumerate(shapes.items())}


def bridged_modules(cfg, trees, dtype=torch.float32) -> dict:
    """Port modules (the VAE with its encoder) holding the trees."""
    pc = port_config(cfg)
    gen = torch.Generator().manual_seed(0)
    mods = {"unet": unet.UNet(pc.model, generator=gen),
            "vae": vae.AutoencoderKL(pc.autoencoder, encoder=True, generator=gen),
            "clip": clip_text.CLIPTextModel(pc.text_encoder, generator=gen)}
    for name, m in mods.items():
        load_jax_params(m, **{name: trees[name]})
        m.to(dtype)
    return mods


def first_conv(mods) -> dict:
    conv = mods["unet"].first_conv_sd
    return {"weight": conv.weight.detach().clone(), "bias": conv.bias.detach().clone()}


def training_form(flat: dict, other: dict | None = None) -> dict:
    """The reference training form of a flat SD-form dict; with `other`,
    the flat dict's UNet goes under "ema" and other's under "model"."""
    strip = lambda d, prefix: {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}
    out = {TRAIN_FORM[name]: strip(flat, prefix) for name, prefix in PREFIX.items()}
    if other is not None:
        out["ema"], out["model"] = out["model"], strip(other, PREFIX["unet"])
    out["iters"] = 1234  # a non-tensor entry, as reference checkpoints carry
    return out


def assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:10]
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)


def assert_modules_equal(a: torch.nn.Module, b: torch.nn.Module):
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    assert set(pa) == set(pb)
    for k in pa:
        assert pa[k].dtype == pb[k].dtype, k
        assert torch.equal(pa[k], pb[k]), k


@pytest.fixture(scope="module")
def setup():
    """(cfg, trees, modules, flat SD-form dict, other trees' flat dict)."""
    cfg = ckpt_config()
    trees = reference_trees(cfg, 1)
    mods = bridged_modules(cfg, trees)
    other = pckpt.reference_state_dict(**bridged_modules(cfg, reference_trees(cfg, 40)))
    return cfg, trees, mods, pckpt.reference_state_dict(**mods), other


def _write(path, form: str, flat: dict, other: dict) -> str:
    if form == "flat":
        torch.save(flat, path)
    elif form == "wrapped":
        torch.save({"state_dict": flat, "global_step": 7}, path)
    elif form == "safetensors":
        from safetensors.torch import save_file

        path = path + ".safetensors"
        save_file({k: v.contiguous() for k, v in flat.items()}, path)
    elif form == "training_ema":  # `model` holds other weights: the EMA must win
        torch.save(training_form(flat, other), path)
    elif form == "training":
        torch.save(training_form(flat), path)
    return path


@pytest.mark.parametrize("form", ["flat", "training_ema"])
def test_reference_state_dict_inverts_jax_converters(setup, tmp_path, monkeypatch, form):
    """JAX's own loader (its converters behind load_pipeline_params) reads
    the helper's files back into the trees they came from, leaf for leaf,
    in the flat SD form and in the training form; the stock first conv
    comes from pretrained/ in the working directory."""
    cfg, trees, mods, flat, other = setup
    monkeypatch.chdir(tmp_path)
    os.makedirs("pretrained")
    torch.save(first_conv(mods), pckpt.FIRST_CONV_FILE)
    path = _write(str(tmp_path / "ckpt.pth"), form, flat, other)
    got = jckpt.load_pipeline_params(path, cfg)
    assert_trees_equal(got.unet, trees["unet"])
    assert_trees_equal(got.vae, trees["vae"])
    assert_trees_equal(got.clip, trees["clip"])
    # and the JAX converters alone on the split flat dict
    parts = jtc.split_official_ckpt(jtc.to_numpy_state_dict(flat))
    assert_trees_equal(jtc.convert_vae(parts["autoencoder"], cfg.autoencoder), trees["vae"])
    assert_trees_equal(jtc.convert_clip_text(parts["text_encoder"], cfg.text_encoder),
                       trees["clip"])


@pytest.mark.parametrize("form", ["flat", "wrapped", "safetensors", "training", "training_ema"])
def test_from_checkpoint_equals_the_bridge(setup, tmp_path, form):
    """from_checkpoint(device="cpu", dtype=float32) on every file form
    holds exactly the weights load_jax_params puts in from the JAX
    package's trees (the training form's EMA, not its model)."""
    cfg, trees, mods, flat, other = setup
    path = _write(str(tmp_path / "ckpt.pth"), form, flat, other)
    pc = port_config(cfg)
    pipe = InstanceDiffusionPipeline.from_checkpoint(path, pc, device="cpu", dtype=torch.float32,
                                                     vae_encoder=True)
    for name in ("vae", "clip"):
        assert_modules_equal(getattr(pipe, name), mods[name])
    # without a pretrained/ first conv, the stock conv is the trained one
    ref = bridged_modules(cfg, dict(trees, unet=dict(
        trees["unet"], first_conv_sd=trees["unet"]["input_blocks"][0][0]["conv"])))
    assert_modules_equal(pipe.unet, ref["unet"])


def test_from_checkpoint_first_conv_file_and_decoder_only_vae(setup, tmp_path, monkeypatch):
    """A pretrained/SD_v1_5_input_conv_weight_bias.pth under the working
    directory becomes the UNet's stock first conv; without vae_encoder the
    VAE holds the decoding half only."""
    cfg, trees, mods, flat, other = setup
    path = _write(str(tmp_path / "ckpt.pth"), "flat", flat, other)
    monkeypatch.chdir(tmp_path)
    os.makedirs("pretrained")
    torch.save(first_conv(mods), pckpt.FIRST_CONV_FILE)
    pipe = InstanceDiffusionPipeline.from_checkpoint(path, port_config(cfg), device="cpu",
                                                     dtype=torch.float32)
    assert_modules_equal(pipe.unet, mods["unet"])
    assert not hasattr(pipe.vae, "encoder")
    params = dict(pipe.vae.named_parameters())
    want = dict(mods["vae"].named_parameters())
    assert set(params) < set(want)
    for k, v in params.items():
        assert torch.equal(v, want[k]), k


def test_from_checkpoint_bf16_file_is_bit_exact(setup, tmp_path):
    """A bf16 file loads into bf16 weights bit for bit (bf16 -> float32 ->
    bf16 is exact), as the card's smoke checks at full width."""
    cfg, trees, mods, flat, other = setup
    mods16 = bridged_modules(cfg, trees, dtype=torch.bfloat16)
    path = str(tmp_path / "ckpt16.pth")
    torch.save(pckpt.reference_state_dict(**mods16), path)
    pipe = InstanceDiffusionPipeline.from_checkpoint(path, port_config(cfg), device="cpu",
                                                     dtype=torch.bfloat16, vae_encoder=True)
    for name in ("vae", "clip"):
        assert_modules_equal(getattr(pipe, name), mods16[name])
    p16 = dict(pipe.unet.named_parameters())
    for k, v in mods16["unet"].named_parameters():
        if not k.startswith("first_conv_sd."):
            assert v.dtype == p16[k].dtype == torch.bfloat16 and torch.equal(v, p16[k]), k


@pytest.mark.parametrize("key", [
    "model.diffusion_model.scaleu_b_0",
    "model.diffusion_model.input_blocks.1.1.transformer_blocks.0.fuser.alpha_attn",
    "model.diffusion_model.position_net.convnext_tiny_backbone.stages.2.8.gamma",
    "model.diffusion_model.output_blocks.1.0.in_layers.2.weight",
    "first_stage_model.decoder.conv_out.weight",
    "cond_stage_model.transformer.text_model.encoder.layers.1.mlp.fc2.weight",
])
def test_missing_key_raises_naming_it(setup, tmp_path, key):
    """A file without a key the configuration needs raises KeyError naming
    it (a plain SD1.5 file lacks the InstanceDiffusion keys): never a
    half-random model."""
    cfg, trees, mods, flat, other = setup
    assert key in flat
    path = str(tmp_path / "ckpt.pth")
    torch.save({k: v for k, v in flat.items() if k != key}, path)
    stripped = next(key[len(p):] for p in PREFIX.values() if key.startswith(p))
    with pytest.raises(KeyError, match=re.escape(stripped)):
        InstanceDiffusionPipeline.from_checkpoint(path, port_config(cfg), device="cpu",
                                                  dtype=torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16, torch.int64])
def test_read_safetensors_equals_the_library(tmp_path, dtype):
    """The numpy reader against safetensors.torch.load_file: the same names,
    shapes (a scalar and an empty tensor among them) and values; bf16 upcast
    to float32, as the JAX package's loader does."""
    from safetensors.torch import load_file, save_file

    g = torch.Generator().manual_seed(0)
    sd = {"a.weight": torch.randn(5, 3, generator=g), "b": torch.randn(2, 1, 3, 3, generator=g),
          "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 4)}
    sd = {k: (v * 100).to(dtype) for k, v in sd.items()}
    path = str(tmp_path / "t.safetensors")
    save_file(sd, path, metadata={"format": "pt"})
    got = ptc.read_safetensors(path)
    want = ptc.to_numpy_state_dict(load_file(path))
    assert set(got) == set(want) == set(sd)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k])
        if dtype == torch.bfloat16:
            assert got[k].dtype == np.float32
    # and the JAX package's loader reads the same file to the same arrays
    jax_got = jtc.load_torch_checkpoint(path)
    for k in want:
        np.testing.assert_array_equal(got[k], jax_got[k])


def test_load_torch_checkpoint_matches_jax(tmp_path):
    """The pickle form with a state_dict wrapper, fp16 kept, bf16 upcast."""
    sd = {"model.diffusion_model.w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
          "half": torch.full((4,), 1.5, dtype=torch.float16),
          "bf16": torch.full((3,), 2.0, dtype=torch.bfloat16)}
    path = str(tmp_path / "ckpt.pth")
    torch.save({"state_dict": sd}, path)
    got, want = ptc.load_torch_checkpoint(path), jtc.load_torch_checkpoint(path)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_expt_folder_with_auto_resume_matches_jax(tmp_path):
    """The same tagXX folders and previous checkpoints as the JAX package's
    in the same sequence of restarts (a restart that saved nothing leaves
    no checkpoint to resume)."""
    roots = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    fns = {"jax": jckpt.expt_folder_with_auto_resume,
           "port": pckpt.expt_folder_with_auto_resume}
    for save in (True, False, True, True):
        got = {}
        for side, fn in fns.items():
            folder, prev = fn(roots[side], "run")
            if save:
                open(os.path.join(folder, "checkpoint_latest"), "w").close()
            got[side] = (os.path.relpath(folder, roots[side]),
                         prev and os.path.relpath(prev, roots[side]))
        assert got["jax"] == got["port"], got


# -- training state --------------------------------------------------------

IMAGE, BATCH = 16, 2


def _train_state(cfg, seed: int):
    """A tiny training state: densified fp32 weights, AdamW with a 3-step
    warm-up (so the LR moves every step), frozen weights bf16."""
    state = pts.init_train_state(cfg, seed=seed, device="cpu")
    for i, m in enumerate((state.unet, state.vae, state.clip)):
        chip_smoke.densify_(m, seed * 10 + i)
    state.ema = popt.init_ema(state.unet)
    state.optimizer, state.scheduler = popt.make_optimizer(state.unet, 1e-3, warmup_steps=3)
    return pts.cast_frozen_bf16(state)


def _batch(cfg):
    r = np.random.default_rng(0)
    g = cfg.model.grounding_tokenizer
    n, b, s = cfg.model.max_objs, BATCH, g.seg_resize_input
    lo = r.uniform(0, 0.5, (b, n, 2))
    out = {
        "image": r.standard_normal((b, IMAGE, IMAGE, 3)) * 0.5,
        "boxes": np.concatenate([lo, lo + r.uniform(0.2, 0.5, (b, n, 2))], -1),
        "masks": np.ones((b, n)),
        "text_embeddings": r.standard_normal((b, n, g.in_dim)),
        "scribbles": r.uniform(0, 1, (b, n, g.n_scribble_points * 2)),
        "polygons": r.uniform(0, 1, (b, n, g.n_polygon_points * 2)),
        "segs": r.uniform(size=(b, n, s, s)) > 0.7,
        "points": r.uniform(0, 1, (b, n, 2)),
    }
    out = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in out.items()}
    out["caption_ids"] = torch.from_numpy(
        r.integers(0, cfg.text_encoder.vocab_size, (b, 77)).astype(np.int64))
    return out


@pytest.fixture(scope="module")
def train_setup():
    cfg = port_config(tiny_config())
    d = cfg.diffusion
    step = pts.make_train_step(cfg, make_diffusion_schedule(
        d.beta_schedule, d.timesteps, d.linear_start, d.linear_end))
    gen = torch.Generator().manual_seed(0)
    draws = [pts.sample_draws(gen, BATCH, pts.latent_shape(cfg, IMAGE)) for _ in range(2)]
    for dr in draws:  # every group takes part in both steps
        dr.drop_all = False
    return cfg, step, _batch(cfg), draws


def test_save_restore_resumes_training(train_setup, tmp_path):
    """Two steps straight equal one step, save, restore into a fresh state
    (other random weights), one step: the same loss, parameters, EMA,
    optimizer moments, step counts and learning rate, with the frozen
    weights still bf16 and the Parameter objects the optimizer holds
    the ones restored into."""
    cfg, step, batch, draws = train_setup
    straight = _train_state(cfg, seed=1)
    for dr in draws:
        straight, m_straight = step(straight, batch, dr)

    first = _train_state(cfg, seed=1)
    first, _ = step(first, batch, draws[0])
    folder, prev = pckpt.expt_folder_with_auto_resume(str(tmp_path), "run")
    assert prev is None
    pckpt.save_train_ckpt(folder, first, {"lr": 1e-3})
    assert os.path.exists(os.path.join(folder, "config.json"))
    folder2, prev = pckpt.expt_folder_with_auto_resume(str(tmp_path), "run")
    assert prev == os.path.join(folder, "checkpoint_latest") and folder2 != folder

    resumed = _train_state(cfg, seed=2)
    held = list(resumed.optimizer.param_groups[0]["params"])
    resumed = pckpt.restore_train_ckpt(prev, resumed)
    assert resumed.step == 1 and resumed.scheduler.last_epoch == 1
    resumed, m_resumed = step(resumed, batch, draws[1])

    assert torch.equal(m_straight["loss"], m_resumed["loss"])
    assert resumed.step == straight.step == 2
    assert all(a is b for a, b in zip(held, resumed.optimizer.param_groups[0]["params"]))
    assert_modules_equal(resumed.unet, straight.unet)
    assert_modules_equal(resumed.vae, straight.vae)
    assert_modules_equal(resumed.clip, straight.clip)
    for name, p in resumed.unet.named_parameters():
        assert p.dtype == (torch.float32 if popt.is_trainable(name) else torch.bfloat16), name
    assert set(resumed.ema) == set(straight.ema)
    for k in straight.ema:
        assert resumed.ema[k].dtype == torch.float32 and torch.equal(resumed.ema[k],
                                                                     straight.ema[k]), k
    sa, sb = straight.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert set(sa["state"]) == set(sb["state"])
    for i in sa["state"]:
        for k, v in sa["state"][i].items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
    assert straight.scheduler.get_last_lr() == resumed.scheduler.get_last_lr()
    assert straight.scheduler.last_epoch == resumed.scheduler.last_epoch == 2


def test_restore_without_frozen_encoders(train_setup, tmp_path):
    """A checkpoint saved without the VAE/CLIP raises on restore when the
    caller has no pretrained encoders (random frozen encoders would train
    garbage) and keeps the caller's own otherwise."""
    cfg, step, batch, draws = train_setup
    state = _train_state(cfg, seed=1)
    state.vae = state.clip = None
    path = pckpt.save_train_ckpt(str(tmp_path), state, None)
    payload = torch.load(path, map_location="cpu", weights_only=False)
    assert "vae" not in payload and "clip" not in payload

    fresh = _train_state(cfg, seed=2)
    with pytest.raises(RuntimeError, match="lacks frozen VAE/CLIP"):
        pckpt.restore_train_ckpt(path, fresh, have_pretrained=False)
    fresh = _train_state(cfg, seed=2)
    own = {k: v.clone() for k, v in fresh.vae.named_parameters()}
    fresh = pckpt.restore_train_ckpt(path, fresh, have_pretrained=True)
    assert all(torch.equal(v, own[k]) for k, v in fresh.vae.named_parameters())
    assert_modules_equal(fresh.unet, state.unet)
