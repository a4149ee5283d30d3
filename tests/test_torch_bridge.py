"""The JAX -> PyTorch parameter bridge (instancediffusion_tpu_torch.io.jax_params),
the port's copy of the config, and the helpers the port's parity tests
share: densified random weights drawn once with numpy and handed to both
packages, and a JAX config carried over into the port's."""

import dataclasses
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from instancediffusion_tpu import config as jconfig
from instancediffusion_tpu.models import clip_text as jclip
from instancediffusion_tpu.models import unet as junet
from instancediffusion_tpu.models import vae as jvae
from instancediffusion_tpu_torch import config as pconfig
from instancediffusion_tpu_torch.io.jax_params import load_jax_params
from instancediffusion_tpu_torch.models import clip_text, unet, vae

from tests.test_pipeline import tiny_config

_GATES = ("alpha_attn", "alpha_dense")


def densify_tree(tree, seed: int):
    """Redraw every leaf of a JAX parameter tree from a seeded normal, as
    float32 numpy. Random init zeroes the UNet's output convs, the fuser
    gates (tanh(0) = 0) and ScaleU (identity), which would hide every error
    behind them. Weights `w`: N(0, 1/fan_in); norm scales 1 + N(0, 0.1);
    fuser gates and ScaleU: N(0, 0.5); everything else N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def draw(shape, key, under_scaleu):
        z = rng.standard_normal(shape)
        if key in _GATES or under_scaleu:
            return 0.5 * z
        if key == "w":
            return z / np.sqrt(np.prod(shape[:-1]))
        if key == "scale":
            return 1.0 + 0.1 * z
        return 0.1 * z

    def walk(node, key, under_scaleu):
        if isinstance(node, dict):
            return {k: walk(v, k, under_scaleu or k == "scaleu") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, key, under_scaleu) for v in node]
        return draw(np.shape(node), key, under_scaleu).astype(np.float32)

    return walk(tree, None, False)


def to_jax(tree):
    return jax.tree_util.tree_map(jax.numpy.asarray, tree)


def dense_params(cfg, seed=0):
    """Densified numpy trees {"unet", "vae", "clip"} for a config (the VAE
    tree holds the decoding half the port has)."""
    k = jax.random.PRNGKey(seed)
    vae_tree = jvae.init_vae(k, cfg.autoencoder)
    return {
        "unet": densify_tree(junet.init_unet(k, cfg.model), seed + 1),
        "vae": densify_tree({"decoder": vae_tree["decoder"],
                             "post_quant_conv": vae_tree["post_quant_conv"]}, seed + 2),
        "clip": densify_tree(jclip.init_clip_text(k, cfg.text_encoder), seed + 3),
    }


_SECTIONS = ("diffusion", "model", "autoencoder", "text_encoder", "sampler", "data", "train")


def port_config(cfg):
    """The port's Config holding the values of a JAX package Config."""
    return pconfig.load_config(
        overrides={s: dataclasses.asdict(getattr(cfg, s)) for s in _SECTIONS})


def port_modules(cfg):
    """Port modules for a JAX package config (random weights)."""
    cfg = port_config(cfg)
    gen = torch.Generator().manual_seed(0)
    return {
        "unet": unet.UNet(cfg.model, generator=gen),
        "vae": vae.AutoencoderKL(cfg.autoencoder, generator=gen),
        "clip": clip_text.CLIPTextModel(cfg.text_encoder, generator=gen),
    }


@pytest.fixture(scope="module")
def bridged():
    cfg = tiny_config()
    return cfg, dense_params(cfg), port_modules(cfg)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


@pytest.mark.parametrize("part", ["unet", "vae", "clip"])
def test_bridge_maps_every_leaf(bridged, part):
    """Every JAX leaf lands in exactly one port parameter, in the port's
    layout, and every port parameter is set."""
    cfg, trees, mods = bridged
    load_jax_params(mods[part], **{part: trees[part]})
    params = dict(mods[part].named_parameters())
    seen = set()
    for path, arr in _leaves(trees[part]):
        head, _, key = path.rpartition(".")
        owner = mods[part].get_submodule(head) if head else mods[part]
        if key == "w" and arr.ndim == 4:
            name, want = "weight", arr.transpose(3, 2, 0, 1)
        elif key == "w":
            name, want = "weight", arr.T
        elif key == "b" and hasattr(owner, "weight"):
            name, want = "bias", arr
        elif key == "scale":
            name, want = "weight", arr
        else:
            name, want = key, arr
        full = f"{head}.{name}" if head else name
        np.testing.assert_array_equal(params[full].detach().numpy(), want, err_msg=full)
        seen.add(full)
    assert seen == set(params)


def test_bridge_missing_leaf_raises(bridged):
    cfg, trees, _ = bridged
    tree = dict(trees["unet"])
    tree["out"] = {"norm": tree["out"]["norm"], "conv": {"w": tree["out"]["conv"]["w"]}}
    with pytest.raises(KeyError, match="out.conv.bias"):
        load_jax_params(port_modules(cfg)["unet"], unet=tree)


def test_bridge_unknown_leaf_raises(bridged):
    cfg, trees, _ = bridged
    tree = dict(trees["clip"])
    tree["text_projection"] = {"w": np.zeros((32, 32), np.float32)}
    with pytest.raises(KeyError, match="text_projection"):
        load_jax_params(port_modules(cfg)["clip"], clip=tree)


def test_bridge_shape_mismatch_raises(bridged):
    cfg, trees, _ = bridged
    tree = dict(trees["clip"])
    tree["final_ln"] = {"scale": np.ones(7, np.float32), "bias": np.zeros(7, np.float32)}
    with pytest.raises(ValueError, match="final_ln.weight"):
        load_jax_params(port_modules(cfg)["clip"], clip=tree)


@pytest.mark.parametrize("preset", [None, "box", "mask"])
def test_port_config_matches_jax(preset):
    """The port's copy of the config has the JAX package's defaults and
    presets, and carries a reduced JAX config over unchanged."""
    jcfg, pcfg = jconfig.Config(), pconfig.Config()
    if preset:
        jcfg = jconfig.apply_test_preset(jcfg, preset)
        pcfg = pconfig.apply_test_preset(pcfg, preset)
    for s in _SECTIONS:
        assert dataclasses.asdict(getattr(pcfg, s)) == dataclasses.asdict(getattr(jcfg, s)), s
    tiny = tiny_config()
    for s in _SECTIONS:
        assert (dataclasses.asdict(getattr(port_config(tiny), s))
                == dataclasses.asdict(getattr(tiny, s))), s
    assert pconfig.TEST_PRESETS == jconfig.TEST_PRESETS


@pytest.mark.parametrize("name", ["RefinerUNetConfig", "OpenCLIPTextConfig"])
def test_port_refiner_config_matches_jax(name):
    """The port's copies of the SDXL refiner's UNet and OpenCLIP-bigG
    configs have the JAX package's defaults, field for field."""
    assert (dataclasses.asdict(getattr(pconfig, name)())
            == dataclasses.asdict(getattr(jconfig, name)()))


def test_port_config_rejects_unknown_keys():
    with pytest.raises(KeyError, match="refiner"):
        pconfig.load_config(overrides={"refiner": {"steps": 2}})
    with pytest.raises(KeyError, match="batch"):
        pconfig.load_config(overrides={"train": {"batch": 2}})
    with pytest.raises(KeyError, match="max_boxes"):
        pconfig.load_config(overrides={"model": {"max_boxes": 2}})


def test_port_import_leaves_jax_out():
    """Importing every port module imports neither JAX nor the JAX package,
    nor PIL, cv2 or safetensors: the port needs none of them (fresh
    interpreter)."""
    code = (
        "import sys\n"
        "import instancediffusion_tpu_torch.pipeline, instancediffusion_tpu_torch.io.jax_params\n"
        "import instancediffusion_tpu_torch.kernels.flash_attention\n"
        "import instancediffusion_tpu_torch.kernels.geglu_ff\n"
        "import instancediffusion_tpu_torch.kernels.head_layout\n"
        "import instancediffusion_tpu_torch.serve, instancediffusion_tpu_torch.inference\n"
        "import instancediffusion_tpu_torch.io.checkpoint, instancediffusion_tpu_torch.io.lora\n"
        "import instancediffusion_tpu_torch.io.torch_convert, instancediffusion_tpu_torch.io.png\n"
        "import instancediffusion_tpu_torch.data.geometry\n"
        "import instancediffusion_tpu_torch.samplers.dpm, instancediffusion_tpu_torch.samplers.ddim\n"
        "import instancediffusion_tpu_torch.launch, instancediffusion_tpu_torch.train.trainer\n"
        "import instancediffusion_tpu_torch.train.sample_saver\n"
        "import instancediffusion_tpu_torch.data.jsondataset, instancediffusion_tpu_torch.data.jpeg\n"
        "import instancediffusion_tpu_torch.data.resample, instancediffusion_tpu_torch.data._native\n"
        "import instancediffusion_tpu_torch.utils.logging\n"
        "import instancediffusion_tpu_torch.pipeline_refiner\n"
        "import instancediffusion_tpu_torch.models.sdxl_refiner\n"
        "import instancediffusion_tpu_torch.models.clip_vision\n"
        "import instancediffusion_tpu_torch.evalsuite.coco_eval\n"
        "import instancediffusion_tpu_torch.evalsuite.pim\n"
        "import instancediffusion_tpu_torch.evalsuite.attribute_binding\n"
        "import instancediffusion_tpu_torch.datagen.backends\n"
        "import instancediffusion_tpu_torch.datagen.label\n"
        "import instancediffusion_tpu_torch.datagen.coco_to_training_jsons\n"
        "import instancediffusion_tpu_torch.aot\n"
        "import instancediffusion_tpu_torch.datagen.backends_zoo\n"
        "banned = ('jax', 'instancediffusion_tpu', 'PIL', 'cv2', 'safetensors')\n"
        "mods = [m for m in sys.modules if m.split('.')[0] in banned]\n"
        "assert not mods, mods\n"
        "assert 'triton' not in sys.modules\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
