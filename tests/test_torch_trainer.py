"""The port's training driver against the JAX package's, on the CPU.

* Trainer: the JAX `Trainer` and the port's `Trainer` on the same tiny
  config, the same densified initial weights (JAX's trees carried into the
  port by `io/jax_params`), the same JSON records and the draws of JAX's key
  chain (`rng = PRNGKey(seed)`, `rng, sub = split(rng)` per step, then the
  step's own `split(sub, 8)` recipe) take 3 AdamW steps in float32 (JAX's
  `make_train_step` patched to compute_dtype float32 and its mesh to one
  device; frozen weights bf16 on both sides, as both Trainers cast them).
* `--official_ckpt` merge of a stock SD-form file (no new parameters).
* The sample grid against JAX's `save_train_samples` on the same initial
  noise (JAX's `normal(PRNGKey(seed + bi))`, float32 on both sides).
(The launcher's tests are in tests/test_torch_launch.py.)
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancediffusion_tpu.config import load_config as jax_load_config
from instancediffusion_tpu.models import clip_text as jclip
from instancediffusion_tpu.models import unet as junet
from instancediffusion_tpu.models import vae as jvae
from instancediffusion_tpu.parallel import mesh as jmesh
from instancediffusion_tpu.train import sample_saver as jsaver
from instancediffusion_tpu.train import train_step as jts
from instancediffusion_tpu.train import trainer as jtrainer
from instancediffusion_tpu_torch.config import load_config
from instancediffusion_tpu_torch.data import jsondataset as pds
from instancediffusion_tpu_torch.data.tokenizer import CLIPTokenizer
from instancediffusion_tpu_torch.io import checkpoint as ckpt_io
from instancediffusion_tpu_torch.io.jax_params import load_jax_params
from instancediffusion_tpu_torch.io.png import read_png
from instancediffusion_tpu_torch.models import unet, unifusion
from instancediffusion_tpu_torch.train import optimizer as popt
from instancediffusion_tpu_torch.train import sample_saver as psaver
from instancediffusion_tpu_torch.train import train_step as pts
from instancediffusion_tpu_torch.train import trainer as ptrainer

import chip_smoke
from tests.test_torch_bridge import densify_tree, to_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE = 16   # the decoded size: VAE /2, UNet latent 8
BATCH = 2
STEPS = 3
# the first step's loss, on equal weights: fp32 on both sides through the
# VAE encoder, CLIP, UniFusion and the UNet (as tests/test_torch_train.py)
LOSS_RTOL = 1e-4
# AdamW divides each coordinate's update by its own gradient's size, so a
# gradient at fp32 noise level (~1e-4 of the largest) moves its weight by up
# to lr either way: weights agree as a whole, not coordinate by coordinate.
# Trainable weights after 3 steps at lr 1e-3: ||port - JAX|| over the
# trainable subset within 10 % of ||JAX - init||, and the later losses
# (steps 2-3, on those weights) within 1e-3 relative
WEIGHT_REL = 0.1
LATER_LOSS_RTOL = 1e-3

# the dataset's fixed widths: 768-float phrase embeddings, 20 scribble and
# 256 polygon points; a tiny UNet and ConvNeXt
TINY = {
    "model": {"image_size": 8, "model_channels": 32, "num_heads": 4, "context_dim": 32,
              "max_objs": 4, "channel_mult": [1], "num_res_blocks": 1,
              "attention_resolutions": [1], "use_checkpoint": False,
              "grounding_tokenizer": {
                  "in_dim": 768, "out_dim": 32, "mid_dim": 32, "fourier_freqs": 4,
                  "fourier_freqs_polygons": 4, "n_scribble_points": 20,
                  "n_polygon_points": 256, "seg_channels": 4, "seg_resize_input": 64,
                  "convnext_depths": [1, 1], "convnext_dims": [8, 16],
                  "convnext_feature_dim": 1024}},
    "autoencoder": {"ch": 32, "ch_mult": [1, 2], "resolution": 64},
    "text_encoder": {"vocab_size": 512, "hidden_size": 32, "intermediate_size": 64,
                     "num_hidden_layers": 2, "num_attention_heads": 4},
    "data": {"image_size": IMAGE, "max_boxes_per_data": 4},
}


def _train(tmp_path, **kw):
    return dict(batch_size=BATCH, total_iters=STEPS, warmup_steps=0, base_learning_rate=1e-3,
                ckpt_every_iters=1000, save_every_iters=1000, output_dir=str(tmp_path),
                name="parity", seed=7, workers=2, **kw)


@pytest.fixture(scope="module")
def listing(tmp_path_factory):
    d = tmp_path_factory.mktemp("records")
    recs = chip_smoke.training_records(n=6, seed=2)
    for rec in recs:
        rec["annos"] = rec["annos"][:5]
    paths = []
    for i, rec in enumerate(recs):
        paths.append(str(d / f"{i}.json"))
        with open(paths[-1], "w") as f:
            json.dump(rec, f)
    (d / "train.txt").write_text("\n".join(paths) + "\n")
    return str(d / "train.txt")


@pytest.fixture(scope="module")
def trees():
    cfg = jax_load_config(None, TINY)
    k = jax.random.PRNGKey(0)
    return {"unet": densify_tree(junet.init_unet(k, cfg.model), 21),
            "vae": densify_tree(jvae.init_vae(k, cfg.autoencoder), 22),
            "clip": densify_tree(jclip.init_clip_text(k, cfg.text_encoder), 23)}


def _port_state(cfg, trees, device="cpu"):
    state = pts.init_train_state(cfg, seed=0, device=device)
    load_jax_params(state.unet, unet=trees["unet"])
    load_jax_params(state.vae, vae=trees["vae"])
    load_jax_params(state.clip, clip=trees["clip"])
    state.ema = popt.init_ema(state.unet)
    return state


def chain_draws(cfg, key, b=BATCH, image=IMAGE):
    """The draws of JAX's step recipe for one step key (train_step.py:
    rngs = split(rng, 8)), as the port's Draws."""
    rngs = jax.random.split(key, 8)
    h, w, zc = pts.latent_shape(cfg, image)
    vae_noise = jax.random.normal(rngs[0], (b, h, w, zc), jnp.float32)
    t = jnp.minimum((jax.random.uniform(rngs[1], (b,)) * 1000).astype(jnp.int32), 999)
    noise = jax.random.normal(rngs[2], (b, h, w, zc), jnp.float32)
    drop_all = bool(jax.random.uniform(rngs[3]) < 0.1)
    ks = jax.random.split(rngs[4], 6)
    u = [float(jax.random.uniform(ks[i])) for i in range(6)]
    return pts.Draws(torch.from_numpy(np.array(vae_noise)),
                     torch.from_numpy(np.array(t)).long(),
                     torch.from_numpy(np.array(noise)), drop_all,
                     unifusion.train_modality_drops(u))


def test_trainer_matches_jax_trainer(trees, listing, tmp_path, monkeypatch):
    """3 steps of both Trainers: the first loss within 1e-4, the later ones
    within 1e-3, the trainable weights within 10 % of the update's norm
    (see WEIGHT_REL); the port's state took 3 optimizer steps and its
    frozen weights stay bf16."""
    monkeypatch.setenv("IDTPU_ALLOW_HASH_TOKENIZER", "1")
    overrides = dict(TINY, train=_train(tmp_path / "jax"))
    jcfg = jax_load_config(None, overrides)

    def jax_init(cfg, tx=None, seed=0):
        s = jts.init_train_state(cfg, tx, seed)
        return s._replace(unet_params=to_jax(trees["unet"]), vae_params=to_jax(trees["vae"]),
                          clip_params=to_jax(trees["clip"]))

    monkeypatch.setattr(jtrainer, "init_train_state", jax_init)
    monkeypatch.setattr(jtrainer, "make_mesh",
                        lambda: jmesh.make_mesh(devices=jax.devices()[:1]))
    monkeypatch.setattr(jtrainer, "make_train_step",
                        functools.partial(jts.make_train_step, compute_dtype=jnp.float32))
    jt = jtrainer.Trainer(jcfg, listing)
    jlosses = []
    step_fn = jt.train_step

    def recording_step(state, batch, key):
        state, metrics = step_fn(state, batch, key)
        jlosses.append(float(metrics["loss"]))
        return state, metrics

    jt.train_step = recording_step
    jt.start_training()
    jparams = jax.tree_util.tree_map(np.asarray, jax.device_get(jt.state.unet_params))

    pcfg = load_config(overrides=dict(TINY, train=_train(tmp_path / "port")))
    monkeypatch.setattr(ptrainer, "init_train_state",
                        lambda cfg, seed, device: _port_state(cfg, trees, device))
    pt = ptrainer.Trainer(pcfg, listing, device="cpu")
    keys = [jax.random.PRNGKey(pcfg.train.seed)]

    def draws(b):
        keys[0], sub = jax.random.split(keys[0])
        return chain_draws(pcfg, sub, b)

    pt.draws = draws
    assert pt.start_training()
    stats = pt.stats()
    assert len(jlosses) == STEPS and stats["final_step"] == STEPS
    np.testing.assert_allclose(stats["losses"][0], jlosses[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(stats["losses"], jlosses, rtol=LATER_LOSS_RTOL)
    want = dict(_module_from_tree(pcfg, jparams).named_parameters())
    init = dict(_module_from_tree(pcfg, trees["unet"]).named_parameters())
    diff = move = 0.0
    for name, p in pt.state.unet.named_parameters():
        if popt.is_trainable(name):
            diff += float((p.detach() - want[name].detach()).pow(2).sum())
            move += float((want[name].detach() - init[name].detach()).pow(2).sum())
        else:
            assert p.dtype == torch.bfloat16, name
    assert move > 0 and (diff / move) ** 0.5 <= WEIGHT_REL, (diff / move) ** 0.5
    steps = {float(s["step"]) for s in pt.state.optimizer.state_dict()["state"].values()}
    assert steps == {float(STEPS)}


def _module_from_tree(cfg, tree):
    m = unet.UNet(cfg.model)
    load_jax_params(m, unet=tree)
    return m


# -- --official_ckpt -----------------------------------------------------------


def test_official_ckpt_merges_a_stock_sd_file(tmp_path, monkeypatch):
    """A flat SD-form file without the new parameters (fusers, UniFusion,
    ScaleU), as a stock SD1.5 file is: every frozen UNet weight, the VAE and
    CLIP come from the file (bf16 after the cast), the first conv's stock
    copy from the file's first conv, and every new parameter keeps its
    seeded init."""
    monkeypatch.setenv("IDTPU_ALLOW_HASH_TOKENIZER", "1")
    cfg = load_config(overrides=dict(TINY, train=_train(tmp_path / "out")))
    src = pts.init_train_state(cfg, seed=5, device="cpu")
    for i, m in enumerate((src.unet, src.vae, src.clip)):
        chip_smoke.densify_(m, 30 + i)
    sd = ckpt_io.reference_state_dict(src.unet, src.vae, src.clip)
    stock = {k: v for k, v in sd.items()
             if not any(t in k for t in popt.TRAINABLE_MARKERS)}
    assert len(stock) < len(sd)
    path = str(tmp_path / "sd15_form.pth")
    torch.save({"state_dict": stock}, path)
    listing = chip_smoke.write_training_records(str(tmp_path / "recs"), n=2)

    tr = ptrainer.Trainer(cfg, listing, pretrained_ckpt=path, device="cpu")
    fresh = pts.init_train_state(cfg, seed=cfg.train.seed, device="cpu")
    init = dict(fresh.unet.named_parameters())
    srcp = dict(src.unet.named_parameters())
    for name, p in tr.state.unet.named_parameters():
        if popt.is_trainable(name):
            assert p.dtype == torch.float32 and torch.equal(p, init[name]), name
        elif name.startswith("first_conv_sd."):
            conv = srcp["input_blocks.0.0.conv." + name.split(".")[-1]]
            assert torch.equal(p, conv.to(torch.bfloat16)), name
        else:
            assert p.dtype == torch.bfloat16 and torch.equal(p, srcp[name].bfloat16()), name
    for part in ("vae", "clip"):
        want = dict(getattr(src, part).named_parameters())
        for name, p in getattr(tr.state, part).named_parameters():
            assert torch.equal(p, want[name].bfloat16()), (part, name)
    assert {n: e for n, e in tr.state.ema.items()}.keys() == popt.trainable_parameters(
        tr.state.unet).keys()


# -- the sample grid --------------------------------------------------------------


def test_sample_grid_matches_jax(trees, listing, tmp_path, monkeypatch):
    """save_train_samples on equal fp32 weights and JAX's initial noise (its
    normal(PRNGKey(seed + bi)), drawn in float32 on both sides: JAX's saver
    draws bf16, patched here to float32 so neither side rounds): the grid
    within one uint8 level of JAX's, equal captions.txt."""
    monkeypatch.setenv("IDTPU_ALLOW_HASH_TOKENIZER", "1")
    pcfg = load_config(overrides=TINY)
    jcfg = jax_load_config(None, TINY)
    tok = CLIPTokenizer.load_default()
    ds = pds.JsonDataset(listing, pds.SampleDecoder(image_size=IMAGE, max_boxes_per_data=4))
    batch = pds.collate([ds.__getitem__(i) for i in range(BATCH)], tok, keep_caption=True)
    normal = jax.random.normal
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32: normal(key, shape, jnp.float32))
    jstate = jts.TrainState(jnp.zeros((), jnp.int32), to_jax(trees["unet"]), None, None,
                            to_jax(trees["vae"]), to_jax(trees["clip"]))
    from instancediffusion_tpu.data.tokenizer import CLIPTokenizer as JaxTokenizer

    jsaver.save_train_samples(jcfg, jstate, [batch], str(tmp_path / "jax"), steps=4, seed=3,
                              tokenizer=JaxTokenizer.load_default())
    noise = [np.asarray(normal(jax.random.PRNGKey(3), (BATCH, 8, 8, 4), jnp.float32))]
    state = _port_state(pcfg, trees)
    paths = psaver.save_train_samples(pcfg, state, [batch], str(tmp_path / "port"), steps=4,
                                      seed=3, tokenizer=tok, initial_noise=noise)
    got = read_png(open(paths[0], "rb").read())
    from PIL import Image

    want = np.asarray(Image.open(tmp_path / "jax" / "batch0.png").convert("RGB"))
    assert got.shape == want.shape == (BATCH * IMAGE, 2 * IMAGE, 3)
    assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1
    assert (tmp_path / "port" / "captions.txt").read_text() == \
        (tmp_path / "jax" / "captions.txt").read_text()


def test_box_outlines_match_pil():
    """draw_boxes_on against JAX's (PIL's ImageDraw.rectangle(width=2)) on
    boxes at the edges, thin boxes and dead slots."""
    r = np.random.default_rng(4)
    img = r.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    lo = r.uniform(0, 0.9, (12, 2)).astype(np.float32)
    boxes = np.concatenate([lo, np.minimum(lo + r.uniform(0, 0.4, (12, 2)), 1)], 1)
    boxes = np.concatenate([boxes, [[0, 0, 1, 1], [0.5, 0.5, 0.51, 0.52]]]).astype(np.float32)
    masks = np.array([1] * 10 + [0, 0, 1, 1], np.float32)
    np.testing.assert_array_equal(psaver.draw_boxes_on(img, boxes, masks),
                                  jsaver.draw_boxes_on(img, boxes, masks))
