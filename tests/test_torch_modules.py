"""Each ported module against its JAX counterpart on the same densified
random weights (tests/test_torch_bridge.py) and the same numpy inputs, in
float32 on the CPU (JAX at matmul precision "highest")."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancediffusion_tpu.data import grounding_input as jgi
from instancediffusion_tpu.data import tokenizer as jtok
from instancediffusion_tpu.models import clip_text as jclip
from instancediffusion_tpu.models import convnext as jconvnext
from instancediffusion_tpu.models import unet as junet
from instancediffusion_tpu.models import unifusion as junifusion
from instancediffusion_tpu.models import vae as jvae
from instancediffusion_tpu.ops import schedules as jsched
from instancediffusion_tpu.samplers import plms as jplms
from instancediffusion_tpu_torch.data import grounding_input as pgi
from instancediffusion_tpu_torch.data import tokenizer as ptok
from instancediffusion_tpu_torch.io.jax_params import load_jax_params
from instancediffusion_tpu_torch.models import clip_text, convnext, unet, unifusion, vae
from instancediffusion_tpu_torch.nn.core import plain_kernels
from instancediffusion_tpu_torch.ops import schedules
from instancediffusion_tpu_torch.samplers import plms

from tests.test_torch_bridge import dense_params, densify_tree, port_config, port_modules, to_jax
from tests.test_pipeline import tiny_config

import jax


def _close(port, ref, rel):
    """max |port - ref| <= rel * max |ref| (fp32 differences in summation
    order, grown through the network's depth)."""
    ref = np.asarray(ref)
    err = np.abs(port.detach().numpy() - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.fixture(scope="module")
def models():
    cfg = tiny_config()
    trees = dense_params(cfg)
    mods = port_modules(cfg)
    load_jax_params(mods["unet"], unet=trees["unet"])
    load_jax_params(mods["vae"], vae=trees["vae"])
    load_jax_params(mods["clip"], clip=trees["clip"])
    return cfg, port_config(cfg), {k: to_jax(v) for k, v in trees.items()}, mods


def _grounding(cfg, batch, seed):
    """Random grounding inputs: two live instances with boxes, points and
    phrase embeddings, nonzero seg masks, zero scribbles/polygons."""
    g = cfg.model.grounding_tokenizer
    n = cfg.model.max_objs
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0, 0.5, (batch, n, 2))
    out = {
        "boxes": np.concatenate([lo, lo + rng.uniform(0.1, 0.5, (batch, n, 2))], -1),
        "masks": np.tile(np.array([1, 1] + [0] * (n - 2), np.float64), (batch, 1)),
        "text_masks": np.tile(np.array([1, 1] + [0] * (n - 2), np.float64), (batch, 1)),
        "positive_embeddings": rng.standard_normal((batch, n, g.in_dim)),
        "scribbles": np.zeros((batch, n, g.n_scribble_points * 2)),
        "polygons": np.zeros((batch, n, g.n_polygon_points * 2)),
        "segs": (rng.uniform(size=(batch, n, g.seg_resize_input, g.seg_resize_input)) > 0.7),
        "points": rng.uniform(0, 1, (batch, n, 2)),
    }
    return {k: v.astype(np.float32) for k, v in out.items()}


def test_schedules_match():
    d = jsched.make_diffusion_schedule("linear", 1000, 0.00085, 0.012)
    pd = schedules.make_diffusion_schedule("linear", 1000, 0.00085, 0.012)
    np.testing.assert_array_equal(pd.alphas_cumprod, d.alphas_cumprod)
    js = jplms.make_plms_schedule(d, 50, [0.75, 0.0, 0.25])
    ps = plms.make_plms_schedule(pd, 50, [0.75, 0.0, 0.25])
    for f in ("ts", "ts_next", "a_t", "a_prev", "sqrt_one_minus_a_t", "gates"):
        np.testing.assert_array_equal(getattr(ps, f), getattr(js, f), err_msg=f)
    assert plms.gate_runs(ps.gates) == jplms.gate_runs(js.gates) == ((1.0, 37), (0.0, 13))
    # sin/cos of fp32 arguments up to 981 rad: one fp32 ulp of the argument
    # there is 6e-5, and the two libraries' trig differ by about that much
    t = np.array([0, 17, 981], np.int32)
    np.testing.assert_allclose(
        schedules.timestep_embedding(torch.from_numpy(t), 320).numpy(),
        np.asarray(jsched.timestep_embedding(jnp.asarray(t), 320)), atol=2e-4)


@pytest.mark.parametrize("schedule", ["linear", "cosine", "sqrt_linear", "sqrt"])
def test_beta_schedules_and_gates_match(schedule):
    """The port's numpy copies of the schedule functions give the JAX
    package's values exactly."""
    np.testing.assert_array_equal(schedules.make_beta_schedule(schedule, 1000, 1e-4, 2e-2),
                                  jsched.make_beta_schedule(schedule, 1000, 1e-4, 2e-2))
    for alpha_type in ([0.75, 0.0, 0.25], [0.3, 0.4, 0.3], [1.0, 0.0, 0.0], None):
        np.testing.assert_array_equal(schedules.alpha_generator(50, alpha_type),
                                      jsched.alpha_generator(50, alpha_type))
    for method in ("uniform", "quad"):
        np.testing.assert_array_equal(schedules.make_ddim_timesteps(method, 20, 1000),
                                      jsched.make_ddim_timesteps(method, 20, 1000))


@pytest.mark.parametrize("text",["a cat and a dog", "  Two   CATS &amp; a DOG!", ""])
def test_tokenizer_matches(tmp_path, text):
    """The port's copy of the tokenizer gives the JAX package's ids, on the
    hash fallback and on a small BPE vocabulary."""
    assert np.array_equal(ptok.CLIPTokenizer(None, None).encode(text),
                          jtok.CLIPTokenizer(None, None).encode(text))
    vocab = {"ca": 5, "cat</w>": 6, "a</w>": 7, "dog</w>": 8, "!</w>": 9, "&</w>": 10}
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version: 0.2\nc a\nca t</w>\nd o\ndo g</w>\n")
    paths = (str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt"))
    ids = ptok.CLIPTokenizer.from_files(*paths).encode(text)
    assert ids.shape == (77,) and ids[0] == ptok.SOT
    np.testing.assert_array_equal(ids, jtok.CLIPTokenizer.from_files(*paths).encode(text))


def test_prepare_grounding_matches():
    """Deferred and given phrase embeddings, boxes, points, scribbles and a
    per-instance text_mask, at the SD1.5 grounding widths."""
    rng = np.random.default_rng(8)
    meta = {
        "locations": [[0.1, 0.1, 0.5, 0.5], [0.6, 0.6, 0.9, 0.9], [0.2, 0.5, 0.4, 0.9]],
        "points": [[0.3, 0.3], [0.7, 0.7], [0.3, 0.7]],
        "scribbles": [rng.uniform(size=40).tolist(), None, rng.uniform(size=40).tolist()],
        "text_mask": [1, 0, 1],
    }
    emb = [jgi.DEFER_EMBEDDING, rng.standard_normal(768).astype(np.float32), None]
    ref = jgi.prepare_grounding(meta, emb, batch=2)
    out = pgi.prepare_grounding(meta, [pgi.DEFER_EMBEDDING] + emb[1:], batch=2)
    assert out.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


def test_fourier_filter_matches():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 12, 8)).astype(np.float32)
    for s in (0.3, 1.7):
        ref = junet.fourier_filter(jnp.asarray(x), 1, jnp.asarray([s], jnp.float32))
        out = unet.fourier_filter(torch.from_numpy(x), 1, torch.tensor([s]))
        _close(out, ref, 1e-5)
        ref = junet._fourier_filter_fft(jnp.asarray(x), 2, jnp.float32(s))
        out = unet._fourier_filter_fft(torch.from_numpy(x), 2, torch.tensor(s))
        _close(out, ref, 1e-5)


def test_convnext_matches():
    rng = np.random.default_rng(1)
    tree = densify_tree(jconvnext.init_convnext_tiny(jax.random.PRNGKey(0), 3, (1, 2),
                                                     (8, 16)), 7)
    mod = convnext.ConvNeXt(3, (1, 2), (8, 16))
    load_jax_params(mod, unet=tree)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    ref = jconvnext.apply_convnext_tiny(to_jax(tree), jnp.asarray(x))
    _close(mod(torch.from_numpy(x)), ref, 1e-4)


def test_unifusion_matches(models):
    cfg, pcfg, jp, mods = models
    gcfg, pgcfg = cfg.model.grounding_tokenizer, pcfg.model.grounding_tokenizer
    g = _grounding(cfg, 2, 2)
    ref, _ = junifusion.apply_unifusion(jp["unet"]["position_net"], gcfg,
                                        {k: jnp.asarray(v) for k, v in g.items()},
                                        junifusion.ModalityDrops.test_defaults(gcfg))
    out = unifusion.apply_unifusion(mods["unet"].position_net, pgcfg,
                                    {k: torch.from_numpy(v) for k, v in g.items()},
                                    unifusion.ModalityDrops.test_defaults(pgcfg))
    assert out.shape == (2, unifusion.num_grounding_tokens(pgcfg, cfg.model.max_objs),
                         gcfg.out_dim)
    _close(out, ref, 1e-4)
    null = junifusion.null_grounding(1, cfg.model.max_objs, gcfg)
    ref, _ = junifusion.apply_unifusion(jp["unet"]["position_net"], gcfg, null,
                                        junifusion.ModalityDrops.test_defaults(gcfg))
    out = unifusion.apply_unifusion(
        mods["unet"].position_net, pgcfg,
        unifusion.null_grounding(1, cfg.model.max_objs, pgcfg),
        unifusion.ModalityDrops.test_defaults(pgcfg))
    _close(out, ref, 1e-4)


def test_unifusion_bf16_weights_runs_fp32(models):
    """With bf16 weights (the pipeline's default) and fp32 grounding,
    UniFusion computes in fp32 on the bf16-rounded weights, as the JAX
    pipeline does (its dtype promotion). Same 1e-4 bound as the fp32 test:
    the only difference left is fp32 summation order."""
    import copy

    cfg, pcfg, jp, mods = models
    gcfg, pgcfg = cfg.model.grounding_tokenizer, pcfg.model.grounding_tokenizer
    g = _grounding(cfg, 1, 6)
    jpos = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp["unet"]["position_net"])
    ref, _ = junifusion.apply_unifusion(jpos, gcfg, {k: jnp.asarray(v) for k, v in g.items()},
                                        junifusion.ModalityDrops.test_defaults(gcfg))
    assert ref.dtype == jnp.float32
    pos = copy.deepcopy(mods["unet"].position_net).to(torch.bfloat16)
    out = unifusion.apply_unifusion(pos, pgcfg, {k: torch.from_numpy(v) for k, v in g.items()},
                                    unifusion.ModalityDrops.test_defaults(pgcfg))
    assert out.dtype == torch.float32
    _close(out, ref, 1e-4)


def test_clip_text_matches(models):
    cfg, _, jp, mods = models
    ids = np.random.default_rng(3).integers(0, cfg.text_encoder.vocab_size, (3, 77))
    ref = jclip.apply_clip_text(jp["clip"], cfg.text_encoder, jnp.asarray(ids, jnp.int32))
    out = clip_text.apply_clip_text(mods["clip"], torch.from_numpy(ids))
    _close(out["last_hidden_state"], ref["last_hidden_state"], 1e-4)
    _close(out["pooler_output"], ref["pooler_output"], 1e-4)


@pytest.mark.parametrize("gate", [1.0, 0.0])
def test_apply_unet_matches(models, gate):
    """Densified UNet, real grounding through UniFusion; gate 0 skips the
    fuser and swaps in the stock-SD first conv."""
    cfg, pcfg, jp, mods = models
    mc = cfg.model
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, mc.image_size, mc.image_size, 4)).astype(np.float32)
    t = np.array([981, 501], np.int32)
    ctx = rng.standard_normal((2, 77, mc.context_dim)).astype(np.float32)
    g = _grounding(cfg, 2, 5)
    ref = junet.apply_unet(jp["unet"], mc, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                           {k: jnp.asarray(v) for k, v in g.items()}, gate_scale=gate)
    args = (mods["unet"], pcfg.model, torch.from_numpy(x), torch.from_numpy(t),
            torch.from_numpy(ctx), {k: torch.from_numpy(v) for k, v in g.items()})
    out = unet.apply_unet(*args, gate_scale=gate)
    assert float(np.abs(np.asarray(ref)).max()) > 0.1  # densified: eps is not ~0
    _close(out, ref, 1e-4)
    with plain_kernels():
        _close(unet.apply_unet(*args, gate_scale=gate), ref, 1e-4)


def test_vae_decode_matches(models):
    cfg, _, jp, mods = models
    z = np.random.default_rng(6).standard_normal((2, 8, 8, 4)).astype(np.float32)
    jtree = {"decoder": jp["vae"]["decoder"], "post_quant_conv": jp["vae"]["post_quant_conv"]}
    ref = jvae.vae_decode(jtree, cfg.autoencoder, jnp.asarray(z))
    out = vae.vae_decode(mods["vae"], torch.from_numpy(z))
    assert out.shape == (2, 16, 16, 3)
    _close(out, ref, 1e-4)


def test_plms_sample_matches():
    """4 steps (the peeled order-1 step with its extra call, then orders
    2-4) with one model function written in both frameworks."""
    d = jsched.make_diffusion_schedule("linear", 1000, 0.00085, 0.012)
    js = jplms.make_plms_schedule(d, 4, [0.75, 0.0, 0.25])
    ps = plms.make_plms_schedule(
        schedules.make_diffusion_schedule("linear", 1000, 0.00085, 0.012), 4,
        [0.75, 0.0, 0.25])
    x0 = np.random.default_rng(7).standard_normal((2, 4, 4, 3)).astype(np.float32)
    calls = []

    def torch_fn(x, t, gate):
        calls.append(gate)
        return torch.tanh(x) * (t.float() / 1000)[:, None, None, None] + 0.1 * gate

    def jax_fn(x, t, gate):
        return jnp.tanh(x) * (t.astype(jnp.float32) / 1000)[:, None, None, None] + 0.1 * gate

    ref = jplms.plms_sample(jax_fn, js, jnp.asarray(x0), static_gates=jplms.gate_runs(js.gates))
    out = plms.plms_sample(torch_fn, ps, torch.from_numpy(x0))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    assert calls == [1.0, 1.0, 1.0, 1.0, 0.0]  # 5 model calls: step 0 calls twice
