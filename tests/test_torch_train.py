"""The port's training step against the JAX package's, on the CPU.

Same densified weights (numpy, tests/test_torch_bridge.py), same batch and
the JAX step's own random draws (its `split(rng, 8)` recipe, reproduced
outside jit and handed to the port), float32 compute on both sides (JAX at
matmul precision "highest"). Both sides take one SGD(lr=1) step, so
parameters-before minus parameters-after is the gradient. Tolerances:
fp32 summation order only, grown through the network (stated per test).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from instancediffusion_tpu.models import clip_text as jclip
from instancediffusion_tpu.models import unet as junet
from instancediffusion_tpu.models import unifusion as junifusion
from instancediffusion_tpu.models import vae as jvae
from instancediffusion_tpu.ops import schedules as jsched
from instancediffusion_tpu.train import optimizer as jopt
from instancediffusion_tpu.train import train_step as jts
from instancediffusion_tpu_torch.io.jax_params import load_jax_params
from instancediffusion_tpu_torch.models import unet, unifusion, vae
from instancediffusion_tpu_torch.ops import schedules
from instancediffusion_tpu_torch.train import optimizer as popt
from instancediffusion_tpu_torch.train import train_step as pts

from tests.test_pipeline import tiny_config
from tests.test_torch_bridge import densify_tree, port_config, port_modules, to_jax

IMAGE = 16  # tiny_config: VAE /2, UNet image_size 8
BATCH = 2
# loss and gradients: fp32 on both sides through VAE encoder, CLIP,
# UniFusion + ConvNeXt, UNet forward and backward
LOSS_RTOL = 1e-4
GRAD_REL = 2e-3


def _cfg(masked: bool):
    cfg = tiny_config()
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, use_masked_att=masked))


@pytest.fixture(scope="module")
def trees():
    cfg = tiny_config()
    k = jax.random.PRNGKey(0)
    return {
        "unet": densify_tree(junet.init_unet(k, cfg.model), 11),
        "vae": densify_tree(jvae.init_vae(k, cfg.autoencoder), 12),
        "clip": densify_tree(jclip.init_clip_text(k, cfg.text_encoder), 13),
    }


def _batch(cfg, seed=0):
    r = np.random.default_rng(seed)
    g = cfg.model.grounding_tokenizer
    n, b, s = cfg.model.max_objs, BATCH, g.seg_resize_input
    lo = r.uniform(0, 0.5, (b, n, 2))
    out = {
        "image": r.standard_normal((b, IMAGE, IMAGE, 3)) * 0.5,
        "boxes": np.concatenate([lo, lo + r.uniform(0.2, 0.5, (b, n, 2))], -1),
        "masks": np.tile(np.array([1, 1, 1] + [0] * (n - 3)), (b, 1)),
        "text_masks": np.tile(np.array([1, 1, 1] + [0] * (n - 3)), (b, 1)),
        "text_embeddings": r.standard_normal((b, n, g.in_dim)),
        "scribbles": r.uniform(0, 1, (b, n, g.n_scribble_points * 2)),
        "polygons": r.uniform(0, 1, (b, n, g.n_polygon_points * 2)),
        "segs": r.uniform(size=(b, n, s, s)) > 0.7,
        "points": r.uniform(0, 1, (b, n, 2)),
    }
    out = {k: v.astype(np.float32) for k, v in out.items()}
    out["caption_ids"] = r.integers(0, cfg.text_encoder.vocab_size, (b, 77)).astype(np.int32)
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def jax_draws(cfg, key):
    """The draws of the JAX step's recipe (train_step.py: rngs = split(rng,
    8)), made outside jit, as the port's Draws."""
    rngs = jax.random.split(key, 8)
    h, w, zc = pts.latent_shape(pts_cfg(cfg), IMAGE)
    vae_noise = jax.random.normal(rngs[0], (BATCH, h, w, zc), jnp.float32)
    t = jnp.minimum((jax.random.uniform(rngs[1], (BATCH,)) * 1000).astype(jnp.int32), 999)
    noise = jax.random.normal(rngs[2], (BATCH, h, w, zc), jnp.float32)
    drop_all = bool(jax.random.uniform(rngs[3]) < 0.1)
    ks = jax.random.split(rngs[4], 6)
    u = [float(jax.random.uniform(ks[i])) for i in range(6)]
    return pts.Draws(torch.from_numpy(np.array(vae_noise)), torch.from_numpy(np.array(t)).long(),
                     torch.from_numpy(np.array(noise)), drop_all,
                     unifusion.train_modality_drops(u))


def pts_cfg(cfg):
    return port_config(cfg)


def port_state(cfg, trees, sgd=True):
    pcfg = port_config(cfg)
    mods = port_modules(cfg)
    u = mods["unet"]
    v = vae.AutoencoderKL(pcfg.autoencoder, encoder=True)
    load_jax_params(u, unet=trees["unet"])
    load_jax_params(v, vae=trees["vae"])
    load_jax_params(mods["clip"], clip=trees["clip"])
    popt.trainable_mask(u)
    state = pts.TrainState(step=0, unet=u, ema=popt.init_ema(u), vae=v, clip=mods["clip"])
    if sgd:
        state.optimizer = torch.optim.SGD(popt.trainable_parameters(u).values(), lr=1.0)
    return pcfg, state


def _diffusion():
    return schedules.make_diffusion_schedule("linear", 1000, 0.00085, 0.012)


def _jax_step(cfg, trees, batch, key):
    """(loss, gradient tree of the trainable subset as parameters-before
    minus parameters-after) of one JAX step under optax.sgd(1.0)."""
    diffusion = jsched.make_diffusion_schedule("linear", 1000, 0.00085, 0.012)
    tx = optax.sgd(1.0)
    params = to_jax(trees["unet"])
    state = jts.TrainState(jnp.zeros((), jnp.int32), params, jopt.init_ema(params),
                           tx.init(params), to_jax(trees["vae"]), to_jax(trees["clip"]))
    step = jax.jit(jts.make_train_step(cfg, diffusion, tx, compute_dtype=jnp.float32))
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b), params,
                                   new.unet_params)
    return float(metrics["loss"]), grads


def _port_grads(state, before):
    return {n: before[n] - p.detach() for n, p in popt.trainable_parameters(state.unet).items()}


@pytest.mark.parametrize("masked", [False, True])
def test_train_step_matches_jax(trees, masked):
    """One step, unmasked and with use_masked_att: loss and every trainable
    gradient (via SGD(lr=1) on both sides) against JAX's make_train_step,
    on two keys (the second drops the whole grounding of the batch)."""
    cfg = _cfg(masked)
    batch = _batch(cfg)
    for key in (jax.random.PRNGKey(5), _drop_all_key(cfg)):
        jloss, jgrads = _jax_step(cfg, trees, batch, key)
        pcfg, state = port_state(cfg, trees)
        draws = jax_draws(cfg, key)
        before = {n: p.detach().clone() for n, p in popt.trainable_parameters(state.unet).items()}
        step = pts.make_train_step(pcfg, _diffusion(), compute_dtype=torch.float32)
        state, metrics = step(state, _torch_batch(batch), draws)
        assert not metrics["skipped"] and state.step == 1
        np.testing.assert_allclose(float(metrics["loss"]), jloss, rtol=LOSS_RTOL)
        ref = port_modules(cfg)["unet"]
        load_jax_params(ref, unet=jgrads)
        ref = dict(ref.named_parameters())
        pgrads = _port_grads(state, before)
        assert set(pgrads) == {n for n in ref if popt.is_trainable(n)}
        for name, g in pgrads.items():
            want = ref[name].detach()
            err = (g - want).abs().max().item()
            scale = max(want.abs().max().item(), 1e-3)
            assert err <= GRAD_REL * scale, (name, err, scale)


def _drop_all_key(cfg):
    """The first PRNG key whose draws drop the whole grounding."""
    for i in range(100, 400):
        key = jax.random.PRNGKey(i)
        if bool(jax.random.uniform(jax.random.split(key, 8)[3]) < 0.1):
            return key
    raise AssertionError("no drop-all key")


def test_remat_gives_the_same_gradients(trees):
    """Gradient checkpointing (remat) recomputes blocks; the gradients are
    those of the plain backward (fp32, 1e-6 of the largest entry)."""
    cfg = _cfg(True)
    batch = _torch_batch(_batch(cfg))
    draws = jax_draws(cfg, jax.random.PRNGKey(5))
    grads = []
    for remat in (False, True):
        pcfg, state = port_state(cfg, trees, sgd=False)
        pcfg = dataclasses.replace(pcfg, model=dataclasses.replace(pcfg.model,
                                                                   use_checkpoint=remat))
        pts.make_loss_fn(pcfg, _diffusion(), torch.float32)(state, batch, draws).backward()
        grads.append({n: p.grad for n, p in popt.trainable_parameters(state.unet).items()})
    for name, g in grads[0].items():
        assert torch.allclose(grads[1][name], g, rtol=0, atol=1e-6 * max(g.abs().max(), 1)), name


def test_nan_loss_skips_the_update(trees):
    """A non-finite loss leaves parameters, optimizer moments, schedule and
    EMA as they were; only `step` advances."""
    cfg = _cfg(False)
    pcfg, state = port_state(cfg, trees, sgd=False)
    state.optimizer, state.scheduler = popt.make_optimizer(state.unet, 1e-3, warmup_steps=2)
    step = pts.make_train_step(pcfg, _diffusion(), torch.float32)
    draws = jax_draws(cfg, jax.random.PRNGKey(5))
    batch = _torch_batch(_batch(cfg))
    state, m = step(state, batch, draws)  # one good step: moments exist
    assert not m["skipped"]
    snap = lambda: ({n: p.detach().clone() for n, p in state.unet.named_parameters()},
                    {n: e.clone() for n, e in state.ema.items()},
                    {i: {k: v.clone() for k, v in s.items()}
                     for i, s in state.optimizer.state_dict()["state"].items()},
                    state.scheduler.last_epoch)
    params0, ema0, opt0, sched0 = snap()
    batch["image"] = torch.full_like(batch["image"], float("nan"))
    state, m = step(state, batch, draws)
    assert m["skipped"] and state.step == 2
    params1, ema1, opt1, sched1 = snap()
    assert sched1 == sched0
    for a, b in ((params0, params1), (ema0, ema1)):
        assert all(torch.equal(a[n], b[n]) for n in a)
    assert all(torch.equal(opt0[i][k], opt1[i][k]) for i in opt0 for k in opt0[i])
    assert all(p.grad is None for p in state.unet.parameters())


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------


def test_vae_encoder_matches_jax(trees):
    """Encoder + quant_conv: the mode against vae_encode_mode, and the
    sample with injected noise against vae_encode with the same noise
    (1e-4 of the largest latent: fp32 summation order)."""
    cfg = tiny_config()
    pcfg = port_config(cfg)
    v = vae.AutoencoderKL(pcfg.autoencoder, encoder=True)
    load_jax_params(v, vae=trees["vae"])
    jp = to_jax(trees["vae"])
    x = np.random.default_rng(3).standard_normal((2, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jvae.vae_encode_mode(jp, cfg.autoencoder, jnp.asarray(x)))
    out = vae.vae_encode_mode(v, torch.from_numpy(x)).detach().numpy()
    assert out.shape == (2, 16, 16, 4)
    np.testing.assert_allclose(out, ref, atol=1e-4 * np.abs(ref).max())
    key = jax.random.PRNGKey(7)
    noise = np.asarray(jax.random.normal(key, ref.shape, jnp.float32))
    ref_s = np.asarray(jvae.vae_encode(jp, cfg.autoencoder, jnp.asarray(x), key))
    out_s = vae.vae_encode(v, torch.from_numpy(x), torch.from_numpy(noise)).detach().numpy()
    np.testing.assert_allclose(out_s, ref_s, atol=1e-4 * np.abs(ref_s).max())


def test_vae_encoder_is_drawn_after_the_decoder():
    """Asking for the encoder leaves the decoder's seeded weights as they
    were (generate's weights do not move)."""
    cfg = port_config(tiny_config()).autoencoder
    a = vae.AutoencoderKL(cfg, generator=torch.Generator().manual_seed(0))
    b = vae.AutoencoderKL(cfg, encoder=True, generator=torch.Generator().manual_seed(0))
    pb = dict(b.named_parameters())
    assert all(torch.equal(p, pb[n]) for n, p in a.named_parameters())
    assert any(n.startswith("encoder.") for n in pb) and "quant_conv.weight" in pb


def test_modality_drops_match_jax_on_its_uniforms():
    """train_modality_drops on JAX's own six uniforms gives JAX's drops, over
    enough keys to reach every fix-up branch."""
    cfg = tiny_config().model.grounding_tokenizer
    seen = set()
    for i in range(400):
        key = jax.random.PRNGKey(i)
        ks = jax.random.split(key, 6)
        u = [float(jax.random.uniform(ks[j])) for j in range(6)]
        jd = junifusion.train_modality_drops(key, cfg)
        pd = unifusion.train_modality_drops(u)
        want = tuple(bool(getattr(jd, f.name)) for f in dataclasses.fields(pd))
        assert tuple(getattr(pd, f.name) for f in dataclasses.fields(pd)) == want, (i, u)
        seen.add((u[4] < 0.1, u[5] < 0.1, u[3] < 0.1))
    assert len(seen) >= 6


def test_trainable_mask_matches_jax():
    """The same parameters train, by count and by name (JAX paths carried
    over by the parameter bridge), and requires_grad marks exactly them."""
    cfg = tiny_config()
    params = junet.init_unet(jax.random.PRNGKey(0), cfg.model)
    mod = port_modules(cfg)["unet"]
    mask = popt.trainable_mask(mod)
    assert popt.count_trainable(mod) == jopt.count_trainable(params)
    marks = jax.tree_util.tree_map(lambda m: np.full((), float(m)),
                                   jopt.trainable_mask(params))
    # a tree of 0/1 per leaf, loaded through the bridge, marks each port
    # parameter with its JAX leaf's mask
    ref = port_modules(cfg)["unet"]
    load_jax_params(ref, unet=jax.tree_util.tree_map(
        lambda p, m: np.broadcast_to(m, np.shape(p)).astype(np.float32), params, marks))
    for name, p in ref.named_parameters():
        jax_mask = bool(p.detach().reshape(-1)[0]) if p.numel() else False
        assert mask[name] == jax_mask, name
        assert dict(mod.named_parameters())[name].requires_grad == jax_mask


def test_adamw_warmup_and_ema_match_optax():
    """AdamW + warmup schedule + EMA against optax (make_optimizer of the
    JAX package) on identical gradients for 3 steps; warmup 2 makes the
    first update run at lr 0, as optax reads the schedule at the count
    before the update (fp32: 1e-6)."""
    rng = np.random.default_rng(9)
    w0 = rng.standard_normal((4, 3)).astype(np.float32)
    f0 = rng.standard_normal(5).astype(np.float32)
    grads = [(rng.standard_normal((4, 3)).astype(np.float32),
              rng.standard_normal(5).astype(np.float32)) for _ in range(3)]
    jparams = {"fuser": {"w": jnp.asarray(w0)}, "frozen": {"b": jnp.asarray(f0)}}
    tx = jopt.make_optimizer(learning_rate=0.1, warmup_steps=2, params=jparams)
    jstate = tx.init(jparams)
    jema = jopt.init_ema(jparams)

    mod = torch.nn.Module()
    mod.fuser = torch.nn.Module()
    mod.fuser.w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    mod.frozen = torch.nn.Parameter(torch.from_numpy(f0.copy()))
    opt, sched = popt.make_optimizer(mod, learning_rate=0.1, warmup_steps=2)
    ema = popt.init_ema(mod)
    assert set(ema) == {"fuser.w"} and not mod.frozen.requires_grad
    for i, (gw, gf) in enumerate(grads):
        jg = {"fuser": {"w": jnp.asarray(gw)}, "frozen": {"b": jnp.asarray(gf)}}
        upd, jstate = tx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        jema = jopt.update_ema(jema, jparams, 0.9)
        mod.fuser.w.grad = torch.from_numpy(gw.copy())
        opt.step()
        sched.step()
        popt.update_ema(ema, mod, 0.9)
        if i == 0:  # lr 0: the parameters have not moved
            np.testing.assert_array_equal(mod.fuser.w.detach().numpy(), w0)
        np.testing.assert_allclose(mod.fuser.w.detach().numpy(), np.asarray(jparams["fuser"]["w"]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ema["fuser.w"].numpy(), np.asarray(jema["fuser"]["w"]),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(mod.frozen.detach().numpy(), f0)
    full = popt.ema_full_params(ema, mod)
    assert full["frozen"] is not None and torch.equal(full["fuser.w"], ema["fuser.w"])


@pytest.mark.parametrize("kind", ["constant", "cosine"])
def test_warmup_factor_matches_optax_schedules(kind):
    import optax as ox

    if kind == "constant":
        sched = ox.join_schedules([ox.linear_schedule(0.0, 1.0, 10),
                                   ox.constant_schedule(1.0)], [10])
    else:
        sched = ox.warmup_cosine_decay_schedule(0.0, 1.0, 10, 50)
    for c in (0, 1, 5, 10, 11, 30, 50, 80):
        assert abs(popt.warmup_factor(c, 10, kind, 50) - float(sched(c))) < 1e-6, c


def test_q_sample_and_schedule_buffers_match_jax():
    d = jsched.make_diffusion_schedule("linear", 1000, 0.00085, 0.012)
    pd = _diffusion()
    np.testing.assert_array_equal(pd.sqrt_alphas_cumprod, d.sqrt_alphas_cumprod)
    np.testing.assert_array_equal(pd.sqrt_one_minus_alphas_cumprod,
                                  d.sqrt_one_minus_alphas_cumprod)
    rng = np.random.default_rng(4)
    x, n = rng.standard_normal((2, 3, 3, 4)).astype(np.float32), rng.standard_normal(
        (2, 3, 3, 4)).astype(np.float32)
    t = np.array([3, 998])
    ref = jsched.q_sample(jnp.asarray(d.sqrt_alphas_cumprod),
                          jnp.asarray(d.sqrt_one_minus_alphas_cumprod), jnp.asarray(x),
                          jnp.asarray(t), jnp.asarray(n))
    out = schedules.q_sample(torch.from_numpy(pd.sqrt_alphas_cumprod),
                             torch.from_numpy(pd.sqrt_one_minus_alphas_cumprod),
                             torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(n))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_sample_draws_follow_the_recipe():
    """Host-drawn draws: shapes, t in [0, 999], and a seeded generator
    repeats them."""
    cfg = port_config(tiny_config())
    a = pts.sample_draws(torch.Generator().manual_seed(1), 3, pts.latent_shape(cfg, 16))
    b = pts.sample_draws(torch.Generator().manual_seed(1), 3, pts.latent_shape(cfg, 16))
    assert a.noise.shape == a.vae_noise.shape == (3, 8, 8, 4)
    assert a.t.dtype == torch.int64 and int(a.t.min()) >= 0 and int(a.t.max()) <= 999
    assert torch.equal(a.noise, b.noise) and torch.equal(a.t, b.t) and a.drops == b.drops


def test_init_train_state_marks_and_casts():
    """init_train_state marks the trainable subset and copies it into the
    EMA; cast_frozen_bf16 keeps it fp32 and stores everything else bf16."""
    cfg = port_config(tiny_config())
    state = pts.init_train_state(cfg, seed=0, device="cpu")
    trainable = popt.trainable_parameters(state.unet)
    assert set(state.ema) == set(trainable) and trainable
    assert hasattr(state.vae, "encoder")
    state = pts.cast_frozen_bf16(state)
    for n, p in state.unet.named_parameters():
        assert p.dtype == (torch.float32 if popt.is_trainable(n) else torch.bfloat16), n
        assert p.requires_grad == popt.is_trainable(n)
    assert all(p.dtype == torch.bfloat16 for p in state.vae.parameters())
    assert all(p.dtype == torch.bfloat16 for p in state.clip.parameters())
