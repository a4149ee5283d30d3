"""The port's data-parallel training on the CPU against the JAX package's
sharded program on the conftest's virtual mesh: the training step on 2
gloo ranks (one row each, with and without ZeRO-1) against JAX's
`make_train_step` jitted over a 2-device "data" mesh and against one
process of the port; the collectives a step issues; the NaN skip decided
on the global loss; the Prefetcher's equal batch counts; the ranks'
devices and refusals (`generate_batch(mesh=)` is in
tests/test_torch_parallel_sampling.py).

Same densified weights (numpy), batches and draws on both sides (JAX's
`split(rng, 8)` recipe of one 2-row step, its rows handed to the ranks),
fp32 compute, and an EMA rate of 0.5 so that two steps move the EMA as
far as the parameters. Tolerances: JAX's own for the loss (rtol 2e-5) and
the parameters (rtol 2e-4, atol 1e-6, tests/test_parallel.py); the
gradients' bound and the parameters JAX's bound leaves out are stated at
the test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from instancediffusion_tpu.models import clip_text as jclip
from instancediffusion_tpu.models import unet as junet
from instancediffusion_tpu.models import vae as jvae
from instancediffusion_tpu.ops import schedules as jsched
from instancediffusion_tpu.parallel.mesh import data_sharding, make_mesh, replicated
from instancediffusion_tpu.train import optimizer as jopt
from instancediffusion_tpu.train import train_step as jts
from instancediffusion_tpu_torch.io.jax_params import load_jax_params
from instancediffusion_tpu_torch.models import unet
from instancediffusion_tpu_torch.train import optimizer as popt

from tests import torch_ranks
from tests.test_parallel import make_batch, micro_cfg
from tests.test_torch_bridge import densify_tree, port_config, to_jax

LR = 1e-3
STEPS = 2
EMA_RATE = 0.5
LOSS_RTOL = 2e-5
PARAM_RTOL, PARAM_ATOL = 2e-4, 1e-6
GRAD_REL = 1e-4
SETTLED_EPS = 100


@pytest.fixture(scope="module")
def setup():
    cfg = micro_cfg()
    cfg.train.ema_rate = EMA_RATE
    k = jax.random.PRNGKey(0)
    trees = {
        "unet": densify_tree(junet.init_unet(k, cfg.model), 11),
        "vae": densify_tree(jvae.init_vae(k, cfg.autoencoder), 12),
        "clip": densify_tree(jclip.init_clip_text(k, cfg.text_encoder), 13),
    }
    batches = [make_batch(cfg, 2, seed=s) for s in range(STEPS)]
    keys = [jax.random.PRNGKey(7 + s) for s in range(STEPS)]
    return cfg, port_config(cfg), trees, batches, keys


def numpy_draws(cfg, key, b=2):
    """The draws of JAX's step recipe (rngs = split(rng, 8)) for a b-row
    batch, as numpy."""
    rngs = jax.random.split(key, 8)
    ex = cfg.data.image_size // 2 ** (len(cfg.autoencoder.ch_mult) - 1)
    shape = (b, ex, ex, cfg.autoencoder.embed_dim)
    ks = jax.random.split(rngs[4], 6)
    return {
        "vae_noise": np.asarray(jax.random.normal(rngs[0], shape, jnp.float32)),
        "t": np.asarray(jnp.minimum((jax.random.uniform(rngs[1], (b,)) * 1000)
                                    .astype(jnp.int32), 999)),
        "noise": np.asarray(jax.random.normal(rngs[2], shape, jnp.float32)),
        "drop_all": bool(jax.random.uniform(rngs[3]) < 0.1),
        "u": [float(jax.random.uniform(ks[i])) for i in range(6)],
    }


@pytest.fixture(scope="module")
def port_ranks(setup):
    """The port's 2-rank steps, started before JAX's reference compiles."""
    cfg, pcfg, trees, batches, keys = setup
    draws = [numpy_draws(cfg, k) for k in keys]
    return torch_ranks.spawn_ranks(torch_ranks.dp_train, 2, pcfg, trees, batches, draws, LR)


def recording(tx):
    """`tx` that also keeps the gradients of its last update in its state
    ((tx's state, gradients)): the averaged gradients of JAX's step."""

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(
        lambda params: (tx.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)),
        update)


@pytest.fixture(scope="module")
def jax_dp(setup, port_ranks):
    """JAX's step on a 2-device data mesh: losses and each step's averaged
    gradients, then the trainable parameters and the EMA, {port name:
    array}."""
    cfg, _, trees, batches, keys = setup
    diffusion = jsched.make_diffusion_schedule("linear", 1000, 0.00085, 0.012)
    params = to_jax(trees["unet"])
    tx = recording(jopt.make_optimizer(learning_rate=LR, warmup_steps=0, params=params))
    mesh = make_mesh(devices=jax.devices()[:2])
    state = jts.TrainState(jnp.zeros((), jnp.int32), params, jopt.init_ema(params),
                           tx.init(params), to_jax(trees["vae"]), to_jax(trees["clip"]))
    state = jax.device_put(state, replicated(mesh))
    step = jax.jit(jts.make_train_step(cfg, diffusion, tx, compute_dtype=jnp.float32))
    pcfg = setup[1]
    losses, grads = [], []
    for batch, key in zip(batches, keys):
        batch = {k: jax.device_put(v, data_sharding(mesh)) for k, v in batch.items()}
        state, m = step(state, batch, jax.device_put(key, replicated(mesh)))
        losses.append(float(m["loss"]))
        grads.append(_port_names(state.opt_state[1], pcfg))
    # JAX's EMA tree holds scalars for the frozen leaves
    ema = jax.tree_util.tree_map(lambda e, p: e if e.shape == p.shape else p,
                                 state.ema_params, state.unet_params)
    return losses, grads, _port_names(state.unet_params, pcfg), _port_names(ema, pcfg)


def _port_names(tree, pcfg) -> dict:
    """{port parameter name: array} of the trainable parameters of a JAX
    UNet tree, through the parameter bridge."""
    u = unet.UNet(pcfg.model)
    load_jax_params(u, unet=jax.tree_util.tree_map(np.asarray, tree))
    return {n: p.detach().numpy() for n, p in popt.trainable_parameters(u).items()}


@pytest.fixture(scope="module")
def port_dp(setup, port_ranks):
    """The port's steps: on 2 ranks ({zero1: [rank 0, rank 1]}), and on one
    process over the whole batch."""
    cfg, pcfg, trees, batches, keys = setup
    draws = [numpy_draws(cfg, k) for k in keys]
    one = torch_ranks.one_rank_train(pcfg, trees, batches, draws, LR)
    ranks = port_ranks.results()
    return {z: [r[z] for r in ranks] for z in (False, True)}, one


def settled(grads: list) -> dict:
    """{name: mask} of the elements a parameter bound of JAX's holds after
    AdamW steps with the reference gradients `grads` (one {name: array} a
    step): all but those whose gradient, at some step, is nonzero and at
    most SETTLED_EPS x AdamW's eps (1e-8). AdamW's first update of an
    element is lr * g / (|g| + eps): where |g| is within two decades of
    eps, a relative error r of the gradient moves the parameter by up to
    lr * r / 100, and fp32 summation leaves such a gradient, a sum of much
    larger terms, with r up to 1 (4 % at 1.3e-7 here). A gradient that is
    exactly zero (a parameter the step did not reach) leaves its element
    held."""
    keep = {name: True for name in grads[0]}
    for ref in grads:
        keep = {name: keep[name] & ~((ref[name] != 0) & (np.abs(ref[name]) <= SETTLED_EPS * 1e-8))
                for name in ref}
    return keep


@pytest.mark.parametrize("zero1", [False, True])
def test_dp_train_step_matches_jax(jax_dp, port_dp, zero1):
    """2 AdamW steps on 2 ranks (one row each) against JAX's 2-device step
    and the port's one process over the 2-row batch: the global losses
    (rtol 2e-5); each step's averaged gradients, on both ranks and on one
    process, against JAX's (fp32 summation order: 1e-4 of the step's
    largest gradient, since a sum's rounding scales with its terms, not
    with the sum); both ranks' parameters bitwise equal; the trainable
    parameters and the EMA within JAX's bound (rtol 2e-4, atol 1e-6) on
    every element `settled` keeps (at least 98 % of them; the rest are
    held by the gradients' bound)."""
    jlosses, jgrads, jparams, jema = jax_dp
    ranks, one = port_dp
    r0, r1 = ranks[zero1]
    np.testing.assert_allclose(r0["losses"], jlosses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(r0["losses"], one["losses"], rtol=LOSS_RTOL)
    assert r0["losses"] == r1["losses"] and not any(r0["skipped"])
    assert set(r0["params"]) == set(jparams) == set(one["params"])
    assert len(r0["grads"]) == len(one["grads"]) == len(jgrads) == STEPS
    for steps in (r0["grads"], r1["grads"], one["grads"]):
        for got, ref in zip(steps, jgrads):
            scale = max(np.abs(g).max() for g in ref.values())
            for name, g in ref.items():
                assert np.abs(got[name] - g).max() <= GRAD_REL * scale, name
    keep = settled(jgrads)
    assert sum(k.sum() for k in keep.values()) >= 0.98 * sum(k.size for k in keep.values())
    for name, want in jparams.items():
        np.testing.assert_array_equal(r1["params"][name], r0["params"][name], err_msg=name)
        k = keep[name]
        for got, ref in ((r0["params"], one["params"]), (r0["ema"], one["ema"]),
                         (r0["params"], jparams), (r0["ema"], jema)):
            np.testing.assert_allclose(got[name][k], ref[name][k], rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL, err_msg=name)


@pytest.mark.parametrize("zero1", [False, True])
def test_dp_step_collectives(port_dp, zero1):
    """Each step: exactly one all_reduce (the flat fp32 gradients and the
    loss), and under ZeRO-1 one all_gather of the updated slices."""
    from instancediffusion_tpu_torch.parallel.zero import FlatLayout

    for rank in port_dp[0][zero1]:
        lay = FlatLayout([p.size for p in rank["params"].values()], 2, 0)
        for comm in rank["collectives"]:
            want = {"all_reduce": 1, "all_reduce_bytes": 4 * lay.padded}
            if zero1:
                want.update(all_gather=1, all_gather_bytes=4 * lay.padded)
            assert comm == want


@pytest.mark.parametrize("zero1", [False, True])
def test_nan_on_one_rank_skips_every_rank(port_dp, zero1):
    """NaN in the last rank's rows only: the all-reduced loss is NaN on
    every rank, so every rank skips the step and keeps its parameters."""
    for rank in port_dp[0][zero1]:
        assert np.isnan(rank["nan_loss"]) and rank["nan_skipped"] and rank["nan_kept"]


def test_prefetcher_gives_every_rank_the_same_batch_count(tmp_path):
    """14 records at batch 2 over 4 ranks: JAX's Prefetcher takes len(shard)
    // 2 = 2, 2, 1, 1 batches (the rank that runs out first would leave the
    others waiting in their next collective); the port's every rank 14 // 4
    // 2 = 1, disjoint records, one epoch's batches each."""
    import json

    from instancediffusion_tpu.data import jsondataset as jds
    from instancediffusion_tpu_torch.data import jsondataset as pds
    from instancediffusion_tpu_torch.data.tokenizer import CLIPTokenizer

    from tests.test_dataset import _fake_record

    names = []
    for i in range(14):  # small PNG records: the count is what matters
        (tmp_path / f"{i}.json").write_text(json.dumps(_fake_record(n_annos=2, seed=i)))
        names.append(f"{i}.json")
    listing = tmp_path / "train.txt"
    listing.write_text("\n".join(names) + "\n")
    listing = str(listing)
    kw = dict(image_size=64, max_boxes_per_data=4)
    jset = jds.JsonDataset(listing, jds.SampleDecoder(**kw), seed=0)
    pset = pds.JsonDataset(listing, pds.SampleDecoder(**kw), seed=0)
    tok = CLIPTokenizer.load_default()
    jcounts, seen = [], []
    for r in range(4):
        jcounts.append(len(list(jds.Prefetcher(jset, 2, tokenizer=tok, host_index=r,
                                               num_hosts=4).epoch(0))))
        pf = pds.Prefetcher(pset, 2, tokenizer=tok, host_index=r, num_hosts=4, workers=1)
        assert pf.batches_per_epoch() == 1
        batches = list(pf.epoch(0))
        assert len(batches) == 1 and batches[0]["image"].shape[0] == 2
        seen += [tuple(b["caption_ids"][i]) for b in batches for i in range(2)]
    assert jcounts == [2, 2, 1, 1]
    assert len(seen) == 8


def test_rank_devices_and_refusals(monkeypatch):
    """A rank's device: the one the caller gave (ranks may share it), else
    cuda:LOCAL_RANK, and a rank with no card of its own raises; a mesh
    needs a process group; NCCL needs a card."""
    from instancediffusion_tpu_torch.parallel import mesh

    assert mesh.rank_device("cpu", 3, 4) == torch.device("cpu")
    assert mesh.rank_device("cuda:0", 1, 2) == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert mesh.rank_device(None, 5, 8) == torch.device("cuda", 1)
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="no cuda:2"):
        mesh.rank_device(None, 6, 8)
    assert mesh.rank_and_world() == (0, 1)
    with pytest.raises(RuntimeError, match="init_distributed"):
        mesh.make_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="nccl"):
        mesh.init_distributed("127.0.0.1:1", 2, 0, backend="nccl")
    with pytest.raises(ValueError, match="backend"):
        mesh.init_distributed("127.0.0.1:1", 2, 0, backend="mpi")
