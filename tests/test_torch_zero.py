"""ZeRO-1 (`parallel/zero.py`) on the CPU: the flat slice layout, the
per-rank bytes of the sharded moments and EMA, ZeRO-1 against the
replicated optimizer over 2 steps on 2 gloo ranks, and checkpoints moving
between rank counts: one saved from 2 ZeRO-1 ranks resumes on 1 process,
one saved from 1 process resumes on 2 ranks, each to the next step of the
run that did not stop.

Sharding changes where the optimizer state lives, not what the step
computes: ZeRO-1 against the replicated optimizer, and a restored EMA and
AdamW moments against the saved ones, within JAX's bound
(tests/test_zero.py: rtol 1e-5, atol 1e-7). A run that moves between rank
counts changes the gradients' summation order; its next step is held as
tests/test_torch_parallel.py holds data parallelism: the gradients within
1e-4 of the largest, the parameters and EMA within JAX's rtol 2e-4, atol
1e-6 on the elements `settled` keeps. The EMA rate is 0.5, so that a step
moves the EMA as far as the parameters.
"""

import os

import jax
import numpy as np
import pytest
import torch

from instancediffusion_tpu.models import clip_text as jclip
from instancediffusion_tpu.models import unet as junet
from instancediffusion_tpu.models import vae as jvae
from instancediffusion_tpu_torch.config import Config
from instancediffusion_tpu_torch.io import checkpoint as ckpt_io
from instancediffusion_tpu_torch.models import unet
from instancediffusion_tpu_torch.parallel.zero import FlatLayout
from instancediffusion_tpu_torch.train import optimizer as popt

from tests import torch_ranks
from tests.test_parallel import make_batch, micro_cfg
from tests.test_torch_bridge import densify_tree, port_config
from tests.test_torch_parallel import (EMA_RATE, GRAD_REL, PARAM_ATOL, PARAM_RTOL,
                                       numpy_draws, settled)

LR = 1e-3
ZERO_RTOL, ZERO_ATOL = 1e-5, 1e-7
OPT_KEYS = ("ema", "exp_avg", "exp_avg_sq")


@pytest.fixture(scope="module")
def setup():
    cfg = micro_cfg()
    cfg.train.ema_rate = EMA_RATE
    k = jax.random.PRNGKey(0)
    trees = {
        "unet": densify_tree(junet.init_unet(k, cfg.model), 41),
        "vae": densify_tree(jvae.init_vae(k, cfg.autoencoder), 42),
        "clip": densify_tree(jclip.init_clip_text(k, cfg.text_encoder), 43),
    }
    batches = [make_batch(cfg, 2, seed=10 + s) for s in range(3)]
    draws = [numpy_draws(cfg, jax.random.PRNGKey(20 + s)) for s in range(3)]
    return port_config(cfg), trees, batches, draws


def test_flat_layout_policy():
    """Every parameter in module order, then the loss slot, padded to a
    multiple of the ranks; rank r owns the r-th equal slice."""
    sizes = [48, 168, 1, 15]
    for world in (1, 2, 4, 8):
        lay = [FlatLayout(sizes, world, r) for r in range(world)]
        assert lay[0].numel == 232 and lay[0].loss_at == 232
        assert lay[0].padded % world == 0 and 233 <= lay[0].padded < 233 + world
        assert [(l.lo, l.hi) for l in lay] == [(r * lay[0].shard, (r + 1) * lay[0].shard)
                                                for r in range(world)]
        flat = torch.arange(lay[0].padded, dtype=torch.float32)
        parts = lay[0].split(flat)
        assert [p.numel() for p in parts] == sizes and parts[3][0] == 217


@pytest.mark.parametrize("world", [2, 4, 8])
def test_sharded_bytes_are_one_nth(world):
    """At SD1.5 scale (the trainable parameters of `Config()`'s UNet) a
    rank's AdamW moments and EMA come to (2 + 1) x 4 bytes x the trainable
    count / N, plus at most N - 1 padding elements: about 4.43 GB / N."""
    u = unet.UNet(Config().model, device="meta")
    popt.trainable_mask(u)
    sizes = [p.numel() for p in popt.trainable_parameters(u).values()]
    full = 12 * sum(sizes)
    assert 4.40e9 < full < 4.46e9
    lay = FlatLayout(sizes, world, world - 1)
    assert full / world <= lay.sharded_bytes() <= full / world + 12 * world


@pytest.fixture(scope="module")
def two_rank_runs(setup, tmp_path_factory):
    """On 2 ranks: the replicated optimizer and ZeRO-1 (2 steps), then a
    ZeRO-1 run that saves after 2 steps and takes a third."""
    pcfg, trees, batches, draws = setup
    path = str(tmp_path_factory.mktemp("zero2") / "checkpoint_latest")
    dp = torch_ranks.spawn_ranks(torch_ranks.dp_train, 2, pcfg, trees, batches[:2], draws[:2],
                                 LR)
    saved = torch_ranks.spawn_ranks(torch_ranks.zero_ckpt, 2, pcfg, trees, batches, draws, LR,
                                    path, False)
    init = torch_ranks.trained(torch_ranks.port_train_state(pcfg, trees, LR, None))
    return dp.results(), path, saved.results(), init


def _assert_zero_close(got: dict, want: dict, what: str):
    """{name: array} of two runs within JAX's ZeRO bound."""
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=ZERO_RTOL, atol=ZERO_ATOL,
                                   err_msg=f"{what} {name}")


def _assert_same_state(got: dict, want: dict, keys=OPT_KEYS):
    """The EMA and AdamW moments (`torch_ranks.opt_arrays`) of two runs
    within JAX's ZeRO bound."""
    for key in keys:
        _assert_zero_close(got[key], want[key], key)


def test_zero1_matches_replicated(two_rank_runs):
    """ZeRO-1 and the replicated optimizer give the same losses, averaged
    gradients, parameters, EMA and AdamW moments after 2 steps on both
    ranks; the EMA moved from the initial parameters by at least a tenth
    of the parameters' own movement (so a stale EMA cannot pass)."""
    dp = two_rank_runs[0]
    for rank in dp:
        rep, z = rank[False], rank[True]
        np.testing.assert_allclose(z["losses"], rep["losses"], rtol=ZERO_RTOL)
        for got, want in zip(z["grads"], rep["grads"]):
            _assert_zero_close(got, want, "grads")
        _assert_same_state(z, rep, ("params", *OPT_KEYS))
    init = two_rank_runs[3]
    for name, p0 in init.items():
        moved = np.abs(dp[0][True]["params"][name] - p0).max()
        assert np.abs(dp[0][True]["ema"][name] - p0).max() >= 0.1 * moved, name


def _one_process(pcfg, trees, batches, draws, path=None, save_to=None):
    """One process (no group): restore `path` or run all but the last
    batch (saving into `save_to`), then the last step. Returns the EMA and
    moments as saved or restored, the last step's gradients, and the state
    after it."""
    state = torch_ranks.port_train_state(pcfg, trees, LR, None)
    rows = slice(0, batches[0]["image"].shape[0])
    if path is not None:
        state = ckpt_io.restore_train_ckpt(path, state)
    else:
        state, _, _ = torch_ranks.train_steps(state, pcfg, batches[:-1], draws[:-1], rows)
        ckpt_io.save_train_ckpt(save_to, state, None)
    at_ckpt = torch_ranks.opt_arrays(state)
    grads = torch_ranks.record_grads(state)
    state, _, _ = torch_ranks.train_steps(state, pcfg, batches[-1:], draws[-1:], rows)
    return at_ckpt, grads[0], state


def _assert_same_step(got: dict, want: dict):
    """The step after a checkpoint, on another rank count: its gradients
    within GRAD_REL of the largest; the parameters and EMA within JAX's
    bound on the elements `settled` keeps by the reference's gradients."""
    scale = max(np.abs(g).max() for g in want["grads"].values())
    keep = settled([want["grads"]])
    assert set(got["params"]) == set(want["params"]) == set(keep)
    for name, k in keep.items():
        assert np.abs(got["grads"][name] - want["grads"][name]).max() <= GRAD_REL * scale
        for key in ("params", "ema"):
            np.testing.assert_allclose(got[key][name][k], want[key][name][k], rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL, err_msg=f"{key} {name}")


def test_checkpoint_from_two_ranks_resumes_on_one(setup, two_rank_runs):
    """The file 2 ZeRO-1 ranks saved (rank 0 wrote it, in the one-process
    format: per-parameter moments with every rank's slice) restores on one
    process to the EMA and moments the ranks held, and resumes to the
    2-rank run's third step."""
    pcfg, trees, batches, draws = setup
    _, path, saved, _ = two_rank_runs
    payload = torch.load(path, weights_only=False)
    names = list(saved[0]["params"])
    assert list(payload["ema"]) == names and payload["step"] == 2
    assert sorted(payload["optimizer"]["state"]) == list(range(len(names)))
    assert payload["optimizer"]["param_groups"][0]["params"] == list(range(len(names)))
    restored, grads, state = _one_process(pcfg, trees, batches, draws, path=path)
    _assert_same_state(restored, saved[0]["at_ckpt"])
    assert state.step == 3 == saved[0]["step"]
    _assert_same_step({"grads": grads, "params": torch_ranks.trained(state),
                       **torch_ranks.opt_arrays(state)}, saved[0])


def test_checkpoint_from_one_process_resumes_on_two(setup, tmp_path):
    """A one-process checkpoint restores on 2 ZeRO-1 ranks (each takes its
    slice of the moments and the EMA; gathered, they are the saved ones)
    and resumes to the one-process run's third step; each rank holds half
    the sharded state."""
    pcfg, trees, batches, draws = setup
    at_save, grads, state = _one_process(pcfg, trees, batches, draws, save_to=str(tmp_path))
    path = os.path.join(str(tmp_path), "checkpoint_latest")
    ranks = torch_ranks.run_ranks(torch_ranks.zero_ckpt, 2, pcfg, trees, batches, draws, LR,
                                  path, True)
    want = {"grads": grads, "params": torch_ranks.trained(state),
            **torch_ranks.opt_arrays(state)}
    sizes = [v.size for v in want["params"].values()]
    for rank in ranks:
        _assert_same_state(rank["at_ckpt"], at_save)
        assert rank["step"] == 3
        assert rank["sharded_bytes"] == FlatLayout(sizes, 2, 0).sharded_bytes()
        _assert_same_step(rank, want)
