"""`generate_batch(mesh=)` of the port on the CPU: 2 gloo ranks with the
batch over "data" (3 metas, so the padding row runs) against JAX's
`generate_batch(mesh=make_mesh(2))` on the conftest's virtual mesh and
against one process of the port, and with the UNet over "model" (data 1 x
model 2, tensor parallel) against one process. PLMS with the
Multi-Instance Sampler (mis 0.5: each image keeps its own trajectory
weights over the padded trajectory count) on the tiny config's densified
weights, fp32; every image within one uint8 level (JAX's bound for
sampling under resharding, tests/test_tp.py), and the same on every rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import instancediffusion_tpu.data.grounding_input as gi
from instancediffusion_tpu.parallel.mesh import make_mesh
from instancediffusion_tpu.pipeline import InstanceDiffusionPipeline as JaxPipeline
from instancediffusion_tpu.pipeline import PipelineParams
from instancediffusion_tpu_torch.io.jax_params import load_jax_params
from instancediffusion_tpu_torch.pipeline import InstanceDiffusionPipeline

from tests import torch_ranks
from tests.test_pipeline import META, tiny_config
from tests.test_torch_bridge import dense_params, port_config, to_jax

SEEDS = [3, 1, 4]
KW = dict(steps=4, seeds=SEEDS, mis=0.5, sampler="plms")


def _metas(cfg):
    """Three metas with 2, 1 and 0 instances (uneven MIS trajectory counts)."""
    g = cfg.model.grounding_tokenizer
    one = {"prompt": "one shape", "phrases": ["a green triangle"],
           "locations": [[0.2, 0.3, 0.7, 0.9]], "points": [[0.45, 0.6]],
           "scribbles": [[0.4] * (g.n_scribble_points * 2)]}
    none = {"prompt": "an empty field", "phrases": [], "locations": []}
    return [dict(META), one, none]


@pytest.fixture(scope="module")
def runs():
    cfg = tiny_config()
    trees = dense_params(cfg, seed=17)
    pcfg = port_config(cfg)
    metas = _metas(cfg)
    mc = cfg.model
    x0 = np.concatenate([np.asarray(jax.random.normal(
        jax.random.PRNGKey(s), (1, mc.image_size, mc.image_size, mc.in_channels)))
        for s in SEEDS])
    kw = dict(KW, initial_latents=x0)
    ranks = torch_ranks.spawn_ranks(torch_ranks.mesh_generate, 2, pcfg, trees, metas, kw,
                                    (1, 2))
    g = mc.grounding_tokenizer
    old = (gi.N_SCRIBBLE_POINTS, gi.N_POLYGON_POINTS, gi.SEG_SIZE)
    gi.N_SCRIBBLE_POINTS, gi.N_POLYGON_POINTS, gi.SEG_SIZE = (
        g.n_scribble_points, g.n_polygon_points, g.seg_resize_input)
    try:
        jpipe = JaxPipeline(cfg, PipelineParams(**{k: to_jax(v) for k, v in trees.items()}))
        ref = jpipe.generate_batch(metas, mesh=make_mesh(n_data=2, devices=jax.devices()[:2]),
                                   compute_dtype=jnp.float32, **KW)
    finally:
        gi.N_SCRIBBLE_POINTS, gi.N_POLYGON_POINTS, gi.SEG_SIZE = old
    one = InstanceDiffusionPipeline.random_init(pcfg, seed=0, device="cpu", dtype=torch.float32)
    load_jax_params(one, **trees)
    single = one.generate_batch(metas, **kw)
    return ref, single, ranks.results()


def _within_one_level(a, b):
    assert a.shape == b.shape and a.dtype == np.uint8
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_data_parallel_generate_batch_matches_jax_and_one_process(runs):
    """data 2: 3 metas padded to 4, each rank samples 2 rows; every rank
    returns JAX's 2-device images and the one-process images (3, H, W, 3),
    gathered by one all_gather."""
    ref, single, ranks = runs
    assert ref.shape[0] == 3 and int(ref.max()) - int(ref.min()) > 10
    for rank in ranks:
        imgs, comm = rank[1]
        np.testing.assert_array_equal(imgs, ranks[0][1][0])
        _within_one_level(imgs, ref)
        _within_one_level(imgs, single)
        assert comm.get("all_gather") == 1 and "all_reduce" not in comm


def test_tensor_parallel_generate_batch_matches_one_process(runs):
    """model 2: the UNet's transformer stack over 2 ranks (heads and FF
    columns), the same images as one process on both ranks, every UNet
    forward's row-parallel projections completed by all_reduces."""
    _, single, ranks = runs
    for rank in ranks:
        imgs, comm = rank[2]
        np.testing.assert_array_equal(imgs, ranks[0][2][0])
        _within_one_level(imgs, single)
        assert comm["all_reduce"] > 0 and "all_gather" not in comm
