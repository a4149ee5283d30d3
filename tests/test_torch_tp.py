"""Tensor parallelism of the port's UNet (`parallel/tp.py`) on the CPU
against the JAX package's on the conftest's virtual mesh: `tp_apply_unet`
on 2 gloo ranks (data 1 x model 2) and on 4 (data 2 x model 2) against
JAX's `tp_apply_unet` over the same mesh shapes and against the port's
replicated forward; the all_reduces a forward issues against the count
`all_reduces_per_forward` derives from the layer plan; the GEGLU row
interleave; the parameter specs against JAX's on the torch layout.

Densified weights from numpy, fp32 on both sides; tolerances JAX's own
for the TP forward (tests/test_tp.py: rtol 2e-5, atol 2e-6).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from instancediffusion_tpu.models import unet as junet
from instancediffusion_tpu.models import unifusion as junifusion
from instancediffusion_tpu.parallel import tp as jtp
from instancediffusion_tpu.parallel.mesh import make_mesh
from instancediffusion_tpu_torch.io.jax_params import load_jax_params
from instancediffusion_tpu_torch.models import unet
from instancediffusion_tpu_torch.parallel import tp

from tests import torch_ranks
from tests.test_parallel import micro_cfg
from tests.test_torch_bridge import densify_tree, port_config, to_jax

RTOL, ATOL = 2e-5, 2e-6
B = 8


@pytest.fixture(scope="module")
def setup():
    cfg = micro_cfg()
    mcfg = cfg.model
    tree = densify_tree(junet.init_unet(jax.random.PRNGKey(0), mcfg), 31)
    r = np.random.RandomState(3)
    g = junifusion.null_grounding(B, mcfg.max_objs, mcfg.grounding_tokenizer)
    objs, _ = junifusion.apply_unifusion(
        to_jax(tree["position_net"]), mcfg.grounding_tokenizer, g,
        junifusion.ModalityDrops.test_defaults(mcfg.grounding_tokenizer))
    inputs = {
        "x": r.randn(B, mcfg.image_size, mcfg.image_size, mcfg.in_channels).astype(np.float32),
        "t": r.randint(0, 1000, (B,)).astype(np.int32),
        "ctx": r.randn(B, 77, mcfg.context_dim).astype(np.float32),
        "objs": np.asarray(objs, np.float32),
    }
    return cfg, port_config(cfg), tree, inputs


@pytest.fixture(scope="module")
def replicated(setup):
    """The port's plain forward (one process) at gate 1 and gate 0."""
    _, pcfg, tree, inp = setup
    u = unet.UNet(pcfg.model)
    load_jax_params(u, unet=tree)
    x, t, ctx, objs = (torch.from_numpy(inp[k]) for k in ("x", "t", "ctx", "objs"))
    with torch.no_grad():
        return {gate: unet.apply_unet(u, pcfg.model, x, t.long(), ctx, gate_scale=gate,
                                      precomputed_objs=objs).numpy()
                for gate in (1.0, 0.0)}


@pytest.fixture(scope="module", params=[(1, 2), (2, 2)], ids=["data1xmodel2", "data2xmodel2"])
def meshes(request, setup):
    """(mesh shape, JAX's tp_apply_unet at gate 1, the port's ranks)."""
    n_data, n_model = request.param
    cfg, pcfg, tree, inp = setup
    ranks = torch_ranks.spawn_ranks(torch_ranks.tp_forward, n_data * n_model, pcfg, tree, inp,
                                    n_model)
    mesh = make_mesh(n_data=n_data, n_model=n_model, devices=jax.devices()[:n_data * n_model])
    params = to_jax(tree)
    ref = jax.jit(lambda p, x, t, c, o: jtp.tp_apply_unet(
        mesh, cfg.model, p, x, t, c, o, gate_scale=1.0))(
        params, *(jnp.asarray(inp[k]) for k in ("x", "t", "ctx", "objs")))
    return request.param, np.asarray(ref), ranks.results()


def test_tp_forward_matches_jax_and_replicated(meshes, replicated):
    """Every rank returns the whole batch: JAX's sharded forward at gate 1,
    and the port's replicated forward at gate 1 and gate 0 (the fuser
    skipped)."""
    _, ref, ranks = meshes
    for rank in ranks:
        np.testing.assert_allclose(rank[1.0][0], ref, rtol=RTOL, atol=ATOL)
        for gate in (1.0, 0.0):
            np.testing.assert_allclose(rank[gate][0], replicated[gate], rtol=RTOL, atol=ATOL)


def test_tp_all_reduces_per_forward(meshes, setup):
    """A forward issues `all_reduces_per_forward` all_reduces over "model":
    five per transformer block (three to_out, two FFs), three at gate 0;
    micro_cfg's four spatial transformers of depth 1 give 20 and 12. The
    batch's gather over "data" is one all_gather."""
    (n_data, _), _, ranks = meshes
    cfg = setup[1].model
    assert tp.all_reduces_per_forward(cfg, 1.0) == 20
    assert tp.all_reduces_per_forward(cfg, 0.0) == 12
    for rank in ranks:
        for gate in (1.0, 0.0):
            comm = rank[gate][1]
            assert comm["all_reduce"] == tp.all_reduces_per_forward(cfg, gate)
            assert comm.get("all_gather", 0) == (n_data > 1)


def test_sd15_all_reduce_count():
    """SD1.5's 16 transformer blocks: 80 all_reduces a forward (48 at gate 0)."""
    from instancediffusion_tpu_torch.config import Config

    assert tp.all_reduces_per_forward(Config().model, 1.0) == 80
    assert tp.all_reduces_per_forward(Config().model, 0.0) == 48


def test_geglu_interleave_roundtrip():
    """`shuffle_ffn_params` reorders the up-projection rows so a contiguous
    per-rank slice holds matched [a_r | gate_r] halves: the ranks' partial
    sums by hand equal the unsharded GEGLU (JAX's test_tp.py, torch
    layout)."""
    g = torch.Generator().manual_seed(0)
    d, inner, tp_size = 6, 8, 2
    w1 = torch.randn(2 * inner, d, generator=g)
    b1 = torch.randn(2 * inner, generator=g)
    w2 = torch.randn(d, inner, generator=g)
    b2 = torch.randn(d, generator=g)
    x = torch.randn(3, d, generator=g)
    a, gate = torch.nn.functional.linear(x, w1, b1).chunk(2, dim=-1)
    ref = torch.nn.functional.linear(a * torch.nn.functional.gelu(gate), w2, b2)
    w1s, b1s = tp.shuffle_ffn_params(w1, tp_size), tp.shuffle_ffn_params(b1, tp_size)
    rows, cols = 2 * inner // tp_size, inner // tp_size
    acc = 0.0
    for r in range(tp_size):
        al, gl = torch.nn.functional.linear(x, w1s[r * rows:(r + 1) * rows],
                                            b1s[r * rows:(r + 1) * rows]).chunk(2, dim=-1)
        acc = acc + torch.nn.functional.linear(al * torch.nn.functional.gelu(gl),
                                               w2[:, r * cols:(r + 1) * cols])
    torch.testing.assert_close(acc + b2, ref, rtol=1e-5, atol=1e-6)
    assert torch.equal(tp.shuffle_ffn_params(w1, 1), w1)


def test_param_specs_match_jax(setup):
    """The port's specs are JAX's on the torch layout: JAX's column shard of
    a (in, out) weight slices torch's dim 0, its row shard dim 1, a sharded
    bias dim 0; the rest is replicated, parameter for parameter."""
    cfg, pcfg, tree, _ = setup
    jspecs = jtp.param_specs(to_jax(tree))
    want = {}
    for path, spec in jax.tree_util.tree_leaves_with_path(
            jspecs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec)):
        keys = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
        want[".".join(keys)] = spec
    u = unet.UNet(pcfg.model, device="meta")
    specs = tp.param_specs(u)
    shapes = dict(u.named_parameters())
    n = {0: 0, 1: 0}
    for name, dim in specs.items():
        head, _, leaf = name.rpartition(".")
        key = f"{head}.{'w' if leaf == 'weight' else 'b'}" if leaf in ("weight", "bias") else name
        spec = want.get(key, want.get(name.replace(".weight", ".scale")))
        if dim is None:
            assert spec in (None, jax.sharding.PartitionSpec()), name
            continue
        n[dim] += 1
        if spec == jax.sharding.PartitionSpec(None, "model"):
            assert dim == 0 and shapes[name].ndim == 2, name
        else:
            assert spec == jax.sharding.PartitionSpec("model"), name
            assert dim == (1 if shapes[name].ndim == 2 else 0), name
    assert n[0] > 0 and n[1] > 0


def test_shard_unet_slices_and_shares(setup):
    """A rank's copy holds its slice of every sharded parameter (the GEGLU
    rows interleaved first) and shares every other parameter with the
    UNet; heads that do not split raise."""
    _, pcfg, tree, _ = setup
    u = unet.UNet(pcfg.model)
    load_jax_params(u, unet=tree)
    full = dict(u.named_parameters())
    for r in range(2):
        local = dict(tp.shard_module(u, 2, r).named_parameters())
        for name, dim in tp.param_specs(u).items():
            if dim is None:
                assert local[name] is full[name], name
                continue
            t = full[name]
            if ".ff.proj." in name:
                t = tp.shuffle_ffn_params(t, 2)
            n = t.shape[dim] // 2
            assert torch.equal(local[name], t.narrow(dim, r * n, n)), name
    with pytest.raises(ValueError, match="num_heads"):
        tp.shard_module(u, 3, 0)
