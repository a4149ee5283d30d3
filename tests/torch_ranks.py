"""Gloo ranks for the port's multi-rank CPU tests, and the work each rank
does. Imports no JAX: a spawned rank imports this module, torch and the
port only.

`run_ranks(fn, world, *args)` spawns `world` processes on 127.0.0.1 (a
free port, one intra-op thread each, `spawn` start method), joins them to
one gloo group through the port's own `init_distributed`, runs
`fn(rank, world, *args)` in each and returns the results by rank
(`spawn_ranks` starts them and returns, so a test can compute its JAX
reference while they run). A rank that raises fails the call with its
traceback; the wait is bounded and every process is killed after it, so
no test can hang the suite.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import socket
import time
import traceback

import numpy as np
import torch


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(fn, rank, world, port, args, out, join):
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ.setdefault("IDTPU_ALLOW_HASH_TOKENIZER", "1")
    torch.set_num_threads(1)
    from instancediffusion_tpu_torch.parallel.mesh import init_distributed

    try:
        if join:
            init_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo", timeout_s=120)
            out.put((rank, True, fn(rank, world, *args)))
        else:
            out.put((rank, True, fn(rank, world, f"127.0.0.1:{port}", *args)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


class Ranks:
    """Ranks started by `spawn_ranks`; `results()` waits for them."""

    def __init__(self, procs, out, world: int, timeout: float):
        self.procs, self.out, self.world = procs, out, world
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout

    def results(self) -> list:
        """Every rank's result, by rank; a rank's failure raises with its
        traceback. Every process is joined or killed before it returns."""
        results: dict = {}
        try:
            while len(results) < self.world:
                try:
                    rank, ok, res = self.out.get(
                        timeout=max(0.1, self.deadline - time.monotonic()))
                except queue.Empty:
                    raise TimeoutError(f"{self.world - len(results)} of {self.world} ranks gave "
                                       f"no result in {self.timeout:.0f}s") from None
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{res}")
                results[rank] = res
        finally:
            for p in self.procs:
                p.join(timeout=max(1.0, self.deadline - time.monotonic()))
                if p.is_alive():
                    p.kill()
                    p.join(5)
        assert not any(p.is_alive() for p in self.procs)
        return [results[r] for r in range(self.world)]


def spawn_ranks(fn, world: int, *args, timeout: float = 150.0, join: bool = True) -> Ranks:
    """Start fn(rank, world, *args) on `world` gloo ranks and return at once
    (the caller may work meanwhile). join=False: the ranks join no group
    first, and fn(rank, world, "127.0.0.1:PORT", *args) meets the others
    itself."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry, args=(fn, r, world, port, args, out, join), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    return Ranks(procs, out, world, timeout)


def run_ranks(fn, world: int, *args, timeout: float = 150.0, join: bool = True) -> list:
    """fn(rank, world, *args) on `world` gloo ranks; their results by rank."""
    return spawn_ranks(fn, world, *args, timeout=timeout, join=join).results()


# ---------------------------------------------------------------------------
# Work of the ranks
# ---------------------------------------------------------------------------


def port_train_state(pcfg, trees, lr: float, zero1: bool | None, warmup: int = 0):
    """fp32 port TrainState from numpy trees (UNet, VAE with encoder, CLIP),
    AdamW at `lr`; data-parallel over the default group unless zero1 is
    None (one rank, no group)."""
    from instancediffusion_tpu_torch.io.jax_params import load_jax_params
    from instancediffusion_tpu_torch.models import clip_text, unet, vae
    from instancediffusion_tpu_torch.parallel.zero import DataParallel
    from instancediffusion_tpu_torch.train import optimizer as popt
    from instancediffusion_tpu_torch.train import train_step as pts

    u = unet.UNet(pcfg.model)
    v = vae.AutoencoderKL(pcfg.autoencoder, encoder=True)
    c = clip_text.CLIPTextModel(pcfg.text_encoder)
    load_jax_params(u, unet=trees["unet"])
    load_jax_params(v, vae=trees["vae"])
    load_jax_params(c, clip=trees["clip"])
    popt.trainable_mask(u)
    dp = None if zero1 is None else DataParallel(popt.trainable_parameters(u), zero1=zero1)
    state = pts.TrainState(step=0, unet=u, ema=None, vae=v, clip=c, dp=dp)
    state.optimizer, state.scheduler = popt.make_optimizer(u, lr, warmup_steps=warmup, dp=dp)
    if dp is None or not dp.zero1:
        state.ema = popt.init_ema(u)
    return state


def draws_rows(draws: dict, rows: slice):
    """The port's Draws of `rows` from numpy draws {vae_noise, t, noise,
    drop_all, u}."""
    from instancediffusion_tpu_torch.models import unifusion
    from instancediffusion_tpu_torch.train import train_step as pts

    return pts.Draws(torch.from_numpy(draws["vae_noise"][rows]),
                     torch.from_numpy(draws["t"][rows]).long(),
                     torch.from_numpy(draws["noise"][rows]), draws["drop_all"],
                     unifusion.train_modality_drops(draws["u"]))


def batch_rows(batch: dict, rows: slice) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v[rows])) for k, v in batch.items()}


def trained(state) -> dict:
    from instancediffusion_tpu_torch.train import optimizer as popt

    return {n: p.detach().numpy().copy()
            for n, p in popt.trainable_parameters(state.unet).items()}


def record_grads(state) -> list:
    """A list that receives, at each optimizer step, the gradients the
    optimizer steps with ({name: numpy}; under data parallelism the
    averaged ones, every parameter's also under ZeRO-1)."""
    from instancediffusion_tpu_torch.train import optimizer as popt

    params = popt.trainable_parameters(state.unet)
    seen: list = []
    step = state.optimizer.step

    def grads():
        if state.dp is None:
            return {n: p.grad for n, p in params.items()}
        flat = state.dp.layout.split(state.dp.flat)
        return {n: g.view_as(p) for (n, p), g in zip(params.items(), flat)}

    def step_and_record(*a, **kw):
        seen.append({n: g.numpy().copy() for n, g in grads().items()})
        return step(*a, **kw)

    state.optimizer.step = step_and_record
    return seen


def opt_arrays(state) -> dict:
    """The EMA and the AdamW moments in the one-process layout: {"ema",
    "exp_avg", "exp_avg_sq": {name: numpy}} (under ZeRO-1 gathered from
    every rank: a collective)."""
    from instancediffusion_tpu_torch.train import optimizer as popt

    names = list(popt.trainable_parameters(state.unet))
    if state.dp is not None and state.dp.zero1:
        opt_sd, ema = state.dp.full_state(state.optimizer)
    else:
        opt_sd, ema = state.optimizer.state_dict(), state.ema
    out = {"ema": {n: ema[n].detach().numpy().copy() for n in names}}
    for key in ("exp_avg", "exp_avg_sq"):
        out[key] = {n: opt_sd["state"][i][key].numpy().copy() for i, n in enumerate(names)}
    return out


def train_steps(state, pcfg, batches, draws, rows, collectives=None):
    """Run one step per (batch, draws) on `rows`; the losses (global under
    data parallelism) and skips. `collectives` receives each step's
    collective counts."""
    from instancediffusion_tpu_torch import parallel
    from instancediffusion_tpu_torch.ops.schedules import make_diffusion_schedule
    from instancediffusion_tpu_torch.train import train_step as pts

    step = pts.make_train_step(pcfg, make_diffusion_schedule("linear", 1000, 0.00085, 0.012),
                               torch.float32)
    losses, skipped = [], []
    for batch, dr in zip(batches, draws):
        parallel.reset_collective_counts()
        state, m = step(state, batch_rows(batch, rows), draws_rows(dr, rows))
        losses.append(float(m["loss"]))
        skipped.append(m["skipped"])
        if collectives is not None:
            collectives.append(dict(parallel.COLLECTIVES))
    return state, losses, skipped


def dp_train(rank, world, pcfg, trees, batches, draws, lr):
    """Each rank, with the replicated optimizer and then with ZeRO-1: its
    rows of every step's batch; then one more step with NaN in the last
    rank's rows. Returns, by zero1: the losses, skips, collectives and
    averaged gradients per step, the trained parameters, EMA and AdamW
    moments after the good steps, the NaN step's skip and whether it left
    the parameters as they were."""
    out = {}
    for zero1 in (False, True):
        state = port_train_state(pcfg, trees, lr, zero1)
        n = batches[0]["image"].shape[0] // world
        rows = slice(rank * n, (rank + 1) * n)
        comm: list = []
        grads = record_grads(state)
        state, losses, skipped = train_steps(state, pcfg, batches, draws, rows, comm)
        opt = opt_arrays(state)
        params = trained(state)
        bad = dict(batches[-1], image=batches[-1]["image"].copy())
        bad["image"][-n:] = np.nan
        state, nan_losses, nan_skipped = train_steps(state, pcfg, [bad], draws[-1:], rows)
        out[zero1] = {
            "losses": losses, "skipped": skipped, "collectives": comm, "params": params,
            "grads": grads, **opt,
            "nan_loss": nan_losses[0], "nan_skipped": nan_skipped[0],
            "nan_kept": all(np.array_equal(v, params[k]) for k, v in trained(state).items()),
        }
    return out


def one_rank_train(pcfg, trees, batches, draws, lr):
    """The same steps on one process over the whole batch (no group)."""
    state = port_train_state(pcfg, trees, lr, None)
    grads = record_grads(state)
    state, losses, _ = train_steps(state, pcfg, batches, draws,
                                   slice(0, batches[0]["image"].shape[0]))
    return {"losses": losses, "params": trained(state), "grads": grads, **opt_arrays(state)}


def tp_forward(rank, world, pcfg, unet_tree, inputs, n_model):
    """Each rank: `tp_apply_unet` on a (world / n_model, n_model) mesh over
    the whole inputs, at gate 1 and at gate 0; the outputs and the
    all_reduces of each forward."""
    from instancediffusion_tpu_torch import parallel
    from instancediffusion_tpu_torch.io.jax_params import load_jax_params
    from instancediffusion_tpu_torch.models import unet
    from instancediffusion_tpu_torch.parallel import tp
    from instancediffusion_tpu_torch.parallel.mesh import make_mesh

    u = unet.UNet(pcfg.model)
    load_jax_params(u, unet=unet_tree)
    mesh = make_mesh(n_model=n_model)
    local = tp.shard_unet(u, mesh)
    x, t, ctx, objs = (torch.from_numpy(inputs[k]) for k in ("x", "t", "ctx", "objs"))
    out = {}
    with torch.no_grad():
        for gate in (1.0, 0.0):
            parallel.reset_collective_counts()
            eps = tp.tp_apply_unet(mesh, pcfg.model, local, x, t.long(), ctx, objs,
                                   gate_scale=gate)
            # tp_apply_unet's own row gather over "data" is one all_gather
            out[gate] = (eps.numpy().copy(), dict(parallel.COLLECTIVES))
    return out


def zero_ckpt(rank, world, pcfg, trees, batches, draws, lr, path, resume):
    """ZeRO-1 over the ranks. resume=False: the steps of all but the last
    batch, `save_train_ckpt` into `path`'s folder (every rank calls it,
    rank 0 writes), then the last step. resume=True: `restore_train_ckpt`
    from `path`, then the last step. Returns the EMA and moments as saved or
    as restored (`opt_arrays`), the last step's averaged gradients, the
    trained parameters, EMA and moments after it, and this rank's moment +
    EMA bytes."""
    from instancediffusion_tpu_torch.io import checkpoint as ckpt_io

    state = port_train_state(pcfg, trees, lr, True)
    n = batches[0]["image"].shape[0] // world
    rows = slice(rank * n, (rank + 1) * n)
    if resume:
        state = ckpt_io.restore_train_ckpt(path, state)
    else:
        state, _, _ = train_steps(state, pcfg, batches[:-1], draws[:-1], rows)
        saved = ckpt_io.save_train_ckpt(os.path.dirname(path), state, None)
        assert saved == path
    at_ckpt = opt_arrays(state)
    grads = record_grads(state)
    state, _, _ = train_steps(state, pcfg, batches[-1:], draws[-1:], rows)
    return {"at_ckpt": at_ckpt, "grads": grads[0], "params": trained(state),
            **opt_arrays(state), "step": state.step,
            "sharded_bytes": state.dp.layout.sharded_bytes()}


def mesh_generate(rank, world, pcfg, trees, metas, kw, n_models):
    """Each rank: a pipeline from numpy trees (fp32, CPU) and
    `generate_batch(metas, mesh=)` on a (world / n_model, n_model) mesh for
    each n_model; the images (every rank's) and the all_gathers of each."""
    from instancediffusion_tpu_torch import parallel
    from instancediffusion_tpu_torch.io.jax_params import load_jax_params
    from instancediffusion_tpu_torch.parallel.mesh import make_mesh
    from instancediffusion_tpu_torch.pipeline import InstanceDiffusionPipeline

    pipe = InstanceDiffusionPipeline.random_init(pcfg, seed=0, device="cpu", dtype=torch.float32)
    load_jax_params(pipe, **trees)
    out = {}
    for n_model in n_models:
        parallel.reset_collective_counts()
        imgs = pipe.generate_batch(metas, mesh=make_mesh(n_model=n_model), **kw)
        out[n_model] = (imgs, dict(parallel.COLLECTIVES))
    return out


def coco_eval_main(rank, world, coordinator, pcfg, argv):
    """Each rank: the coco_eval CLI with --mesh at its rank, the pipeline
    built from `pcfg` (a tiny config) in place of `Config()`."""
    from instancediffusion_tpu_torch import config
    from instancediffusion_tpu_torch.evalsuite import coco_eval

    config.Config = lambda: pcfg
    return coco_eval.main([*argv, "--mesh", "--device", "cpu", "--coordinator", coordinator,
                           "--num_processes", str(world), "--process_id", str(rank)])["images"]


def serve_mesh(rank, world, pcfg, trees, meta, kw):
    """`serve(mesh=)` over the ranks: rank 0 serves (port 0, batch 2, no
    warm-up), posts one request (seed 7) and stops the server, which ends
    the followers; every other rank runs `follow`. Rank 0 returns the PNG
    bytes and the health reply, the others their batch count."""
    import json
    import urllib.request

    from instancediffusion_tpu_torch import serve
    from instancediffusion_tpu_torch.io.jax_params import load_jax_params
    from instancediffusion_tpu_torch.parallel.mesh import make_mesh
    from instancediffusion_tpu_torch.pipeline import InstanceDiffusionPipeline

    pipe = InstanceDiffusionPipeline.random_init(pcfg, seed=0, device="cpu", dtype=torch.float32)
    load_jax_params(pipe, **trees)
    mesh = make_mesh()
    if rank != 0:
        return serve.follow(pipe, mesh)
    server = serve.serve(pipe, port=0, batch_size=2, max_wait_ms=20.0, warmup=False, mesh=mesh,
                         **kw)
    try:
        port = server.server_address[1]
        req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                     data=json.dumps(dict(meta, seed=7)).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            png = r.read()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            health = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.close()
        server.leader.close()
    return png, health
