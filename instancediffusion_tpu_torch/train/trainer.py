"""Host-side training driver (counterpart of
`instancediffusion_tpu/train/trainer.py`): data prefetch, the training
step, checkpoints, sample grids, logging and auto-resume, on one device.

Setup, in the JAX Trainer's order: a seeded random `TrainState`; an SD1.5 /
reference checkpoint merged into it (`io/checkpoint.load_weights`: the
reference's strict=False, new parameters keep their init); AdamW with its
warm-up schedule and the EMA; frozen weights to bf16; the auto-resume
folder OUTPUT/name/tagXX and, when an earlier tag holds checkpoint_latest,
its state restored. The loop (`start_training`) is JAX's: it logs every 10
steps, saves checkpoint_latest every ckpt_every_iters, a tagged checkpoint
and the sample grids every save_every_iters, and a final checkpoint. As in
JAX, a resumed run starts its loop again at epoch 0 with a fresh RNG, so it
replays epoch 0's order and draws.

Differences from JAX: one device (no mesh; multi-GPU is not ported); the
draws of a step come from a torch.Generator seeded seed + rank through
`train_step.sample_draws` (`self.draws` is the hook a caller can replace,
as the tests do with JAX's key chain); samples decode in `train.workers`
spawned processes and batches reach the device from pinned memory with
non_blocking copies; the Trainer keeps per-step timings and kernel
launches (`stats`).
"""

from __future__ import annotations

import collections
import dataclasses
import os
import time

import torch

from instancediffusion_tpu_torch import kernels
from instancediffusion_tpu_torch.config import Config
from instancediffusion_tpu_torch.data.jsondataset import (
    JsonDataset, Prefetcher, SampleDecoder, collate,
)
from instancediffusion_tpu_torch.data.tokenizer import CLIPTokenizer
from instancediffusion_tpu_torch.io import checkpoint as ckpt_io
from instancediffusion_tpu_torch.ops.schedules import make_diffusion_schedule
from instancediffusion_tpu_torch.pipeline import default_dtype
from instancediffusion_tpu_torch.train.optimizer import count_trainable, init_ema, make_optimizer
from instancediffusion_tpu_torch.train.train_step import (
    cast_frozen_bf16, init_train_state, latent_shape, make_train_step, sample_draws,
)
from instancediffusion_tpu_torch.utils.logging import MetricLogger


class Trainer:
    def __init__(self, cfg: Config, train_list_file: str,
                 pretrained_ckpt: str | None = None, device="cuda"):
        """Activations run in bf16 on the card and in float32 on the CPU
        (`pipeline.default_dtype`)."""
        self.cfg = cfg
        tcfg = cfg.train
        self.device = torch.device(device)
        self.compute_dtype = default_dtype(self.device)
        self.timings: dict = {"save_s": [], "restore_s": None, "pretrained_s": None,
                              "samples_s": []}
        dc = cfg.diffusion
        self.diffusion = make_diffusion_schedule(
            dc.beta_schedule, dc.timesteps, dc.linear_start, dc.linear_end)

        state = init_train_state(cfg, seed=tcfg.seed, device=self.device)
        if pretrained_ckpt:
            # ingest SD1.5: frozen backbone + VAE + CLIP; new params keep init
            t0 = time.perf_counter()
            merged = ckpt_io.load_weights(state.unet, state.vae, state.clip, pretrained_ckpt,
                                           strict=False)
            self.timings["pretrained_s"] = time.perf_counter() - t0
            print(f"loaded {pretrained_ckpt}: {len(merged['loaded'])} UNet parameters from "
                  f"the file, {len(merged['kept_init'])} kept at init", flush=True)
        state.optimizer, state.scheduler = make_optimizer(
            state.unet, tcfg.base_learning_rate, tcfg.weight_decay, tcfg.warmup_steps,
            tcfg.scheduler_type, tcfg.total_iters)
        state.ema = init_ema(state.unet)
        # fp32 master weights for trainables only; frozen backbone/VAE/CLIP bf16
        state = cast_frozen_bf16(state)

        # auto-resume; refuses to resume with random frozen VAE/CLIP when the
        # checkpoint lacks them and no official checkpoint was passed
        self.folder, prev = ckpt_io.expt_folder_with_auto_resume(tcfg.output_dir, tcfg.name)
        if prev is not None:
            t0 = time.perf_counter()
            state = ckpt_io.restore_train_ckpt(prev, state,
                                               have_pretrained=pretrained_ckpt is not None)
            self._sync()
            self.timings["restore_s"] = time.perf_counter() - t0
            print(f"auto-resumed from {prev} at step {state.step}", flush=True)
        self.state = state
        self.train_step = make_train_step(cfg, self.diffusion, self.compute_dtype)
        self.latent = latent_shape(cfg, cfg.data.image_size)
        self.generator = torch.Generator(device=self.device)
        self.draws = lambda b: sample_draws(self.generator, b, self.latent,
                                            self.diffusion.num_timesteps)

        decoder = SampleDecoder(
            image_size=cfg.data.image_size,
            max_boxes_per_data=cfg.data.max_boxes_per_data,
            prob_use_caption=cfg.data.prob_use_caption,
            random_flip=cfg.data.random_flip,
        )
        self.dataset = JsonDataset(train_list_file, decoder, seed=tcfg.seed)
        self.loader = Prefetcher(
            self.dataset, tcfg.batch_size, tokenizer=CLIPTokenizer.load_default(),
            seed=tcfg.seed, workers=tcfg.workers, pin_memory=self.device.type == "cuda",
        )
        self.logger = MetricLogger(log_dir=os.path.join(self.folder, "Log"))
        self.config_dict = dataclasses.asdict(cfg)
        if tcfg.wandb:
            self.logger.enable_wandb(project="InstDiff", name=tcfg.name, config=self.config_dict)
        print(f"trainable params: {count_trainable(state.unet) / 1e6:.1f}M", flush=True)
        # per step: loss, data wait and step seconds; kernel launches of the
        # steps and of the sample grids
        self.history: list[dict] = []
        self.step_launches: collections.Counter = collections.Counter()
        self.sample_launches: collections.Counter = collections.Counter()
        self.stop_signal: int | None = None  # set by a signal handler: save and stop

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def save(self, latest: bool = True) -> str:
        t0 = time.perf_counter()
        path = ckpt_io.save_train_ckpt(self.folder, self.state, self.config_dict, latest=latest,
                                       iter_idx=None if latest else self.state.step)
        self.timings["save_s"].append(time.perf_counter() - t0)
        return path

    def start_training(self) -> bool:
        """Train to total_iters; returns False when a signal stopped it (after
        saving checkpoint_latest), True when it finished."""
        tcfg = self.cfg.train
        self.generator.manual_seed(tcfg.seed)  # seed + rank, as JAX; one device: rank 0
        step = self.state.step
        epoch = 0
        t_last = time.time()
        print(f"training from step {step} to {tcfg.total_iters}", flush=True)
        while step < tcfg.total_iters:
            batches = self.loader.epoch(epoch)
            first = True  # an epoch's first batch waits for its whole decode
            try:
                while step < tcfg.total_iters:
                    t0 = time.perf_counter()
                    host = next(batches, None)
                    if host is None:
                        break
                    batch = self._to_device(host)
                    t1 = time.perf_counter()
                    before = collections.Counter(kernels.LAUNCHES)
                    self.state, metrics = self.train_step(
                        self.state, batch, self.draws(batch["image"].shape[0]))
                    loss = float(metrics["loss"])
                    t2 = time.perf_counter()
                    self.step_launches.update(collections.Counter(kernels.LAUNCHES) - before)
                    step += 1
                    self.history.append({"step": step, "loss": loss,
                                         "skipped": metrics["skipped"], "epoch_start": first,
                                         "data_s": t1 - t0, "step_s": t2 - t1})
                    first = False

                    if step % 10 == 0:
                        dt = time.time() - t_last
                        t_last = time.time()
                        self.logger.log(step, {"loss": loss, "sec/iter": dt / 10})
                    if step % tcfg.ckpt_every_iters == 0:
                        self.save()
                    if step % tcfg.save_every_iters == 0:
                        self.save(latest=False)
                        self._save_samples(step)
                    if self.stop_signal is not None:
                        self.save()
                        print(f"signal {self.stop_signal}: saved checkpoint_latest at step "
                              f"{step}", flush=True)
                        self.close()
                        return False
            finally:
                batches.close()  # stops the epoch's producer thread
            epoch += 1
        self.save()
        self.close()
        print("Model training is completed!", flush=True)
        return True

    def close(self) -> None:
        """End the loader's decode processes and close the logs."""
        self.loader.close()
        self.logger.close()

    def _save_samples(self, step: int):
        """In-training visual inspection: the full PLMS sampler on
        n_sample_batches training batches, (generated | real) grids with
        GT-box overlays (save_ckpt_and_result, utils/checkpoint.py:146-212),
        the window rotating through the dataset by step."""
        tcfg = self.cfg.train
        if tcfg.n_sample_batches <= 0:
            return
        from instancediffusion_tpu_torch.train.sample_saver import save_train_samples

        n = len(self.dataset)
        need = tcfg.n_sample_batches * tcfg.batch_size
        start = (step // max(1, tcfg.save_every_iters)) * need % max(1, n)
        batches = []
        idx = start
        for _ in range(tcfg.n_sample_batches):
            if n < tcfg.batch_size:
                break
            rows = [(idx + j) % n for j in range(tcfg.batch_size)]
            samples = [self.dataset.__getitem__(i, epoch=0) for i in rows]
            batches.append(collate(samples, self.loader.tokenizer, keep_caption=True))
            idx += tcfg.batch_size
        if not batches:
            return
        out_dir = os.path.join(self.folder, f"samples_{step:08d}")
        t0 = time.perf_counter()
        before = collections.Counter(kernels.LAUNCHES)
        save_train_samples(self.cfg, self.state, batches, out_dir, steps=tcfg.sample_steps,
                           seed=tcfg.seed, tokenizer=self.loader.tokenizer)
        self._sync()
        self.sample_launches.update(collections.Counter(kernels.LAUNCHES) - before)
        self.timings["samples_s"].append(time.perf_counter() - t0)
        print(f"saved {len(batches)} sample grids to {out_dir}", flush=True)

    def stats(self) -> dict:
        """Per-run numbers: steps; mean step seconds and data wait over the
        steps after the first (which warms up), the data wait split into
        steps within an epoch and an epoch's first step (nothing is
        prefetched across epochs); samples/s over the steps after the first;
        save / restore / sample-grid seconds; the device's peak memory;
        kernel launches per step and of the sample grids."""
        h = self.history
        rest = h[1:] or h
        mean = lambda rows, key: (sum(r[key] for r in rows) / len(rows)) if rows else None
        within = [r for r in rest if not r["epoch_start"]]
        starts = [r for r in rest if r["epoch_start"]]
        out = {
            "steps": len(h), "final_step": self.state.step,
            "losses": [r["loss"] for r in h], "skipped": sum(r["skipped"] for r in h),
            "first_step_s": h[0]["step_s"] if h else None,
            "step_s": mean(rest, "step_s"), "data_wait_s": mean(rest, "data_s"),
            "data_wait_within_epoch_s": mean(within, "data_s"),
            "data_wait_epoch_start_s": mean(starts, "data_s"),
            "samples_per_s": (self.cfg.train.batch_size
                              / (mean(rest, "data_s") + mean(rest, "step_s")) if rest else None),
            "save_s": self.timings["save_s"], "restore_s": self.timings["restore_s"],
            "pretrained_s": self.timings["pretrained_s"],
            "samples_s": self.timings["samples_s"],
            "launches_per_step": {k: v / max(len(h), 1) for k, v in self.step_launches.items()},
            "sample_launches": dict(self.sample_launches),
        }
        if self.device.type == "cuda":
            out["peak_memory_gib"] = torch.cuda.max_memory_allocated(self.device) / 2**30
        return out
