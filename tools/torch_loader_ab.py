"""Decode processes against a thread pool in the port's Prefetcher, inside
the full-width Trainer on the card.

    python3 tools/torch_loader_ab.py [--records 48] [--steps 11] [--workers 4]

Writes JSON training records of the fixture JPEGs (chip_smoke.py's
`write_training_records`), then trains `Config()` at B=4 from random weights
four times in turns: the Prefetcher as it is (samples decoded in spawned
processes), then with its `_samples` replaced by a per-batch thread pool of
the same size, processes again, threads again. Each run prints s/step, the
data wait (within an epoch and at an epoch's first step) and samples/s over
the steps after the first, with the card's name and power limit. With more
records than steps * 4 the run stays inside one epoch, so the data wait is
the loader's steady state.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def threaded_samples(self, idxs, epoch: int, stop):
    """`Prefetcher._samples` on a thread pool: each batch's samples decoded
    by `self.workers` threads of this process."""
    with ThreadPoolExecutor(self.workers) as pool:
        for b in range(0, len(idxs), self.bs):
            if stop.is_set():
                return
            yield from pool.map(lambda i: self.ds.__getitem__(int(i), epoch), idxs[b:b + self.bs])


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--records", type=int, default=48)
    p.add_argument("--steps", type=int, default=11)
    p.add_argument("--workers", type=int, default=4)
    args = p.parse_args()

    import torch

    import chip_smoke
    from instancediffusion_tpu_torch.config import load_config
    from instancediffusion_tpu_torch.data import jsondataset
    from instancediffusion_tpu_torch.train.trainer import Trainer

    if not torch.cuda.is_available():
        raise RuntimeError("torch_loader_ab: needs a CUDA card")
    os.environ.setdefault("IDTPU_ALLOW_HASH_TOKENIZER", "1")
    card = chip_smoke.card_line()
    processes = jsondataset.Prefetcher._samples
    tmp = tempfile.mkdtemp(prefix="torch_loader_ab_")
    try:
        listing = chip_smoke.write_training_records(os.path.join(tmp, "records"), args.records)
        for i, mode in enumerate(("processes", "threads", "processes", "threads")):
            jsondataset.Prefetcher._samples = processes if mode == "processes" else \
                threaded_samples
            cfg = load_config(overrides={"train": dict(
                batch_size=4, total_iters=args.steps, workers=args.workers, n_sample_batches=0,
                ckpt_every_iters=10**6, save_every_iters=10**6,
                output_dir=os.path.join(tmp, f"run{i}"))})
            trainer = Trainer(cfg, listing, device="cuda")
            t0 = time.perf_counter()
            trainer.start_training()
            st = trainer.stats()
            keys = ("step_s", "data_wait_s", "data_wait_within_epoch_s",
                    "data_wait_epoch_start_s", "samples_per_s", "first_step_s")
            print(f"{mode} ({args.workers}): " + json.dumps({k: st[k] for k in keys})
                  + f" run {time.perf_counter() - t0:.1f}s on {card}", flush=True)
            del trainer
            torch.cuda.empty_cache()
    finally:
        jsondataset.Prefetcher._samples = processes
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
