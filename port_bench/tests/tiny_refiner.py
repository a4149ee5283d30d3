"""A tiny SDXL refiner configuration and runs of the refine driver on the
CPU (the port's float32 plain routes against the reference), for the
tests: the cell's configuration file with tiny widths over it, 32 px
images (4x4 latents)."""

from __future__ import annotations

import json

from port_bench.harness.context import Run
from port_bench.tests.tiny import BENCH, _merge, traffic

REFINER_TINY = {
    "unet": {"image_size": 4, "model_channels": 32, "channel_mult": [1, 2],
             "num_res_blocks": 1, "attention_resolutions": [2], "num_head_channels": 16,
             "transformer_depth": 2, "context_dim": 32, "adm_in_channels": 32 + 5 * 256},
    "text_encoder": {"vocab_size": 512, "hidden_size": 32, "intermediate_size": 64,
                     "num_hidden_layers": 2, "num_attention_heads": 4, "projection_dim": 32},
    "autoencoder": {"ch": 32, "ch_mult": [1, 1, 1, 1], "num_res_blocks": 1},
}
TRAFFIC = "refine512_s035_ddim20_b8"


def config() -> dict:
    cfg = json.loads((BENCH / "configs" / "sdxl_refiner.json").read_text())
    cfg["config"] = _merge(cfg["config"], REFINER_TINY)
    return cfg


def run(seed: int = 7, seconds: float = 0.0, trace: bool = False, **traffic_over) -> Run:
    over = dict(image_size=32, num_images=2, planned_requests=2)
    over.update(traffic_over)
    return Run(workload="sdxl_refiner_512x8", seed=seed, seconds=seconds, trace=trace,
               device="cpu", config=config(), traffic=traffic(TRAFFIC, **over))
