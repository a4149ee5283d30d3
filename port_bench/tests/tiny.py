"""Tiny configurations and runs of the benchmark's drivers on the CPU (the
port's float32 plain routes against the reference), for the tests."""

from __future__ import annotations

import copy
import json
from pathlib import Path

from port_bench.harness.context import Run

BENCH = Path(__file__).resolve().parents[1]

SD15_TINY = {
    "model": {"image_size": 8, "model_channels": 32, "num_heads": 4, "context_dim": 32,
              "max_objs": 4, "channel_mult": [1, 2], "num_res_blocks": 1,
              "attention_resolutions": [1, 2],
              "grounding_tokenizer": {
                  "in_dim": 32, "out_dim": 32, "mid_dim": 32, "fourier_freqs": 4,
                  "fourier_freqs_polygons": 4, "n_scribble_points": 4, "n_polygon_points": 8,
                  "seg_channels": 4, "seg_resize_input": 64, "convnext_depths": [1, 1],
                  "convnext_dims": [8, 16], "convnext_feature_dim": 1024}},
    "autoencoder": {"ch": 32, "ch_mult": [1, 2], "resolution": 64},
    "text_encoder": {"vocab_size": 512, "hidden_size": 32, "intermediate_size": 64,
                     "num_hidden_layers": 2, "num_attention_heads": 4},
}


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def config(name: str) -> dict:
    """The cell's configuration file with the tiny widths over it."""
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg["config"] = _merge(cfg["config"], SD15_TINY)
    return cfg


def traffic(name: str, **over) -> dict:
    t = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    t.update(over)
    return t


def run(workload: str, config_name: str, traffic_name: str, seed: int = 7,
        seconds: float = 0.0, trace: bool = False, **traffic_over) -> Run:
    return Run(workload=workload, seed=seed, seconds=seconds, trace=trace, device="cpu",
               config=config(config_name), traffic=traffic(traffic_name, **traffic_over))
