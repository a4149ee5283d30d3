"""Checkpoints (counterpart of `instancediffusion_tpu/io/checkpoint.py`):
read reference / SD1.5 checkpoints into parameter trees, and save and
restore the port's training state with auto-resume folders.

Reference semantics:
  * the flat SD form (`model.diffusion_model.*`, `first_stage_model.*`,
    `cond_stage_model.*`, optionally under a `state_dict` key) or the
    reference training form {model, ema, text_encoder, autoencoder, ...},
    whose UNet prefers `ema` over `model`
  * the stock SD first conv, `pretrained/SD_v1_5_input_conv_weight_bias.pth`,
    swapped in at gate 0 when present
  * auto-resume folders OUTPUT/name/tagXX, resuming from the newest tag's
    checkpoint_latest

The training state is one `torch.save` file: step, UNet, EMA, optimizer and
LR-schedule state, the frozen VAE and CLIP, with `config.json` beside it.
"""

from __future__ import annotations

import json
import os
import re
import time

from instancediffusion_tpu_torch.config import Config
from instancediffusion_tpu_torch.io import torch_convert as tc

FIRST_CONV_FILE = "pretrained/SD_v1_5_input_conv_weight_bias.pth"


# ---------------------------------------------------------------------------
# Reference (.pth / .safetensors) ingestion
# ---------------------------------------------------------------------------


def _torch_load(path: str):
    import torch

    # reference checkpoints carry non-tensor entries: a full unpickle
    return torch.load(path, map_location="cpu", weights_only=False)


def load_pipeline_params(path: str, cfg: Config, timings: dict | None = None) -> dict:
    """{"unet", "vae", "clip"} numpy trees (the JAX package's layout, float32
    for bf16 files) from the flat SD form or the reference training form;
    the training form's UNet is its `ema` where it has one. The VAE tree
    holds the encoder too. `timings`, when given, receives the host seconds
    of reading the file ("read"), of the numpy state dicts ("numpy") and of
    the converters ("convert")."""
    t0 = time.perf_counter()
    raw = tc.read_safetensors(path) if path.endswith(".safetensors") else _torch_load(path)
    first_conv_sd = _maybe_first_conv_sd()
    t1 = time.perf_counter()

    if isinstance(raw, dict) and "model" in raw and not _is_flat_sd(raw):
        parts = {"model": raw.get("ema") or raw["model"], "autoencoder": raw["autoencoder"],
                 "text_encoder": raw["text_encoder"]}
        parts = {k: tc.to_numpy_state_dict(v) for k, v in parts.items()}
    else:
        sd = raw.get("state_dict", raw) if isinstance(raw, dict) else raw
        parts = tc.split_official_ckpt(tc.to_numpy_state_dict(sd))
    del raw
    t2 = time.perf_counter()
    trees = {"unet": tc.convert_unet(parts["model"], cfg.model, first_conv_sd),
             "vae": tc.convert_vae(parts["autoencoder"], cfg.autoencoder),
             "clip": tc.convert_clip_text(parts["text_encoder"], cfg.text_encoder)}
    if timings is not None:
        timings.update(read=t1 - t0, numpy=t2 - t1, convert=time.perf_counter() - t2)
    return trees


def _is_flat_sd(d: dict) -> bool:
    return any(k.startswith("model.diffusion_model.") for k in d)


def _maybe_first_conv_sd():
    """The stock SD first conv {weight, bias} as numpy, looked up under the
    working directory, then under the repository root; None if absent."""
    for p in (FIRST_CONV_FILE,
              os.path.join(os.path.dirname(__file__), "../..", FIRST_CONV_FILE)):
        if os.path.exists(p):
            return tc.to_numpy_state_dict(_torch_load(p))
    return None


# ---------------------------------------------------------------------------
# Training state with auto-resume
# ---------------------------------------------------------------------------


def expt_folder_with_auto_resume(output_root: str, name: str):
    """Create OUTPUT/name/tagXX (incrementing per restart) and return
    (folder, path_of_previous_latest_or_None)."""
    base = os.path.join(output_root, name)
    os.makedirs(base, exist_ok=True)
    tags = sorted(
        int(m.group(1))
        for d in os.listdir(base)
        if (m := re.fullmatch(r"tag(\d+)", d))
    )
    prev = None
    if tags:
        cand = os.path.join(base, f"tag{tags[-1]:02d}", "checkpoint_latest")
        if os.path.exists(cand):
            prev = cand
    new_tag = (tags[-1] + 1) if tags else 0
    folder = os.path.join(base, f"tag{new_tag:02d}")
    os.makedirs(folder, exist_ok=True)
    return folder, prev


def save_train_ckpt(folder: str, state, config_dict: dict | None, latest=True,
                    iter_idx: int | None = None) -> str:
    """Save the whole training state, the frozen VAE and CLIP included (a
    resumed run then needs no SD checkpoint), as one torch.save file
    (checkpoint_latest, or checkpoint_<iter_idx>), written to a temporary
    name first. Returns its path."""
    import torch

    name = "checkpoint_latest" if latest else f"checkpoint_{iter_idx:08d}"
    path = os.path.abspath(os.path.join(folder, name))
    payload = {
        "step": state.step,
        "unet": _params(state.unet),
        "ema": state.ema,
        "optimizer": state.optimizer.state_dict(),
        "scheduler": None if state.scheduler is None else state.scheduler.state_dict(),
    }
    if state.vae is not None:
        payload["vae"] = _params(state.vae)
    if state.clip is not None:
        payload["clip"] = _params(state.clip)
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)
    if config_dict is not None:
        with open(os.path.join(folder, "config.json"), "w") as f:
            json.dump(config_dict, f, indent=2, default=str)
    return path


def _params(module) -> dict:
    return {n: p.detach() for n, p in module.named_parameters()}


def _load_into(module, saved: dict) -> None:
    """Copy a saved state dict into `module`'s own parameters, each taking
    the saved dtype (the Parameter objects stay, so an optimizer holding
    them keeps stepping them)."""
    import torch

    params = dict(module.named_parameters())
    if set(saved) != set(params):
        missing, extra = sorted(set(params) - set(saved)), sorted(set(saved) - set(params))
        raise KeyError(f"checkpoint does not match the module: missing {missing[:5]}, "
                       f"unexpected {extra[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            t = saved[name]
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{name}: checkpoint {tuple(t.shape)}, module {tuple(p.shape)}")
            if p.dtype != t.dtype:
                p.data = p.data.to(t.dtype)
            p.copy_(t)


def restore_train_ckpt(path: str, state, have_pretrained: bool = True):
    """Restore a training checkpoint into an existing TrainState, in place:
    parameters into its modules, the EMA into its tensors, then the
    optimizer's and the schedule's state (so the step count and warm-up
    resume). A checkpoint without the frozen VAE/CLIP keeps the state's own,
    and raises when the caller has no pretrained ones (have_pretrained=False):
    training against random frozen encoders is garbage."""
    import torch

    payload = _torch_load(path)
    wants_frozen = state.vae is not None and state.clip is not None
    has_frozen = "vae" in payload and "clip" in payload
    if wants_frozen and not has_frozen and not have_pretrained:
        raise RuntimeError(
            f"checkpoint {path} lacks frozen VAE/CLIP params and no official SD "
            "checkpoint was provided — resuming would train against randomly "
            "initialized frozen encoders. Re-pass the official checkpoint (or re-save "
            "with the current format).")
    _load_into(state.unet, payload["unet"])
    if set(payload["ema"]) != set(state.ema):
        raise KeyError("checkpoint EMA does not cover the state's trainable parameters")
    with torch.no_grad():
        for name, t in payload["ema"].items():
            state.ema[name].copy_(t)
    state.optimizer.load_state_dict(payload["optimizer"])
    if state.scheduler is not None and payload["scheduler"] is not None:
        state.scheduler.load_state_dict(payload["scheduler"])
    if wants_frozen and has_frozen:
        _load_into(state.vae, payload["vae"])
        _load_into(state.clip, payload["clip"])
    state.step = int(payload["step"])
    return state
