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

import numpy as np

from instancediffusion_tpu_torch.io import torch_convert as tc

FIRST_CONV_FILE = "pretrained/SD_v1_5_input_conv_weight_bias.pth"


# ---------------------------------------------------------------------------
# Reference (.pth / .safetensors) ingestion
# ---------------------------------------------------------------------------


def _torch_load(path: str):
    import torch

    # reference checkpoints carry non-tensor entries: a full unpickle
    return torch.load(path, map_location="cpu", weights_only=False)


def read_checkpoint_parts(path: str, timings: dict | None = None) -> dict:
    """{"model", "autoencoder", "text_encoder"} numpy state dicts (float32
    for bf16 files) of a flat SD-form or reference training-form file; the
    training form's UNet is its `ema` where it has one. `timings` receives
    the seconds of reading the file ("read") and of the numpy state dicts
    ("numpy")."""
    t0 = time.perf_counter()
    raw = tc.read_safetensors(path) if path.endswith(".safetensors") else _torch_load(path)
    t1 = time.perf_counter()
    if isinstance(raw, dict) and "model" in raw and not _is_flat_sd(raw):
        parts = {"model": raw.get("ema") or raw["model"], "autoencoder": raw["autoencoder"],
                 "text_encoder": raw["text_encoder"]}
        parts = {k: tc.to_numpy_state_dict(v) for k, v in parts.items()}
    else:
        sd = raw.get("state_dict", raw) if isinstance(raw, dict) else raw
        parts = tc.split_official_ckpt(tc.to_numpy_state_dict(sd))
    if timings is not None:
        timings.update(read=t1 - t0, numpy=time.perf_counter() - t1)
    return parts


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


def load_weights(unet, vae, clip, path: str, strict: bool = True,
                 timings: dict | None = None) -> dict:
    """Fill the port's UNet, VAE and CLIP, in place, from a reference / SD1.5
    checkpoint file (`read_checkpoint_parts`). The UNet's tensors are
    copied straight into its parameters (`load_unet`); the VAE (its
    decoding half when it was built without an encoder) and CLIP go
    through the converters and `load_jax_params`, and a key they need and
    the file lacks raises. strict: as `load_unet`. Returns `load_unet`'s
    names; `timings` receives the host seconds of reading the file
    ("read"), of the numpy state dicts ("numpy"), of the VAE and CLIP
    converters ("convert") and of filling the modules ("fill",
    synchronised)."""
    import torch

    from instancediffusion_tpu_torch.io.jax_params import load_jax_params

    parts = read_checkpoint_parts(path, timings)
    t0 = time.perf_counter()
    vae_tree = tc.convert_vae(parts["autoencoder"], vae.cfg)
    if not hasattr(vae, "encoder"):
        vae_tree = {k: vae_tree[k] for k in ("decoder", "post_quant_conv")}
    clip_tree = tc.convert_clip_text(parts["text_encoder"], clip.cfg)
    t1 = time.perf_counter()
    names = load_unet(unet, parts["model"], strict)
    load_jax_params(vae, vae=vae_tree)
    load_jax_params(clip, clip=clip_tree)
    device = next(unet.parameters()).device
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if timings is not None:
        timings.update(convert=t1 - t0, fill=time.perf_counter() - t1)
    return names


def load_unet(unet, sd: dict, strict: bool = True) -> dict:
    """Copy a reference UNet state dict (numpy, `model.diffusion_model.`
    stripped) into the port's UNet in place. The reference layouts equal
    the port's, so each tensor is copied as it is, to the parameter that
    `reference_names` pairs with its key. The stock first conv comes from
    pretrained/ when present, else it is the file's first conv (the swap
    at gate 0 is then a no-op). strict: a key the UNet needs and `sd`
    lacks raises KeyError naming it (`from_checkpoint`: never a
    half-random model); otherwise that parameter keeps its init (the
    trainer's `--official_ckpt`, as the reference's strict=False load: a
    stock SD1.5 file lacks the fusers, UniFusion and ScaleU). Returns
    {"loaded", "kept_init"} parameter names."""
    import torch

    names = reference_names(unet, lambda probe: tc.convert_unet(probe, unet.cfg))
    first_conv = _maybe_first_conv_sd()
    if first_conv is None and "input_blocks.0.0.weight" in sd:
        first_conv = {k: sd[f"input_blocks.0.0.{k}"] for k in ("weight", "bias")}
    if first_conv is not None:
        for k, v in first_conv.items():
            names[f"first_conv_sd.{k}"] = f"first_conv_sd.{k}"
            sd = dict(sd, **{f"first_conv_sd.{k}": v})
    params = dict(unet.named_parameters())
    absent = [names.get(name, name) for name in params if names.get(name) not in sd]
    if strict and absent:
        raise KeyError(f"{absent[0]} is not in the checkpoint"
                       + (f" ({len(absent) - 1} more keys are missing)" if len(absent) > 1 else ""))
    loaded = []
    with torch.no_grad():
        for name, p in params.items():
            key = names.get(name)
            if key not in sd:
                continue
            arr = np.asarray(sd[key], np.float32)
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: checkpoint {key} is {arr.shape}, module {tuple(p.shape)}")
            p.copy_(torch.from_numpy(arr).to(p.device))
            loaded.append(name)
    return {"loaded": loaded, "kept_init": [n for n in params if n not in set(loaded)]}


# ---------------------------------------------------------------------------
# Reference-form state dicts of the port's modules
# ---------------------------------------------------------------------------


class _KeyProbe(dict):
    """A state dict that holds every key: reading key k returns a
    (1, 1, 1, 1) array holding k's position in `read`, so the tree a
    converter builds from it says which reference key each leaf came from
    (transposes and copies keep the value)."""

    def __init__(self):
        super().__init__()
        self.read: list[str] = []

    def __contains__(self, key) -> bool:
        return True

    def __getitem__(self, key):
        import numpy as np

        self.read.append(key)
        return np.full((1, 1, 1, 1), len(self.read) - 1, np.float64)


def reference_names(module, convert) -> dict:
    """{port parameter name: reference key} of a module, read off the tree
    `convert(probe)` builds: a parameter's tree path is its name with the
    leaf renamed as `io/jax_params` maps it (Linear / Conv2d weight -> w,
    bias -> b; Norm weight -> scale). The UNet's stock first conv is not
    part of the reference form (pretrained/SD_v1_5_input_conv_weight_bias.pth
    holds it) and is left out."""
    from instancediffusion_tpu_torch.nn.core import Conv2d, Linear, Norm

    probe = _KeyProbe()
    tree = convert(probe)
    names = {}
    for name, _ in module.named_parameters():
        if name.startswith("first_conv_sd."):
            continue
        head, _, leaf = name.rpartition(".")
        owner = module.get_submodule(head) if head else module
        if isinstance(owner, (Linear, Conv2d)) and leaf in ("weight", "bias"):
            leaf = "w" if leaf == "weight" else "b"
        elif isinstance(owner, Norm) and leaf == "weight":
            leaf = "scale"
        node = tree
        for part in (head.split(".") if head else []) + [leaf]:
            node = node[int(part)] if isinstance(node, list) else node[part]
        names[name] = probe.read[int(node.reshape(-1)[0])]
    if len(set(names.values())) != len(names):
        raise RuntimeError("two parameters map to one reference key")
    return names


def reference_state_dict(unet=None, vae=None, clip=None) -> dict:
    """The port's modules as a flat SD-form checkpoint (reference key ->
    CPU tensor in the module's dtype), the inverse of the converters in
    `io/torch_convert`: UNet under model.diffusion_model., the VAE (which
    needs its encoder) under first_stage_model., CLIP under
    cond_stage_model.transformer.text_model., without the UNet's stock
    first conv. Reference layouts equal the port's (Linear (out, in), conv
    OIHW), so every tensor is copied as it is."""
    parts = (
        (unet, "model.diffusion_model.", lambda m: lambda sd: tc.convert_unet(sd, m.cfg)),
        (vae, "first_stage_model.", lambda m: lambda sd: tc.convert_vae(sd, m.cfg)),
        (clip, "cond_stage_model.", lambda m: lambda sd: tc.convert_clip_text(sd, m.cfg)),
    )
    out = {}
    for module, prefix, converter in parts:
        if module is None:
            continue
        params = dict(module.named_parameters())
        for name, key in reference_names(module, converter(module)).items():
            out[prefix + key] = params[name].detach().to("cpu", copy=True)
    return out



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
    name first. Returns its path.

    Over several ranks every rank calls it: under ZeRO-1 the AdamW moments
    and the EMA are gathered from their slices (a collective) into the
    one-rank format, and only rank 0 writes the file."""
    import torch

    from instancediffusion_tpu_torch.parallel.mesh import rank_and_world

    name = "checkpoint_latest" if latest else f"checkpoint_{iter_idx:08d}"
    path = os.path.abspath(os.path.join(folder, name))
    if state.dp is not None and state.dp.zero1:
        opt_sd, ema = state.dp.full_state(state.optimizer)
    else:
        opt_sd, ema = state.optimizer.state_dict(), state.ema
    if rank_and_world()[0] != 0:
        return path
    payload = {
        "step": state.step,
        "unet": _params(state.unet),
        "ema": ema,
        "optimizer": opt_sd,
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
    training against random frozen encoders is garbage. Under ZeRO-1 each
    rank takes its slice of the moments and the EMA (the file holds them
    whole, from whatever number of ranks wrote it)."""
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
    names = state.dp.names if state.ema is None else state.ema
    if set(payload["ema"]) != set(names):
        raise KeyError("checkpoint EMA does not cover the state's trainable parameters")
    if state.dp is not None and state.dp.zero1:
        state.dp.load_full_state(state.optimizer, payload["optimizer"], payload["ema"])
    else:
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
