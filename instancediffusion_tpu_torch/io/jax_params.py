"""Fill the port's parameters from the JAX package's parameter trees.

The JAX `PipelineParams` trees (`unet`, `vae`, `clip`), `RefinerParams`
trees (`unet`: the SDXL refiner's, `vae`, `text`: OpenCLIP-bigG) and the
attribute-binding judge's trees (`vision`: the CLIP ViT tower, `text`,
`text_projection`: what `convert_clip_model` returns) are nested
dicts and lists whose leaves are arrays (numpy, or anything `np.asarray` reads). The
port's modules mirror those trees key for key, so loading is a walk of both
at once:
  * Linear `w` (in, out) -> `weight` (out, in); `b` -> `bias`
  * conv `w` HWIO -> `weight` OIHW; `b` -> `bias`
  * norm `scale` / `bias` -> `weight` / `bias`
  * every other leaf (embeddings, null tokens, gates, ScaleU) as it is.
A JAX leaf without a port counterpart, a shape mismatch, or a port
parameter left unset raises. A VAE built with `encoder=True` takes the
whole JAX VAE tree; one without takes `{"decoder": ..., "post_quant_conv":
...}` of it.
"""

from __future__ import annotations

import numpy as np
import torch

from instancediffusion_tpu_torch.nn.core import Conv2d, Linear, Norm


def _convert(mod: torch.nn.Module, key: str, arr: np.ndarray) -> tuple[str, np.ndarray]:
    """(port parameter name on `mod`, array in the port's layout)."""
    if isinstance(mod, Linear) and key in ("w", "b"):
        return ("weight", arr.T) if key == "w" else ("bias", arr)
    if isinstance(mod, Conv2d) and key in ("w", "b"):
        return ("weight", arr.transpose(3, 2, 0, 1)) if key == "w" else ("bias", arr)
    if isinstance(mod, Norm) and key in ("scale", "bias"):
        return ("weight" if key == "scale" else "bias"), arr
    return key, arr


def _load_module(module: torch.nn.Module, tree) -> None:
    params = dict(module.named_parameters())
    assigned: set[str] = set()

    def walk(mod, node, prefix):
        if isinstance(node, (list, tuple)):
            if not isinstance(mod, torch.nn.ModuleList) or len(mod) != len(node):
                raise KeyError(f"JAX list {prefix or '<root>'} ({len(node)} entries) "
                               f"does not match the port's {type(mod).__name__}")
            for i, sub in enumerate(node):
                walk(mod[i], sub, f"{prefix}{i}.")
            return
        if not isinstance(node, dict):
            raise TypeError(f"JAX node {prefix} is a {type(node).__name__}")
        for key, sub in node.items():
            child = getattr(mod, key, None)
            if isinstance(child, torch.nn.Module):
                walk(child, sub, f"{prefix}{key}.")
                continue
            name, arr = _convert(mod, key, np.asarray(sub))
            full = prefix + name
            if full not in params:
                raise KeyError(f"JAX leaf {prefix}{key} has no port parameter "
                               f"({full})")
            p = params[full]
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{full}: JAX leaf {prefix}{key} converts to "
                                 f"{tuple(arr.shape)}, port has {tuple(p.shape)}")
            # the float32 array goes to the parameter's device as it lies
            # (a transposed view stays one: a flat copy); the transpose and
            # the cast to the parameter's dtype happen there
            with torch.no_grad():
                p.copy_(torch.from_numpy(np.asarray(arr, np.float32)).to(p.device))
            assigned.add(full)

    walk(module, tree, "")
    missing = sorted(set(params) - assigned)
    if missing:
        raise KeyError(f"port parameters not set by the JAX tree: {missing[:10]}"
                       f"{' ...' if len(missing) > 10 else ''}")


def load_jax_params(pipe_or_module, unet=None, vae=None, clip=None, text=None, vision=None,
                    text_projection=None) -> None:
    """Copy JAX parameter trees into a pipeline's `unet`/`vae`/`clip` (the
    refiner pipeline's `unet`/`vae`/`text`, the CLIP judge's
    `vision`/`text`/`text_projection`) modules, or (with exactly one tree
    given, named for no submodule of it) into one module."""
    given = {k: t for k, t in (("unet", unet), ("vae", vae), ("clip", clip), ("text", text),
                               ("vision", vision), ("text_projection", text_projection))
             if t is not None}
    holds_them = all(isinstance(getattr(pipe_or_module, n, None), torch.nn.Module)
                     for n in given)
    if isinstance(pipe_or_module, torch.nn.Module) and not holds_them:
        if len(given) != 1:
            raise ValueError("loading into one module takes exactly one tree")
        _load_module(pipe_or_module, next(iter(given.values())))
        return
    for name, tree in given.items():
        _load_module(getattr(pipe_or_module, name), tree)
