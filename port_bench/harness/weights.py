"""Seeded weights for both sides of a cell.

The benchmark draws every parameter of a model family itself, from
`--seed`, on the device and in a few large calls: one standard-normal
draw per model into a flat float32 buffer, then each parameter's slice
scaled by the rule below and rounded once into the type the model is
served in. Nothing is zero, so no zero-initialised output conv, fuser gate
tanh(0) or ScaleU identity hides a layer:

- fuser gates and ScaleU (`alpha_attn`, `alpha_dense`, `scaleu`): 0.5 z
- other weights of two or more dimensions: z / sqrt(fan_in)
- other one-dimensional weights (norm scales): 1 + 0.1 z
- everything else (biases, embeddings, learned null tokens): 0.1 z

The result is a dict of tensors by `<model>.<parameter name>`; the port's
modules are built empty and take copies through `load_state_dict`, and
the reference builds its own float32 copies from the same dict.
"""

from __future__ import annotations

import math

import torch

GATE_NAMES = ("alpha_attn", "alpha_dense", "scaleu")


def specs(module: torch.nn.Module, prefix: str) -> list[tuple[str, tuple[int, ...]]]:
    """(prefixed name, shape) of every parameter, sorted by name."""
    return sorted((prefix + n, tuple(p.shape)) for n, p in module.named_parameters())


def _value(name: str, shape: tuple[int, ...], z: torch.Tensor) -> torch.Tensor:
    leaf = name.rsplit(".", 1)[-1]
    if any(k in name for k in GATE_NAMES):
        return 0.5 * z
    if leaf == "weight" and len(shape) >= 2:
        return z * (1.0 / math.sqrt(math.prod(shape[1:])))
    if leaf == "weight":
        return 1.0 + 0.1 * z
    return 0.1 * z


def draw(groups: list[list[tuple[str, tuple[int, ...]]]], seed: int, device,
         dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """One tensor per spec, `dtype`, on `device`; group g draws from the
    generator seeded (seed, g) in one call."""
    out: dict[str, torch.Tensor] = {}
    for g, group in enumerate(groups):
        gen = torch.Generator(device=device).manual_seed((int(seed) * 7919 + g) % 2**63)
        total = sum(math.prod(shape) for _, shape in group)
        flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
        off = 0
        for name, shape in group:
            n = math.prod(shape)
            out[name] = _value(name, shape, flat[off:off + n]).to(dtype).view(shape)
            off += n
        del flat
    return out


def load(module: torch.nn.Module, weights: dict[str, torch.Tensor], prefix: str,
         dtype: torch.dtype | None) -> torch.nn.Module:
    """Give a module built on the meta device copies of its tensors (as
    `dtype`, or each in its own where None) through `load_state_dict`;
    frozen and in eval mode."""
    sd = {n: weights[prefix + n].to(dtype=dtype or weights[prefix + n].dtype, copy=True)
          for n, _ in module.named_parameters()}
    module.load_state_dict(sd, strict=True, assign=True)
    for p in module.parameters():
        p.requires_grad_(False)
    return module.eval()
