"""LoRA adapters merged into the port's modules (counterpart of
`instancediffusion_tpu/io/lora.py`, whose key parsing and delta math are
copied here).

Community SD1.5 LoRA files merge into the frozen SD1.5 backbone at load
time: ΔW = up @ down * (alpha / rank) * scale is added to the weight, in
float32, and the sum is rounded to the weight's dtype. No per-step cost.

Supported key formats (auto-detected per key):
  * kohya / sd-scripts: ``lora_unet_<module>_...{.lora_down|.lora_up}.weight``
    + per-module ``.alpha`` scalars, diffusers module topology with
    underscore separators; ``lora_te_...`` for the text encoder
  * diffusers / PEFT:   ``unet.<module>.lora_A.weight`` / ``.lora_B.weight``
    (A = down, B = up; alpha assumed = rank), ``text_encoder.`` prefix for
    the text tower

Covered modules: attn1/attn2 q/k/v/out, GEGLU ff proj/out, proj_in /
proj_out 1x1 convs (UNet); q/k/v/out/fc1/fc2 (CLIP text). Unknown keys
are counted and reported, never silently dropped.

`_delta` gives ΔW in the JAX package's (in, out) layout; the port's Linear
weights are (out, in) and its 1x1 convs (out, in, 1, 1), so the merge adds
the transpose.

Diffusers -> LDM block index mapping (SD1.5 topology):
  down_blocks[i].attentions[j] -> input_blocks[3*i + j + 1]
  mid_block.attentions[0]      -> middle_block
  up_blocks[i].attentions[j]   -> output_blocks[3*i + j]
"""

from __future__ import annotations

import re

import numpy as np
import torch

from instancediffusion_tpu_torch.io.torch_convert import load_torch_checkpoint

# -- key parsing ---------------------------------------------------------------

_LEAF = (
    r"(?P<leaf>attn[12]_to_(?:q|k|v|out_0)|ff_net_(?:0_proj|2))"
)
_UNET_RES = [
    re.compile(
        r"down_blocks_(?P<i>\d+)_attentions_(?P<j>\d+)"
        r"_transformer_blocks_(?P<d>\d+)_" + _LEAF + r"$"
    ),
    re.compile(
        r"mid_block_attentions_(?P<j>0)"
        r"_transformer_blocks_(?P<d>\d+)_" + _LEAF + r"$"
    ),
    re.compile(
        r"up_blocks_(?P<i>\d+)_attentions_(?P<j>\d+)"
        r"_transformer_blocks_(?P<d>\d+)_" + _LEAF + r"$"
    ),
    re.compile(
        r"down_blocks_(?P<i>\d+)_attentions_(?P<j>\d+)_(?P<leaf>proj_in|proj_out)$"
    ),
    re.compile(
        r"mid_block_attentions_(?P<j>0)_(?P<leaf>proj_in|proj_out)$"
    ),
    re.compile(
        r"up_blocks_(?P<i>\d+)_attentions_(?P<j>\d+)_(?P<leaf>proj_in|proj_out)$"
    ),
]
_TE_RE = re.compile(
    r"text_model_encoder_layers_(?P<i>\d+)_"
    r"(?P<leaf>self_attn_(?:q|k|v|out)_proj|mlp_fc1|mlp_fc2)$"
)

_TE_LEAF = {
    "self_attn_q_proj": "q", "self_attn_k_proj": "k",
    "self_attn_v_proj": "v", "self_attn_out_proj": "out",
    "mlp_fc1": "fc1", "mlp_fc2": "fc2",
}


def _parse_unet_module(mod: str):
    """kohya-style underscore module name -> (block_kind, block_idx,
    leaf_path) in the JAX tree, which the port's module names mirror, or None if
    unrecognized."""
    for rx in _UNET_RES:
        m = rx.match(mod)
        if not m:
            continue
        g = m.groupdict()
        if mod.startswith("down_"):
            loc = ("input_blocks", 3 * int(g["i"]) + int(g["j"]) + 1)
        elif mod.startswith("mid_"):
            loc = ("middle_block", None)
        else:
            loc = ("output_blocks", 3 * int(g["i"]) + int(g["j"]))
        leaf = g["leaf"]
        if leaf in ("proj_in", "proj_out"):
            return loc + ((leaf,),)
        d = int(g["d"])
        if leaf.startswith("attn"):
            attn, _, tail = leaf.partition("_to_")
            target = "to_out" if tail == "out_0" else "to_" + tail
            return loc + (("blocks", d, attn, target),)
        # ff_net_0_proj / ff_net_2
        return loc + (("blocks", d, "ff",
                       "proj" if leaf == "ff_net_0_proj" else "out"),)
    return None


def _collect_pairs(sd: dict[str, np.ndarray]):
    """Group raw LoRA keys into {(tower, module): {down, up, alpha}}.
    tower is 'unet' or 'te'; module is the kohya-style underscore name."""
    mods: dict[tuple, dict] = {}
    unknown = []

    def put(tower, mod, part, v):
        mods.setdefault((tower, mod), {})[part] = v

    for k, v in sd.items():
        if k.startswith(("lora_unet_", "lora_te_")):  # kohya
            tower = "unet" if k.startswith("lora_unet_") else "te"
            body = k.split("_", 2 if tower == "unet" else 2)[2]
            if body.endswith(".lora_down.weight"):
                put(tower, body[: -len(".lora_down.weight")], "down", v)
            elif body.endswith(".lora_up.weight"):
                put(tower, body[: -len(".lora_up.weight")], "up", v)
            elif body.endswith(".alpha"):
                put(tower, body[: -len(".alpha")], "alpha", float(v))
            else:
                unknown.append(k)
        elif k.startswith(("unet.", "text_encoder.")):  # diffusers/peft
            tower = "unet" if k.startswith("unet.") else "te"
            body = k.split(".", 1)[1]
            for tag, part in ((".lora_A.weight", "down"),
                              (".lora_B.weight", "up"),
                              (".lora_A.default.weight", "down"),
                              (".lora_B.default.weight", "up")):
                if body.endswith(tag):
                    mod = body[: -len(tag)].replace(".", "_")
                    put(tower, mod, part, v)
                    break
            else:
                unknown.append(k)
        else:
            unknown.append(k)
    return mods, unknown


def _delta(pair: dict, scale: float) -> np.ndarray | None:
    """ΔW in the JAX (in, out) linear layout; None if the pair is incomplete."""
    if "down" not in pair or "up" not in pair:
        return None
    down = np.asarray(pair["down"], np.float32)
    up = np.asarray(pair["up"], np.float32)
    if down.ndim == 4:  # conv1x1 lora: (r, in, 1, 1) / (out, r, 1, 1)
        down = down[..., 0, 0]
        up = up[..., 0, 0]
    r = down.shape[0]
    alpha = float(pair.get("alpha", r))
    return (down.T @ up.T) * (alpha / r) * scale  # (in, out)


def _find_spatial(layers):
    """The spatial transformer among a block's layers (the one with
    `blocks`), or None."""
    for layer in layers:
        if hasattr(layer, "blocks"):
            return layer
    return None


def _add_into(module: torch.nn.Module, path, delta: np.ndarray, conv: bool) -> None:
    """weight += ΔW^T at module/path, in float32, rounded to the weight's
    dtype; a 1x1 conv weight is (out, in, 1, 1)."""
    node = module
    for p in path:
        node = node[p] if isinstance(p, int) else getattr(node, p)
    w = node.weight
    d = np.ascontiguousarray(delta.T)  # (out, in)
    want = tuple(w.shape[:2]) if conv and tuple(w.shape[2:]) == (1, 1) else tuple(w.shape)
    if d.shape != want:
        raise ValueError(
            f"LoRA shape {d.shape} (out, in) does not match weight {tuple(w.shape)} "
            f"at {'/'.join(map(str, path))} — wrong base model?"
        )
    with torch.no_grad():
        dt = torch.from_numpy(d).to(w.device).reshape(w.shape)
        w.copy_((w.float() + dt).to(w.dtype))


def merge_lora(unet: torch.nn.Module, lora_sd: dict[str, np.ndarray], scale: float = 1.0,
               clip: torch.nn.Module | None = None) -> dict:
    """Merge a LoRA state dict into the port's UNet (and CLIP text model
    when given) in place. Returns stats: {applied_unet, applied_te,
    skipped_te, unknown: [keys]}."""
    mods, unknown = _collect_pairs(lora_sd)
    stats = {"applied_unet": 0, "applied_te": 0, "skipped_te": 0,
             "unknown": unknown}
    for (tower, mod), pair in sorted(mods.items()):
        delta = _delta(pair, scale)
        if delta is None:
            stats["unknown"].append(mod)
            continue
        if tower == "unet":
            parsed = _parse_unet_module(mod)
            if parsed is None:
                stats["unknown"].append(mod)
                continue
            kind, idx, leaf_path = parsed
            layers = getattr(unet, kind) if idx is None else getattr(unet, kind)[idx]
            spatial = _find_spatial(layers)
            if spatial is None:
                stats["unknown"].append(mod)
                continue
            _add_into(spatial, leaf_path, delta,
                      conv=leaf_path[-1] in ("proj_in", "proj_out"))
            stats["applied_unet"] += 1
        else:
            m = _TE_RE.match(mod)
            if m is None:
                stats["unknown"].append(mod)
                continue
            if clip is None:
                stats["skipped_te"] += 1
                continue
            layer = clip.layers[int(m.group("i"))]
            _add_into(layer, (_TE_LEAF[m.group("leaf")],), delta, conv=False)
            stats["applied_te"] += 1
    return stats


def load_lora_file(path: str) -> dict[str, np.ndarray]:
    """Read a LoRA checkpoint (.safetensors / torch pickle) to numpy."""
    return load_torch_checkpoint(path)
