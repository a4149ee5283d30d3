"""Convert reference (PyTorch) state dicts into the JAX-layout numpy trees
that `io/jax_params.load_jax_params` reads (counterpart of
`instancediffusion_tpu/io/torch_convert.py`: the SD1.5 parts, UNet with
UniFusion and ConvNeXt-T, VAE, CLIP text; the CLIP ViT-L/14 vision tower
and full CLIPModel of the attribute-binding judge; and the SDXL refiner's
UNet and OpenCLIP-bigG text tower).

Handles the official-checkpoint layout split by key prefix:
    model.diffusion_model.* -> UNet        (convert_unet)
    first_stage_model.*     -> VAE         (convert_vae)
    cond_stage_model.*      -> CLIP text   (convert_clip_text)
and the refiner's sgm layout (`split_refiner_ckpt`):
    model.diffusion_model.*           -> refiner UNet (convert_refiner_unet)
    conditioner.embedders.0.model.*   -> OpenCLIP text (convert_openclip_text)
    first_stage_model.*               -> VAE          (convert_vae)

Layout transforms (reference -> tree):
    Linear  (out,in)   -> (in,out)           transpose
    Conv2d  OIHW       -> HWIO               transpose(2,3,1,0)
    GroupNorm/LayerNorm weight/bias -> scale/bias
A key the converters look for and the file lacks raises KeyError naming it.

All converters take a dict of NUMPY arrays (`to_numpy_state_dict` of a torch
state dict, or `load_torch_checkpoint` of a file). `read_safetensors` reads
the .safetensors format with numpy alone.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Mapping

import numpy as np

from instancediffusion_tpu_torch.config import UNetConfig, UniFusionConfig
from instancediffusion_tpu_torch.models.convnext import TINY_DEPTHS
from instancediffusion_tpu_torch.models.sdxl_refiner import build_refiner_plan
from instancediffusion_tpu_torch.models.unet import build_plan

Params = dict[str, Any]

# safetensors dtype names -> numpy (little-endian); BF16 is read as its bits
_ST_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2", "BF16": "<u2",
    "I64": "<i8", "I32": "<i4", "I16": "<i2", "I8": "i1", "U8": "u1", "BOOL": "?",
}


def to_numpy_state_dict(sd: Mapping[str, Any]) -> dict[str, np.ndarray]:
    out = {}
    for k, v in sd.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu()
            # numpy has no bfloat16: upcast (the loader casts to the
            # model's dtype anyway)
            if str(v.dtype) == "torch.bfloat16":
                v = v.float()
            out[k] = v.numpy()
        else:
            out[k] = np.asarray(v)
    return out


def read_safetensors(path: str) -> dict[str, np.ndarray]:
    """A .safetensors file as numpy arrays: an 8-byte little-endian header
    length, a JSON header of {name: {dtype, shape, data_offsets}}, then the
    raw little-endian bytes (offsets from the end of the header). BF16 is
    upcast to float32, as `to_numpy_state_dict` does."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        base = 8 + n
        out = {}
        for name, info in header.items():
            if name == "__metadata__":
                continue
            if info["dtype"] not in _ST_DTYPES:
                raise ValueError(f"{path}: {name} has unsupported dtype {info['dtype']}")
            begin, end = info["data_offsets"]
            f.seek(base + begin)
            arr = np.frombuffer(f.read(end - begin), _ST_DTYPES[info["dtype"]])
            if info["dtype"] == "BF16":
                arr = (arr.astype(np.uint32) << 16).view(np.float32)
            out[name] = arr.reshape(info["shape"]).copy()
    return out


def load_torch_checkpoint(path: str) -> dict[str, np.ndarray]:
    """Read a .pth/.ckpt (torch pickle) or .safetensors checkpoint and
    return numpy arrays (a `state_dict` wrapper is unwrapped)."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    import torch

    # reference checkpoints carry non-tensor entries: a full unpickle
    raw = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]
    return to_numpy_state_dict(raw)


def split_official_ckpt(sd: dict[str, np.ndarray]) -> dict[str, dict[str, np.ndarray]]:
    """Split an SD-style checkpoint by component prefix."""
    out: dict[str, dict[str, np.ndarray]] = {
        "model": {}, "text_encoder": {}, "autoencoder": {}, "diffusion": {}
    }
    for k, v in sd.items():
        if k.startswith("model.diffusion_model."):
            out["model"][k[len("model.diffusion_model."):]] = v
        elif k.startswith("cond_stage_model."):
            out["text_encoder"][k[len("cond_stage_model."):]] = v
        elif k.startswith("first_stage_model."):
            out["autoencoder"][k[len("first_stage_model."):]] = v
        else:
            out["diffusion"][k] = v
    return out


# -- primitives --------------------------------------------------------------


def _lin(sd, p, bias=True):
    out = {"w": np.ascontiguousarray(sd[p + ".weight"].T)}
    if bias and p + ".bias" in sd:
        out["b"] = sd[p + ".bias"]
    return out


def _conv(sd, p):
    out = {"w": np.ascontiguousarray(sd[p + ".weight"].transpose(2, 3, 1, 0))}
    if p + ".bias" in sd:
        out["b"] = sd[p + ".bias"]
    return out


def _norm(sd, p):
    return {"scale": sd[p + ".weight"], "bias": sd[p + ".bias"]}


# -- UNet transformer stack ---------------------------------------------------


def _mha(sd, p):
    return {
        "to_q": _lin(sd, p + ".to_q"),
        "to_k": _lin(sd, p + ".to_k"),
        "to_v": _lin(sd, p + ".to_v"),
        "to_out": _lin(sd, p + ".to_out.0"),
    }


def _ff_geglu(sd, p):
    return {"proj": _lin(sd, p + ".net.0.proj"), "out": _lin(sd, p + ".net.2")}


def _fuser(sd, p):
    return {
        "linear": _lin(sd, p + ".linear"),
        "attn": _mha(sd, p + ".attn"),
        "ff": _ff_geglu(sd, p + ".ff"),
        "norm1": _norm(sd, p + ".norm1"),
        "norm2": _norm(sd, p + ".norm2"),
        "alpha_attn": sd[p + ".alpha_attn"],
        "alpha_dense": sd[p + ".alpha_dense"],
    }


def _tblock(sd, p):
    return {
        "attn1": _mha(sd, p + ".attn1"),
        "fuser": _fuser(sd, p + ".fuser"),
        "attn2": _mha(sd, p + ".attn2"),
        "ff": _ff_geglu(sd, p + ".ff"),
        "norm1": _norm(sd, p + ".norm1"),
        "norm2": _norm(sd, p + ".norm2"),
        "norm3": _norm(sd, p + ".norm3"),
    }


def _spatial(sd, p, depth):
    return {
        "norm": _norm(sd, p + ".norm"),
        "proj_in": _conv(sd, p + ".proj_in"),
        "blocks": [
            _tblock(sd, f"{p}.transformer_blocks.{d}") for d in range(depth)
        ],
        "proj_out": _conv(sd, p + ".proj_out"),
    }


def _res(sd, p):
    out = {
        "in_norm": _norm(sd, p + ".in_layers.0"),
        "in_conv": _conv(sd, p + ".in_layers.2"),
        "emb_lin": _lin(sd, p + ".emb_layers.1"),
        "out_norm": _norm(sd, p + ".out_layers.0"),
        "out_conv": _conv(sd, p + ".out_layers.3"),
    }
    if p + ".skip_connection.weight" in sd:
        out["skip_conv"] = _conv(sd, p + ".skip_connection")
    return out


# -- ConvNeXt-T ---------------------------------------------------------------


def convert_convnext(sd, prefix=""):
    p = prefix
    out = {
        "stem_conv": _conv(sd, p + "downsample_layers.0.0"),
        "stem_norm": _norm(sd, p + "downsample_layers.0.1"),
        "downsample": [
            {
                "norm": _norm(sd, f"{p}downsample_layers.{i}.0"),
                "conv": _conv(sd, f"{p}downsample_layers.{i}.1"),
            }
            for i in range(1, 4)
        ],
        "stages": [],
    }
    for i, depth in enumerate(TINY_DEPTHS):
        stage = []
        for j in range(depth):
            bp = f"{p}stages.{i}.{j}"
            # depthwise conv: torch (dim,1,7,7) -> HWIO (7,7,1,dim)
            stage.append(
                {
                    "dwconv": {
                        "w": np.ascontiguousarray(
                            sd[bp + ".dwconv.weight"].transpose(2, 3, 1, 0)
                        ),
                        "b": sd[bp + ".dwconv.bias"],
                    },
                    "norm": _norm(sd, bp + ".norm"),
                    "pwconv1": _lin(sd, bp + ".pwconv1"),
                    "pwconv2": _lin(sd, bp + ".pwconv2"),
                    "gamma": sd[bp + ".gamma"],
                }
            )
        out["stages"].append(stage)
    return out


# -- UniFusion ----------------------------------------------------------------


def convert_unifusion(sd, cfg: UniFusionConfig, prefix="position_net."):
    """linears_list order = [box, point, scribble, polygon, seg]
    (text_grounding_net.py:50-82 append order when all add flags on)."""
    p = prefix

    def mlp(idx):
        return {
            "l0": _lin(sd, f"{p}linears_list.{idx}.0"),
            "l1": _lin(sd, f"{p}linears_list.{idx}.2"),
            "l2": _lin(sd, f"{p}linears_list.{idx}.4"),
        }

    out: Params = {"null_positive": sd[p + "null_positive_feature"]}
    idx = 0
    if cfg.train_add_boxes:
        out["mlp_box"] = mlp(idx); idx += 1
        out["null_box"] = sd[p + "null_position_feature"]
    if cfg.train_add_points:
        out["mlp_point"] = mlp(idx); idx += 1
        out["null_point"] = sd[p + "null_point_feature"]
    if cfg.train_add_scribbles:
        out["mlp_scribble"] = mlp(idx); idx += 1
        out["null_scribble"] = sd[p + "null_scribble_feature"]
    if cfg.train_add_masks:
        out["mlp_polygon"] = mlp(idx); idx += 1
        out["null_polygon"] = sd[p + "null_polygon_feature"]
        out["mlp_seg"] = mlp(idx); idx += 1
        out["null_seg"] = sd[p + "null_seg_feature"]
        out["in_conv"] = _conv(sd, p + "in_conv")
        out["pos_embedding"] = sd[p + "pos_embedding"]
        out["convnext"] = convert_convnext(sd, p + "convnext_tiny_backbone.")
    return out


# -- VAE ------------------------------------------------------------------


def _vae_res(sd, p):
    out = {
        "norm1": _norm(sd, p + ".norm1"),
        "conv1": _conv(sd, p + ".conv1"),
        "norm2": _norm(sd, p + ".norm2"),
        "conv2": _conv(sd, p + ".conv2"),
    }
    if p + ".nin_shortcut.weight" in sd:
        out["nin_shortcut"] = _conv(sd, p + ".nin_shortcut")
    return out


def _vae_attn(sd, p):
    return {
        "norm": _norm(sd, p + ".norm"),
        "q": _conv(sd, p + ".q"),
        "k": _conv(sd, p + ".k"),
        "v": _conv(sd, p + ".v"),
        "proj_out": _conv(sd, p + ".proj_out"),
    }


def _vae_mid(sd, p):
    return {
        "block_1": _vae_res(sd, p + ".block_1"),
        "attn_1": _vae_attn(sd, p + ".attn_1"),
        "block_2": _vae_res(sd, p + ".block_2"),
    }


def convert_vae(sd: dict[str, np.ndarray], cfg) -> Params:
    """sd: AutoencoderKL state_dict (first_stage_model stripped)."""
    n_levels = len(cfg.ch_mult)
    enc: Params = {
        "conv_in": _conv(sd, "encoder.conv_in"),
        "down": [],
        "mid": _vae_mid(sd, "encoder.mid"),
        "norm_out": _norm(sd, "encoder.norm_out"),
        "conv_out": _conv(sd, "encoder.conv_out"),
    }
    for i in range(n_levels):
        level: Params = {
            "block": [
                _vae_res(sd, f"encoder.down.{i}.block.{j}")
                for j in range(cfg.num_res_blocks)
            ]
        }
        if f"encoder.down.{i}.downsample.conv.weight" in sd:
            level["downsample"] = _conv(sd, f"encoder.down.{i}.downsample.conv")
        enc["down"].append(level)

    dec: Params = {
        "conv_in": _conv(sd, "decoder.conv_in"),
        "up": [],
        "mid": _vae_mid(sd, "decoder.mid"),
        "norm_out": _norm(sd, "decoder.norm_out"),
        "conv_out": _conv(sd, "decoder.conv_out"),
    }
    for i in range(n_levels):
        level = {
            "block": [
                _vae_res(sd, f"decoder.up.{i}.block.{j}")
                for j in range(cfg.num_res_blocks + 1)
            ]
        }
        if f"decoder.up.{i}.upsample.conv.weight" in sd:
            level["upsample"] = _conv(sd, f"decoder.up.{i}.upsample.conv")
        dec["up"].append(level)

    return {
        "encoder": enc,
        "decoder": dec,
        "quant_conv": _conv(sd, "quant_conv"),
        "post_quant_conv": _conv(sd, "post_quant_conv"),
    }


# -- CLIP text encoder ---------------------------------------------------------


def convert_clip_text(sd: dict[str, np.ndarray], cfg) -> Params:
    """Accepts either an SD checkpoint slice (cond_stage_model.transformer.*)
    or a bare HF CLIPTextModel state dict (text_model.*)."""
    for pre in ("transformer.text_model.", "text_model.", ""):
        if pre + "embeddings.token_embedding.weight" in sd:
            break
    else:
        raise KeyError("CLIP text keys not found")

    out: Params = {
        "token_embedding": sd[pre + "embeddings.token_embedding.weight"],
        "position_embedding": sd[pre + "embeddings.position_embedding.weight"],
        "final_ln": _norm(sd, pre + "final_layer_norm"),
        "layers": [],
    }
    for i in range(cfg.num_hidden_layers):
        lp = f"{pre}encoder.layers.{i}"
        out["layers"].append(
            {
                "ln1": _norm(sd, lp + ".layer_norm1"),
                "q": _lin(sd, lp + ".self_attn.q_proj"),
                "k": _lin(sd, lp + ".self_attn.k_proj"),
                "v": _lin(sd, lp + ".self_attn.v_proj"),
                "out": _lin(sd, lp + ".self_attn.out_proj"),
                "ln2": _norm(sd, lp + ".layer_norm2"),
                "fc1": _lin(sd, lp + ".mlp.fc1"),
                "fc2": _lin(sd, lp + ".mlp.fc2"),
            }
        )
    return out


# -- CLIP vision tower + full-CLIP ---------------------------------------------


def convert_clip_vision(sd: dict[str, np.ndarray], cfg) -> Params:
    """HF CLIPModel/CLIPVisionModel state dict -> vision tower pytree."""
    for pre in ("vision_model.", "clip.vision_model.", ""):
        if pre + "embeddings.patch_embedding.weight" in sd:
            break
    else:
        raise KeyError("CLIP vision keys not found")
    out: Params = {
        "patch_embedding": {
            "w": np.ascontiguousarray(
                sd[pre + "embeddings.patch_embedding.weight"].transpose(2, 3, 1, 0)
            )
        },
        "class_embedding": sd[pre + "embeddings.class_embedding"],
        "position_embedding": sd[pre + "embeddings.position_embedding.weight"],
        "pre_ln": _norm(sd, pre + "pre_layrnorm")
        if pre + "pre_layrnorm.weight" in sd  # (sic — HF's typo'd key name)
        else _norm(sd, pre + "pre_layernorm"),
        "post_ln": _norm(sd, pre + "post_layernorm"),
        "layers": [],
    }
    for i in range(cfg.num_hidden_layers):
        lp = f"{pre}encoder.layers.{i}"
        out["layers"].append(
            {
                "ln1": _norm(sd, lp + ".layer_norm1"),
                "q": _lin(sd, lp + ".self_attn.q_proj"),
                "k": _lin(sd, lp + ".self_attn.k_proj"),
                "v": _lin(sd, lp + ".self_attn.v_proj"),
                "out": _lin(sd, lp + ".self_attn.out_proj"),
                "ln2": _norm(sd, lp + ".layer_norm2"),
                "fc1": _lin(sd, lp + ".mlp.fc1"),
                "fc2": _lin(sd, lp + ".mlp.fc2"),
            }
        )
    if "visual_projection.weight" in sd:
        out["visual_projection"] = _lin(sd, "visual_projection", bias=False)
    return out


def convert_clip_model(sd: dict[str, np.ndarray], text_cfg, vision_cfg):
    """Full HF CLIPModel -> (vision_params, text_params, text_projection)."""
    vision = convert_clip_vision(sd, vision_cfg)
    text = convert_clip_text(sd, text_cfg)
    text_projection = _lin(sd, "text_projection", bias=False)
    return vision, text, text_projection


# -- UNet ---------------------------------------------------------------------


def convert_unet(
    sd: dict[str, np.ndarray],
    cfg: UNetConfig,
    first_conv_sd: dict[str, np.ndarray] | None = None,
) -> Params:
    """sd: reference UNetModel state_dict (model.diffusion_model stripped).

    first_conv_sd: optional {weight, bias} of the stock SD first conv
    (pretrained/SD_v1_5_input_conv_weight_bias.pth) for the alpha==0 swap;
    defaults to the trained first conv (swap becomes a no-op)."""
    input_plan, middle_plan, output_plan = build_plan(cfg)

    def layer(spec, p):
        if spec.kind == "conv_in":
            return {"conv": _conv(sd, p)}
        if spec.kind == "res":
            return _res(sd, p)
        if spec.kind == "attn":
            return _spatial(sd, p, cfg.transformer_depth)
        if spec.kind == "down":
            return {"conv": _conv(sd, p + ".op")}
        if spec.kind == "up":
            return {"conv": _conv(sd, p + ".conv")}
        raise ValueError(spec.kind)

    params: Params = {
        "time_embed": {
            "l1": _lin(sd, "time_embed.0"),
            "l2": _lin(sd, "time_embed.2"),
        },
        "input_blocks": [
            [layer(s, f"input_blocks.{i}.{j}") for j, s in enumerate(blk)]
            for i, blk in enumerate(input_plan)
        ],
        "middle_block": [
            layer(s, f"middle_block.{j}") for j, s in enumerate(middle_plan)
        ],
        "output_blocks": [
            [layer(s, f"output_blocks.{i}.{j}") for j, s in enumerate(blk)]
            for i, blk in enumerate(output_plan)
        ],
        "out": {"norm": _norm(sd, "out.0"), "conv": _conv(sd, "out.2")},
        "scaleu": [
            {"b": sd[f"scaleu_b_{i}"], "s": sd[f"scaleu_s_{i}"]}
            for i in range(len(output_plan))
        ],
        "position_net": convert_unifusion(sd, cfg.grounding_tokenizer),
    }
    if first_conv_sd is not None:
        params["first_conv_sd"] = {
            "w": np.ascontiguousarray(first_conv_sd["weight"].transpose(2, 3, 1, 0)),
            "b": first_conv_sd["bias"],
        }
    else:
        params["first_conv_sd"] = {
            k: np.copy(v) for k, v in params["input_blocks"][0][0]["conv"].items()
        }
    return params


# -- SDXL-Refiner -------------------------------------------------------------


def _proj(sd, p):
    """A spatial transformer's proj_in / proj_out: a 1x1 conv (OIHW) or,
    in files written with `use_linear_in_transformer` (the public
    sd_xl_refiner.yaml), a (C_out, C_in) Linear over the same channels. Both
    are the same per-pixel map, so a 2-D weight is read as the 1x1 conv
    (the JAX package's converter reads the conv form only)."""
    w = sd[p + ".weight"]
    if w.ndim == 2:
        w = w[:, :, None, None]
    out = {"w": np.ascontiguousarray(w.transpose(2, 3, 1, 0))}
    if p + ".bias" in sd:
        out["b"] = sd[p + ".bias"]
    return out


def _tblock_plain(sd, p):
    """Transformer block without a fuser (plain SDXL naming)."""
    return {
        "attn1": _mha(sd, p + ".attn1"),
        "attn2": _mha(sd, p + ".attn2"),
        "ff": _ff_geglu(sd, p + ".ff"),
        "norm1": _norm(sd, p + ".norm1"),
        "norm2": _norm(sd, p + ".norm2"),
        "norm3": _norm(sd, p + ".norm3"),
    }


def _spatial_plain(sd, p, depth):
    return {
        "norm": _norm(sd, p + ".norm"),
        "proj_in": _proj(sd, p + ".proj_in"),
        "blocks": [
            _tblock_plain(sd, f"{p}.transformer_blocks.{d}")
            for d in range(depth)
        ],
        "proj_out": _proj(sd, p + ".proj_out"),
    }


def convert_refiner_unet(sd: dict[str, np.ndarray], cfg) -> Params:
    """sd: sgm `sd_xl_refiner_1.0.safetensors` UNet state_dict with the
    `model.diffusion_model.` prefix stripped (the original LDM naming: the
    SD1.5 openaimodel scheme plus `label_emb` for the ADM vector)."""
    input_plan, middle_plan, output_plan = build_refiner_plan(cfg)

    def layer(spec, p):
        if spec.kind == "conv_in":
            return {"conv": _conv(sd, p)}
        if spec.kind == "res":
            return _res(sd, p)
        if spec.kind == "attn":
            return _spatial_plain(sd, p, cfg.transformer_depth)
        if spec.kind == "down":
            return {"conv": _conv(sd, p + ".op")}
        if spec.kind == "up":
            return {"conv": _conv(sd, p + ".conv")}
        raise ValueError(spec.kind)

    return {
        "time_embed": {
            "l1": _lin(sd, "time_embed.0"),
            "l2": _lin(sd, "time_embed.2"),
        },
        # openaimodel num_classes="sequential": label_emb.0 is itself a
        # Sequential(linear, SiLU, linear)
        "label_emb": {
            "l1": _lin(sd, "label_emb.0.0"),
            "l2": _lin(sd, "label_emb.0.2"),
        },
        "input_blocks": [
            [layer(s, f"input_blocks.{i}.{j}") for j, s in enumerate(blk)]
            for i, blk in enumerate(input_plan)
        ],
        "middle_block": [
            layer(s, f"middle_block.{j}") for j, s in enumerate(middle_plan)
        ],
        "output_blocks": [
            [layer(s, f"output_blocks.{i}.{j}") for j, s in enumerate(blk)]
            for i, blk in enumerate(output_plan)
        ],
        "out": {"norm": _norm(sd, "out.0"), "conv": _conv(sd, "out.2")},
    }


def convert_openclip_text(sd: dict[str, np.ndarray], cfg) -> Params:
    """OpenCLIP text tower (`conditioner.embedders.0.model.` stripped) ->
    the `models/clip_text` tree. open_clip fuses q/k/v into in_proj_*; the
    text_projection parameter is stored (width, proj), already in x @ W
    orientation, so it copies without the torch (out, in) transpose."""
    d = cfg.hidden_size

    def resblock(i):
        p = f"transformer.resblocks.{i}"
        w = sd[p + ".attn.in_proj_weight"]   # (3d, d) torch layout
        b = sd[p + ".attn.in_proj_bias"]
        return {
            "ln1": {"scale": sd[p + ".ln_1.weight"], "bias": sd[p + ".ln_1.bias"]},
            "q": {"w": np.ascontiguousarray(w[:d].T), "b": b[:d]},
            "k": {"w": np.ascontiguousarray(w[d:2 * d].T), "b": b[d:2 * d]},
            "v": {"w": np.ascontiguousarray(w[2 * d:].T), "b": b[2 * d:]},
            "out": _lin(sd, p + ".attn.out_proj"),
            "ln2": {"scale": sd[p + ".ln_2.weight"], "bias": sd[p + ".ln_2.bias"]},
            "fc1": _lin(sd, p + ".mlp.c_fc"),
            "fc2": _lin(sd, p + ".mlp.c_proj"),
        }

    return {
        "token_embedding": sd["token_embedding.weight"],
        "position_embedding": sd["positional_embedding"],
        "layers": [resblock(i) for i in range(cfg.num_hidden_layers)],
        "final_ln": {
            "scale": sd["ln_final.weight"], "bias": sd["ln_final.bias"]
        },
        "text_projection": {"w": sd["text_projection"]},
    }


def split_refiner_ckpt(sd: dict[str, np.ndarray]) -> dict[str, dict[str, np.ndarray]]:
    """Full sd_xl_refiner checkpoint -> {unet, text, vae} sub-dicts with
    prefixes stripped (sgm layout: model.diffusion_model / conditioner.
    embedders.0.model / first_stage_model)."""
    out: dict[str, dict[str, np.ndarray]] = {"unet": {}, "text": {}, "vae": {}}
    for k, v in sd.items():
        if k.startswith("model.diffusion_model."):
            out["unet"][k[len("model.diffusion_model."):]] = v
        elif k.startswith("conditioner.embedders.0.model."):
            out["text"][k[len("conditioner.embedders.0.model."):]] = v
        elif k.startswith("first_stage_model."):
            out["vae"][k[len("first_stage_model."):]] = v
    return out
